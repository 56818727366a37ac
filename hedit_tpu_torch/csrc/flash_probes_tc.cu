// The bounded, exact-exp2, ablation and bf16-PV flash probes in bfloat16 on
// Hopper's tensor cores (sm_90a), replacing for bf16 inputs the TPU kernels
// of scripts/flash_nhd_variants.py (entry point hedit_flash_packed_t_tc, the
// arguments of flash_variants.cu's hedit_flash_packed_t; wrappers
// flash_packed_t*_cuda in ops/flash_probes.py)
//   _packed_t_kernel (:93)              q, k, v [BH, S, D]              layout 0
//   _packed_t_kernel_sminor (:101)      q, k [BH, D, S]; v [BH, S, D]   layout 1
//   _packed_t_kernel_all_sminor (:136)  q, k, v [BH, D, S]              layout 2
// of scripts/flash_v4_variants.py
//   kern_exp2 (:34)                     q, k, v [BH, S, D], both key loops
// (entry point hedit_flash_exp2_t_tc, the arguments of flash_variants.cu's
// hedit_flash_exp2_t; wrapper flash_exp2_t_cuda), of scripts/flash_ablate.py
//   make_kernel(mode) (:34), dots, exp, noprolog     q, k, v [BH, S, D]
// (entry point hedit_flash_ablate_t_tc, the arguments of flash_variants.cu's
// hedit_flash_ablate_t; wrapper flash_ablate_t_cuda; `dots` also as a
// check-only instance that stores its scores and row sums:
// hedit_flash_ablate_dots_check_tc, wrapper flash_ablate_dots_check_cuda)
// and of scripts/flash_variants.py
//   kern_a(pv_bf16=True) (:31)          q, k, v [BH, S, D], D = 40
// (entry point hedit_flash_variant_tc, the arguments of flash_variants.cu's
// hedit_flash_variant; wrapper flash_variant_a_cuda(pv_bf16=True)).  All but
// the last write the transposed output [BH, D, Sq], the same memory as the
// packed transposed [B, H*D, Sq] the TPU wrappers return; the last writes
// [BH, Sq, D].  float32 inputs stay on the CUDA-core kernels of
// flash_variants.cu.
//
// The bounded function: q * scale, the
// scale rounded to bf16 and the product rounded again; float32 scores;
// shift = the row's max over the first `anchor` keys + 16; p = exp2(min(s -
// shift, 100)) rounded to bf16, which feeds both the PV product and the row
// sum; the sum floored at 1.2e-38; the output rounded once.  The exact
// function (row 10) is flash_attention_tc.cu's EXACT mode without its mask
// (the probes cover whole tiles): the same q * scale and scores; over each
// 64-key tile the running max m_new = max(m, tile max), m starting at
// -1e30; alpha = exp2(m - m_new) rescales the accumulators and the sum; p =
// exp2(s - m_new) rounded to bf16 feeds the PV product and the sum; out =
// acc / sum with no floor.  The 64-key tile is the kernel's and decides
// which max each p is rounded against (kern_exp2 with blk_k = 64).  The
// tensor cores change only the summation order.
//
// The ablations (row 8) are the bounded function without its prologue: q
// as it is (no scale; the load skips the multiply), the shift a constant
// (0 for `exp`, 12.34 for `noprolog`), the clamp at 100 for `noprolog`
// only, the sum floored at 1e-30.  `dots` takes p = the float32 score
// rounded to bf16: no shift, no exp2, no clamp.  Its row sum (the sum of
// the rounded p) is as often negative as positive, so out = acc / max(sum,
// 1e-30) is ill-conditioned where the sum nears zero.  Its check therefore
// reads the kernel's own numbers: the CHECK instance (a compile-time flag,
// never the timed kernel) also stores each float32 score before its
// rounding, [BH, Sq, Sk], and each row sum before the floor, [BH, Sq]; the
// two instances compute the same bits.  The row sum is a chain of float32
// adds in a fixed order (each lane adds the pair (key 2t, 2t + 1) of every
// 8-key n-tile, tile after tile; then lanes t ^ 1, then t ^ 2), which
// ops/flash_probes.py:ablate_dots_row_sums repeats bit for bit.  The bf16-PV variant (row 9 d) is the
// exact function with kern_a's arithmetic: q as it is, each float32 score
// q.k (products of bf16 values, exact in float32) times c = sm_scale *
// log2(e) rounded to float32, so that exp2(s c - m) is kern_a's exp(q sm_scale
// . k - m) up to float32 rounding; the row sum takes p before its rounding,
// the PV product p rounded to bf16; out = acc / sum, row-major.
//
// `pipe` is kern_exp2's software-pipelined loop: the score product of tile
// t is issued before the softmax and PV of tile t - 1 (a prologue takes
// tile 0's scores, an epilogue drains the last tile).  Each tile goes
// through the same code in the same order as in the plain loop, so the two
// outputs are bit-identical.  Two score fragments are live (2 x 32 floats a
// thread), and tile t - 1's V is still read while tile t + 1 loads: the
// pipelined loop takes a three-stage K / V ring and a larger register
// budget than the bounded probes' (the launch lines below).
//
// What bounds it on the H100.  At the probes' [16, 8, 4096, 40] and [4, 32,
// 4096, 40] the work is 4 B H S^2 D = 343.6 GFLOP against 168 MB of q, k, v
// and out, ~2,000 FLOP a byte: the bound is the tensor cores' 989 TFLOP/s
// (0.347 ms); row 9 d's [32, 4096, 40], a quarter of it (0.0869 ms).  The
// CUDA-core templates reached 24-27 TFLOP/s here (float32 FMAs, p through
// shared memory, one element a thread a load).
//
// Design: flash_attention_tc.cu's forward (a warp owns 16 query rows; d = 40
// in blocks of 4 warps, contracting the scores over 48; d = 80 in blocks of
// 8 warps; 64-key tiles in a cp.async ring; the score fragments rounded to
// bf16 pairs are the A fragments of PV, so p never leaves registers), with
// the operands where each layout puts them.  ldmatrix's .trans switch
// absorbs the layouts:
// - q, row-major (layout 0, rows 8, 9 d, 10): the bounded forward's
//   [BQ][DK + 8] tile, scaled and rounded (or as it is), columns D .. DK
//   zero; A fragments (m = queries, k = d) by plain ldmatrix.  S-minor
//   (layouts 1, 2): the [D, BQ] slab, D runs of BQ contiguous queries, kept
//   as it lies, [DK][BQ + 8], rows D .. DK zero; A fragments by
//   ldmatrix.trans.  Read once a block;
// - K, row-major: [BK][DK + 8] ring tiles by 16-byte cp.async runs of 8
//   contiguous d, columns D .. DK zeroed once; the score product's B
//   operand (k = d, n = keys) by plain ldmatrix.  S-minor: [DK][BK + 8]
//   tiles by runs of 8 contiguous keys, rows D .. DK zeroed once; B by
//   ldmatrix.trans (S-minor K is to the scores what row-major V is to PV);
// - V, row-major (all but layout 2): the bounded forward's [BK][DK + 8]
//   tile and ldmatrix.trans; S-minor (layout 2): a [D][BK + 8] tile read by
//   plain ldmatrix, since S-minor V is already the col layout of PV's B
//   operand (k = keys, n = d);
// - out: acc / sum, rounded to bf16, staged over q's tile (read only into
//   registers before the key loops): transposed as [D][BQ + 8], then stored
//   as D runs of BQ contiguous queries, 16 bytes a thread, into
//   out[bh][c][q0 + r]; row 9 d row-major as [BQ][D + 8], then stored as the
//   block's one contiguous run of BQ x D elements, 16 bytes a thread.
// Shared rows of BQ + 8, BK + 8, D + 8 or DK + 8 elements (144, 272, 96, 112
// or 176 bytes) put the eight rows of each 8 x 8 ldmatrix on distinct
// 16-byte bank groups.  The loaders' index math divides only by
// compile-time constants.  Sq is a multiple of 64 and the d = 80 block holds
// 128 rows: the last block of an image may hold 64 rows past Sq, read as
// zeros and never stored.
//
// Contract: bf16 only (dtype 1); D 40 or 80 (row 9 d: 40); every operand a
// dense image per (batch, head), 16-byte aligned; Sq and Sk multiples of 64
// (the probes cover whole blocks and mask no key); for the bounded probes
// layout 0, 1 or 2 and the anchor a multiple of 64 that divides Sk; for row
// 10 pipe 0 or 1; for row 8 mode 0 (dots), 1 (exp) or 2 (noprolog); for row
// 9 variant 1 (d).  Anything else returns -1.

#include <climits>
#include <cmath>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kShiftMargin = 16.f;   // shift = anchor max + 16 (base 2)
constexpr float kSaturate = 100.f;     // p = exp2(min(s - shift, 100))
constexpr float kDenomFloor = 1.2e-38f;
constexpr float kNegInf = -1e30f;      // kern_exp2's first running max
constexpr float kAblateFloor = 1e-30f;  // flash_ablate.py's floor of the sum
constexpr float kAblateShift = 12.34f;  // flash_ablate.py's constant shift (noprolog)
constexpr int BK = 64;                 // keys a tile; Sk and the anchor are multiples of it

// The probe a kernel instance computes; see the head of this file.
enum class Op {
  PackedT, PackedTSMinor, PackedTAllSMinor, Exp2, Exp2Pipe, AblateDots, AblateExp, AblateNoProlog,
  VariantBf16PV
};

template <Op P>
struct OpTraits {
  static constexpr bool qk_sminor = P == Op::PackedTSMinor || P == Op::PackedTAllSMinor;
  static constexpr bool v_sminor = P == Op::PackedTAllSMinor;
  static constexpr bool dots = P == Op::AblateDots;  // p = bf16(s): no exp2
  static constexpr bool ablate = dots || P == Op::AblateExp || P == Op::AblateNoProlog;
  static constexpr bool variant = P == Op::VariantBf16PV;
  static constexpr bool exact = P == Op::Exp2 || P == Op::Exp2Pipe || variant;  // running max
  static constexpr bool anchored = !exact && !ablate;   // the prologue finds the shift
  static constexpr bool scale_q = !ablate && !variant;  // q * scale rounded on its load
  static constexpr bool clamp = !exact && !dots && P != Op::AblateExp;  // exp2(min(s - shift, 100))
  static constexpr float const_shift = P == Op::AblateNoProlog ? kAblateShift : 0.f;  // ablations
  static constexpr float denom_floor = ablate ? kAblateFloor : kDenomFloor;  // not exact
  static constexpr bool row_out = variant;  // out [BH, Sq, D], else [BH, D, Sq]
  static constexpr bool pipe = P == Op::Exp2Pipe;
  static constexpr int stages = pipe ? 3 : 2;  // K / V ring depth
};

// A block of WR warps, 16 query rows each, computing probe P.
template <int D, int WR, Op P>
struct ProbeTile {
  using Tr = OpTraits<P>;
  static constexpr int kThreadsTc = 32 * WR;
  static constexpr int BQ = 16 * WR;             // query rows of a block
  static constexpr int DK = (D + 15) / 16 * 16;  // score contraction, zero-padded to k = 16
  static constexpr int QS = Tr::qk_sminor ? BQ + 8 : DK + 8;  // q: [DK][BQ] or [BQ][DK]
  static constexpr int KS = Tr::qk_sminor ? BK + 8 : DK + 8;  // K: [DK][BK] or [BK][DK]
  static constexpr int VS = Tr::v_sminor ? BK + 8 : DK + 8;   // V: [D][BK] or [BK][DK]
  static constexpr int OS = Tr::row_out ? D + 8 : BQ + 8;  // staged out [BQ][D] or [D][BQ]
  static constexpr int NT = BK / 8;              // score n-tiles of a key tile
  static constexpr int NO = D / 8;               // output n-tiles
  static constexpr int q_tile = Tr::qk_sminor ? DK * QS : BQ * QS;
  static constexpr int o_elems = Tr::row_out ? BQ * OS : D * OS;
  static constexpr int q_elems = q_tile > o_elems ? q_tile : o_elems;  // q, then the output
  static constexpr int k_elems = Tr::qk_sminor ? DK * KS : BK * KS;  // one stage
  static constexpr int v_elems = Tr::v_sminor ? D * VS : BK * VS;
  static_assert(D % 8 == 0 && BQ % 8 == 0, "tile does not fit the mma shapes");

  static constexpr size_t smem_bytes() {
    return sizeof(bf16) * (size_t(q_elems) + size_t(Tr::stages) * (k_elems + v_elems));
  }
};

// CHECK: the `dots` instance that also stores its float32 scores s_chk
// [BH, Sq, Sk] and row sums l_chk [BH, Sq] (see the head of this file)
template <int D, int WR, int MINB, Op P, bool CHECK>
__global__ void __launch_bounds__(32 * WR, MINB)
flash_probe_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out, int sq, int sk,
                      float qscale, int anchor, float* __restrict__ s_chk,
                      float* __restrict__ l_chk) {
  using C = ProbeTile<D, WR, P>;
  using Tr = OpTraits<P>;
  static_assert(!CHECK || Tr::dots, "only dots has a check instance");
  constexpr int BQ = C::BQ, DK = C::DK, QS = C::QS, KS = C::KS, VS = C::VS, OS = C::OS,
                NT = C::NT, NO = C::NO, NTH = C::kThreadsTc, S = Tr::stages;
  constexpr int QCH = BQ / 8, KCH = BK / 8, CH = D / 8, DCH = DK / 8;  // 16-byte chunks

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // q * scale: [DK][QS] or [BQ][QS]
  bf16* k_s = q_s + C::q_elems;                   // [S] x (k^T [DK][KS] or k [BK][KS])
  bf16* v_s = k_s + S * C::k_elems;               // [S] x (v^T [D][VS] or v [BK][VS])
  bf16* o_s = q_s;                                // [BQ][OS] or [D][OS]: the output over q's tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' row group and column pair
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const bf16* qg = q + size_t(bh) * D * sq;
  const bf16* kg = k + size_t(bh) * D * sk;
  const bf16* vg = v + size_t(bh) * D * sk;

  // q * scale rounded to bf16 (the scale itself rounded first), as the TPU
  // kernels scale q, or q as it is (rows 8, 9 d); queries past Sq and the
  // contraction's pad are 0
  const float qsc = __bfloat162float(__float2bfloat16(qscale));
  auto scaled = [&](const bf16* src, bool ok) {
    uint4 x = make_uint4(0, 0, 0, 0);
    if (ok) {
      x = *reinterpret_cast<const uint4*>(src);
      if constexpr (Tr::scale_q) {
        bf16* xe = reinterpret_cast<bf16*>(&x);
#pragma unroll
        for (int i = 0; i < 8; ++i) xe[i] = __float2bfloat16(__bfloat162float(xe[i]) * qsc);
      }
    }
    return x;
  };
  if constexpr (Tr::qk_sminor) {
    for (int e = tid; e < DK * QCH; e += NTH) {  // (q * scale)^T: D runs of BQ queries
      const int c = e / QCH, r = (e - c * QCH) * 8;
      *reinterpret_cast<uint4*>(q_s + c * QS + r) =
          scaled(qg + c * sq + q0 + r, c < D && q0 + r < sq);
    }
    // the pad rows D .. DK of every K stage: never copied into, so zeroed once
    if constexpr (DK > D) {
      for (int e = tid; e < S * (DK - D) * KCH; e += NTH) {
        const int row = e / KCH, ch = e - row * KCH;  // row over the stages' pad rows
        const int stage = row / (DK - D), c = D + row - stage * (DK - D);
        *reinterpret_cast<uint4*>(k_s + stage * C::k_elems + c * KS + ch * 8) =
            make_uint4(0, 0, 0, 0);
      }
    }
  } else {
    for (int e = tid; e < BQ * DCH; e += NTH) {  // q * scale: BQ rows of D
      const int r = e / DCH, c = e - r * DCH;
      *reinterpret_cast<uint4*>(q_s + r * QS + c * 8) =
          scaled(qg + (q0 + r) * D + c * 8, q0 + r < sq && c < CH);
    }
    // the pad columns D .. DK of every K row of the ring, zeroed once
    if constexpr (DK > D) {
      for (int e = tid; e < S * BK * (DCH - CH); e += NTH) {
        const int r = e / (DCH - CH), c = e - r * (DCH - CH);
        *reinterpret_cast<uint4*>(k_s + r * KS + D + c * 8) = make_uint4(0, 0, 0, 0);
      }
    }
  }

  // keys k0 .. k0 + BK of K (and V) into ring stage `stage`
  auto load_tile = [&](int k0, int stage, bool with_v) {
    bf16* kd = k_s + stage * C::k_elems;
    if constexpr (Tr::qk_sminor) {
      for (int e = tid; e < D * KCH; e += NTH) {
        const int c = e / KCH, ch = e - c * KCH;
        cp_async_16(smem_u32(kd + c * KS + ch * 8), kg + c * sk + k0 + ch * 8, true);
      }
    } else {
      for (int e = tid; e < BK * CH; e += NTH) {
        const int r = e / CH, c = e - r * CH;
        cp_async_16(smem_u32(kd + r * KS + c * 8), kg + (k0 + r) * D + c * 8, true);
      }
    }
    if (with_v) {
      bf16* vd = v_s + stage * C::v_elems;
      if constexpr (Tr::v_sminor) {
        for (int e = tid; e < D * KCH; e += NTH) {
          const int c = e / KCH, ch = e - c * KCH;
          cp_async_16(smem_u32(vd + c * VS + ch * 8), vg + c * sk + k0 + ch * 8, true);
        }
      } else {
        for (int e = tid; e < BK * CH; e += NTH) {
          const int r = e / CH, c = e - r * CH;
          cp_async_16(smem_u32(vd + r * VS + c * 8), vg + (k0 + r) * D + c * 8, true);
        }
      }
    }
    cp_async_commit();
  };
  // body(j) for every key tile j of 0 .. end (in ring stage j % S), tile
  // j + 1 in flight while tile j is computed.  Tile j + 1 overwrites tile
  // j + 1 - S, whose last reads ended before the barrier closing body(j - 1)
  // (the pipelined loop reads tile j - 1's V in body(j): S = 3)
  auto tile_loop = [&](int end, bool with_v, auto&& body) {
    const int n = end / BK;
    load_tile(0, 0, with_v);
    for (int j = 0; j < n; ++j) {
      if (j + 1 < n) {
        load_tile((j + 1) * BK, (j + 1) % S, with_v);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // tile j visible
      body(j);
      __syncthreads();  // tile j + 1 - S's stage is free for tile j + 2
    }
  };

  // this warp's A fragments of q (m = its 16 queries, k = d): a[0] queries
  // 0-7 / d 0-7, a[1] queries 8-15, a[2] d 8-15
  unsigned qf[DK / 16][4];
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    if constexpr (Tr::qk_sminor)  // the [d][query] tile: ldmatrix.trans
      ldsm_x4_t(smem_u32(q_s + (kk * 16 + (lane >> 4) * 8 + (lane & 7)) * QS + warp * 16 +
                         ((lane >> 3) & 1) * 8),
                qf[kk]);
    else  // the [query][d] tile: plain ldmatrix
      ldsm_x4(smem_u32(q_s + (warp * 16 + (lane & 15)) * QS + kk * 16 + (lane >> 4) * 8),
              qf[kk]);
  }

  // scores (base 2) of the warp's 16 rows against the tile in `stage`:
  // s[j][e] is row g + 8 * (e >> 1), key j * 8 + 2 * t + (e & 1).  B is
  // (k = d, n = keys): [d][key] in k^T's tile (ldmatrix.trans), its col
  // layout in k's [key][d] tile (plain ldmatrix)
  auto scores = [&](int stage, float (&s)[NT][4]) {
    const bf16* kt = k_s + stage * C::k_elems;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        unsigned kf[4];
        if constexpr (Tr::qk_sminor)
          ldsm_x4_t(smem_u32(kt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * KS +
                             jp * 16 + (lane >> 4) * 8),
                    kf);
        else
          ldsm_x4(smem_u32(kt + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * KS + kk * 16 +
                           ((lane >> 3) & 1) * 8),
                  kf);
        mma_bf16(s[2 * jp], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], kf[2], kf[3]);
      }
    }
  };

  // what each row's scores are shifted by before exp2: bounded, the anchor
  // window's max + 16 (the prologue); exact, the running max; the
  // ablations, their constant
  const float shift0 = Tr::exact ? kNegInf : Tr::ablate ? Tr::const_shift : -CUDART_INF_F;
  float shift[2] = {shift0, shift0};
  if constexpr (Tr::anchored) {
    tile_loop(anchor, false, [&](int j) {
      float s[NT][4];
      scores(j % S, s);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) shift[e >> 1] = fmaxf(shift[e >> 1], s[n][e]);
    });
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      shift[r] = fmaxf(shift[r], __shfl_xor_sync(0xffffffffu, shift[r], 1));
      shift[r] = fmaxf(shift[r], __shfl_xor_sync(0xffffffffu, shift[r], 2));
      shift[r] += kShiftMargin;
    }
  }

  float o[NO][4], l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  // the softmax weights of one tile's scores (exact: after the running max
  // moves over the tile and rescales the sums), the row sums, and acc += p v
  // from V's stage `stage`
  auto softmax_pv = [&](float (&s)[NT][4], int stage) {
    if constexpr (Tr::variant) {  // the float32 scores times c, each rounded once
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = __fmul_rn(s[j][e], qscale);
    }
    if constexpr (Tr::exact) {
      float mx[2] = {shift[0], shift[1]};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float alpha = exp2f(shift[r] - mx[r]);
        shift[r] = mx[r];
        l[r] *= alpha;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[n][2 * r] *= alpha;
          o[n][2 * r + 1] *= alpha;
        }
      }
    }
    const bf16* vt = v_s + stage * C::v_elems;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // p of keys kk*16 .. kk*16 + 16 in bf16: the A fragment of the PV product
      unsigned a[4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = 2 * kk + hh;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float d0 = s[j][2 * r] - shift[r], d1 = s[j][2 * r + 1] - shift[r];
          const float p0 = Tr::dots ? d0 : Tr::clamp ? exp2f(fminf(d0, kSaturate)) : exp2f(d0);
          const float p1 = Tr::dots ? d1 : Tr::clamp ? exp2f(fminf(d1, kSaturate)) : exp2f(d1);
          const __nv_bfloat162 pb = __floats2bfloat162_rn(p0, p1);
          // the row sum of the rounded p (row 9 d: of p before its rounding)
          l[r] += Tr::variant ? p0 + p1 : __low2float(pb) + __high2float(pb);
          a[hh * 2 + r] = *reinterpret_cast<const unsigned*>(&pb);
        }
      }
      if constexpr (Tr::v_sminor) {
        // v^T [d][key]: B (k = keys, n = d) in its col layout, plain ldmatrix
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          unsigned vf[4];
          ldsm_x4(smem_u32(vt + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * VS + kk * 16 +
                           ((lane >> 3) & 1) * 8),
                  vf);
          mma_bf16(o[2 * np], a, vf[0], vf[1]);
          mma_bf16(o[2 * np + 1], a, vf[2], vf[3]);
        }
        if constexpr (NO % 2 == 1) {
          unsigned vf[2];
          ldsm_x2(smem_u32(vt + ((NO - 1) * 8 + (lane & 7)) * VS + kk * 16 +
                           ((lane >> 3) & 1) * 8),
                  vf);
          mma_bf16(o[NO - 1], a, vf[0], vf[1]);
        }
      } else {
        // v [key][d]: ldmatrix.trans, as the bounded forward's PV product
        const int vrow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          unsigned vf[4];
          ldsm_x4_t(smem_u32(vt + vrow * VS + np * 16 + (lane >> 4) * 8), vf);
          mma_bf16(o[2 * np], a, vf[0], vf[1]);
          mma_bf16(o[2 * np + 1], a, vf[2], vf[3]);
        }
        if constexpr (NO % 2 == 1) {
          unsigned vf[2];
          ldsm_x2_t(smem_u32(vt + vrow * VS + (NO - 1) * 8), vf);
          mma_bf16(o[NO - 1], a, vf[0], vf[1]);
        }
      }
    }
  };

  if constexpr (Tr::pipe) {
    // tile j's scores, then tile j - 1's softmax and PV; the epilogue
    // drains the last tile
    float s_prev[NT][4];
    tile_loop(sk, true, [&](int j) {
      float s_next[NT][4];
      scores(j % S, s_next);
      if (j > 0) softmax_pv(s_prev, (j - 1) % S);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s_prev[n][e] = s_next[n][e];
    });
    softmax_pv(s_prev, (sk / BK - 1) % S);  // its stage is not reloaded: no tile follows
  } else {
    tile_loop(sk, true, [&](int j) {
      float s[NT][4];
      scores(j % S, s);
      if constexpr (CHECK) {  // s[n][2r + e]: row g + 8r, key j * BK + n * 8 + 2t + e
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = q0 + warp * 16 + g + 8 * r;
          if (row < sq) {
            float* dst = s_chk + (size_t(bh) * sq + row) * sk + size_t(j) * BK + 2 * t;
#pragma unroll
            for (int n = 0; n < NT; ++n)
              *reinterpret_cast<float2*>(dst + n * 8) = make_float2(s[n][2 * r], s[n][2 * r + 1]);
          }
        }
      }
      softmax_pv(s, j % S);
    });
  }

  // out = acc / sum (bounded and ablations: the sum floored; exact: the
  // row's max key added p = 1), rounded once, staged in o_s (the key loops
  // ended on a barrier, and q's tile was last read before them): element
  // (row g + 8r, column n*8 + 2t + e) to o_s[column][row], or row-major to
  // o_s[row][column]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float den = Tr::exact ? l[r] : fmaxf(l[r], Tr::denom_floor);
    const int row = warp * 16 + g + 8 * r;
    if constexpr (CHECK) {
      if (t == 0 && q0 + row < sq) l_chk[size_t(bh) * sq + q0 + row] = l[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if constexpr (Tr::row_out) {
        *reinterpret_cast<__nv_bfloat162*>(o_s + row * OS + n * 8 + 2 * t) =
            __floats2bfloat162_rn(o[n][2 * r] / den, o[n][2 * r + 1] / den);
      } else {
        o_s[(n * 8 + 2 * t) * OS + row] = __float2bfloat16(o[n][2 * r] / den);
        o_s[(n * 8 + 2 * t + 1) * OS + row] = __float2bfloat16(o[n][2 * r + 1] / den);
      }
    }
  }
  __syncthreads();
  // queries past Sq (the last d = 80 block's second half) are not stored
  bf16* og = out + size_t(bh) * D * sq;
  if constexpr (Tr::row_out) {
    // the block's rows q0 .. q0 + BQ of out[bh]: one run of BQ x D elements
    for (int e = tid; e < BQ * CH; e += NTH) {
      const int r = e / CH, c = e - r * CH;
      if (q0 + r < sq)
        *reinterpret_cast<uint4*>(og + (q0 + r) * D + c * 8) =
            *reinterpret_cast<const uint4*>(o_s + r * OS + c * 8);
    }
  } else {
    // D runs of BQ contiguous queries into out[bh][c][q0 ..]
    for (int e = tid; e < D * QCH; e += NTH) {
      const int c = e / QCH, r = (e - c * QCH) * 8;
      if (q0 + r < sq)
        *reinterpret_cast<uint4*>(og + c * sq + q0 + r) =
            *reinterpret_cast<const uint4*>(o_s + c * OS + r);
    }
  }
}

template <int D, int WR, int MINB, Op P, bool CHECK = false>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int bh, int sq,
                   int sk, int anchor, cudaStream_t stream, float* s_chk = nullptr,
                   float* l_chk = nullptr) {
  using C = ProbeTile<D, WR, P>;
  auto kernel = flash_probe_tc_kernel<D, WR, MINB, P, CHECK>;
  const int smem = int(C::smem_bytes());
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + C::BQ - 1) / C::BQ, bh);
  // JAX's constant, (1 / sqrt(d)) * log2(e) in double, then rounded: q's
  // scale (rounded to bf16 in the kernel), or row 9 d's score factor c
  const float qscale = float(1.0 / sqrt(double(D)) * 1.4426950408889634);
  kernel<<<grid, C::kThreadsTc, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), sq, sk, qscale, anchor, s_chk, l_chk);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

// What every probe here takes (the head of this file): bf16, whole tiles,
// 32-bit offsets in an image, 16-byte aligned operands (cp.async and the q
// and out accesses move 16 bytes)
bool takes(const void* q, const void* k, const void* v, void* out, int bh, int sq, int sk,
           int d, int dtype) {
  if (dtype != 1 || bh < 1 || bh > 65535 || sq < BK || sk < BK || sq % BK || sk % BK) return false;
  if ((long long)(sq > sk ? sq : sk) * d > INT_MAX) return false;
  return aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out);
}

// The launch lines, chosen by probes/flash_probe_tiles.py (which builds
// this file with -DEXP2_MINB_40=n or -DABLATE_MINB_40=n to time other
// budgets): d = 40 in blocks of 4 warps, the bounded probes and the
// ablations 5 an SM (96 registers; `dots` read the same at 4, 5 and 6), the
// exact ones and row 9 d 4 (128: the pipelined loop's two score fragments
// fit without a spill, and the plain loop took 2% less time than at 5);
// d = 80 in blocks of 8 warps, 2 an SM (128 registers; the pipelined loop
// 1, 178 registers).
#ifndef EXP2_MINB_40
#define EXP2_MINB_40 4
#endif
#ifndef ABLATE_MINB_40
#define ABLATE_MINB_40 5
#endif
template <Op P>
constexpr int kMinBlocks40 =
    OpTraits<P>::exact ? EXP2_MINB_40 : OpTraits<P>::ablate ? ABLATE_MINB_40 : 5;

template <Op P, bool CHECK = false>
int launch_d(const void* q, const void* k, const void* v, void* out, int bh, int sq, int sk,
             int d, int anchor, cudaStream_t s, float* s_chk = nullptr, float* l_chk = nullptr) {
  using Tr = OpTraits<P>;
  switch (d) {
    case 40:
      return int(launch<40, 4, kMinBlocks40<P>, P, CHECK>(q, k, v, out, bh, sq, sk, anchor, s,
                                                          s_chk, l_chk));
    case 80:
      return int(launch<80, 8, Tr::pipe ? 1 : 2, P, CHECK>(q, k, v, out, bh, sq, sk, anchor, s,
                                                          s_chk, l_chk));
    default: return -1;
  }
}

}  // namespace

// Plain C entry points for ctypes.  Each returns 0 on success, a cudaError_t
// code from the launch, or -1 for arguments the kernel does not take.

// Row 11 in bf16, the arguments of flash_variants.cu's hedit_flash_packed_t:
// layout 0 (11a: q, k, v [BH, S, D]), 1 (11b: q, k [BH, D, S], v [BH, S, D])
// or 2 (11c: q, k, v [BH, D, S]); out [BH, D, Sq].
extern "C" int hedit_flash_packed_t_tc(const void* q, const void* k, const void* v, void* out,
                                       int bh, int sq, int sk, int d, int anchor, int layout,
                                       int dtype, void* stream) {
  if (!takes(q, k, v, out, bh, sq, sk, d, dtype)) return -1;
  if (anchor < BK || anchor % BK || sk % anchor) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (layout) {
    case 0: return launch_d<Op::PackedT>(q, k, v, out, bh, sq, sk, d, anchor, s);
    case 1: return launch_d<Op::PackedTSMinor>(q, k, v, out, bh, sq, sk, d, anchor, s);
    case 2: return launch_d<Op::PackedTAllSMinor>(q, k, v, out, bh, sq, sk, d, anchor, s);
    default: return -1;
  }
}

// Row 10 in bf16, the arguments of flash_variants.cu's hedit_flash_exp2_t:
// q, k, v [BH, S, D] -> out [BH, D, Sq]; pipe: 0 the plain key loop, 1 the
// software-pipelined one.
extern "C" int hedit_flash_exp2_t_tc(const void* q, const void* k, const void* v, void* out,
                                     int bh, int sq, int sk, int d, int pipe, int dtype,
                                     void* stream) {
  if (!takes(q, k, v, out, bh, sq, sk, d, dtype) || (pipe != 0 && pipe != 1)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pipe ? launch_d<Op::Exp2Pipe>(q, k, v, out, bh, sq, sk, d, 0, s)
              : launch_d<Op::Exp2>(q, k, v, out, bh, sq, sk, d, 0, s);
}

// Row 8 in bf16, the arguments of flash_variants.cu's hedit_flash_ablate_t:
// q, k, v [BH, S, D] -> out [BH, D, Sq]; mode 0 dots, 1 exp, 2 noprolog.
extern "C" int hedit_flash_ablate_t_tc(const void* q, const void* k, const void* v, void* out,
                                       int bh, int sq, int sk, int d, int mode, int dtype,
                                       void* stream) {
  if (!takes(q, k, v, out, bh, sq, sk, d, dtype)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch_d<Op::AblateDots>(q, k, v, out, bh, sq, sk, d, 0, s);
    case 1: return launch_d<Op::AblateExp>(q, k, v, out, bh, sq, sk, d, 0, s);
    case 2: return launch_d<Op::AblateNoProlog>(q, k, v, out, bh, sq, sk, d, 0, s);
    default: return -1;
  }
}

// Row 8's dots in bf16, checked: the output of hedit_flash_ablate_t_tc's
// mode 0 bit for bit, and also each float32 score before its rounding,
// scores [BH, Sq, Sk], and each row sum before the floor, sums [BH, Sq]
// (both 8-byte aligned).
extern "C" int hedit_flash_ablate_dots_check_tc(const void* q, const void* k, const void* v,
                                                void* out, void* scores, void* sums, int bh,
                                                int sq, int sk, int d, int dtype,
                                                void* stream) {
  if (!takes(q, k, v, out, bh, sq, sk, d, dtype)) return -1;
  if (reinterpret_cast<unsigned long long>(scores) % 8 || !sums) return -1;
  return launch_d<Op::AblateDots, true>(q, k, v, out, bh, sq, sk, d, 0,
                                        static_cast<cudaStream_t>(stream),
                                        static_cast<float*>(scores), static_cast<float*>(sums));
}

// Row 9 d in bf16, the arguments of flash_variants.cu's hedit_flash_variant:
// q, k, v [BH, S, D] -> out [BH, Sq, D]; variant 1 (kern_a with pv_bf16) at
// D = 40 only (variants 0, 2 and 3 stay on the template).
extern "C" int hedit_flash_variant_tc(const void* q, const void* k, const void* v, void* out,
                                      int bh, int sq, int sk, int d, int variant_code, int dtype,
                                      void* stream) {
  if (!takes(q, k, v, out, bh, sq, sk, d, dtype) || d != 40 || variant_code != 1) return -1;
  return int(launch<40, 4, kMinBlocks40<Op::VariantBf16PV>, Op::VariantBf16PV>(
      q, k, v, out, bh, sq, sk, 0, static_cast<cudaStream_t>(stream)));
}
