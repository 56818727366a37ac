// Flash-attention forward in bfloat16 on Hopper's tensor cores (sm_90a):
// softmax(q k^T / sqrt(d)) v in the TPU kernels' arithmetic, bounded
// (max-free), optionally with the base-2 log-sum-exp of each row as a second
// output, or exact (a running max), chosen at compile time.
//
// Replaces, for bf16 inputs, the TPU kernel _flash_bounded_kernel
// (hedit_tpu/ops/flash_attention.py:220, wrapper flash_attention_bounded)
//   head-split [BH, S, D]: entry point hedit_flash_attention_fwd_tc, wrapper
//     flash_attention_cuda (the VAE's one-head attention on the paths);
//   packed heads [B, S, H*D]: entry point
//     hedit_flash_attention_fwd_packed_bounded_tc, wrapper
//     flash_attention_packed_bounded_cuda (every UNet self-attention of
//     >= 1024 tokens without a gradient: JAX sends those to
//     flash_attention_diff, whose primal is the same kernel);
// and the TPU kernel _flash_bounded_lse_kernel (:464, row 3, wrapper
// _flash_bounded_fwd_lse: the forward of flash_attention_diff, every
// differentiated self-attention of >= 1024 tokens on the NMG path)
//   head-split: entry point hedit_flash_attention_fwd_lse_tc, wrapper
//     flash_attention_lse_cuda.  After the row sum is reduced across its
//     quad, lane t = 0 of the row's quad (of column quarter 0 at d = 512)
//     writes lse2 = shift + log2(max(sum, 1.2e-38)): the same kernel, one
//     float a row more, instantiated with LSE = true (so the other entries'
//     code is untouched and a trace tells the two apart).  Its tiles are its
//     own (forward_lse_tc): one image's grid is small;
// and the exact TPU kernels (EXACT = true, forward_exact_tc; on no editing
// path of either package)
//   _flash_kernel (:60, row 6, wrapper flash_attention, JAX's public exact
//     forward), head-split: entry point hedit_flash_attention_fwd_exact_tc,
//     wrapper flash_attention_exact_cuda;
//   _flash_packed_kernel (:340, row 7, wrapper flash_attention_packed),
//     packed heads: entry point hedit_flash_attention_fwd_packed_exact_tc,
//     wrapper flash_attention_packed_cuda.
// float32 inputs of every mode stay on the CUDA-core template of
// flash_attention.cu.
//
// The function, exactly as flash_attention.cu computes it in Bounded mode:
// q * scale with scale = 1/sqrt(d) * log2(e) formed in double and rounded to
// float, then to bf16, and the product rounded to bf16; scores are bf16
// products summed in float32; each row's shift is the max of its scores over
// the first min(anchor, Sk) keys plus 16; p = exp2(min(s - shift, 100))
// rounded to bf16 is both the A operand of the PV product and the term of the
// row sum (float32, summed in registers); keys at or past Sk add 0 to both;
// the sum is floored at 1.2e-38 and the output rounded once to bf16.  That
// is the operand contract of mma.sync ... .f32.bf16.bf16.f32: the tensor
// cores compute the same function, in another summation order.
//
// The exact mode, as flash_attention.cu computes it in Exact mode: the same
// q * scale and scores; no prologue and no clamp; over each key tile of BK
// keys (the tile decides which max each p is rounded against, so BK is
// exact_key_tile(D) of ops/flash_attention.py: 64 keys, 32 at d = 512) the
// running max m_new = max(m, tile max), keys at or past Sk set to -1e30
// before the tile max; alpha = exp2(m - m_new) rescales the accumulators
// and the row sum; p = exp2(s - m_new) rounded to bf16 feeds both the PV
// product and the sum; out = acc / sum with no floor (the row's max key
// adds p = 1), rounded once.  m starts at JAX's NEG_INF = -1e30, not -inf,
// so no inf - inf can form a NaN.  The quad's four lanes reduce the tile max
// by __shfl_xor_sync 1 and 2; at d = 512 the four column-quarter warps of a
// row group hold the same scores (below), so the same m, alpha and p.
//
// What bounds it on the H100.  The UNet's self-attention at [8, 4096,
// 8 x 40] does 4 * 8 * 8 * 4096^2 * 40 = 171.8 GFLOP against 84 MB of q, k,
// v and out: ~2,000 FLOP a byte, far above the ~295 of the card's balance
// point, so the bound is the tensor cores' 989 TFLOP/s (0.174 ms).  The
// CUDA-core template reached 67 TFLOP/s at best (float32 FMAs); this kernel
// moves both products to the tensor cores.  At d = 40 the exp2 of every
// score (one MUFU op, 16 a clock an SM) costs about as much as the products.
//
// Design (FlashAttention-2's, for mma.sync m16n8k16):
// - a warp owns 16 query rows; q * scale is rounded into shared memory once
//   and its A fragments are kept in registers (ldmatrix).  d = 40: blocks of
//   4 warps (64 rows), 5 blocks an SM (a budget of 102 registers a thread);
//   d = 80: 8 warps (128 rows, so each K / V tile feeds twice the rows), 2
//   blocks an SM;
// - K and V tiles of BK keys stream through a two-stage ring of shared memory
//   by cp.async 16-byte copies (rows past the end zero-filled), so the loads
//   of tile j + 1 overlap the products of tile j;
// - K fragments come by ldmatrix, V fragments by ldmatrix.trans; shared rows
//   are DK + 8 elements (112, 176 or 1040 bytes), which puts the eight rows
//   of an 8 x 8 ldmatrix on eight distinct 16-byte bank groups;
// - the score accumulators (C layout) are rounded to bf16 pairs and used as
//   the A fragments of the PV product directly: p never leaves registers;
//   only the last key tile pays for the mask of keys past Sk;
// - d = 40 contracts the scores over 48 (the pad columns of q and k are 0):
//   1.2x the QK work, one code path; PV writes 5 n-tiles of 8;
// - d = 512 (the VAE): a warp's 16 x 512 float32 accumulator would take 256
//   registers a lane, so 8 warps split a block's 32 rows as 2 row groups x 4
//   column quarters.  Each warp forms the partial scores of its quarter of
//   the contraction; the four partials of a row group are summed through
//   shared memory in a fixed order (every warp of the group gets the same
//   scores, shift and p) and each warp multiplies p by its quarter of V.  32
//   query rows a block give 128 blocks for the VAE's 4096 queries on 132
//   SMs, so no key split is needed;
// - the anchor prologue runs the same score product over the anchor window
//   (K only): anchor / Sk more QK work, 1/8 at the UNet's 4096 keys, 1/4 for
//   the VAE's (anchor 1024).  The exact mode has no prologue and pays per
//   key tile instead: the tile max (a max a score, two shuffles a row), two
//   exp2 for alpha and the rescale of the accumulators and the sum (DO / 4 + 1
//   floats a row a lane).
//
// Why mma.sync and not wgmma yet: wgmma takes 64-row warpgroup tiles with
// its shared-memory operands in 8-row core matrices or 32/64/128-byte
// swizzle atoms; the 80-byte rows of d = 40, the 1,000-launch case, fit
// those only padded, and d = 512's accumulators need two warpgroups.
// mma.sync moves the products to the tensor cores with none of that.
// wgmma + TMA is the next step for whichever of the two shapes then stays
// furthest from its bound.
//
// Contract: bf16 only (dtype 1).  Head-split: q [BH, Sq, D], k and v
// [BH, Sk, D], contiguous, lse2 [BH, Sq] float32 (the LSE entry); packed:
// as flash_attention.cu's packed entry points (packed_layout).  Every
// pointer 16-byte aligned and every element stride a multiple of 8
// (cp.async copies 16 bytes); D one of 40, 80, 512; any Sq, Sk >= 1;
// anchor >= 1 (the bounded entries; the exact ones take none).  Anything
// else returns -1.

#include <cmath>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kShiftMargin = 16.f;   // shift = anchor max + 16 (base 2)
constexpr float kSaturate = 100.f;     // p = exp2(min(s - shift, 100))
constexpr float kDenomFloor = 1.2e-38f;
constexpr float kNegInf = -1e30f;      // JAX's NEG_INF: the exact mode's first max, masked keys
constexpr int kStages = 2;             // K / V ring depth

// A block of WR x WC warps: WR row groups of 16 query rows, each split into
// WC warps along the head dim; key tiles of BK keys.  MINB: the blocks an SM
// should hold (a register budget for the compiler).
template <int D, int WR, int WC, int BK, int MINB>
struct TcTile {
  static constexpr int kWarps = WR * WC;
  static constexpr int kThreadsTc = 32 * kWarps;
  static constexpr int BQ = 16 * WR;             // query rows of a block
  static constexpr int DK = (D + 15) / 16 * 16;  // score contraction, zero-padded to k = 16
  static constexpr int DW = DK / WC;             // one warp's share of the contraction
  static constexpr int DO = D / WC;              // one warp's output columns
  static constexpr int SS = DK + 8;              // shared row stride (elements)
  static constexpr int NT = BK / 8;              // score n-tiles of a key tile
  static constexpr int NO = DO / 8;              // output n-tiles of a warp
  static constexpr int CH = D / 8;               // 16-byte chunks of a row
  static constexpr int XCH = NT * 4 * 32;        // floats of one warp's partial scores
  static_assert(D % 8 == 0 && DK % WC == 0 && DW % 16 == 0 && DO % 8 == 0 && BK % 16 == 0,
                "tile does not fit the mma shapes");

  static constexpr size_t smem_bytes() {
    return sizeof(bf16) * (size_t(BQ) * SS + 2 * size_t(kStages) * BK * SS) +
           (WC > 1 ? sizeof(float) * size_t(kWarps) * XCH : 0);
  }
};

template <int D, int WR, int WC, int BK, int MINB, bool LSE, bool EXACT>
__global__ void __launch_bounds__(32 * WR * WC, MINB)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ lse, Strides qs, Strides ks,
                    Strides vs, Strides os, int heads, int sq, int sk, float qscale,
                    int anchor) {
  using C = TcTile<D, WR, WC, BK, MINB>;
  constexpr int BQ = C::BQ, DK = C::DK, DW = C::DW, DO = C::DO, SS = C::SS, NT = C::NT,
                NO = C::NO, CH = C::CH, XCH = C::XCH, NTH = C::kThreadsTc;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);              // [BQ][SS]
  bf16* k_s = q_s + BQ * SS;                                   // [kStages][BK][SS]
  bf16* v_s = k_s + kStages * BK * SS;                         // [kStages][BK][SS]
  float* x_s = reinterpret_cast<float*>(v_s + kStages * BK * SS);  // [warps][XCH] (WC > 1)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp / WC, wc = warp % WC;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' row group and column pair
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int b = bh / heads, h = bh - b * heads;
  const bf16* qg = q + b * qs.batch + h * qs.head;
  const bf16* kg = k + b * ks.batch + h * ks.head;
  const bf16* vg = v + b * vs.batch + h * vs.head;

  // q * scale rounded to bf16 (the scale itself rounded first), as the TPU
  // kernel scales q; rows past Sq and the contraction's pad columns are 0
  const float qsc = __bfloat162float(__float2bfloat16(qscale));
  for (int e = tid; e < BQ * (DK / 8); e += NTH) {
    const int r = e / (DK / 8), c = e - r * (DK / 8);
    uint4 x = make_uint4(0, 0, 0, 0);
    if (q0 + r < sq && c < CH) {
      x = *reinterpret_cast<const uint4*>(qg + (q0 + r) * qs.row + c * 8);
      bf16* xe = reinterpret_cast<bf16*>(&x);
#pragma unroll
      for (int i = 0; i < 8; ++i) xe[i] = __float2bfloat16(__bfloat162float(xe[i]) * qsc);
    }
    *reinterpret_cast<uint4*>(q_s + r * SS + c * 8) = x;
  }
  // the pad columns D .. DK of every K (and V) row of the ring: never copied
  // into, so zeroed once
  if constexpr (DK > D) {
    for (int e = tid; e < 2 * kStages * BK * ((DK - D) / 8); e += NTH) {
      const int r = e / ((DK - D) / 8), c = e - r * ((DK - D) / 8);
      *reinterpret_cast<uint4*>(k_s + r * SS + D + c * 8) = make_uint4(0, 0, 0, 0);
    }
  }

  // K rows k0 .. k0 + BK (and V's) into ring stage `stage`; rows at or past
  // `end` are zero-filled
  auto load_tile = [&](int k0, int stage, int end, bool with_v) {
    bf16* kd = k_s + stage * BK * SS;
    bf16* vd = v_s + stage * BK * SS;
    for (int e = tid; e < BK * CH; e += NTH) {
      const int r = e / CH, c = e - r * CH;
      const bool ok = k0 + r < end;
      const int row = ok ? k0 + r : 0;
      cp_async_16(smem_u32(kd + r * SS + c * 8), kg + row * ks.row + c * 8, ok);
      if (with_v) cp_async_16(smem_u32(vd + r * SS + c * 8), vg + row * vs.row + c * 8, ok);
    }
    cp_async_commit();
  };
  // body(k0, stage) for every key tile of 0 .. end, tile j + 1 in flight
  // while tile j is computed
  auto tile_loop = [&](int end, bool with_v, auto&& body) {
    const int n = (end + BK - 1) / BK;
    load_tile(0, 0, end, with_v);
    for (int j = 0; j < n; ++j) {
      if (j + 1 < n) {
        load_tile((j + 1) * BK, (j + 1) % kStages, end, with_v);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // tile j (and, at j = 0, q_s and the pad columns) visible
      body(j * BK, j % kStages);
      __syncthreads();  // tile j's stage is free for tile j + 2
    }
  };

  // this warp's A fragments of q: rows wr*16 .., its share of the contraction
  unsigned qf[DW / 16][4];
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < DW / 16; ++kk)
    ldsm_x4(smem_u32(q_s + (wr * 16 + (lane & 15)) * SS + wc * DW + kk * 16 + (lane >> 4) * 8),
            qf[kk]);

  // scores (base 2) of the warp's 16 rows against the tile in `stage`:
  // s[j][e] is row g + 8 * (e >> 1), key j * 8 + 2 * t + (e & 1).  With
  // WC > 1 the row group's partial sums are added in warp order, so every
  // warp of the group holds the same scores.
  auto scores = [&](int stage, float (&s)[NT][4]) {
    const bf16* kt = k_s + stage * BK * SS;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DW / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        unsigned kf[4];
        ldsm_x4(smem_u32(kt + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * SS + wc * DW +
                         kk * 16 + ((lane >> 3) & 1) * 8),
                kf);
        mma_bf16(s[2 * jp], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], kf[2], kf[3]);
      }
    }
    if constexpr (WC > 1) {
      float* mine = x_s + warp * XCH;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(j * 4 + e) * 32 + lane] = s[j][e];
      __syncthreads();
      const float* group = x_s + wr * WC * XCH;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sum = 0.f;
#pragma unroll
          for (int c = 0; c < WC; ++c) sum += group[c * XCH + (j * 4 + e) * 32 + lane];
          s[j][e] = sum;
        }
    }
  };

  // what each row's scores are shifted by before exp2: bounded, the anchor
  // window's max + 16 (the prologue); exact, the running max
  float shift[2] = {EXACT ? kNegInf : -CUDART_INF_F, EXACT ? kNegInf : -CUDART_INF_F};
  if constexpr (!EXACT) {
    // prologue: each row's max over its anchor window
    const int a_end = anchor < sk ? anchor : sk;
    tile_loop(a_end, false, [&](int k0, int stage) {
      float s[NT][4];
      scores(stage, s);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + j * 8 + 2 * t + (e & 1) < a_end) shift[e >> 1] = fmaxf(shift[e >> 1], s[j][e]);
    });
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      shift[r] = fmaxf(shift[r], __shfl_xor_sync(0xffffffffu, shift[r], 1));
      shift[r] = fmaxf(shift[r], __shfl_xor_sync(0xffffffffu, shift[r], 2));
      shift[r] += kShiftMargin;  // key 0 is in the window (sk, anchor >= 1): finite
    }
  }

  float o[NO][4], l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  tile_loop(sk, true, [&](int k0, int stage) {
    float s[NT][4];
    scores(stage, s);
    const bf16* vt = v_s + stage * BK * SS;
    const bool ragged = k0 + BK > sk;  // only the last tile masks keys
    if constexpr (EXACT) {
      // the running max over this tile; keys past Sk (zero-filled rows, score
      // 0) out of it, and exp2(-1e30 - m) = 0 adds nothing to the sums
      float mx[2] = {shift[0], shift[1]};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (ragged && k0 + j * 8 + 2 * t + (e & 1) >= sk) s[j][e] = kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
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
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // p of keys kk*16 .. kk*16 + 16 in bf16: the A fragment of the PV product
      unsigned a[4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = 2 * kk + hh;
        const int key = k0 + j * 8 + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float p0, p1;
          if constexpr (EXACT) {
            p0 = exp2f(s[j][2 * r] - shift[r]);
            p1 = exp2f(s[j][2 * r + 1] - shift[r]);
          } else {
            p0 = exp2f(fminf(s[j][2 * r] - shift[r], kSaturate));
            p1 = exp2f(fminf(s[j][2 * r + 1] - shift[r], kSaturate));
            if (ragged) {  // keys past Sk (zero-filled rows) add 0
              p0 = key < sk ? p0 : 0.f;
              p1 = key + 1 < sk ? p1 : 0.f;
            }
          }
          const __nv_bfloat162 pb = __floats2bfloat162_rn(p0, p1);
          l[r] += __low2float(pb) + __high2float(pb);
          a[hh * 2 + r] = *reinterpret_cast<const unsigned*>(&pb);
        }
      }
      const int vrow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        unsigned vf[4];
        ldsm_x4_t(smem_u32(vt + vrow * SS + wc * DO + np * 16 + (lane >> 4) * 8), vf);
        mma_bf16(o[2 * np], a, vf[0], vf[1]);
        mma_bf16(o[2 * np + 1], a, vf[2], vf[3]);
      }
      if constexpr (NO % 2 == 1) {
        unsigned vf[2];
        ldsm_x2_t(smem_u32(vt + vrow * SS + wc * DO + (NO - 1) * 8), vf);
        mma_bf16(o[NO - 1], a, vf[0], vf[1]);
      }
    }
  });

  bf16* og = out + b * os.batch + h * os.head;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    // exact: the row's max key added p = 1, so no floor
    const float den = EXACT ? l[r] : fmaxf(l[r], kDenomFloor);
    const int row = q0 + wr * 16 + g + 8 * r;
    if (row >= sq) continue;
    // every lane of the quad holds the row's sum; the warps of a row group
    // hold the same shift and sum
    if (LSE && t == 0 && wc == 0) lse[size_t(bh) * sq + row] = shift[r] + log2f(den);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(og + row * os.row + wc * DO + n * 8 + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * r] / den, o[n][2 * r + 1] / den);
    }
  }
}

template <int D, int WR, int WC, int BK, int MINB, bool LSE = false, bool EXACT = false>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, float* lse,
                      const Layout& lay, int sq, int sk, int anchor, cudaStream_t stream) {
  using C = TcTile<D, WR, WC, BK, MINB>;
  auto kernel = flash_fwd_tc_kernel<D, WR, WC, BK, MINB, LSE, EXACT>;
  const int smem = int(C::smem_bytes());
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + C::BQ - 1) / C::BQ, lay.bh);
  // JAX's constant, (1 / sqrt(d)) * log2(e) in double, then rounded
  const float qscale = float(1.0 / sqrt(double(D)) * 1.4426950408889634);
  kernel<<<grid, C::kThreadsTc, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, lay.q, lay.k, lay.v, lay.out, lay.heads, sq, sk, qscale,
      anchor);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

bool strides_of_8(const Strides& s) { return s.batch % 8 == 0 && s.head % 8 == 0 && s.row % 8 == 0; }

bool takes(const void* q, const void* k, const void* v, void* out, const Layout& lay, int sq,
           int sk, int anchor, int dtype) {
  if (dtype != 1 || lay.bh < 1 || lay.bh > 65535 || sq < 1 || sk < 1 || anchor < 1) return false;
  if (!rows_fit(lay, sq, sk)) return false;
  // cp.async and the q loads move 16 bytes
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out)) return false;
  return strides_of_8(lay.q) && strides_of_8(lay.k) && strides_of_8(lay.v) &&
         strides_of_8(lay.out);
}

int forward_tc(const void* q, const void* k, const void* v, void* out, const Layout& lay, int sq,
               int sk, int d, int anchor, int dtype, void* stream) {
  if (!takes(q, k, v, out, lay, sq, sk, anchor, dtype)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 40:
      return int(launch_tc<40, 4, 1, 64, 5>(q, k, v, out, nullptr, lay, sq, sk, anchor, s));
    case 80:
      return int(launch_tc<80, 8, 1, 64, 2>(q, k, v, out, nullptr, lay, sq, sk, anchor, s));
    case 512:
      return int(launch_tc<512, 2, 4, 32, 1>(q, k, v, out, nullptr, lay, sq, sk, anchor, s));
    default: return -1;
  }
}

// Row 3's tiles, chosen at the NMG gradient call's one-image grids by
// probes/flash_lse_tiles.py (which rewrites these lines to time others): at
// [1, 8, 1024, 80] 64-row blocks (128 blocks on 132 SMs) beat the packed
// forward's 128-row ones (64 blocks) by a fifth; at [1, 8, 4096, 40] 32-row
// blocks took twice as long as 64-row ones.
int forward_lse_tc(const void* q, const void* k, const void* v, void* out, float* lse,
                   const Layout& lay, int sq, int sk, int d, int anchor, int dtype, void* stream) {
  if (lse == nullptr || !takes(q, k, v, out, lay, sq, sk, anchor, dtype)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 40:
      return int(launch_tc<40, 4, 1, 64, 5, true>(q, k, v, out, lse, lay, sq, sk, anchor, s));
    case 80:
      return int(launch_tc<80, 4, 1, 64, 3, true>(q, k, v, out, lse, lay, sq, sk, anchor, s));
    case 512:
      return int(launch_tc<512, 2, 4, 32, 1, true>(q, k, v, out, lse, lay, sq, sk, anchor, s));
    default: return -1;
  }
}

// Rows 6 and 7: the exact mode at the bounded forward's tiles, whose key
// tiles (64, 32 at d = 512) are exact_key_tile(D) (the head of this file).
// probes/flash_exact_tiles.py rewrites the d = 40 and 80 lines to time other
// tiles; none was faster.  At d = 40 the 5-block budget (96 registers)
// spills 20 bytes; 4 blocks an SM, without the spill, took as long.  The
// exact mode reads no anchor; takes() is asked with 1.
int forward_exact_tc(const void* q, const void* k, const void* v, void* out, const Layout& lay,
                     int sq, int sk, int d, int dtype, void* stream) {
  if (!takes(q, k, v, out, lay, sq, sk, 1, dtype)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 40:
      return int(launch_tc<40, 4, 1, 64, 5, false, true>(q, k, v, out, nullptr, lay, sq, sk, 1, s));
    case 80:
      return int(launch_tc<80, 8, 1, 64, 2, false, true>(q, k, v, out, nullptr, lay, sq, sk, 1, s));
    case 512:
      return int(launch_tc<512, 2, 4, 32, 1, false, true>(q, k, v, out, nullptr, lay, sq, sk, 1,
                                                          s));
    default: return -1;
  }
}

}  // namespace

// Plain C entry points for ctypes, arguments as flash_attention.cu's bounded
// ones; dtype must be 1 (bfloat16).  Each returns 0 on success, a
// cudaError_t code from the launch, or -1 for arguments the kernel does not
// take.

// Row 1 in bf16: the bounded forward, head-split.
extern "C" int hedit_flash_attention_fwd_tc(const void* q, const void* k, const void* v,
                                            void* out, int bh, int sq, int sk, int d,
                                            int anchor, int dtype, void* stream) {
  return forward_tc(q, k, v, out, head_split(bh, sq, sk, d), sq, sk, d, anchor, dtype, stream);
}

// Row 3 in bf16: the bounded forward, head-split, also writing lse2 [BH, Sq]
// float32; arguments as flash_attention.cu's hedit_flash_attention_fwd_lse.
extern "C" int hedit_flash_attention_fwd_lse_tc(const void* q, const void* k, const void* v,
                                                void* out, void* lse, int bh, int sq, int sk,
                                                int d, int anchor, int dtype, void* stream) {
  return forward_lse_tc(q, k, v, out, static_cast<float*>(lse), head_split(bh, sq, sk, d), sq,
                        sk, d, anchor, dtype, stream);
}

// Row 1 in bf16 on packed heads.
extern "C" int hedit_flash_attention_fwd_packed_bounded_tc(
    const void* q, const void* k, const void* v, void* out, int b, int h, int sq, int sk, int d,
    int anchor, long long q_bs, long long k_bs, long long v_bs, int dtype, void* stream) {
  Layout lay;
  if (!packed_layout(b, h, sq, sk, d, q_bs, k_bs, v_bs, &lay)) return -1;
  return forward_tc(q, k, v, out, lay, sq, sk, d, anchor, dtype, stream);
}

// Row 6 in bf16: the exact forward, head-split; arguments as flash_attention.cu's
// hedit_flash_attention_fwd_exact.
extern "C" int hedit_flash_attention_fwd_exact_tc(const void* q, const void* k, const void* v,
                                                  void* out, int bh, int sq, int sk, int d,
                                                  int dtype, void* stream) {
  return forward_exact_tc(q, k, v, out, head_split(bh, sq, sk, d), sq, sk, d, dtype, stream);
}

// Row 7 in bf16: the exact forward on packed heads; arguments as
// flash_attention.cu's hedit_flash_attention_fwd_packed.
extern "C" int hedit_flash_attention_fwd_packed_exact_tc(
    const void* q, const void* k, const void* v, void* out, int b, int h, int sq, int sk, int d,
    long long q_bs, long long k_bs, long long v_bs, int dtype, void* stream) {
  Layout lay;
  if (!packed_layout(b, h, sq, sk, d, q_bs, k_bs, v_bs, &lay)) return -1;
  return forward_exact_tc(q, k, v, out, lay, sq, sk, d, dtype, stream);
}
