// Flash-attention forwards for Hopper (sm_90a) on the CUDA cores, as two
// kernels (wrappers in ops/flash_probes.py):
//
// The query-major kernel, flash_qm_kernel (described before it), entry
// points hedit_flash_variant, hedit_flash_packed_t, hedit_flash_ablate_t and
// hedit_flash_exp2_t:
//   rows 9 a, b, float32 d: scripts/flash_variants.py
//     kern_a (:31)           [Sq, D] output           flash_variant_a_cuda
//     kern_a, pv_bf16 (:45)  p rounded to bf16 for PV  flash_variant_a_cuda(pv_bf16=True)
//     kern_b (:61)           [D, Sq] output           flash_variant_b_cuda
//   row 11 in float32: scripts/flash_nhd_variants.py, the bounded forward
//   with the transposed output [BH, D, Sq], in three load layouts
//     _packed_t_kernel (:93)              q, k, v [BH, S, D]       flash_packed_t_cuda
//     _packed_t_kernel_sminor (:101)      q, k [BH, D, S]; v [BH, S, D]
//                                                                  flash_packed_t_sminor_cuda
//     _packed_t_kernel_all_sminor (:136)  q, k, v [BH, D, S]       flash_packed_t_all_sminor_cuda
//   row 8 in float32: scripts/flash_ablate.py:34 make_kernel(mode), the
//   bounded loop cut down to measure its floor   flash_ablate_t_cuda
//   row 10 in float32: scripts/flash_v4_variants.py:34 kern_exp2, the exact
//   forward with exp2 and the [BH, D, Sq] output, in its plain and its
//   software-pipelined key loop                  flash_exp2_t_cuda
// The key-major kernel, row 9 c: kern_c (:87), key-major scores, [D, Sq]
// output, flash_variant_c_cuda (entry point hedit_flash_variant_c:
// flash_variant_c_kernel).
//
// Row 9's function is the TPU kernels': q upcast and times sm_scale =
// 1/sqrt(D) in float32 (NOT rounded to the input dtype), k and v upcast,
// float32 scores, a running max m starting at -1e30, p = exp(s - m_new),
// alpha = exp(m_old - m_new), l = l * alpha + sum(p) and out = acc / l
// rounded once to the input dtype.  With pv_bf16 the PV product takes p
// rounded to bfloat16 (with float32 inputs JAX promotes the product to
// float32, so only p is rounded); the row sum still takes the unrounded p.
// The running max moves once a 64-key tile (the TPU kernels' BLK_K is 512):
// without pv_bf16 that moves the output by float32 rounding only, with it p
// is rounded against another point.  kern_a with pv_bf16 in bf16 runs on the
// tensor cores (hedit_flash_variant_tc in flash_probes_tc.cu).
//
// Row 11's function (float32; bf16 runs on the tensor cores,
// hedit_flash_packed_t_tc): q times c = float(sm_scale * log2(e)), rounded
// before the product; float32 scores; each row's shift is the max of its
// scores over the first `anchor` keys (the TPU kernel's blk_k) plus 16;
// p = exp2(min(s - shift, 100)) (the TPU kernel's cast of p to the input
// dtype is the identity in float32); the row sum floored at 1.2e-38; out =
// acc / sum.  Row 8's (float32; bf16: hedit_flash_ablate_t_tc): q NOT
// scaled, no shift but a constant, p = s (dots), exp2(s) (exp) or
// exp2(min(s - 12.34, 100)) (noprolog), the sum floored at 1e-30.  In `dots`
// the sum of p can be negative or near zero; the floor then makes the
// output acc * 1e30, as on the TPU.  Row 10's (float32; bf16:
// hedit_flash_exp2_t_tc): q times c = float(sm_scale * log2(e)) rounded
// before the product, as row 11's; a running max m from -1e30 moved once a
// key tile, p = exp2(s - m_new), alpha = exp2(m_old - m_new), l = l * alpha
// + sum(p) (the TPU kernel's ones column of v_aug), out = acc / l with no
// floor.  The key tile decides only where p is rounded: 64 keys at d = 40,
// 32 at d = 80 (flash_probes.py:exp2_key_tile).
//
// What bounds them: QK and PV, each 2 BH Sq Sk D FLOP; PV in float32 FMAs at
// 67 TFLOP/s (0.641 ms at row 9's [32, 4096, 40]); QK of bf16 inputs on the
// tensor cores at 989 (0.043 ms), of float32 inputs in FMAs at 67 (then both
// products: 0.320 ms at [8, 4096, 40], 0.641 at row 11's [16, 4096, 40]); the
// bytes are ~6 us.  So both kernels keep the CUDA cores busy with PV FMAs
// from register tiles, and take the scores' product on the tensor cores
// where the inputs are bf16 (the products of two bf16 values are exact in
// float32).
//
// Contract: each (batch, head) image of an operand a dense [S, D] or (rows
// 11b, 11c) [D, S], one dtype (float32, or bfloat16 for 9 a, b, c), every
// operand 16-byte aligned; D = 40 (row 9) or 40 and 80 (rows 8, 10, 11); Sq and
// Sk multiples of 64 (the TPU grids cover whole blocks; nothing is masked
// but the queries past Sq of a last block); row 11's anchor a multiple of 64
// that divides Sk.  A block takes 128 queries (64 at d = 80): the last
// block of an image may hold 64 queries past Sq, read as zeros and never
// stored.

#include <climits>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

constexpr int BLOCK_Q = 128;          // queries a block (4 warps) at d = 40
constexpr int TILE_K = 64;            // keys a tile at d = 40
constexpr int HEAD_D = 40;            // row 9's head dim
constexpr int DK16 = 48;              // bf16, row 9 c: the contraction padded to three k16 steps
constexpr int ROW_BF = DK16 + 8;      // bf16 q and K rows, [.][ROW_BF] (conflict-free ldmatrix)
constexpr int ROW_F32 = HEAD_D + 4;   // float32 q and K rows at d = 40, [.][ROW_F32]
constexpr float kNegInf = -1e30f;     // the TPU kernels' initial running max
constexpr float kShiftMargin = 16.f;  // row 11: shift = the window's max + 16
constexpr float kSaturate = 100.f;    // rows 8, 11: p = exp2(min(., 100))
constexpr float kDenomFloor = 1.2e-38f;  // row 11's floor of the row sum
constexpr float kAblateFloor = 1e-30f;   // row 8's (flash_ablate.py)
constexpr float kAblateShift = 12.34f;   // noprolog's constant shift (flash_ablate.py)

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// ---------------------------------------------------------------------------
// The query-major kernel: rows 9 a and 9 b, kern_a (with pv_bf16 in
// float32) and kern_b (scripts/flash_variants.py:31, 61), rows 11a-c, 8 and
// 10 in float32, redesigned for the H100 as one kernel.  They reduce along the
// query's row, which is the row of the mma.sync C fragment: the four lanes of
// a quad hold it.  So each warp keeps its queries' softmax to itself:
// - at d = 40 a block of 4 warps takes 128 queries, warp w the 32 rows w*32
//   .. + 32 (two m16 row tiles) against every key of a 64-key tile; at d = 80
//   64 queries, 16 rows a warp, against 32-key tiles (QmTile).  K and V come
//   in through a two-stage cp.async ring as [key][d] tiles: a row-major
//   [S, D] operand by 16-byte copies, an S-minor [D, S] one transposed on
//   its way by 4-byte copies, a warp's copy 8 keys x 4 d rows (32
//   contiguous bytes of each row, 32 banks).  So every layout runs the
//   same loop; an S-minor q is transposed once, as it is loaded;
// - QK, query-major.  bf16 (rows 9 a, b): mma.sync with d = 40 as two
//   m16n8k16 steps and one m16n8k8 step (no padded products); Q is the A
//   operand, loaded once by ldmatrix, and its fragments stay in registers
//   across the key loop; K's [key][d] tile is the B operand by ldmatrix.
//   float32: the same fragment elements by FMAs from [query][d] and
//   [key][d] tiles, 4 d a 16-byte load (one d step costs 5 loads for 64
//   FMAs at d = 40), d in order.  Either way a thread holds rows g, g + 8
//   (, g + 16, g + 24) of its warp's rows against keys j*8 + 2t, j*8 + 2t +
//   1 (g = lane / 4, t = lane % 4);
// - the softmax along the row inside the warp: each row's max and sum over
//   the thread's keys, then 2 __shfl_xor_sync across the quad; no shared
//   memory, no block barrier.  Row 11's shift needs the max over its anchor
//   window first: the window's tiles take an online shift, a running max m
//   with p = exp2(s - (m + 16)) and alpha = exp2(m_old - m_new) rescaling
//   the sum and the accumulator, as the exact rows do; no window score
//   exceeds the window's max, so min(., 100) never clamps there, and after
//   the window the shift is frozen and keys take the clamp (the same
//   function up to float32 rounding);
// - p is warp-private: the warp writes it as float32 into its own region,
//   [key][rows + 4] (conflict-free fragment stores, 16-byte loads of 4
//   queries), rounded to bf16 for pv_bf16; alpha and, at the end, l go
//   through a region of the warp to the PV layout; __syncwarp separates the
//   softmax from PV;
// - PV on the CUDA cores in float32: each warp its own rows x D, 8 queries
//   (qx*8 .. + 8) x 5 d rows (dy*4 .. + 4 and 4 NDY + dy) a thread (d = 40:
//   4 x 8 lanes; d = 80: 2 x 16); each key costs two 16-byte loads of p, a
//   16-byte and a 4-byte broadcast load of v, and 40 FMAs;
// - each thread waits for its own copies of a tile (and, bf16, converts its
//   own V chunks into the float32 V tile); one __syncthreads makes the tile
//   visible, and the next tile's copies are issued after it, into the stage
//   every warp has left.  float32 reads V from the ring: one barrier a
//   tile; at d = 40 ~100 KB of shared memory and up to 255 registers, 2
//   blocks an SM; at d = 80 ~75 KB and at most 168, 3 blocks an SM.  bf16
//   keeps one float32 V tile and lays q (read once, into registers) over the
//   p regions: a second barrier a tile (before the next conversion), 70 KB
//   and at most 168 registers, 3 blocks an SM;
// - row 10's pipelined loop (kern_exp2's pipe) takes tile t's scores before
//   tile t - 1's softmax and PV, into a second score array (64 floats a
//   thread at d = 40, 16 at d = 80), with the same code in the same order
//   for each tile as the plain loop, so its output is the plain loop's bit
//   for bit.  It needs no third ring stage: K is copied a tile ahead of V.
//   Iteration t issues K(t + 1) into the slot K(t - 1) left (QK(t - 1) is
//   done) and V(t) into the slot V(t - 2) left (PV(t - 2) is done), behind
//   the one barrier a tile, so the shared memory is the plain loop's;
// - the epilogue: the transposed rows (9 b, 11, 8, 10) store 8-query runs of
//   each of a thread's 5 d rows straight to [BH, D, Sq]; 9 a stages its
//   warp's [32][40] tile over the warp's p region and writes the warp's
//   1,280 contiguous outputs of [BH, Sq, D] as 16-byte vectors.  Both divide
//   the same acc by the same l, so a's output is b's transposed, bit for
//   bit; each output has one writer, so every launch gives the same bits.
// The scale: a and b (either dtype) take it after the product with log2(e)
// folded in, s2 = s c with c = sm_scale log2(e) rounded to float32, the
// running max of s2 and p = 2^(fma(s, c, -m2)) by ex2.approx.ftz (a p below
// 2^-126 is 0), as row 9 c does (with bf16 inputs the tensor cores must see
// q unscaled to keep the products exact).  kern_a with pv_bf16 (float32
// only) keeps the template's order instead: q times sm_scale before an
// in-order FMA chain over d and p = expf(s - m), so that p, rounded to
// bf16, lands where the plain version's does.  Row 11 takes q times c as
// it is loaded (its function rounds q c first), row 10 likewise with p =
// 2^(s - m) after it, row 8 q as it is; all three take their exp2 by
// ex2.approx.ftz.

enum class QmVariant {
  A, ABf16PV, B,                             // row 9: kern_a, kern_a with pv_bf16, kern_b
  Bounded, BoundedSMinor, BoundedAllSMinor,  // row 11: layouts 0, 1, 2
  Dots, Exp, NoProlog,                       // row 8's modes
  Exp2, Exp2Pipe                             // row 10: the plain and the pipelined loop
};

template <QmVariant V>
struct QmTraits {
  static constexpr bool natural = V == QmVariant::ABf16PV;
  static constexpr bool exp2_q = V == QmVariant::Exp2 || V == QmVariant::Exp2Pipe;  // row 10
  static constexpr bool pipe = V == QmVariant::Exp2Pipe;
  static constexpr bool exact = V == QmVariant::A || V == QmVariant::B || natural || exp2_q;
  static constexpr bool bounded = V == QmVariant::Bounded || V == QmVariant::BoundedSMinor ||
                                  V == QmVariant::BoundedAllSMinor;
  static constexpr bool qk_sminor = V == QmVariant::BoundedSMinor ||
                                    V == QmVariant::BoundedAllSMinor;
  static constexpr bool v_sminor = V == QmVariant::BoundedAllSMinor;
  static constexpr bool rows_out = V == QmVariant::A || natural;  // [BH, Sq, D]; else [BH, D, Sq]
  static constexpr bool scale_q = natural || bounded || exp2_q;   // q times scale as it is loaded
  static constexpr bool scale_after = exact && !scale_q;          // a, b: s times scale
  static constexpr float floor = bounded ? kDenomFloor : exact ? 0.f : kAblateFloor;
};

// The tiles at head dim D: d = 80 halves the rows a warp and the keys a
// tile, so that its q, K and V tiles fit 3 blocks an SM, and keeps d = 40's
// 8 x 5 PV tile a thread.
template <int D>
struct QmTile {
  static_assert(D == 40 || D == 80, "d = 40 or 80");
  static constexpr int WR = D == 40 ? 32 : 16;   // query rows a warp
  static constexpr int BQ = 4 * WR;              // queries a block
  static constexpr int TK = D == 40 ? 64 : 32;   // keys a tile
  static constexpr int NI = WR / 16;             // m16 row tiles a warp
  static constexpr int NJ = TK / 8;              // 8-key n-tiles a tile
  static constexpr int NDY = D / 5;              // PV: lanes along d, 5 d rows each
  static constexpr int QX = 32 / NDY;            // PV: lanes along the rows, 8 queries each
  static constexpr int ROW = D + 4;              // float32 q and K rows, [.][ROW]
  static constexpr int PS = WR + 4;              // a warp's p [TK][PS]
  static constexpr int MIN_BLOCKS = D == 40 ? 2 : 3;  // float32 blocks an SM
  static_assert(QX * 8 == WR && NDY * 5 == D && kThreads == 4 * 32, "8 x 5 PV tiles");
};
static_assert(QmTile<HEAD_D>::BQ == BLOCK_Q && QmTile<HEAD_D>::TK == TILE_K &&
              QmTile<HEAD_D>::ROW == ROW_F32, "row 9 c's tiles are d = 40's");

template <typename T, QmVariant V, int D>
struct QmSmem {
  using Tl = QmTile<D>;
  using Tr = QmTraits<V>;
  static constexpr bool bf = sizeof(T) == 2;
  // bytes of each region, in order: float32 q; the K ring; the V ring (as
  // the input type; an S-minor V's rows padded as K's); the float32 V tile
  // (bf16 only); each warp's p; each warp's row statistics (alpha, at the
  // end l).  bf16 q lies over the p
  // regions: it is read once, into registers, before the first softmax.
  static constexpr size_t q = bf ? 0 : 4 * Tl::BQ * Tl::ROW;
  static constexpr size_t k_stage = bf ? 2 * Tl::TK * ROW_BF : 4 * Tl::TK * Tl::ROW;
  static constexpr size_t v_stage = sizeof(T) * Tl::TK * (Tr::v_sminor ? Tl::ROW : D);
  static constexpr size_t v32 = bf ? 4 * Tl::TK * D : 0;
  static constexpr size_t p_warp = 4 * Tl::TK * Tl::PS;
  static constexpr size_t rows_warp = 4 * Tl::WR;
  static constexpr size_t bytes = q + 2 * k_stage + 2 * v_stage + v32 + 4 * (p_warp + rows_warp);
  static_assert(q % 16 == 0 && k_stage % 16 == 0 && v_stage % 16 == 0 && v32 % 16 == 0 &&
                p_warp % 16 == 0, "16-byte aligned regions");
  static_assert(!Tr::rows_out || p_warp >= 4 * Tl::WR * D,
                "a's output tile fits a warp's p region");
  static_assert(!bf || 4 * p_warp >= 2 * Tl::BQ * ROW_BF, "bf16 q fits the p regions");
};

__device__ __forceinline__ float ex2_ftz(float x) {  // 2^x, results below 2^-126 flushed to 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, QmVariant V, int D>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 3 : QmTile<D>::MIN_BLOCKS)
flash_qm_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ out, int sq, int sk, float scale, int anchor) {
  using Sm = QmSmem<T, V, D>;
  using Tl = QmTile<D>;
  using Tr = QmTraits<V>;
  constexpr bool BF = Sm::bf;
  constexpr int WR = Tl::WR, TK = Tl::TK, NI = Tl::NI, NJ = Tl::NJ, ROW = Tl::ROW, PS = Tl::PS;
  constexpr int VROW = Tr::v_sminor ? ROW : D;  // the V tile's rows
  // pv_bf16: q times sm_scale (= scale) on load and p = expf(s - m); a, b: s
  // times c (= scale) and p = 2^(s c - m); rows 10, 11: q times c (= scale)
  // on load
  constexpr bool NATURAL = Tr::natural;
  static_assert(!BF || (D == HEAD_D && (V == QmVariant::A || V == QmVariant::B)),
                "bf16: rows 9 a and b (pv_bf16 runs on the tensor cores, flash_probes_tc.cu)");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* k_raw = smem_raw + Sm::q;
  unsigned char* v_raw = k_raw + 2 * Sm::k_stage;
  float* v32_s = reinterpret_cast<float*>(v_raw + 2 * Sm::v_stage);  // bf16: [TK][D]
  float* p_base = reinterpret_cast<float*>(v_raw + 2 * Sm::v_stage + Sm::v32);
  unsigned char* q_raw = BF ? reinterpret_cast<unsigned char*>(p_base) : smem_raw;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;                 // the fragments' row group, key pair
  const int qx = lane % Tl::QX, dy = lane / Tl::QX;      // PV: queries qx*8 .. + 8, 5 d rows
  float* p_w = p_base + warp * (TK * PS);                // this warp's p [key][PS]
  float* rows_w = p_base + 4 * (TK * PS) + warp * WR;    // this warp's alpha, then l
  const int bh = blockIdx.y, q0 = blockIdx.x * Tl::BQ;
  const T* qg = q + size_t(bh) * sq * D;
  const T* kg = k + size_t(bh) * sk * D;
  const T* vg = v + size_t(bh) * sk * D;
  constexpr int CH = D * int(sizeof(T)) / 16;  // 16-byte chunks of an [S, D] row
  const int nk = sk / TK;

  // q, once, [query][d]: bf16 as it lies (the scale follows the product),
  // float32 times the scale where the function scales it first, an S-minor
  // q transposed.  Queries past Sq are zero.
  if constexpr (BF) {
    __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(q_raw);
    for (int e = tid; e < Tl::BQ * CH; e += kThreads) {
      const int r = e / CH, c = e - r * CH;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (q0 + r < sq) x = *reinterpret_cast<const uint4*>(qg + (q0 + r) * D + c * 8);
      *reinterpret_cast<uint4*>(q_s + r * ROW_BF + c * 8) = x;
    }
  } else if constexpr (Tr::qk_sminor) {
    float* q_s = reinterpret_cast<float*>(q_raw);
    constexpr int RUNS = Tl::BQ / 4;  // 16-byte runs of a d row's queries
    for (int e = tid; e < D * RUNS; e += kThreads) {
      const int c = e / RUNS, r = (e - c * RUNS) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);  // past Sq: the next d row, not read
      if (q0 + r < sq) x = *reinterpret_cast<const float4*>(qg + c * sq + q0 + r);
      q_s[r * ROW + c] = x.x * scale;
      q_s[(r + 1) * ROW + c] = x.y * scale;
      q_s[(r + 2) * ROW + c] = x.z * scale;
      q_s[(r + 3) * ROW + c] = x.w * scale;
    }
  } else {
    float* q_s = reinterpret_cast<float*>(q_raw);
    for (int e = tid; e < Tl::BQ * CH; e += kThreads) {
      const int r = e / CH, c = e - r * CH;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < sq) x = *reinterpret_cast<const float4*>(qg + (q0 + r) * D + c * 4);
      if constexpr (Tr::scale_q)
        x = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
      *reinterpret_cast<float4*>(q_s + r * ROW + c * 4) = x;
    }
  }

  // an S-minor [D, S] operand's keys k0 .. k0 + TK into a [key][ROW] tile,
  // transposed by 4-byte copies: a warp's copy is 8 keys x 4 d rows (32
  // contiguous bytes of each row; 32 banks), warp w takes the 8-key blocks
  // w, w + 4, ...
  auto load_sminor = [&](unsigned char* dst, const T* img, int k0) {
    for (int kb = warp; kb < TK / 8; kb += 4) {
      const int key = kb * 8 + (lane & 7), c0 = lane >> 3;
      const T* src = img + c0 * sk + k0 + key;
      unsigned char* row = dst + (key * ROW + c0) * 4;
#pragma unroll
      for (int c = 0; c < D; c += 4) cp_async_4(smem_u32(row + c * 4), src + c * sk, true);
    }
  };
  // keys kk0 .. kk0 + TK of K into ring stage ks and keys vk0 .. vk0 + TK
  // of V into stage vs (either left out where its first key is negative),
  // as [key][d], one commit group: a row-major operand 16 bytes a copy,
  // thread tid copying chunks tid, tid + 128, ... (bf16: the V chunks it
  // converts); an S-minor one by load_sminor
  auto load_kv = [&](int kk0, int ks, int vk0, int vs) {
    unsigned char* kd = k_raw + ks * Sm::k_stage;
    unsigned char* vd = v_raw + vs * Sm::v_stage;
    if constexpr (Tr::qk_sminor) {
      if (kk0 >= 0) load_sminor(kd, kg, kk0);
    }
    if constexpr (Tr::v_sminor) {
      if (vk0 >= 0) load_sminor(vd, vg, vk0);
    }
    for (int e = tid; e < TK * CH; e += kThreads) {
      if constexpr (!Tr::qk_sminor) {
        constexpr int row_bytes = BF ? 2 * ROW_BF : 4 * ROW;
        const int r = e / CH, c = e - r * CH;
        if (kk0 >= 0)
          cp_async_16(smem_u32(kd + r * row_bytes + c * 16),
                      kg + (kk0 + r) * D + c * (16 / sizeof(T)), true);
      }
      if constexpr (!Tr::v_sminor) {
        if (vk0 >= 0)
          cp_async_16(smem_u32(vd + e * 16), vg + size_t(vk0) * D + e * (16 / sizeof(T)), true);
      }
    }
    cp_async_commit();
  };
  // the keys k0 .. k0 + TK of K and V into ring stage `stage`
  auto load_tile = [&](int k0, int stage) { load_kv(k0, stage, k0, stage); };
  // bf16: this thread's own V chunks of the tile in ring stage `stage`
  // (visible to it once its copies landed) into the float32 V tile
  auto convert_v = [&](int stage) {
    const __nv_bfloat16* vb = reinterpret_cast<const __nv_bfloat16*>(v_raw + stage * Sm::v_stage);
    for (int e = tid; e < TK * CH; e += kThreads) {
      const uint4 x = *reinterpret_cast<const uint4*>(vb + e * 8);
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
      const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.z));
      const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.w));
      *reinterpret_cast<float4*>(v32_s + e * 8) = make_float4(a.x, a.y, b.x, b.y);
      *reinterpret_cast<float4*>(v32_s + e * 8 + 4) = make_float4(c.x, c.y, d.x, d.y);
    }
  };

  // s[i][j][2r + e]: row warp*WR + i*16 + r*8 + g, key j*8 + 2t + e (row
  // 10's pipelined loop: the previous tile's, the next tile's in s_next)
  float s[NI][NJ][4];
  // bf16: the warp's Q fragments for the whole loop, 2 row tiles x (two k16
  // steps, d 0 .. 32, and one k8 step, d 32 .. 40)
  unsigned qa[NI][2][4], qa8[NI][2];
  // bf16, the scores of n-tiles 2jp, 2jp + 1 (16 keys) of the tile in ring
  // stage `stage`: d = 40 as 16 + 16 + 8 (no padded products), K's [key][d]
  // tile the B operand
  auto qk_bf16_pair = [&](int stage, int jp) {
    const __nv_bfloat16* kt = reinterpret_cast<const __nv_bfloat16*>(k_raw + stage * Sm::k_stage);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      unsigned b[4];
      ldsm_x4(smem_u32(kt + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * ROW_BF + kk * 16 +
                       ((lane >> 3) & 1) * 8),
              b);
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        mma_bf16(s[i][2 * jp], qa[i][kk], b[0], b[1]);
        mma_bf16(s[i][2 * jp + 1], qa[i][kk], b[2], b[3]);
      }
    }
    unsigned b8[2];
    ldsm_x2(smem_u32(kt + (jp * 16 + (lane & 15)) * ROW_BF + 32), b8);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      mma_bf16_k8(s[i][2 * jp], qa8[i][0], qa8[i][1], b8[0]);
      mma_bf16_k8(s[i][2 * jp + 1], qa8[i][0], qa8[i][1], b8[1]);
    }
  };
  auto zero_s = [&](float (&sc)[NI][NJ][4]) {
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[i][j][e] = 0.f;
  };
  // float32, the scores of the tile in ring stage `stage` into sc, by FMAs
  // from [query][d] and [key][d] tiles, 4 d a 16-byte load, d in order (the
  // template's FMA chain)
  auto qk_f32 = [&](int stage, float (&sc)[NI][NJ][4]) {
    const float* q_s = reinterpret_cast<const float*>(q_raw) + (warp * WR + g) * ROW;
    const float* kt = reinterpret_cast<const float*>(k_raw + stage * Sm::k_stage) + 2 * t * ROW;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      float4 qv[NI][2];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          qv[i][r] = *reinterpret_cast<const float4*>(q_s + (i * 16 + r * 8) * ROW + c);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 kv = *reinterpret_cast<const float4*>(kt + (j * 8 + e) * ROW + c);
#pragma unroll
          for (int i = 0; i < NI; ++i)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float& x = sc[i][j][2 * r + e];
              x = fmaf(qv[i][r].x, kv.x, x);
              x = fmaf(qv[i][r].y, kv.y, x);
              x = fmaf(qv[i][r].z, kv.z, x);
              x = fmaf(qv[i][r].w, kv.w, x);
            }
        }
    }
  };

  // row (i, r) = warp*WR + i*16 + r*8 + g: its running max (a, b: of s c;
  // pv_bf16 and row 10: of s; row 11: of s over the window) and sum, the
  // same in the 4 lanes of the quad
  float m[NI][2], l[NI][2];
  float acc[5][8];  // d rows dy*4 .. + 4, 4 NDY + dy; queries qx*8 .. + 8
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[i][r] = kNegInf;
      l[i][r] = 0.f;
    }
#pragma unroll
  for (int i = 0; i < 5; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  // the max of each of the thread's rows over its keys of the tile, then
  // over the quad
  auto row_max = [&](int i, int r) {
    float mx = fmaxf(s[i][0][2 * r], s[i][0][2 * r + 1]);
#pragma unroll
    for (int j = 1; j < NJ; ++j) mx = fmaxf(mx, fmaxf(s[i][j][2 * r], s[i][j][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    return fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  };
  // the softmax weights of the scores in s along each row inside the warp:
  // the thread's keys, then the quad; p into the warp's region, alpha (where
  // the tile rescales: exact rows, row 11's window) through its row region
  // (the warp's PV of the previous tile must be done)
  auto softmax = [&](bool rescale) {
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float ref = 0.f, alpha = 1.f;
        if constexpr (Tr::exact) {
          const float mx = row_max(i, r);
          // c > 0 and rounding is monotonic: max(s) c is the max of s c
          const float m_new = fmaxf(m[i][r], Tr::scale_after ? mx * scale : mx);
          alpha = NATURAL ? expf(m[i][r] - m_new) : ex2_ftz(m[i][r] - m_new);
          m[i][r] = ref = m_new;
        } else if constexpr (Tr::bounded) {
          if (rescale) {  // the window: an online shift
            const float m_new = fmaxf(m[i][r], row_max(i, r));
            alpha = ex2_ftz(m[i][r] - m_new);
            m[i][r] = m_new;
          }
          ref = m[i][r] + kShiftMargin;
        }
        float sum = 0.f;
        const int row = i * 16 + r * 8 + g;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = s[i][j][2 * r + e];
            float p;
            if constexpr (Tr::exact) {
              p = NATURAL           ? expf(x - ref)
                  : Tr::scale_after ? ex2_ftz(fmaf(x, scale, -ref))
                                    : ex2_ftz(x - ref);
            } else if constexpr (Tr::bounded) {
              p = ex2_ftz(fminf(x - ref, kSaturate));
            } else if constexpr (V == QmVariant::Dots) {
              p = x;
            } else if constexpr (V == QmVariant::Exp) {
              p = ex2_ftz(x);
            } else {
              p = ex2_ftz(fminf(x - kAblateShift, kSaturate));
            }
            sum += p;
            p_w[(j * 8 + 2 * t + e) * PS + row] = NATURAL ? round_bf16(p) : p;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (rescale) {
          l[i][r] = l[i][r] * alpha + sum;
          if (t == 0) rows_w[row] = alpha;
        } else {
          l[i][r] += sum;
        }
      }
    __syncwarp();
  };
  // acc = acc alpha (where the tile rescales) + p v over the tile's TK keys
  // (V tile vt, [key][VROW]): this thread's 8 queries x 5 d rows
  auto pv = [&](const float* vt, bool rescale) {
    if (rescale) {
      const float4 aa = *reinterpret_cast<const float4*>(rows_w + qx * 8);
      const float4 ab = *reinterpret_cast<const float4*>(rows_w + qx * 8 + 4);
      const float al[8] = {aa.x, aa.y, aa.z, aa.w, ab.x, ab.y, ab.z, ab.w};
#pragma unroll
      for (int i = 0; i < 5; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] *= al[j];
    }
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(p_w + kk * PS + qx * 8);
      const float4 pb = *reinterpret_cast<const float4*>(p_w + kk * PS + qx * 8 + 4);
      const float pv[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      const float4 va = *reinterpret_cast<const float4*>(vt + kk * VROW + dy * 4);
      const float vv[5] = {va.x, va.y, va.z, va.w, vt[kk * VROW + 4 * Tl::NDY + dy]};
#pragma unroll
      for (int i = 0; i < 5; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(vv[i], pv[j], acc[i][j]);
    }
  };

  const int nw = Tr::bounded ? anchor / TK : 0;  // the anchor window's tiles
  if constexpr (Tr::pipe) {
    // row 10's pipelined loop: tile 0's K and V and tile 1's K, then tile
    // 0's scores (the prologue); iteration t takes tile t's scores, then
    // tile t - 1's softmax and PV; the epilogue drains the last tile
    load_tile(0, 0);
    if (nk > 1) load_kv(TK, 1, -1, 0);
    cp_async_wait<0>();
    __syncthreads();  // q, K(0), K(1) and V(0) visible
    zero_s(s);
    qk_f32(0, s);
    for (int tile = 1; tile < nk; ++tile) {
      const int stage = tile & 1;
      cp_async_wait<0>();  // this thread's copies of K(tile) and V(tile - 1) have landed
      // K(tile) and V(tile - 1) visible; every warp is past QK(tile - 1)
      // and PV(tile - 2), so K(tile - 1)'s and V(tile - 2)'s slots may be
      // refilled
      __syncthreads();
      load_kv(tile + 1 < nk ? (tile + 1) * TK : -1, stage ^ 1, tile * TK, stage);
      float s_next[NI][NJ][4];
      zero_s(s_next);
      qk_f32(stage, s_next);
      softmax(true);
      pv(reinterpret_cast<const float*>(v_raw + (stage ^ 1) * Sm::v_stage), true);
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][j][e] = s_next[i][j][e];
      __syncwarp();  // the warp's p and alpha are rewritten by the next softmax
    }
    cp_async_wait<0>();
    __syncthreads();  // V(nk - 1) visible
    softmax(true);
    pv(reinterpret_cast<const float*>(v_raw + ((nk - 1) & 1) * Sm::v_stage), true);
  } else {
    load_tile(0, 0);
    __syncthreads();  // q visible
    if constexpr (BF) {
      const __nv_bfloat16* q_s = reinterpret_cast<const __nv_bfloat16*>(q_raw);
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const __nv_bfloat16* rows = q_s + (warp * WR + i * 16 + (lane & 15)) * ROW_BF;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          ldsm_x4(smem_u32(rows + kk * 16 + (lane >> 4) * 8), qa[i][kk]);
        ldsm_x2(smem_u32(rows + 32), qa8[i]);
      }
    }
    for (int tile = 0; tile < nk; ++tile) {
      const int stage = tile & 1;
      cp_async_wait<0>();  // this thread's copies of the tile have landed
      const float* vt;
      if constexpr (BF) {
        convert_v(stage);
        vt = v32_s;
      } else {
        vt = reinterpret_cast<const float*>(v_raw + stage * Sm::v_stage);
      }
      // the tile (and its float32 V) visible; every warp is past the previous
      // tile, so its stage may be refilled (and, first, is done with q's tile)
      __syncthreads();
      if (tile + 1 < nk) load_tile((tile + 1) * TK, stage ^ 1);
      zero_s(s);
      if constexpr (BF) {
#pragma unroll
        for (int jp = 0; jp < NJ / 2; ++jp) qk_bf16_pair(stage, jp);
      } else {
        qk_f32(stage, s);
      }
      const bool rescale = Tr::exact || (Tr::bounded && tile < nw);
      softmax(rescale);
      pv(vt, rescale);
      // bf16: the float32 V tile is rewritten by the next tile's conversion;
      // float32: the warp's p and alpha are rewritten by the next softmax
      if constexpr (BF) __syncthreads(); else __syncwarp();
    }
  }

  // l (floored for rows 8 and 11) to the PV layout; out = acc / l, rounded
  // once; a warp's queries lie wholly before or past Sq (Sq is a multiple
  // of 64)
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        rows_w[i * 16 + r * 8 + g] = Tr::floor > 0.f ? fmaxf(l[i][r], Tr::floor) : l[i][r];
  }
  __syncwarp();
  const int r0 = q0 + warp * WR;  // the warp's first query
  if (r0 >= sq) return;
  float o[5][8];
  {
    const float4 la = *reinterpret_cast<const float4*>(rows_w + qx * 8);
    const float4 lb = *reinterpret_cast<const float4*>(rows_w + qx * 8 + 4);
    const float ls[8] = {la.x, la.y, la.z, la.w, lb.x, lb.y, lb.z, lb.w};
#pragma unroll
    for (int i = 0; i < 5; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) o[i][j] = acc[i][j] / ls[j];
  }
  if constexpr (!Tr::rows_out) {
    // [BH, D, Sq]: an 8-query run of each of the thread's 5 d rows
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const int c = i < 4 ? dy * 4 + i : 4 * Tl::NDY + dy;
      T* og = out + (size_t(bh) * D + c) * sq + r0 + qx * 8;
      if constexpr (BF) {
        *reinterpret_cast<uint4*>(og) =
            make_uint4(pack_bf16(o[i][0], o[i][1]), pack_bf16(o[i][2], o[i][3]),
                       pack_bf16(o[i][4], o[i][5]), pack_bf16(o[i][6], o[i][7]));
      } else {
        *reinterpret_cast<float4*>(og) = make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
        *reinterpret_cast<float4*>(og + 4) = make_float4(o[i][4], o[i][5], o[i][6], o[i][7]);
      }
    }
  } else {
    // [BH, Sq, D]: the warp's [32][40] tile staged over its p region, then
    // its 1,280 contiguous outputs as 16-byte vectors
    float* o_s = p_w;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* row = o_s + (qx * 8 + j) * D;
      *reinterpret_cast<float4*>(row + dy * 4) = make_float4(o[0][j], o[1][j], o[2][j], o[3][j]);
      row[4 * Tl::NDY + dy] = o[4][j];
    }
    __syncwarp();
    T* og = out + (size_t(bh) * sq + r0) * D;
    constexpr int EV = 16 / sizeof(T);  // elements a 16-byte vector
    for (int e = lane; e < WR * D / EV; e += 32) {
      if constexpr (BF) {
        const float4 x = *reinterpret_cast<const float4*>(o_s + e * 8);
        const float4 y = *reinterpret_cast<const float4*>(o_s + e * 8 + 4);
        *reinterpret_cast<uint4*>(og + e * 8) = make_uint4(
            pack_bf16(x.x, x.y), pack_bf16(x.z, x.w), pack_bf16(y.x, y.y), pack_bf16(y.z, y.w));
      } else {
        *reinterpret_cast<float4*>(og + e * 4) = *reinterpret_cast<const float4*>(o_s + e * 4);
      }
    }
  }
}

template <typename T, QmVariant V, int D>
cudaError_t launch_qm(const void* q, const void* k, const void* v, void* out, int bh, int sq,
                      int sk, int anchor, cudaStream_t stream) {
  auto kernel = flash_qm_kernel<T, V, D>;
  const int smem = int(QmSmem<T, V, D>::bytes);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // JAX's 1 / D**0.5, rounded once; times log2(e) in double first where the
  // scale follows the product (row 9 d's c) or q is scaled by it (rows 10
  // and 11); row 8 takes q unscaled
  const double sm_scale = 1.0 / sqrt(double(D));
  const float scale = float(V == QmVariant::ABf16PV ? sm_scale : sm_scale * 1.4426950408889634);
  const dim3 grid((sq + QmTile<D>::BQ - 1) / QmTile<D>::BQ, bh);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(out), sq,
                                           sk, scale, anchor);
  return cudaGetLastError();
}

// rows 8, 10 and 11 (float32) at d = 40 or 80
template <QmVariant V>
int launch_qm_d(const void* q, const void* k, const void* v, void* out, int bh, int sq, int sk,
                int d, int anchor, cudaStream_t s) {
  return d == 40 ? int(launch_qm<float, V, 40>(q, k, v, out, bh, sq, sk, anchor, s))
                 : int(launch_qm<float, V, 80>(q, k, v, out, bh, sq, sk, anchor, s));
}

// ---------------------------------------------------------------------------
// Row 9 c, kern_c (scripts/flash_variants.py:87), redesigned for the H100.
//
// The function, kern_c's: s_t[k][q] = (q sm_scale) . k in float32, key-major;
// a running max from -1e30 that moves once a 64-key tile, m_new = max(m,
// max over the tile's keys of s_t); p_t = exp(s_t - m_new) in float32;
// alpha = exp(m - m_new); l = l alpha + sum over keys of p_t; acc^T = acc^T
// alpha + v^T p_t; out^T = acc^T / l, [BH, D, Sq].  Here the scale follows
// the product and carries log2(e), s2 = (k . q) c with c = sm_scale log2(e)
// rounded to float32, and p = exp2(s2 - m2) with the running max m2 of s2:
// exp(s - m) up to float32 rounding (with bf16 inputs k . q is a sum of
// exact products), as row 9 d's kernel takes it.
//
// It is bound as the query-major kernel is (the file's head), and its design
// likewise keeps the CUDA cores busy with PV FMAs:
// - a block of 4 warps takes 128 queries; key tiles of 64 in a two-stage
//   cp.async ring (K and V; bf16 V converted to a float32 tile once);
// - QK: warp w computes the 16 keys w*16 .. w*16 + 16 against all 128
//   queries, S^T = K Q^T as the C fragments of mma.sync m16n8k16 (bf16: K's
//   [key][d] tile is A by ldmatrix, Q's [query][d] tile the col B operand,
//   d = 40 zero-padded to three k16 steps); with float32 inputs the same
//   fragment elements by FMAs from K [key][d] and Q^T [d][query] tiles.
//   Either way a thread holds keys g and g + 8 of its warp's 16 against
//   queries j*8 + 2t, j*8 + 2t + 1 (j < 16; g = lane / 4, t = lane % 4);
// - softmax down the key axis: each column's max and sum over the thread's
//   two keys, then across the 8 lanes of a t by shuffles that halve the
//   columns a lane holds at each step (32 -> 16 -> 8 -> 4: 28 shuffles, not
//   96), then across the 4 warps through shared memory, where thread q (one
//   a query) keeps its query's m and l; p goes to shared memory as float32,
//   key-major p_t [64][128 + 8] (the pad keeps the fragment's pair stores
//   conflict-free);
// - PV on the CUDA cores from a register tile of 5 d rows x 8 queries a
//   thread (d = ty*4 .. + 4 and 32 + ty; queries tx*4 .. + 4 and 64 + tx*4
//   .. + 4): each key costs two 16-byte loads of p, a 16-byte and a 4-byte
//   broadcast load of v, and 40 FMAs.
// 87 KB (bf16) or 100 KB (float32) of shared memory: 2 blocks an SM.  Sq is
// a multiple of 64: the last block of an image may hold 64 queries past Sq,
// read as zeros and never stored.

constexpr int KC_NT = BLOCK_Q / 8;     // score n-tiles (8 queries each) of a warp
constexpr int KC_PS = BLOCK_Q + 8;     // p_t [TILE_K][KC_PS] and float32 q^T [HEAD_D][KC_PS]
static_assert(TILE_K == 16 * 4 && kThreads == BLOCK_Q && HEAD_D == 5 * 8,
              "4 warps of 16 keys; one stats thread a query; 8 x 5 d rows");

template <typename T>
struct KcSmem {
  static constexpr bool bf = sizeof(T) == 2;
  // bytes of each region, in order: q (bf16 [BLOCK_Q][ROW_BF], float32 q^T
  // [HEAD_D][KC_PS]); the K ring; the V ring (as the input type); the float32
  // V tile (bf16 only); p_t; four rows of partial statistics, m and alpha
  static constexpr size_t q = bf ? 2 * BLOCK_Q * ROW_BF : 4 * HEAD_D * KC_PS;
  static constexpr size_t k_stage = bf ? 2 * TILE_K * ROW_BF : 4 * TILE_K * ROW_F32;
  static constexpr size_t v_stage = sizeof(T) * TILE_K * HEAD_D;
  static constexpr size_t v32 = bf ? 4 * TILE_K * HEAD_D : 0;
  static constexpr size_t p = 4 * TILE_K * KC_PS;
  static constexpr size_t stats = 4 * 6 * BLOCK_Q;
  static constexpr size_t bytes = q + 2 * k_stage + 2 * v_stage + v32 + p + stats;
  static_assert(q % 16 == 0 && k_stage % 16 == 0 && v_stage % 16 == 0 && v32 % 16 == 0 &&
                p % 16 == 0, "16-byte aligned regions");
};

// v[c] (c = 2j + e: query j*8 + 2t + e) reduced by `op` over the 8 lanes of
// a t (lane bits 2-4), each shuffle step keeping half the columns: the lane
// of row group g ends with columns 4g .. 4g + 4 in v[0 .. 4], queries
// 16g + 2t + (0, 1) and 16g + 8 + 2t + (0, 1).
// One step: lane bit H (16, 8, then 4) picks the half of v[0 .. 2H] it keeps.
template <int H, typename Op>
__device__ __forceinline__ void column_step(float (&v)[2 * KC_NT], int lane, Op op) {
  const bool hi = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = hi ? v[i] : v[i + H], keep = hi ? v[i + H] : v[i];
    v[i] = op(keep, __shfl_xor_sync(0xffffffffu, send, H));
  }
}
template <typename Op>
__device__ __forceinline__ void column_reduce(float (&v)[2 * KC_NT], int lane, Op op) {
  static_assert(2 * KC_NT == 32, "32 columns a lane");
  column_step<16>(v, lane, op);
  column_step<8>(v, lane, op);
  column_step<4>(v, lane, op);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_variant_c_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int sq, int sk,
                       float scale) {
  using Sm = KcSmem<T>;
  constexpr bool BF = Sm::bf;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* q_raw = smem_raw;
  unsigned char* k_raw = q_raw + Sm::q;
  unsigned char* v_raw = k_raw + 2 * Sm::k_stage;
  float* v32_s = reinterpret_cast<float*>(v_raw + 2 * Sm::v_stage);  // bf16: V in float32
  float* p_s = reinterpret_cast<float*>(v_raw + 2 * Sm::v_stage + Sm::v32);  // p_t [K][PS]
  float* red_s = p_s + TILE_K * KC_PS;  // [4][BLOCK_Q]: each warp's column max, then sum
  float* m_s = red_s + 4 * BLOCK_Q;      // [BLOCK_Q]: the tile's new running max
  float* a_s = m_s + BLOCK_Q;            // [BLOCK_Q]: alpha; at the end l

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;                // the fragments' row group, column pair
  const int tx = lane & 15, ty = warp * 2 + (lane >> 4);  // PV: queries tx*4, d rows ty*4, 32 + ty
  const int bh = blockIdx.y, q0 = blockIdx.x * BLOCK_Q;
  const T* qg = q + size_t(bh) * sq * HEAD_D;
  const T* kg = k + size_t(bh) * sk * HEAD_D;
  const T* vg = v + size_t(bh) * sk * HEAD_D;
  constexpr int CH = HEAD_D * int(sizeof(T)) / 16;  // 16-byte chunks of a row: 5 or 10

  // q, once: bf16 [query][d] with d 40 .. 48 zero, as it lies (the scale
  // follows the product); float32 transposed, q^T [d][query].  Queries past
  // Sq are zero.  The K ring's bf16 pad columns are zeroed once.
  if constexpr (BF) {
    __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(q_raw);
    for (int e = tid; e < BLOCK_Q * (DK16 / 8); e += kThreads) {
      const int r = e / (DK16 / 8), c = e - r * (DK16 / 8);
      uint4 x = make_uint4(0, 0, 0, 0);
      if (c < CH && q0 + r < sq) x = *reinterpret_cast<const uint4*>(qg + (q0 + r) * HEAD_D + c * 8);
      *reinterpret_cast<uint4*>(q_s + r * ROW_BF + c * 8) = x;
    }
    for (int r = tid; r < 2 * TILE_K; r += kThreads)
      *reinterpret_cast<uint4*>(reinterpret_cast<__nv_bfloat16*>(k_raw) + r * ROW_BF + HEAD_D) =
          make_uint4(0, 0, 0, 0);
  } else {
    float* q_s = reinterpret_cast<float*>(q_raw);
    for (int e = tid; e < BLOCK_Q * CH; e += kThreads) {
      const int r = e % BLOCK_Q, c = e / BLOCK_Q;  // consecutive threads, consecutive queries
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < sq) x = *reinterpret_cast<const float4*>(qg + (q0 + r) * HEAD_D + c * 4);
      q_s[(c * 4) * KC_PS + r] = x.x;
      q_s[(c * 4 + 1) * KC_PS + r] = x.y;
      q_s[(c * 4 + 2) * KC_PS + r] = x.z;
      q_s[(c * 4 + 3) * KC_PS + r] = x.w;
    }
  }

  // keys k0 .. k0 + 64 of K and V into ring stage `stage`, 16 bytes a copy
  auto load_tile = [&](int k0, int stage) {
    unsigned char* kd = k_raw + stage * Sm::k_stage;
    unsigned char* vd = v_raw + stage * Sm::v_stage;
    constexpr int row_bytes = BF ? 2 * ROW_BF : 4 * ROW_F32;
    for (int e = tid; e < TILE_K * CH; e += kThreads) {
      const int r = e / CH, c = e - r * CH;
      cp_async_16(smem_u32(kd + r * row_bytes + c * 16), kg + (k0 + r) * HEAD_D + c * (16 / sizeof(T)),
                  true);
      cp_async_16(smem_u32(vd + e * 16), vg + size_t(k0) * HEAD_D + e * (16 / sizeof(T)), true);
    }
    cp_async_commit();
  };

  float m = kNegInf, l = 0.f, alpha = 1.f;  // thread tid's query: the running max (of s2), sum
  float acc[5][8];
#pragma unroll
  for (int i = 0; i < 5; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = sk / TILE_K;
  load_tile(0, 0);
  for (int tile = 0; tile < nk; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < nk) {
      load_tile((tile + 1) * TILE_K, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the tile (and, first, q) visible

    // s[j][e]: key warp*16 + g + 8 (e >> 1), query j*8 + 2t + (e & 1)
    float s[KC_NT][4];
#pragma unroll
    for (int j = 0; j < KC_NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (BF) {
      const __nv_bfloat16* q_s = reinterpret_cast<const __nv_bfloat16*>(q_raw);
      const __nv_bfloat16* kt = reinterpret_cast<const __nv_bfloat16*>(k_raw + stage * Sm::k_stage);
#pragma unroll
      for (int kk = 0; kk < DK16 / 16; ++kk) {
        unsigned a[4];  // K: m = the warp's 16 keys, k = d
        ldsm_x4(smem_u32(kt + (warp * 16 + (lane & 15)) * ROW_BF + kk * 16 + (lane >> 4) * 8), a);
#pragma unroll
        for (int jp = 0; jp < KC_NT / 2; ++jp) {
          unsigned b[4];  // q [query][d]: the col layout of B (k = d, n = queries)
          ldsm_x4(smem_u32(q_s + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * ROW_BF + kk * 16 +
                           ((lane >> 3) & 1) * 8),
                  b);
          mma_bf16(s[2 * jp], a, b[0], b[1]);
          mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
        }
      }
    } else {
      const float* q_s = reinterpret_cast<const float*>(q_raw);
      const float* kt = reinterpret_cast<const float*>(k_raw + stage * Sm::k_stage) +
                        (warp * 16 + g) * ROW_F32;
#pragma unroll 4
      for (int c = 0; c < HEAD_D; ++c) {
        const float k0 = kt[c], k1 = kt[8 * ROW_F32 + c];
#pragma unroll
        for (int j = 0; j < KC_NT; ++j) {
          const float2 x = *reinterpret_cast<const float2*>(q_s + c * KC_PS + j * 8 + 2 * t);
          s[j][0] = fmaf(k0, x.x, s[j][0]);
          s[j][1] = fmaf(k0, x.y, s[j][1]);
          s[j][2] = fmaf(k1, x.x, s[j][2]);
          s[j][3] = fmaf(k1, x.y, s[j][3]);
        }
      }
    }

    // the tile's max of each query column: the thread's two keys, the 8
    // lanes of its t, then the 4 warps (thread q, below)
    float col[2 * KC_NT];
#pragma unroll
    for (int j = 0; j < KC_NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale;
      col[2 * j] = fmaxf(s[j][0], s[j][2]);
      col[2 * j + 1] = fmaxf(s[j][1], s[j][3]);
    }
    column_reduce(col, lane, [](float a, float b) { return fmaxf(a, b); });
    float* red_w = red_s + warp * BLOCK_Q + 16 * g + 2 * t;  // this lane's four columns
    *reinterpret_cast<float2*>(red_w) = make_float2(col[0], col[1]);
    *reinterpret_cast<float2*>(red_w + 8) = make_float2(col[2], col[3]);
    __syncthreads();
    {
      const float mx = fmaxf(fmaxf(red_s[tid], red_s[BLOCK_Q + tid]),
                             fmaxf(red_s[2 * BLOCK_Q + tid], red_s[3 * BLOCK_Q + tid]));
      const float m_new = fmaxf(m, mx);
      alpha = exp2f(m - m_new);
      m = m_new;
      m_s[tid] = m_new;
      a_s[tid] = alpha;
    }
    __syncthreads();
    // p = exp2(s2 - m2) into p_t; the column sums as the maxima went
#pragma unroll
    for (int j = 0; j < KC_NT; ++j) {
      const float2 mn = *reinterpret_cast<const float2*>(m_s + j * 8 + 2 * t);
      const float p0 = exp2f(s[j][0] - mn.x), p1 = exp2f(s[j][1] - mn.y);
      const float p2 = exp2f(s[j][2] - mn.x), p3 = exp2f(s[j][3] - mn.y);
      const int key = warp * 16 + g;
      *reinterpret_cast<float2*>(p_s + key * KC_PS + j * 8 + 2 * t) = make_float2(p0, p1);
      *reinterpret_cast<float2*>(p_s + (key + 8) * KC_PS + j * 8 + 2 * t) = make_float2(p2, p3);
      col[2 * j] = p0 + p2;
      col[2 * j + 1] = p1 + p3;
    }
    column_reduce(col, lane, [](float a, float b) { return a + b; });
    *reinterpret_cast<float2*>(red_w) = make_float2(col[0], col[1]);
    *reinterpret_cast<float2*>(red_w + 8) = make_float2(col[2], col[3]);
    const float* vt;
    if constexpr (BF) {  // the bf16 V tile in float32, 2 elements a step
      const __nv_bfloat162* vb =
          reinterpret_cast<const __nv_bfloat162*>(v_raw + stage * Sm::v_stage);
      for (int e = tid; e < TILE_K * HEAD_D / 2; e += kThreads)
        *reinterpret_cast<float2*>(v32_s + 2 * e) = __bfloat1622float2(vb[e]);
      vt = v32_s;
    } else {
      vt = reinterpret_cast<const float*>(v_raw + stage * Sm::v_stage);
    }
    __syncthreads();
    l = l * alpha + ((red_s[tid] + red_s[BLOCK_Q + tid]) + (red_s[2 * BLOCK_Q + tid] +
                                                         red_s[3 * BLOCK_Q + tid]));
    // acc^T = acc^T alpha + v^T p_t over the tile's 64 keys
    {
      const float4 aa = *reinterpret_cast<const float4*>(a_s + tx * 4);
      const float4 ab = *reinterpret_cast<const float4*>(a_s + 64 + tx * 4);
      const float al[8] = {aa.x, aa.y, aa.z, aa.w, ab.x, ab.y, ab.z, ab.w};
#pragma unroll
      for (int i = 0; i < 5; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] *= al[j];
    }
#pragma unroll 4
    for (int kk = 0; kk < TILE_K; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(p_s + kk * KC_PS + tx * 4);
      const float4 pb = *reinterpret_cast<const float4*>(p_s + kk * KC_PS + 64 + tx * 4);
      const float pv[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      const float4 va = *reinterpret_cast<const float4*>(vt + kk * HEAD_D + ty * 4);
      const float vv[5] = {va.x, va.y, va.z, va.w, vt[kk * HEAD_D + 32 + ty]};
#pragma unroll
      for (int i = 0; i < 5; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(vv[i], pv[j], acc[i][j]);
    }
    __syncthreads();  // p_t, the statistics and this stage free for the next tiles
  }

  // out^T = acc^T / l, rounded once; D rows of 4-query runs, queries past Sq
  // not stored
  a_s[tid] = l;
  __syncthreads();
  const float4 la = *reinterpret_cast<const float4*>(a_s + tx * 4);
  const float4 lb = *reinterpret_cast<const float4*>(a_s + 64 + tx * 4);
  const float ls[8] = {la.x, la.y, la.z, la.w, lb.x, lb.y, lb.z, lb.w};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    T* og = out + (size_t(bh) * HEAD_D + (i < 4 ? ty * 4 + i : 32 + ty)) * sq + q0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half * 64 + tx * 4;
      if (q0 + r >= sq) continue;
      const float o0 = acc[i][4 * half] / ls[4 * half],
                  o1 = acc[i][4 * half + 1] / ls[4 * half + 1],
                  o2 = acc[i][4 * half + 2] / ls[4 * half + 2],
                  o3 = acc[i][4 * half + 3] / ls[4 * half + 3];
      if constexpr (BF) {
        uint2 x;
        x.x = pack_bf16(o0, o1);
        x.y = pack_bf16(o2, o3);
        *reinterpret_cast<uint2*>(og + r) = x;
      } else {
        *reinterpret_cast<float4*>(og + r) = make_float4(o0, o1, o2, o3);
      }
    }
  }
}

template <typename T>
cudaError_t launch_c(const void* q, const void* k, const void* v, void* out, int bh, int sq,
                     int sk, cudaStream_t stream) {
  auto kernel = flash_variant_c_kernel<T>;
  const int smem = int(KcSmem<T>::bytes);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // JAX's 1 / D**0.5 times log2(e) in double, rounded once (row 9 d's c)
  const float scale = float(1.0 / sqrt(double(HEAD_D)) * 1.4426950408889634);
  const dim3 grid((sq + BLOCK_Q - 1) / BLOCK_Q, bh);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(out), sq,
                                           sk, scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

// Sq and Sk multiples of 64, 32-bit offsets in an image, every operand
// 16-byte aligned (the kernels copy 16 bytes at a time); each entry point
// checks its head dims
bool takes(const void* q, const void* k, const void* v, const void* out, int bh, int sq, int sk,
           int d) {
  if (d < 1 || bh < 1 || bh > 65535 || sq < 64 || sk < 64 || sq % 64 || sk % 64) return false;
  if ((long long)(sq > sk ? sq : sk) * d > INT_MAX) return false;
  return aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out);
}

}  // namespace

// Plain C entry points for ctypes.  Each returns 0 on success, a cudaError_t
// code from the launch, or -1 for arguments the kernel does not take.

// Rows 9 a and b (the query-major kernel).  variant: 0 kern_a, 1 kern_a with
// pv_bf16 (float32 only; bf16: hedit_flash_variant_tc), 2 kern_b (3, kern_c:
// hedit_flash_variant_c); D = 40; dtype: 0 float32, 1 bfloat16.  out is
// [BH, Sq, D] for variants 0 and 1, [BH, D, Sq] for 2.
extern "C" int hedit_flash_variant(const void* q, const void* k, const void* v, void* out,
                                   int bh, int sq, int sk, int d, int variant_code, int dtype,
                                   void* stream) {
  if (!takes(q, k, v, out, bh, sq, sk, d) || d != HEAD_D || variant_code < 0 ||
      variant_code > 3 || dtype < 0 || dtype > 1)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF16 = __nv_bfloat16;
  switch (dtype * 4 + variant_code) {
    case 0: return int(launch_qm<float, QmVariant::A, HEAD_D>(q, k, v, out, bh, sq, sk, 0, s));
    case 1:
      return int(launch_qm<float, QmVariant::ABf16PV, HEAD_D>(q, k, v, out, bh, sq, sk, 0, s));
    case 2: return int(launch_qm<float, QmVariant::B, HEAD_D>(q, k, v, out, bh, sq, sk, 0, s));
    case 4: return int(launch_qm<BF16, QmVariant::A, HEAD_D>(q, k, v, out, bh, sq, sk, 0, s));
    case 6: return int(launch_qm<BF16, QmVariant::B, HEAD_D>(q, k, v, out, bh, sq, sk, 0, s));
    default: return -1;
  }
}

// Row 9 c (kern_c): q, k, v [BH, S, D] -> out [BH, D, Sq]; D = 40; dtype 0
// float32, 1 bfloat16; every operand 16-byte aligned.
extern "C" int hedit_flash_variant_c(const void* q, const void* k, const void* v, void* out,
                                     int bh, int sq, int sk, int d, int dtype, void* stream) {
  if (!takes(q, k, v, out, bh, sq, sk, d) || d != HEAD_D) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(launch_c<float>(q, k, v, out, bh, sq, sk, s));
    case 1: return int(launch_c<__nv_bfloat16>(q, k, v, out, bh, sq, sk, s));
    default: return -1;
  }
}

// Row 11 (the query-major kernel): the bounded probes.  layout 0: q, k, v
// [BH, S, D]; 1: q, k [BH, D, S] and v [BH, S, D]; 2: q, k, v [BH, D, S].
// out [BH, D, Sq].  D = 40 or 80; the anchor a multiple of 64 that divides
// Sk.  float32 only (bf16: hedit_flash_packed_t_tc).
extern "C" int hedit_flash_packed_t(const void* q, const void* k, const void* v, void* out,
                                    int bh, int sq, int sk, int d, int anchor, int layout,
                                    int dtype, void* stream) {
  if (!takes(q, k, v, out, bh, sq, sk, d) || (d != 40 && d != 80) || dtype != 0 ||
      anchor < 64 || anchor % 64 || sk % anchor)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (layout) {
    case 0: return launch_qm_d<QmVariant::Bounded>(q, k, v, out, bh, sq, sk, d, anchor, s);
    case 1: return launch_qm_d<QmVariant::BoundedSMinor>(q, k, v, out, bh, sq, sk, d, anchor, s);
    case 2:
      return launch_qm_d<QmVariant::BoundedAllSMinor>(q, k, v, out, bh, sq, sk, d, anchor, s);
    default: return -1;
  }
}

// Row 8 (the query-major kernel): the ablations, q, k, v [BH, S, D] -> out
// [BH, D, Sq]; mode 0 dots, 1 exp, 2 noprolog; D = 40 or 80.  float32 only
// (bf16: hedit_flash_ablate_t_tc).
extern "C" int hedit_flash_ablate_t(const void* q, const void* k, const void* v, void* out,
                                    int bh, int sq, int sk, int d, int mode, int dtype,
                                    void* stream) {
  if (!takes(q, k, v, out, bh, sq, sk, d) || (d != 40 && d != 80) || dtype != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch_qm_d<QmVariant::Dots>(q, k, v, out, bh, sq, sk, d, 0, s);
    case 1: return launch_qm_d<QmVariant::Exp>(q, k, v, out, bh, sq, sk, d, 0, s);
    case 2: return launch_qm_d<QmVariant::NoProlog>(q, k, v, out, bh, sq, sk, d, 0, s);
    default: return -1;
  }
}

// Row 10 (the query-major kernel): the exact exp2 probe, q, k, v [BH, S, D]
// -> out [BH, D, Sq]; pipe: 0 the plain key loop, 1 the software-pipelined
// one (the same bits); D = 40 or 80.  float32 only (bf16:
// hedit_flash_exp2_t_tc).
extern "C" int hedit_flash_exp2_t(const void* q, const void* k, const void* v, void* out,
                                  int bh, int sq, int sk, int d, int pipe, int dtype,
                                  void* stream) {
  if (!takes(q, k, v, out, bh, sq, sk, d) || (d != 40 && d != 80) || dtype != 0 ||
      (pipe != 0 && pipe != 1))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pipe ? launch_qm_d<QmVariant::Exp2Pipe>(q, k, v, out, bh, sq, sk, d, 0, s)
              : launch_qm_d<QmVariant::Exp2>(q, k, v, out, bh, sq, sk, d, 0, s);
}
