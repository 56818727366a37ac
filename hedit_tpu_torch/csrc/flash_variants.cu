// Exact flash-attention forwards in float32 for Hopper (sm_90a): the ports
// of the TPU kernels of scripts/flash_variants.py (wrappers in
// ops/flash_probes.py), as two kernels:
//
//   kern_a (:31)           [Sq, D] output          flash_variant_a_cuda
//   kern_a, pv_bf16 (:45)  p rounded to bf16 for PV flash_variant_a_cuda(pv_bf16=True)
//   kern_b (:61)           [D, Sq] output          flash_variant_b_cuda
//     (entry point hedit_flash_variant: the query-major kernel,
//     flash_variant_qm_kernel, described before it)
//   kern_c (:87)           key-major scores, [D, Sq] output  flash_variant_c_cuda
//     (entry point hedit_flash_variant_c: flash_variant_c_kernel)
//
// Their function is the TPU kernels': q upcast and times sm_scale = 1/sqrt(D)
// in float32 (NOT rounded to the input dtype), k and v upcast, float32
// scores, a running max m starting at -1e30, p = exp(s - m_new), alpha =
// exp(m_old - m_new), l = l * alpha + sum(p) and out = acc / l rounded once
// to the input dtype.  With pv_bf16 the PV product takes p rounded to
// bfloat16 (with float32 inputs JAX promotes the product to float32, so only
// p is rounded); the row sum still takes the unrounded p.  The running max
// moves once a 64-key tile (the TPU kernels' BLK_K is 512): without pv_bf16
// that moves the output by float32 rounding only, with it p is rounded
// against another point.  kern_a with pv_bf16 in bf16 runs on the tensor
// cores (hedit_flash_variant_tc in flash_probes_tc.cu).
//
// What bounds both kernels: PV, 2 BH Sq Sk D FLOP of float32 FMAs at 67
// TFLOP/s (0.641 ms at the probe's [32, 4096, 40]); QK, as many FLOP of bf16
// products at 989 (0.043 ms) or, with float32 inputs, of float32 FMAs (then
// both products at 67: 0.320 ms at [8, 4096, 40]); the bytes are ~6 us.  So
// both keep the CUDA cores busy with PV FMAs from register tiles, and take
// the scores' product on the tensor cores where the inputs are bf16 (the
// products of two bf16 values are exact in float32).
//
// Contract: q [BH, Sq, D], k and v [BH, Sk, D], contiguous, one dtype
// (float32 or bfloat16), every operand 16-byte aligned; D = 40 (the probe's
// head dim); Sq and Sk multiples of 64 (the TPU grid covers whole blocks;
// nothing is masked).  A block takes 128 queries: the last block of an
// image may hold 64 queries past Sq, read as zeros and never stored.

#include <climits>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

constexpr int BLOCK_Q = 128;          // queries a block (4 warps)
constexpr int TILE_K = 64;            // keys a tile
constexpr int HEAD_D = 40;            // the head dim
constexpr int DK16 = 48;              // bf16, row 9 c: the contraction padded to three k16 steps
constexpr int ROW_BF = DK16 + 8;      // bf16 q and K rows, [.][ROW_BF] (conflict-free ldmatrix)
constexpr int ROW_F32 = HEAD_D + 4;   // float32 q (a, b) and K rows, [.][ROW_F32]
constexpr float kNegInf = -1e30f;     // the TPU kernels' initial running max

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// ---------------------------------------------------------------------------
// Rows 9 a and 9 b, kern_a (with pv_bf16 in float32) and kern_b
// (scripts/flash_variants.py:31, 61), redesigned for the H100 as one
// query-major kernel.  kern_a and kern_b reduce along the query's row, which
// is the row of the mma.sync C fragment: the four lanes of a quad hold it.
// So each warp keeps its queries' softmax to itself:
// - a block of 4 warps takes 128 queries, warp w the 32 rows w*32 .. + 32
//   (two m16 row tiles) against every key of a 64-key tile; K and V come in
//   through a two-stage cp.async ring of 16-byte copies;
// - QK, query-major.  bf16: mma.sync with d = 40 as two m16n8k16 steps and
//   one m16n8k8 step (no padded products); Q is the A operand, loaded once
//   by ldmatrix, and its fragments stay in registers across the key loop;
//   K's [key][d] tile is the B operand by ldmatrix.  float32: the same
//   fragment elements by FMAs from [query][d] and [key][d] tiles, 4 d a
//   16-byte load (one d step costs 5 loads for 64 FMAs).  Either way a
//   thread holds rows g, g + 8, g + 16, g + 24 of its warp's 32 against keys
//   j*8 + 2t, j*8 + 2t + 1 (j < 8; g = lane / 4, t = lane % 4);
// - softmax along the row inside the warp: each row's max and sum over the
//   thread's 16 keys, then 2 __shfl_xor_sync across the quad; no shared
//   memory, no block barrier;
// - p is warp-private: the warp writes it as float32 into its own region,
//   [key][32 queries + 4] (conflict-free fragment stores, 16-byte loads of 4
//   queries), rounded to bf16 for pv_bf16; alpha and, at the end, l go
//   through a 32-float region of the warp to the PV layout; __syncwarp
//   separates the softmax from PV;
// - PV on the CUDA cores in float32: each warp its own 32 queries x 40 d,
//   8 queries (qx*8 .. + 8) x 5 d rows (dy*4 .. + 4 and 32 + dy) a thread;
//   each key costs two 16-byte loads of p, a 16-byte and a 4-byte broadcast
//   load of v, and 40 FMAs;
// - each thread waits for its own copies of a tile (and, bf16, converts its
//   own V chunks into the float32 V tile); one __syncthreads makes the tile
//   visible, and the next tile's copies are issued after it, into the stage
//   every warp has left.  float32 reads V from the ring: one barrier a
//   tile, 100 KB of shared memory and up to 255 registers, 2 blocks an SM.
//   bf16 keeps one float32 V tile and lays q (read once, into registers)
//   over the p regions: a second barrier a tile (before the next
//   conversion), 70 KB and at most 168 registers, 3 blocks an SM;
// - the epilogue is the only place a and b differ: b stores 8-query runs of
//   each of its 5 d rows straight to [BH, D, Sq]; a stages its warp's
//   [32][40] tile over the warp's p region and writes the warp's 1,280
//   contiguous outputs of [BH, Sq, D] as 16-byte vectors.  Both divide the
//   same acc by the same l, so a's output is b's transposed, bit for bit;
//   each output has one writer, so every launch gives the same bits.
// The scale: a and b (either dtype) take it after the product with log2(e)
// folded in, s2 = s c with c = sm_scale log2(e) rounded to float32, the
// running max of s2 and p = 2^(fma(s, c, -m2)) by ex2.approx.ftz (a p below
// 2^-126 is 0), as row 9 c does (with bf16 inputs the tensor cores must see
// q unscaled to keep the products exact).  kern_a with pv_bf16 (float32
// only) keeps the template's order instead: q times sm_scale before an
// in-order FMA chain over d and p = expf(s - m), so that p, rounded to
// bf16, lands where the plain version's does.

enum class QmVariant { A, ABf16PV, B };  // kern_a, kern_a with pv_bf16, kern_b

constexpr int QM_PS = 32 + 4;  // a warp's p [TILE_K][QM_PS]: 16-byte rows, conflict-free stores
static_assert(kThreads == BLOCK_Q && BLOCK_Q == 4 * 32 && TILE_K == 8 * 8 && HEAD_D == 5 * 8,
              "4 warps of 32 rows; 8 key n-tiles; 8 x 5 d rows a warp's PV");

template <typename T>
struct QmSmem {
  static constexpr bool bf = sizeof(T) == 2;
  // bytes of each region, in order: float32 q; the K ring; the V ring (as
  // the input type); the float32 V tile (bf16 only); each warp's p; each
  // warp's row statistics (alpha, at the end l).  bf16 q lies over the p
  // regions: it is read once, into registers, before the first softmax.
  static constexpr size_t q = bf ? 0 : 4 * BLOCK_Q * ROW_F32;
  static constexpr size_t k_stage = bf ? 2 * TILE_K * ROW_BF : 4 * TILE_K * ROW_F32;
  static constexpr size_t v_stage = sizeof(T) * TILE_K * HEAD_D;
  static constexpr size_t v32 = bf ? 4 * TILE_K * HEAD_D : 0;
  static constexpr size_t p_warp = 4 * TILE_K * QM_PS;
  static constexpr size_t rows_warp = 4 * 32;
  static constexpr size_t bytes = q + 2 * k_stage + 2 * v_stage + v32 + 4 * (p_warp + rows_warp);
  static_assert(q % 16 == 0 && k_stage % 16 == 0 && v_stage % 16 == 0 && v32 % 16 == 0 &&
                p_warp % 16 == 0, "16-byte aligned regions");
  static_assert(p_warp >= 4 * 32 * HEAD_D, "a's output tile fits a warp's p region");
  static_assert(4 * p_warp >= 2 * BLOCK_Q * ROW_BF, "bf16 q fits the p regions");
};

__device__ __forceinline__ float ex2_ftz(float x) {  // 2^x, results below 2^-126 flushed to 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, QmVariant V>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 3 : 2)  // blocks an SM
flash_variant_qm_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, int sq, int sk,
                        float scale) {
  using Sm = QmSmem<T>;
  constexpr bool BF = Sm::bf;
  // pv_bf16: q times sm_scale (= scale) on load and p = expf(s - m); else s
  // times c (= scale) and p = 2^(s c - m)
  constexpr bool NATURAL = V == QmVariant::ABf16PV;
  static_assert(!(NATURAL && BF), "bf16 pv_bf16 runs on the tensor cores (flash_probes_tc.cu)");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* k_raw = smem_raw + Sm::q;
  unsigned char* v_raw = k_raw + 2 * Sm::k_stage;
  float* v32_s = reinterpret_cast<float*>(v_raw + 2 * Sm::v_stage);  // bf16: [TILE_K][HEAD_D]
  float* p_base = reinterpret_cast<float*>(v_raw + 2 * Sm::v_stage + Sm::v32);
  unsigned char* q_raw = BF ? reinterpret_cast<unsigned char*>(p_base) : smem_raw;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;    // the fragments' row group, key pair
  const int qx = lane & 3, dy = lane >> 2;  // PV: queries qx*8 .. + 8, d rows dy*4 .. + 4, 32 + dy
  float* p_w = p_base + warp * (TILE_K * QM_PS);                  // this warp's p [key][QM_PS]
  float* rows_w = p_base + 4 * (TILE_K * QM_PS) + warp * 32;      // this warp's alpha, then l
  const int bh = blockIdx.y, q0 = blockIdx.x * BLOCK_Q;
  const T* qg = q + size_t(bh) * sq * HEAD_D;
  const T* kg = k + size_t(bh) * sk * HEAD_D;
  const T* vg = v + size_t(bh) * sk * HEAD_D;
  constexpr int CH = HEAD_D * int(sizeof(T)) / 16;  // 16-byte chunks of a row: 5 or 10
  const int nk = sk / TILE_K;

  // q, once, [query][d]: bf16 as it lies (the scale follows the product),
  // float32 times sm_scale for pv_bf16.  Queries past Sq are zero.
  if constexpr (BF) {
    __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(q_raw);
    for (int e = tid; e < BLOCK_Q * CH; e += kThreads) {
      const int r = e / CH, c = e - r * CH;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (q0 + r < sq) x = *reinterpret_cast<const uint4*>(qg + (q0 + r) * HEAD_D + c * 8);
      *reinterpret_cast<uint4*>(q_s + r * ROW_BF + c * 8) = x;
    }
  } else {
    float* q_s = reinterpret_cast<float*>(q_raw);
    for (int e = tid; e < BLOCK_Q * CH; e += kThreads) {
      const int r = e / CH, c = e - r * CH;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < sq) x = *reinterpret_cast<const float4*>(qg + (q0 + r) * HEAD_D + c * 4);
      if constexpr (NATURAL) x = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
      *reinterpret_cast<float4*>(q_s + r * ROW_F32 + c * 4) = x;
    }
  }

  // keys k0 .. k0 + 64 of K and V into ring stage `stage`, 16 bytes a copy:
  // thread tid copies V chunks tid, tid + 128, ... (the ones it converts)
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
  // bf16: this thread's own V chunks of the tile in ring stage `stage`
  // (visible to it once its copies landed) into the float32 V tile
  auto convert_v = [&](int stage) {
    const __nv_bfloat16* vb = reinterpret_cast<const __nv_bfloat16*>(v_raw + stage * Sm::v_stage);
    for (int e = tid; e < TILE_K * CH; e += kThreads) {
      const uint4 x = *reinterpret_cast<const uint4*>(vb + e * 8);
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
      const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.z));
      const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.w));
      *reinterpret_cast<float4*>(v32_s + e * 8) = make_float4(a.x, a.y, b.x, b.y);
      *reinterpret_cast<float4*>(v32_s + e * 8 + 4) = make_float4(c.x, c.y, d.x, d.y);
    }
  };

  // s[i][j][2r + e]: row warp*32 + i*16 + r*8 + g, key j*8 + 2t + e
  float s[2][8][4];
  // bf16: the warp's Q fragments for the whole loop, 2 row tiles x (two k16
  // steps, d 0 .. 32, and one k8 step, d 32 .. 40)
  unsigned qa[2][2][4], qa8[2][2];
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
      for (int i = 0; i < 2; ++i) {
        mma_bf16(s[i][2 * jp], qa[i][kk], b[0], b[1]);
        mma_bf16(s[i][2 * jp + 1], qa[i][kk], b[2], b[3]);
      }
    }
    unsigned b8[2];
    ldsm_x2(smem_u32(kt + (jp * 16 + (lane & 15)) * ROW_BF + 32), b8);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mma_bf16_k8(s[i][2 * jp], qa8[i][0], qa8[i][1], b8[0]);
      mma_bf16_k8(s[i][2 * jp + 1], qa8[i][0], qa8[i][1], b8[1]);
    }
  };
  auto zero_s = [&] {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][j][e] = 0.f;
  };
  // float32, the tile's scores by FMAs from [query][d] and [key][d] tiles,
  // 4 d a 16-byte load, d in order (the template's FMA chain)
  auto qk_f32 = [&](int stage) {
    const float* q_s = reinterpret_cast<const float*>(q_raw) + (warp * 32 + g) * ROW_F32;
    const float* kt = reinterpret_cast<const float*>(k_raw + stage * Sm::k_stage) + 2 * t * ROW_F32;
#pragma unroll 2
    for (int c = 0; c < HEAD_D; c += 4) {
      float4 qv[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          qv[i][r] = *reinterpret_cast<const float4*>(q_s + (i * 16 + r * 8) * ROW_F32 + c);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 kv = *reinterpret_cast<const float4*>(kt + (j * 8 + e) * ROW_F32 + c);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float& x = s[i][j][2 * r + e];
              x = fmaf(qv[i][r].x, kv.x, x);
              x = fmaf(qv[i][r].y, kv.y, x);
              x = fmaf(qv[i][r].z, kv.z, x);
              x = fmaf(qv[i][r].w, kv.w, x);
            }
        }
    }
  };

  // row (i, r) = warp*32 + i*16 + r*8 + g: its running max (of s c, or of s
  // for pv_bf16) and sum, the same in the 4 lanes of the quad
  float m[2][2], l[2][2];
  float acc[5][8];  // d rows dy*4 .. + 4, 32 + dy; queries qx*8 .. + 8
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[i][r] = kNegInf;
      l[i][r] = 0.f;
    }
#pragma unroll
  for (int i = 0; i < 5; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // the softmax of the scores in s along each row inside the warp: the
  // thread's 16 keys, then the quad; p into the warp's region, alpha through
  // its row region (the warp's PV of the previous tile must be done)
  auto softmax = [&] {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = fmaxf(s[i][0][2 * r], s[i][0][2 * r + 1]);
#pragma unroll
        for (int j = 1; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[i][j][2 * r], s[i][j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // c > 0 and rounding is monotonic: max(s) c is the max of s c
        const float m_new = fmaxf(m[i][r], NATURAL ? mx : mx * scale);
        const float alpha = NATURAL ? expf(m[i][r] - m_new) : ex2_ftz(m[i][r] - m_new);
        m[i][r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = s[i][j][2 * r + e];
            const float p = NATURAL ? expf(x - m_new) : ex2_ftz(fmaf(x, scale, -m_new));
            sum += p;
            p_w[(j * 8 + 2 * t + e) * QM_PS + i * 16 + r * 8 + g] = NATURAL ? round_bf16(p) : p;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[i][r] = l[i][r] * alpha + sum;
        if (t == 0) rows_w[i * 16 + r * 8 + g] = alpha;
      }
    __syncwarp();
  };
  // acc = acc alpha + p v over the tile's 64 keys (V tile vt): this
  // thread's 8 queries x 5 d
  auto pv = [&](const float* vt) {
    {
      const float4 aa = *reinterpret_cast<const float4*>(rows_w + qx * 8);
      const float4 ab = *reinterpret_cast<const float4*>(rows_w + qx * 8 + 4);
      const float al[8] = {aa.x, aa.y, aa.z, aa.w, ab.x, ab.y, ab.z, ab.w};
#pragma unroll
      for (int i = 0; i < 5; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] *= al[j];
    }
#pragma unroll 8
    for (int kk = 0; kk < TILE_K; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(p_w + kk * QM_PS + qx * 8);
      const float4 pb = *reinterpret_cast<const float4*>(p_w + kk * QM_PS + qx * 8 + 4);
      const float pv[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      const float4 va = *reinterpret_cast<const float4*>(vt + kk * HEAD_D + dy * 4);
      const float vv[5] = {va.x, va.y, va.z, va.w, vt[kk * HEAD_D + 32 + dy]};
#pragma unroll
      for (int i = 0; i < 5; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(vv[i], pv[j], acc[i][j]);
    }
  };

  load_tile(0, 0);
  __syncthreads();  // q visible
  if constexpr (BF) {
    const __nv_bfloat16* q_s = reinterpret_cast<const __nv_bfloat16*>(q_raw);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __nv_bfloat16* rows = q_s + (warp * 32 + i * 16 + (lane & 15)) * ROW_BF;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) ldsm_x4(smem_u32(rows + kk * 16 + (lane >> 4) * 8), qa[i][kk]);
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
    if (tile + 1 < nk) load_tile((tile + 1) * TILE_K, stage ^ 1);
    zero_s();
    if constexpr (BF) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) qk_bf16_pair(stage, jp);
    } else {
      qk_f32(stage);
    }
    softmax();
    pv(vt);
    // bf16: the float32 V tile is rewritten by the next tile's conversion;
    // float32: the warp's p and alpha are rewritten by the next softmax
    if constexpr (BF) __syncthreads(); else __syncwarp();
  }

  // l to the PV layout; out = acc / l, rounded once; a warp's queries lie
  // wholly before or past Sq (Sq is a multiple of 64)
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) rows_w[i * 16 + r * 8 + g] = l[i][r];
  }
  __syncwarp();
  const int r0 = q0 + warp * 32;  // the warp's first query
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
  if constexpr (V == QmVariant::B) {
    // [BH, D, Sq]: an 8-query run of each of the thread's 5 d rows
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      T* og = out + (size_t(bh) * HEAD_D + (i < 4 ? dy * 4 + i : 32 + dy)) * sq + r0 + qx * 8;
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
      float* row = o_s + (qx * 8 + j) * HEAD_D;
      *reinterpret_cast<float4*>(row + dy * 4) = make_float4(o[0][j], o[1][j], o[2][j], o[3][j]);
      row[32 + dy] = o[4][j];
    }
    __syncwarp();
    T* og = out + (size_t(bh) * sq + r0) * HEAD_D;
    constexpr int EV = 16 / sizeof(T);  // elements a 16-byte vector
    for (int e = lane; e < 32 * HEAD_D / EV; e += 32) {
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

template <typename T, QmVariant V>
cudaError_t launch_qm(const void* q, const void* k, const void* v, void* out, int bh, int sq,
                      int sk, cudaStream_t stream) {
  auto kernel = flash_variant_qm_kernel<T, V>;
  const int smem = int(QmSmem<T>::bytes);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // JAX's 1 / D**0.5, rounded once; times log2(e) in double first where the
  // scale follows the product (row 9 d's c)
  const double sm_scale = 1.0 / sqrt(double(HEAD_D));
  const float scale = float(V == QmVariant::ABf16PV ? sm_scale : sm_scale * 1.4426950408889634);
  const dim3 grid((sq + BLOCK_Q - 1) / BLOCK_Q, bh);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(out), sq,
                                           sk, scale);
  return cudaGetLastError();
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

// Sq and Sk multiples of 64, D = 40, 32-bit offsets in an image, every
// operand 16-byte aligned (both kernels copy 16 bytes at a time)
bool takes(const void* q, const void* k, const void* v, const void* out, int bh, int sq, int sk,
           int d) {
  if (d != HEAD_D || bh < 1 || bh > 65535 || sq < 64 || sk < TILE_K || sq % 64 || sk % TILE_K)
    return false;
  if ((long long)(sq > sk ? sq : sk) * d > INT_MAX) return false;
  return aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out);
}

}  // namespace

// Plain C entry points for ctypes.  Each returns 0 on success, a cudaError_t
// code from the launch, or -1 for arguments the kernel does not take.

// Rows 9 a and b (the query-major kernel).  variant: 0 kern_a, 1 kern_a with
// pv_bf16 (float32 only; bf16: hedit_flash_variant_tc), 2 kern_b (3, kern_c:
// hedit_flash_variant_c); dtype: 0 float32, 1 bfloat16.  out is [BH, Sq, D]
// for variants 0 and 1, [BH, D, Sq] for 2.
extern "C" int hedit_flash_variant(const void* q, const void* k, const void* v, void* out,
                                   int bh, int sq, int sk, int d, int variant_code, int dtype,
                                   void* stream) {
  if (!takes(q, k, v, out, bh, sq, sk, d) || variant_code < 0 || variant_code > 3 || dtype < 0 ||
      dtype > 1)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF16 = __nv_bfloat16;
  switch (dtype * 4 + variant_code) {
    case 0: return int(launch_qm<float, QmVariant::A>(q, k, v, out, bh, sq, sk, s));
    case 1: return int(launch_qm<float, QmVariant::ABf16PV>(q, k, v, out, bh, sq, sk, s));
    case 2: return int(launch_qm<float, QmVariant::B>(q, k, v, out, bh, sq, sk, s));
    case 4: return int(launch_qm<BF16, QmVariant::A>(q, k, v, out, bh, sq, sk, s));
    case 6: return int(launch_qm<BF16, QmVariant::B>(q, k, v, out, bh, sq, sk, s));
    default: return -1;
  }
}

// Row 9 c (kern_c): q, k, v [BH, S, D] -> out [BH, D, Sq]; D = 40; dtype 0
// float32, 1 bfloat16; every operand 16-byte aligned.
extern "C" int hedit_flash_variant_c(const void* q, const void* k, const void* v, void* out,
                                     int bh, int sq, int sk, int d, int dtype, void* stream) {
  if (!takes(q, k, v, out, bh, sq, sk, d)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(launch_c<float>(q, k, v, out, bh, sq, sk, s));
    case 1: return int(launch_c<__nv_bfloat16>(q, k, v, out, bh, sq, sk, s));
    default: return -1;
  }
}
