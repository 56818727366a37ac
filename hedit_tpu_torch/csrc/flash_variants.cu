// Exact flash-attention forwards in float32, in three layouts, for Hopper
// (sm_90a): the ports of the TPU kernels of scripts/flash_variants.py
// (wrappers in ops/flash_probes.py):
//
//   kern_a           [BQ, D] accumulator, out [BH, Sq, D]    flash_variant_a_cuda
//   kern_a, pv_bf16  the same with p rounded to bf16 for PV  flash_variant_a_cuda(pv_bf16=True)
//   kern_b           [D, BQ] accumulator, out [BH, D, Sq]    flash_variant_b_cuda
//     (entry point hedit_flash_variant, the CUDA-core template below)
//   kern_c (:87)     key-major [BK, BQ] scores, out [BH, D, Sq]  flash_variant_c_cuda
//     (entry point hedit_flash_variant_c, flash_variant_c_kernel at the end)
//
// Their arithmetic is the TPU kernels': q upcast and times sm_scale = 1/sqrt(D)
// in float32 (NOT rounded to the input dtype), k and v upcast, float32
// scores, a running max m starting at -1e30, p = exp(s - m_new) with the
// natural exp, alpha = exp(m_old - m_new), l = l * alpha + sum(p) and
// out = acc / l rounded to the input dtype.  With pv_bf16 the PV product
// takes p rounded to bfloat16 (whatever the input dtype: with float32 inputs
// JAX promotes the product to float32, so only p is rounded); the row sum
// still takes the unrounded p.  The running max moves once a 64-key tile
// (the TPU kernels' BLK_K is 512): without pv_bf16 that moves the output by
// float32 rounding only, with it p is rounded against another point.
//
// The three layouts differ in code, as on the TPU:
// * a: the 16 x 8 thread grid owns 4 query rows x 8 keys of the score tile
//   and 4 rows x D/8 columns of the accumulator: the softmax statistics and
//   the rescale stay in the owner's registers; the [64][D] result is staged
//   in shared memory and stored as one contiguous run.
// * b: the scores and softmax as a, but the accumulator is transposed: a
//   thread owns one query column and D/2 of its d rows (acc_t[d][q]), reads
//   its row's alpha from shared memory, and stores D runs of 64 queries
//   coalesced along S, with no staging.
// * c (its own kernel, flash_variant_c_kernel, described before it): the
//   scores kept key-major, s_t[k][q], the softmax taken down the key axis,
//   PV contracting the key axis into a transposed accumulator.
//
// Contract: q [BH, Sq, D], k and v [BH, Sk, D], contiguous, one dtype
// (float32 or bfloat16; kern_a with pv_bf16 float32 only, bf16 on the
// tensor cores: hedit_flash_variant_tc in flash_probes_tc.cu); D = 40 (the
// probe's head dim); Sq and Sk multiples of the 64-row tile (the TPU grid
// covers whole blocks; nothing is masked).
//
// What bounds the template (a, b): all of it is float32 arithmetic on the
// CUDA cores, 4 BH Sq Sk D FLOP against 67 TFLOP/s (the function's own rate:
// the TPU kernels cast to float32 before both products); 128 threads a
// block, 64 queries x 64 keys a tile, 48 KB of shared memory.

#include <climits>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

// kern_a, kern_a with pv_bf16, kern_b (kern_c: flash_variant_c_kernel below)
enum class Variant { A, ABf16PV, B };

constexpr int TQ = 16, TK = 8, RQ = 4, RK = 8;  // a, b: score grid, 4 rows x 8 keys a thread
constexpr int BQ = TQ * RQ, BK = TK * RK;       // 64 x 64
constexpr int PS = BK + 1;                      // odd row stride of p [BQ][PS] (a, b)
constexpr float kNegInf = -1e30f;               // the TPU kernels' initial running max
static_assert(BQ == BK && TQ * TK == kThreads && 2 * BQ == kThreads,
              "tiles and thread grids agree");

template <int D>
struct Smem {
  static constexpr int DP = D | 1;  // odd row stride of the Q, K and V tiles
  static constexpr int tile = BQ * DP;
  // Q, K, V tiles; p; four rows of BQ for the per-column statistics
  static constexpr size_t bytes = sizeof(float) * (3 * tile + BQ * PS + 4 * BQ);
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Rows r0 .. r0 + 64 of one [S, D] image into dst [64][DP] in float32, each
// element times scale (q) or as it is (k, v).
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* __restrict__ dst, const T* __restrict__ img,
                                          int r0, float scale) {
  constexpr int DP = Smem<D>::DP;
  const T* src = img + size_t(r0) * D;
  for (int e = threadIdx.x; e < BQ * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    const float x = to_float(src[e]);
    dst[r * DP + c] = scale != 1.f ? x * scale : x;
  }
}

template <typename T, Variant V, int D>
__global__ void __launch_bounds__(kThreads)
flash_variant_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, int sq, int sk, float scale) {
  using Sm = Smem<D>;
  constexpr int DP = Sm::DP, NC = D / TK, ND = D / 2;
  static_assert(NC * TK == D && 2 * ND == D, "the head dim splits over the thread grids");

  extern __shared__ float smem[];
  float* q_s = smem;                  // [BQ][DP], q * scale
  float* k_s = q_s + Sm::tile;        // [BK][DP]
  float* v_s = k_s + Sm::tile;        // [BK][DP]
  float* w_s = v_s + Sm::tile;        // p [BQ][PS]
  float* row_s = w_s + BQ * PS;       // [4][BQ]: b: alpha, l

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const T* kg = k + size_t(bh) * sk * D;
  const T* vg = v + size_t(bh) * sk * D;
  load_rows<T, D>(q_s, q + size_t(bh) * sq * D, q0, scale);

  // transposed accumulator (b): query column qc, d rows h*ND .. (h+1)*ND
  const int qc = tid % BQ, h = tid / BQ;
  const int nk = sk / BK;

  constexpr bool transposed = V == Variant::B;
  const int tq = tid / TK, tk = tid % TK;
  float m_i[RQ], l_i[RQ], acc[RQ][NC], acc_t[ND];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < ND; ++c) acc_t[c] = 0.f;
  for (int t = 0; t < nk; ++t) {
    __syncthreads();  // the previous tile's k / v / p / alpha reads are done
    load_rows<T, D>(k_s, kg, t * BK, 1.f);
    load_rows<T, D>(v_s, vg, t * BK, 1.f);
    __syncthreads();
    // s[query tq*RQ + i][key tk + TK*j]
    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[RQ], kv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = q_s[(tq * RQ + i) * DP + c];
#pragma unroll
      for (int j = 0; j < RK; ++j) kv[j] = k_s[(tk + TK * j) * DP + c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
    // row statistics across the TK lanes that share a row
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < RK; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = TK / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = expf(s[i][j] - m_new);
        w_s[(tq * RQ + i) * PS + tk + TK * j] = V == Variant::ABf16PV ? round_bf16(p) : p;
        sum += p;
      }
#pragma unroll
      for (int off = TK / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i[i] = l_i[i] * alpha + sum;
      m_i[i] = m_new;
      if (transposed) {
        if (tk == 0) row_s[tq * RQ + i] = alpha;
      } else {
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      }
    }
    __syncthreads();
    if (transposed) {
      // acc_t[d][q] = acc_t * alpha + v^T p^T: one query column, D/2 rows
      const float alpha = row_s[qc];
#pragma unroll
      for (int c = 0; c < ND; ++c) acc_t[c] *= alpha;
      for (int j = 0; j < BK; ++j) {
        const float p = w_s[qc * PS + j];
#pragma unroll
        for (int c = 0; c < ND; ++c) acc_t[c] = fmaf(p, v_s[j * DP + h * ND + c], acc_t[c]);
      }
    } else {
      for (int j = 0; j < BK; ++j) {
        float pv[RQ], vv[NC];
#pragma unroll
        for (int i = 0; i < RQ; ++i) pv[i] = w_s[(tq * RQ + i) * PS + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) vv[c] = v_s[j * DP + tk + TK * c];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
      }
    }
  }
  __syncthreads();  // every read of the tiles is done
  if (transposed) {
    if (tk == 0) {
#pragma unroll
      for (int i = 0; i < RQ; ++i) row_s[BQ + tq * RQ + i] = l_i[i];
    }
    __syncthreads();
    const float l = row_s[BQ + qc];
    T* og = out + (size_t(bh) * D + h * ND) * sq + q0 + qc;
#pragma unroll
    for (int c = 0; c < ND; ++c) og[size_t(c) * sq] = from_float<T>(acc_t[c] / l);
  } else {
    // stage the [BQ][D] result over Q's tile, then one contiguous run
    float* o_s = q_s;
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) o_s[(tq * RQ + i) * DP + tk + TK * c] = acc[i][c] / l_i[i];
    __syncthreads();
    T* og = out + (size_t(bh) * sq + q0) * D;
    for (int e = tid; e < BQ * D; e += kThreads) {
      const int r = e / D, c = e - r * D;
      og[e] = from_float<T>(o_s[r * DP + c]);
    }
  }
}

template <typename T, Variant V>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int bh, int sq,
                   int sk, cudaStream_t stream) {
  constexpr int D = 40;
  auto kernel = flash_variant_kernel<T, V, D>;
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const float scale = float(1.0 / sqrt(double(D)));  // JAX's 1 / D**0.5, rounded once
  const dim3 grid(sq / BQ, bh);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(out), sq,
                                           sk, scale);
  return cudaGetLastError();
}

template <Variant V>
int variant(const void* q, const void* k, const void* v, void* out, int bh, int sq, int sk,
            int dtype, cudaStream_t stream) {
  if constexpr (V == Variant::ABf16PV) {  // bf16: flash_probes_tc.cu
    if (dtype) return -1;
    return int(launch<float, V>(q, k, v, out, bh, sq, sk, stream));
  } else {
    return int(dtype ? launch<__nv_bfloat16, V>(q, k, v, out, bh, sq, sk, stream)
                     : launch<float, V>(q, k, v, out, bh, sq, sk, stream));
  }
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
// What bounds it: PV, 2 BH Sq Sk D FLOP of float32 FMAs at 67 TFLOP/s
// (0.641 ms at the probe's [32, 4096, 40]); QK, as many FLOP of bf16 products
// at 989 (0.043 ms) or, with float32 inputs, of float32 FMAs (then both
// products at 67: 0.320 ms at [8, 4096, 40]); the bytes (21 MB) are ~6 us.
// So the design keeps the CUDA cores busy with PV FMAs:
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

constexpr int KC_Q = 128;           // queries a block
constexpr int KC_K = 64;            // keys a tile
constexpr int KC_D = 40;            // the head dim
constexpr int KC_DK = 48;           // bf16: the contraction padded to three k16 steps
constexpr int KC_NT = KC_Q / 8;     // score n-tiles (8 queries each) of a warp
constexpr int KC_PS = KC_Q + 8;     // p_t [KC_K][KC_PS] and float32 q^T [KC_D][KC_PS]
constexpr int KC_BS = KC_DK + 8;    // bf16 q and K rows, [.][KC_BS]
constexpr int KC_FS = KC_D + 4;     // float32 K rows, [KC_K][KC_FS]
static_assert(KC_K == 16 * 4 && kThreads == KC_Q && KC_D == 5 * 8,
              "4 warps of 16 keys; one stats thread a query; 8 x 5 d rows");

template <typename T>
struct KcSmem {
  static constexpr bool bf = sizeof(T) == 2;
  // bytes of each region, in order: q (bf16 [KC_Q][KC_BS], float32 q^T
  // [KC_D][KC_PS]); the K ring; the V ring (as the input type); the float32
  // V tile (bf16 only); p_t; four rows of partial statistics, m and alpha
  static constexpr size_t q = bf ? 2 * KC_Q * KC_BS : 4 * KC_D * KC_PS;
  static constexpr size_t k_stage = bf ? 2 * KC_K * KC_BS : 4 * KC_K * KC_FS;
  static constexpr size_t v_stage = sizeof(T) * KC_K * KC_D;
  static constexpr size_t v32 = bf ? 4 * KC_K * KC_D : 0;
  static constexpr size_t p = 4 * KC_K * KC_PS;
  static constexpr size_t stats = 4 * 6 * KC_Q;
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
  float* red_s = p_s + KC_K * KC_PS;  // [4][KC_Q]: each warp's column max, then sum
  float* m_s = red_s + 4 * KC_Q;      // [KC_Q]: the tile's new running max
  float* a_s = m_s + KC_Q;            // [KC_Q]: alpha; at the end l

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;                // the fragments' row group, column pair
  const int tx = lane & 15, ty = warp * 2 + (lane >> 4);  // PV: queries tx*4, d rows ty*4, 32 + ty
  const int bh = blockIdx.y, q0 = blockIdx.x * KC_Q;
  const T* qg = q + size_t(bh) * sq * KC_D;
  const T* kg = k + size_t(bh) * sk * KC_D;
  const T* vg = v + size_t(bh) * sk * KC_D;
  constexpr int CH = KC_D * int(sizeof(T)) / 16;  // 16-byte chunks of a row: 5 or 10

  // q, once: bf16 [query][d] with d 40 .. 48 zero, as it lies (the scale
  // follows the product); float32 transposed, q^T [d][query].  Queries past
  // Sq are zero.  The K ring's bf16 pad columns are zeroed once.
  if constexpr (BF) {
    __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(q_raw);
    for (int e = tid; e < KC_Q * (KC_DK / 8); e += kThreads) {
      const int r = e / (KC_DK / 8), c = e - r * (KC_DK / 8);
      uint4 x = make_uint4(0, 0, 0, 0);
      if (c < CH && q0 + r < sq) x = *reinterpret_cast<const uint4*>(qg + (q0 + r) * KC_D + c * 8);
      *reinterpret_cast<uint4*>(q_s + r * KC_BS + c * 8) = x;
    }
    for (int r = tid; r < 2 * KC_K; r += kThreads)
      *reinterpret_cast<uint4*>(reinterpret_cast<__nv_bfloat16*>(k_raw) + r * KC_BS + KC_D) =
          make_uint4(0, 0, 0, 0);
  } else {
    float* q_s = reinterpret_cast<float*>(q_raw);
    for (int e = tid; e < KC_Q * CH; e += kThreads) {
      const int r = e % KC_Q, c = e / KC_Q;  // consecutive threads, consecutive queries
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < sq) x = *reinterpret_cast<const float4*>(qg + (q0 + r) * KC_D + c * 4);
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
    constexpr int row_bytes = BF ? 2 * KC_BS : 4 * KC_FS;
    for (int e = tid; e < KC_K * CH; e += kThreads) {
      const int r = e / CH, c = e - r * CH;
      cp_async_16(smem_u32(kd + r * row_bytes + c * 16), kg + (k0 + r) * KC_D + c * (16 / sizeof(T)),
                  true);
      cp_async_16(smem_u32(vd + e * 16), vg + size_t(k0) * KC_D + e * (16 / sizeof(T)), true);
    }
    cp_async_commit();
  };

  float m = kNegInf, l = 0.f, alpha = 1.f;  // thread tid's query: the running max (of s2), sum
  float acc[5][8];
#pragma unroll
  for (int i = 0; i < 5; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = sk / KC_K;
  load_tile(0, 0);
  for (int tile = 0; tile < nk; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < nk) {
      load_tile((tile + 1) * KC_K, stage ^ 1);
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
      for (int kk = 0; kk < KC_DK / 16; ++kk) {
        unsigned a[4];  // K: m = the warp's 16 keys, k = d
        ldsm_x4(smem_u32(kt + (warp * 16 + (lane & 15)) * KC_BS + kk * 16 + (lane >> 4) * 8), a);
#pragma unroll
        for (int jp = 0; jp < KC_NT / 2; ++jp) {
          unsigned b[4];  // q [query][d]: the col layout of B (k = d, n = queries)
          ldsm_x4(smem_u32(q_s + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * KC_BS + kk * 16 +
                           ((lane >> 3) & 1) * 8),
                  b);
          mma_bf16(s[2 * jp], a, b[0], b[1]);
          mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
        }
      }
    } else {
      const float* q_s = reinterpret_cast<const float*>(q_raw);
      const float* kt = reinterpret_cast<const float*>(k_raw + stage * Sm::k_stage) +
                        (warp * 16 + g) * KC_FS;
#pragma unroll 4
      for (int c = 0; c < KC_D; ++c) {
        const float k0 = kt[c], k1 = kt[8 * KC_FS + c];
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
    float* red_w = red_s + warp * KC_Q + 16 * g + 2 * t;  // this lane's four columns
    *reinterpret_cast<float2*>(red_w) = make_float2(col[0], col[1]);
    *reinterpret_cast<float2*>(red_w + 8) = make_float2(col[2], col[3]);
    __syncthreads();
    {
      const float mx = fmaxf(fmaxf(red_s[tid], red_s[KC_Q + tid]),
                             fmaxf(red_s[2 * KC_Q + tid], red_s[3 * KC_Q + tid]));
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
      for (int e = tid; e < KC_K * KC_D / 2; e += kThreads)
        *reinterpret_cast<float2*>(v32_s + 2 * e) = __bfloat1622float2(vb[e]);
      vt = v32_s;
    } else {
      vt = reinterpret_cast<const float*>(v_raw + stage * Sm::v_stage);
    }
    __syncthreads();
    l = l * alpha + ((red_s[tid] + red_s[KC_Q + tid]) + (red_s[2 * KC_Q + tid] +
                                                         red_s[3 * KC_Q + tid]));
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
    for (int kk = 0; kk < KC_K; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(p_s + kk * KC_PS + tx * 4);
      const float4 pb = *reinterpret_cast<const float4*>(p_s + kk * KC_PS + 64 + tx * 4);
      const float pv[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      const float4 va = *reinterpret_cast<const float4*>(vt + kk * KC_D + ty * 4);
      const float vv[5] = {va.x, va.y, va.z, va.w, vt[kk * KC_D + 32 + ty]};
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
    T* og = out + (size_t(bh) * KC_D + (i < 4 ? ty * 4 + i : 32 + ty)) * sq + q0;
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
  const float scale = float(1.0 / sqrt(double(KC_D)) * 1.4426950408889634);
  const dim3 grid((sq + KC_Q - 1) / KC_Q, bh);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(out), sq,
                                           sk, scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

}  // namespace

// Plain C entry points for ctypes.  Each returns 0 on success, a cudaError_t
// code from the launch, or -1 for arguments the kernel does not take.

// The template.  variant: 0 kern_a, 1 kern_a with pv_bf16 (float32 only;
// bf16: hedit_flash_variant_tc), 2 kern_b (3, kern_c: hedit_flash_variant_c);
// dtype: 0 float32, 1 bfloat16.  out is [BH, Sq, D] for variants 0 and 1,
// [BH, D, Sq] for 2.
extern "C" int hedit_flash_variant(const void* q, const void* k, const void* v, void* out,
                                   int bh, int sq, int sk, int d, int variant_code, int dtype,
                                   void* stream) {
  if (d != 40 || bh < 1 || bh > 65535 || sq < BQ || sk < BK || sq % BQ || sk % BK) return -1;
  if ((long long)(sq > sk ? sq : sk) * d > INT_MAX) return -1;  // 32-bit offsets in an image
  if (dtype != 0 && dtype != 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant_code) {
    case 0: return variant<Variant::A>(q, k, v, out, bh, sq, sk, dtype, s);
    case 1: return variant<Variant::ABf16PV>(q, k, v, out, bh, sq, sk, dtype, s);
    case 2: return variant<Variant::B>(q, k, v, out, bh, sq, sk, dtype, s);
    default: return -1;
  }
}

// Row 9 c (kern_c): q, k, v [BH, S, D] -> out [BH, D, Sq]; D = 40; dtype 0
// float32, 1 bfloat16; every operand 16-byte aligned.
extern "C" int hedit_flash_variant_c(const void* q, const void* k, const void* v, void* out,
                                     int bh, int sq, int sk, int d, int dtype, void* stream) {
  if (d != KC_D || bh < 1 || bh > 65535 || sq < 64 || sk < KC_K || sq % 64 || sk % KC_K)
    return -1;
  if ((long long)(sq > sk ? sq : sk) * d > INT_MAX) return -1;  // 32-bit offsets in an image
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out))) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(launch_c<float>(q, k, v, out, bh, sq, sk, s));
    case 1: return int(launch_c<__nv_bfloat16>(q, k, v, out, bh, sq, sk, s));
    default: return -1;
  }
}
