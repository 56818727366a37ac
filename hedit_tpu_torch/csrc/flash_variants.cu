// Exact flash-attention forwards entirely in float32, in three layouts, for
// Hopper (sm_90a): the ports of the TPU kernels of scripts/flash_variants.py
// (entry point hedit_flash_variant, wrappers in ops/flash_probes.py):
//
//   kern_a           [BQ, D] accumulator, out [BH, Sq, D]    flash_variant_a_cuda
//   kern_a, pv_bf16  the same with p rounded to bf16 for PV  flash_variant_a_cuda(pv_bf16=True)
//   kern_b           [D, BQ] accumulator, out [BH, D, Sq]    flash_variant_b_cuda
//   kern_c           key-major [BK, BQ] scores, out [BH, D, Sq]  flash_variant_c_cuda
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
// * c: the score tile is computed and kept key-major, s_t[k][q] in shared
//   memory, by a thread grid that owns 4 keys x 8 queries; max and sum reduce
//   down the key axis (two threads a query column, a half of the keys each,
//   combined through shared memory), p overwrites s_t in place, and PV
//   contracts the key axis into the transposed accumulator of b.
//
// Contract: q [BH, Sq, D], k and v [BH, Sk, D], contiguous, one dtype
// (float32 or bfloat16; kern_a with pv_bf16 float32 only, bf16 on the
// tensor cores: hedit_flash_variant_tc in flash_probes_tc.cu); D = 40 (the
// probe's head dim); Sq and Sk multiples of the 64-row tile (the TPU grid
// covers whole blocks; nothing is masked).
//
// What bounds it: all of it is float32 arithmetic on the CUDA cores, 4 BH
// Sq Sk D FLOP against 67 TFLOP/s (the function's own rate: the TPU kernels
// cast to float32 before both products); 128 threads a block, 64 queries x
// 64 keys a tile, 48 KB of shared memory.

#include <climits>

#include "flash_common.cuh"

namespace {

// kern_a, kern_a with pv_bf16, kern_b, kern_c
enum class Variant { A, ABf16PV, B, C };

constexpr int TQ = 16, TK = 8, RQ = 4, RK = 8;  // a, b: score grid, 4 rows x 8 keys a thread
constexpr int BQ = TQ * RQ, BK = TK * RK;       // 64 x 64
constexpr int TKR = 16, TQC = 8, CK = 4, CQ = 8;  // c: key-major grid, 4 keys x 8 queries
constexpr int PS = BK + 1;                      // odd row stride of p [BQ][PS] (a, b)
constexpr int SS = BQ + 1;                      // odd row stride of s_t [BK][SS] (c)
constexpr float kNegInf = -1e30f;               // the TPU kernels' initial running max
static_assert(BQ == BK && TKR * CK == BK && TQC * CQ == BQ && TQ * TK == kThreads &&
              TKR * TQC == kThreads && 2 * BQ == kThreads, "tiles and thread grids agree");

template <int D>
struct Smem {
  static constexpr int DP = D | 1;  // odd row stride of the Q, K and V tiles
  static constexpr int tile = BQ * DP;
  // Q, K, V tiles; p or s_t; four rows of BQ for the per-column statistics
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
  float* w_s = v_s + Sm::tile;        // a, b: p [BQ][PS]; c: s_t and then p, [BK][SS]
  float* row_s = w_s + BQ * PS;       // [4][BQ]: b: alpha, l; c: two partial maxima, two sums

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const T* kg = k + size_t(bh) * sk * D;
  const T* vg = v + size_t(bh) * sk * D;
  load_rows<T, D>(q_s, q + size_t(bh) * sq * D, q0, scale);

  // transposed accumulator (b, c): query column qc, d rows h*ND .. (h+1)*ND;
  // in c also the half of the keys whose statistics the thread takes
  const int qc = tid % BQ, h = tid / BQ;
  const int nk = sk / BK;

  if constexpr (V == Variant::C) {
    const int kr = tid / TQC, qg8 = tid % TQC;
    float m = kNegInf, l = 0.f, acc_t[ND];
#pragma unroll
    for (int c = 0; c < ND; ++c) acc_t[c] = 0.f;
    for (int t = 0; t < nk; ++t) {
      __syncthreads();  // the previous tile's k / v / p reads are done
      load_rows<T, D>(k_s, kg, t * BK, 1.f);
      load_rows<T, D>(v_s, vg, t * BK, 1.f);
      __syncthreads();
      // s_t[key kr*CK + j][query qg8 + TQC*i]
      float st[CK][CQ];
#pragma unroll
      for (int j = 0; j < CK; ++j)
#pragma unroll
        for (int i = 0; i < CQ; ++i) st[j][i] = 0.f;
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        float kv[CK], qv[CQ];
#pragma unroll
        for (int j = 0; j < CK; ++j) kv[j] = k_s[(kr * CK + j) * DP + c];
#pragma unroll
        for (int i = 0; i < CQ; ++i) qv[i] = q_s[(qg8 + TQC * i) * DP + c];
#pragma unroll
        for (int j = 0; j < CK; ++j)
#pragma unroll
          for (int i = 0; i < CQ; ++i) st[j][i] = fmaf(kv[j], qv[i], st[j][i]);
      }
#pragma unroll
      for (int j = 0; j < CK; ++j)
#pragma unroll
        for (int i = 0; i < CQ; ++i) w_s[(kr * CK + j) * SS + qg8 + TQC * i] = st[j][i];
      __syncthreads();
      // the column's max down the key axis: each half of the keys, then both
      const int k_lo = h * (BK / 2), k_hi = k_lo + BK / 2;
      float mx = -CUDART_INF_F;
      for (int kk = k_lo; kk < k_hi; ++kk) mx = fmaxf(mx, w_s[kk * SS + qc]);
      row_s[h * BQ + qc] = mx;
      __syncthreads();
      const float m_new = fmaxf(m, fmaxf(row_s[qc], row_s[BQ + qc]));
      const float alpha = expf(m - m_new);
      float sum = 0.f;
      for (int kk = k_lo; kk < k_hi; ++kk) {
        const float p = expf(w_s[kk * SS + qc] - m_new);
        w_s[kk * SS + qc] = p;
        sum += p;
      }
      row_s[(2 + h) * BQ + qc] = sum;
      __syncthreads();
      l = l * alpha + (row_s[2 * BQ + qc] + row_s[3 * BQ + qc]);
      m = m_new;
      // acc_t[d][q] += v[k][d] p_t[k][q], contracting the key axis
#pragma unroll
      for (int c = 0; c < ND; ++c) acc_t[c] *= alpha;
      for (int kk = 0; kk < BK; ++kk) {
        const float p = w_s[kk * SS + qc];
#pragma unroll
        for (int c = 0; c < ND; ++c) acc_t[c] = fmaf(v_s[kk * DP + h * ND + c], p, acc_t[c]);
      }
    }
    T* og = out + (size_t(bh) * D + h * ND) * sq + q0 + qc;
#pragma unroll
    for (int c = 0; c < ND; ++c) og[size_t(c) * sq] = from_float<T>(acc_t[c] / l);
  } else {
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

}  // namespace

// Plain C entry point for ctypes.  variant: 0 kern_a, 1 kern_a with
// pv_bf16 (float32 only; bf16: hedit_flash_variant_tc), 2 kern_b, 3
// kern_c; dtype: 0 float32, 1 bfloat16.  out is
// [BH, Sq, D] for variants 0 and 1, [BH, D, Sq] for 2 and 3.  Returns 0 on
// success, a cudaError_t code from the launch, or -1 for arguments the
// kernel does not take.
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
    case 3: return variant<Variant::C>(q, k, v, out, bh, sq, sk, dtype, s);
    default: return -1;
  }
}
