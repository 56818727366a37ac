// Flash-attention forward for Hopper (sm_90a): softmax(q k^T / sqrt(d)) v,
// and the same forward with the per-query log-sum-exp as a second output.
//
// Replaces the TPU kernels hedit_tpu/ops/flash_attention.py:_flash_bounded_kernel
// (wrapper flash_attention_bounded, reached through
// hedit_tpu/ops/attention.py:fused_attention) and, with the second output,
// _flash_bounded_lse_kernel (wrapper _flash_bounded_fwd_lse, the forward of
// flash_attention_diff).  One template serves both: the online softmax
// already carries the running row max m and row sum l in base-2 units, so the
// log-sum-exp the backward kernels need is lse2 = m + log2(l), written only
// when the caller passes a buffer for it.
//
// Contract: q [BH, Sq, D], k and v [BH, Sk, D], contiguous, all of one dtype
// (float32 or bfloat16); out [BH, Sq, D] in that dtype; lse2 [BH, Sq] float32
// or null.  Any Sq, Sk
// >= 1 (ragged tails are masked here); D is one of the head dims of SD-1.5:
// 40 and 80 (UNet self-attention) or 512 (VAE mid-block).  Each has its own
// tile shape below, and any other D is refused.
//
// Softmax form: exact online softmax (running row max and rescale) in base 2,
// with the scale 1/sqrt(d) * log2(e) folded into q.  The TPU kernel's
// max-free "bounded" shift was a VPU-saving trick; it agrees with this form
// wherever no key scores 116 log2-units above block 0's row max, and this
// form needs no such premise.
//
// What bounds it on the H100.  The UNet's self-attention at [rows, 8, 4096,
// 40] does 2 * 4096 * 4096 * 40 * 2 FLOP per (row, head) against 1.3 MB of
// q, k, v and out in bf16: about 2,000 FLOP per byte, far above the ~295
// FLOP/byte balance point of an H100 SXM (data sheet, 700 W), so the kernel
// is bound by arithmetic, not by device memory.  This first version does its
// arithmetic in float32 on the CUDA cores (67 TFLOP/s peak on the data
// sheet), not on the tensor cores (989 TFLOP/s bf16): its limit is the rate at
// which shared memory feeds the FMAs.  The design answers that with register
// tiling: each thread owns an RQ x RK tile of scores and an RQ x NC tile of
// the output, so every shared-memory word it loads feeds several FMAs, and
// the output accumulator never leaves registers.  Odd row strides keep the
// strided shared-memory reads free of bank conflicts.  Tensor cores (mma /
// wgmma) and TMA loads are the next step.
//
// Block layout: 128 threads as a TQ x TK grid (tid = tq * TK + tk).  A block
// owns BQ = TQ * RQ query rows of one (batch, head) and loops over key tiles
// of BK = TK * RK keys.  Thread (tq, tk) owns query rows tq*RQ + i (i < RQ),
// key columns tk + TK*j (j < RK) of the score tile, and output columns
// tk + TK*c (c < NC) of its rows.  The TK threads that share a row are
// consecutive lanes of one warp, so row max and row sum are warp shuffles.

#include "flash_common.cuh"

namespace {

// Shared-memory row strides.  Q and K rows are read with a stride across the
// lanes of a warp, so their stride is odd (odd_stride); V rows are
// read along the row and hold DV = TK * NC columns, which launch() checks to
// be D.
template <int TQ, int TK, int RQ, int RK, int NC>
struct Tile {
  static constexpr int BQ = TQ * RQ;
  static constexpr int BK = TK * RK;
  static constexpr int DV = TK * NC;  // V row: every column a thread owns
  static constexpr int PS = BK + 1;   // odd P row stride
  static_assert(TQ * TK == kThreads, "tile must use every thread once");

  static size_t smem_bytes(int d) {
    const int dp = odd_stride(d);
    return sizeof(float) * (size_t(BQ) * dp + size_t(BK) * dp + size_t(BK) * DV +
                            size_t(BQ) * PS);
  }
};

template <typename T, int TQ, int TK, int RQ, int RK, int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int sq, int sk, int d, float qscale) {
  using Cfg = Tile<TQ, TK, RQ, RK, NC>;
  constexpr int BQ = Cfg::BQ, BK = Cfg::BK, DV = Cfg::DV, PS = Cfg::PS;

  extern __shared__ float smem[];
  const int dp = odd_stride(d);
  float* q_s = smem;              // [BQ][dp], pre-scaled
  float* k_s = q_s + BQ * dp;     // [BK][dp]
  float* v_s = k_s + BK * dp;     // [BK][DV]
  float* p_s = v_s + BK * DV;     // [BQ][PS]

  const int tid = threadIdx.x;
  const int tq = tid / TK;
  const int tk = tid % TK;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;

  const T* qg = q + (size_t(bh) * sq + q0) * d;
  const T* kg = k + size_t(bh) * sk * d;
  const T* vg = v + size_t(bh) * sk * d;

  for (int e = tid; e < BQ * d; e += kThreads) {
    const int r = e / d, c = e - r * d;
    q_s[r * dp + c] = (q0 + r < sq) ? to_float(qg[e]) * qscale : 0.f;
  }

  float acc[RQ][NC];
  float m_i[RQ], l_i[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m_i[i] = -CUDART_INF_F;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < sk; k0 += BK) {
    __syncthreads();  // previous tile's k_s / v_s / p_s reads are done
    for (int e = tid; e < BK * d; e += kThreads) {
      const int r = e / d, c = e - r * d;
      const bool ok = k0 + r < sk;
      const size_t g = size_t(k0) * d + e;
      k_s[r * dp + c] = ok ? to_float(kg[g]) : 0.f;
      v_s[r * DV + c] = ok ? to_float(vg[g]) : 0.f;
    }
    __syncthreads();

    // scores (base 2): s[i][j] = q_s[row i] . k_s[col j]
    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[RQ], kv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = q_s[(tq * RQ + i) * dp + c];
#pragma unroll
      for (int j = 0; j < RK; ++j) kv[j] = k_s[(tk + TK * j) * dp + c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax per row; the TK lanes of a row reduce by shuffles
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        if (k0 + tk + TK * j >= sk) s[i][j] = -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = TK / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // key 0 is always valid (sk >= 1), so m_new is finite from tile 0 on
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = exp2f(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        p_s[(tq * RQ + i) * PS + tk + TK * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = TK / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i[i] = l_i[i] * alpha + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc[i][c] += sum_j p[row i][j] * v[j][col c]
    for (int j = 0; j < BK; ++j) {
      float pv[RQ], vv[NC];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = p_s[(tq * RQ + i) * PS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = v_s[j * DV + tk + TK * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* og = out + (size_t(bh) * sq + q0) * d;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = tq * RQ + i;
    if (q0 + r >= sq) continue;
    const float inv_l = 1.f / l_i[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      og[size_t(r) * d + tk + TK * c] = from_float<T>(acc[i][c] * inv_l);
    }
    if (lse != nullptr && tk == 0) lse[size_t(bh) * sq + q0 + r] = m_i[i] + log2f(l_i[i]);
  }
}

template <typename T, int TQ, int TK, int RQ, int RK, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   int bh, int sq, int sk, int d, cudaStream_t stream) {
  using Cfg = Tile<TQ, TK, RQ, RK, NC>;
  auto kernel = flash_fwd_kernel<T, TQ, TK, RQ, RK, NC>;
  if (d != Cfg::DV) return cudaErrorInvalidValue;
  const size_t smem = Cfg::smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + Cfg::BQ - 1) / Cfg::BQ, bh);
  const float qscale = kLog2e / sqrtf(float(d));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, sq, sk, d, qscale);
  return cudaGetLastError();
}

// One tile shape a head dim.  d=40 and d=80 (the UNet): 64 queries x 64
// keys, 4 x 8 scores and 4 x d/8 outputs a thread.  d=512 (the VAE mid
// block): 16 queries x 32 keys, 4 x 1 scores and 4 x 16 outputs a thread,
// which keeps shared memory under 170 KB.
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, float* lse,
                     int bh, int sq, int sk, int d, cudaStream_t s) {
  switch (d) {
    case 40: return launch<T, 16, 8, 4, 8, 5>(q, k, v, out, lse, bh, sq, sk, d, s);
    case 80: return launch<T, 16, 8, 4, 8, 10>(q, k, v, out, lse, bh, sq, sk, d, s);
    case 512: return launch<T, 4, 32, 4, 1, 16>(q, k, v, out, lse, bh, sq, sk, d, s);
    default: return cudaErrorInvalidValue;
  }
}

int forward(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
            int sq, int sk, int d, int dtype, void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || bh > 65535) return -1;
  if (d != 40 && d != 80 && d != 512) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(dispatch<float>(q, k, v, out, lse, bh, sq, sk, d, s));
    case 1: return int(dispatch<__nv_bfloat16>(q, k, v, out, lse, bh, sq, sk, d, s));
    default: return -1;
  }
}

}  // namespace

// Plain C entry points for ctypes.  dtype: 0 float32, 1 bfloat16.
// Each returns 0 on success, a cudaError_t code from the launch, or -1 for
// arguments the kernel does not take.
extern "C" int hedit_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* out, int bh,
                                         int sq, int sk, int d, int dtype,
                                         void* stream) {
  return forward(q, k, v, out, nullptr, bh, sq, sk, d, dtype, stream);
}

// The same forward, also writing lse2 [BH, Sq] float32 (base-2 log-sum-exp of
// the scaled scores of each query).
extern "C" int hedit_flash_attention_fwd_lse(const void* q, const void* k,
                                             const void* v, void* out, void* lse,
                                             int bh, int sq, int sk, int d,
                                             int dtype, void* stream) {
  if (lse == nullptr) return -1;
  return forward(q, k, v, out, static_cast<float*>(lse), bh, sq, sk, d, dtype, stream);
}
