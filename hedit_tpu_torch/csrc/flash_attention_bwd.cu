// Flash-attention backward for Hopper (sm_90a): dq, dk and dv of
// out = softmax(q k^T / sqrt(d)) v from the saved per-query log-sum-exp.
//
// The first port of the TPU kernels hedit_tpu/ops/flash_attention.py:
// _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel (wrapper _flash_bwd_pallas,
// the backward of flash_attention_diff), which carry every mode that
// differentiates through the UNet (NMG, null-text, the style and face
// rewards).  No wrapper launches it: bwd_entry sends bf16 at every head dim
// to the tensor-core kernels of flash_attention_bwd_tc.cu, float32 at D = 40
// / 80 to the fused kernel of flash_attention_bwd_f32.cu and float32 at the
// VAE's D = 512 to flash_attention_bwd_f32_512.cu.  Its float32 D = 512 and
// bf16 (D = 40, 80, 512) instances stay, launched only by their entry points,
// so that the smoke and the tile probes can time the template beside the
// kernels that replaced it on the same inputs; the float32 ones at D = 40 /
// 80 are gone.
//
// With s2 = (q k^T) * scale * log2(e), lse2 the forward's base-2 log-sum-exp
// of each query row and delta = rowsum(dO * O) (computed outside, in plain
// tensor code, as the JAX package does):
//
//   p  = exp2(s2 - lse2)                  the forward's probabilities, rebuilt
//   dp = dO v^T
//   ds = p * (dp - delta)
//   dq = ds k * scale      dk = ds^T q * scale      dv = p^T dO
//
// bf16 inputs take the TPU kernels' roundings: q * scale * log2(e) in dq and
// k * scale * log2(e) in dk/dv rounded to bf16 at load (the scale itself
// rounded first), ds rounded to bf16 before its product on each side, and p
// rounded to bf16 for dv = p^T dO only; everything else float32.  In float32
// nothing is rounded.
//
// The forward (row 3) is the bounded, max-free one, and this backward, like
// the TPU's, ignores its clamp: p is rebuilt as exp2(s2 - lse2) from the
// forward's lse2, which is the forward's p wherever no key saturates.  Both
// packages do the same.
//
// Contract: q, dO [BH, Sq, D]; k, v [BH, Sk, D]; lse2, delta [BH, Sq]
// float32; all contiguous; q, k, v, dO of one dtype (float32 or bfloat16);
// dq, dk, dv in that dtype.  Any Sq, Sk >= 1: padded keys are masked out of
// dq and padded queries out of dk and dv.  D is 512 (the VAE's mid-block
// attention, which the style reward differentiates through the decoder) in
// either dtype, or 40 or 80 (the UNet's self-attention) in bf16; anything
// else is refused.
//
// What bounds them on the H100.  dq is three products over the Sq x Sk score
// grid (s, dp, ds k) and dk/dv four (s, dp, p^T dO, ds^T q): 14 * Sq * Sk * D
// FLOP a (batch, head) against the forward's 4.  At [1, 8, 4096, 40] that is
// 75 GFLOP over 21 MB of inputs and outputs in bf16, about 3,500 FLOP per
// byte, far above the ~295 FLOP/byte balance point of an H100 SXM (data sheet,
// 700 W): both kernels are bound by arithmetic.  This template does its
// arithmetic in float32 on the CUDA cores (67 TFLOP/s peak), so its limit is
// the rate at which shared memory feeds the FMAs, and the design is the
// forward's register tiling: each thread owns a 4 x 8 tile of the score grid
// and a 4 x D/8 tile of each output, so every shared-memory word feeds
// several FMAs and the gradients accumulate in registers.  The tensor-core
// kernels of flash_attention_bwd_tc.cu (bf16, D = 40, 80 and 512) and the
// fused float32 kernel of flash_attention_bwd_f32.cu (D = 40 / 80, 5
// products, not 7) replace it on the paths.
//
// D = 512 cannot keep that tile: 4 x 64 floats an output, two outputs in
// dk/dv, is more than a thread's 255 registers.  Its blocks own 16 rows, not
// 64, and stream 32-row tiles; a warp's 32 lanes share one score row each
// (4 x 1 scores a thread) and split the 512 output columns (4 x 16 of each
// output a thread: 64 registers for dq, 128 for dk and dv).  The four
// [rows][513] float32 tiles then take ~197 KB of shared memory, so one block
// runs on an SM at a time: a simple design, held to the plain version.  In
// bf16 at [1, 1, 4096, 512] it ran 3.3x slower than SDPA's backward, and the
// tensor-core kernels replaced it there (PERF.md).
//
// The TPU programs keep K/V (dq) or Q/dO (dk, dv) of a whole (batch, head)
// resident in VMEM and walk 512 x 512 blocks.  Here a block owns 64 rows (16
// at D = 512) of the gradient it writes and streams tiles of the other side
// through shared memory:
//
// * dq: a block owns queries of one (batch, head) and loops over key tiles;
// * dk, dv: a block owns keys and loops over query tiles.
//
// Every output element is written by exactly one thread of one block: no
// atomics and no reduction across blocks, so results do not change from run
// to run.
//
// Block layout (both kernels): 128 threads as a TR x TC grid (tid = tr * TC +
// tc).  Thread (tr, tc) owns rows tr*RR + i (i < RR) of the block's own
// rows, columns tc + TC*j (j < RC) of the streamed tile, and output columns
// tc + TC*c (c < NC = D / TC) of its rows.

#include <type_traits>

#include "flash_common.cuh"

namespace {

template <int TR, int TC, int RR, int RC, int NC>
struct BwdTile {
  static constexpr int BR = TR * RR;   // rows the block owns
  static constexpr int BC = TC * RC;   // rows of a streamed tile
  static constexpr int D = TC * NC;
  static constexpr int PS = BC + 1;    // odd row stride of a [BR][BC] tile
  static_assert(TR * TC == kThreads, "tile must use every thread once");

  static size_t dq_smem_bytes() {
    const int dp = odd_stride(D);
    return sizeof(float) * (size_t(2 * BR + 2 * BC) * dp + size_t(BR) * PS);
  }
  static size_t dkv_smem_bytes() {
    const int dp = odd_stride(D);
    return sizeof(float) * (size_t(2 * BR + 2 * BC) * dp + size_t(2 * BR) * PS + 2 * BC);
  }
};

// x rounded to T and back: the TPU kernels' bf16 roundings of ds and of p
// (for p^T dO); nothing in float32
__device__ __forceinline__ float round_as(float x, float) { return x; }
__device__ __forceinline__ float round_as(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

// dst [rows][dp] <- src [valid][d] * scale; rows past `valid` are zero.  In
// bf16 the scale is rounded to bf16 and so is each product, as the TPU
// kernels form qs and ks (scale 1 leaves the values as they are); in
// float32 the product stays float32.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, int valid,
                                          int rows, int d, int dp, float scale) {
  const float sc = round_as(scale, T());
  for (int e = threadIdx.x; e < rows * d; e += kThreads) {
    const int r = e / d, c = e - r * d;
    dst[r * dp + c] = r < valid ? round_as(to_float(src[e]) * sc, T()) : 0.f;
  }
}

// s[i][j] = a[row i] . b[col j] and t[i][j] = a2[row i] . b2[col j]: the two
// products of the score grid that both kernels need, in one pass over D
template <int TC, int RR, int RC>
__device__ __forceinline__ void two_products(const float* a, const float* a2, const float* b,
                                             const float* b2, int row0, int tc, int d, int dp,
                                             float (&s)[RR][RC], float (&t)[RR][RC]) {
#pragma unroll
  for (int i = 0; i < RR; ++i)
#pragma unroll
    for (int j = 0; j < RC; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < d; ++c) {
    float av[RR], a2v[RR], bv[RC], b2v[RC];
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      av[i] = a[(row0 + i) * dp + c];
      a2v[i] = a2[(row0 + i) * dp + c];
    }
#pragma unroll
    for (int j = 0; j < RC; ++j) {
      bv[j] = b[(tc + TC * j) * dp + c];
      b2v[j] = b2[(tc + TC * j) * dp + c];
    }
#pragma unroll
    for (int i = 0; i < RR; ++i)
#pragma unroll
      for (int j = 0; j < RC; ++j) {
        s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        t[i][j] = fmaf(a2v[i], b2v[j], t[i][j]);
      }
  }
}

// dq: the block owns BQ queries (rows) and streams key tiles (columns).
template <typename T, int TQ, int TK, int RQ, int RK, int NC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int sq, int sk,
                    float sm_scale) {
  using Cfg = BwdTile<TQ, TK, RQ, RK, NC>;
  constexpr int BQ = Cfg::BR, BK = Cfg::BC, PS = Cfg::PS, d = Cfg::D;
  constexpr int dp = d | 1;

  extern __shared__ float smem[];
  float* q_s = smem;               // [BQ][dp], scaled by sm_scale * log2(e)
  float* do_s = q_s + BQ * dp;     // [BQ][dp]
  float* k_s = do_s + BQ * dp;     // [BK][dp]
  float* v_s = k_s + BK * dp;      // [BK][dp]
  float* ds_s = v_s + BK * dp;     // [BQ][PS]

  const int tid = threadIdx.x;
  const int tq = tid / TK;
  const int tk = tid % TK;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int row0 = tq * RQ;
  const size_t qoff = (size_t(bh) * sq + q0) * d;

  load_rows(q_s, q + qoff, sq - q0, BQ, d, dp, sm_scale * kLog2e);
  load_rows(do_s, dout + qoff, sq - q0, BQ, d, dp, 1.f);

  // a padded query row has q = dO = 0 and takes lse = delta = 0: ds = 0
  float lse_r[RQ], delta_r[RQ], acc[RQ][NC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + row0 + i;
    lse_r[i] = r < sq ? lse[size_t(bh) * sq + r] : 0.f;
    delta_r[i] = r < sq ? delta[size_t(bh) * sq + r] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < sk; k0 += BK) {
    __syncthreads();  // the previous tile's k_s / v_s / ds_s reads are done
    const size_t koff = (size_t(bh) * sk + k0) * d;
    load_rows(k_s, k + koff, sk - k0, BK, d, dp, 1.f);
    load_rows(v_s, v + koff, sk - k0, BK, d, dp, 1.f);
    __syncthreads();

    float s[RQ][RK], dpv[RQ][RK];
    two_products<TK, RQ, RK>(q_s, do_s, k_s, v_s, row0, tk, d, dp, s, dpv);
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int col = tk + TK * j;
        // a padded key has p = 0 and so adds nothing to dq
        const float p = k0 + col < sk ? exp2f(s[i][j] - lse_r[i]) : 0.f;
        ds_s[(row0 + i) * PS + col] = round_as(p * (dpv[i][j] - delta_r[i]), T());
      }
    __syncthreads();

    // acc[i][c] += sum_j ds[row i][j] * k[j][col c]
    for (int j = 0; j < BK; ++j) {
      float dsv[RQ], kv[NC];
#pragma unroll
      for (int i = 0; i < RQ; ++i) dsv[i] = ds_s[(row0 + i) * PS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = k_s[j * dp + tk + TK * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = row0 + i;
    if (q0 + r >= sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dq[qoff + size_t(r) * d + tk + TK * c] = from_float<T>(acc[i][c] * sm_scale);
  }
}

// dk, dv: the block owns BK keys (rows) and streams query tiles (columns).
template <typename T, int TK, int TQ, int RK, int RQ, int NC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int sq, int sk, float sm_scale) {
  using Cfg = BwdTile<TK, TQ, RK, RQ, NC>;
  constexpr int BK = Cfg::BR, BQ = Cfg::BC, PS = Cfg::PS, d = Cfg::D;
  constexpr int dp = d | 1;

  extern __shared__ float smem[];
  float* k_s = smem;               // [BK][dp], scaled by sm_scale * log2(e)
  float* v_s = k_s + BK * dp;      // [BK][dp]
  float* q_s = v_s + BK * dp;      // [BQ][dp], raw: it also feeds dk
  float* do_s = q_s + BQ * dp;     // [BQ][dp]
  float* p_s = do_s + BQ * dp;     // [BK][PS]
  float* ds_s = p_s + BK * PS;     // [BK][PS]
  float* lse_s = ds_s + BK * PS;   // [BQ]
  float* delta_s = lse_s + BQ;     // [BQ]

  const int tid = threadIdx.x;
  const int tk = tid / TQ;
  const int tq = tid % TQ;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int row0 = tk * RK;
  const size_t koff = (size_t(bh) * sk + k0) * d;

  load_rows(k_s, k + koff, sk - k0, BK, d, dp, sm_scale * kLog2e);
  load_rows(v_s, v + koff, sk - k0, BK, d, dp, 1.f);

  float acc_dk[RK][NC], acc_dv[RK][NC];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_dk[i][c] = acc_dv[i][c] = 0.f;

  for (int q0 = 0; q0 < sq; q0 += BQ) {
    __syncthreads();  // the previous tile's q_s / do_s / p_s / ds_s reads are done
    const size_t qoff = (size_t(bh) * sq + q0) * d;
    load_rows(q_s, q + qoff, sq - q0, BQ, d, dp, 1.f);
    load_rows(do_s, dout + qoff, sq - q0, BQ, d, dp, 1.f);
    if (tid < BQ) {
      const bool ok = q0 + tid < sq;
      lse_s[tid] = ok ? lse[size_t(bh) * sq + q0 + tid] : 0.f;
      delta_s[tid] = ok ? delta[size_t(bh) * sq + q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[RK][RQ], dpv[RK][RQ];
    two_products<TQ, RK, RQ>(k_s, v_s, q_s, do_s, row0, tq, d, dp, s, dpv);
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < RQ; ++j) {
        const int col = tq + TQ * j;
        // a padded query has p = 0 and so adds nothing to dk or dv; a padded
        // key row is never stored, and p = 0 keeps it finite
        const bool ok = q0 + col < sq && k0 + row0 + i < sk;
        const float p = ok ? exp2f(s[i][j] - lse_s[col]) : 0.f;
        p_s[(row0 + i) * PS + col] = round_as(p, T());
        ds_s[(row0 + i) * PS + col] = round_as(p * (dpv[i][j] - delta_s[col]), T());
      }
    __syncthreads();

    // dv[i][c] += sum_j p[row i][j] * dO[j][col c]; dk[i][c] += sum_j ds[row i][j] * q[j][col c]
    for (int j = 0; j < BQ; ++j) {
      float pv[RK], dsv[RK], dov[NC], qv[NC];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        pv[i] = p_s[(row0 + i) * PS + j];
        dsv[i] = ds_s[(row0 + i) * PS + j];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        dov[c] = do_s[j * dp + tq + TQ * c];
        qv[c] = q_s[j * dp + tq + TQ * c];
      }
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc_dv[i][c] = fmaf(pv[i], dov[c], acc_dv[i][c]);
          acc_dk[i][c] = fmaf(dsv[i], qv[c], acc_dk[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int r = row0 + i;
    if (k0 + r >= sk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const size_t o = koff + size_t(r) * d + tq + TQ * c;
      dk[o] = from_float<T>(acc_dk[i][c] * sm_scale);
      dv[o] = from_float<T>(acc_dv[i][c]);
    }
  }
}

// Tile <TR, TC, RR, RC, NC> of both kernels a head dim.  d = 40, 80: 64 own
// rows x 64 streamed rows, 4 x 8 of the score grid and 4 x D/8 of each output
// a thread.  d = 512: 16 own rows x 32 streamed rows, 4 x 1 scores and 4 x 16
// of each output a thread.
template <typename T, int TR, int TC, int RR, int RC, int NC>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, int bh, int sq, int sk,
                      cudaStream_t stream) {
  using Cfg = BwdTile<TR, TC, RR, RC, NC>;
  auto kernel = flash_bwd_dq_kernel<T, TR, TC, RR, RC, NC>;
  const size_t smem = Cfg::dq_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + Cfg::BR - 1) / Cfg::BR, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), sq, sk,
      1.f / sqrtf(float(Cfg::D)));
  return cudaGetLastError();
}

template <typename T, int TR, int TC, int RR, int RC, int NC>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv, int bh,
                       int sq, int sk, cudaStream_t stream) {
  using Cfg = BwdTile<TR, TC, RR, RC, NC>;
  auto kernel = flash_bwd_dkv_kernel<T, TR, TC, RR, RC, NC>;
  const size_t smem = Cfg::dkv_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sk + Cfg::BR - 1) / Cfg::BR, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), sq,
      sk, 1.f / sqrtf(float(Cfg::D)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dq_for(int d, const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, int bh, int sq, int sk,
                   cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (d == 40) return launch_dq<T, 16, 8, 4, 8, 5>(q, k, v, dout, lse, delta, dq, bh, sq, sk, s);
    if (d == 80)
      return launch_dq<T, 16, 8, 4, 8, 10>(q, k, v, dout, lse, delta, dq, bh, sq, sk, s);
  }
  if (d == 512) return launch_dq<T, 4, 32, 4, 1, 16>(q, k, v, dout, lse, delta, dq, bh, sq, sk, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dkv_for(int d, const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, int bh, int sq,
                    int sk, cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (d == 40)
      return launch_dkv<T, 16, 8, 4, 8, 5>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, s);
    if (d == 80)
      return launch_dkv<T, 16, 8, 4, 8, 10>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, s);
  }
  if (d == 512)
    return launch_dkv<T, 4, 32, 4, 1, 16>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, s);
  return cudaErrorInvalidValue;
}

// d = 512 in either dtype; d = 40 / 80 in bf16 only (float32 there:
// flash_attention_bwd_f32.cu)
bool takes(int bh, int sq, int sk, int d, int dtype) {
  return bh >= 1 && bh <= 65535 && sq >= 1 && sk >= 1 && (dtype == 0 || dtype == 1) &&
         (d == 512 || (dtype == 1 && (d == 40 || d == 80)));
}

}  // namespace

// Plain C entry points for ctypes.  dtype: 0 float32, 1 bfloat16.  Each
// returns 0 on success, a cudaError_t code from the launch, or -1 for
// arguments the kernel does not take.
extern "C" int hedit_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse,
                                            const void* delta, void* dq, int bh, int sq,
                                            int sk, int d, int dtype, void* stream) {
  if (!takes(bh, sq, sk, d, dtype)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  return int(dtype == 0 ? dq_for<float>(d, q, k, v, dout, l, dl, dq, bh, sq, sk, s)
                        : dq_for<__nv_bfloat16>(d, q, k, v, dout, l, dl, dq, bh, sq, sk, s));
}

extern "C" int hedit_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse,
                                             const void* delta, void* dk, void* dv, int bh,
                                             int sq, int sk, int d, int dtype, void* stream) {
  if (!takes(bh, sq, sk, d, dtype)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  return int(dtype == 0
                 ? dkv_for<float>(d, q, k, v, dout, l, dl, dk, dv, bh, sq, sk, s)
                 : dkv_for<__nv_bfloat16>(d, q, k, v, dout, l, dl, dk, dv, bh, sq, sk, s));
}
