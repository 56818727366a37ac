// The flash-attention exact exp2 probe in float32 for Hopper (sm_90a): the
// CUDA-core template's last instances, row 10 (scripts/flash_v4_variants.py:
// kern_exp2, entry point hedit_flash_exp2_t, wrapper flash_exp2_t_cuda in
// ops/flash_probes.py), both key loops.  They write the transposed output
// [BH, D, Sq].  bf16 runs on the tensor cores (flash_probes_tc.cu,
// hedit_flash_exp2_t_tc), and this entry point refuses it.  Rows 8 and 11
// in float32 run on the query-major kernel of flash_variants.cu.
//
// The function: q * scale rounded to the input dtype, a running max m,
// p = exp2(s - m_new) rounded to the input dtype, alpha = exp2(m_old -
// m_new), the row sum from the rounded p, and no floor (the row's largest p
// is 1).  The running max moves once a key tile, as the TPU kernel's does
// with blk_k = 64 (its wrapper's default of 512 keys rounds p against other
// points, which moves the output by rounding only).  `pipe` is the TPU
// kernel's software-pipelined loop: the scores of tile t are computed before
// the softmax and PV of tile t - 1 (a prologue computes tile 0's scores, an
// epilogue drains the last tile), with K and V tiles double-buffered in
// shared memory so tile t loads while tile t - 1's V is still read.  Both
// loops give the same function.
//
// The output is staged in shared memory: the block's [64][D] result is
// written transposed into it, then stored as D rows of 64 contiguous
// elements.
//
// Contract: q, k, v dense [BH, S, D] images, float32 (bfloat16 runs on the
// tensor cores); D is 40 or 80 (the UNet's head dims); Sq and Sk are
// multiples of the 64-row tile (the TPU kernels' grids cover only whole
// blocks, and nothing is masked here).
//
// Tiles and what bounds them are those of flash_attention.cu's d = 40 / 80
// forward: 128 threads as 16 x 8, 64 queries x 64 keys a block, 4 x 8 scores
// and 4 x D/8 outputs a thread, float32 FMAs on the CUDA cores fed from
// shared memory.

#include <climits>

#include "flash_common.cuh"

namespace {

// The loop a kernel instance runs; see the head of this file.
enum class Probe { Exp2, Exp2Pipe };

constexpr int TQ = 16, TK = 8, RQ = 4, RK = 8;
constexpr int BQ = TQ * RQ, BK = TK * RK;  // 64 x 64
constexpr int PS = BK + 1;                 // odd P row stride
constexpr float kNegInf = -1e30f;          // the TPU kernel's initial running max

template <Probe P>
struct Traits {
  static constexpr bool pipe = P == Probe::Exp2Pipe;
  static constexpr int buffers = pipe ? 2 : 1;
};

template <int D>
struct Smem {
  static constexpr int DP = D | 1;  // odd row stride of the Q, K and V tiles
  static constexpr int tile = BK * DP;
  static constexpr int OS = BQ + 1;  // odd row stride of the staged [D][BQ] output
  static_assert(BQ == BK, "Q and K tiles share a row count");
  static_assert(D * OS <= (BQ + 2 * BK) * DP, "the staged output fits Q's and K's tiles");
  static size_t bytes(int buffers) {
    return sizeof(float) * (size_t(BQ) * DP + size_t(buffers) * 2 * tile + size_t(BQ) * PS);
  }
};

// Rows r0 .. r0 + 64 of one (batch, head) [S, D] image (row-major: the
// rows are one contiguous run) into dst [64][DP].  scale > 0: each element
// times scale, rounded to T (q's treatment).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const T* __restrict__ img,
                                          int r0, float scale) {
  constexpr int DP = Smem<D>::DP;
  for (int e = threadIdx.x; e < BQ * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    float x = to_float(img[r0 * D + e]);
    if (scale > 0.f) x = to_float(from_float<T>(x * scale));
    dst[r * DP + c] = x;
  }
}

// s[i][j] = q_s[row tq*RQ + i] . k_s[col tk + TK*j], float32 FMAs
template <int D>
__device__ __forceinline__ void tile_scores(const float* __restrict__ q_s,
                                            const float* __restrict__ k_s, int tq, int tk,
                                            float (&s)[RQ][RK]) {
  constexpr int DP = Smem<D>::DP;
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
}

template <typename T, Probe P, int D>
__global__ void __launch_bounds__(kThreads)
flash_probe_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   T* __restrict__ out, int sq, int sk, float qscale) {
  using Tr = Traits<P>;
  using Sm = Smem<D>;
  constexpr int DP = Sm::DP, NC = D / TK;
  static_assert(NC * TK == D, "the output columns split evenly over the TK lanes of a row");

  extern __shared__ float smem[];
  float* q_s = smem;                              // [BQ][DP], scaled
  float* kv_s = q_s + BQ * DP;                    // buffers x (K [BK][DP], V [BK][DP])
  float* p_s = kv_s + Tr::buffers * 2 * Sm::tile;  // [BQ][PS]

  const int tid = threadIdx.x;
  const int tq = tid / TK, tk = tid % TK;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const T* qg = q + size_t(bh) * sq * D;
  const T* kg = k + size_t(bh) * sk * D;
  const T* vg = v + size_t(bh) * sk * D;

  load_tile<T, D>(q_s, qg, q0, to_float(from_float<T>(qscale)));

  auto k_buf = [&](int b) { return kv_s + b * 2 * Sm::tile; };
  auto v_buf = [&](int b) { return kv_s + b * 2 * Sm::tile + Sm::tile; };
  auto load_kv = [&](int t, int b) {
    load_tile<T, D>(k_buf(b), kg, t * BK, 0.f);
    load_tile<T, D>(v_buf(b), vg, t * BK, 0.f);
  };

  float acc[RQ][NC], m_i[RQ], l_i[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // The softmax weights of one tile's scores into p_s (rounded to T), the
  // row sums and the rescale, then acc += p v from V buffer b.
  // Starts after every read of p_s and of the buffer's previous tile is done.
  auto softmax_pv = [&](float (&s)[RQ][RK], int b) {
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < RK; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = TK / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float ref = fmaxf(m_i[i], mx);
      const float alpha = exp2f(m_i[i] - ref);
      m_i[i] = ref;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = to_float(from_float<T>(exp2f(s[i][j] - ref)));  // in the input dtype
        p_s[(tq * RQ + i) * PS + tk + TK * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = TK / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i[i] = l_i[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    const float* vb = v_buf(b);
    for (int j = 0; j < BK; ++j) {
      float pv[RQ], vv[NC];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = p_s[(tq * RQ + i) * PS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = vb[j * DP + tk + TK * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  };

  const int nk = sk / BK;
  if (!Tr::pipe) {
    for (int t = 0; t < nk; ++t) {
      __syncthreads();  // the previous tile's k / v / p reads are done
      load_kv(t, 0);
      __syncthreads();
      float s[RQ][RK];
      tile_scores<D>(q_s, k_buf(0), tq, tk, s);
      softmax_pv(s, 0);
    }
  } else {
    // prologue: tile 0's scores
    __syncthreads();
    load_kv(0, 0);
    __syncthreads();
    float s_prev[RQ][RK];
    tile_scores<D>(q_s, k_buf(0), tq, tk, s_prev);
    // steady state: tile t's scores, then tile t - 1's softmax and PV
    for (int t = 1; t < nk; ++t) {
      __syncthreads();  // tile t - 2's V and p reads are done: its buffer is free
      load_kv(t, t & 1);
      __syncthreads();
      float s_next[RQ][RK];
      tile_scores<D>(q_s, k_buf(t & 1), tq, tk, s_next);
      softmax_pv(s_prev, (t - 1) & 1);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s_prev[i][j] = s_next[i][j];
    }
    // epilogue: the last tile
    __syncthreads();
    softmax_pv(s_prev, (nk - 1) & 1);
  }

  // out[bh][c][q0 + r]: stage the [BQ][D] result transposed in shared memory
  // (over Q's and K's tiles), then store D runs of BQ contiguous elements
  __syncthreads();
  float* o_s = smem;  // [D][OS]
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c) o_s[(tk + TK * c) * Sm::OS + tq * RQ + i] = acc[i][c] / l_i[i];
  }
  __syncthreads();
  T* og = out + size_t(bh) * D * sq;
  for (int e = tid; e < D * BQ; e += kThreads) {
    const int c = e / BQ, r = e - c * BQ;
    og[c * sq + q0 + r] = from_float<T>(o_s[c * Sm::OS + r]);
  }
}

template <typename T, Probe P, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int bh, int sq,
                   int sk, cudaStream_t stream) {
  auto kernel = flash_probe_kernel<T, P, D>;
  const size_t smem = Smem<D>::bytes(Traits<P>::buffers);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  // JAX's constant, sm_scale * log2(e) in double, then rounded
  const float qscale = float(1.0 / sqrt(double(D)) * 1.4426950408889634);
  const dim3 grid(sq / BQ, bh);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(out), sq,
                                           sk, qscale);
  return cudaGetLastError();
}

template <typename T, Probe P>
int launch_d(const void* q, const void* k, const void* v, void* out, int bh, int sq, int sk,
             int d, cudaStream_t s) {
  if (d == 40) return int(launch<T, P, 40>(q, k, v, out, bh, sq, sk, s));
  if (d == 80) return int(launch<T, P, 80>(q, k, v, out, bh, sq, sk, s));
  return -1;
}

template <Probe P>
int probe(const void* q, const void* k, const void* v, void* out, int bh, int sq, int sk, int d,
          int dtype, void* stream) {
  if (bh < 1 || bh > 65535 || sq < BQ || sk < BK || sq % BQ || sk % BK) return -1;
  if ((long long)(sq > sk ? sq : sk) * d > INT_MAX) return -1;  // 32-bit offsets in an image
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // float32 only: bf16 runs on the tensor cores (flash_probes_tc.cu)
  return dtype == 0 ? launch_d<float, P>(q, k, v, out, bh, sq, sk, d, s) : -1;
}

}  // namespace

// Plain C entry points for ctypes.  dtype: 0 float32, 1 bfloat16.  Each
// returns 0 on success, a cudaError_t code from the launch, or -1 for
// arguments the kernel does not take.

// Row 10: the exact exp2 probe, q, k, v [BH, S, D] -> out [BH, D, Sq];
// pipe: 0 the plain key loop, 1 the software-pipelined one.  float32 only
// (bf16: hedit_flash_exp2_t_tc).
extern "C" int hedit_flash_exp2_t(const void* q, const void* k, const void* v, void* out,
                                  int bh, int sq, int sk, int d, int pipe, int dtype,
                                  void* stream) {
  if (pipe != 0 && pipe != 1) return -1;
  return pipe ? probe<Probe::Exp2Pipe>(q, k, v, out, bh, sq, sk, d, dtype, stream)
              : probe<Probe::Exp2>(q, k, v, out, bh, sq, sk, d, dtype, stream);
}
