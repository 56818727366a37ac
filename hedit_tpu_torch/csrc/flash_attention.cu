// Flash-attention forward for Hopper (sm_90a) on the CUDA cores (float32
// FMAs): softmax(q k^T / sqrt(d)) v, optionally with the per-query base-2
// log-sum-exp as a second output, in one of two softmax modes chosen at
// compile time (Mode below).  It serves float32 inputs of rows 6 and 7, and
// of rows 1 and 3 at the VAE's d = 512; float32 rows 1 and 3 at d = 40 and
// 80 run flash_attention_f32.cu, bf16 inputs of every row the tensor-core
// kernel of flash_attention_tc.cu (the wrappers dispatch by dtype and head
// dim).  The bounded mode's bf16 instantiation stays for side-by-side
// timings only (chip_smoke.py launches its LSE entry by its entry point; no
// wrapper does); the exact mode takes float32 only.
//
// Bounded (max-free) replaces the TPU kernels of
// hedit_tpu/ops/flash_attention.py
//   row 1 in float32 at d = 512: _flash_bounded_kernel (wrapper flash_attention_bounded,
//          reached through hedit_tpu/ops/attention.py:fused_attention); entry
//          point hedit_flash_attention_fwd, wrapper flash_attention_cuda;
//   row 3 in float32 at d = 512: _flash_bounded_lse_kernel (wrapper
//          _flash_bounded_fwd_lse, the forward of flash_attention_diff on the
//          NMG path); entry point hedit_flash_attention_fwd_lse, wrapper
//          flash_attention_lse_cuda;
// and, on packed heads (below), row 1 in float32 at d = 512 (on no path:
// JAX sends every UNet self-attention of >= 1024 tokens to
// flash_attention_diff, whose primal is row 1, at d = 40 and 80); entry point
// hedit_flash_attention_fwd_packed_bounded, wrapper
// flash_attention_packed_bounded_cuda.  The bounded float32 instances at
// d = 40 and 80 are gone: flash_attention_f32.cu computes the anchor window's
// scores once, where this prologue computes them twice (below).
// A prologue takes each query row's max m0 over its anchor window, the first
// `anchor` keys (the key block the JAX wrapper picks at that shape, passed in
// by the wrapper; not this kernel's own key tile, or the saturation would
// land on other keys than on the TPU).  Then one pass over all keys with
// shift = m0 + 16 and p = exp2(min(s - shift, 100)): no running max, no
// rescale, no dependency between key tiles but the sum.  The sum is floored
// at 1.2e-38, and lse2 = shift + log2(sum).  The two modes agree wherever no
// key scores more than 116 log2 units above its row's anchor max; beyond
// that the bounded form saturates such keys at 2^100 as the TPU kernel does.
//
// Exact (running max m and rescale of the accumulator and the row sum l)
// replaces, in float32 (the template's only dtype in this mode),
//   row 6: _flash_kernel (wrapper flash_attention, JAX's public exact
//          forward, on no editing path of either package); entry point
//          hedit_flash_attention_fwd_exact, wrapper flash_attention_exact_cuda;
//   row 7: _flash_packed_kernel (wrapper flash_attention_packed, on no path
//          of either package); entry point hedit_flash_attention_fwd_packed,
//          wrapper flash_attention_packed_cuda.
// (bf16 rows 6 and 7: the exact mode of flash_attention_tc.cu.)
// The running max is taken over each key tile of BK keys, so the plain
// version (flash_attention_exact_reference) runs at the same key block.
//
// In both modes, as in the TPU kernels, the scale 1/sqrt(d) * log2(e) (in
// double, then rounded to float) is rounded to the input dtype, q * scale
// is rounded to it, and p is rounded to it before both the PV product and
// the row sum (the TPU kernels sum p through a ones-column of v).
//
// Packed heads (row 7, and row 1 on the paths): q [B, Sq, H*D], k and v
// [B, Sk, H*D] -> out [B, Sq, H*D], head h in columns h*D .. (h+1)*D.  The
// TPU program owned one batch row, looped over the heads in Python and kept
// K/V of all heads resident in VMEM; here a block still owns 64 queries of
// one (batch row, head), and the only change is in addressing: the template takes the
// element strides (batch, head, row) of q, k, v and out, so the head-split
// layout (head stride 0 with BH as the batch, row stride D) and the packed
// one (head stride D, row stride H*D) are the same code, and no [B, H, S, D]
// copy exists before or after the packed call.  A head's row is D elements
// (80 bytes at D = 40 in bf16), neither a multiple of a 128-byte line nor
// 16-byte aligned for every head, so the loaders stay element-wise: no vector
// load wider than the alignment proves.  The kernel is bound by arithmetic
// (below), and the extra sectors of the unaligned rows do not show: both
// layouts take the same time at the same shape.
//
// Contract, head-split entry points: q [BH, Sq, D], k and v [BH, Sk, D],
// contiguous, all of one dtype (float32 or bfloat16); out [BH, Sq, D] in that
// dtype; lse2 [BH, Sq] float32 or null.  Packed entry points: each [S, H*D]
// image dense, the images of q, k and v a batch stride apart (so a row slice
// of a larger batch needs no copy); out dense.  Any Sq, Sk
// >= 1 (ragged tails are masked here); D is one of the head dims of SD-1.5:
// 40 and 80 (UNet self-attention) or 512 (VAE mid-block), in the bounded
// mode in float32 512 only.  Each has its own tile shape below, and any other
// D is refused.
//
// In both modes the scale 1/sqrt(d) * log2(e) is folded into q, so scores
// are in base 2 and every exponential is an exp2.
//
// What bounds it on the H100.  The UNet's self-attention at [rows, 8, 4096,
// 40] does 2 * 4096 * 4096 * 40 * 2 FLOP per (row, head) against 1.3 MB of
// q, k, v and out in bf16: about 2,000 FLOP per byte, far above the ~295
// FLOP/byte balance point of an H100 SXM (data sheet, 700 W), so the kernel
// is bound by arithmetic, not by device memory.  This template does its
// arithmetic in float32 on the CUDA cores (67 TFLOP/s peak on the data
// sheet), not on the tensor cores (989 TFLOP/s bf16): its limit is the rate at
// which shared memory feeds the FMAs.  The design answers that with register
// tiling: each thread owns an RQ x RK tile of scores and an RQ x NC tile of
// the output, so every shared-memory word it loads feeds several FMAs, and
// the output accumulator never leaves registers.  Odd row strides keep the
// strided shared-memory reads free of bank conflicts.  bf16 rows 1, 3, 6 and
// 7 run on the tensor cores (flash_attention_tc.cu).  The bounded prologue
// computes the anchor window's scores a second time (no V, no exp2): anchor /
// Sk more QK^T work, 1/8 at the UNet's 4096 keys and 1/4 for the VAE's.
//
// Block layout: 128 threads as a TQ x TK grid (tid = tq * TK + tk).  A block
// owns BQ = TQ * RQ query rows of one (batch, head) and loops over key tiles
// of BK = TK * RK keys.  Thread (tq, tk) owns query rows tq*RQ + i (i < RQ),
// key columns tk + TK*j (j < RK) of the score tile, and output columns
// tk + TK*c (c < NC) of its rows.  The TK threads that share a row are
// consecutive lanes of one warp, so row max and row sum are warp shuffles.

#include <cmath>
#include <type_traits>

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

// The softmax form of a forward; see the head of this file.
enum class Mode { Exact, Bounded };

constexpr float kShiftMargin = 16.f;   // shift = anchor max + 16 (base 2)
constexpr float kSaturate = 100.f;     // p = exp2(min(s - shift, 100))
constexpr float kDenomFloor = 1.2e-38f;

template <typename T, Mode M, int TQ, int TK, int RQ, int RK, int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Strides qs, Strides ks, Strides vs, Strides os,
                 int heads, int sq, int sk, int d, float qscale, int anchor) {
  using Cfg = Tile<TQ, TK, RQ, RK, NC>;
  constexpr int BQ = Cfg::BQ, BK = Cfg::BK, DV = Cfg::DV, PS = Cfg::PS;
  constexpr bool kBounded = M == Mode::Bounded;

  extern __shared__ float smem[];
  // launch() checks d == DV.  The loaders divide by the compile-time D: with
  // the run-time d their index math (a division an element) cost the whole
  // kernel a fifth of its time once the strides came in.
  constexpr int D = DV;
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

  const int b = bh / heads, h = bh - b * heads;

  const T* qg = q + b * qs.batch + h * qs.head + (long long)q0 * qs.row;
  const T* kg = k + b * ks.batch + h * ks.head;
  const T* vg = v + b * vs.batch + h * vs.head;

  // q * scale in the input dtype, as the TPU kernels scale q
  const float qsc = to_float(from_float<T>(qscale));
  for (int e = tid; e < BQ * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    float x = 0.f;
    if (q0 + r < sq) x = to_float(from_float<T>(to_float(qg[r * qs.row + c]) * qsc));
    q_s[r * dp + c] = x;
  }

  // K rows k0 .. k0 + BK (and V's unless only the scores are wanted) into
  // shared memory; rows at or past `end` read as 0
  auto load_tile = [&](int k0, int end, bool with_v) {
    for (int e = tid; e < BK * D; e += kThreads) {
      const int r = e / D, c = e - r * D;
      const bool ok = k0 + r < end;
      k_s[r * dp + c] = ok ? to_float(kg[(k0 + r) * ks.row + c]) : 0.f;
      if (with_v) v_s[r * DV + c] = ok ? to_float(vg[(k0 + r) * vs.row + c]) : 0.f;
    }
  };
  // scores (base 2) of the tile in k_s: s[i][j] = q_s[row i] . k_s[col j]
  auto tile_scores = [&](float (&s)[RQ][RK]) {
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
  };

  float acc[RQ][NC];
  // Exact: running max m_i.  Bounded: the fixed shift of each row.
  float m_i[RQ], l_i[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m_i[i] = -CUDART_INF_F;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  if (kBounded) {
    // prologue: the max of each row over its anchor window
    const int a_end = anchor < sk ? anchor : sk;
    for (int k0 = 0; k0 < a_end; k0 += BK) {
      __syncthreads();  // q_s written / previous tile's k_s reads done
      load_tile(k0, a_end, false);
      __syncthreads();
      float s[RQ][RK];
      tile_scores(s);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j)
          if (k0 + tk + TK * j < a_end) m_i[i] = fmaxf(m_i[i], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
#pragma unroll
      for (int off = TK / 2; off > 0; off >>= 1)
        m_i[i] = fmaxf(m_i[i], __shfl_xor_sync(0xffffffffu, m_i[i], off));
      m_i[i] += kShiftMargin;  // key 0 is in the window (sk, anchor >= 1): finite
    }
  }

  for (int k0 = 0; k0 < sk; k0 += BK) {
    __syncthreads();  // previous tile's k_s / v_s / p_s reads are done
    load_tile(k0, sk, true);
    __syncthreads();

    float s[RQ][RK];
    tile_scores(s);

    // softmax weights per row; the TK lanes of a row reduce by shuffles
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      if (kBounded) {
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          float p = 0.f;
          if (k0 + tk + TK * j < sk) {
            p = exp2f(fminf(s[i][j] - m_i[i], kSaturate));
            p = to_float(from_float<T>(p));  // p in the input dtype, as on the TPU
          }
          p_s[(tq * RQ + i) * PS + tk + TK * j] = p;
          sum += p;
        }
#pragma unroll
        for (int off = TK / 2; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        l_i[i] += sum;
        continue;
      }
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
        // p in the input dtype, as on the TPU; masked keys give 0
        const float p = to_float(from_float<T>(exp2f(s[i][j] - m_new)));
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

  T* og = out + b * os.batch + h * os.head + (long long)q0 * os.row;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = tq * RQ + i;
    if (q0 + r >= sq) continue;
    const float l = kBounded ? fmaxf(l_i[i], kDenomFloor) : l_i[i];
    const float inv_l = 1.f / l;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      og[r * os.row + tk + TK * c] = from_float<T>(acc[i][c] * inv_l);
    }
    // m_i is the running max (Exact) or the shift (Bounded)
    if (lse != nullptr && tk == 0) lse[size_t(bh) * sq + q0 + r] = m_i[i] + log2f(l);
  }
}

template <typename T, Mode M, int TQ, int TK, int RQ, int RK, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   const Layout& lay, int sq, int sk, int d, int anchor, cudaStream_t stream) {
  using Cfg = Tile<TQ, TK, RQ, RK, NC>;
  auto kernel = flash_fwd_kernel<T, M, TQ, TK, RQ, RK, NC>;
  if (d != Cfg::DV) return cudaErrorInvalidValue;
  const size_t smem = Cfg::smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + Cfg::BQ - 1) / Cfg::BQ, lay.bh);
  // JAX's constant, (1 / sqrt(d)) * log2(e) in double, then rounded
  const float qscale = float(1.0 / sqrt(double(d)) * 1.4426950408889634);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, lay.q, lay.k, lay.v, lay.out,
      lay.heads, sq, sk, d, qscale, anchor);
  return cudaGetLastError();
}

// One tile shape a head dim.  d=40 and d=80 (the UNet): 64 queries x 64
// keys, 4 x 8 scores and 4 x d/8 outputs a thread.  d=512 (the VAE mid
// block): 16 queries x 32 keys, 4 x 1 scores and 4 x 16 outputs a thread,
// which keeps shared memory under 170 KB.
// The bounded mode in float32 keeps d = 512 only (forward() refuses 40 and
// 80, which flash_attention_f32.cu serves), so those two are not instantiated.
template <typename T, Mode M>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, float* lse,
                     const Layout& lay, int sq, int sk, int d, int anchor, cudaStream_t s) {
  constexpr bool kUnetDims = !(std::is_same<T, float>::value && M == Mode::Bounded);
  if constexpr (kUnetDims) {
    if (d == 40) return launch<T, M, 16, 8, 4, 8, 5>(q, k, v, out, lse, lay, sq, sk, d, anchor, s);
    if (d == 80) return launch<T, M, 16, 8, 4, 8, 10>(q, k, v, out, lse, lay, sq, sk, d, anchor, s);
  }
  if (d == 512) return launch<T, M, 4, 32, 4, 1, 16>(q, k, v, out, lse, lay, sq, sk, d, anchor, s);
  return cudaErrorInvalidValue;
}

// anchor: the bounded mode's anchor window (>= 1); the exact mode reads none.
template <Mode M>
int forward(const void* q, const void* k, const void* v, void* out, float* lse,
            const Layout& lay, int sq, int sk, int d, int anchor, int dtype, void* stream) {
  if (lay.bh < 1 || sq < 1 || sk < 1 || lay.bh > 65535) return -1;
  if (d != 40 && d != 80 && d != 512) return -1;
  if (M == Mode::Bounded && anchor < 1) return -1;
  if (M == Mode::Bounded && dtype == 0 && d != 512) return -1;  // flash_attention_f32.cu
  if (!rows_fit(lay, sq, sk)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(dispatch<float, M>(q, k, v, out, lse, lay, sq, sk, d, anchor, s));
    case 1:  // bf16 exact: the exact mode of flash_attention_tc.cu
      if constexpr (M == Mode::Exact) return -1;
      else return int(dispatch<__nv_bfloat16, M>(q, k, v, out, lse, lay, sq, sk, d, anchor, s));
    default: return -1;
  }
}

}  // namespace

// Plain C entry points for ctypes.  dtype: 0 float32, 1 bfloat16 (bounded
// entries only).
// Each returns 0 on success, a cudaError_t code from the launch, or -1 for
// arguments the kernel does not take.

// Row 1: the bounded forward, head-split; anchor: the anchor window in keys.
extern "C" int hedit_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* out, int bh,
                                         int sq, int sk, int d, int anchor, int dtype,
                                         void* stream) {
  return forward<Mode::Bounded>(q, k, v, out, nullptr, head_split(bh, sq, sk, d), sq, sk, d,
                                anchor, dtype, stream);
}

// Row 3: the same forward, also writing lse2 [BH, Sq] float32 (base-2
// log-sum-exp of the scaled scores of each query, shift + log2(sum)).  The
// wrapper sends float32 here and bf16 to hedit_flash_attention_fwd_lse_tc.
extern "C" int hedit_flash_attention_fwd_lse(const void* q, const void* k,
                                             const void* v, void* out, void* lse,
                                             int bh, int sq, int sk, int d, int anchor,
                                             int dtype, void* stream) {
  if (lse == nullptr) return -1;
  return forward<Mode::Bounded>(q, k, v, out, static_cast<float*>(lse),
                                head_split(bh, sq, sk, d), sq, sk, d, anchor, dtype, stream);
}

// Row 6: the exact forward, head-split.  The wrapper sends float32 here and
// bf16 to hedit_flash_attention_fwd_exact_tc.
extern "C" int hedit_flash_attention_fwd_exact(const void* q, const void* k,
                                               const void* v, void* out, int bh,
                                               int sq, int sk, int d, int dtype,
                                               void* stream) {
  return forward<Mode::Exact>(q, k, v, out, nullptr, head_split(bh, sq, sk, d), sq, sk, d, 0,
                              dtype, stream);
}

// Row 7: the exact forward on packed heads; float32 here, bf16 to
// hedit_flash_attention_fwd_packed_exact_tc.
extern "C" int hedit_flash_attention_fwd_packed(const void* q, const void* k,
                                                const void* v, void* out, int b,
                                                int h, int sq, int sk, int d,
                                                long long q_bs, long long k_bs,
                                                long long v_bs, int dtype,
                                                void* stream) {
  Layout lay;
  if (!packed_layout(b, h, sq, sk, d, q_bs, k_bs, v_bs, &lay)) return -1;
  return forward<Mode::Exact>(q, k, v, out, nullptr, lay, sq, sk, d, 0, dtype, stream);
}

// Row 1 on packed heads: the bounded forward; anchor as in
// hedit_flash_attention_fwd.
extern "C" int hedit_flash_attention_fwd_packed_bounded(const void* q, const void* k,
                                                        const void* v, void* out, int b,
                                                        int h, int sq, int sk, int d,
                                                        int anchor, long long q_bs,
                                                        long long k_bs, long long v_bs,
                                                        int dtype, void* stream) {
  Layout lay;
  if (!packed_layout(b, h, sq, sk, d, q_bs, k_bs, v_bs, &lay)) return -1;
  return forward<Mode::Bounded>(q, k, v, out, nullptr, lay, sq, sk, d, anchor, dtype, stream);
}
