// The flash-attention layout, pipelining and ablation probes for Hopper
// (sm_90a): seven forwards that write the transposed output [BH, D, Sq] (the
// same memory as the packed transposed [B, H*D, Sq]: head h of batch row b is
// rows h*D .. (h+1)*D of that row's [H*D, Sq] image, bh = b * H + h).
//
// Bounded (max-free), replacing the TPU kernels of scripts/flash_nhd_variants.py
// (entry point hedit_flash_packed_t, wrappers in ops/flash_probes.py):
//   _packed_t_kernel            q, k, v [BH, S, D]            flash_packed_t_cuda
//   _packed_t_kernel_sminor     q, k [BH, D, S]; v [BH, S, D] flash_packed_t_sminor_cuda
//   _packed_t_kernel_all_sminor q, k, v [BH, D, S]            flash_packed_t_all_sminor_cuda
// They run here in float32 only: in bf16 they run on the tensor cores
// (flash_probes_tc.cu, hedit_flash_packed_t_tc), and this entry point
// refuses them.
// Their arithmetic is the bounded forward's (flash_attention.cu): q * scale
// rounded to the input dtype, float32 scores, shift = the row's max over the
// first `anchor` keys (the TPU kernel's blk_k) + 16, p = exp2(min(s - shift,
// 100)) rounded to the input dtype before the PV product and the row sum (the
// TPU kernel sums p through a ones-column of v), the sum floored at 1.2e-38.
//
// Exact with exp2, replacing scripts/flash_v4_variants.py:kern_exp2 (entry
// point hedit_flash_exp2_t, wrapper flash_exp2_t_cuda; float32 only, bf16
// on the tensor cores: hedit_flash_exp2_t_tc): q * scale rounded to
// the input dtype, a running max m, p = exp2(s - m_new) rounded to the input
// dtype, alpha = exp2(m_old - m_new), the row sum from the rounded p, and no
// floor (the row's largest p is 1).  The running max moves once a key tile,
// as the TPU kernel's does with blk_k = 64 (its wrapper's default of 512 keys
// rounds p against other points, which moves the output by rounding only).
// `pipe` is the TPU kernel's software-pipelined loop: the scores of tile t
// are computed before the softmax and PV of tile t - 1 (a prologue computes
// tile 0's scores, an epilogue drains the last tile), with K and V tiles
// double-buffered in shared memory so tile t loads while tile t - 1's V is
// still read.  Both loops give the same function.
//
// The ablations, replacing scripts/flash_ablate.py:make_kernel(mode) (entry
// point hedit_flash_ablate_t, wrapper flash_ablate_t_cuda): the bounded
// loop cut down to measure its floor.  q is NOT scaled (no sm_scale, no
// log2 e), there is no prologue, no running max and no shift but a
// constant; p is rounded to the input dtype and summed through the TPU
// kernel's ones-column of v, and the sum is floored at 1e-30 (float32 only:
// in bf16 all three run on the tensor cores, hedit_flash_ablate_t_tc):
//   dots      p = s                       (the products and the cast alone)
//   exp       p = exp2(s)
//   noprolog  p = exp2(min(s - 12.34, 100))
// In `dots` the sum of p can be negative or near zero; the floor then makes
// the output acc * 1e30, as on the TPU.
//
// S-minor operands ([D, S], S contiguous) are read as D rows of a tile's 64
// contiguous elements: coalesced in global memory, and stored transposed
// into the [row][odd stride] shared tile the FMA loops read, where the odd
// stride keeps the transposing writes free of bank conflicts.  The output is
// staged the same way: the block's [64][D] result is written transposed into
// shared memory, then stored as D rows of 64 contiguous elements.
//
// Contract: every operand a dense [BH, S, D] or [BH, D, S] image per
// (batch, head), float32 (bfloat16 runs on the tensor cores); D is
// 40 or 80 (the UNet's head dims); Sq and Sk are multiples of the 64-row
// tile (the TPU kernels' grids cover only whole blocks, and nothing is
// masked here), and for the bounded probes the anchor is a multiple of 64
// that divides Sk.
//
// Tiles and what bounds them are those of flash_attention.cu's d = 40 / 80
// forward: 128 threads as 16 x 8, 64 queries x 64 keys a block, 4 x 8 scores
// and 4 x D/8 outputs a thread, float32 FMAs on the CUDA cores fed from
// shared memory.

#include <climits>

#include "flash_common.cuh"

namespace {

// The probe a kernel instance computes; see the head of this file.
enum class Probe {
  PackedT, PackedTSMinor, PackedTAllSMinor, Exp2, Exp2Pipe, AblateDots, AblateExp, AblateNoProlog
};

constexpr int TQ = 16, TK = 8, RQ = 4, RK = 8;
constexpr int BQ = TQ * RQ, BK = TK * RK;  // 64 x 64
constexpr int PS = BK + 1;                 // odd P row stride
constexpr float kShiftMargin = 16.f;
constexpr float kSaturate = 100.f;
constexpr float kDenomFloor = 1.2e-38f;
constexpr float kAblateFloor = 1e-30f;     // flash_ablate.py's floor
constexpr float kAblateShift = 12.34f;     // flash_ablate.py's constant shift (noprolog)
constexpr float kNegInf = -1e30f;          // the TPU kernel's initial running max

template <Probe P>
struct Traits {
  static constexpr bool q_sminor = P == Probe::PackedTSMinor || P == Probe::PackedTAllSMinor;
  static constexpr bool k_sminor = q_sminor;
  static constexpr bool v_sminor = P == Probe::PackedTAllSMinor;
  static constexpr bool running_max = P == Probe::Exp2 || P == Probe::Exp2Pipe;
  static constexpr bool ablate =
      P == Probe::AblateDots || P == Probe::AblateExp || P == Probe::AblateNoProlog;
  static constexpr bool bounded = !running_max && !ablate;  // anchored shift, prologue
  static constexpr bool pipe = P == Probe::Exp2Pipe;
  static constexpr int buffers = pipe ? 2 : 1;
  static constexpr float floor = bounded ? kDenomFloor : ablate ? kAblateFloor : 0.f;
};

// One score's softmax weight before it is rounded to the input dtype; ref is
// the row's shift (bounded) or running max (exact).
template <Probe P>
__device__ __forceinline__ float weight(float s, float ref) {
  if (P == Probe::AblateDots) return s;
  if (P == Probe::AblateExp) return exp2f(s);
  if (P == Probe::AblateNoProlog) return exp2f(fminf(s - kAblateShift, kSaturate));
  if (Traits<P>::running_max) return exp2f(s - ref);
  return exp2f(fminf(s - ref, kSaturate));
}

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

// Rows r0 .. r0 + 64 of one (batch, head) image into dst [64][DP]: from an
// [S, D] image (row-major: the rows are one contiguous run) or from a [D, S]
// image (S-minor: D runs of 64 contiguous elements, transposed on the way).
// scale > 0: each element times scale, rounded to T (q's treatment).
template <typename T, int D, bool SMinor>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const T* __restrict__ img,
                                          int s, int r0, float scale) {
  constexpr int DP = Smem<D>::DP;
  for (int e = threadIdx.x; e < BQ * D; e += kThreads) {
    int r, c;
    float x;
    if (SMinor) {
      c = e / BQ;
      r = e - c * BQ;
      x = to_float(img[c * s + r0 + r]);
    } else {
      r = e / D;
      c = e - r * D;
      x = to_float(img[r0 * D + e]);
    }
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
                   T* __restrict__ out, int sq, int sk, float qscale, int anchor) {
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

  load_tile<T, D, Tr::q_sminor>(q_s, qg, sq, q0,
                                Tr::ablate ? 0.f : to_float(from_float<T>(qscale)));

  auto k_buf = [&](int b) { return kv_s + b * 2 * Sm::tile; };
  auto v_buf = [&](int b) { return kv_s + b * 2 * Sm::tile + Sm::tile; };
  auto load_kv = [&](int t, int b, bool with_v) {
    load_tile<T, D, Tr::k_sminor>(k_buf(b), kg, sk, t * BK, 0.f);
    if (with_v) load_tile<T, D, Tr::v_sminor>(v_buf(b), vg, sk, t * BK, 0.f);
  };

  float acc[RQ][NC], m_i[RQ], l_i[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m_i[i] = Tr::bounded ? -CUDART_INF_F : kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  if (Tr::bounded) {
    // prologue: each row's max over its anchor window, then shift = max + 16
    for (int t = 0; t < anchor / BK; ++t) {
      __syncthreads();  // q_s written / the previous tile's k_s reads done
      load_kv(t, 0, false);
      __syncthreads();
      float s[RQ][RK];
      tile_scores<D>(q_s, k_buf(0), tq, tk, s);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) m_i[i] = fmaxf(m_i[i], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
#pragma unroll
      for (int off = TK / 2; off > 0; off >>= 1)
        m_i[i] = fmaxf(m_i[i], __shfl_xor_sync(0xffffffffu, m_i[i], off));
      m_i[i] += kShiftMargin;
    }
  }

  // The softmax weights of one tile's scores into p_s (rounded to T), the
  // row sums and (running max) the rescale, then acc += p v from V buffer b.
  // Starts after every read of p_s and of the buffer's previous tile is done.
  auto softmax_pv = [&](float (&s)[RQ][RK], int b) {
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      float ref = m_i[i], alpha = 1.f;
      if (Tr::running_max) {
        float mx = s[i][0];
#pragma unroll
        for (int j = 1; j < RK; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
        for (int off = TK / 2; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        ref = fmaxf(m_i[i], mx);
        alpha = exp2f(m_i[i] - ref);
        m_i[i] = ref;
      }
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = to_float(from_float<T>(weight<P>(s[i][j], ref)));  // in the input dtype
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
      load_kv(t, 0, true);
      __syncthreads();
      float s[RQ][RK];
      tile_scores<D>(q_s, k_buf(0), tq, tk, s);
      softmax_pv(s, 0);
    }
  } else {
    // prologue: tile 0's scores
    __syncthreads();
    load_kv(0, 0, true);
    __syncthreads();
    float s_prev[RQ][RK];
    tile_scores<D>(q_s, k_buf(0), tq, tk, s_prev);
    // steady state: tile t's scores, then tile t - 1's softmax and PV
    for (int t = 1; t < nk; ++t) {
      __syncthreads();  // tile t - 2's V and p reads are done: its buffer is free
      load_kv(t, t & 1, true);
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
    const float l = Tr::floor > 0.f ? fmaxf(l_i[i], Tr::floor) : l_i[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) o_s[(tk + TK * c) * Sm::OS + tq * RQ + i] = acc[i][c] / l;
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
                   int sk, int anchor, cudaStream_t stream) {
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
                                           sk, qscale, anchor);
  return cudaGetLastError();
}

template <typename T, Probe P>
int launch_d(const void* q, const void* k, const void* v, void* out, int bh, int sq, int sk,
             int d, int anchor, cudaStream_t s) {
  if (d == 40) return int(launch<T, P, 40>(q, k, v, out, bh, sq, sk, anchor, s));
  if (d == 80) return int(launch<T, P, 80>(q, k, v, out, bh, sq, sk, anchor, s));
  return -1;
}

template <Probe P>
int probe(const void* q, const void* k, const void* v, void* out, int bh, int sq, int sk, int d,
          int anchor, int dtype, void* stream) {
  if (bh < 1 || bh > 65535 || sq < BQ || sk < BK || sq % BQ || sk % BK) return -1;
  if (Traits<P>::bounded && (anchor < BK || anchor % BK || sk % anchor)) return -1;
  if ((long long)(sq > sk ? sq : sk) * d > INT_MAX) return -1;  // 32-bit offsets in an image
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // float32 only: bf16 runs on the tensor cores (flash_probes_tc.cu)
  return dtype == 0 ? launch_d<float, P>(q, k, v, out, bh, sq, sk, d, anchor, s) : -1;
}

}  // namespace

// Plain C entry points for ctypes.  dtype: 0 float32, 1 bfloat16.  Each
// returns 0 on success, a cudaError_t code from the launch, or -1 for
// arguments the kernel does not take.

// Row 11: the bounded probes.  layout 0: q, k, v [BH, S, D]; 1: q, k
// [BH, D, S] and v [BH, S, D]; 2: q, k, v [BH, D, S].  out [BH, D, Sq].
// float32 only (bf16: hedit_flash_packed_t_tc).
extern "C" int hedit_flash_packed_t(const void* q, const void* k, const void* v, void* out,
                                    int bh, int sq, int sk, int d, int anchor, int layout,
                                    int dtype, void* stream) {
  switch (layout) {
    case 0: return probe<Probe::PackedT>(q, k, v, out, bh, sq, sk, d, anchor, dtype, stream);
    case 1:
      return probe<Probe::PackedTSMinor>(q, k, v, out, bh, sq, sk, d, anchor, dtype, stream);
    case 2:
      return probe<Probe::PackedTAllSMinor>(q, k, v, out, bh, sq, sk, d, anchor, dtype, stream);
    default: return -1;
  }
}

// Row 10: the exact exp2 probe, q, k, v [BH, S, D] -> out [BH, D, Sq];
// pipe: 0 the plain key loop, 1 the software-pipelined one.  float32 only
// (bf16: hedit_flash_exp2_t_tc).
extern "C" int hedit_flash_exp2_t(const void* q, const void* k, const void* v, void* out,
                                  int bh, int sq, int sk, int d, int pipe, int dtype,
                                  void* stream) {
  if (pipe != 0 && pipe != 1) return -1;
  return pipe ? probe<Probe::Exp2Pipe>(q, k, v, out, bh, sq, sk, d, 0, dtype, stream)
              : probe<Probe::Exp2>(q, k, v, out, bh, sq, sk, d, 0, dtype, stream);
}

// Row 8: the ablations, q, k, v [BH, S, D] -> out [BH, D, Sq]; mode 0 dots,
// 1 exp, 2 noprolog.  float32 only (bf16: hedit_flash_ablate_t_tc).
extern "C" int hedit_flash_ablate_t(const void* q, const void* k, const void* v, void* out,
                                    int bh, int sq, int sk, int d, int mode, int dtype,
                                    void* stream) {
  switch (mode) {
    case 0: return probe<Probe::AblateDots>(q, k, v, out, bh, sq, sk, d, 0, dtype, stream);
    case 1: return probe<Probe::AblateExp>(q, k, v, out, bh, sq, sk, d, 0, dtype, stream);
    case 2: return probe<Probe::AblateNoProlog>(q, k, v, out, bh, sq, sk, d, 0, dtype, stream);
    default: return -1;
  }
}
