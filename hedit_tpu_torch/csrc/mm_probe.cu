// The matmul cost probe in float32 on Hopper's CUDA cores (sm_90a), replacing
// the TPU kernel scripts/mm_probe.py:_loop_kernel for float32 operands (entry
// point hedit_mm_loop, wrapper ops/mm_probe.py:mm_loop_cuda; bf16 operands,
// the script's own, take the tensor-core kernel of mm_probe_tc.cu):
//
//   o = sum_{i < reps} dot(nudge_i(A), B),  nudge_i(A) = A + i,
//
// accumulated in float32 into a float32 [M, N] output.  The operands come in
// the script's four dimension numbers:
//
//   layout  A        B        the script's dnums
//   nn      [M, K]   [K, N]   (((1,), (0,)), ((), ()))
//   tl      [K, M]   [K, N]   (((0,), (0,)), ((), ()))
//   tr      [M, K]   [N, K]   (((1,), (1,)), ((), ()))
//   tm      [K, M]   [N, K]   (((0,), (1,)), ((), ()))
//
// One template with two compile-time flags, A stored K-major ([K, M]) and B
// stored N-major ([N, K]); they change only the loaders' addressing, which
// reads consecutive addresses with consecutive threads in either layout and
// writes the same [k][m] / [k][n] shared tiles (odd strides).
//
// A block owns 64 x 64 outputs (256 threads as 16 x 16, 4 x 4 a thread,
// float32 FMAs on the CUDA cores).  The TPU kernel kept both whole operands
// in VMEM; an H100 block has 227 KB, so:
// * K <= 128 (the qk-like cases, K = 40, 48, 128): the block's A rows and B
//   columns stay resident in shared memory across all reps; each rep writes
//   the nudged A tile from the resident one and runs the FMA loop;
// * K > 128 (the pv-like cases, K = 2048): each rep streams K in chunks of
//   128 from device memory, nudging A on the way in.  The working set (at
//   most 5.2 MB of operands) stays in the 50 MB L2, so the re-reads are L2
//   traffic.
// Ragged edges of M and N are masked; K is any length.
//
// What bounds it: 2 M N K reps FLOP of float32 FMAs, at most 67 TFLOP/s on
// the CUDA cores.  The pv-like cases have few output blocks (8 or 16 for 132
// SMs).

#include <climits>

#include "flash_common.cuh"

namespace {

constexpr int TM = 16, TN = 16, RM = 4, RN = 4;
constexpr int BM = TM * RM, BN = TN * RN;  // 64 x 64 outputs a block
constexpr int kMmThreads = TM * TN;        // 256
constexpr int KC = 128;                    // K rows of a shared tile
constexpr int AS = BM + 1, BS = BN + 1;    // odd strides of a_s [KC][AS], b_s [KC][BS]
constexpr size_t kTileBytes = sizeof(float) * KC * AS;
static_assert(AS == BS, "the three shared tiles have one size");

template <bool AT, bool BT>
__global__ void __launch_bounds__(kMmThreads)
mm_loop_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ o, int m,
               int n, int k, int reps) {
  extern __shared__ float smem[];
  float* a_s = smem;              // [KC][AS]: this rep's nudged A rows of the chunk
  float* b_s = a_s + KC * AS;     // [KC][BS]
  float* a_raw = b_s + KC * BS;   // [KC][AS]: the block's A, resident (K <= KC only)

  const int tid = threadIdx.x;
  const int tx = tid % TN, ty = tid / TN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int rows = min(BM, m - m0), cols = min(BN, n - n0);
  const bool resident = k <= KC;

  // A[m0 + r][k0 + kk] into dst[kk][r], nudged by rep (rep < 0: as it is);
  // rows past M are 0
  auto load_a = [&](float* dst, int k0, int kc, int rep) {
    for (int e = tid; e < BM * kc; e += kMmThreads) {
      int r, kk;
      if (AT) {
        kk = e / BM;
        r = e - kk * BM;
      } else {
        r = e / kc;
        kk = e - r * kc;
      }
      float x = 0.f;
      if (r < rows) {
        x = AT ? a[size_t(k0 + kk) * m + m0 + r] : a[size_t(m0 + r) * k + k0 + kk];
        if (rep >= 0) x += float(rep);
      }
      dst[kk * AS + r] = x;
    }
  };
  // B[k0 + kk][n0 + c] into b_s[kk][c]; columns past N are 0
  auto load_b = [&](int k0, int kc) {
    for (int e = tid; e < BN * kc; e += kMmThreads) {
      int c, kk;
      if (BT) {
        c = e / kc;
        kk = e - c * kc;
      } else {
        kk = e / BN;
        c = e - kk * BN;
      }
      b_s[kk * BS + c] = c < cols ? (BT ? b[size_t(n0 + c) * k + k0 + kk]
                                        : b[size_t(k0 + kk) * n + n0 + c])
                                  : 0.f;
    }
  };

  if (resident) {
    load_a(a_raw, 0, k, -1);
    load_b(0, k);
  }
  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  for (int rep = 0; rep < reps; ++rep) {
    for (int k0 = 0; k0 < k; k0 += KC) {
      const int kc = min(KC, k - k0);
      __syncthreads();  // the previous chunk's reads of a_s and b_s are done
      if (resident) {
        for (int e = tid; e < BM * kc; e += kMmThreads) {
          const int kk = e / BM, r = e - kk * BM;
          a_s[kk * AS + r] = r < rows ? a_raw[kk * AS + r] + float(rep) : 0.f;
        }
      } else {
        load_a(a_s, k0, kc, rep);
        load_b(k0, kc);
      }
      __syncthreads();
      for (int kk = 0; kk < kc; ++kk) {
        float av[RM], bv[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) av[i] = a_s[kk * AS + ty + TM * i];
#pragma unroll
        for (int j = 0; j < RN; ++j) bv[j] = b_s[kk * BS + tx + TN * j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + TM * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int c = tx + TN * j;
      if (c < cols) o[size_t(m0 + r) * n + n0 + c] = acc[i][j];
    }
  }
}

template <bool AT, bool BT>
cudaError_t launch(const void* a, const void* b, void* o, int m, int n, int k, int reps,
                   cudaStream_t stream) {
  auto kernel = mm_loop_kernel<AT, BT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(3 * kTileBytes));
  if (err != cudaSuccess) return err;
  const size_t smem = (k <= KC ? 3 : 2) * kTileBytes;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, kMmThreads, smem, stream>>>(static_cast<const float*>(a),
                                             static_cast<const float*>(b),
                                             static_cast<float*>(o), m, n, k, reps);
  return cudaGetLastError();
}

cudaError_t by_layout(const void* a, const void* b, void* o, int m, int n, int k, int reps,
                      int layout, cudaStream_t s) {
  switch (layout) {
    case 0: return launch<false, false>(a, b, o, m, n, k, reps, s);
    case 1: return launch<true, false>(a, b, o, m, n, k, reps, s);
    case 2: return launch<false, true>(a, b, o, m, n, k, reps, s);
    default: return launch<true, true>(a, b, o, m, n, k, reps, s);
  }
}

}  // namespace

// Plain C entry point for ctypes.  a, b float32 (dtype 0; anything else is
// refused), o [M, N] float32; layout 0 nn, 1 tl, 2 tr, 3 tm (the table above).
// Returns 0 on success, a cudaError_t code from the launch, or -1 for
// arguments the kernel does not take.
extern "C" int hedit_mm_loop(const void* a, const void* b, void* o, int m, int n, int k,
                             int reps, int layout, int dtype, void* stream) {
  if (m < 1 || n < 1 || k < 1 || reps < 0 || layout < 0 || layout > 3) return -1;
  if ((m + BM - 1) / BM > 65535) return -1;
  if ((long long)m * k > INT_MAX || (long long)n * k > INT_MAX) return -1;
  if (dtype != 0) return -1;
  return int(by_layout(a, b, o, m, n, k, reps, layout, static_cast<cudaStream_t>(stream)));
}
