// The matmul cost probe in float32 on Hopper's CUDA cores (sm_90a), replacing
// the TPU kernel scripts/mm_probe.py:_loop_kernel for float32 operands (entry
// point hedit_mm_loop, wrapper ops/mm_probe.py:mm_loop_cuda; bf16 operands,
// the script's own, take the tensor-core kernel of mm_probe_tc.cu):
//
//   o = sum_{i < reps} dot(nudge_i(A), B),  nudge_i(A) = A + i,
//
// accumulated in float32 into a float32 [M, N] output, every term one
// float32 FMA of the nudged A (rounded to float32 each rep) by B.  The
// operands come in the script's four dimension numbers:
//
//   layout  A        B        the script's dnums
//   nn      [M, K]   [K, N]   (((1,), (0,)), ((), ()))
//   tl      [K, M]   [K, N]   (((0,), (0,)), ((), ()))
//   tr      [M, K]   [N, K]   (((1,), (1,)), ((), ()))
//   tm      [K, M]   [N, K]   (((0,), (1,)), ((), ()))
//
// What bounds it: 2 M N K reps FLOP of float32 FMAs, at most 67 TFLOP/s on
// the CUDA cores (the operands, at most 4.2 MB on the probe, and the output
// are microseconds at 3.35 TB/s).  The TPU kernel kept both operands in VMEM
// across the reps and ran its grid in order on one core; here:
// * the plan (ops/mm_probe.py:core_plan, passed to the entry point) splits
//   the contraction, reps x K terms an output, into slices: K chunks and,
//   where K is too short to fill the card, ranges of reps.  One block takes
//   one output tile and one slice, so the probe's few tiles still fill the
//   132 SMs (the pv cases: 2 or 4 tiles, 128 K chunks of 16 or 64 of 32;
//   the qk cases: 64 tiles, 2 or 4 K chunks).  With one slice the block
//   writes the output; with more it writes its float32 partial into a
//   workspace [slices, M, N], and mm_split_sum.cuh sums the partials in
//   slice order (no atomics: a relaunch is bit for bit the same);
// * the block copies its A rows and B columns of the slice's K chunk into
//   shared memory once, kt rows of K at a time, as A [k][m] and B [k][n],
//   each thread's rm rows (rn columns) in slots rounded up to a multiple of
//   4: B by 16-byte cp.async where it is stored [K, N] and aligned, else
//   (and A always) by element loads, which transpose where the operand is
//   stored K-contiguous.  Nothing is read again per rep;
// * a thread owns rm x rn outputs and, for each k, reads its rm values of A
//   and rn of B once, as float4s, then runs all the slice's reps on them in
//   registers: per rep rm FADDs make the nudged A, fl(a + i), one FADD the
//   rep's float, and rm x rn FMAs add its products.  The rep loop reads no
//   memory, so the shared-load ceiling of the earlier 4 x 4 tile, re-read
//   each rep, is gone.  The nudge is what is left: one FADD a row a rep, so
//   a thread takes few rows and many columns (2 x 32: 64 FMAs to 3 FADDs;
//   8 x 8 would pay 9);
// * tiles (ops/mm_probe.py:core_tile): 128 x 128 (2 x 32 a thread, 4 x 64
//   threads), 256 x 40 where N <= 40 (2 x 20, 2 x 128 threads), 40 x 256
//   where M <= 40 (5 x 8, 32 x 8 threads: a 40-row tile covered whole);
//   ragged M, N and K are masked (zeros in shared memory past M and N; the
//   rows past a chunk's end are never summed).
// On the probe's all-ones input every partial and every sum is an integer
// below 2^24, so the outputs are exact whatever the slices.

#include <climits>
#include <cstdint>

#include "flash_mma.cuh"
#include "mm_split_sum.cuh"

namespace {

constexpr int PAD = 4;           // floats at the end of each shared row
constexpr int MAX_THREADS = 256;
constexpr size_t MAX_SHARED = 232448;  // 227 KB, a block's most

// shared slots a thread's rm rows of A (or rn columns of B) take: a
// multiple of 4, so that each thread's values start 16-byte aligned
__host__ __device__ constexpr int slots(int r) { return (r + 3) / 4 * 4; }

// bytes of a block's shared tiles: kt rows of A [k][ty slots(rm) + PAD] and
// of B [k][tx slots(rn) + PAD]
size_t shared_bytes(int rm, int rn, int tx, int ty, int kt) {
  return sizeof(float) * size_t(kt) * (ty * slots(rm) + PAD + tx * slots(rn) + PAD);
}

// the thread's R values at p (16-byte aligned, slots(R) of them) as float4s
template <int R>
__device__ __forceinline__ void load_frag(float (&v)[R], const float* p) {
#pragma unroll
  for (int q = 0; q < slots(R) / 4; ++q) {
    const float4 x = reinterpret_cast<const float4*>(p)[q];
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (4 * q + t < R) v[4 * q + t] = xs[t];
  }
}

template <int RM, int RN, bool AT, bool BT>
__global__ void __launch_bounds__(MAX_THREADS, 2)
mm_loop_core_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ o, int m, int n, int k, int tx, int kt, int chunk,
                    int reps, int rchunk, int rsplits, bool b_vec, bool o_vec) {
  constexpr int SA = slots(RM), SB = slots(RN);
  extern __shared__ __align__(16) float smem[];
  const int ty = blockDim.x / tx;
  const int bm = ty * RM, bn = tx * RN;
  const int as = ty * SA + PAD, bs = tx * SB + PAD;  // shared row strides
  float* a_s = smem;            // [kt][as]: row r of the tile at slot (r / RM) SA + r % RM
  float* b_s = smem + kt * as;  // [kt][bs]: column c at slot (c / RN) SB + c % RN
  const int tid = threadIdx.x, tc = tid % tx, tr = tid / tx;
  const int m0 = blockIdx.y * bm, n0 = blockIdx.x * bn;
  const int slice = blockIdx.z, ks = slice / rsplits, rs = slice % rsplits;
  const int kb = ks * chunk, ke = min(k, kb + chunk);
  const int r0 = rs * rchunk, r1 = min(reps, r0 + rchunk);

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  for (int c0 = kb; c0 < ke; c0 += kt) {
    const int kc = min(kt, ke - c0);
    __syncthreads();  // every thread has read the previous rows
    // A rows m0.., K rows c0.. into a_s[kk][slot]; rows past M are 0 (element
    // loads: a thread's rm = 2 or 5 rows take 4 or 8 slots)
    for (int e = tid; e < kc * bm; e += blockDim.x) {
      int r, kk;
      if (AT) {
        kk = e / bm;
        r = e - kk * bm;
      } else {  // consecutive threads along K, A's contiguous dim
        r = e / kc;
        kk = e - r * kc;
      }
      a_s[kk * as + (r / RM) * SA + r % RM] =
          m0 + r < m ? (AT ? a[size_t(c0 + kk) * m + m0 + r] : a[size_t(m0 + r) * k + c0 + kk])
                     : 0.f;
    }
    // B rows c0.., columns n0.. into b_s[kk][slot]; columns past N are 0
    if (!BT && b_vec) {  // SB = RN (slot = column), N % 4 == 0: 16-byte copies along N
      const int groups = bn / 4;
      for (int e = tid; e < kc * groups; e += blockDim.x) {
        const int kk = e / groups, c = 4 * (e - kk * groups);
        const bool valid = n0 + c < n;
        cp_async_16(smem_u32(b_s + kk * bs + c),
                    valid ? b + size_t(c0 + kk) * n + n0 + c : b, valid);
      }
    } else {
      for (int e = tid; e < kc * bn; e += blockDim.x) {
        int c, kk;
        if (BT) {  // consecutive threads along K, B's contiguous dim
          c = e / kc;
          kk = e - c * kc;
        } else {
          kk = e / bn;
          c = e - kk * bn;
        }
        b_s[kk * bs + (c / RN) * SB + c % RN] =
            n0 + c < n ? (BT ? b[size_t(n0 + c) * k + c0 + kk] : b[size_t(c0 + kk) * n + n0 + c])
                       : 0.f;
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    for (int kk = 0; kk < kc; ++kk) {
      float av[RM], bv[RN];
      load_frag(av, a_s + kk * as + tr * SA);
      load_frag(bv, b_s + kk * bs + tc * SB);
      float fi = float(r0);  // the rep, exact (reps < 2^24)
#pragma unroll 4
      for (int rep = r0; rep < r1; ++rep) {
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float t = av[i] + fi;  // fl(a + i), the nudge
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(t, bv[j], acc[i][j]);
        }
        fi += 1.f;
      }
    }
  }

  // this slice's [M, N] partial (the output itself when there is one slice)
  float* part = o + size_t(slice) * m * n;
  const int col = n0 + tc * RN;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = m0 + tr * RM + i;
    if (row >= m || col >= n) continue;
    float* dst = part + size_t(row) * n + col;
    if (RN % 4 == 0 && o_vec && col + RN <= n) {  // N % 4 == 0, col % 4 == 0: aligned
#pragma unroll
      for (int q = 0; q < RN / 4; ++q)
        reinterpret_cast<float4*>(dst)[q] =
            make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2], acc[i][4 * q + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < RN; ++j)
        if (col + j < n) dst[j] = acc[i][j];
    }
  }
}

struct Args {
  const float *a, *b;
  float* o;
  int m, n, k, reps, tx, ty, kt, chunk, ksplits, rchunk, rsplits;
  bool b_vec, o_vec;
};

template <int RM, int RN, bool AT, bool BT>
cudaError_t launch(const Args& p, cudaStream_t s) {
  auto kernel = mm_loop_core_kernel<RM, RN, AT, BT>;
  const size_t smem = shared_bytes(RM, RN, p.tx, p.ty, p.kt);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.n + p.tx * RN - 1) / (p.tx * RN), (p.m + p.ty * RM - 1) / (p.ty * RM),
                  p.ksplits * p.rsplits);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  kernel<<<grid, p.tx * p.ty, smem, s>>>(p.a, p.b, p.o, p.m, p.n, p.k, p.tx, p.kt, p.chunk,
                                         p.reps, p.rchunk, p.rsplits, p.b_vec, p.o_vec);
  return cudaGetLastError();
}

template <int RM, int RN>
cudaError_t by_layout(int layout, const Args& p, cudaStream_t s) {
  switch (layout) {
    case 0: return launch<RM, RN, false, false>(p, s);
    case 1: return launch<RM, RN, true, false>(p, s);
    case 2: return launch<RM, RN, false, true>(p, s);
    default: return launch<RM, RN, true, true>(p, s);
  }
}

// the thread tiles the plan takes (ops/mm_probe.py:core_tile)
bool tile_supported(int rm, int rn) {
  return (rm == 2 && rn == 32) || (rm == 2 && rn == 20) || (rm == 5 && rn == 8);
}

cudaError_t by_tile(int rm, int rn, int layout, const Args& p, cudaStream_t s) {
  if (rm == 2 && rn == 32) return by_layout<2, 32>(layout, p, s);
  if (rm == 2 && rn == 20) return by_layout<2, 20>(layout, p, s);
  return by_layout<5, 8>(layout, p, s);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Plain C entry point for ctypes.  a, b float32 (dtype 0; anything else is
// refused), o [M, N] float32, ws the float32 workspace [ksplits rsplits, M, N]
// (read only when there is more than one slice); layout 0 nn, 1 tl, 2 tr,
// 3 tm (the table above); the plan as ops/mm_probe.py:core_plan gives it: a
// thread's rm x rn outputs, the block's threads tx x ty (an output tile of
// ty rm x tx rn), kt K rows of shared tiles at a time, K chunks of chunk
// (ksplits = ceil(K / chunk)) and rep ranges of rchunk (rsplits =
// ceil(reps / rchunk), 1 when reps = 0); slice s is chunk s / rsplits and
// rep range s % rsplits.  Returns 0 on success, a cudaError_t code from a
// launch, or -1 for arguments the kernel does not take.
extern "C" int hedit_mm_loop(const void* a, const void* b, void* o, void* ws, int m, int n,
                             int k, int reps, int layout, int rm, int rn, int tx, int ty, int kt,
                             int chunk, int ksplits, int rchunk, int rsplits, int dtype,
                             void* stream) {
  if (m < 1 || n < 1 || k < 1 || reps < 0 || layout < 0 || layout > 3 || dtype != 0) return -1;
  if (!tile_supported(rm, rn) || tx < 1 || ty < 1 || tx * ty > MAX_THREADS || kt < 1 ||
      shared_bytes(rm, rn, tx, ty, kt) > MAX_SHARED)
    return -1;
  if (chunk < 1 || ksplits != (k + chunk - 1) / chunk || rchunk < 1 ||
      rsplits != (reps == 0 ? 1 : (reps + rchunk - 1) / rchunk))
    return -1;
  const long long slices = (long long)ksplits * rsplits;
  if (slices > 65535 || (slices > 1 && ws == nullptr)) return -1;
  if ((long long)m * k > INT_MAX || (long long)n * k > INT_MAX) return -1;
  const bool b_t = layout >= 2;
  float* dst = static_cast<float*>(slices > 1 ? ws : o);
  // 16-byte copies of B where it is stored [K, N], every row 16-byte aligned
  // (a thread's rn columns fill their slots)
  const Args p{static_cast<const float*>(a), static_cast<const float*>(b), dst, m, n, k, reps,
               tx, ty, kt, chunk, ksplits, rchunk, rsplits,
               !b_t && rn % 4 == 0 && aligned16(b) && n % 4 == 0, aligned16(dst) && n % 4 == 0};
  cudaError_t err = by_tile(rm, rn, layout, p, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess || slices == 1) return int(err);
  return int(launch_split_sum(dst, static_cast<float*>(o), size_t(m) * n, int(slices),
                              static_cast<cudaStream_t>(stream)));
}
