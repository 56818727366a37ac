// The matmul cost probe in bf16 on Hopper's tensor cores (sm_90a, mma.sync
// m16n8k16, bf16 x bf16 -> float32), replacing the TPU kernel
// scripts/mm_probe.py:_loop_kernel (entry point hedit_mm_loop_tc, wrapper
// ops/mm_probe.py:mm_loop_cuda; float32 operands take the CUDA-core kernel of
// mm_probe.cu):
//
//   o[M, N] (float32) = sum_{i < reps} dot(nudge_i(A), B),  nudge_i(A) = bf16(A + i),
//
// in the script's four dimension numbers (layout 0 nn: A [M, K], B [K, N];
// 1 tl: A [K, M], B [K, N]; 2 tr: A [M, K], B [N, K]; 3 tm: A [K, M], B [N, K]).
//
// What bounds it: 2 M N K reps FLOP at the bf16 tensor-core rate; the
// operands are read once and the output written once (at most 2.6 MB and
// 4 MB on the probe, against 5-17 us of products).  The TPU kernel kept both
// operands in VMEM across the reps; here they stay on chip too:
// * a block copies its A rows and B columns of a K chunk once into shared
//   memory (16-byte cp.async where each contiguous dim is a multiple of 8
//   and the pointer 16-byte aligned, else element loads); the stored layout
//   is kept, and the fragments are read with ldmatrix (A stored [K, M] and
//   B stored [K, N] with ldmatrix.trans);
// * each warp loads its raw A fragment (16 rows x 16 k) and its B fragments
//   (16 k x 8 WN columns) of one k-tile into registers once, then runs all the
//   reps on them: the rep loop reads no memory at all.  Each rep nudges the
//   raw A fragment in registers with one add.rn.bf16x2 a register, which
//   rounds a + i once, correctly; the plain version adds in float32 and
//   rounds to bf16, the same value (float32's 24 bits are at least 2 x 8 + 2,
//   so the double rounding is harmless; tests/test_torch_mm_probe_tc.py
//   checks every bf16 value against every i up to 256).  Past rep 256, where
//   i is no bf16 integer, the kernel adds in float32 and rounds as the plain
//   version does.  An A register feeds WN products a rep: a warp takes 16 x BN
//   outputs, BN = 8 WN columns;
// * the caller picks the tile (ops/mm_probe.py:tc_tile): BM = 16, 32, 48 or
//   64 rows (one warp each 16) and BN = 64 (WN = 8) or 40 (WN = 5, for
//   N <= 40: pv_raw's 40 columns are five n8 tiles);
// * K is padded to mma's step of 16 with zeros in both operands' shared
//   tiles: a nudged padding column of A is i, not 0, so B's zero rows are
//   what keeps it out of the sum.  M is padded to 16 rows a warp (M = 40 to
//   48 where BM = 48), the padded rows masked at the store;
// * split-K (ops/mm_probe.py:split_k_plan): where the output tiles are
//   fewer than the card's 132 SMs (the pv cases: 8 or 16 tiles), K is split
//   into chunks that are multiples of 16, one block a tile and a chunk, each
//   writing its float32 partial to a workspace [splits, M, N]; a second
//   kernel sums the partials in split order (no atomics: a relaunch is bit
//   for bit the same).
// On the probe's all-ones input every partial and every sum is an integer
// below 2^24, so the outputs are exact whatever the order.

#include <climits>
#include <cstdint>

#include "flash_mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int KC = 128;          // K rows of a block's shared tiles at a time
constexpr int MAX_WARPS = 4;     // 16 output rows a warp, up to 64 a block
constexpr int TILE_COLS = 64;    // the widest BM and BN
constexpr int PAD = 8;           // bf16 padding at the end of each shared row
// the larger of [KC][TILE_COLS + PAD] and [TILE_COLS][KC + PAD]: every
// layout's tile of A or B
constexpr int TILE_ELEMS = KC * (TILE_COLS + PAD) > TILE_COLS * (KC + PAD)
                               ? KC * (TILE_COLS + PAD) : TILE_COLS * (KC + PAD);
constexpr unsigned kOnePair = 0x3f803f80u;  // bf16 1.0 in both halves
constexpr int kSumThreads = 256;

// rows [r0, r0 + nr) and columns [c0, c0 + nc) of a row-major global matrix
// (row length ld) into dst (row stride ds); elements at rows >= rlim or
// columns >= clim are 0.  vec: 16-byte copies (nc, clim, ld multiples of 8,
// src 16-byte aligned), else element loads.
__device__ __forceinline__ void load_tile(bf16* dst, int ds, const bf16* __restrict__ src,
                                          int ld, int r0, int nr, int rlim, int c0, int nc,
                                          int clim, bool vec) {
  if (vec) {
    const int groups = nc / 8;
    for (int e = threadIdx.x; e < nr * groups; e += blockDim.x) {
      const int r = e / groups, c = 8 * (e - r * groups);
      const bool valid = r0 + r < rlim && c0 + c < clim;
      cp_async_16(smem_u32(dst + r * ds + c),
                  valid ? src + size_t(r0 + r) * ld + c0 + c : src, valid);
    }
  } else {
    for (int e = threadIdx.x; e < nr * nc; e += blockDim.x) {
      const int r = e / nc, c = e - r * nc;
      dst[r * ds + c] = r0 + r < rlim && c0 + c < clim ? src[size_t(r0 + r) * ld + c0 + c]
                                                        : __ushort_as_bfloat16(0);
    }
  }
}

__device__ __forceinline__ unsigned add_bf16x2(unsigned x, unsigned y) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(x), "r"(y));
  return d;
}

// reps [r0, r1) of one k-tile on resident fragments.  EXACT_I: every i is a
// bf16 integer (i <= 256), one add.rn.bf16x2 a register; else the float32
// add of the plain version, then the rounding to bf16.
template <int WN, bool EXACT_I>
__device__ __forceinline__ void run_reps(float (&acc)[WN][4], const unsigned (&a_raw)[4],
                                         const unsigned (&b)[WN][2], int r0, int r1) {
  unsigned ii = 0;  // EXACT_I (r0 = 0): bf16 of rep in both halves, counted up exactly
#pragma unroll 2
  for (int rep = r0; rep < r1; ++rep) {
    unsigned a[4];
    if (EXACT_I) {
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = add_bf16x2(a_raw[r], ii);
      ii = add_bf16x2(ii, kOnePair);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[r] = pack_bf16(__uint_as_float(a_raw[r] << 16) + float(rep),
                         __uint_as_float(a_raw[r] & 0xffff0000u) + float(rep));
    }
#pragma unroll
    for (int nt = 0; nt < WN; ++nt) mma_bf16(acc[nt], a, b[nt][0], b[nt][1]);
  }
}

template <bool AT, bool BT, int WN>
__global__ void __launch_bounds__(MAX_WARPS * 32)
mm_loop_tc_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b, float* __restrict__ o,
                  int m, int n, int k, int reps, int chunk, bool a_vec, bool b_vec) {
  __shared__ __align__(16) bf16 a_s[TILE_ELEMS];
  __shared__ __align__(16) bf16 b_s[TILE_ELEMS];
  constexpr int BN = 8 * WN;
  const int bm = 16 * (blockDim.x / 32);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * bm, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * chunk, ke = min(k, kb + chunk);
  const bool active = m0 + 16 * warp < m;  // a warp wholly below M only loads
  // element strides of the shared tiles: A [k][m] or [m][k], B [n][k] or [k][n]
  const int as = AT ? bm + PAD : KC + PAD;
  const int bs = BT ? KC + PAD : BN + PAD;
  const int wr = 16 * warp;  // the warp's first row in the block

  float acc[WN][4];
#pragma unroll
  for (int nt = 0; nt < WN; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = 0.f;

  for (int c0 = kb; c0 < ke; c0 += KC) {
    const int ktiles = (min(KC, ke - c0) + 15) / 16;
    const int kp = 16 * ktiles;  // this chunk's K, padded with zeros to mma's step
    __syncthreads();             // every warp has read the previous chunk's tiles
    if (AT)
      load_tile(a_s, as, a, m, c0, kp, ke, m0, bm, m, a_vec);
    else
      load_tile(a_s, as, a, k, m0, bm, m, c0, kp, ke, a_vec);
    if (BT)
      load_tile(b_s, bs, b, k, n0, BN, n, c0, kp, ke, b_vec);
    else
      load_tile(b_s, bs, b, n, c0, kp, ke, n0, BN, n, b_vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < ktiles; ++t) {
      const int kt = 16 * t;
      const int j = lane / 8, l8 = lane % 8;  // the lane's 8 x 8 matrix and row in it
      unsigned a_raw[4], bf[WN][2];
      if (AT)  // rows k, columns m
        ldsm_x4_t(smem_u32(a_s + (kt + l8 + 8 * (j / 2)) * as + wr + 8 * (j % 2)), a_raw);
      else     // rows m, columns k
        ldsm_x4(smem_u32(a_s + (wr + l8 + 8 * (j % 2)) * as + kt + 8 * (j / 2)), a_raw);
#pragma unroll
      for (int p = 0; p < WN / 2; ++p) {  // n tiles 2p, 2p + 1
        unsigned r[4];
        if (BT)  // rows n, columns k
          ldsm_x4(smem_u32(b_s + (16 * p + l8 + 8 * (j / 2)) * bs + kt + 8 * (j % 2)), r);
        else     // rows k, columns n
          ldsm_x4_t(smem_u32(b_s + (kt + l8 + 8 * (j % 2)) * bs + 16 * p + 8 * (j / 2)), r);
        bf[2 * p][0] = r[0];
        bf[2 * p][1] = r[1];
        bf[2 * p + 1][0] = r[2];
        bf[2 * p + 1][1] = r[3];
      }
      if (WN % 2) {  // the last n tile alone; lanes 16-31 repeat 0-15's addresses
        constexpr int nt = WN - 1;
        unsigned r[2];
        if (BT)
          ldsm_x2(smem_u32(b_s + (8 * nt + l8) * bs + kt + 8 * (j % 2)), r);
        else
          ldsm_x2_t(smem_u32(b_s + (kt + l8 + 8 * (j % 2)) * bs + 8 * nt), r);
        bf[nt][0] = r[0];
        bf[nt][1] = r[1];
      }
      const int exact_reps = min(reps, 257);
      run_reps<WN, true>(acc, a_raw, bf, 0, exact_reps);
      if (reps > exact_reps) run_reps<WN, false>(acc, a_raw, bf, exact_reps, reps);
    }
  }
  if (!active) return;

  // this split's [M, N] partial (the output itself when there is one split)
  float* part = o + size_t(blockIdx.z) * m * n;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int nt = 0; nt < WN; ++nt) {
    const int col = n0 + 8 * nt + 2 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wr + g + 8 * h;
      if (row >= m || col >= n) continue;
      float* dst = part + size_t(row) * n + col;
      if (n % 2 == 0) {  // col is even, so col + 1 < n and the pair is 8-byte aligned
        *reinterpret_cast<float2*>(dst) = make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
      } else {
        dst[0] = acc[nt][2 * h];
        if (col + 1 < n) dst[1] = acc[nt][2 * h + 1];
      }
    }
  }
}

// o[e] = sum over s of ws[s][e], in split order
__global__ void __launch_bounds__(kSumThreads)
mm_split_sum_kernel(const float* __restrict__ ws, float* __restrict__ o, size_t count,
                    int splits) {
  for (size_t e = size_t(blockIdx.x) * blockDim.x + threadIdx.x; e < count;
       e += size_t(gridDim.x) * blockDim.x) {
    float s = ws[e];
    for (int z = 1; z < splits; ++z) s += ws[size_t(z) * count + e];
    o[e] = s;
  }
}

template <bool AT, bool BT, int WN>
cudaError_t launch(const bf16* a, const bf16* b, float* o, int m, int n, int k, int reps,
                   int bm, int chunk, int splits, bool a_vec, bool b_vec, cudaStream_t s) {
  const dim3 grid((n + 8 * WN - 1) / (8 * WN), (m + bm - 1) / bm, splits);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  mm_loop_tc_kernel<AT, BT, WN><<<grid, 2 * bm, 0, s>>>(a, b, o, m, n, k, reps, chunk,
                                                       a_vec, b_vec);
  return cudaGetLastError();
}

template <int WN>
cudaError_t by_layout(const bf16* a, const bf16* b, float* o, int m, int n, int k, int reps,
                      int layout, int bm, int chunk, int splits, bool a_vec, bool b_vec,
                      cudaStream_t s) {
  switch (layout) {
    case 0: return launch<false, false, WN>(a, b, o, m, n, k, reps, bm, chunk, splits, a_vec, b_vec, s);
    case 1: return launch<true, false, WN>(a, b, o, m, n, k, reps, bm, chunk, splits, a_vec, b_vec, s);
    case 2: return launch<false, true, WN>(a, b, o, m, n, k, reps, bm, chunk, splits, a_vec, b_vec, s);
    default: return launch<true, true, WN>(a, b, o, m, n, k, reps, bm, chunk, splits, a_vec, b_vec, s);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Plain C entry point for ctypes.  a, b bfloat16 (dtype 1; anything else is
// refused), o [M, N] float32, ws the float32 workspace [splits, M, N] (read
// only when splits > 1); layout 0 nn, 1 tl, 2 tr, 3 tm (the table above);
// the output tile bm x bn (bm 16, 32, 48 or 64; bn 40 or 64) and the split,
// chunk a multiple of 16 and splits = ceil(K / chunk), as
// ops/mm_probe.py:tc_tile and split_k_plan give them.  Returns 0 on success,
// a cudaError_t code from a launch, or -1 for arguments the kernel does not
// take.
extern "C" int hedit_mm_loop_tc(const void* a, const void* b, void* o, void* ws, int m, int n,
                                int k, int reps, int layout, int bm, int bn, int chunk,
                                int splits, int dtype, void* stream) {
  if (m < 1 || n < 1 || k < 1 || reps < 0 || layout < 0 || layout > 3 || dtype != 1) return -1;
  if (bm < 16 || bm > 16 * MAX_WARPS || bm % 16 || (bn != 40 && bn != TILE_COLS)) return -1;
  if (chunk < 16 || chunk % 16 || splits < 1 || splits > 65535 ||
      splits != (k + chunk - 1) / chunk || (splits > 1 && ws == nullptr))
    return -1;
  if ((long long)m * k > INT_MAX || (long long)n * k > INT_MAX) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool a_t = layout == 1 || layout == 3, b_t = layout >= 2;
  // 16-byte copies where every row of the stored operand starts 16-byte aligned
  const bool a_vec = aligned16(a) && (a_t ? m : k) % 8 == 0;
  const bool b_vec = aligned16(b) && (b_t ? k : n) % 8 == 0;
  const auto* ab = static_cast<const bf16*>(a);
  const auto* bb = static_cast<const bf16*>(b);
  float* dst = static_cast<float*>(splits > 1 ? ws : o);
  cudaError_t err = bn == 40
      ? by_layout<5>(ab, bb, dst, m, n, k, reps, layout, bm, chunk, splits, a_vec, b_vec, s)
      : by_layout<8>(ab, bb, dst, m, n, k, reps, layout, bm, chunk, splits, a_vec, b_vec, s);
  if (err != cudaSuccess || splits == 1) return int(err);
  const size_t count = size_t(m) * n;
  const size_t blocks = (count + kSumThreads - 1) / kSumThreads;
  mm_split_sum_kernel<<<unsigned(blocks < 4096 ? blocks : 4096), kSumThreads, 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(o), count, splits);
  return int(cudaGetLastError());
}
