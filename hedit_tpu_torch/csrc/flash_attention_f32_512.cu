// The flash-attention forward in float32 at the VAE's head dim d = 512 on
// Hopper's CUDA cores (sm_90a), in both softmax forms: the bounded
// (max-free) one, optionally with the base-2 log-sum-exp of each query as a
// second output, and the exact one (running max and rescale).  Every
// product is a float32 FMA: no TF32 in any form.
//
// Replaces, for float32 inputs at d = 512, the TPU kernels of
// hedit_tpu/ops/flash_attention.py
//   row 1: _flash_bounded_kernel (:220), head-split [BH, S, D]: entry point
//     hedit_flash_attention_fwd_f32_512, wrapper flash_attention_cuda (every
//     float32 VAE encode or decode whose mid-block attention fits JAX's K/V
//     budget: 256 px to 360 px images); on packed heads
//     hedit_flash_attention_fwd_packed_bounded_f32_512, wrapper
//     flash_attention_packed_bounded_cuda (on no path);
//   row 3: _flash_bounded_lse_kernel (:464): hedit_flash_attention_fwd_lse_f32_512,
//     wrapper flash_attention_lse_cuda (the float32 style gradient through
//     such a decode);
//   row 6: _flash_kernel (:60): hedit_flash_attention_fwd_exact_f32_512,
//     wrapper flash_attention_exact_cuda; row 7 on packed heads,
//     _flash_packed_kernel (:340): hedit_flash_attention_fwd_packed_exact_f32_512,
//     wrapper flash_attention_packed_cuda (both on no editing path).
// The CUDA-core template (flash_attention.cu) served these before; its
// float32 d = 512 forward instances stay for side-by-side timings by entry
// point only.  float32 at d = 40 / 80 runs flash_attention_f32.cu (bounded)
// and the template (exact), bf16 the tensor cores.
//
// The function, as the plain versions compute it: q * scale, scale =
// 1/sqrt(d) * log2(e) formed in double and rounded to float; scores in
// float32.  Bounded: each row's shift = the max of its scores over the first
// a_end = min(anchor, Sk) keys (anchor 1024 at d = 512) + 16; p =
// exp2(min(s - shift, 100)) for every key below Sk; the sum floored at
// 1.2e-38; out = acc / sum, lse2 = shift + log2(sum).  Exact: over key tiles
// of kKeys (exact_key_tile(512, float32)) a running max m, p = exp2(s - m),
// the accumulator and the sum rescaled by exp2(m_old - m_new); out = acc /
// sum.  Sums run in a fixed order (no atomics), so two launches give the same
// bits.
//
// What bounds it on the H100.  4 Sq Sk D FLOP of float32 FMAs against 4
// bytes an element of q, k, v and out: at [1, 1, 1024, 512] 2.1 GFLOP
// against 8 MB, so the bound is the FP32 rate (67 TFLOP/s: 0.0321 ms; 0.513
// ms at 4096).  The template reached 3% (1024) and 9% (4096) of it, for three
// reasons this kernel answers:
//
// 1. The anchor window is scored once and kept on chip.  At d = 512 the
//    window is 1024 keys: the template's prologue ran the window's score
//    product a second time, at Sk = 1024 every key (3 products where the
//    function needs 2).  As the TPU kernel keeps block 0's scores
//    (hedit_tpu/ops/flash_attention.py:235-237, 290-293), each CTA here
//    scores its share of the window's key tiles once and keeps the scores in
//    registers (16 floats a thread a tile), takes their max over keys below
//    a_end, exchanges the row maxima across the cluster (distributed shared
//    memory), and turns the same scores into p and their PV contribution.
//    The keys after the window stream after that.
// 2. A thread-block cluster of C CTAs shares one block of kRows = 32 query
//    rows and splits the keys: the window's key tiles, then the rest, each
//    in C contiguous shares.  Each CTA keeps its own row sums and its 32 x
//    512 accumulator (and, exact, its running max); at the end the
//    accumulators cross the cluster through distributed shared memory and
//    CTA c combines rows c 32 / C .. in CTA order 0 .. C - 1 (exact: each
//    CTA's part weighted by exp2(m_c - max_c m_c)), so the result is
//    deterministic.  One CTA an SM (218 KB of shared memory), and the card
//    runs 66 clusters of 2 or 15 of 8 at once: C = 2 where that grid fills
//    every SM ([1, 1, 4096, 512]: 256 CTAs, 16 key tiles each), C = 8
//    where it would not ([1, 1, 1024, 512]: 32 row blocks, 256 CTAs of one
//    tile).  Clusters of 4 (30 at once) lost at both shapes.  A K/V element
//    read from L2 feeds 32 rows: 32 MB of L2 reads at [1, 1, 1024, 512].
// 3. Register tiles fed by 128-bit shared-memory loads and cp.async
//    streams.  QK: the 8 warps form kSplit = 4 groups of 2; group g takes
//    dims 16 g .. 16 g + 15 of every 64-dim K item, and each of its threads
//    an 8 x 8 tile of partial scores (16 float4 loads for 256 FMAs, 0.25
//    words a FMA, the rate shared memory can feed; the 4 x 4 tile of the
//    float32 kernel at d = 40 / 80 needs 0.5); the groups' partials of a
//    row are added in group order by the group that owns the row, through
//    shared memory (52 KB, the space p uses later).  PV: a thread owns 8
//    rows x 8 columns of the 32 x 512 output (warp w the columns 64 w ..),
//    reading p [32][132] along the keys and V [16][512] along the columns
//    as float4 (16 loads for 256 FMAs).  K and V stream as items of 32 KB
//    (K: 128 keys x 64 dims; V: 16 keys x 512 columns, so V needs no
//    transpose) through a ring of kSlots shared slots by 16-byte cp.async,
//    kSlots - 1 items ahead, rows past Sk zero-filled.
//
// Block: 256 threads, 8 warps.  QK group g (warps 2g, 2g + 1): thread (tr,
// tk) (tr = t % 4, tk = t / 4 of its 64) owns partial rows tr + 4 i (i < 8)
// and keys tk + 16 j (j < 8); after the exchange, the summed scores of rows
// tr + 4 (2 g + ii) (ii < 2), the same keys.  A row's max and sum reduce
// over its lanes by shuffles and over the group's two warps through shared
// memory in warp order.  PV: warp w owns output rows lane / 8 + 4 i (i < 8)
// and columns 64 w + 4 (lane % 8) + 32 jj (jj < 2, 4 columns each).
// (-D knobs for the tile probe: F512_CLUSTER, F512_QK_SPLIT, F512_ROWS,
// F512_SLOTS, F512_UNROLL; the notes describe the defaults.)
//
// Contract: float32 (dtype 0) only; D = 512; any Sq, Sk >= 1 (ragged tails
// masked); bounded: 1 <= anchor and min(anchor, Sk) <= kWindowMax = 1024;
// every pointer of q, k, v and out 16-byte aligned and every element stride
// a multiple of 4.  Head-split entries: q [BH, Sq, D], k and v [BH, Sk, D],
// contiguous, lse2 [BH, Sq]; packed: as flash_attention.cu's packed entry
// points (packed_layout).  Anything else returns -1.

#include <cooperative_groups.h>

#include <cmath>
#include <cstdint>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace cg = cooperative_groups;

// The tile probe (probes/flash_f32_tiles.py --d512) builds other values with -D:
// CTAs a cluster: 0 chooses by the grid (launch_512), 2, 4 or 8 forces it
#ifndef F512_CLUSTER
#define F512_CLUSTER 0
#endif
// query rows a cluster (and each of its CTAs): 32 or 16
#ifndef F512_ROWS
#define F512_ROWS 32
#endif
// QK: warp groups that split the contraction (1, 2 or 4); each group's
// threads own a register tile of 16 * F512_QK_SPLIT partial scores (at 32
// rows: 4 x 4, 8 x 4, 8 x 8)
#ifndef F512_QK_SPLIT
#define F512_QK_SPLIT 4
#endif
// shared slots of the K / V ring
#ifndef F512_SLOTS
#define F512_SLOTS 3
#endif
// the QK loop's unroll factor
#ifndef F512_UNROLL
#define F512_UNROLL 4
#endif

namespace {

constexpr int kD = 512;
constexpr int kBlock = 256;                    // threads, 8 warps
constexpr int kRows = F512_ROWS;
constexpr int kForceCluster = F512_CLUSTER;
constexpr int kSplit = F512_QK_SPLIT;
constexpr int kSlots = F512_SLOTS;
constexpr int kUnroll = F512_UNROLL;
constexpr int kKeys = 128;                     // keys a tile
constexpr int kChunks = 8;                     // items a tile's K and a tile's V
constexpr int kKDims = kD / kChunks;           // 64 dims of a K item
constexpr int kVKeys = kKeys / kChunks;        // 16 keys of a V item
constexpr int kQStride = kD + 4;               // q rows: 4 rows on 4 bank groups
constexpr int kKStride = kKDims + 4;           // K rows: 8 keys on 8 bank groups
constexpr int kPStride = kKeys + 4;            // p rows: 4 rows on 4 bank groups
constexpr int kSlot = kKeys * kKStride;        // a K item; a V item is kVKeys * kD
constexpr int kWindowMax = 1024;               // bounded_anchor at d = 512
// a CTA's share of the window's tiles, in a cluster of C
__host__ __device__ constexpr int win_tiles(int c) { return (kWindowMax / kKeys + c - 1) / c; }
// QK: group g of kGroupThreads threads takes dims g * kGroupDims .. of every
// K item; thread (tr, tk) of a group owns the partial scores of rows tr +
// kTR i (i < kQkI) and keys tk + kTK j (j < kQkJ) over them
constexpr int kGroupThreads = kBlock / kSplit;
constexpr int kGroupWarps = kGroupThreads / 32;
constexpr int kGroupDims = kKDims / kSplit;
constexpr int kQkI = kSplit == 1 ? 4 : kSplit == 2 ? (kRows == 32 ? 8 : 4) : 8;
constexpr int kQkJ = kRows * kKeys / kGroupThreads / kQkI;
constexpr int kTR = kRows / kQkI;
constexpr int kTK = kKeys / kQkJ;
// after the exchange group g holds the summed scores of its share of each
// thread's rows: i = g kFI + ii (ii < kFI)
constexpr int kFI = kQkI / kSplit;
constexpr int kXStride = kKeys + 8;            // exchange rows: 4 rows x 8 keys on 32 banks
constexpr int kXSlot = kRows / kSplit * kXStride;
constexpr int kXFloats = kSplit * (kSplit - 1) * kXSlot;
constexpr int kPBuf = kXFloats > kRows * kPStride ? kXFloats : kRows * kPStride;
constexpr int kPvI = kRows / 4;                // rows of a PV thread
constexpr float kShiftMargin = 16.f;           // shift = anchor max + 16 (base 2)
constexpr float kSaturate = 100.f;             // p = exp2(min(s - shift, 100))
constexpr float kDenomFloor = 1.2e-38f;

static_assert(kRows == 16 || kRows == 32, "16 or 32 rows a block");
static_assert(kSplit == 1 || kSplit == 2 || kSplit == 4, "a split of 1, 2 or 4");
static_assert(kTR * kTK == kGroupThreads && 32 % kTR == 0 && kQkI % kSplit == 0, "QK tiles");
static_assert(kForceCluster == 0 || kForceCluster == 2 || kForceCluster == 4 ||
              kForceCluster == 8, "a cluster of 2, 4 or 8");
static_assert(kSlots >= 2, "a ring of two slots or more");
static_assert(kVKeys * kD <= kSlot, "a V item fits a slot");

// q, the ring, p (or the QK groups' exchange), red_s [kGroupWarps][kRows],
// this CTA's row max (or running max) and row sums, which the cluster reads
constexpr int kSmemFloats =
    kRows * kQStride + kSlots * kSlot + kPBuf + kGroupWarps * kRows + 2 * kRows;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }
__device__ __forceinline__ float comp(const float4& x, int t) {
  return t == 0 ? x.x : t == 1 ? x.y : t == 2 ? x.z : x.w;
}

template <bool EXACT, bool LSE, int kCluster>
__global__ void __launch_bounds__(kBlock, 1)
flash_fwd_f32_512_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         float* __restrict__ lse, Strides qs, Strides ks, Strides vs, Strides os,
                         int heads, int sq, int sk, float qscale, int anchor) {
  constexpr int kWinTiles = win_tiles(kCluster);
  constexpr int kRowsPer = kRows / kCluster;   // output rows a CTA combines
  static_assert(kRowsPer * (kCluster + 1) <= kGroupWarps * kRows, "the weights fit red_s");
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                        // [kRows][kQStride]: q * scale, then the accumulator
  float* slots = q_s + kRows * kQStride;    // kSlots x (K [kKeys][kKStride] or V [kVKeys][kD])
  float* p_s = slots + kSlots * kSlot;      // [kRows][kPStride]; the QK exchange before it
  float* red_s = p_s + kPBuf;               // [kGroupWarps][kRows]
  float* m_s = red_s + kGroupWarps * kRows; // [kRows]: window max (bounded), running max (exact)
  float* l_s = m_s + kRows;                 // [kRows]: row sums

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = tid / kGroupThreads, gt = tid % kGroupThreads;   // QK group, its thread
  const int tr = gt % kTR, tk = gt / kTR;
  const int wg = gt / 32;                                          // the warp within the group
  const int pv_row = lane >> 3;                                    // + 4i
  const int pv_col = warp * 64 + 4 * (lane & 7);                   // + 32jj, 4 columns each
  // the row of this thread's summed scores ii
  auto frow = [&](int ii) { return tr + kTR * (grp * kFI + ii); };

  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int q0 = (blockIdx.x / kCluster) * kRows;
  const float* qg = q + b * qs.batch + h * qs.head;
  const float* kg = k + b * ks.batch + h * ks.head;
  const float* vg = v + b * vs.batch + h * vs.head;

  // this CTA's key tiles: its share of the window's (bounded), then of the rest
  const int a_end = anchor < sk ? anchor : sk;
  const int nt = (sk + kKeys - 1) / kKeys;
  const int wt = EXACT ? 0 : (a_end + kKeys - 1) / kKeys;
  const int w0 = rank * wt / kCluster, nw = (rank + 1) * wt / kCluster - w0;
  const int r0 = wt + rank * (nt - wt) / kCluster;
  const int nr = wt + (rank + 1) * (nt - wt) / kCluster - r0;
  const int n_items = 2 * kChunks * (nw + nr);

  // item n of the stream: the window's K items (tile-major, 8 a tile), its V
  // items, then K and V of each later tile; into slot n % kSlots.  Every
  // call commits a group (empty past the end), so wait_group counts items.
  auto fetch = [&](int n) {
    if (n < n_items) {
      const int chunk = n & (kChunks - 1);
      int g = n / kChunks, tile, is_v;
      if (g < nw) {
        tile = w0 + g, is_v = 0;
      } else if (g < 2 * nw) {
        tile = w0 + g - nw, is_v = 1;
      } else {
        g -= 2 * nw;
        tile = r0 + (g >> 1), is_v = g & 1;
      }
      float* dst = slots + (n % kSlots) * kSlot;
      if (!is_v) {   // K: keys tile*128 .., dims chunk*64 ..
        const int k0 = tile * kKeys, d0 = chunk * kKDims;
#pragma unroll
        for (int u = 0; u < kKeys * kKDims / 4 / kBlock; ++u) {
          const int e = tid + kBlock * u, r = e >> 4, c4 = e & 15;
          const bool ok = k0 + r < sk;
          cp_async_16(smem_u32(dst + r * kKStride + 4 * c4),
                      kg + (ok ? (k0 + r) * ks.row + d0 + 4 * c4 : 0), ok);
        }
      } else {       // V: keys tile*128 + chunk*16 .., every column
        const int k0 = tile * kKeys + chunk * kVKeys;
#pragma unroll
        for (int u = 0; u < kVKeys * kD / 4 / kBlock; ++u) {
          const int e = tid + kBlock * u, r = e >> 7, c4 = e & 127;
          const bool ok = k0 + r < sk;
          cp_async_16(smem_u32(dst + r * kD + 4 * c4), vg + (ok ? (k0 + r) * vs.row + 4 * c4 : 0),
                      ok);
        }
      }
    }
    cp_async_commit();
  };
  // item n has landed and every thread is done with item n - 1, whose slot
  // item n + kSlots - 1 takes
  auto step = [&](int n) {
    cp_async_wait<kSlots - 2>();
    __syncthreads();
    fetch(n + kSlots - 1);
  };
  auto slot = [&](int n) { return slots + (n % kSlots) * kSlot; };

  // s[i][j] += q_s[tr + kTR i][this group's dims of the item] . K[tk + kTK j], in order of d
  auto qk = [&](const float* k_s, int chunk, float (&s)[kQkI][kQkJ]) {
    const float* qr = q_s + tr * kQStride + chunk * kKDims + grp * kGroupDims;
    const float* kr = k_s + tk * kKStride + grp * kGroupDims;
#pragma unroll kUnroll
    for (int c = 0; c < kGroupDims; c += 4) {
      float4 qv[kQkI];
#pragma unroll
      for (int i = 0; i < kQkI; ++i) qv[i] = ld4(qr + kTR * i * kQStride + c);
#pragma unroll
      for (int j = 0; j < kQkJ; ++j) {
        const float4 kv = ld4(kr + kTK * j * kKStride + c);
#pragma unroll
        for (int i = 0; i < kQkI; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }
  };
  // A tile's scores through its 8 K items, from item n on, into f: each
  // group's partial products over its dims, then (kSplit > 1) the groups'
  // partials of each row added in group order by the group that owns the
  // row, through shared memory (p_s's space: every PV read of it is done).
  auto score_tile = [&](int& n, float (&f)[kFI][kQkJ]) {
    float s[kQkI][kQkJ];
#pragma unroll
    for (int i = 0; i < kQkI; ++i)
#pragma unroll
      for (int j = 0; j < kQkJ; ++j) s[i][j] = 0.f;
    for (int c = 0; c < kChunks; ++c, ++n) {
      step(n);
      qk(slot(n), c, s);
    }
    if (kSplit == 1) {
#pragma unroll
      for (int ii = 0; ii < kFI; ++ii)
#pragma unroll
        for (int j = 0; j < kQkJ; ++j) f[ii][j] = s[ii][j];
      return;
    }
    // slot (h, o): group h's partials of group o's rows, o != h
    auto xslot = [&](int hh, int o) {
      return p_s + (hh * (kSplit - 1) + (o < hh ? o : o - 1)) * kXSlot;
    };
    float own[kFI][kQkJ];
#pragma unroll
    for (int o = 0; o < kSplit; ++o) {
#pragma unroll
      for (int ii = 0; ii < kFI; ++ii)
#pragma unroll
        for (int j = 0; j < kQkJ; ++j) {
          if (o == grp) {
            own[ii][j] = s[o * kFI + ii][j];
          } else {
            xslot(grp, o)[(ii * kTR + tr) * kXStride + tk + kTK * j] = s[o * kFI + ii][j];
          }
        }
    }
    __syncthreads();
#pragma unroll
    for (int ii = 0; ii < kFI; ++ii)
#pragma unroll
      for (int j = 0; j < kQkJ; ++j) {
        float a = 0.f;
#pragma unroll
        for (int hh = 0; hh < kSplit; ++hh)
          a += hh == grp ? own[ii][j] : xslot(hh, grp)[(ii * kTR + tr) * kXStride + tk + kTK * j];
        f[ii][j] = a;
      }
    __syncthreads();   // every read of the exchange is done: p_s may be written
  };

  // zeroed just before the first PV: the window's scores and the
  // accumulator are not live at once
  float acc[kPvI][8];
  auto zero_acc = [&]() {
#pragma unroll
    for (int i = 0; i < kPvI; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  };
  // acc[i][..] += p[pv_row + 4i][keys of the item] V[key][pv_col ..], in order of the keys
  auto pv = [&](const float* v_s, int chunk) {
    const float* pr = p_s + pv_row * kPStride + chunk * kVKeys;
    const float* vc = v_s + pv_col;
#pragma unroll
    for (int kk = 0; kk < kVKeys; kk += 4) {
      float4 p4[kPvI];
#pragma unroll
      for (int i = 0; i < kPvI; ++i) p4[i] = ld4(pr + 4 * i * kPStride + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float4 v0 = ld4(vc + (kk + t) * kD), v1 = ld4(vc + (kk + t) * kD + 32);
#pragma unroll
        for (int i = 0; i < kPvI; ++i) {
          const float p = comp(p4[i], t);
          acc[i][0] = fmaf(p, v0.x, acc[i][0]);
          acc[i][1] = fmaf(p, v0.y, acc[i][1]);
          acc[i][2] = fmaf(p, v0.z, acc[i][2]);
          acc[i][3] = fmaf(p, v0.w, acc[i][3]);
          acc[i][4] = fmaf(p, v1.x, acc[i][4]);
          acc[i][5] = fmaf(p, v1.y, acc[i][5]);
          acc[i][6] = fmaf(p, v1.z, acc[i][6]);
          acc[i][7] = fmaf(p, v1.w, acc[i][7]);
        }
      }
    }
  };
  // a tile's PV through 8 V items, from item n on (the first step's barrier
  // publishes p_s)
  auto pv_tile = [&](int& n) {
    for (int c = 0; c < kChunks; ++c, ++n) {
      step(n);
      pv(slot(n), c);
    }
  };
  // Per row of this thread's summed scores: x combined (max or sum) over the
  // row's lanes of this warp by shuffles (lanes kTR apart), then written to
  // red_s for the group's other warps; lane < kTR writes.
  auto to_red = [&](float (&x)[kFI], bool is_max) {
#pragma unroll
    for (int ii = 0; ii < kFI; ++ii) {
#pragma unroll
      for (int off = kTR; off < 32; off <<= 1) {
        const float y = __shfl_xor_sync(0xffffffffu, x[ii], off);
        x[ii] = is_max ? fmaxf(x[ii], y) : x[ii] + y;
      }
      if (lane < kTR) red_s[wg * kRows + frow(ii)] = x[ii];
    }
  };
  // red_s's kGroupWarps values of row r, combined in warp order
  auto groups_max = [&](int r) {
    float m = red_s[r];
#pragma unroll
    for (int g = 1; g < kGroupWarps; ++g) m = fmaxf(m, red_s[g * kRows + r]);
    return m;
  };

  // the stream's first items, then q * scale in float32 (rows past Sq are 0)
  for (int n = 0; n < kSlots - 1; ++n) fetch(n);
  for (int e = tid; e < kRows * kD / 4; e += kBlock) {
    const int r = e >> 7, c4 = e & 127;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < sq) {
      x = ld4(qg + (q0 + r) * qs.row + 4 * c4);
      x.x *= qscale, x.y *= qscale, x.z *= qscale, x.w *= qscale;
    }
    st4(q_s + r * kQStride + 4 * c4, x);
  }

  float lsum[kFI];
  float mrow[kFI];  // bounded: the shift; exact: the running max (rows frow(ii))
  float mpv[kPvI];  // exact: the running max of the PV rows
#pragma unroll
  for (int ii = 0; ii < kFI; ++ii) lsum[ii] = 0.f, mrow[ii] = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < kPvI; ++i) mpv[i] = -CUDART_INF_F;
  // p of a tile's scores into p_s and the row sums; keys at or past Sk give 0
  auto emit_p = [&](const float (&f)[kFI][kQkJ], int k0) {
#pragma unroll
    for (int ii = 0; ii < kFI; ++ii)
#pragma unroll
      for (int j = 0; j < kQkJ; ++j) {
        float p = EXACT ? exp2f(f[ii][j] - mrow[ii])
                        : exp2f(fminf(f[ii][j] - mrow[ii], kSaturate));
        if (k0 + tk + kTK * j >= sk) p = 0.f;
        p_s[frow(ii) * kPStride + tk + kTK * j] = p;
        lsum[ii] += p;
      }
  };

  int n = 0;
  if (EXACT) zero_acc();
  if (!EXACT) {
    // The window: this CTA's share of its tiles scored once, kept in
    // registers, their max over keys below a_end; the row max crosses the
    // cluster (every CTA reads every CTA's m_s, in rank order).
    float win[kWinTiles][kFI][kQkJ];
    float mx[kFI];
#pragma unroll
    for (int ii = 0; ii < kFI; ++ii) mx[ii] = -CUDART_INF_F;
#pragma unroll
    for (int t = 0; t < kWinTiles; ++t) {
      if (t < nw) {
        score_tile(n, win[t]);
#pragma unroll
        for (int ii = 0; ii < kFI; ++ii)
#pragma unroll
          for (int j = 0; j < kQkJ; ++j)
            if ((w0 + t) * kKeys + tk + kTK * j < a_end) mx[ii] = fmaxf(mx[ii], win[t][ii][j]);
      }
    }
    to_red(mx, true);
    __syncthreads();
    if (tid < kRows) m_s[tid] = groups_max(tid);
    cluster.sync();   // every CTA's window max is written
#pragma unroll
    for (int ii = 0; ii < kFI; ++ii) {
      float m = -CUDART_INF_F;
      for (int c = 0; c < kCluster; ++c) m = fmaxf(m, cluster.map_shared_rank(m_s, c)[frow(ii)]);
      mrow[ii] = m + kShiftMargin;   // key 0 lies in some CTA's window: finite
    }
    zero_acc();
    // the window's p (every key below Sk, a_end .. included) and its PV
#pragma unroll
    for (int t = 0; t < kWinTiles; ++t) {
      if (t < nw) {
        __syncthreads();   // the last PV is done with p_s
        emit_p(win[t], (w0 + t) * kKeys);
        pv_tile(n);
      }
    }
  }
  // the keys after the window (exact: every key)
  for (int t = r0; t < r0 + nr; ++t) {
    float f[kFI][kQkJ];
    score_tile(n, f);   // its barriers: the last PV is done with p_s, red_s read
    if (EXACT) {
      // the tile's max of each row: its lanes, then the group's warps; the
      // QK and the PV threads of a row take the same max in the same order
      float tm[kFI];
#pragma unroll
      for (int ii = 0; ii < kFI; ++ii) {
        tm[ii] = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < kQkJ; ++j) {
          if (t * kKeys + tk + kTK * j >= sk) f[ii][j] = -CUDART_INF_F;
          tm[ii] = fmaxf(tm[ii], f[ii][j]);
        }
      }
      to_red(tm, true);
      __syncthreads();
#pragma unroll
      for (int ii = 0; ii < kFI; ++ii) {
        // a tile holds a key below Sk: m_new is finite
        const float m_new = fmaxf(mrow[ii], groups_max(frow(ii)));
        lsum[ii] *= exp2f(mrow[ii] - m_new);
        mrow[ii] = m_new;
      }
#pragma unroll
      for (int i = 0; i < kPvI; ++i) {
        const float m_new = fmaxf(mpv[i], groups_max(pv_row + 4 * i));
        const float alpha = exp2f(mpv[i] - m_new);
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
        mpv[i] = m_new;
      }
    }
    emit_p(f, t * kKeys);
    pv_tile(n);
  }

  // This CTA's row sums (the row's lanes, then the group's warps, in that
  // order), its running max (exact) and its accumulator into shared memory,
  // for the cluster.
  __syncthreads();   // every read of q_s, p_s and red_s is done
  to_red(lsum, false);
#pragma unroll
  for (int ii = 0; ii < kFI; ++ii)
    if (EXACT && lane < kTR && wg == 0) m_s[frow(ii)] = mrow[ii];
#pragma unroll
  for (int i = 0; i < kPvI; ++i) {
    float* dst = q_s + (pv_row + 4 * i) * kQStride + pv_col;
    st4(dst, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    st4(dst + 32, make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
  }
  __syncthreads();
  if (tid < kRows) {
    float l = red_s[tid];
#pragma unroll
    for (int g = 1; g < kGroupWarps; ++g) l += red_s[g * kRows + tid];
    l_s[tid] = l;
  }
  cluster.sync();   // every CTA's accumulator, sums and maxima are written

  // CTA `rank` combines rows rank * kRowsPer .. in CTA order: the weights
  // (exact: exp2(m_c - max m); bounded: 1) and the floored sum first
  float* wgt_s = red_s;   // [kRowsPer][kCluster + 1]: the weights, then the sum
  if (tid < kRowsPer) {
    const int r = rank * kRowsPer + tid;
    float m = -CUDART_INF_F;
    for (int c = 0; c < kCluster; ++c) m = fmaxf(m, cluster.map_shared_rank(m_s, c)[r]);
    float l = 0.f;
    for (int c = 0; c < kCluster; ++c) {
      const float a = EXACT ? exp2f(cluster.map_shared_rank(m_s, c)[r] - m) : 1.f;
      wgt_s[tid * (kCluster + 1) + c] = a;
      l = fmaf(a, cluster.map_shared_rank(l_s, c)[r], l);
    }
    if (!EXACT) l = fmaxf(l, kDenomFloor);
    wgt_s[tid * (kCluster + 1) + kCluster] = l;
    // the shift as the QK threads formed it: the window max + 16
    if (LSE && q0 + r < sq) lse[size_t(bh) * sq + q0 + r] = (m + kShiftMargin) + log2f(l);
  }
  __syncthreads();
  float* og = out + b * os.batch + h * os.head;
  for (int e = tid; e < kRowsPer * kD / 4; e += kBlock) {
    const int rl = e >> 7, c4 = e & 127, r = rank * kRowsPer + rl;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < kCluster; ++c) {
      const float a = wgt_s[rl * (kCluster + 1) + c];
      const float4 x = ld4(cluster.map_shared_rank(q_s, c) + r * kQStride + 4 * c4);
      o.x = fmaf(a, x.x, o.x), o.y = fmaf(a, x.y, o.y);
      o.z = fmaf(a, x.z, o.z), o.w = fmaf(a, x.w, o.w);
    }
    const float l = wgt_s[rl * (kCluster + 1) + kCluster];
    if (q0 + r < sq)
      st4(og + (q0 + r) * os.row + 4 * c4, make_float4(o.x / l, o.y / l, o.z / l, o.w / l));
  }
  cluster.sync();   // no CTA leaves while another reads its shared memory
}

// The launch of a grid of `row_blocks` x `bh` clusters of `cluster` CTAs.
cudaLaunchConfig_t cluster_config(int cluster, int row_blocks, int bh, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * row_blocks, bh);
  cfg.blockDim = dim3(kBlock);
  cfg.dynamicSmemBytes = sizeof(float) * kSmemFloats;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool EXACT, bool LSE, int C>
cudaError_t launch_c(const void* q, const void* k, const void* v, void* out, float* lse,
                     const Layout& lay, int sq, int sk, int anchor, cudaStream_t stream) {
  auto kernel = flash_fwd_f32_512_kernel<EXACT, LSE, C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(sizeof(float)) * kSmemFloats);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(C, (sq + kRows - 1) / kRows, lay.bh, stream,
                                                &attr);
  // JAX's constant, (1 / sqrt(d)) * log2(e) in double, then rounded
  const float qscale = float(1.0 / sqrt(double(kD)) * 1.4426950408889634);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(q),
                           static_cast<const float*>(k), static_cast<const float*>(v),
                           static_cast<float*>(out), lse, lay.q, lay.k, lay.v, lay.out, lay.heads,
                           sq, sk, qscale, anchor);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The cluster size: two CTAs a row block where that grid fills every SM of
// the card (more keys a CTA, fewer combines: [1, 1, 4096, 512]), eight where
// it would leave SMs idle ([1, 1, 1024, 512]: 32 row blocks); forced by
// F512_CLUSTER (the tile probe's variants).
int cluster_size(int row_blocks, int bh) {
  if (kForceCluster != 0) return kForceCluster;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  return 2LL * row_blocks * bh >= sms ? 2 : 8;
}

template <bool EXACT, bool LSE>
cudaError_t launch_512(const void* q, const void* k, const void* v, void* out, float* lse,
                       const Layout& lay, int sq, int sk, int anchor, cudaStream_t stream) {
  if (cluster_size((sq + kRows - 1) / kRows, lay.bh) == 2)
    return launch_c<EXACT, LSE, 2>(q, k, v, out, lse, lay, sq, sk, anchor, stream);
  // clusters of 4 only where F512_CLUSTER forces them
  constexpr int kOther = kForceCluster == 4 ? 4 : 8;
  return launch_c<EXACT, LSE, kOther>(q, k, v, out, lse, lay, sq, sk, anchor, stream);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool strides_of_4(const Strides& s) {
  return s.batch % 4 == 0 && s.head % 4 == 0 && s.row % 4 == 0;
}

// mode 0 bounded, 1 bounded with lse2, 2 exact (anchor unread)
int forward_512(int mode, const void* q, const void* k, const void* v, void* out, float* lse,
                const Layout& lay, int sq, int sk, int d, int anchor, int dtype, void* stream) {
  if (dtype != 0 || d != kD) return -1;
  if (lay.bh < 1 || sq < 1 || sk < 1 || lay.bh > 65535) return -1;
  if (mode != 2 && (anchor < 1 || (anchor < sk ? anchor : sk) > kWindowMax)) return -1;
  if (!rows_fit(lay, sq, sk)) return -1;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out))) return -1;
  if (!(strides_of_4(lay.q) && strides_of_4(lay.k) && strides_of_4(lay.v) &&
        strides_of_4(lay.out)))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) return int(launch_512<false, false>(q, k, v, out, lse, lay, sq, sk, anchor, s));
  if (mode == 1) return int(launch_512<false, true>(q, k, v, out, lse, lay, sq, sk, anchor, s));
  return int(launch_512<true, false>(q, k, v, out, lse, lay, sq, sk, 1, s));
}

}  // namespace

// Plain C entry points for ctypes, the arguments of flash_attention.cu's
// entries of the same names without "_f32_512" (dtype must be 0, float32;
// d must be 512).  Each returns 0 on success, a cudaError_t code from the
// launch, or -1 for arguments the kernel does not take.

// Row 1, head-split; anchor: the anchor window in keys.
extern "C" int hedit_flash_attention_fwd_f32_512(const void* q, const void* k, const void* v,
                                                 void* out, int bh, int sq, int sk, int d,
                                                 int anchor, int dtype, void* stream) {
  return forward_512(0, q, k, v, out, nullptr, head_split(bh, sq, sk, d), sq, sk, d, anchor,
                     dtype, stream);
}

// Row 3: the same forward, also writing lse2 [BH, Sq] float32.
extern "C" int hedit_flash_attention_fwd_lse_f32_512(const void* q, const void* k,
                                                     const void* v, void* out, void* lse, int bh,
                                                     int sq, int sk, int d, int anchor,
                                                     int dtype, void* stream) {
  if (lse == nullptr) return -1;
  return forward_512(1, q, k, v, out, static_cast<float*>(lse), head_split(bh, sq, sk, d), sq,
                     sk, d, anchor, dtype, stream);
}

// Row 1 on packed heads.
extern "C" int hedit_flash_attention_fwd_packed_bounded_f32_512(
    const void* q, const void* k, const void* v, void* out, int b, int h, int sq, int sk, int d,
    int anchor, long long q_bs, long long k_bs, long long v_bs, int dtype, void* stream) {
  Layout lay;
  if (!packed_layout(b, h, sq, sk, d, q_bs, k_bs, v_bs, &lay)) return -1;
  return forward_512(0, q, k, v, out, nullptr, lay, sq, sk, d, anchor, dtype, stream);
}

// Row 6: the exact forward, head-split.
extern "C" int hedit_flash_attention_fwd_exact_f32_512(const void* q, const void* k,
                                                       const void* v, void* out, int bh, int sq,
                                                       int sk, int d, int dtype, void* stream) {
  return forward_512(2, q, k, v, out, nullptr, head_split(bh, sq, sk, d), sq, sk, d, 0, dtype,
                     stream);
}

// How many clusters of `cluster` CTAs (1 to 8) of the bounded kernel's size
// (its shared memory, 256 threads) the card runs at once, into *out (int):
// cudaOccupancyMaxActiveClusters, printed by the tile probe.
extern "C" int hedit_flash_attention_f32_512_active_clusters(int cluster, void* out) {
  if (cluster < 1 || cluster > 8) return -1;
  auto kernel = flash_fwd_f32_512_kernel<false, false, 8>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(sizeof(float)) * kSmemFloats);
  if (err != cudaSuccess) return int(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, 1024, 1, nullptr, &attr);
  return int(cudaOccupancyMaxActiveClusters(static_cast<int*>(out), kernel, &cfg));
}

// Row 7: the exact forward on packed heads.
extern "C" int hedit_flash_attention_fwd_packed_exact_f32_512(
    const void* q, const void* k, const void* v, void* out, int b, int h, int sq, int sk, int d,
    long long q_bs, long long k_bs, long long v_bs, int dtype, void* stream) {
  Layout lay;
  if (!packed_layout(b, h, sq, sk, d, q_bs, k_bs, v_bs, &lay)) return -1;
  return forward_512(2, q, k, v, out, nullptr, lay, sq, sk, d, 0, dtype, stream);
}
