// The flash-attention backward in float32 at the VAE's head dim d = 512 on
// Hopper's CUDA cores (sm_90a): dq, dk and dv of out = softmax(q k^T /
// sqrt(d)) v from the forward's base-2 log-sum-exp, in five products and two
// launches, with no atomics.  Every product is a float32 FMA: no TF32 in any
// form.
//
// Replaces, for float32 inputs at d = 512, the two TPU kernels of
// hedit_tpu/ops/flash_attention.py
//   row 4: _flash_bwd_dq_kernel (:553), one program per query block;
//   row 5: _flash_bwd_dkv_kernel (:593), one program per key block;
// wrapper _flash_bwd_pallas (:648), the backward of flash_attention_diff:
// the float32 gradient through a VAE decode whose mid-block attention fits
// JAX's K/V budget and reaches _BWD_MIN_SEQ, that is 2048 tokens exactly (a
// 32 x 64 latent, a 256 x 512 px image; the style reward's route in the
// CLIs' default precision).  Entry points hedit_flash_attention_bwd_dkv_f32_512
// and hedit_flash_attention_bwd_dq_f32_512, wrapper flash_bwd_f32_512_cuda
// (ops/flash_attention.py, chosen by bwd_entry).  The CUDA-core template
// (flash_attention_bwd.cu) served these before; its float32 d = 512
// instances stay, launched by their entry points only, for side-by-side
// timings.
//
// The function, as flash_attention_backward_reference computes it in
// float32: with lse2 the forward's base-2 log-sum-exp of each query and
// delta = rowsum(dO * out) (computed outside, as the JAX package does),
//   p = exp2(q k^T * scale * log2(e) - lse2),  dp = dO v^T,
//   ds = p * (dp - delta),
//   dq = ds k * scale,  dk = ds^T q * scale,  dv = p^T dO.
// Keys at or past Sk give p = 0 in dq, queries at or past Sq p = 0 in dk and
// dv.  Like the TPU's, this backward ignores the forward's clamp.
//
// Why two kernels and a workspace.  The TPU's two programs each rebuild the
// score grid: 7 products of Sq x Sk x D per (batch, head) where the function
// needs 5.  The fused float32 kernel at d = 40 / 80 (flash_attention_bwd_f32.cu)
// forms s and dp once and adds each key block's dq partial into dq with
// atomics; at d = 512 a key block's partial is Sq x 512 floats, and at the
// 16 keys a block that the registers allow (below) that is 4 bytes of atomic
// traffic for every 32 FMAs, more than the L2's atomics sustain at the FP32
// rate.  Here:
//   kernel 1 (dk / dv) owns kKeys keys and streams query tiles; for each it
//     forms s^T and dp^T once, turns them into p^T and ds^T, adds p^T dO
//     into dV and ds^T Q into dK (registers), and stores ds^T once, float32
//     and unrounded, into a workspace ds [BH][Sk][ldq] (ldq = Sq rounded up
//     to 4) that the wrapper allocates;
//   kernel 2 (dq) is the product dq = ds k * scale over the workspace: a
//     register-tiled CUDA-core GEMM (8 x 8 outputs a thread, tiles of ds and
//     K in two cp.async stages: three ran ~6% slower, their slot index a
//     division by 3), each output summed over the keys in ascending order.
// 10 B H Sq Sk D FLOP against the TPU's 14; the workspace (16 MiB a (batch,
// head) at 2048 tokens, 64 MiB at 4096) is written once and read once.
// Every output element has one writer and sums in a fixed order, so two
// launches give dq, dk and dv bit for bit.
//
// What bounds it on the H100.  10 B H Sq Sk D FLOP of float32 FMAs against 4
// bytes an element of q, k, v, dO, dq, dk, dv: at [1, 1, 2048, 512] 21.5
// GFLOP against 25 MB, so the bound is the FP32 rate (67 TFLOP/s at 700 W:
// 0.3205 ms; 1.2821 ms at 4096).  The template reached 8.5% of its seven
// products' bound at 4096 (PERF.md): 16-row blocks of 128 threads, one
// block an SM for its 197 KB of shared memory, 4 x 1 score tiles (1.25
// shared words a FMA), synchronous loads, seven products.  This design:
//
// 1. Registers decide the dk / dv tile.  Two kKeys x 512 float32
//    accumulators at 16 keys are 16,384 floats: 64 registers a thread at
//    256 threads (the float32 forward at d = 512 measured 242-255 registers a
//    thread with one 32 x 512 accumulator, so 32 keys a CTA would spill).
//    Phase O: warps 0-3 own dV, warps 4-7 dK; a thread owns all 16 keys x 4
//    columns (4 u .. 4 u + 3, u = tid % 128).  It reads p^T or ds^T [16][BQ]
//    as float4 along the queries (the same address across the warp: one
//    broadcast wavefront) and dO or Q [BQ][512] as float4 along its columns
//    (four wavefronts for the warp), 32 wavefronts for 256 FMAs a thread.
// 2. The score products split the contraction.  Phase S: warp w takes dims
//    64 w .. 64 w + 63; lane l computes one product (l / 16: s^T from K and Q,
//    or dp^T from V and dO) over a 4 x 4 tile of keys kg + 4 i and queries
//    qg + 4 j (kg = l / 4 % 4, qg = l % 4): 8 float4 loads, 64 FMAs, each
//    load one wavefront for the warp (K and V, Q and dO sit 16 banks apart,
//    the row stride 516 puts 4 rows on 4 bank groups).  The 8 warps'
//    partials meet in shared memory and thread t adds those of one (key,
//    query) pair in warp order 0 .. 7, for s and dp both, and forms p and
//    ds.
// 3. Copies in flight during the arithmetic.  K and V of the CTA's keys stay
//    resident (64 KB); the query tiles (Q, dO [BQ][512], lse2, delta) stream
//    by cp.async through two slots, tile t + 1 landing while tile t
//    computes.  212 KB of shared memory: one CTA an SM.
// 4. The grid.  16 keys a CTA: [1, 1, 2048, 512] gives 128 CTAs for 132
//    SMs, [1, 1, 4096, 512] 256.  Each Q / dO element read from L2 feeds 16
//    keys: 16 MiB of L2 reads a CTA at 4096 tokens.  A cluster of 2 CTAs
//    sharing 32 keys (each half the columns) would halve them, at the cost
//    of a cluster barrier and an exchange of partial scores every tile; the
//    tile probe's ablation that copies no query tile after the first two
//    ran only 14% faster at [1, 1, 4096, 512] (PERF.md), which bounds that
//    gain, so a CTA keeps a key block of its own.
//
// Contract: float32 (dtype 0) only; D = 512; q, dO [BH, Sq, D], k, v [BH,
// Sk, D], lse2 and delta [BH, Sq], ds [BH, Sk, ldq], dq, dk, dv like q, k,
// v; all contiguous; any Sq, Sk >= 1; every pointer of q, k, v, dO, ds, dq,
// dk and dv 16-byte aligned.  Anything else returns -1.  (-D knobs for the
// tile probe: BWD512_UNROLL, BWD512_DQ_BM, BWD512_DQ_BK, BWD512_DQ_STAGES,
// and the timing ablations BWD512_ABLATE; the notes describe the defaults.)

#include <cmath>
#include <cstdint>

#include "flash_mma.cuh"

// the score loop's unroll factor (its 16 steps of 4 dims)
#ifndef BWD512_UNROLL
#define BWD512_UNROLL 4
#endif
// the dq product: query rows a CTA (32 or 64), keys a stage (8 or 16), stages
#ifndef BWD512_DQ_BM
#define BWD512_DQ_BM 64
#endif
#ifndef BWD512_DQ_BK
#define BWD512_DQ_BK 16
#endif
#ifndef BWD512_DQ_STAGES
#define BWD512_DQ_STAGES 2
#endif
// timing ablations of the tile probe only, whose outputs are wrong: 1 copies
// no query tile after the first two, 2 leaves out phase S's products, 3
// phase O's
#ifndef BWD512_ABLATE
#define BWD512_ABLATE 0
#endif

namespace {

constexpr int kD = 512;
constexpr int kKvThreads = 256;               // the dk / dv kernel: 8 warps
constexpr int kKeys = 16;                     // keys a CTA
constexpr int kBQ = 16;                       // queries a streamed tile
constexpr int kRS = kD + 4;                   // K, V, Q, dO rows: 4 rows on 4 bank groups
constexpr int kSplit = 8;                     // phase S: warps that split the contraction
constexpr int kSDims = kD / kSplit;           // 64 dims a warp
constexpr int kUnroll = BWD512_UNROLL;
constexpr int kAblate = BWD512_ABLATE;
constexpr int kPairs = kKeys * kBQ;           // (key, query) pairs of a tile
// shared memory of the dk / dv kernel, in floats: K, V (V 16 banks after K),
// two slots of Q and dO (dO 16 banks after Q), lse2 and delta of each slot,
// p^T and ds^T, the warps' partial scores
constexpr int kTile = kKeys * kRS;            // one [16][516] array
constexpr int kVOff = kTile + 16;
constexpr int kSlot0 = ((kVOff + kTile + 31) / 32) * 32;
constexpr int kDoOff = kTile + 16;            // dO within a slot
constexpr int kSlotSize = ((kDoOff + kTile + 31) / 32) * 32;
constexpr int kStats = kSlot0 + 2 * kSlotSize;    // [2 slots][lse2, delta][kBQ]
constexpr int kPT = kStats + 2 * 2 * kBQ;         // p^T [kKeys][kBQ]
constexpr int kDsT = kPT + kPairs;                // ds^T [kKeys][kBQ]
constexpr int kRed = kDsT + kPairs;               // [kSplit][16 m][32 lanes]
constexpr int kKvSmemFloats = kRed + kSplit * 16 * 32;

static_assert(kKeys == 16 && kBQ == 16, "phase S maps 2 x 4 x 4 lanes over 16 keys x 16 queries");
static_assert(kPairs == kKvThreads, "one (key, query) pair a thread when the partials meet");
static_assert(kSlotSize % 32 == 0 && kSlot0 % 32 == 0 && kVOff % 32 == 16 &&
              kDoOff % 32 == 16, "K / V and Q / dO 16 banks apart");

// the dq product: BM query rows x kBN columns a CTA, kBK keys a stage
constexpr int kDqThreads = 128;
constexpr int kBM = BWD512_DQ_BM;
constexpr int kBK = BWD512_DQ_BK;
constexpr int kStages = BWD512_DQ_STAGES;
constexpr int kTM = kBM / 8;                  // thread rows (8 rows each)
constexpr int kTN = kDqThreads / kTM;         // thread columns (8 columns each)
constexpr int kBN = 8 * kTN;                  // 128 columns at kBM = 64, 256 at 32
static_assert(kBM == 32 || kBM == 64, "32 or 64 query rows a CTA");
static_assert(kBK == 8 || kBK == 16, "8 or 16 keys a stage");
static_assert(kStages >= 2 && kStages <= 4, "2 to 4 stages");
constexpr int kDqSmemFloats = kStages * kBK * (kBM + kBN);

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }

// Kernel 1: dk, dv and the workspace ds.  The grid: (ceil(Sk / kKeys), BH).
__global__ void __launch_bounds__(kKvThreads, 1)
flash_bwd_dkv_f32_512_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             float* __restrict__ ds, float* __restrict__ dk,
                             float* __restrict__ dv, int sq, int sk, int ldq, float c2,
                             float scale) {
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = smem + kVOff;
  float* pt_s = smem + kPT;
  float* dst_s = smem + kDsT;
  float* red_s = smem + kRed;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, k0 = blockIdx.x * kKeys;
  const float* qg = q + size_t(bh) * sq * kD;
  const float* dog = dout + size_t(bh) * sq * kD;
  const float* kg_ = k + size_t(bh) * sk * kD;
  const float* vg = v + size_t(bh) * sk * kD;
  const float* lg = lse + size_t(bh) * sq;
  const float* dg = delta + size_t(bh) * sq;
  const int nt = (sq + kBQ - 1) / kBQ;

  auto q_slot = [&](int t) { return smem + kSlot0 + (t & 1) * kSlotSize; };
  auto stats = [&](int t) { return smem + kStats + (t & 1) * 2 * kBQ; };

  // tile t's Q, dO, lse2 and delta into slot t & 1 (rows past Sq zero-filled)
  auto fetch = [&](int t) {
    const int q0 = t * kBQ;
    float* qs = q_slot(t);
#pragma unroll
    for (int u = 0; u < kBQ * kD / 4 / kKvThreads; ++u) {
      const int e = tid + kKvThreads * u, r = e >> 7, c4 = e & 127;
      const bool ok = q0 + r < sq;
      const size_t off = ok ? size_t(q0 + r) * kD + 4 * c4 : 0;
      cp_async_16(smem_u32(qs + r * kRS + 4 * c4), qg + off, ok);
      cp_async_16(smem_u32(qs + kDoOff + r * kRS + 4 * c4), dog + off, ok);
    }
    if (tid < 2 * kBQ) {
      const int r = tid & (kBQ - 1);
      const bool ok = q0 + r < sq;
      cp_async_4(smem_u32(stats(t) + tid), (tid < kBQ ? lg : dg) + (ok ? q0 + r : 0), ok);
    }
  };

  // K and V of this CTA's keys (rows past Sk zero-filled), with tile 0
#pragma unroll
  for (int u = 0; u < kKeys * kD / 4 / kKvThreads; ++u) {
    const int e = tid + kKvThreads * u, r = e >> 7, c4 = e & 127;
    const bool ok = k0 + r < sk;
    const size_t off = ok ? size_t(k0 + r) * kD + 4 * c4 : 0;
    cp_async_16(smem_u32(k_s + r * kRS + 4 * c4), kg_ + off, ok);
    cp_async_16(smem_u32(v_s + r * kRS + 4 * c4), vg + off, ok);
  }
  fetch(0);
  cp_async_commit();

  // phase S: lane's product, key group and query group
  const int prod = lane >> 4, kgrp = (lane >> 2) & 3, qgrp = lane & 3;
  const float* a_s = (prod ? v_s : k_s) + kgrp * kRS + warp * kSDims;
  // the pair this thread forms after the partials meet: m = 2 warp + h
  const int h = lane >> 4, ls = lane & 15, pm = 2 * warp + h;
  const int pkey = (ls >> 2) + 4 * (pm >> 2), pquery = (ls & 3) + 4 * (pm & 3);
  // phase O: dV (warps 0-3) or dK (warps 4-7), columns 4 u ..
  const bool is_dk = tid >= 128;
  const int ocol = 4 * (tid & 127);
  const float* o_a = is_dk ? dst_s : pt_s;

  float acc[kKeys][4];
#pragma unroll
  for (int i = 0; i < kKeys; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<0>();
    __syncthreads();   // tile t landed; every thread is done with tile t - 1's slot
    if (t + 1 < nt && (kAblate != 1 || t < 1)) fetch(t + 1);
    cp_async_commit();
    const float* qs = q_slot(t);
    const int q0 = t * kBQ;

    // phase S: this warp's dims of s^T (K Q^T) or dp^T (V dO^T), a 4 x 4 tile
    {
      const float* b_s = qs + (prod ? kDoOff : 0) + qgrp * kRS + warp * kSDims;
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll kUnroll
      for (int c = 0; c < (kAblate == 2 ? 0 : kSDims); c += 4) {
        float4 av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = ld4(a_s + 4 * i * kRS + c);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = ld4(b_s + 4 * j * kRS + c);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
            s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
            s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
            s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
          }
      }
      // partial m = 4 i + j of lane l at red[warp][m][l ^ 16 (m & 1)]: the
      // writes of one m and the reads of one warp below hit 32 banks
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = 4 * i + j;
          red_s[(warp * 16 + m) * 32 + (lane ^ ((m & 1) << 4))] = s[i][j];
        }
    }
    __syncthreads();

    // the partials of pair (pkey, pquery) added in warp order, then p and ds
    {
      float sv = 0.f, dpv = 0.f;
#pragma unroll
      for (int w = 0; w < kSplit; ++w) {
        const float* r = red_s + (w * 16 + pm) * 32;
        sv += r[ls ^ (h << 4)];
        dpv += r[(16 + ls) ^ (h << 4)];
      }
      const float* st = stats(t);
      const bool ok = k0 + pkey < sk && q0 + pquery < sq;
      const float p = ok ? exp2f(sv * c2 - st[pquery]) : 0.f;
      pt_s[pkey * kBQ + pquery] = p;
      dst_s[pkey * kBQ + pquery] = p * (dpv - st[kBQ + pquery]);
    }
    __syncthreads();

    // ds^T of the tile into the workspace, 16 keys x 16 queries, float4 rows
    if (tid < kPairs / 4) {
      const int r = tid >> 2, c4 = tid & 3;
      if (k0 + r < sk && q0 + 4 * c4 < ldq)
        st4(ds + (size_t(bh) * sk + k0 + r) * ldq + q0 + 4 * c4, ld4(dst_s + r * kBQ + 4 * c4));
    }
    // phase O: acc[key][..] += p^T or ds^T [key][query] x dO or Q [query][cols], queries in order
    {
      const float* b_o = qs + (is_dk ? 0 : kDoOff) + ocol;
#pragma unroll
      for (int qq = 0; qq < (kAblate == 3 ? 0 : kBQ); qq += 4) {
        float4 bq[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) bq[u] = ld4(b_o + (qq + u) * kRS);
#pragma unroll
        for (int i = 0; i < kKeys; ++i) {
          const float4 a4 = ld4(o_a + i * kBQ + qq);
          acc[i][0] = fmaf(a4.x, bq[0].x, acc[i][0]);
          acc[i][1] = fmaf(a4.x, bq[0].y, acc[i][1]);
          acc[i][2] = fmaf(a4.x, bq[0].z, acc[i][2]);
          acc[i][3] = fmaf(a4.x, bq[0].w, acc[i][3]);
          acc[i][0] = fmaf(a4.y, bq[1].x, acc[i][0]);
          acc[i][1] = fmaf(a4.y, bq[1].y, acc[i][1]);
          acc[i][2] = fmaf(a4.y, bq[1].z, acc[i][2]);
          acc[i][3] = fmaf(a4.y, bq[1].w, acc[i][3]);
          acc[i][0] = fmaf(a4.z, bq[2].x, acc[i][0]);
          acc[i][1] = fmaf(a4.z, bq[2].y, acc[i][1]);
          acc[i][2] = fmaf(a4.z, bq[2].z, acc[i][2]);
          acc[i][3] = fmaf(a4.z, bq[2].w, acc[i][3]);
          acc[i][0] = fmaf(a4.w, bq[3].x, acc[i][0]);
          acc[i][1] = fmaf(a4.w, bq[3].y, acc[i][1]);
          acc[i][2] = fmaf(a4.w, bq[3].z, acc[i][2]);
          acc[i][3] = fmaf(a4.w, bq[3].w, acc[i][3]);
        }
      }
    }
  }

  float* og = (is_dk ? dk : dv) + size_t(bh) * sk * kD;
  const float f = is_dk ? scale : 1.f;
#pragma unroll
  for (int i = 0; i < kKeys; ++i)
    if (k0 + i < sk)
      st4(og + size_t(k0 + i) * kD + ocol,
          make_float4(acc[i][0] * f, acc[i][1] * f, acc[i][2] * f, acc[i][3] * f));
}

// Kernel 2: dq = ds k * scale over the workspace ds [BH][Sk][ldq] (keys the
// contraction, queries the rows).  The grid: (ceil(Sq / kBM), kD / kBN, BH).
// Thread (tr, tc) = (tid / kTN, tid % kTN) owns rows 4 tr + i and kBM / 2 +
// 4 tr + i (i < 4) and columns 4 tc + j and kBN / 2 + 4 tc + j (j < 4) of the
// CTA's tile, each summed over the keys in ascending order.
__global__ void __launch_bounds__(kDqThreads)
flash_bwd_dq_f32_512_kernel(const float* __restrict__ k, const float* __restrict__ ds,
                            float* __restrict__ dq, int sq, int sk, int ldq, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                              // [kStages][kBK][kBM]: ds^T rows, key-major
  float* b_s = smem + kStages * kBK * kBM;        // [kStages][kBK][kBN]: K rows
  const int tid = threadIdx.x, tr = tid / kTN, tc = tid % kTN;
  const int bh = blockIdx.z, m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const float* dsg = ds + size_t(bh) * sk * ldq;
  const float* kg_ = k + size_t(bh) * sk * kD;
  const int nk = (sk + kBK - 1) / kBK;

  // stage kt's keys kt * kBK .. into slot kt % kStages; keys past Sk and
  // queries past ldq zero-filled
  auto fetch = [&](int kt) {
    if (kt < nk) {
      const int key0 = kt * kBK, slot = kt % kStages;
      float* as = a_s + slot * kBK * kBM;
      float* bs = b_s + slot * kBK * kBN;
      for (int e = tid; e < kBK * kBM / 4; e += kDqThreads) {
        const int r = e / (kBM / 4), c4 = e % (kBM / 4);
        const bool ok = key0 + r < sk && m0 + 4 * c4 < ldq;
        cp_async_16(smem_u32(as + r * kBM + 4 * c4),
                    dsg + (ok ? size_t(key0 + r) * ldq + m0 + 4 * c4 : 0), ok);
      }
      for (int e = tid; e < kBK * kBN / 4; e += kDqThreads) {
        const int r = e / (kBN / 4), c4 = e % (kBN / 4);
        const bool ok = key0 + r < sk;
        cp_async_16(smem_u32(bs + r * kBN + 4 * c4),
                    kg_ + (ok ? size_t(key0 + r) * kD + n0 + 4 * c4 : 0), ok);
      }
    }
    cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < kStages - 1; ++s) fetch(s);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage kt landed; every thread is done with stage kt - 1's slot
    fetch(kt + kStages - 1);
    const float* as = a_s + (kt % kStages) * kBK * kBM + 4 * tr;
    const float* bs = b_s + (kt % kStages) * kBK * kBN + 4 * tc;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = ld4(as + kk * kBM), a1 = ld4(as + kk * kBM + kBM / 2);
      const float4 b0 = ld4(bs + kk * kBN), b1 = ld4(bs + kk * kBN + kBN / 2);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  float* dqg = dq + size_t(bh) * sq * kD;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 4 * tr + i : kBM / 2 + 4 * tr + i - 4);
    if (m >= sq) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half)
      st4(dqg + size_t(m) * kD + n0 + half * (kBN / 2) + 4 * tc,
          make_float4(acc[i][4 * half] * scale, acc[i][4 * half + 1] * scale,
                      acc[i][4 * half + 2] * scale, acc[i][4 * half + 3] * scale));
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool takes(int bh, int sq, int sk, int d, int dtype) {
  return dtype == 0 && d == kD && bh >= 1 && bh <= 65535 && sq >= 1 && sk >= 1;
}

// the workspace's row stride: Sq rounded up to 4 (16-byte rows)
int ld_of(int sq) { return (sq + 3) & ~3; }

// JAX's constants: (1 / sqrt(d)) * log2(e) and 1 / sqrt(d) in double, then rounded
float c2_of() { return float(1.0 / sqrt(double(kD)) * 1.4426950408889634); }
float scale_of() { return float(1.0 / sqrt(double(kD))); }

}  // namespace

// Plain C entry points for ctypes.  dtype must be 0 (float32) and d 512.
// Each returns 0 on success, a cudaError_t code from the launch, or -1 for
// arguments the kernel does not take.

// dk, dv and the workspace ds [BH, Sk, ldq] (ldq = Sq rounded up to 4) of q,
// k, v, dO [BH, S, 512], lse2 and delta [BH, Sq]: the template's dk / dv
// arguments with ds before dk.
extern "C" int hedit_flash_attention_bwd_dkv_f32_512(const void* q, const void* k, const void* v,
                                                      const void* dout, const void* lse,
                                                      const void* delta, void* ds, void* dk,
                                                      void* dv, int bh, int sq, int sk, int d,
                                                      int dtype, void* stream) {
  if (!takes(bh, sq, sk, d, dtype)) return -1;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) && aligned16(ds) &&
        aligned16(dk) && aligned16(dv)))
    return -1;
  const int bytes = int(sizeof(float)) * kKvSmemFloats;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_f32_512_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((sk + kKeys - 1) / kKeys, bh);
  flash_bwd_dkv_f32_512_kernel<<<grid, kKvThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(ds), static_cast<float*>(dk),
      static_cast<float*>(dv), sq, sk, ld_of(sq), c2_of(), scale_of());
  return int(cudaGetLastError());
}

// dq [BH, Sq, 512] = ds k * scale from the workspace that
// hedit_flash_attention_bwd_dkv_f32_512 wrote and k [BH, Sk, 512].
extern "C" int hedit_flash_attention_bwd_dq_f32_512(const void* k, const void* ds, void* dq,
                                                     int bh, int sq, int sk, int d, int dtype,
                                                     void* stream) {
  if (!takes(bh, sq, sk, d, dtype)) return -1;
  if (!(aligned16(k) && aligned16(ds) && aligned16(dq))) return -1;
  const int bytes = int(sizeof(float)) * kDqSmemFloats;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_f32_512_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((sq + kBM - 1) / kBM, kD / kBN, bh);
  flash_bwd_dq_f32_512_kernel<<<grid, kDqThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(k), static_cast<const float*>(ds), static_cast<float*>(dq), sq,
      sk, ld_of(sq), scale_of());
  return int(cudaGetLastError());
}
