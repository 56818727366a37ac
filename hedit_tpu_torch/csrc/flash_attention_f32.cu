// The bounded (max-free) flash-attention forward in float32 on Hopper's CUDA
// cores (sm_90a), at the UNet's head dims 40 and 80: softmax(q k^T / sqrt(d))
// v, optionally with the base-2 log-sum-exp of each query as a second
// output.  Every product is a float32 FMA: no TF32 in any form.
//
// Replaces, for float32 inputs at d = 40 and 80 (the CLIs' default
// precision), the TPU kernels of hedit_tpu/ops/flash_attention.py
//   row 1: _flash_bounded_kernel (:220), head-split [BH, S, D]: entry point
//     hedit_flash_attention_fwd_f32, wrapper flash_attention_cuda;
//   row 1 on packed heads [B, S, H*D] (every UNet self-attention of >= 1024
//     tokens without a gradient): entry point
//     hedit_flash_attention_fwd_packed_bounded_f32, wrapper
//     flash_attention_packed_bounded_cuda;
//   row 3: _flash_bounded_lse_kernel (:464), the forward of
//     flash_attention_diff (every differentiated self-attention of >= 1024
//     tokens on the NMG path): entry point hedit_flash_attention_fwd_lse_f32,
//     wrapper flash_attention_lse_cuda; the same kernel instantiated with
//     LSE = true.
// bf16 inputs go to flash_attention_tc.cu; float32 at d = 512 (the VAE) and
// the exact mode stay on the CUDA-core template of flash_attention.cu.
//
// The function, as the template computes it: q * scale, scale = 1/sqrt(d) *
// log2(e) formed in double and rounded to float; scores in float32; each
// row's shift = the max of its scores over the first a_end = min(anchor, Sk)
// keys + 16; p = exp2(min(s - shift, 100)) for every key below Sk, summed in
// float32 and multiplied into V; the sum floored at 1.2e-38; out = acc / sum;
// lse2 = shift + log2(sum).  Sums run in a fixed order (no atomics), so two
// launches give the same bits.
//
// What bounds it on the H100.  4 B H Sq Sk D FLOP of float32 FMAs against
// 4 bytes an element of q, k, v and out: at [4, 8, 1024, 80] 107 GFLOP
// against 21 MB, ~5,000 FLOP a byte, so the bound is the FP32 rate (67
// TFLOP/s: 0.160 ms there).  The template (flash_attention.cu) reached 34% of
// it at d = 40 and less at d = 80, for three reasons this kernel answers:
//
// 1. The anchor window's scores are computed once, as on the TPU ("block
//    0's scores are computed once in the prologue (and their PV contribution
//    reused - no recompute)", hedit_tpu/ops/flash_attention.py:235-237; the
//    code at :290-293: s0 = scores(0), the shift from its max, then
//    acc0 = pv(0, exp2(s0 - shift))).  Here the first wt = ceil(a_end / 64)
//    key tiles (at most kWindow = 512 keys: bounded_anchor is 512 at d = 40
//    and 80) are scored and kept on chip, the first REG_TILES in registers
//    (16 floats a thread each, win below; 6 tiles at d = 80, 3 at d = 40)
//    and the rest in shared memory, their max over keys < a_end taken, and
//    then the same scores become p and their PV contribution, with each V
//    tile streamed once.  The keys a_end .. Sk stream as key tiles after
//    that.  The template ran the score product over the window twice (1/5
//    of the function's work at 1024 keys).  All 8 tiles in registers (128
//    floats) took 230 registers a thread and two blocks an SM; the split
//    fits three.
// 2. Register tiles fed by 128-bit shared-memory loads.  Both products are
//    rows-by-rows dot products over a contraction held in the minor dim of
//    two shared tiles, read as float4: QK reads q [32][D + 4] and K
//    [64][D + 4] along d, 4 x 4 scores a thread, 8 loads for 64 FMAs; PV reads
//    p [32][64 + 8] and V^T [D][64 + 4] along the keys, 4 rows x 5 columns a
//    thread, 9 loads for 80 FMAs (at d = 40 each half of a tile's keys gives
//    a partial output, the two added once at the end, so a thread's tile
//    is no thinner than at d = 80).  Shared memory delivers 32 lanes x 4
//    bytes a clock to the SM's 128 FMA lanes, so these tiles (2 and 1.8
//    bytes a FMA) cap the kernel near half the float32 rate; larger ones
//    would not leave the registers the window needs.  V is stored
//    transposed by 4-byte cp.async copies whose 32 lanes take 4 keys x 8
//    columns, so a warp's copy reads 4 sectors and its stores hit 32
//    distinct banks.  The strides put the rows a warp reads at once on
//    distinct 16-byte bank groups.
// 3. Asynchronous loads.  K and V^T tiles stream through two shared slots
//    by cp.async (rows past Sk zero-filled), one item ahead of the one in
//    use: window K tiles, window V tiles, then K and V of each later tile.
//    32 query rows a block: the UNet's [1, 8, 1024, 80] (row 3) gives 256
//    blocks, up to three an SM (shared memory 73 KB a block at d = 80).
//
// Block: 128 threads, 4 warps.  QK: warp w owns rows (w & 1) * 16 + lq + 4i
// and keys (w >> 1) * 32 + lk + 8j of a 64-key tile (lq = lane / 8, lk =
// lane % 8, i, j < 4); a row's max and sum reduce over its 8 lanes by
// shuffles and over the two key halves through shared memory.  PV: warp w
// owns output rows (w & 1) * 16 + lq + 4i and columns lk + 8m (m < 5), at
// d = 80 plus (w >> 1) * 40, at d = 40 over the keys (w >> 1) * 32 .. + 32
// of each tile.
//
// Contract: float32 (dtype 0) only; D one of 40, 80; any Sq, Sk >= 1
// (ragged tails masked); 1 <= anchor and min(anchor, Sk) <= kWindow; every
// pointer of q, k, v and out 16-byte aligned and every element stride a
// multiple of 4 (16-byte copies of rows).  Head-split entries: q [BH, Sq, D],
// k and v [BH, Sk, D], contiguous, lse2 [BH, Sq]; packed: as
// flash_attention.cu's packed entry points (packed_layout).  Anything else
// returns -1.

#include <cmath>
#include <cstdint>

#include "flash_common.cuh"
#include "flash_mma.cuh"

// blocks an SM the compiler budgets registers for (the tile probe builds
// other values with -D)
#ifndef F32_MINB_40
#define F32_MINB_40 3
#endif
#ifndef F32_MINB_80
#define F32_MINB_80 3
#endif
// the inner loops' unroll factor (the tile probe builds 1 with -D)
#ifndef F32_UNROLL
#define F32_UNROLL 2
#endif
// timing ablations of the tile probe only (wrong outputs): 1 copies no V,
// 2 computes no exp2
#ifndef F32_ABLATE
#define F32_ABLATE 0
#endif

namespace {

constexpr int kF32Threads = 128;
constexpr int kRows = 32;                      // query rows of a block
constexpr int kKeys = 64;                      // keys of a tile
constexpr int kWindow = 512;                   // anchor keys kept on chip
constexpr int kWindowTiles = kWindow / kKeys;
constexpr int kUnroll = F32_UNROLL;
constexpr int kPStride = kKeys + 8;            // p rows: 4 rows of a warp on 4 bank groups
constexpr int kVStride = kKeys + 4;            // V^T rows: 8 columns on 8 bank groups
constexpr float kShiftMargin = 16.f;           // shift = anchor max + 16 (base 2)
constexpr float kSaturate = 100.f;             // p = exp2(min(s - shift, 100))
constexpr float kDenomFloor = 1.2e-38f;

template <int D>
struct F32Tile {
  static_assert(D == 40 || D == 80, "the float32 kernel takes d = 40 and 80");
  static constexpr int DS = D + 4;             // q and K rows
  // PV: 4 rows x 5 columns a thread; d = 80 splits the 80 columns over two
  // warp pairs, d = 40 splits a tile's 64 keys instead (KS = 2 partial
  // outputs, added in a fixed order at the end)
  static constexpr int KS = D == 80 ? 1 : 2;
  // window tiles in registers (16 floats a thread each); the others in
  // shared memory, as much as three blocks an SM leave (d = 80: 1 + p_s,
  // d = 40: 4 + p_s)
  static constexpr int REG_TILES = D == 80 ? 6 : 3;
  static constexpr int SLOT = kKeys * DS > D * kVStride ? kKeys * DS : D * kVStride;
  // q, two K / V^T slots, p (window tile 7), window tiles REG_TILES .. 6, the
  // two key halves' row max or sum
  static constexpr int SMEM_FLOATS =
      kRows * DS + 2 * SLOT + (kWindowTiles - REG_TILES) * kRows * kPStride + 2 * kRows;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int D, bool LSE, int MINB>
__global__ void __launch_bounds__(kF32Threads, MINB)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, Strides qs, Strides ks, Strides vs, Strides os,
                     int heads, int sq, int sk, float qscale, int anchor) {
  using Cfg = F32Tile<D>;
  constexpr int DS = Cfg::DS, KS = Cfg::KS, kRegTiles = Cfg::REG_TILES;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                        // [kRows][DS], q * scale
  float* slots = q_s + kRows * DS;          // 2 x (K [kKeys][DS] or V^T [D][kVStride])
  float* p_s = slots + 2 * Cfg::SLOT;       // [kRows][kPStride]; window tile 7's scores
  float* w_s = p_s + kRows * kPStride;      // [..][kRows][kPStride]: window tiles kRegTiles ..
  float* red_s = w_s + (kWindowTiles - 1 - kRegTiles) * kRows * kPStride;   // [2][kRows]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lq = lane >> 3, lk = lane & 7;
  const int kh = warp >> 1;                               // QK key half
  const int qk_row = (warp & 1) * 16 + lq;                // + 4i
  const int qk_key = kh * 32 + lk;                        // + 8j
  const int pv_row = (warp & 1) * 16 + lq;                // + 4i
  const int pv_col = (KS == 1 ? kh * 40 : 0) + lk;        // + 8m
  const int pv_key = KS == 2 ? kh * 32 : 0;               // + the tile's keys / KS

  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int q0 = blockIdx.x * kRows;
  const float* qg = q + b * qs.batch + h * qs.head;
  const float* kg = k + b * ks.batch + h * ks.head;
  const float* vg = v + b * vs.batch + h * vs.head;

  const int a_end = anchor < sk ? anchor : sk;
  const int nt = (sk + kKeys - 1) / kKeys;      // key tiles
  const int wt = (a_end + kKeys - 1) / kKeys;   // of them the window's (<= kWindowTiles)
  const int ws = wt > kRegTiles ? wt - kRegTiles : 0;   // window tiles in shared memory
  const int n_items = 2 * nt;

  // item n of the load stream: window K tiles 0 .. wt-1; window V tiles in
  // the order of their PV products, those in shared memory first (wt - 1
  // down to kRegTiles), then 0 .. ; then K and V of tiles wt, wt + 1, ...;
  // into slot n & 1
  auto fetch = [&](int n) {
    int tile, is_v;
    if (n < wt) {
      tile = n, is_v = 0;
    } else if (n < 2 * wt) {
      tile = n - wt < ws ? 2 * wt - 1 - n : n - wt - ws, is_v = 1;
    } else {
      tile = wt + ((n - 2 * wt) >> 1), is_v = (n - 2 * wt) & 1;
    }
    float* dst = slots + (n & 1) * Cfg::SLOT;
    const int k0 = tile * kKeys;
    if (!is_v) {
#pragma unroll 2
      for (int e = tid; e < kKeys * D / 4; e += kF32Threads) {
        const int r = e / (D / 4), c4 = e - r * (D / 4);
        const bool ok = k0 + r < sk;
        cp_async_16(smem_u32(dst + r * DS + 4 * c4), kg + (ok ? (k0 + r) * ks.row + 4 * c4 : 0),
                    ok);
      }
    } else if (F32_ABLATE != 1) {
      // V^T[col][key] by 4-byte copies: a warp's 32 copies are 4 keys x 8
      // consecutive columns (4 sectors of global memory, 32 distinct banks);
      // warp w takes keys 4 (w + 4 kk) + 0..3, every column
      const int col0 = lane & 7, key0 = (lane >> 3) + 4 * warp;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int key = key0 + 16 * kk;
        const bool ok = k0 + key < sk;
        const float* src = vg + (ok ? (k0 + key) * vs.row : 0) + col0;
        const unsigned d0 = smem_u32(dst + col0 * kVStride + key);
#pragma unroll
        for (int c = 0; c < D; c += 8)
          cp_async_4(d0 + 4 * c * kVStride, src + c, ok);
      }
    }
    cp_async_commit();
  };
  // item n has landed and every thread is done with item n - 1; start n + 1
  auto step = [&](int n) {
    cp_async_wait<0>();
    __syncthreads();
    if (n + 1 < n_items) fetch(n + 1);
  };
  auto slot = [&](int n) { return slots + (n & 1) * Cfg::SLOT; };

  // s[i][j] = q_s[qk_row + 4i] . K[qk_key + 8j], summed over d in order
  auto qk = [&](const float* k_s, float (&s)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll kUnroll
    for (int c = 0; c < D; c += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = ld4(q_s + (qk_row + 4 * i) * DS + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 kv = ld4(k_s + (qk_key + 8 * j) * DS + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }
  };

  // this thread's entries of a [kRows][kPStride] tile: row qk_row + 4i, key qk_key + 8j
  auto at = [&](float* buf, int i, int j) -> float& {
    return buf[(qk_row + 4 * i) * kPStride + qk_key + 8 * j];
  };
  // p of a tile's scores into buf and the row sums; keys at or past Sk give 0
  auto emit_p = [&](const float (&s)[4][4], int k0, const float (&shift)[4], float (&lsum)[4],
                    float* buf) {
    const bool tail = k0 + kKeys > sk;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = F32_ABLATE == 2 ? s[i][j] - shift[i]
                                  : exp2f(fminf(s[i][j] - shift[i], kSaturate));
        if (tail && k0 + qk_key + 8 * j >= sk) p = 0.f;
        at(buf, i, j) = p;
        lsum[i] += p;
      }
  };
  // acc[i][m] += sum over the tile's keys of p[pv_row + 4i][key] V[key][pv_col + 8m]
  auto pv = [&](const float* p_t, const float* v_t, float (&acc)[4][5]) {
#pragma unroll kUnroll
    for (int kk = pv_key; kk < pv_key + kKeys / KS; kk += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ld4(p_t + (pv_row + 4 * i) * kPStride + kk);
#pragma unroll
      for (int m = 0; m < 5; ++m) {
        const float4 vv = ld4(v_t + (pv_col + 8 * m) * kVStride + kk);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][m] = fmaf(pr[i].x, vv.x, acc[i][m]);
          acc[i][m] = fmaf(pr[i].y, vv.y, acc[i][m]);
          acc[i][m] = fmaf(pr[i].z, vv.z, acc[i][m]);
          acc[i][m] = fmaf(pr[i].w, vv.w, acc[i][m]);
        }
      }
    }
  };

  // q * scale in float32, as the TPU kernel scales q; rows past Sq are 0
  for (int e = tid; e < kRows * D / 4; e += kF32Threads) {
    const int r = e / (D / 4), c4 = e - r * (D / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < sq) {
      x = ld4(qg + (q0 + r) * qs.row + 4 * c4);
      x.x *= qscale, x.y *= qscale, x.z *= qscale, x.w *= qscale;
    }
    *reinterpret_cast<float4*>(q_s + r * DS + 4 * c4) = x;
  }
  fetch(0);

  // The window: its scores once, kept on chip until the shift is known:
  // tiles 0 .. kRegTiles - 1 in registers, the next in w_s, tile 7 in p_s
  // (free until the window's PV), so three blocks fit an SM.
  auto wbuf = [&](int t) {
    return t == kWindowTiles - 1 ? p_s : w_s + (t - kRegTiles) * kRows * kPStride;
  };
  float win[kRegTiles][4][4];
  float mx[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int t = 0; t < kWindowTiles; ++t) {
    if (t < wt) {
      step(t);
      float s[4][4];
      float (&sc)[4][4] = t < kRegTiles ? win[t < kRegTiles ? t : 0] : s;
      qk(slot(t), sc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (t >= kRegTiles) at(wbuf(t), i, j) = sc[i][j];
          if (t * kKeys + qk_key + 8 * j < a_end) mx[i] = fmaxf(mx[i], sc[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
    if (lk == 0) red_s[kh * kRows + qk_row + 4 * i] = mx[i];
  }
  __syncthreads();
  float shift[4], lsum[4], acc[4][5];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // key 0 is in the window (sk, anchor >= 1): finite
    shift[i] = fmaxf(red_s[qk_row + 4 * i], red_s[kRows + qk_row + 4 * i]) + kShiftMargin;
    lsum[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < 5; ++m) acc[i][m] = 0.f;

  // The window's p (every key below Sk, a_end .. 64 wt included) and its
  // PV: the tiles in shared memory first (7, 6, ..), each turned into p in
  // place, then 0 .. from the registers through p_s.
  int n = wt;
#pragma unroll
  for (int t = kWindowTiles - 1; t >= kRegTiles; --t) {
    if (t < wt) {
      step(n);          // V tile t landed
      float* buf = wbuf(t);
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = at(buf, i, j);
      emit_p(s, t * kKeys, shift, lsum, buf);
      __syncthreads();
      pv(buf, slot(n), acc);
      ++n;
    }
  }
#pragma unroll
  for (int t = 0; t < kRegTiles; ++t) {
    if (t < wt) {
      step(n);          // V tile t landed; the last PV's p_s reads are done
      emit_p(win[t], t * kKeys, shift, lsum, p_s);
      __syncthreads();
      pv(p_s, slot(n), acc);
      ++n;
    }
  }
  // the keys after the window
  for (int t = wt; t < nt; ++t) {
    step(2 * t);        // K tile t; the last PV is done with p_s
    float s[4][4];
    qk(slot(2 * t), s);
    emit_p(s, t * kKeys, shift, lsum, p_s);
    step(2 * t + 1);    // V tile t; p_s written
    pv(p_s, slot(2 * t + 1), acc);
  }

  // row sums: the 8 lanes of a row, then the two key halves, in that order;
  // at d = 40 the PV key half 1 hands its partial outputs over through p_s
  if (KS == 2) __syncthreads();     // every PV is done with p_s
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], off);
    if (lk == 0) red_s[kh * kRows + qk_row + 4 * i] = lsum[i];
    if (KS == 2 && kh == 1) {
#pragma unroll
      for (int m = 0; m < 5; ++m) p_s[(pv_row + 4 * i) * kPStride + pv_col + 8 * m] = acc[i][m];
    }
  }
  __syncthreads();
  if (LSE && kh == 0 && lk == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = qk_row + 4 * i;
      const float l = fmaxf(red_s[r] + red_s[kRows + r], kDenomFloor);
      if (q0 + r < sq) lse[size_t(bh) * sq + q0 + r] = shift[i] + log2f(l);
    }
  }
  if (KS == 2 && kh == 1) return;
  float* og = out + b * os.batch + h * os.head;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = pv_row + 4 * i;
    if (q0 + r >= sq) continue;
    const float l = fmaxf(red_s[r] + red_s[kRows + r], kDenomFloor);
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      const float o = KS == 2 ? acc[i][m] + p_s[r * kPStride + pv_col + 8 * m] : acc[i][m];
      og[(q0 + r) * os.row + pv_col + 8 * m] = o / l;
    }
  }
}

template <int D, bool LSE, int MINB>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, float* lse,
                       const Layout& lay, int sq, int sk, int anchor, cudaStream_t stream) {
  auto kernel = flash_fwd_f32_kernel<D, LSE, MINB>;
  const size_t smem = sizeof(float) * F32Tile<D>::SMEM_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kRows - 1) / kRows, lay.bh);
  // JAX's constant, (1 / sqrt(d)) * log2(e) in double, then rounded
  const float qscale = float(1.0 / sqrt(double(D)) * 1.4426950408889634);
  kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, lay.q, lay.k, lay.v, lay.out, lay.heads, sq, sk, qscale,
      anchor);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool strides_of_4(const Strides& s) {
  return s.batch % 4 == 0 && s.head % 4 == 0 && s.row % 4 == 0;
}

template <bool LSE>
int forward_f32(const void* q, const void* k, const void* v, void* out, float* lse,
                const Layout& lay, int sq, int sk, int d, int anchor, int dtype, void* stream) {
  if (dtype != 0) return -1;
  if (lay.bh < 1 || sq < 1 || sk < 1 || lay.bh > 65535) return -1;
  if (anchor < 1 || (anchor < sk ? anchor : sk) > kWindow) return -1;
  if (!rows_fit(lay, sq, sk)) return -1;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out))) return -1;
  if (!(strides_of_4(lay.q) && strides_of_4(lay.k) && strides_of_4(lay.v) &&
        strides_of_4(lay.out)))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 40)
    return int(launch_f32<40, LSE, F32_MINB_40>(q, k, v, out, lse, lay, sq, sk, anchor, s));
  if (d == 80)
    return int(launch_f32<80, LSE, F32_MINB_80>(q, k, v, out, lse, lay, sq, sk, anchor, s));
  return -1;
}

}  // namespace

// Plain C entry points for ctypes, the arguments of flash_attention.cu's
// bounded entries (dtype must be 0, float32).  Each returns 0 on success, a
// cudaError_t code from the launch, or -1 for arguments the kernel does not
// take.

// Row 1, head-split; anchor: the anchor window in keys.
extern "C" int hedit_flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                                             void* out, int bh, int sq, int sk, int d,
                                             int anchor, int dtype, void* stream) {
  return forward_f32<false>(q, k, v, out, nullptr, head_split(bh, sq, sk, d), sq, sk, d, anchor,
                            dtype, stream);
}

// Row 3: the same forward, also writing lse2 [BH, Sq] float32.
extern "C" int hedit_flash_attention_fwd_lse_f32(const void* q, const void* k, const void* v,
                                                 void* out, void* lse, int bh, int sq, int sk,
                                                 int d, int anchor, int dtype, void* stream) {
  if (lse == nullptr) return -1;
  return forward_f32<true>(q, k, v, out, static_cast<float*>(lse), head_split(bh, sq, sk, d), sq,
                           sk, d, anchor, dtype, stream);
}

// Row 1 on packed heads.
extern "C" int hedit_flash_attention_fwd_packed_bounded_f32(const void* q, const void* k,
                                                            const void* v, void* out, int b,
                                                            int h, int sq, int sk, int d,
                                                            int anchor, long long q_bs,
                                                            long long k_bs, long long v_bs,
                                                            int dtype, void* stream) {
  Layout lay;
  if (!packed_layout(b, h, sq, sk, d, q_bs, k_bs, v_bs, &lay)) return -1;
  return forward_f32<false>(q, k, v, out, nullptr, lay, sq, sk, d, anchor, dtype, stream);
}
