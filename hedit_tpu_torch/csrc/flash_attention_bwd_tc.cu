// Flash-attention backward in bfloat16 on Hopper's tensor cores (sm_90a):
// dq, dk and dv of out = softmax(q k^T / sqrt(d)) v from the forward's
// base-2 log-sum-exp, in the TPU kernels' arithmetic.
//
// Replaces, for bf16 inputs at the UNet's head dims (40 and 80) and the
// VAE's 512, the TPU kernels hedit_tpu/ops/flash_attention.py:
// _flash_bwd_dq_kernel (:553) and _flash_bwd_dkv_kernel (:593), wrapper
// _flash_bwd_pallas (:648), the backward of flash_attention_diff: every mode
// that differentiates through the UNet (NMG's guidance, null-text) and, at
// D = 512, the style reward's gradient through the VAE decode's mid-block
// attention.  Entry points hedit_flash_attention_bwd_dq_tc and
// hedit_flash_attention_bwd_dkv_tc, wrappers flash_bwd_dq_cuda and
// flash_bwd_dkv_cuda (ops/flash_attention.py, which route by bwd_entry).
// float32 inputs at D = 40 / 80 go to the fused kernel of
// flash_attention_bwd_f32.cu, float32 at D = 512 to the CUDA-core template
// of flash_attention_bwd.cu.
//
// The function, exactly as the TPU kernels round it.  With c = 1/sqrt(d) *
// log2(e) (formed in double, rounded to float, then to bf16, as the
// tensor-core forward forms it), lse2 the forward's base-2 log-sum-exp of
// each query and delta = rowsum(dO * O) (float32, computed outside):
//   dq:    qs = bf16(q * c); s = qs k^T; p = exp2(s - lse2); dp = dO v^T;
//          ds = bf16(p * (dp - delta)); dq = bf16(scale * sum ds k)
//   dk/dv: ks = bf16(k * c); s = q ks^T, p, dp and ds as above on those
//          scores; dv = bf16(sum bf16(p)^T dO); dk = bf16(scale * sum ds^T q)
// Every product takes bf16 operands and sums in float32: the operand
// contract of mma.sync ... .f32.bf16.bf16.f32.  The two kernels see
// differently rounded scores (qs k against q ks), as on the TPU.  Keys at or
// past Sk give p = 0 in dq and queries at or past Sq give p = 0 in dk/dv.
//
// What bounds them on the H100.  dq does three products over the Sq x Sk
// score grid (s, dp, ds k), dk/dv four (s, dp, p^T dO, ds^T q): 6 and 8 *
// Sq * Sk * D FLOP a (batch, head).  At [1, 8, 4096, 40] that is 32 + 43
// GFLOP over ~11 MB of inputs and outputs, ~3,000 FLOP a byte against the
// card's ~295: both are bound by the tensor cores' 989 TFLOP/s (0.033 and
// 0.043 ms).  Beside the products, every score costs one exp2 (MUFU, 16 a
// clock an SM) and a few FMAs, so at D = 40 the exponentials are a third of
// the products' time in each kernel.
//
// Design at D = 40 / 80 (FlashAttention-2's backward for mma.sync m16n8k16,
// without its atomics):
// - Two kernels, as the TPU and the template have them.  A dq block owns
//   query rows and streams K / V tiles; a dk/dv block owns key rows and
//   streams Q / dO tiles with their lse2 and delta.  Every output element is
//   written by one block: no atomics, results do not change from run to run.
// - A warp owns 16 rows.  Its own-side operands are rounded into shared
//   memory once and kept in registers as A fragments (ldmatrix): qs and dO
//   in dq, ks and V in dk/dv.  The streamed tiles pass through a two-stage
//   ring of cp.async 16-byte copies (rows past the end zero-filled; lse2
//   and delta by 4-byte copies), so tile j + 1 loads while tile j computes.
//   Shared rows are DK + 8 elements (112 or 176 bytes), which puts the
//   eight rows of an 8 x 8 ldmatrix on distinct 16-byte bank groups.
// - dq: per 16 streamed keys, S = qs K^T and dP = dO V^T (two n-tiles each,
//   K and V fragments by ldmatrix); ds in the C layout is rounded to bf16
//   pairs and is the A fragment of dQ += dS K (K by ldmatrix.trans).
// - dk/dv forms the transposed grids directly: per 16 streamed queries,
//   S^T = ks Q^T and dP^T = V dO^T, Q and dO by ldmatrix.  P^T and dS^T come
//   out in the C layout whose rows are keys, which is the A layout of
//   dV += P^T dO and dK += dS^T Q (dO and Q by ldmatrix.trans).  p and ds
//   never leave registers, as p does not in the tensor-core forward.
// - D = 40: the S and dP products contract over 48 (zero pad columns in the
//   fragments and in the ring), the outputs are 5 n-tiles of 8.
// - Only the last streamed tile pays for the mask.
// - Tiles (the entry points below): BR own rows (16 a warp) and BT streamed
//   rows a tile, chosen by a sweep on an H100 80GB HBM3 at 700 W
//   (probes/flash_bwd_tiles.py, its six variants; PERF.md).  Occupancy
//   decides at D = 40: the dk/dv kernel at 145 registers (3 blocks of 4
//   warps an SM) took 0.24 ms at [1, 8, 4096, 40], capped at 128 (4 blocks,
//   no spills) 0.17; 2-warp blocks were 1.8-2x slower (each streamed tile
//   feeds half the rows), 32-row tiles 9-13% slower.  At D = 80 a dk/dv
//   warp holds its dK and dV accumulators (80 registers a lane), its ks and
//   V fragments (40) and the 16 x 16 score tiles: 212 registers, 2 blocks an
//   SM, no spills; [1, 8, 1024, 80] gives 128 blocks of 64 rows on 132 SMs,
//   and 128-row tiles (half the barriers) were 7-8% faster than 64.
//
// D = 512 (the kernels after the D = 40 / 80 ones).  A warp cannot own
// whole rows there: one 16 x 512 float32 accumulator is 256 registers a
// lane, one 16 x 512 bf16 A operand 128.  At [1, 1, 4096, 512] the two
// kernels need 52 + 69 GFLOP over ~21 MB (0.052 + 0.069 ms at 989 TFLOP/s),
// and one head has to fill 132 SMs.  So:
// - A block owns BR = 32 rows (128 blocks at 4096) and stages its two
//   operands once (qs and dO in dq, ks and V in dk/dv: 66.5 KB, rows of
//   1040 bytes, 65 16-byte units, so an ldmatrix's eight rows fall on
//   distinct bank groups); the streamed tiles (BT = 32 rows) pass through
//   the same two-stage cp.async ring as at D = 40 / 80 (133 KB).
// - The block's 8 warps split each tile's work two ways and pass p and ds
//   between them through shared memory.  The score grid (S and dP in dq,
//   S^T and dP^T in dk/dv: 32 x 32 each, contracted over 512) is cut into
//   jobs of 16 own rows x JN = 32 streamed rows x half the contraction, one
//   a warp, both operands by ldmatrix; each job writes its float32 partial
//   sums into a grid of its own.  After a barrier every thread adds the two
//   halves (the half over d = 0 .. 255 first), forms p = exp2(s - lse2)
//   with the mask, and rounds ds = bf16(p (dp - delta)) (and, in dk/dv,
//   bf16(p)) into bf16 [32][40] grids: the TPU kernels' roundings.
// - After another barrier the output products (dQ += dS K; dV += P^T dO
//   and dK += dS^T Q) are split by output columns: warp w owns 64 columns
//   of all 32 rows (64 float32 registers a lane for dq, 128 for dk and dv),
//   A fragments from the bf16 grids by ldmatrix, B from the ring by
//   ldmatrix.trans; the outputs leave registers once, at the end.
// - Shared memory: 218 KB (dq) and 221 KB (dk/dv) of the 227 KB a block
//   may have, so one block of 8 warps an SM.  No atomics: one writer an
//   output element, results the same from launch to launch.
// - Tiles chosen by the sweep on an H100 80GB HBM3 at 700 W
//   (probes/flash_bwd_tiles.py --tc; PERF.md): 16 x 16 jobs over the whole
//   contraction were 7-9% slower (512 bytes of ldmatrix an mma against
//   384), 16-row tiles 27-28%, 16-row blocks 34-48%, and 64-row dq blocks
//   (half the L2 traffic, half the SMs) twice as slow.
//
// Contract: bf16 only (dtype 1), D 40, 80 or 512.  q, dO [BH, Sq, D]; k, v
// [BH, Sk, D]; lse2, delta [BH, Sq] float32; dq, dk, dv in bf16; all
// contiguous.  Every bf16 pointer 16-byte aligned (cp.async copies 16
// bytes); any Sq, Sk >= 1.  Anything else returns -1.

#include <cmath>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kStages = 2;  // streamed ring depth

// WR warps of 16 own rows; streamed tiles of BT rows; MINB blocks an SM (a
// register budget for the compiler).
template <int D, int WR, int BT, int MINB>
struct BwdTc {
  static constexpr int kThreadsTc = 32 * WR;
  static constexpr int BR = 16 * WR;              // own rows of a block
  static constexpr int DK = (D + 15) / 16 * 16;   // score contraction, zero-padded to k = 16
  static constexpr int KD = DK / 16;              // its k-steps
  static constexpr int SS = DK + 8;               // shared row stride (elements)
  static constexpr int NO = D / 8;                // output n-tiles
  static constexpr int CH = D / 8;                // 16-byte chunks of a row
  static_assert(D % 8 == 0 && BT % 16 == 0, "tile does not fit the mma shapes");

  // the own side's two staged operands, then the ring of two streamed operands
  static constexpr size_t tiles_bytes() {
    return sizeof(bf16) * (2 * size_t(BR) + 2 * size_t(kStages) * BT) * SS;
  }
};

// Rows r0 .. r0 + rows of the [valid][D] operands a and b, scaled (a only) and
// rounded to bf16, into two [rows][SS] staging tiles; rows past `valid` and
// the pad columns D .. DK are zero.
template <int D, int DK, int SS, int NTH>
__device__ __forceinline__ void stage_own(bf16* a_s, bf16* b_s, const bf16* a, const bf16* b,
                                          int r0, int rows, int valid, float scale) {
  constexpr int CH = D / 8, CK = DK / 8;
  for (int e = threadIdx.x; e < rows * CK; e += NTH) {
    const int r = e / CK, c = e - r * CK;
    uint4 x = make_uint4(0, 0, 0, 0), y = make_uint4(0, 0, 0, 0);
    if (r0 + r < valid && c < CH) {
      x = *reinterpret_cast<const uint4*>(a + size_t(r0 + r) * D + c * 8);
      y = *reinterpret_cast<const uint4*>(b + size_t(r0 + r) * D + c * 8);
      bf16* xe = reinterpret_cast<bf16*>(&x);
#pragma unroll
      for (int i = 0; i < 8; ++i) xe[i] = __float2bfloat16(__bfloat162float(xe[i]) * scale);
    }
    *reinterpret_cast<uint4*>(a_s + r * SS + c * 8) = x;
    *reinterpret_cast<uint4*>(b_s + r * SS + c * 8) = y;
  }
}

// The pad columns D .. DK of `rows` rows of the ring: never copied into, so
// zeroed once.
template <int D, int DK, int SS, int NTH>
__device__ __forceinline__ void zero_pad(bf16* ring, int rows) {
  if constexpr (DK > D) {
    for (int e = threadIdx.x; e < rows * ((DK - D) / 8); e += NTH) {
      const int r = e / ((DK - D) / 8), c = e - r * ((DK - D) / 8);
      *reinterpret_cast<uint4*>(ring + r * SS + D + c * 8) = make_uint4(0, 0, 0, 0);
    }
  }
}

// The A fragments of one warp's 16 staged rows, over the whole contraction.
template <int KD, int SS>
__device__ __forceinline__ void load_a(const bf16* s, int lane, unsigned (&f)[KD][4]) {
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldsm_x4(smem_u32(s + (lane & 15) * SS + kk * 16 + (lane >> 4) * 8), f[kk]);
}

// c[0..1] += a b^T over the contraction for the 16 streamed rows at `tile`
// (two n-tiles of 8): the streamed rows are the B operand's columns, read
// by ldmatrix from their shared rows.
template <int KD, int SS>
__device__ __forceinline__ void scores16(const bf16* tile, int lane, const unsigned (&a)[KD][4],
                                         float (&c)[2][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[h][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    unsigned b[4];
    ldsm_x4(smem_u32(tile + ((lane & 7) + (lane >> 4) * 8) * SS + kk * 16 +
                     ((lane >> 3) & 1) * 8),
            b);
    mma_bf16(c[0], a[kk], b[0], b[1]);
    mma_bf16(c[1], a[kk], b[2], b[3]);
  }
}

// acc += a x, x the 16 streamed rows at `tile` by D columns (ldmatrix.trans).
template <int NO, int SS>
__device__ __forceinline__ void accumulate16(const bf16* tile, int lane, const unsigned (&a)[4],
                                             float (&acc)[NO][4]) {
  const bf16* row = tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * SS;
#pragma unroll
  for (int np = 0; np < NO / 2; ++np) {
    unsigned b[4];
    ldsm_x4_t(smem_u32(row + np * 16 + (lane >> 4) * 8), b);
    mma_bf16(acc[2 * np], a, b[0], b[1]);
    mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
  }
  if constexpr (NO % 2 == 1) {
    unsigned b[2];
    ldsm_x2_t(smem_u32(row + (NO - 1) * 8), b);
    mma_bf16(acc[NO - 1], a, b[0], b[1]);
  }
}

// dq: a block owns BR queries of one (batch, head) and streams key tiles.
template <int D, int WR, int BT, int MINB>
__global__ void __launch_bounds__(32 * WR, MINB)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dq, int sq, int sk, float cscale, float scale) {
  using C = BwdTc<D, WR, BT, MINB>;
  constexpr int BR = C::BR, DK = C::DK, KD = C::KD, SS = C::SS, NO = C::NO, CH = C::CH,
                NTH = C::kThreadsTc;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs_s = reinterpret_cast<bf16*>(smem_raw);  // [BR][SS] qs
  bf16* do_s = qs_s + BR * SS;                      // [BR][SS] dO
  bf16* k_s = do_s + BR * SS;                       // [kStages][BT][SS]
  bf16* v_s = k_s + kStages * BT * SS;              // [kStages][BT][SS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * BR;
  const bf16* kg = k + size_t(bh) * sk * D;
  const bf16* vg = v + size_t(bh) * sk * D;

  // qs = q * c rounded to bf16, c itself rounded first, as the TPU kernel
  stage_own<D, DK, SS, NTH>(qs_s, do_s, q + size_t(bh) * sq * D, dout + size_t(bh) * sq * D,
                            q0, BR, sq, __bfloat162float(__float2bfloat16(cscale)));
  zero_pad<D, DK, SS, NTH>(k_s, 2 * kStages * BT);  // the K and V rings
  __syncthreads();
  unsigned qf[KD][4], df[KD][4];
  load_a<KD, SS>(qs_s + warp * 16 * SS, lane, qf);
  load_a<KD, SS>(do_s + warp * 16 * SS, lane, df);

  // lse2 and delta of the lane's rows g and g + 8; a padded query row takes
  // 0 and gives finite values that are never stored
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    lse_r[r] = row < sq ? lse[size_t(bh) * sq + row] : 0.f;
    dl_r[r] = row < sq ? delta[size_t(bh) * sq + row] : 0.f;
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  auto load_tile = [&](int k0, int stage) {
    bf16* kd = k_s + stage * BT * SS;
    bf16* vd = v_s + stage * BT * SS;
    for (int e = tid; e < BT * CH; e += NTH) {
      const int r = e / CH, c = e - r * CH;
      const bool ok = k0 + r < sk;
      const size_t src = size_t(ok ? k0 + r : 0) * D + c * 8;
      cp_async_16(smem_u32(kd + r * SS + c * 8), kg + src, ok);
      cp_async_16(smem_u32(vd + r * SS + c * 8), vg + src, ok);
    }
    cp_async_commit();
  };

  const int n = (sk + BT - 1) / BT;
  load_tile(0, 0);
  for (int j = 0; j < n; ++j) {
    if (j + 1 < n) {
      load_tile((j + 1) * BT, (j + 1) % kStages);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and, at j = 0, the pad columns) visible
    const int k0 = j * BT;
    const bf16* kt = k_s + (j % kStages) * BT * SS;
    const bf16* vt = v_s + (j % kStages) * BT * SS;
    const bool ragged = k0 + BT > sk;  // only the last tile masks keys
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      float s[2][4], dp[2][4];
      scores16<KD, SS>(kt + kk * 16 * SS, lane, qf, s);
      scores16<KD, SS>(vt + kk * 16 * SS, lane, df, dp);
      // ds of keys kk*16 .. kk*16 + 16, rounded to bf16: the A fragment of dS K
      unsigned a[4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int key = k0 + kk * 16 + hh * 8 + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float p0 = exp2f(s[hh][2 * r] - lse_r[r]);
          float p1 = exp2f(s[hh][2 * r + 1] - lse_r[r]);
          if (ragged) {  // keys past Sk (zero-filled rows) add 0
            p0 = key < sk ? p0 : 0.f;
            p1 = key + 1 < sk ? p1 : 0.f;
          }
          a[hh * 2 + r] = pack_bf16(p0 * (dp[hh][2 * r] - dl_r[r]),
                                    p1 * (dp[hh][2 * r + 1] - dl_r[r]));
        }
      }
      accumulate16<NO, SS>(kt + kk * 16 * SS, lane, a, acc);
    }
    __syncthreads();  // tile j's stage is free for tile j + 2
  }

  bf16* og = dq + size_t(bh) * sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= sq) continue;
#pragma unroll
    for (int nn = 0; nn < NO; ++nn)
      *reinterpret_cast<__nv_bfloat162*>(og + size_t(row) * D + nn * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[nn][2 * r] * scale, acc[nn][2 * r + 1] * scale);
  }
}

// dk, dv: a block owns BR keys of one (batch, head) and streams query tiles
// with their lse2 and delta.
template <int D, int WR, int BT, int MINB>
__global__ void __launch_bounds__(32 * WR, MINB)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk,
                        float cscale, float scale) {
  using C = BwdTc<D, WR, BT, MINB>;
  constexpr int BR = C::BR, DK = C::DK, KD = C::KD, SS = C::SS, NO = C::NO, CH = C::CH,
                NTH = C::kThreadsTc;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks_s = reinterpret_cast<bf16*>(smem_raw);   // [BR][SS] ks
  bf16* v_s = ks_s + BR * SS;                        // [BR][SS] V
  bf16* q_s = v_s + BR * SS;                         // [kStages][BT][SS]
  bf16* o_s = q_s + kStages * BT * SS;               // [kStages][BT][SS] dO
  float* l_s = reinterpret_cast<float*>(o_s + kStages * BT * SS);  // [kStages][BT] lse2
  float* d_s = l_s + kStages * BT;                   // [kStages][BT] delta

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, k0 = blockIdx.x * BR;
  const bf16* qg = q + size_t(bh) * sq * D;
  const bf16* og = dout + size_t(bh) * sq * D;
  const float* lg = lse + size_t(bh) * sq;
  const float* dg = delta + size_t(bh) * sq;

  // ks = k * c rounded to bf16, c itself rounded first, as the TPU kernel
  stage_own<D, DK, SS, NTH>(ks_s, v_s, k + size_t(bh) * sk * D, v + size_t(bh) * sk * D, k0,
                            BR, sk, __bfloat162float(__float2bfloat16(cscale)));
  zero_pad<D, DK, SS, NTH>(q_s, 2 * kStages * BT);  // the Q and dO rings
  __syncthreads();
  unsigned kf[KD][4], vf[KD][4];
  load_a<KD, SS>(ks_s + warp * 16 * SS, lane, kf);
  load_a<KD, SS>(v_s + warp * 16 * SS, lane, vf);

  float acc_k[NO][4], acc_v[NO][4];
#pragma unroll
  for (int nn = 0; nn < NO; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[nn][e] = acc_v[nn][e] = 0.f;

  auto load_tile = [&](int q0, int stage) {
    bf16* qd = q_s + stage * BT * SS;
    bf16* od = o_s + stage * BT * SS;
    for (int e = tid; e < BT * CH; e += NTH) {
      const int r = e / CH, c = e - r * CH;
      const bool ok = q0 + r < sq;
      const size_t src = size_t(ok ? q0 + r : 0) * D + c * 8;
      cp_async_16(smem_u32(qd + r * SS + c * 8), qg + src, ok);
      cp_async_16(smem_u32(od + r * SS + c * 8), og + src, ok);
    }
    for (int r = tid; r < BT; r += NTH) {
      const bool ok = q0 + r < sq;
      const int row = ok ? q0 + r : 0;
      cp_async_4(smem_u32(l_s + stage * BT + r), lg + row, ok);
      cp_async_4(smem_u32(d_s + stage * BT + r), dg + row, ok);
    }
    cp_async_commit();
  };

  const int n = (sq + BT - 1) / BT;
  load_tile(0, 0);
  for (int j = 0; j < n; ++j) {
    if (j + 1 < n) {
      load_tile((j + 1) * BT, (j + 1) % kStages);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and, at j = 0, the pad columns) visible
    const int q0 = j * BT, stage = j % kStages;
    const bf16* qt = q_s + stage * BT * SS;
    const bf16* ot = o_s + stage * BT * SS;
    const float* lt = l_s + stage * BT;
    const float* dt = d_s + stage * BT;
    const bool ragged = q0 + BT > sq;  // only the last tile masks queries
#pragma unroll
    for (int qq = 0; qq < BT / 16; ++qq) {
      // S^T and dP^T of the warp's 16 keys against queries qq*16 .. + 16:
      // rows are keys g, g + 8; columns queries hh*8 + 2t (+1)
      float s[2][4], dp[2][4];
      scores16<KD, SS>(qt + qq * 16 * SS, lane, kf, s);
      scores16<KD, SS>(ot + qq * 16 * SS, lane, vf, dp);
      unsigned pa[4], da[4];  // bf16(p^T) and bf16(ds^T): A fragments
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c = qq * 16 + hh * 8 + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(lt + c);
        const float2 d2 = *reinterpret_cast<const float2*>(dt + c);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float p0 = exp2f(s[hh][2 * r] - l2.x);
          float p1 = exp2f(s[hh][2 * r + 1] - l2.y);
          if (ragged) {  // queries past Sq (zero-filled rows) add 0
            p0 = q0 + c < sq ? p0 : 0.f;
            p1 = q0 + c + 1 < sq ? p1 : 0.f;
          }
          pa[hh * 2 + r] = pack_bf16(p0, p1);
          da[hh * 2 + r] = pack_bf16(p0 * (dp[hh][2 * r] - d2.x), p1 * (dp[hh][2 * r + 1] - d2.y));
        }
      }
      accumulate16<NO, SS>(ot + qq * 16 * SS, lane, pa, acc_v);
      accumulate16<NO, SS>(qt + qq * 16 * SS, lane, da, acc_k);
    }
    __syncthreads();  // tile j's stage is free for tile j + 2
  }

  const size_t base = size_t(bh) * sk * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + warp * 16 + g + 8 * r;
    if (row >= sk) continue;
#pragma unroll
    for (int nn = 0; nn < NO; ++nn) {
      const size_t o = base + size_t(row) * D + nn * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dk + o) =
          __floats2bfloat162_rn(acc_k[nn][2 * r] * scale, acc_k[nn][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + o) =
          __floats2bfloat162_rn(acc_v[nn][2 * r], acc_v[nn][2 * r + 1]);
    }
  }
}

// D = 512, the VAE's mid-block attention (the design note at the head of
// this file).  BR own rows, BT streamed rows a tile, NW warps; score jobs of
// 16 own rows by JN streamed rows over 512 / KS of the contraction.
template <int BR, int BT, int NW, int JN, int KS>
struct Bwd512 {
  static constexpr int D = 512;
  static constexpr int kBR = BR, kBT = BT, kJN = JN, kKS = KS;
  static constexpr int NTH = 32 * NW;
  static constexpr int SS = D + 8;             // staged row stride (elements): 1040 bytes
  static constexpr int CH = D / 8;             // 16-byte chunks of a row
  static constexpr int MR = BR / 16;           // own m-tiles
  static constexpr int NJ = BT / JN;           // job columns of a tile
  static constexpr int KN = D / 16 / KS;       // k-steps of a job
  static constexpr int JOBS = 2 * MR * NJ * KS;  // both products
  static constexpr int NO = D / NW / 8;        // output n-tiles of a warp
  static constexpr int GS = BT + 8;            // row stride of the [BR][BT] grids (elements)
  static_assert(BR % 16 == 0 && BT % JN == 0 && JN % 16 == 0 && NO % 2 == 0 &&
                    (D / 16) % KS == 0,
                "tile does not fit the mma shapes");

  // the own side's two staged operands, the ring of two streamed operands,
  // `grids` bf16 [BR][GS] grids, 2 * KS float [BR][GS] partial grids and
  // `floats` floats; every part a multiple of 16 bytes
  static constexpr size_t smem_bytes(int grids, int floats) {
    return sizeof(bf16) * ((2 * size_t(BR) + 2 * size_t(kStages) * BT) * SS +
                           size_t(grids) * BR * GS) +
           sizeof(float) * (2 * size_t(KS) * BR * GS + floats);
  }
};

// c = a b^T over KN k-steps: a's 16 rows at `a`, b's 16 * NP rows at `b`,
// both [rows][SS] bf16 in shared memory and both by ldmatrix (c[n]: the
// columns n * 8 .. n * 8 + 8 of b's rows)
template <int KN, int NP, int SS>
__device__ __forceinline__ void scores_ab(const bf16* a, const bf16* b, int lane,
                                          float (&c)[2 * NP][4]) {
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
  const bf16* ar = a + (lane & 15) * SS + (lane >> 4) * 8;
  const bf16* br = b + ((lane & 7) + (lane >> 4) * 8) * SS + ((lane >> 3) & 1) * 8;
#pragma unroll 4
  for (int kk = 0; kk < KN; ++kk) {
    unsigned af[4];
    ldsm_x4(smem_u32(ar + kk * 16), af);
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      unsigned bf[4];
      ldsm_x4(smem_u32(br + np * 16 * SS + kk * 16), bf);
      mma_bf16(c[2 * np], af, bf[0], bf[1]);
      mma_bf16(c[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// The score grid of one streamed tile, both products, as partial sums:
// job i of the block's JOBS (dealt to the warps in turn) contracts the 16 own
// rows of its m-tile against JN streamed rows over its 512 / KS of the
// contraction and writes the sums into partial grid (product * KS + part).
// Product 0 is a1 b1^T (the scores), 1 a2 b2^T (dp).
template <class C>
__device__ __forceinline__ void score_grid(const bf16* a1, const bf16* b1, const bf16* a2,
                                           const bf16* b2, float* part, int warp, int lane) {
  constexpr int SS = C::SS, GS = C::GS, JN = C::kJN, KN = C::KN;
  const int g = lane >> 2, t = lane & 3;
  for (int job = warp; job < C::JOBS; job += C::NTH / 32) {
    const int kp = job % C::kKS, mi = (job / C::kKS) % C::MR,
              nj = (job / (C::kKS * C::MR)) % C::NJ, prod = job / (C::kKS * C::MR * C::NJ);
    const int k0 = kp * KN * 16;
    float c[JN / 8][4];
    scores_ab<KN, JN / 16, SS>((prod ? a2 : a1) + mi * 16 * SS + k0,
                               (prod ? b2 : b1) + nj * JN * SS + k0, lane, c);
    float* gp = part + (prod * C::kKS + kp) * C::kBR * GS + (mi * 16 + g) * GS + nj * JN + 2 * t;
#pragma unroll
    for (int n = 0; n < JN / 8; ++n) {
      *reinterpret_cast<float2*>(gp + n * 8) = make_float2(c[n][0], c[n][1]);
      *reinterpret_cast<float2*>(gp + 8 * GS + n * 8) = make_float2(c[n][2], c[n][3]);
    }
  }
}

// The partial sums of element (r, c .. c + 1) of product `prod`: part 0,
// then part 1 added to it (KS = 2)
template <class C>
__device__ __forceinline__ float2 summed(const float* part, int prod, int r, int c) {
  float2 x = *reinterpret_cast<const float2*>(part + prod * C::kKS * C::kBR * C::GS +
                                              r * C::GS + c);
#pragma unroll
  for (int kp = 1; kp < C::kKS; ++kp) {
    const float2 y = *reinterpret_cast<const float2*>(
        part + (prod * C::kKS + kp) * C::kBR * C::GS + r * C::GS + c);
    x.x += y.x;
    x.y += y.y;
  }
  return x;
}

// acc[mi][n] += a b over one streamed tile for the warp's output columns:
// a the bf16 [BR][GS] grid (own rows by streamed rows) by ldmatrix, b the
// streamed tile's [BT][SS] rows from column c0 by ldmatrix.trans
template <class C>
__device__ __forceinline__ void accumulate_tile(const bf16* a_grid, const bf16* tile, int c0,
                                                int lane, float (&acc)[C::MR][C::NO][4]) {
  constexpr int MR = C::MR, NO = C::NO, SS = C::SS, GS = C::GS;
#pragma unroll
  for (int kk = 0; kk < C::kBT / 16; ++kk) {
    unsigned a[MR][4];
#pragma unroll
    for (int mi = 0; mi < MR; ++mi)
      ldsm_x4(smem_u32(a_grid + (mi * 16 + (lane & 15)) * GS + kk * 16 + (lane >> 4) * 8), a[mi]);
    const bf16* row = tile + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * SS + c0;
#pragma unroll
    for (int np = 0; np < NO / 2; ++np) {
      unsigned b[4];
      ldsm_x4_t(smem_u32(row + np * 16 + (lane >> 4) * 8), b);
#pragma unroll
      for (int mi = 0; mi < MR; ++mi) {
        mma_bf16(acc[mi][2 * np], a[mi], b[0], b[1]);
        mma_bf16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

// dq at D = 512: a block owns BR queries of one (batch, head) and streams key
// tiles.
template <int BR, int BT, int NW, int JN, int KS, int MINB>
__global__ void __launch_bounds__(32 * NW, MINB)
flash_bwd_dq512_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dq, int sq, int sk, float cscale, float scale) {
  using C = Bwd512<BR, BT, NW, JN, KS>;
  constexpr int D = C::D, SS = C::SS, CH = C::CH, MR = C::MR, NO = C::NO, GS = C::GS,
                NTH = C::NTH;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs_s = reinterpret_cast<bf16*>(smem_raw);         // [BR][SS] qs
  bf16* do_s = qs_s + BR * SS;                             // [BR][SS] dO
  bf16* k_s = do_s + BR * SS;                              // [kStages][BT][SS]
  bf16* v_s = k_s + kStages * BT * SS;                     // [kStages][BT][SS]
  bf16* ds_s = v_s + kStages * BT * SS;                    // [BR][GS] bf16(ds)
  float* part = reinterpret_cast<float*>(ds_s + BR * GS);  // [2][KS][BR][GS] s, dp
  float* l_s = part + 2 * KS * BR * GS;                    // [BR] lse2 of the own rows
  float* dl_s = l_s + BR;                                  // [BR] delta

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * BR, c0 = warp * (D / NW);
  const bf16* kg = k + size_t(bh) * sk * D;
  const bf16* vg = v + size_t(bh) * sk * D;

  // qs = q * c rounded to bf16, c itself rounded first, as the TPU kernel;
  // a padded query row takes lse2 = delta = 0 and is never stored
  stage_own<D, D, SS, NTH>(qs_s, do_s, q + size_t(bh) * sq * D, dout + size_t(bh) * sq * D,
                           q0, BR, sq, __bfloat162float(__float2bfloat16(cscale)));
  for (int r = tid; r < BR; r += NTH) {
    const bool ok = q0 + r < sq;
    l_s[r] = ok ? lse[size_t(bh) * sq + q0 + r] : 0.f;
    dl_s[r] = ok ? delta[size_t(bh) * sq + q0 + r] : 0.f;
  }
  float acc[MR][NO][4];
#pragma unroll
  for (int mi = 0; mi < MR; ++mi)
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;

  auto load_tile = [&](int k0, int stage) {
    bf16* kd = k_s + stage * BT * SS;
    bf16* vd = v_s + stage * BT * SS;
    for (int e = tid; e < BT * CH; e += NTH) {
      const int r = e / CH, c = e - r * CH;
      const bool ok = k0 + r < sk;
      const size_t src = size_t(ok ? k0 + r : 0) * D + c * 8;
      cp_async_16(smem_u32(kd + r * SS + c * 8), kg + src, ok);
      cp_async_16(smem_u32(vd + r * SS + c * 8), vg + src, ok);
    }
    cp_async_commit();
  };

  const int n = (sk + BT - 1) / BT;
  load_tile(0, 0);
  for (int j = 0; j < n; ++j) {
    if (j + 1 < n) {
      load_tile((j + 1) * BT, (j + 1) % kStages);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and, at j = 0, the staged rows) visible
    const int k0 = j * BT;
    const bf16* kt = k_s + (j % kStages) * BT * SS;
    const bf16* vt = v_s + (j % kStages) * BT * SS;
    score_grid<C>(qs_s, kt, do_s, vt, part, warp, lane);  // S = qs K^T, dP = dO V^T
    __syncthreads();
    // ds = bf16(p (dp - delta)), p = exp2(s - lse2): the TPU kernel's rounding
    const bool ragged = k0 + BT > sk;  // only the last tile masks keys
    for (int e = tid; e < BR * BT / 2; e += NTH) {
      const int r = e / (BT / 2), c = 2 * (e - r * (BT / 2));
      const float2 s = summed<C>(part, 0, r, c), dp = summed<C>(part, 1, r, c);
      float p0 = exp2f(s.x - l_s[r]), p1 = exp2f(s.y - l_s[r]);
      if (ragged) {  // keys past Sk (zero-filled rows) add 0
        p0 = k0 + c < sk ? p0 : 0.f;
        p1 = k0 + c + 1 < sk ? p1 : 0.f;
      }
      *reinterpret_cast<unsigned*>(ds_s + r * GS + c) =
          pack_bf16(p0 * (dp.x - dl_s[r]), p1 * (dp.y - dl_s[r]));
    }
    __syncthreads();
    accumulate_tile<C>(ds_s, kt, c0, lane, acc);  // dQ += dS K, the warp's columns
    __syncthreads();  // tile j's stage and the grids are free
  }

  bf16* og = dq + size_t(bh) * sq * D;
#pragma unroll
  for (int mi = 0; mi < MR; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + mi * 16 + g + 8 * r;
      if (row >= sq) continue;
#pragma unroll
      for (int nn = 0; nn < NO; ++nn)
        *reinterpret_cast<__nv_bfloat162*>(og + size_t(row) * D + c0 + nn * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[mi][nn][2 * r] * scale, acc[mi][nn][2 * r + 1] * scale);
    }
}

// dk, dv at D = 512: a block owns BR keys of one (batch, head) and streams
// query tiles with their lse2 and delta.
template <int BR, int BT, int NW, int JN, int KS, int MINB>
__global__ void __launch_bounds__(32 * NW, MINB)
flash_bwd_dkv512_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk,
                        float cscale, float scale) {
  using C = Bwd512<BR, BT, NW, JN, KS>;
  constexpr int D = C::D, SS = C::SS, CH = C::CH, MR = C::MR, NO = C::NO, GS = C::GS,
                NTH = C::NTH;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks_s = reinterpret_cast<bf16*>(smem_raw);         // [BR][SS] ks
  bf16* v_s = ks_s + BR * SS;                              // [BR][SS] V
  bf16* q_s = v_s + BR * SS;                               // [kStages][BT][SS]
  bf16* o_s = q_s + kStages * BT * SS;                     // [kStages][BT][SS] dO
  bf16* ds_s = o_s + kStages * BT * SS;                    // [BR][GS] bf16(ds^T)
  bf16* p_s = ds_s + BR * GS;                              // [BR][GS] bf16(p^T)
  float* part = reinterpret_cast<float*>(p_s + BR * GS);   // [2][KS][BR][GS] s^T, dp^T
  float* l_s = part + 2 * KS * BR * GS;                    // [kStages][BT] lse2
  float* d_s = l_s + kStages * BT;                         // [kStages][BT] delta

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, k0 = blockIdx.x * BR, c0 = warp * (D / NW);
  const bf16* qg = q + size_t(bh) * sq * D;
  const bf16* og = dout + size_t(bh) * sq * D;
  const float* lg = lse + size_t(bh) * sq;
  const float* dg = delta + size_t(bh) * sq;

  // ks = k * c rounded to bf16, c itself rounded first, as the TPU kernel
  stage_own<D, D, SS, NTH>(ks_s, v_s, k + size_t(bh) * sk * D, v + size_t(bh) * sk * D, k0, BR,
                           sk, __bfloat162float(__float2bfloat16(cscale)));
  float acc_k[MR][NO][4], acc_v[MR][NO][4];
#pragma unroll
  for (int mi = 0; mi < MR; ++mi)
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[mi][n][e] = acc_v[mi][n][e] = 0.f;

  auto load_tile = [&](int q0, int stage) {
    bf16* qd = q_s + stage * BT * SS;
    bf16* od = o_s + stage * BT * SS;
    for (int e = tid; e < BT * CH; e += NTH) {
      const int r = e / CH, c = e - r * CH;
      const bool ok = q0 + r < sq;
      const size_t src = size_t(ok ? q0 + r : 0) * D + c * 8;
      cp_async_16(smem_u32(qd + r * SS + c * 8), qg + src, ok);
      cp_async_16(smem_u32(od + r * SS + c * 8), og + src, ok);
    }
    for (int r = tid; r < BT; r += NTH) {
      const bool ok = q0 + r < sq;
      const int row = ok ? q0 + r : 0;
      cp_async_4(smem_u32(l_s + stage * BT + r), lg + row, ok);
      cp_async_4(smem_u32(d_s + stage * BT + r), dg + row, ok);
    }
    cp_async_commit();
  };

  const int n = (sq + BT - 1) / BT;
  load_tile(0, 0);
  for (int j = 0; j < n; ++j) {
    if (j + 1 < n) {
      load_tile((j + 1) * BT, (j + 1) % kStages);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and, at j = 0, the staged rows) visible
    const int q0 = j * BT, stage = j % kStages;
    const bf16* qt = q_s + stage * BT * SS;
    const bf16* ot = o_s + stage * BT * SS;
    score_grid<C>(ks_s, qt, v_s, ot, part, warp, lane);  // S^T = ks Q^T, dP^T = V dO^T
    __syncthreads();
    // p^T = exp2(s^T - lse2) and ds^T = p^T (dp^T - delta), each rounded to
    // bf16 for its product, as the TPU kernel rounds them
    const bool ragged = q0 + BT > sq;  // only the last tile masks queries
    const float* lt = l_s + stage * BT;
    const float* dt = d_s + stage * BT;
    for (int e = tid; e < BR * BT / 2; e += NTH) {
      const int r = e / (BT / 2), c = 2 * (e - r * (BT / 2));
      const float2 s = summed<C>(part, 0, r, c), dp = summed<C>(part, 1, r, c);
      float p0 = exp2f(s.x - lt[c]), p1 = exp2f(s.y - lt[c + 1]);
      if (ragged) {  // queries past Sq (zero-filled rows) add 0
        p0 = q0 + c < sq ? p0 : 0.f;
        p1 = q0 + c + 1 < sq ? p1 : 0.f;
      }
      *reinterpret_cast<unsigned*>(p_s + r * GS + c) = pack_bf16(p0, p1);
      *reinterpret_cast<unsigned*>(ds_s + r * GS + c) =
          pack_bf16(p0 * (dp.x - dt[c]), p1 * (dp.y - dt[c + 1]));
    }
    __syncthreads();
    accumulate_tile<C>(p_s, ot, c0, lane, acc_v);   // dV += P^T dO
    accumulate_tile<C>(ds_s, qt, c0, lane, acc_k);  // dK += dS^T Q
    __syncthreads();  // tile j's stage and the grids are free
  }

  const size_t base = size_t(bh) * sk * D;
#pragma unroll
  for (int mi = 0; mi < MR; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = k0 + mi * 16 + g + 8 * r;
      if (row >= sk) continue;
#pragma unroll
      for (int nn = 0; nn < NO; ++nn) {
        const size_t o = base + size_t(row) * D + c0 + nn * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(dk + o) = __floats2bfloat162_rn(
            acc_k[mi][nn][2 * r] * scale, acc_k[mi][nn][2 * r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + o) =
            __floats2bfloat162_rn(acc_v[mi][nn][2 * r], acc_v[mi][nn][2 * r + 1]);
      }
    }
}

// c = 1/sqrt(d) * log2(e) and scale = 1/sqrt(d), in double, then rounded
struct Scales {
  float c, scale;
};
Scales scales_for(int d) {
  const double s = 1.0 / sqrt(double(d));
  return Scales{float(s * 1.4426950408889634), float(s)};
}

template <int D, int WR, int BT, int MINB>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, int bh, int sq, int sk,
                      cudaStream_t stream) {
  using C = BwdTc<D, WR, BT, MINB>;
  auto kernel = flash_bwd_dq_tc_kernel<D, WR, BT, MINB>;
  const int smem = int(C::tiles_bytes());
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const Scales sc = scales_for(D);
  const dim3 grid((sq + C::BR - 1) / C::BR, bh);
  kernel<<<grid, C::kThreadsTc, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), sq, sk, sc.c,
      sc.scale);
  return cudaGetLastError();
}

template <int D, int WR, int BT, int MINB>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv, int bh,
                       int sq, int sk, cudaStream_t stream) {
  using C = BwdTc<D, WR, BT, MINB>;
  auto kernel = flash_bwd_dkv_tc_kernel<D, WR, BT, MINB>;
  const int smem = int(C::tiles_bytes() + sizeof(float) * 2 * kStages * BT);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const Scales sc = scales_for(D);
  const dim3 grid((sk + C::BR - 1) / C::BR, bh);
  kernel<<<grid, C::kThreadsTc, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      sq, sk, sc.c, sc.scale);
  return cudaGetLastError();
}

template <int BR, int BT, int NW, int JN, int KS, int MINB>
cudaError_t launch_dq512(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, void* dq, int bh, int sq, int sk,
                         cudaStream_t stream) {
  using C = Bwd512<BR, BT, NW, JN, KS>;
  auto kernel = flash_bwd_dq512_kernel<BR, BT, NW, JN, KS, MINB>;
  const int smem = int(C::smem_bytes(1, 2 * BR));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const Scales sc = scales_for(C::D);
  const dim3 grid((sq + BR - 1) / BR, bh);
  kernel<<<grid, C::NTH, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), sq, sk, sc.c,
      sc.scale);
  return cudaGetLastError();
}

template <int BR, int BT, int NW, int JN, int KS, int MINB>
cudaError_t launch_dkv512(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dk, void* dv, int bh,
                          int sq, int sk, cudaStream_t stream) {
  using C = Bwd512<BR, BT, NW, JN, KS>;
  auto kernel = flash_bwd_dkv512_kernel<BR, BT, NW, JN, KS, MINB>;
  const int smem = int(C::smem_bytes(2, 2 * kStages * BT));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const Scales sc = scales_for(C::D);
  const dim3 grid((sk + BR - 1) / BR, bh);
  kernel<<<grid, C::NTH, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      sq, sk, sc.c, sc.scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

bool takes(int bh, int sq, int sk, int d, int dtype) {
  return dtype == 1 && bh >= 1 && bh <= 65535 && sq >= 1 && sk >= 1 &&
         (d == 40 || d == 80 || d == 512);
}

}  // namespace

// Plain C entry points for ctypes, arguments as flash_attention_bwd.cu's;
// dtype must be 1 (bfloat16) and d 40, 80 or 512.  Each returns 0 on success, a
// cudaError_t code from the launch, or -1 for arguments the kernel does not
// take.

// Row 4 in bf16: dq.  Tiles (WR warps, BT streamed rows, MINB): 4 warps (64
// queries); 64-key tiles at D = 40, 128 at D = 80.  D = 512 (BR own rows, BT
// streamed rows, NW warps, JN, KS, MINB): 32 queries, 32-key tiles, 8 warps.
extern "C" int hedit_flash_attention_bwd_dq_tc(const void* q, const void* k, const void* v,
                                               const void* dout, const void* lse,
                                               const void* delta, void* dq, int bh, int sq,
                                               int sk, int d, int dtype, void* stream) {
  if (!takes(bh, sq, sk, d, dtype)) return -1;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(dq))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (d == 512)
    return int(launch_dq512<32, 32, 8, 32, 2, 1>(q, k, v, dout, l, dl, dq, bh, sq, sk, s));
  return int(d == 40 ? launch_dq<40, 4, 64, 4>(q, k, v, dout, l, dl, dq, bh, sq, sk, s)
                     : launch_dq<80, 4, 128, 2>(q, k, v, dout, l, dl, dq, bh, sq, sk, s));
}

// Row 5 in bf16: dk and dv.  Tiles: 4 warps (64 keys); 64-query tiles at
// D = 40, 128 at D = 80; at D = 512 32 keys, 32-query tiles, 8 warps.
extern "C" int hedit_flash_attention_bwd_dkv_tc(const void* q, const void* k, const void* v,
                                                const void* dout, const void* lse,
                                                const void* delta, void* dk, void* dv, int bh,
                                                int sq, int sk, int d, int dtype,
                                                void* stream) {
  if (!takes(bh, sq, sk, d, dtype)) return -1;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(dk) ||
      !aligned16(dv))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (d == 512)
    return int(launch_dkv512<32, 32, 8, 32, 2, 1>(q, k, v, dout, l, dl, dk, dv, bh, sq, sk, s));
  return int(d == 40 ? launch_dkv<40, 4, 64, 4>(q, k, v, dout, l, dl, dk, dv, bh, sq, sk, s)
                     : launch_dkv<80, 4, 128, 2>(q, k, v, dout, l, dl, dk, dv, bh, sq, sk, s));
}
