// Flash-attention backward in bfloat16 on Hopper's tensor cores (sm_90a):
// dq, dk and dv of out = softmax(q k^T / sqrt(d)) v from the forward's
// base-2 log-sum-exp, in the TPU kernels' arithmetic.
//
// Replaces, for bf16 inputs at the UNet's head dims (40 and 80), the TPU
// kernels hedit_tpu/ops/flash_attention.py:_flash_bwd_dq_kernel (:553) and
// _flash_bwd_dkv_kernel (:593), wrapper _flash_bwd_pallas (:648), the
// backward of flash_attention_diff: every mode that differentiates through
// the UNet (NMG's guidance, null-text, the style reward).  Entry points
// hedit_flash_attention_bwd_dq_tc and hedit_flash_attention_bwd_dkv_tc,
// wrappers flash_bwd_dq_cuda and flash_bwd_dkv_cuda (ops/flash_attention.py,
// which route by bwd_entry).  float32 inputs at D = 40 / 80 go to the fused
// kernel of flash_attention_bwd_f32.cu, the VAE's D = 512 to the CUDA-core
// template of flash_attention_bwd.cu.
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
// Design (FlashAttention-2's backward for mma.sync m16n8k16, without its
// atomics):
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
// Contract: bf16 only (dtype 1), D 40 or 80.  q, dO [BH, Sq, D]; k, v
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

bool aligned16(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

bool takes(int bh, int sq, int sk, int d, int dtype) {
  return dtype == 1 && bh >= 1 && bh <= 65535 && sq >= 1 && sk >= 1 && (d == 40 || d == 80);
}

}  // namespace

// Plain C entry points for ctypes, arguments as flash_attention_bwd.cu's;
// dtype must be 1 (bfloat16) and d 40 or 80.  Each returns 0 on success, a
// cudaError_t code from the launch, or -1 for arguments the kernel does not
// take.

// Row 4 in bf16: dq.  Tiles (WR warps, BT streamed rows, MINB): 4 warps (64
// queries); 64-key tiles at D = 40, 128 at D = 80.
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
  return int(d == 40 ? launch_dq<40, 4, 64, 4>(q, k, v, dout, l, dl, dq, bh, sq, sk, s)
                     : launch_dq<80, 4, 128, 2>(q, k, v, dout, l, dl, dq, bh, sq, sk, s));
}

// Row 5 in bf16: dk and dv.  Tiles: 4 warps (64 keys); 64-query tiles at
// D = 40, 128 at D = 80.
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
  return int(d == 40 ? launch_dkv<40, 4, 64, 4>(q, k, v, dout, l, dl, dk, dv, bh, sq, sk, s)
                     : launch_dkv<80, 4, 128, 2>(q, k, v, dout, l, dl, dk, dv, bh, sq, sk, s));
}
