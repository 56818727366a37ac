// The flash-attention backward in float32 on Hopper's CUDA cores (sm_90a), at
// the UNet's head dims 40 and 80: dq, dk and dv of out = softmax(q k^T /
// sqrt(d)) v from the forward's base-2 log-sum-exp, in ONE launch.  Every
// product is a float32 FMA: no TF32 in any form.
//
// Replaces, for float32 inputs at d = 40 and 80 (the CLIs' default
// precision), the two TPU kernels of hedit_tpu/ops/flash_attention.py
//   row 4: _flash_bwd_dq_kernel (:553), one program per query block;
//   row 5: _flash_bwd_dkv_kernel (:593), one program per key block;
// wrapper _flash_bwd_pallas (:648), the backward of flash_attention_diff:
// every gradient call of an NMG-type mode at the UNet's 4096-token level.
// Entry point hedit_flash_attention_bwd_f32, wrapper flash_bwd_f32_cuda
// (ops/flash_attention.py, chosen by bwd_entry).  bf16 at d = 40 / 80 runs
// on the tensor cores (flash_attention_bwd_tc.cu); d = 512 in either dtype
// on the CUDA-core template (flash_attention_bwd.cu).
//
// The function, as flash_attention_backward_reference computes it in
// float32: with lse2 the forward's base-2 log-sum-exp of each query and
// delta = rowsum(dO * out) (computed outside, as the JAX package does),
//   p = exp2(q k^T * scale * log2(e) - lse2),  dp = dO v^T,
//   ds = p * (dp - delta),
//   dq = ds k * scale,  dk = ds^T q * scale,  dv = p^T dO.
// Keys at or past Sk give p = 0 in dq, queries at or past Sq p = 0 in dk and
// dv.  scale * log2(e) is applied to each score after its product, and scale
// to each key block's dq partial: that changes only the rounding order.
//
// Why one kernel where JAX has two.  On the TPU each program keeps one side
// resident in VMEM and walks the other, so dq (s, dp, ds k) and dk / dv (s,
// dp, p^T dO, ds^T q) each rebuild the score grid: 7 products of Sq x Sk x D
// per (batch, head) where the function needs 5.  On the card the grid's
// blocks run at once and can add into one dq: a block owns a key tile,
// forms s^T and dp^T once per (query, key) pair and feeds all three
// gradients from them (FlashAttention-2's backward), 10 B H Sq Sk D FLOP in
// all against the two kernels' 14.
//
// Run to run.  dk and dv have one writer each (the block that owns the keys)
// and sum in a fixed order: two launches give the same bits.  dq sums the
// key blocks' partials with atomic adds in the order the blocks happen to
// run, so only dq's last bits may change from launch to launch.  Each dq
// element is a float32 sum of Sk / 64 partials; reordering it moves the
// result by a few float32 ulps of the partials' magnitudes (~1e-6 of the
// largest element at 64 partials), two orders below the 1e-4 relative
// tolerance (F32_TOL) that holds the kernel to its plain version.
//
// What bounds it on the H100.  10 B H Sq Sk D FLOP of float32 FMAs against
// 4 bytes an element of q, k, v, dO, dq, dk, dv: at [1, 8, 4096, 40] 53.7
// GFLOP against 9 MB, far above the balance point, so the bound is the FP32
// rate (67 TFLOP/s at 700 W: 0.801 ms).  The CUDA-core template
// (flash_attention_bwd.cu) reached 23% of it there, for four reasons this
// kernel answers:
//
// 1. Five products, not seven (above).
// 2. Register tiles fed by 128-bit shared-memory loads, every operand of a
//    product stored with its contraction (or, for the score products, its
//    output rows) along the minor dim.  Shared memory delivers 32 lanes x
//    4 bytes a clock to an SM's 128 FMA lanes, so the FMAs a float read
//    cap the rate: s^T, dp^T: 4 keys x AQ queries a thread as outer
//    products over d from K^T, V^T, Q^T, dO^T [D][rows + 4] (2.7 FMAs a
//    float at AQ = 8); dV, dK: CK keys x CC columns a thread, dot products
//    over the query tile from p^T, ds^T [keys][queries] and Q^T, dO^T (3.1
//    at d = 40: 8 x 5, the tile split over two query halves added once at
//    the end); dq: DQ queries x 5 columns from ds [queries][keys] and K^T
//    (3.1 at d = 40, two key halves).  p^T and ds^T pass through shared
//    memory once each, ds once more key-minor for the dq product, with its
//    16-byte slots XOR-swizzled by query so the stores hit distinct banks.
// 3. Asynchronous copies.  K^T and V^T are copied once a block; each query
//    tile's Q^T, dO^T, lse2 and delta by cp.async, issued as soon as the
//    previous tile's dV / dK products are done with them, so they land
//    while the dq product and the other resident block compute.  The
//    transposed copies move 4 bytes a lane, a warp's 32 lanes 4 rows x 8
//    consecutive columns (4 sectors read, 32 distinct banks written).  Two
//    full Q / dO stages would not leave two blocks an SM.
// 4. Whole waves.  64-key blocks: [1, 8, 4096, 40] gives 512 blocks, 2 an
//    SM (93 KB of shared memory each at d = 40), 1.94 waves of 264; the
//    template's 3 an SM made 1.29.
// The dq partials of a query tile (two key halves at d = 40) are added
// through shared memory and then into dq with 16-byte atomic adds
// (atomicAdd on float4, sm_90), which the wrapper's launch zeroes first.
//
// Block: 128 threads.  Phase A (s^T, dp^T): thread (kg = tid / 8, qg = tid
// % 8) owns keys 4 kg + i and queries 4 qg + 32 h + c.  Phase C (dV, dK):
// columns lc + 8 m (lc = tid % 8), keys CK kc + i, queries of split hc.
// Phase D (dq): columns ld + NLD m (ld = tid % NLD), queries DQ qd + i,
// keys of split hd.
//
// Contract: float32 (dtype 0) only; D one of 40, 80; q, dO [BH, Sq, D], k,
// v [BH, Sk, D], lse2 and delta [BH, Sq], dq, dk, dv like q, k, v; all
// contiguous; any Sq, Sk >= 1; every pointer of q, k, v, dO, dq, dk and dv
// 16-byte aligned.  Anything else returns -1.

#include <climits>
#include <cmath>

#include "flash_common.cuh"
#include "flash_mma.cuh"

// query rows of a tile at each head dim, and blocks an SM the compiler
// budgets registers for (the tile probe builds other values with -D)
#ifndef BWD_F32_BQ_40
#define BWD_F32_BQ_40 64
#endif
#ifndef BWD_F32_BQ_80
#define BWD_F32_BQ_80 32
#endif
#ifndef BWD_F32_MINB_40
#define BWD_F32_MINB_40 2
#endif
#ifndef BWD_F32_MINB_80
#define BWD_F32_MINB_80 2
#endif
// the unroll factor of the products' loops
#ifndef BWD_F32_UNROLL
#define BWD_F32_UNROLL 2
#endif
// a timing ablation of the tile probe only (dq left at zero): 1 adds no dq
// partial into dq
#ifndef BWD_F32_ABLATE
#define BWD_F32_ABLATE 0
#endif

namespace {

constexpr int kBwdThreads = 128;
constexpr int kKeys = 64;     // keys a block owns
constexpr int kUnroll = BWD_F32_UNROLL;

template <int D, int BQ>
struct BwdF32Tile {
  static_assert(D == 40 || D == 80, "the float32 backward takes d = 40 and 80");
  static_assert(BQ == 32 || BQ == 64, "query tiles of 32 or 64 rows");
  static constexpr int KS = kKeys + 4;           // K^T, V^T rows: 8 rows on 8 bank groups
  static constexpr int QS = BQ + 4;              // Q^T, dO^T rows
  static constexpr int AQ = BQ / 8;              // phase A: queries a thread
  static constexpr int CK = D == 40 ? 8 : 4;     // phase C: keys a thread
  static constexpr int CC = D / 8;               // phase C: columns a thread
  static constexpr int CS = 16 / (kKeys / CK);   // phase C: splits of the query tile
  static constexpr int NLD = D / 5;              // phase D: column lanes (5 columns each)
  static constexpr int DQ = BQ / 8;              // phase D: queries a thread
  static constexpr int DS = 16 / NLD;            // phase D: splits of the key tile
  static constexpr int DQS = D + 4;              // dq partial rows
  // K^T, V^T, Q^T, dO^T, lse2 and delta, p^T, ds^T, ds
  static constexpr int SMEM_FLOATS = 2 * D * KS + 2 * D * QS + 2 * BQ + 3 * kKeys * BQ;
  static_assert(DS * DQS <= 2 * kKeys, "the dq partials fit p^T and ds^T");
  static_assert((CS - 1) * 2 * D <= 3 * BQ, "the dK / dV partials fit the score tiles");
  static_assert((BQ / CS) % 4 == 0 && (kKeys / DS) % 4 == 0, "float4 steps");
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
// acc + a . b over the four lanes, in order
__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// dst[c][r] (row stride S) <- src[r][c] for rows r < R of a [*, D] image,
// rows at or past `valid` zero-filled; 4-byte cp.async copies, a warp's 32
// lanes 4 rows x 8 consecutive columns
template <int D, int R, int S>
__device__ __forceinline__ void load_t(float* dst, const float* src, int valid, int lane,
                                       int warp) {
  const int c0 = lane & 7, r0 = (lane >> 3) + 4 * warp;
#pragma unroll
  for (int rr = 0; rr < R; rr += 16) {
    const int r = r0 + rr;
    const bool ok = r < valid;
    const float* s = src + (ok ? r * D : 0) + c0;
    const unsigned d0 = smem_u32(dst + c0 * S + r);
#pragma unroll
    for (int c = 0; c < D; c += 8) cp_async_4(d0 + 4 * c * S, s + c, ok);
  }
}

template <int D, int BQ, int MINB>
__global__ void __launch_bounds__(kBwdThreads, MINB)
flash_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                     int sq, int sk, float c2, float scale) {
  using Cfg = BwdF32Tile<D, BQ>;
  constexpr int KS = Cfg::KS, QS = Cfg::QS, AQ = Cfg::AQ, CK = Cfg::CK, CC = Cfg::CC,
                CS = Cfg::CS, NLD = Cfg::NLD, DQ = Cfg::DQ, DS = Cfg::DS, DQS = Cfg::DQS;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                  // K^T [D][KS]
  float* vt = kt + D * KS;           // V^T [D][KS]
  float* qt = vt + D * KS;           // Q^T [D][QS] of the query tile
  float* ot = qt + D * QS;           // dO^T [D][QS]
  float* lse_s = ot + D * QS;        // lse2 [BQ], then delta [BQ]
  float* pt = lse_s + 2 * BQ;        // p^T [kKeys][BQ]
  float* dst = pt + kKeys * BQ;      // ds^T [kKeys][BQ]
  float* dsq = dst + kKeys * BQ;     // ds [BQ][kKeys], 16-byte slots swizzled by query
  float* dq_s = pt;                  // [DS][BQ][DQS] dq partials, once p^T, ds^T are read
  float* red_s = pt;                 // [CS - 1][2][kKeys][D] dK, dV partials, at the end

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, k0 = blockIdx.x * kKeys;
  const float* qg = q + size_t(bh) * sq * D;
  const float* og = dout + size_t(bh) * sq * D;
  const float* lg = lse + size_t(bh) * sq;
  const float* dg = delta + size_t(bh) * sq;

  // the query tile at q0: Q^T, dO^T, lse2, delta
  auto fetch = [&](int q0) {
    load_t<D, BQ, QS>(qt, qg + size_t(q0) * D, sq - q0, lane, warp);
    load_t<D, BQ, QS>(ot, og + size_t(q0) * D, sq - q0, lane, warp);
    if (tid < 2 * BQ) {
      const int r = tid < BQ ? tid : tid - BQ;
      const bool ok = q0 + r < sq;
      cp_async_4(smem_u32(lse_s + tid), (tid < BQ ? lg : dg) + (ok ? q0 + r : 0), ok);
    }
    cp_async_commit();
  };
  load_t<D, kKeys, KS>(kt, k + (size_t(bh) * sk + k0) * D, sk - k0, lane, warp);
  load_t<D, kKeys, KS>(vt, v + (size_t(bh) * sk + k0) * D, sk - k0, lane, warp);
  fetch(0);

  const int kg = tid >> 3, qg4 = tid & 7;                  // phase A
  const int lc = tid & 7, kc = (tid >> 3) % (kKeys / CK);  // phase C
  const int hc = (tid >> 3) / (kKeys / CK);
  const int ld = tid % NLD, qd = (tid / NLD) & 7;          // phase D
  const int hd = tid / (NLD * 8);

  float acc_v[CK][CC], acc_k[CK][CC];
#pragma unroll
  for (int i = 0; i < CK; ++i)
#pragma unroll
    for (int m = 0; m < CC; ++m) acc_v[i][m] = acc_k[i][m] = 0.f;

  const int nq = (sq + BQ - 1) / BQ;
  for (int t = 0; t < nq; ++t) {
    const int q0 = t * BQ;
    cp_async_wait<0>();
    __syncthreads();  // the tile landed; the last tile's dq partials are read

    // A: s^T = K Q^T and dp^T = V dO^T, outer products over d
    float s[4][AQ], dp[4][AQ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < AQ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float4 kv = ld4(kt + c * KS + 4 * kg), vv = ld4(vt + c * KS + 4 * kg);
      const float kr[4] = {kv.x, kv.y, kv.z, kv.w}, vr[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int h = 0; h < AQ / 4; ++h) {
        const float4 qv = ld4(qt + c * QS + 4 * qg4 + 32 * h);
        const float4 ov = ld4(ot + c * QS + 4 * qg4 + 32 * h);
        const float qr[4] = {qv.x, qv.y, qv.z, qv.w}, orow[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[i][4 * h + e] = fmaf(kr[i], qr[e], s[i][4 * h + e]);
            dp[i][4 * h + e] = fmaf(vr[i], orow[e], dp[i][4 * h + e]);
          }
      }
    }

    // B: p and ds, into p^T, ds^T and the key-minor ds
    const bool ragged = q0 + BQ > sq || k0 + kKeys > sk;
#pragma unroll
    for (int j = 0; j < AQ; ++j) {
      const int qj = 4 * qg4 + (j & 3) + 32 * (j >> 2);
      const float l = lse_s[qj], dl = lse_s[BQ + qj];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = exp2f(fmaf(s[i][j], c2, -l));
        // padded keys add nothing to dq, padded queries nothing to dk, dv
        if (ragged && (q0 + qj >= sq || k0 + 4 * kg + i >= sk)) p = 0.f;
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - dl);
      }
      st4(dsq + qj * kKeys + 4 * (kg ^ ((qj >> 2) & 7)), dp[0][j], dp[1][j], dp[2][j],
          dp[3][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < AQ / 4; ++h) {
        const int o = (4 * kg + i) * BQ + 4 * qg4 + 32 * h;
        st4(pt + o, s[i][4 * h], s[i][4 * h + 1], s[i][4 * h + 2], s[i][4 * h + 3]);
        st4(dst + o, dp[i][4 * h], dp[i][4 * h + 1], dp[i][4 * h + 2], dp[i][4 * h + 3]);
      }
    __syncthreads();

    // C: dV += p^T dO and dK += ds^T Q, dot products over this split's queries
    {
      constexpr int QH = BQ / CS;
#pragma unroll kUnroll
      for (int qq = hc * QH; qq < hc * QH + QH; qq += 4) {
        if constexpr (CC <= CK) {
          float4 ov[CC], qv[CC];
#pragma unroll
          for (int m = 0; m < CC; ++m) {
            ov[m] = ld4(ot + (lc + 8 * m) * QS + qq);
            qv[m] = ld4(qt + (lc + 8 * m) * QS + qq);
          }
#pragma unroll
          for (int i = 0; i < CK; ++i) {
            const float4 pv = ld4(pt + (CK * kc + i) * BQ + qq);
            const float4 sv = ld4(dst + (CK * kc + i) * BQ + qq);
#pragma unroll
            for (int m = 0; m < CC; ++m) {
              acc_v[i][m] = dot4(pv, ov[m], acc_v[i][m]);
              acc_k[i][m] = dot4(sv, qv[m], acc_k[i][m]);
            }
          }
        } else {
          float4 pv[CK], sv[CK];
#pragma unroll
          for (int i = 0; i < CK; ++i) {
            pv[i] = ld4(pt + (CK * kc + i) * BQ + qq);
            sv[i] = ld4(dst + (CK * kc + i) * BQ + qq);
          }
#pragma unroll
          for (int m = 0; m < CC; ++m) {
            const float4 ov = ld4(ot + (lc + 8 * m) * QS + qq);
            const float4 qv = ld4(qt + (lc + 8 * m) * QS + qq);
#pragma unroll
            for (int i = 0; i < CK; ++i) {
              acc_v[i][m] = dot4(pv[i], ov, acc_v[i][m]);
              acc_k[i][m] = dot4(sv[i], qv, acc_k[i][m]);
            }
          }
        }
      }
    }
    __syncthreads();  // Q^T, dO^T, p^T and ds^T are read
    if (t + 1 < nq) fetch(q0 + BQ);

    // D: this tile's dq partial, ds K, dot products over this split's keys
    {
      constexpr int KH = kKeys / DS;
      float a[DQ][5];
#pragma unroll
      for (int i = 0; i < DQ; ++i)
#pragma unroll
        for (int m = 0; m < 5; ++m) a[i][m] = 0.f;
#pragma unroll kUnroll
      for (int kk = hd * KH; kk < hd * KH + KH; kk += 4) {
        float4 kv[5];
#pragma unroll
        for (int m = 0; m < 5; ++m) kv[m] = ld4(kt + (ld + NLD * m) * KS + kk);
#pragma unroll
        for (int i = 0; i < DQ; ++i) {
          const int r = DQ * qd + i;
          const float4 x = ld4(dsq + r * kKeys + 4 * ((kk >> 2) ^ ((r >> 2) & 7)));
#pragma unroll
          for (int m = 0; m < 5; ++m) a[i][m] = dot4(x, kv[m], a[i][m]);
        }
      }
#pragma unroll
      for (int i = 0; i < DQ; ++i)
#pragma unroll
        for (int m = 0; m < 5; ++m) dq_s[(hd * BQ + DQ * qd + i) * DQS + ld + NLD * m] = a[i][m];
    }
    __syncthreads();
    // the splits' partials added in order, scaled, and added into dq
    for (int e = tid; e < BQ * D / 4; e += kBwdThreads) {
      const int r = e / (D / 4), c4 = e - r * (D / 4);
      if (q0 + r >= sq) continue;
      float4 x = ld4(dq_s + r * DQS + 4 * c4);
#pragma unroll
      for (int h = 1; h < DS; ++h) {
        const float4 y = ld4(dq_s + (h * BQ + r) * DQS + 4 * c4);
        x.x += y.x, x.y += y.y, x.z += y.z, x.w += y.w;
      }
      x.x *= scale, x.y *= scale, x.z *= scale, x.w *= scale;
      if (BWD_F32_ABLATE != 1)
        atomicAdd(reinterpret_cast<float4*>(dq + (size_t(bh) * sq + q0 + r) * D + 4 * c4), x);
    }
  }

  // dK and dV: the query splits' partials added in split order
  if (CS > 1) {
    __syncthreads();  // the last tile's dq partials are read
    if (hc > 0) {
      float* r = red_s + (hc - 1) * 2 * kKeys * D;
#pragma unroll
      for (int i = 0; i < CK; ++i)
#pragma unroll
        for (int m = 0; m < CC; ++m) {
          r[(CK * kc + i) * D + lc + 8 * m] = acc_k[i][m];
          r[(kKeys + CK * kc + i) * D + lc + 8 * m] = acc_v[i][m];
        }
    }
    __syncthreads();
    if (hc == 0) {
#pragma unroll
      for (int h = 1; h < CS; ++h) {
        const float* r = red_s + (h - 1) * 2 * kKeys * D;
#pragma unroll
        for (int i = 0; i < CK; ++i)
#pragma unroll
          for (int m = 0; m < CC; ++m) {
            acc_k[i][m] += r[(CK * kc + i) * D + lc + 8 * m];
            acc_v[i][m] += r[(kKeys + CK * kc + i) * D + lc + 8 * m];
          }
      }
    }
  }
  if (hc == 0) {
#pragma unroll
    for (int i = 0; i < CK; ++i) {
      const int key = k0 + CK * kc + i;
      if (key >= sk) continue;
      const size_t o = (size_t(bh) * sk + key) * D + lc;
#pragma unroll
      for (int m = 0; m < CC; ++m) {
        dk[o + 8 * m] = acc_k[i][m] * scale;
        dv[o + 8 * m] = acc_v[i][m];
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

template <int D, int BQ, int MINB>
cudaError_t launch_bwd_f32(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq, void* dk, void* dv,
                           int bh, int sq, int sk, cudaStream_t stream) {
  auto kernel = flash_bwd_f32_kernel<D, BQ, MINB>;
  const size_t smem = sizeof(float) * BwdF32Tile<D, BQ>::SMEM_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  // the key blocks add their dq partials into a zeroed dq
  err = cudaMemsetAsync(dq, 0, sizeof(float) * size_t(bh) * sq * D, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((sk + kKeys - 1) / kKeys, bh);
  const double scale = 1.0 / sqrt(double(D));
  kernel<<<grid, kBwdThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), sq, sk, float(scale * 1.4426950408889634), float(scale));
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes, the arguments of flash_attention_bwd.cu's
// two entries in one (dtype must be 0, float32): q, k, v, dO, lse2, delta,
// dq, dk, dv | bh, sq, sk, d, dtype | stream.  Zeroes dq and launches the
// kernel on the stream; returns 0 on success, a cudaError_t code from the
// launch, or -1 for arguments the kernel does not take.
extern "C" int hedit_flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse,
                                             const void* delta, void* dq, void* dk, void* dv,
                                             int bh, int sq, int sk, int d, int dtype,
                                             void* stream) {
  if (dtype != 0 || bh < 1 || bh > 65535 || sq < 1 || sk < 1) return -1;
  if ((long long)sq * d > INT_MAX || (long long)sk * d > INT_MAX) return -1;
  if (lse == nullptr || delta == nullptr) return -1;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) && aligned16(dq) &&
        aligned16(dk) && aligned16(dv)))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 40)
    return int(launch_bwd_f32<40, BWD_F32_BQ_40, BWD_F32_MINB_40>(q, k, v, dout, lse, delta, dq,
                                                                  dk, dv, bh, sq, sk, s));
  if (d == 80)
    return int(launch_bwd_f32<80, BWD_F32_BQ_80, BWD_F32_MINB_80>(q, k, v, dout, lse, delta, dq,
                                                                  dk, dv, bh, sq, sk, s));
  return -1;
}
