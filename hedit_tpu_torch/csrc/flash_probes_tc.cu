// The two S-minor bounded flash probes in bfloat16 on Hopper's tensor cores
// (sm_90a), replacing for bf16 inputs the TPU kernels of
// scripts/flash_nhd_variants.py
//   _packed_t_kernel_sminor (:101)      q, k [BH, D, S]; v [BH, S, D]   layout 1
//   _packed_t_kernel_all_sminor (:136)  q, k, v [BH, D, S]              layout 2
// (entry point hedit_flash_packed_t_tc, the arguments of flash_probes.cu's
// hedit_flash_packed_t; wrappers flash_packed_t_sminor_cuda and
// flash_packed_t_all_sminor_cuda in ops/flash_probes.py).  Each writes the
// transposed output [BH, D, Sq], the same memory as the packed transposed
// [B, H*D, Sq] the TPU wrappers return.  float32 inputs, and the row-major
// layout 0 (_packed_t_kernel), stay on the CUDA-core template of
// flash_probes.cu.
//
// The function is the bounded probe's (the head of flash_probes.cu): q *
// scale, the scale rounded to bf16 and the product rounded again; float32
// scores; shift = the row's max over the first `anchor` keys + 16; p =
// exp2(min(s - shift, 100)) rounded to bf16, which feeds both the PV product
// and the row sum; the sum floored at 1.2e-38; the output rounded once.  The
// tensor cores change only the summation order.
//
// What bounds it on the H100.  At the probe's [16, 8, 4096, 40] the work is
// 4 B H S^2 D = 343.6 GFLOP against 168 MB of q, k, v and out, ~2,000 FLOP
// a byte: the bound is the tensor cores' 989 TFLOP/s (0.347 ms).  The
// CUDA-core template reached 24 TFLOP/s here (float32 FMAs, p through shared
// memory, one element a thread a load).
//
// Design: flash_attention_tc.cu's bounded forward (a warp owns 16 query
// rows; d = 40 in blocks of 4 warps, 5 blocks an SM, contracting the scores
// over 48; d = 80 in blocks of 8 warps, 2 an SM; 64-key tiles in a two-stage
// cp.async ring; the score fragments rounded to bf16 pairs are the A
// fragments of PV, so p never leaves registers), with the operands where the
// S-minor layouts put them.  ldmatrix's .trans switch absorbs the layouts:
// - q: the [D, BQ] slab of S-minor q, D runs of BQ contiguous queries, is
//   scaled, rounded and kept as it lies, [DK][BQ + 8]; its A fragments
//   (m = queries, k = d) come by ldmatrix.trans.  Rows D .. DK are the
//   contraction's zero pad.  Read once a block;
// - K (both layouts): [DK][BK + 8] tiles filled by 16-byte cp.async runs of
//   8 contiguous keys; the score product's B operand (k = d, n = keys) comes
//   by ldmatrix.trans: S-minor K is to the scores what row-major V is to
//   the bounded forward's PV product.  Rows D .. DK are zeroed once, never
//   copied into;
// - V, layout 1 ([S, D]): the bounded forward's [BK][DK + 8] tile and
//   ldmatrix.trans;
//   layout 2 ([D, S]): a [D][BK + 8] tile read by plain ldmatrix, since
//   S-minor V is already the col layout of PV's B operand (k = keys, n = d);
// - out: acc / floored sum, rounded to bf16, staged transposed as [D][BQ +
//   8] over q's tile (read only before the prologue), then stored as D runs
//   of BQ contiguous queries, 16 bytes a thread, into out[bh][c][q0 + r].
// Shared rows of BQ + 8, BK + 8 or DK + 8 elements (144, 272, 112 or 176
// bytes) put the eight rows of each 8 x 8 ldmatrix on distinct 16-byte bank
// groups.  The loaders' index math divides only by compile-time constants.
// Sq is a multiple of 64 and the d = 80 block holds 128 rows: the last block
// of an image may hold 64 rows past Sq, read as zeros and never stored.
//
// Contract: bf16 only (dtype 1); layout 1 or 2; D 40 or 80; every operand a
// dense image per (batch, head), 16-byte aligned; Sq and Sk multiples of 64
// (the probes cover whole blocks and mask no key); the anchor a multiple of
// 64 that divides Sk.  Anything else returns -1.

#include <climits>
#include <cmath>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kShiftMargin = 16.f;   // shift = anchor max + 16 (base 2)
constexpr float kSaturate = 100.f;     // p = exp2(min(s - shift, 100))
constexpr float kDenomFloor = 1.2e-38f;
constexpr int kStages = 2;             // K / V ring depth
constexpr int BK = 64;                 // keys a tile; Sk and the anchor are multiples of it
constexpr int KS = BK + 8;             // row stride of the [D][BK] tiles (elements)

// A block of WR warps, 16 query rows each; V S-minor (layout 2) or not.
template <int D, int WR, bool VT>
struct ProbeTile {
  static constexpr int kThreadsTc = 32 * WR;
  static constexpr int BQ = 16 * WR;             // query rows of a block
  static constexpr int DK = (D + 15) / 16 * 16;  // score contraction, zero-padded to k = 16
  static constexpr int QS = BQ + 8;              // row stride of q's [DK][BQ] and out's [D][BQ]
  static constexpr int VS = VT ? KS : DK + 8;    // V: [D][BK] (layout 2) or [BK][D]
  static constexpr int NT = BK / 8;              // score n-tiles of a key tile
  static constexpr int NO = D / 8;               // output n-tiles
  static constexpr int q_elems = DK * QS;
  static constexpr int k_elems = DK * KS;        // one stage
  static constexpr int v_elems = VT ? D * KS : BK * VS;
  static_assert(D % 8 == 0 && BQ % 8 == 0, "tile does not fit the mma shapes");

  static constexpr size_t smem_bytes() {
    return sizeof(bf16) * (size_t(q_elems) + size_t(kStages) * (k_elems + v_elems));
  }
};

template <int D, int WR, int MINB, bool VT>
__global__ void __launch_bounds__(32 * WR, MINB)
flash_probe_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out, int sq, int sk,
                      float qscale, int anchor) {
  using C = ProbeTile<D, WR, VT>;
  constexpr int BQ = C::BQ, DK = C::DK, QS = C::QS, VS = C::VS, NT = C::NT, NO = C::NO,
                NTH = C::kThreadsTc;
  constexpr int QCH = BQ / 8, KCH = BK / 8, CH = D / 8;  // 16-byte chunks of a row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [DK][QS]: (q * scale)^T
  bf16* k_s = q_s + C::q_elems;                   // [kStages][DK][KS]: k^T
  bf16* v_s = k_s + kStages * C::k_elems;         // [kStages] x (v^T [D][KS] or v [BK][VS])
  bf16* o_s = q_s;                                // [D][QS]: the output, staged over q's tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' row group and column pair
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const bf16* qg = q + size_t(bh) * D * sq;
  const bf16* kg = k + size_t(bh) * D * sk;
  const bf16* vg = v + size_t(bh) * D * sk;

  // (q * scale)^T rounded to bf16 (the scale itself rounded first), as the
  // TPU kernel scales q; queries past Sq and the pad rows D .. DK are 0
  const float qsc = __bfloat162float(__float2bfloat16(qscale));
  for (int e = tid; e < DK * QCH; e += NTH) {
    const int c = e / QCH, r = (e - c * QCH) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (c < D && q0 + r < sq) {
      x = *reinterpret_cast<const uint4*>(qg + c * sq + q0 + r);
      bf16* xe = reinterpret_cast<bf16*>(&x);
#pragma unroll
      for (int i = 0; i < 8; ++i) xe[i] = __float2bfloat16(__bfloat162float(xe[i]) * qsc);
    }
    *reinterpret_cast<uint4*>(q_s + c * QS + r) = x;
  }
  // the pad rows D .. DK of every K stage: never copied into, so zeroed once
  if constexpr (DK > D) {
    for (int e = tid; e < kStages * (DK - D) * KCH; e += NTH) {
      const int row = e / KCH, ch = e - row * KCH;  // row over the stages' pad rows
      const int stage = row / (DK - D), c = D + row - stage * (DK - D);
      *reinterpret_cast<uint4*>(k_s + stage * C::k_elems + c * KS + ch * 8) =
          make_uint4(0, 0, 0, 0);
    }
  }

  // keys k0 .. k0 + BK of K (and V) into ring stage `stage`
  auto load_tile = [&](int k0, int stage, bool with_v) {
    bf16* kd = k_s + stage * C::k_elems;
    for (int e = tid; e < D * KCH; e += NTH) {
      const int c = e / KCH, ch = e - c * KCH;
      cp_async_16(smem_u32(kd + c * KS + ch * 8), kg + c * sk + k0 + ch * 8, true);
    }
    if (with_v) {
      bf16* vd = v_s + stage * C::v_elems;
      if constexpr (VT) {
        for (int e = tid; e < D * KCH; e += NTH) {
          const int c = e / KCH, ch = e - c * KCH;
          cp_async_16(smem_u32(vd + c * KS + ch * 8), vg + c * sk + k0 + ch * 8, true);
        }
      } else {
        for (int e = tid; e < BK * CH; e += NTH) {
          const int r = e / CH, c = e - r * CH;
          cp_async_16(smem_u32(vd + r * VS + c * 8), vg + (k0 + r) * D + c * 8, true);
        }
      }
    }
    cp_async_commit();
  };
  // body(stage) for every key tile of 0 .. end, tile j + 1 in flight while
  // tile j is computed
  auto tile_loop = [&](int end, bool with_v, auto&& body) {
    const int n = end / BK;
    load_tile(0, 0, with_v);
    for (int j = 0; j < n; ++j) {
      if (j + 1 < n) {
        load_tile((j + 1) * BK, (j + 1) % kStages, with_v);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // tile j visible
      body(j % kStages);
      __syncthreads();  // tile j's stage is free for tile j + 2
    }
  };

  // this warp's A fragments of q (m = its 16 queries, k = d) from the
  // [d][query] tile: a[0] queries 0-7 / d 0-7, a[1] queries 8-15, a[2] d 8-15
  unsigned qf[DK / 16][4];
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk)
    ldsm_x4_t(smem_u32(q_s + (kk * 16 + (lane >> 4) * 8 + (lane & 7)) * QS + warp * 16 +
                       ((lane >> 3) & 1) * 8),
              qf[kk]);

  // scores (base 2) of the warp's 16 rows against the tile in `stage`:
  // s[j][e] is row g + 8 * (e >> 1), key j * 8 + 2 * t + (e & 1).  B (k = d,
  // n = keys) lies [d][key] in k^T's tile: ldmatrix.trans
  auto scores = [&](int stage, float (&s)[NT][4]) {
    const bf16* kt = k_s + stage * C::k_elems;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        unsigned kf[4];
        ldsm_x4_t(smem_u32(kt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * KS + jp * 16 +
                           (lane >> 4) * 8),
                  kf);
        mma_bf16(s[2 * jp], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], kf[2], kf[3]);
      }
    }
  };

  // prologue: each row's max over its anchor window, then shift = max + 16
  float shift[2] = {-CUDART_INF_F, -CUDART_INF_F};
  tile_loop(anchor, false, [&](int stage) {
    float s[NT][4];
    scores(stage, s);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) shift[e >> 1] = fmaxf(shift[e >> 1], s[j][e]);
  });
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    shift[r] = fmaxf(shift[r], __shfl_xor_sync(0xffffffffu, shift[r], 1));
    shift[r] = fmaxf(shift[r], __shfl_xor_sync(0xffffffffu, shift[r], 2));
    shift[r] += kShiftMargin;
  }

  float o[NO][4], l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  tile_loop(sk, true, [&](int stage) {
    float s[NT][4];
    scores(stage, s);
    const bf16* vt = v_s + stage * C::v_elems;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // p of keys kk*16 .. kk*16 + 16 in bf16: the A fragment of the PV product
      unsigned a[4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = 2 * kk + hh;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const __nv_bfloat162 pb =
              __floats2bfloat162_rn(exp2f(fminf(s[j][2 * r] - shift[r], kSaturate)),
                                    exp2f(fminf(s[j][2 * r + 1] - shift[r], kSaturate)));
          l[r] += __low2float(pb) + __high2float(pb);
          a[hh * 2 + r] = *reinterpret_cast<const unsigned*>(&pb);
        }
      }
      if constexpr (VT) {
        // v^T [d][key]: B (k = keys, n = d) in its col layout, plain ldmatrix
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          unsigned vf[4];
          ldsm_x4(smem_u32(vt + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * VS + kk * 16 +
                           ((lane >> 3) & 1) * 8),
                  vf);
          mma_bf16(o[2 * np], a, vf[0], vf[1]);
          mma_bf16(o[2 * np + 1], a, vf[2], vf[3]);
        }
        if constexpr (NO % 2 == 1) {
          unsigned vf[2];
          ldsm_x2(smem_u32(vt + ((NO - 1) * 8 + (lane & 7)) * VS + kk * 16 +
                           ((lane >> 3) & 1) * 8),
                  vf);
          mma_bf16(o[NO - 1], a, vf[0], vf[1]);
        }
      } else {
        // v [key][d]: ldmatrix.trans, as the bounded forward's PV product
        const int vrow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          unsigned vf[4];
          ldsm_x4_t(smem_u32(vt + vrow * VS + np * 16 + (lane >> 4) * 8), vf);
          mma_bf16(o[2 * np], a, vf[0], vf[1]);
          mma_bf16(o[2 * np + 1], a, vf[2], vf[3]);
        }
        if constexpr (NO % 2 == 1) {
          unsigned vf[2];
          ldsm_x2_t(smem_u32(vt + vrow * VS + (NO - 1) * 8), vf);
          mma_bf16(o[NO - 1], a, vf[0], vf[1]);
        }
      }
    }
  });

  // out = acc / max(sum, floor), rounded once, staged transposed in o_s (the
  // tile loop ended on a barrier, and q's tile was last read before the
  // prologue): element (row g + 8r, column n*8 + 2t + e) to o_s[column][row]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float den = fmaxf(l[r], kDenomFloor);
    const int row = warp * 16 + g + 8 * r;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o_s[(n * 8 + 2 * t) * QS + row] = __float2bfloat16(o[n][2 * r] / den);
      o_s[(n * 8 + 2 * t + 1) * QS + row] = __float2bfloat16(o[n][2 * r + 1] / den);
    }
  }
  __syncthreads();
  // D runs of BQ contiguous queries into out[bh][c][q0 ..]; queries past Sq
  // (the last d = 80 block's second half) are not stored
  bf16* og = out + size_t(bh) * D * sq;
  for (int e = tid; e < D * QCH; e += NTH) {
    const int c = e / QCH, r = (e - c * QCH) * 8;
    if (q0 + r < sq)
      *reinterpret_cast<uint4*>(og + c * sq + q0 + r) =
          *reinterpret_cast<const uint4*>(o_s + c * QS + r);
  }
}

template <int D, int WR, int MINB, bool VT>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int bh, int sq,
                   int sk, int anchor, cudaStream_t stream) {
  using C = ProbeTile<D, WR, VT>;
  auto kernel = flash_probe_tc_kernel<D, WR, MINB, VT>;
  const int smem = int(C::smem_bytes());
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + C::BQ - 1) / C::BQ, bh);
  // JAX's constant, (1 / sqrt(d)) * log2(e) in double, then rounded
  const float qscale = float(1.0 / sqrt(double(D)) * 1.4426950408889634);
  kernel<<<grid, C::kThreadsTc, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), sq, sk, qscale, anchor);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

}  // namespace

// Plain C entry point for ctypes, the arguments of flash_probes.cu's
// hedit_flash_packed_t: rows 11b (layout 1: q, k [BH, D, S], v [BH, S, D])
// and 11c (layout 2: q, k, v [BH, D, S]) in bf16; out [BH, D, Sq].  Returns
// 0 on success, a cudaError_t code from the launch, or -1 for arguments the
// kernel does not take (layout 0, row 11a, included).
extern "C" int hedit_flash_packed_t_tc(const void* q, const void* k, const void* v, void* out,
                                       int bh, int sq, int sk, int d, int anchor, int layout,
                                       int dtype, void* stream) {
  if (dtype != 1 || (layout != 1 && layout != 2)) return -1;
  if (bh < 1 || bh > 65535 || sq < BK || sk < BK || sq % BK || sk % BK) return -1;
  if (anchor < BK || anchor % BK || sk % anchor) return -1;
  if ((long long)(sq > sk ? sq : sk) * d > INT_MAX) return -1;  // 32-bit offsets in an image
  // cp.async and the q and out accesses move 16 bytes
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vt = layout == 2;
  switch (d) {
    case 40:
      return int(vt ? launch<40, 4, 5, true>(q, k, v, out, bh, sq, sk, anchor, s)
                    : launch<40, 4, 5, false>(q, k, v, out, bh, sq, sk, anchor, s));
    case 80:
      return int(vt ? launch<80, 8, 2, true>(q, k, v, out, bh, sq, sk, anchor, s)
                    : launch<80, 8, 2, false>(q, k, v, out, bh, sq, sk, anchor, s));
    default: return -1;
  }
}
