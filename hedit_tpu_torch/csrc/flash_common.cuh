// Helpers shared by the flash-attention kernels (flash_attention.cu,
// flash_attention_tc.cu, flash_attention_bwd.cu): element conversion, the
// block size, the conflict-free shared-memory row stride, and the operand
// layouts of the forward entry points (head-split and packed heads).

#pragma once

#include <climits>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows that are read with a stride across the lanes of a warp get an odd
// stride, so the strided reads are free of bank conflicts.
__host__ __device__ __forceinline__ int odd_stride(int d) { return d | 1; }

// Element strides of one operand seen as [batch, head, row, D]; D is dense.
// One (batch, head) image spans fewer than 2^31 elements (the entry points
// refuse more), so offsets inside it are 32-bit.
struct Strides {
  long long batch, head;
  int row;
};

// The grid's second axis (bh = batch rows * heads, head fastest) and the
// strides of the four operands.
struct Layout {
  int bh, heads;
  Strides q, k, v, out;
};

// [BH, S, D] contiguous: BH plays the batch, one head a batch row.
inline Layout head_split(int bh, int sq, int sk, int d) {
  const Strides qo{(long long)sq * d, 0, d}, kv{(long long)sk * d, 0, d};
  return Layout{bh, 1, qo, kv, kv, qo};
}

// Packed heads: q [B, Sq, H*D], k and v [B, Sk, H*D], each [S, H*D] image
// dense and the images q_bs, k_bs, v_bs elements apart (0: one image read by
// every batch row); out [B, Sq, H*D] contiguous.  Head h of a row is its
// columns h*D .. (h+1)*D, on both sides.  False for arguments that are not
// such a batch.
inline bool packed_layout(int b, int h, int sq, int sk, int d, long long q_bs, long long k_bs,
                          long long v_bs, Layout* lay) {
  if (b < 1 || h < 1 || sq < 1 || sk < 1 || (long long)b * h > 65535) return false;
  if ((long long)h * d > INT_MAX) return false;
  const int row = h * d;
  const long long q_img = (long long)sq * row, kv_img = (long long)sk * row;
  // images that overlap, or lie before the pointer, are not a batch
  if ((q_bs != 0 && q_bs < q_img) || (k_bs != 0 && k_bs < kv_img) ||
      (v_bs != 0 && v_bs < kv_img))
    return false;
  *lay = Layout{b * h, h, {q_bs, d, row}, {k_bs, d, row}, {v_bs, d, row}, {q_img, d, row}};
  return true;
}

// One (batch, head) image's row offsets must fit the kernels' 32-bit
// arithmetic.
inline bool rows_fit(const Layout& lay, int sq, int sk) {
  const long long longest = sq > sk ? sq : sk;
  return longest * lay.q.row <= INT_MAX && longest * lay.k.row <= INT_MAX &&
         longest * lay.v.row <= INT_MAX && longest * lay.out.row <= INT_MAX;
}

}  // namespace
