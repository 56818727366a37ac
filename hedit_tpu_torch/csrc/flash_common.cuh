// Helpers shared by the flash-attention kernels (flash_attention.cu,
// flash_attention_bwd.cu): element conversion, the block size, and the
// conflict-free shared-memory row stride.

#pragma once

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

}  // namespace
