// The second pass of the matmul cost probe's split contraction, shared by
// its two routes (mm_probe.cu, float32 on the CUDA cores; mm_probe_tc.cu,
// bf16 on the tensor cores): each block of a split writes its float32
// partial [M, N] into a workspace [splits, M, N], and this kernel sums the
// partials in split order.  No atomics, so a relaunch is bit for bit the
// same.

#pragma once

#include <cstddef>

#include <cuda_runtime.h>

namespace {

constexpr int kSumThreads = 256;

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

// o [count] = the sum of the splits partials of ws [splits, count]
inline cudaError_t launch_split_sum(const float* ws, float* o, size_t count, int splits,
                                    cudaStream_t s) {
  const size_t blocks = (count + kSumThreads - 1) / kSumThreads;
  mm_split_sum_kernel<<<unsigned(blocks < 4096 ? blocks : 4096), kSumThreads, 0, s>>>(
      ws, o, count, splits);
  return cudaGetLastError();
}

}  // namespace
