// Shared by the backward marches (march_bwd.cu, K4; a5_bwd.cu, K6;
// smooth_bwd.cu, K9): the block's reduction of its rays' per-interval
// [K, NC] sums (NC = 4 colour columns, 6 with the two bounds) into one
// partial.
// Warp shuffles first, then the warps in a fixed order, so every run adds
// the same numbers in the same order (no atomics); the caller sums the
// blocks' partials with torch.sum.

#pragma once

#include <cuda_runtime.h>

namespace {

// Every thread of the block calls this with its sums (zeros for threads off
// the image).  Writes partials[block, 0:num_intervals, 0:NC], where block is
// blockIdx.y * gridDim.x + blockIdx.x.
template <int KMAX, int WARPS, int NC>
__device__ __forceinline__ void write_block_partial(const float (&acc)[KMAX][NC],
                                                    int num_intervals,
                                                    float* __restrict__ partials) {
  __shared__ float s_warp[WARPS][KMAX * NC];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float v = acc[k][c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) s_warp[warp][NC * k + c] = v;
    }
  }
  __syncthreads();
  if (tid < num_intervals * NC) {
    float sum = 0.0f;
    for (int w = 0; w < WARPS; ++w) sum += s_warp[w][tid];
    const long long block = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    partials[block * num_intervals * NC + tid] = sum;
  }
}

}  // namespace
