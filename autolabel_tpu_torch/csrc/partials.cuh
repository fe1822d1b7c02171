// The deterministic sum of per-block weight-gradient partials, shared by
// K3b (heads_bwd.cu) and K4b (mlp3.cu): blocks add their points into
// partials of their own, and this kernel adds the partials in block
// order, so dW is the same for a launch shape every run, with no float
// atomics.
#pragma once

#include <cuda_runtime.h>

// out[i] = sum over blocks b of part[b * total + i], in block order.
__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    int blocks, long long total,
                                    float* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int b = 0; b < blocks; ++b) s += part[(size_t)b * total + i];
    out[i] = s;
  }
}

static cudaError_t sum_partials(const float* part, int blocks,
                                long long total, float* out,
                                cudaStream_t s) {
  const int threads = 256;
  long long grid = (total + threads - 1) / threads;
  if (grid > 4096) grid = 4096;
  sum_partials_kernel<<<(unsigned int)grid, threads, 0, s>>>(part, blocks,
                                                              total, out);
  return cudaGetLastError();
}
