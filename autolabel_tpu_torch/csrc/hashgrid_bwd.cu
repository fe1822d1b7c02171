// Exact trilinear hash-grid encode, backward: the table gradient.
//
// Replaces the table cotangent of autolabel_tpu/ops/hashgrid_pallas.py
// `_hybrid_bwd`, which the JAX package leaves to XLA (the VJP of
// encoders.hashgrid_encode: a scatter-add, not a Pallas kernel). For every
// point p, level l and cell corner c it adds g[p, l*F:(l+1)*F] * w_c(p, l)
// to row idx_c(p, l) of the level's table, with the cell, fraction, corner
// index and weight computed exactly as the forward kernel computes them
// (hashgrid_common.cuh: level_corner_index, with the sizes' divisor
// constants from the host): dense indices wrap floor-mod the level size,
// so a point at x = 1, whose upper corner has weight 0, still adds inside
// the table. The gradient for x (pose refinement) is not computed here.
//
// What bounds it on the H100: bytes. It reads g (N * L * F fp32, 256 MiB
// at the training slice's 131,072 points x 512) and x once, and writes the
// table gradient (64 MiB at TPU_GRID) once; the 8 * N * L * F fp32 atomic
// adds land in that table, which sits mostly in the 50 MB L2, where the
// atomics resolve. Design: for wide rows (F a multiple of 4, F >= 32) one
// warp owns a (point, level) pair and its lanes cover the features four at
// a time, so each corner is one coalesced 512-byte row of vector atomics
// (float4 atomicAdd on global memory, which sm_90 has). Narrow rows (the
// reference's F = 2) use one thread per (point, level). The output is
// zeroed with cudaMemsetAsync on the stream first. Atomics add in an order
// that changes from run to run, so the result is nondeterministic in its
// last bits: rows that many points touch differ from a sequential sum by a
// few fp32 roundings of the row's magnitude.
#include "hashgrid_common.cuh"

// One warp per (point, level); lanes over features, four at a time.
__global__ void scatter_rows_kernel(const float* __restrict__ x,
                                    const float* __restrict__ g,
                                    float* __restrict__ dtable, Levels geo,
                                    float offset, long long n, int levels,
                                    long long table_size, int features) {
  long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (warp >= n * levels) return;
  long long p = warp / levels;
  int l = (int)(warp - p * levels);
  const Level L = geo.l[l];
  Cell cell = cell_of(x, p, L.scale, offset);
  float* level = dtable + (long long)l * table_size * features;
  const float* src = g + (p * levels + l) * (long long)features;
  for (int f = lane * 4; f < features; f += 128) {
    float4 gv = __ldg(reinterpret_cast<const float4*>(src + f));
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      unsigned int idx = level_corner_index(cell.c[0] + ((c >> 2) & 1),
                                            cell.c[1] + ((c >> 1) & 1),
                                            cell.c[2] + (c & 1), L);
      float w = corner_weight(cell, c);
      atomicAdd(reinterpret_cast<float4*>(level + (long long)idx * features +
                                          f),
                make_float4(__fmul_rn(gv.x, w), __fmul_rn(gv.y, w),
                            __fmul_rn(gv.z, w), __fmul_rn(gv.w, w)));
    }
  }
}

// One thread per (point, level); any feature width.
__global__ void scatter_lanes_kernel(const float* __restrict__ x,
                                     const float* __restrict__ g,
                                     float* __restrict__ dtable,
                                     Levels geo, float offset, long long n,
                                     int levels, long long table_size,
                                     int features) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * levels) return;
  long long p = t / levels;
  int l = (int)(t - p * levels);
  const Level L = geo.l[l];
  Cell cell = cell_of(x, p, L.scale, offset);
  float* level = dtable + (long long)l * table_size * features;
  const float* src = g + (p * levels + l) * (long long)features;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    unsigned int idx = level_corner_index(cell.c[0] + ((c >> 2) & 1),
                                          cell.c[1] + ((c >> 1) & 1),
                                          cell.c[2] + (c & 1), L);
    float w = corner_weight(cell, c);
    float* row = level + (long long)idx * features;
    for (int f = 0; f < features; ++f)
      atomicAdd(row + f, __fmul_rn(__ldg(src + f), w));
  }
}

extern "C" int hashgrid_encode_bwd(const float* x, const float* g,
                                   float* dtable, const float* scale,
                                   const int* stride, const int* size,
                                   const int* dense,
                                   const unsigned int* magic,
                                   const int* shift, float offset,
                                   long long n, int levels,
                                   long long table_size, int features,
                                   void* stream) {
  Levels geo;
  if (!make_levels(&geo, scale, stride, size, dense, magic, shift, levels))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      dtable, 0, (size_t)levels * table_size * features * sizeof(float), s);
  if (err != cudaSuccess || n == 0) return (int)err;
  const int threads = 256;
  if (features % 4 == 0 && features >= 32) {
    long long total = n * levels * 32;
    unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
    scatter_rows_kernel<<<blocks, threads, 0, s>>>(
        x, g, dtable, geo, offset, n, levels, table_size, features);
  } else {
    long long total = n * levels;
    unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
    scatter_lanes_kernel<<<blocks, threads, 0, s>>>(
        x, g, dtable, geo, offset, n, levels, table_size, features);
  }
  return (int)cudaGetLastError();
}
