// Exact trilinear multiresolution hash-grid encode (forward) for Hopper.
//
// Replaces the TPU kernel autolabel_tpu/ops/hashgrid_pallas.py
// `_encode_kernel` (launched by `hashgrid_encode_pallas`). It computes what
// autolabel_tpu/ops/encoders.py `_encode_rows` / `_encode_lanes` compute:
// per point and level, pos = x * scale + pos_offset, floor/frac, the 8 cell
// corners, a coherent-prime uint32 XOR hash `% level_size` (or a dense
// index, which wraps floor-mod `level_size` too, unlike the Pallas kernel,
// so no corner reads out of bounds, not even for a point outside [0, 1]),
// a gather of F features and a trilinear blend in corner order. Per-level
// scale / stride / size / use_dense and the size's divisor constants come
// from the host, so the 'native', 'tcnn' and 'torch_ngp' lattices are all
// covered.
//
// What bounds it on the H100: bytes. Per point and level it reads 8 table
// rows of F floats and writes F floats; at TPU_GRID (4 x 2^15 x 128, fp32,
// 64 MiB) the byte floor is the output stream, N * L * F * 4 bytes (1 GiB
// per 524,288-point chunk) plus one pass over the table. Uniform points
// reuse no rows, so the gathers (8 rows of 512 B per point and level,
// 8.6 GB a chunk) run from L2 at its rate, not at that floor.
//
// Design, wide rows (F a multiple of 4, F >= 32; TPU_GRID's F = 128):
// - blocks run one level each, levels slowest in the grid (the Pallas
//   grid's (L, N / TILE) order), so the blocks resident together gather
//   from one level's table (16 MiB at TPU_GRID) instead of all four;
// - a warp takes K1_POINTS points of its level; first each lane computes
//   one (point, corner)'s index and weight, without a division
//   (level_corner_index), into the warp's slice of shared memory; then,
//   per point, its lanes read the 8 corner rows as float4 (one coalesced
//   512-byte row per corner) and blend them: K1_POINTS x 8 independent
//   16-byte loads a lane;
// - the output rows are written with streaming stores (st.global.cs), so
//   the 1 GiB stream does not evict the level's table from L2.
// Narrow rows (e.g. the reference's F = 2) use one thread per point and
// level, levels slowest too (one 4 MiB level of the reference preset in
// L2 instead of all 64 MiB). The arithmetic uses explicitly rounded fp32
// operations (no FMA contraction) in the plain version's order, so kernel
// and plain version agree to the last bits.
#include "hashgrid_common.cuh"

#define K1_POINTS 4  // points of one level per warp (a multiple of 4)
#define K1_THREADS 256
#define K1_WARPS (K1_THREADS / 32)

__device__ __forceinline__ float4 blend(float4 acc, float4 v, float w) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, w));
  acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, w));
  acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, w));
  acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, w));
  return acc;
}

// A warp per K1_POINTS points of level blockIdx.y; lanes over features,
// float4 wide.
__global__ void __launch_bounds__(K1_THREADS)
    encode_rows_kernel(const float* __restrict__ x,
                       const float* __restrict__ table,
                       float* __restrict__ out, Levels geo, float offset,
                       long long n, int levels, long long table_size,
                       int features) {
  // (index, weight bits) of each (point, corner) of a warp's points
  __shared__ __align__(16) uint2 corners[K1_WARPS][K1_POINTS * 8];
  const int l = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long p0 =
      ((long long)blockIdx.x * K1_WARPS + warp) * K1_POINTS;
  if (p0 >= n) return;
  const Level L = geo.l[l];
  uint2* mine = corners[warp];
  const int c = lane & 7;
#pragma unroll
  for (int r = 0; r < K1_POINTS / 4; ++r) {
    const int j = r * 4 + (lane >> 3);
    unsigned int idx = 0;
    float w = 0.0f;  // points past n: row 0, weight 0, never stored
    if (p0 + j < n) {
      const Cell cell = cell_of(x, p0 + j, L.scale, offset);
      idx = level_corner_index(cell.c[0] + ((c >> 2) & 1),
                               cell.c[1] + ((c >> 1) & 1),
                               cell.c[2] + (c & 1), L);
      w = corner_weight(cell, c);
    }
    mine[j * 8 + c] = make_uint2(idx, __float_as_uint(w));
  }
  __syncwarp();
  const float* level_table = table + (long long)l * table_size * features;
  const uint4* pairs = reinterpret_cast<const uint4*>(mine);
  for (int f = lane * 4; f < features; f += 128) {
    float4 acc[K1_POINTS];
#pragma unroll
    for (int j = 0; j < K1_POINTS; ++j) {
      acc[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // corners 2k, 2k + 1
        const uint4 e = pairs[j * 4 + k];
        const float4 v0 = __ldg(reinterpret_cast<const float4*>(
            level_table + (long long)e.x * features + f));
        const float4 v1 = __ldg(reinterpret_cast<const float4*>(
            level_table + (long long)e.z * features + f));
        acc[j] = blend(acc[j], v0, __uint_as_float(e.y));
        acc[j] = blend(acc[j], v1, __uint_as_float(e.w));
      }
    }
#pragma unroll
    for (int j = 0; j < K1_POINTS; ++j)
      if (p0 + j < n)
        __stcs(reinterpret_cast<float4*>(
                   out + ((p0 + j) * levels + l) * (long long)features + f),
               acc[j]);
  }
}

// One thread per point of level blockIdx.y; any feature width.
__global__ void encode_lanes_kernel(const float* __restrict__ x,
                                    const float* __restrict__ table,
                                    float* __restrict__ out, Levels geo,
                                    float offset, long long n, int levels,
                                    long long table_size, int features) {
  const int l = blockIdx.y;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const Level L = geo.l[l];
  Cell cell = cell_of(x, p, L.scale, offset);
  const float* level_table = table + (long long)l * table_size * features;
  unsigned int idx[8];
  float w[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    idx[c] = level_corner_index(cell.c[0] + ((c >> 2) & 1),
                                cell.c[1] + ((c >> 1) & 1),
                                cell.c[2] + (c & 1), L);
    w[c] = corner_weight(cell, c);
  }
  float* dst = out + (p * levels + l) * (long long)features;
  for (int f = 0; f < features; ++f) {
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      acc = __fadd_rn(acc, __fmul_rn(
          __ldg(level_table + (long long)idx[c] * features + f), w[c]));
    }
    dst[f] = acc;
  }
}

static bool wide_rows(int features) {
  return features % 4 == 0 && features >= 32;
}

// The grid of a launch, levels slowest: (point chunks, levels), a chunk
// K1_WARPS * K1_POINTS points (wide rows) or K1_THREADS (narrow rows).
static dim3 encode_grid(long long n, int levels, int features) {
  const int chunk = wide_rows(features) ? K1_WARPS * K1_POINTS : K1_THREADS;
  return dim3((unsigned int)((n + chunk - 1) / chunk), levels);
}

extern "C" int hashgrid_encode_fwd(const float* x, const float* table,
                                   float* out, const float* scale,
                                   const int* stride, const int* size,
                                   const int* dense,
                                   const unsigned int* magic,
                                   const int* shift, float offset,
                                   long long n, int levels,
                                   long long table_size, int features,
                                   void* stream) {
  Levels g;
  if (!make_levels(&g, scale, stride, size, dense, magic, shift, levels))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = encode_grid(n, levels, features);
  if (wide_rows(features))
    encode_rows_kernel<<<grid, K1_THREADS, 0, s>>>(
        x, table, out, g, offset, n, levels, table_size, features);
  else
    encode_lanes_kernel<<<grid, K1_THREADS, 0, s>>>(
        x, table, out, g, offset, n, levels, table_size, features);
  return (int)cudaGetLastError();
}

// out[0..6): the launch shape for n points: blocks, threads, static shared
// bytes, blocks per SM, registers per thread, points per warp (1 for the
// narrow path's thread per point and level).
extern "C" int hashgrid_encode_shape(int levels, int features, long long n,
                                     int* out) {
  const bool wide = wide_rows(features);
  const void* kernel = wide ? (const void*)encode_rows_kernel
                            : (const void*)encode_lanes_kernel;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      K1_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = encode_grid(n, levels, features);
  out[0] = (int)(grid.x * grid.y);
  out[1] = K1_THREADS;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = per_sm;
  out[4] = attr.numRegs;
  out[5] = wide ? K1_POINTS : 1;
  return 0;
}
