// Exact trilinear multiresolution hash-grid encode (forward) for Hopper.
//
// Replaces the TPU kernel autolabel_tpu/ops/hashgrid_pallas.py
// `_encode_kernel` (launched by `hashgrid_encode_pallas`). It computes what
// autolabel_tpu/ops/encoders.py `_encode_rows` / `_encode_lanes` compute:
// per point and level, pos = x * scale + pos_offset, floor/frac, the 8 cell
// corners, a coherent-prime uint32 XOR hash `% level_size` (or a dense
// index, which wraps floor-mod `level_size` too, unlike the Pallas kernel,
// so no corner reads out of bounds, not even for a point outside [0, 1]),
// a gather of F features and a
// trilinear blend in corner order. Per-level scale / stride / size /
// use_dense come from the host, so the 'native', 'tcnn' and 'torch_ngp'
// lattices are all covered.
//
// What bounds it on the H100: bytes. Per point and level it reads 8 table
// rows of F floats and writes F floats; at TPU_GRID (4 x 2^15 x 128, fp32,
// 64 MiB) the table sits mostly in the 50 MB L2, so the floor is the
// output stream, N * L * F * 4 bytes (1 GiB per 524,288-point chunk).
// Design: for wide rows (F a multiple of 4, F >= 32) one warp owns a
// (point, level) pair and its lanes cover the features with float4 loads,
// so each corner is one coalesced 512-byte row read and the output row is
// one coalesced 512-byte write. Narrow rows (e.g. the reference's F = 2)
// use one thread per (point, level). The arithmetic uses explicitly
// rounded fp32 operations (no FMA contraction) in the plain version's
// order, so kernel and plain version agree to the last bits.
#include "hashgrid_common.cuh"

// One warp per (point, level); lanes over features, float4 wide.
__global__ void encode_rows_kernel(const float* __restrict__ x,
                                   const float* __restrict__ table,
                                   float* __restrict__ out, Geometry g,
                                   float offset, long long n, int levels,
                                   long long table_size, int features) {
  long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (warp >= n * levels) return;
  long long p = warp / levels;
  int l = (int)(warp - p * levels);
  Cell cell = cell_of(x, p, g.scale[l], offset);
  const float* level_table = table + (long long)l * table_size * features;
  float* dst = out + (p * levels + l) * (long long)features;
  for (int f = lane * 4; f < features; f += 128) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      unsigned int idx = corner_index(
          cell.c[0] + ((c >> 2) & 1), cell.c[1] + ((c >> 1) & 1),
          cell.c[2] + (c & 1), g.stride[l], g.size[l], g.dense[l]);
      float w = corner_weight(cell, c);
      float4 v = __ldg(reinterpret_cast<const float4*>(
          level_table + (long long)idx * features + f));
      acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, w));
      acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, w));
      acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, w));
      acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, w));
    }
    *reinterpret_cast<float4*>(dst + f) = acc;
  }
}

// One thread per (point, level); any feature width.
__global__ void encode_lanes_kernel(const float* __restrict__ x,
                                    const float* __restrict__ table,
                                    float* __restrict__ out, Geometry g,
                                    float offset, long long n, int levels,
                                    long long table_size, int features) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * levels) return;
  long long p = t / levels;
  int l = (int)(t - p * levels);
  Cell cell = cell_of(x, p, g.scale[l], offset);
  const float* level_table = table + (long long)l * table_size * features;
  unsigned int idx[8];
  float w[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    idx[c] = corner_index(cell.c[0] + ((c >> 2) & 1),
                          cell.c[1] + ((c >> 1) & 1), cell.c[2] + (c & 1),
                          g.stride[l], g.size[l], g.dense[l]);
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

extern "C" int hashgrid_encode_fwd(const float* x, const float* table,
                                   float* out, const float* scale,
                                   const int* stride, const int* size,
                                   const int* dense, float offset,
                                   long long n, int levels,
                                   long long table_size, int features,
                                   void* stream) {
  Geometry g;
  if (!make_geometry(&g, scale, stride, size, dense, levels))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  if (features % 4 == 0 && features >= 32) {
    long long total = n * levels * 32;
    unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
    encode_rows_kernel<<<blocks, threads, 0, s>>>(x, table, out, g, offset,
                                                  n, levels, table_size,
                                                  features);
  } else {
    long long total = n * levels;
    unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
    encode_lanes_kernel<<<blocks, threads, 0, s>>>(x, table, out, g, offset,
                                                   n, levels, table_size,
                                                   features);
  }
  return (int)cudaGetLastError();
}
