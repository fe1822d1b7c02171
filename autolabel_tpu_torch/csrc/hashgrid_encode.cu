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
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LEVELS 32

struct Geometry {
  float scale[MAX_LEVELS];
  int stride[MAX_LEVELS];
  unsigned int size[MAX_LEVELS];
  int dense[MAX_LEVELS];
};

__device__ __forceinline__ unsigned int corner_index(int cx, int cy, int cz,
                                                     int stride,
                                                     unsigned int size,
                                                     int dense) {
  if (dense) {
    // Floor-mod in int64, as the plain version computes it: a point outside
    // [0, 1] gives negative cell coordinates, and C's % would then give a
    // negative index.
    long long v = (long long)cx +
                  (long long)stride * ((long long)cy + (long long)stride * cz);
    long long m = v % (long long)size;
    return (unsigned int)(m < 0 ? m + size : m);
  }
  unsigned int h = (unsigned int)cx * 1u ^ (unsigned int)cy * 2654435761u ^
                   (unsigned int)cz * 805459861u;
  return h % size;
}

struct Cell {
  int c[3];
  float f[3];
};

__device__ __forceinline__ Cell cell_of(const float* __restrict__ x,
                                        long long p, float scale,
                                        float offset) {
  Cell cell;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float pos = __fadd_rn(__fmul_rn(scale, x[p * 3 + a]), offset);
    float fl = floorf(pos);
    cell.c[a] = (int)fl;
    cell.f[a] = __fsub_rn(pos, fl);
  }
  return cell;
}

__device__ __forceinline__ float corner_weight(const Cell& cell, int c) {
  float wx = (c >> 2) & 1 ? cell.f[0] : __fsub_rn(1.0f, cell.f[0]);
  float wy = (c >> 1) & 1 ? cell.f[1] : __fsub_rn(1.0f, cell.f[1]);
  float wz = c & 1 ? cell.f[2] : __fsub_rn(1.0f, cell.f[2]);
  return __fmul_rn(__fmul_rn(wx, wy), wz);
}

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
  if (levels < 1 || levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  Geometry g;
  for (int l = 0; l < levels; ++l) {
    g.scale[l] = scale[l];
    g.stride[l] = stride[l];
    g.size[l] = (unsigned int)size[l];
    g.dense[l] = dense[l];
  }
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
