// Lattice geometry shared by the hash-grid encode and its backward
// (hashgrid_encode.cu, hashgrid_bwd.cu): per point and level, the cell and
// fraction, the 8 corner indices and the trilinear corner weights, with
// the same explicitly rounded fp32 operations (no FMA contraction) in the
// plain version's order, so kernel and plain version agree to the last
// bits.
#pragma once
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

// The per-level geometry from the host's arrays; false for a level count
// the struct cannot hold.
static bool make_geometry(Geometry* g, const float* scale, const int* stride,
                          const int* size, const int* dense, int levels) {
  if (levels < 1 || levels > MAX_LEVELS) return false;
  for (int l = 0; l < levels; ++l) {
    g->scale[l] = scale[l];
    g->stride[l] = stride[l];
    g->size[l] = (unsigned int)size[l];
    g->dense[l] = dense[l];
  }
  return true;
}
