// Lattice geometry shared by the hash-grid encode and its backward
// (hashgrid_encode.cu, hashgrid_bwd.cu): per point and level, the cell and
// fraction, the 8 corner indices (level_corner_index, without divisions)
// and the trilinear corner weights, with the same explicitly rounded fp32
// operations (no FMA contraction) in the plain version's order, so kernels
// and plain version agree to the last bits.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LEVELS 32

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

// One level's constants, with its size's divisor from the host
// (hashgrid_cuda.level_divisors): magic 0 where the size is a power of two
// (h % size = h & (size - 1)), else the Granlund-Montgomery multiplier for
// shift = ceil(log2 size), whose quotient is exact for every uint32.
struct Level {
  float scale;
  int stride;
  unsigned int size;
  int dense;
  unsigned int magic;
  int shift;
};

struct Levels {
  Level l[MAX_LEVELS];
};

__device__ __forceinline__ unsigned int level_mod(unsigned int h,
                                                  const Level& L) {
  if (L.magic == 0) return h & (L.size - 1u);
  const unsigned int t = __umulhi(h, L.magic);
  const unsigned int q = (t + ((h - t) >> 1)) >> (L.shift - 1);
  return h - q * L.size;
}

// The row of corner (cx, cy, cz) in level L, without a division: the
// coherent-prime uint32 hash `% size` by level_mod, or the dense linear
// index v wrapped floor-mod size, as the plain version wraps it (a point
// outside [0, 1] gives negative cell coordinates, where C's % would give a
// negative row). The floor-mod runs in 32 bits wherever v lies in
// (-2^32, 2^32) (always, for points near [0, 1]): v mod size for v >= 0,
// size - 1 - ((-v - 1) mod size) below; in int64 outside that range.
__device__ __forceinline__ unsigned int level_corner_index(int cx, int cy,
                                                           int cz,
                                                           const Level& L) {
  if (L.dense) {
    const long long v =
        (long long)cx +
        (long long)L.stride * ((long long)cy + (long long)L.stride * cz);
    if (v > -4294967296LL && v < 4294967296LL) {
      const bool neg = v < 0;
      const unsigned int r = level_mod((unsigned int)(neg ? -v - 1 : v), L);
      return neg ? L.size - 1u - r : r;
    }
    const long long m = v % (long long)L.size;
    return (unsigned int)(m < 0 ? m + L.size : m);
  }
  return level_mod((unsigned int)cx * 1u ^ (unsigned int)cy * 2654435761u ^
                       (unsigned int)cz * 805459861u,
                   L);
}

// The per-level constants from the host's arrays; false for a level count
// the struct cannot hold or a divisor the arithmetic does not take.
static bool make_levels(Levels* g, const float* scale, const int* stride,
                        const int* size, const int* dense,
                        const unsigned int* magic, const int* shift,
                        int levels) {
  if (levels < 1 || levels > MAX_LEVELS) return false;
  for (int l = 0; l < levels; ++l) {
    if (size[l] < 1 || (magic[l] != 0 && shift[l] < 1)) return false;
    g->l[l] = {scale[l], stride[l], (unsigned int)size[l], dense[l],
               magic[l], shift[l]};
  }
  return true;
}
