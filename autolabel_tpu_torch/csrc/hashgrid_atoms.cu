// Hash-grid encode from each point's interpolation atoms (K1s): the
// simplex (tetrahedral, 4 atoms) or trilinear (8 atoms) encode, with the
// atoms written out for a backward that needs them.
//
// Replaces what XLA compiles on the TPU for
// autolabel_tpu/ops/encoders.py `_encode_rows_simplex` (the exact simplex
// encode, with `_simplex_corners`), `_corner_idx_weights` (the (L, A, N)
// int32 indices and fp32 weights the sampled backward saves) and
// `_gather_from_atoms` (the interpolation from them, in the compute dtype).
// Per point and level: pos = x * scale + pos_offset, floor/frac; for the
// simplex, the fractions sorted s1 >= s2 >= s3 (argmax and argmin take the
// first index on ties, as jnp.argmax does), the corners base, +e_argmax,
// +(1 - e_argmin), (1, 1, 1) with weights (1 - s1, s1 - s2, s2 - s3, s3),
// s2 = ((f0 + f1) + f2 - s1) - s3 in the JAX package's fp32 order, so
// indices are equal and weights bit-equal; the trilinear atoms are the 8
// cell corners in the JAX meshgrid order. Rows come from
// level_corner_index (hashgrid_common.cuh, no division). The blend sums
// w * row in atom order in fp32, as the plain version; the bf16 form
// rounds that fp32 sum once, where the plain bf16 version rounds every
// product and partial sum.
//
// What bounds it on the H100: L2, not DRAM. Its DRAM bytes (x, each
// table row its atoms name once, the output and, in training, the atoms)
// take 0.061 ms at the flagship's N = 131,072 (3.35 TB/s). But each
// warp's A rows a point come through L2, and away from the coarsest level
// neighbouring ray samples share few rows: the distinct rows of each
// warp's 8 points come to 0.65 GB at that shape (1.44 GB at the train
// CLI's 524,288), which L2 serves, as scattered 512-byte rows with four
// of a warp in flight at 8 blocks of 256 an SM, in 0.083 ms (0.159; the
// gather_rows probe below). Fewer loads in flight serve them slower. The
// output stores (0.15 GB in training, 0.27 GB in eval) pass through L2
// beside them. So the gathers run at the rate of the loads in flight,
// and the kernel keeps as many warps issuing them as an SM holds without
// spilling.
//
// Design (K1's encode_rows_kernel frame): blocks of 4 warps run one level
// each, levels slowest; a warp takes 32 / A points of its level, and each
// lane computes one (point, atom)'s row and weight once, into shared
// memory (and, with atoms, to the (L, A, N) arrays: a lane per atom and
// point, consecutive points on consecutive lanes); then the warp's lanes
// gather the points' A rows float4 wide (a row's 512 contiguous bytes a
// warp load) and blend them, streaming the output rows out. The registers
// are capped at 64 a thread (K1S_MIN_BLOCKS), so an SM holds 32 warps,
// each with its loads in flight, where 256-thread blocks at 70 registers
// held 24 (NVIDIA H100 80GB HBM3, 700 W: 0.117 against 0.130 ms device at
// the flagship's shape, 0.379 against 0.406 at the CLI's); at 56
// registers (36 warps) or 48 (40) it runs slower. Designs that stage
// rows in shared memory lost: a tile's distinct rows fetched once by
// cp.async into two stages held too few bytes in flight and ran 2.2
// times slower, and async copies of scattered rows (cp.async, bulk
// copies) came in slower than register loads with as much in flight;
// skipping the loads of rows a lane already held for the previous point
// took away the loads' independence and cost 3 to 8%.
// Features must be a multiple of 4; the JAX package asks 8 for simplex.
#include <cuda_bf16.h>

#include "hashgrid_common.cuh"

#define K1S_THREADS 128
#define K1S_WARPS (K1S_THREADS / 32)
// Blocks an SM must hold: 64 registers a thread, 32 warps an SM.
#define K1S_MIN_BLOCKS 8

__device__ __forceinline__ float4 blend4(float4 acc, float4 v, float w) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, w));
  acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, w));
  acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, w));
  acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, w));
  return acc;
}

__device__ __forceinline__ void store4(float* out, long long at, float4 v) {
  __stcs(reinterpret_cast<float4*>(out + at), v);
}

__device__ __forceinline__ void store4(__nv_bfloat16* out, long long at,
                                       float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 bits;
  bits.x = *reinterpret_cast<unsigned int*>(&lo);
  bits.y = *reinterpret_cast<unsigned int*>(&hi);
  __stcs(reinterpret_cast<uint2*>(out + at), bits);
}

// A warp per 32 / A points of level blockIdx.y; lanes over features.
template <int A, bool ATOMS, typename Out>
__global__ void __launch_bounds__(K1S_THREADS, K1S_MIN_BLOCKS)
    atoms_rows_kernel(const float* __restrict__ x,
                      const float* __restrict__ table, Out* __restrict__ out,
                      int* __restrict__ idx, float* __restrict__ wts,
                      Levels geo, float offset, long long n, int levels,
                      long long table_size, int features) {
  constexpr int P = 32 / A;  // points a warp
  __shared__ __align__(16) uint2 atoms[K1S_WARPS][32];
  const int l = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long p0 = ((long long)blockIdx.x * K1S_WARPS + warp) * P;
  if (p0 >= n) return;
  const Level L = geo.l[l];
  const int j = lane % P, a = lane / P;  // lane = a * P + j
  unsigned int row = 0;
  float w = 0.0f;  // points past n: row 0, weight 0, never stored
  if (p0 + j < n) {
    const Cell cell = cell_of(x, p0 + j, L.scale, offset);
    int off[3];
    if (A == 4) {
      w = simplex_atom(cell, a, off);
    } else {
      off[0] = (a >> 2) & 1;
      off[1] = (a >> 1) & 1;
      off[2] = a & 1;
      w = corner_weight(cell, a);
    }
    row = level_corner_index(cell.c[0] + off[0], cell.c[1] + off[1],
                             cell.c[2] + off[2], L);
    if (ATOMS) {
      const long long at = ((long long)l * A + a) * n + p0 + j;
      idx[at] = (int)row;
      wts[at] = w;
    }
  }
  atoms[warp][j * A + a] = make_uint2(row, __float_as_uint(w));
  __syncwarp();
  const float* level_table = table + (long long)l * table_size * features;
  for (int f = lane * 4; f < features; f += 128) {
    float4 acc[P];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      acc[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int b = 0; b < A; ++b) {
        const uint2 e = atoms[warp][q * A + b];
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            level_table + (long long)e.x * features + f));
        acc[q] = blend4(acc[q], v, __uint_as_float(e.y));
      }
    }
#pragma unroll
    for (int q = 0; q < P; ++q)
      if (p0 + q < n)
        store4(out, ((p0 + q) * levels + l) * (long long)features + f,
               acc[q]);
  }
}

static const void* atoms_kernel(int atoms, bool write, bool bf16) {
#define K1S_PICK(A)                                                      \
  if (atoms == A) {                                                     \
    if (write)                                                          \
      return bf16 ? (const void*)atoms_rows_kernel<A, true, __nv_bfloat16> \
                  : (const void*)atoms_rows_kernel<A, true, float>;     \
    return bf16 ? (const void*)atoms_rows_kernel<A, false, __nv_bfloat16> \
                : (const void*)atoms_rows_kernel<A, false, float>;      \
  }
  K1S_PICK(4)
  K1S_PICK(8)
#undef K1S_PICK
  return nullptr;
}

static dim3 atoms_grid(long long n, int levels, int atoms) {
  const int chunk = K1S_WARPS * (32 / atoms);
  return dim3((unsigned int)((n + chunk - 1) / chunk), levels);
}

extern "C" int hashgrid_atoms_fwd(const float* x, const float* table,
                                  void* out, int* idx, float* w,
                                  const float* scale, const int* stride,
                                  const int* size, const int* dense,
                                  const unsigned int* magic, const int* shift,
                                  float offset, long long n, int levels,
                                  long long table_size, int features,
                                  int atoms, int out_bf16, void* stream) {
  Levels g;
  if (!make_levels(&g, scale, stride, size, dense, magic, shift, levels) ||
      features % 4 || (atoms != 4 && atoms != 8) || (!idx) != (!w))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = atoms_grid(n, levels, atoms);
  const bool write = idx != nullptr;
#define K1S_LAUNCH(A, W, T)                                               \
  atoms_rows_kernel<A, W, T><<<grid, K1S_THREADS, 0, s>>>(                \
      x, table, reinterpret_cast<T*>(out), idx, w, g, offset, n, levels,  \
      table_size, features)
  if (atoms == 4) {
    if (write) {
      if (out_bf16) K1S_LAUNCH(4, true, __nv_bfloat16);
      else K1S_LAUNCH(4, true, float);
    } else {
      if (out_bf16) K1S_LAUNCH(4, false, __nv_bfloat16);
      else K1S_LAUNCH(4, false, float);
    }
  } else {
    if (write) {
      if (out_bf16) K1S_LAUNCH(8, true, __nv_bfloat16);
      else K1S_LAUNCH(8, true, float);
    } else {
      if (out_bf16) K1S_LAUNCH(8, false, __nv_bfloat16);
      else K1S_LAUNCH(8, false, float);
    }
  }
#undef K1S_LAUNCH
  return (int)cudaGetLastError();
}

// out[0..6): the launch shape for n points: blocks, threads, static shared
// bytes, blocks per SM, registers per thread, points per warp.
extern "C" int hashgrid_atoms_shape(int levels, long long n, int atoms,
                                    int write, int out_bf16, int* out) {
  const void* kernel = atoms_kernel(atoms, write != 0, out_bf16 != 0);
  if (!kernel) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      K1S_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = atoms_grid(n, levels, atoms);
  out[0] = (int)(grid.x * grid.y);
  out[1] = K1S_THREADS;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = per_sm;
  out[4] = attr.numRegs;
  out[5] = 32 / atoms;
  return 0;
}

// The L2 gather floor's probe, on no path: a warp per listed row (rows[i]
// of the whole table, F floats) reads it float4 wide, 4 rows of a warp in
// flight (64 KB of loads an SM at 8 blocks of 256), rows in list order on
// a grid stride, and folds them into a value written only when it is a
// NaN the table never holds. Timed on the distinct rows each warp's
// points need, it is the least time the kernel's gathers can take at the
// rate L2 serves them.
#define GATHER_DEPTH 4
__global__ void __launch_bounds__(256)
    gather_rows_kernel(const float* __restrict__ table,
                       const long long* __restrict__ rows, long long count,
                       int features, float* __restrict__ sink) {
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * 8 * GATHER_DEPTH;
  float acc = 0.0f;
  for (long long r = ((long long)blockIdx.x * 8 + (threadIdx.x >> 5)) *
                     GATHER_DEPTH;
       r < count; r += step)
    for (int f = lane * 4; f < features; f += 128) {
      float4 v[GATHER_DEPTH];
#pragma unroll
      for (int q = 0; q < GATHER_DEPTH; ++q)
        v[q] = r + q < count ? __ldg(reinterpret_cast<const float4*>(
                                   table + rows[r + q] * features + f))
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int q = 0; q < GATHER_DEPTH; ++q)
        acc += v[q].x + v[q].y + v[q].z + v[q].w;
    }
  if (__float_as_uint(acc) == 0x7fc00001u) sink[0] = acc;
}

extern "C" int hashgrid_atoms_gather_rows(const float* table,
                                          const long long* rows,
                                          long long count, int features,
                                          float* sink, void* stream) {
  if (features < 4 || features % 4) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if (count == 0) return 0;
  gather_rows_kernel<<<sms * 8, 256, 0, (cudaStream_t)stream>>>(
      table, rows, count, features, sink);
  return (int)cudaGetLastError();
}
