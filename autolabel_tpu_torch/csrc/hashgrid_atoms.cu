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
// What bounds it on the H100: bytes. It reads x and the table once and
// writes the output (N * L * F, fp32 or bf16) and, in training, the atoms
// (2 * L * A * N * 4 bytes). The gathers (A rows of F floats per point and
// level) run from L2, as K1's do.
//
// Design (K1's encode_rows_kernel frame): blocks run one level each, levels
// slowest; a warp takes 32 / A points of its level, and each lane computes
// one (point, atom)'s row and weight once, into shared memory (and, with
// atoms, to the (L, A, N) arrays: a lane per atom and point, consecutive
// points on consecutive lanes); then the warp's lanes gather the points'
// A rows float4 wide and blend them, streaming the output rows out.
// Features must be a multiple of 4; the JAX package asks 8 for simplex.
#include <cuda_bf16.h>

#include "hashgrid_common.cuh"

#define K1S_THREADS 256
#define K1S_WARPS (K1S_THREADS / 32)

// Atom a of the simplex corners of `cell`: its corner offset and weight.
__device__ __forceinline__ float simplex_atom(const Cell& cell, int a,
                                              int (&off)[3]) {
  const float f0 = cell.f[0], f1 = cell.f[1], f2 = cell.f[2];
  int hi = 0, lo = 0;
  float s1 = f0, s3 = f0;
  if (f1 > s1) { hi = 1; s1 = f1; }
  if (f2 > s1) { hi = 2; s1 = f2; }
  if (f1 < s3) { lo = 1; s3 = f1; }
  if (f2 < s3) { lo = 2; s3 = f2; }
  const float s2 =
      __fsub_rn(__fsub_rn(__fadd_rn(__fadd_rn(f0, f1), f2), s1), s3);
#pragma unroll
  for (int d = 0; d < 3; ++d)
    off[d] = a == 0 ? 0 : a == 1 ? (d == hi) : a == 2 ? (d != lo) : 1;
  return a == 0 ? __fsub_rn(1.0f, s1)
         : a == 1 ? __fsub_rn(s1, s2)
         : a == 2 ? __fsub_rn(s2, s3)
                  : s3;
}

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
__global__ void __launch_bounds__(K1S_THREADS)
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
