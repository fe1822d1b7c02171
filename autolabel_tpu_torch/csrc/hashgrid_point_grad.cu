// The hash-grid encode's gradient for the points (K2x), for Hopper.
//
// Replaces the x half of autolabel_tpu/ops/hashgrid_pallas.py:141-145
// `_hybrid_bwd` (JAX's VJP of encoders.hashgrid_encode, which XLA compiles),
// and the same VJP through every form of the encode: the exact trilinear
// encode (wide or narrow rows), the exact simplex encode, and the
// stochastic-corner and residual encodes level by level (a plan's kinds,
// hashgrid_stochastic.cuh): DRAWS levels carry no gradient (a comparison
// picks the row); an EXACT level's atoms a give coef_a = <g_l, row_a>; a
// RESIDUAL level's output w_m f_m + (1 - w_m) f_J gives coef_a =
// <g_l, f_m - f_J> / ties on the atoms whose weight ties the maximum w_m.
// From the coefs, the fractions' cotangent follows the weights' derivatives
// (the trilinear corner products; the simplex weights (1 - s1, s1 - s2,
// s2 - s3, s3), s2 = sum - s1 - s3, s1 = max and s3 = min shared evenly
// among tied axes, as jnp.max and jnp.min share them), times the level's
// scale, summed over levels: dx (N, 3). Its plain version is
// ops/encoders.hashgrid_encode_point_grad_plain.
//
// What bounds it on the H100: bytes. It reads g (N x L x F fp32: 268 MB at
// TPU_GRID for N = 131,072) once and writes dx (N x 3); the table rows it
// gathers (A of F floats a point and level, 1.07 GB at TPU_GRID simplex)
// come from L2, as K1's do.
//
// Design, a first simple one: wide rows (F a multiple of 4, F >= 32,
// F <= 32 * 4 * K2X_VEC) take a warp per point, walking its levels; the
// lanes hold the point's g block of the level in registers (float4 wide)
// and read each atom's row float4 wide, one coalesced row per atom; the
// dot is reduced by a butterfly of shuffles, the level's cotangent
// computed by every lane, and lane 0 writes the point's dx: no atomics,
// no shared memory, the result the same on every run. Narrow rows take a
// thread per point, walking levels, atoms and features. The rows come
// from the caller where a forward kernel wrote them (K1s's (L, A, N)
// atoms, K6's (S, N) drawn rows: `rows` with each level's first row),
// else from the cell (level_corner_index). Fusion with the table-gradient
// kernels (K2, K2s, K7), which read the same g and rows, is later work.
#include "hashgrid_common.cuh"

#define K2X_THREADS 256
#define K2X_WARPS (K2X_THREADS / 32)
#define K2X_VEC 4  // float4 of g a lane holds: F up to 512
#define KIND_DRAWS 0
#define KIND_RESIDUAL 1
#define KIND_EXACT 2

struct Plan {
  int kind[MAX_LEVELS];
  int first[MAX_LEVELS];
};

// Atom a's row index and weight at `cell` (trilinear corners in
// encoders._CORNERS order, or the simplex atoms), the row read from the
// caller's rows where given.
template <int A>
__device__ __forceinline__ void atom(const Cell& cell, const Level& L, int a,
                                     const int* __restrict__ rows,
                                     long long row, long long n, long long p,
                                     unsigned int& idx, float& w) {
  int off[3];
  if (A == 4) {
    w = simplex_atom(cell, a, off);
  } else {
    off[0] = (a >> 2) & 1;
    off[1] = (a >> 1) & 1;
    off[2] = a & 1;
    w = corner_weight(cell, a);
  }
  idx = rows != nullptr
            ? (unsigned int)__ldg(rows + row * n + p)
            : level_corner_index(cell.c[0] + off[0], cell.c[1] + off[1],
                                 cell.c[2] + off[2], L);
}

// The level's fraction cotangent from the atoms' coefs, in the plain
// version's order.
template <int A>
__device__ __forceinline__ void frac_cotangent(const Cell& cell,
                                               const float (&coef)[A],
                                               float (&out)[3]) {
  const float* f = cell.f;
  if (A == 4) {
    const float d1 = __fsub_rn(coef[1], coef[0]);
    const float d2 = __fsub_rn(coef[2], coef[1]);
    const float d3 = __fsub_rn(coef[3], coef[2]);
    const float ct1 = __fsub_rn(d1, d2), ct3 = __fsub_rn(d3, d2);
    const float s1 = fmaxf(fmaxf(f[0], f[1]), f[2]);
    const float s3 = fminf(fminf(f[0], f[1]), f[2]);
    const float n1 = (float)((f[0] == s1) + (f[1] == s1) + (f[2] == s1));
    const float n3 = (float)((f[0] == s3) + (f[1] == s3) + (f[2] == s3));
    const float q1 = __fdiv_rn(ct1, n1), q3 = __fdiv_rn(ct3, n3);
#pragma unroll
    for (int d = 0; d < 3; ++d)
      out[d] = __fadd_rn(__fadd_rn(d2, f[d] == s1 ? q1 : 0.f),
                         f[d] == s3 ? q3 : 0.f);
    return;
  }
  out[0] = out[1] = out[2] = 0.f;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int ox = (a >> 2) & 1, oy = (a >> 1) & 1, oz = a & 1;
    const float wx = ox ? f[0] : __fsub_rn(1.0f, f[0]);
    const float wy = oy ? f[1] : __fsub_rn(1.0f, f[1]);
    const float wz = oz ? f[2] : __fsub_rn(1.0f, f[2]);
    const float cz = __fmul_rn(coef[a], __fmul_rn(wx, wy));
    const float cxy = __fmul_rn(coef[a], wz);
    const float cx = __fmul_rn(cxy, wy), cy = __fmul_rn(cxy, wx);
    out[0] = ox ? __fadd_rn(out[0], cx) : __fsub_rn(out[0], cx);
    out[1] = oy ? __fadd_rn(out[1], cy) : __fsub_rn(out[1], cy);
    out[2] = oz ? __fadd_rn(out[2], cz) : __fsub_rn(out[2], cz);
  }
}

// coef of a RESIDUAL level: diff = <g, f_m> - <g, f_J> shared evenly by the
// atoms whose weight equals the largest.
template <int A>
__device__ __forceinline__ void residual_coef(const float (&w)[A], float diff,
                                              float (&coef)[A]) {
  float wm = w[0];
#pragma unroll
  for (int a = 1; a < A; ++a) wm = fmaxf(wm, w[a]);
  int ties = 0;
#pragma unroll
  for (int a = 0; a < A; ++a) ties += w[a] == wm;
  const float share = __fdiv_rn(1.0f, (float)ties);
#pragma unroll
  for (int a = 0; a < A; ++a)
    coef[a] = w[a] == wm ? __fmul_rn(diff, share) : 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A warp per point, walking its levels; lanes over features, float4 wide.
template <int A>
__global__ void __launch_bounds__(K2X_THREADS)
    point_grad_rows_kernel(const float* __restrict__ x,
                           const float* __restrict__ table,
                           const float* __restrict__ g,
                           const int* __restrict__ rows,
                           float* __restrict__ dx, Levels geo, Plan plan,
                           float offset, long long n, int levels,
                           long long table_size, int features) {
  const int lane = threadIdx.x & 31;
  const long long p =
      (long long)blockIdx.x * K2X_WARPS + (threadIdx.x >> 5);
  if (p >= n) return;
  const int vecs = features / 4;
  float acc[3] = {0.f, 0.f, 0.f};
  for (int l = 0; l < levels; ++l) {
    const int kind = plan.kind[l];
    if (kind == KIND_DRAWS) continue;
    const Level L = geo.l[l];
    const Cell cell = cell_of(x, p, L.scale, offset);
    const float4* gl = reinterpret_cast<const float4*>(
        g + (p * levels + l) * (long long)features);
    float4 gv[K2X_VEC];
#pragma unroll
    for (int k = 0; k < K2X_VEC; ++k) {
      const int v = lane + 32 * k;
      gv[k] = v < vecs ? __ldg(gl + v) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const float4* level_table = reinterpret_cast<const float4*>(
        table + (long long)l * table_size * features);
    auto dot = [&](unsigned int idx) {
      const float4* row = level_table + (long long)idx * vecs;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < K2X_VEC; ++k) {
        const int v = lane + 32 * k;
        if (v < vecs) {
          const float4 t = __ldg(row + v);
          s += gv[k].x * t.x + gv[k].y * t.y + gv[k].z * t.z + gv[k].w * t.w;
        }
      }
      return warp_sum(s);
    };
    unsigned int idx[A];
    float w[A], coef[A];
    const bool exact = kind == KIND_EXACT;
#pragma unroll
    for (int a = 0; a < A; ++a)
      atom<A>(cell, L, a, exact ? rows : nullptr, plan.first[l] + a, n, p,
              idx[a], w[a]);
    if (exact) {
#pragma unroll
      for (int a = 0; a < A; ++a) coef[a] = dot(idx[a]);
    } else {
      const long long first = plan.first[l];
      const float dm = dot((unsigned int)__ldg(rows + first * n + p));
      const float dj = dot((unsigned int)__ldg(rows + (first + 1) * n + p));
      residual_coef<A>(w, __fsub_rn(dm, dj), coef);
    }
    float ct[3];
    frac_cotangent<A>(cell, coef, ct);
#pragma unroll
    for (int d = 0; d < 3; ++d)
      acc[d] = __fadd_rn(acc[d], __fmul_rn(L.scale, ct[d]));
  }
  if (lane == 0) {
#pragma unroll
    for (int d = 0; d < 3; ++d) dx[p * 3 + d] = acc[d];
  }
}

// Narrow rows: a thread per point, walking levels, atoms and features.
template <int A>
__global__ void __launch_bounds__(K2X_THREADS)
    point_grad_lanes_kernel(const float* __restrict__ x,
                            const float* __restrict__ table,
                            const float* __restrict__ g,
                            const int* __restrict__ rows,
                            float* __restrict__ dx, Levels geo, Plan plan,
                            float offset, long long n, int levels,
                            long long table_size, int features) {
  const long long p = (long long)blockIdx.x * K2X_THREADS + threadIdx.x;
  if (p >= n) return;
  float acc[3] = {0.f, 0.f, 0.f};
  for (int l = 0; l < levels; ++l) {
    const int kind = plan.kind[l];
    if (kind == KIND_DRAWS) continue;
    const Level L = geo.l[l];
    const Cell cell = cell_of(x, p, L.scale, offset);
    const float* gl = g + (p * levels + l) * (long long)features;
    const float* level_table = table + (long long)l * table_size * features;
    auto dot = [&](unsigned int idx) {
      const float* row = level_table + (long long)idx * features;
      float s = 0.f;
      for (int f = 0; f < features; ++f)
        s = __fadd_rn(s, __fmul_rn(__ldg(gl + f), __ldg(row + f)));
      return s;
    };
    unsigned int idx[A];
    float w[A], coef[A];
    const bool exact = kind == KIND_EXACT;
#pragma unroll
    for (int a = 0; a < A; ++a)
      atom<A>(cell, L, a, exact ? rows : nullptr, plan.first[l] + a, n, p,
              idx[a], w[a]);
    if (exact) {
#pragma unroll
      for (int a = 0; a < A; ++a) coef[a] = dot(idx[a]);
    } else {
      const long long first = plan.first[l];
      const float dm = dot((unsigned int)__ldg(rows + first * n + p));
      const float dj = dot((unsigned int)__ldg(rows + (first + 1) * n + p));
      residual_coef<A>(w, __fsub_rn(dm, dj), coef);
    }
    float ct[3];
    frac_cotangent<A>(cell, coef, ct);
#pragma unroll
    for (int d = 0; d < 3; ++d)
      acc[d] = __fadd_rn(acc[d], __fmul_rn(L.scale, ct[d]));
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) dx[p * 3 + d] = acc[d];
}

static bool wide_rows(int features) {
  return features % 4 == 0 && features >= 32 &&
         features <= 32 * 4 * K2X_VEC;
}

static const void* kernel_of(int features, int atoms) {
  if (wide_rows(features))
    return atoms == 4 ? (const void*)point_grad_rows_kernel<4>
                      : (const void*)point_grad_rows_kernel<8>;
  return atoms == 4 ? (const void*)point_grad_lanes_kernel<4>
                    : (const void*)point_grad_lanes_kernel<8>;
}

static unsigned int point_blocks(long long n, int features) {
  const int chunk = wide_rows(features) ? K2X_WARPS : K2X_THREADS;
  return (unsigned int)((n + chunk - 1) / chunk);
}

// rows: null (every level EXACT, rows from the cell) or int32 (S, N), level
// l's rows from first[l]; kind[l]: 0 DRAWS, 1 RESIDUAL, 2 EXACT. A RESIDUAL
// level needs rows.
extern "C" int hashgrid_point_grad(
    const float* x, const float* table, const float* g, const int* rows,
    float* dx, const float* scale, const int* stride, const int* size,
    const int* dense, const unsigned int* magic, const int* shift,
    const int* kind, const int* first, float offset, long long n, int levels,
    long long table_size, int features, int atoms, void* stream) {
  Levels geo;
  if (!make_levels(&geo, scale, stride, size, dense, magic, shift, levels))
    return (int)cudaErrorInvalidValue;
  if (atoms != 4 && atoms != 8) return (int)cudaErrorInvalidValue;
  Plan plan;
  for (int l = 0; l < levels; ++l) {
    if (kind[l] < KIND_DRAWS || kind[l] > KIND_EXACT ||
        (kind[l] == KIND_RESIDUAL && rows == nullptr))
      return (int)cudaErrorInvalidValue;
    plan.kind[l] = kind[l];
    plan.first[l] = first[l];
  }
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned int blocks = point_blocks(n, features);
  if (wide_rows(features)) {
    if (atoms == 4)
      point_grad_rows_kernel<4><<<blocks, K2X_THREADS, 0, s>>>(
          x, table, g, rows, dx, geo, plan, offset, n, levels, table_size,
          features);
    else
      point_grad_rows_kernel<8><<<blocks, K2X_THREADS, 0, s>>>(
          x, table, g, rows, dx, geo, plan, offset, n, levels, table_size,
          features);
  } else {
    if (atoms == 4)
      point_grad_lanes_kernel<4><<<blocks, K2X_THREADS, 0, s>>>(
          x, table, g, rows, dx, geo, plan, offset, n, levels, table_size,
          features);
    else
      point_grad_lanes_kernel<8><<<blocks, K2X_THREADS, 0, s>>>(
          x, table, g, rows, dx, geo, plan, offset, n, levels, table_size,
          features);
  }
  return (int)cudaGetLastError();
}

// out[0..6): the launch shape for n points: blocks, threads, static shared
// bytes, blocks per SM, registers per thread, points per block; out[6]
// 1 for the wide-rows kernel.
extern "C" int hashgrid_point_grad_shape(int features, int atoms, long long n,
                                         int* out) {
  if (atoms != 4 && atoms != 8) return (int)cudaErrorInvalidValue;
  const void* kernel = kernel_of(features, atoms);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      K2X_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = (int)point_blocks(n, features);
  out[1] = K2X_THREADS;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = per_sm;
  out[4] = attr.numRegs;
  out[5] = wide_rows(features) ? K2X_WARPS : K2X_THREADS;
  out[6] = wide_rows(features) ? 1 : 0;
  return 0;
}
