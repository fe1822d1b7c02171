// The stochastic-corner and residual hash-grid encodes (K6): each level's
// output from a few drawn table rows instead of every interpolation atom.
//
// Replaces what XLA compiles on the TPU for autolabel_tpu/ops/encoders.py
// `_encode_stochastic` (its wide-row branch and its narrow lanes branch),
// `_encode_stochastic_simplex` and `_encode_residual`, with the finest
// `exact_levels` levels interpolated exactly (`_exact_level_rows`,
// `_exact_level_rows_simplex`, `_encode_lanes`). Each level is of one kind
// (the host's plan, encoders.stochastic_plan):
//   - DRAWS: n_samples rows, drawn in antithetic pairs (v = u, then
//     v = 1 - u in fp32) and, for odd n_samples, one more at u. Trilinear:
//     per axis the upper corner where v < frac (u (D, 3, L, N)). Simplex:
//     the atom #{k < 3 : v > cum_k}, cum the fp32 partial sums of the atom
//     weights (u (D, L, N)). Blend: each pair's sum, the pairs chained in
//     order, the single draw added, then the product with 1 / n_samples
//     (rounded once on the host): XLA compiles JAX's `acc / n_samples` to
//     that product, so the kernel is bit-equal to the JAX package there.
//   - RESIDUAL: the max-weight atom m (the first on ties) at w_m and the
//     atom j = #{a < A - 1 : u > cum_a / max(cum_{A-1}, 1e-12)}, cum the
//     partial sums of the weights with atom m zeroed, at 1 - w_m; blend
//     w_m f_m + (1 - w_m) f_j (u (L, N)).
//   - EXACT: every atom (4 simplex, 8 trilinear) at its weight, summed from
//     zero in atom order, as K1 and K1s.
// Every product and sum is rounded on its own (no FMA contraction), in the
// plain version's order (encoders.blend_drawn_rows), so kernel and plain
// version agree to the last bits; the geometry is K1's and K1s's
// (hashgrid_common.cuh). The output is fp32, the table's dtype. In training
// the kernel also writes each level's rows (the table indices, int32, as
// (S, N)) and the weights of the RESIDUAL and EXACT rows (fp32, (SW, N);
// a draw's weight is 1 / n_samples and is not stored), in the format of
// hashgrid_stochastic.cuh that the scatter of the backward
// (hashgrid_stochastic_bwd.cu) reads.
//
// What bounds it on the H100: the output stores. At TPU_GRID (4 x 2^15 x
// 128) with 2 draws and the train CLI's N = 524,288 it writes 1.07 GB and
// reads 2 rows of 512 bytes a level and point (2.1 GB, mostly from L2,
// where a level's 16 MiB table stays); the bytes it must move take about
// 0.35 ms at 3.35 TB/s. On the reference preset (16 x 2^19 x 2) the
// uniforms (D, 3, 16, N), 100 MB, are the largest stream.
//
// Design, a simple kernel first. Wide rows (F a multiple of 4, at least
// 32), K1's frame: blocks of 4 warps take one level each, levels slowest;
// a warp takes 32 / RS points (RS the plan's most rows a level, rounded up
// to a power of two); first each lane computes one (point, row)'s draw,
// table row and weight into shared memory (and, in training, to the rows
// arrays); then the lanes gather the rows float4 wide, 8 rows of loads in
// flight a lane where the points allow, blend them and stream the output
// rows out. Narrow rows (the reference's F = 2): a thread per point of one
// level, levels slowest, its RS rows in registers.
#include "hashgrid_stochastic.cuh"

#define K6_THREADS 128
#define K6_WARPS (K6_THREADS / 32)

// What the draws read: the uniforms and their axes, the atoms of the
// interpolation (4 simplex, 8 trilinear), n_samples and 1 / n_samples.
struct Draws {
  const float* u;
  long long n;
  int levels, atoms, n_samples;
  float scale;
};

// Atom a of the interpolation: its corner offset and weight.
__device__ __forceinline__ float atom_of(const Cell& cell, int a, int atoms,
                                         int (&off)[3]) {
  if (atoms == 4) return simplex_atom(cell, a, off);
  off[0] = (a >> 2) & 1;
  off[1] = (a >> 1) & 1;
  off[2] = a & 1;
  return corner_weight(cell, a);
}

// Row r of level l of point p: its table row, and its weight in w.
__device__ __forceinline__ unsigned int drawn_row(const Cell& cell,
                                                  const Level& L, int l,
                                                  long long p, int kind,
                                                  int r, const Draws& d,
                                                  float& w) {
  int off[3];
  if (kind == KIND_EXACT) {
    w = atom_of(cell, r, d.atoms, off);
  } else if (kind == KIND_RESIDUAL) {
    // the max-weight atom (the first on ties) at w_m, and a draw from the
    // others' partial sums at 1 - w_m
    float wv[8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
      wv[a] = a < d.atoms ? atom_of(cell, a, d.atoms, off) : 0.0f;
    int mx = 0;
    float wm = wv[0];
#pragma unroll
    for (int a = 1; a < 8; ++a)
      if (a < d.atoms && wv[a] > wm) {
        mx = a;
        wm = wv[a];
      }
    float cum[8];
    float c = mx == 0 ? 0.0f : wv[0];
    cum[0] = c;
#pragma unroll
    for (int a = 1; a < 8; ++a)
      if (a < d.atoms) {
        c = __fadd_rn(c, a == mx ? 0.0f : wv[a]);
        cum[a] = c;
      }
    const float den = fmaxf(c, 1e-12f);
    const float ul = d.u[(long long)l * d.n + p];
    int j = 0;
#pragma unroll
    for (int a = 0; a < 7; ++a)
      if (a < d.atoms - 1) j += ul > __fdiv_rn(cum[a], den);
    atom_of(cell, r == 0 ? mx : j, d.atoms, off);
    w = r == 0 ? wm : __fsub_rn(1.0f, wm);
  } else {
    const int pairs = d.n_samples / 2;
    const int s = r < 2 * pairs ? r >> 1 : pairs;
    const bool flip = r < 2 * pairs && (r & 1);
    w = 1.0f;
    if (d.atoms == 8) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float v = d.u[(((long long)s * 3 + a) * d.levels + l) * d.n + p];
        if (flip) v = __fsub_rn(1.0f, v);
        off[a] = v < cell.f[a];
      }
    } else {
      float wv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) wv[a] = simplex_atom(cell, a, off);
      const float c0 = wv[0], c1 = __fadd_rn(c0, wv[1]),
                  c2 = __fadd_rn(c1, wv[2]);
      float v = d.u[((long long)s * d.levels + l) * d.n + p];
      if (flip) v = __fsub_rn(1.0f, v);
      simplex_atom(cell, (v > c0) + (v > c1) + (v > c2), off);
    }
  }
  return level_corner_index(cell.c[0] + off[0], cell.c[1] + off[1],
                            cell.c[2] + off[2], L);
}

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ float mul(float a, float w) {
  return __fmul_rn(a, w);
}
__device__ __forceinline__ float4 mul(float4 a, float w) {
  return make_float4(__fmul_rn(a.x, w), __fmul_rn(a.y, w),
                     __fmul_rn(a.z, w), __fmul_rn(a.w, w));
}
__device__ __forceinline__ float zero_of(float) { return 0.0f; }
__device__ __forceinline__ float4 zero_of(float4) {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// One point's level output from its R rows v (weights w), as its kind
// blends them.
template <int RS, typename T>
__device__ __forceinline__ T blend(const T (&v)[RS], const float (&w)[RS],
                                   int R, int kind, int n_samples,
                                   float scale) {
  T acc = zero_of(v[0]);
  if (kind == KIND_DRAWS) {
    const int pairs = n_samples / 2;
#pragma unroll
    for (int s = 0; 2 * s + 1 < RS; ++s)
      if (s < pairs) {
        const T pair = add(v[2 * s], v[2 * s + 1]);
        acc = s == 0 ? pair : add(acc, pair);
      }
    if (n_samples & 1) {
#pragma unroll
      for (int r = 0; r < RS; ++r)
        if (r == R - 1) acc = pairs ? add(acc, v[r]) : v[r];
    }
    return n_samples > 1 ? mul(acc, scale) : acc;
  }
  if (kind == KIND_RESIDUAL) return add(mul(v[0], w[0]), mul(v[1], w[1]));
#pragma unroll
  for (int r = 0; r < RS; ++r)
    if (r < R) acc = add(acc, mul(v[r], w[r]));
  return acc;
}

// A warp per 32 / RS points of level blockIdx.y; lanes over features.
template <int RS>
__global__ void __launch_bounds__(K6_THREADS)
    stochastic_rows_kernel(const float* __restrict__ x,
                           const float* __restrict__ table,
                           float* __restrict__ out, int* __restrict__ idx,
                           float* __restrict__ wts, Levels geo, Plan plan,
                           Draws d, float offset, long long n, int levels,
                           long long table_size, int features) {
  constexpr int P = 32 / RS;                       // points a warp
  constexpr int Q = RS >= 8 ? 1 : 8 / RS;          // points a load round
  __shared__ __align__(16) uint2 rows[K6_WARPS][32];
  const int l = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long p0 = ((long long)blockIdx.x * K6_WARPS + warp) * P;
  if (p0 >= n) return;
  const Level L = geo.l[l];
  const int kind = plan.kind[l], R = plan.rows[l];
  const int j = lane / RS, r = lane % RS;  // lane = j * RS + r
  unsigned int row = 0;
  float w = 0.0f;  // rows past R or points past n: row 0, never stored
  if (r < R && p0 + j < n) {
    const Cell cell = cell_of(x, p0 + j, L.scale, offset);
    row = drawn_row(cell, L, l, p0 + j, kind, r, d, w);
    if (idx) {
      idx[(long long)(plan.first[l] + r) * n + p0 + j] = (int)row;
      if (kind != KIND_DRAWS)
        wts[(long long)(plan.wfirst[l] + r) * n + p0 + j] = w;
    }
  }
  rows[warp][lane] = make_uint2(row, __float_as_uint(w));
  __syncwarp();
  const float* level_table = table + (long long)l * table_size * features;
  for (int f = lane * 4; f < features; f += 128) {
    for (int q0 = 0; q0 < P; q0 += Q) {
      float4 v[Q][RS];
      float wq[Q][RS];
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int k = 0; k < RS; ++k) {
          const uint2 e = rows[warp][(q0 + q) * RS + k];
          wq[q][k] = __uint_as_float(e.y);
          v[q][k] = k < R ? __ldg(reinterpret_cast<const float4*>(
                                level_table + (long long)e.x * features + f))
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
#pragma unroll
      for (int q = 0; q < Q; ++q)
        if (p0 + q0 + q < n)
          __stcs(reinterpret_cast<float4*>(
                     out + ((p0 + q0 + q) * levels + l) * (long long)features +
                     f),
                 blend<RS>(v[q], wq[q], R, kind, d.n_samples, d.scale));
    }
  }
}

// A thread per point of level blockIdx.y; any feature width.
template <int RS>
__global__ void __launch_bounds__(K6_THREADS)
    stochastic_lanes_kernel(const float* __restrict__ x,
                            const float* __restrict__ table,
                            float* __restrict__ out, int* __restrict__ idx,
                            float* __restrict__ wts, Levels geo, Plan plan,
                            Draws d, float offset, long long n, int levels,
                            long long table_size, int features) {
  const int l = blockIdx.y;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const Level L = geo.l[l];
  const int kind = plan.kind[l], R = plan.rows[l];
  const Cell cell = cell_of(x, p, L.scale, offset);
  unsigned int row[RS];
  float w[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    row[r] = 0;
    w[r] = 0.0f;
    if (r < R) {
      row[r] = drawn_row(cell, L, l, p, kind, r, d, w[r]);
      if (idx) {
        idx[(long long)(plan.first[l] + r) * n + p] = (int)row[r];
        if (kind != KIND_DRAWS)
          wts[(long long)(plan.wfirst[l] + r) * n + p] = w[r];
      }
    }
  }
  const float* level_table = table + (long long)l * table_size * features;
  float* dst = out + (p * levels + l) * (long long)features;
  for (int f = 0; f < features; ++f) {
    float v[RS];
#pragma unroll
    for (int r = 0; r < RS; ++r)
      v[r] = r < R ? __ldg(level_table + (long long)row[r] * features + f)
                   : 0.0f;
    dst[f] = blend<RS>(v, w, R, kind, d.n_samples, d.scale);
  }
}

static const void* k6_kernel(int rs, bool wide) {
#define K6_PICK(RS)                                                   \
  if (rs == RS)                                                       \
    return wide ? (const void*)stochastic_rows_kernel<RS>             \
                : (const void*)stochastic_lanes_kernel<RS>;
  K6_PICK(1) K6_PICK(2) K6_PICK(4) K6_PICK(8) K6_PICK(16) K6_PICK(32)
#undef K6_PICK
  return nullptr;
}

// The grid, levels slowest: (point chunks, levels), a chunk K6_WARPS warps
// of 32 / rs points (wide rows) or K6_THREADS points (narrow rows).
static dim3 k6_grid(long long n, int levels, bool wide, int rs) {
  const int chunk = wide ? K6_WARPS * (32 / rs) : K6_THREADS;
  return dim3((unsigned int)((n + chunk - 1) / chunk), levels);
}

extern "C" int hashgrid_stochastic_fwd(
    const float* x, const float* table, const float* u, float* out,
    int* idx, float* w, const float* scale, const int* stride,
    const int* size, const int* dense, const unsigned int* magic,
    const int* shift, const int* kinds, const int* rows, float offset,
    long long n, int levels, long long table_size, int features, int atoms,
    int n_samples, void* stream) {
  Levels g;
  Plan plan;
  if (!make_levels(&g, scale, stride, size, dense, magic, shift, levels) ||
      (atoms != 4 && atoms != 8))
    return (int)cudaErrorInvalidValue;
  const int rs = make_plan(&plan, kinds, rows, levels, atoms, n_samples);
  if (!rs || (idx && !w && weighted_rows(plan, levels)))
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < levels; ++l)
    if (kinds[l] != KIND_EXACT && !u) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Draws d{u, n, levels, atoms, n_samples, 1.0f / (float)n_samples};
  const bool wide = wide_rows(features);
  const dim3 grid = k6_grid(n, levels, wide, rs);
  cudaStream_t s = (cudaStream_t)stream;
#define K6_LAUNCH(RS)                                                        \
  if (rs == RS) {                                                            \
    if (wide)                                                                \
      stochastic_rows_kernel<RS><<<grid, K6_THREADS, 0, s>>>(                \
          x, table, out, idx, w, g, plan, d, offset, n, levels, table_size,  \
          features);                                                         \
    else                                                                     \
      stochastic_lanes_kernel<RS><<<grid, K6_THREADS, 0, s>>>(               \
          x, table, out, idx, w, g, plan, d, offset, n, levels, table_size,  \
          features);                                                         \
  }
  K6_LAUNCH(1) K6_LAUNCH(2) K6_LAUNCH(4) K6_LAUNCH(8) K6_LAUNCH(16)
  K6_LAUNCH(32)
#undef K6_LAUNCH
  return (int)cudaGetLastError();
}

// out[0..7): the launch shape for n points and this plan: blocks, threads,
// static shared bytes, blocks per SM, registers per thread, points per warp
// (1 for the narrow kernel's thread per point and level), and 1 for the
// wide kernel, 0 for the narrow one.
extern "C" int hashgrid_stochastic_shape(const int* kinds, const int* rows,
                                         int levels, int features,
                                         long long n, int atoms,
                                         int n_samples, int* out) {
  Plan plan;
  if (atoms != 4 && atoms != 8) return (int)cudaErrorInvalidValue;
  const int rs = make_plan(&plan, kinds, rows, levels, atoms, n_samples);
  const bool wide = wide_rows(features);
  const void* kernel = k6_kernel(rs, wide);
  if (!kernel) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      K6_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = k6_grid(n, levels, wide, rs);
  out[0] = (int)(grid.x * grid.y);
  out[1] = K6_THREADS;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = per_sm;
  out[4] = attr.numRegs;
  out[5] = wide ? 32 / rs : 1;
  out[6] = wide;
  return 0;
}
