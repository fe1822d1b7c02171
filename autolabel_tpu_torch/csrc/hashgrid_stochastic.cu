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
// (hashgrid_stochastic_bwd.cu) reads. A level may draw any count of rows:
// both kernels fold them into the blend in rounds of K6_ROUND, in order,
// the sum carried in fp32 registers from round to round (fp32 stores and
// reloads are exact, so the rounds change no bit).
//
// What bounds it on the H100: bytes. At TPU_GRID (4 x 2^15 x 128) with 2
// draws and the train CLI's N = 524,288 it writes 1.07 GB of output and
// gathers 2 rows of 512 bytes a level and point (2.1 GB, from L2, where a
// level's 16 MiB table stays); the bytes it must move take about 0.35 ms
// at 3.35 TB/s. On the reference preset (16 x 2^19 x 2) the uniforms
// (D, 3, 16, N), 100 MB, the rows written (117 MB of indices, 67 MB of
// weights at 4 exact levels) and the 67 MB output are the streams.
//
// Design. Wide rows (F a multiple of 4, at least 32), K1s's frame: blocks
// of 4 warps take one level each, levels slowest, capped at 64 registers a
// thread so an SM holds 32 warps with their loads in flight; a warp takes
// K6_POINTS points and streams their (point, row) entries, point by point:
// each lane draws one entry's row and weight into shared memory (and, in
// training, to the rows arrays), then the warp gathers K6_ROUND of them at
// once, float4 wide, and folds them into the blend, storing a point's
// output row as its last row is folded. Narrow rows (the reference's F =
// 2): a thread per (point, slice of W = 2 or 1 features) walks the
// point's levels (blocks of 128 threads, 64 registers), folds each
// level's rows in rounds of K6_LANE_ROUND float2 loads, its registers
// sized by the round, not by the most rows a level, and stages its
// outputs in shared memory; a warp then stores its 32 points' output
// rows whole, 16 bytes a lane, where a level at a time left 8 bytes of
// each 32-byte sector to 4 blocks far apart in time. Its level loop
// unrolled by 2 ran 1.16 times slower, and at 40 registers (48 warps an
// SM) it spilled and ran 2.1 times slower (NVIDIA H100 80GB HBM3, 700 W;
// kernel_compare.py at the reference preset's N = 524,288).
// K6_PART_* select parts of the work for timing them alone (the
// production launch takes them all).
#include "hashgrid_stochastic.cuh"

#define K6_THREADS 128
#define K6_WARPS (K6_THREADS / 32)
#define K6_MIN_BLOCKS 8  // 64 registers a thread, 32 warps an SM
#define K6_POINTS 16     // wide rows: points a warp
#define K6_ROUND 8       // wide rows: rows gathered at once
#define K6_LANE_ROUND 4  // narrow rows: rows a thread gathers at once
#define K6_STAGE 32      // narrow rows: most floats a thread stages
#define K6_PART_DRAW 1    // draw the rows (and write them in training)
#define K6_PART_GATHER 2  // gather and blend them
#define K6_PART_STORE 4   // store the output
#define K6_PART_ALL 7

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
    const float ul = __ldg(d.u + (long long)l * d.n + p);
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
        float v = __ldg(d.u + (((long long)s * 3 + a) * d.levels + l) * d.n + p);
        if (flip) v = __fsub_rn(1.0f, v);
        off[a] = v < cell.f[a];
      }
    } else {
      float wv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) wv[a] = simplex_atom(cell, a, off);
      const float c0 = wv[0], c1 = __fadd_rn(c0, wv[1]),
                  c2 = __fadd_rn(c1, wv[2]);
      float v = __ldg(d.u + ((long long)s * d.levels + l) * d.n + p);
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
__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
__device__ __forceinline__ float2 mul(float2 a, float w) {
  return make_float2(__fmul_rn(a.x, w), __fmul_rn(a.y, w));
}
__device__ __forceinline__ float zero_of(float) { return 0.0f; }
__device__ __forceinline__ float2 zero_of(float2) {
  return make_float2(0.0f, 0.0f);
}
__device__ __forceinline__ float4 zero_of(float4) {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Row r of a level's R rows, value v (weight w), folded into the blend in
// the plain version's order (encoders.blend_drawn_rows): a pair's first
// draw kept in `hold`, each pair's sum chained into acc, the odd draw
// added last, then the product with 1 / n_samples; w_m f_m + w_j f_j for
// RESIDUAL; w f summed from zero in row order for EXACT. True where r is
// the level's last row: acc then holds the level's output.
template <typename T>
__device__ __forceinline__ bool fold(T& acc, T& hold, T v, float w, int r,
                                     int R, int kind, int n_samples,
                                     float scale) {
  if (kind == KIND_DRAWS) {
    const int pairs = n_samples >> 1;
    if (r < 2 * pairs) {
      if (!(r & 1)) {
        hold = v;
      } else {
        const T pair = add(hold, v);
        acc = r == 1 ? pair : add(acc, pair);
      }
    } else {
      acc = pairs ? add(acc, v) : v;
    }
    if (r == R - 1 && n_samples > 1) acc = mul(acc, scale);
  } else if (kind == KIND_RESIDUAL) {
    acc = r == 0 ? mul(v, w) : add(acc, mul(v, w));
  } else {
    acc = add(r == 0 ? zero_of(v) : acc, mul(v, w));
  }
  return r == R - 1;
}

// A warp per K6_POINTS points of level blockIdx.y; lanes over features.
template <int PARTS>
__global__ void __launch_bounds__(K6_THREADS, K6_MIN_BLOCKS)
    stochastic_rows_kernel(const float* __restrict__ x,
                           const float* __restrict__ table,
                           float* __restrict__ out, int* __restrict__ idx,
                           float* __restrict__ wts, Levels geo, Plan plan,
                           Draws d, float offset, long long n, int levels,
                           long long table_size, int features) {
  __shared__ __align__(8) uint2 rows[K6_WARPS][32];
  const int l = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long p0 = ((long long)blockIdx.x * K6_WARPS + warp) * K6_POINTS;
  if (p0 >= n) return;
  const int total = (int)min((long long)K6_POINTS, n - p0) * plan.rows[l];
  const Level L = geo.l[l];
  const int kind = plan.kind[l], R = plan.rows[l];
  const float* level_table = table + (long long)l * table_size * features;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int f0 = 0; f0 < features; f0 += 128) {
    const int f = f0 + lane * 4;
    const bool live = f < features;
    float4 acc = zero, hold = zero;
    int j = 0, r = 0;  // the point and row the warp folds next
    for (int e0 = 0; e0 < total; e0 += 32) {
      // lane k draws entry e0 + k: point e / R, row e % R
      unsigned int row = 0;
      float w = 0.0f;
      const int e = e0 + lane;
      if ((PARTS & K6_PART_DRAW) && e < total) {
        const int je = e / R, re = e - je * R;
        const long long p = p0 + je;
        const Cell cell = cell_of(x, p, L.scale, offset);
        row = drawn_row(cell, L, l, p, kind, re, d, w);
        if (idx && f0 == 0) {
          idx[(long long)(plan.first[l] + re) * n + p] = (int)row;
          if (kind != KIND_DRAWS)
            wts[(long long)(plan.wfirst[l] + re) * n + p] = w;
        }
      }
      __syncwarp();
      rows[warp][lane] = make_uint2(row, __float_as_uint(w));
      __syncwarp();
      const int count = min(32, total - e0);
      for (int k0 = 0; k0 < count; k0 += K6_ROUND) {
        float4 v[K6_ROUND];
#pragma unroll
        for (int k = 0; k < K6_ROUND; ++k)
          v[k] = (PARTS & K6_PART_GATHER) && live && k0 + k < count
                     ? __ldg(reinterpret_cast<const float4*>(
                           level_table +
                           (long long)rows[warp][k0 + k].x * features + f))
                     : zero;
#pragma unroll
        for (int k = 0; k < K6_ROUND; ++k) {
          if (k0 + k >= count) break;
          const float wk = __uint_as_float(rows[warp][k0 + k].y);
          if (!fold(acc, hold, v[k], wk, r, R, kind, d.n_samples, d.scale)) {
            ++r;
            continue;
          }
          float* dst = out + ((p0 + j) * levels + l) * (long long)features + f;
          if ((PARTS & K6_PART_STORE) && live)
            __stcs(reinterpret_cast<float4*>(dst), acc);
          else if (live && acc.x == 1.0e30f)  // keeps a timed gather alive
            *dst = acc.y;
          ++j;
          r = 0;
        }
      }
    }
  }
}

template <int W>
struct Slice;
template <>
struct Slice<1> {
  typedef float T;
  static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
};
template <>
struct Slice<2> {
  typedef float2 T;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
};

// A thread per (point, slice of W features) walks levels [g0, g0 + group)
// of its point, g0 = blockIdx.y * group; any feature width (W = 2 where F
// is even). Dynamic shared memory: K6_THREADS * group * W floats, where
// each thread stages its group's outputs; where a point's outputs of the
// group are contiguous (one slice) and whole 16-byte pieces, a warp then
// stores its 32 points' together, two lanes to a 32-byte sector.
template <int W, int PARTS>
__global__ void __launch_bounds__(K6_THREADS, K6_MIN_BLOCKS)
    stochastic_lanes_kernel(const float* __restrict__ x,
                            const float* __restrict__ table,
                            float* __restrict__ out, int* __restrict__ idx,
                            float* __restrict__ wts, Levels geo, Plan plan,
                            Draws d, float offset, long long n, int levels,
                            long long table_size, int features, int group) {
  typedef typename Slice<W>::T T;
  extern __shared__ __align__(16) float stage[];
  const int slices = features / W;
  const long long t = (long long)blockIdx.x * K6_THREADS + threadIdx.x;
  const long long p = t / slices;
  const int s = (int)(t - p * slices);
  const int g0 = blockIdx.y * group;
  const int levels_here = min(group, levels - g0);
  T* mine = reinterpret_cast<T*>(stage + threadIdx.x * group * W);
#pragma unroll 1
  for (int k = 0; p < n && k < levels_here; ++k) {
    const int l = g0 + k;
    const Level L = geo.l[l];
    const int kind = plan.kind[l], R = plan.rows[l];
    const Cell cell = cell_of(x, p, L.scale, offset);
    const float* level_table =
        table + (long long)l * table_size * features + s * W;
    const T zero = zero_of(T());
    T acc = zero, hold = zero;
    for (int r0 = 0; r0 < R; r0 += K6_LANE_ROUND) {
      unsigned int row[K6_LANE_ROUND];
      float w[K6_LANE_ROUND];
      T v[K6_LANE_ROUND];
#pragma unroll
      for (int c = 0; c < K6_LANE_ROUND; ++c) {
        const int r = r0 + c;
        row[c] = 0;
        w[c] = 0.0f;
        if ((PARTS & K6_PART_DRAW) && r < R) {
          row[c] = drawn_row(cell, L, l, p, kind, r, d, w[c]);
          if (idx && s == 0) {
            idx[(long long)(plan.first[l] + r) * n + p] = (int)row[c];
            if (kind != KIND_DRAWS)
              wts[(long long)(plan.wfirst[l] + r) * n + p] = w[c];
          }
        }
      }
#pragma unroll
      for (int c = 0; c < K6_LANE_ROUND; ++c)
        v[c] = (PARTS & K6_PART_GATHER) && r0 + c < R
                   ? Slice<W>::load(level_table +
                                    (long long)row[c] * features)
                   : zero;
#pragma unroll
      for (int c = 0; c < K6_LANE_ROUND; ++c)
        if (r0 + c < R)
          fold(acc, hold, v[c], w[c], r0 + c, R, kind, d.n_samples, d.scale);
    }
    mine[k] = acc;
  }
  const float* got = stage + threadIdx.x * group * W;
  if (!(PARTS & K6_PART_STORE)) {
    if (p < n && got[0] == 1.0e30f) out[0] = got[1];  // keeps the gathers
    return;
  }
  const int pieces = levels_here * W / 4;  // 16-byte pieces a point
  if (slices == 1 && (group * W) % 4 == 0 && (levels_here * W) % 4 == 0 &&
      (levels * features) % 4 == 0 && (g0 * features) % 4 == 0) {
    // the warp's 32 points (t = p: one slice), piece c of point c / pieces
    __syncwarp();
    const int lane = threadIdx.x & 31;
    const long long p0 = p - lane;
    const float* warp_stage = stage + (threadIdx.x - lane) * group * W;
    for (int c = lane; c < 32 * pieces; c += 32) {
      const int j = c / pieces, q = c - j * pieces;
      if (p0 + j < n)
        __stcs(reinterpret_cast<float4*>(
                   out + ((p0 + j) * levels + g0) * (long long)features) +
                   q,
               reinterpret_cast<const float4*>(warp_stage +
                                               j * group * W)[q]);
    }
    return;
  }
  if (p >= n) return;
  float* dst = out + (p * levels + g0) * (long long)features + s * W;
  for (int k = 0; k < levels_here; ++k)
    for (int i = 0; i < W; ++i) __stcs(dst + k * features + i, got[k * W + i]);
}

// The levels a narrow-rows thread walks: `group` where the caller sets it,
// else every level, at most what K6_STAGE holds. Walking a point's levels
// its thread writes the point's whole output row at once: 0.2931 ms at
// the reference preset's N = 524,288, against 0.3113 in groups of 4 (a
// 32-byte sector a point) and 0.7819 a level at a time, though its
// gathers then reach all 16 tables, 64 MiB, more than L2 holds (NVIDIA
// H100 80GB HBM3, 700 W; kernel_compare.py's parts).
static int k6_group(int features, int levels, int group) {
  const int most = K6_STAGE / (features % 2 == 0 ? 2 : 1);
  return max(1, min(group > 0 ? group : levels, min(most, levels)));
}

static dim3 k6_grid(long long n, int levels, int features, int group) {
  if (wide_rows(features))
    return dim3((unsigned int)((n + K6_WARPS * K6_POINTS - 1) /
                               (K6_WARPS * K6_POINTS)),
                levels);
  const long long threads = n * (features % 2 == 0 ? features / 2 : features);
  return dim3((unsigned int)((threads + K6_THREADS - 1) / K6_THREADS),
              (levels + group - 1) / group);
}

static const void* k6_kernel(int features, int parts) {
  const bool wide = wide_rows(features), even = features % 2 == 0;
#define K6_PICK(P)                                                   \
  if (parts == P)                                                    \
    return wide ? (const void*)stochastic_rows_kernel<P>             \
                : even ? (const void*)stochastic_lanes_kernel<2, P>  \
                       : (const void*)stochastic_lanes_kernel<1, P>;
  K6_PICK(1) K6_PICK(3) K6_PICK(4) K6_PICK(K6_PART_ALL)
#undef K6_PICK
  return nullptr;
}

// parts: K6_PART_ALL for the encode; 1 (draws and rows written), 3 (draws,
// gathers and blend) or 4 (stores) for timing a part alone. group: the
// narrow rows' levels a thread walks, 0 to choose (k6_group).
extern "C" int hashgrid_stochastic_fwd(
    const float* x, const float* table, const float* u, float* out,
    int* idx, float* w, const float* scale, const int* stride,
    const int* size, const int* dense, const unsigned int* magic,
    const int* shift, const int* kinds, const int* rows, float offset,
    long long n, int levels, long long table_size, int features, int atoms,
    int n_samples, int parts, int group, void* stream) {
  Levels g;
  Plan plan;
  if (!make_levels(&g, scale, stride, size, dense, magic, shift, levels) ||
      (atoms != 4 && atoms != 8) || features < 1 ||
      !make_plan(&plan, kinds, rows, levels, atoms, n_samples) ||
      (idx && !w && weighted_rows(plan, levels)) ||
      !k6_kernel(features, parts))
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < levels; ++l)
    if (kinds[l] != KIND_EXACT && !u) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Draws d{u, n, levels, atoms, n_samples, 1.0f / (float)n_samples};
  group = k6_group(features, levels, group);
  const dim3 grid = k6_grid(n, levels, features, group);
  const size_t smem =
      (size_t)K6_THREADS * group * (features % 2 == 0 ? 2 : 1) * 4;
  cudaStream_t s = (cudaStream_t)stream;
#define K6_LAUNCH(P)                                                         \
  if (parts == P) {                                                          \
    if (wide_rows(features))                                                 \
      stochastic_rows_kernel<P><<<grid, K6_THREADS, 0, s>>>(                 \
          x, table, out, idx, w, g, plan, d, offset, n, levels, table_size,  \
          features);                                                         \
    else if (features % 2 == 0)                                              \
      stochastic_lanes_kernel<2, P><<<grid, K6_THREADS, smem, s>>>(          \
          x, table, out, idx, w, g, plan, d, offset, n, levels, table_size,  \
          features, group);                                                  \
    else                                                                     \
      stochastic_lanes_kernel<1, P><<<grid, K6_THREADS, smem, s>>>(          \
          x, table, out, idx, w, g, plan, d, offset, n, levels, table_size,  \
          features, group);                                                  \
  }
  K6_LAUNCH(1) K6_LAUNCH(3) K6_LAUNCH(4) K6_LAUNCH(K6_PART_ALL)
#undef K6_LAUNCH
  return (int)cudaGetLastError();
}

// out[0..8): the launch shape for n points and this plan: blocks, threads,
// shared bytes (static and dynamic), blocks per SM, registers per thread,
// points per warp (the wide kernel's; 1 for the narrow kernel's thread per
// point and slice), 1 for the wide kernel (0 narrow) and the levels a
// narrow thread walks (1 wide).
extern "C" int hashgrid_stochastic_shape(const int* kinds, const int* rows,
                                         int levels, int features,
                                         long long n, int atoms,
                                         int n_samples, int* out) {
  Plan plan;
  if ((atoms != 4 && atoms != 8) || features < 1 ||
      !make_plan(&plan, kinds, rows, levels, atoms, n_samples))
    return (int)cudaErrorInvalidValue;
  const bool wide = wide_rows(features);
  const void* kernel = k6_kernel(features, K6_PART_ALL);
  const int group = wide ? 1 : k6_group(features, levels, 0);
  const size_t smem =
      wide ? 0 : (size_t)K6_THREADS * group * (features % 2 == 0 ? 2 : 1) * 4;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      K6_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = k6_grid(n, levels, features, group);
  out[0] = (int)(grid.x * grid.y);
  out[1] = K6_THREADS;
  out[2] = (int)(attr.sharedSizeBytes + smem);
  out[3] = per_sm;
  out[4] = attr.numRegs;
  out[5] = wide ? K6_POINTS : 1;
  out[6] = wide;
  out[7] = group;
  return 0;
}
