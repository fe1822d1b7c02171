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
// scale, summed over levels from 0 in level order: dx (N, 3). Its plain
// version is ops/encoders.hashgrid_encode_point_grad_plain.
//
// What bounds it on the H100: bytes. It reads g (N x L x F fp32: 268 MB at
// TPU_GRID for N = 131,072) once and writes dx (N x 3); the table rows it
// gathers (A of F floats a point and level, 1.07 GB at TPU_GRID simplex)
// come from L2 where one level's table (16 MiB at TPU_GRID) stays.
//
// Design. Wide rows (F a multiple of 4, 32 <= F <= 512), K1s's frame
// (hashgrid_atoms.cu): blocks of 4 warps each take one level, the level
// the slowest index of the grid and only the levels that carry a gradient
// launched, so one level's table is live in L2 at a time; registers capped
// at 64 a thread (K2X_MIN_BLOCKS), 32 warps an SM. A warp takes P = 32 / A
// points of its level; lane a * P + j finds point j's atom a (its row from
// the caller's rows where given: K1s's (L A, N) atoms or K6's (S, N) drawn
// rows; else level_corner_index) into shared memory. Point by point the
// lanes read the point's g row (streamed, __ldcs) and its A table rows,
// float4 wide, all independent loads, and keep A partial dot products.
// One reduce-scatter a warp replaces A butterflies a point: each point's
// A partials are halved with lane ^ 16, lane ^ 8, ... (the atom bits of
// the lane), leaving one value a point, then the P points' with the point
// bits: 31 shuffles a warp (simplex: 3 a point and 7; trilinear: 7 a point
// and 3), where butterflies took 5 a dot (20 and 40 a point); the pairs
// are added in the butterflies' tree, so dx is bit-equal to the first
// design's. Lane a * P + j ends with coef_a of point j; lane j gathers its
// point's A coefs by A shuffles, finishes the level's cotangent
// (frac_cotangent, residual_coef) and streams scale * ct to a per-level
// partial, fp32 (L', N, 3), from the pool of the caller's allocator. A
// second launch (level_sum_kernel) sums the partials in level order from
// 0, as the plain version does: no atomics, the same bits on every run.
// Narrow rows (F < 32 or not a multiple of 4; the tcnn lattice's F = 2):
// a thread a point walking its levels (point_grad_points_kernel), its
// warp's g rows staged whole in shared memory.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; kernel_compare.py at N =
// 131,072, in turns with the first design, a warp a point walking its
// levels with a butterfly a dot; device ms, events in brackets): TPU_GRID
// simplex 0.1789 (0.1864) against 0.3414 (0.3419), trilinear 0.2970
// against 0.7292, the registration iteration's inputs 0.1473 against
// 0.3216. Its parts alone (K2X_PART_*, TPU_GRID simplex): g's stream
// 0.0966, the gathers 0.1331, the reduction and the partials' stores
// 0.0294, the level sum 0.0030: the gathers from L2 set the time, as
// K1s's do. Variants that lost, built from this source by hand and timed
// in turns (simplex / trilinear): two or four groups of P points a warp,
// their atoms found together, 0.1810 / 0.3009 and 0.1901 / 0.3050
// against 0.1791 / 0.2975; g read through __ldg instead of streamed,
// 0.1823 / 0.2976; 72 registers (24 warps an SM), 0.1792 / 0.3002. On
// narrow rows, a thread a point walking its levels took 0.1314 (0.1398)
// at the tcnn lattice's 16 levels against 0.1448 (0.1689) for levels
// slowest with the same per-level partials, a thread a point of one
// level; on Run D's plan (4 exact levels of 16) 0.0455 (0.1264) against
// 0.0450 (0.1307).
// K2X_PART_* select parts of the wide kernel's work, and the level sum
// alone, for timing them (the production launch takes them all).
#include "hashgrid_common.cuh"

#define K2X_THREADS 128
#define K2X_WARPS (K2X_THREADS / 32)
#define K2X_MIN_BLOCKS 8  // 64 registers a thread, 32 warps an SM
#define K2X_SUM_THREADS 256
#define K2X_STAGE 32       // narrow rows: most g floats a point staged at once
#define K2X_PART_G 1       // stream g
#define K2X_PART_GATHER 2  // gather the table rows
#define K2X_PART_REDUCE 4  // reduce, the level's cotangent, the partial's store
#define K2X_PART_ALL 7
#define K2X_PART_SUM 8     // the level sum alone
#define KIND_DRAWS 0
#define KIND_RESIDUAL 1
#define KIND_EXACT 2

struct Plan {
  int kind[MAX_LEVELS];
  int first[MAX_LEVELS];
  int level[MAX_LEVELS];  // the levels that carry a gradient, in order
  int count;
};

// Atom a's corner offset and weight at `cell` (trilinear corners in
// encoders._CORNERS order, or the simplex atoms).
template <int A>
__device__ __forceinline__ float atom_weight(const Cell& cell, int a,
                                             int (&off)[3]) {
  if (A == 4) return simplex_atom(cell, a, off);
  off[0] = (a >> 2) & 1;
  off[1] = (a >> 1) & 1;
  off[2] = a & 1;
  return corner_weight(cell, a);
}

// Row r of point p's level l: an EXACT level's atom r (from the caller's
// rows where given, else from the cell), a RESIDUAL level's drawn row r.
template <int A>
__device__ __forceinline__ unsigned int level_row(const Cell& cell,
                                                  const Level& L, int kind,
                                                  int r,
                                                  const int* __restrict__ rows,
                                                  int first, long long n,
                                                  long long p) {
  if (rows != nullptr)
    return (unsigned int)__ldg(rows + (long long)(first + r) * n + p);
  int off[3];
  atom_weight<A>(cell, r, off);
  return level_corner_index(cell.c[0] + off[0], cell.c[1] + off[1],
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

// The level's scaled cotangent from the coefs of its D rows (A atoms of an
// EXACT level; the two drawn rows of a RESIDUAL one).
template <int A>
__device__ __forceinline__ void level_cotangent(const Cell& cell, int kind,
                                                const float (&dots)[A],
                                                float scale, float (&ct)[3]) {
  float coef[A];
  if (kind == KIND_EXACT) {
#pragma unroll
    for (int a = 0; a < A; ++a) coef[a] = dots[a];
  } else {
    float w[A];
    int off[3];
#pragma unroll
    for (int a = 0; a < A; ++a) w[a] = atom_weight<A>(cell, a, off);
    residual_coef<A>(w, __fsub_rn(dots[0], dots[1]), coef);
  }
  frac_cotangent<A>(cell, coef, ct);
#pragma unroll
  for (int d = 0; d < 3; ++d) ct[d] = __fmul_rn(scale, ct[d]);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float sum4(float4 a) {
  return (a.x + a.y) + (a.z + a.w);
}

// One halving stage after another: v's first K values, lanes with bit M
// keeping the upper half and taking their partner's (lane ^ M) lower half,
// down to one value; value i ends in the lane whose bits M, M / 2, ... are
// the bits of i from the top.
template <int N, int K, int M>
struct Halve {
  static __device__ __forceinline__ float run(float (&v)[N], int lane) {
    const bool up = (lane & M) != 0;
#pragma unroll
    for (int i = 0; i < K / 2; ++i) {
      const float keep = up ? v[i + K / 2] : v[i];
      const float send = up ? v[i] : v[i + K / 2];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
    }
    return Halve<N, K / 2, M / 2>::run(v, lane);
  }
};

template <int N, int M>
struct Halve<N, 1, M> {
  static __device__ __forceinline__ float run(float (&v)[N], int) {
    return v[0];
  }
};

// Wide rows: a warp per P = 32 / A points of level plan.level[blockIdx.y];
// lanes over features, float4 wide. partials: (plan.count, N, 3).
template <int A, int PARTS>
__global__ void __launch_bounds__(K2X_THREADS, K2X_MIN_BLOCKS)
    point_grad_levels_kernel(const float* __restrict__ x,
                             const float* __restrict__ table,
                             const float* __restrict__ g,
                             const int* __restrict__ rows,
                             float* __restrict__ partials, Levels geo,
                             Plan plan, float offset, long long n,
                             int levels, long long table_size,
                             int features) {
  constexpr int P = 32 / A;  // points a warp
  __shared__ unsigned int row_of[K2X_WARPS][32];
  const int k = blockIdx.y;
  const int l = plan.level[k], kind = plan.kind[l];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long p0 = ((long long)blockIdx.x * K2X_WARPS + warp) * P;
  if (p0 >= n) return;
  const Level L = geo.l[l];
  const int j = lane % P, a = lane / P;  // lane = a * P + j
  const long long p = p0 + j;
  const int D = kind == KIND_EXACT ? A : 2;  // rows a point reads
  unsigned int row = 0;  // points past n and unused atoms: row 0, no load
  if (p < n && a < D)
    row = level_row<A>(cell_of(x, p, L.scale, offset), L, kind, a, rows,
                       plan.first[l], n, p);
  row_of[warp][lane] = row;
  __syncwarp();
  const float* level_table = table + (long long)l * table_size * features;
  const float* gw = g + (p0 * levels + l) * (long long)features;
  const long long g_step = (long long)levels * features;  // a point's g row
  float acc[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    float part[A];
#pragma unroll
    for (int b = 0; b < A; ++b) part[b] = 0.f;
    const bool live = p0 + q < n;
    for (int f = lane * 4; f < features; f += 128) {
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 gv =
          (PARTS & K2X_PART_G) && live
              ? __ldcs(reinterpret_cast<const float4*>(gw + q * g_step + f))
              : zero;
      float4 t[A];
#pragma unroll
      for (int b = 0; b < A; ++b)
        t[b] = (PARTS & K2X_PART_GATHER) && live && b < D
                   ? __ldg(reinterpret_cast<const float4*>(
                         level_table +
                         (long long)row_of[warp][b * P + q] * features + f))
                   : zero;
#pragma unroll
      for (int b = 0; b < A; ++b)
        part[b] += PARTS == K2X_PART_ALL ? dot4(gv, t[b])
                                         : sum4(gv) + sum4(t[b]);
    }
    if (!(PARTS & K2X_PART_REDUCE)) {
      acc[q] = part[0];
#pragma unroll
      for (int b = 1; b < A; ++b) acc[q] += part[b];
      continue;
    }
    if (PARTS == K2X_PART_REDUCE) {  // the reduction alone: runtime values
#pragma unroll
      for (int b = 0; b < A; ++b)
        part[b] = (float)row_of[warp][b * P + q];
    }
    acc[q] = Halve<A, A, 16>::run(part, lane);  // atom bits: 16 .. P
  }
  if (!(PARTS & K2X_PART_REDUCE)) {  // keep the loads; never stores
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < P; ++q) s += acc[q];
    if (s == 1.0e30f) partials[0] = s;
    return;
  }
  const float coef = Halve<P, P, P / 2>::run(acc, lane);  // point bits
  // lane a * P + j holds coef_a of point j; lane j gathers its point's
  float dots[A];
#pragma unroll
  for (int b = 0; b < A; ++b)
    dots[b] = __shfl_sync(0xffffffffu, coef, b * P + j);
  if (a == 0 && p < n) {
    float ct[3];
    level_cotangent<A>(cell_of(x, p, L.scale, offset), kind, dots, L.scale,
                       ct);
    float* out = partials + ((long long)k * n + p) * 3;
#pragma unroll
    for (int d = 0; d < 3; ++d) __stcs(out + d, ct[d]);
  }
}

// dx = the partials summed in level order from 0: a thread an element.
__global__ void __launch_bounds__(K2X_SUM_THREADS)
    level_sum_kernel(const float* __restrict__ partials,
                     float* __restrict__ dx, long long count, int parts) {
  const long long e = (long long)blockIdx.x * K2X_SUM_THREADS + threadIdx.x;
  if (e >= count) return;
  float acc = 0.f;
#pragma unroll 4
  for (int k = 0; k < parts; ++k)
    acc = __fadd_rn(acc, __ldcs(partials + (long long)k * count + e));
  dx[e] = acc;
}

// W features of a row at once: float2 where F is even, else one float.
template <int W>
struct Slice;
template <>
struct Slice<1> {
  static __device__ __forceinline__ float2 load(const float* p) {
    return make_float2(__ldg(p), 0.f);
  }
};
template <>
struct Slice<2> {
  static __device__ __forceinline__ float2 load(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
};

// Narrow rows: one point's level l, its g at gl (shared or global memory):
// the dots of its D rows, read W features at a time, a round of A loads.
template <int A, int W>
__device__ __forceinline__ void narrow_level(
    const Cell& cell, const Level& L, int l, int kind, int first,
    const float* __restrict__ table, const float* gl,
    const int* __restrict__ rows, long long n, long long p,
    long long table_size, int features, float (&dots)[A]) {
  const int D = kind == KIND_EXACT ? A : 2;
  unsigned int row[A];
#pragma unroll
  for (int b = 0; b < A; ++b) {
    dots[b] = 0.f;
    row[b] = b < D ? level_row<A>(cell, L, kind, b, rows, first, n, p) : 0u;
  }
  const float* level_table = table + (long long)l * table_size * features;
  for (int f = 0; f < features; f += W) {
    float2 t[A];
#pragma unroll
    for (int b = 0; b < A; ++b)
      t[b] = b < D ? Slice<W>::load(level_table +
                                    (long long)row[b] * features + f)
                   : make_float2(0.f, 0.f);
    const float g0 = gl[f], g1 = W == 2 ? gl[f + 1] : 0.f;
#pragma unroll
    for (int b = 0; b < A; ++b) {
      dots[b] = __fadd_rn(dots[b], __fmul_rn(g0, t[b].x));
      if (W == 2) dots[b] = __fadd_rn(dots[b], __fmul_rn(g1, t[b].y));
    }
  }
}

// Narrow rows, a thread a point walking its levels (K6's choice on this
// lattice). A warp first moves its 32 points' g rows of `group` levels into
// shared memory whole (float4 wide where the staged span is the points'
// whole rows), each point's at a pitch of span | 1 floats so that the
// threads' reads fall in distinct banks; each thread then reads its levels'
// g from there. F > K2X_STAGE is read from global memory in place.
template <int A, int W>
__global__ void __launch_bounds__(K2X_THREADS, K2X_MIN_BLOCKS)
    point_grad_points_kernel(const float* __restrict__ x,
                             const float* __restrict__ table,
                             const float* __restrict__ g,
                             const int* __restrict__ rows,
                             float* __restrict__ dx, Levels geo, Plan plan,
                             float offset, long long n, int levels,
                             long long table_size, int features, int group) {
  extern __shared__ __align__(16) float stage[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long p0 = ((long long)blockIdx.x * K2X_WARPS + warp) * 32;
  if (p0 >= n) return;
  const long long p = p0 + lane;
  const int pts = (int)min(32LL, n - p0);
  const long long row_len = (long long)levels * features;
  const bool staged = group > 0;
  const int span = staged ? group * features : 0, pitch = span | 1;
  float* mine = stage + warp * 32 * pitch;
  float acc[3] = {0.f, 0.f, 0.f};
  for (int g0 = 0; g0 < levels; g0 += staged ? group : levels) {
    const int here = staged ? min(group, levels - g0) : levels;
    if (staged) {
      const int cnt = here * features;
      __syncwarp();
      if (cnt == row_len && (row_len & 3) == 0) {
        // the warp's points' whole rows: one contiguous span, float4 wide
        const float4* src = reinterpret_cast<const float4*>(g + p0 * row_len);
        for (int e4 = lane; e4 < pts * cnt / 4; e4 += 32) {
          const float4 v = __ldcs(src + e4);
          const int e = e4 * 4, q = e / cnt, i = e - q * cnt;
          float* dst = mine + q * pitch + i;  // 4 | cnt: one point's
          dst[0] = v.x;
          dst[1] = v.y;
          dst[2] = v.z;
          dst[3] = v.w;
        }
      } else {
        for (int e = lane; e < pts * cnt; e += 32) {
          const int q = e / cnt, i = e - q * cnt;
          mine[q * pitch + i] =
              __ldcs(g + (p0 + q) * row_len + (long long)g0 * features + i);
        }
      }
      __syncwarp();
    }
    if (p >= n) continue;
    for (int h = 0; h < here; ++h) {
      const int l = g0 + h, kind = plan.kind[l];
      if (kind == KIND_DRAWS) continue;
      const Level L = geo.l[l];
      const Cell cell = cell_of(x, p, L.scale, offset);
      const float* gl = staged ? mine + lane * pitch + h * features
                               : g + p * row_len + (long long)l * features;
      float dots[A], ct[3];
      narrow_level<A, W>(cell, L, l, kind, plan.first[l], table, gl, rows,
                         n, p, table_size, features, dots);
      level_cotangent<A>(cell, kind, dots, L.scale, ct);
#pragma unroll
      for (int d = 0; d < 3; ++d) acc[d] = __fadd_rn(acc[d], ct[d]);
    }
  }
  if (p < n) {
#pragma unroll
    for (int d = 0; d < 3; ++d) dx[p * 3 + d] = acc[d];
  }
}

static bool wide_rows(int features) {
  return features % 4 == 0 && features >= 32 && features <= 512;
}

// The levels a narrow thread's warp stages at once; 0: g read in place.
static int narrow_group(int features, int levels) {
  if (features > K2X_STAGE) return 0;
  return min(levels, K2X_STAGE / features);
}

static size_t narrow_smem(int features, int levels) {
  const int group = narrow_group(features, levels);
  return group ? (size_t)K2X_THREADS * ((group * features) | 1) * 4 : 0;
}


static const void* levels_kernel(int atoms, int parts) {
#define K2X_PICK(P)                                             \
  if (parts == P)                                               \
    return atoms == 4 ? (const void*)point_grad_levels_kernel<4, P> \
                      : (const void*)point_grad_levels_kernel<8, P>;
  K2X_PICK(1) K2X_PICK(2) K2X_PICK(4) K2X_PICK(K2X_PART_ALL)
#undef K2X_PICK
  return nullptr;
}

static const void* narrow_kernel(int features, int atoms) {
  const bool even = features % 2 == 0;
  return atoms == 4 ? (even ? (const void*)point_grad_points_kernel<4, 2>
                            : (const void*)point_grad_points_kernel<4, 1>)
                    : (even ? (const void*)point_grad_points_kernel<8, 2>
                            : (const void*)point_grad_points_kernel<8, 1>);
}

static unsigned int level_blocks(long long n, int atoms) {
  const long long chunk = K2X_WARPS * (32 / atoms);
  return (unsigned int)((n + chunk - 1) / chunk);
}

// The floats of partials a point and level that carries a gradient: 3 on
// wide rows (the partials (levels, N, 3)), 0 on narrow rows.
extern "C" int hashgrid_point_grad_workspace(int features) {
  return wide_rows(features) ? 3 : 0;
}

// rows: null (every level EXACT, rows from the cell) or int32 (S, N), level
// l's rows from first[l]; kind[l]: 0 DRAWS, 1 RESIDUAL, 2 EXACT. A RESIDUAL
// level needs rows. partials: hashgrid_point_grad_workspace's floats.
// parts: K2X_PART_ALL for the gradient; on wide rows 1 (g), 2 (gathers), 4
// (the reduction and the partials' stores) or 8 (the level sum) alone for
// timing.
extern "C" int hashgrid_point_grad(
    const float* x, const float* table, const float* g, const int* rows,
    float* dx, float* partials, const float* scale, const int* stride,
    const int* size, const int* dense, const unsigned int* magic,
    const int* shift, const int* kind, const int* first, float offset,
    long long n, int levels, long long table_size, int features, int atoms,
    int parts, void* stream) {
  Levels geo;
  if (!make_levels(&geo, scale, stride, size, dense, magic, shift, levels))
    return (int)cudaErrorInvalidValue;
  if (atoms != 4 && atoms != 8) return (int)cudaErrorInvalidValue;
  const bool wide = wide_rows(features);
  if (wide ? parts != K2X_PART_SUM && !levels_kernel(atoms, parts)
           : parts != K2X_PART_ALL)
    return (int)cudaErrorInvalidValue;
  Plan plan;
  plan.count = 0;
  for (int l = 0; l < levels; ++l) {
    if (kind[l] < KIND_DRAWS || kind[l] > KIND_EXACT ||
        (kind[l] == KIND_RESIDUAL && rows == nullptr))
      return (int)cudaErrorInvalidValue;
    plan.kind[l] = kind[l];
    plan.first[l] = first[l];
    if (kind[l] != KIND_DRAWS) plan.level[plan.count++] = l;
  }
  if (wide && plan.count > 0 && partials == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (!wide) {
    const int group = narrow_group(features, levels);
    const unsigned int blocks =
        (unsigned int)((n + K2X_THREADS - 1) / K2X_THREADS);
    const size_t smem = narrow_smem(features, levels);
#define K2X_POINTS(A, W)                                                  \
  point_grad_points_kernel<A, W><<<blocks, K2X_THREADS, smem, s>>>(       \
      x, table, g, rows, dx, geo, plan, offset, n, levels, table_size,    \
      features, group)
    if (atoms == 4) {
      if (features % 2 == 0) K2X_POINTS(4, 2);
      else K2X_POINTS(4, 1);
    } else {
      if (features % 2 == 0) K2X_POINTS(8, 2);
      else K2X_POINTS(8, 1);
    }
#undef K2X_POINTS
    return (int)cudaGetLastError();
  }
  if (plan.count > 0 && parts != K2X_PART_SUM) {
    const dim3 grid(level_blocks(n, atoms), plan.count);
#define K2X_LEVELS(A, P)                                                   \
  point_grad_levels_kernel<A, P><<<grid, K2X_THREADS, 0, s>>>(             \
      x, table, g, rows, partials, geo, plan, offset, n, levels,           \
      table_size, features)
    if (atoms == 4) {
      if (parts == 1) K2X_LEVELS(4, 1);
      else if (parts == 2) K2X_LEVELS(4, 2);
      else if (parts == 4) K2X_LEVELS(4, 4);
      else K2X_LEVELS(4, K2X_PART_ALL);
    } else {
      if (parts == 1) K2X_LEVELS(8, 1);
      else if (parts == 2) K2X_LEVELS(8, 2);
      else if (parts == 4) K2X_LEVELS(8, 4);
      else K2X_LEVELS(8, K2X_PART_ALL);
    }
#undef K2X_LEVELS
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (parts != K2X_PART_ALL) return 0;
  }
  const long long count = n * 3;
  level_sum_kernel<<<(unsigned int)((count + K2X_SUM_THREADS - 1) /
                                    K2X_SUM_THREADS),
                     K2X_SUM_THREADS, 0, s>>>(partials, dx, count,
                                              plan.count);
  return (int)cudaGetLastError();
}

static int shape_of(const void* kernel, int threads, size_t smem,
                    unsigned int blocks, int points, int id, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = id;
  out[1] = (int)blocks;
  out[2] = threads;
  out[3] = (int)(attr.sharedSizeBytes + smem);
  out[4] = per_sm;
  out[5] = attr.numRegs;
  out[6] = points;
  return 0;
}

// The launches of a call for n points and `active` levels that carry a
// gradient: out[0] their count, then 7 ints each: the kernel (0 the wide
// levels kernel, 1 the level sum, 2 the narrow points kernel), blocks,
// threads, shared bytes (static and dynamic), blocks per SM, registers per
// thread, points a block (the level sum's: elements).
extern "C" int hashgrid_point_grad_shape(int features, int atoms, int levels,
                                         int active, long long n, int* out) {
  if (atoms != 4 && atoms != 8) return (int)cudaErrorInvalidValue;
  if (!wide_rows(features)) {
    out[0] = 1;
    return shape_of(narrow_kernel(features, atoms), K2X_THREADS,
                    narrow_smem(features, levels),
                    (unsigned int)((n + K2X_THREADS - 1) / K2X_THREADS),
                    K2X_THREADS, 2, out + 1);
  }
  out[0] = 2;
  const int err = shape_of(levels_kernel(atoms, K2X_PART_ALL), K2X_THREADS,
                           0, level_blocks(n, atoms) * active,
                           K2X_WARPS * (32 / atoms), 0, out + 1);
  if (err) return err;
  return shape_of((const void*)level_sum_kernel, K2X_SUM_THREADS, 0,
                  (unsigned int)((n * 3 + K2X_SUM_THREADS - 1) /
                                 K2X_SUM_THREADS),
                  K2X_SUM_THREADS, 1, out + 8);
}
