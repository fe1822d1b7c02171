// Exact trilinear multiresolution hash-grid encode (forward) for Hopper.
//
// Replaces the TPU kernel autolabel_tpu/ops/hashgrid_pallas.py
// `_encode_kernel` (launched by `hashgrid_encode_pallas`). It computes what
// autolabel_tpu/ops/encoders.py `_encode_rows` / `_encode_lanes` compute:
// per point and level, pos = x * scale + pos_offset, floor/frac, the 8 cell
// corners, a coherent-prime uint32 XOR hash `% level_size` (or a dense
// index, which wraps floor-mod `level_size` too, unlike the Pallas kernel,
// so no corner reads out of bounds, not even for a point outside [0, 1]),
// a gather of F features and a trilinear blend in corner order. Per-level
// scale / stride / size / use_dense and the size's divisor constants come
// from the host, so the 'native', 'tcnn' and 'torch_ngp' lattices are all
// covered.
//
// What bounds it on the H100: bytes. Per point and level it reads 8 table
// rows of F floats and writes F floats; at TPU_GRID (4 x 2^15 x 128, fp32,
// 64 MiB) the byte floor is the output stream, N * L * F * 4 bytes (1 GiB
// per 524,288-point chunk) plus one pass over the table. Uniform points
// reuse no rows, so the gathers (8 rows of 512 B per point and level,
// 8.6 GB a chunk) run from L2 at its rate, not at that floor.
//
// Design, wide rows (F a multiple of 4, F >= 32; TPU_GRID's F = 128):
// - blocks run one level each, levels slowest in the grid (the Pallas
//   grid's (L, N / TILE) order), so the blocks resident together gather
//   from one level's table (16 MiB at TPU_GRID) instead of all four;
// - a warp takes K1_POINTS points of its level; first each lane computes
//   one (point, corner)'s index and weight, without a division
//   (level_corner_index), into the warp's slice of shared memory; then,
//   per point, its lanes read the 8 corner rows as float4 (one coalesced
//   512-byte row per corner) and blend them: K1_POINTS x 8 independent
//   16-byte loads a lane;
// - the output rows are written with streaming stores (st.global.cs), so
//   the 1 GiB stream does not evict the level's table from L2.
// Narrow rows (the reference presets' F = 2; any F not a multiple of 4
// of at least 32): a thread per (point, slice of W = 2 or 1 features)
// walks a group of its point's levels, groups slowest in the grid. It
// reads the point once; per level it computes the cell once and issues
// the 8 corner rows' loads together, float2 wide, before it blends them
// in corner order. It stages its outputs in shared memory; a warp then
// stores its points' rows of the group, 16 bytes a lane (two lanes to a
// 32-byte sector) where they are whole 16-byte pieces, else a float a
// lane. The group (k1_group) is the levels whose rows fill one 32-byte
// sector, 4 at F = 2: no sector of the output is split between groups,
// and the blocks resident together gather from 4 levels' tables (16 MB
// on the tcnn preset), which L2 holds, not from all 16 (57 MB). At the
// tcnn preset's N = 524,288, device ms by group (uniform points /
// ray-ordered ones; NVIDIA H100 80GB HBM3, 700 W; kernel_compare.py):
// 16 levels 0.5404 / 0.4913, 8 0.5441 / 0.4895, 4 0.5101 / 0.4484, 2
// 0.5485 / 0.4938, 1 0.6295 / 0.5914. Its first form, a thread per
// (point, level), levels slowest, wrote 8 bytes a thread at a stride of
// L * F * 4 bytes, each 32-byte sector from 4 blocks far apart in time,
// with scalar loads: 1.1990 ms there.
// The arithmetic uses explicitly rounded fp32 operations (no FMA
// contraction) in the plain version's order, so kernel and plain version
// agree to the last bits.
#include "hashgrid_common.cuh"

#define K1_POINTS 4  // points of one level per warp (a multiple of 4)
#define K1_THREADS 256
#define K1_WARPS (K1_THREADS / 32)
#define K1N_THREADS 128   // narrow rows: threads a block
#define K1N_MIN_BLOCKS 8  // narrow rows: 64 registers a thread, 32 warps an SM
#define K1N_STAGE 32      // narrow rows: most floats a thread stages
#define K1N_SECTOR 8      // narrow rows: floats of a 32-byte sector
#define K1N_PAD 4         // narrow rows: floats after each staged point row

__device__ __forceinline__ float4 blend(float4 acc, float4 v, float w) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, w));
  acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, w));
  acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, w));
  acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, w));
  return acc;
}
__device__ __forceinline__ float2 blend(float2 acc, float2 v, float w) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, w));
  acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, w));
  return acc;
}
__device__ __forceinline__ float blend(float acc, float v, float w) {
  return __fadd_rn(acc, __fmul_rn(v, w));
}

// A warp per K1_POINTS points of level blockIdx.y; lanes over features,
// float4 wide.
__global__ void __launch_bounds__(K1_THREADS)
    encode_rows_kernel(const float* __restrict__ x,
                       const float* __restrict__ table,
                       float* __restrict__ out, Levels geo, float offset,
                       long long n, int levels, long long table_size,
                       int features) {
  // (index, weight bits) of each (point, corner) of a warp's points
  __shared__ __align__(16) uint2 corners[K1_WARPS][K1_POINTS * 8];
  const int l = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long p0 =
      ((long long)blockIdx.x * K1_WARPS + warp) * K1_POINTS;
  if (p0 >= n) return;
  const Level L = geo.l[l];
  uint2* mine = corners[warp];
  const int c = lane & 7;
#pragma unroll
  for (int r = 0; r < K1_POINTS / 4; ++r) {
    const int j = r * 4 + (lane >> 3);
    unsigned int idx = 0;
    float w = 0.0f;  // points past n: row 0, weight 0, never stored
    if (p0 + j < n) {
      const Cell cell = cell_of(x, p0 + j, L.scale, offset);
      idx = level_corner_index(cell.c[0] + ((c >> 2) & 1),
                               cell.c[1] + ((c >> 1) & 1),
                               cell.c[2] + (c & 1), L);
      w = corner_weight(cell, c);
    }
    mine[j * 8 + c] = make_uint2(idx, __float_as_uint(w));
  }
  __syncwarp();
  const float* level_table = table + (long long)l * table_size * features;
  const uint4* pairs = reinterpret_cast<const uint4*>(mine);
  for (int f = lane * 4; f < features; f += 128) {
    float4 acc[K1_POINTS];
#pragma unroll
    for (int j = 0; j < K1_POINTS; ++j) {
      acc[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // corners 2k, 2k + 1
        const uint4 e = pairs[j * 4 + k];
        const float4 v0 = __ldg(reinterpret_cast<const float4*>(
            level_table + (long long)e.x * features + f));
        const float4 v1 = __ldg(reinterpret_cast<const float4*>(
            level_table + (long long)e.z * features + f));
        acc[j] = blend(acc[j], v0, __uint_as_float(e.y));
        acc[j] = blend(acc[j], v1, __uint_as_float(e.w));
      }
    }
#pragma unroll
    for (int j = 0; j < K1_POINTS; ++j)
      if (p0 + j < n)
        __stcs(reinterpret_cast<float4*>(
                   out + ((p0 + j) * levels + l) * (long long)features + f),
               acc[j]);
  }
}

// A slice of W features of a table row: its load and its zero.
template <int W>
struct Lane;
template <>
struct Lane<1> {
  typedef float T;
  static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ T zero() { return 0.0f; }
  static __device__ __forceinline__ void put(float* p, T v) { p[0] = v; }
};
template <>
struct Lane<2> {
  typedef float2 T;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ void put(float* p, T v) {
    *reinterpret_cast<float2*>(p) = v;
  }
};

// Pieces of V (float4 or float) of `points` point rows of `len` floats:
// from the stage, a row every `srow` floats, to out, a row every `orow`
// floats; lane c of the warp takes pieces c, c + 32, ..., so neighbouring
// lanes store neighbouring pieces.
template <typename V>
__device__ __forceinline__ void store_rows(float* __restrict__ out,
                                           const float* stage, int points,
                                           int len, int srow, long long orow,
                                           int lane) {
  const int per = len * (int)sizeof(float) / (int)sizeof(V);
  for (int c = lane; c < points * per; c += 32) {
    const int j = c / per, q = c - j * per;
    __stcs(reinterpret_cast<V*>(out + j * orow) + q,
           reinterpret_cast<const V*>(stage + j * srow)[q]);
  }
}

// A thread per (point, slice of W features) walks levels [g0, g0 + group)
// of its point, g0 = blockIdx.y * group; any feature width (W = 2 where F
// is even). Dynamic shared memory (k1_stage_floats): where a warp holds
// whole points (slices divides 32), its points' group rows, point-major,
// K1N_PAD floats apart (a point's row of 32 floats at a stride of 32
// would put a level's 32 float2 stores in one bank pair); else a thread's
// own group * W floats.
template <int W>
__global__ void __launch_bounds__(K1N_THREADS, K1N_MIN_BLOCKS)
    encode_lanes_kernel(const float* __restrict__ x,
                        const float* __restrict__ table,
                        float* __restrict__ out, Levels geo, float offset,
                        long long n, int levels, long long table_size,
                        int features, int group) {
  typedef typename Lane<W>::T T;
  extern __shared__ __align__(16) float stage[];
  const int slices = features / W;
  const long long t = (long long)blockIdx.x * K1N_THREADS + threadIdx.x;
  const long long p = t / slices;
  const int s = (int)(t - p * slices);
  const int lane = threadIdx.x & 31;
  const int g0 = blockIdx.y * group;
  const int levels_here = min(group, levels - g0);
  const bool whole = 32 % slices == 0;
  const int srow = group * features + K1N_PAD;  // staged floats a point
  float* mine = whole ? stage + threadIdx.x / slices * srow + s * W
                      : stage + threadIdx.x * group * W;
  const int step = whole ? features : W;
  if (p < n) {
    float xp[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) xp[a] = x[p * 3 + a];
    const float* slice_table = table + s * W;
#pragma unroll 1
    for (int k = 0; k < levels_here; ++k) {
      const int l = g0 + k;
      const Level L = geo.l[l];
      Cell cell;
#pragma unroll
      for (int a = 0; a < 3; ++a) {  // cell_of, on the point read once
        const float pos = __fadd_rn(__fmul_rn(L.scale, xp[a]), offset);
        const float fl = floorf(pos);
        cell.c[a] = (int)fl;
        cell.f[a] = __fsub_rn(pos, fl);
      }
      const float* level_table =
          slice_table + (long long)l * table_size * features;
      T v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        v[c] = Lane<W>::load(
            level_table +
            (long long)level_corner_index(cell.c[0] + ((c >> 2) & 1),
                                          cell.c[1] + ((c >> 1) & 1),
                                          cell.c[2] + (c & 1), L) *
                features);
      T acc = Lane<W>::zero();
#pragma unroll
      for (int c = 0; c < 8; ++c) acc = blend(acc, v[c], corner_weight(cell, c));
      Lane<W>::put(mine + k * step, acc);
    }
  }
  const int len = levels_here * features;  // floats of a point's group row
  const long long orow = (long long)levels * features;
  if (whole) {
    __syncwarp();
    const long long p0 = (t - lane) / slices;
    if (p0 >= n) return;
    const int points = (int)min((long long)(32 / slices), n - p0);
    float* dst = out + p0 * orow + (long long)g0 * features;
    const float* warp_stage = stage + (threadIdx.x - lane) / slices * srow;
    if (len % 4 == 0 && srow % 4 == 0 && orow % 4 == 0 &&
        (g0 * features) % 4 == 0)
      store_rows<float4>(dst, warp_stage, points, len, srow, orow, lane);
    else
      store_rows<float>(dst, warp_stage, points, len, srow, orow, lane);
    return;
  }
  if (p >= n) return;
  float* dst = out + p * orow + (long long)g0 * features + s * W;
  for (int k = 0; k < levels_here; ++k)
    for (int i = 0; i < W; ++i) __stcs(dst + k * features + i, mine[k * W + i]);
}

static bool wide_rows(int features) {
  return features % 4 == 0 && features >= 32;
}

// The levels a narrow-rows thread walks: `group` where the caller sets it,
// else the levels whose rows fill a 32-byte sector (4 at F = 2, 1 from
// F = 5 on); at most what K1N_STAGE holds and at most every level.
static int k1_group(int features, int levels, int group) {
  const int most = K1N_STAGE / (features % 2 == 0 ? 2 : 1);
  const int chosen = max(1, K1N_SECTOR / features);
  return max(1, min(group > 0 ? group : chosen, min(most, levels)));
}

// Narrow rows' dynamic shared memory, in floats (encode_lanes_kernel).
static size_t k1_stage_floats(int features, int group) {
  const int slices = features % 2 == 0 ? features / 2 : features;
  if (32 % slices == 0)
    return (size_t)(K1N_THREADS / slices) * (group * features + K1N_PAD);
  return (size_t)K1N_THREADS * group * (features % 2 == 0 ? 2 : 1);
}

// The grid of a launch: wide rows (point chunks of K1_WARPS * K1_POINTS,
// levels), levels slowest; narrow rows (chunks of K1N_THREADS (point,
// slice) threads, level groups).
static dim3 encode_grid(long long n, int levels, int features, int group) {
  if (wide_rows(features))
    return dim3((unsigned int)((n + K1_WARPS * K1_POINTS - 1) /
                               (K1_WARPS * K1_POINTS)),
                levels);
  const long long threads = n * (features % 2 == 0 ? features / 2 : features);
  return dim3((unsigned int)((threads + K1N_THREADS - 1) / K1N_THREADS),
              (levels + group - 1) / group);
}

static const void* lanes_kernel(int features) {
  return features % 2 == 0 ? (const void*)encode_lanes_kernel<2>
                           : (const void*)encode_lanes_kernel<1>;
}

// group: the narrow rows' levels a thread walks, 0 to choose (k1_group);
// wide rows ignore it.
extern "C" int hashgrid_encode_fwd(const float* x, const float* table,
                                   float* out, const float* scale,
                                   const int* stride, const int* size,
                                   const int* dense,
                                   const unsigned int* magic,
                                   const int* shift, float offset,
                                   long long n, int levels,
                                   long long table_size, int features,
                                   int group, void* stream) {
  Levels g;
  if (!make_levels(&g, scale, stride, size, dense, magic, shift, levels) ||
      features < 1 || group < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (wide_rows(features)) {
    encode_rows_kernel<<<encode_grid(n, levels, features, 1), K1_THREADS, 0,
                         s>>>(x, table, out, g, offset, n, levels, table_size,
                              features);
    return (int)cudaGetLastError();
  }
  group = k1_group(features, levels, group);
  const dim3 grid = encode_grid(n, levels, features, group);
  const size_t smem = k1_stage_floats(features, group) * sizeof(float);
  if (features % 2 == 0)
    encode_lanes_kernel<2><<<grid, K1N_THREADS, smem, s>>>(
        x, table, out, g, offset, n, levels, table_size, features, group);
  else
    encode_lanes_kernel<1><<<grid, K1N_THREADS, smem, s>>>(
        x, table, out, g, offset, n, levels, table_size, features, group);
  return (int)cudaGetLastError();
}

// out[0..7): the launch shape for n points: blocks, threads, shared bytes
// (static and dynamic), blocks per SM, registers per thread, points per
// warp (wide rows: K1_POINTS; narrow: the points whose rows a warp stores
// whole, 32 / slices, or 0 where slices does not divide 32 and a thread
// stores its own) and the levels a thread walks (1 on wide rows).
extern "C" int hashgrid_encode_shape(int levels, int features, long long n,
                                     int* out) {
  if (features < 1 || levels < 1) return (int)cudaErrorInvalidValue;
  const bool wide = wide_rows(features);
  const void* kernel =
      wide ? (const void*)encode_rows_kernel : lanes_kernel(features);
  const int threads = wide ? K1_THREADS : K1N_THREADS;
  const int group = wide ? 1 : k1_group(features, levels, 0);
  const size_t smem =
      wide ? 0 : k1_stage_floats(features, group) * sizeof(float);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = encode_grid(n, levels, features, group);
  const int slices = features % 2 == 0 ? features / 2 : features;
  out[0] = (int)(grid.x * grid.y);
  out[1] = threads;
  out[2] = (int)(attr.sharedSizeBytes + smem);
  out[3] = per_sm;
  out[4] = attr.numRegs;
  out[5] = wide ? K1_POINTS : (32 % slices == 0 ? 32 / slices : 0);
  out[6] = group;
  return 0;
}
