// The table gradient of the stochastic-corner and residual encodes (K7):
// a weighted scatter-add of the rows the forward (K6,
// hashgrid_stochastic.cu) drew.
//
// Replaces what XLA compiles on the TPU for the VJP of the `jnp.take`s of
// autolabel_tpu/ops/encoders.py `_encode_stochastic`,
// `_encode_stochastic_simplex` and `_encode_residual`: per point and level,
// from the rows and weights K6 wrote (hashgrid_stochastic.cuh), the level's
// slice of the cotangent g (N, L * F, fp32) goes into each of its rows in
// fp32: a DRAWS row takes g * (1 / n_samples) (g itself for one sample: the
// VJP of the product XLA makes of `acc / n_samples`; no weight is read), a
// RESIDUAL or EXACT row w * g (w_m and 1 - w_m; every atom at its weight).
// Only the plan's rows of each level are read and scattered: no padded row
// costs an atomic, and a level may have any count of rows.
//
// What bounds it on the H100: the atomics, resolved in L2. At TPU_GRID
// with 2 draws and the train CLI's N = 524,288 a point makes 4 levels x 2
// rows of 512-byte updates (4.2 M, 32 float4 atomics each, 134 M in all);
// the bytes it must move (g, the rows, the 64 MiB gradient written once)
// take about 0.35 ms at 3.35 TB/s. On the reference preset (16 x 2^19 x
// 2) with 4 exact levels it is 56 rows of 8 bytes a point, 29.4 M float2
// atomics, a million of them on level 0's 4,913 rows.
//
// Design: combine terms of one row before they reach L2, where the rows
// repeat. The train CLI's samples are
// ray-ordered (a ray's samples are consecutive points), so a tile of
// consecutive points shares rows on the coarse levels.
// - Wide rows (F a multiple of 4, at least 32), K2's frame
//   (hashgrid_bwd.cu): a block per tile of up to K7_POINTS points of one
//   level, levels slowest; cp.async stages the tile's slices of g; a thread
//   per (point, row) entry reads its row and weight (K7_ENTRIES at a time)
//   and files it under its row in an open-addressing table in shared
//   memory, each group a linked list; a warp per group sums w * g in fp32
//   and adds it with one float4 atomic a lane: one row of atomics per
//   distinct row of the tile.
// - Narrow rows: a thread per (point, level), levels slowest, its rows'
//   atomics in turn; per row, the lanes of a warp on one row (the CLI
//   repeats samples: a tile of 256 points names 27-66% distinct rows a
//   level on the reference preset) merged by __match_any_sync, then one
//   float2 atomic a distinct row (F = 2), else F scalar atomics a row.
//   Measured per level on the reference preset (NVIDIA H100 80GB HBM3,
//   700 W; kernel_compare.py's K7 levels), this merge beat the block's
//   shared-memory grouping on every level (0.020-0.024 against
//   0.027-0.031 ms a level of 2 draws, 0.041 against 0.087 an exact
//   level), and a thread per (point, row), rows slowest as one index_add_
//   of every row runs, was 1.3 times slower than a thread per (point,
//   level) without it.
// The gradient is zeroed with cudaMemsetAsync first. Atomics, and the
// order in which a group's terms are summed, change from run to run: the
// result is nondeterministic in its last bits, within a few fp32 roundings
// of its terms' magnitude (hashgrid_cuda.stochastic_backward_tolerance).
#include "hashgrid_stochastic.cuh"
#include "mma_ptx.cuh"

#define K7_THREADS 256
#define K7_WARPS (K7_THREADS / 32)
#define K7_POINTS 32                   // wide rows: points a tile, at most
#define K7_G_FLOATS (K7_POINTS * 128)  // the staged g: points x F floats
#define K7_ENTRIES 256                 // wide rows: entries grouped at once
#define K7_SLOTS 512                   // their row table, a power of two
#define K7_EMPTY 0xffffffffu

__host__ __device__ constexpr int log2i(int v) {
  return v <= 1 ? 0 : 1 + log2i(v >> 1);
}

// The slot of `row` in the row table `key` (K7_SLOTS, a power of two):
// linear probing; `opened` says whether this call opened it.
__device__ __forceinline__ int slot_of(unsigned int* key, unsigned int row,
                                       bool& opened) {
  unsigned int s = (row * 2654435761u) >> (32 - log2i(K7_SLOTS));
  for (;;) {
    const unsigned int was = atomicCAS(&key[s], K7_EMPTY, row);
    if (was == K7_EMPTY || was == row) {
      opened = was == K7_EMPTY;
      return (int)s;
    }
    s = (s + 1) & (K7_SLOTS - 1);
  }
}

// A block per tile of `points` points of level level0 + blockIdx.y.
__global__ void __launch_bounds__(K7_THREADS)
    stochastic_scatter_rows_kernel(const float* __restrict__ g,
                                   const int* __restrict__ idx,
                                   const float* __restrict__ wts,
                                   float* __restrict__ dtable, Plan plan,
                                   float scale, long long n, int levels,
                                   long long table_size, int features,
                                   int points, int level0) {
  __shared__ __align__(16) float gt[K7_G_FLOATS];  // g of the tile's points
  __shared__ unsigned int key[K7_SLOTS];  // a group's row
  __shared__ int head[K7_SLOTS];          // its first entry
  __shared__ int next[K7_ENTRIES];        // the entry after, or -1
  __shared__ float weight[K7_ENTRIES];    // an entry's weight
  __shared__ int point[K7_ENTRIES];       // and its point in the tile
  __shared__ int group[K7_ENTRIES];       // the slots of the groups
  __shared__ int groups;
  const int l = level0 + blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long p0 = (long long)blockIdx.x * points;
  const int live = (int)min((long long)points, n - p0);
  const int f4 = features >> 2;
  for (int r = warp; r < live; r += K7_WARPS)
    for (int c = lane; c < f4; c += 32)
      cp_async16(gt + r * features + 4 * c,
                 g + ((p0 + r) * levels + l) * (long long)features + 4 * c,
                 true);
  cp_async_commit();
  const int kind = plan.kind[l], R = plan.rows[l];
  const int first = plan.first[l], wfirst = plan.wfirst[l];
  const int total = live * R;
  float* level = dtable + (long long)l * table_size * features;
  for (int c0 = 0; c0 < total; c0 += K7_ENTRIES) {
    for (int s = tid; s < K7_SLOTS; s += K7_THREADS) {
      key[s] = K7_EMPTY;
      head[s] = -1;
    }
    if (tid == 0) groups = 0;
    __syncthreads();
    // entry c0 + e: row r = (c0 + e) / live of point (c0 + e) % live, so
    // consecutive threads read consecutive points' indices
    const int count = min(K7_ENTRIES, total - c0);
    for (int e = tid; e < count; e += K7_THREADS) {
      const int r = (c0 + e) / live, j = c0 + e - r * live;
      const long long p = p0 + j;
      const unsigned int row =
          (unsigned int)__ldg(idx + (long long)(first + r) * n + p);
      weight[e] = kind == KIND_DRAWS
                      ? scale
                      : __ldg(wts + (long long)(wfirst + r) * n + p);
      point[e] = j;
      bool opened;
      const int s = slot_of(key, row, opened);
      if (opened) group[atomicAdd(&groups, 1)] = s;
      next[e] = atomicExch(&head[s], e);
    }
    if (c0 == 0) cp_async_wait_all();
    __syncthreads();
    for (int u = warp; u < groups; u += K7_WARPS) {
      const int s = group[u];
      float* dst = level + (long long)key[s] * features;
      for (int f = lane * 4; f < features; f += 128) {
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int e = head[s]; e >= 0; e = next[e]) {
          const float4 v = *reinterpret_cast<const float4*>(
              gt + point[e] * features + f);
          const float w = weight[e];
          acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, w));
          acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, w));
          acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, w));
          acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, w));
        }
        atomicAdd(reinterpret_cast<float4*>(dst + f), acc);
      }
    }
    __syncthreads();
  }
}

// A thread per (point, level level0 + blockIdx.y); any feature width, the
// warp's merge at F = 2 only.
__global__ void __launch_bounds__(K7_THREADS)
    stochastic_scatter_lanes_kernel(const float* __restrict__ g,
                                    const int* __restrict__ idx,
                                    const float* __restrict__ wts,
                                    float* __restrict__ dtable, Plan plan,
                                    float scale, long long n, int levels,
                                    long long table_size, int features,
                                    int level0) {
  __shared__ float2 terms[K7_THREADS];  // a thread's term of the row
  const int l = level0 + blockIdx.y;
  const long long p = (long long)blockIdx.x * K7_THREADS + threadIdx.x;
  const bool live = p < n;
  const int kind = plan.kind[l], R = plan.rows[l];
  const int first = plan.first[l], wfirst = plan.wfirst[l];
  const float* src = g + (p * levels + l) * (long long)features;
  float* level = dtable + (long long)l * table_size * features;
  if (features == 2) {
    const float2 v = live ? *reinterpret_cast<const float2*>(src)
                          : make_float2(0.0f, 0.0f);
    // per row, the lanes of a warp that hit one row (repeated samples)
    // merged first, the lowest of them adding their sum in lane order with
    // one float2 atomic
    const int lane = threadIdx.x & 31;
    for (int r = 0; r < R; ++r) {
      const float w =
          !live || kind == KIND_DRAWS
              ? scale
              : __ldg(wts + (long long)(wfirst + r) * n + p);
      const unsigned int row =
          live ? (unsigned int)__ldg(idx + (long long)(first + r) * n + p)
               : K7_EMPTY;
      const float2 t = make_float2(__fmul_rn(v.x, w), __fmul_rn(v.y, w));
      const unsigned int peers = __match_any_sync(0xffffffffu, row);
      terms[threadIdx.x] = t;
      __syncwarp();
      if (live && lane == __ffs(peers) - 1) {
        float2 acc = t;
        for (unsigned int m = peers & (peers - 1); m; m &= m - 1) {
          const float2 o = terms[threadIdx.x - lane + __ffs(m) - 1];
          acc = make_float2(__fadd_rn(acc.x, o.x), __fadd_rn(acc.y, o.y));
        }
        atomicAdd(reinterpret_cast<float2*>(level + (long long)row * 2), acc);
      }
      __syncwarp();
    }
    return;
  }
  if (!live) return;
  for (int r = 0; r < R; ++r) {
    const float w =
        kind == KIND_DRAWS
            ? scale
            : __ldg(wts + (long long)(wfirst + r) * n + p);
    const bool weighted = kind != KIND_DRAWS || scale != 1.0f;
    float* dst =
        level + (long long)__ldg(idx + (long long)(first + r) * n + p) *
                    features;
    for (int f = 0; f < features; ++f) {
      const float v = __ldg(src + f);
      atomicAdd(dst + f, weighted ? __fmul_rn(v, w) : v);
    }
  }
}

// Points per tile of the wide kernel: as many as the staged g holds, at
// most K7_POINTS.
static int k7_points(int features) {
  return min(K7_POINTS, K7_G_FLOATS / features);
}

static bool k7_wide(int features) {
  return wide_rows(features) && features <= K7_G_FLOATS;
}

// The grid, levels slowest.
static dim3 k7_grid(long long n, int levels, int features) {
  const int chunk = k7_wide(features) ? k7_points(features) : K7_THREADS;
  return dim3((unsigned int)((n + chunk - 1) / chunk), levels);
}

// level < 0: the table gradient, zeroed first, every level; level >= 0:
// that level's scatter alone, nothing zeroed (for timing a level's
// atomics).
extern "C" int hashgrid_stochastic_bwd(const float* g, const int* idx,
                                       const float* w, const int* kinds,
                                       const int* rows, float* dtable,
                                       long long n, int levels,
                                       long long table_size, int features,
                                       int n_samples, int level,
                                       void* stream) {
  Plan plan;
  if (!make_plan(&plan, kinds, rows, levels, 0, n_samples) ||
      features < 1 || (!w && weighted_rows(plan, levels)) ||
      level >= levels)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (level < 0) {
    const cudaError_t err = cudaMemsetAsync(
        dtable, 0, (size_t)levels * table_size * features * sizeof(float),
        s);
    if (err != cudaSuccess) return (int)err;
  }
  if (n == 0) return 0;
  const float scale = n_samples > 1 ? 1.0f / (float)n_samples : 1.0f;
  dim3 grid = k7_grid(n, levels, features);
  if (k7_wide(features)) {
    if (level >= 0) grid.y = 1;
    stochastic_scatter_rows_kernel<<<grid, K7_THREADS, 0, s>>>(
        g, idx, w, dtable, plan, scale, n, levels, table_size, features,
        k7_points(features), level < 0 ? 0 : level);
  } else {
    if (level >= 0) grid.y = 1;
    stochastic_scatter_lanes_kernel<<<grid, K7_THREADS, 0, s>>>(
        g, idx, w, dtable, plan, scale, n, levels, table_size, features,
        level < 0 ? 0 : level);
  }
  return (int)cudaGetLastError();
}

// out[0..7): the launch shape for n points: blocks, threads, static shared
// bytes, blocks per SM, registers per thread, points per block, and 1 for
// the wide kernel, 0 for the narrow one.
extern "C" int hashgrid_stochastic_bwd_shape(int levels, int features,
                                             long long n, int* out) {
  const bool wide = k7_wide(features);
  const void* kernel = wide ? (const void*)stochastic_scatter_rows_kernel
                            : (const void*)stochastic_scatter_lanes_kernel;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      K7_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = k7_grid(n, levels, features);
  out[0] = (int)(grid.x * grid.y);
  out[1] = K7_THREADS;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = per_sm;
  out[4] = attr.numRegs;
  out[5] = wide ? k7_points(features) : K7_THREADS;
  out[6] = wide;
  return 0;
}
