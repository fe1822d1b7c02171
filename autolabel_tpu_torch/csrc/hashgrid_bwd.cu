// Exact trilinear hash-grid encode, backward: the table gradient (K2).
//
// Replaces the table cotangent of autolabel_tpu/ops/hashgrid_pallas.py
// `_hybrid_bwd`, which the JAX package leaves to XLA (the VJP of
// encoders.hashgrid_encode: a scatter-add, not a Pallas kernel). For every
// point p, level l and cell corner c it adds g[p, l*F:(l+1)*F] * w_c(p, l)
// to row idx_c(p, l) of the level's table, with the cell, fraction, corner
// index and weight computed exactly as the forward kernel computes them
// (hashgrid_common.cuh: level_corner_index, with the sizes' divisor
// constants from the host): dense indices wrap floor-mod the level size,
// so a point at x = 1, whose upper corner has weight 0, still adds inside
// the table. The gradient for x (pose refinement) is not computed here.
//
// What bounds it on the H100: bytes. It must read g (N * L * F fp32,
// 256 MiB at the training slice's 131,072 points x 512) and x once, and
// write the table gradient (64 MiB at TPU_GRID) once. The scatter itself
// is 8 * N * L corner updates of F floats, resolved by float4 atomics in
// L2 (2.15 GB of payload at that size if every update were its own).
//
// Design, wide rows (F a multiple of 4, F >= 32; TPU_GRID's F = 128):
// - blocks run one level each, levels slowest in the grid, so the blocks
//   resident together add into one level's gradient (16 MiB at TPU_GRID,
//   which L2 holds) instead of all four;
// - a block takes a tile of `points` consecutive points of its level:
//   cp.async stages the tile's slices of g (one 512-byte run per point)
//   into shared memory, and each thread computes one (point, corner)'s
//   row and weight, once, with the unchanged hashgrid_common.cuh helpers;
// - the tile's 8 x points (row, entry) pairs are grouped by row in an
//   open-addressing table in shared memory, each group a linked list of
//   its entries;
// - a warp per group sums w * g over its entries in fp32 registers, lanes
//   over the features float4 wide, then adds it with one float4 atomic
//   per lane: one 512-byte row of atomics per distinct row of the tile. The
//   training step's samples are ray-ordered (a ray's samples are
//   consecutive points), so a tile's points share cells, on every level,
//   and their updates merge before they reach L2. Uniform points share
//   almost none; their atomics run at the rate at which L2 takes
//   scattered 512-byte rows, which is also that of plain stores.
// Narrow rows (e.g. the reference's F = 2) use one thread per point and
// level, levels slowest too, an atomic per feature and corner.
//
// The output is zeroed with cudaMemsetAsync on the stream first. Atomics,
// and the order of a group's list, change from run to run, so the result
// is nondeterministic in its last bits: a row's sum differs from a
// sequential sum by a few fp32 roundings of its terms' magnitude.
#include "hashgrid_common.cuh"
#include "mma_ptx.cuh"

#define K2_POINTS 32  // points of one level per block tile, at most
#define K2_THREADS 256
#define K2_WARPS (K2_THREADS / 32)
#define K2_ENTRIES (8 * K2_POINTS)
#define K2_SLOTS (2 * K2_ENTRIES)  // the row table's slots, a power of two
#define K2_G_FLOATS (K2_POINTS * 128)  // the staged g: points x F floats
#define K2_EMPTY 0xffffffffu

__host__ __device__ constexpr int log2i(int v) {
  return v <= 1 ? 0 : 1 + log2i(v >> 1);
}

// A block per tile of `points` points of level blockIdx.y.
__global__ void __launch_bounds__(K2_THREADS)
    scatter_rows_kernel(const float* __restrict__ x,
                        const float* __restrict__ g,
                        float* __restrict__ dtable, Levels geo, float offset,
                        long long n, int levels, long long table_size,
                        int features, int points) {
  __shared__ __align__(16) float gt[K2_G_FLOATS];  // g of the tile's points
  __shared__ unsigned int key[K2_SLOTS];  // a group's row
  __shared__ int head[K2_SLOTS];          // its first entry
  __shared__ int next[K2_ENTRIES];        // the entry after, or -1
  __shared__ float weight[K2_ENTRIES];    // entry (point, corner) = 8p + c
  __shared__ int group[K2_ENTRIES];       // the slots of the groups
  __shared__ int groups;
  const int l = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long p0 = (long long)blockIdx.x * points;
  const int live = (int)min((long long)points, n - p0);
  const int f4 = features >> 2;
  // g's slice of each point: a 16-byte copy a lane, a row a warp
  for (int r = warp; r < live; r += K2_WARPS)
    for (int c = lane; c < f4; c += 32)
      cp_async16(gt + r * features + 4 * c,
                 g + ((p0 + r) * levels + l) * (long long)features + 4 * c,
                 true);
  cp_async_commit();
  for (int s = tid; s < K2_SLOTS; s += K2_THREADS) {
    key[s] = K2_EMPTY;
    head[s] = -1;
  }
  if (tid == 0) groups = 0;
  __syncthreads();

  const Level L = geo.l[l];
  for (int e = tid; e < 8 * live; e += K2_THREADS) {
    const int c = e & 7;
    const Cell cell = cell_of(x, p0 + (e >> 3), L.scale, offset);
    const unsigned int row = level_corner_index(cell.c[0] + ((c >> 2) & 1),
                                                cell.c[1] + ((c >> 1) & 1),
                                                cell.c[2] + (c & 1), L);
    weight[e] = corner_weight(cell, c);
    unsigned int s = (row * 2654435761u) >> (32 - log2i(K2_SLOTS));
    for (;;) {  // linear probing; the first entry of a row opens its group
      const unsigned int was = atomicCAS(&key[s], K2_EMPTY, row);
      if (was == K2_EMPTY) {
        group[atomicAdd(&groups, 1)] = s;
        break;
      }
      if (was == row) break;
      s = (s + 1) & (K2_SLOTS - 1);
    }
    next[e] = atomicExch(&head[s], e);
  }
  cp_async_wait_all();
  __syncthreads();

  // A warp per group: the sum of w * g over its entries, then one float4
  // atomic a lane.
  float* level = dtable + (long long)l * table_size * features;
  for (int u = warp; u < groups; u += K2_WARPS) {
    const int s = group[u];
    float* dst = level + (long long)key[s] * features;
    for (int f = lane * 4; f < features; f += 128) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int e = head[s]; e >= 0; e = next[e]) {
        const float4 v = *reinterpret_cast<const float4*>(
            gt + (e >> 3) * features + f);
        const float w = weight[e];
        acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, w));
        acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, w));
        acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, w));
        acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, w));
      }
      atomicAdd(reinterpret_cast<float4*>(dst + f), acc);
    }
  }
}

// One thread per point of level blockIdx.y; any feature width.
__global__ void scatter_lanes_kernel(const float* __restrict__ x,
                                     const float* __restrict__ g,
                                     float* __restrict__ dtable,
                                     Levels geo, float offset, long long n,
                                     int levels, long long table_size,
                                     int features) {
  const int l = blockIdx.y;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const Level L = geo.l[l];
  Cell cell = cell_of(x, p, L.scale, offset);
  float* level = dtable + (long long)l * table_size * features;
  const float* src = g + (p * levels + l) * (long long)features;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    unsigned int idx = level_corner_index(cell.c[0] + ((c >> 2) & 1),
                                          cell.c[1] + ((c >> 1) & 1),
                                          cell.c[2] + (c & 1), L);
    float w = corner_weight(cell, c);
    float* row = level + (long long)idx * features;
    for (int f = 0; f < features; ++f)
      atomicAdd(row + f, __fmul_rn(__ldg(src + f), w));
  }
}

// The floor K2's atomics stand on (a measurement, on no path): `updates`
// rows of float4 atomics adding 1, a warp a row of `features` floats, each
// into a row of buf (rows x features) drawn by a fixed hash, so that their
// time says what L2 resolves when buf fits in it and when it does not.
__global__ void atomic_rows_kernel(float* __restrict__ buf, long long rows,
                                   long long updates, int features) {
  const long long u =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (u >= updates) return;
  unsigned long long h = (unsigned long long)u * 0x9e3779b97f4a7c15ull;
  h ^= h >> 29;
  h *= 0xbf58476d1ce4e5b9ull;
  h ^= h >> 32;
  float* row = buf + (long long)(h % (unsigned long long)rows) * features;
  for (int f = (threadIdx.x & 31) * 4; f < features; f += 128)
    atomicAdd(reinterpret_cast<float4*>(row + f),
              make_float4(1.0f, 1.0f, 1.0f, 1.0f));
}

extern "C" int hashgrid_bwd_atomic_rows(float* buf, long long rows,
                                        long long updates, int features,
                                        void* stream) {
  if (rows < 1 || features % 4 || ((uintptr_t)buf & 15))
    return (int)cudaErrorInvalidValue;
  const long long threads = updates * 32;
  atomic_rows_kernel<<<(unsigned int)((threads + K2_THREADS - 1) /
                                      K2_THREADS),
                       K2_THREADS, 0, (cudaStream_t)stream>>>(
      buf, rows, updates, features);
  return (int)cudaGetLastError();
}

static bool wide_rows(int features) {
  return features % 4 == 0 && features >= 32 && features <= K2_G_FLOATS;
}

// Points per tile of the wide-row kernel: as many as the staged g holds,
// at most K2_POINTS.
static int tile_points(int features) {
  const int p = K2_G_FLOATS / features;
  return p < K2_POINTS ? p : K2_POINTS;
}

static dim3 scatter_grid(long long n, int levels, int features) {
  const int chunk = wide_rows(features) ? tile_points(features) : K2_THREADS;
  return dim3((unsigned int)((n + chunk - 1) / chunk), levels);
}

extern "C" int hashgrid_encode_bwd(const float* x, const float* g,
                                   float* dtable, const float* scale,
                                   const int* stride, const int* size,
                                   const int* dense,
                                   const unsigned int* magic,
                                   const int* shift, float offset,
                                   long long n, int levels,
                                   long long table_size, int features,
                                   void* stream) {
  Levels geo;
  if (!make_levels(&geo, scale, stride, size, dense, magic, shift, levels))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      dtable, 0, (size_t)levels * table_size * features * sizeof(float), s);
  if (err != cudaSuccess || n == 0) return (int)err;
  const dim3 grid = scatter_grid(n, levels, features);
  if (wide_rows(features))
    scatter_rows_kernel<<<grid, K2_THREADS, 0, s>>>(
        x, g, dtable, geo, offset, n, levels, table_size, features,
        tile_points(features));
  else
    scatter_lanes_kernel<<<grid, K2_THREADS, 0, s>>>(
        x, g, dtable, geo, offset, n, levels, table_size, features);
  return (int)cudaGetLastError();
}

// out[0..6): the launch shape for n points: blocks, threads, static shared
// bytes, blocks per SM, registers per thread, points per tile (1 for the
// narrow path's thread per point and level).
extern "C" int hashgrid_encode_bwd_shape(int levels, int features,
                                         long long n, int* out) {
  const bool wide = wide_rows(features);
  const void* kernel = wide ? (const void*)scatter_rows_kernel
                            : (const void*)scatter_lanes_kernel;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      K2_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = scatter_grid(n, levels, features);
  out[0] = (int)(grid.x * grid.y);
  out[1] = K2_THREADS;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = per_sm;
  out[4] = attr.numRegs;
  out[5] = wide ? tile_points(features) : 1;
  return 0;
}
