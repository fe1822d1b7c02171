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
// Narrow rows (the reference presets' F = 2; any F that is not wide), a
// thread per (point, slice of W = 4, 2 or 1 features) walking a group of
// its point's levels, groups slowest in the grid:
// - the group is the levels whose slices of g fill one 32-byte sector (4
//   at F = 2), so x is read and a group's g sector fetched once, and the
//   blocks resident together add into 4 levels' gradients (16 MB on the
//   tcnn lattice, which L2 holds);
// - every corner's update is one vector atomic of the thread's slice
//   (float2 at F = 2, float4 where F is a multiple of 4) instead of one
//   scalar atomic a feature; the x-neighbour corners c and c | 4 go in
//   one atomic of twice the width where their rows are the two halves of
//   one aligned piece (at F = 2, one float4 for every even cx of a hashed
//   level of power-of-two size, every even index of a dense level);
// - where two lanes of a warp share a cell of a level (one
//   __match_any_sync a level on the cell's first corner row), that
//   level's rounds merge the lanes with the same target before L2 (a
//   __match_any_sync a round, the lowest lane summing the others' terms
//   from shared memory): the coarse levels and the ray-ordered samples a
//   training step hands it. Elsewhere each lane issues its own atomics.
// What bounds it is the count of atomic requests L2 resolves, not bytes:
// the first form, a thread per (point, level) issuing 8 F scalar atomics,
// ran 1.79 ms on the tcnn lattice at N = 524,288 (134 M requests; its
// atomics as plain stores 3.09 ms, all but the table writes 0.55 ms), and
// warps of 32 uniform points need 50.1 M 16-byte requests at the least.
// Device ms there, uniform / ray-ordered / a train CLI step's samples
// (NVIDIA H100 80GB HBM3, 700 W; kernel_compare.py's K2 narrow variants):
// this design 0.681 / 0.665 / 0.512; merging every level 0.903 / 0.855 /
// 0.500, never 0.677 / 0.674 / 0.865; no x-neighbour pairs 0.873 / 0.822
// / 0.545; scalar atomics, no merges 1.632 / 1.582 / 2.036; level 0
// summed in shared memory by each block instead (group 0 launched alone)
// 0.680 / 0.846 / 0.648; 1, 2, 8, 16 levels a thread 0.747, 0.703,
// 0.877, 1.374 uniform.
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
#define K2N_THREADS 128   // narrow rows: threads a block
#define K2N_MIN_BLOCKS 8  // narrow rows: 64 registers a thread, 32 warps an SM
#define K2N_SECTOR 8      // narrow rows: floats of a 32-byte sector of g

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

// A slice of W features of a narrow row (W = 4 where F is a multiple of
// 4, 2 where F is even, else 1): its load from g, held as a float4.
template <int W>
__device__ __forceinline__ float4 load_slice(const float* p) {
  if (W == 4) return __ldg(reinterpret_cast<const float4*>(p));
  if (W == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    return make_float4(v.x, v.y, 0.0f, 0.0f);
  }
  return make_float4(__ldg(p), 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ float4 scaled(float4 v, float w) {
  return make_float4(__fmul_rn(v.x, w), __fmul_rn(v.y, w),
                     __fmul_rn(v.z, w), __fmul_rn(v.w, w));
}

// One vector atomic of `width` floats (1, 2 or 4) of v at dst.
__device__ __forceinline__ void add_piece(float* dst, float4 v, int width) {
  if (width == 4)
    atomicAdd(reinterpret_cast<float4*>(dst), v);
  else if (width == 2)
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v.x, v.y));
  else
    atomicAdd(dst, v.x);
}

#define K2N_NONE 0xffffffffffffffffull  // no target this round
#define K2N_NO_ROW 0xffffffffu           // no row (a lane past the points)

// One round of a warp's atomics into one level's gradient: lane i adds v
// (`width` floats) at level + (key >> 1), or nothing for key K2N_NONE.
// Where the warp merges (`merge`, the same for all its lanes), lanes with
// one key (one target and width: the key's low bit marks a merged
// x-neighbour pair) are merged first: the lowest of them sums the others'
// v from the warp's stage, in lane order, and issues the one atomic; a
// round where no two lanes share a target skips the stage.
__device__ __forceinline__ void scatter_round(float* level,
                                              unsigned long long key,
                                              float4 v, int width,
                                              float4* stage, int lane,
                                              bool merge) {
  const unsigned int all = 0xffffffffu;
  const bool live = key != K2N_NONE;
  if (!merge) {
    if (live) add_piece(level + (key >> 1), v, width);
    return;
  }
  if (!__any_sync(all, live)) return;
  const unsigned int peers = __match_any_sync(all, key);
  const bool shared = live && peers != (1u << lane);
  if (!__any_sync(all, shared)) {
    if (live) add_piece(level + (key >> 1), v, width);
    return;
  }
  stage[lane] = v;
  __syncwarp();
  if (live && lane == __ffs(peers) - 1) {
    float4 acc = v;
    for (unsigned int m = peers & (peers - 1); m; m &= m - 1) {
      const float4 o = stage[__ffs(m) - 1];
      acc = make_float4(__fadd_rn(acc.x, o.x), __fadd_rn(acc.y, o.y),
                        __fadd_rn(acc.z, o.z), __fadd_rn(acc.w, o.w));
    }
    add_piece(level + (key >> 1), acc, width);
  }
  __syncwarp();
}

// A thread per (point, slice of W features) walks levels [g0, g0 + group)
// of its point, g0 = blockIdx.y * group; any feature width. Per level it
// computes the cell once from the point read once, reads its slice of g
// (a group's slices are one 32-byte sector at F = 2), and adds the 8
// corners' terms g * w in 8 rounds, corners c and c | 4 (x-neighbours)
// in rounds 2k and 2k + 1: where a thread owns whole rows of 1 or 2
// floats (F = W) and the two rows are the halves of one aligned 8- or
// 16-byte piece (idx and idx ^ 1 on a hashed level of a power-of-two size
// at even cx; idx and idx + 1 on a dense level at an even index), one
// atomic of the piece in round 2k and none in round 2k + 1; else one
// atomic of W floats a corner. A level's rounds are merged within the
// warp only where two of its lanes share a cell there.
template <int W>
__global__ void __launch_bounds__(K2N_THREADS, K2N_MIN_BLOCKS)
    scatter_group_kernel(const float* __restrict__ x,
                         const float* __restrict__ g,
                         float* __restrict__ dtable, Levels geo,
                         float offset, long long n, int levels,
                         long long table_size, int features, int group) {
  __shared__ float4 stage[K2N_THREADS];
  const int slices = features / W;
  const long long t = (long long)blockIdx.x * K2N_THREADS + threadIdx.x;
  const long long p = t / slices;
  const int s = (int)(t - p * slices);
  const int lane = threadIdx.x & 31;
  const bool live = p < n;
  if (!__any_sync(0xffffffffu, live)) return;
  const int g0 = blockIdx.y * group;
  const int levels_here = min(group, levels - g0);
  const bool pairs = slices == 1 && W < 4;
  float xp[3] = {0.0f, 0.0f, 0.0f};
  if (live)
    for (int a = 0; a < 3; ++a) xp[a] = x[p * 3 + a];
  const float* src = g + p * levels * (long long)features + s * W;
  float4* warp_stage = stage + (threadIdx.x - lane);
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
    const float4 gv =
        live ? load_slice<W>(src + (long long)l * features) : float4{};
    float* level = dtable + (long long)l * table_size * features;
    // The warp merges this level's rounds where two of its lanes share a
    // cell (the row of its first corner): a match a level, not a round.
    const unsigned int first =
        level_corner_index(cell.c[0], cell.c[1], cell.c[2], L);
    const unsigned int mates =
        __match_any_sync(0xffffffffu, live ? first : K2N_NO_ROW);
    const bool merge = __any_sync(0xffffffffu, live && mates != (1u << lane));
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // corners q (cx) and q | 4 (cx + 1)
      const int cy = cell.c[1] + ((q >> 1) & 1), cz = cell.c[2] + (q & 1);
      const unsigned int i0 = level_corner_index(cell.c[0], cy, cz, L);
      const unsigned int i1 = level_corner_index(cell.c[0] + 1, cy, cz, L);
      const float4 t0 = scaled(gv, corner_weight(cell, q));
      const float4 t1 = scaled(gv, corner_weight(cell, q | 4));
      const unsigned int lo = min(i0, i1);
      const bool merged =
          pairs && max(i0, i1) == lo + 1 &&
          ((uintptr_t)(level + (long long)lo * W) & (8 * W - 1)) == 0;
      unsigned long long k0 = K2N_NONE, k1 = K2N_NONE;
      float4 v0 = t0;
      if (live) {
        const unsigned long long e0 =
            (unsigned long long)i0 * features + s * W;
        const unsigned long long e1 =
            (unsigned long long)i1 * features + s * W;
        if (merged) {
          k0 = ((unsigned long long)lo * W) << 1 | 1ull;
          v0 = i0 == lo ? make_float4(t0.x, W == 2 ? t0.y : t1.x,
                                      W == 2 ? t1.x : 0.0f,
                                      W == 2 ? t1.y : 0.0f)
                        : make_float4(t1.x, W == 2 ? t1.y : t0.x,
                                      W == 2 ? t0.x : 0.0f,
                                      W == 2 ? t0.y : 0.0f);
        } else {
          k0 = e0 << 1;
          k1 = e1 << 1;
        }
      }
      scatter_round(level, k0, v0, merged ? 2 * W : W, warp_stage, lane,
                    merge);
      scatter_round(level, k1, t1, W, warp_stage, lane, merge);
    }
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

// The slice of a row a narrow-rows thread owns: 4 floats where F is a
// multiple of 4, 2 where it is even, else 1.
static int slice_width(int features) {
  return features % 4 == 0 ? 4 : features % 2 == 0 ? 2 : 1;
}

// The levels a narrow-rows thread walks: those whose slices of g fill a
// 32-byte sector (4 at F = 2, 8 at F = 1, 1 from F = 5 on), at most every
// level.
static int k2_group(int features, int levels) {
  const int chosen = K2N_SECTOR / features;
  return chosen < 1 ? 1 : chosen < levels ? chosen : levels;
}

// The grid of a launch: wide rows (tiles of points, levels), narrow rows
// (chunks of K2N_THREADS (point, slice) threads, level groups); levels
// slowest.
static dim3 scatter_grid(long long n, int levels, int features) {
  if (wide_rows(features)) {
    const int chunk = tile_points(features);
    return dim3((unsigned int)((n + chunk - 1) / chunk), levels);
  }
  const long long threads = n * (features / slice_width(features));
  const int group = k2_group(features, levels);
  return dim3((unsigned int)((threads + K2N_THREADS - 1) / K2N_THREADS),
              (levels + group - 1) / group);
}

static const void* group_kernel(int features) {
  const int w = slice_width(features);
  return w == 4   ? (const void*)scatter_group_kernel<4>
         : w == 2 ? (const void*)scatter_group_kernel<2>
                  : (const void*)scatter_group_kernel<1>;
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
  if (!make_levels(&geo, scale, stride, size, dense, magic, shift, levels) ||
      features < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      dtable, 0, (size_t)levels * table_size * features * sizeof(float), s);
  if (err != cudaSuccess || n == 0) return (int)err;
  const dim3 grid = scatter_grid(n, levels, features);
  if (wide_rows(features)) {
    scatter_rows_kernel<<<grid, K2_THREADS, 0, s>>>(
        x, g, dtable, geo, offset, n, levels, table_size, features,
        tile_points(features));
    return (int)cudaGetLastError();
  }
  const int group = k2_group(features, levels);
  switch (slice_width(features)) {
    case 4:
      scatter_group_kernel<4><<<grid, K2N_THREADS, 0, s>>>(
          x, g, dtable, geo, offset, n, levels, table_size, features, group);
      break;
    case 2:
      scatter_group_kernel<2><<<grid, K2N_THREADS, 0, s>>>(
          x, g, dtable, geo, offset, n, levels, table_size, features, group);
      break;
    default:
      scatter_group_kernel<1><<<grid, K2N_THREADS, 0, s>>>(
          x, g, dtable, geo, offset, n, levels, table_size, features, group);
  }
  return (int)cudaGetLastError();
}

// out[0..7): the launch shape for n points: blocks, threads, static shared
// bytes, blocks per SM, registers per thread, points per tile (wide rows;
// on narrow rows the points a warp holds, 32 / slices, 0 where a point's
// slices do not divide a warp) and the levels a thread walks (1 on wide
// rows).
extern "C" int hashgrid_encode_bwd_shape(int levels, int features,
                                         long long n, int* out) {
  if (features < 1 || levels < 1) return (int)cudaErrorInvalidValue;
  const bool wide = wide_rows(features);
  const void* kernel =
      wide ? (const void*)scatter_rows_kernel : group_kernel(features);
  const int threads = wide ? K2_THREADS : K2N_THREADS;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = scatter_grid(n, levels, features);
  const int slices = features / slice_width(features);
  out[0] = (int)(grid.x * grid.y);
  out[1] = threads;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = per_sm;
  out[4] = attr.numRegs;
  out[5] = wide ? tile_points(features) : (32 % slices == 0 ? 32 / slices : 0);
  out[6] = wide ? 1 : k2_group(features, levels);
  return 0;
}
