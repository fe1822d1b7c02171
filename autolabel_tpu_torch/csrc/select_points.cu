// The sampled backward's point subsample (K5): k of n points drawn by
// systematic resampling from p_i ∝ ||g_i||, compacted.
//
// Replaces what XLA compiles on the TPU for
// autolabel_tpu/ops/encoders.py `_select_backward_points`: s_i = ||g_i||
// (fp32 row norms of the encode's cotangent), p = s / sum(s) (uniform when
// the sum is 0), cum = the inclusive scan of p normalized to end at 1,
// c_i = floor(k cum_i - u), counts_i = c_i - c_{i-1} (c_{-1} = -1), and
// the points with counts > 0 with coef = counts / (k p). The JAX package
// compacts them with top_k, padding to k with coef-0 rows that scatter
// nothing; here a prefix-sum compaction writes them in ascending order
// and their number to `count`, which the sampled scatter reads.
//
// What bounds it on the H100: bytes. It must read g once (n * D bf16: 128
// MiB at the flagship step's 131,072 x 512) and write the selection (k ints
// and floats). g is bf16, as the sampled encode's output and so its
// cotangent always are.
//
// Design, four kernels:
//   1. norms_kernel<CH>: the streamed read of g, s_i only. Blocks on a
//      grid stride, 8 of 256 threads an SM (faster on the H100 than the
//      blocks its registers hold at once, or one an SM: PERF.md); a
//      warp takes R = 16 / CH consecutive rows at a time and issues all
//      their 16-byte loads (CH a lane a row, CH = row bytes / 512 rounded
//      up: two at D = 512) before it reduces any: each lane adds the
//      squares of its chunks in order by fused multiply-adds, a butterfly
//      of shuffles sums the lanes (every lane ends with the same bits),
//      lane q writes row q's norm;
//   2. scan_kernel, a block per tile of 1024 points: each thread scans its
//      4 consecutive norms in order, the threads' totals are chained in
//      order along the warp (shuffles) and the warps' along the block, so
//      that the tile's inclusive scan loc_i never decreases: each partial
//      sum is an earlier one plus a non-negative number, rounded;
//   3. counts_kernel: each block chains the tiles' totals in tile order
//      (the same additions in every block, so every block gets the same
//      offsets P_b and total), cum_i = (P_b + loc_i) / total (the last one
//      exactly 1, none decreasing, so every count is >= 0 and they sum to
//      k), counts_i, and the tile's number of points with counts > 0;
//   4. compact_kernel: each block sums the earlier tiles' numbers (exact
//      integers), scans its own flags and writes (sel, coef); the last
//      tile writes the count.
// Under a device mesh (autolabel_tpu_torch/parallel) the subsample is the
// global batch's: the chain splits at its norms. select_points_norms runs
// kernel 1 on a rank's rows (squared, without the root, when the rows'
// features are split across ranks and their squares are summed first);
// the ranks gather the norms of the global batch; select_points_scan runs
// kernels 2-4 on them and keeps the draws that fall in the rank's own
// rows [lo, hi), numbered from lo. select_points is the two with every
// row the rank's.
// The order of every fp32 addition is fixed by the tile (1024 points), a
// thread's rows (4) and the lanes' chunks, so a CPU copy of it
// (hashgrid_cuda.select_chain, which checks select_points_order) gives
// the same bits. Two fp32 scans in different orders move floor(k cum - u)
// where it lies within their rounding of an integer, so the selection is
// not bit-equal to another implementation's there; its expectation is the
// same.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

#define K5_THREADS 256
#define K5_WARPS (K5_THREADS / 32)
#define K5_ROWS 4  // consecutive points a thread scans
#define K5_TILE (K5_THREADS * K5_ROWS)
#define K5_MAX_TILES 4096  // n up to 4M points

// acc plus the squares of 8 bf16 values
__device__ __forceinline__ float sumsq8(uint4 v, float acc) {
  const unsigned int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const float a = __uint_as_float(w[h] << 16);
    const float b = __uint_as_float(w[h] & 0xffff0000u);
    acc = __fmaf_rn(a, a, acc);
    acc = __fmaf_rn(b, b, acc);
  }
  return acc;
}

#define K5_NORM_THREADS 256
#define K5_NORM_WAVE 8    // norms blocks an SM: 2,048 threads
#define K5_MAX_CHUNKS 16  // 16-byte chunks a lane per row: D up to 4096

// s_i for n rows of CH * 512 bytes or fewer (`chunks` 16-byte chunks a
// row): a warp takes R = 16 / CH rows at a time, issues their loads, then
// reduces them. Without `root`, the squared norms.
template <int CH>
__global__ void __launch_bounds__(K5_NORM_THREADS)
    norms_kernel(const uint4* __restrict__ g, long long n, int chunks,
                 int root, float* __restrict__ s) {
  constexpr int R = 16 / CH;
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (K5_NORM_THREADS / 32);
  for (long long r0 = ((long long)blockIdx.x * (K5_NORM_THREADS / 32) +
                       (threadIdx.x >> 5)) * R;
       r0 < n; r0 += warps * R) {
    uint4 v[R][CH];
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int j = c * 32 + lane;  // the lane's c-th chunk of the row
        v[q][c] = r0 + q < n && j < chunks ? __ldcs(g + (r0 + q) * chunks + j)
                                           : make_uint4(0, 0, 0, 0);
      }
    float mine = 0.0f;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < CH; ++c) acc = sumsq8(v[q][c], acc);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == q) mine = acc;
    }
    if (lane < R && r0 + lane < n) s[r0 + lane] = root ? sqrtf(mine) : mine;
  }
}

// A tile's inclusive scan of the norms (loc) and its total, in the fixed
// order: a thread's K5_ROWS rows, the threads' totals along the lanes, the
// warps' along the block.
__global__ void __launch_bounds__(K5_THREADS)
    scan_kernel(const float* __restrict__ s, long long n,
                float* __restrict__ loc, float* __restrict__ tile_total) {
  __shared__ float warp_total[K5_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = (long long)blockIdx.x * K5_TILE;
  const int rows = (int)min((long long)K5_TILE, n - base);
  float run[K5_ROWS];
  float c = 0.0f;
#pragma unroll
  for (int k = 0; k < K5_ROWS; ++k) {
    const int r = tid * K5_ROWS + k;
    c = __fadd_rn(c, r < rows ? s[base + r] : 0.0f);
    run[k] = c;
  }
  // the threads' totals chained in lane order
  float q = 0.0f, mine = 0.0f;
  for (int i = 0; i < 32; ++i) {
    const float ci = __shfl_sync(0xffffffffu, c, i);
    if (lane == i) mine = q;
    q = __fadd_rn(q, ci);
  }
  if (lane == 0) warp_total[warp] = q;
  __syncthreads();
  float w = 0.0f;  // the warps' totals chained in warp order
  for (int i = 0; i < warp; ++i) w = __fadd_rn(w, warp_total[i]);
#pragma unroll
  for (int k = 0; k < K5_ROWS; ++k) {
    const int r = tid * K5_ROWS + k;
    if (r < rows) loc[base + r] = __fadd_rn(w, __fadd_rn(mine, run[k]));
  }
  if (tid == 0) {
    float t = 0.0f;
    for (int i = 0; i < K5_WARPS; ++i) t = __fadd_rn(t, warp_total[i]);
    tile_total[blockIdx.x] = t;
  }
}

// The tiles' totals chained in tile order, in shared memory by one thread:
// the offset of tile b and the total of all.
__device__ void chain_tiles(const float* __restrict__ tile_total, int tiles,
                            int b, float* offset, float* total) {
  __shared__ float tt[K5_MAX_TILES];
  __shared__ float out[2];
  for (int i = threadIdx.x; i < tiles; i += blockDim.x) tt[i] = tile_total[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    float p = 0.0f;
    for (int i = 0; i < tiles; ++i) {
      if (i == b) out[0] = p;
      p = __fadd_rn(p, tt[i]);
    }
    out[1] = p;
  }
  __syncthreads();
  *offset = out[0];
  *total = out[1];
}

__device__ __forceinline__ float draw_floor(float cum, int k, float u) {
  return floorf(__fsub_rn(__fmul_rn((float)k, cum), u));
}

// counts_i for every point; a tile's flags count its points in [lo, hi)
// with counts > 0.
__global__ void __launch_bounds__(K5_THREADS)
    counts_kernel(const float* __restrict__ loc,
                  const float* __restrict__ tile_total, long long n, int k,
                  const float* __restrict__ u_sys, long long lo, long long hi,
                  int* __restrict__ counts, int* __restrict__ tile_flags,
                  float* __restrict__ total_out) {
  __shared__ int flags;
  const int tid = threadIdx.x;
  const int tiles = gridDim.x, b = blockIdx.x;
  float offset, total;
  chain_tiles(tile_total, tiles, b, &offset, &total);
  if (tid == 0) {
    flags = 0;
    if (b == 0) *total_out = total;
  }
  __syncthreads();
  const float u = *u_sys;
  const long long base = (long long)b * K5_TILE;
  const bool uniform = !(total > 0.0f);
  int mine = 0;
#pragma unroll
  for (int q = 0; q < K5_ROWS; ++q) {
    const long long i = base + tid * K5_ROWS + q;
    if (i >= n) break;
    float cum, prev;
    if (uniform) {
      cum = __fdiv_rn((float)(i + 1), (float)n);
      prev = __fdiv_rn((float)i, (float)n);
    } else {
      cum = __fdiv_rn(__fadd_rn(offset, loc[i]), total);
      prev = i == base ? __fdiv_rn(offset, total)
                       : __fdiv_rn(__fadd_rn(offset, loc[i - 1]), total);
    }
    const float c = draw_floor(cum, k, u);
    const float cp = i == 0 ? -1.0f : draw_floor(prev, k, u);
    const int cnt = (int)(c - cp);
    counts[i] = cnt;
    mine += cnt > 0 && i >= lo && i < hi;
  }
  atomicAdd(&flags, mine);
  __syncthreads();
  if (tid == 0) tile_flags[b] = flags;
}

// The points of [lo, hi) with counts > 0, in order, numbered from lo: at
// most `cap` of them written.
__global__ void __launch_bounds__(K5_THREADS)
    compact_kernel(const float* __restrict__ s, const int* __restrict__ counts,
                   const int* __restrict__ tile_flags,
                   const float* __restrict__ total_in, long long n, int k,
                   long long lo, long long hi, int cap,
                   int* __restrict__ sel, float* __restrict__ coef,
                   int* __restrict__ count) {
  __shared__ int warp_sum[K5_WARPS];
  __shared__ int before;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  // the selected points of the earlier tiles (exact integer sums)
  int acc = 0;
  for (int i = tid; i < b; i += K5_THREADS) acc += tile_flags[i];
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) warp_sum[warp] = acc;
  __syncthreads();
  if (tid == 0) {
    int t = 0;
    for (int i = 0; i < K5_WARPS; ++i) t += warp_sum[i];
    before = t;
  }
  __syncthreads();
  const long long base = (long long)b * K5_TILE;
  int cnt[K5_ROWS];
  int mine = 0;
#pragma unroll
  for (int q = 0; q < K5_ROWS; ++q) {
    const long long i = base + tid * K5_ROWS + q;
    cnt[q] = i < n && i >= lo && i < hi ? counts[i] : 0;
    mine += cnt[q] > 0;
  }
  // exclusive scan of the threads' flags: in the warp, then across warps
  int incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  __syncthreads();
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int pos = before + incl - mine;
  for (int i = 0; i < warp; ++i) pos += warp_sum[i];
  const float total = *total_in;
  const bool uniform = !(total > 0.0f);
#pragma unroll
  for (int q = 0; q < K5_ROWS; ++q) {
    if (cnt[q] <= 0) continue;
    const long long i = base + tid * K5_ROWS + q;
    if (pos < cap) {
      const float p = uniform ? __fdiv_rn(1.0f, (float)n)
                              : __fdiv_rn(s[i], fmaxf(total, 1e-30f));
      sel[pos] = (int)(i - lo);
      coef[pos] = __fdiv_rn((float)cnt[q],
                            __fmul_rn((float)k, fmaxf(p, 1e-30f)));
    }
    ++pos;
  }
  if (b == gridDim.x - 1 && tid == K5_THREADS - 1) *count = min(pos, cap);
}

static long long k5_tiles(long long n) { return (n + K5_TILE - 1) / K5_TILE; }

// The workspace of n points, in bytes: s, loc and counts (n each), the
// tiles' totals and flags, the total. The caller may read it after a call.
extern "C" long long select_points_workspace(long long n) {
  return 4 * (3 * n + 2 * k5_tiles(n) + 4);
}

// The constants that fix K5's order of fp32 additions: points a tile and
// consecutive points a thread scans.
extern "C" void select_points_order(int* out) {
  out[0] = K5_TILE;
  out[1] = K5_ROWS;
}

typedef void (*NormsKernel)(const uint4*, long long, int, int, float*);

// The 16-byte chunks a lane reads of a row of `chunks` chunks, as the norms
// kernel's template width (1, 2, 4, 8 or K5_MAX_CHUNKS), or 0 beyond.
static int lane_chunks(int chunks) {
  for (int ch = 1; ch <= K5_MAX_CHUNKS; ch *= 2)
    if (chunks <= 32 * ch) return ch;
  return 0;
}

static NormsKernel norms_for(int ch) {
  switch (ch) {
    case 1: return norms_kernel<1>;
    case 2: return norms_kernel<2>;
    case 4: return norms_kernel<4>;
    case 8: return norms_kernel<8>;
    case K5_MAX_CHUNKS: return norms_kernel<K5_MAX_CHUNKS>;
    default: return nullptr;
  }
}

// The norms kernel's grid for n rows on the current device: K5_NORM_WAVE
// blocks an SM (2,048 threads, the most an SM holds, whatever its
// registers allow at once), and no more blocks than rows for all their
// warps; each warp walks its rows on a grid stride. The SM count is asked
// once per device and kept.
static cudaError_t norms_grid(int ch, long long n, int* blocks) {
  static std::mutex mu;
  static std::map<int, int> sms_of;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int sms = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = sms_of.find(dev);
    if (it == sms_of.end()) {
      if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev)) != cudaSuccess)
        return err;
      it = sms_of.emplace(dev, sms).first;
    }
    sms = it->second;
  }
  const long long rows = (long long)(16 / ch) * (K5_NORM_THREADS / 32);
  const long long want = (n + rows - 1) / rows;
  const long long most = (long long)sms * K5_NORM_WAVE;
  *blocks = (int)(want < most ? want : most);
  return *blocks > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// Kernel 1 on n rows of `dim` bf16 values: their norms (root) or squared
// norms into s.
extern "C" int select_points_norms(const void* g, long long n, int dim,
                                   int root, float* s, void* stream) {
  const int row_bytes = dim * 2;
  const int chunks = row_bytes / 16, ch = lane_chunks(chunks);
  if (n < 1 || row_bytes % 16 || ((uintptr_t)g & 15) || !ch)
    return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err = norms_grid(ch, n, &blocks);
  if (err != cudaSuccess) return (int)err;
  norms_for(ch)<<<blocks, K5_NORM_THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const uint4*>(g), n, chunks, root, s);
  return (int)cudaGetLastError();
}

// Kernels 2-4 on the norms of n points in the workspace's first n floats:
// the draws of k among all n, of which those in [lo, hi) are written (sel
// numbered from lo, at most cap) with their number in count.
extern "C" int select_points_scan(long long n, const float* u_sys, int k,
                                  long long lo, long long hi, int cap,
                                  void* workspace, int* sel, float* coef,
                                  int* count, void* stream) {
  const long long tiles = k5_tiles(n);
  if (n < 1 || tiles > K5_MAX_TILES || k < 1 || k > n || lo < 0 || hi > n ||
      lo >= hi || cap < 1)
    return (int)cudaErrorInvalidValue;
  float* s = reinterpret_cast<float*>(workspace);
  float* loc = s + n;
  int* counts = reinterpret_cast<int*>(loc + n);
  float* tile_total = reinterpret_cast<float*>(counts + n);
  int* tile_flags = reinterpret_cast<int*>(tile_total + tiles);
  float* total = reinterpret_cast<float*>(tile_flags + tiles);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  scan_kernel<<<(unsigned int)tiles, K5_THREADS, 0, st>>>(s, n, loc,
                                                          tile_total);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  counts_kernel<<<(unsigned int)tiles, K5_THREADS, 0, st>>>(
      loc, tile_total, n, k, u_sys, lo, hi, counts, tile_flags, total);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  compact_kernel<<<(unsigned int)tiles, K5_THREADS, 0, st>>>(
      s, counts, tile_flags, total, n, k, lo, hi, cap, sel, coef, count);
  return (int)cudaGetLastError();
}

extern "C" int select_points(const void* g, long long n, int dim,
                             const float* u_sys, int k, void* workspace,
                             int* sel, float* coef, int* count,
                             void* stream) {
  if (n < 1 || k5_tiles(n) > K5_MAX_TILES || k < 1 || k > n)
    return (int)cudaErrorInvalidValue;
  const int err = select_points_norms(g, n, dim, 1,
                                      reinterpret_cast<float*>(workspace),
                                      stream);
  if (err != 0) return err;
  return select_points_scan(n, u_sys, k, 0, n, k, workspace, sel, coef,
                            count, stream);
}

// out[0..24): per kernel (norms, scan, counts, compact) for n points of
// width dim: blocks, threads, static shared bytes, blocks per SM,
// registers, and the points a block takes at a time (norms) or a tile.
extern "C" int select_points_shape(long long n, int dim, int* out) {
  const int ch = lane_chunks(dim * 2 / 16);
  if (!ch || dim % 8 || n < 1) return (int)cudaErrorInvalidValue;
  int norms_blocks = 0;
  cudaError_t err = norms_grid(ch, n, &norms_blocks);
  if (err != cudaSuccess) return (int)err;
  const void* kernels[4] = {
      (const void*)norms_for(ch), (const void*)scan_kernel,
      (const void*)counts_kernel, (const void*)compact_kernel};
  for (int i = 0; i < 4; ++i) {
    const int threads = i == 0 ? K5_NORM_THREADS : K5_THREADS;
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, kernels[i])) != cudaSuccess)
      return (int)err;
    int per_sm = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernels[i], threads, 0)) != cudaSuccess)
      return (int)err;
    int* o = out + 6 * i;
    o[0] = i == 0 ? norms_blocks : (int)k5_tiles(n);
    o[1] = threads;
    o[2] = (int)attr.sharedSizeBytes;
    o[3] = per_sm;
    o[4] = attr.numRegs;
    o[5] = i == 0 ? 16 / ch * (K5_NORM_THREADS / 32) : K5_TILE;
  }
  return 0;
}
