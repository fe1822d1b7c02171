// The sampled hash-grid table gradient (K2s): the backward of the
// exact-forward / sampled-backward encode, from the forward's atoms.
//
// Replaces what XLA compiles on the TPU for
// autolabel_tpu/ops/encoders.py `_encode_sampled_bwd_bwd` (after its point
// subsample, which select_points.cu computes). Per selected point i (every
// point when the points are not subsampled) and level l, with the (L, A, N)
// atoms (rows idx, weights w) and uniforms u (L, N[+1]), the cotangent
// g[i, l*F:(l+1)*F] * coef_i goes into rows[l] table rows:
//   - rows[l] = A: every atom at its weight (the exact gradient; every
//     level at A rows is the table gradient of the exact simplex encode);
//   - 2: the max-weight atom m (the first on ties, as jnp.argmax) at w_m,
//     and atom j at 1 - w_m, j = #{a < A - 1 : u > cum_a / cum_{A-1}}, cum
//     the fp32 partial sums, in atom order, of w with atom m zeroed;
//   - 1: atom j at weight 1, j = #{a < A - 1 : u > cum_a}, cum the partial
//     sums of w.
// The draws compare the same fp32 numbers as the JAX package does, so they
// pick the same rows. A term is fp32 (w * (g * coef)), as there.
//
// What bounds it on the H100: bytes. It must read the selected points' g
// (k * L * F, bf16 or fp32), their atoms and uniforms, and write the table
// gradient (64 MiB at TPU_GRID) once. The scatter is k * sum(rows) row
// updates of F floats, resolved by float4 atomics in L2. At the
// flagship's few thousand points the kernel is a few dependent memory
// round trips a tile (count, sel, atoms and g, atomics), slowed by the
// write-back of the memset before it, which shares DRAM with them.
//
// Design: persistent blocks (the SMs times the blocks an SM holds, no
// more than the slots' tiles) walk tiles of the selected points up to the
// count drawn, which they read from the device: the grid is sized by the
// card, not by the k slots, and a tile holds the count dealt evenly to
// the blocks, at most K2S_POINTS (a few at the flagship's draw of about
// 4,000 of 32,768 slots, so every SM has work). A tile spans every
// level: its points' sel, coef and full g rows (L * F values, contiguous;
// staged by cp.async) are read once; a thread per (point, level) issues
// that level's atom weights, indices and uniform together and computes its
// rows[l] (row, weight) targets (the draw) at once; the tile's targets are
// grouped by (level, row) in an open-addressing table in shared memory
// sized for its real entries (points * sum(rows)); a warp per group sums
// its terms in fp32 registers and adds them with one float4 atomic per
// lane. The output is zeroed with cudaMemsetAsync first (at its bound: a
// 64 MiB write); atomics and the groups' order make the last bits
// nondeterministic.
#include <cuda_bf16.h>

#include <array>
#include <map>
#include <mutex>

#include "hashgrid_common.cuh"
#include "mma_ptx.cuh"

#define K2S_THREADS 256
#define K2S_WARPS (K2S_THREADS / 32)
#define K2S_POINTS 32         // points a tile, at most
#define K2S_ENTRIES 1024      // (point, target) entries a tile, at most
#define K2S_G_BYTES (64 * 1024)  // the staged g rows, at most
#define K2S_EMPTY 0xffffffffu

// Per level: its rows and the offset of its first target among a point's.
struct Rows {
  int r[MAX_LEVELS];
  int off[MAX_LEVELS];
};

// A launch's tile: points, entries, the row table's slots (log2) and the
// dynamic shared layout.
struct Tile {
  int points, entries, log2_slots;
  unsigned int g, key, head, next, weight, src, group, point, scale, bytes;
};

static Tile k2s_tile(int levels, int features, int g_bytes, int sum_rows) {
  Tile t{};
  const int row = levels * features * g_bytes;
  int p = K2S_POINTS;
  if (p > K2S_G_BYTES / row) p = K2S_G_BYTES / row;
  if (p > K2S_ENTRIES / sum_rows) p = K2S_ENTRIES / sum_rows;
  if (p < 1) return t;
  t.points = p;
  t.entries = p * sum_rows;
  t.log2_slots = 1;
  while ((1 << t.log2_slots) < 2 * t.entries) ++t.log2_slots;
  const size_t slots = (size_t)1 << t.log2_slots;
  size_t at = 0;
  auto take = [&](size_t bytes) {
    const unsigned int here = (unsigned int)at;
    at += round128(bytes);
    return here;
  };
  t.g = take((size_t)p * row);
  t.key = take(slots * 4);
  t.head = take(slots * 4);
  t.next = take((size_t)t.entries * 4);
  t.weight = take((size_t)t.entries * 4);
  t.src = take((size_t)t.entries * 4);
  t.group = take((size_t)t.entries * 4);
  t.point = take((size_t)p * 8);
  t.scale = take((size_t)p * 4);
  t.bytes = (unsigned int)at;
  return t;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 b = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(b.x << 16),
                     __uint_as_float(b.x & 0xffff0000u),
                     __uint_as_float(b.y << 16),
                     __uint_as_float(b.y & 0xffff0000u));
}

// Add entry e, a target in table row `row` (level * table size + row), to
// the tile's row table: the first entry of a row opens its group.
__device__ __forceinline__ void insert(unsigned int* key, int* head,
                                       int* next, int* group, int* groups,
                                       int log2_slots, unsigned int row,
                                       int e) {
  const unsigned int mask = (1u << log2_slots) - 1u;
  unsigned int s = (row * 2654435761u) >> (32 - log2_slots);
  for (;;) {  // linear probing
    const unsigned int was = atomicCAS(&key[s], K2S_EMPTY, row);
    if (was == K2S_EMPTY) {
      group[atomicAdd(groups, 1)] = (int)s;
      break;
    }
    if (was == row) break;
    s = (s + 1) & mask;
  }
  next[e] = atomicExch(&head[s], e);
}

// A persistent block walks tiles of up to `tile.points` selected points
// (every level of each), up to the count drawn.
template <typename G>
__global__ void __launch_bounds__(K2S_THREADS)
    sampled_rows_kernel(const G* __restrict__ g, const int* __restrict__ idx,
                        const float* __restrict__ wts,
                        const float* __restrict__ u, long long u_stride,
                        const int* __restrict__ sel,
                        const float* __restrict__ coef,
                        const int* __restrict__ count, Rows rows,
                        float* __restrict__ dtable, long long slots,
                        long long n, int levels, long long table_size,
                        int features, int atoms, int sum_rows, Tile tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  G* staged = reinterpret_cast<G*>(smem + tile.g);
  unsigned int* key = reinterpret_cast<unsigned int*>(smem + tile.key);
  int* head = reinterpret_cast<int*>(smem + tile.head);
  int* next = reinterpret_cast<int*>(smem + tile.next);
  float* weight = reinterpret_cast<float*>(smem + tile.weight);
  int* src = reinterpret_cast<int*>(smem + tile.src);  // point * L + level
  int* group = reinterpret_cast<int*>(smem + tile.group);
  long long* point = reinterpret_cast<long long*>(smem + tile.point);
  float* scale = reinterpret_cast<float*>(smem + tile.scale);
  __shared__ int groups;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int width = levels * features;
  const int n_slots = 1 << tile.log2_slots;
  const long long m = count ? min((long long)*count, slots) : slots;
  // points a tile: the m points dealt evenly to the grid, at most the
  // layout's, so that a small draw still spreads over every SM
  const long long even = (m + gridDim.x - 1) / gridDim.x;
  const int P = (int)max(1LL, min((long long)tile.points, even));
  constexpr int vec = 16 / sizeof(G);
  const int chunks = width / vec;
  for (long long q0 = (long long)blockIdx.x * P; q0 < m;
       q0 += (long long)gridDim.x * P) {
    const int live = (int)min((long long)P, m - q0);
    if (tid < live) {
      point[tid] = sel ? (long long)sel[q0 + tid] : q0 + tid;
      scale[tid] = sel ? coef[q0 + tid] : 1.0f;
    }
    for (int s = tid; s < n_slots; s += K2S_THREADS) {
      key[s] = K2S_EMPTY;
      head[s] = -1;
    }
    if (tid == 0) groups = 0;
    __syncthreads();
    // each point's g row, once for all levels: 16-byte copies
    for (int c = tid; c < live * chunks; c += K2S_THREADS) {
      const int r = c / chunks, j = c - r * chunks;
      cp_async16(staged + r * width + j * vec,
                 g + point[r] * (long long)width + j * vec, true);
    }
    cp_async_commit();
    // a thread per (point, level), points fastest so that a warp's loads
    // of one atom row fall in few sectors: its atoms and uniform read
    // together, then its rows[l] targets
    for (int e = tid; e < live * levels; e += K2S_THREADS) {
      const int l = e / live, r = e - l * live;
      const long long i = point[r];
      const int* ia = idx + (long long)l * atoms * n + i;
      const float* wa = wts + (long long)l * atoms * n + i;
      const int E = rows.r[l];
      float wv[8];
      int iv[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        wv[a] = a < atoms ? wa[a * n] : 0.0f;
        iv[a] = a < atoms ? ia[a * n] : 0;
      }
      const float ul = E < atoms ? u[l * u_stride + i] : 0.0f;
      const int first = r * sum_rows + rows.off[l];
      const unsigned int level_row = (unsigned int)(l * table_size);
      auto target = [&](int t, int row, float w) {
        weight[first + t] = w;
        src[first + t] = r * levels + l;
        insert(key, head, next, group, &groups, tile.log2_slots,
               level_row + (unsigned int)row, first + t);
      };
      // iv[j] for a j known only at run time, by unrolled compares: no
      // indexing at run time, so wv and iv stay in registers
      auto row_of = [&](int j) {
        int row = iv[0];
#pragma unroll
        for (int a = 1; a < 8; ++a)
          if (a == j) row = iv[a];
        return row;
      };
      if (E >= atoms) {
#pragma unroll
        for (int a = 0; a < 8; ++a)
          if (a < atoms) target(a, iv[a], wv[a]);
      } else if (E == 2) {
        // the max-weight atom (the first on ties) at w_m, and a draw from
        // the others' partial sums at 1 - w_m
        int mx = 0;
        float wm = wv[0];
#pragma unroll
        for (int a = 1; a < 8; ++a)
          if (a < atoms && wv[a] > wm) {
            mx = a;
            wm = wv[a];
          }
        float cum[8];
        float c = mx == 0 ? 0.0f : wv[0];
        cum[0] = c;
#pragma unroll
        for (int a = 1; a < 8; ++a)
          if (a < atoms) {
            c = __fadd_rn(c, a == mx ? 0.0f : wv[a]);
            cum[a] = c;
          }
        const float d = fmaxf(c, 1e-12f);
        int j = 0;
#pragma unroll
        for (int a = 0; a < 7; ++a)
          if (a < atoms - 1) j += ul > __fdiv_rn(cum[a], d);
        target(0, row_of(mx), wm);
        target(1, row_of(j), __fsub_rn(1.0f, wm));
      } else {
        // one draw J ~ w at weight 1
        float c = wv[0];
        int j = ul > c;
#pragma unroll
        for (int a = 1; a < 7; ++a)
          if (a < atoms - 1) {
            c = __fadd_rn(c, wv[a]);
            j += ul > c;
          }
        target(0, row_of(j), 1.0f);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    // A warp per group: the sum of w * (g * coef) over its entries, then one
    // float4 atomic a lane.
    for (int v = warp; v < groups; v += K2S_WARPS) {
      const int s = group[v];
      float* dst = dtable + (long long)key[s] * features;
      for (int f = lane * 4; f < features; f += 128) {
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int e = head[s]; e >= 0; e = next[e]) {
          const int sv = src[e], r = sv / levels;
          const float4 x = load4(staged + r * width +
                                 (sv - r * levels) * features + f);
          const float c = scale[r], w = weight[e];
          acc.x = __fadd_rn(acc.x, __fmul_rn(__fmul_rn(x.x, c), w));
          acc.y = __fadd_rn(acc.y, __fmul_rn(__fmul_rn(x.y, c), w));
          acc.z = __fadd_rn(acc.z, __fmul_rn(__fmul_rn(x.z, c), w));
          acc.w = __fadd_rn(acc.w, __fmul_rn(__fmul_rn(x.w, c), w));
        }
        atomicAdd(reinterpret_cast<float4*>(dst + f), acc);
      }
    }
    __syncthreads();  // the tile's table and staged rows are free again
  }
}

// The kernel of a cotangent dtype, and the blocks an SM holds at a tile's
// shared bytes on the current device, asked once and kept (the kernel's
// dynamic shared limit is raised to the card's, less its static bytes,
// so a plan never lowers another's).
struct Plan {
  const void* kernel;
  int per_sm, sms;
};

static cudaError_t k2s_plan(int g_bf16, const Tile& t, Plan* p) {
  static std::mutex mu;
  static std::map<std::array<int, 3>, std::pair<cudaError_t, Plan>> kept;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::array<int, 3> k = {dev, g_bf16, (int)t.bytes};
  std::lock_guard<std::mutex> lock(mu);
  auto it = kept.find(k);
  if (it == kept.end()) {
    Plan q{g_bf16 ? (const void*)sampled_rows_kernel<__nv_bfloat16>
                  : (const void*)sampled_rows_kernel<float>,
           0, 0};
    int limit = 0;
    cudaFuncAttributes attr;
    if ((err = cudaDeviceGetAttribute(
             &q.sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(
             &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
            cudaSuccess ||
        (err = cudaFuncGetAttributes(&attr, q.kernel)) != cudaSuccess)
      return err;
    limit -= (int)attr.sharedSizeBytes;  // the dynamic part's limit
    if ((err = cudaFuncSetAttribute(
             q.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             limit)) != cudaSuccess)
      return err;
    if ((int)t.bytes > limit) {
      err = cudaErrorInvalidValue;
    } else {
      if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &q.per_sm, q.kernel, K2S_THREADS, t.bytes)) != cudaSuccess)
        return err;
      err = q.per_sm < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
    }
    it = kept.emplace(k, std::make_pair(err, q)).first;
  }
  *p = it->second.second;
  return it->second.first;
}

// The persistent grid: the SMs times the blocks an SM holds, no more than
// the slots' tiles.
static int k2s_blocks(const Plan& p, const Tile& t, long long slots) {
  const long long tiles = (slots + t.points - 1) / t.points;
  const long long most = (long long)p.sms * p.per_sm;
  return (int)(tiles < most ? tiles : most);
}

// The rows of each level checked and their offsets; the tile for them.
static cudaError_t k2s_setup(const int* rows, int levels, int features,
                             int atoms, int g_bf16, long long table_size,
                             Rows* r, int* sum_rows, Tile* t) {
  if (levels < 1 || levels > MAX_LEVELS || features < 8 || features % 8 ||
      (atoms != 4 && atoms != 8) ||
      (long long)levels * table_size >= (long long)K2S_EMPTY)
    return cudaErrorInvalidValue;
  *sum_rows = 0;
  for (int l = 0; l < levels; ++l) {
    if (rows[l] != 1 && rows[l] != 2 && rows[l] != atoms)
      return cudaErrorInvalidValue;
    r->r[l] = rows[l];
    r->off[l] = *sum_rows;
    *sum_rows += rows[l];
  }
  *t = k2s_tile(levels, features, g_bf16 ? 2 : 4, *sum_rows);
  return t->points < 1 ? cudaErrorInvalidValue : cudaSuccess;
}

extern "C" int hashgrid_sampled_bwd(const void* g, int g_bf16,
                                    const int* idx, const float* w,
                                    const float* u, long long u_stride,
                                    const int* sel, const float* coef,
                                    const int* count, const int* rows,
                                    float* dtable, long long slots,
                                    long long n, int levels,
                                    long long table_size, int features,
                                    int atoms, void* stream) {
  if ((!sel) != (!coef) || (!sel) != (!count))
    return (int)cudaErrorInvalidValue;
  Rows r;
  Tile t;
  int sum_rows = 0;
  cudaError_t err = k2s_setup(rows, levels, features, atoms, g_bf16,
                              table_size, &r, &sum_rows, &t);
  if (err != cudaSuccess) return (int)err;
  for (int l = 0; l < levels; ++l)
    if (rows[l] < atoms && !u) return (int)cudaErrorInvalidValue;
  Plan p;
  if ((err = k2s_plan(g_bf16, t, &p)) != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  err = cudaMemsetAsync(
      dtable, 0, (size_t)levels * table_size * features * sizeof(float), s);
  if (err != cudaSuccess || n == 0 || slots == 0) return (int)err;
  const int blocks = k2s_blocks(p, t, slots);
  if (g_bf16)
    sampled_rows_kernel<__nv_bfloat16><<<blocks, K2S_THREADS, t.bytes, s>>>(
        reinterpret_cast<const __nv_bfloat16*>(g), idx, w, u, u_stride, sel,
        coef, count, r, dtable, slots, n, levels, table_size, features,
        atoms, sum_rows, t);
  else
    sampled_rows_kernel<float><<<blocks, K2S_THREADS, t.bytes, s>>>(
        reinterpret_cast<const float*>(g), idx, w, u, u_stride, sel, coef,
        count, r, dtable, slots, n, levels, table_size, features, atoms,
        sum_rows, t);
  return (int)cudaGetLastError();
}

// out[0..6): the launch shape for `slots` points and these rows: blocks,
// threads, dynamic shared bytes, blocks per SM, registers per thread,
// points per tile.
extern "C" int hashgrid_sampled_bwd_shape(int levels, int features,
                                          int atoms, const int* rows,
                                          long long table_size,
                                          long long slots, int g_bf16,
                                          int* out) {
  Rows r;
  Tile t;
  int sum_rows = 0;
  cudaError_t err = k2s_setup(rows, levels, features, atoms, g_bf16,
                              table_size, &r, &sum_rows, &t);
  Plan p;
  if (err != cudaSuccess || (err = k2s_plan(g_bf16, t, &p)) != cudaSuccess)
    return (int)err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, p.kernel)) != cudaSuccess)
    return (int)err;
  out[0] = k2s_blocks(p, t, slots);
  out[1] = K2S_THREADS;
  out[2] = (int)t.bytes;
  out[3] = p.per_sm;
  out[4] = attr.numRegs;
  out[5] = t.points;
  return 0;
}
