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
// updates of F floats, resolved by float4 atomics in L2.
//
// Design (K2's scatter_rows_kernel frame): blocks run one level each,
// levels slowest; a block takes a tile of up to 32 selected points of its
// level (it reads how many there are from the device, so a launch sized
// for k points skips the empty tail); cp.async stages the tile's slices of
// g into shared memory; one thread per (point, target) computes its row
// and weight (the draw) once; the tile's pairs are grouped by row in an
// open-addressing table in shared memory; a warp per row sums its terms in
// fp32 registers and adds them with one float4 atomic per lane. The output
// is zeroed with cudaMemsetAsync first; atomics and the groups' order make
// the last bits nondeterministic.
#include <cuda_bf16.h>

#include "hashgrid_common.cuh"
#include "mma_ptx.cuh"

#define K2S_POINTS 32
#define K2S_THREADS 256
#define K2S_WARPS (K2S_THREADS / 32)
#define K2S_ENTRIES (8 * K2S_POINTS)
#define K2S_SLOTS (2 * K2S_ENTRIES)  // the row table's slots, a power of two
#define K2S_G_BYTES (K2S_POINTS * 512)  // the staged g
#define K2S_EMPTY 0xffffffffu

struct Rows {
  int r[MAX_LEVELS];
};

__host__ __device__ constexpr int k2s_log2(int v) {
  return v <= 1 ? 0 : 1 + k2s_log2(v >> 1);
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

// The (row, weight) of target t of a point on a level with E < A rows:
// t = 0 of a residual pair is the max-weight atom, the other target a draw.
__device__ __forceinline__ void draw_target(const int* __restrict__ ia,
                                            const float* __restrict__ wa,
                                            long long stride, int atoms,
                                            int E, int t, float u,
                                            unsigned int* row, float* w) {
  float wv[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) wv[a] = a < atoms ? wa[a * stride] : 0.0f;
  int j = 0;
  if (E == 2) {
    int m = 0;
#pragma unroll
    for (int a = 1; a < 8; ++a)
      if (a < atoms && wv[a] > wv[m]) m = a;
    const float wm = wv[m];
    if (t == 0) {
      *row = (unsigned int)ia[m * stride];
      *w = wm;
      return;
    }
    float cum[8];
    float c = m == 0 ? 0.0f : wv[0];
    cum[0] = c;
#pragma unroll
    for (int a = 1; a < 8; ++a)
      if (a < atoms) {
        c = __fadd_rn(c, a == m ? 0.0f : wv[a]);
        cum[a] = c;
      }
    const float d = fmaxf(c, 1e-12f);
#pragma unroll
    for (int a = 0; a < 7; ++a)
      if (a < atoms - 1) j += u > __fdiv_rn(cum[a], d);
    *row = (unsigned int)ia[j * stride];
    *w = __fsub_rn(1.0f, wm);
    return;
  }
  float c = wv[0];
  j = u > c;
#pragma unroll
  for (int a = 1; a < 7; ++a)
    if (a < atoms - 1) {
      c = __fadd_rn(c, wv[a]);
      j += u > c;
    }
  *row = (unsigned int)ia[j * stride];
  *w = 1.0f;
}

// A block per tile of `points` selected points of level blockIdx.y.
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
                        int features, int atoms, int points) {
  __shared__ __align__(16) unsigned char staged[K2S_G_BYTES];
  __shared__ unsigned int key[K2S_SLOTS];  // a group's row
  __shared__ int head[K2S_SLOTS];          // its first entry
  __shared__ int next[K2S_ENTRIES];        // the entry after, or -1
  __shared__ float weight[K2S_ENTRIES];
  __shared__ unsigned char owner[K2S_ENTRIES];  // the entry's tile point
  __shared__ int group[K2S_ENTRIES];            // the slots of the groups
  __shared__ long long point[K2S_POINTS];
  __shared__ float scale[K2S_POINTS];
  __shared__ int groups;
  G* gt = reinterpret_cast<G*>(staged);
  const int l = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long q0 = (long long)blockIdx.x * points;
  const long long m = count ? (long long)*count : slots;
  if (q0 >= m) return;
  const int live = (int)min((long long)points, min(m, slots) - q0);
  if (live <= 0) return;
  if (tid < live) {
    point[tid] = sel ? (long long)sel[q0 + tid] : q0 + tid;
    scale[tid] = sel ? coef[q0 + tid] : 1.0f;
  }
  for (int s = tid; s < K2S_SLOTS; s += K2S_THREADS) {
    key[s] = K2S_EMPTY;
    head[s] = -1;
  }
  if (tid == 0) groups = 0;
  __syncthreads();
  // g's slice of each point: 16-byte copies, a row a warp
  constexpr int vec = 16 / sizeof(G);
  const int chunks = features / vec;
  for (int r = warp; r < live; r += K2S_WARPS)
    for (int c = lane; c < chunks; c += 32)
      cp_async16(gt + r * features + c * vec,
                 g + (point[r] * levels + l) * (long long)features + c * vec,
                 true);
  cp_async_commit();

  const int E = rows.r[l];
  for (int e = tid; e < E * live; e += K2S_THREADS) {
    const int r = e / E, t = e - r * E;
    const long long i = point[r];
    const int* ia = idx + (long long)l * atoms * n + i;
    const float* wa = wts + (long long)l * atoms * n + i;
    unsigned int row;
    float w;
    if (E >= atoms) {
      row = (unsigned int)ia[t * n];
      w = wa[t * n];
    } else {
      draw_target(ia, wa, n, atoms, E, t, u[l * u_stride + i], &row, &w);
    }
    weight[e] = w;
    owner[e] = (unsigned char)r;
    unsigned int s = (row * 2654435761u) >> (32 - k2s_log2(K2S_SLOTS));
    for (;;) {  // linear probing; the first entry of a row opens its group
      const unsigned int was = atomicCAS(&key[s], K2S_EMPTY, row);
      if (was == K2S_EMPTY) {
        group[atomicAdd(&groups, 1)] = s;
        break;
      }
      if (was == row) break;
      s = (s + 1) & (K2S_SLOTS - 1);
    }
    next[e] = atomicExch(&head[s], e);
  }
  cp_async_wait_all();
  __syncthreads();

  // A warp per group: the sum of w * (g * coef) over its entries, then one
  // float4 atomic a lane.
  float* level = dtable + (long long)l * table_size * features;
  for (int v = warp; v < groups; v += K2S_WARPS) {
    const int s = group[v];
    float* dst = level + (long long)key[s] * features;
    for (int f = lane * 4; f < features; f += 128) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int e = head[s]; e >= 0; e = next[e]) {
        const int r = owner[e];
        const float4 x = load4(gt + r * features + f);
        const float c = scale[r], w = weight[e];
        acc.x = __fadd_rn(acc.x, __fmul_rn(__fmul_rn(x.x, c), w));
        acc.y = __fadd_rn(acc.y, __fmul_rn(__fmul_rn(x.y, c), w));
        acc.z = __fadd_rn(acc.z, __fmul_rn(__fmul_rn(x.z, c), w));
        acc.w = __fadd_rn(acc.w, __fmul_rn(__fmul_rn(x.w, c), w));
      }
      atomicAdd(reinterpret_cast<float4*>(dst + f), acc);
    }
  }
}

// Points per tile: as many as the staged g holds, at most K2S_POINTS.
static int k2s_tile_points(int features, int g_bytes) {
  const int p = K2S_G_BYTES / (features * g_bytes);
  return p < K2S_POINTS ? p : K2S_POINTS;
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
  const int g_bytes = g_bf16 ? 2 : 4;
  if (levels < 1 || levels > MAX_LEVELS || features < 8 || features % 8 ||
      features * g_bytes > K2S_G_BYTES || (atoms != 4 && atoms != 8) ||
      (!sel) != (!coef) || (!sel) != (!count))
    return (int)cudaErrorInvalidValue;
  Rows r;
  for (int l = 0; l < levels; ++l) {
    if (rows[l] != 1 && rows[l] != 2 && rows[l] != atoms)
      return (int)cudaErrorInvalidValue;
    if (rows[l] < atoms && !u) return (int)cudaErrorInvalidValue;
    r.r[l] = rows[l];
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      dtable, 0, (size_t)levels * table_size * features * sizeof(float), s);
  if (err != cudaSuccess || n == 0 || slots == 0) return (int)err;
  const int points = k2s_tile_points(features, g_bytes);
  const dim3 grid((unsigned int)((slots + points - 1) / points), levels);
  if (g_bf16)
    sampled_rows_kernel<__nv_bfloat16><<<grid, K2S_THREADS, 0, s>>>(
        reinterpret_cast<const __nv_bfloat16*>(g), idx, w, u, u_stride, sel,
        coef, count, r, dtable, slots, n, levels, table_size, features,
        atoms, points);
  else
    sampled_rows_kernel<float><<<grid, K2S_THREADS, 0, s>>>(
        reinterpret_cast<const float*>(g), idx, w, u, u_stride, sel, coef,
        count, r, dtable, slots, n, levels, table_size, features, atoms,
        points);
  return (int)cudaGetLastError();
}

// out[0..6): the launch shape for `slots` points: blocks, threads, static
// shared bytes, blocks per SM, registers per thread, points per tile.
extern "C" int hashgrid_sampled_bwd_shape(int levels, int features,
                                          long long slots, int g_bf16,
                                          int* out) {
  const void* kernel = g_bf16
                           ? (const void*)sampled_rows_kernel<__nv_bfloat16>
                           : (const void*)sampled_rows_kernel<float>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      K2S_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  const int points = k2s_tile_points(features, g_bf16 ? 2 : 4);
  out[0] = (int)((slots + points - 1) / points) * levels;
  out[1] = K2S_THREADS;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = per_sm;
  out[4] = attr.numRegs;
  out[5] = points;
  return 0;
}
