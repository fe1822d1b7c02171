// Warp-tile helpers shared by the fused head and MLP kernels
// (heads_fwd.cu, heads_bwd.cu).
//
// One warp owns 16 points. Activations live in the warp's shared memory as
// bf16 row-major tiles of 16 rows; products run on the tensor cores as
// nvcuda::wmma 16x16x16 bf16 MMAs with fp32 accumulation. A layer's output
// is produced in column tiles of COL_TILE columns (MAX_FRAGS accumulator
// fragments), so any width that is a multiple of 16 is covered.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>
    FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    FragBT;

#define MAX_WARPS 8  // warps per block at most; each warp owns 16 points
#define MAX_FRAGS 8  // accumulator fragments: one column tile
#define COL_TILE (MAX_FRAGS * 16)
#define A_CHUNK 64   // columns of a wide input staged at a time

// Shared-memory bytes of one region, rounded so every region starts on a
// 128-byte boundary (wmma needs 32-byte aligned tile pointers).
__host__ __device__ __forceinline__ size_t round128(size_t b) {
  return (b + 127) & ~(size_t)127;
}

// A warp's 16-row bf16 tile of `width` columns, each row padded by 8
// elements against bank conflicts (leading dimension width + 8).
__host__ __device__ __forceinline__ size_t tile_bytes(int width) {
  return round128((size_t)16 * (width + 8) * sizeof(bf16));
}

__host__ __device__ __forceinline__ size_t scratch_bytes() {
  return round128(256 * sizeof(float));
}

__device__ __forceinline__ void zero_acc(Acc (&acc)[MAX_FRAGS]) {
#pragma unroll
  for (int j = 0; j < MAX_FRAGS; ++j) wmma::fill_fragment(acc[j], 0.0f);
}

// acc[j] += X[16 x K] @ W[0:K, col0 + 16j : col0 + 16j + 16] for the
// j < ncols / 16 fragments of one column tile.
// X: bf16 in shared memory, row-major, leading dim ldx.
// W: bf16 in device memory, row-major (in, out), leading dim ldw.
__device__ __forceinline__ void mma_rows(Acc (&acc)[MAX_FRAGS],
                                         const bf16* x, int ldx, int k_dim,
                                         const bf16* __restrict__ w, int ldw,
                                         int col0, int ncols) {
  const int nf = ncols >> 4;
  for (int k = 0; k < k_dim; k += 16) {
    FragA a;
    wmma::load_matrix_sync(a, x + k, ldx);
#pragma unroll
    for (int j = 0; j < MAX_FRAGS; ++j) {
      if (j < nf) {
        FragB b;
        wmma::load_matrix_sync(b, w + (size_t)k * ldw + col0 + j * 16, ldw);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
}

// acc[j] += X[16 x K] @ W^T[0:K, col0 + 16j : ...], where W is stored
// row-major as (out, K) with leading dim ldw: the transposed product of a
// backward pass, read without materialising the transpose.
__device__ __forceinline__ void mma_rows_t(Acc (&acc)[MAX_FRAGS],
                                           const bf16* x, int ldx, int k_dim,
                                           const bf16* __restrict__ w,
                                           int ldw, int col0, int ncols) {
  const int nf = ncols >> 4;
  for (int k = 0; k < k_dim; k += 16) {
    FragA a;
    wmma::load_matrix_sync(a, x + k, ldx);
#pragma unroll
    for (int j = 0; j < MAX_FRAGS; ++j) {
      if (j < nf) {
        FragBT b;
        wmma::load_matrix_sync(b, w + (size_t)(col0 + j * 16) * ldw + k,
                               ldw);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
}

// Hand every accumulator element (row, col within the tile, value) to op,
// one 16x16 fragment at a time through the warp's fp32 scratch tile.
template <class Op>
__device__ __forceinline__ void epilogue(Acc (&acc)[MAX_FRAGS], int ncols,
                                         float* scratch, int lane, Op op) {
  const int nf = ncols >> 4;
#pragma unroll
  for (int j = 0; j < MAX_FRAGS; ++j) {
    if (j < nf) {
      wmma::store_matrix_sync(scratch, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32)
        op(e >> 4, j * 16 + (e & 15), scratch[e]);
      __syncwarp();
    }
  }
}

// One layer of n_out columns, tile by tile: prod(col0, ncols) accumulates
// the tile's products into acc, then op(row, col, value) consumes every
// element (col counts from the layer's first column).
template <class Prod, class Op>
__device__ __forceinline__ void layer(int n_out, Acc (&acc)[MAX_FRAGS],
                                      float* scratch, int lane, Prod prod,
                                      Op op) {
  for (int c0 = 0; c0 < n_out; c0 += COL_TILE) {
    const int nc = min(COL_TILE, n_out - c0);
    zero_acc(acc);
    prod(c0, nc);
    epilogue(acc, nc, scratch, lane,
             [&](int r, int c, float v) { op(r, c0 + c, v); });
  }
}

// dst[r][c] = bf16(src[r][col0 + c]) for c < width; zero past the source's
// columns or rows. src points at the warp's first row.
__device__ __forceinline__ void load_rows(bf16* dst, int ld,
                                          const float* __restrict__ src,
                                          int src_cols, int col0, int width,
                                          int rows, int lane) {
  for (int e = lane; e < 16 * width; e += 32) {
    int r = e / width;
    int c = e - r * width;
    float v = 0.0f;
    if (r < rows && col0 + c < src_cols)
      v = src[(size_t)r * src_cols + col0 + c];
    dst[r * ld + c] = __float2bfloat16(v);
  }
  __syncwarp();
}

__host__ __device__ __forceinline__ bool tile_width(int v) {
  return v > 0 && v % 16 == 0;
}

// Warps per block for a kernel whose warps each take warp_bytes of dynamic
// shared memory: as many as fit, at most max_warps; 0 when not even one
// fits. Opts the kernel in to more than 48 KB where needed.
static int fit_warps(const void* kernel, size_t warp_bytes, int max_warps,
                     cudaError_t* err) {
  int dev = 0, optin = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  *err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (*err != cudaSuccess) return 0;
  int warps = (int)((size_t)optin / warp_bytes);
  if (warps > max_warps) warps = max_warps;
  if (warps < 1) {
    *err = cudaErrorInvalidValue;  // shared memory runs out
    return 0;
  }
  size_t smem = (size_t)warps * warp_bytes;
  if (smem > 48 * 1024) {
    *err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (*err != cudaSuccess) return 0;
  }
  return warps;
}

// The 14 packed head matrices, in pack_head_weights order.
enum { WA, WBs, W1s, W2s, WBc, WSc, W1c, W2c, WSf, W1f, W2f, WFo, WSo, W1o,
       N_WEIGHTS };
struct HeadsWeights {
  const bf16* m[N_WEIGHTS];
};

// Layer widths (all multiples of 16): A's packed width, B's width, sigma
// hidden, S width, color hidden, R / out1 width, feature hidden, feature
// width, logits hidden, logits width; then the real columns of A and B.
struct HeadsDims {
  int Ap, Bw, H, Sw, Hc, Rw, Hf, Sp, Ho, Cp, a_cols, b_cols;
};

__host__ __device__ __forceinline__ HeadsDims heads_dims(const int* v) {
  HeadsDims d = {v[0], v[1], v[2], v[3], v[4],  v[5],
                 v[6], v[7], v[8], v[9], v[10], v[11]};
  return d;
}

static bool heads_dims_ok(const HeadsDims& d) {
  const int widths[] = {d.Ap, d.Bw, d.H, d.Sw, d.Hc, d.Rw, d.Hf, d.Sp,
                        d.Ho, d.Cp};
  for (int v : widths)
    if (!tile_width(v)) return false;
  return d.a_cols <= d.Ap && d.b_cols <= d.Bw && d.Rw >= 4;
}

// The widest hidden layer: the width of the activation tiles that any
// hidden layer may occupy.
__host__ __device__ __forceinline__ int heads_hidden(const HeadsDims& d) {
  int pq = d.H;
  if (d.Hc > pq) pq = d.Hc;
  if (d.Hf > pq) pq = d.Hf;
  if (d.Ho > pq) pq = d.Ho;
  return pq;
}
