// Fused 3-matrix ReLU MLP (the proposal density net), forward K4f and
// backward K4b, for Hopper.
//
// mlp3_fwd replaces the TPU kernel autolabel_tpu/ops/heads_pallas.py
// `_mlp3_fwd_kernel` (`_mlp3_fwd_impl`): out = relu(relu(X.W0).W1).W2.
// mlp3_bwd replaces `_mlp3_bwd_kernel` (`_mlp3_vjp_bwd`): dX and the three
// weight gradients.
//
// Numerics: bf16 operands with fp32 accumulation (warp-level bf16 tensor
// core MMAs, nvcuda::wmma 16x16x16), as heads_pallas._dot does on its
// accelerator; ReLU in fp32 before rounding the next operand to bf16;
// masks from the recomputed activations; fp32 weight gradients.
//
// What bounds it on the H100: bytes (36 fp32 inputs and one real output
// column per point against 2 x 6,400 MACs). Design: one warp owns 16
// points and runs the whole net on them; activations stay in that warp's
// shared memory (bf16 tiles of 16 rows) and never touch device memory. Each layer's output is produced in
// 128-column tiles, so every width that is a multiple of 16 is covered.
// Weight fragments are read from device memory (L2). The backward runs
// persistent blocks whose warps share the weight-gradient tiles at one
// block-wide phase per step, adding the block's points (K = warps x 16)
// into a per-block fp32 partial with MMAs; a second kernel sums the
// partials in block order, so dW is deterministic for a launch shape.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "partials.cuh"

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

#define FWD_WARPS 4  // warps per block where shared memory allows

__host__ __device__ __forceinline__ size_t mlp3_warp_bytes(int d_in,
                                                           int hidden) {
  return tile_bytes(d_in) + 2 * tile_bytes(hidden) + scratch_bytes();
}

__global__ void __launch_bounds__(FWD_WARPS * 32)
    mlp3_fwd_kernel(const float* __restrict__ X, int x_cols,
                    const bf16* __restrict__ W0,
                    const bf16* __restrict__ W1,
                    const bf16* __restrict__ W2, int d_in, int hidden,
                    int d_out, float* __restrict__ out, long long n) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const long long r0 = ((long long)blockIdx.x * warps + warp) * 16;
  if (r0 >= n) return;
  const int rows = (int)min((long long)16, n - r0);

  unsigned char* base = smem + warp * mlp3_warp_bytes(d_in, hidden);
  bf16* xa = (bf16*)base;
  base += tile_bytes(d_in);
  bf16* p = (bf16*)base;
  base += tile_bytes(hidden);
  bf16* q = (bf16*)base;
  base += tile_bytes(hidden);
  float* scratch = (float*)base;
  const int ldx = d_in + 8, ldh = hidden + 8;

  Acc acc[MAX_FRAGS];
  load_rows(xa, ldx, X + r0 * x_cols, x_cols, 0, d_in, rows, lane);
  layer(hidden, acc, scratch, lane, [&](int c0, int nc) {
    mma_rows(acc, xa, ldx, d_in, W0, hidden, c0, nc);
  }, [&](int r, int c, float v) {
    p[r * ldh + c] = __float2bfloat16(fmaxf(v, 0.0f));
  });
  layer(hidden, acc, scratch, lane, [&](int c0, int nc) {
    mma_rows(acc, p, ldh, hidden, W1, hidden, c0, nc);
  }, [&](int r, int c, float v) {
    q[r * ldh + c] = __float2bfloat16(fmaxf(v, 0.0f));
  });
  layer(d_out, acc, scratch, lane, [&](int c0, int nc) {
    mma_rows(acc, q, ldh, hidden, W2, d_out, c0, nc);
  }, [&](int r, int c, float v) {
    if (r < rows) out[(r0 + r) * d_out + c] = v;
  });
}

extern "C" int mlp3_fwd(const float* X, int x_cols, const void* W0,
                        const void* W1, const void* W2, int d_in, int hidden,
                        int d_out, float* out, long long n, void* stream) {
  if (!tile_width(d_in) || !tile_width(hidden) || !tile_width(d_out) ||
      x_cols > d_in)
    return (int)cudaErrorInvalidValue;
  const size_t warp_bytes = mlp3_warp_bytes(d_in, hidden);
  cudaError_t err;
  const int warps = fit_warps((const void*)mlp3_fwd_kernel, warp_bytes,
                              FWD_WARPS, &err);
  if (!warps) return (int)err;
  if (n == 0) return 0;
  unsigned int blocks = (unsigned int)((n + warps * 16 - 1) / (warps * 16));
  mlp3_fwd_kernel<<<blocks, warps * 32, warps * warp_bytes,
                    (cudaStream_t)stream>>>(X, x_cols, (const bf16*)W0,
                                            (const bf16*)W1, (const bf16*)W2,
                                            d_in, hidden, d_out, out, n);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- backward

// One term of a weight-gradient phase: part[in x out] += X^T @ dY, where
// X (16 x in) and dY (16 x out) are bf16 tiles at byte offsets x_off and
// y_off of every warp's shared memory (leading dims ldx, ldy).
struct DwTerm {
  float* part;
  int in, out;
  size_t x_off, y_off;
  int ldx, ldy;
};

__device__ __forceinline__ void dw_term(const DwTerm& t,
                                        const unsigned char* smem,
                                        size_t warp_bytes, int nwarps,
                                        int warp) {
  const int tiles_n = t.out >> 4;
  const int tiles = (t.in >> 4) * tiles_n;
  for (int i = warp; i < tiles; i += nwarps) {
    const int mi = i / tiles_n, nj = i - mi * tiles_n;
    float* dst = t.part + (size_t)mi * 16 * t.out + nj * 16;
    Acc c;
    wmma::load_matrix_sync(c, dst, t.out, wmma::mem_row_major);
    for (int w2 = 0; w2 < nwarps; ++w2) {
      const unsigned char* wb = smem + w2 * warp_bytes;
      FragAT a;  // X^T (in x 16): X's columns as rows
      wmma::load_matrix_sync(a, (const bf16*)(wb + t.x_off) + mi * 16,
                             t.ldx);
      FragB b;
      wmma::load_matrix_sync(b, (const bf16*)(wb + t.y_off) + nj * 16,
                             t.ldy);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(dst, c, t.out, wmma::mem_row_major);
  }
}

struct Mlp3Layout {
  size_t x, h1, h2, g, dh2, dh1, scratch, warp_bytes;
};

__host__ __device__ __forceinline__ Mlp3Layout mlp3_layout(int d_in,
                                                           int hidden,
                                                           int d_out) {
  Mlp3Layout L;
  size_t o = 0;
  L.x = o; o += tile_bytes(d_in);
  L.h1 = o; o += tile_bytes(hidden);
  L.h2 = o; o += tile_bytes(hidden);
  L.g = o; o += tile_bytes(d_out);
  L.dh2 = o; o += tile_bytes(hidden);
  L.dh1 = o; o += tile_bytes(hidden);
  L.scratch = o; o += scratch_bytes();
  L.warp_bytes = o;
  return L;
}

__global__ void __launch_bounds__(MAX_WARPS * 32)
    mlp3_bwd_kernel(const float* __restrict__ X, int x_cols,
                    const bf16* __restrict__ W0,
                    const bf16* __restrict__ W1,
                    const bf16* __restrict__ W2, int d_in, int hidden,
                    int d_out, const float* __restrict__ g,
                    float* __restrict__ dX, float* __restrict__ part,
                    long long n) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const Mlp3Layout L = mlp3_layout(d_in, hidden, d_out);
  const size_t total = (size_t)d_in * hidden + (size_t)hidden * hidden +
                       (size_t)hidden * d_out;
  float* dw0 = part + (size_t)blockIdx.x * total;
  float* dw1 = dw0 + (size_t)d_in * hidden;
  float* dw2 = dw1 + (size_t)hidden * hidden;
  unsigned char* mine = smem + warp * L.warp_bytes;
  bf16* x = (bf16*)(mine + L.x);
  bf16* h1 = (bf16*)(mine + L.h1);
  bf16* h2 = (bf16*)(mine + L.h2);
  bf16* gb = (bf16*)(mine + L.g);
  bf16* dh2 = (bf16*)(mine + L.dh2);
  bf16* dh1 = (bf16*)(mine + L.dh1);
  float* scratch = (float*)(mine + L.scratch);
  const int ldx = d_in + 8, ldh = hidden + 8, ldg = d_out + 8;
  auto act = [&](bf16* dst) {
    return [=](int r, int c, float v) {
      dst[r * ldh + c] = __float2bfloat16(fmaxf(v, 0.0f));
    };
  };
  auto grad = [&](bf16* dst, const bf16* mask) {
    return [=](int r, int c, float v) {
      bool on = __bfloat162float(mask[r * ldh + c]) > 0.0f;
      dst[r * ldh + c] = __float2bfloat16(on ? v : 0.0f);
    };
  };
  Acc acc[MAX_FRAGS];

  const long long step = (long long)nwarps * 16;
  for (long long base = (long long)blockIdx.x * step; base < n;
       base += (long long)gridDim.x * step) {
    const long long r0 = base + warp * 16;
    const int rows = (int)max(0LL, min(16LL, n - r0));
    const long long rs = r0 < n ? r0 : 0;
    load_rows(x, ldx, X + rs * x_cols, x_cols, 0, d_in, rows, lane);
    load_rows(gb, ldg, g + rs * d_out, d_out, 0, d_out, rows, lane);
    layer(hidden, acc, scratch, lane, [&](int c0, int nc) {
      mma_rows(acc, x, ldx, d_in, W0, hidden, c0, nc);
    }, act(h1));
    layer(hidden, acc, scratch, lane, [&](int c0, int nc) {
      mma_rows(acc, h1, ldh, hidden, W1, hidden, c0, nc);
    }, act(h2));
    layer(hidden, acc, scratch, lane, [&](int c0, int nc) {
      mma_rows_t(acc, gb, ldg, d_out, W2, d_out, c0, nc);
    }, grad(dh2, h2));
    layer(hidden, acc, scratch, lane, [&](int c0, int nc) {
      mma_rows_t(acc, dh2, ldh, hidden, W1, hidden, c0, nc);
    }, grad(dh1, h1));
    if (dX != nullptr) {
      layer(d_in, acc, scratch, lane, [&](int c0, int nc) {
        mma_rows_t(acc, dh1, ldh, hidden, W0, hidden, c0, nc);
      }, [&](int r, int c, float v) {
        if (r < rows && c < x_cols) dX[(r0 + r) * x_cols + c] = v;
      });
    }
    __syncthreads();
    DwTerm t0 = {dw0, d_in, hidden, L.x, L.dh1, ldx, ldh};
    DwTerm t1 = {dw1, hidden, hidden, L.h1, L.dh2, ldh, ldh};
    DwTerm t2 = {dw2, hidden, d_out, L.h2, L.g, ldh, ldg};
    dw_term(t0, smem, L.warp_bytes, nwarps, warp);
    dw_term(t1, smem, L.warp_bytes, nwarps, warp);
    dw_term(t2, smem, L.warp_bytes, nwarps, warp);
    __syncthreads();
  }
}

// The launch shape of a persistent backward kernel: warps per block (as
// many as shared memory allows, at most MAX_WARPS) and blocks (as many as
// stay resident on the card, at most one per step of points).
static cudaError_t persistent_shape(const void* kernel, size_t warp_bytes,
                                    long long n, int* warps, int* blocks) {
  cudaError_t err;
  *warps = fit_warps(kernel, warp_bytes, MAX_WARPS, &err);
  if (!*warps) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, *warps * 32, *warps * warp_bytes)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long steps = (n + *warps * 16 - 1) / (*warps * 16);
  long long b = (long long)sms * per_sm;
  *blocks = (int)(steps < b ? (steps > 0 ? steps : 1) : b);
  return cudaSuccess;
}

extern "C" int mlp3_bwd_workspace(int d_in, int hidden, int d_out,
                                  long long n, int* blocks_out,
                                  long long* total_out) {
  if (!tile_width(d_in) || !tile_width(hidden) || !tile_width(d_out))
    return (int)cudaErrorInvalidValue;
  int warps = 0;
  cudaError_t err = persistent_shape(
      (const void*)mlp3_bwd_kernel,
      mlp3_layout(d_in, hidden, d_out).warp_bytes, n, &warps, blocks_out);
  *total_out = (long long)d_in * hidden + (long long)hidden * hidden +
               (long long)hidden * d_out;
  return (int)err;
}

// dW holds dW0, dW1, dW2 back to back (fp32); dX may be null.
extern "C" int mlp3_bwd(const float* X, int x_cols, const void* W0,
                        const void* W1, const void* W2, int d_in, int hidden,
                        int d_out, const float* g, float* dX, float* dW,
                        float* part, int blocks, long long n, void* stream) {
  if (!tile_width(d_in) || !tile_width(hidden) || !tile_width(d_out) ||
      x_cols > d_in)
    return (int)cudaErrorInvalidValue;
  const size_t warp_bytes = mlp3_layout(d_in, hidden, d_out).warp_bytes;
  const long long total = (long long)d_in * hidden +
                          (long long)hidden * hidden +
                          (long long)hidden * d_out;
  int warps = 0, max_blocks = 0;
  cudaError_t err = persistent_shape((const void*)mlp3_bwd_kernel,
                                     warp_bytes, n, &warps, &max_blocks);
  if (err != cudaSuccess) return (int)err;
  if (blocks < 1 || blocks > max_blocks) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if ((err = cudaMemsetAsync(part, 0, (size_t)blocks * total * sizeof(float),
                             s)) != cudaSuccess)
    return (int)err;
  if (n > 0) {
    mlp3_bwd_kernel<<<blocks, warps * 32, warps * warp_bytes, s>>>(
        X, x_cols, (const bf16*)W0, (const bf16*)W1, (const bf16*)W2, d_in,
        hidden, d_out, g, dX, part, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)sum_partials(part, blocks, total, dW, s);
}
