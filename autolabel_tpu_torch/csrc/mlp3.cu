// Fused 3-matrix ReLU MLP (the proposal density net), forward K4f and
// backward K4b, for Hopper.
//
// mlp3_fwd replaces the TPU kernel autolabel_tpu/ops/heads_pallas.py
// `_mlp3_fwd_kernel` (`_mlp3_fwd_impl`): out = relu(relu(X.W0).W1).W2.
// mlp3_bwd replaces `_mlp3_bwd_kernel` (`_mlp3_vjp_bwd`): dX and the three
// weight gradients.
//
// Numerics: bf16 operands with fp32 accumulation, as heads_pallas._dot
// does on its accelerator; ReLU in fp32 before rounding the next operand to
// bf16; masks from the recomputed activations; fp32 weight gradients.
//
// What bounds both on the H100: bytes (36 fp32 inputs and one real output
// column per point against 2 x 6,400 MACs). K4f (the forward section
// below) keeps the weights in shared memory and every activation in
// registers: mma.sync m16n8k16 from ldmatrix, X staged by cp.async. K4b:
// one warp owns 16 points and runs the net on them with warp-level MMAs
// (nvcuda::wmma 16x16x16); activations stay in that warp's shared memory
// (bf16 tiles of 16 rows), each layer's output produced in 128-column
// tiles, so every width that is a multiple of 16 is covered; weight
// fragments are read from device memory (L2). It runs persistent blocks
// whose warps share the weight-gradient tiles at one block-wide phase per
// step, adding the block's points (K = warps x 16) into a per-block fp32
// partial with MMAs; a second kernel sums the partials in block order, so
// dW is deterministic for a launch shape.
#include <mma.h>

#include <array>
#include <map>
#include <mutex>
#include <utility>

#include "mma_ptx.cuh"
#include "partials.cuh"

using namespace nvcuda;
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

// ---------------------------------------------------------------- forward
//
// K4f. Weights sit in shared memory for the whole launch and every warp
// runs the net on 16-point tiles of its own, so no barrier follows the
// first: persistent blocks (FWD_WARPS warps; as many blocks as stay
// resident, at most one per FWD_WARPS tiles) load W0, W1, W2 once with
// cp.async into padded bf16 tiles (rows + 8 elements, so ldmatrix reads 8
// rows from 8 bank groups); each warp walks tiles warp, warp + all warps,
// ... and stages each tile's fp32 X rows through a ring of its own of
// fwd_stages(hidden) slots by cp.async, fwd_stages - 1 tiles ahead. Each
// layer is mma.sync m16n8k16 with B by ldmatrix.trans from the weights:
// layer 0 rounds X to bf16 in registers on its way in (8-byte shared loads,
// cvt.rn.bf16x2); the accumulators of a 16 x 8 tile pair are, lane for
// lane, the A fragment of the next layer's 16-column slice, so each
// hidden layer's ReLU and bf16 rounding run in registers and its output
// never leaves them; the last layer's accumulators go straight to device
// memory (st.global.cs). The hidden width is a template parameter (at
// most MAX_HIDDEN: the A fragments of a layer take hidden / 4 registers
// and its accumulators hidden / 2); d_in and d_out are any multiple of 16
// whose weights and X stages fit in shared memory.
#define FWD_THREADS 256
#define FWD_WARPS (FWD_THREADS / 32)
#define FWD_ROWS 16     // points per warp tile
#define MAX_HIDDEN 256  // widest hidden layer: 16 templates of 16 columns

// The ring of a warp's X tiles: three slots where the hidden width lets two
// blocks share an SM, else two (shared memory then goes to the weights).
__host__ __device__ constexpr int fwd_stages(int hidden) {
  return hidden <= 128 ? 3 : 2;
}

struct FwdLayout {
  size_t w0, w1, w2, x, bytes;
  int ldx;  // an X slot's row pitch in floats: d_in + 8
};

__host__ __device__ __forceinline__ FwdLayout fwd_layout(int d_in, int hidden,
                                                         int d_out) {
  FwdLayout L;
  size_t o = 0;
  L.ldx = d_in + 8;
  L.w0 = o; o += round128((size_t)d_in * (hidden + 8) * sizeof(bf16));
  L.w1 = o; o += round128((size_t)hidden * (hidden + 8) * sizeof(bf16));
  L.w2 = o; o += round128((size_t)hidden * (d_out + 8) * sizeof(bf16));
  L.x = o;
  o += (size_t)FWD_WARPS * fwd_stages(hidden) * FWD_ROWS * L.ldx *
       sizeof(float);
  L.bytes = o;
  return L;
}

// dst[r][c] (pitch cols + 8) = src[r][c] (pitch cols), rows x cols bf16,
// by the block's threads in 16-byte copies (cols a multiple of 16).
__device__ __forceinline__ void copy_weight(bf16* dst,
                                            const bf16* __restrict__ src,
                                            int rows, int cols) {
  const int per = cols >> 3;
  for (int i = threadIdx.x; i < rows * per; i += blockDim.x) {
    const int r = i / per, c = (i - r * per) * 8;
    cp_async16(dst + r * (cols + 8) + c, src + (size_t)r * cols + c, true);
  }
}

// A lane's share of copying a 16-row X tile: pieces (r, c) from (r0, c0)
// in steps of 32 pieces (dr rows and dc pieces), each 16 bytes (vec) or 4.
struct XCopy {
  int r0, c0, dr, dc, per;
  bool vec;
};

__device__ __forceinline__ XCopy x_copy(int x_cols, bool vec, int lane) {
  const int per = vec ? x_cols >> 2 : x_cols;
  return {lane / per, lane % per, 32 / per, 32 % per, per, vec};
}

// Stage rows [row0, row0 + 16) of X (n x x_cols fp32) into dst (pitch ldx);
// rows past n are zero-filled.
__device__ __forceinline__ void stage_tile(float* dst, int ldx,
                                           const float* __restrict__ X,
                                           int x_cols, const XCopy& cp,
                                           long long row0, long long n) {
  int r = cp.r0, c = cp.c0;
  while (r < FWD_ROWS) {
    const bool ok = row0 + r < n;
    const float* src = ok ? X + (row0 + r) * x_cols : X;
    if (cp.vec)
      cp_async16(dst + r * ldx + 4 * c, src + 4 * c, ok);
    else
      cp_async4(dst + r * ldx + c, src + c, ok);
    r += cp.dr;
    c += cp.dc;
    if (c >= cp.per) {
      c -= cp.per;
      ++r;
    }
  }
}

// acc[2j], acc[2j + 1] += A @ w[k0 : k0 + 16, 16j : 16j + 16] for j < NJ
// (w: bf16 in shared memory, pitch ldw).
template <int NJ>
__device__ __forceinline__ void mma_row(float (*acc)[4],
                                        const uint32_t (&a)[4],
                                        const bf16* w, int ldw, int k0,
                                        int lane) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    uint32_t b[4];
    ldsm_x4_t(b, w + (k0 + (lane & 15)) * ldw + j * 16 + (lane >> 4) * 8);
    mma16816(acc[2 * j], a, b[0], b[1]);
    mma16816(acc[2 * j + 1], a, b[2], b[3]);
  }
}

// relu and bf16 rounding of a layer's accumulators into the next layer's
// A fragments: the 16-column slice k is the tile pair (2k, 2k + 1).
template <int NT>
__device__ __forceinline__ void to_fragments(const float (*acc)[4],
                                             uint32_t (*a)[4]) {
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    const float* lo = acc[2 * k];
    const float* hi = acc[2 * k + 1];
    a[k][0] = pack_bf16(fmaxf(lo[0], 0.0f), fmaxf(lo[1], 0.0f));
    a[k][1] = pack_bf16(fmaxf(lo[2], 0.0f), fmaxf(lo[3], 0.0f));
    a[k][2] = pack_bf16(fmaxf(hi[0], 0.0f), fmaxf(hi[1], 0.0f));
    a[k][3] = pack_bf16(fmaxf(hi[2], 0.0f), fmaxf(hi[3], 0.0f));
  }
}

template <int NT>  // hidden / 16
__global__ void __launch_bounds__(FWD_THREADS, NT <= 8 ? 2 : 1)
    mlp3_fwd_kernel(const float* __restrict__ X, int x_cols, bool x_vec,
                    const bf16* __restrict__ W0,
                    const bf16* __restrict__ W1,
                    const bf16* __restrict__ W2, int d_in, int d_out,
                    float* __restrict__ out, long long n) {
  constexpr int H = NT * 16, S = fwd_stages(H);
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLayout L = fwd_layout(d_in, H, d_out);
  bf16* w0 = (bf16*)(smem + L.w0);
  bf16* w1 = (bf16*)(smem + L.w1);
  bf16* w2 = (bf16*)(smem + L.w2);
  const int ldh = H + 8, ldo = d_out + 8, ldx = L.ldx;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  copy_weight(w0, W0, d_in, H);
  copy_weight(w1, W1, H, H);
  copy_weight(w2, W2, H, d_out);
  cp_async_commit();

  float* xs = (float*)(smem + L.x) + (size_t)warp * S * FWD_ROWS * ldx;
  // X's padding columns [x_cols, d_in) stay zero: no copy writes them.
  const int pad = d_in - x_cols;
  for (int e = lane; e < S * FWD_ROWS * pad; e += 32)
    xs[(e / pad) * ldx + x_cols + e % pad] = 0.0f;
  const XCopy cp = x_copy(x_cols, x_vec, lane);
  const long long tiles = (n + FWD_ROWS - 1) / FWD_ROWS;
  const long long step = (long long)gridDim.x * FWD_WARPS;
  long long tile = (long long)blockIdx.x * FWD_WARPS + warp;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (tile + s * step < tiles)
      stage_tile(xs + s * FWD_ROWS * ldx, ldx, X, x_cols, cp,
                 (tile + s * step) * FWD_ROWS, n);
    cp_async_commit();
  }
  cp_async_wait<S - 1>();  // this thread's weight copies
  __syncthreads();         // everyone's

  for (int slot = 0; tile < tiles; tile += step) {
    cp_async_wait<S - 2>();  // this tile's X
    __syncwarp();            // and every lane's; last tile's reads done
    const int refill = slot == 0 ? S - 1 : slot - 1;
    if (tile + (S - 1) * step < tiles)
      stage_tile(xs + refill * FWD_ROWS * ldx, ldx, X, x_cols, cp,
                 (tile + (S - 1) * step) * FWD_ROWS, n);
    cp_async_commit();
    const float* xt = xs + slot * FWD_ROWS * ldx;
    slot = slot + 1 == S ? 0 : slot + 1;

    uint32_t a[NT][4];
    float acc[2 * NT][4];
    // layer 0: X (rounded to bf16 here) @ W0
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    for (int k = 0; k < d_in; k += 16) {
      const float* p = xt + g * ldx + k + 2 * t;
      const float2 v0 = *reinterpret_cast<const float2*>(p);
      const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * ldx);
      const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
      const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * ldx + 8);
      const uint32_t ax[4] = {pack_bf16(v0.x, v0.y), pack_bf16(v1.x, v1.y),
                              pack_bf16(v2.x, v2.y), pack_bf16(v3.x, v3.y)};
      mma_row<NT>(acc, ax, w0, ldh, k, lane);
    }
    to_fragments<NT>(acc, a);
    // layer 1: relu(h1) @ W1, A from registers
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
    for (int k = 0; k < NT; ++k) mma_row<NT>(acc, a[k], w1, ldh, k * 16, lane);
    to_fragments<NT>(acc, a);
    // layer 2: relu(h2) @ W2, 64 output columns a pass, stored from the
    // accumulators
    const long long row = tile * FWD_ROWS + g;
    for (int o0 = 0; o0 < d_out; o0 += 64) {
      float oc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        oc[j][0] = oc[j][1] = oc[j][2] = oc[j][3] = 0.0f;
      const int nj = min(4, (d_out - o0) >> 4);
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        switch (nj) {
          case 1: mma_row<1>(oc, a[k], w2 + o0, ldo, k * 16, lane); break;
          case 2: mma_row<2>(oc, a[k], w2 + o0, ldo, k * 16, lane); break;
          case 3: mma_row<3>(oc, a[k], w2 + o0, ldo, k * 16, lane); break;
          default: mma_row<4>(oc, a[k], w2 + o0, ldo, k * 16, lane); break;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < 2 * nj) {
          const int col = o0 + j * 8 + 2 * t;
          if (row < n)
            __stcs(reinterpret_cast<float2*>(out + row * d_out + col),
                   make_float2(oc[j][0], oc[j][1]));
          if (row + 8 < n)
            __stcs(reinterpret_cast<float2*>(out + (row + 8) * d_out + col),
                   make_float2(oc[j][2], oc[j][3]));
        }
      }
    }
  }
}

typedef void (*FwdKernel)(const float*, int, bool, const bf16*, const bf16*,
                          const bf16*, int, int, float*, long long);

template <int NT>
static FwdKernel fwd_kernels(int nt) {
  if constexpr (NT > MAX_HIDDEN / 16) {
    return nullptr;
  } else {
    return nt == NT ? mlp3_fwd_kernel<NT> : fwd_kernels<NT + 1>(nt);
  }
}

// K4f's plan for these widths on one device: kernel, shared bytes, blocks
// per SM, SMs; the shared bytes and the card's limit are filled in even
// where the widths do not fit (cudaErrorInvalidValue, also for widths off
// the 16-column tile or a hidden layer wider than MAX_HIDDEN).
struct FwdPlan {
  FwdKernel kernel;
  int per_sm, sms;
  size_t smem, limit;
};

static cudaError_t plan_widths(int d_in, int hidden, int d_out, int dev,
                               FwdPlan* p) {
  *p = FwdPlan{nullptr, 0, 0, 0, 0};
  if (!tile_width(d_in) || !tile_width(hidden) || !tile_width(d_out))
    return cudaErrorInvalidValue;
  p->smem = fwd_layout(d_in, hidden, d_out).bytes;
  int optin = 0;
  cudaError_t err;
  if ((err = cudaDeviceGetAttribute(&p->sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return err;
  p->limit = (size_t)optin;
  if (hidden > MAX_HIDDEN || p->smem > p->limit) return cudaErrorInvalidValue;
  p->kernel = fwd_kernels<1>(hidden / 16);
  if ((err = cudaFuncSetAttribute((const void*)p->kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)p->smem)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &p->per_sm, (const void*)p->kernel, FWD_THREADS, p->smem)) !=
      cudaSuccess)
    return err;
  return p->per_sm < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// The plan for these widths on the current device, made on the first call
// for them and kept, with its refusal: a launch then costs one
// cudaGetDevice and a lookup. Faults of the runtime are not kept.
static cudaError_t fwd_plan(int d_in, int hidden, int d_out, FwdPlan* p) {
  static std::mutex mu;
  static std::map<std::array<int, 4>, std::pair<cudaError_t, FwdPlan>> plans;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::array<int, 4> key = {dev, d_in, hidden, d_out};
  std::lock_guard<std::mutex> lock(mu);
  auto it = plans.find(key);
  if (it == plans.end()) {
    err = plan_widths(d_in, hidden, d_out, dev, p);
    if (err != cudaSuccess && err != cudaErrorInvalidValue) return err;
    it = plans.emplace(key, std::make_pair(err, *p)).first;
  }
  *p = it->second.second;
  return it->second.first;
}

// Persistent blocks for n points: one per FWD_WARPS warp tiles, at most as
// many as stay resident.
static int fwd_blocks(const FwdPlan& p, long long n) {
  const long long tiles = (n + FWD_ROWS - 1) / FWD_ROWS;
  const long long want = (tiles + FWD_WARPS - 1) / FWD_WARPS;
  const long long most = (long long)p.sms * p.per_sm;
  return (int)(want < most ? (want > 0 ? want : 1) : most);
}

extern "C" int mlp3_fwd(const float* X, int x_cols, const void* W0,
                        const void* W1, const void* W2, int d_in, int hidden,
                        int d_out, float* out, long long n, void* stream) {
  if (x_cols < 1 || x_cols > d_in) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)W0 | (uintptr_t)W1 | (uintptr_t)W2) & 15)
    return (int)cudaErrorMisalignedAddress;
  FwdPlan p;
  cudaError_t err = fwd_plan(d_in, hidden, d_out, &p);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const bool x_vec = x_cols % 4 == 0 && ((uintptr_t)X & 15) == 0;
  p.kernel<<<fwd_blocks(p, n), FWD_THREADS, p.smem, (cudaStream_t)stream>>>(
      X, x_cols, x_vec, (const bf16*)W0, (const bf16*)W1, (const bf16*)W2,
      d_in, d_out, out, n);
  return (int)cudaGetLastError();
}

// out[0..8): K4f's launch shape for these widths and n points: blocks,
// threads, dynamic shared bytes, blocks per SM, registers per thread,
// points per warp tile, the card's shared-memory limit per block and the
// widest hidden layer. Where the widths do not fit, the return is
// cudaErrorInvalidValue and out[2], out[6], out[7] say why.
extern "C" int mlp3_fwd_shape(int d_in, int hidden, int d_out, long long n,
                              int* out) {
  FwdPlan p;
  cudaError_t err = fwd_plan(d_in, hidden, d_out, &p);
  cudaFuncAttributes attr;
  attr.numRegs = 0;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, (const void*)p.kernel);
  out[0] = err == cudaSuccess ? fwd_blocks(p, n) : 0;
  out[1] = FWD_THREADS;
  out[2] = (int)p.smem;
  out[3] = p.per_sm;
  out[4] = attr.numRegs;
  out[5] = FWD_ROWS;
  out[6] = (int)p.limit;
  out[7] = MAX_HIDDEN;
  return (int)err;
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
