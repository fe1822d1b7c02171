// Fused field head stack and fused 3-matrix MLP (forward) for Hopper.
//
// heads_fwd replaces the TPU kernel autolabel_tpu/ops/heads_pallas.py
// `_fwd_kernel` (launched by `_fused_heads_fwd_impl`): per point,
//   sigma net  h1 = relu(A.WA + B.WBs), h2 = relu(h1.W1s), S = h2.W2s
//   color net  c1 = relu(B.WBc + S.WSc), c2 = relu(c1.W1c), R = c2.W2c
//   features   f1 = relu(S.WSf), f2 = relu(f1.W1f), F = f2.W2f
//   logits     o1 = relu(relu(F).WFo + S.WSo), L = o1.W1o
// and writes out1 = [exp(min(S0, 15)), sigmoid(R0..2), 0...], F and L.
// mlp3_fwd replaces `_mlp3_fwd_kernel` (`_mlp3_fwd_impl`): the proposal
// density net, out = relu(relu(X.W0).W1).W2.
//
// Numerics: bf16 operands with fp32 accumulation (warp-level bf16 tensor
// core MMAs, nvcuda::wmma 16x16x16), as heads_pallas._dot does on its
// accelerator; ReLU is applied in fp32 before rounding the next layer's
// operand to bf16; S enters the heads unrectified; sigma and rgb are
// computed in fp32 from the fp32 accumulators.
//
// What bounds it on the H100: at the render slice's widths the head stack
// does about 0.2 MFLOP per point against 2 KiB of fp32 A read, about 100
// FLOP per byte, so at bf16 tensor-core rates it is bound by the bytes of
// A; the proposal MLP is byte-bound likewise. Design: one warp owns 16
// points and runs the whole stack on them; every activation stays in that
// warp's shared memory (bf16) between layers and never touches device
// memory. A is streamed through shared memory in 64-column chunks, so the
// wide first layer needs no staging of its 128 KiB weight. Weight
// fragments are read straight from device memory, where the ~250 KiB of
// bf16 weights stay resident in L2; a later version can stage them in
// shared memory per block and feed wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragB;

#define WARPS 4     // warps per block; each warp owns 16 points
#define MAX_FRAGS 8 // layer widths up to 128 columns
#define A_CHUNK 64  // columns of A staged at a time

// Shared-memory bytes of one region, rounded so every region starts on a
// 128-byte boundary (wmma needs 32-byte aligned tile pointers).
__host__ __device__ __forceinline__ size_t round128(size_t b) {
  return (b + 127) & ~(size_t)127;
}

// A warp's 16-row bf16 activation tile of `width` columns, each row padded
// by 8 elements against bank conflicts.
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

// acc[j] += X[16 x K] @ W[K x N] for the j < N/16 column tiles.
// X: bf16 in shared memory, row-major, leading dim ldx.
// W: bf16 in device memory, row-major (in, out), leading dim N.
__device__ __forceinline__ void mma_rows(Acc (&acc)[MAX_FRAGS],
                                         const bf16* x, int ldx, int k_dim,
                                         const bf16* __restrict__ w,
                                         int n_dim) {
  const int nf = n_dim >> 4;
  for (int k = 0; k < k_dim; k += 16) {
    FragA a;
    wmma::load_matrix_sync(a, x + k, ldx);
#pragma unroll
    for (int j = 0; j < MAX_FRAGS; ++j) {
      if (j < nf) {
        FragB b;
        wmma::load_matrix_sync(b, w + (size_t)k * n_dim + j * 16, n_dim);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
}

// Hand every accumulator element (row, col, value) to op, one 16x16 tile
// at a time through the warp's fp32 scratch tile.
template <class Op>
__device__ __forceinline__ void epilogue(Acc (&acc)[MAX_FRAGS], int n_dim,
                                         float* scratch, int lane, Op op) {
  const int nf = n_dim >> 4;
#pragma unroll
  for (int j = 0; j < MAX_FRAGS; ++j) {
    if (j < nf) {
      wmma::store_matrix_sync(scratch, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) op(e >> 4, j * 16 + (e & 15),
                                                scratch[e]);
      __syncwarp();
    }
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

// The 14 packed matrices, in pack_head_weights order.
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

// pq: the widest hidden layer, the width of the two ping-pong tiles.
__host__ __device__ __forceinline__ size_t heads_warp_bytes(
    const HeadsDims& d, int pq) {
  return tile_bytes(A_CHUNK) + tile_bytes(d.Bw) + 2 * tile_bytes(pq) +
         tile_bytes(d.Sw) + tile_bytes(d.Sp) + scratch_bytes() +
         round128(16 * sizeof(float));
}

__host__ __device__ __forceinline__ size_t mlp3_warp_bytes(int d_in,
                                                           int hidden) {
  return tile_bytes(d_in) + 2 * tile_bytes(hidden) + scratch_bytes();
}

__global__ void __launch_bounds__(WARPS * 32)
    heads_fwd_kernel(const float* __restrict__ A,
                     const float* __restrict__ B, HeadsWeights w,
                     HeadsDims d, int pq, float* __restrict__ out1,
                     float* __restrict__ outf, float* __restrict__ outl,
                     long long n) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long r0 = ((long long)blockIdx.x * WARPS + warp) * 16;
  if (r0 >= n) return;  // no block-level synchronisation below
  const int rows = (int)min((long long)16, n - r0);

  unsigned char* base = smem + warp * heads_warp_bytes(d, pq);
  bf16* xa = (bf16*)base;
  base += tile_bytes(A_CHUNK);
  bf16* xb = (bf16*)base;
  base += tile_bytes(d.Bw);
  bf16* p = (bf16*)base;
  base += tile_bytes(pq);
  bf16* q = (bf16*)base;
  base += tile_bytes(pq);
  bf16* s = (bf16*)base;
  base += tile_bytes(d.Sw);
  bf16* fr = (bf16*)base;
  base += tile_bytes(d.Sp);
  float* scratch = (float*)base;
  base += scratch_bytes();
  float* sig = (float*)base;

  const int lda = A_CHUNK + 8, ldb = d.Bw + 8, ldp = pq + 8,
            lds = d.Sw + 8, ldf = d.Sp + 8;
  auto relu_into = [&](bf16* dst) {
    return [=](int r, int c, float v) {
      dst[r * ldp + c] = __float2bfloat16(fmaxf(v, 0.0f));
    };
  };

  Acc acc[MAX_FRAGS];

  // sigma net
  zero_acc(acc);
  for (int k0 = 0; k0 < d.Ap; k0 += A_CHUNK) {
    int kw = min(A_CHUNK, d.Ap - k0);
    load_rows(xa, lda, A + r0 * d.a_cols, d.a_cols, k0, kw, rows, lane);
    mma_rows(acc, xa, lda, kw, w.m[WA] + (size_t)k0 * d.H, d.H);
    __syncwarp();
  }
  load_rows(xb, ldb, B + r0 * d.b_cols, d.b_cols, 0, d.Bw, rows, lane);
  mma_rows(acc, xb, ldb, d.Bw, w.m[WBs], d.H);
  epilogue(acc, d.H, scratch, lane, relu_into(p));
  zero_acc(acc);
  mma_rows(acc, p, ldp, d.H, w.m[W1s], d.H);
  epilogue(acc, d.H, scratch, lane, relu_into(q));
  zero_acc(acc);
  mma_rows(acc, q, ldp, d.H, w.m[W2s], d.Sw);
  epilogue(acc, d.Sw, scratch, lane, [&](int r, int c, float v) {
    s[r * lds + c] = __float2bfloat16(v);
    if (c == 0) sig[r] = expf(fminf(v, 15.0f));
  });

  // color net -> out1 = [sigma, rgb, 0...]
  zero_acc(acc);
  mma_rows(acc, xb, ldb, d.Bw, w.m[WBc], d.Hc);
  mma_rows(acc, s, lds, d.Sw, w.m[WSc], d.Hc);
  epilogue(acc, d.Hc, scratch, lane, relu_into(p));
  zero_acc(acc);
  mma_rows(acc, p, ldp, d.Hc, w.m[W1c], d.Hc);
  epilogue(acc, d.Hc, scratch, lane, relu_into(q));
  zero_acc(acc);
  mma_rows(acc, q, ldp, d.Hc, w.m[W2c], d.Rw);
  epilogue(acc, d.Rw, scratch, lane, [&](int r, int c, float v) {
    if (r < rows && c + 1 < d.Rw)
      out1[(r0 + r) * d.Rw + c + 1] = c < 3 ? 1.0f / (1.0f + expf(-v))
                                            : 0.0f;
  });
  if (lane < rows) out1[(r0 + lane) * d.Rw] = sig[lane];

  // semantic features
  zero_acc(acc);
  mma_rows(acc, s, lds, d.Sw, w.m[WSf], d.Hf);
  epilogue(acc, d.Hf, scratch, lane, relu_into(p));
  zero_acc(acc);
  mma_rows(acc, p, ldp, d.Hf, w.m[W1f], d.Hf);
  epilogue(acc, d.Hf, scratch, lane, relu_into(q));
  zero_acc(acc);
  mma_rows(acc, q, ldp, d.Hf, w.m[W2f], d.Sp);
  epilogue(acc, d.Sp, scratch, lane, [&](int r, int c, float v) {
    if (r < rows) outf[(r0 + r) * d.Sp + c] = v;
    fr[r * ldf + c] = __float2bfloat16(fmaxf(v, 0.0f));
  });

  // class logits
  zero_acc(acc);
  mma_rows(acc, fr, ldf, d.Sp, w.m[WFo], d.Ho);
  mma_rows(acc, s, lds, d.Sw, w.m[WSo], d.Ho);
  epilogue(acc, d.Ho, scratch, lane, relu_into(p));
  zero_acc(acc);
  mma_rows(acc, p, ldp, d.Ho, w.m[W1o], d.Cp);
  epilogue(acc, d.Cp, scratch, lane, [&](int r, int c, float v) {
    if (r < rows) outl[(r0 + r) * d.Cp + c] = v;
  });
}

__global__ void __launch_bounds__(WARPS * 32)
    mlp3_fwd_kernel(const float* __restrict__ X, int x_cols,
                    const bf16* __restrict__ W0,
                    const bf16* __restrict__ W1,
                    const bf16* __restrict__ W2, int d_in, int hidden,
                    int d_out, float* __restrict__ out, long long n) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long r0 = ((long long)blockIdx.x * WARPS + warp) * 16;
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
  zero_acc(acc);
  mma_rows(acc, xa, ldx, d_in, W0, hidden);
  epilogue(acc, hidden, scratch, lane, [&](int r, int c, float v) {
    p[r * ldh + c] = __float2bfloat16(fmaxf(v, 0.0f));
  });
  zero_acc(acc);
  mma_rows(acc, p, ldh, hidden, W1, hidden);
  epilogue(acc, hidden, scratch, lane, [&](int r, int c, float v) {
    q[r * ldh + c] = __float2bfloat16(fmaxf(v, 0.0f));
  });
  zero_acc(acc);
  mma_rows(acc, q, ldh, hidden, W2, d_out);
  epilogue(acc, d_out, scratch, lane, [&](int r, int c, float v) {
    if (r < rows) out[(r0 + r) * d_out + c] = v;
  });
}

static bool tile_width(int v) { return v > 0 && v % 16 == 0; }

// Opt in to more than 48 KB of dynamic shared memory where needed.
static cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

extern "C" int heads_fwd(const float* A, const float* B,
                         const void* const* weights, const int* dims,
                         float* out1, float* outf, float* outl, long long n,
                         void* stream) {
  HeadsDims d = {dims[0], dims[1], dims[2], dims[3], dims[4],  dims[5],
                 dims[6], dims[7], dims[8], dims[9], dims[10], dims[11]};
  const int widths[] = {d.H, d.Sw, d.Hc, d.Rw, d.Hf, d.Sp, d.Ho, d.Cp};
  for (int v : widths)
    if (!tile_width(v) || v > MAX_FRAGS * 16) return (int)cudaErrorInvalidValue;
  if (!tile_width(d.Ap) || !tile_width(d.Bw) || d.a_cols > d.Ap ||
      d.b_cols > d.Bw || d.Rw < 4)
    return (int)cudaErrorInvalidValue;
  HeadsWeights w;
  for (int i = 0; i < N_WEIGHTS; ++i) w.m[i] = (const bf16*)weights[i];
  int pq = d.H;
  if (d.Hc > pq) pq = d.Hc;
  if (d.Hf > pq) pq = d.Hf;
  if (d.Ho > pq) pq = d.Ho;
  size_t smem = WARPS * heads_warp_bytes(d, pq);
  cudaError_t err = allow_smem((const void*)heads_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  unsigned int blocks = (unsigned int)((n + WARPS * 16 - 1) / (WARPS * 16));
  heads_fwd_kernel<<<blocks, WARPS * 32, smem, (cudaStream_t)stream>>>(
      A, B, w, d, pq, out1, outf, outl, n);
  return (int)cudaGetLastError();
}

extern "C" int mlp3_fwd(const float* X, int x_cols, const void* W0,
                        const void* W1, const void* W2, int d_in, int hidden,
                        int d_out, float* out, long long n, void* stream) {
  if (!tile_width(d_in) || !tile_width(hidden) || !tile_width(d_out) ||
      hidden > MAX_FRAGS * 16 || d_out > MAX_FRAGS * 16 || x_cols > d_in)
    return (int)cudaErrorInvalidValue;
  size_t smem = WARPS * mlp3_warp_bytes(d_in, hidden);
  cudaError_t err = allow_smem((const void*)mlp3_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  unsigned int blocks = (unsigned int)((n + WARPS * 16 - 1) / (WARPS * 16));
  mlp3_fwd_kernel<<<blocks, WARPS * 32, smem, (cudaStream_t)stream>>>(
      X, x_cols, (const bf16*)W0, (const bf16*)W1, (const bf16*)W2, d_in,
      hidden, d_out, out, n);
  return (int)cudaGetLastError();
}
