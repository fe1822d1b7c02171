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
// memory. Each layer's output is produced in 128-column tiles
// (heads_common.cuh `layer`), so every width that is a multiple of 16 is
// covered (the lseg-shaped 512-wide semantic head included); the launch
// takes as many warps per block as the widest layer's tiles leave room
// for. A is streamed through shared memory in 64-column chunks, so the
// wide first layer needs no staging of its 128 KiB weight. Weight
// fragments are read straight from device memory, where the ~250 KiB of
// bf16 weights stay resident in L2; a later version can stage them in
// shared memory per block and feed wgmma.
#include "heads_common.cuh"

#define FWD_WARPS 4  // warps per block where shared memory allows

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

__global__ void __launch_bounds__(FWD_WARPS * 32)
    heads_fwd_kernel(const float* __restrict__ A,
                     const float* __restrict__ B, HeadsWeights w,
                     HeadsDims d, int pq, float* __restrict__ out1,
                     float* __restrict__ outf, float* __restrict__ outl,
                     long long n) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const long long r0 = ((long long)blockIdx.x * warps + warp) * 16;
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
  load_rows(xb, ldb, B + r0 * d.b_cols, d.b_cols, 0, d.Bw, rows, lane);

  // sigma net
  layer(d.H, acc, scratch, lane, [&](int c0, int nc) {
    for (int k0 = 0; k0 < d.Ap; k0 += A_CHUNK) {
      int kw = min(A_CHUNK, d.Ap - k0);
      load_rows(xa, lda, A + r0 * d.a_cols, d.a_cols, k0, kw, rows, lane);
      mma_rows(acc, xa, lda, kw, w.m[WA] + (size_t)k0 * d.H, d.H, c0, nc);
      __syncwarp();
    }
    mma_rows(acc, xb, ldb, d.Bw, w.m[WBs], d.H, c0, nc);
  }, relu_into(p));
  layer(d.H, acc, scratch, lane, [&](int c0, int nc) {
    mma_rows(acc, p, ldp, d.H, w.m[W1s], d.H, c0, nc);
  }, relu_into(q));
  layer(d.Sw, acc, scratch, lane, [&](int c0, int nc) {
    mma_rows(acc, q, ldp, d.H, w.m[W2s], d.Sw, c0, nc);
  }, [&](int r, int c, float v) {
    s[r * lds + c] = __float2bfloat16(v);
    if (c == 0) sig[r] = expf(fminf(v, 15.0f));
  });

  // color net -> out1 = [sigma, rgb, 0...]
  layer(d.Hc, acc, scratch, lane, [&](int c0, int nc) {
    mma_rows(acc, xb, ldb, d.Bw, w.m[WBc], d.Hc, c0, nc);
    mma_rows(acc, s, lds, d.Sw, w.m[WSc], d.Hc, c0, nc);
  }, relu_into(p));
  layer(d.Hc, acc, scratch, lane, [&](int c0, int nc) {
    mma_rows(acc, p, ldp, d.Hc, w.m[W1c], d.Hc, c0, nc);
  }, relu_into(q));
  layer(d.Rw, acc, scratch, lane, [&](int c0, int nc) {
    mma_rows(acc, q, ldp, d.Hc, w.m[W2c], d.Rw, c0, nc);
  }, [&](int r, int c, float v) {
    if (r < rows && c + 1 < d.Rw)
      out1[(r0 + r) * d.Rw + c + 1] = c < 3 ? 1.0f / (1.0f + expf(-v))
                                            : 0.0f;
  });
  if (lane < rows) out1[(r0 + lane) * d.Rw] = sig[lane];

  // semantic features
  layer(d.Hf, acc, scratch, lane, [&](int c0, int nc) {
    mma_rows(acc, s, lds, d.Sw, w.m[WSf], d.Hf, c0, nc);
  }, relu_into(p));
  layer(d.Hf, acc, scratch, lane, [&](int c0, int nc) {
    mma_rows(acc, p, ldp, d.Hf, w.m[W1f], d.Hf, c0, nc);
  }, relu_into(q));
  layer(d.Sp, acc, scratch, lane, [&](int c0, int nc) {
    mma_rows(acc, q, ldp, d.Hf, w.m[W2f], d.Sp, c0, nc);
  }, [&](int r, int c, float v) {
    if (r < rows) outf[(r0 + r) * d.Sp + c] = v;
    fr[r * ldf + c] = __float2bfloat16(fmaxf(v, 0.0f));
  });

  // class logits
  layer(d.Ho, acc, scratch, lane, [&](int c0, int nc) {
    mma_rows(acc, fr, ldf, d.Sp, w.m[WFo], d.Ho, c0, nc);
    mma_rows(acc, s, lds, d.Sw, w.m[WSo], d.Ho, c0, nc);
  }, relu_into(p));
  layer(d.Cp, acc, scratch, lane, [&](int c0, int nc) {
    mma_rows(acc, p, ldp, d.Ho, w.m[W1o], d.Cp, c0, nc);
  }, [&](int r, int c, float v) {
    if (r < rows) outl[(r0 + r) * d.Cp + c] = v;
  });
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

extern "C" int heads_fwd(const float* A, const float* B,
                         const void* const* weights, const int* dims,
                         float* out1, float* outf, float* outl, long long n,
                         void* stream) {
  HeadsDims d = heads_dims(dims);
  if (!heads_dims_ok(d)) return (int)cudaErrorInvalidValue;
  HeadsWeights w;
  for (int i = 0; i < N_WEIGHTS; ++i) w.m[i] = (const bf16*)weights[i];
  const int pq = heads_hidden(d);
  const size_t warp_bytes = heads_warp_bytes(d, pq);
  cudaError_t err;
  const int warps = fit_warps((const void*)heads_fwd_kernel, warp_bytes,
                              FWD_WARPS, &err);
  if (!warps) return (int)err;
  if (n == 0) return 0;
  unsigned int blocks = (unsigned int)((n + warps * 16 - 1) / (warps * 16));
  heads_fwd_kernel<<<blocks, warps * 32, warps * warp_bytes,
                     (cudaStream_t)stream>>>(A, B, w, d, pq, out1, outf,
                                             outl, n);
  return (int)cudaGetLastError();
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
