// Fused field head stack and fused 3-matrix MLP (backward) for Hopper.
//
// heads_bwd replaces the TPU kernel autolabel_tpu/ops/heads_pallas.py
// `_bwd_kernel` (launched by `_fused_heads_vjp_bwd`): per point it
// recomputes the forward of heads_fwd.cu, then runs the backward chain of
// `_bwd_kernel` (the trunc_exp VJP g * exp(clip(S0, -15, 15)), the sigmoid
// VJP on rgb, ReLU masks from the recomputed activations) and writes dA
// and dB per point; the 14 weight gradients are summed over all points.
// mlp3_bwd replaces `_mlp3_bwd_kernel` (`_mlp3_vjp_bwd`): dX and the three
// weight gradients of relu(relu(X.W0).W1).W2.
//
// Numerics, as the TPU kernel: bf16 operands (activations, cotangents and
// weights) with fp32 accumulation, masks taken from the recomputed
// activations, fp32 weight gradients.
//
// What bounds it on the H100: bytes at the training slice's widths (A is
// read once, 2 KiB per point, and dA written once, another 2 KiB, against
// about 0.7 MFLOP of bf16 products per point). The trap is the weight
// gradients: about 128 k fp32 values (WA alone is 512 x 128), which a
// per-warp atomic flush would add 128 k atomics per 16 points. Design:
// persistent blocks walk the points in steps of (warps x 16); each warp
// recomputes and back-propagates its own 16 points with every activation
// and cotangent kept in its shared memory (bf16 tiles, 9 hidden-width
// slots reused as lifetimes end); then, at four block-wide phases per
// step, the block's warps share the weight-gradient tiles among them and
// add the step's whole block of points (K = warps x 16) into a per-block
// fp32 partial in device memory with MMAs. Each block's partial is thus
// read and written once per step rather than per warp. A second kernel
// sums the per-block partials in a fixed order. So dW is deterministic for
// a given launch shape; dA and dB are per point.
#include "heads_common.cuh"

#define BWD_HIDDEN_SLOTS 9  // hidden-width activation / cotangent tiles

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

// Per-warp shared-memory layout of heads_bwd_kernel (byte offsets).
struct BwdLayout {
  size_t xa, xb, s, ds, fr, dr, gl, slot0, scratch, dsig, warp_bytes;
  int pq;
};

__host__ __device__ __forceinline__ BwdLayout bwd_layout(const HeadsDims& d) {
  BwdLayout L;
  L.pq = heads_hidden(d);
  size_t o = 0;
  L.xa = o; o += tile_bytes(A_CHUNK);
  L.xb = o; o += tile_bytes(d.Bw);
  L.s = o; o += tile_bytes(d.Sw);
  L.ds = o; o += tile_bytes(d.Sw);
  L.fr = o; o += tile_bytes(d.Sp);
  L.dr = o; o += tile_bytes(d.Rw);
  L.gl = o; o += tile_bytes(d.Cp);
  L.slot0 = o; o += BWD_HIDDEN_SLOTS * tile_bytes(L.pq);
  L.scratch = o; o += scratch_bytes();
  L.dsig = o; o += round128(16 * sizeof(float));
  L.warp_bytes = o;
  return L;
}

// Offsets (in floats) of the 14 weight gradients in one block's partial.
struct DwOffsets {
  size_t o[N_WEIGHTS + 1];  // o[N_WEIGHTS] = total
};

__host__ __device__ __forceinline__ DwOffsets dw_offsets(const HeadsDims& d) {
  const int shape[N_WEIGHTS][2] = {
      {d.Ap, d.H},  {d.Bw, d.H},  {d.H, d.H},   {d.H, d.Sw},  {d.Bw, d.Hc},
      {d.Sw, d.Hc}, {d.Hc, d.Hc}, {d.Hc, d.Rw}, {d.Sw, d.Hf}, {d.Hf, d.Hf},
      {d.Hf, d.Sp}, {d.Sp, d.Ho}, {d.Sw, d.Ho}, {d.Ho, d.Cp}};
  DwOffsets r;
  size_t o = 0;
  for (int i = 0; i < N_WEIGHTS; ++i) {
    r.o[i] = o;
    o += (size_t)shape[i][0] * shape[i][1];
  }
  r.o[N_WEIGHTS] = o;
  return r;
}

__global__ void __launch_bounds__(MAX_WARPS * 32)
    heads_bwd_kernel(const float* __restrict__ A,
                     const float* __restrict__ B, HeadsWeights w,
                     HeadsDims d, const float* __restrict__ g1,
                     const float* __restrict__ gf,
                     const float* __restrict__ gl, float* __restrict__ dA,
                     float* __restrict__ dB, float* __restrict__ part,
                     long long n) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const BwdLayout L = bwd_layout(d);
  const DwOffsets off = dw_offsets(d);
  float* dw = part + (size_t)blockIdx.x * off.o[N_WEIGHTS];
  unsigned char* mine = smem + warp * L.warp_bytes;
  bf16* xa = (bf16*)(mine + L.xa);
  bf16* xb = (bf16*)(mine + L.xb);
  bf16* s = (bf16*)(mine + L.s);
  bf16* ds = (bf16*)(mine + L.ds);
  bf16* fr = (bf16*)(mine + L.fr);
  bf16* dr = (bf16*)(mine + L.dr);
  bf16* glb = (bf16*)(mine + L.gl);
  float* scratch = (float*)(mine + L.scratch);
  float* dsig = (float*)(mine + L.dsig);
  const size_t slot_bytes = tile_bytes(L.pq);
  auto slot_off = [&](int i) { return L.slot0 + i * slot_bytes; };
  auto slot = [&](int i) { return (bf16*)(mine + slot_off(i)); };
  // Slot use, reused as lifetimes end (phases P1..P4 below):
  bf16 *h1s = slot(0), *h2s = slot(1), *c1 = slot(2), *c2 = slot(3),
       *f1 = slot(4), *f2 = slot(5), *o1 = slot(6), *do1 = slot(7),
       *df2 = slot(6), *df1 = slot(8), *dc2 = slot(4), *dc1 = slot(5),
       *dh2s = slot(2), *dh1s = slot(3);
  const int lda = A_CHUNK + 8, ldb = d.Bw + 8, ldp = L.pq + 8,
            lds = d.Sw + 8, ldf = d.Sp + 8, ldr = d.Rw + 8,
            ldl = d.Cp + 8;
  auto term = [&](int m, int in, int out, size_t x_off, int ldx,
                  size_t y_off, int ldy) {
    DwTerm t = {dw + off.o[m], in, out, x_off, y_off, ldx, ldy};
    dw_term(t, smem, L.warp_bytes, nwarps, warp);
  };
  // act(dst) stores relu(v); grad(dst, mask) stores v where mask > 0.
  auto act = [&](bf16* dst) {
    return [=](int r, int c, float v) {
      dst[r * ldp + c] = __float2bfloat16(fmaxf(v, 0.0f));
    };
  };
  auto grad = [&](bf16* dst, const bf16* mask) {
    return [=](int r, int c, float v) {
      bool on = __bfloat162float(mask[r * ldp + c]) > 0.0f;
      dst[r * ldp + c] = __float2bfloat16(on ? v : 0.0f);
    };
  };
  Acc acc[MAX_FRAGS];

  const long long step = (long long)nwarps * 16;
  for (long long base = (long long)blockIdx.x * step; base < n;
       base += (long long)gridDim.x * step) {
    const long long r0 = base + warp * 16;
    const int rows = (int)max(0LL, min(16LL, n - r0));
    const float* Ar = A + (r0 < n ? r0 : 0) * d.a_cols;

    // ---- recompute the forward (heads_fwd.cu) into the warp's tiles
    load_rows(xb, ldb, B + (r0 < n ? r0 : 0) * d.b_cols, d.b_cols, 0, d.Bw,
              rows, lane);
    layer(d.H, acc, scratch, lane, [&](int c0, int nc) {
      for (int k0 = 0; k0 < d.Ap; k0 += A_CHUNK) {
        int kw = min(A_CHUNK, d.Ap - k0);
        load_rows(xa, lda, Ar, d.a_cols, k0, kw, rows, lane);
        mma_rows(acc, xa, lda, kw, w.m[WA] + (size_t)k0 * d.H, d.H, c0, nc);
        __syncwarp();
      }
      mma_rows(acc, xb, ldb, d.Bw, w.m[WBs], d.H, c0, nc);
    }, act(h1s));
    layer(d.H, acc, scratch, lane, [&](int c0, int nc) {
      mma_rows(acc, h1s, ldp, d.H, w.m[W1s], d.H, c0, nc);
    }, act(h2s));
    layer(d.Sw, acc, scratch, lane, [&](int c0, int nc) {
      mma_rows(acc, h2s, ldp, d.H, w.m[W2s], d.Sw, c0, nc);
    }, [&](int r, int c, float v) {
      s[r * lds + c] = __float2bfloat16(v);
      if (c == 0)  // trunc_exp VJP
        dsig[r] = r < rows ? g1[(r0 + r) * d.Rw] *
                                 expf(fminf(fmaxf(v, -15.0f), 15.0f))
                           : 0.0f;
    });
    layer(d.Hc, acc, scratch, lane, [&](int c0, int nc) {
      mma_rows(acc, xb, ldb, d.Bw, w.m[WBc], d.Hc, c0, nc);
      mma_rows(acc, s, lds, d.Sw, w.m[WSc], d.Hc, c0, nc);
    }, act(c1));
    layer(d.Hc, acc, scratch, lane, [&](int c0, int nc) {
      mma_rows(acc, c1, ldp, d.Hc, w.m[W1c], d.Hc, c0, nc);
    }, act(c2));
    layer(d.Rw, acc, scratch, lane, [&](int c0, int nc) {
      mma_rows(acc, c2, ldp, d.Hc, w.m[W2c], d.Rw, c0, nc);
    }, [&](int r, int c, float v) {  // sigmoid VJP on rgb
      float dv = 0.0f;
      if (r < rows && c < 3) {
        float rgb = 1.0f / (1.0f + expf(-v));
        dv = g1[(r0 + r) * d.Rw + 1 + c] * rgb * (1.0f - rgb);
      }
      dr[r * ldr + c] = __float2bfloat16(dv);
    });
    layer(d.Hf, acc, scratch, lane, [&](int c0, int nc) {
      mma_rows(acc, s, lds, d.Sw, w.m[WSf], d.Hf, c0, nc);
    }, act(f1));
    layer(d.Hf, acc, scratch, lane, [&](int c0, int nc) {
      mma_rows(acc, f1, ldp, d.Hf, w.m[W1f], d.Hf, c0, nc);
    }, act(f2));
    layer(d.Sp, acc, scratch, lane, [&](int c0, int nc) {
      mma_rows(acc, f2, ldp, d.Hf, w.m[W2f], d.Sp, c0, nc);
    }, [&](int r, int c, float v) {
      fr[r * ldf + c] = __float2bfloat16(fmaxf(v, 0.0f));
    });
    layer(d.Ho, acc, scratch, lane, [&](int c0, int nc) {
      mma_rows(acc, fr, ldf, d.Sp, w.m[WFo], d.Ho, c0, nc);
      mma_rows(acc, s, lds, d.Sw, w.m[WSo], d.Ho, c0, nc);
    }, act(o1));

    // ---- logits head
    load_rows(glb, ldl, gl + (r0 < n ? r0 : 0) * d.Cp, d.Cp, 0, d.Cp, rows,
              lane);
    layer(d.Ho, acc, scratch, lane, [&](int c0, int nc) {
      mma_rows_t(acc, glb, ldl, d.Cp, w.m[W1o], d.Cp, c0, nc);
    }, grad(do1, o1));
    __syncthreads();  // P1
    term(W1o, d.Ho, d.Cp, slot_off(6), ldp, L.gl, ldl);
    term(WFo, d.Sp, d.Ho, L.fr, ldf, slot_off(7), ldp);
    term(WSo, d.Sw, d.Ho, L.s, lds, slot_off(7), ldp);
    __syncthreads();

    // ---- feature head (+ the relu(F) branch into the logits head)
    layer(d.Sp, acc, scratch, lane, [&](int c0, int nc) {
      mma_rows_t(acc, do1, ldp, d.Ho, w.m[WFo], d.Ho, c0, nc);
    }, [&](int r, int c, float v) {  // dF, in place of relu(F)
      bool on = __bfloat162float(fr[r * ldf + c]) > 0.0f;
      float g = r < rows ? gf[(r0 + r) * d.Sp + c] : 0.0f;
      fr[r * ldf + c] = __float2bfloat16(g + (on ? v : 0.0f));
    });
    layer(d.Hf, acc, scratch, lane, [&](int c0, int nc) {
      mma_rows_t(acc, fr, ldf, d.Sp, w.m[W2f], d.Sp, c0, nc);
    }, grad(df2, f2));
    layer(d.Hf, acc, scratch, lane, [&](int c0, int nc) {
      mma_rows_t(acc, df2, ldp, d.Hf, w.m[W1f], d.Hf, c0, nc);
    }, grad(df1, f1));
    __syncthreads();  // P2
    term(W2f, d.Hf, d.Sp, slot_off(5), ldp, L.fr, ldf);
    term(W1f, d.Hf, d.Hf, slot_off(4), ldp, slot_off(6), ldp);
    term(WSf, d.Sw, d.Hf, L.s, lds, slot_off(8), ldp);
    __syncthreads();

    // ---- color head
    layer(d.Hc, acc, scratch, lane, [&](int c0, int nc) {
      mma_rows_t(acc, dr, ldr, d.Rw, w.m[W2c], d.Rw, c0, nc);
    }, grad(dc2, c2));
    layer(d.Hc, acc, scratch, lane, [&](int c0, int nc) {
      mma_rows_t(acc, dc2, ldp, d.Hc, w.m[W1c], d.Hc, c0, nc);
    }, grad(dc1, c1));
    __syncthreads();  // P3
    term(W2c, d.Hc, d.Rw, slot_off(3), ldp, L.dr, ldr);
    term(W1c, d.Hc, d.Hc, slot_off(2), ldp, slot_off(4), ldp);
    term(WBc, d.Bw, d.Hc, L.xb, ldb, slot_off(5), ldp);
    term(WSc, d.Sw, d.Hc, L.s, lds, slot_off(5), ldp);
    __syncthreads();

    // ---- every path into dS, then the sigma trunk
    layer(d.Sw, acc, scratch, lane, [&](int c0, int nc) {
      mma_rows_t(acc, dc1, ldp, d.Hc, w.m[WSc], d.Hc, c0, nc);
      mma_rows_t(acc, df1, ldp, d.Hf, w.m[WSf], d.Hf, c0, nc);
      mma_rows_t(acc, do1, ldp, d.Ho, w.m[WSo], d.Ho, c0, nc);
    }, [&](int r, int c, float v) {
      ds[r * lds + c] = __float2bfloat16(c == 0 ? v + dsig[r] : v);
    });
    layer(d.H, acc, scratch, lane, [&](int c0, int nc) {
      mma_rows_t(acc, ds, lds, d.Sw, w.m[W2s], d.Sw, c0, nc);
    }, grad(dh2s, h2s));
    layer(d.H, acc, scratch, lane, [&](int c0, int nc) {
      mma_rows_t(acc, dh2s, ldp, d.H, w.m[W1s], d.H, c0, nc);
    }, grad(dh1s, h1s));
    layer(d.Ap, acc, scratch, lane, [&](int c0, int nc) {
      mma_rows_t(acc, dh1s, ldp, d.H, w.m[WA], d.H, c0, nc);
    }, [&](int r, int c, float v) {
      if (r < rows && c < d.a_cols) dA[(r0 + r) * d.a_cols + c] = v;
    });
    if (dB != nullptr) {
      layer(d.Bw, acc, scratch, lane, [&](int c0, int nc) {
        mma_rows_t(acc, dh1s, ldp, d.H, w.m[WBs], d.H, c0, nc);
        mma_rows_t(acc, dc1, ldp, d.Hc, w.m[WBc], d.Hc, c0, nc);
      }, [&](int r, int c, float v) {
        if (r < rows && c < d.b_cols) dB[(r0 + r) * d.b_cols + c] = v;
      });
    }
    __syncthreads();  // P4
    term(W2s, d.H, d.Sw, slot_off(1), ldp, L.ds, lds);
    term(W1s, d.H, d.H, slot_off(0), ldp, slot_off(2), ldp);
    term(WBs, d.Bw, d.H, L.xb, ldb, slot_off(3), ldp);
    // dWA, A staged again in 64-column chunks.
    for (int k0 = 0; k0 < d.Ap; k0 += A_CHUNK) {
      int kw = min(A_CHUNK, d.Ap - k0);
      __syncthreads();
      load_rows(xa, lda, Ar, d.a_cols, k0, kw, rows, lane);
      __syncthreads();
      DwTerm t = {dw + off.o[WA] + (size_t)k0 * d.H, kw, d.H, L.xa,
                  slot_off(3), lda, ldp};
      dw_term(t, smem, L.warp_bytes, nwarps, warp);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- mlp3

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

// out[i] = sum over blocks b of part[b * total + i], in block order.
__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    int blocks, long long total,
                                    float* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int b = 0; b < blocks; ++b) s += part[(size_t)b * total + i];
    out[i] = s;
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

static cudaError_t sum_partials(const float* part, int blocks,
                                long long total, float* out,
                                cudaStream_t s) {
  const int threads = 256;
  long long grid = (total + threads - 1) / threads;
  if (grid > 4096) grid = 4096;
  sum_partials_kernel<<<(unsigned int)grid, threads, 0, s>>>(part, blocks,
                                                              total, out);
  return cudaGetLastError();
}

// The scratch the wrapper allocates for heads_bwd: blocks x (sum of the 14
// packed weight sizes) floats; *total_out is that sum. Returns a CUDA
// error code.
extern "C" int heads_bwd_workspace(const int* dims, long long n,
                                   int* blocks_out, long long* total_out) {
  HeadsDims d = heads_dims(dims);
  if (!heads_dims_ok(d)) return (int)cudaErrorInvalidValue;
  int warps = 0;
  cudaError_t err = persistent_shape((const void*)heads_bwd_kernel,
                                     bwd_layout(d).warp_bytes, n, &warps,
                                     blocks_out);
  *total_out = (long long)dw_offsets(d).o[N_WEIGHTS];
  return (int)err;
}

// dW (the 14 gradients, packed back to back in pack order, fp32) must have
// room for the total of heads_bwd_workspace; part for blocks x total. dB
// may be null (no gradient for B is wanted).
extern "C" int heads_bwd(const float* A, const float* B,
                         const void* const* weights, const int* dims,
                         const float* g1, const float* gf, const float* gl,
                         float* dA, float* dB, float* dW, float* part,
                         int blocks, long long n, void* stream) {
  HeadsDims d = heads_dims(dims);
  if (!heads_dims_ok(d)) return (int)cudaErrorInvalidValue;
  HeadsWeights w;
  for (int i = 0; i < N_WEIGHTS; ++i) w.m[i] = (const bf16*)weights[i];
  const size_t warp_bytes = bwd_layout(d).warp_bytes;
  const long long total = (long long)dw_offsets(d).o[N_WEIGHTS];
  int warps = 0, max_blocks = 0;
  cudaError_t err = persistent_shape((const void*)heads_bwd_kernel,
                                     warp_bytes, n, &warps, &max_blocks);
  if (err != cudaSuccess) return (int)err;
  if (blocks < 1 || blocks > max_blocks) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if ((err = cudaMemsetAsync(part, 0, (size_t)blocks * total * sizeof(float),
                             s)) != cudaSuccess)
    return (int)err;
  if (n > 0) {
    heads_bwd_kernel<<<blocks, warps * 32, warps * warp_bytes, s>>>(
        A, B, w, d, g1, gf, gl, dA, dB, part, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)sum_partials(part, blocks, total, dW, s);
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
