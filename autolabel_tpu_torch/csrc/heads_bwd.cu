// Fused field head stack (backward), K3b, for Hopper.
//
// Replaces the TPU kernel autolabel_tpu/ops/heads_pallas.py `_bwd_kernel`
// (launched by `_fused_heads_vjp_bwd`): per point it recomputes the
// forward of heads_fwd.cu, runs the backward chain of `_bwd_kernel` (the
// trunc_exp VJP g * exp(clip(S0, -15, 15)), the sigmoid VJP on rgb, ReLU
// masks from the recomputed activations) and writes dA and dB; the 14
// weight gradients are summed over all points. Numerics as the TPU
// kernel: bf16 operands (activations, cotangents, weights) with fp32
// accumulation, fp32 weight gradients.
//
// What bounds it on the H100: bytes. At the training step's 131,072
// points it reads A (256 MiB fp32) and writes dA (256 MiB), plus B's 28
// real columns, the cotangents of the 74 real outputs and the fp32 weight
// gradients: 0.176 ms at 3.35 TB/s, against about 0.7 MFLOP of bf16
// products per point (0.09 ms at 989 TFLOP/s). The earlier design took 10.47
// ms on an NVIDIA H100 80GB HBM3 at 700.00 W; clock64 stamps per phase
// put 41% of it in the recompute, 33% in the backward chain (dA alone
// 16%), 10% in the small weight gradients and 16% in dWA: weight
// fragments read from L2 for every 16 points by one 4-warp block per SM.
//
// Design: four kernels in order, each a hand-written tensor-core kernel.
// 1. heads_bwd_kernel, the heads_tile.cuh machinery of heads_fwd.cu with
//    tiles of 64 points: the recompute, the backward chain down to dh1s,
//    and dB. The heads are back-propagated one at a time right after
//    their forward (color, then features and logits), so a cotangent
//    overwrites its own activation in place and five hidden-width tiles
//    suffice; dS and the color head's share of dB gather in fp32 tiles.
//    It takes no weight gradient: five times a tile, once every warp has
//    written them, it copies the gradients' operand tiles (X and dY of
//    X^T @ dY, 21 tiles, 1,720 bf16 columns per point at the flagship
//    widths) to a workspace, 16 bytes a thread; the DH1 epilogue writes
//    dh1s there too. Adding each tile's small gradients into a per-block
//    fp32 partial instead (250 KB of read-modify-write per 64 points)
//    took a third of K3b's time (PERF.md).
// 2. da_kernel: dA = dh1s @ WA^T, 128 points x 128 columns a block. In
//    the fused kernel its eight steps a tile took 0.38 ms (NVIDIA H100
//    80GB HBM3, 700.00 W; PERF.md), nearly five times what its 256 MiB of
//    writes take at 3.35 TB/s.
// 3. dw_kernel, twice: every weight gradient as a split-K product X^T @
//    dY over the points, X from A (dWA, rounded to bf16 in shared memory)
//    or from the workspace; each split stores its partial.
// 4. sum_partials_kernel: the splits added in order, so dW is the same
//    for a launch shape every run, with no atomics.
// The price of leaving the partials: A is read twice, and the workspace
// (1,720 bf16 values, 3,440 B a point: 451 MB at 131,072 points, growing
// with N and not capped) is written and read once, about 13 KB of traffic
// a point against the bound's 4 KB.
//
// Shared memory at the flagship widths, for 64 points: weight stages 3 x
// 18,432 B, A stages 2 x 18,432, five hidden tiles 4 x 17,408 + 9,216, xb
// 5,120, S, dS, dR and the logits' cotangent 4 x 3,072, relu(F) / dF
// 9,216, the fp32 dS and dB tiles 4,096 + 8,192, the schedule 512 (35
// steps) and the weight table 128: 210,560 B, one block of 8 warps per
// SM. da_kernel: 2 x (18,432 + 18,432) = 73,728 B, two blocks per SM.
// dw_kernel: for dWA 2 x (18,432 fp32 A + 17,408 dY) + 9,216 bf16 A =
// 80,896 B, two blocks per SM; for the others 2 x (9,216 + 17,408) =
// 53,248 B, four blocks per SM.
#include "heads_tile.cuh"
#include "partials.cuh"

#define BWD_SLOT (128 * (64 + 8))  // bf16 elements of a weight stage

// The layers of the recompute and the backward chain, in the order they
// run: the sigma trunk, the color head and its cotangents (with their
// share of dS and dB), the feature and logits heads and their cotangents,
// dS, then the trunk's cotangents down to dh1s, and dB (dA = dh1s @ WA^T
// is da_kernel's).
enum {
  B_H1, B_H2, B_S, B_C1, B_C2, B_R, B_DC2, B_DC1, B_DSC, B_DBC,
  B_F1, B_F2, B_F, B_O1, B_DO1, B_DSO, B_DF, B_DF2, B_DF1, B_DS,
  B_DH2, B_DH1, B_DB
};

// The order in which those layers take their weight chunks (the two dB
// layers' only where wanted).
__host__ __device__ inline int heads_bwd_schedule(const HeadsDims& d,
                                                  bool need_dB, Step* out) {
  Sched s = {out, 0, BWD_SLOT, d};
  sched_layer(s, B_H1, WBs, WA, false, true);
  sched_layer(s, B_H2, W1s, -1, false, false);
  sched_layer(s, B_S, W2s, -1, false, false);
  sched_layer(s, B_C1, WBc, WSc, false, false);
  sched_layer(s, B_C2, W1c, -1, false, false);
  sched_layer(s, B_R, W2c, -1, false, false);
  sched_layer(s, B_DC2, W2c, -1, true, false);
  sched_layer(s, B_DC1, W1c, -1, true, false);
  sched_layer(s, B_DSC, WSc, -1, true, false);
  if (need_dB) sched_layer(s, B_DBC, WBc, -1, true, false);
  sched_layer(s, B_F1, WSf, -1, false, false);
  sched_layer(s, B_F2, W1f, -1, false, false);
  sched_layer(s, B_F, W2f, -1, false, false);
  sched_layer(s, B_O1, WFo, WSo, false, false);
  sched_layer(s, B_DO1, W1o, -1, true, false);
  sched_layer(s, B_DSO, WSo, -1, true, false);
  sched_layer(s, B_DF, WFo, -1, true, false);
  sched_layer(s, B_DF2, W2f, -1, true, false);
  sched_layer(s, B_DF1, W1f, -1, true, false);
  sched_layer(s, B_DS, WSf, -1, true, false);
  sched_layer(s, B_DH2, W2s, -1, true, false);
  sched_layer(s, B_DH1, W1s, -1, true, false);
  if (need_dB) sched_layer(s, B_DB, WBs, -1, true, false);
  return s.n;
}

#define N_HIDDEN 5

// The tiles the fused kernel hands to dw_kernel, the operands of the 14
// weight gradients: per point, bf16, each a region of n rows x its width
// in the workspace. X^T @ dY of a weight takes its X and dY from here (or
// X from A, for dWA).
enum {
  D_XB, D_S, D_H1, D_DH1, D_H2, D_DH2, D_DS, D_C1, D_DC1, D_C2, D_DC2,
  D_DR, D_F1, D_DF1, D_F2, D_DF2, D_RF, D_DF, D_O1, D_DO1, D_GL, N_DUMP
};

__host__ __device__ inline int dump_width(const HeadsDims& d, int k) {
  const int w[N_DUMP] = {d.Bw, d.Sw, d.H,  d.H,  d.H,  d.H,  d.Sw,
                         d.Hc, d.Hc, d.Hc, d.Hc, d.Rw, d.Hf, d.Hf,
                         d.Hf, d.Hf, d.Sp, d.Sp, d.Ho, d.Ho, d.Cp};
  return w[k];
}

// X's and dY's regions of each weight's gradient (X of WA: A itself).
static const int DW_X[N_WEIGHTS] = {-1,   D_XB, D_H1, D_H2, D_XB, D_S, D_C1,
                                    D_C2, D_S,  D_F1, D_F2, D_RF, D_S, D_O1};
static const int DW_Y[N_WEIGHTS] = {D_DH1, D_DH1, D_DH2, D_DS,  D_DC1,
                                    D_DC1, D_DC2, D_DR,  D_DF1, D_DF2,
                                    D_DF,  D_DO1, D_DO1, D_GL};

// Byte offsets of the block's shared-memory regions, and the element
// offsets of the workspace's regions.
struct BwdLayout {
  size_t sched, wtab, w, w_bytes, x, x_bytes, xb, s, ds, dr, gl, fr,
      h[N_HIDDEN], ds32, db32, bytes;
  long long reg[N_DUMP], ws_elems;
  int m, nsteps;
  bool g_staged;  // the cotangents fit the A stages once the trunk is in
};

// Tiles of m points; h[0..1] hold the sigma trunk (H wide), h[2..3] the
// color, then the feature head (Hc or Hf wide), h[4] the logits head.
static BwdLayout bwd_layout(const HeadsDims& d, int m, bool need_dB,
                            long long n) {
  BwdLayout L;
  L.m = m;
  L.nsteps = heads_bwd_schedule(d, need_dB, nullptr);
  L.w_bytes = round128((size_t)BWD_SLOT * sizeof(bf16));
  L.x_bytes = round128((size_t)m * X_LD * sizeof(float));
  size_t o = 0;
  L.w = o; o += W_STAGES * L.w_bytes;
  L.x = o; o += 2 * L.x_bytes;
  L.g_staged = (size_t)m * (d.Rw + d.Sp + d.Cp) * sizeof(float) <=
               2 * L.x_bytes;
  const int widths[N_HIDDEN] = {d.H, d.H, d.Hc > d.Hf ? d.Hc : d.Hf,
                                d.Hc > d.Hf ? d.Hc : d.Hf, d.Ho};
  for (int i = 0; i < N_HIDDEN; ++i) {
    L.h[i] = o;
    o += tile_bytes(m, widths[i]);
  }
  L.xb = o; o += tile_bytes(m, d.Bw);
  L.s = o; o += tile_bytes(m, d.Sw);
  L.ds = o; o += tile_bytes(m, d.Sw);
  L.dr = o; o += tile_bytes(m, d.Rw);
  L.gl = o; o += tile_bytes(m, d.Cp);
  L.fr = o; o += tile_bytes(m, d.Sp);
  L.ds32 = o; o += round128((size_t)m * d.Sw * sizeof(float));
  L.db32 = o; o += round128((size_t)m * d.Bw * sizeof(float));
  L.sched = o; o += round128((size_t)L.nsteps * sizeof(Step));
  L.wtab = o; o += round128(N_WEIGHTS * sizeof(bf16*));
  L.bytes = o;
  L.ws_elems = 0;
  for (int k = 0; k < N_DUMP; ++k) {
    L.reg[k] = L.ws_elems;
    L.ws_elems += n * dump_width(d, k);
  }
  return L;
}

// Copy a tile (bf16, pitch ld) of the block's points to its workspace
// region, 16 bytes a thread at a time; rows past n are left out.
__device__ __forceinline__ void dump(bf16* ws, const BwdLayout& L,
                                     const HeadsDims& d, int k,
                                     const bf16* tile, int ld,
                                     long long row0, long long n) {
  const int w = dump_width(d, k);
  bf16* dst = ws + L.reg[k] + row0 * w;
  block_copy(L.m, w >> 3, [&](int r, int c8) {
    if (row0 + r < n)
      *reinterpret_cast<uint4*>(dst + (size_t)r * w + c8 * 8) =
          *reinterpret_cast<const uint4*>(tile + r * ld + c8 * 8);
  });
}

// dB may be null (not wanted). ws takes dh1s (for da_kernel and
// dw_kernel) and the other weight gradients' operands.
__global__ void __launch_bounds__(HEAD_THREADS)
    heads_bwd_kernel(const float* __restrict__ A,
                     const float* __restrict__ B, HeadsWeights w,
                     HeadsDims d, BwdLayout L, bool a_vec, bool b_vec,
                     const float* __restrict__ g1,
                     const float* __restrict__ gf,
                     const float* __restrict__ gl, float* __restrict__ dB,
                     bf16* __restrict__ ws, long long n) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x == 0)
    heads_bwd_schedule(d, dB != nullptr, (Step*)(smem + L.sched));
  Stream s = stream_start(smem, L.sched, L.wtab, L.w, L.w_bytes, L.x,
                          L.x_bytes, L.nsteps, w, d, A, B, a_vec, b_vec, n,
                          L.m);
  const WarpTile wt = warp_tile(L.m);
  bf16* xb = (bf16*)(smem + L.xb);
  bf16* st = (bf16*)(smem + L.s);
  bf16* dst = (bf16*)(smem + L.ds);
  bf16* dr = (bf16*)(smem + L.dr);
  bf16* glt = (bf16*)(smem + L.gl);
  bf16* fr = (bf16*)(smem + L.fr);
  float* ds32 = (float*)(smem + L.ds32);
  float* db32 = (float*)(smem + L.db32);
  // The cotangents of the tile's outputs: staged (fp32, rows past n
  // zero) in the A stages once the first layer is done with them, or read
  // from device memory.
  float* g1s = (float*)(smem + L.x);
  float* gfs = g1s + L.m * d.Rw;
  float* gls = gfs + L.m * d.Sp;
  const int ldh = d.H + 8, ldc = (d.Hc > d.Hf ? d.Hc : d.Hf) + 8,
            ldo = d.Ho + 8, ldb = d.Bw + 8, lds = d.Sw + 8, ldr = d.Rw + 8,
            ldl = d.Cp + 8, ldf = d.Sp + 8;
  bf16* const h0 = (bf16*)(smem + L.h[0]);
  bf16* const h1 = (bf16*)(smem + L.h[1]);
  bf16* const h2 = (bf16*)(smem + L.h[2]);
  bf16* const h3 = (bf16*)(smem + L.h[3]);
  bf16* const h4 = (bf16*)(smem + L.h[4]);
  // Each layer's input (h0 = h1s, h1 = h2s; h2, h3 = c1, c2, then f1, f2;
  // h4 = o1; each cotangent in place of its activation).
  auto src = [=](const Step& k) {
    switch (k.layer) {
      case B_H2: case B_DB: return Src{h0, ldh};
      case B_S: case B_DH1: return Src{h1, ldh};
      case B_C2: case B_DSC: case B_DBC: case B_F2: case B_DS:
        return Src{h2, ldc};
      case B_R: case B_DC1: case B_F: case B_DF1: return Src{h3, ldc};
      case B_DSO: case B_DF: return Src{h4, ldo};
      case B_DC2: return Src{dr, ldr};
      case B_DO1: return Src{glt, ldl};
      case B_DF2: return Src{fr, ldf};
      case B_DH2: return Src{dst, lds};
      case B_C1: return k.m == WBc ? Src{xb, ldb} : Src{st, lds};
      case B_O1: return k.m == WFo ? Src{fr, ldf} : Src{st, lds};
      default: return Src{st, lds};  // B_F1 (B_H1 comes staged)
    }
  };
  auto relu_to = [=](bf16* dst_, int ld) {
    return [=](int r, int c, float v0, float v1) {
      store_pair(dst_ + r * ld + c, fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
    };
  };
  // The cotangent v where the activation held in place is positive.
  auto grad_to = [=](bf16* act, int ld) {
    return [=](int r, int c, float v0, float v1) {
      const float2 m = load_pair(act + r * ld + c);
      store_pair(act + r * ld + c, m.x > 0.0f ? v0 : 0.0f,
                 m.y > 0.0f ? v1 : 0.0f);
    };
  };
  auto ds_add = [=](int r, int c, float v0, float v1) {
    ds32[r * d.Sw + c] += v0;
    ds32[r * d.Sw + c + 1] += v1;
  };

  Acc acc;
  for (long long tile = blockIdx.x; tile * L.m < n; tile += gridDim.x) {
    const long long row0 = tile * L.m;
    const float* g1t = L.g_staged ? g1s : g1 + row0 * d.Rw;
    const float* gft = L.g_staged ? gfs : gf + row0 * d.Sp;
    const float* glt_src = L.g_staged ? gls : gl + row0 * d.Cp;
    for (int k = 0; k < L.nsteps; ++k) {
      const bf16* wst;
      const float* xst;
      const Step step = stream_next(s, &wst, &xst);
      step_mma(acc, step, src(step), wst, xst, xb, ldb, L.m, wt);
      if (step.flags & STEP_LAST) {
        switch (step.layer) {
          case B_H1: epilogue(acc, step, wt, relu_to(h0, ldh)); break;
          case B_H2: epilogue(acc, step, wt, relu_to(h1, ldh)); break;
          case B_C1: case B_F1: epilogue(acc, step, wt, relu_to(h2, ldc)); break;
          case B_C2: case B_F2: epilogue(acc, step, wt, relu_to(h3, ldc)); break;
          case B_F: epilogue(acc, step, wt, relu_to(fr, ldf)); break;
          case B_O1: epilogue(acc, step, wt, relu_to(h4, ldo)); break;
          case B_DC2: case B_DF2: epilogue(acc, step, wt, grad_to(h3, ldc)); break;
          case B_DC1: case B_DF1: epilogue(acc, step, wt, grad_to(h2, ldc)); break;
          case B_DO1: epilogue(acc, step, wt, grad_to(h4, ldo)); break;
          case B_DH2: epilogue(acc, step, wt, grad_to(h1, ldh)); break;
          case B_DSC: case B_DSO: epilogue(acc, step, wt, ds_add); break;
          case B_S:  // S; dS starts as the trunc_exp VJP in column 0
            epilogue(acc, step, wt, [&](int r, int c, float v0, float v1) {
              store_pair(st + r * lds + c, v0, v1);
              ds32[r * d.Sw + c] =
                  c == 0 && row0 + r < n
                      ? g1t[r * d.Rw] * expf(fminf(fmaxf(v0, -15.0f), 15.0f))
                      : 0.0f;
              ds32[r * d.Sw + c + 1] = 0.0f;
            });
            break;
          case B_R:  // the sigmoid VJP on rgb
            epilogue(acc, step, wt, [&](int r, int c, float v0, float v1) {
              const float v[2] = {v0, v1};
              float dv[2] = {0.0f, 0.0f};
              for (int e = 0; e < 2; ++e) {
                if (c + e < 3 && row0 + r < n) {
                  const float rgb = 1.0f / (1.0f + expf(-v[e]));
                  dv[e] = g1t[r * d.Rw + 1 + c + e] * rgb * (1.0f - rgb);
                }
              }
              store_pair(dr + r * ldr + c, dv[0], dv[1]);
            });
            break;
          case B_DBC:  // the color head's share of dB
            epilogue(acc, step, wt, [&](int r, int c, float v0, float v1) {
              db32[r * d.Bw + c] = v0;
              db32[r * d.Bw + c + 1] = v1;
            });
            break;
          case B_DF:  // dF = gf + the relu(F) branch, over relu(F)
            epilogue(acc, step, wt, [&](int r, int c, float v0, float v1) {
              const float2 m = load_pair(fr + r * ldf + c);
              const float2 g =
                  row0 + r < n
                      ? *reinterpret_cast<const float2*>(gft + r * d.Sp + c)
                      : make_float2(0.0f, 0.0f);
              store_pair(fr + r * ldf + c, g.x + (m.x > 0.0f ? v0 : 0.0f),
                         g.y + (m.y > 0.0f ? v1 : 0.0f));
            });
            break;
          case B_DS:  // dS complete
            epilogue(acc, step, wt, [&](int r, int c, float v0, float v1) {
              store_pair(dst + r * lds + c, ds32[r * d.Sw + c] + v0,
                         ds32[r * d.Sw + c + 1] + v1);
            });
            break;
          case B_DH1:  // dh1s, also to the workspace
            epilogue(acc, step, wt, [&](int r, int c, float v0, float v1) {
              const float2 m = load_pair(h0 + r * ldh + c);
              const float a = m.x > 0.0f ? v0 : 0.0f;
              const float b = m.y > 0.0f ? v1 : 0.0f;
              store_pair(h0 + r * ldh + c, a, b);
              if (row0 + r < n)
                store_pair(ws + L.reg[D_DH1] + (row0 + r) * d.H + c, a, b);
            });
            break;
          default:  // B_DB: both heads' shares of dB
            epilogue(acc, step, wt, [&](int r, int c, float v0, float v1) {
              if (row0 + r >= n) return;
              float* o = dB + (row0 + r) * d.b_cols;
              if (c < d.b_cols) o[c] = v0 + db32[r * d.Bw + c];
              if (c + 1 < d.b_cols) o[c + 1] = v1 + db32[r * d.Bw + c + 1];
            });
        }
      }
      if (!(step.flags & STEP_END)) continue;
      // After a layer, once every warp's rows are written: the cotangents
      // into the A stages; and the weight gradients' operands into the
      // workspace, five times a tile, each tile between the layer that
      // writes it and the one that overwrites it.
      auto put = [&](int k, const bf16* tile, int ld) {
        dump(ws, L, d, k, tile, ld, row0, n);
      };
      switch (step.layer) {
        case B_H1:  // the A stages are free: stage the cotangents
          if (L.g_staged) {
            __syncthreads();
            stage_rows(g1s, g1, d.Rw, row0, L.m, n);
            stage_rows(gfs, gf, d.Sp, row0, L.m, n);
            stage_rows(gls, gl, d.Cp, row0, L.m, n);
          }
          break;
        case B_R:
          __syncthreads();
          put(D_H1, h0, ldh);
          put(D_H2, h1, ldh);
          put(D_C1, h2, ldc);
          put(D_C2, h3, ldc);
          put(D_DR, dr, ldr);
          break;
        case B_DC1:
          __syncthreads();
          put(D_DC2, h3, ldc);
          put(D_DC1, h2, ldc);
          put(D_XB, xb, ldb);
          put(D_S, st, lds);
          break;
        case B_O1:  // the logits' cotangent as a bf16 tile
          block_copy(L.m, d.Cp >> 1, [&](int r, int c2) {
            const float2 v =
                row0 + r < n ? *reinterpret_cast<const float2*>(
                                   glt_src + r * d.Cp + 2 * c2)
                             : make_float2(0.0f, 0.0f);
            store_pair(glt + r * ldl + 2 * c2, v.x, v.y);
          });
          __syncthreads();
          put(D_F1, h2, ldc);
          put(D_F2, h3, ldc);
          put(D_RF, fr, ldf);
          put(D_O1, h4, ldo);
          put(D_GL, glt, ldl);
          break;
        case B_DF1:
          __syncthreads();
          put(D_DO1, h4, ldo);
          put(D_DF, fr, ldf);
          put(D_DF2, h3, ldc);
          put(D_DF1, h2, ldc);
          break;
        case B_DH1:
          __syncthreads();
          put(D_DS, dst, lds);
          put(D_DH2, h1, ldh);
          break;
        default:
          break;
      }
    }
  }
  cp_async_wait_all();
}

// ----------------------------------------------------------------- dW

// dW = X^T @ dY over all points, for each weight: a split-K tensor-core
// product. A block takes one 64-row x 128-column tile of one weight's
// gradient (rows: X's columns, one 16-row slice per warp) over one split
// of the points, in chunks of 64 points staged one ahead with cp.async,
// and stores it to its split's partial; sum_partials_kernel then adds the
// splits in order. X comes from A (fp32, rounded to bf16 in shared
// memory: dWA) or from a workspace region (bf16); dY from a region.
#define DW_N 128  // output columns per block
#define DW_K 64   // output rows per block: 4 warps x 16

struct DwTerm {
  long long x, y;   // element offsets of X's (unless from A) and dY's region
  long long part;   // float offset of the gradient in a split's partial
  int x_ld, in, out;
  int unit0;        // the term's first block (blockIdx.y)
};

struct DwTerms {
  DwTerm t[N_WEIGHTS];
  int n, units;
};

struct DwLayout {
  size_t xs[2], hb[2], abf, bytes;
};

// X's stages hold fp32 A (pitch X_LD floats, then rounded into abf) or a
// region's bf16 (pitch DW_K + 8); dY's stages bf16 (pitch DW_N + 8).
template <bool XF32>
__host__ __device__ inline DwLayout dw_layout() {
  DwLayout L;
  size_t o = 0;
  for (int i = 0; i < 2; ++i) {
    L.xs[i] = o;
    o += XF32 ? round128((size_t)TILE_M * X_LD * sizeof(float))
              : tile_bytes(TILE_M, DW_K);
    L.hb[i] = o;
    o += tile_bytes(TILE_M, DW_N);
  }
  L.abf = o;
  if (XF32) o += tile_bytes(TILE_M, DW_K);
  L.bytes = o;
  return L;
}

// acc (16 rows of this warp x NS 16-column slices) += xs^T @ hb over one
// chunk of 64 points: xs the chunk's X columns (bf16, pitch DW_K + 8), hb
// its dY (pitch DW_N + 8).
template <int NS>
__device__ __forceinline__ void dw_chunk(float (&acc)[DW_N / 8][4],
                                         const bf16* xs, const bf16* hb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < TILE_M; k += 16) {
    uint32_t a[4], b[NS][4];  // a: X^T, the chunk's columns as rows
    ldsm_x4_t(a, xs + (k + (lane & 7) + (lane >> 4) * 8) * (DW_K + 8) +
                     warp * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int jp = 0; jp < NS; ++jp)
      ldsm_x4_t(b[jp], hb + (k + (lane & 15)) * (DW_N + 8) + jp * 16 +
                           (lane >> 4) * 8);
#pragma unroll
    for (int jp = 0; jp < NS; ++jp) {
      mma16816(acc[2 * jp], a, b[jp][0], b[jp][1]);
      mma16816(acc[2 * jp + 1], a, b[jp][2], b[jp][3]);
    }
  }
}

// blockIdx = (split, tile of some term's gradient).
template <bool XF32>
__global__ void __launch_bounds__(TILE_THREADS)
    dw_kernel(const float* __restrict__ A, const bf16* __restrict__ ws,
              DwTerms T, bool a_vec, long long n, long long pts,
              long long part_stride, float* __restrict__ part) {
  extern __shared__ __align__(128) unsigned char smem[];
  const DwLayout L = dw_layout<XF32>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  int ti = 0;
  while (ti + 1 < T.n && (int)blockIdx.y >= T.t[ti + 1].unit0) ++ti;
  const DwTerm tm = T.t[ti];
  const int ctiles = (tm.out + DW_N - 1) / DW_N;
  const int u = blockIdx.y - tm.unit0;
  const int k0 = (u / ctiles) * DW_K, c0 = (u % ctiles) * DW_N;
  const int nc = min(DW_N, tm.out - c0);
  const long long p0 = blockIdx.x * pts;
  const long long p1 = min(n, p0 + pts);
  const long long chunks = (p1 - p0 + TILE_M - 1) / TILE_M;
  const int ldx = DW_K + 8, ldh = DW_N + 8;
  auto issue = [&](long long c) {
    if (c < chunks) {
      const long long r0 = p0 + c * TILE_M;
      if (XF32) {
        stage_x((float*)(smem + L.xs[c & 1]), A, tm.x_ld, a_vec, r0, TILE_M,
                n, k0, DW_K);
      } else {
        bf16* xs = (bf16*)(smem + L.xs[c & 1]);
        block_copy(TILE_M, DW_K >> 3, [&](int r, int c8) {
          const int col = k0 + c8 * 8;
          const bool ok = r0 + r < n && col < tm.in;
          cp_async16(xs + r * ldx + c8 * 8,
                     ok ? ws + tm.x + (r0 + r) * tm.x_ld + col : ws, ok);
        });
      }
      bf16* hb = (bf16*)(smem + L.hb[c & 1]);
      block_copy(TILE_M, nc >> 3, [&](int r, int c8) {
        const bool ok = r0 + r < n;
        cp_async16(hb + r * ldh + c8 * 8,
                   ok ? ws + tm.y + (r0 + r) * tm.out + c0 + c8 * 8 : ws,
                   ok);
      });
    }
    cp_async_commit();
  };
  float acc[DW_N / 8][4];
#pragma unroll
  for (int j = 0; j < DW_N / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  issue(0);
  for (long long c = 0; c < chunks; ++c) {
    cp_async_wait_all();
    __syncthreads();
    issue(c + 1);
    const bf16* xs = (const bf16*)(smem + L.xs[c & 1]);
    if (XF32) {  // round the chunk's A to bf16
      const float* af = (const float*)xs;
      bf16* abf = (bf16*)(smem + L.abf);
      for (int e = threadIdx.x; e < TILE_M * (DW_K / 4); e += TILE_THREADS) {
        const int r = e / (DW_K / 4), c4 = (e % (DW_K / 4)) * 4;
        const float4 v = *reinterpret_cast<const float4*>(af + r * X_LD + c4);
        store_pair(abf + r * ldx + c4, v.x, v.y);
        store_pair(abf + r * ldx + c4 + 2, v.z, v.w);
      }
      __syncthreads();
      xs = abf;
    }
    const bf16* hb = (const bf16*)(smem + L.hb[c & 1]);
    switch (nc >> 4) {
      case 1: dw_chunk<1>(acc, xs, hb); break;
      case 2: dw_chunk<2>(acc, xs, hb); break;
      case 3: dw_chunk<3>(acc, xs, hb); break;
      case 4: dw_chunk<4>(acc, xs, hb); break;
      case 5: dw_chunk<5>(acc, xs, hb); break;
      case 6: dw_chunk<6>(acc, xs, hb); break;
      case 7: dw_chunk<7>(acc, xs, hb); break;
      default: dw_chunk<8>(acc, xs, hb);
    }
  }
  if (k0 + warp * 16 >= tm.in) return;  // past the gradient's rows
  float* out = part + (size_t)blockIdx.x * part_stride + tm.part +
               (size_t)(k0 + warp * 16 + g) * tm.out + c0 + 2 * t;
#pragma unroll
  for (int j = 0; j < DW_N / 8; ++j) {
    if (j * 8 < nc) {
      *reinterpret_cast<float2*>(out + j * 8) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(out + 8 * tm.out + j * 8) =
          make_float2(acc[j][2], acc[j][3]);
    }
  }
}

// One dw_kernel launch: its terms, their gradients' floats (one split's
// partial), and the splits of the points that fill the card.
struct DwLaunch {
  DwTerms T;
  long long total, split_pts;
  int splits, per_sm;
};

template <bool XF32>
static cudaError_t dw_plan(const HeadsDims& d, const BwdLayout& L,
                           long long n, DwLaunch* P) {
  DwTerms& T = P->T;
  T.n = 0;
  T.units = 0;
  P->total = 0;
  for (int m = 0; m < N_WEIGHTS; ++m) {
    if ((m == WA) != XF32) continue;
    int rows, cols;
    weight_shape(d, m, &rows, &cols);
    DwTerm& tm = T.t[T.n++];
    tm.x = XF32 ? 0 : L.reg[DW_X[m]];
    tm.y = L.reg[DW_Y[m]];
    tm.part = P->total;
    tm.x_ld = XF32 ? d.a_cols : rows;
    tm.in = rows;
    tm.out = cols;
    tm.unit0 = T.units;
    T.units += ((rows + DW_K - 1) / DW_K) * ((cols + DW_N - 1) / DW_N);
    P->total += (long long)rows * cols;
  }
  int capacity = 0;
  cudaError_t err = tile_shape((const void*)dw_kernel<XF32>,
                               dw_layout<XF32>().bytes, TILE_M, TILE_THREADS,
                               n, &capacity, &P->per_sm);
  if (err != cudaSuccess) return err;
  // tile_shape caps the blocks at one per tile of points; take the card's.
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  capacity = sms * P->per_sm;
  const long long chunks = (n + TILE_M - 1) / TILE_M;
  long long splits = capacity / T.units;
  if (splits < 1) splits = 1;
  if (splits > chunks) splits = chunks > 0 ? chunks : 1;
  P->split_pts = (chunks + splits - 1) / splits * TILE_M;
  P->splits = (int)(n > 0 ? (n + P->split_pts - 1) / P->split_pts : 1);
  return cudaSuccess;
}

template <bool XF32>
static cudaError_t dw_launch(const DwLaunch& P, const float* A,
                             const bf16* ws, bool a_vec, long long n,
                             float* part, float* dW, cudaStream_t s) {
  dw_kernel<XF32><<<dim3((unsigned)P.splits, (unsigned)P.T.units),
                    TILE_THREADS, dw_layout<XF32>().bytes, s>>>(
      A, ws, P.T, a_vec, n, P.split_pts, P.total, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_partials(part, P.splits, P.total, dW, s);
}

// ----------------------------------------------------------------- dA

// dA = dh1s @ WA^T: (n x H) bf16 from the workspace times WA (Ap x H,
// bf16), fp32 out (n x a_cols). A block computes 128 points x 128 columns
// of dA, its 8 warps 32 x 64 each, over K = H in chunks of 64 staged one
// ahead with cp.async; the MMAs and the epilogue are the fused kernels'.
#define DA_M 128
#define DA_N 128
#define DA_K 64

struct DaLayout {
  size_t x[2], w[2], bytes;
};

__host__ __device__ inline DaLayout da_layout() {
  DaLayout L;
  size_t o = 0;
  for (int i = 0; i < 2; ++i) {
    L.x[i] = o;
    o += tile_bytes(DA_M, DA_K);
    L.w[i] = o;
    o += tile_bytes(DA_N, DA_K);
  }
  L.bytes = o;
  return L;
}

__global__ void __launch_bounds__(HEAD_THREADS)
    da_kernel(const bf16* __restrict__ dh, const bf16* __restrict__ wa,
              HeadsDims d, long long n, float* __restrict__ dA) {
  extern __shared__ __align__(128) unsigned char smem[];
  const DaLayout L = da_layout();
  const long long p0 = (long long)blockIdx.x * DA_M;
  const int a0 = blockIdx.y * DA_N;
  const int nc = min(DA_N, d.Ap - a0), ld = DA_K + 8;
  const int chunks = (d.H + DA_K - 1) / DA_K;
  auto issue = [&](int c) {
    if (c < chunks) {
      const int k0 = c * DA_K, kr = min(DA_K, d.H - k0);
      bf16* xs = (bf16*)(smem + L.x[c & 1]);
      bf16* ws = (bf16*)(smem + L.w[c & 1]);
      block_copy(DA_M, kr >> 3, [&](int r, int c8) {
        const bool ok = p0 + r < n;
        cp_async16(xs + r * ld + c8 * 8,
                   ok ? dh + (p0 + r) * d.H + k0 + c8 * 8 : dh, ok);
      });
      block_copy(nc, kr >> 3, [&](int r, int c8) {
        cp_async16(ws + r * ld + c8 * 8,
                   wa + (size_t)(a0 + r) * d.H + k0 + c8 * 8, true);
      });
    }
    cp_async_commit();
  };
  const WarpTile wt = warp_tile(DA_M);
  Acc acc;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < COL_TILE / 16; ++j)
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.0f;
  issue(0);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait_all();
    __syncthreads();
    issue(c + 1);
    mma_ns<true, false>(acc, (const bf16*)(smem + L.x[c & 1]), ld, nullptr,
                        min(DA_K, d.H - c * DA_K),
                        (const bf16*)(smem + L.w[c & 1]), ld, nc, wt);
  }
  Step st = {};
  st.cols = (uint16_t)nc;
  epilogue(acc, st, wt, [&](int r, int c, float v0, float v1) {
    const int a = a0 + c;
    if (p0 + r >= n) return;
    float* o = dA + (p0 + r) * d.a_cols + a;
    if (a + 1 < d.a_cols && d.a_cols % 2 == 0) {
      *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    } else if (a < d.a_cols) {
      o[0] = v0;
      if (a + 1 < d.a_cols) o[1] = v1;
    }
  });
}

// The launch plan of one backward: the fused kernel's layout and blocks,
// da_kernel's grid, and the two dw_kernel launches (dWA from A; the other
// 13 from the workspace).
struct BwdPlan {
  BwdLayout L;
  int blocks, per_sm, da_per_sm;
  dim3 da_grid;
  DwLaunch wa, rest;
};

static cudaError_t bwd_plan(const HeadsDims& d, long long n, bool need_dB,
                            BwdPlan* P) {
  cudaError_t err;
  int optin = 0;
  if ((err = smem_optin(&optin)) != cudaSuccess) return err;
  // Tiles of 64 points, or of 32 where the widest heads' tiles need it.
  P->L = bwd_layout(d, TILE_M, need_dB, n);
  if (P->L.bytes > (size_t)optin)
    P->L = bwd_layout(d, TILE_M / 2, need_dB, n);
  if (P->L.nsteps > MAX_STEPS) return cudaErrorInvalidValue;
  if ((err = tile_shape((const void*)heads_bwd_kernel, P->L.bytes, P->L.m,
                        HEAD_THREADS, n, &P->blocks, &P->per_sm)) !=
      cudaSuccess)
    return err;
  int da_blocks = 0;
  if ((err = tile_shape((const void*)da_kernel, da_layout().bytes, DA_M,
                        HEAD_THREADS, n, &da_blocks, &P->da_per_sm)) !=
      cudaSuccess)
    return err;
  P->da_grid = dim3((unsigned)((n + DA_M - 1) / DA_M),
                    (unsigned)((d.Ap + DA_N - 1) / DA_N));
  if ((err = dw_plan<true>(d, P->L, n, &P->wa)) != cudaSuccess) return err;
  return dw_plan<false>(d, P->L, n, &P->rest);
}

// The scratch the wrapper allocates for heads_bwd, whether or not dB is
// wanted: *ws_elems bf16 (dh1s and the other weight gradients' operands,
// 1,720 values a point at the flagship widths) and *part_floats fp32 (the
// dw_kernel launches' per-split partials).
extern "C" int heads_bwd_workspace(const int* dims, long long n,
                                   long long* part_floats,
                                   long long* ws_elems) {
  HeadsDims d = heads_dims(dims);
  if (!heads_dims_ok(d)) return (int)cudaErrorInvalidValue;
  BwdPlan P;
  cudaError_t err = bwd_plan(d, n, true, &P);
  if (err != cudaSuccess) return (int)err;
  *part_floats = (long long)P.wa.splits * P.wa.total +
                 (long long)P.rest.splits * P.rest.total;
  *ws_elems = P.L.ws_elems;
  return 0;
}

// dB may be null (not wanted). dW (the 14 gradients, packed back to back
// in pack order, fp32) needs part and ws of heads_bwd_workspace's sizes.
extern "C" int heads_bwd(const float* A, const float* B,
                         const void* const* weights, const int* dims,
                         const float* g1, const float* gf, const float* gl,
                         float* dA, float* dB, float* dW, float* part,
                         void* ws, long long n, void* stream) {
  HeadsDims d = heads_dims(dims);
  if (!heads_dims_ok(d)) return (int)cudaErrorInvalidValue;
  HeadsWeights w;
  for (int i = 0; i < N_WEIGHTS; ++i) {
    w.m[i] = (const bf16*)weights[i];
    if (!aligned16(w.m[i])) return (int)cudaErrorInvalidValue;
  }
  if (!dW || !part || (n > 0 && (!dA || !ws)))
    return (int)cudaErrorInvalidValue;
  BwdPlan P;
  cudaError_t err = bwd_plan(d, n, dB != nullptr, &P);
  if (err != cudaSuccess) return (int)err;
  P.L.g_staged = P.L.g_staged && aligned16(g1) && aligned16(gf) &&
                 aligned16(gl);
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0)
    return (int)cudaMemsetAsync(
        dW, 0, (P.wa.total + P.rest.total) * sizeof(float), s);
  const bool a_vec = aligned16(A) && d.a_cols % 4 == 0;
  bf16* wsb = (bf16*)ws;
  heads_bwd_kernel<<<P.blocks, HEAD_THREADS, P.L.bytes, s>>>(
      A, B, w, d, P.L, a_vec, aligned16(B) && d.b_cols % 4 == 0, g1, gf, gl,
      dB, wsb, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  da_kernel<<<P.da_grid, HEAD_THREADS, da_layout().bytes, s>>>(
      wsb + P.L.reg[D_DH1], w.m[WA], d, n, dA);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = dw_launch<true>(P.wa, A, wsb, a_vec, n, part, dW, s)) !=
      cudaSuccess)
    return (int)err;
  return (int)dw_launch<false>(
      P.rest, A, wsb, a_vec, n, part + (size_t)P.wa.splits * P.wa.total,
      dW + P.wa.total, s);
}

// out[0..6): the fused kernel's blocks, threads, dynamic shared bytes,
// blocks per SM, registers per thread and schedule steps; out[6..12):
// the same for da_kernel (its last field: the chunks of K); out[12..18)
// and out[18..24): for the dw_kernel launches of dWA and of the other 13
// gradients (their last field: the splits of the points).
extern "C" int heads_bwd_shape(const int* dims, long long n, int need_dB,
                               int* out) {
  HeadsDims d = heads_dims(dims);
  if (!heads_dims_ok(d)) return (int)cudaErrorInvalidValue;
  BwdPlan P;
  cudaError_t err = bwd_plan(d, n, need_dB, &P);
  if (err != cudaSuccess) return (int)err;
  if ((err = shape_report((const void*)heads_bwd_kernel, P.blocks,
                          HEAD_THREADS, P.L.bytes, P.per_sm, P.L.nsteps,
                          out)) != cudaSuccess)
    return (int)err;
  if ((err = shape_report((const void*)da_kernel,
                          (int)(P.da_grid.x * P.da_grid.y), HEAD_THREADS,
                          da_layout().bytes, P.da_per_sm,
                          (d.H + DA_K - 1) / DA_K, out + 6)) != cudaSuccess)
    return (int)err;
  if ((err = shape_report((const void*)dw_kernel<true>,
                          P.wa.splits * P.wa.T.units, TILE_THREADS,
                          dw_layout<true>().bytes, P.wa.per_sm, P.wa.splits,
                          out + 12)) != cudaSuccess)
    return (int)err;
  return (int)shape_report((const void*)dw_kernel<false>,
                           P.rest.splits * P.rest.T.units, TILE_THREADS,
                           dw_layout<false>().bytes, P.rest.per_sm,
                           P.rest.splits, out + 18);
}
