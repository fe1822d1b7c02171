// Fused field head stack (forward), K3f, for Hopper.
//
// Replaces the TPU kernel autolabel_tpu/ops/heads_pallas.py `_fwd_kernel`
// (launched by `_fused_heads_fwd_impl`): per point,
//   sigma net  h1 = relu(A.WA + B.WBs), h2 = relu(h1.W1s), S = h2.W2s
//   color net  c1 = relu(B.WBc + S.WSc), c2 = relu(c1.W1c), R = c2.W2c
//   features   f1 = relu(S.WSf), f2 = relu(f1.W1f), F = f2.W2f
//   logits     o1 = relu(relu(F).WFo + S.WSo), L = o1.W1o
// and writes out1 = [exp(min(S0, 15)), sigmoid(R0..2), 0...], F and L.
// Numerics: bf16 operands with fp32 accumulation, as heads_pallas._dot
// does on its accelerator; ReLU in fp32 before the next layer's operand is
// rounded to bf16; S enters the heads unrectified; sigma and rgb in fp32
// from the fp32 accumulators.
//
// What bounds it on the H100: bytes. Per point it reads 2,048 B of fp32 A
// (512 columns), 112 B of B's 28 real columns and writes 296 B (74 real
// output columns): 2,456 B, so 1.29 GB at the render's 524,288 points, or
// 0.384 ms at 3.35 TB/s; its 241,664 FLOP per point take 0.128 ms at the
// bf16 tensor-core peak of 989 TFLOP/s. The earlier design (one warp per 16
// points, every weight fragment read from L2 for every 16 points: 16 KiB
// of L2 reads per point) took 6.1856 ms on an NVIDIA H100 80GB HBM3 at
// 700.00 W, 53% of it in the first layer.
//
// Design (heads_tile.cuh): a block of 8 warps owns a tile of 128 points;
// activations stay in shared memory (bf16, padded rows) for the whole
// stack; mma.sync m16n8k16 with operands from ldmatrix; every epilogue
// works on the accumulator registers. The packed weights (250 KiB at the
// flagship widths) stream through three shared-memory stages of 64 x 128
// in the order the layers take them, so L2 serves 2,000 B of weights per
// point, no more than A's HBM bytes; A's 64-column fp32 chunks are staged
// beside them, one step ahead. Persistent blocks walk the tiles.
//
// Shared memory at the flagship widths (Ap 512, Bw 32, H = Hc = 128, Sw =
// Rw = Cp = 16, Hf = Sp = Ho = 64), for 128 points: weight stages 3 x
// 17,408 B, A stages 2 x 36,864 B (128 x 72 fp32), xb 10,240, the
// ping-pong hidden tiles p and q 2 x 34,816, S 6,144, the schedule 384 (23
// steps) and the weight table 128: 212,480 B, one block per SM. Wider
// heads take tiles of 64 or 32 points.
#include "heads_tile.cuh"

#define FWD_SLOT (64 * (COL_TILE + 8))  // bf16 elements of a weight stage

// The stack's layers, in the order they run.
enum { F_H1, F_H2, F_S, F_C1, F_C2, F_R, F_F1, F_F2, F_F, F_O1, F_L };

// The order in which the stack takes its weight chunks.
__host__ __device__ inline int heads_fwd_schedule(const HeadsDims& d,
                                                  Step* out) {
  Sched s = {out, 0, FWD_SLOT, d};
  sched_layer(s, F_H1, WBs, WA, false, true);
  sched_layer(s, F_H2, W1s, -1, false, false);
  sched_layer(s, F_S, W2s, -1, false, false);
  sched_layer(s, F_C1, WBc, WSc, false, false);
  sched_layer(s, F_C2, W1c, -1, false, false);
  sched_layer(s, F_R, W2c, -1, false, false);
  sched_layer(s, F_F1, WSf, -1, false, false);
  sched_layer(s, F_F2, W1f, -1, false, false);
  sched_layer(s, F_F, W2f, -1, false, false);
  sched_layer(s, F_O1, WFo, WSo, false, false);
  sched_layer(s, F_L, W1o, -1, false, false);
  return s.n;
}

// Byte offsets of the block's shared-memory regions, for tiles of m
// points.
struct FwdLayout {
  size_t sched, wtab, w, w_bytes, x, x_bytes, xb, p, q, s, bytes;
  int m, pq, nsteps;
};

static FwdLayout fwd_layout(const HeadsDims& d, int m) {
  FwdLayout L;
  L.m = m;
  L.pq = heads_hidden(d);
  L.nsteps = heads_fwd_schedule(d, nullptr);
  L.w_bytes = round128((size_t)FWD_SLOT * sizeof(bf16));
  L.x_bytes = round128((size_t)m * X_LD * sizeof(float));
  size_t o = 0;
  L.w = o; o += W_STAGES * L.w_bytes;
  L.x = o; o += 2 * L.x_bytes;
  L.xb = o; o += tile_bytes(m, d.Bw);
  L.p = o; o += tile_bytes(m, L.pq);
  L.q = o; o += tile_bytes(m, L.pq);
  L.s = o; o += tile_bytes(m, d.Sw);
  L.sched = o; o += round128((size_t)L.nsteps * sizeof(Step));
  L.wtab = o; o += round128(N_WEIGHTS * sizeof(bf16*));
  L.bytes = o;
  return L;
}

__global__ void __launch_bounds__(HEAD_THREADS)
    heads_fwd_kernel(const float* __restrict__ A,
                     const float* __restrict__ B, HeadsWeights w,
                     HeadsDims d, FwdLayout L, bool a_vec, bool b_vec,
                     float* __restrict__ out1, float* __restrict__ outf,
                     float* __restrict__ outl, long long n) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x == 0) heads_fwd_schedule(d, (Step*)(smem + L.sched));
  Stream s = stream_start(smem, L.sched, L.wtab, L.w, L.w_bytes, L.x,
                          L.x_bytes, L.nsteps, w, d, A, B, a_vec, b_vec, n,
                          L.m);
  const WarpTile wt = warp_tile(L.m);
  bf16* xb = (bf16*)(smem + L.xb);
  bf16* p = (bf16*)(smem + L.p);
  bf16* q = (bf16*)(smem + L.q);
  bf16* st = (bf16*)(smem + L.s);
  const int ldb = d.Bw + 8, ldp = L.pq + 8, lds = d.Sw + 8;
  // Each layer's input: p and q alternate as hidden tiles; relu(F) lands
  // in p, free once W1f has read it.
  auto src = [=](const Step& k) {
    switch (k.layer) {
      case F_H2: case F_C2: case F_F2: return Src{p, ldp};
      case F_S: case F_R: case F_F: case F_L: return Src{q, ldp};
      case F_C1: return k.m == WBc ? Src{xb, ldb} : Src{st, lds};
      case F_O1: return k.m == WFo ? Src{p, ldp} : Src{st, lds};
      default: return Src{st, lds};  // F_F1 (F_H1 comes staged)
    }
  };
  auto relu_to = [=](bf16* dst) {
    return [=](int r, int c, float v0, float v1) {
      store_pair(dst + r * ldp + c, fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
    };
  };

  Acc acc;
  for (long long tile = blockIdx.x; tile * L.m < n; tile += gridDim.x) {
    const long long row0 = tile * L.m;
    for (int k = 0; k < L.nsteps; ++k) {
      const bf16* wst;
      const float* xst;
      const Step step = stream_next(s, &wst, &xst);
      step_mma(acc, step, src(step), wst, xst, xb, ldb, L.m, wt);
      if (!(step.flags & STEP_LAST)) continue;
      switch (step.layer) {
        case F_H1: case F_C1: case F_F1:
          epilogue(acc, step, wt, relu_to(p));
          break;
        case F_H2: case F_C2: case F_F2: case F_O1:
          epilogue(acc, step, wt, relu_to(q));
          break;
        case F_S:  // S, and sigma = exp(min(S0, 15)) into out1[:, 0]
          epilogue(acc, step, wt, [&](int r, int c, float v0, float v1) {
            store_pair(st + r * lds + c, v0, v1);
            if (c == 0 && row0 + r < n)
              out1[(row0 + r) * d.Rw] = expf(fminf(v0, 15.0f));
          });
          break;
        case F_R:  // rgb = sigmoid(R0..2) into out1[:, 1..3], zeros after
          epilogue(acc, step, wt, [&](int r, int c, float v0, float v1) {
            if (row0 + r >= n) return;
            float* o = out1 + (row0 + r) * d.Rw + 1;
            const float v[2] = {v0, v1};
            for (int e = 0; e < 2; ++e)
              if (c + e + 1 < d.Rw)
                o[c + e] = c + e < 3 ? 1.0f / (1.0f + expf(-v[e])) : 0.0f;
          });
          break;
        case F_F:  // the features out, relu(F) into p
          epilogue(acc, step, wt, [&](int r, int c, float v0, float v1) {
            if (row0 + r < n)
              *reinterpret_cast<float2*>(outf + (row0 + r) * d.Sp + c) =
                  make_float2(v0, v1);
            store_pair(p + r * ldp + c, fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
          });
          break;
        default:  // F_L: the logits out
          epilogue(acc, step, wt, [&](int r, int c, float v0, float v1) {
            if (row0 + r < n)
              *reinterpret_cast<float2*>(outl + (row0 + r) * d.Cp + c) =
                  make_float2(v0, v1);
          });
      }
    }
  }
  cp_async_wait_all();
}

// Tiles of 128 points where the widths let them fit, else 64 or 32.
static cudaError_t fwd_plan(const HeadsDims& d, long long n, FwdLayout* L,
                            int* blocks, int* per_sm) {
  int optin = 0;
  cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return err;
  for (int m = 128; m >= 32; m /= 2) {
    *L = fwd_layout(d, m);
    if (L->bytes <= (size_t)optin) break;
  }
  if (L->nsteps > MAX_STEPS) return cudaErrorInvalidValue;
  return tile_shape((const void*)heads_fwd_kernel, L->bytes, L->m,
                    HEAD_THREADS, n, blocks, per_sm);
}

extern "C" int heads_fwd(const float* A, const float* B,
                         const void* const* weights, const int* dims,
                         float* out1, float* outf, float* outl, long long n,
                         void* stream) {
  HeadsDims d = heads_dims(dims);
  if (!heads_dims_ok(d)) return (int)cudaErrorInvalidValue;
  HeadsWeights w;
  for (int i = 0; i < N_WEIGHTS; ++i) {
    w.m[i] = (const bf16*)weights[i];
    if (!aligned16(w.m[i])) return (int)cudaErrorInvalidValue;
  }
  FwdLayout L;
  int blocks = 0, per_sm = 0;
  cudaError_t err = fwd_plan(d, n, &L, &blocks, &per_sm);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  heads_fwd_kernel<<<blocks, HEAD_THREADS, L.bytes,
                     (cudaStream_t)stream>>>(
      A, B, w, d, L, aligned16(A) && d.a_cols % 4 == 0,
      aligned16(B) && d.b_cols % 4 == 0, out1, outf, outl, n);
  return (int)cudaGetLastError();
}

// out[0..6): blocks, threads, dynamic shared bytes, blocks per SM,
// registers per thread and schedule steps of the launch for n points.
extern "C" int heads_fwd_shape(const int* dims, long long n, int* out) {
  HeadsDims d = heads_dims(dims);
  if (!heads_dims_ok(d)) return (int)cudaErrorInvalidValue;
  FwdLayout L;
  int blocks = 0, per_sm = 0;
  cudaError_t err = fwd_plan(d, n, &L, &blocks, &per_sm);
  if (err != cudaSuccess) return (int)err;
  return (int)shape_report((const void*)heads_fwd_kernel, blocks,
                           HEAD_THREADS, L.bytes, per_sm, L.nsteps, out);
}
