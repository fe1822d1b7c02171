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
// column per point against 2 x 6,400 MACs, three times that backward).
// Both keep the weights in shared memory for a persistent launch, stage
// each warp's 16-point tiles through a cp.async ring of its own, run
// mma.sync m16n8k16 from ldmatrix and keep every activation in registers
// as the next product's A fragments (forward section, backward section).
#include <array>
#include <map>
#include <mutex>
#include <utility>

#include "mma_ptx.cuh"
#include "partials.cuh"

#define TILE_ROWS 16    // points per warp tile, forward and backward
#define MAX_HIDDEN 256  // widest hidden layer: 16 templates of 16 columns

__host__ __device__ __forceinline__ bool tile_width(int v) {
  return v > 0 && v % 16 == 0;
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

// A lane's share of copying a 16-row fp32 tile: pieces (r, c) from (r0,
// c0) in steps of 32 pieces (dr rows and dc pieces), each 16 bytes (vec)
// or 4.
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
  while (r < TILE_ROWS) {
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

// The A fragment (rows g, g + 8; columns k0 + 2t, + 1, + 8, + 9) of a
// 16-row fp32 tile (pitch ld), rounded to bf16 on the way.
__device__ __forceinline__ void fp32_fragment(uint32_t (&a)[4],
                                              const float* tile, int ld,
                                              int k0, int lane) {
  const float* p = tile + (lane >> 2) * ld + k0 + 2 * (lane & 3);
  const float2 v0 = *reinterpret_cast<const float2*>(p);
  const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * ld);
  const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
  const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * ld + 8);
  a[0] = pack_bf16(v0.x, v0.y);
  a[1] = pack_bf16(v1.x, v1.y);
  a[2] = pack_bf16(v2.x, v2.y);
  a[3] = pack_bf16(v3.x, v3.y);
}

// acc[2j], acc[2j + 1] += A @ w[k0 : k0 + 16, 16j : 16j + 16] for j < NJ
// (w: bf16 in shared memory, row-major (K, N), pitch ldw).
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

template <int NT>
__device__ __forceinline__ void zero_acc(float (*acc)[4]) {
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
}

// The plan of one kernel for these widths on the current device, made by
// make(d_in, hidden, d_out, device, plan) on the first call for them and
// kept, with its refusal: a launch then costs one cudaGetDevice and a
// lookup. Faults of the runtime are not kept.
template <class Plan>
static cudaError_t kept_plan(int d_in, int hidden, int d_out, Plan* p,
                             cudaError_t (*make)(int, int, int, int,
                                                 Plan*)) {
  static std::mutex mu;
  static std::map<std::array<int, 4>, std::pair<cudaError_t, Plan>> plans;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::array<int, 4> key = {dev, d_in, hidden, d_out};
  std::lock_guard<std::mutex> lock(mu);
  auto it = plans.find(key);
  if (it == plans.end()) {
    err = make(d_in, hidden, d_out, dev, p);
    if (err != cudaSuccess && err != cudaErrorInvalidValue) return err;
    it = plans.emplace(key, std::make_pair(err, *p)).first;
  }
  *p = it->second.second;
  return it->second.first;
}

// The card's SM count and shared-memory limit per block.
static cudaError_t card_limits(int dev, int* sms, size_t* limit) {
  int optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *limit = (size_t)optin;
  return err;
}

// Persistent blocks for n points: one per `warps` warp tiles, at most as
// many as stay resident.
static int persistent_blocks(int sms, int per_sm, int warps, long long n) {
  const long long tiles = (n + TILE_ROWS - 1) / TILE_ROWS;
  const long long want = (tiles + warps - 1) / warps;
  const long long most = (long long)sms * per_sm;
  return (int)(want < most ? (want > 0 ? want : 1) : most);
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
  o += (size_t)FWD_WARPS * fwd_stages(hidden) * TILE_ROWS * L.ldx *
       sizeof(float);
  L.bytes = o;
  return L;
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

  float* xs = (float*)(smem + L.x) + (size_t)warp * S * TILE_ROWS * ldx;
  // X's padding columns [x_cols, d_in) stay zero: no copy writes them.
  const int pad = d_in - x_cols;
  for (int e = lane; e < S * TILE_ROWS * pad; e += 32)
    xs[(e / pad) * ldx + x_cols + e % pad] = 0.0f;
  const XCopy cp = x_copy(x_cols, x_vec, lane);
  const long long tiles = (n + TILE_ROWS - 1) / TILE_ROWS;
  const long long step = (long long)gridDim.x * FWD_WARPS;
  long long tile = (long long)blockIdx.x * FWD_WARPS + warp;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (tile + s * step < tiles)
      stage_tile(xs + s * TILE_ROWS * ldx, ldx, X, x_cols, cp,
                 (tile + s * step) * TILE_ROWS, n);
    cp_async_commit();
  }
  cp_async_wait<S - 1>();  // this thread's weight copies
  __syncthreads();         // everyone's

  for (int slot = 0; tile < tiles; tile += step) {
    cp_async_wait<S - 2>();  // this tile's X
    __syncwarp();            // and every lane's; last tile's reads done
    const int refill = slot == 0 ? S - 1 : slot - 1;
    if (tile + (S - 1) * step < tiles)
      stage_tile(xs + refill * TILE_ROWS * ldx, ldx, X, x_cols, cp,
                 (tile + (S - 1) * step) * TILE_ROWS, n);
    cp_async_commit();
    const float* xt = xs + slot * TILE_ROWS * ldx;
    slot = slot + 1 == S ? 0 : slot + 1;

    uint32_t a[NT][4];
    float acc[2 * NT][4];
    // layer 0: X (rounded to bf16 here) @ W0
    zero_acc<NT>(acc);
    for (int k = 0; k < d_in; k += 16) {
      uint32_t ax[4];
      fp32_fragment(ax, xt, ldx, k, lane);
      mma_row<NT>(acc, ax, w0, ldh, k, lane);
    }
    to_fragments<NT>(acc, a);
    // layer 1: relu(h1) @ W1, A from registers
    zero_acc<NT>(acc);
#pragma unroll
    for (int k = 0; k < NT; ++k) mma_row<NT>(acc, a[k], w1, ldh, k * 16, lane);
    to_fragments<NT>(acc, a);
    // layer 2: relu(h2) @ W2, 64 output columns a pass, stored from the
    // accumulators
    const long long row = tile * TILE_ROWS + g;
    for (int o0 = 0; o0 < d_out; o0 += 64) {
      float oc[8][4];
      zero_acc<4>(oc);
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

static cudaError_t plan_fwd(int d_in, int hidden, int d_out, int dev,
                            FwdPlan* p) {
  *p = FwdPlan{nullptr, 0, 0, 0, 0};
  if (!tile_width(d_in) || !tile_width(hidden) || !tile_width(d_out))
    return cudaErrorInvalidValue;
  p->smem = fwd_layout(d_in, hidden, d_out).bytes;
  cudaError_t err = card_limits(dev, &p->sms, &p->limit);
  if (err != cudaSuccess) return err;
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

extern "C" int mlp3_fwd(const float* X, int x_cols, const void* W0,
                        const void* W1, const void* W2, int d_in, int hidden,
                        int d_out, float* out, long long n, void* stream) {
  if (x_cols < 1 || x_cols > d_in) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)W0 | (uintptr_t)W1 | (uintptr_t)W2) & 15)
    return (int)cudaErrorMisalignedAddress;
  FwdPlan p;
  cudaError_t err = kept_plan(d_in, hidden, d_out, &p, plan_fwd);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const bool x_vec = x_cols % 4 == 0 && ((uintptr_t)X & 15) == 0;
  p.kernel<<<persistent_blocks(p.sms, p.per_sm, FWD_WARPS, n), FWD_THREADS,
             p.smem, (cudaStream_t)stream>>>(
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
  cudaError_t err = kept_plan(d_in, hidden, d_out, &p, plan_fwd);
  cudaFuncAttributes attr;
  attr.numRegs = 0;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, (const void*)p.kernel);
  out[0] = err == cudaSuccess ? persistent_blocks(p.sms, p.per_sm,
                                                  FWD_WARPS, n)
                              : 0;
  out[1] = FWD_THREADS;
  out[2] = (int)p.smem;
  out[3] = p.per_sm;
  out[4] = attr.numRegs;
  out[5] = TILE_ROWS;
  out[6] = (int)p.limit;
  out[7] = MAX_HIDDEN;
  return (int)err;
}

// ---------------------------------------------------------------- backward
//
// K4b: recompute, backward chain and the three weight gradients in one
// persistent launch. Blocks of up to BWD_MAX_WARPS warps (as many as
// shared memory holds) load W0, W1, W2 once into padded bf16 tiles; every
// product by W (ldmatrix.trans) and by W^T (ldmatrix) reads that one copy.
// Each block step, every warp takes one 16-point tile: its fp32 X and g
// rows come through a cp.async ring of its own (BWD_STAGES slots, a tile
// ahead); it recomputes h1 and h2 with the forward's register-resident
// fragments, then dh2 = g.W2^T masked by [h2 > 0] and dh1 = dh2.W1^T
// masked by [h1 > 0], lane-locally (an accumulator has the layout of the
// activation's fragment), and dX = dh1.W0^T only when asked. On the way it
// writes the bf16 tiles of X, h1, h2, g, dh2 and dh1 once into its shared
// memory. After one barrier the block's warps share the weight-gradient
// products X^T.dh1, h1^T.dh2, h2^T.g over the block's points: 16 x 16
// tiles of dW dealt round-robin to the warps, operands by ldmatrix.trans
// from every warp's tiles; a second barrier frees the tiles. Where the
// tiles number at most DW_REG_TILES a warp (the proposal net's 48-64-64-16:
// 32 tiles, 4 a warp) their fp32 accumulators stay in registers for the
// whole launch and reach the block's partial once, at the end; wider nets
// add each step into the block's partial in device memory. The partials
// are summed in block order (partials.cuh), so dW is the same for a launch
// shape every run.
#define BWD_MAX_WARPS 8
#define BWD_STAGES 2    // X and g slots of a warp's ring
#define DW_REG_TILES 4  // weight-gradient tiles a warp keeps in registers

struct BwdLayout {
  size_t w0, w1, w2, fixed;              // the block's weights
  size_t xs, gs, xb, h1, h2, gb, dh2, dh1;  // offsets in a warp's region
  size_t warp_bytes;
  int ldx, ldg;  // row pitches of the fp32 X and g slots, in floats
};

// A warp's 16-row bf16 tile of `width` columns, rows padded by 8 elements
// (ldmatrix then reads 8 rows from 8 bank groups).
__host__ __device__ __forceinline__ size_t tile_bytes(int width) {
  return round128((size_t)TILE_ROWS * (width + 8) * sizeof(bf16));
}

__host__ __device__ __forceinline__ BwdLayout bwd_layout(int d_in, int hidden,
                                                         int d_out) {
  BwdLayout L;
  size_t o = 0;
  L.w0 = o; o += round128((size_t)d_in * (hidden + 8) * sizeof(bf16));
  L.w1 = o; o += round128((size_t)hidden * (hidden + 8) * sizeof(bf16));
  L.w2 = o; o += round128((size_t)hidden * (d_out + 8) * sizeof(bf16));
  L.fixed = o;
  L.ldx = d_in + 8;
  L.ldg = d_out + 8;
  o = 0;
  L.xs = o; o += round128((size_t)BWD_STAGES * TILE_ROWS * L.ldx * 4);
  L.gs = o; o += round128((size_t)BWD_STAGES * TILE_ROWS * L.ldg * 4);
  L.xb = o; o += tile_bytes(d_in);
  L.h1 = o; o += tile_bytes(hidden);
  L.h2 = o; o += tile_bytes(hidden);
  L.gb = o; o += tile_bytes(d_out);
  L.dh2 = o; o += tile_bytes(hidden);
  L.dh1 = o; o += tile_bytes(hidden);
  L.warp_bytes = o;
  return L;
}

// acc[2j], acc[2j + 1] += A @ W^T[k0 : k0 + 16, 16j : 16j + 16] for j < NJ,
// where W is stored (N, K) row-major in shared memory, pitch ldw: the
// non-transposing ldmatrix of W's rows gives W^T's B fragments.
template <int NJ>
__device__ __forceinline__ void mma_row_t(float (*acc)[4],
                                          const uint32_t (&a)[4],
                                          const bf16* w, int ldw, int k0,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    uint32_t b[4];
    ldsm_x4(b, w + (j * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldw + k0 +
                   ((lane >> 3) & 1) * 8);
    mma16816(acc[2 * j], a, b[0], b[1]);
    mma16816(acc[2 * j + 1], a, b[2], b[3]);
  }
}

// Write an A fragment (16 rows, columns col0 .. col0 + 16) into a bf16 tile
// of pitch ld, and read one back.
__device__ __forceinline__ void store_fragment(bf16* tile, int ld, int col0,
                                               const uint32_t (&a)[4],
                                               int lane) {
  uint32_t* p = reinterpret_cast<uint32_t*>(
      tile + (lane >> 2) * ld + col0 + 2 * (lane & 3));
  const int down = 4 * ld;  // 8 rows, in 32-bit words
  p[0] = a[0];
  p[down] = a[1];
  p[4] = a[2];
  p[down + 4] = a[3];
}

__device__ __forceinline__ void load_fragment(uint32_t (&a)[4],
                                              const bf16* tile, int ld,
                                              int col0, int lane) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(
      tile + (lane >> 2) * ld + col0 + 2 * (lane & 3));
  const int down = 4 * ld;
  a[0] = p[0];
  a[1] = p[down];
  a[2] = p[4];
  a[3] = p[down + 4];
}

// bf16 pair (v0, v1), each kept where its half of `mask` (a pair of bf16
// activations after ReLU) is positive, else 0.
__device__ __forceinline__ uint32_t pack_masked(float v0, float v1,
                                                uint32_t mask) {
  return pack_bf16((short)(mask & 0xffffu) > 0 ? v0 : 0.0f,
                   (short)(mask >> 16) > 0 ? v1 : 0.0f);
}

// The masked cotangent of a layer's accumulators into A fragments; mask
// holds the layer's activations as A fragments, so every element and its
// mask sit in the same lane.
__device__ __forceinline__ void to_grad_fragment(uint32_t (&d)[4],
                                                 const float* lo,
                                                 const float* hi,
                                                 const uint32_t (&mask)[4]) {
  d[0] = pack_masked(lo[0], lo[1], mask[0]);
  d[1] = pack_masked(lo[2], lo[3], mask[1]);
  d[2] = pack_masked(hi[0], hi[1], mask[2]);
  d[3] = pack_masked(hi[2], hi[3], mask[3]);
}

// One 16 x 16 tile of a weight gradient, Act^T . Grad over the block's
// points: Act and Grad are the warps' bf16 tiles at byte offsets act and
// grad of each warp's region (pitches lda, ldb), the tile's rows m0 of Act's
// columns and its columns n0 of Grad's; dst is the tile's first element in
// a partial whose rows hold `cols` floats.
struct DwTile {
  size_t act, grad;
  int lda, ldb, m0, n0, cols;
  size_t dst;
};

// Weight-gradient tile i of d_in x H (dW0), H x H (dW1), H x d_out (dW2),
// in that order, each row-major by 16 x 16 tiles.
__device__ __forceinline__ DwTile dw_tile(int i, const BwdLayout& L,
                                          int d_in, int H, int d_out) {
  const int nt = H >> 4;
  const int t0 = (d_in >> 4) * nt, t1 = nt * nt;
  const int ldi = d_in + 8, ldh = H + 8, ldo = d_out + 8;
  if (i < t0)
    return {L.xb, L.dh1, ldi, ldh, (i / nt) * 16, (i % nt) * 16, H,
            (size_t)(i / nt) * 16 * H + (i % nt) * 16};
  i -= t0;
  const size_t o1 = (size_t)d_in * H;
  if (i < t1)
    return {L.h1, L.dh2, ldh, ldh, (i / nt) * 16, (i % nt) * 16, H,
            o1 + (size_t)(i / nt) * 16 * H + (i % nt) * 16};
  i -= t1;
  const int to = d_out >> 4;
  return {L.h2, L.gb, ldh, ldo, (i / to) * 16, (i % to) * 16, d_out,
          o1 + (size_t)H * H + (size_t)(i / to) * 16 * d_out +
              (i % to) * 16};
}

// c[k] (two 16 x 8 accumulators each) += the products of tile t[k], for
// k < count, over the first `warps` warps' points, in warp order; the
// tiles' chains interleave.
template <int R>
__device__ __forceinline__ void dw_products(float (&c)[R][2][4],
                                            const DwTile (&t)[R], int count,
                                            const unsigned char* regions,
                                            size_t warp_bytes, int warps,
                                            int lane) {
  const int ra = (lane & 7) + ((lane >> 4) << 3), ca = ((lane >> 3) & 1) * 8;
  const int rb = lane & 15, cb = (lane >> 4) * 8;
  for (int w = 0; w < warps; ++w) {
    const unsigned char* r = regions + w * warp_bytes;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (k < count) {
        uint32_t a[4], b[4];
        // Act^T's A fragment: Act's 16 x 16 block transposed on the load
        ldsm_x4_t(a, (const bf16*)(r + t[k].act) + ra * t[k].lda + t[k].m0 +
                         ca);
        ldsm_x4_t(b, (const bf16*)(r + t[k].grad) + rb * t[k].ldb + t[k].n0 +
                         cb);
        mma16816(c[k][0], a, b[0], b[1]);
        mma16816(c[k][1], a, b[2], b[3]);
      }
    }
  }
}

// The accumulators of a tile at dst: (row g, g + 8; columns 2t, 2t + 1 of
// each 8-column half), added to what is there when `add`.
__device__ __forceinline__ void dw_store(float* dst, int cols,
                                         float (&c)[2][4], int lane,
                                         bool add) {
  float* p = dst + (lane >> 2) * cols + 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float2* top = reinterpret_cast<float2*>(p + h * 8);
    float2* bottom = reinterpret_cast<float2*>(p + 8 * cols + h * 8);
    float2 v0 = make_float2(c[h][0], c[h][1]);
    float2 v1 = make_float2(c[h][2], c[h][3]);
    if (add) {
      const float2 o0 = *top, o1 = *bottom;
      v0.x += o0.x; v0.y += o0.y; v1.x += o1.x; v1.y += o1.y;
    }
    *top = v0;
    *bottom = v1;
  }
}

template <int NT>  // hidden / 16
__global__ void __launch_bounds__(BWD_MAX_WARPS * 32, 1)
    mlp3_bwd_kernel(const float* __restrict__ X, int x_cols, bool x_vec,
                    const bf16* __restrict__ W0,
                    const bf16* __restrict__ W1,
                    const bf16* __restrict__ W2, int d_in, int d_out,
                    const float* __restrict__ g, bool g_vec,
                    float* __restrict__ dX, float* __restrict__ part,
                    long long n, bool resident) {
  constexpr int H = NT * 16, S = BWD_STAGES;
  constexpr int RT = NT <= 4 ? DW_REG_TILES : 1;  // register tiles a warp
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdLayout L = bwd_layout(d_in, H, d_out);
  bf16* w0 = (bf16*)(smem + L.w0);
  bf16* w1 = (bf16*)(smem + L.w1);
  bf16* w2 = (bf16*)(smem + L.w2);
  const int ldh = H + 8, ldo = d_out + 8, ldi = d_in + 8;
  const int ldx = L.ldx, ldg = L.ldg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  copy_weight(w0, W0, d_in, H);
  copy_weight(w1, W1, H, H);
  copy_weight(w2, W2, H, d_out);
  cp_async_commit();

  const unsigned char* regions = smem + L.fixed;
  unsigned char* mine = smem + L.fixed + warp * L.warp_bytes;
  float* xs = (float*)(mine + L.xs);
  float* gs = (float*)(mine + L.gs);
  bf16* xb = (bf16*)(mine + L.xb);
  bf16* h1 = (bf16*)(mine + L.h1);
  bf16* h2 = (bf16*)(mine + L.h2);
  bf16* gb = (bf16*)(mine + L.gb);
  bf16* dh2 = (bf16*)(mine + L.dh2);
  bf16* dh1 = (bf16*)(mine + L.dh1);
  const int n_tiles = ((d_in + H + d_out) >> 4) * NT;  // dW's 16 x 16 tiles
  float* mypart =
      part + (size_t)blockIdx.x * ((size_t)(d_in + H + d_out) * H);
  if (!resident)  // the partial takes every step's sums
    for (int i = threadIdx.x; i < (d_in + H + d_out) * H; i += blockDim.x)
      mypart[i] = 0.0f;
  // X's padding columns [x_cols, d_in) stay zero: no copy writes them.
  const int pad = d_in - x_cols;
  for (int e = lane; e < S * TILE_ROWS * pad; e += 32)
    xs[(e / pad) * ldx + x_cols + e % pad] = 0.0f;
  const XCopy cx = x_copy(x_cols, x_vec, lane), cg = x_copy(d_out, g_vec, lane);
  const long long tiles = (n + TILE_ROWS - 1) / TILE_ROWS;
  const long long step = (long long)gridDim.x * warps;
  auto stage = [&](int slot, long long tile) {
    stage_tile(xs + slot * TILE_ROWS * ldx, ldx, X, x_cols, cx,
               tile * TILE_ROWS, n);
    stage_tile(gs + slot * TILE_ROWS * ldg, ldg, g, d_out, cg,
               tile * TILE_ROWS, n);
  };
  const long long first = (long long)blockIdx.x * warps;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (first + warp + s * step < tiles) stage(s, first + warp + s * step);
    cp_async_commit();
  }
  cp_async_wait<S - 1>();  // this thread's weight copies
  __syncthreads();         // everyone's, and the zeroed partial

  // This warp's weight-gradient tiles warp, warp + warps, ...: in
  // registers for the whole launch where they number at most RT.
  float dw[RT][2][4];
  DwTile mine_dw[RT];
  const int owned = warp < n_tiles ? (n_tiles - warp + warps - 1) / warps : 0;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    zero_acc<1>(dw[r]);
    if (r < owned) mine_dw[r] = dw_tile(warp + r * warps, L, d_in, H, d_out);
  }

  int slot = 0;
  for (long long base = first; base < tiles; base += step) {
    const long long tile = base + warp;
    cp_async_wait<S - 2>();  // this tile's X and g
    __syncwarp();            // and every lane's; last tile's reads done
    const int refill = slot == 0 ? S - 1 : slot - 1;
    if (tile + (S - 1) * step < tiles) stage(refill, tile + (S - 1) * step);
    cp_async_commit();
    const float* xt = xs + slot * TILE_ROWS * ldx;
    const float* gt = gs + slot * TILE_ROWS * ldg;
    slot = slot + 1 == S ? 0 : slot + 1;

    if (tile < tiles) {
      uint32_t a[NT][4];
      float acc[2 * NT][4];
      // h1 = relu(X @ W0)
      zero_acc<NT>(acc);
      for (int k = 0; k < d_in; k += 16) {
        uint32_t ax[4];
        fp32_fragment(ax, xt, ldx, k, lane);
        store_fragment(xb, ldi, k, ax, lane);
        mma_row<NT>(acc, ax, w0, ldh, k, lane);
      }
      to_fragments<NT>(acc, a);
#pragma unroll
      for (int k = 0; k < NT; ++k) store_fragment(h1, ldh, k * 16, a[k], lane);
      // h2 = relu(h1 @ W1)
      zero_acc<NT>(acc);
#pragma unroll
      for (int k = 0; k < NT; ++k)
        mma_row<NT>(acc, a[k], w1, ldh, k * 16, lane);
      to_fragments<NT>(acc, a);
#pragma unroll
      for (int k = 0; k < NT; ++k) store_fragment(h2, ldh, k * 16, a[k], lane);
      // dh2 = (g @ W2^T) [h2 > 0], the mask from h2's fragments in a
      zero_acc<NT>(acc);
      for (int k = 0; k < d_out; k += 16) {
        uint32_t ag[4];
        fp32_fragment(ag, gt, ldg, k, lane);
        store_fragment(gb, ldo, k, ag, lane);
        mma_row_t<NT>(acc, ag, w2, ldo, k, lane);
      }
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        to_grad_fragment(a[k], acc[2 * k], acc[2 * k + 1], a[k]);
        store_fragment(dh2, ldh, k * 16, a[k], lane);
      }
      // dh1 = (dh2 @ W1^T) [h1 > 0], the mask read back from h1's tile
      zero_acc<NT>(acc);
#pragma unroll
      for (int k = 0; k < NT; ++k)
        mma_row_t<NT>(acc, a[k], w1, ldh, k * 16, lane);
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        uint32_t m[4];
        load_fragment(m, h1, ldh, k * 16, lane);
        to_grad_fragment(a[k], acc[2 * k], acc[2 * k + 1], m);
        store_fragment(dh1, ldh, k * 16, a[k], lane);
      }
      // dX = dh1 @ W0^T, 64 columns a pass, when asked
      if (dX != nullptr) {
        const long long row = tile * TILE_ROWS + (lane >> 2);
        for (int o0 = 0; o0 < d_in; o0 += 64) {
          float oc[8][4];
          zero_acc<4>(oc);
          const int nj = min(4, (d_in - o0) >> 4);
          const bf16* w = w0 + (size_t)o0 * ldh;
#pragma unroll
          for (int k = 0; k < NT; ++k) {
            switch (nj) {
              case 1: mma_row_t<1>(oc, a[k], w, ldh, k * 16, lane); break;
              case 2: mma_row_t<2>(oc, a[k], w, ldh, k * 16, lane); break;
              case 3: mma_row_t<3>(oc, a[k], w, ldh, k * 16, lane); break;
              default: mma_row_t<4>(oc, a[k], w, ldh, k * 16, lane); break;
            }
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = o0 + j * 8 + 2 * (lane & 3) + e;
              if (j < 2 * nj && col < x_cols) {
                if (row < n) dX[row * x_cols + col] = oc[j][e];
                if (row + 8 < n) dX[(row + 8) * x_cols + col] = oc[j][2 + e];
              }
            }
          }
        }
      }
    }
    __syncthreads();  // every warp's tiles written
    const int live = (int)min((long long)warps, tiles - base);
    if (resident) {
      dw_products(dw, mine_dw, owned, regions, L.warp_bytes, live, lane);
    } else {
      for (int i = warp; i < n_tiles; i += warps) {
        const DwTile t[1] = {dw_tile(i, L, d_in, H, d_out)};
        float c[1][2][4];
        zero_acc<1>(c[0]);
        dw_products(c, t, 1, regions, L.warp_bytes, live, lane);
        dw_store(mypart + t[0].dst, t[0].cols, c[0], lane, true);
      }
    }
    __syncthreads();  // every warp's tiles read
  }
  if (resident) {
#pragma unroll
    for (int r = 0; r < RT; ++r)
      if (r < owned)
        dw_store(mypart + mine_dw[r].dst, mine_dw[r].cols, dw[r], lane,
                 false);
  }
}

typedef void (*BwdKernel)(const float*, int, bool, const bf16*, const bf16*,
                          const bf16*, int, int, const float*, bool, float*,
                          float*, long long, bool);

template <int NT>
static BwdKernel bwd_kernels(int nt) {
  if constexpr (NT > MAX_HIDDEN / 16) {
    return nullptr;
  } else {
    return nt == NT ? mlp3_bwd_kernel<NT> : bwd_kernels<NT + 1>(nt);
  }
}

// K4b's plan for these widths on one device: kernel, warps per block (as
// many as shared memory holds, at most BWD_MAX_WARPS), shared bytes,
// blocks per SM, SMs, and whether dW stays in registers. As for K4f, the
// shared bytes (for one warp) and the limit are filled in where the widths
// do not fit.
struct BwdPlan {
  BwdKernel kernel;
  int warps, per_sm, sms;
  bool resident;
  size_t smem, limit;
};

static cudaError_t plan_bwd(int d_in, int hidden, int d_out, int dev,
                            BwdPlan* p) {
  *p = BwdPlan{nullptr, 0, 0, 0, false, 0, 0};
  if (!tile_width(d_in) || !tile_width(hidden) || !tile_width(d_out))
    return cudaErrorInvalidValue;
  const BwdLayout L = bwd_layout(d_in, hidden, d_out);
  p->smem = L.fixed + L.warp_bytes;
  cudaError_t err = card_limits(dev, &p->sms, &p->limit);
  if (err != cudaSuccess) return err;
  if (hidden > MAX_HIDDEN || p->smem > p->limit) return cudaErrorInvalidValue;
  p->warps = (int)((p->limit - L.fixed) / L.warp_bytes);
  if (p->warps > BWD_MAX_WARPS) p->warps = BWD_MAX_WARPS;
  p->smem = L.fixed + p->warps * L.warp_bytes;
  const int n_tiles = ((d_in + hidden + d_out) >> 4) * (hidden >> 4);
  p->resident = hidden <= 64 && n_tiles <= DW_REG_TILES * p->warps;
  p->kernel = bwd_kernels<1>(hidden / 16);
  if ((err = cudaFuncSetAttribute((const void*)p->kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)p->smem)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &p->per_sm, (const void*)p->kernel, p->warps * 32, p->smem)) !=
      cudaSuccess)
    return err;
  return p->per_sm < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// The most blocks a launch for these widths takes (the number of
// partials the caller provides) and the floats of one partial.
extern "C" int mlp3_bwd_workspace(int d_in, int hidden, int d_out,
                                  int* max_blocks, long long* total) {
  BwdPlan p;
  cudaError_t err = kept_plan(d_in, hidden, d_out, &p, plan_bwd);
  *max_blocks = p.sms * p.per_sm;
  *total = (long long)(d_in + hidden + d_out) * hidden;
  return (int)err;
}

// dW holds dW0, dW1, dW2 back to back (fp32); dX may be null; part holds
// part_blocks partials of mlp3_bwd_workspace's size.
extern "C" int mlp3_bwd(const float* X, int x_cols, const void* W0,
                        const void* W1, const void* W2, int d_in, int hidden,
                        int d_out, const float* g, float* dX, float* dW,
                        float* part, int part_blocks, long long n,
                        void* stream) {
  if (x_cols < 1 || x_cols > d_in) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)W0 | (uintptr_t)W1 | (uintptr_t)W2 | (uintptr_t)part) & 15)
    return (int)cudaErrorMisalignedAddress;
  BwdPlan p;
  cudaError_t err = kept_plan(d_in, hidden, d_out, &p, plan_bwd);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)(d_in + hidden + d_out) * hidden;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0)
    return (int)cudaMemsetAsync(dW, 0, (size_t)total * sizeof(float), s);
  const int blocks = persistent_blocks(p.sms, p.per_sm, p.warps, n);
  if (blocks > part_blocks) return (int)cudaErrorInvalidValue;
  const bool x_vec = x_cols % 4 == 0 && ((uintptr_t)X & 15) == 0;
  const bool g_vec = ((uintptr_t)g & 15) == 0;
  p.kernel<<<blocks, p.warps * 32, p.smem, s>>>(
      X, x_cols, x_vec, (const bf16*)W0, (const bf16*)W1, (const bf16*)W2,
      d_in, d_out, g, g_vec, dX, part, n, p.resident);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)sum_partials(part, blocks, total, dW, s);
}

// out[0..9): K4b's launch shape, as mlp3_fwd_shape's eight values, then 1
// where the weight gradients stay in registers.
extern "C" int mlp3_bwd_shape(int d_in, int hidden, int d_out, long long n,
                              int* out) {
  BwdPlan p;
  cudaError_t err = kept_plan(d_in, hidden, d_out, &p, plan_bwd);
  cudaFuncAttributes attr;
  attr.numRegs = 0;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, (const void*)p.kernel);
  out[0] =
      err == cudaSuccess ? persistent_blocks(p.sms, p.per_sm, p.warps, n) : 0;
  out[1] = p.warps * 32;
  out[2] = (int)p.smem;
  out[3] = p.per_sm;
  out[4] = attr.numRegs;
  out[5] = TILE_ROWS;
  out[6] = (int)p.limit;
  out[7] = MAX_HIDDEN;
  out[8] = p.resident;
  return (int)err;
}
