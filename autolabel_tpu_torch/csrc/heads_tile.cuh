// Block-tile machinery shared by the fused head kernels K3f (heads_fwd.cu)
// and K3b (heads_bwd.cu).
//
// A block of 8 warps owns a tile of M points (K3f: 128; K3b: 64; half
// that where the widest heads' tiles would not fit); warp w computes the
// rows of one 32-row group and a share of the 16-column slices of every
// 128-column pass (warp_tile). Every layer's activations live once per
// tile in shared memory as bf16 row-major tiles whose rows are padded by 8
// elements (16 bytes), so ldmatrix reads 8 rows from 8 different bank
// groups. Products run on the tensor cores as mma.sync m16n8k16 (bf16
// operands, fp32 accumulation), operands loaded from shared memory with
// ldmatrix; each epilogue takes its values straight from the accumulator
// registers, whose layout is fixed: thread (g = lane / 4, t = lane % 4)
// holds rows g and g + 8, columns 2t and 2t + 1 of each 16 x 8 tile.
//
// Weights never feed an MMA from device memory. The 14 packed matrices
// are cut into chunks of at most one stage and streamed through a ring of
// W_STAGES shared-memory stages with cp.async, two steps ahead, in the
// order the layers consume them (the schedule, built from the dims by one
// function on the host and in every block); each step costs one
// __syncthreads. Chunks of the first layer also stage the matching 64 fp32
// columns of A (or B) for the tile's points in a ring of two, one step
// ahead, so A is double-buffered too, and is rounded to bf16 in registers
// on its way into the MMA (8-byte shared loads, cvt.rn.bf16x2). The
// stream's cursors advance without divisions, and its copies use shifts
// where a row's 16-byte pieces are a power of two: at these kernels'
// short steps, that per-step arithmetic cost K3f about a fifth of its
// time (PERF.md).
#pragma once
#include "mma_ptx.cuh"

#define TILE_M 64                  // points per tile of K3b and dw_kernel
#define TILE_THREADS (TILE_M * 2)  // dw_kernel's blocks: 4 warps
#define HEAD_THREADS 256           // the fused kernels' blocks: 8 warps
#define W_STAGES 3                 // weight stages in the ring
#define COL_TILE 128               // output columns per accumulator pass
#define X_COLS 64                  // fp32 columns of A or B staged per step
#define X_LD (X_COLS + 8)          // their row pitch in floats
#define MAX_STEPS 4096             // schedule capacity (all supported widths)

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

// (rows, cols) of packed matrix m, stored row-major as (in, out).
__host__ __device__ __forceinline__ void weight_shape(const HeadsDims& d,
                                                      int m, int* rows,
                                                      int* cols) {
  const int shape[N_WEIGHTS][2] = {
      {d.Ap, d.H},  {d.Bw, d.H},  {d.H, d.H},   {d.H, d.Sw},  {d.Bw, d.Hc},
      {d.Sw, d.Hc}, {d.Hc, d.Hc}, {d.Hc, d.Rw}, {d.Sw, d.Hf}, {d.Hf, d.Hf},
      {d.Hf, d.Sp}, {d.Sp, d.Ho}, {d.Sw, d.Ho}, {d.Ho, d.Cp}};
  *rows = shape[m][0];
  *cols = shape[m][1];
}

// The widest layer that lands in a hidden-width tile.
__host__ __device__ __forceinline__ int heads_hidden(const HeadsDims& d) {
  int pq = d.H;
  if (d.Hc > pq) pq = d.Hc;
  if (d.Hf > pq) pq = d.Hf;
  if (d.Ho > pq) pq = d.Ho;
  if (d.Sp > pq) pq = d.Sp;
  return pq;
}

// Every width a multiple of 16, below 65,536 (the schedule's fields), and
// B no wider than one staged chunk.
static bool heads_dims_ok(const HeadsDims& d) {
  const int widths[] = {d.Ap, d.Bw, d.H, d.Sw, d.Hc, d.Rw, d.Hf, d.Sp,
                        d.Ho, d.Cp};
  for (int v : widths)
    if (v <= 0 || v % 16 != 0 || v >= 65536) return false;
  return d.a_cols <= d.Ap && d.b_cols <= d.Bw && d.Bw <= X_COLS &&
         d.Rw >= 4;
}

// A tile of m rows and `width` bf16 columns, rows padded by 8.
__host__ __device__ __forceinline__ size_t tile_bytes(int m, int width) {
  return round128((size_t)m * (width + 8) * sizeof(bf16));
}


// ------------------------------------------------------------ schedule

enum {
  STEP_T = 1,      // transposed product: out = X @ W^T
  STEP_X = 2,      // stages fp32 columns of A (WA) or B (WBs) beside W
  STEP_FIRST = 4,  // first chunk of an accumulator pass: zero it
  STEP_LAST = 8,   // last chunk of a pass: run the epilogue
  STEP_END = 16,   // last chunk of the layer
};

// One stage: rows [r0, r0 + rows) x cols [c0, c0 + cols) of matrix m
// (whose row pitch is `pitch`), copied to a stage with row pitch cols + 8,
// for layer `layer` of the kernel's program.
struct Step {
  uint8_t m, flags, layer;
  uint16_t r0, c0, rows, cols, pitch;
};

struct Sched {
  Step* out;  // null: count only
  int n;
  int slot_elems;  // bf16 elements of one weight stage
  HeadsDims d;
};

// Append the chunks of one layer: out = sum over its terms of X_t @ W_t
// (or X_t @ W_t^T), pass by pass of COL_TILE output columns; within a
// pass every term's chunks in order. `staged`: the terms' X come from A
// or B in device memory (the first layer).
__host__ __device__ inline void sched_layer(Sched& s, int layer, int m0,
                                            int m1, bool trans,
                                            bool staged) {
  int rows, cols;
  weight_shape(s.d, m0, &rows, &cols);
  const int n_out = trans ? rows : cols;
  const int terms[2] = {m0, m1};
  for (int c0 = 0; c0 < n_out; c0 += COL_TILE) {
    const int nc = n_out - c0 < COL_TILE ? n_out - c0 : COL_TILE;
    int kmax = trans ? s.slot_elems / nc - 8 : s.slot_elems / (nc + 8);
    kmax = kmax / 16 * 16;
    if (staged && kmax > X_COLS) kmax = X_COLS;
    bool first = true;
    for (int t = 0; t < 2 && terms[t] >= 0; ++t) {
      weight_shape(s.d, terms[t], &rows, &cols);
      const int k_dim = trans ? cols : rows;
      for (int k0 = 0; k0 < k_dim; k0 += kmax) {
        const int kr = k_dim - k0 < kmax ? k_dim - k0 : kmax;
        const bool last_k = k0 + kr >= k_dim && (t == 1 || m1 < 0);
        if (s.out) {
          Step& st = s.out[s.n];
          st.m = (uint8_t)terms[t];
          st.layer = (uint8_t)layer;
          st.flags = (uint8_t)((trans ? STEP_T : 0) |
                               (staged ? STEP_X : 0) |
                               (first ? STEP_FIRST : 0) |
                               (last_k ? STEP_LAST : 0) |
                               (last_k && c0 + nc >= n_out ? STEP_END : 0));
          st.r0 = (uint16_t)(trans ? c0 : k0);
          st.c0 = (uint16_t)(trans ? k0 : c0);
          st.rows = (uint16_t)(trans ? nc : kr);
          st.cols = (uint16_t)(trans ? kr : nc);
          st.pitch = (uint16_t)cols;
        }
        ++s.n;
        first = false;
      }
    }
  }
}

// ------------------------------------------------------------ bf16 pairs

__device__ __forceinline__ void store_pair(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// ------------------------------------------------------------ stream

// The block's weight (and first-layer input) stream. Weight chunks go
// through a ring of W_STAGES stages, issued two steps ahead; staged fp32
// columns of A or B through a ring of two, issued one step ahead. All
// threads issue the copies and all wait, so the stream advances in lock
// step with the block's one __syncthreads per step.
struct Stream {
  const Step* sched;
  int nsteps;
  const bf16* const* wtab;  // the 14 matrices (a table in shared memory)
  HeadsDims d;
  const float* A;
  const float* B;
  bool a_vec, b_vec;  // rows 16-byte aligned: 16-byte copies
  long long n;
  int m;       // points per tile
  bf16* wst;   // weight stage 0; stage k at wst + k * w_pitch
  int w_pitch;
  float* xst;  // staged columns 0; stage 1 at xst + x_pitch
  int x_pitch;
  int i, k;  // the next step to compute and its schedule entry
  // The next step whose staged columns (x) and weights (w) go in flight:
  // its number, schedule entry and tile's first row, advanced by one step
  // per copy (no divisions on the way).
  struct Cursor {
    int j, k;
    long long row;
  } x, w;
};

__device__ __forceinline__ Stream::Cursor advance(const Stream& s,
                                                  Stream::Cursor* c) {
  const Stream::Cursor now = *c;
  ++c->j;
  if (++c->k == s.nsteps) {
    c->k = 0;
    c->row += (long long)gridDim.x * s.m;
  }
  return now;
}

// Copy rows x per_row pieces, piece (r, c) by copy(r, c), spread over the
// block's threads: one division per call, none per piece, and none at all
// with POW2 where per_row is a power of two (the stream's copies, every
// step).
template <bool POW2 = false, class Copy>
__device__ __forceinline__ void block_copy(int rows, int per_row,
                                           Copy copy) {
  if (POW2 && (per_row & (per_row - 1)) == 0 &&
      per_row <= (int)blockDim.x) {
    const int sh = __ffs(per_row) - 1;
    const int c = threadIdx.x & (per_row - 1), dr = blockDim.x >> sh;
    for (int r = threadIdx.x >> sh; r < rows; r += dr) copy(r, c);
    return;
  }
  const int dr = blockDim.x / per_row, dc = blockDim.x % per_row;
  int r = threadIdx.x / per_row, c = threadIdx.x % per_row;
  while (r < rows) {
    copy(r, c);
    r += dr;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// Stage rows [row0, row0 + m) x cols [k0, k0 + kr) of src (n x src_cols
// fp32) into dst (pitch X_LD), zeros outside src.
__device__ __forceinline__ void stage_x(float* dst, const float* src,
                                        int src_cols, bool vec,
                                        long long row0, int m, long long n,
                                        int k0, int kr) {
  if (vec) {
    block_copy<true>(m, kr >> 2, [&](int r, int c4) {
      const int c = k0 + c4 * 4;
      const bool ok = row0 + r < n && c < src_cols;
      cp_async16(dst + r * X_LD + c4 * 4,
                 ok ? src + (row0 + r) * src_cols + c : src, ok);
    });
  } else {
    block_copy(m, kr, [&](int r, int c1) {
      const int c = k0 + c1;
      const bool ok = row0 + r < n && c < src_cols;
      cp_async4(dst + r * X_LD + c1,
                ok ? src + (row0 + r) * src_cols + c : src, ok);
    });
  }
}

// Stage rows [row0, row0 + m) of src (n x width fp32, rows 16-byte
// aligned, width a multiple of 4) into dst (pitch width), rows past n
// zero; completes with the stream's next cp.async group.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int width, long long row0, int m,
                                           long long n) {
  block_copy(m, width >> 2, [&](int r, int c4) {
    const bool ok = row0 + r < n;
    cp_async16(dst + r * width + c4 * 4,
               ok ? src + (row0 + r) * width + c4 * 4 : src, ok);
  });
}

// One cp.async group each: the weight chunk of step j into stage
// j % W_STAGES, and the staged columns of step j (if any) into j % 2.
__device__ __forceinline__ void issue_w(Stream& s) {
  const Stream::Cursor c = advance(s, &s.w);
  if (c.row < s.n) {
    const Step st = s.sched[c.k];
    const bf16* src = s.wtab[st.m] + (size_t)st.r0 * st.pitch + st.c0;
    bf16* dst = s.wst + (c.j % W_STAGES) * s.w_pitch;
    const int ld = st.cols + 8;
    block_copy<true>(st.rows, st.cols >> 3, [&](int r, int c8) {
      cp_async16(dst + r * ld + c8 * 8, src + (size_t)r * st.pitch + c8 * 8,
                 true);
    });
  }
  cp_async_commit();
}

__device__ __forceinline__ void issue_x(Stream& s) {
  const Stream::Cursor c = advance(s, &s.x);
  const Step st = s.sched[c.k];
  if (c.row < s.n && (st.flags & STEP_X)) {
    const bool is_a = st.m == WA;
    stage_x(s.xst + (c.j & 1) * s.x_pitch, is_a ? s.A : s.B,
            is_a ? s.d.a_cols : s.d.b_cols, is_a ? s.a_vec : s.b_vec, c.row,
            s.m, s.n, st.r0, st.rows);
  }
  cp_async_commit();
}

// A block's stream over its tiles: the schedule, the weight table and the
// stages at the given shared-memory offsets; the first chunks go in
// flight. Every thread of the block calls it.
__device__ __forceinline__ Stream stream_start(
    unsigned char* smem, size_t sched_off, size_t wtab_off, size_t w_off,
    size_t w_bytes, size_t x_off, size_t x_bytes, int nsteps,
    const HeadsWeights& w, const HeadsDims& d, const float* A,
    const float* B, bool a_vec, bool b_vec, long long n, int m) {
  const bf16** wtab = (const bf16**)(smem + wtab_off);
  if (threadIdx.x < N_WEIGHTS) wtab[threadIdx.x] = w.m[threadIdx.x];
  __syncthreads();
  Stream s = {(const Step*)(smem + sched_off), nsteps, wtab, d, A, B,
              a_vec, b_vec, n, m, (bf16*)(smem + w_off),
              (int)(w_bytes / sizeof(bf16)), (float*)(smem + x_off),
              (int)(x_bytes / sizeof(float)), 0, 0};
  s.x = s.w = {0, 0, (long long)blockIdx.x * m};
  issue_x(s);  // step 0
  issue_w(s);  // steps 0 and 1
  issue_w(s);
  return s;
}

// Wait for the current step's stages (every group but the newest, which
// holds the weights of the step after next), let every warp past the
// previous step, start the following copies, and return the current step.
__device__ __forceinline__ Step stream_next(Stream& s, const bf16** wst,
                                            const float** xst) {
  cp_async_wait_group1();
  __syncthreads();
  issue_x(s);
  issue_w(s);
  *wst = s.wst + (s.i % W_STAGES) * s.w_pitch;
  *xst = s.xst + (s.i & 1) * s.x_pitch;
  const Step st = s.sched[s.k];
  if (++s.k == s.nsteps) s.k = 0;
  ++s.i;
  return st;
}

// A layer's input for one matrix: a bf16 tile (pitch ld) in shared memory.
struct Src {
  const bf16* x;
  int ld;
};

// A warp's accumulators: two 16-row MMA tiles of its 32-row group, by
// up to eight 8-column tiles of its share of a COL_TILE pass.
typedef float Acc[2][COL_TILE / 16][4];

// The warps of a block of m-point tiles share each 32-row group: warp w
// computes rows [row0, row0 + 32) and, of each pass, the 16-column slices
// jp = part, part + parts, ... Every B fragment it loads feeds two MMAs.
struct WarpTile {
  int row0, part, parts;
};

__device__ __forceinline__ WarpTile warp_tile(int m) {
  const int warp = threadIdx.x >> 5, parts = (blockDim.x >> 5) / (m >> 5);
  return {(warp / parts) * 32, warp % parts, parts};
}

// acc += X[warp rows, kk0 : kk0 + kr] @ chunk for this warp's NS 16-column
// slices jp = h, h + 2, ... of the chunk: TRANS (the chunk holds W^T's
// rows, read by ldmatrix without .trans), F32 (X is the fp32 staged
// columns, rounded to bf16 in registers). Compile-time shapes keep the
// loop free of branches around the warp-synchronous ldmatrix and mma.
template <bool TRANS, bool F32, int NS>
__device__ __forceinline__ void mma_slices(Acc& acc, const bf16* x, int ldx,
                                           const float* xf, int kr,
                                           const bf16* wst, int ldw,
                                           const WarpTile& wt) {
  const int lane = threadIdx.x & 31, row0 = wt.row0;
  const int g = lane >> 2, t = lane & 3;
  for (int kk = 0; kk < kr; kk += 16) {
    uint32_t a[2][4], b[NS][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = row0 + mt * 16;
      if (F32) {
        const float* p = xf + (r + g) * X_LD + kk + 2 * t;
        const float2 v0 = *reinterpret_cast<const float2*>(p);
        const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * X_LD);
        const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
        const float2 v3 =
            *reinterpret_cast<const float2*>(p + 8 * X_LD + 8);
        a[mt][0] = pack_bf16(v0.x, v0.y);
        a[mt][1] = pack_bf16(v1.x, v1.y);
        a[mt][2] = pack_bf16(v2.x, v2.y);
        a[mt][3] = pack_bf16(v3.x, v3.y);
      } else {
        ldsm_x4(a[mt], x + (r + (lane & 15)) * ldx + kk + (lane >> 4) * 8);
      }
    }
#pragma unroll
    for (int jl = 0; jl < NS; ++jl) {
      const int jp = wt.parts * jl + wt.part;
      if (TRANS)
        ldsm_x4(b[jl], wst + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * ldw +
                           kk + ((lane >> 3) & 1) * 8);
      else
        ldsm_x4_t(b[jl],
                  wst + (kk + (lane & 15)) * ldw + jp * 16 + (lane >> 4) * 8);
    }
#pragma unroll
    for (int jl = 0; jl < NS; ++jl) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma16816(acc[mt][2 * jl], a[mt], b[jl][0], b[jl][1]);
        mma16816(acc[mt][2 * jl + 1], a[mt], b[jl][2], b[jl][3]);
      }
    }
  }
}

template <bool TRANS, bool F32>
__device__ __forceinline__ void mma_ns(Acc& acc, const bf16* x, int ldx,
                                       const float* xf, int kr,
                                       const bf16* wst, int ldw, int nc,
                                       const WarpTile& wt) {
  const int slices = nc >> 4;  // this warp's share of them:
  switch (slices > wt.part ? (slices - wt.part + wt.parts - 1) / wt.parts
                           : 0) {
    case 1: mma_slices<TRANS, F32, 1>(acc, x, ldx, xf, kr, wst, ldw, wt); break;
    case 2: mma_slices<TRANS, F32, 2>(acc, x, ldx, xf, kr, wst, ldw, wt); break;
    case 3: mma_slices<TRANS, F32, 3>(acc, x, ldx, xf, kr, wst, ldw, wt); break;
    case 4: mma_slices<TRANS, F32, 4>(acc, x, ldx, xf, kr, wst, ldw, wt); break;
    default: break;
  }
}

// acc += X[warp rows, k0 : k0 + kr] @ chunk, the chunk a weight stage of
// pitch ldw: (kr x nc) for a plain product, (nc x kr) for a transposed
// one. X is a bf16 tile, or (xf != null) the fp32 staged columns.
__device__ __forceinline__ void mma_chunk(Acc& acc, const Src& x,
                                          const float* xf, int k0, int kr,
                                          const bf16* wst, int ldw, int nc,
                                          bool trans, const WarpTile& wt) {
  if (trans)
    mma_ns<true, false>(acc, x.x + k0, x.ld, nullptr, kr, wst, ldw, nc, wt);
  else if (xf)
    mma_ns<false, true>(acc, nullptr, 0, xf, kr, wst, ldw, nc, wt);
  else
    mma_ns<false, false>(acc, x.x + k0, x.ld, nullptr, kr, wst, ldw, nc, wt);
}

// One step's products: zero the accumulators on a pass's first chunk,
// round the first layer's B chunk into xb (bf16, pitch ldb) for the later
// layers that read B, and add the chunk's MMAs. x: the layer's input for
// matrix st.m (unused where the step stages its input). Every step starts
// with a block-wide barrier, so a layer may read rows and columns that
// other warps wrote.
__device__ __forceinline__ void step_mma(Acc& acc, const Step& st,
                                         const Src& x, const bf16* wst,
                                         const float* xst, bf16* xb, int ldb,
                                         int m, const WarpTile& wt) {
  const bool trans = st.flags & STEP_T;
  const int k0 = trans ? st.c0 : st.r0, kr = trans ? st.cols : st.rows;
  const int nc = trans ? st.rows : st.cols;
  if (st.flags & STEP_FIRST) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < COL_TILE / 16; ++j)
        acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.0f;
  }
  const float* xf = nullptr;
  if (st.flags & STEP_X) {
    xf = xst;
    if (st.m == WBs && xb) {
      block_copy(m, kr >> 1, [&](int r, int c2) {
        const float2 v =
            *reinterpret_cast<const float2*>(xf + r * X_LD + 2 * c2);
        store_pair(xb + r * ldb + k0 + 2 * c2, v.x, v.y);
      });
    }
  }
  mma_chunk(acc, x, xf, xf ? 0 : k0, kr, wst, st.cols + 8, nc, trans, wt);
}

// A pass's epilogue: op(row, col, v0, v1) on this thread's accumulator
// pairs (row: tile row; col: even output column of the layer, v1 at col +
// 1), straight from the registers.
template <class Op>
__device__ __forceinline__ void epilogue(const Acc& acc, const Step& st,
                                         const WarpTile& wt, Op op) {
  const bool trans = st.flags & STEP_T;
  const int out0 = trans ? st.r0 : st.c0, nc = trans ? st.rows : st.cols;
  const int lane = threadIdx.x & 31, row0 = wt.row0;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int jl = 0; jl < COL_TILE / 32; ++jl) {
    const int jp = wt.parts * jl + wt.part;
    if (jp * 16 < nc) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int r = row0 + mt * 16 + g;
          const int c = out0 + jp * 16 + q * 8 + 2 * t;
          const float(&v)[4] = acc[mt][2 * jl + q];
          op(r, c, v[0], v[1]);
          op(r + 8, c, v[2], v[3]);
        }
      }
    }
  }
}

// The most dynamic shared memory a block may opt in to.
static cudaError_t smem_optin(int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(optin,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// The launch shape of a persistent kernel with tiles of m points and
// blocks of `threads`: blocks (as many as stay resident, at most one per
// tile) and blocks per SM. Opts the kernel in to its dynamic shared memory.
static cudaError_t tile_shape(const void* kernel, size_t smem, int m,
                              int threads, long long n, int* blocks,
                              int* per_sm) {
  cudaError_t err;
  int dev = 0, sms = 0, optin = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = smem_optin(&optin)) != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           (int)smem)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (n + m - 1) / m;
  const long long b = (long long)sms * *per_sm;
  *blocks = (int)(tiles < b ? (tiles > 0 ? tiles : 1) : b);
  return cudaSuccess;
}

// Fill out[0..6) with a kernel's launch shape: blocks, threads, dynamic
// shared bytes, blocks per SM, registers per thread, schedule steps.
static cudaError_t shape_report(const void* kernel, int blocks, int threads,
                                size_t smem, int per_sm, int steps,
                                int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[0] = blocks;
  out[1] = threads;
  out[2] = (int)smem;
  out[3] = per_sm;
  out[4] = attr.numRegs;
  out[5] = steps;
  return cudaSuccess;
}

static bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}
