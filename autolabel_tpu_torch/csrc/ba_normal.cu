// Bundle adjustment's Levenberg-Marquardt products and its conjugate-
// gradient solve (K9).
//
// Replaces what XLA compiles on the TPU for autolabel_tpu/mapping/ba.py
// `_lm_step` (:80-99): the residuals of every observation and the
// gradient J^T r (the vjp of `_residual`, :63-69), and the solve of the
// damped normal equations by jax.scipy.sparse.linalg.cg (:94-95), a device
// while-loop whose every iteration takes the damped normal product
// (J^T J + lam I) v (a jvp, then the same vjp). `_cost` and
// `_huber_sqrt_weights` take entry 1 without the gradient.
//
// The parameters are one flat fp32 vector of L = 6 M + 3 P + 1 values: the
// M cameras' Rodrigues vectors (3 M), their translations (3 M), the P
// points (3 P) and the log focal scale (1). `_mask_gauge` holds camera 0
// and, unless refine_focal, the focal scale fixed: their entries of the
// gradient and of the product are 0, and a masked v entry is read as 0.
//
// The Jacobian is analytic. For observation n of camera c and point p,
// Xc = R_c X_p + t_c, z = max(Xc_z, 1e-6), (u, v) = (Xc_x, Xc_y) / z,
// fx = fx0 exp(dlog_f) and fy likewise:
//   d pred / d Xc = diag(fx, fy) [[1/z, 0, -u/z dz], [0, 1/z, -v/z dz]],
// dz = 1 where Xc_z > 1e-6, 0 where the clamp holds, 1/2 at a tie (the
// gradient jnp.maximum and torch.maximum pass); d Xc / d rvec_c is
// dR/drvec_c X_p, with dR/drvec (M x 3 x 3 x 3, [c][i][j][k] =
// dR_ij / drvec_k) computed once per LM step by the caller; d Xc / d t_c is
// I, d Xc / d X_p is R_c; d pred / d dlog_f = (u fx, v fy). Each residual
// row carries sqrt_w. One pair of device functions computes J_n v
// (`forward`) and J_n^T e (`transpose`) for all three entries.
//
// Entries 1 and 2 (the residual and gradient; one damped product): a
// thread per observation, 256 a block. A point takes 3 atomics an
// observation; a camera's 6 sums go through a segmented inclusive scan over
// the warp (segments of equal camera, found by ballot, correct in any
// order), whose last lane a segment issues the camera's atomics. The focal
// scale's terms and the cost's are summed over the block and written one a
// block; a one-block kernel sums the focal's in a fixed order. (An atomic
// a block adds 1,407 partials in sequence at N = 360,000: on the H100 that
// gave the focal entry 4 times the plain version's fp32 error.) Entry 1
// zeroes the gradient first (a memset); entry 2 first writes lam * masked
// v (`damp_kernel`), then adds J^T J v.
//
// Entry 3 (the solve): one persistent cooperative kernel of 512-thread
// blocks, its grid every block the device holds resident, runs jax.scipy's
// rule with grid barriers between its phases and no host in the loop.
// x0 = 0, r0 = b (A(0) is exactly 0), q0 = b; an iteration is
//   q: q_k = r + beta q_{k-1}, each entry by its owner (k > 0); | barrier
//   product: each warp takes 32-observation tiles of its block's
//     contiguous range of the camera-sorted observations and stores,
//     without atomics, each observation's 3 point terms and each camera
//     run's 6 sums at the run's last lane; the focal's terms summed a
//     block;                                                     | barrier
//   gather: a thread a point coordinate sums its observations' terms in
//     ascending order (a point CSR built once a bundle adjustment), a warp
//     a camera its runs' sums (every n = 31 mod 32 inside the camera's
//     range, and its last), the focal entry its blocks' sums in block
//     order; + lam q_k, masked; the blocks' sums of q_k . Aq a leaf;
//                                                                 | barrier
//   update: alpha = gamma / q_k . Aq; x, r updated; the blocks' sums of
//     r . r a leaf;                                                | barrier
// and the next iteration's head reads gamma' from those sums. A dot is
// _vdot_tree's: a sum a leaf (rvecs, tvecs, points, dlog_f), each over the
// blocks' sums by a fixed tree (thread t of every block holds block t's),
// then the leaves in order; every block reads the same sums in the same
// order, so every block takes the same stopping decision, and the solve is
// the same bit for bit from run to run. (Recomputing q_k where the
// product reads it would save the first barrier, but the product would
// then read r and q_{k-1} at every gathered entry: on the H100 that was
// the slower design.) Why no atomics and no host: on the H100 at M = 300,
// P = 40,000, N = 360,000, a product whose points took atomics spent 39%
// of its time on them (0.0096 of 0.0245 ms), and a CG loop of torch
// launches around a product kernel took ~30 launches an iteration and
// 39-64 ms of wall an LM step for 4.5 ms of device work.
//
// What bounds it. Counted once, a product must read the observations'
// indices and weights (12 bytes each, 20 with the observed pixels), the
// points, the cameras' R, dR and t, v, and write the output: at M = 300
// cameras, P = 40,000 points and N = 360,000 observations about 6 MB for
// the matvec and 12 MB for the residual and gradient, 2 to 4 us on the
// H100's 3.35 TB/s; a CG iteration adds its passes over the L-vectors.
// The arithmetic (about 200 fp32 operations an observation) is far below
// the card's rate.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#define BA_THREADS 256
#define BA_WARPS (BA_THREADS / 32)
#define Z_MIN 1e-6f

namespace {

struct Intr {
  float fx0, fy0, cx, cy;
};

// One observation's linearisation point.
struct Obs {
  int c, p;       // camera and point, c = -1 for a lane past N
  bool live;
  float X[3];     // the point
  float z, u, v;  // clamped depth and normalised coordinates
  float dz;       // the gradient the clamp passes: 1, 1/2 at a tie, or 0
  float fx, fy, w;
};

__device__ __forceinline__ Obs load_obs(long long n, long long N,
                                        const float* R, const float* t,
                                        const float* X, float scale,
                                        Intr in, const int* cam,
                                        const int* pt, const float* sw) {
  Obs o;
  o.live = n < N;
  o.c = o.live ? cam[n] : -1;
  o.p = o.live ? pt[n] : -1;
  o.fx = in.fx0 * scale;
  o.fy = in.fy0 * scale;
  if (!o.live) {
    o.X[0] = o.X[1] = o.X[2] = 0.f;
    o.z = 1.f;
    o.u = o.v = o.dz = o.w = 0.f;
    return o;
  }
  const float* Rc = R + 9 * o.c;
  for (int q = 0; q < 3; ++q) o.X[q] = X[3 * o.p + q];
  float xc[3];
  for (int i = 0; i < 3; ++i)
    xc[i] = Rc[3 * i] * o.X[0] + Rc[3 * i + 1] * o.X[1]
            + Rc[3 * i + 2] * o.X[2] + t[3 * o.c + i];
  o.z = fmaxf(xc[2], Z_MIN);
  o.dz = xc[2] > Z_MIN ? 1.f : (xc[2] == Z_MIN ? 0.5f : 0.f);
  o.u = xc[0] / o.z;
  o.v = xc[1] / o.z;
  o.w = sw[n];
  return o;
}

// dR/drvec_k X for k = 0..2: A[k][i] = sum_j dR[c][i][j][k] X_j.
__device__ __forceinline__ void rot_tangents(const float* dR, const Obs& o,
                                             float A[3][3]) {
  const float* d = dR + 27 * o.c;
  for (int k = 0; k < 3; ++k)
    for (int i = 0; i < 3; ++i)
      A[k][i] = d[(3 * i) * 3 + k] * o.X[0] + d[(3 * i + 1) * 3 + k] * o.X[1]
                + d[(3 * i + 2) * 3 + k] * o.X[2];
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// The block's sum of x (WARPS warps), valid in thread 0.
template <int WARPS = BA_WARPS>
__device__ __forceinline__ float block_sum(float x, float* shared) {
  x = warp_sum(x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) shared[warp] = x;
  __syncthreads();
  x = threadIdx.x < WARPS ? shared[threadIdx.x] : 0.f;
  if (warp == 0) x = warp_sum(x);
  return x;
}

// A segmented inclusive scan of vals[0..5] over the warp's runs of equal
// key: afterwards the last lane of each run holds the run's sums, and the
// call returns true in that lane (never where key < 0). The order of the
// adds is fixed by the lanes' keys alone.
__device__ __forceinline__ bool segment_sums(int key, float vals[6]) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(full, key, 1);
  const unsigned heads = __ballot_sync(full, lane == 0 || prev != key);
  const int start = 31 - __clz(heads & (full >> (31 - lane)));
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const float o = __shfl_up_sync(full, vals[q], off);
      if (lane - off >= start) vals[q] += o;
    }
  }
  const int next = __shfl_down_sync(full, key, 1);
  return (lane == 31 || next != key) && key >= 0;
}

// Adds vals[0..5] to camera `key`'s rvec (g_r) and translation (g_t)
// entries: the last lane of each run of the segmented scan issues 6
// atomics. key < 0 adds nothing.
__device__ __forceinline__ void camera_add(float* g_r, float* g_t, int key,
                                           float vals[6]) {
  if (segment_sums(key, vals)) {
    for (int q = 0; q < 3; ++q) {
      atomicAdd(g_r + 3 * key + q, vals[q]);
      atomicAdd(g_t + 3 * key + q, vals[3 + q]);
    }
  }
}

// J_n v without the weight, from v's entries of the observation's point
// (vp), camera (vr, vt: read only for a camera that is not the gauge's)
// and focal scale (vf, read only with refine_focal).
__device__ __forceinline__ void forward(const Obs& o, const float* Rc,
                                        const float A[3][3],
                                        const float vp[3], const float vr[3],
                                        const float vt[3], float vf,
                                        int refine_focal, float& j0,
                                        float& j1) {
  float d[3];
  for (int i = 0; i < 3; ++i)
    d[i] = Rc[3 * i] * vp[0] + Rc[3 * i + 1] * vp[1] + Rc[3 * i + 2] * vp[2];
  if (o.c > 0) {
    for (int i = 0; i < 3; ++i)
      d[i] += A[0][i] * vr[0] + A[1][i] * vr[1] + A[2][i] * vr[2] + vt[i];
  }
  j0 = o.fx * (d[0] - o.u * o.dz * d[2]) / o.z;
  j1 = o.fy * (d[1] - o.v * o.dz * d[2]) / o.z;
  if (refine_focal) {
    j0 += o.u * o.fx * vf;
    j1 += o.v * o.fy * vf;
  }
}

// J_n^T e for e = w * (c0, c1): the point's 3 terms (R_c^T gx, zero in a
// lane past N), the camera's 6 ((dR/drvec X)^T gx, then gx) and the focal
// scale's (returned).
__device__ __forceinline__ float transpose(const Obs& o, const float* R,
                                           const float A[3][3], float c0,
                                           float c1, float pt[3],
                                           float cam[6]) {
  const float e0 = o.w * c0, e1 = o.w * c1;
  float gx[3];
  gx[0] = o.fx * e0 / o.z;
  gx[1] = o.fy * e1 / o.z;
  gx[2] = -(gx[0] * o.u + gx[1] * o.v) * o.dz;
  for (int k = 0; k < 3; ++k)
    cam[k] = A[k][0] * gx[0] + A[k][1] * gx[1] + A[k][2] * gx[2];
  for (int q = 0; q < 3; ++q) cam[3 + q] = gx[q];
  if (o.live) {
    const float* Rc = R + 9 * o.c;
    for (int j = 0; j < 3; ++j)
      pt[j] = Rc[j] * gx[0] + Rc[3 + j] * gx[1] + Rc[6 + j] * gx[2];
  } else {
    pt[0] = pt[1] = pt[2] = 0.f;
  }
  return e0 * o.u * o.fx + e1 * o.v * o.fy;
}

// Scatters J_n^T e with atomics: the point's 3 entries, the camera's 6
// (unless camera 0) by camera_add; returns the focal scale's term.
__device__ __forceinline__ float scatter(const Obs& o, const float* R,
                                         const float A[3][3], float c0,
                                         float c1, int m, float* g) {
  float pt[3], cam[6];
  const float gf = transpose(o, R, A, c0, c1, pt, cam);
  if (o.live) {
    float* gp = g + 6 * m + 3 * o.p;
    for (int j = 0; j < 3; ++j) atomicAdd(gp + j, pt[j]);
  }
  camera_add(g, g + 3 * m, o.c > 0 ? o.c : -1, cam);
  return gf;
}

__global__ void __launch_bounds__(BA_THREADS)
residual_grad_kernel(const float* R, const float* dR, const float* t,
                     const float* X, const float* dlog_f, Intr in,
                     const int* cam, const int* pt, const float* xy,
                     const float* sw, long long N, int m, int p,
                     int refine_focal, int want_grad, float* r,
                     float* partials, float* focal_partials, float* g) {
  __shared__ float shared[BA_WARPS];
  const long long n = (long long)blockIdx.x * BA_THREADS + threadIdx.x;
  const Obs o = load_obs(n, N, R, t, X, expf(dlog_f[0]), in, cam, pt, sw);
  float r0 = 0.f, r1 = 0.f;
  if (o.live) {
    r0 = (o.u * o.fx + in.cx - xy[2 * n]) * o.w;
    r1 = (o.v * o.fy + in.cy - xy[2 * n + 1]) * o.w;
    r[2 * n] = r0;
    r[2 * n + 1] = r1;
  }
  const float cost = block_sum(r0 * r0 + r1 * r1, shared);
  if (threadIdx.x == 0) partials[blockIdx.x] = cost;
  if (!want_grad) return;
  float A[3][3] = {{0.f}};
  if (o.live) rot_tangents(dR, o, A);
  const float gf = scatter(o, R, A, r0, r1, m, g);
  if (refine_focal) {
    __syncthreads();  // `shared` is reused
    const float s = block_sum(gf, shared);
    if (threadIdx.x == 0) focal_partials[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(BA_THREADS)
matvec_kernel(const float* R, const float* dR, const float* t,
              const float* X, const float* dlog_f, Intr in, const int* cam,
              const int* pt, const float* sw, long long N, int m, int p,
              int refine_focal, const float* vec, float* focal_partials,
              float* out) {
  __shared__ float shared[BA_WARPS];
  const long long n = (long long)blockIdx.x * BA_THREADS + threadIdx.x;
  const Obs o = load_obs(n, N, R, t, X, expf(dlog_f[0]), in, cam, pt, sw);
  float A[3][3] = {{0.f}};
  float j0 = 0.f, j1 = 0.f;  // J_n v without the weight
  if (o.live) {
    rot_tangents(dR, o, A);
    float vp[3], vr[3] = {0.f, 0.f, 0.f}, vt[3] = {0.f, 0.f, 0.f};
    for (int q = 0; q < 3; ++q) vp[q] = vec[6 * m + 3 * o.p + q];
    if (o.c > 0) {
      for (int q = 0; q < 3; ++q) {
        vr[q] = vec[3 * o.c + q];
        vt[q] = vec[3 * m + 3 * o.c + q];
      }
    }
    forward(o, R + 9 * o.c, A, vp, vr, vt,
            refine_focal ? vec[6 * m + 3 * p] : 0.f, refine_focal, j0, j1);
  }
  const float gf = scatter(o, R, A, o.w * j0, o.w * j1, m, out);
  if (refine_focal) {
    const float s = block_sum(gf, shared);
    if (threadIdx.x == 0) focal_partials[blockIdx.x] = s;
  }
}

// *out += the sum of n partials, in a fixed order: thread i sums partials
// i, i + 1024, ... in turn, then the block's tree.
__global__ void __launch_bounds__(1024)
focal_sum_kernel(const float* partials, int n, float* out) {
  __shared__ float shared[32];
  float x = 0.f;
  for (int i = threadIdx.x; i < n; i += 1024) x += partials[i];
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) shared[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x < 32) {
    x = warp_sum(shared[threadIdx.x]);
    if (threadIdx.x == 0) *out += x;
  }
}

// out = lam * v with the gauge's entries (and the focal scale's unless
// refine_focal) zero.
__global__ void damp_kernel(const float* vec, float lam, long long L, int m,
                            int refine_focal, float* out) {
  const long long i = (long long)blockIdx.x * BA_THREADS + threadIdx.x;
  if (i >= L) return;
  const bool masked = i < 3 || (i >= 3 * m && i < 3 * m + 3)
                      || (i == L - 1 && !refine_focal);
  out[i] = masked ? 0.f : lam * vec[i];
}

// ---- Entry 3: the LM step's conjugate-gradient solve, one cooperative
// kernel (see the head of the file).

#define SOLVE_THREADS 512
#define SOLVE_WARPS (SOLVE_THREADS / 32)
#define GATHER_BATCH 8

struct Solve {
  const float *R, *dR, *t, *X, *dlog_f;
  Intr in;
  const int *cam, *pt;
  const float* sw;
  long long N, L;
  int m, p, refine_focal, maxiter;
  float lam, tol2;
  const int *cam_start, *pt_start, *pt_obs;
  const float* b;
  float *x, *r, *q0, *q1, *Aq;
  float* obs_pt;   // N x 3
  float* obs_cam;  // N x 6 (a camera run's last lane)
  float4 *part_qAq, *part_rr;  // gridDim.x: a block's sum a leaf
  float* part_f;               // gridDim.x: a block's focal term
  int* k_out;
};

// Adds v to acc[leaf] without indexing the array by a variable (which
// would put it in local memory).
__device__ __forceinline__ void add_leaf(float acc[4], int leaf, float v) {
#pragma unroll
  for (int l = 0; l < 4; ++l)
    if (leaf == l) acc[l] += v;
}

// Which of _vdot_tree's leaves (rvecs, tvecs, points, dlog_f) entry i is.
__device__ __forceinline__ int leaf_of(long long i, const Solve& s) {
  return i < 3 * s.m ? 0 : i < 6 * s.m ? 1 : i < s.L - 1 ? 2 : 3;
}

// The 4 leaves' sums of the block, in a fixed order (each warp's tree,
// then the warps' tree), written to *out by thread 0.
__device__ __forceinline__ void block_leaves(float acc[4], float* shared,
                                             float4* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const float x = warp_sum(acc[l]);
    if (lane == 0) shared[l * SOLVE_WARPS + warp] = x;
  }
  __syncthreads();
  if (warp == 0) {
    float v[4];
#pragma unroll
    for (int l = 0; l < 4; ++l)
      v[l] = warp_sum(lane < SOLVE_WARPS ? shared[l * SOLVE_WARPS + lane]
                                         : 0.f);
    if (lane == 0) __stcg(out, make_float4(v[0], v[1], v[2], v[3]));
  }
  __syncthreads();
}

// _vdot_tree's value from the grid's block sums: thread t holds block t's
// 4 leaves (one load), each leaf summed by the warps' trees and then the
// tree of the warps, the leaves added in order. Every block reads the same
// sums in the same order, so every block gets the same value.
__device__ __forceinline__ float grid_dot(const float4* part, float* shared) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float4 v = threadIdx.x < gridDim.x ? __ldcg(part + threadIdx.x)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
  float acc[4] = {warp_sum(v.x), warp_sum(v.y), warp_sum(v.z), warp_sum(v.w)};
  if (lane == 0) {
#pragma unroll
    for (int l = 0; l < 4; ++l) shared[l * SOLVE_WARPS + warp] = acc[l];
  }
  __syncthreads();
  if (warp == 0) {
    float total = 0.f;
#pragma unroll
    for (int l = 0; l < 4; ++l)
      total += warp_sum(lane < SOLVE_WARPS ? shared[l * SOLVE_WARPS + lane]
                                           : 0.f);
    if (lane == 0) shared[4 * SOLVE_WARPS] = total;
  }
  __syncthreads();
  const float total = shared[4 * SOLVE_WARPS];
  __syncthreads();
  return total;
}

// The product's first half, J^T W J q_k without lam: each warp takes
// 32-observation tiles of the block's contiguous range; a point's 3 terms
// are stored an observation (obs_pt), a camera run's 6 sums at its last
// lane (obs_cam); returns the thread's focal terms.
__device__ __forceinline__ float product_obs(const Solve& s, float scale,
                                             const float* qk) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tiles = (s.N + 31) / 32;
  const long long per = (tiles + gridDim.x - 1) / gridDim.x;
  const long long t1 = min(tiles, per * (blockIdx.x + 1));
  const int m = s.m;
  float focal = 0.f;
  for (long long tile = per * blockIdx.x + warp; tile < t1;
       tile += SOLVE_WARPS) {
    const long long n = tile * 32 + lane;
    const Obs o = load_obs(n, s.N, s.R, s.t, s.X, scale, s.in, s.cam, s.pt,
                           s.sw);
    float A[3][3] = {{0.f}};
    float j0 = 0.f, j1 = 0.f;
    if (o.live) {
      rot_tangents(s.dR, o, A);
      float vp[3], vr[3] = {0.f, 0.f, 0.f}, vt[3] = {0.f, 0.f, 0.f};
      for (int q = 0; q < 3; ++q)
        vp[q] = __ldcg(qk + 6LL * m + 3LL * o.p + q);
      if (o.c > 0) {
        for (int q = 0; q < 3; ++q) {
          vr[q] = __ldcg(qk + 3LL * o.c + q);
          vt[q] = __ldcg(qk + 3LL * m + 3LL * o.c + q);
        }
      }
      const float vf = s.refine_focal ? __ldcg(qk + s.L - 1) : 0.f;
      forward(o, s.R + 9 * o.c, A, vp, vr, vt, vf, s.refine_focal, j0, j1);
    }
    float pt[3], cam[6];
    focal += transpose(o, s.R, A, o.w * j0, o.w * j1, pt, cam);
    if (o.live) {
      for (int j = 0; j < 3; ++j) __stcg(s.obs_pt + 3 * n + j, pt[j]);
    }
    if (segment_sums(o.c > 0 ? o.c : -1, cam)) {
      for (int q = 0; q < 6; ++q) __stcg(s.obs_cam + 6 * n + q, cam[q]);
    }
  }
  return focal;
}

// The product's second half: Aq = (J^T W J + lam) q_k, masked, each entry
// summed in a fixed order (a point's coordinate over its observations in
// ascending order, a thread each, a point's 3 in neighbouring lanes,
// GATHER_BATCH index loads and then as many terms in flight; a camera over
// its runs' sums, a warp a camera; the focal scale over the blocks), and
// the block's sums of q_k . Aq a leaf.
__device__ __forceinline__ void product_gather(const Solve& s,
                                               const float* qk,
                                               float* shared) {
  const int lane = threadIdx.x & 31;
  const long long threads = (long long)gridDim.x * SOLVE_THREADS;
  const long long gtid = (long long)blockIdx.x * SOLVE_THREADS + threadIdx.x;
  const int m = s.m;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (long long t = gtid; t < 3LL * s.p; t += threads) {
    const long long pp = t / 3;  // entry 6 M + t: point pp's coordinate j
    const int j = (int)(t - 3 * pp);
    const float* terms = s.obs_pt + j;
    const int e1 = __ldg(s.pt_start + pp + 1);
    float sum = 0.f;
    for (int e = __ldg(s.pt_start + pp); e < e1; e += GATHER_BATCH) {
      int n[GATHER_BATCH];
      float v[GATHER_BATCH];
#pragma unroll
      for (int u = 0; u < GATHER_BATCH; ++u)
        n[u] = e + u < e1 ? __ldg(s.pt_obs + e + u) : -1;
#pragma unroll
      for (int u = 0; u < GATHER_BATCH; ++u)
        v[u] = n[u] >= 0 ? __ldcg(terms + 3LL * n[u]) : 0.f;
#pragma unroll
      for (int u = 0; u < GATHER_BATCH; ++u)
        if (n[u] >= 0) sum += v[u];
    }
    const long long i = 6LL * m + 3 * pp + j;
    const float qv = __ldcg(qk + i);
    const float a = sum + s.lam * qv;
    __stcg(s.Aq + i, a);
    acc[2] += qv * a;
  }
  const long long warps = threads / 32;
  const long long gwarp = gtid / 32;
  for (long long c = gwarp; c < m; c += warps) {
    float sum[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const int cs = __ldg(s.cam_start + c), ce = __ldg(s.cam_start + c + 1);
    if (c > 0 && ce > cs) {
      // the camera's runs end at every n = 31 (mod 32) in [cs, ce - 1)
      // and at ce - 1
      const int first = cs | 31;
      const int runs = (first < ce - 1 ? (ce - 2 - first) / 32 + 1 : 0) + 1;
      for (int j = lane; j < runs; j += 32) {
        const long long n = j + 1 < runs ? first + 32LL * j : ce - 1;
        for (int q = 0; q < 6; ++q) sum[q] += __ldcg(s.obs_cam + 6 * n + q);
      }
      for (int q = 0; q < 6; ++q) sum[q] = warp_sum(sum[q]);
    }
    if (lane == 0) {
      for (int q = 0; q < 6; ++q) {
        const long long i = (q < 3 ? 3LL * c : 3LL * m + 3LL * c) + q % 3;
        const float qv = __ldcg(qk + i);
        const float a = c > 0 ? sum[q] + s.lam * qv : 0.f;
        __stcg(s.Aq + i, a);
        if (q < 3) acc[0] += qv * a;
        else acc[1] += qv * a;
      }
    }
  }
  if (gwarp == warps - 1) {  // the focal scale, in the grid's last warp
    float sum = 0.f;
    if (s.refine_focal) {
      for (int b = lane; b < (int)gridDim.x; b += 32)
        sum += __ldcg(s.part_f + b);
      sum = warp_sum(sum);
    }
    if (lane == 0) {
      const float qv = __ldcg(qk + s.L - 1);
      const float a = s.refine_focal ? sum + s.lam * qv : 0.f;
      __stcg(s.Aq + s.L - 1, a);
      acc[3] += qv * a;
    }
  }
  block_leaves(acc, shared, s.part_qAq + blockIdx.x);
}

__global__ void __launch_bounds__(SOLVE_THREADS, 1)
cg_solve_kernel(const Solve s) {
  namespace cgr = cooperative_groups;
  cgr::grid_group grid = cgr::this_grid();
  __shared__ float shared[4 * SOLVE_WARPS + 1];
  const long long threads = (long long)gridDim.x * SOLVE_THREADS;
  const long long gtid = (long long)blockIdx.x * SOLVE_THREADS + threadIdx.x;
  const float scale = expf(__ldg(s.dlog_f));
  // x0 = 0, r0 = b - A(0) = b (A(0) is exactly 0 on finite inputs), q0 = b
  {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (long long i = gtid; i < s.L; i += threads) {
      const float bi = __ldg(s.b + i);
      __stcg(s.x + i, 0.f);
      __stcg(s.r + i, bi);
      __stcg(s.q0 + i, bi);
      add_leaf(acc, leaf_of(i, s), bi * bi);
    }
    block_leaves(acc, shared, s.part_rr + blockIdx.x);
  }
  grid.sync();
  float gamma = 0.f, atol2 = 0.f, beta = 0.f;
  int k = 0;
  for (;; ++k) {
    const float gamma_new = grid_dot(s.part_rr, shared);
    if (k == 0) {
      atol2 = s.tol2 * gamma_new;  // b^T b: r0 is b
    } else {
      beta = gamma_new / gamma;
    }
    gamma = gamma_new;
    if (k >= s.maxiter || !(gamma > atol2)) break;
    float* qk = (k & 1) ? s.q1 : s.q0;
    const float* qk_prev = (k & 1) ? s.q0 : s.q1;
    if (k > 0) {
      for (long long i = gtid; i < s.L; i += threads)
        __stcg(qk + i, __fmaf_rn(beta, __ldcg(qk_prev + i), __ldcg(s.r + i)));
      grid.sync();
    }
    const float focal = product_obs(s, scale, qk);
    if (s.refine_focal) {
      const float f = block_sum<SOLVE_WARPS>(focal, shared);
      if (threadIdx.x == 0) __stcg(s.part_f + blockIdx.x, f);
      __syncthreads();
    }
    grid.sync();
    product_gather(s, qk, shared);
    grid.sync();
    const float alpha = gamma / grid_dot(s.part_qAq, shared);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (long long i = gtid; i < s.L; i += threads) {
      const float qv = __ldcg(qk + i);
      __stcg(s.x + i, __fmaf_rn(alpha, qv, __ldcg(s.x + i)));
      const float ri = __fmaf_rn(-alpha, __ldcg(s.Aq + i), __ldcg(s.r + i));
      __stcg(s.r + i, ri);
      add_leaf(acc, leaf_of(i, s), ri * ri);
    }
    block_leaves(acc, shared, s.part_rr + blockIdx.x);
    grid.sync();
  }
  if (gtid == 0) *s.k_out = k;
}

inline unsigned blocks(long long n) {
  return (unsigned)((n + BA_THREADS - 1) / BA_THREADS);
}

}  // namespace

// Entry 1: r (N x 2), the cost's partial sums (one a block of BA_THREADS
// observations: B = ceil(N / BA_THREADS) floats, followed by B floats of
// workspace for the focal's) and, with want_grad, the masked gradient g
// (L floats).
extern "C" int ba_residual_grad(const float* R, const float* dR,
                                const float* t, const float* X,
                                const float* dlog_f, float fx0, float fy0,
                                float cx, float cy, const int* cam,
                                const int* pt, const float* xy,
                                const float* sw, long long N, int m, int p,
                                int refine_focal, int want_grad, float* r,
                                float* partials, float* g,
                                void* stream_ptr) {
  if (N <= 0 || m <= 0 || p <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (want_grad) {
    const cudaError_t e = cudaMemsetAsync(
        g, 0, sizeof(float) * (6LL * m + 3LL * p + 1), stream);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned b = blocks(N);
  residual_grad_kernel<<<b, BA_THREADS, 0, stream>>>(
      R, dR, t, X, dlog_f, Intr{fx0, fy0, cx, cy}, cam, pt, xy, sw, N, m, p,
      refine_focal, want_grad, r, partials, partials + b, g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !(want_grad && refine_focal)) return (int)e;
  focal_sum_kernel<<<1, 1024, 0, stream>>>(partials + b, (int)b,
                                           g + 6LL * m + 3LL * p);
  return (int)cudaGetLastError();
}

// Entry 2: out = (J^T J + lam I) v on the masked parameters (L floats);
// work: ceil(N / BA_THREADS) floats for the focal's partials.
extern "C" int ba_normal_matvec(const float* R, const float* dR,
                                const float* t, const float* X,
                                const float* dlog_f, float fx0, float fy0,
                                float cx, float cy, const int* cam,
                                const int* pt, const float* sw, long long N,
                                int m, int p, int refine_focal,
                                const float* vec, float lam, float* work,
                                float* out, void* stream_ptr) {
  if (N <= 0 || m <= 0 || p <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long L = 6LL * m + 3LL * p + 1;
  damp_kernel<<<blocks(L), BA_THREADS, 0, stream>>>(vec, lam, L, m,
                                                    refine_focal, out);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const unsigned b = blocks(N);
  matvec_kernel<<<b, BA_THREADS, 0, stream>>>(
      R, dR, t, X, dlog_f, Intr{fx0, fy0, cx, cy}, cam, pt, sw, N, m, p,
      refine_focal, vec, work, out);
  e = cudaGetLastError();
  if (e != cudaSuccess || !refine_focal) return (int)e;
  focal_sum_kernel<<<1, 1024, 0, stream>>>(work, (int)b, out + L - 1);
  return (int)cudaGetLastError();
}

// Entry 3's grid: the blocks of cg_solve_kernel that the device holds
// resident at once (the occupancy's blocks a multiprocessor times the
// multiprocessors), or an error when the device has no cooperative launch.
extern "C" int ba_cg_grid(int* grid) {
  int dev = 0, coop = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, cg_solve_kernel,
                                                      SOLVE_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  *grid = occ * sms;
  return occ > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

// Entry 3: x solving (J^T J + lam I) x = b on the masked parameters by
// jax.scipy.sparse.linalg.cg's rule (x0 = 0; while r^T r > tol^2 b^T b and
// k < maxiter), and k, the iterations run, into *k_out; one cooperative
// launch of `grid` blocks (ba_cg_grid's, or fewer; at most SOLVE_THREADS:
// a block's dots hold one block's sums a thread). The observations must be
// in camera order; cam_start (M + 1) is each camera's first, pt_start
// (P + 1) and pt_obs (N) each point's observations in ascending order
// (the point CSR).
// work: 9 grid + 4 L + 9 N floats; after the launch its Aq (L floats at
// 9 grid + 3 L) holds the last iteration's damped product.
extern "C" int ba_cg_solve(const float* R, const float* dR, const float* t,
                           const float* X, const float* dlog_f, float fx0,
                           float fy0, float cx, float cy, const int* cam,
                           const int* pt, const float* sw, long long N, int m,
                           int p, int refine_focal, const int* cam_start,
                           const int* pt_start, const int* pt_obs,
                           const float* b, float lam, float tol, int maxiter,
                           int grid, float* work, float* x,
                           int* k_out, void* stream_ptr) {
  if (N <= 0 || m <= 0 || p <= 0 || grid <= 0 || maxiter < 0)
    return (int)cudaErrorInvalidValue;
  if (grid > SOLVE_THREADS) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long L = 6LL * m + 3LL * p + 1;
  Solve s;
  s.R = R; s.dR = dR; s.t = t; s.X = X; s.dlog_f = dlog_f;
  s.in = Intr{fx0, fy0, cx, cy};
  s.cam = cam; s.pt = pt; s.sw = sw;
  s.N = N; s.L = L; s.m = m; s.p = p;
  s.refine_focal = refine_focal; s.maxiter = maxiter;
  s.lam = lam; s.tol2 = tol * tol;
  s.cam_start = cam_start; s.pt_start = pt_start; s.pt_obs = pt_obs;
  s.b = b; s.x = x;
  // the block sums first: float4-aligned where torch's allocation is
  s.part_qAq = reinterpret_cast<float4*>(work);
  s.part_rr = s.part_qAq + grid;
  s.part_f = reinterpret_cast<float*>(s.part_rr + grid);
  s.r = s.part_f + grid; s.q0 = s.r + L; s.q1 = s.q0 + L; s.Aq = s.q1 + L;
  s.obs_pt = s.Aq + L; s.obs_cam = s.obs_pt + 3 * N;
  s.k_out = k_out;
  void* args[] = {&s};
  return (int)cudaLaunchCooperativeKernel((void*)cg_solve_kernel, grid,
                                          SOLVE_THREADS, args, 0,
                                          (cudaStream_t)stream_ptr);
}
