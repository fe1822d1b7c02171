// Bundle adjustment's two Levenberg-Marquardt products (K9).
//
// Replaces what XLA compiles on the TPU for autolabel_tpu/mapping/ba.py
// `_lm_step` (:80-99): the residuals of every observation and the
// gradient J^T r (the vjp of `_residual`, :63-69), and inside each of up to
// `cg_iters` conjugate-gradient iterations the damped normal product
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
// row carries sqrt_w.
//
// What bounds it. Counted once, a product must read the observations'
// indices and weights (12 bytes each, 20 with the observed pixels), the
// points, the cameras' R, dR and t, v, and write the output: at M = 300
// cameras, P = 40,000 points and N = 360,000 observations about 6 MB for
// the matvec and 12 MB for the residual and gradient, 2 to 4 us on the
// H100's 3.35 TB/s. The arithmetic (about 200 fp32 operations an
// observation) is far below the card's rate. What costs more is the
// scatter: every observation adds 3 values to its point (about 9
// observations a point, so little contention), and 6 to its camera, which
// about N / M observations share.
//
// Design, simple first: a thread per observation, 256 a block. The caller
// orders the observations by camera once per `bundle_adjust` call, so a
// warp's observations mostly share one camera; a segmented inclusive scan
// over the warp (segments of equal camera, found by ballot, correct in any
// order) leaves one lane per segment to issue the camera's 6 atomics.
// Points take 3 atomics an observation. The focal scale's terms and the
// cost's are summed over the block and written one a block; the caller
// sums the cost's partials, and a one-block kernel sums the focal's in a
// fixed order into its entry. (An atomic a block adds 1,407 partials in
// sequence at N = 360,000: on the H100 that gave the focal entry, the
// product's largest, 4 times the plain version's fp32 error.) Entry 1
// zeroes the gradient first (a memset); entry 2 first writes lam * masked
// v, then adds J^T J v. The contention that remains: the camera atomics,
// about (N / M) / 32 runs of one camera in flight, ~38 a product per
// camera address at that size.
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

// The block's sum of x, valid in thread 0.
__device__ __forceinline__ float block_sum(float x, float* shared) {
  x = warp_sum(x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) shared[warp] = x;
  __syncthreads();
  x = threadIdx.x < BA_WARPS ? shared[threadIdx.x] : 0.f;
  if (warp == 0) x = warp_sum(x);
  return x;
}

// Adds vals[0..5] to camera `key`'s rvec (g_r) and translation (g_t)
// entries: a segmented inclusive scan over the warp's runs of equal key,
// then the last lane of each run issues 6 atomics. key < 0 adds nothing.
__device__ __forceinline__ void camera_add(float* g_r, float* g_t, int key,
                                           float vals[6]) {
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
  if ((lane == 31 || next != key) && key >= 0) {
    for (int q = 0; q < 3; ++q) {
      atomicAdd(g_r + 3 * key + q, vals[q]);
      atomicAdd(g_t + 3 * key + q, vals[3 + q]);
    }
  }
}

// Scatters J_n^T e for e = w * cot (cot the 2 residual-space values): the
// point's 3 entries, the camera's 6 (unless camera 0) and the focal scale
// (returned, for the block sum).
__device__ __forceinline__ float scatter(const Obs& o, const float* R,
                                         const float A[3][3], float c0,
                                         float c1, int m, float* g) {
  const float e0 = o.w * c0, e1 = o.w * c1;
  float gx[3];
  gx[0] = o.fx * e0 / o.z;
  gx[1] = o.fy * e1 / o.z;
  gx[2] = -(gx[0] * o.u + gx[1] * o.v) * o.dz;
  float cam_vals[6];
  for (int k = 0; k < 3; ++k)
    cam_vals[k] = A[k][0] * gx[0] + A[k][1] * gx[1] + A[k][2] * gx[2];
  for (int q = 0; q < 3; ++q) cam_vals[3 + q] = gx[q];
  if (o.live) {
    const float* Rc = R + 9 * o.c;
    float* gp = g + 6 * m + 3 * o.p;
    for (int j = 0; j < 3; ++j)
      atomicAdd(gp + j, Rc[j] * gx[0] + Rc[3 + j] * gx[1] + Rc[6 + j] * gx[2]);
  }
  camera_add(g, g + 3 * m, o.c > 0 ? o.c : -1, cam_vals);
  return e0 * o.u * o.fx + e1 * o.v * o.fy;
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
    const float* Rc = R + 9 * o.c;
    const float* vp = vec + 6 * m + 3 * o.p;
    float d[3];
    for (int i = 0; i < 3; ++i)
      d[i] = Rc[3 * i] * vp[0] + Rc[3 * i + 1] * vp[1] + Rc[3 * i + 2] * vp[2];
    if (o.c > 0) {
      const float* vr = vec + 3 * o.c;
      const float* vt = vec + 3 * m + 3 * o.c;
      for (int i = 0; i < 3; ++i)
        d[i] += A[0][i] * vr[0] + A[1][i] * vr[1] + A[2][i] * vr[2] + vt[i];
    }
    j0 = o.fx * (d[0] - o.u * o.dz * d[2]) / o.z;
    j1 = o.fy * (d[1] - o.v * o.dz * d[2]) / o.z;
    if (refine_focal) {
      const float vf = vec[6 * m + 3 * p];
      j0 += o.u * o.fx * vf;
      j1 += o.v * o.fy * vf;
    }
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
