// The baked preview's splat render (K8): K splats projected into an
// H x W frame, a z-buffer, the winners' mean colour and largest class, then
// `passes` footprint passes over the 8 neighbours and the background rule.
//
// Replaces what XLA compiles on the TPU for
// autolabel_tpu/render/baked.py `_splat_render` (:146-254). Four kernels,
// 3 + passes launches a frame after one memset of the accumulators:
//   (a) project_kernel, a thread per splat: a splat that is not valid (the
//       bake's zero padding) reads nothing more; a valid one takes the
//       camera transform, the in-front test z > 0.05, u = fx x / z + cx
//       rounded half to even (rintf, as jnp.round) and the in-frame test.
//       The splat's pixel (-1 for none) and z are kept, and the pixel's
//       z-buffer takes the smaller z by an atomicMax of BIG_BITS - bits(z):
//       positive floats order as their bits do, so the zeroed buffer reads
//       as z = BIG and no kernel is needed to fill it.
//   (b) winners_kernel, a thread per splat: a splat wins its pixel when
//       z <= zbuf * 1.0001f; a winner shades its colour (through the
//       degree-1 SH when there is one) and adds it and a count with
//       atomicAdd, and takes atomicMax of class + 1.
//   (c) resolve_kernel, a thread per pixel: image = sum / max(count, 1),
//       depth, class, hit = count > 0 (also splat_hit).
//   (d) fill_kernel, a thread per pixel, one launch a pass, ping-ponging
//       two state buffers: JAX's gated adoption of the nearest qualifying
//       neighbour, dy outer, dx inner, neighbours read with jnp.roll's
//       wrap-around (the pixel left of column 0 is column W - 1); the last
//       pass (or resolve, with no pass) applies the background rule.
//
// Arithmetic: the JAX package's as XLA's CPU code computes it, and the
// plain version (ops/splat_cuda.py) computes the same: the camera
// transform, the view direction's squared norm and the SH dot product are
// chains whose first product is rounded to fp32 and whose every further
// term is added as a double-precision product-sum rounded once to fp32
// (dmul_add32); every other operation is one correctly rounded fp32
// operation in the JAX order, written with the _rn intrinsics so that nvcc
// contracts nothing into an fma. The camera centre -R^T t, a chain of the
// same kind, is computed once a frame on the host and shared with the plain
// version. So the pixel a splat lands on, its z and the fill gate are
// bit-equal to the plain version's; only a pixel's summed colour depends on
// the order of the atomics when several splats tie in it.
#include <cuda_runtime.h>

#define SPLAT_THREADS 256
// 1e9f, the z-buffer's empty value, and fp32(1.0 + 1e-4), the winners'
// factor (JAX's weak-typed Python constant rounded to fp32).
#define BIG_BITS 0x4e6e6b28
#define WIN_FACTOR_BITS 0x3f800347

struct Camera {
  float fx, fy, cx, cy;
  float r[9];  // world -> camera rotation, row-major
  float t[3];
  float centre[3];  // -R^T t
};

__device__ __forceinline__ float dmul_add32(float a, float b, float acc) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)acc));
}

// cam_j = sum_i r[j][i] p_i + t_j, as an XLA dot: p0 r0 rounded, then each
// further product added in one rounding.
__device__ __forceinline__ float cam_row(const Camera& c, int j, float p0,
                                         float p1, float p2) {
  float acc = __fmul_rn(p0, c.r[3 * j]);
  acc = dmul_add32(p1, c.r[3 * j + 1], acc);
  acc = dmul_add32(p2, c.r[3 * j + 2], acc);
  return __fadd_rn(acc, c.t[j]);
}

__global__ void __launch_bounds__(SPLAT_THREADS)
    project_kernel(const float* __restrict__ points,
                   const unsigned char* __restrict__ valid, long long k,
                   Camera c, int height, int width, int* __restrict__ pid,
                   float* __restrict__ zs, int* __restrict__ zkey) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  if (!valid[i]) {
    pid[i] = -1;
    return;
  }
  const float p0 = points[3 * i], p1 = points[3 * i + 1],
              p2 = points[3 * i + 2];
  const float x = cam_row(c, 0, p0, p1, p2);
  const float y = cam_row(c, 1, p0, p1, p2);
  const float z = cam_row(c, 2, p0, p1, p2);
  const float px = rintf(__fadd_rn(__fdiv_rn(__fmul_rn(c.fx, x), z), c.cx));
  const float py = rintf(__fadd_rn(__fdiv_rn(__fmul_rn(c.fy, y), z), c.cy));
  const bool ok = z > 0.05f && px >= 0.0f && px < (float)width &&
                  py >= 0.0f && py < (float)height;
  int p = -1;
  if (ok) {
    p = (int)py * width + (int)px;
    atomicMax(zkey + p, BIG_BITS - __float_as_int(z));
  }
  pid[i] = p;
  zs[i] = z;
}

__global__ void __launch_bounds__(SPLAT_THREADS)
    winners_kernel(const float* __restrict__ points,
                   const float* __restrict__ rgb,
                   const float* __restrict__ sh,
                   const int* __restrict__ semantic, long long k, Camera c,
                   const int* __restrict__ pid, const float* __restrict__ zs,
                   const int* __restrict__ zkey, float* __restrict__ img,
                   int* __restrict__ cnt, int* __restrict__ sem) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  const int p = pid[i];
  if (p < 0) return;
  const float zbuf = __int_as_float(BIG_BITS - zkey[p]);
  if (!(zs[i] <= __fmul_rn(zbuf, __int_as_float(WIN_FACTOR_BITS)))) return;
  float col[3] = {rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2]};
  if (sh != nullptr) {
    // view = (p - centre) / max(|p - centre|, 1e-8),
    // colour = clip(rgb + sum_a view_a sh[a], 0, 1)
    float v[3];
    for (int a = 0; a < 3; ++a)
      v[a] = __fsub_rn(points[3 * i + a], c.centre[a]);
    float ss = __fmul_rn(v[0], v[0]);
    ss = dmul_add32(v[1], v[1], ss);
    ss = dmul_add32(v[2], v[2], ss);
    const float norm = fmaxf(__fsqrt_rn(ss), 1e-8f);
    for (int a = 0; a < 3; ++a) v[a] = __fdiv_rn(v[a], norm);
    const float* s = sh + 9 * i;
    for (int ch = 0; ch < 3; ++ch) {
      float lin = __fmul_rn(v[0], s[ch]);
      lin = dmul_add32(v[1], s[3 + ch], lin);
      lin = dmul_add32(v[2], s[6 + ch], lin);
      col[ch] = fminf(fmaxf(__fadd_rn(col[ch], lin), 0.0f), 1.0f);
    }
  }
  for (int ch = 0; ch < 3; ++ch)
    atomicAdd(img + 3 * (long long)p + ch, col[ch]);
  atomicAdd(cnt + p, 1);
  atomicMax(sem + p, semantic[i] + 1);
}

struct State {
  float* img;  // (n, 3)
  float* depth;
  int* cls;
  int* hit;
};

struct Outputs {
  float* image;  // (n, 3)
  float* depth;
  int* classes;
  unsigned char* splat_hit;
};

// The background rule of the last step: a pixel no splat reached is white,
// at depth 0, class 0; every other class id drops the +1 of the scatter.
__device__ __forceinline__ void write_final(const Outputs& o, long long p,
                                            const float* im, float d, int cl,
                                            bool h) {
  for (int ch = 0; ch < 3; ++ch) o.image[3 * p + ch] = h ? im[ch] : 1.0f;
  o.depth[p] = h ? d : 0.0f;
  o.classes[p] = h ? max(cl - 1, 0) : 0;
}

__global__ void __launch_bounds__(SPLAT_THREADS)
    resolve_kernel(long long n, const int* __restrict__ zkey,
                   const float* __restrict__ img, const int* __restrict__ cnt,
                   const int* __restrict__ sem, State s, Outputs o,
                   int final_step) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int count = cnt[p];
  const float div = fmaxf((float)count, 1.0f);
  float im[3];
  for (int ch = 0; ch < 3; ++ch) im[ch] = __fdiv_rn(img[3 * p + ch], div);
  const float d = __int_as_float(BIG_BITS - zkey[p]);
  const bool h = count > 0;
  o.splat_hit[p] = h;
  if (final_step) {
    write_final(o, p, im, d, sem[p], h);
    return;
  }
  for (int ch = 0; ch < 3; ++ch) s.img[3 * p + ch] = im[ch];
  s.depth[p] = d;
  s.cls[p] = sem[p];
  s.hit[p] = h;
}

__global__ void __launch_bounds__(SPLAT_THREADS)
    fill_kernel(int height, int width, State in, State out, Outputs o,
                int final_step, float ring, float cell, float focal) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long long)height * width) return;
  const int y = (int)(p / width), x = (int)(p % width);
  const float d = in.depth[p];
  const bool h = in.hit[p] != 0;
  const float big = __int_as_float(BIG_BITS);
  const float margin = fmaxf(__fmul_rn(3.0f, cell), __fmul_rn(0.05f, d));
  const float beat = h ? __fsub_rn(d, margin) : big;
  const float cf = __fmul_rn(cell, focal);
  float best_d = big;
  long long src = p;  // the pixel whose image and class this one shows
  bool took = false;
  for (int dy = -1; dy <= 1; ++dy)
    for (int dx = -1; dx <= 1; ++dx) {
      if (dx == 0 && dy == 0) continue;
      // jnp.roll(a, (dy, dx))[y, x] = a[(y - dy) mod H, (x - dx) mod W]
      int ny = y - dy, nx = x - dx;
      ny = ny < 0 ? ny + height : (ny >= height ? ny - height : ny);
      nx = nx < 0 ? nx + width : (nx >= width ? nx - width : nx);
      const long long q = (long long)ny * width + nx;
      if (!in.hit[q]) continue;
      const float nd = in.depth[q];
      const float rad = __fdiv_rn(cf, __fmul_rn(2.0f, fmaxf(nd, 1e-6f)));
      const float reach = __fadd_rn(h ? rad : __fmul_rn(2.0f, rad), 0.5f);
      if (reach >= ring && nd < fminf(beat, best_d)) {
        best_d = nd;
        src = q;
        took = true;
      }
    }
  const float depth = took ? best_d : d;
  const float* im = in.img + 3 * src;
  const int cl = in.cls[src];
  const bool hit = h || took;
  if (final_step) {
    write_final(o, p, im, depth, cl, hit);
    return;
  }
  for (int ch = 0; ch < 3; ++ch) out.img[3 * p + ch] = im[ch];
  out.depth[p] = depth;
  out.cls[p] = cl;
  out.hit[p] = hit;
}

static unsigned blocks(long long count) {
  return (unsigned)((count + SPLAT_THREADS - 1) / SPLAT_THREADS);
}

// The workspace's int32 words: per splat its pixel and, for a valid one, z
// (2 k), the
// accumulators (z key, count, class, colour: 6 n) and two fill states (6 n
// each).
extern "C" long long splat_render_workspace_words(long long k,
                                                  long long n) {
  return 2 * k + 18 * n;
}

// camera: fx, fy, cx, cy, the rotation (row-major) and the translation of
// T_CW and the camera centre, 19 floats on the host. sh may be null. Returns a cudaError_t.
extern "C" int splat_render(const float* points, const float* rgb,
                            const float* sh, const int* semantic,
                            const unsigned char* valid, long long k,
                            const float* camera, int height, int width,
                            int passes, float cell, float focal, int* work,
                            float* image, float* depth, int* classes,
                            unsigned char* splat_hit, void* stream_ptr) {
  if (k < 0 || height <= 0 || width <= 0 || passes < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  Camera c;
  c.fx = camera[0];
  c.fy = camera[1];
  c.cx = camera[2];
  c.cy = camera[3];
  for (int j = 0; j < 9; ++j) c.r[j] = camera[4 + j];
  for (int j = 0; j < 3; ++j) c.t[j] = camera[13 + j];
  for (int j = 0; j < 3; ++j) c.centre[j] = camera[16 + j];
  const long long n = (long long)height * width;
  int* pid = work;
  float* zs = reinterpret_cast<float*>(work + k);
  int* zkey = work + 2 * k;
  int* cnt = zkey + n;
  int* sem = cnt + n;
  float* img = reinterpret_cast<float*>(sem + n);
  State st[2];
  int* base = work + 2 * k + 6 * n;
  for (int b = 0; b < 2; ++b, base += 6 * n) {
    st[b].img = reinterpret_cast<float*>(base);
    st[b].depth = reinterpret_cast<float*>(base + 3 * n);
    st[b].cls = base + 4 * n;
    st[b].hit = base + 5 * n;
  }
  const Outputs o{image, depth, classes, splat_hit};
  cudaError_t err =
      cudaMemsetAsync(zkey, 0, sizeof(int) * 6 * n, stream);
  if (err != cudaSuccess) return (int)err;
  if (k > 0) {
    project_kernel<<<blocks(k), SPLAT_THREADS, 0, stream>>>(
        points, valid, k, c, height, width, pid, zs, zkey);
    winners_kernel<<<blocks(k), SPLAT_THREADS, 0, stream>>>(
        points, rgb, sh, semantic, k, c, pid, zs, zkey, img, cnt, sem);
  } else {
    // no splat: the launches are kept, so the count is the same
    project_kernel<<<1, SPLAT_THREADS, 0, stream>>>(
        points, valid, 0, c, height, width, pid, zs, zkey);
    winners_kernel<<<1, SPLAT_THREADS, 0, stream>>>(
        points, rgb, sh, semantic, 0, c, pid, zs, zkey, img, cnt, sem);
  }
  resolve_kernel<<<blocks(n), SPLAT_THREADS, 0, stream>>>(
      n, zkey, img, cnt, sem, st[0], o, passes == 0);
  for (int i = 0; i < passes; ++i)
    fill_kernel<<<blocks(n), SPLAT_THREADS, 0, stream>>>(
        height, width, st[i % 2], st[(i + 1) % 2], o, i == passes - 1,
        (float)(i + 1), cell, focal);
  return (int)cudaGetLastError();
}
