// The baked preview's splat render (K8): K splats projected into an
// H x W frame, a z-buffer, the winners' mean colour and largest class, then
// `passes` footprint passes over the 8 neighbours and the background rule.
//
// Replaces what XLA compiles on the TPU for
// autolabel_tpu/render/baked.py `_splat_render` (:146-254).
//
// What bounds it. Counted once, a frame must read a byte of `valid` a splat
// row, the valid splats' points and the winners' colour, SH and class, and
// write 21 bytes a pixel (image, depth, class, splat_hit): 0.008 ms on the
// H100's 3.35 TB/s for 2^18 splats at 1280 x 720. What costs more is what
// the algorithm adds: a scatter whose atomics serialise where splats share
// a pixel, a memset of the accumulators, and a gather over 8 neighbours a
// pass, `passes` times. A launch a pass paid that in launches and in state
// moved through L2 (6 words a pixel written and 54 read a pass); in shared
// memory it is bound by instruction issue: 11.4 million region pixel
// updates for 8 passes at 1280 x 720, each a few dozen instructions.
//
// Three kernels after one memset of the accumulators (z keys, colour sums
// and counts, classes: 24 bytes a pixel), 3 + ceil(passes / HALO_MAX)
// launches a frame with the memset (4 up to HALO_MAX passes; at least one
// fill launch, which with no pass is the resolve alone):
//   (a) project_kernel, a thread per splat: a splat that is not valid (the
//       bake's zero padding) reads nothing more; a valid one takes the
//       camera transform, the in-front test z > 0.05, u = fx x / z + cx
//       rounded half to even (rintf, as jnp.round) and the in-frame test.
//       The splat's pixel (-1 for none) and z are kept. A splat in the
//       frame that can win any pixel (z <= WIN_TOP, the winners' limit at
//       an empty z-buffer, BIG * WIN_FACTOR) takes the smaller z by an
//       atomicMax of key(z) = bits(WIN_TOP) + 1 - bits(z):
//       positive floats order as their bits do, so a key is positive, and
//       a key of 0 means that no splat wins the pixel. Its z-buffer value
//       is min(BIG, z of the key), BIG for a key of 0.
//   (b) winners_kernel, a thread per splat: a splat wins its pixel when
//       z <= zbuf * WIN_FACTOR; a winner shades its colour (through the
//       degree-1 SH when there is one) and adds (r, g, b, 1) with one float4
//       atomicAdd (the count in fp32 is exact below 2^24 winners a pixel,
//       and JAX counts in fp32 too), and takes atomicMax of class + 1.
//       Summing a warp's winners of one pixel first (__match_any_sync) was
//       slower on the baked scenes and full clouds, faster only where every
//       splat is repeated in adjacent rows.
//   (c) fill_kernel, a block per TILE x TILE output tile: it loads the tile
//       and a halo of P = min(passes left, HALO_MAX) pixels a side into
//       shared memory, reading each pixel's row and column modulo H and W
//       (jnp.roll's wrap-around, as often as a small frame needs), runs
//       the P passes there over a region that shrinks by a pixel a side a
//       pass, and writes each tile pixel once. The state a pixel carries
//       is the region index of the pixel whose splat it shows (`src`, 2
//       bytes; a sentinel for none): an adoption copies a neighbour's
//       image, depth and class unchanged, so every one of them is a
//       function of the source, and depth and footprint radius are kept
//       once per source (`orig`). In a pass a thread sweeps a strip of
//       one column with its 3 x 3 neighbourhood in registers (3 sources
//       and 3 (depth, radius) read a pixel, not 9 and 9); a pass in which
//       no pixel adopts ends the launch's passes (no later one adopts).
//       The last launch looks up the source's colour sum / max(count, 1)
//       and class once and applies the background rule; an earlier one
//       writes each pixel's source (global index + 1) for the next
//       launch, which reads it back as each region pixel's depth and
//       radius. The loads of the region and of the outputs' sources are
//       all issued before any is used: latency, not bytes, sets those
//       phases.
//
// Where HALO_MAX comes from. A launch of P passes updates
// sum_{j<P} (TILE + 2 j)^2 region pixels a tile: 12,336 at P = 8, 36,704
// at P = 16, where two launches of 8 update 24,672 and pay one launch and
// a round trip of 4 bytes a pixel more. So past 8 passes another launch is
// cheaper than a wider halo; and 8 is what BakedRenderer runs from 640
// pixels of width, so every frame of the repo's paths takes one fill
// launch. At P = 8 a block's shared memory is 28,040 bytes.
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
#include <math_constants.h>

#define SPLAT_THREADS 256
#define TILE 32
#define HALO_MAX 8
#define FILL_THREADS 256
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

// bits(WIN_TOP) + 1: WIN_TOP = BIG * WIN_FACTOR, the largest z that wins a
// pixel whose z-buffer is empty.
__device__ __forceinline__ int key_top() {
  return __float_as_int(__fmul_rn(__int_as_float(BIG_BITS),
                                  __int_as_float(WIN_FACTOR_BITS))) +
         1;
}

// The z-buffer value of a key: min(BIG, its z); a key of 0 decodes to
// WIN_TOP's successor, so to BIG.
__device__ __forceinline__ float zbuf_of(int key, int top) {
  return fminf(__int_as_float(top - key), __int_as_float(BIG_BITS));
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
    const int top = key_top();
    if (__float_as_int(z) < top) atomicMax(zkey + p, top - __float_as_int(z));
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
                   const int* __restrict__ zkey, float4* __restrict__ sums,
                   int* __restrict__ sem) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int p = -1;  // the pixel this splat wins, -1 for none
  if (i < k) {
    const int q = pid[i];
    if (q >= 0 && zs[i] <= __fmul_rn(zbuf_of(zkey[q], key_top()),
                                     __int_as_float(WIN_FACTOR_BITS)))
      p = q;
  }
  float4 term = make_float4(0.0f, 0.0f, 0.0f, 1.0f);
  int cls = 0;
  if (p >= 0) {
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
    term = make_float4(col[0], col[1], col[2], 1.0f);
    cls = semantic[i] + 1;
  }
  if (p >= 0) {
    atomicAdd(sums + p, term);
    atomicMax(sem + p, cls);
  }
}

struct Fill {
  int height, width;
  const int* zkey;
  const float4* sums;
  const int* sem;
  const int* carry_in;  // null on the first launch: each pixel its own source
  int* carry_out;       // null on the last launch, which writes the outputs
  float* image;         // (n, 3)
  float* depth;
  int* classes;
  unsigned char* splat_hit;
};

// i / w for 0 <= i < w * w, w <= TILE + 2 HALO_MAX, by a product with
// 1 / w: (i + 0.5) / w lies at least 0.5 / w from an integer, far beyond
// the product's rounding error at these sizes.
__device__ __forceinline__ int div_small(int i, float inv_w) {
  return (int)(((float)i + 0.5f) * inv_w);
}

__host__ __device__ inline size_t fill_shared_bytes(int halo) {
  const size_t rw = TILE + 2 * halo, area = rw * rw;
  return (area + 1) * sizeof(float2) + 2 * rw * sizeof(int) +
         2 * area * sizeof(unsigned short);
}

// Region pixels a thread loads, tile pixels it writes.
#define LOAD_MAX \
  (((TILE + 2 * HALO_MAX) * (TILE + 2 * HALO_MAX) + FILL_THREADS - 1) / \
   FILL_THREADS)
#define OUT_PER_THREAD (TILE * TILE / FILL_THREADS)
static_assert(TILE * TILE % FILL_THREADS == 0, "tile pixels a thread");

// A neighbour q (its depth and radius o) is taken when its footprint
// reaches the ring and it is nearer than best_d.
__device__ __forceinline__ void gate(int q, float2 o, float scale, float ring,
                                     float& best_d, int& best) {
  if (__fadd_rn(__fmul_rn(o.y, scale), 0.5f) >= ring && o.x < best_d) {
    best_d = o.x;
    best = q;
  }
}

// One pixel of a pass: region index r, its rows above, at and below
// (sources q, their depth and radius o; the row below loaded here from
// row r + rw). JAX's gate: the nearest neighbour whose footprint reaches
// `ring` and that is nearer than what the pixel shows by a margin (a hole:
// than BIG), neighbours dy outer, dx inner, jnp.roll(a, (dy, dx))[y, x] =
// a[y - dy, x - dx], the strict < keeping the first of equals. Writes the
// pixel's source to next[r]; returns whether it adopted one.
__device__ __forceinline__ bool fill_pixel(
    const unsigned short* __restrict__ src, unsigned short* __restrict__ next,
    const float2* __restrict__ orig, int r, int rw, int none, float ring,
    float cell3, const int (&qa)[3], const float2 (&oa)[3],
    const int (&qm)[3], const float2 (&om)[3], int (&qb)[3],
    float2 (&ob)[3]) {
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    qb[b] = src[r + rw + b - 1];
    ob[b] = orig[qb[b]];
  }
  const float big = __int_as_float(BIG_BITS);
  const int own = qm[1];
  const bool h = own != none;
  const float d = om[1].x;
  // the depth a neighbour must beat: anything for a hole, a margin nearer
  // for a covered pixel; best_d is min(beat, the depth taken so far)
  const float beat =
      h ? __fsub_rn(d, fmaxf(cell3, __fmul_rn(0.05f, d))) : big;
  float best_d = fminf(beat, big);
  const float scale = h ? 1.0f : 2.0f;  // holes accept twice the radius
  int best = own;
  // (dy, dx) = (-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1),
  // (1, 0), (1, 1): the pixels below right, below, below left, right,
  // left, above right, above, above left
  gate(qb[2], ob[2], scale, ring, best_d, best);
  gate(qb[1], ob[1], scale, ring, best_d, best);
  gate(qb[0], ob[0], scale, ring, best_d, best);
  gate(qm[2], om[2], scale, ring, best_d, best);
  gate(qm[0], om[0], scale, ring, best_d, best);
  gate(qa[2], oa[2], scale, ring, best_d, best);
  gate(qa[1], oa[1], scale, ring, best_d, best);
  gate(qa[0], oa[0], scale, ring, best_d, best);
  next[r] = (unsigned short)best;
  return best != own;
}

__global__ void __launch_bounds__(FILL_THREADS)
    fill_kernel(Fill f, int halo, int first_pass, float cell, float focal) {
  extern __shared__ float2 smem[];
  const int rw = TILE + 2 * halo, area = rw * rw;
  // orig[r]: depth and footprint radius of region pixel r's source at the
  // launch's start (hit pixels), orig[area] the sentinel of none (depth
  // BIG, radius -inf: it reaches no ring and is nearer than nothing)
  float2* orig = smem;
  int* row_of = reinterpret_cast<int*>(orig + area + 1);  // row * width
  int* col_of = row_of + rw;
  unsigned short* src = reinterpret_cast<unsigned short*>(col_of + rw);
  unsigned short* next = src + area;
  const float big = __int_as_float(BIG_BITS);
  const float cf = __fmul_rn(cell, focal);
  const int top = key_top();
  const int y0 = blockIdx.y * TILE - halo, x0 = blockIdx.x * TILE - halo;
  for (int j = threadIdx.x; j < 2 * rw; j += FILL_THREADS) {
    // jnp.roll's wrap-around: frame rows and columns modulo H and W
    if (j < rw) {
      const int y = ((y0 + j) % f.height + f.height) % f.height;
      row_of[j] = y * f.width;
    } else {
      col_of[j - rw] = ((x0 + j - rw) % f.width + f.width) % f.width;
    }
  }
  if (threadIdx.x == 0) orig[area] = make_float2(big, -CUDART_INF_F);
  __syncthreads();
  // The region's z keys (through the carried sources after the first
  // launch), every load of a thread issued before any is used.
  const float inv_rw = 1.0f / (float)rw;
  int key[LOAD_MAX];
#pragma unroll
  for (int j = 0; j < LOAD_MAX; ++j) {
    const int r = threadIdx.x + j * FILL_THREADS;
    key[j] = 0;
    if (r < area) {
      const int ry = div_small(r, inv_rw);
      key[j] = __ldg((f.carry_in == nullptr ? f.zkey : f.carry_in) +
                     row_of[ry] + col_of[r - ry * rw]);
    }
  }
  if (f.carry_in != nullptr) {
#pragma unroll
    for (int j = 0; j < LOAD_MAX; ++j)
      if (key[j] != 0) key[j] = __ldg(f.zkey + key[j] - 1);
  }
#pragma unroll
  for (int j = 0; j < LOAD_MAX; ++j) {
    const int r = threadIdx.x + j * FILL_THREADS;
    if (r >= area) continue;
    if (key[j] != 0) {
      const float d = zbuf_of(key[j], top);
      orig[r] =
          make_float2(d, __fdiv_rn(cf, __fmul_rn(2.0f, fmaxf(d, 1e-6f))));
      src[r] = (unsigned short)r;
    } else {
      src[r] = (unsigned short)area;
    }
  }
  const float cell3 = __fmul_rn(3.0f, cell);
  __syncthreads();
  for (int pass = 1; pass <= halo; ++pass) {
    // The pixels pass `pass` updates, `pass` or more from the region's
    // edge: a w x w square, cut into w columns of `strips` strips. A thread
    // sweeps one strip down its column with the 3 x 3 neighbourhood's
    // sources, depths and radii in registers (three rows whose roles
    // rotate), so it reads 3 sources and 3 of their (depth, radius) a
    // pixel, not 9 and 9.
    const int w = rw - 2 * pass;
    const int strips = max(FILL_THREADS / w, 1);
    const int rows = (w + strips - 1) / strips;
    const int strip = div_small(threadIdx.x, 1.0f / (float)w);
    const float ring = (float)(first_pass + pass);
    bool adopted = false;
    int y = strip * rows;
    const int y1 = min(y + rows, w);
    if (strip < strips && y < y1) {
      int r = (y + pass) * rw + threadIdx.x - strip * w + pass;
      int q0[3], q1[3], q2[3];
      float2 o0[3], o1[3], o2[3];
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        q0[b] = src[r - rw + b - 1];
        o0[b] = orig[q0[b]];
        q1[b] = src[r + b - 1];
        o1[b] = orig[q1[b]];
      }
      for (; y + 3 <= y1; y += 3, r += 3 * rw) {
        adopted |= fill_pixel(src, next, orig, r, rw, area, ring, cell3, q0,
                              o0, q1, o1, q2, o2);
        adopted |= fill_pixel(src, next, orig, r + rw, rw, area, ring,
                              cell3, q1, o1, q2, o2, q0, o0);
        adopted |= fill_pixel(src, next, orig, r + 2 * rw, rw, area, ring,
                              cell3, q2, o2, q0, o0, q1, o1);
      }
      if (y < y1)
        adopted |= fill_pixel(src, next, orig, r, rw, area, ring, cell3, q0,
                              o0, q1, o1, q2, o2);
      if (y + 1 < y1)
        adopted |= fill_pixel(src, next, orig, r + rw, rw, area, ring,
                              cell3, q1, o1, q2, o2, q0, o0);
    }
    unsigned short* t = src;
    src = next;
    next = t;
    // A pass in which no pixel adopts leaves the state as it was, and the
    // next pass's rings only reach less far: no later pass adopts either.
    if (!__syncthreads_or(adopted)) break;
  }
  // Each tile pixel's source in the frame (-1 for none), then its outputs
  // (or, before the last launch, its source for the next), every load of
  // a thread issued before any is used.
  long long pix[OUT_PER_THREAD];
  int source[OUT_PER_THREAD], own_s[OUT_PER_THREAD];
#pragma unroll
  for (int j = 0; j < OUT_PER_THREAD; ++j) {
    const int t = threadIdx.x + j * FILL_THREADS;
    const int y = blockIdx.y * TILE + t / TILE;
    const int x = blockIdx.x * TILE + t % TILE;
    pix[j] = y < f.height && x < f.width ? (long long)y * f.width + x : -1;
    own_s[j] = src[(t / TILE + halo) * rw + t % TILE + halo];
    source[j] = -1;
    if (pix[j] >= 0 && own_s[j] != area) {
      const int sy = div_small(own_s[j], inv_rw);
      source[j] = row_of[sy] + col_of[own_s[j] - sy * rw];
      if (f.carry_in != nullptr) source[j] = __ldg(f.carry_in + source[j]) - 1;
    }
  }
  if (f.carry_out != nullptr) {
#pragma unroll
    for (int j = 0; j < OUT_PER_THREAD; ++j)
      if (pix[j] >= 0) f.carry_out[pix[j]] = source[j] + 1;
    return;
  }
  float4 acc[OUT_PER_THREAD];
  int cls[OUT_PER_THREAD], hit[OUT_PER_THREAD];
#pragma unroll
  for (int j = 0; j < OUT_PER_THREAD; ++j) {
    if (pix[j] < 0) continue;
    hit[j] = __ldg(f.zkey + pix[j]);
    if (source[j] >= 0) {
      acc[j] = f.sums[source[j]];
      cls[j] = __ldg(f.sem + source[j]);
    }
  }
  // the background rule: a pixel no splat reached is white, at depth 0,
  // class 0; every other class id drops the +1 of the scatter
#pragma unroll
  for (int j = 0; j < OUT_PER_THREAD; ++j) {
    const long long p = pix[j];
    if (p < 0) continue;
    f.splat_hit[p] = hit[j] != 0;
    if (source[j] < 0) {
      for (int ch = 0; ch < 3; ++ch) f.image[3 * p + ch] = 1.0f;
      f.depth[p] = 0.0f;
      f.classes[p] = 0;
      continue;
    }
    const float div = fmaxf(acc[j].w, 1.0f);
    f.image[3 * p] = __fdiv_rn(acc[j].x, div);
    f.image[3 * p + 1] = __fdiv_rn(acc[j].y, div);
    f.image[3 * p + 2] = __fdiv_rn(acc[j].z, div);
    f.depth[p] = orig[own_s[j]].x;
    f.classes[p] = max(cls[j] - 1, 0);
  }
}

static unsigned blocks(long long count) {
  return (unsigned)((count + SPLAT_THREADS - 1) / SPLAT_THREADS);
}

// camera: fx, fy, cx, cy, the rotation (row-major) and the translation of
// T_CW and the camera centre, 19 floats on the host. sh may be null.
// work: the colour sums and counts (4 n floats, 16-byte aligned), the z
// keys (n), the classes (n), then each splat's pixel (k) and z (k). carry:
// 2 n ints when passes > HALO_MAX, else unused. Returns a cudaError_t.
extern "C" int splat_render(const float* points, const float* rgb,
                            const float* sh, const int* semantic,
                            const unsigned char* valid, long long k,
                            const float* camera, int height, int width,
                            int passes, float cell, float focal,
                            int* work, int* carry, float* image,
                            float* depth, int* classes,
                            unsigned char* splat_hit, void* stream_ptr) {
  const long long n = (long long)height * width;
  if (k < 0 || height <= 0 || width <= 0 || passes < 0 || n >= (1LL << 31))
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
  float4* sums = reinterpret_cast<float4*>(work);
  int* zkey = work + 4 * n;
  int* sem = zkey + n;
  int* pid = sem + n;
  float* zs = reinterpret_cast<float*>(pid + k);
  cudaError_t err = cudaMemsetAsync(work, 0, sizeof(int) * 6 * n, stream);
  if (err != cudaSuccess) return (int)err;
  // with no splat the launches are kept, so the count is the same
  const unsigned splat_blocks = k > 0 ? blocks(k) : 1;
  project_kernel<<<splat_blocks, SPLAT_THREADS, 0, stream>>>(
      points, valid, k, c, height, width, pid, zs, zkey);
  winners_kernel<<<splat_blocks, SPLAT_THREADS, 0, stream>>>(
      points, rgb, sh, semantic, k, c, pid, zs, zkey, sums, sem);
  const dim3 grid((width + TILE - 1) / TILE, (height + TILE - 1) / TILE);
  int done = 0, launch = 0;
  do {
    const int halo = passes - done < HALO_MAX ? passes - done : HALO_MAX;
    const bool last = done + halo == passes;
    const Fill f{height, width, zkey, sums, sem,
                 done == 0 ? nullptr : carry + (launch + 1) % 2 * n,
                 last ? nullptr : carry + launch % 2 * n,
                 image, depth, classes, splat_hit};
    fill_kernel<<<grid, FILL_THREADS, fill_shared_bytes(halo), stream>>>(
        f, halo, done, cell, focal);
    done += halo;
    ++launch;
  } while (done < passes);
  return (int)cudaGetLastError();
}
