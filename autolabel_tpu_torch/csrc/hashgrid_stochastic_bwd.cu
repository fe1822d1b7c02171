// The table gradient of the stochastic-corner and residual encodes (K7):
// a weighted scatter-add of the rows the forward (K6,
// hashgrid_stochastic.cu) drew.
//
// Replaces what XLA compiles on the TPU for the VJP of the `jnp.take`s of
// autolabel_tpu/ops/encoders.py `_encode_stochastic`,
// `_encode_stochastic_simplex` and `_encode_residual`: per point and level,
// from the rows and weights K6 wrote (hashgrid_stochastic.cuh), the level's
// slice of the cotangent g (N, L * F, fp32) goes into each of its rows in
// fp32: a DRAWS row takes g * (1 / n_samples) (g itself for one sample: the
// VJP of the product XLA makes of `acc / n_samples`; no weight is read), a
// RESIDUAL or EXACT row w * g (w_m and 1 - w_m; every atom at its weight).
// Only the plan's rows of each level are read and scattered: no padded row
// costs an atomic.
//
// What bounds it on the H100: the atomics. At TPU_GRID with 2 draws and
// the train CLI's N = 524,288 it makes 4 levels x 2 rows x N = 4.2 M row
// updates of 512 bytes (32 float4 atomics each), resolved in L2 (a
// level's 16 MiB gradient stays there); the bytes it must move (g, the
// rows, the 64 MiB gradient written once) take about 0.35 ms at 3.35
// TB/s. On the reference preset (16 x 2^19 x 2) it is 16 x 2 x N = 16.8 M
// row updates of 8 bytes, one float2 atomic each.
//
// Design, a simple kernel first. The gradient is zeroed with
// cudaMemsetAsync. Wide rows (F a multiple of 4, at least 32): a warp per
// (point, level), levels slowest in the grid; its lanes read the level's
// slice of g float4 wide once and add each row's term with one float4
// atomic a lane. Narrow rows: a thread per (point, level), levels slowest,
// one float2 atomic a row where F = 2, else F scalar atomics. Why not K2s
// (hashgrid_sampled_bwd.cu): it takes one atom count A in {4, 8} for every
// level and wide rows only, and groups a tile's targets in shared memory
// for the flagship's few thousand subsampled points; here the levels mix
// kinds (n_samples draws, 2 residual rows, A exact atoms), every point
// scatters, and the reference preset's rows are 8 bytes. Atomics make the
// last bits of the sums nondeterministic.
#include "hashgrid_stochastic.cuh"

#define K7_THREADS 256
#define K7_WARPS (K7_THREADS / 32)

// A warp per (point, level); lanes over features, float4 wide.
__global__ void __launch_bounds__(K7_THREADS)
    stochastic_scatter_rows_kernel(const float* __restrict__ g,
                                   const int* __restrict__ idx,
                                   const float* __restrict__ wts,
                                   float* __restrict__ dtable, Plan plan,
                                   float scale, long long n, int levels,
                                   long long table_size, int features) {
  const int l = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long p = (long long)blockIdx.x * K7_WARPS + warp;
  if (p >= n) return;
  const int kind = plan.kind[l], R = plan.rows[l];
  const float* src = g + (p * levels + l) * (long long)features;
  float* level = dtable + (long long)l * table_size * features;
  for (int f = lane * 4; f < features; f += 128) {
    float4 gv = *reinterpret_cast<const float4*>(src + f);
    if (kind == KIND_DRAWS && scale != 1.0f)
      gv = make_float4(__fmul_rn(gv.x, scale), __fmul_rn(gv.y, scale),
                       __fmul_rn(gv.z, scale), __fmul_rn(gv.w, scale));
    for (int r = 0; r < R; ++r) {
      float4 t = gv;
      if (kind != KIND_DRAWS) {
        const float w = __ldg(wts + (long long)(plan.wfirst[l] + r) * n + p);
        t = make_float4(__fmul_rn(gv.x, w), __fmul_rn(gv.y, w),
                        __fmul_rn(gv.z, w), __fmul_rn(gv.w, w));
      }
      const int row = __ldg(idx + (long long)(plan.first[l] + r) * n + p);
      atomicAdd(reinterpret_cast<float4*>(
                    level + (long long)row * features + f),
                t);
    }
  }
}

// A thread per (point, level); any feature width.
__global__ void __launch_bounds__(K7_THREADS)
    stochastic_scatter_lanes_kernel(const float* __restrict__ g,
                                    const int* __restrict__ idx,
                                    const float* __restrict__ wts,
                                    float* __restrict__ dtable, Plan plan,
                                    float scale, long long n, int levels,
                                    long long table_size, int features) {
  const int l = blockIdx.y;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int kind = plan.kind[l], R = plan.rows[l];
  const float* src = g + (p * levels + l) * (long long)features;
  float* level = dtable + (long long)l * table_size * features;
  for (int r = 0; r < R; ++r) {
    const float w =
        kind == KIND_DRAWS
            ? scale
            : __ldg(wts + (long long)(plan.wfirst[l] + r) * n + p);
    const bool weighted = kind != KIND_DRAWS || scale != 1.0f;
    const int row = __ldg(idx + (long long)(plan.first[l] + r) * n + p);
    float* dst = level + (long long)row * features;
    if (features == 2) {  // the reference's rows: one 8-byte atomic
      const float2 v = *reinterpret_cast<const float2*>(src);
      atomicAdd(reinterpret_cast<float2*>(dst),
                weighted ? make_float2(__fmul_rn(v.x, w), __fmul_rn(v.y, w))
                         : v);
      continue;
    }
    for (int f = 0; f < features; ++f) {
      const float v = __ldg(src + f);
      atomicAdd(dst + f, weighted ? __fmul_rn(v, w) : v);
    }
  }
}

static dim3 k7_grid(long long n, int levels, bool wide) {
  const int chunk = wide ? K7_WARPS : K7_THREADS;
  return dim3((unsigned int)((n + chunk - 1) / chunk), levels);
}

extern "C" int hashgrid_stochastic_bwd(const float* g, const int* idx,
                                       const float* w, const int* kinds,
                                       const int* rows, float* dtable,
                                       long long n, int levels,
                                       long long table_size, int features,
                                       int n_samples, void* stream) {
  Plan plan;
  if (!make_plan(&plan, kinds, rows, levels, 0, n_samples) || features < 1 ||
      (!w && weighted_rows(plan, levels)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      dtable, 0, (size_t)levels * table_size * features * sizeof(float), s);
  if (err != cudaSuccess || n == 0) return (int)err;
  const float scale = n_samples > 1 ? 1.0f / (float)n_samples : 1.0f;
  const bool wide = wide_rows(features);
  const dim3 grid = k7_grid(n, levels, wide);
  if (wide)
    stochastic_scatter_rows_kernel<<<grid, K7_THREADS, 0, s>>>(
        g, idx, w, dtable, plan, scale, n, levels, table_size, features);
  else
    stochastic_scatter_lanes_kernel<<<grid, K7_THREADS, 0, s>>>(
        g, idx, w, dtable, plan, scale, n, levels, table_size, features);
  return (int)cudaGetLastError();
}

// out[0..7): the launch shape for n points: blocks, threads, static shared
// bytes, blocks per SM, registers per thread, points per block, and 1 for
// the wide kernel, 0 for the narrow one.
extern "C" int hashgrid_stochastic_bwd_shape(int levels, int features,
                                             long long n, int* out) {
  const bool wide = wide_rows(features);
  const void* kernel = wide ? (const void*)stochastic_scatter_rows_kernel
                            : (const void*)stochastic_scatter_lanes_kernel;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      K7_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = k7_grid(n, levels, wide);
  out[0] = (int)(grid.x * grid.y);
  out[1] = K7_THREADS;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = per_sm;
  out[4] = attr.numRegs;
  out[5] = wide ? K7_WARPS : K7_THREADS;
  out[6] = wide;
  return 0;
}
