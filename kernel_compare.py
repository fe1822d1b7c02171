#!/usr/bin/env python3
"""Time the port's kernels against another checkout's, in turns, on one
CUDA card.

    git archive <commit> autolabel_tpu_torch | tar -x -C build/parent
    python3 kernel_compare.py [--parent build/parent] [--rounds 4]

Both packages are imported side by side, each as a module tree of its own
that builds its kernels into a build directory beside itself, and every
kernel of the main path is called through each package's public wrapper
on the same inputs: K1 at TPU_GRID (wide rows) and on the reference
presets' lattices ('native', 'tcnn', 'torch_ngp': 16 x 2^19 x 2, narrow
rows), K2 at TPU_GRID and on the tcnn lattice (narrow rows), K3f, K3b,
K4f and K4b at chip_smoke.py's shapes, K2 also on the (g, x) of a step
of chip_smoke.py's training slice, and K5
and K2s on the inputs a flagship step hands them (chip_smoke.py's
flagship 'xla' leg after 200 steps; K2s fed one (sel, coef, count), this
tree's K5's), and K1s in its four instantiations (simplex or trilinear
atoms; the training form, bf16 out with the atoms written, or the eval
form, fp32 out) on the (table, x) a flagship step hands it (N = 131,072)
and on the last step's of a short run of the train CLI (README's command,
the ray-ordered samples of N = 524,288 a step), and K6 (training form,
rows written) and K7 on the last step's (table, x) of short runs of the
CLI's stochastic estimators: Run C (--sampled-backward 0: the TPU grid's
simplex encode of 2 draws) and Run D (--grid-preset reference
--stochastic-exact-levels 4: 16 x 2^19 x 2, trilinear, narrow rows), K7
fed this tree's K6 rows, and K8 (the splat render) on frames of scenes
baked from the flagship field with seeded weights: the render CLI's
--baked defaults at 480 x 360 (4 passes), full and tied clouds of 2^19
valid splats there, and the interactive preview (2^18 splats, 1280 x 720,
8 passes), and K2x (the encode's gradient for the points) in
chip_smoke.py's phase 16 (a) forms at N = 131,072, on Run D's lattice and
plan, and on what the register CLI's first iteration hands it at its
defaults (2,048 rays x 64 samples, TPU_GRID simplex) on chip_smoke.py's
pose room trained 30 iterations (`--only K2x` runs these alone, about 4
minutes with both builds). Each kernel's old and new outputs are compared
(largest absolute difference; 0 means bit-equal; for K5 whether the
selections, count, points and coefs, are bit-equal; for K7 the worst
element's share of hashgrid_cuda.stochastic_backward_tolerance, at most
1; for K8 depth, classes and splat_hit equal and the image's worst share
of twice the tie rule's tolerance; for K2x the worst share of
encoders.point_grad_tolerance), then both are timed by CUDA events,
old, new, new, old, ... for
--rounds rounds, and by torch.profiler's device time a call (all of a
call's kernels and memsets; events carry a call's host work where it
exceeds its device time); K7 with one index_add_ of the pre-weighted
drawn rows timed in the same rounds, its library yardstick, and K8 with
the three scatter_reduce_ calls of its scatter stage, its device time
split into the fill (the resolve and the passes) and the scatter stage,
and its wrapper's host time a call. Then, for this
tree alone, K6's parts on the same inputs (the draws with their rows
written, the gathers and blend, the stores, each launched alone; on Run D
also the levels a narrow thread walks: 1, levels slowest, and 4, a
32-byte sector a point, beside the library's choice of all 16), K7's
scatter of each level alone and the distinct rows a tile of K7's points
(a block's on wide rows, a warp's on narrow rows) names per level, and
K2x's parts on each wide-rows form (g's stream, the gathers, the
reduction with the partials' stores, the level sum, each alone), and K1's
narrow rows on the tcnn lattice, uniform and ray-ordered points, walked
in level groups of 16, 8, 4, 2 and 1 and, for comparison, K6's narrow
kernel on a plan of every level exact, beside their byte bound and
sector floor (`--only 'K1 reference'` runs the narrow cases and these
alone, with no recorded inputs). --only takes a regular expression of the cases to run (e.g.
'K6|K7'). Prints one line per kernel and writes
chiprun_out/kernel_compare.json.

`--only K9` runs K9's parts alone (about a minute): the parent's damped
product (csrc/ba_normal.cu's entry 2 as the parent checkout has it, with
its point atomics) in parts, built from copies of the parent's source cut
by macros (`K9_PARENT_PARTS`): the loads, projection and J v alone; + the
camera scan and its atomics; + the point atomics; + `damp_kernel` (the
entry); and the point atomics made plain stores; each by events and
device time in turns on chip_smoke.py's mapping-ba-300x40k problem;
what one grid.sync() of a cooperative kernel of 256-thread blocks costs
at 1, 2, 4 and 8 blocks a multiprocessor; and this tree's fused solve
(entry 3) in parts, from copies of its source cut the same way
(`K9_SOLVE_PARTS`), in turns with the solve itself at lam 1e-2 and 50
iterations.

K2's narrow rows (the tcnn lattice, 16 x 2^19 x 2, N = 524,288): 'K2
reference tcnn N', 'K2 reference tcnn ray-ordered' and 'K2 reference cli
E step' (the last of 30 steps of chip_smoke.py's Run E, the reference
preset's exact estimator) against the parent's, each beside one
index_add_ of the pre-weighted corner rows (chip_smoke.k2_yardstick);
'K2 narrow parts' the parent's kernel in parts (`K2N_PARENT_PARTS`,
copies of its source cut by macros, and its kernel on each level alone
and on the dense and the hashed levels together), with the request
floor (the 16-byte pieces warps of 32 points need at the least); 'K2
narrow variants' this tree's kernel in `K2N_VARIANTS` (copies of its
source cut the same way; one sums level 0 in each block's shared memory
instead of merging within the warp). `--only 'K2 narrow parts'` runs the parent's
parts alone, without building either package.
"""
import argparse
import dataclasses
import functools
import importlib
import json
import os
import re
import sys
import types

from chip_smoke import (_cuda_ms, _gpu_line, _k2x_forms, _k8_host_us,
                        _kernel_ms, _ray_points, k2_yardstick, k7_yardstick)

K9_PARENT_PARTS = {1: 'loads, projection and J v alone',
                   2: '+ the camera scan and its atomics',
                   3: '+ the point atomics', 4: '+ damp_kernel (the entry)',
                   5: 'part 3 with the point atomics as stores'}
# The parent's matvec_kernel / scatter / entry 2, and what each part keeps.
_K9_CUTS = (
    ("""  if (o.live) {
    const float* Rc = R + 9 * o.c;
    float* gp = g + 6 * m + 3 * o.p;
    for (int j = 0; j < 3; ++j)
      atomicAdd(gp + j, Rc[j] * gx[0] + Rc[3 + j] * gx[1] + Rc[6 + j] * gx[2]);
  }""", """  if (o.live) {
    const float* Rc = R + 9 * o.c;
    float* gp = g + 6 * m + 3 * o.p;
#if K9_PART == 5
    for (int j = 0; j < 3; ++j)
      k9_store[3 * o.n + j] = Rc[j] * gx[0] + Rc[3 + j] * gx[1]
                              + Rc[6 + j] * gx[2];
#elif K9_PART >= 3
    for (int j = 0; j < 3; ++j)
      atomicAdd(gp + j, Rc[j] * gx[0] + Rc[3 + j] * gx[1] + Rc[6 + j] * gx[2]);
#else
    float s = 0.f;
    for (int j = 0; j < 3; ++j)
      s += Rc[j] * gx[0] + Rc[3 + j] * gx[1] + Rc[6 + j] * gx[2];
    if (s == 1234.5f) gp[0] = s;
#endif
  }"""),
    ("""__device__ __forceinline__ float scatter(""",
     """__device__ float* k9_store;
__device__ __forceinline__ float scatter("""),
    ("  int c, p;       // camera and point, c = -1 for a lane past N",
     "  int c, p;       // camera and point, c = -1 for a lane past N\n"
     "  long long n;"),
    ("  o.live = n < N;\n", "  o.live = n < N;\n  o.n = n;\n"),
    ("""  const float gf = scatter(o, R, A, o.w * j0, o.w * j1, m, out);""",
     """#if K9_PART == 1
  if (o.live && j0 == 1234.5f && j1 == 5432.1f) out[0] = j0;
  return;
#endif
  const float gf = scatter(o, R, A, o.w * j0, o.w * j1, m, out);"""),
    ("""  damp_kernel<<<blocks(L), BA_THREADS, 0, stream>>>(vec, lam, L, m,
                                                    refine_focal, out);""",
     """#if K9_PART == 4
  damp_kernel<<<blocks(L), BA_THREADS, 0, stream>>>(vec, lam, L, m,
                                                    refine_focal, out);
#endif"""),
)
K9_SOLVE_PARTS = {1: "the loop's grid barriers and its head's dot alone",
                  2: "+ the product's observation pass",
                  3: "+ the product's gather and q . Aq",
                  4: '+ the q and x, r updates (the solve)'}
# cg_solve_kernel's loop, and what each part keeps; parts 1-3 run maxiter
# iterations whatever the stop test says.
_K9_SOLVE_CUTS = (
    ('''    if (k >= s.maxiter || !(gamma > atol2)) break;
''', '''#if K9_SOLVE_PART < 4
    if (k >= s.maxiter) break;
#else
    if (k >= s.maxiter || !(gamma > atol2)) break;
#endif
'''),
    ('''      for (long long i = gtid; i < s.L; i += threads)
        __stcg(qk + i, __fmaf_rn(beta, __ldcg(qk_prev + i), __ldcg(s.r + i)));
''', '''#if K9_SOLVE_PART >= 4
      for (long long i = gtid; i < s.L; i += threads)
        __stcg(qk + i, __fmaf_rn(beta, __ldcg(qk_prev + i), __ldcg(s.r + i)));
#endif
'''),
    ('''    const float focal = product_obs(s, scale, qk);
    if (s.refine_focal) {
      const float f = block_sum<SOLVE_WARPS>(focal, shared);
      if (threadIdx.x == 0) __stcg(s.part_f + blockIdx.x, f);
      __syncthreads();
    }
''', '''#if K9_SOLVE_PART >= 2
    const float focal = product_obs(s, scale, qk);
    if (s.refine_focal) {
      const float f = block_sum<SOLVE_WARPS>(focal, shared);
      if (threadIdx.x == 0) __stcg(s.part_f + blockIdx.x, f);
      __syncthreads();
    }
#endif
'''),
    ('''    product_gather(s, qk, shared);
''', '''#if K9_SOLVE_PART >= 3
    product_gather(s, qk, shared);
#endif
'''),
    ('''    const float alpha = gamma / grid_dot(s.part_qAq, shared);
''', '''#if K9_SOLVE_PART >= 4
    const float alpha = gamma / grid_dot(s.part_qAq, shared);
'''),
    ('''    block_leaves(acc, shared, s.part_rr + blockIdx.x);
    grid.sync();
  }
''', '''    block_leaves(acc, shared, s.part_rr + blockIdx.x);
#endif
    grid.sync();
  }
'''),
)
_K9_SYNC = r'''
#include <cooperative_groups.h>
#include <cuda_runtime.h>
__global__ void __launch_bounds__(256) sync_kernel(int k, float* out) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  float acc = 0.f;
  for (int i = 0; i < k; ++i) {
    acc += out[(blockIdx.x + i) % gridDim.x];
    grid.sync();
  }
  if (acc == 1234.5f) out[0] = acc;
}
extern "C" int sync_bench(int k, int per_sm, float* out, void* stream) {
  int dev, sms, occ;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, sync_kernel, 256, 0);
  if (per_sm > occ) return -1;
  void* args[] = {&k, &out};
  return (int)cudaLaunchCooperativeKernel((void*)sync_kernel, per_sm * sms,
                                          256, args, 0,
                                          (cudaStream_t)stream);
}
'''


def _k9_parts(parent, gpu, rounds):
    """The parent's K9 product in parts, and a grid sync's cost."""
    import ctypes
    import subprocess
    import numpy as np
    import torch
    from chip_smoke import _ba_problem, _ba_tensors
    from autolabel_tpu_torch.mapping import ba
    from autolabel_tpu_torch.ops import _kernels
    out_dir = os.path.join(HERE, 'build', 'k9_parts')
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(parent, PKG, 'csrc', 'ba_normal.cu')) as f:
        src = f.read()
    for old, new in _K9_CUTS:
        if old not in src:
            raise RuntimeError('K9 parts: the parent\'s ba_normal.cu is not '
                               'the design these cuts were written for')
        src = src.replace(old, new)
    src += ('extern "C" int k9_set_store(float* p) {\n'
            '  return (int)cudaMemcpyToSymbol(k9_store, &p, sizeof(p));\n}\n')
    with open(os.path.join(HERE, PKG, 'csrc', 'ba_normal.cu')) as f:
        solve_src = f.read()
    for old, new in _K9_SOLVE_CUTS:
        if old not in solve_src:
            raise RuntimeError('K9 solve parts: csrc/ba_normal.cu is not the '
                               'design these cuts were written for')
        solve_src = solve_src.replace(old, new)
    paths = {'parts': os.path.join(out_dir, 'parts.cu'),
             'sync': os.path.join(out_dir, 'sync.cu'),
             'solve': os.path.join(out_dir, 'solve.cu')}
    for key, text in (('parts', src), ('sync', _K9_SYNC),
                      ('solve', solve_src)):
        with open(paths[key], 'w') as f:
            f.write(text)
    jobs = {part: [f'-DK9_PART={part}', '-o',
                   os.path.join(out_dir, f'parts{part}.so'), paths['parts']]
            for part in K9_PARENT_PARTS}
    jobs.update({f'solve{part}': [
        f'-DK9_SOLVE_PART={part}', '-o',
        os.path.join(out_dir, f'solve{part}.so'), paths['solve']]
        for part in K9_SOLVE_PARTS})
    jobs['sync'] = ['-o', os.path.join(out_dir, 'sync.so'), paths['sync']]
    procs = {k: subprocess.Popen([_kernels._nvcc(), *_kernels.NVCC_FLAGS, *a],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, a in jobs.items()}
    for k, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'K9 parts: nvcc failed on {k}:\n{err}')
    dev = torch.device('cuda')
    prob = _ba_problem(18)
    order = np.argsort(prob['cam_idx'], kind='stable')
    params, unit = _ba_tensors(dev, prob['start'], prob['cam_idx'][order],
                               prob['pt_idx'][order], prob['xy'][order])
    const = unit[:4] + (ba._huber_sqrt_weights(params, unit, 4.0),)
    kern = ba.products(params, const, False)
    m, p, n = kern.m, kern.p, kern.n
    v = torch.randn(ba.size(m, p), generator=torch.Generator()
                    .manual_seed(3)).to(dev)
    store = torch.empty(3 * n, device=dev)
    out, work = torch.empty_like(v), torch.empty(1, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    ptr, f32, i32 = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    calls = {}
    for part in K9_PARENT_PARTS:
        lib = ctypes.CDLL(os.path.join(out_dir, f'parts{part}.so'))
        lib.k9_set_store.argtypes = [ptr]
        _kernels.check(lib.k9_set_store(store.data_ptr()), 'K9 parts')
        f = lib.ba_normal_matvec
        f.argtypes = ([ptr] * 5 + [f32] * 4 + [ptr] * 3 + [ctypes.c_longlong]
                      + [i32] * 3 + [ptr, f32, ptr, ptr, ptr])
        f.restype = i32
        calls[part] = (lambda f=f: _kernels.check(f(
            *kern._head(), kern.sw.data_ptr(), n, m, p, 0, v.data_ptr(),
            0.01, work.data_ptr(), out.data_ptr(), stream), 'K9 parts'))
    times = {part: [] for part in calls}
    device = {part: [] for part in calls}
    for r in range(rounds):
        for part in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            times[part].append(_cuda_ms(calls[part], 50))
            d = _kernel_ms(calls[part], 20)
            device[part].append(None if d is None else sum(d.values()))
    result = {'parts': {}, 'sync_us': {}}
    for part, name in K9_PARENT_PARTS.items():
        dev_ms = [d for d in device[part] if d is not None]
        result['parts'][part] = dict(name=name, ms=times[part],
                                     device_ms=device[part])
        print(f'K9 parent part {part} ({name}) [{gpu}], N = {n}: '
              f'{float(np.median(times[part])):.4f} ms by events, '
              f'{float(np.median(dev_ms)) if dev_ms else None} device '
              f'(rounds {[round(t, 4) for t in times[part]]})')
    sync = ctypes.CDLL(os.path.join(out_dir, 'sync.so')).sync_bench
    sync.argtypes = [i32, i32, ptr, ptr]
    sync.restype = i32
    buf = torch.zeros(4096, device=dev)
    for per_sm in (1, 2, 4, 8):
        ms = {}
        for k in (0, 1000):
            def call(k=k):
                status = sync(k, per_sm, buf.data_ptr(), stream)
                if status:
                    raise RuntimeError(f'grid sync bench: {status}')
            ms[k] = _cuda_ms(call, 5)
        us = (ms[1000] - ms[0]) / 1000 * 1e3
        result['sync_us'][per_sm] = us
        print(f'grid sync [{gpu}]: {per_sm} blocks of 256 a multiprocessor: '
              f'{us:.3f} us a grid.sync()')
    result['solve_parts'] = _k9_solve_parts(out_dir, kern, gpu, rounds)
    return result


def _k9_solve_parts(out_dir, kern, gpu, rounds):
    """This tree's fused solve in parts (K9_SOLVE_PARTS), each launched
    through KernelProducts.cg_solve with the cut copy's entry in place of
    the built one, in turns with the built entry."""
    import ctypes
    import numpy as np
    from autolabel_tpu_torch.ops import ba_cuda
    from chip_smoke import BA_CG
    real = ba_cuda._launchers()
    b = -kern.residual_grad()[2]

    def through(entry):
        def call():
            saved = ba_cuda._launchers
            ba_cuda._launchers = lambda: (real[0], real[1], entry, real[3])
            try:
                kern.cg_solve(b, 1e-2, BA_CG)
            finally:
                ba_cuda._launchers = saved
        return call

    calls = {'entry': through(real[2])}
    for part in K9_SOLVE_PARTS:
        f = ctypes.CDLL(os.path.join(out_dir, f'solve{part}.so')).ba_cg_solve
        f.argtypes, f.restype = real[2].argtypes, real[2].restype
        calls[part] = through(f)
    times = {part: [] for part in calls}
    device = {part: [] for part in calls}
    for r in range(rounds):
        for part in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            times[part].append(_cuda_ms(calls[part], 10))
            d = _kernel_ms(calls[part], 5)
            device[part].append(None if d is None else sum(d.values()))
    k = int(kern.cg_solve(b, 1e-2, BA_CG)[1])
    out = {}
    for part in calls:
        name = K9_SOLVE_PARTS.get(part, 'the built entry')
        dev_ms = [d for d in device[part] if d is not None]
        out[part] = dict(name=name, ms=times[part], device_ms=device[part])
        print(f'K9 solve part {part} ({name}) [{gpu}], {BA_CG} iterations '
              f'(the solve: {k}): {float(np.median(times[part])):.4f} ms by '
              f'events, {float(np.median(dev_ms)) if dev_ms else None} device'
              f' (rounds {[round(t, 4) for t in times[part]]})')
    return out


# K2's narrow rows in parts: copies of the parent's csrc/hashgrid_bwd.cu
# (its first-form scatter_lanes_kernel, a thread a (point, level) issuing
# an atomic a feature and corner) cut by -DK2N_PART, each launched through
# the copy's own hashgrid_encode_bwd (its memset included).
K2N_PARENT_PARTS = {1: 'the kernel as it is',
                    2: 'its atomics as plain stores',
                    3: "x's stream and the cells alone",
                    4: "+ g's stream",
                    5: '+ the corner rows, weights and products, no writes'}
_K2N_CUTS = (
    ('// One thread per point of level blockIdx.y; any feature width.\n',
     '__device__ int k2n_first;  // the first level launched\n'
     'static int k2n_count = 0;  // the levels launched, 0 for all\n'
     '// One thread per point of level blockIdx.y; any feature width.\n'),
    ('  const int l = blockIdx.y;\n'
     '  const long long p = (long long)blockIdx.x * blockDim.x'
     ' + threadIdx.x;\n',
     '  const int l = blockIdx.y + k2n_first;\n'
     '  const long long p = (long long)blockIdx.x * blockDim.x'
     ' + threadIdx.x;\n'),
    ('  const float* src = g + (p * levels + l) * (long long)features;\n',
     '  const float* src = g + (p * levels + l) * (long long)features;\n'
     '#if K2N_PART == 3 || K2N_PART == 4\n'
     '  float keep = cell.f[0] + cell.f[1] + cell.f[2]\n'
     '               + (float)(cell.c[0] ^ cell.c[1] ^ cell.c[2]);\n'
     '#if K2N_PART == 4\n'
     '  for (int f = 0; f < features; ++f) keep += __ldg(src + f);\n'
     '#endif\n'
     '  if (keep == 1234.5f) level[0] = keep;\n'
     '  return;\n'
     '#endif\n'
     '#if K2N_PART == 5\n'
     '  float keep = 0.f;\n'
     '#endif\n'),
    ('      atomicAdd(row + f, __fmul_rn(__ldg(src + f), w));\n  }\n}\n',
     '#if K2N_PART == 2\n'
     '      row[f] = __fmul_rn(__ldg(src + f), w);\n'
     '#elif K2N_PART == 5\n'
     '      keep += __fmul_rn(__ldg(src + f), w) + (float)(idx & 7);\n'
     '#else\n'
     '      atomicAdd(row + f, __fmul_rn(__ldg(src + f), w));\n'
     '#endif\n'
     '  }\n'
     '#if K2N_PART == 5\n'
     '  if (keep == 1234.5f) level[0] = keep;\n'
     '#endif\n'
     '}\n'),
    ('    scatter_lanes_kernel<<<grid, K2_THREADS, 0, s>>>(',
     '    scatter_lanes_kernel<<<dim3(grid.x, k2n_count ? k2n_count'
     ' : grid.y), K2_THREADS, 0, s>>>('),
)


def _k2n_inputs(seed, config, n=524288):
    """K2 narrow's inputs on the tcnn lattice: g and, as _narrow_rows makes
    them, uniform and ray-ordered points (on the card)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    xs = {'uniform': torch.rand((n, 3), generator=g),
          'ray-ordered': _ray_points(n, g)}
    cot = torch.randn((n, config.out_dim), generator=g)
    return cot.to('cuda'), {k: v.to('cuda') for k, v in xs.items()}


def _k2n_floor(gpu, name, x, config):
    """K2 narrow's byte bound and its atomic request floor on x: the least
    16-byte atomic requests a warp of 32 points makes (the distinct
    16-byte pieces of each warp's corner rows, level by level), beside the
    8 L N F scalar atomics of the parent's form."""
    from autolabel_tpu_torch.ops import hashgrid_cuda as hg
    from chip_smoke import PEAK_BYTES
    n, f = x.shape[0], config.n_features
    pieces = hg.gather_sectors(x, config, points=32, sector=16)
    nbytes = (x.numel() + n * config.out_dim
              + config.n_levels * config.table_size * f) * 4
    out = dict(byte_bound_ms=nbytes / PEAK_BYTES * 1e3,
               warp_pieces=pieces, warp_pieces_total=sum(pieces),
               scalar_atomics=8 * config.n_levels * n * f)
    print(f'K2 narrow [{gpu}] tcnn N={n} {name}: byte bound '
          f'{out["byte_bound_ms"]:.4f} ms; warps of 32 points request '
          f'{sum(pieces)} 16-byte pieces at the least (by level {pieces}), '
          f'against the parent\'s {out["scalar_atomics"]} scalar atomics')
    return out


def _k2n_build(name, src, cuts, flags, csrc):
    """Copies of a hashgrid_bwd.cu source cut by `cuts` (each text found
    once), built by nvcc in parallel, one a {key: extra flags} of `flags`,
    into build/<name>/; returns {key: the library's path}, printing each
    build's register and spill report."""
    import subprocess
    from autolabel_tpu_torch.ops import _kernels
    out_dir = os.path.join(HERE, 'build', name)
    os.makedirs(out_dir, exist_ok=True)
    for old, new in cuts:
        if src.count(old) != 1:
            raise RuntimeError(f'{name}: hashgrid_bwd.cu is not the design '
                               'these cuts were written for')
        src = src.replace(old, new)
    path = os.path.join(out_dir, 'cut.cu')
    with open(path, 'w') as f:
        f.write(src)
    sos = {key: os.path.join(out_dir, f'cut{i}.so')
           for i, key in enumerate(flags)}
    procs = {key: subprocess.Popen(
        [_kernels._nvcc(), *_kernels.NVCC_FLAGS, *extra, '-I', csrc, '-o',
         sos[key], path], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for key, extra in flags.items()}
    for key, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'{name}: nvcc failed on {key}:\n{err}')
        print(f'{name} {key}: ' + '; '.join(
            line.split('ptxas info    : ')[-1].strip()
            for line in err.splitlines()
            if 'registers' in line or 'spill' in line))
    return sos


def _k2n_entry(so):
    """A built copy's hashgrid_encode_bwd, its signature set."""
    import ctypes
    lib = ctypes.CDLL(so)
    fn = lib.hashgrid_encode_bwd
    fn.argtypes = ([ctypes.c_void_p] * 9
                   + [ctypes.c_float, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def _k2n_launch(fn, cot, x, config, dtable, before=None):
    """A call of a built copy's entry on (cot, x) into dtable; `before`
    runs first (a part's level selection)."""
    import torch
    from autolabel_tpu_torch.ops import _kernels
    from autolabel_tpu_torch.ops import hashgrid_cuda as hg
    geometry = hg._geometry(config)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        if before is not None:
            before()
        _kernels.check(fn(
            x.data_ptr(), cot.data_ptr(), dtable.data_ptr(),
            *[a.ctypes.data for a in geometry], float(config.pos_offset),
            x.shape[0], config.n_levels, config.table_size,
            config.n_features, stream), 'K2 narrow cut copy')
        return dtable
    return call


def _k2n_turns(gpu, tag, calls, rounds, reps, kernel):
    """calls timed in turns (forward, then backward order) for `rounds`
    rounds, by events and by device ms a call, all kernels and memsets
    and the one whose name holds `kernel` alone; prints the medians."""
    import numpy as np
    res = dict(ms={k: [] for k in calls}, device_ms={k: [] for k in calls},
               kernel_device_ms={k: [] for k in calls})
    for r in range(rounds):
        for k in list(calls)[::1 if r % 2 == 0 else -1]:
            res['ms'][k].append(_cuda_ms(calls[k], reps))
            by_kernel = _kernel_ms(calls[k])
            res['device_ms'][k].append(
                None if by_kernel is None else sum(by_kernel.values()))
            res['kernel_device_ms'][k].append(
                None if by_kernel is None else
                sum(v for name, v in by_kernel.items() if kernel in name))
    for k in calls:
        dev = [d for d in res['device_ms'][k] if d is not None]
        kern = [d for d in res['kernel_device_ms'][k] if d is not None]
        print(f'{tag} [{gpu}] {k}: {float(np.median(res["ms"][k])):.4f} ms '
              f'by events, {float(np.median(dev)) if dev else None} device, '
              f'{float(np.median(kern)) if kern else None} the kernel alone '
              f'(rounds {[round(v, 4) for v in res["ms"][k]]})')
    return res


def _k2n_parts(parent, gpu, rounds, seed, reps=10):
    """The parent's K2 narrow rows in parts (K2N_PARENT_PARTS) on the tcnn
    lattice at N = 524,288, uniform and ray-ordered points, and part 1 (the
    kernel) on each level alone and on the dense and the hashed levels
    together; by events and device ms (the kernel's own and with its
    memset), in turns, with the request floor."""
    import ctypes
    import torch
    from autolabel_tpu_torch.ops import encoders
    from autolabel_tpu_torch.ops import hashgrid_cuda as hg
    csrc = os.path.join(parent, PKG, 'csrc')
    with open(os.path.join(csrc, 'hashgrid_bwd.cu')) as f:
        src = f.read() + ('extern "C" int k2n_select(int first, int count) {\n'
                          '  k2n_count = count;\n'
                          '  return (int)cudaMemcpyToSymbol(k2n_first, '
                          '&first, sizeof(int));\n}\n')
    sos = _k2n_build('k2n_parts', src, _K2N_CUTS,
                     {p: [f'-DK2N_PART={p}'] for p in K2N_PARENT_PARTS}, csrc)
    entries = {p: _k2n_entry(so) for p, so in sos.items()}
    for lib, _ in entries.values():
        lib.k2n_select.argtypes = [ctypes.c_int, ctypes.c_int]
    config = _reference_lattices(encoders)[' tcnn']
    n_dense = int(sum(encoders.level_geometry(config)[3]))
    cot, xs = _k2n_inputs(seed, config)
    dtable = torch.empty((config.n_levels, config.table_size,
                          config.n_features), device='cuda')

    def launch(part, x, first=0, count=0):
        lib, fn = entries[part]
        return _k2n_launch(fn, cot, x, config, dtable, lambda: (
            hg._kernels.check(lib.k2n_select(first, count),
                              'K2 narrow parts')))

    result = dict(dense_levels=n_dense, parts=K2N_PARENT_PARTS)
    for name, x in xs.items():
        floor = _k2n_floor(gpu, name, x, config)
        same = float((launch(1, x)() - hg.hashgrid_encode_backward_plain(
            cot, x, config)).abs().max())
        print(f'K2 narrow parent parts [{gpu}] {name}: part 1 against the '
              f'plain version max |d| {same:.3e}')
        calls = {f'part {p} ({what})': launch(p, x)
                 for p, what in K2N_PARENT_PARTS.items()}
        calls.update({f'level {l}': launch(1, x, l, 1)
                      for l in range(config.n_levels)})
        calls[f'dense levels 0-{n_dense - 1}'] = launch(1, x, 0, n_dense)
        calls[f'hashed levels {n_dense}-{config.n_levels - 1}'] = launch(
            1, x, n_dense, config.n_levels - n_dense)
        result[name] = dict(floor=floor, part1_max_abs_err=same,
                            **_k2n_turns(gpu, f'K2 narrow parent {name}',
                                         calls, rounds, reps,
                                         'scatter_lanes'))
    return result


# This tree's K2 narrow rows (scatter_group_kernel) in variants: copies of
# csrc/hashgrid_bwd.cu cut by -DK2N_VARIANT / -DK2N_GROUP, each launched
# through the copy's own hashgrid_encode_bwd, in turns with the built one.
K2N_VARIANTS = {'no warp merge': ['-DK2N_VARIANT=1'],
                'warp merge every level': ['-DK2N_VARIANT=4'],
                'level 0 privatised in shared memory': ['-DK2N_VARIANT=5'],
                'no pair merge': ['-DK2N_VARIANT=2'],
                'scalar atomics, no merges': ['-DK2N_VARIANT=3'],
                'a level a thread': ['-DK2N_GROUP=1'],
                '2 levels a thread': ['-DK2N_GROUP=2'],
                '8 levels a thread': ['-DK2N_GROUP=8'],
                '16 levels a thread': ['-DK2N_GROUP=16']}
_K2N_VARIANT_CUTS = (
    ('#include "hashgrid_common.cuh"\n',
     '#include "hashgrid_common.cuh"\n'
     '#ifndef K2N_VARIANT\n#define K2N_VARIANT 0\n#endif\n'
     '#ifndef K2N_GROUP\n#define K2N_GROUP 0\n#endif\n'
     '#define K2N_PRIV 10240  // variant 5: most floats of level 0 kept\n'
     '__device__ int k2n_yoff;  // variant 5: the first group launched\n'),
    # variant 5: level 0, where dense and within K2N_PRIV floats, added
    # into shared memory by the blocks of group 0 (launched alone, with
    # that dynamic shared memory) and flushed once a block, a float4
    # atomic a nonzero piece; the other groups launched after, without.
    ('// A thread per (point, slice of W features) walks levels [g0, g0 + '
     'group)\n',
     '#if K2N_VARIANT == 5\n'
     '__device__ __forceinline__ void add_shared(float* priv,\n'
     '                                           unsigned long long key,\n'
     '                                           float4 v, int width) {\n'
     '  if (key == K2N_NONE) return;\n'
     '  float* d = priv + (key >> 1);\n'
     '  atomicAdd(d, v.x);\n'
     '  if (width > 1) atomicAdd(d + 1, v.y);\n'
     '  if (width > 2) {\n'
     '    atomicAdd(d + 2, v.z);\n'
     '    atomicAdd(d + 3, v.w);\n'
     '  }\n'
     '}\n'
     '#endif\n'
     '// A thread per (point, slice of W features) walks levels [g0, g0 + '
     'group)\n'),
    ('  if (!__any_sync(0xffffffffu, live)) return;\n'
     '  const int g0 = blockIdx.y * group;\n',
     '#if K2N_VARIANT == 5\n'
     '  const int g0 = (blockIdx.y + k2n_yoff) * group;\n'
     '  extern __shared__ __align__(16) float priv[];\n'
     '  const int total0 = (int)geo.l[0].size * features;\n'
     '  const bool private0 = W == 2 && g0 == 0 && geo.l[0].dense &&\n'
     '                        total0 <= K2N_PRIV && total0 % 4 == 0;\n'
     '  if (private0) {\n'
     '    for (int i = threadIdx.x; i < total0; i += K2N_THREADS)\n'
     '      priv[i] = 0.0f;\n'
     '    __syncthreads();\n'
     '  }\n'
     '#else\n'
     '  if (!__any_sync(0xffffffffu, live)) return;\n'
     '  const int g0 = blockIdx.y * group;\n'
     '#endif\n'),
    ('      scatter_round(level, k0, v0, merged ? 2 * W : W, warp_stage, '
     'lane,\n',
     '#if K2N_VARIANT == 5\n'
     '      if (private0 && l == 0) {\n'
     '        add_shared(priv, k0, v0, merged ? 2 * W : W);\n'
     '        add_shared(priv, k1, t1, W);\n'
     '        continue;\n'
     '      }\n'
     '#endif\n'
     '      scatter_round(level, k0, v0, merged ? 2 * W : W, warp_stage, '
     'lane,\n'),
    ('      scatter_round(level, k1, t1, W, warp_stage, lane, merge);\n'
     '    }\n  }\n}\n',
     '      scatter_round(level, k1, t1, W, warp_stage, lane, merge);\n'
     '    }\n  }\n'
     '#if K2N_VARIANT == 5\n'
     '  if (private0) {\n'
     '    __syncthreads();\n'
     '    for (int i = 4 * threadIdx.x; i < total0; i += 4 * K2N_THREADS) {\n'
     '      const float4 v = *reinterpret_cast<const float4*>(priv + i);\n'
     '      if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f)\n'
     '        atomicAdd(reinterpret_cast<float4*>(dtable + i), v);\n'
     '    }\n'
     '  }\n'
     '#endif\n'
     '}\n'),
    ('    case 2:\n'
     '      scatter_group_kernel<2><<<grid, K2N_THREADS, 0, s>>>(\n'
     '          x, g, dtable, geo, offset, n, levels, table_size, features, '
     'group);\n'
     '      break;\n',
     '    case 2:\n'
     '#if K2N_VARIANT == 5\n'
     '    {\n'
     '      int yoff = 0;\n'
     '      cudaMemcpyToSymbolAsync(k2n_yoff, &yoff, sizeof(int), 0,\n'
     '                              cudaMemcpyHostToDevice, s);\n'
     '      scatter_group_kernel<2><<<dim3(grid.x, 1), K2N_THREADS,\n'
     '                                K2N_PRIV * sizeof(float), s>>>(\n'
     '          x, g, dtable, geo, offset, n, levels, table_size, features, '
     'group);\n'
     '      if (grid.y > 1) {\n'
     '        yoff = 1;\n'
     '        cudaMemcpyToSymbolAsync(k2n_yoff, &yoff, sizeof(int), 0,\n'
     '                                cudaMemcpyHostToDevice, s);\n'
     '        scatter_group_kernel<2><<<dim3(grid.x, grid.y - 1), '
     'K2N_THREADS, 0,\n'
     '                                  s>>>(\n'
     '            x, g, dtable, geo, offset, n, levels, table_size, '
     'features,\n'
     '            group);\n'
     '      }\n'
     '      break;\n'
     '    }\n'
     '#endif\n'
     '      scatter_group_kernel<2><<<grid, K2N_THREADS, 0, s>>>(\n'
     '          x, g, dtable, geo, offset, n, levels, table_size, features, '
     'group);\n'
     '      break;\n'),
    ('__device__ __forceinline__ void add_piece(float* dst, float4 v, '
     'int width) {\n',
     '__device__ __forceinline__ void add_piece(float* dst, float4 v, '
     'int width) {\n'
     '#if K2N_VARIANT == 3\n'
     '  atomicAdd(dst, v.x);\n'
     '  if (width > 1) atomicAdd(dst + 1, v.y);\n'
     '  if (width > 2) {\n'
     '    atomicAdd(dst + 2, v.z);\n'
     '    atomicAdd(dst + 3, v.w);\n'
     '  }\n'
     '  return;\n'
     '#endif\n'),
    ('    float* level = dtable + (long long)l * table_size * features;\n',
     '    float* level = dtable + (long long)l * table_size * features;\n'
     '#if K2N_VARIANT == 1 || K2N_VARIANT == 3\n'
     '    const bool merge = false;\n'
     '#elif K2N_VARIANT == 4\n'
     '    const bool merge = true;\n'
     '#else\n'),
    ('    const bool merge = __any_sync(0xffffffffu, live && mates != '
     '(1u << lane));\n',
     '    const bool merge = __any_sync(0xffffffffu, live && mates != '
     '(1u << lane));\n'
     '#endif\n'),
    ('  const bool pairs = slices == 1 && W < 4;\n',
     '  const bool pairs =\n'
     '      K2N_VARIANT != 2 && K2N_VARIANT != 3 && slices == 1 && W < 4;\n'),
    ('  const int chosen = K2N_SECTOR / features;\n',
     '  const int chosen = K2N_GROUP ? K2N_GROUP : K2N_SECTOR / features;\n'),
)


def _k2n_variants(gpu, rounds, seed, exact=None, reps=10):
    """This tree's K2 narrow rows in K2N_VARIANTS, on the tcnn lattice at
    N = 524,288, uniform and ray-ordered points, and on Run E's recorded
    (g, x, config) where given, by events and device ms a call (memset
    included), in turns with the built kernel; each held within
    hashgrid_cuda.backward_tolerance."""
    import torch
    from autolabel_tpu_torch.ops import encoders
    from autolabel_tpu_torch.ops import hashgrid_cuda as hg
    csrc = os.path.join(HERE, PKG, 'csrc')
    with open(os.path.join(csrc, 'hashgrid_bwd.cu')) as f:
        src = f.read()
    entries = {name: _k2n_entry(so)[1] for name, so in _k2n_build(
        'k2n_variants', src, _K2N_VARIANT_CUTS, K2N_VARIANTS, csrc).items()}
    config = _reference_lattices(encoders)[' tcnn']
    cot, xs = _k2n_inputs(seed, config)
    inputs = {kind: (cot, x, config) for kind, x in xs.items()}
    if exact is not None:
        inputs['cli E step'] = exact
    result = {}
    for kind, (cot, x, config) in inputs.items():
        dtable = torch.empty((config.n_levels, config.table_size,
                              config.n_features), device='cuda')
        calls = {'built': lambda cot=cot, x=x, config=config:
                 hg.hashgrid_encode_backward(cot, x, config)}
        calls.update({name: _k2n_launch(fn, cot, x, config, dtable)
                      for name, fn in entries.items()})
        tol = hg.backward_tolerance(cot, x, config)
        want = hg.hashgrid_encode_backward_plain(cot, x, config)
        held = {k: bool(((call() - want).abs() <= tol).all())
                for k, call in calls.items()}
        del tol, want
        print(f'K2 narrow variants [{gpu}] {kind}: within tolerance {held}')
        if not all(held.values()):
            raise RuntimeError(f'K2 narrow variants: {kind}: a variant '
                               f'misses the tolerance: {held}')
        result[kind] = dict(held=held, **_k2n_turns(
            gpu, f'K2 narrow variant {kind}', calls, rounds, reps,
            'scatter_group'))
    return result


HERE = os.path.dirname(os.path.abspath(__file__))
PKG = 'autolabel_tpu_torch'
MODULES = ('ops._kernels', 'ops.encoders', 'ops.hashgrid_cuda',
           'ops.heads_cuda', 'ops.mlp', 'ops.splat_cuda')


def _load(root):
    """The package under root as a module tree of its own: the modules of
    MODULES by their last name. sys.modules is left as it was."""
    def ours(name):
        return name == PKG or name.startswith(PKG + '.')
    saved = {k: sys.modules.pop(k) for k in list(sys.modules) if ours(k)}
    sys.path.insert(0, root)
    try:
        mods = {m.split('.')[-1].lstrip('_'): importlib.import_module(
            f'{PKG}.{m}') for m in MODULES}
    finally:
        sys.path.remove(root)
        for k in [k for k in sys.modules if ours(k)]:
            del sys.modules[k]
        sys.modules.update(saved)
    return types.SimpleNamespace(**mods)


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [] if out is None else [out]


def _max_diff(a, b):
    return max((float((x - y).abs().max()) if x.numel() else 0.0)
               for x, y in zip(_flat(a), _flat(b)))


def _step_samples(seed, steps=40):
    """The (g, x) that a training step's backward hands K2, recorded from
    chip_smoke.py's training slice (this tree's package) after `steps`
    steps: the main path's own ray-ordered traffic."""
    import torch
    from chip_smoke import _record_k2_inputs, _train_slice
    trainer, loader, _ = _train_slice(torch.device('cuda'), seed)
    trainer.train_iterations(loader, steps)
    return _record_k2_inputs(trainer, loader)


def _flagship_samples(seed, steps=200):
    """What a flagship step hands K5 (g, u, k) and K2s (the atoms and rows),
    recorded from chip_smoke.py's flagship 'xla' leg (this tree's package)
    after `steps` steps, with the grid config and this tree's K5 selection
    (sel, coef, count)."""
    import torch
    from autolabel_tpu_torch.ops import hashgrid_cuda
    from chip_smoke import (TRAIN_CHUNK, _flagship_options, _model_config,
                            _record_flagship_inputs, _train_slice)
    trainer, loader, _ = _train_slice(torch.device('cuda'), seed,
                                      _model_config('simplex', 'xla'),
                                      _flagship_options(), 'compare')
    for _ in range(steps // TRAIN_CHUNK):
        trainer.train_iterations(loader, TRAIN_CHUNK)
    rec = _record_flagship_inputs(trainer, loader, hashgrid_cuda)
    g, u, k = rec['select']
    return dict(g=g, u=u, k=k, atoms=rec['scatter'], encode=rec['atoms'],
                grid=trainer.field.config.grid_config,
                selection=hashgrid_cuda.select_points(g, u, k))


def _cli_samples(iters=30):
    """The (table, x) the train CLI's last step hands K1s (README's command,
    4,096 rays x 128 samples, this tree's package) after `iters` steps on
    the sphere scene chip_smoke.py's phase 10 writes, with its grid."""
    from autolabel_tpu_torch.ops import hashgrid_cuda
    from autolabel_tpu_torch.train import __main__ as cli
    from autolabel_tpu_torch.utils import fixtures
    from chip_smoke import CLI_SCENE, WORK_DIR
    root = os.path.join(WORK_DIR, 'compare_cli')
    scene = os.path.join(root, 'sphere')
    fixtures.make_synthetic_scene(scene, **CLI_SCENE)
    rec, atoms = {}, hashgrid_cuda._atoms_call

    def rec_atoms(table, x, config, interp, out_dtype, with_atoms):
        if with_atoms:
            rec['atoms'] = (table.detach().clone(), x.clone())
        return atoms(table, x, config, interp, out_dtype, with_atoms)

    hashgrid_cuda._atoms_call = rec_atoms
    try:
        run = cli.main([scene, '--proposal', '--factor-train', '1',
                        '--iters', str(iters),
                        '--workspace', os.path.join(root, 'ws')])
    finally:
        hashgrid_cuda._atoms_call = atoms
    return rec['atoms'], run.trainer.field.config.grid_config


# The CLI's stochastic estimators (chip_smoke.py's phase 11 runs C and D).
STOCHASTIC_RUNS = {'C': ['--sampled-backward', '0'],
                   'D': ['--grid-preset', 'reference',
                         '--stochastic-exact-levels', '4']}


def _stochastic_samples(iters=30):
    """{run: (table, x, config, interp, n_samples, plan)}: what the last of
    `iters` steps of each of STOCHASTIC_RUNS hands K6 (this tree's
    package), on the sphere scene of chip_smoke.py's phase 10."""
    from autolabel_tpu_torch.ops import hashgrid_cuda
    from autolabel_tpu_torch.train import __main__ as cli
    from autolabel_tpu_torch.utils import fixtures
    from chip_smoke import CLI_SCENE, WORK_DIR
    root = os.path.join(WORK_DIR, 'compare_stochastic')
    scene = os.path.join(root, 'sphere')
    fixtures.make_synthetic_scene(scene, **CLI_SCENE)
    out, call = {}, hashgrid_cuda._stochastic_call
    for run, flags in STOCHASTIC_RUNS.items():
        rec = {}

        def rec_call(table, x, u, config, interp, n_samples, plan, rows,
                     **kw):
            if rows:
                rec['last'] = (table.detach().clone(), x.clone(), config,
                               interp, n_samples, plan)
            return call(table, x, u, config, interp, n_samples, plan, rows,
                        **kw)

        hashgrid_cuda._stochastic_call = rec_call
        try:
            cli.main([scene, '--proposal', '--factor-train', '1', *flags,
                      '--iters', str(iters),
                      '--workspace', os.path.join(root, run)])
        finally:
            hashgrid_cuda._stochastic_call = call
        out[run] = rec['last']
    return out


def _exact_samples(iters=30):
    """(g, x, config): what the last of `iters` steps of chip_smoke.py's Run
    E (CLI_EXACT: the reference preset's exact estimator) hands K2 (this
    tree's package), on the sphere scene of chip_smoke.py's phase 10."""
    from autolabel_tpu_torch.ops import hashgrid_cuda
    from autolabel_tpu_torch.train import __main__ as cli
    from autolabel_tpu_torch.utils import fixtures
    from chip_smoke import CLI_BASE, CLI_EXACT, CLI_SCENE, WORK_DIR
    root = os.path.join(WORK_DIR, 'compare_exact')
    scene = os.path.join(root, 'sphere')
    fixtures.make_synthetic_scene(scene, **CLI_SCENE)
    rec, launch = {}, hashgrid_cuda._launch_backward

    def record(g, x, config):
        rec['last'] = (g.detach().clone(), x.detach().clone(), config)
        return launch(g, x, config)

    hashgrid_cuda._launch_backward = record
    try:
        cli.main([scene, *CLI_BASE, *CLI_EXACT[0], '--factor-train', '1',
                  '--iters', str(iters), '--workspace',
                  os.path.join(root, 'E')])
    finally:
        hashgrid_cuda._launch_backward = launch
    return rec['last']


def _lazy(make):
    """A call that makes its function on first use (a yardstick's inputs,
    made only for the side that times it)."""
    made = []

    def call():
        if not made:
            made.append(make())
        return made[0]()
    return call


def _k2_narrow_cases(pkg, seed, exact):
    """{name: (fn(pkg), reps, compare, library, library name)}: K2's narrow
    rows on the tcnn lattice at N = 524,288 with ray-ordered points (the
    uniform ones are _synthetic_cases' 'K2 reference tcnn'), and on Run
    E's recorded (g, x); each with the index_add_ yardstick
    (chip_smoke.k2_yardstick)."""
    hg = pkg.hashgrid_cuda
    config = _reference_lattices(pkg.encoders)[' tcnn']
    cot, xs = _k2n_inputs(seed, config)
    x_r = xs['ray-ordered']
    cases = {f'K2 reference tcnn ray-ordered N={x_r.shape[0]}': (
        lambda: hg.hashgrid_encode_backward(cot, x_r, config), 5, None,
        _lazy(lambda: k2_yardstick(pkg.encoders, cot, x_r, config)))}
    if exact is not None:
        g_e, x_e, config_e = exact
        cases[f'K2 reference cli E step N={x_e.shape[0]}'] = (
            lambda: hg.hashgrid_encode_backward(g_e, x_e, config_e), 5, None,
            _lazy(lambda: k2_yardstick(pkg.encoders, g_e, x_e, config_e)))
    return cases


def _stochastic_cases(pkg, seed, samples):
    """K6 (training form) and K7 through pkg's wrappers on each run's
    recorded (table, x), with u and g made from seed and K7 fed this
    tree's K6 rows; K7's compare is the worst share of its tolerance, and
    its fourth element the index_add_ yardstick."""
    import torch
    from autolabel_tpu_torch.ops import hashgrid_cuda as ours
    g = torch.Generator(device='cuda').manual_seed(seed + 1)
    cases = {}
    for run, (table, x, config, interp, n_samples, plan) in samples.items():
        n = x.shape[0]
        u = torch.rand(ours.encoders.uniform_shape(
            config.n_levels, n, interp, n_samples), generator=g,
            device='cuda')
        cot = torch.randn((n, config.out_dim), generator=g, device='cuda')
        _, idx, w = ours._stochastic_call(table, x, u, config, interp,
                                          n_samples, plan, True)
        tol = ours.stochastic_backward_tolerance(cot, idx, w, plan, config,
                                                 n_samples)

        def used(a, b, tol=tol):
            return float(((a - b).abs() / tol.clamp(min=1e-38)).max())

        cases[f'K6 cli {run} step N={n}'] = (
            lambda table=table, x=x, u=u, config=config, interp=interp,
            n_samples=n_samples, plan=plan: pkg.hashgrid_cuda.
            _stochastic_call(table, x, u, config, interp, n_samples, plan,
                             True), 20, None)
        cases[f'K7 cli {run} step N={n}'] = (
            lambda cot=cot, idx=idx, w=w, plan=plan, config=config,
            n_samples=n_samples: pkg.hashgrid_cuda._stochastic_scatter_call(
                cot, idx, w, plan, config, n_samples), 20, used,
            k7_yardstick(ours.encoders, cot, idx, w, plan, config,
                         n_samples))
    return cases


def _k8_samples(seed):
    """{case: (splat args, K, T, height, width, passes, cell)}: K8's frames
    on scenes made by this tree's package from the flagship field with
    seeded weights (chip_smoke.py's phase 13): the baked scene (the render
    CLI's --baked defaults: 192^3, 2^19 rows, adaptive threshold) at 480 x
    360, 4 passes; chip_smoke.py's full and tied clouds of 2^19 valid
    splats there; the preview (128^3, 2^18 splats, threshold 0) at 1280 x
    720, 8 passes. Cameras: phase 13's first orbit pose, focal 0.9 w."""
    import numpy as np
    import torch
    from autolabel_tpu_torch.models.field import Field, FieldConfig
    from autolabel_tpu_torch.ops import splat_cuda
    from autolabel_tpu_torch.ops.encoders import TPU_GRID
    from autolabel_tpu_torch.render.baked import bake, fill_passes_for
    from chip_smoke import (PREVIEW_RESOLUTION, PREVIEW_SIZE, PREVIEW_SPLATS,
                            _full_cloud, _preview_pose)
    dev = torch.device('cuda')
    field = Field(FieldConfig(encoding='hg+freq', hidden_dim=128,
                              hidden_dim_color=128, hidden_dim_semantic=64,
                              semantic_classes=6, bound=2.0, grid=TPU_GRID,
                              proposal=True),
                  device=dev, generator=torch.Generator().manual_seed(seed))
    T = _preview_pose(0, 30)

    def camera(w, h):
        return np.array([[0.9 * w, 0, w / 2], [0, 0.9 * w, h / 2],
                         [0, 0, 1.0]])

    def args(scene):
        return (scene.points, scene.rgb, scene.sh, scene.semantic,
                scene.valid)

    cli = bake(field, resolution=192, max_points=2 ** 19)
    preview = bake(field, resolution=PREVIEW_RESOLUTION,
                   max_points=PREVIEW_SPLATS, alpha_threshold=0.0)
    w, h = 480, 360
    K = camera(w, h)
    z, _, _, _, ok, _ = splat_cuda.project_plain(
        cli.points, cli.rgb, cli.sh, cli.valid, K, T, h, w)
    z_range = (float(z[ok].min()), float(z[ok].max()))
    out = {f'baked scene {w}x{h}': (args(cli), K, T, h, w,
                                    fill_passes_for(w, 2), cli.cell_size)}
    for ties in (False, True):
        tag = f'{"tied " if ties else ""}full cloud {w}x{h}'
        out[tag] = (_full_cloud(dev, K, T, w, h, 2 ** 19, ties, z_range), K,
                    T, h, w, fill_passes_for(w, 2), cli.cell_size)
    w, h = PREVIEW_SIZE
    out[f'preview {w}x{h}'] = (args(preview), camera(w, h), T, h, w,
                               fill_passes_for(w, 2), preview.cell_size)
    return out


def _k8_cases(pkg, samples):
    """K8 through pkg's wrapper on each of _k8_samples' frames. Its compare
    holds old and new to K8's rules against each other: depth, classes and
    splat_hit equal (else inf), and the image's worst share of twice the
    tie rule's tolerance (each frame lies within it of the plain
    version); the three scatter_reduce_ calls of the scatter stage are the
    library yardstick."""
    import torch
    from autolabel_tpu_torch.ops import splat_cuda as ours
    cases = {}
    for tag, (args, K, T, h, w, passes, cell) in samples.items():
        tol = 2 * ours.image_tolerance(*args, K, T, h, w, passes, cell)

        def used(a, b, tol=tol):
            if not all(torch.equal(x, y) for x, y in zip(a[1:], b[1:])):
                return float('inf')
            err = (a[0] - b[0]).abs()
            if not torch.equal(a[0][tol == 0], b[0][tol == 0]):
                return float('inf')
            return float((err / tol.clamp(min=1e-38)).max())

        z, _, _, pid, ok, shaded = ours.project_plain(
            args[0], args[1], args[2], args[4], K, T, h, w)
        cases[f'K8 {tag} passes={passes}'] = (
            lambda args=args, K=K, T=T, h=h, w=w, passes=passes, cell=cell:
            pkg.splat_cuda.splat_render(*args, K, T, h, w, passes, cell),
            50, used,
            lambda z=z, pid=pid, ok=ok, shaded=shaded, sem=args[3], n=h * w:
            ours.scatter_plain(z, pid, ok, shaded, sem, n),
            'three scatter_reduce_ calls')
    return cases


def _k8_split(rounds):
    """Median device ms of K8's fill (resolve_kernel and fill_kernel, the
    parent's one launch a pass or the tiled fill) and of the rest (memset,
    project, winners) over the rounds' traces."""
    import numpy as np
    if any(r is None for r in rounds):
        return None
    fill = [sum(ms for k, ms in r.items() if 'fill_kernel' in k
                or 'resolve_kernel' in k) for r in rounds]
    rest = [sum(r.values()) - f for r, f in zip(rounds, fill)]
    return dict(fill=float(np.median(fill)), scatter=float(np.median(rest)))


def _timed(fn, reps=20):
    """(events ms, device ms) a call of fn."""
    by_kernel = _kernel_ms(fn)
    return _cuda_ms(fn, reps), (None if by_kernel is None
                                else sum(by_kernel.values()))


def _stochastic_parts(gpu, samples, seed):
    """This tree's K6 parts (and, on narrow rows, its level groupings) and
    K7's levels alone on each run's recorded inputs, and the distinct rows
    a tile of K7's points names per level."""
    import torch
    from autolabel_tpu_torch.ops import hashgrid_cuda as hg
    g = torch.Generator(device='cuda').manual_seed(seed + 2)
    out = {}
    for run, (table, x, config, interp, n_samples, plan) in samples.items():
        n, f = x.shape[0], config.n_features
        u = torch.rand(hg.encoders.uniform_shape(
            config.n_levels, n, interp, n_samples), generator=g,
            device='cuda')
        res = out[run] = {'K6': {}, 'K7': {}}
        wide = f % 4 == 0 and f >= 32
        variants = [(part, 0) for part in hg.K6_PARTS] + (
            [] if wide else [('all', 1), ('all', 4)])
        for part, group in variants:
            ms, dev = _timed(lambda part=part, group=group: hg._stochastic_call(
                table, x, u, config, interp, n_samples, plan, True, part,
                group))
            res['K6'][f'{part} group {group}'] = dict(ms=ms, device_ms=dev)
            print(f'K6 part cli {run} [{gpu}] {part}'
                  + (f' (levels a thread {group})' if group else '')
                  + f': {ms:.4f} ms by events, {dev} ms device')
        _, idx, w = hg._stochastic_call(table, x, u, config, interp,
                                        n_samples, plan, True)
        cot = torch.randn((n, config.out_dim), generator=g, device='cuda')
        dtable = torch.zeros(hg._table_shape(config), device='cuda')
        # K7's tiles: 32 points of every row of a level (wide), a warp's
        # 32 points of one row (narrow)
        tile = 32
        for l, (_, rows, first, _) in enumerate(
                hg.encoders.plan_starts(plan)):
            m = n // tile * tile
            t = idx[first:first + rows, :m].reshape(rows, -1, tile)
            t = (t.permute(1, 0, 2).reshape(m // tile, -1) if wide
                 else t.reshape(-1, tile)).sort(dim=1).values
            distinct = int((t[:, 1:] != t[:, :-1]).sum()) + t.shape[0]
            ms, dev = _timed(lambda l=l: hg._stochastic_scatter_call(
                cot, idx, w, plan, config, n_samples, l, dtable))
            res['K7'][l] = dict(entries=rows * m, distinct=distinct, ms=ms,
                                device_ms=dev)
            print(f'K7 level {l} cli {run} [{gpu}] N={n}: {rows * m} rows, '
                  f'{distinct} distinct in tiles of {tile} points; '
                  f'{ms:.4f} ms by events, {dev} ms device')
        del idx, w, cot, dtable, u
        torch.cuda.empty_cache()
    return out


# K2x's narrow-rows form on Run D's lattice (the reference preset, 16 x
# 2^19 x 2, trilinear) and plan (2 draws, the 4 finest levels exact).
K2X_RUN_D = 'reference 16x2x2^19 Run D plan'


def _k2x_samples(seed, iters=30):
    """{form: (g, table, x, config, interp, plan, rows)}: what K2x is handed
    in chip_smoke.py's phase 16 (a) forms at N = 131,072 and on Run D's
    lattice (points, tables and cotangents from seed; rows from this
    tree's K1s or K6), and in the register CLI's first iteration at its
    defaults (2,048 rays x 64 main samples, TPU_GRID simplex, K1s's atoms
    as rows) on chip_smoke.py's pose room trained `iters` iterations
    through the train CLI as phase 16 trains it."""
    import shutil
    import torch
    from autolabel_tpu_torch import register as register_cli
    from autolabel_tpu_torch.ops import hashgrid_cuda
    from autolabel_tpu_torch.ops.encoders import HashGridConfig
    from autolabel_tpu_torch.train import __main__ as cli
    from autolabel_tpu_torch.utils import fixtures
    from chip_smoke import (POSE_FRAME, POSE_PERTURB, POSE_SCENE, POSE_TRAIN,
                            WORK_DIR, _first_point_grad, _k2x_inputs)
    gen = torch.Generator().manual_seed(seed + 16)
    dev = torch.device('cuda')
    forms = _k2x_forms() + [(K2X_RUN_D, HashGridConfig(), 'trilinear',
                             (2, False, 4))]
    out = {tag: _k2x_inputs(gen, dev, config, interp, stochastic)
           for tag, config, interp, stochastic in forms}
    root = os.path.join(WORK_DIR, 'compare_register')
    shutil.rmtree(root, ignore_errors=True)
    scene = os.path.join(root, 'room')
    fixtures.make_room_scene(scene, **POSE_SCENE)
    trained = cli.main([scene, '--iters', str(iters), '--workspace',
                        os.path.join(root, 'ws')] + POSE_TRAIN)
    with _first_point_grad(hashgrid_cuda, {}) as rec:
        register_cli.main([scene, '--model-dir', trained.model_dir,
                           '--frame-index', str(POSE_FRAME), '--iters', '1']
                          + POSE_PERTURB)
    out['registration iteration'] = rec['args']
    return out


def _k2x_name(tag, args):
    return f'K2x {tag} N={args[2].shape[0]}'


def _k2x_cases(pkg, samples):
    """K2x through pkg's wrapper on each of _k2x_samples' forms; its compare
    is the worst element's share of encoders.point_grad_tolerance (each
    side lies within it of the plain version)."""
    from autolabel_tpu_torch.ops import encoders as ours
    cases = {}
    for tag, args in samples.items():
        tol = ours.point_grad_tolerance(*args)

        def used(a, b, tol=tol):
            return float(((a - b).abs() / tol.clamp(min=1e-38)).max())

        cases[_k2x_name(tag, args)] = (
            lambda args=args: pkg.hashgrid_cuda._point_grad_call(*args), 20,
            used)
    return cases


def _k2x_parts(gpu, samples):
    """This tree's K2x parts on each wide-rows form: g's stream, the
    gathers, the reduction with the partials' stores and the level sum,
    each alone, beside the whole call."""
    from autolabel_tpu_torch.ops import hashgrid_cuda as hg
    out = {}
    for tag, args in samples.items():
        if not hg._point_grad_partials(args[3].n_features):
            continue  # narrow rows: one kernel, no parts
        res = out[tag] = {}
        for part in hg.K2X_PARTS:
            ms, dev = _timed(lambda part=part: hg._point_grad_call(
                *args, parts=part))
            res[part] = dict(ms=ms, device_ms=dev)
            print(f'K2x part {tag} [{gpu}] {part}: {ms:.4f} ms by events, '
                  f'{dev} ms device')
    return out


def _same_selection(a, b):
    """0.0 where two K5 outputs (sel, coef, count) draw the same points with
    bit-equal coefs, else 1.0."""
    import torch
    m = int(a[2][0])
    same = (m == int(b[2][0]) and torch.equal(a[0][:m], b[0][:m])
            and torch.equal(a[1][:m], b[1][:m]))
    return 0.0 if same else 1.0


def _reference_lattices(encoders):
    """The reference presets at full size, 16 levels of up to 2^19 rows of
    2 features: 'native' (`--grid-preset reference`), 'tcnn' (a
    checkpoint imported from tcnn, chip_smoke.py's phase 14 (d)) and
    'torch_ngp' (desired resolution 2^18; level sizes not powers of
    two)."""
    ref = encoders.HashGridConfig()
    return {'': ref, ' tcnn': dataclasses.replace(ref, variant='tcnn'),
            ' torch_ngp': encoders.HashGridConfig.from_desired_resolution(
                2 ** 18, variant='torch_ngp')}


def _reference_table(config, g):
    """A seeded table of config's shape, rows beyond a level's size zero
    as an imported checkpoint's."""
    import torch
    table = torch.randn((config.n_levels, config.table_size,
                         config.n_features), generator=g) * 0.5
    for level, size in enumerate(config.level_sizes):
        table[level, size:] = 0.0
    return table


def _synthetic_cases(pkg, seed):
    """{name: (fn(pkg), reps, compare)}: the kernels of the main path on
    inputs made from seed (the same for every pkg) at chip_smoke.py's
    shapes: K1 at TPU_GRID and on the reference lattices (narrow rows),
    K2 on both, K3f, K3b, K4f, K4b; compare None for the largest absolute
    difference."""
    import torch
    g = torch.Generator().manual_seed(seed)
    dev = torch.device('cuda')
    grid, refs = pkg.encoders.TPU_GRID, _reference_lattices(pkg.encoders)
    n1, n2, n4 = 524288, 131072, 1048576
    x = torch.rand((n1, 3), generator=g).to(dev)
    table = (torch.randn((grid.n_levels, grid.table_size, grid.n_features),
                         generator=g) * 0.5).to(dev)
    tables = {k: _reference_table(c, g).to(dev) for k, c in refs.items()}
    g2 = torch.randn((n2, grid.out_dim), generator=g).to(dev)
    x2 = x[:n2].contiguous()
    g_ref = torch.randn((n1, refs[''].out_dim), generator=g).to(dev)
    # chip_smoke.py's heads: hidden 128, geo 15, 64 semantic features, 6
    # classes; A the TPU_GRID encode's width
    init = pkg.mlp.mlp_init
    params = {'sigma_net': init(g, 12 + grid.out_dim, 128, 16, 2),
              'color_net': init(g, 16 + 15, 128, 3, 2),
              'semantic_features': init(g, 15, 64, 64, 2),
              'semantic_out': init(g, 64 + 15, 64, 6, 1)}
    packed = [w.to(dev).to(torch.bfloat16)
              for w in pkg.heads_cuda.pack_head_weights(params, 12)]
    A = torch.randn((n1, grid.out_dim), generator=g).to(dev) * 0.5
    B = torch.zeros((n1, 32), device=dev)
    B[:, :12] = torch.rand((n1, 12), generator=g).to(dev) * 2 - 1
    B[:, 16:32] = torch.randn((n1, 16), generator=g).to(dev) * 0.3
    A2, B2 = A[:n2].contiguous(), B[:n2].contiguous()
    cots = [torch.randn((n2, packed[i].shape[1]), generator=g).to(dev)
            for i in (7, 10, 13)]
    ws = [w.to(dev).to(torch.bfloat16)
          for w in pkg.heads_cuda.pack_mlp3(init(g, 36, 64, 1, 2))]
    X = (torch.rand((n4, 36), generator=g) * 2 - 1).to(dev)
    X4, g4 = X[:n4 // 4].contiguous(), torch.randn(
        (n4 // 4, ws[2].shape[1]), generator=g).to(dev)
    hg, hd = pkg.hashgrid_cuda, pkg.heads_cuda
    return {
        f'K1 TPU_GRID N={n1}': (lambda: hg.hashgrid_encode(table, x, grid),
                                20, None),
        **{f'K1 reference{k} N={n1}': (
            lambda k=k, c=c: hg.hashgrid_encode(tables[k], x, c), 20, None)
           for k, c in refs.items()},
        f'K2 TPU_GRID N={n2}': (
            lambda: hg.hashgrid_encode_backward(g2, x2, grid), 20, None),
        f'K2 reference tcnn N={n1}': (
            lambda: hg.hashgrid_encode_backward(g_ref, x, refs[' tcnn']), 5,
            None, _lazy(lambda: k2_yardstick(pkg.encoders, g_ref, x,
                                             refs[' tcnn']))),
        f'K3f N={n1}': (lambda: hd.fused_heads(packed, A, B), 10, None),
        f'K3b N={n2}': (lambda: hd.fused_heads_backward(
            packed, A2, B2, *cots, need_dB=False), 10, None),
        f'K4f N={n4}': (lambda: hd.fused_mlp3(ws, X), 20, None),
        f'K4b N={n4 // 4}': (
            lambda: hd.fused_mlp3_backward(ws, X4, g4), 20, None),
    }


def _cases(pkg, step_samples, flagship, cli_samples):
    """{name: (fn(pkg), reps, compare)}: the kernels on recorded inputs,
    K2 on a training step's samples, K5, K2s and K1s on a flagship step's,
    K1s also on a CLI step's; compare(old, new) of their outputs, None for
    the largest absolute difference."""
    import torch
    hg = pkg.hashgrid_cuda
    g_s, x_s = step_samples
    f = flagship
    g_f, u_f, k_f, fl_grid = f['g'], f['u'], f['k'], f['grid']
    idx_f, w_f, rows_f = f['atoms']
    sel_f, coef_f, count_f = f['selection']
    n_f, m_f = g_f.shape[0], int(count_f[0])
    k1s = {}
    for where, ((t_e, x_e), grid_e) in (('flagship step', (f['encode'],
                                                          fl_grid)),
                                       ('cli step', cli_samples)):
        for interp in ('simplex', 'trilinear'):
            for form, dtype, atoms in (
                    ('training', torch.bfloat16, True),
                    ('eval', torch.float32, False)):
                k1s[f'K1s {interp} {form} {where} N={x_e.shape[0]}'] = (
                    lambda t_e=t_e, x_e=x_e, grid_e=grid_e, interp=interp,
                    dtype=dtype, atoms=atoms: hg.encode_atoms(
                        t_e, x_e, grid_e, interp, dtype, atoms), 20, None)
    return {
        **k1s,
        f'K2 TPU_GRID step samples N={x_s.shape[0]}': (
            lambda: hg.hashgrid_encode_backward(g_s, x_s,
                                               pkg.encoders.TPU_GRID),
            20, None),
        f'K5 flagship step N={n_f} k={k_f}': (
            lambda: hg.select_points(g_f, u_f, k_f), 20, _same_selection),
        f'K2s flagship step N={n_f} drawn={m_f}': (
            lambda: hg.sampled_scatter(g_f, idx_f, w_f, u_f, rows_f, fl_grid,
                                       sel_f, coef_f, count_f), 20, None),
    }


# K1 narrow's level groups timed for this tree alone: the library's
# choice (4 at F = 2), every level (16), 8, 4, 2 and one level a block
# row, levels slowest, as its first form ran.
K1_GROUPS = (0, 16, 8, 4, 2, 1)


def _narrow_rows(gpu, seed, rounds, reps=20):
    """This tree's K1 on the tcnn lattice at N = 524,288, uniform points
    and ray-ordered ones (chip_smoke._ray_points), walking each of K1_GROUPS' level
    groups in turns for `rounds` rounds, with K6's narrow kernel on a plan
    of every level exact (the same encode, its rows not written) in the
    same turns, each bit-equal to the library's choice, beside K1's byte
    bound and its sector floor: the distinct
    32-byte sectors its gathers touch (hashgrid_cuda.gather_sectors) plus
    the point and output streams, over the card's 3.35 TB/s; and the
    sectors a warp's 32 points request of L2 at the least. Also K2's byte
    bound there (the 'K2 reference tcnn' case): g and x read once, the
    (L, T, F) gradient written once."""
    import numpy as np
    import torch
    from autolabel_tpu_torch.ops import encoders
    from autolabel_tpu_torch.ops import hashgrid_cuda as hg
    from chip_smoke import PEAK_BYTES
    g = torch.Generator().manual_seed(seed)
    config = _reference_lattices(encoders)[' tcnn']
    n = 524288
    inputs = {'uniform': torch.rand((n, 3), generator=g).to('cuda'),
              'ray-ordered': _ray_points(n, g).to('cuda')}
    table = _reference_table(config, g).to('cuda')
    rows = sum(config.level_sizes) * config.n_features * 4
    out = dict(n=n, gpu=gpu, shape=hg.encode_launch_shapes(config, n))
    exact = encoders.stochastic_plan(config, 'trilinear', 1, config.n_levels)
    no_draws = torch.zeros(1, device='cuda')
    for name, x in inputs.items():
        want = hg.hashgrid_encode(table, x, config)
        calls = {group: (lambda group=group: hg._launch(table, x, config,
                                                        group))
                 for group in K1_GROUPS}
        calls['K6 all exact'] = lambda: hg._stochastic_call(
            table, x, no_draws, config, 'trilinear', 1, exact, False)[0]
        streams = x.numel() * 4 + want.numel() * 4
        sectors = hg.gather_sectors(x, config)
        tile_sectors = hg.gather_sectors(x, config, points=32)
        res = out[name] = dict(
            byte_bound_ms=(streams + rows) / PEAK_BYTES * 1e3,
            k2_byte_bound_ms=(streams + table.numel() * 4) / PEAK_BYTES
            * 1e3,
            sector_floor_ms=(streams + 32 * sum(sectors)) / PEAK_BYTES
            * 1e3, sectors=sectors, warp_sector_requests=tile_sectors,
            equal={k: torch.equal(call(), want) for k, call in calls.items()},
            ms={k: [] for k in calls}, device_ms={k: [] for k in calls})
        print(f'K1 narrow [{gpu}] tcnn N={n} {name}: byte bound '
              f'{res["byte_bound_ms"]:.4f} ms, sector floor '
              f'{res["sector_floor_ms"]:.4f} ms ({sum(sectors)} sectors of '
              f'32 bytes; {sum(tile_sectors)} requested by warps of 32 '
              f'points at the least, {32 * sum(tile_sectors) / 1e9:.3f} '
              f'GB); K2 narrow byte bound {res["k2_byte_bound_ms"]:.4f} ms; '
              f'groups bit-equal {res["equal"]}')
        for r in range(rounds):
            for k in list(calls)[::1 if r % 2 == 0 else -1]:
                ms, dev = _timed(calls[k], reps)
                res['ms'][k].append(ms)
                res['device_ms'][k].append(dev)
        for k in calls:
            dev = [d for d in res['device_ms'][k] if d is not None]
            label = k if isinstance(k, str) else f'group {k or "chosen"}'
            print(f'K1 narrow [{gpu}] {name} {label}: '
                  f'{float(np.median(res["ms"][k])):.4f} ms by events, '
                  f'{float(np.median(dev)) if dev else None} device '
                  f'(rounds {[round(v, 4) for v in res["ms"][k]]})')
    print(f'K1 narrow [{gpu}] launch shape {out["shape"]}')
    if not all(all(out[k]['equal'].values()) for k in inputs):
        raise RuntimeError('K1 narrow: a level group or K6 differs from '
                           'the library\'s choice')
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--parent', default=os.path.join(HERE, 'build',
                                                         'parent'))
    parser.add_argument('--rounds', type=int, default=4)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--only', default='',
                        help='regular expression of the cases to run')
    args = parser.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('kernel_compare: no CUDA device', file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(args.parent, PKG)):
        print(f'kernel_compare: no {PKG} under {args.parent}',
              file=sys.stderr)
        return 2
    only = re.compile(args.only)
    if args.only in ('K9', 'K2 narrow parts'):
        parts = _k9_parts if args.only == 'K9' else functools.partial(
            _k2n_parts, seed=args.seed)
        key = 'k9_parts' if args.only == 'K9' else 'k2n_parts'
        result = {'gpu': _gpu_line(), key: parts(
            os.path.abspath(args.parent), _gpu_line(), args.rounds)}
        os.makedirs(os.path.join(HERE, 'chiprun_out'), exist_ok=True)
        with open(os.path.join(HERE, 'chiprun_out', 'kernel_compare.json'),
                  'w') as f:
            json.dump(result, f, indent=1)
        return 0
    sides = {'old': _load(os.path.abspath(args.parent)), 'new': _load(HERE)}
    for pkg in sides.values():
        pkg.kernels.build_all()
    gpu = _gpu_line()
    result = {'gpu': gpu, 'rounds': args.rounds, 'kernels': {}}
    cases = {side: {} for side in sides}
    def wanted(names):
        return any(only.search(name) for name in names)

    if wanted(('K1 TPU_GRID', 'K1 reference N', 'K1 reference tcnn',
               'K1 reference torch_ngp', 'K2 TPU_GRID N', 'K2 reference tcnn',
               'K3f', 'K3b', 'K4f', 'K4b')):
        for side, pkg in sides.items():
            cases[side].update(_synthetic_cases(pkg, args.seed))
    if wanted(('K2 TPU_GRID step', 'K5 flagship', 'K2s flagship',
               'K1s simplex', 'K1s trilinear')):
        step_samples = _step_samples(args.seed)
        flagship = _flagship_samples(args.seed)
        cli_samples = _cli_samples()
        for side, pkg in sides.items():
            cases[side].update(_cases(pkg, step_samples, flagship,
                                      cli_samples))
    exact = (_exact_samples()
             if wanted(('K2 reference cli E', 'K2 narrow variants'))
             else None)
    if wanted(('K2 reference tcnn ray-ordered', 'K2 reference cli E')):
        for side, pkg in sides.items():
            cases[side].update(_k2_narrow_cases(pkg, args.seed, exact))
    stochastic = None
    if wanted([f'{k} cli {run} step' for k in ('K6', 'K7')
               for run in STOCHASTIC_RUNS]):
        stochastic = _stochastic_samples()
        for side, pkg in sides.items():
            cases[side].update(_stochastic_cases(pkg, args.seed, stochastic))
    k2x = None
    k2x_tags = [tag for tag, *_ in _k2x_forms()] + [
        K2X_RUN_D, 'registration iteration']
    if wanted([f'K2x {tag}' for tag in k2x_tags]):
        k2x = _k2x_samples(args.seed)
        for side, pkg in sides.items():
            cases[side].update(_k2x_cases(pkg, k2x))
    if wanted([f'K8 {tag}' for tag in ('baked scene', 'full cloud',
                                       'tied full cloud', 'preview')]):
        k8 = _k8_samples(args.seed)
        for side, pkg in sides.items():
            cases[side].update(_k8_cases(pkg, k8))
    for name in [k for k in cases['new'] if only.search(k)]:
        old, reps, compare, *library = cases['old'][name]
        new = cases['new'][name][0]
        diff = (compare or _max_diff)(old(), new())
        sided = {'old': old, 'new': new}
        if library:
            sided['library'] = library[0]
        times = {k: [] for k in sided}
        device = {k: [] for k in sided}
        split = {k: [] for k in sided}
        host = {k: [] for k in ('old', 'new')}
        for r in range(args.rounds):
            order = list(sided) if r % 2 == 0 else list(sided)[::-1]
            for side in order:
                fn = sided[side]
                times[side].append(_cuda_ms(fn, reps))
                by_kernel = _kernel_ms(fn)
                split[side].append(by_kernel)
                device[side].append(None if by_kernel is None
                                    else sum(by_kernel.values()))
                if name.startswith('K8') and side in host:
                    host[side].append(_k8_host_us(fn))
        med = {k: float(np.median(v)) for k, v in times.items()}
        dev_med = {k: None if None in v else float(np.median(v))
                   for k, v in device.items()}
        result['kernels'][name] = dict(max_diff_old_new=diff, ms=times,
                                       median_ms=med, device_ms=device,
                                       median_device_ms=dev_med,
                                       device_split=split)
        what = ('selections differ' if diff else 'selections equal') \
            if compare is _same_selection else (
                f'worst |new - old| uses {diff:.3f} of the tolerance'
                if compare else f'max |new - old| {diff:.3e}')
        dev_text = ('device ms not measured'
                    if None in (dev_med['old'], dev_med['new'])
                    else f'device old {dev_med["old"]:.4f} ms, new '
                         f'{dev_med["new"]:.4f} ms (new/old '
                         f'{dev_med["new"] / dev_med["old"]:.3f})')
        lib_name = library[1] if len(library) > 1 else 'index_add_'
        lib_text = '' if not library else (
            f'; {lib_name} {med["library"]:.4f} ms by events, '
            f'{dev_med["library"]} ms device')
        print(f'{name} [{gpu}]: old {med["old"]:.4f} ms, new '
              f'{med["new"]:.4f} ms (new/old {med["new"] / med["old"]:.3f}) '
              f'by events; {dev_text}{lib_text}; {what}; rounds old '
              f'{[round(v, 4) for v in times["old"]]} new '
              f'{[round(v, 4) for v in times["new"]]}')
        if host['new']:
            parts = {side: _k8_split(split[side]) for side in ('old', 'new')}
            result['kernels'][name].update(host_us=host, parts=parts)
            print(f'{name} [{gpu}]: device ms a part (medians; fill = '
                  f'resolve and passes, scatter = memset, project, winners) '
                  f'{parts}; wrapper host us old '
                  f'{float(np.median(host["old"])):.1f}, new '
                  f'{float(np.median(host["new"])):.1f} (rounds old '
                  f'{[round(v, 1) for v in host["old"]]} new '
                  f'{[round(v, 1) for v in host["new"]]})')
        torch.cuda.empty_cache()
    del cases
    torch.cuda.empty_cache()
    if wanted(['K1 reference tcnn', 'K2 reference tcnn']):
        result['narrow_rows'] = _narrow_rows(gpu, args.seed, args.rounds)
    if wanted(['K2 narrow parts']):
        result['k2n_parts'] = _k2n_parts(os.path.abspath(args.parent), gpu,
                                         args.rounds, args.seed)
    if wanted(['K2 narrow variants']):
        result['k2n_variants'] = _k2n_variants(gpu, args.rounds, args.seed,
                                               exact)
    if stochastic is not None:
        result['stochastic_parts'] = _stochastic_parts(gpu, stochastic,
                                                       args.seed)
    if k2x is not None:
        result['k2x_parts'] = _k2x_parts(gpu, {
            tag: a for tag, a in k2x.items()
            if only.search(_k2x_name(tag, a))})
    os.makedirs(os.path.join(HERE, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(HERE, 'chiprun_out', 'kernel_compare.json'),
              'w') as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
