#!/usr/bin/env python3
"""Drive the PyTorch port's render (serving) path and its training step on
one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each failing loudly:
  1. the card's name and power limit, torch and CUDA versions;
  2. build every kernel of both paths from csrc/ (nvcc, sm_90a, one
     process per source, in parallel);
  3. hold the hash-grid encode kernel (K1) against its plain version at
     TPU_GRID (N = 524,288, x including 0 and 1) and at the reference
     preset (16 x 2 x 2^19, N = 65,536); time it at both (the reference
     preset's narrow rows at N = 524,288 too), with the bytes its gathers
     read beside its bound, and print its launch shapes (blocks, threads,
     shared bytes, blocks per SM, registers) as the C library plans them;
  4. hold the fused head kernel (K3f, N = 524,288) and the proposal MLP
     kernel (K4f, N = 1,048,576) against their plain versions; print
     their launch shapes;
  5. the render slice: a full-width model (TPU_GRID trilinear encode
     through K1, fused heads through K3f, the 36-64-64-1 proposal net
     through K4f, hidden 128, geo 15, 64 semantic features, 6 classes,
     bound 2) with seeded random weights is written as a numpy checkpoint,
     loaded through InferenceModel.from_checkpoint, and renders 2 frames of
     480 x 360 (num_steps 32, proposal_steps 64, max_ray_batch 16384: 11
     chunks a frame), with every launch count set to 0 just before and read
     just after; the same render with the plain versions swapped in is the
     reference; before it, K1 is held and timed on the main samples of one
     render chunk (16,384 rays x 32, in ray order), recorded from a render;
  6. ms per frame, rays/s and each kernel's time from CUDA events; the
     steady state, frames rendered in turns (plain, kernels, kernels,
     plain) with their median and quartiles; one frame under
     torch.profiler for device time by kernel and the device's busy share;
  7. the backward kernels alone at the training step's shapes: the
     hash-grid table gradient (K2) at TPU_GRID (N = 131,072, x including 0
     and 1) and at the reference preset, each element within the stated
     bound of two fp32 summation orders (hashgrid_cuda.backward_tolerance),
     with its atomics floor (as many float4 atomic rows into random rows
     of 16 and 64 MiB); the fused head backward (K3b, N = 131,072) and the
     proposal-MLP backward (K4b, N = 262,144) against their plain versions
     (K3b's dA and dB also against the fp32 plain version, no further from
     it than the bf16 plain version is; K3b's and K4b's weight gradients
     bit-equal across two launches), with their times, bounds and the
     autograd backward of the bf16 torch.matmul chains as the library
     yardstick; K2's, K3b's and K4b's launch shapes, K3b's peak memory and
     its breakdown: device time by kernel from torch.profiler, beside K3f
     at the same N (the recompute alone);
  8. the training slice: SimpleTrainer on the same full-width model (all
     six kernels: K1, K2, K3f, K3b, K4f, K4b), batch 4096, proposal 64 ->
     32, perturbed, exact trilinear gathers, on ray batches of a procedural
     scene (a sphere coloured and labelled by its normal, seen from 8
     cameras). (a) one step with the kernels against one with the plain
     versions, same params and draws: loss parts and every parameter's
     gradient; (b) 200 steps through train_iterations, every launch count
     set to 0 just before and read just after: each kernel launched once a
     step, every loss finite, the held-out rgb loss falling; then K2
     held and timed on the (g, x) of one more step's backward, the main
     path's own ray-ordered samples; (c) ms per
     step and rays/s in turns (plain, kernels, kernels, plain); (d) one
     step's peak memory, and one step under torch.profiler; (e) the trained model's checkpoint served
     through InferenceModel.from_checkpoint, equal to the trainer's own
     render.
The last lines are the kernel table as JSON and
{"ok": true, "device": {...}}. Exits non-zero without them when there is
no CUDA device, when run outside the repository, or when any check fails.
"""
import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, 'chiprun_out')
WORK_DIR = os.path.join(HERE, 'build', 'chip_smoke')

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s, and
# FLOP/s in fp32 outside the tensor cores and in bf16 on them.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12

FRAME_W, FRAME_H = 480, 360
NUM_STEPS, PROPOSAL_STEPS, MAX_RAY_BATCH = 32, 64, 16384
N_FRAMES = 2
TIMED_ROUNDS = 4  # each round renders plain, kernels, kernels, plain

# The training slice: bench.py's batch and sample counts.
TRAIN_BATCH, TRAIN_STEPS = 4096, 200
TRAIN_CHUNK = 20  # steps per train_iterations call (one EMA tick each)
TRAIN_ROUNDS, STEPS_PER_TURN = 4, 5
SPHERE_RADIUS = 0.8


def _fail_early(msg):
    print(f'chip_smoke: {msg}', file=sys.stderr)
    sys.exit(2)


def _gpu_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def _cuda_ms(fn, reps):
    """Mean device ms of fn over reps launches, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _quartiles(values):
    import numpy as np
    q1, med, q3 = np.percentile(values, [25, 50, 75])
    return {'median': float(med), 'q1': float(q1), 'q3': float(q3),
            'n': len(values)}


def _device_profile(fn):
    """Device time of one call of fn by kernel, from torch.profiler:
    (rows of (name, ms, launches) by time, total device ms), or (None,
    None) when the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        return None, None
    rows.sort(key=lambda r: -r[1])
    return rows, sum(r[1] for r in rows)


def _kernel_ms(fn, reps=5):
    """Device ms per call of fn by kernel name, from torch.profiler over
    reps calls (after one warm-up), or None when the trace holds no device
    time."""
    import torch
    fn()
    torch.cuda.synchronize()
    rows, _ = _device_profile(lambda: [fn() for _ in range(reps)])
    if rows is None:
        return None
    return {name: ms / reps for name, ms, _ in rows}


def _print_shapes(gpu, shapes):
    for kernel, sh in shapes.items():
        print(f'launch shape [{gpu}] {kernel}: ' + ', '.join(
            f'{k} {v}' for k, v in sh.items()))


def _bound(nbytes, flops, peak_flops):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else
            'operations')


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


class Checks:
    """Collects every comparison, so one run reports them all."""

    def __init__(self):
        self.failures = []

    def close(self, name, got, want, atol, rtol):
        import torch
        got, want = got.float(), want.float()
        err = (got - want).abs()
        allowed = atol + rtol * want.abs()
        max_abs = float(err.max()) if err.numel() else 0.0
        # The worst element's share of its allowance (1 = at the limit).
        used = float((err / allowed).max()) if err.numel() else 0.0
        ok = bool(torch.isfinite(got).all()) and bool((err <= allowed).all())
        print(f'check {name}: max_abs_err={max_abs:.3e} '
              f'max|want|={float(want.abs().max()):.3e} '
              f'(atol={atol}, rtol={rtol}, worst uses {used:.3f} of it) '
              f'{"ok" if ok else "FAILED"}')
        if not ok:
            self.failures.append(name)
        return max_abs

    def rel_norm(self, name, got, want, tol):
        """|got - want| / |want| in the Frobenius norm, at most tol."""
        import torch
        got, want = got.float(), want.float()
        err = float((got - want).norm() / want.norm().clamp(min=1e-30))
        ok = bool(torch.isfinite(got).all()) and err <= tol
        print(f'check {name}: rel_err={err:.3e} |want|={float(want.norm()):.3e}'
              f' (tol {tol}) {"ok" if ok else "FAILED"}')
        if not ok:
            self.failures.append(name)
        return err

    def flips(self, name, got, want, atol, max_share):
        """At most max_share of the elements differ by more than atol
        (the rest may not: see the callers for why some can)."""
        import torch
        err = (got.float() - want.float()).abs()
        share = float((err > atol).float().mean())
        ok = bool(torch.isfinite(got).all()) and share <= max_share
        print(f'check {name}: {share:.3e} of the elements beyond '
              f'{atol:.3e} (at most {max_share}); max_abs_err '
              f'{float(err.max()):.3e} {"ok" if ok else "FAILED"}')
        if not ok:
            self.failures.append(name)
        return float(err.max())

    def no_worse(self, name, got, ref, want, atol, room):
        """got is no further from want than ref is, up to the factor room:
        in the Frobenius norm and in the share of elements beyond atol."""
        import torch
        want = want.float()

        def errors(x):
            d = x.float() - want
            return (float(d.norm() / want.norm().clamp(min=1e-30)),
                    float((d.abs() > atol).float().mean()))

        (norm_got, share_got), (norm_ref, share_ref) = errors(got), errors(ref)
        ok = bool(torch.isfinite(got).all()) \
            and norm_got <= room * norm_ref and share_got <= room * share_ref
        print(f'check {name}: rel_err {norm_got:.4e} against {norm_ref:.4e}, '
              f'share beyond {atol:.3e} {share_got:.4e} against '
              f'{share_ref:.4e} (room {room}) {"ok" if ok else "FAILED"}')
        if not ok:
            self.failures.append(name)
        return dict(rel_err=norm_got, ref_rel_err=norm_ref, share=share_got,
                    ref_share=share_ref)

    def within(self, name, got, want, tol):
        """|got - want| at most tol, element by element."""
        import torch
        err = (got.float() - want.float()).abs()
        ok = bool(torch.isfinite(got).all()) and bool((err <= tol).all())
        used = float((err / tol.clamp(min=1e-38)).max()) if err.numel() \
            else 0.0
        print(f'check {name}: max_abs_err={float(err.max()):.3e} '
              f'max|want|={float(want.abs().max()):.3e} (worst uses '
              f'{used:.3f} of its tolerance) {"ok" if ok else "FAILED"}')
        if not ok:
            self.failures.append(name)
        return float(err.max())

    def true(self, name, cond, detail=''):
        print(f'check {name}: {"ok" if cond else "FAILED"} {detail}')
        if not cond:
            self.failures.append(name)


def _look_at(pos, target=(0.0, 0.0, 0.0)):
    """OpenCV camera-to-world rotation (x right, y down, z forward)."""
    import numpy as np
    pos = np.asarray(pos, np.float64)
    forward = np.asarray(target) - pos
    forward /= np.linalg.norm(forward)
    right = np.cross(forward, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    return np.stack([right, down, forward], axis=1)


def _frame(rays, pos):
    import numpy as np
    R = _look_at(pos)
    dirs, norms = rays.compute_directions(
        R, np.arange(FRAME_W * FRAME_H), FRAME_W, 400.0, 400.0,
        FRAME_W / 2, FRAME_H / 2)
    return {
        'rays_o': np.broadcast_to(np.asarray(pos, np.float32),
                                  (FRAME_H, FRAME_W, 3)).copy(),
        'rays_d': dirs.reshape(FRAME_H, FRAME_W, 3),
        'direction_norms': norms.reshape(FRAME_H, FRAME_W, 1),
    }


def _scene_frame(rays, pos):
    """A frame of the procedural training scene: _frame's rays and the
    ground truth of a sphere of radius SPHERE_RADIUS at the origin, its
    colour and class (the dominant axis of the normal and its sign: 6
    classes) taken from the normal; the background is white (the
    renderer's bg_color), unlabelled (-1) and has no depth."""
    import numpy as np
    frame = _frame(rays, pos)
    o = frame['rays_o'].reshape(-1, 3).astype(np.float64)
    d = frame['rays_d'].reshape(-1, 3).astype(np.float64)
    norms = frame['direction_norms'].reshape(-1)
    b = (o * d).sum(-1)
    disc = b * b - ((o * o).sum(-1) - SPHERE_RADIUS ** 2)
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    hit = (disc > 0) & (t > 0)
    normal = (o + t[:, None] * d) / SPHERE_RADIUS
    axis = np.abs(normal).argmax(-1)
    cls = 2 * axis + (normal[np.arange(len(axis)), axis] < 0)
    frame['pixels'] = np.where(hit[:, None], 0.2 + 0.3 * (normal + 1.0),
                               1.0).astype(np.float32).reshape(
                                   FRAME_H, FRAME_W, 3)
    frame['depth'] = np.where(hit, t / norms, 0.0).astype(
        np.float32).reshape(FRAME_H, FRAME_W)
    frame['semantic'] = np.where(hit, cls, -1).reshape(FRAME_H, FRAME_W)
    return frame


class _RayBatches:
    """Endless batches of rays drawn uniformly, on the card, from a pool
    of frames held on the card."""

    def __init__(self, frames, batch, device, seed):
        import numpy as np
        import torch
        keys = ('rays_o', 'rays_d', 'direction_norms', 'pixels', 'depth',
                'semantic')
        self.pool = {k: torch.as_tensor(np.concatenate(
            [np.asarray(f[k]).reshape(FRAME_W * FRAME_H, -1)
             for f in frames])).squeeze(-1).to(device) for k in keys}
        self.n = self.pool['rays_o'].shape[0]
        self.batch = batch
        self.generator = torch.Generator(device=device).manual_seed(seed)

    def __iter__(self):
        return self

    def __next__(self):
        import torch
        idx = torch.randint(0, self.n, (self.batch,),
                            generator=self.generator,
                            device=self.generator.device)
        return {k: v[idx] for k, v in self.pool.items()}


def _psnr(mse):
    import math
    return -10.0 * math.log10(max(mse, 1e-12))


@contextlib.contextmanager
def _plain_kernels(hashgrid_cuda, heads_cuda):
    """Swap the three kernel wrappers for their plain versions (bf16
    operands for the heads, as the kernels), on the card."""
    import torch
    saved = (hashgrid_cuda.hashgrid_encode, heads_cuda.fused_heads,
             heads_cuda.fused_mlp3)
    hashgrid_cuda.hashgrid_encode = hashgrid_cuda.hashgrid_encode_plain
    heads_cuda.fused_heads = lambda p, A, B: heads_cuda.fused_heads_plain(
        p, A, B, torch.bfloat16)
    heads_cuda.fused_mlp3 = lambda p, X: heads_cuda.fused_mlp3_plain(
        p, X, torch.bfloat16)
    try:
        yield
    finally:
        (hashgrid_cuda.hashgrid_encode, heads_cuda.fused_heads,
         heads_cuda.fused_mlp3) = saved


def _model_config():
    """The full-width model both slices drive: TPU_GRID trilinear through
    the encode kernel, the fused heads, the 36-64-64-1 proposal net,
    hidden 128, geo 15, 64 semantic features, 6 classes, bound 2."""
    import numpy as np
    from autolabel_tpu_torch import model_utils
    flags = model_utils.model_flag_parser().parse_args(
        ['--grid-preset', 'tpu', '--proposal', '--heads-impl', 'pallas',
         '--grid-interp', 'trilinear', '--feature-dim', '64'])
    lo, hi = np.full(3, -1.0), np.full(3, 1.0)  # bound = 2.0
    return dataclasses.replace(model_utils.model_config(lo, hi, 6, flags),
                               grid_impl='pallas')


def _train_slice(dev, seed):
    """The training slice: (trainer, loader of ray batches, held-out
    frame). SimpleTrainer on a fresh full-width field, batch TRAIN_BATCH,
    proposal 64 -> 32, perturbed, exact trilinear gathers, on rays of the
    procedural sphere scene seen from 8 cameras."""
    import numpy as np
    import torch
    from autolabel_tpu_torch.core import rays
    from autolabel_tpu_torch.models.field import Field
    from autolabel_tpu_torch.render.renderer import RenderOptions
    from autolabel_tpu_torch.train.trainer import SimpleTrainer
    positions = [(3.2 * np.cos(a), 3.2 * np.sin(a), 0.9 * (-1) ** k)
                 for k, a in enumerate(np.linspace(0, 2 * np.pi, 9)[:-1])]
    loader = _RayBatches([_scene_frame(rays, pos) for pos in positions],
                         TRAIN_BATCH, dev, seed + 4)
    held_out = _scene_frame(rays, (2.2, 2.6, -0.4))
    options = RenderOptions(perturb=True, stochastic_corners=0,
                            sampled_backward=0, num_steps=NUM_STEPS,
                            proposal_steps=PROPOSAL_STEPS)
    field = Field(_model_config(), device=dev,
                  generator=torch.Generator().manual_seed(seed + 2))
    trainer = SimpleTrainer('chip_smoke', field, lr=5e-3, iters=10000,
                            render_options=options,
                            workspace=os.path.join(WORK_DIR, 'train'),
                            use_checkpoint=None,
                            max_ray_batch=MAX_RAY_BATCH, metrics=False,
                            seed=seed)
    return trainer, loader, held_out


def _record_k2_inputs(trainer, loader):
    """The (g, x) that one training step's backward hands the table
    gradient kernel (K2): the step's main samples, ray by ray."""
    from autolabel_tpu_torch.ops import hashgrid_cuda
    recorded, launch = [], hashgrid_cuda._launch_backward

    def record(g, x, config):
        recorded.append((g.detach().clone(), x.detach().clone()))
        return launch(g, x, config)

    hashgrid_cuda._launch_backward = record
    try:
        trainer.train_step(next(loader))
    finally:
        hashgrid_cuda._launch_backward = launch
    return recorded[0]


def _check_k2(checks, name, hashgrid_cuda, g, x, config):
    """K2 against its plain version on (g, x): each element within
    hashgrid_cuda.backward_tolerance (the same fp32 products summed in
    another order: 2 k 2^-24 of the terms' magnitudes, k the terms of the
    element's row), and the hottest row's k. Returns the largest
    error."""
    got = hashgrid_cuda.hashgrid_encode_backward(g, x, config)
    want = hashgrid_cuda.hashgrid_encode_backward_plain(g, x, config)
    tol = hashgrid_cuda.backward_tolerance(g, x, config)
    err = checks.within(name, got, want, tol)
    # the hottest row's terms: the tolerance over 2^-23 times the
    # magnitude, where the magnitude is largest
    magnitude = hashgrid_cuda.hashgrid_encode_backward_plain(g.abs(), x,
                                                             config)
    hottest = float((tol / (2.0 ** -23 * magnitude).clamp(
        min=1e-38)).max())
    print(f'  {name}: the hottest row sums {hottest:.0f} terms')
    return err


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        _fail_early('no CUDA device is available')
    if not os.path.isdir(os.path.join(HERE, 'autolabel_tpu_torch')):
        _fail_early('autolabel_tpu_torch/ is not beside this script; run it '
                    'from a checkout of the repository')
    sys.path.insert(0, HERE)
    from autolabel_tpu_torch import bridge
    from autolabel_tpu_torch.core import rays
    from autolabel_tpu_torch.inference import InferenceModel
    from autolabel_tpu_torch.models.field import Field
    from autolabel_tpu_torch.ops import _kernels, hashgrid_cuda, heads_cuda
    from autolabel_tpu_torch.ops.encoders import TPU_GRID, HashGridConfig
    from autolabel_tpu_torch.render.renderer import draw_perturbations
    from autolabel_tpu_torch.train import checkpoints

    # fp32 products in the plain versions stay full fp32 (PyTorch's
    # default, stated here).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    t_start = time.perf_counter()
    checks = Checks()
    gpu = _gpu_line()
    print(f'gpu: {gpu}')
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]} devices '
          f'{torch.cuda.device_count()}')

    # ---- 2. build
    build_s = _kernels.build_all()
    print(f'build: {build_s:.1f} s for {", ".join(_kernels.SOURCES)}')
    for source, log in _kernels.build_log.items():
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  ptxas {source}: {line.strip()}')

    g = torch.Generator().manual_seed(args.seed)
    results = {}

    # ---- 3. K1: hash-grid encode
    n1 = 524288
    x = torch.rand((n1, 3), generator=g)
    x[:8] = torch.tensor([[0., 0., 0.], [1., 1., 1.], [0., 1., 0.5],
                          [1., 0., 0.999999], [1., 1., 0.], [0.5, 0., 1.],
                          [0.25, 0.75, 1.], [1., 0.5, 0.5]])
    x = x.to(dev)
    table = (torch.randn((TPU_GRID.n_levels, TPU_GRID.table_size,
                          TPU_GRID.n_features), generator=g) * 0.5).to(dev)
    enc = hashgrid_cuda.hashgrid_encode(table, x, TPU_GRID)
    enc_plain = hashgrid_cuda.hashgrid_encode_plain(table, x, TPU_GRID)
    torch.cuda.synchronize()
    # Same products and sums in the same order, rounded the same way: the
    # kernel should agree to the last bits; 1e-5 absolute on O(1) values.
    k1_err = checks.close('K1 encode TPU_GRID N=524288', enc, enc_plain,
                          atol=1e-5, rtol=0.0)
    ref_grid = HashGridConfig()
    x_ref = x[:65536].contiguous()
    table_ref = (torch.randn((ref_grid.n_levels, ref_grid.table_size,
                              ref_grid.n_features), generator=g)
                 * 0.5).to(dev)
    checks.close('K1 encode reference 16x2x2^19 N=65536',
                 hashgrid_cuda.hashgrid_encode(table_ref, x_ref, ref_grid),
                 hashgrid_cuda.hashgrid_encode_plain(table_ref, x_ref,
                                                     ref_grid),
                 atol=1e-5, rtol=0.0)
    k1_ms = _cuda_ms(lambda: hashgrid_cuda.hashgrid_encode(table, x,
                                                           TPU_GRID), 20)
    k1_plain = _cuda_ms(lambda: hashgrid_cuda.hashgrid_encode_plain(
        table, x, TPU_GRID), 3)
    k1_bound = _bound(_nbytes(x, table, enc),
                      16 * n1 * TPU_GRID.out_dim, PEAK_FP32)
    results['K1'] = dict(max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain,
                         bound=k1_bound, library_ms=None)
    # The rows the gathers read (8 corner rows of F fp32 per point and
    # level), which the byte bound counts once per table row instead.
    k1_gathered = 8 * TPU_GRID.n_features * 4 * n1 * TPU_GRID.n_levels
    print(f'K1 [{gpu}] uniform N={n1}: {k1_ms:.4f} ms, gathers '
          f'{k1_gathered / 1e9:.3f} GB a launch '
          f'({k1_gathered / k1_ms / 1e9:.3f} TB/s), bound '
          f'{k1_bound[0]:.4f} ms ({k1_bound[1]})')
    # The narrow path (the reference preset's F = 2) at the same N.
    k1_narrow_ms = _cuda_ms(lambda: hashgrid_cuda.hashgrid_encode(
        table_ref, x, ref_grid), 20)
    print(f'K1 [{gpu}] reference 16x2x2^19 N={n1} (narrow rows): '
          f'{k1_narrow_ms:.4f} ms')
    shapes = {'K1': hashgrid_cuda.encode_launch_shapes(TPU_GRID, n1),
              'K1 reference': hashgrid_cuda.encode_launch_shapes(ref_grid,
                                                                 n1)}
    _print_shapes(gpu, {f'{key} N={n1} {kernel}': sh
                        for key in ('K1', 'K1 reference')
                        for kernel, sh in shapes[key].items()})

    # ---- 5a. the model (built here so K3f/K4f see its real weights)
    config = _model_config()
    assert config.bound == 2.0 and config.grid == TPU_GRID
    field = Field(config, device=dev, generator=g)
    # A table far from its U(-1e-4, 1e-4) init, so density, color and
    # semantics are non-trivial.
    with torch.no_grad():
        field.encoder['grid'].copy_(
            torch.randn(field.encoder['grid'].shape, generator=g) * 0.5)
    params = {k: [w.detach() for w in ws]
              for k, ws in field.head_params().items()}

    # ---- 4. K3f: fused heads; K4f: proposal MLP
    n3 = 524288
    A = enc[:n3]
    B = torch.zeros((n3, 32), device=dev)
    B[:, :12] = torch.rand((n3, 12), generator=g).to(dev) * 2 - 1
    B[:, 16:32] = torch.randn((n3, 16), generator=g).to(dev) * 0.3
    # Packed and cast to bf16 once, as the field does.
    packed = [w.to(torch.bfloat16)
              for w in heads_cuda.pack_head_weights(params, 12)]
    got = heads_cuda.fused_heads(packed, A, B)
    want = heads_cuda.fused_heads_plain(packed, A, B, torch.bfloat16)
    torch.cuda.synchronize()
    # bf16 operands and fp32 accumulation on both sides; only the
    # accumulation order differs, which can flip the bf16 rounding of an
    # intermediate (2^-8 relative) and carries through the later layers.
    k3_err = max(checks.close(f'K3f {name} N=524288', a, b, atol=2e-2,
                              rtol=2e-2)
                 for name, a, b in zip(('out1', 'features', 'logits'),
                                       got, want))
    shapes['K3f'] = heads_cuda.heads_launch_shapes(packed, A, B)
    _print_shapes(gpu, {'K3f N=524288 heads_fwd_kernel':
                        shapes['K3f']['heads_fwd_kernel']})
    k3_ms = _cuda_ms(lambda: heads_cuda.fused_heads(packed, A, B), 10)
    k3_plain = _cuda_ms(lambda: heads_cuda.fused_heads_plain(
        packed, A, B, torch.bfloat16), 3)

    def heads_library():
        # The yardstick: the same stack as a chain of native bf16 cuBLAS
        # products (bf16 outputs between layers).
        (WA, WBs, W1s, W2s, WBc, WSc, W1c, W2c, WSf, W1f, W2f, WFo, WSo,
         W1o) = packed
        a, b = A.to(torch.bfloat16), B.to(torch.bfloat16)
        h = torch.relu(a @ WA + b @ WBs)
        S = torch.relu(h @ W1s) @ W2s
        c = torch.relu(torch.relu(b @ WBc + S @ WSc) @ W1c) @ W2c
        F = torch.relu(torch.relu(S @ WSf) @ W1f) @ W2f
        L = torch.relu(torch.relu(F) @ WFo + S @ WSo) @ W1o
        return torch.exp(torch.clamp(S[:, :1].float(), max=15.0)), \
            torch.sigmoid(c[:, :3].float()), F, L

    k3_lib = _cuda_ms(heads_library, 10)
    # The function's own work, at the real widths (no padding): A, B's 28
    # real columns (12 freq, 16 SH), the 14 bf16 matrices, and 4 + S + C
    # output columns; one MAC per weight entry per point.
    head_macs = sum(w.numel() for ws in params.values() for w in ws)
    n_out = 4 + params['semantic_features'][2].shape[1] \
        + params['semantic_out'][1].shape[1]
    k3_bound = _bound(_nbytes(A) + n3 * (12 + 16) * 4 + head_macs * 2
                      + n3 * n_out * 4, 2 * n3 * head_macs, PEAK_BF16)
    results['K3f'] = dict(max_abs_err=k3_err, ms=k3_ms, plain_ms=k3_plain,
                          bound=k3_bound, library_ms=k3_lib)

    n4 = 1048576
    X = torch.rand((n4, 36), generator=g).to(dev) * 2 - 1
    packed3 = [w.to(torch.bfloat16) for w in heads_cuda.pack_mlp3(
        [w.detach() for w in field.proposal])]
    got4 = heads_cuda.fused_mlp3(packed3, X)
    want4 = heads_cuda.fused_mlp3_plain(packed3, X, torch.bfloat16)
    k4_err = checks.close('K4f mlp3 N=1048576', got4, want4, atol=2e-2,
                          rtol=2e-2)
    shapes['K4f'] = {'mlp3_fwd_kernel': heads_cuda.mlp3_launch_shapes(
        packed3, X)['mlp3_fwd_kernel']}
    _print_shapes(gpu, {f'K4f N={n4} {kernel}': sh
                        for kernel, sh in shapes['K4f'].items()})
    k4_ms = _cuda_ms(lambda: heads_cuda.fused_mlp3(packed3, X), 20)
    k4_plain = _cuda_ms(lambda: heads_cuda.fused_mlp3_plain(
        packed3, X, torch.bfloat16), 5)

    def mlp3_library():
        Xp = torch.nn.functional.pad(X, (0, packed3[0].shape[0] - 36))
        h = torch.relu(Xp.to(torch.bfloat16) @ packed3[0])
        return torch.relu(h @ packed3[1]) @ packed3[2]

    k4_lib = _cuda_ms(mlp3_library, 20)
    # X, the 3 bf16 matrices and the one real output column (36-64-64-1).
    mlp3_macs = sum(w.numel() for w in field.proposal)
    k4_bound = _bound(_nbytes(X) + mlp3_macs * 2 + n4 * 4,
                      2 * n4 * mlp3_macs, PEAK_BF16)
    results['K4f'] = dict(max_abs_err=k4_err, ms=k4_ms, plain_ms=k4_plain,
                          bound=k4_bound, library_ms=k4_lib)
    del enc_plain, got, want, got4, want4, A, B, X

    # ---- 5b. the slice through the serving entry point
    model_dir = os.path.join(WORK_DIR, 'model')
    tree = bridge.params_to_numpy(field)
    checkpoints.save_checkpoint(
        os.path.join(model_dir, 'checkpoints', 'best.pth'),
        {'params': tree, 'ema': tree, 'step': 0}, include_optimizer=False)
    served = Field(config, device=dev,
                   generator=torch.Generator().manual_seed(args.seed + 1))
    model = InferenceModel.from_checkpoint(
        served, model_dir, num_steps=NUM_STEPS, proposal_steps=PROPOSAL_STEPS,
        max_ray_batch=MAX_RAY_BATCH)
    checks.true('checkpoint round trip', all(
        torch.equal(a, b) for a, b in zip(served.state_dict().values(),
                                          field.state_dict().values())))
    frames = [_frame(rays, (3.2, -2.4, 1.2)), _frame(rays, (-2.8, -3.0, 0.8))]
    chunks = -(-FRAME_W * FRAME_H // MAX_RAY_BATCH)

    # K1 on the main samples of one render chunk (16,384 rays x 32, in ray
    # order), recorded from a render: does their locality help the gathers?
    n_chunk = MAX_RAY_BATCH * NUM_STEPS
    recorded, encode = [], hashgrid_cuda.hashgrid_encode

    def record(table_, x_, config_):
        if not recorded and x_.shape[0] == n_chunk:
            recorded.append((table_.detach(), x_.detach().clone()))
        return encode(table_, x_, config_)

    hashgrid_cuda.hashgrid_encode = record
    try:
        model.render(frames[0])
    finally:
        hashgrid_cuda.hashgrid_encode = encode
    checks.true('K1 ray-ordered samples recorded', bool(recorded))
    table_r, x_r = recorded[0]
    checks.close(f'K1 encode ray-ordered N={n_chunk}',
                 hashgrid_cuda.hashgrid_encode(table_r, x_r, TPU_GRID),
                 hashgrid_cuda.hashgrid_encode_plain(table_r, x_r, TPU_GRID),
                 atol=1e-5, rtol=0.0)
    k1_ray_ms = _cuda_ms(lambda: hashgrid_cuda.hashgrid_encode(
        table_r, x_r, TPU_GRID), 20)
    print(f'K1 [{gpu}] ray-ordered N={n_chunk}: {k1_ray_ms:.4f} ms '
          f'(uniform {k1_ms:.4f} ms)')
    del recorded, table_r, x_r

    torch.cuda.synchronize()
    _kernels.reset_launches()
    frame_s, renders = [], []
    for batch in frames:
        t0 = time.perf_counter()
        renders.append(model.render(batch))  # numpy: synchronised
        frame_s.append(time.perf_counter() - t0)
    launches = dict(_kernels.launches)
    expected = chunks * N_FRAMES
    for name in (hashgrid_cuda.NAME, heads_cuda.HEADS, heads_cuda.MLP3):
        checks.true(f'launches {name}', launches.get(name, 0) == expected,
                    f'{launches.get(name, 0)} (expected {expected})')

    with _plain_kernels(hashgrid_cuda, heads_cuda):
        plain_s, plain_renders = [], []
        for batch in frames:
            t0 = time.perf_counter()
            plain_renders.append(model.render(batch))
            plain_s.append(time.perf_counter() - t0)
    render_errors = {}
    for i, (ours, ref) in enumerate(zip(renders, plain_renders)):
        for key, shape in (('image', (FRAME_H, FRAME_W, 3)),
                           ('depth', (FRAME_H, FRAME_W)),
                           ('semantic', (FRAME_H, FRAME_W, 6)),
                           ('semantic_features', (FRAME_H, FRAME_W, 64))):
            checks.true(f'frame {i} {key} shape and finite',
                        ours[key].shape == shape
                        and bool(np.isfinite(ours[key]).all()))
        # bf16 differences of accumulation order can move a proposal sample
        # by one bin on a few rays: each map must agree with the plain
        # render on average and on all but a handful of pixels, relative to
        # its largest magnitude (1 for the image).
        for key in ('image', 'depth', 'semantic', 'semantic_features'):
            err = np.abs(ours[key] - ref[key])
            scale = 1.0 if key == 'image' else float(np.abs(ref[key]).max())
            mean, p999 = float(err.mean()), float(np.quantile(err, 0.999))
            render_errors[f'frame {i} {key}'] = dict(
                mean_abs=mean, p99_9=p999, max=float(err.max()), scale=scale)
            checks.true(f'frame {i} {key} vs plain render',
                        mean < 5e-3 * scale and p999 < 5e-2 * scale,
                        f'mean_abs={mean:.3e} p99.9={p999:.3e} '
                        f'max={float(err.max()):.3e} (scale {scale:.3e})')
        ws = ours['weights_sum']
        checks.true(f'frame {i} non-trivial density',
                    0.05 < float(ws.mean()) < 0.999,
                    f'mean weights_sum={float(ws.mean()):.4f}')

    # ---- 6. steady state and where the device time goes
    def render_ms(batch):
        t0 = time.perf_counter()
        model.render(batch)  # returns numpy: synchronised
        return (time.perf_counter() - t0) * 1e3

    steady = {'kernels': [], 'plain': []}
    for r in range(TIMED_ROUNDS):
        batch = frames[r % N_FRAMES]
        for side in ('plain', 'kernels', 'kernels', 'plain'):
            if side == 'plain':
                with _plain_kernels(hashgrid_cuda, heads_cuda):
                    steady[side].append(render_ms(batch))
            else:
                steady[side].append(render_ms(batch))
    steady_stats = {k: _quartiles(v) for k, v in steady.items()}
    profile_rows, busy_ms = _device_profile(lambda: model.render(frames[0]))

    rays_per_frame = FRAME_W * FRAME_H
    print(f'render [{gpu}]: ms per frame {[round(s * 1e3, 3) for s in frame_s]} '
          f'(kernels, first two), {[round(s * 1e3, 3) for s in plain_s]} '
          f'(plain)')
    for side, st in steady_stats.items():
        print(f'render steady [{gpu}] {side}: ms per frame median '
              f'{st["median"]:.3f} (q1 {st["q1"]:.3f}, q3 {st["q3"]:.3f}, '
              f'n {st["n"]}); rays/s {rays_per_frame / st["median"] * 1e3:.1f}')
    if profile_rows is None:
        print('profile: the trace holds no device time: not measured')
    else:
        wall = steady_stats['kernels']['median']
        print(f'profile [{gpu}]: device busy {busy_ms:.3f} ms of a '
              f'{wall:.3f} ms frame (median wall, unprofiled): busy share '
              f'{busy_ms / wall:.4f}')
        for name, ms, count in profile_rows[:12]:
            print(f'  {ms:9.3f} ms {ms / busy_ms:7.2%} x{count:<5d} '
                  f'{name[:90]}')
    for key, r in results.items():
        print(f'kernel {key} [{gpu}]: {r["ms"]:.4f} ms, plain '
              f'{r["plain_ms"]:.4f} ms, library {r["library_ms"]}, bound '
              f'{r["bound"][0]:.4f} ms ({r["bound"][1]})')

    # ---- 7. the backward kernels at the training step's shapes
    n_tr = TRAIN_BATCH * NUM_STEPS  # main samples per step: 131,072
    x2 = x[:n_tr].contiguous()  # holds the points at 0 and 1
    g2 = torch.randn((n_tr, TPU_GRID.out_dim), generator=g).to(dev)
    k2_err = _check_k2(checks, f'K2 table gradient TPU_GRID N={n_tr}',
                       hashgrid_cuda, g2, x2, TPU_GRID)
    g_ref = torch.randn((65536, ref_grid.out_dim), generator=g).to(dev)
    _check_k2(checks, 'K2 table gradient reference 16x2x2^19 N=65536',
              hashgrid_cuda, g_ref, x_ref, ref_grid)
    k2_ms = _cuda_ms(lambda: hashgrid_cuda.hashgrid_encode_backward(
        g2, x2, TPU_GRID), 20)
    k2_plain = _cuda_ms(lambda: hashgrid_cuda.hashgrid_encode_backward_plain(
        g2, x2, TPU_GRID), 3)
    # x and g read once, the 64 MiB table gradient written once; a mul and
    # an add per corner per element in fp32.
    k2_bound = _bound(_nbytes(x2, g2, table), 16 * n_tr * TPU_GRID.out_dim,
                      PEAK_FP32)
    # K2's atomics floor: as many float4 atomic rows as K2 would make with
    # no row combined (8 corners x points x levels, 512 bytes each), into
    # random rows of a buffer L2 holds (one level's gradient) and of one it
    # does not (all four levels').
    k2_updates = 8 * n_tr * TPU_GRID.n_levels
    k2_floor = {}
    for mib in (16, 64):
        buf = torch.zeros((mib * 2 ** 20 // 512, 128), device=dev)
        k2_floor[f'{mib} MiB'] = _cuda_ms(
            lambda: hashgrid_cuda.atomic_rows(buf, k2_updates), 10)
        del buf
    print(f'K2 atomics floor [{gpu}]: {k2_updates * 32} float4 atomics '
          f'({k2_updates * 512 / 1e9:.3f} GB) into random 512-byte rows: '
          f'{k2_floor["16 MiB"]:.4f} ms into 16 MiB, '
          f'{k2_floor["64 MiB"]:.4f} ms into 64 MiB; K2 {k2_ms:.4f} ms')
    results['K2'] = dict(max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain,
                         bound=k2_bound, library_ms=None,
                         atomics_floor_ms=k2_floor)
    shapes['K2'] = hashgrid_cuda.encode_backward_launch_shapes(TPU_GRID, n_tr)
    shapes['K2 reference'] = hashgrid_cuda.encode_backward_launch_shapes(
        ref_grid, n_tr)
    _print_shapes(gpu, {f'{key} N={n_tr} {kernel}': sh
                        for key in ('K2', 'K2 reference')
                        for kernel, sh in shapes[key].items()})

    A3 = hashgrid_cuda.hashgrid_encode(table, x2, TPU_GRID)
    B3 = torch.zeros((n_tr, 32), device=dev)
    B3[:, :12] = torch.rand((n_tr, 12), generator=g).to(dev) * 2 - 1
    B3[:, 16:32] = torch.randn((n_tr, 16), generator=g).to(dev) * 0.3
    g1 = torch.randn((n_tr, packed[7].shape[1]), generator=g).to(dev)
    gf = torch.randn((n_tr, packed[10].shape[1]), generator=g).to(dev)
    gl = torch.randn((n_tr, packed[13].shape[1]), generator=g).to(dev)
    dA, dB, dws = heads_cuda.fused_heads_backward(packed, A3, B3, g1, gf, gl)
    wA, wB, wws = heads_cuda.fused_heads_backward_plain(
        packed, A3, B3, g1, gf, gl, torch.bfloat16)
    # bf16 operands on both sides, sums in another order (as K3f). That
    # order can round an activation that sits at 0 to either side, and the
    # ReLU mask of that (point, unit) then flips: the point's cotangents
    # differ by O(their size) there. So dA and dB are held within 1e-2 of
    # their norm, with at most 3e-4 of their elements beyond 2e-2 of the
    # largest magnitude (the seeded inputs gave 9.0e-5 and 5.0e-5 on the
    # H100); each weight gradient, a sum over 131,072 points, within 1e-2
    # of its norm.
    checks.rel_norm(f'K3b dA N={n_tr}', dA, wA, 1e-2)
    k3b_err = checks.flips(f'K3b dA N={n_tr} elements', dA, wA,
                           2e-2 * float(wA.abs().max()), 3e-4)
    checks.rel_norm(f'K3b dB N={n_tr}', dB, wB, 1e-2)
    checks.flips(f'K3b dB N={n_tr} elements', dB, wB,
                 2e-2 * float(wB.abs().max()), 3e-4)
    # The second witness, for the cause: against the fp32 plain version,
    # the kernel is no less accurate than the bf16 plain version. Both
    # round at the same places, so where the kernel departs from the bf16
    # plain version by mask flips alone, its distance from fp32 (bf16's own
    # error, mask flips included) grows by a small share; a fault (a wrong
    # index, a dropped term or mask) adds errors of the values' own size.
    fA, fB, _ = heads_cuda.fused_heads_backward_plain(packed, A3, B3, g1, gf,
                                                      gl, torch.float32)
    k3b_witness = {
        key: checks.no_worse(f'K3b {key} N={n_tr} against fp32', got, ref,
                             want, 2e-2 * float(want.abs().max()), 1.1)
        for key, got, ref, want in (('dA', dA, wA, fA), ('dB', dB, wB, fB))}
    del fA, fB
    weight_names = ('WA', 'WBs', 'W1s', 'W2s', 'WBc', 'WSc', 'W1c', 'W2c',
                    'WSf', 'W1f', 'W2f', 'WFo', 'WSo', 'W1o')
    for name, a, b in zip(weight_names, dws, wws):
        checks.rel_norm(f'K3b d{name}', a, b, 1e-2)
    # Per-block partials summed in a fixed order: a second launch on the
    # same inputs gives the same bits.
    _, _, again = heads_cuda.fused_heads_backward(packed, A3, B3, g1, gf, gl)
    checks.true('K3b dW bit-equal across two launches',
                all(torch.equal(a, b) for a, b in zip(dws, again)))
    del dA, dB, dws, wA, wB, wws, again
    k3b_ms = _cuda_ms(lambda: heads_cuda.fused_heads_backward(
        packed, A3, B3, g1, gf, gl, need_dB=False), 10)
    k3b_plain = _cuda_ms(lambda: heads_cuda.fused_heads_backward_plain(
        packed, A3, B3, g1, gf, gl, torch.bfloat16), 3)
    shapes['K3b'] = heads_cuda.heads_launch_shapes(packed, A3, B3,
                                                   need_dB=False)
    _print_shapes(gpu, {f'K3b N={n_tr} {k}': v for k, v in
                        shapes['K3b'].items() if k != 'heads_fwd_kernel'})

    # K3b's peak memory above its inputs in the training step's call (the
    # workspace, the partials, dA and dW), and its kernels' device times by
    # name from torch.profiler: heads_bwd_kernel (recompute, backward chain
    # and the weight gradients' operands to the workspace), da_kernel,
    # dw_kernel for dWA and for the other 13, sum_partials_kernel; and K3f
    # at the same N, the recompute's own code alone.
    def k3b_train():
        return heads_cuda.fused_heads_backward(packed, A3, B3, g1, gf, gl,
                                               need_dB=False)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    k3b_train()
    torch.cuda.synchronize()
    k3b_mem = torch.cuda.max_memory_allocated() - base
    print(f'K3b memory [{gpu}] N={n_tr}: peak {k3b_mem / 1e6:.1f} MB above '
          f'its inputs ({k3b_mem / n_tr:.0f} B a point)')
    phase_ms = {'K3b': _kernel_ms(k3b_train),
                'K3f': _kernel_ms(lambda: heads_cuda.fused_heads(packed, A3,
                                                                 B3))}
    k3b_breakdown = None
    if all(v is not None for v in phase_ms.values()):
        def kernel(key, name):
            return sum(ms for k, ms in phase_ms[key].items() if name in k)

        k3b_breakdown = {
            'recompute (K3f alone)': kernel('K3f', 'heads_fwd_kernel'),
            'heads_bwd_kernel': kernel('K3b', 'heads_bwd_kernel'),
            'da_kernel': kernel('K3b', 'da_kernel'),
            'dw_kernel dWA': kernel('K3b', 'dw_kernel<true>'),
            'dw_kernel others': kernel('K3b', 'dw_kernel<false>'),
            'sum_partials_kernel': kernel('K3b', 'sum_partials'),
        }
        print(f'K3b phases [{gpu}] N={n_tr}, device ms per call: ' + ', '.join(
            f'{k} {v:.4f}' for k, v in k3b_breakdown.items()))
    else:
        print('K3b phases: the trace holds no device time: not measured')

    def heads_library_backward():
        # The yardstick: autograd's backward of the bf16 torch.matmul chain
        # (heads_library's products), graph built once.
        ws = [w.detach().clone().requires_grad_(True) for w in packed]
        (WA, WBs, W1s, W2s, WBc, WSc, W1c, W2c, WSf, W1f, W2f, WFo, WSo,
         W1o) = ws
        a = A3.to(torch.bfloat16).requires_grad_(True)
        b = B3.to(torch.bfloat16)
        h = torch.relu(a @ WA + b @ WBs)
        S = torch.relu(h @ W1s) @ W2s
        c = torch.relu(torch.relu(b @ WBc + S @ WSc) @ W1c) @ W2c
        F = torch.relu(torch.relu(S @ WSf) @ W1f) @ W2f
        L = torch.relu(torch.relu(F) @ WFo + S @ WSo) @ W1o
        outs = (torch.exp(torch.clamp(S[:, :1].float(), max=15.0)),
                torch.sigmoid(c[:, :3].float()), F, L)
        cots = (g1[:, :1], g1[:, 1:4], gf.to(torch.bfloat16),
                gl.to(torch.bfloat16))
        return lambda: torch.autograd.grad(outs, [a, *ws], cots,
                                           retain_graph=True)

    k3b_lib = _cuda_ms(heads_library_backward(), 10)
    # Real widths: A, B's 28 columns and the cotangents of the 4 + S + C
    # real outputs read, dA and the fp32 weight gradients written; the
    # forward recomputed (all but the logits layer), the cotangents of
    # every layer but those of B, and every weight gradient.
    s_dim = params['semantic_features'][2].shape[1]
    c_dim = params['semantic_out'][1].shape[1]
    macs_fwd = head_macs - params['semantic_out'][1].numel()
    macs_data = head_macs - 12 * params['sigma_net'][0].shape[1] \
        - 16 * params['color_net'][0].shape[1]
    k3b_bound = _bound(
        2 * _nbytes(A3) + n_tr * (28 + 4 + s_dim + c_dim) * 4
        + head_macs * (2 + 4),
        2 * n_tr * (macs_fwd + macs_data + head_macs), PEAK_BF16)
    results['K3b'] = dict(max_abs_err=k3b_err, ms=k3b_ms,
                          plain_ms=k3b_plain, bound=k3b_bound,
                          library_ms=k3b_lib)
    del A3, B3, g1, gf, gl, g2

    n4b = TRAIN_BATCH * PROPOSAL_STEPS  # proposal samples per step: 262,144
    X4 = (torch.rand((n4b, 36), generator=g) * 2 - 1).to(dev)
    g4 = torch.zeros((n4b, packed3[2].shape[1]), device=dev)
    g4[:, 0] = torch.randn(n4b, generator=g).to(dev)  # density's column
    dX, dws = heads_cuda.fused_mlp3_backward(packed3, X4, g4)
    wX, wws = heads_cuda.fused_mlp3_backward_plain(packed3, X4, g4,
                                                   torch.bfloat16)
    k4b_err = checks.close(f'K4b dX N={n4b}', dX, wX, rtol=0.0,
                           atol=2e-2 * float(wX.abs().max()))
    for name, a, b in zip(('W0', 'W1', 'W2'), dws, wws):
        checks.rel_norm(f'K4b d{name}', a, b, 1e-2)
    del dX, wX, wws
    # Per-block partials summed in a fixed order: a second launch on the
    # same inputs gives the same bits.
    _, again = heads_cuda.fused_mlp3_backward(packed3, X4, g4, need_dX=False)
    checks.true('K4b dW bit-equal across two launches',
                all(torch.equal(a, b) for a, b in zip(dws, again)))
    shapes['K4b'] = {'mlp3_bwd_kernel': heads_cuda.mlp3_launch_shapes(
        packed3, X4)['mlp3_bwd_kernel']}
    _print_shapes(gpu, {f'K4b N={n4b} mlp3_bwd_kernel':
                        shapes['K4b']['mlp3_bwd_kernel']})
    k4b_ms = _cuda_ms(lambda: heads_cuda.fused_mlp3_backward(
        packed3, X4, g4, need_dX=False), 20)
    k4b_plain = _cuda_ms(lambda: heads_cuda.fused_mlp3_backward_plain(
        packed3, X4, g4, torch.bfloat16), 5)

    def mlp3_library_backward():
        ws = [w.detach().clone().requires_grad_(True) for w in packed3]
        Xp = torch.nn.functional.pad(X4, (0, packed3[0].shape[0] - 36))
        out = torch.relu(torch.relu(Xp.to(torch.bfloat16) @ ws[0]) @ ws[1]) \
            @ ws[2]
        cot = g4.to(torch.bfloat16)
        return lambda: torch.autograd.grad(out, ws, cot, retain_graph=True)

    k4b_lib = _cuda_ms(mlp3_library_backward(), 20)
    # X and the one real cotangent column read, the fp32 weight gradients
    # written; the forward recomputed without the output layer, the
    # hidden cotangents, and the three weight gradients (36-64-64-1).
    k4b_bound = _bound(
        _nbytes(X4) + n4b * 4 + mlp3_macs * (2 + 4),
        2 * n4b * ((mlp3_macs - 64) + (mlp3_macs - 36 * 64) + mlp3_macs),
        PEAK_BF16)
    results['K4b'] = dict(max_abs_err=k4b_err, ms=k4b_ms,
                          plain_ms=k4b_plain, bound=k4b_bound,
                          library_ms=k4b_lib)
    del X4, g4, x2, table, enc, x, dws, again
    torch.cuda.empty_cache()

    # ---- 8. the training slice through SimpleTrainer
    trainer, loader, held_out = _train_slice(dev, args.seed)
    train_options = trainer.render_options
    workspace = trainer.workspace

    # (a) one step, kernels against plain versions: same params and draws.
    step_batch = next(loader)
    draws = draw_perturbations(trainer.generator, TRAIN_BATCH, train_options)
    parts_k, grads_k = trainer.loss_and_grads(step_batch, draws)
    with _plain_kernels(hashgrid_cuda, heads_cuda):
        parts_p, grads_p = trainer.loss_and_grads(step_batch, draws)
    # bf16 operands in the heads on both sides, rounded at other places
    # (the kernels round every cotangent to bf16, autograd of the plain
    # version keeps them fp32): loss parts within 2e-2, each gradient
    # within 5e-2 of its norm.
    for key in parts_k:
        checks.close(f'train step loss {key}', parts_k[key], parts_p[key],
                     atol=1e-6, rtol=2e-2)
    grad_errors = {name: checks.rel_norm(f'train step grad {name}',
                                         grads_k[name], grads_p[name], 5e-2)
                   for name in grads_k}
    del grads_k, grads_p

    # (b) the main path: TRAIN_STEPS steps through train_iterations.
    _, mse_before = trainer.eval_step(held_out)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    chunk_losses = [trainer.train_iterations(loader, TRAIN_CHUNK)
                    for _ in range(TRAIN_STEPS // TRAIN_CHUNK)]
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = dict(_kernels.launches)
    kernel_names = {'K1': hashgrid_cuda.NAME, 'K2': hashgrid_cuda.BWD_NAME,
                    'K3f': heads_cuda.HEADS, 'K3b': heads_cuda.HEADS_BWD,
                    'K4f': heads_cuda.MLP3, 'K4b': heads_cuda.MLP3_BWD}
    for name in kernel_names.values():
        checks.true(f'train launches {name}',
                    train_launches.get(name, 0) == TRAIN_STEPS,
                    f'{train_launches.get(name, 0)} (expected {TRAIN_STEPS})')
    loss_curve = [{k: float(v) for k, v in losses.items()}
                  for losses in chunk_losses]
    checks.true('train losses finite', all(
        np.isfinite(v) for losses in loss_curve for v in losses.values()))
    _, mse_after = trainer.eval_step(held_out)
    # A held-out view of the sphere after 200 steps: its rgb loss (MSE)
    # falls at least 4-fold from the untrained field's.
    checks.true('train held-out rgb loss falls', mse_after * 4 < mse_before,
                f'{mse_before:.5f} -> {mse_after:.5f} (PSNR '
                f'{_psnr(mse_before):.2f} -> {_psnr(mse_after):.2f} dB)')

    # K2 on the main path's own traffic: the (g, x) of one more step's
    # backward, after the 200 steps (main samples ray by ray, where the
    # trained proposal net concentrates them).
    g_s, x_s = _record_k2_inputs(trainer, loader)
    n_s = x_s.shape[0]
    _check_k2(checks, f'K2 table gradient step samples N={n_s}',
              hashgrid_cuda, g_s, x_s, TPU_GRID)
    k2_step_ms = _cuda_ms(lambda: hashgrid_cuda.hashgrid_encode_backward(
        g_s, x_s, TPU_GRID), 20)
    print(f'K2 [{gpu}] step samples N={n_s}: {k2_step_ms:.4f} ms (uniform '
          f'{results["K2"]["ms"]:.4f} ms)')
    results['K2']['ms_step_samples'] = k2_step_ms
    del g_s, x_s

    # (c) steady state, kernels against plain versions in turns.
    def step_ms():
        batches = [next(loader) for _ in range(STEPS_PER_TURN)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for batch in batches:
            trainer.train_step(batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t1) * 1e3 / STEPS_PER_TURN

    train_steady = {'kernels': [], 'plain': []}
    for _ in range(TRAIN_ROUNDS):
        for side in ('plain', 'kernels', 'kernels', 'plain'):
            if side == 'plain':
                with _plain_kernels(hashgrid_cuda, heads_cuda):
                    train_steady[side].append(step_ms())
            else:
                train_steady[side].append(step_ms())
    train_stats = {k: _quartiles(v) for k, v in train_steady.items()}

    # (d) one step's peak memory, then one step under the profiler.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(next(loader))
    torch.cuda.synchronize()
    train_peak = torch.cuda.max_memory_allocated()
    train_profile, train_busy = _device_profile(
        lambda: trainer.train_step(next(loader)))

    # (e) the trained checkpoint, served.
    trainer.save_checkpoint('best', include_optimizer=False)
    served_train = InferenceModel.from_checkpoint(
        Field(config, device=dev,
              generator=torch.Generator().manual_seed(args.seed + 3)),
        workspace, num_steps=NUM_STEPS, proposal_steps=PROPOSAL_STEPS,
        max_ray_batch=MAX_RAY_BATCH)
    served_out = served_train.render(held_out)
    own_image = trainer.test_step(held_out)[0].cpu().numpy()
    checks.true('trained checkpoint serves', served_out['image'].shape == (
        FRAME_H, FRAME_W, 3) and bool(np.isfinite(served_out['image']).all())
        and float(np.abs(served_out['image'] - own_image).max()) < 1e-5,
        f'max |served - trainer render| = '
        f'{float(np.abs(served_out["image"] - own_image).max()):.3e}')

    print(f'train [{gpu}]: {TRAIN_STEPS} steps in {train_s:.3f} s '
          f'({train_s * 1e3 / TRAIN_STEPS:.3f} ms per step incl. '
          f'{TRAIN_STEPS // TRAIN_CHUNK} EMA ticks); loss at chunk ends '
          f'{[round(c["total"], 5) for c in loss_curve]}')
    print(f'train step grads: worst relative error '
          f'{max(grad_errors.values()):.3e} '
          f'({max(grad_errors, key=grad_errors.get)})')
    for side, st in train_stats.items():
        print(f'train steady [{gpu}] {side}: ms per step median '
              f'{st["median"]:.3f} (q1 {st["q1"]:.3f}, q3 {st["q3"]:.3f}, '
              f'n {st["n"]}); rays/s '
              f'{TRAIN_BATCH / st["median"] * 1e3:.1f}')
    print(f'train step peak memory [{gpu}]: {train_peak / 1e9:.3f} GB '
          f'allocated at {TRAIN_BATCH} rays')
    if train_profile is None:
        print('train profile: the trace holds no device time: not measured')
    else:
        wall = train_stats['kernels']['median']
        print(f'train profile [{gpu}]: device busy {train_busy:.3f} ms of a '
              f'{wall:.3f} ms step (median wall, unprofiled): busy share '
              f'{train_busy / wall:.4f}')
        for name, ms, count in train_profile[:16]:
            print(f'  {ms:9.3f} ms {ms / train_busy:7.2%} x{count:<5d} '
                  f'{name[:90]}')
    for key in ('K2', 'K3b', 'K4b'):
        r = results[key]
        print(f'kernel {key} [{gpu}]: {r["ms"]:.4f} ms, plain '
              f'{r["plain_ms"]:.4f} ms, library {r["library_ms"]}, bound '
              f'{r["bound"][0]:.4f} ms ({r["bound"][1]})')

    table_rows = [
        ('K1 hashgrid_encode', 'autolabel_tpu_torch/csrc/hashgrid_encode.cu',
         'autolabel_tpu/ops/hashgrid_pallas.py:33', 'K1'),
        ('K2 hashgrid_encode_bwd', 'autolabel_tpu_torch/csrc/hashgrid_bwd.cu',
         'autolabel_tpu/ops/hashgrid_pallas.py:141', 'K2'),
        ('K3f fused_heads', 'autolabel_tpu_torch/csrc/heads_fwd.cu',
         'autolabel_tpu/ops/heads_pallas.py:182', 'K3f'),
        ('K3b fused_heads_bwd', 'autolabel_tpu_torch/csrc/heads_bwd.cu',
         'autolabel_tpu/ops/heads_pallas.py:196', 'K3b'),
        ('K4f fused_mlp3', 'autolabel_tpu_torch/csrc/mlp3.cu',
         'autolabel_tpu/ops/heads_pallas.py:407', 'K4f'),
        ('K4b fused_mlp3_bwd', 'autolabel_tpu_torch/csrc/mlp3.cu',
         'autolabel_tpu/ops/heads_pallas.py:414', 'K4b'),
    ]
    kernels = [{
        'name': name, 'route': 'cuda', 'source': source, 'replaces': replaces,
        'launches': train_launches.get(kernel_names[key], 0),
        'launches_train': train_launches.get(kernel_names[key], 0),
        'launches_render': launches.get(kernel_names[key], 0),
        'max_abs_err': results[key]['max_abs_err'],
        'ms': results[key]['ms'], 'plain_ms': results[key]['plain_ms'],
        'bound_ms': results[key]['bound'][0],
        'bound_by': results[key]['bound'][1],
        'library_ms': results[key]['library_ms'],
        **{k: results[key][k] for k in ('ms_step_samples', 'atomics_floor_ms')
           if k in results[key]},
    } for name, source, replaces, key in table_rows]

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'chip_smoke.json'), 'w') as f:
        json.dump({'gpu': gpu, 'torch': torch.__version__,
                   'cuda': torch.version.cuda, 'build_s': build_s,
                   'frame_s': frame_s, 'plain_frame_s': plain_s,
                   'steady_frame_ms': steady, 'steady_stats': steady_stats,
                   'profile_busy_ms': busy_ms,
                   'profile': profile_rows,
                   'render_errors': render_errors,
                   'train_s': train_s, 'train_launches': train_launches,
                   'train_loss_curve': loss_curve,
                   'train_heldout_mse': [mse_before, mse_after],
                   'train_grad_rel_errors': grad_errors,
                   'k3b_against_fp32': k3b_witness,
                   'launch_shapes': shapes, 'k3b_phases': k3b_breakdown,
                   'k1_gathered_bytes': k1_gathered,
                   'k1_ray_ordered_ms': k1_ray_ms,
                   'k1_narrow_ms': k1_narrow_ms,
                   'k3b_phase_profiles': phase_ms, 'k3b_peak_bytes': k3b_mem,
                   'train_peak_bytes': train_peak,
                   'train_steady_step_ms': train_steady,
                   'train_steady_stats': train_stats,
                   'train_profile_busy_ms': train_busy,
                   'train_profile': train_profile,
                   'kernels': kernels, 'failures': checks.failures,
                   'build_log': _kernels.build_log}, f, indent=1)
    print(f'total: {time.perf_counter() - t_start:.1f} s')
    if checks.failures:
        print(f'FAILED: {checks.failures}', file=sys.stderr)
        return 1
    print(gpu)  # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
