#!/usr/bin/env python3
"""Drive the PyTorch port's render (serving) path on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each failing loudly:
  1. the card's name and power limit, torch and CUDA versions;
  2. build every kernel of the path from csrc/ (nvcc, sm_90a);
  3. hold the hash-grid encode kernel (K1) against its plain version at
     TPU_GRID (N = 524,288, x including 0 and 1) and at the reference
     preset (16 x 2 x 2^19, N = 65,536);
  4. hold the fused head kernel (K3f, N = 524,288) and the proposal MLP
     kernel (K4f, N = 1,048,576) against their plain versions;
  5. the slice: a full-width model (TPU_GRID trilinear encode through K1,
     fused heads through K3f, the 36-64-64-1 proposal net through K4f,
     hidden 128, geo 15, 64 semantic features, 6 classes, bound 2) with
     seeded random weights is written as a numpy checkpoint, loaded
     through InferenceModel.from_checkpoint, and renders 2 frames of
     480 x 360 (num_steps 32, proposal_steps 64, max_ray_batch 16384: 11
     chunks a frame), with every launch count set to 0 just before and read
     just after; the same render with the plain versions swapped in is the
     reference;
  6. ms per frame, rays/s and each kernel's time from CUDA events; the
     steady state, frames rendered in turns (plain, kernels, kernels,
     plain) with their median and quartiles; one frame under
     torch.profiler for device time by kernel and the device's busy share.
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
    from autolabel_tpu_torch import bridge, model_utils
    from autolabel_tpu_torch.core import rays
    from autolabel_tpu_torch.inference import InferenceModel
    from autolabel_tpu_torch.models.field import Field
    from autolabel_tpu_torch.ops import _kernels, hashgrid_cuda, heads_cuda
    from autolabel_tpu_torch.ops.encoders import TPU_GRID, HashGridConfig
    from autolabel_tpu_torch.train import checkpoints

    # fp32 products in the plain versions stay full fp32 (PyTorch's
    # default, stated here).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
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

    # ---- 5a. the model (built here so K3f/K4f see its real weights)
    flags = model_utils.model_flag_parser().parse_args(
        ['--grid-preset', 'tpu', '--proposal', '--heads-impl', 'pallas',
         '--grid-interp', 'trilinear', '--feature-dim', '64'])
    lo, hi = np.full(3, -1.0), np.full(3, 1.0)  # bound = 2.0
    config = dataclasses.replace(model_utils.model_config(lo, hi, 6, flags),
                                 grid_impl='pallas')
    assert config.bound == 2.0 and config.grid == TPU_GRID
    field = Field(config, device=dev, generator=g)
    # A table far from its U(-1e-4, 1e-4) init, so density, color and
    # semantics are non-trivial.
    with torch.no_grad():
        field.encoder['grid'].copy_(
            torch.randn(field.encoder['grid'].shape, generator=g) * 0.5)
    params = field.head_params()

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
    packed3 = [w.to(torch.bfloat16)
               for w in heads_cuda.pack_mlp3(list(field.proposal))]
    got4 = heads_cuda.fused_mlp3(packed3, X)
    want4 = heads_cuda.fused_mlp3_plain(packed3, X, torch.bfloat16)
    k4_err = checks.close('K4f mlp3 N=1048576', got4, want4, atol=2e-2,
                          rtol=2e-2)
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

    table_rows = [
        ('K1 hashgrid_encode', 'autolabel_tpu_torch/csrc/hashgrid_encode.cu',
         'autolabel_tpu/ops/hashgrid_pallas.py:33', hashgrid_cuda.NAME, 'K1'),
        ('K3f fused_heads', 'autolabel_tpu_torch/csrc/heads_fwd.cu',
         'autolabel_tpu/ops/heads_pallas.py:182', heads_cuda.HEADS, 'K3f'),
        ('K4f fused_mlp3', 'autolabel_tpu_torch/csrc/heads_fwd.cu',
         'autolabel_tpu/ops/heads_pallas.py:407', heads_cuda.MLP3, 'K4f'),
    ]
    kernels = [{
        'name': name, 'route': 'cuda', 'source': source, 'replaces': replaces,
        'launches': launches.get(counter, 0),
        'max_abs_err': results[key]['max_abs_err'],
        'ms': results[key]['ms'], 'plain_ms': results[key]['plain_ms'],
        'bound_ms': results[key]['bound'][0],
        'bound_by': results[key]['bound'][1],
        'library_ms': results[key]['library_ms'],
    } for name, source, replaces, counter, key in table_rows]

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'chip_smoke.json'), 'w') as f:
        json.dump({'gpu': gpu, 'torch': torch.__version__,
                   'cuda': torch.version.cuda, 'build_s': build_s,
                   'frame_s': frame_s, 'plain_frame_s': plain_s,
                   'steady_frame_ms': steady, 'steady_stats': steady_stats,
                   'profile_busy_ms': busy_ms,
                   'profile': profile_rows,
                   'render_errors': render_errors,
                   'kernels': kernels, 'failures': checks.failures,
                   'build_log': _kernels.build_log}, f, indent=1)
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
