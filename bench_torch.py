"""Benchmark of the PyTorch port: steady-state training throughput of the
flagship configuration on one CUDA card, bench.py's workload.

    python3 bench_torch.py

The model, batch and render options are bench.py's: hg+freq encoding on
the TPU_GRID table (4 levels x 128 features x 2^15 rows) with simplex
interpolation, hidden 128, 64 semantic features, 6 classes, bound 2, the
proposal net (64 proposal samples place 32 main samples), the
exact-forward / sampled-backward encode with 2 scatter rows a level and a
quarter of the points scattering (stochastic_corners pinned to 0), batch
4096 drawn from np.random.default_rng(0), lr 5e-3. A step is
SimpleTrainer.train_step of the port (render, the four losses, backward,
Adam). Each leg runs 5 warm-up steps, then times 40, fenced by
torch.cuda.synchronize. Legs: the heads as bench.py runs them
(heads_impl='xla': plain products), the same with exact gathers
(sampled_backward=0, as bench.py's exact leg), and the fused head kernels
(heads_impl='pallas').

Prints ONE JSON line with bench.py's keys (train_rays_per_sec_effective,
vs_baseline over bench.py's 100,000 rays/s) and the other legs in extra
keys, with the card's name and power limit. Needs a CUDA card: without
one it exits non-zero and prints no result.
"""
import json
import subprocess
import sys
import time

import numpy as np

REFERENCE_RAYS_PER_SEC = 100_000.0  # bench.py's denominator

BATCH = 4096
NUM_STEPS = 32
PROPOSAL_STEPS = 64
GRID_INTERP = 'simplex'
SAMPLED_BACKWARD = 2
BACKWARD_POINTS = 0.25
EXACT_FINAL_FRACTION = 0.0
WARMUP_ITERS = 5
BENCH_ITERS = 40


def _batch(device):
    """bench.py's synthetic batch, the same draws in the same order."""
    import torch
    rng = np.random.default_rng(0)
    d = rng.normal(size=(BATCH, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    batch = {
        'rays_o': rng.uniform(-0.5, 0.5, (BATCH, 3)).astype(np.float32),
        'rays_d': d,
        'direction_norms': np.ones((BATCH, 1), np.float32),
        'pixels': rng.random((BATCH, 3)).astype(np.float32),
        'depth': rng.uniform(0.5, 2.0, BATCH).astype(np.float32),
        'semantic': rng.integers(-1, 6, BATCH).astype(np.int64),
    }
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _measure(heads_impl, sampled_backward, backward_points, batch):
    """Seconds per step of SimpleTrainer.train_step on a fresh field (the
    same seeded init for every leg)."""
    import torch
    from autolabel_tpu_torch.models.field import Field, FieldConfig
    from autolabel_tpu_torch.ops.encoders import TPU_GRID
    from autolabel_tpu_torch.render.renderer import RenderOptions
    from autolabel_tpu_torch.train.trainer import SimpleTrainer
    field = Field(FieldConfig(encoding='hg+freq', hidden_dim=128,
                              hidden_dim_color=128, hidden_dim_semantic=64,
                              semantic_classes=6, bound=2.0, grid=TPU_GRID,
                              grid_interp=GRID_INTERP, proposal=True,
                              heads_impl=heads_impl),
                  device='cuda', generator=torch.Generator().manual_seed(0))
    options = RenderOptions(num_steps=NUM_STEPS, proposal_steps=PROPOSAL_STEPS,
                            perturb=True, stochastic_corners=0,
                            sampled_backward=sampled_backward,
                            backward_points=backward_points)
    trainer = SimpleTrainer('bench', field, lr=5e-3, iters=10000,
                            render_options=options, metrics=False, seed=1)
    for _ in range(WARMUP_ITERS):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(BENCH_ITERS):
        loss = trainer.train_step(batch)['total']
    torch.cuda.synchronize()
    sec = (time.perf_counter() - start) / BENCH_ITERS
    if not bool(torch.isfinite(loss)):
        raise RuntimeError(f'{heads_impl} leg: non-finite loss')
    return sec


def main():
    import torch
    if not torch.cuda.is_available():
        print('bench_torch: no CUDA device is available', file=sys.stderr)
        return 2
    gpu = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0].strip()
    batch = _batch(torch.device('cuda'))
    sec_sampled = _measure('xla', SAMPLED_BACKWARD, BACKWARD_POINTS, batch)
    sec_exact = _measure('xla', 0, 1.0, batch)
    sec_pallas = _measure('pallas', SAMPLED_BACKWARD, BACKWARD_POINTS, batch)
    effective_sec = ((1.0 - EXACT_FINAL_FRACTION) * sec_sampled
                     + EXACT_FINAL_FRACTION * sec_exact)
    rays_per_sec = BATCH / effective_sec
    print(json.dumps({
        'metric': 'train_rays_per_sec_effective',
        'value': round(rays_per_sec, 1),
        'unit': 'rays/s',
        'vs_baseline': round(rays_per_sec / REFERENCE_RAYS_PER_SEC, 3),
        'sampled_backward_ms_per_step': round(sec_sampled * 1000, 3),
        'exact_ms_per_step': round(sec_exact * 1000, 3),
        'exact_final_fraction': EXACT_FINAL_FRACTION,
        'backward_points': BACKWARD_POINTS,
        'pallas_heads_rays_per_sec': round(BATCH / sec_pallas, 1),
        'pallas_heads_ms_per_step': round(sec_pallas * 1000, 3),
        'gpu': gpu,
        'device': torch.cuda.get_device_name(0),
    }))
    return 0


if __name__ == '__main__':
    sys.exit(main())
