"""Rank targets of tests/test_torch_port_parallel.py: the port's mesh step
in spawned ranks on the CPU (gloo, a file rendezvous).

Spawned children re-import this module, so it imports neither jax nor
autolabel_tpu: the test process computes the JAX references and writes the
cases (numpy params, batches and draws, port configs) to a work directory
as pickles; every rank reads them, runs its part, and writes what the test
compares (rank 0 the gathered results, each rank its own selection).
"""
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

from autolabel_tpu_torch import bridge, parallel
from autolabel_tpu_torch.models.field import Field
from autolabel_tpu_torch.ops import encoders, hashgrid_cuda
from autolabel_tpu_torch.train.losses import LossOptions
from autolabel_tpu_torch.train.trainer import SimpleTrainer


def spawn(world, workdir, tag):
    """Run every case of workdir/cases.pkl on a world of `world` ranks
    (DP `world` // 2 x TP 2 when world is 4, else DP `world`)."""
    init = os.path.join(workdir, f'rendezvous_{tag}')
    torch.multiprocessing.start_processes(
        _entry, args=(world, init, workdir, tag), nprocs=world, join=True,
        start_method='spawn')


def _entry(rank, world, init, workdir, tag):
    torch.set_num_threads(1)
    parallel.init_world(rank, world, init, 'cpu')
    try:
        mesh = (parallel.make_mesh_2d(world // 2, 2, device='cpu')
                if world == 4 else parallel.make_mesh(world, device='cpu'))
        with open(os.path.join(workdir, 'cases.pkl'), 'rb') as f:
            cases = pickle.load(f)
        out = {'steps': {}}
        for case in cases['steps']:
            if world in case['worlds']:
                out['steps'][case['name']] = _step(case, mesh)
        out['select'] = _select(cases['select'], mesh)
        out['gather'] = _gather_backward(mesh)
        out['nonfinite'] = _nonfinite(cases['steps'][0], mesh)
        out['modules'] = sorted({m.split('.')[0] for m in sys.modules})
        with open(os.path.join(workdir, f'{tag}_rank{rank}.pkl'), 'wb') as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _trainer(case, mesh):
    field = bridge.load_params(Field(case['config'], device='cpu'),
                               case['params'])
    return SimpleTrainer('t', field, iters=1000, loss_options=LossOptions(),
                         render_options=case['options'], mesh=mesh,
                         metrics=False)


def _step(case, mesh):
    """One step's loss parts and gradients on the global batch (the table's
    gathered whole), without an update; and the global norms the sampled
    backward drew from (None without a subsample)."""
    seen = []
    select = encoders.select_backward_points_global

    def recording(g, u_sys, k, mesh_):
        seen.append((encoders.select_norms_global(g, mesh_).numpy(),
                     float(u_sys), k))
        return select(g, u_sys, k, mesh_)

    trainer = _trainer(case, mesh)
    draws = case['draws'] and {k: torch.tensor(v)
                               for k, v in case['draws'].items()}
    encoders.select_backward_points_global = recording
    try:
        parts, grads = trainer.loss_and_grads(case['batch'], draws)
    finally:
        encoders.select_backward_points_global = select
    grads['encoder.grid'] = parallel.gather_grid(grads['encoder.grid'], mesh)
    return {'parts': {k: float(v) for k, v in parts.items()},
            'grads': bridge.state_to_numpy(grads),
            'norms': seen[0] if seen else None}


def _select(case, mesh):
    """The global subsample from this rank's rows and feature slice of the
    cotangent g (N, L F): (the global indices of its draws, their coefs,
    its model index)."""
    g, u_sys, k, levels = case['g'], case['u_sys'], case['k'], case['levels']
    rows = parallel.batch_sharding(mesh)
    lo, _ = rows.bounds(g.shape[0])
    mine = rows.take(g).reshape(-1, levels, g.shape[1] // levels)
    mine = parallel.grid_sharding(mesh).take(mine).reshape(
        mine.shape[0], -1)
    u = torch.zeros((levels, mine.shape[0] + 1))
    u[0, -1] = float(u_sys)
    sel, coef, count = hashgrid_cuda.select_points(
        torch.tensor(np.ascontiguousarray(mine)), u, k, mesh)
    m = int(count[0])
    return (sel[:m].numpy() + lo, coef[:m].numpy(),
            parallel.axis_index(mesh, parallel.MODEL))


def _gather_backward(mesh):
    """gather_features' forward and backward on a (16, L F / m) slice: the
    whole is the slices interleaved level by level, and the slice's
    gradient is its own part of the cotangent, unscaled."""
    levels, f = 3, 4
    m = parallel.axis_size(mesh, parallel.MODEL)
    j = parallel.axis_index(mesh, parallel.MODEL)
    whole = torch.arange(16 * levels * f * m, dtype=torch.float32).reshape(
        16, levels, f * m)
    cot = torch.linspace(-1.0, 1.0, whole.numel()).reshape(whole.shape)
    mine = whole[:, :, j * f:(j + 1) * f].reshape(16, -1).requires_grad_()
    out = parallel.gather_features(mine, mesh, levels)
    (out * cot.reshape(16, -1)).sum().backward()
    return (torch.equal(out, whole.reshape(16, -1)),
            torch.equal(mine.grad,
                        cot[:, :, j * f:(j + 1) * f].reshape(16, -1)))


def _nonfinite(case, mesh):
    """A NaN in the last rank's table-slice gradient: (whether the update
    was applied, whether the params stayed), then a finite step."""
    trainer = _trainer(case, mesh)
    opt = trainer.optimizer
    before = {k: v.detach().clone() for k, v in opt.params.items()}
    grads = {k: torch.ones_like(p) for k, p in opt.params.items()}
    if dist.get_rank() == dist.get_world_size() - 1:
        grads['encoder.grid'][0, 0, 0] = float('nan')
    skipped = opt.step(grads, mesh)
    kept = all(torch.equal(before[k], p) for k, p in opt.params.items())
    applied = opt.step({k: torch.ones_like(p)
                        for k, p in opt.params.items()}, mesh)
    moved = not torch.equal(before['encoder.grid'],
                            opt.params['encoder.grid'])
    return bool(skipped), kept, bool(applied), moved
