"""Rank targets of tests/test_torch_port_parallel.py and
tests/test_torch_port_parallel_pose.py: the port's mesh step in spawned
ranks on the CPU (gloo, a file rendezvous).

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
from autolabel_tpu_torch.train.trainer import (InteractiveTrainer,
                                               SimpleTrainer)


def spawn(world, workdir, tag, pose=False):
    """Run every case of workdir/cases.pkl (with pose, of
    workdir/pose_cases.pkl: _pose_entry) on a world of `world` ranks (DP
    `world` // 2 x TP 2 when world is 4, else DP `world`)."""
    init = os.path.join(workdir, f'rendezvous_{tag}')
    torch.multiprocessing.start_processes(
        _pose_entry if pose else _entry, args=(world, init, workdir, tag),
        nprocs=world, join=True, start_method='spawn')


def _mesh(world):
    return (parallel.make_mesh_2d(world // 2, 2, device='cpu')
            if world == 4 else parallel.make_mesh(world, device='cpu'))


def _entry(rank, world, init, workdir, tag):
    torch.set_num_threads(1)
    parallel.init_world(rank, world, init, 'cpu')
    try:
        mesh = _mesh(world)
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


# -- joint pose refinement and the interactive trainer on a mesh -------------

def _pose_entry(rank, world, init, workdir, tag):
    torch.set_num_threads(1)
    parallel.init_world(rank, world, init, 'cpu')
    try:
        mesh = _mesh(world)
        with open(os.path.join(workdir, 'pose_cases.pkl'), 'rb') as f:
            cases = pickle.load(f)
        out = {'pose': {case['name']: _pose_steps(case, mesh)
                        for case in cases['pose']},
               'interactive': _interactive(cases['interactive'], mesh),
               'sum_once': _sum_once(mesh),
               'point_grad': _field_point_grad(cases['pose'][-1], mesh),
               'collectives': _collectives(cases['pose'][0], mesh),
               'resume': _pose_resume(cases['pose'][-1], mesh,
                                      os.path.join(workdir, f'{tag}_ws')),
               'model_index': parallel.axis_index(mesh, parallel.MODEL)}
        with open(os.path.join(workdir, f'{tag}_rank{rank}.pkl'), 'wb') as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def pose_trainer(case, mesh, iters, pose=True, workspace=None):
    """A SimpleTrainer of the case's field and options, with pose
    refinement from its (R0, t0) and deltas (unless pose is False),
    resuming the latest checkpoint in `workspace` when given."""
    field = bridge.load_params(Field(case['config'], device='cpu'),
                               case['params'])
    trainer = SimpleTrainer('t', field, iters=iters,
                            loss_options=LossOptions(),
                            render_options=case['options'], mesh=mesh,
                            metrics=False, seed=3, workspace=workspace,
                            pose_refine=case['pose_init'] if pose else None)
    if workspace is not None:
        return trainer
    with torch.no_grad():
        for k, p in trainer.pose.items():
            p.copy_(torch.tensor(case['pose'][k]))
    return trainer


def pose_run(trainer, batches):
    """train_step on each batch (the trainer's own draws): each step's
    loss parts and reduced pose gradients, and the deltas after them."""
    step = trainer.optimizer.step
    grads = []

    def recording(g, mesh=None):
        grads.append({k: g[k].clone() for k in g if k.startswith('pose.')})
        return step(g, mesh)

    trainer.optimizer.step = recording
    parts = [trainer.train_step(b) for b in batches]
    trainer.optimizer.step = step
    return {'parts': [{k: v.numpy() for k, v in p.items()} for p in parts],
            'pose_grads': [{k: v.numpy() for k, v in g.items()}
                           for g in grads],
            'pose': {k: v.detach().clone().numpy()
                     for k, v in trainer.pose.items()},
            'table': parallel.gather_grid(
                trainer.field.encoder['grid'].detach(),
                trainer.mesh).numpy()}


def _pose_steps(case, mesh):
    """Step 1's loss parts and gradients (the table's gathered whole) with
    every level open (iters None: no level windows), without an update;
    then pose_run's three steps under the level windows (iters 10: one
    window a step, the deltas moving from the second)."""
    trainer = pose_trainer(case, mesh, None)
    draws = {k: torch.tensor(v) for k, v in case['draws'].items()}
    parts, grads = trainer.loss_and_grads(case['batch'], draws)
    grads['encoder.grid'] = parallel.gather_grid(grads['encoder.grid'], mesh)
    return {'parts': {k: float(v) for k, v in parts.items()},
            'grads': bridge.state_to_numpy(grads),
            'steps': pose_run(pose_trainer(case, mesh, 10),
                              case['batches'])}


def _interactive(case, mesh):
    """InteractiveTrainer with EMA_EVERY 2: init over the case's batches,
    three take_steps with JAX's draws; their loss parts, and whether the
    EMA ticked at the second step alone."""
    field = bridge.load_params(Field(case['config'], device='cpu'),
                               case['params'])
    InteractiveTrainer.EMA_EVERY = 2
    trainer = InteractiveTrainer('t', field, render_options=case['options'],
                                 mesh=mesh, metrics=False)
    trainer.init(iter(case['batches']))
    ema0 = trainer.ema['sigma_net.0'].clone()
    parts, ticks = [], []
    for draws in case['draws']:
        before = trainer.ema['sigma_net.0'].clone()
        got = trainer.take_step({k: torch.tensor(v)
                                 for k, v in draws.items()})
        parts.append({k: float(v) for k, v in got.items()})
        ticks.append(not torch.equal(before, trainer.ema['sigma_net.0']))
    return {'parts': parts, 'ticks': ticks, 'step': trainer.step,
            'global_step': trainer.global_step,
            'ema_moved': not torch.equal(ema0, trainer.ema['sigma_net.0'])}


def _sum_once(mesh):
    """sum_grad_over_model on a hand-made loss: a part every rank computes
    whole from x (x^2, as the frequency encode) and a part of model index
    j's slice ((j + 1) x): x's gradient, 2 x + m (m + 1) / 2 when the slices'
    parts are summed once and the whole part is not."""
    j = parallel.axis_index(mesh, parallel.MODEL)
    x = torch.linspace(-1.0, 1.0, 12).reshape(4, 3).requires_grad_()
    mine = parallel.sum_grad_over_model(x, mesh)
    ((x ** 2).sum() + ((j + 1.0) * mine).sum()).backward()
    return x.detach().numpy(), x.grad.numpy()


def _field_point_grad(case, mesh):
    """The field's density gradient for its points (hg+freq: the frequency
    encode's part and the grid's) with the table sharded on this mesh, and
    the same field whole without a mesh: (sharded, whole)."""
    x = torch.tensor(case['batch']['rays_d'] * 0.7)

    def dx(field):
        xx = x.clone().requires_grad_()
        sigma, geo = field.density(xx)
        (sigma.sum() + geo.square().sum()).backward()
        return xx.grad.numpy()

    whole = bridge.load_params(Field(case['config'], device='cpu'),
                               case['params'])
    want = dx(whole)
    sharded = parallel.shard_field(
        bridge.load_params(Field(case['config'], device='cpu'),
                           case['params']), mesh)
    return dx(sharded), want


def _collectives(case, mesh):
    """How many collectives (all_gather, all_reduce_sum) one step's
    loss_and_grads calls, and how many times the field applied
    sum_grad_over_model, without pose refinement and with it."""
    saved = (parallel.all_gather, parallel.all_reduce_sum,
             parallel.sum_grad_over_model)
    calls = {'collectives': 0, 'applied': 0}

    def counted(fn):
        def run(*args, **kwargs):
            calls['collectives'] += 1
            return fn(*args, **kwargs)
        return run

    def applied(x, mesh_):
        calls['applied'] += 1
        return saved[2](x, mesh_)

    draws = {k: torch.tensor(v) for k, v in case['draws'].items()}
    out = {}
    parallel.all_gather, parallel.all_reduce_sum = map(counted, saved[:2])
    parallel.sum_grad_over_model = applied
    try:
        for name, pose in (('plain', False), ('pose', True)):
            trainer = pose_trainer(case, mesh, None, pose)
            calls.update(collectives=0, applied=0)
            trainer.loss_and_grads(case['batch'], draws)
            out[name] = dict(calls)
    finally:
        (parallel.all_gather, parallel.all_reduce_sum,
         parallel.sum_grad_over_model) = saved
    return out


def _pose_resume(case, mesh, workspace):
    """A checkpoint written on the mesh after pose_run's three steps (rank
    0 writes, the table whole), resumed on the mesh with pose refinement
    (the deltas, their EMA and Adam moments, and the rank's table slice
    as they were) and across the toggle without it (the field resumed,
    the moments restarted)."""
    trainer = pose_trainer(case, mesh, 10)
    pose_run(trainer, case['batches'])
    trainer.workspace = workspace
    trainer.save_checkpoint()
    again = pose_trainer(case, mesh, 10, workspace=workspace)
    off = pose_trainer(case, mesh, 10, pose=False, workspace=workspace)
    opt, opt_again = trainer.optimizer.state, again.optimizer.state
    return {
        'pose': all(torch.equal(again.pose[k], trainer.pose[k])
                    and torch.equal(again.ema[f'pose.{k}'],
                                    trainer.ema[f'pose.{k}'])
                    and torch.equal(opt_again['mu'][f'pose.{k}'],
                                    opt['mu'][f'pose.{k}'])
                    for k in trainer.pose),
        'table': torch.equal(again.field.encoder['grid'],
                             trainer.field.encoder['grid']),
        'steps': (again.global_step, off.global_step),
        'toggle': (not off.pose and torch.equal(off.field.encoder['grid'],
                                                trainer.field.encoder['grid'])
                   and int(off.optimizer.state['count']) == 0),
        'moved': any(bool(trainer.pose[k].any()) for k in trainer.pose)}
