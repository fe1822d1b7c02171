"""The port's device meshes (autolabel_tpu_torch/parallel) on the CPU.

A mesh step must compute JAX's one-device step on the global batch, as
tests/test_parallel.py holds JAX's own mesh step. The ranks are spawned
processes on gloo with a file rendezvous (tests/torch_parallel_ranks.py,
which imports neither jax nor autolabel_tpu): 2 ranks (DP 2) and 4 ranks
(DP 2 x TP 2, the table sharded on its feature axis). This process
computes the JAX references and hands the ranks the same numpy params,
global batch and draws.

- A world of 1 (make_mesh(1), make_mesh_2d(1, 1)) is bit-equal to no mesh
  over 3 training steps: losses and params.
- DP 2 and DP 2 x TP 2: the loss parts within rtol 1e-4 and the table
  gradient (gathered whole) within atol 1e-5 of JAX's one-device
  value_and_grad (JAX's own bars, tests/test_parallel.py), every other
  gradient as tests/test_torch_port_train.py holds one device: a small
  field (tests/test_parallel.py's _tiny_field, exact trilinear gathers)
  and an F = 8 simplex field with the sampled backward (sampled_backward
  2, backward_points 0.25), whose point subsample is the global batch's;
  DP 2 x TP 2 once against JAX's own 2 x 2 mesh step on the virtual CPU
  devices.
- A batch whose depth mask and labels fall unevenly across the data
  shards: the global means match one device, where per-rank means miss.
- The global subsample (sel, coef) from the ranks' rows and feature
  slices equals JAX's _select_backward_points on inputs away from the
  subsample's boundaries (as tests/test_torch_port_sampled.py holds the
  one-device subsample).
- gather_features' backward takes the rank's slice, unscaled; a NaN in one
  rank's table slice skips the update on every rank.
- The train CLI with --mesh-devices 4 --mesh-model 2: its first step's
  loss parts within rtol 1e-5 of the one-device CLI's on the same seeded
  batches, a host-complete checkpoint, and a resume at the global step.
"""
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from autolabel_tpu.models.field import Field as JaxField
from autolabel_tpu.models.field import FieldConfig as JaxFieldConfig
from autolabel_tpu.ops import encoders as jax_encoders
from autolabel_tpu.ops.encoders import HashGridConfig as JaxGridConfig
from autolabel_tpu.parallel import batch_sharding as jax_batch_sharding
from autolabel_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from autolabel_tpu.parallel import tree_shardings as jax_tree_shardings
from autolabel_tpu.render.renderer import RenderOptions as JaxRenderOptions
from autolabel_tpu.render.renderer import render_rays as jax_render_rays
from autolabel_tpu.train.losses import LossOptions as JaxLossOptions
from autolabel_tpu.train.losses import compute_losses as jax_compute_losses
from autolabel_tpu_torch import bridge, parallel
from autolabel_tpu_torch.models.field import Field, FieldConfig
from autolabel_tpu_torch.ops.encoders import HashGridConfig
from autolabel_tpu_torch.render.renderer import RenderOptions, render_rays
from autolabel_tpu_torch.train import __main__ as port_cli
from autolabel_tpu_torch.train import checkpoints
from autolabel_tpu_torch.train.losses import LossOptions, compute_losses
from autolabel_tpu_torch.train.trainer import SimpleTrainer
from autolabel_tpu_torch.utils import fixtures
from tests import test_torch_port_train as train_tests
from tests import torch_parallel_ranks as ranks
from tests.test_torch_port_render import _rays

RTOL, GRID_ATOL = 1e-4, 1e-5
N_RAYS = 64
# tests/test_parallel.py's TINY_GRID, and a wide-row grid for the sampled
# backward (F = 8, so that the simplex encode and the subsample run).
TINY = dict(n_levels=4, n_features=2, log2_hashmap_size=12,
            base_resolution=8, per_level_scale=1.5)
WIDE = dict(n_levels=4, n_features=8, log2_hashmap_size=10,
            base_resolution=8, per_level_scale=1.6)
HEADS = dict(encoding='hg+freq', hidden_dim=32, hidden_dim_color=32,
             hidden_dim_semantic=8, geo_feat_dim=7, semantic_classes=2,
             bound=1.0)
CASES = {
    # name: (grid, field overrides, render options, worlds)
    'tiny': (TINY, {}, dict(num_steps=8, perturb=True, stochastic_corners=0),
             (2, 4)),
    # 4 samples a ray: 256 points, so that the subsample's boundaries lie
    # beyond the scans' rounding bound n k 2^-24 (asserted).
    'sampled': (WIDE, dict(grid_interp='simplex', proposal=True),
                dict(num_steps=4, proposal_steps=16, perturb=True,
                     stochastic_corners=0, sampled_backward=2,
                     backward_points=0.25), (2, 4)),
    'uneven': (TINY, {}, dict(num_steps=8, perturb=False,
                              stochastic_corners=0), (2, 4)),
    'eval': (TINY, {}, dict(num_steps=8, perturb=False,
                            stochastic_corners=0), (4,)),
}


def _configs(name):
    grid, over, opts, _ = CASES[name]
    jax_field = JaxField(JaxFieldConfig(grid=JaxGridConfig(**grid),
                                        **HEADS, **over))
    port = FieldConfig(grid=HashGridConfig(**grid), **HEADS, **over)
    return jax_field, port, JaxRenderOptions(**opts), RenderOptions(**opts)


def _params(jax_field, seed=0):
    """JAX's init, the table drawn N(0, 0.5) so density is non-trivial."""
    params = jax.tree.map(np.asarray, jax_field.init(jax.random.PRNGKey(
        seed)))
    grid = params['encoder']['grid']
    params['encoder']['grid'] = np.random.default_rng(seed).normal(
        0.0, 0.5, grid.shape).astype(np.float32)
    return params


def _batch(name, seed=1):
    o, d, norms = _rays(N_RAYS, seed=seed)
    rng = np.random.default_rng(seed + 100)
    depth = rng.uniform(0.2, 1.5, N_RAYS).astype(np.float32)
    semantic = rng.integers(0, 2, N_RAYS).astype(np.int32)
    if name == 'uneven':
        # The first data shard's rays carry depth and labels; of the
        # second's, only every eighth.
        half = N_RAYS // 2
        depth[half:][np.arange(half) % 8 != 0] = 0.0
        semantic[half:][np.arange(half) % 8 != 0] = -1
    else:
        depth[::5] = 0.0
        semantic[::3] = -1
    return {'rays_o': o, 'rays_d': d, 'direction_norms': norms[:, 0],
            'pixels': rng.uniform(0, 1, (N_RAYS, 3)).astype(np.float32),
            'depth': depth, 'semantic': semantic}


def _jax_draws(key, opts, levels):
    """The uniforms JAX's render_rays draws from `key`, the encode's
    from k_enc (renderer.py)."""
    if not opts.perturb:
        return None
    _, k_coarse, k_fine, k_enc = jax.random.split(key, 4)
    first = opts.proposal_steps or opts.num_steps
    fine = opts.num_steps if opts.proposal_steps else opts.upsample_steps
    draws = {'u_coarse': np.asarray(jax.random.uniform(
        k_coarse, (N_RAYS, first)))}
    if fine:
        draws['u_fine'] = np.asarray(jax.random.uniform(k_fine,
                                                        (N_RAYS, fine)))
    if opts.sampled_backward:
        extra = int(opts.backward_points < 1.0)
        draws['u_enc'] = np.asarray(jax.random.uniform(
            k_enc, (levels, N_RAYS * opts.num_steps + extra)))
    return draws


def _jax_loss_fn(jax_field, opts, batch, key):
    def loss_fn(p, b):
        out = jax_render_rays(jax_field, p, b['rays_o'], b['rays_d'],
                              b['direction_norms'][:, None], key=key,
                              options=opts)
        loss, parts = jax_compute_losses(out, b, JaxLossOptions())
        return loss, parts
    return loss_fn


def _cotangent(rng, n, width):
    """Rows of spread magnitudes, a third zero (the render's empty space)."""
    g = rng.normal(size=(n, width)) * np.exp(rng.normal(size=(n, 1)))
    g[::3] = 0.0
    return g.astype(np.float32)


def _margin(s, u_sys, k):
    """How far every k cum_i - u_sys lies from an integer (cum from float64
    sums of the norms s), against n k 2^-24, within which fp32 scans in
    other orders may move it."""
    s = np.asarray(s, np.float64)
    v = k * np.cumsum(s) / s.sum() - u_sys
    return float(np.abs(v - np.round(v)).min()), len(s) * k * 2.0 ** -24


@pytest.fixture(scope='module')
def mesh_runs(tmp_path_factory):
    """The JAX references, and every case run on 2 and on 4 ranks."""
    work = str(tmp_path_factory.mktemp('mesh'))
    key = jax.random.PRNGKey(11)
    refs, steps = {}, []
    for name, (_, _, _, worlds) in CASES.items():
        jf, pc, jopts, popts = _configs(name)
        params = _params(jf)
        batch = _batch(name)
        loss_fn = _jax_loss_fn(jf, jopts, batch, key)
        (loss, parts), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
        refs[name] = dict(loss=float(loss), grads=grads, params=params,
                          batch=batch, parts={k: float(v)
                                              for k, v in parts.items()},
                          config=pc, options=popts, loss_fn=loss_fn)
        steps.append(dict(name=name, config=pc, options=popts, params=params,
                          batch=batch, worlds=worlds,
                          draws=_jax_draws(key, jopts, pc.grid.n_levels)))
    rng = np.random.default_rng(4)
    n, levels, k = 256, 4, 64
    select = dict(g=_cotangent(rng, n, levels * 8), u_sys=np.float32(
        rng.uniform()), k=k, levels=levels)
    with open(os.path.join(work, 'cases.pkl'), 'wb') as f:
        pickle.dump({'steps': steps, 'select': select}, f)
    out = {}
    for world in (2, 4):
        ranks.spawn(world, work, f'w{world}')
        out[world] = []
        for rank in range(world):
            with open(os.path.join(work, f'w{world}_rank{rank}.pkl'),
                      'rb') as f:
                out[world].append(pickle.load(f))
    return refs, select, out


@pytest.mark.parametrize('world', [2, 4])
@pytest.mark.parametrize('name', ['tiny', 'sampled'])
def test_mesh_step_matches_jax_one_device(mesh_runs, name, world):
    """DP 2 (2 ranks) and DP 2 x TP 2 (4 ranks): the loss parts within rtol
    1e-4 and the gathered table gradient within atol 1e-5 of JAX's
    one-device value_and_grad on the global batch; every other gradient
    as one device is held (test_torch_port_train._close_trees). The
    sampled case's subsample is the global batch's: its norms lie away
    from the boundaries, so one device and the mesh draw the same
    points."""
    refs, _, out = mesh_runs
    ref = refs[name]
    got = out[world][0]['steps'][name]
    if got['norms'] is not None:
        margin, bound = _margin(*got['norms'])
        assert margin > bound, (margin, bound)
    np.testing.assert_allclose(got['parts']['total'], ref['loss'], rtol=RTOL)
    for k, v in ref['parts'].items():
        np.testing.assert_allclose(got['parts'][k], v, rtol=RTOL, err_msg=k)
    grid = np.asarray(ref['grads']['encoder']['grid'])
    assert got['grads']['encoder']['grid'].shape == grid.shape
    np.testing.assert_allclose(got['grads']['encoder']['grid'], grid,
                               atol=GRID_ATOL, rtol=0)
    assert np.abs(grid).max() > 10 * GRID_ATOL  # not vacuous
    train_tests._close_trees(
        got['grads'], ref['grads'],
        leaf_atol=train_tests._proposal_atol(dict(proposal_steps=16))
        if name == 'sampled' else None)
    # every data rank reports the same global loss
    assert len({r['steps'][name]['parts']['total'] for r in out[world]}) == 1


def test_dp_tp_step_matches_jax_mesh_step(mesh_runs):
    """DP 2 x TP 2 against JAX's own 2 x 2 mesh step on the virtual CPU
    devices, built as tests/test_parallel.py builds it."""
    refs, _, out = mesh_runs
    ref = refs['eval']
    mesh = jax_make_mesh_2d(2, 2)
    params = ref['params']
    batch = {k: jnp.asarray(v) for k, v in ref['batch'].items()}
    grad_fn = jax.value_and_grad(lambda p, b: ref['loss_fn'](p, b)[0])
    pspecs = jax_tree_shardings(mesh, params,
                                params['encoder']['grid'].shape)
    bspecs = jax.tree.map(lambda _: jax_batch_sharding(mesh), batch)
    jit_tp = jax.jit(grad_fn, in_shardings=(pspecs, bspecs),
                     out_shardings=(NamedSharding(mesh, P()), pspecs))
    p_tp = jax.device_put(params, pspecs)
    assert {s.data.shape for s in p_tp['encoder']['grid'].addressable_shards
            } == {(4, 4096, 1)}
    loss, grads = jit_tp(p_tp, jax.device_put(batch, bspecs))
    got = out[4][0]['steps']['eval']
    np.testing.assert_allclose(got['parts']['total'], float(loss), rtol=RTOL)
    np.testing.assert_allclose(got['grads']['encoder']['grid'],
                               np.asarray(grads['encoder']['grid']),
                               atol=GRID_ATOL, rtol=0)


@pytest.mark.parametrize('world', [2, 4])
def test_uneven_masks_take_the_global_means(mesh_runs, world):
    """Depth and labels on every ray of the first data shard and on an
    eighth of the second's: the mesh's masked means divide by the global
    counts and match JAX's one device, where the mean of the two shards'
    own means (a per-rank mean) misses by more than ten times the
    tolerance."""
    refs, _, out = mesh_runs
    ref = refs['uneven']
    got = out[world][0]['steps']['uneven']
    for k, v in ref['parts'].items():
        np.testing.assert_allclose(got['parts'][k], v, rtol=RTOL, err_msg=k)
    field = bridge.load_params(Field(ref['config'], device='cpu'),
                               ref['params'])
    per_rank = []
    with torch.no_grad():
        for half in np.split(np.arange(N_RAYS), 2):
            b = train_tests._torch_batch({k: v[half] for k, v in
                                          ref['batch'].items()})
            rendered = render_rays(field, b['rays_o'], b['rays_d'],
                                   b['direction_norms'],
                                   options=ref['options'])
            per_rank.append(compute_losses(rendered, b, LossOptions())[1])
    for k in ('depth', 'semantic'):
        naive = np.mean([float(p[k]) for p in per_rank])
        assert abs(naive - ref['parts'][k]) > 10 * RTOL * abs(
            ref['parts'][k]), (k, naive, ref['parts'][k])


@pytest.mark.parametrize('world', [2, 4])
def test_global_subsample_matches_jax(mesh_runs, world):
    """Each rank draws from the global batch's norms (its rows' squared
    norms summed over 'model', gathered over 'data') with the one u_sys:
    the data ranks' draws together are JAX's top_k selection as a set,
    coefs within rtol 1e-5, and the model ranks of a data index agree."""
    _, select, out = mesh_runs
    g, u_sys, k = select['g'], float(select['u_sys']), select['k']
    s = np.sqrt((g.astype(np.float64) ** 2).sum(-1))
    margin, bound = _margin(s, u_sys, k)
    assert margin > bound, (margin, bound)
    ref_sel, ref_coef = jax_encoders._select_backward_points(
        jnp.asarray(g), u_sys, k)
    ref_sel, ref_coef = np.asarray(ref_sel), np.asarray(ref_coef)
    live = ref_coef > 0
    order = np.argsort(ref_sel[live])
    by_model = {}
    for r in out[world]:
        sel, coef, j = r['select']
        by_model.setdefault(j, []).append((sel, coef))
    views = []
    for j, parts in sorted(by_model.items()):
        sel = np.concatenate([p[0] for p in parts])
        coef = np.concatenate([p[1] for p in parts])
        np.testing.assert_array_equal(sel, ref_sel[live][order])
        np.testing.assert_allclose(coef, ref_coef[live][order], rtol=1e-5)
        views.append((sel, coef))
    for sel, coef in views[1:]:
        assert np.array_equal(sel, views[0][0])
        assert np.array_equal(coef, views[0][1])
    assert len(views[0][0]) < k  # some points drawn more than once


@pytest.mark.parametrize('world', [2, 4])
def test_gather_backward_takes_the_slice_unscaled(mesh_runs, world):
    for r in mesh_runs[2][world]:
        assert r['gather'] == (True, True)


@pytest.mark.parametrize('world', [2, 4])
def test_ranks_import_neither_jax_nor_the_jax_package(mesh_runs, world):
    for r in mesh_runs[2][world]:
        assert 'autolabel_tpu_torch' in r['modules']
        assert not {'jax', 'autolabel_tpu'} & set(r['modules'])


@pytest.mark.parametrize('world', [2, 4])
def test_nonfinite_slice_skips_every_rank(mesh_runs, world):
    """A NaN in the last rank's table slice: no rank applies the update or
    moves a parameter; the next, finite, step moves every rank."""
    for r in mesh_runs[2][world]:
        assert r['nonfinite'] == (False, True, True, True)


# -- a world of one, in this process ------------------------------------------

@pytest.fixture
def world_of_one():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize('make', ['make_mesh', 'make_mesh_2d'])
@pytest.mark.parametrize('name', ['tiny', 'sampled'])
def test_world_of_one_is_bit_equal_to_no_mesh(world_of_one, name, make):
    """make_mesh(1) or make_mesh_2d(1, 1) in this process alone: 3 steps of
    train_step (the trainer's own draws), every loss part and parameter
    bit-equal to the trainer without a mesh."""
    jf, pc, _, popts = _configs(name)
    params = _params(jf)

    def run(mesh):
        field = bridge.load_params(Field(pc, device='cpu'), params)
        trainer = SimpleTrainer('t', field, iters=1000, render_options=popts,
                                mesh=mesh, metrics=False, seed=3)
        parts = [trainer.train_step(_batch(name, seed=s)) for s in range(3)]
        return parts, field.state_dict()

    mesh = (parallel.make_mesh(1, device='cpu') if make == 'make_mesh'
            else parallel.make_mesh_2d(1, 1, device='cpu'))
    want, want_state = run(None)
    got, got_state = run(mesh)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for k in want_state:
        assert torch.equal(got_state[k], want_state[k]), k


def test_mesh_refuses_an_uneven_global_batch(world_of_one):
    """A global batch that the data ranks do not divide raises, as JAX's
    sharding does (here on a 1-rank mesh's sharding of 2 parts)."""
    with pytest.raises(ValueError):
        parallel.Sharding(0, 0, 2).take(np.zeros((5, 3)))
    mesh = parallel.make_mesh(1, device='cpu')
    assert parallel.batch_sharding(mesh).bounds(5) == (0, 5)
    assert parallel.grid_sharding(mesh).parts == 1
    tree = {'encoder': {'grid': np.zeros((4, 8, 6))}, 'sigma_net': [
        np.zeros((4, 8, 6))]}
    assert parallel.tree_shardings(mesh, tree, (4, 8, 6))['encoder'][
        'grid'] == parallel.replicated(mesh)


# -- the train CLI on a mesh ---------------------------------------------------

CLI = ['--batch-size', '512', '--num-steps', '16', '--factor-train', '1',
       '--proposal', '--save-optimizer']


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('scenes') / 'sphere')
    fixtures.make_synthetic_scene(path, n_frames=12, width=48, height=36)
    return path


def _metrics(model_dir):
    with open(os.path.join(model_dir, 'metrics.jsonl')) as f:
        return [json.loads(line) for line in f]


def test_cli_mesh_dp2_tp2_trains_checkpoints_and_resumes(scene, tmp_path):
    """--mesh-devices 4 --mesh-model 2 on 4 spawned ranks: the first step's
    loss parts (metrics.jsonl after one iteration) within rtol 1e-5 of the
    one-device CLI's on the same seeded batches; the checkpoint holds the
    table, its EMA and its Adam moments whole (L, T, F); a second run
    resumes it under the mesh at the global step and trains on."""
    one = port_cli.main([scene, '--iters', '1', '--workspace',
                         str(tmp_path / 'one')] + CLI, device='cpu', seed=7)
    argv = [scene, '--workspace', str(tmp_path / 'mesh'), '--mesh-devices',
            '4', '--mesh-model', '2'] + CLI
    first = port_cli.main(argv + ['--iters', '1'], device='cpu', seed=7)
    assert first.trainer is None and first.train_s > 0
    (want,), (got,) = _metrics(one.model_dir), _metrics(first.model_dir)
    assert got.keys() == want.keys() and got['step'] == 1
    for k, v in want.items():
        if k not in ('epoch', 'step', 'wall_s'):
            np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
    shape = one.trainer.field.encoder['grid'].shape
    resumed = port_cli.main(argv + ['--iters', '19'], device='cpu', seed=8)
    payload = checkpoints.load_checkpoint(os.path.join(resumed.model_dir,
                                                       'checkpoints'))
    assert payload['global_step'] == 20 and payload['epoch'] == 2
    for tree in (payload['model'], payload['ema']):
        assert np.shape(tree['encoder']['grid']) == tuple(shape)
        assert np.isfinite(tree['encoder']['grid']).all()
    for key in ('mu', 'nu'):
        assert np.shape(payload['optimizer'][key]['encoder.grid']) == \
            tuple(shape)
    assert int(payload['optimizer']['count']) == 20
    assert [m['step'] for m in _metrics(resumed.model_dir)] == [1, 20]
    assert sorted(os.listdir(os.path.join(resumed.model_dir,
                                          'checkpoints'))) == [
        'ngp_ep0001.pth', 'ngp_ep0002.pth']
    # the two legs' checkpoints: the resumed table moved on from the first
    first_ckpt = checkpoints.load_checkpoint_file(os.path.join(
        resumed.model_dir, 'checkpoints', 'ngp_ep0001.pth'))
    assert not np.array_equal(first_ckpt['model']['encoder']['grid'],
                              payload['model']['encoder']['grid'])


# -- K5 split at its norms: the chain the card's global subsample follows -----

@pytest.mark.parametrize('n', [1, 1023, 3 * 1024 + 17])
def test_split_chain_selection_holds_against_float64_and_plain(monkeypatch,
                                                                n):
    """The subsample of a TP 2 mesh as K5's split runs it, on the CPU: each
    model rank's squared norms in K5's order (select_chain_norms without
    the root) over its feature slice of every level, summed in rank order,
    the root, then K5's scan (select_chain_scan) and compaction from those
    norms; check_selection, started from them, holds it to every condition
    it holds K5 to (float64 and the plain subsample included)."""
    from autolabel_tpu_torch.ops import hashgrid_cuda
    from tests import test_torch_port_sampled as sampled_tests
    levels, dim = 4, 512
    g = sampled_tests._chain_cotangent(n, dim)
    slices = g.reshape(n, levels, 2, dim // (2 * levels))
    parts = [hashgrid_cuda.select_chain_norms(
        slices[:, :, j].reshape(n, -1).contiguous(), root=False)
        for j in range(2)]
    s = np.sqrt(parts[0] + parts[1]).astype(np.float32)
    assert s.dtype == np.float32
    monkeypatch.setattr(hashgrid_cuda, 'select_chain',
                        lambda _: (s, *hashgrid_cuda.select_chain_scan(s)))
    views, _, _, sel, coef, count, k, u_sys = sampled_tests._chain_draws(
        g, n + dim)
    check = hashgrid_cuda.check_selection(g, u_sys, k, sel, coef, count,
                                          views, norms=s)
    failures = hashgrid_cuda.selection_failures(check, n, k, dim)
    assert not failures, (failures, check)
    assert check['compared'] == int(count[0]) > 0
    # the whole rows' chain: the same norms within its rounding bound
    whole = hashgrid_cuda.select_chain_norms(g)
    norm, _ = hashgrid_cuda._select_roundings(n, dim)
    assert np.all(np.abs(whole.astype(np.float64) - s) <= 2 * norm
                  * 2.0 ** -24 * np.maximum(whole, 2.0 ** -50))
