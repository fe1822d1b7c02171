"""Joint pose refinement and the interactive trainer on the port's device
meshes (autolabel_tpu_torch/parallel), on the CPU.

The ranks are spawned processes on gloo with a file rendezvous
(tests/torch_parallel_ranks.py, which imports neither jax nor
autolabel_tpu): 2 ranks (DP 2) and 4 ranks (DP 2 x TP 2, the table sharded
on its feature axis), on tests/test_torch_port_parallel.py's small fields:
TINY (exact trilinear, F = 2) and WIDE (F = 8 simplex with the proposal, so
TP 2 gives each rank F = 4). This process computes the JAX references and
hands the ranks the same numpy params, deltas, (R0, t0), batches and draws.

Under 'model' each rank's encode gives the points only its feature slice's
part of their gradient, and the pose gradient flows through that: the
field sums the parts over the model group (parallel.sum_grad_over_model),
and the deltas' gradient sums over 'data' in rank order, so the deltas
never part across ranks.

- DP 2 and DP 2 x TP 2 with pose_refine: step 1's loss parts within rtol
  1e-4, the table gradient within atol 1e-5, the pose gradient within 1e-4
  by relative norm of JAX's one-device value_and_grad on the same params,
  batch and (R0, t0); DP 2 x TP 2 once against JAX's own 2 x 2 mesh step.
- The pose gradient of every step and the deltas after 3 steps (under the
  level windows) are bit-equal across every rank.
- A world of one with pose_refine is bit-equal to no mesh over 3 steps.
- sum_grad_over_model counts the slices' parts once and a part every rank
  computes whole (the frequency encode's) once; the field's point gradient
  on a sharded table is the whole field's; a step without pose refinement
  applies it nowhere, and so calls the collectives it called before.
- InteractiveTrainer on DP 2 and DP 2 x TP 2: 3 steps' loss parts within
  rtol 1e-4 of JAX's InteractiveTrainer on one device (EMA_EVERY 2 on both).
- The train CLI with --mesh-devices 4 --mesh-model 2
  --pose-refine-experimental: step 1's loss parts within rtol 1e-5 of the
  one-device CLI's on the same seeded batches, and a poses_refined.npz of
  the one-device run's frames and shapes.
"""
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
from autolabel_tpu.ops.encoders import HashGridConfig as JaxGridConfig
from autolabel_tpu.parallel import batch_sharding as jax_batch_sharding
from autolabel_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from autolabel_tpu.parallel import tree_shardings as jax_tree_shardings
from autolabel_tpu.render.renderer import RenderOptions as JaxRenderOptions
from autolabel_tpu.render.renderer import render_rays as jax_render_rays
from autolabel_tpu.train import pose_refine as jax_pose_refine
from autolabel_tpu.train.losses import LossOptions as JaxLossOptions
from autolabel_tpu.train.losses import compute_losses as jax_compute_losses
from autolabel_tpu.train.trainer import \
    InteractiveTrainer as JaxInteractiveTrainer
from autolabel_tpu_torch import parallel
from autolabel_tpu_torch.models.field import FieldConfig
from autolabel_tpu_torch.ops.encoders import HashGridConfig
from autolabel_tpu_torch.render.renderer import RenderOptions
from autolabel_tpu_torch.train import __main__ as port_cli
from autolabel_tpu_torch.utils import fixtures
from tests import test_torch_port_train as train_tests
from tests import torch_parallel_ranks as ranks
from tests.test_torch_port_parallel import (CLI, GRID_ATOL, HEADS, N_RAYS,
                                            RTOL, TINY, WIDE, _jax_draws,
                                            _metrics, _params)
from tests.test_torch_port_pose_refine import _pose_batch, _pose_init

POSE_RTOL = 1e-4  # the pose gradient, by relative norm
N_FRAMES = 4
CASES = {
    # name: (grid, field overrides, render options); pose refinement turns
    # the estimators off, as the trainer does
    'tiny': (TINY, {}, dict(num_steps=8, perturb=True, stochastic_corners=0)),
    'wide': (WIDE, dict(grid_interp='simplex', proposal=True),
             dict(num_steps=4, proposal_steps=16, perturb=True,
                  stochastic_corners=0, sampled_backward=0)),
}


def _configs(name):
    grid, over, opts = CASES[name]
    jax_field = JaxField(JaxFieldConfig(grid=JaxGridConfig(**grid),
                                        **HEADS, **over))
    port = FieldConfig(grid=HashGridConfig(**grid), **HEADS, **over)
    return jax_field, port, JaxRenderOptions(**opts), RenderOptions(**opts)


def _batch(seed):
    """_pose_batch's rays of N_FRAMES frames, labelled with HEADS' two
    classes (-1: unlabelled)."""
    rng = np.random.default_rng(seed)
    batch = _pose_batch(rng, N_FRAMES, N_RAYS)
    batch['semantic'] = rng.integers(-1, 2, N_RAYS).astype(np.int32)
    return batch


def _jax_pose_loss(jax_field, opts, key, pose_init):
    def loss_fn(p, b):
        o, d = jax_pose_refine.refined_rays(p['pose'], pose_init,
                                            b['frame_idx'], b['rays_d_cam'])
        out = jax_render_rays(jax_field, p, o, d,
                              b['direction_norms'][:, None], key=key,
                              options=opts)
        return jax_compute_losses(out, b, JaxLossOptions())
    return loss_fn


def _interactive_case():
    """JAX's InteractiveTrainer on one device, EMA_EVERY 2, three steps from
    the tiny case's params; and what the ranks need to take them."""
    jf, pc, jopts, popts = _configs('tiny')
    params = _params(jf)
    batches = [{k: v for k, v in _batch(30 + i).items()
                if k not in ('frame_idx', 'rays_d_cam')} for i in range(3)]
    jt = JaxInteractiveTrainer('t', jf, render_options=jopts, metrics=False)
    jt.EMA_EVERY = 2
    p = jax.tree.map(jnp.asarray, params)
    jt.state = dict(jt.state, params=p, ema=jax.tree.map(jnp.copy, p),
                    opt_state=jt.tx.init(p))
    jt.init(iter(batches))
    draws, parts = [], []
    for step in range(3):
        step_key = jax.random.fold_in(jax.random.PRNGKey(1), step)
        draws.append(_jax_draws(step_key, jopts, pc.grid.n_levels))
        parts.append({k: float(v) for k, v in jt.take_step().items()})
    return parts, dict(config=pc, options=popts, params=params,
                       batches=batches, draws=draws)


@pytest.fixture(scope='module')
def pose_runs(tmp_path_factory):
    """The JAX references, and every case run on 2 and on 4 ranks."""
    work = str(tmp_path_factory.mktemp('pose_mesh'))
    key = jax.random.PRNGKey(11)
    refs, cases = {}, []
    for i, name in enumerate(CASES):
        jf, pc, jopts, popts = _configs(name)
        params = _params(jf)
        rng = np.random.default_rng(40 + i)
        R0, t0 = _pose_init(rng, N_FRAMES)
        pose = {k: (rng.normal(size=(N_FRAMES, 3)) * 0.01).astype(np.float32)
                for k in ('rot', 't')}
        batch = _batch(60 + i)
        loss_fn = _jax_pose_loss(jf, jopts, key, (jnp.asarray(R0),
                                                  jnp.asarray(t0)))
        jparams = dict(params, pose=pose)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, parts), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            jax.tree.map(jnp.asarray, jparams), jbatch)
        refs[name] = dict(loss=float(loss), grads=grads, params=jparams,
                          batch=jbatch, loss_fn=loss_fn,
                          parts={k: float(v) for k, v in parts.items()})
        cases.append(dict(
            name=name, config=pc, options=popts, params=params,
            pose_init=(R0, t0), pose=pose, batch=batch,
            draws=_jax_draws(key, jopts, pc.grid.n_levels),
            batches=[_batch(50 + s) for s in range(3)]))
    interactive_ref, interactive = _interactive_case()
    with open(os.path.join(work, 'pose_cases.pkl'), 'wb') as f:
        pickle.dump({'pose': cases, 'interactive': interactive}, f)
    out = {}
    for world in (2, 4):
        ranks.spawn(world, work, f'w{world}', pose=True)
        out[world] = []
        for rank in range(world):
            with open(os.path.join(work, f'w{world}_rank{rank}.pkl'),
                      'rb') as f:
                out[world].append(pickle.load(f))
    return refs, cases, interactive_ref, out


def _rel_norm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.mark.parametrize('world', [2, 4])
@pytest.mark.parametrize('name', ['tiny', 'wide'])
def test_pose_step_matches_jax_one_device(pose_runs, name, world):
    """DP 2 and DP 2 x TP 2 with pose refinement, every level open: step
    1's loss parts within rtol 1e-4, the gathered table gradient within
    atol 1e-5 and the pose gradient within 1e-4 by relative norm of JAX's
    one-device value_and_grad; the heads' gradients as one device is held
    (test_torch_port_train._close_trees); every rank the same loss."""
    refs, _, _, out = pose_runs
    ref = refs[name]
    got = out[world][0]['pose'][name]
    np.testing.assert_allclose(got['parts']['total'], ref['loss'], rtol=RTOL)
    for k, v in ref['parts'].items():
        np.testing.assert_allclose(got['parts'][k], v, rtol=RTOL, err_msg=k)
    grid = np.asarray(ref['grads']['encoder']['grid'])
    np.testing.assert_allclose(got['grads']['encoder']['grid'], grid,
                               atol=GRID_ATOL, rtol=0)
    assert np.abs(grid).max() > 10 * GRID_ATOL  # not vacuous
    for k in ('rot', 't'):
        want = np.asarray(ref['grads']['pose'][k])
        assert np.abs(want[1:]).max() > 0 and not want[0].any(), k
        assert _rel_norm(got['grads']['pose'][k], want) <= POSE_RTOL, k
    heads = {k: v for k, v in got['grads'].items() if k != 'pose'}
    train_tests._close_trees(
        heads, {k: v for k, v in ref['grads'].items() if k != 'pose'},
        leaf_atol=train_tests._proposal_atol(dict(proposal_steps=16))
        if name == 'wide' else None)
    assert len({r['pose'][name]['parts']['total'] for r in out[world]}) == 1


def test_dp_tp_pose_step_matches_jax_mesh_step(pose_runs):
    """DP 2 x TP 2 with pose refinement against JAX's own 2 x 2 mesh step
    on the virtual CPU devices: the deltas replicated (tree_shardings), the
    batch, frame_idx and rays_d_cam included, sharded over 'data'."""
    refs, _, _, out = pose_runs
    ref = refs['tiny']
    mesh = jax_make_mesh_2d(2, 2)
    params = jax.tree.map(jnp.asarray, ref['params'])
    grad_fn = jax.value_and_grad(lambda p, b: ref['loss_fn'](p, b)[0])
    pspecs = jax_tree_shardings(mesh, params,
                                params['encoder']['grid'].shape)
    bspecs = jax.tree.map(lambda _: jax_batch_sharding(mesh), ref['batch'])
    jit_tp = jax.jit(grad_fn, in_shardings=(pspecs, bspecs),
                     out_shardings=(NamedSharding(mesh, P()), pspecs))
    p_tp = jax.device_put(params, pspecs)
    assert {s.data.shape for s in p_tp['pose']['rot'].addressable_shards
            } == {(N_FRAMES, 3)}
    loss, grads = jit_tp(p_tp, jax.device_put(ref['batch'], bspecs))
    got = out[4][0]['pose']['tiny']
    np.testing.assert_allclose(got['parts']['total'], float(loss), rtol=RTOL)
    np.testing.assert_allclose(got['grads']['encoder']['grid'],
                               np.asarray(grads['encoder']['grid']),
                               atol=GRID_ATOL, rtol=0)
    for k in ('rot', 't'):
        assert _rel_norm(got['grads']['pose'][k],
                         np.asarray(grads['pose'][k])) <= POSE_RTOL, k


@pytest.mark.parametrize('world', [2, 4])
def test_pose_deltas_bit_equal_across_ranks(pose_runs, world):
    """Three steps under the level windows (iters 10: the pose warmup is
    one update, so the deltas move from the second step): every step's
    reduced pose gradient, the deltas after them and the losses bit-equal
    on every rank; the deltas moved, and the table's slices on the ranks
    of one data index make one whole table."""
    for name in CASES:
        runs = [r['pose'][name]['steps'] for r in pose_runs[3][world]]
        first = runs[0]
        for run in runs[1:]:
            for a, b in zip(run['pose_grads'], first['pose_grads']):
                for k in a:
                    assert a[k].tobytes() == b[k].tobytes(), (name, k)
            for k in first['pose']:
                assert run['pose'][k].tobytes() == first['pose'][k].tobytes()
            assert run['table'].tobytes() == first['table'].tobytes()
            for a, b in zip(run['parts'], first['parts']):
                assert {k: v.tobytes() for k, v in a.items()} == \
                    {k: v.tobytes() for k, v in b.items()}
        start = pose_runs[1][list(CASES).index(name)]['pose']
        assert all(np.abs(first['pose'][k] - start[k]).max() > 0
                   for k in start), name
        assert all(np.abs(g['pose.t'][1:]).max() > 0
                   for g in first['pose_grads'])


@pytest.mark.parametrize('world', [2, 4])
def test_pose_checkpoint_resumes_on_the_mesh(pose_runs, world):
    """A checkpoint written by rank 0 after 3 pose steps on the mesh: a
    trainer with pose refinement resumes the deltas, their EMA and Adam
    moments and the rank's table slice bit for bit; one without resumes
    the field across the toggle with the moments restarted."""
    for r in pose_runs[3][world]:
        got = r['resume']
        assert got['moved'] and got['pose'] and got['table'] and got['toggle']
        assert got['steps'] == (3, 3)


@pytest.fixture
def world_of_one():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize('make', ['make_mesh', 'make_mesh_2d'])
def test_world_of_one_with_pose_is_bit_equal_to_no_mesh(world_of_one,
                                                        pose_runs, make):
    """make_mesh(1) or make_mesh_2d(1, 1) in this process alone, with pose
    refinement: 3 steps' losses and pose gradients, the deltas and the
    table after them bit-equal to the trainer without a mesh."""
    case = pose_runs[1][1]  # wide: the simplex field with the proposal
    torch.set_num_threads(1)
    want = ranks.pose_run(ranks.pose_trainer(case, None, 10), case['batches'])
    mesh = (parallel.make_mesh(1, device='cpu') if make == 'make_mesh'
            else parallel.make_mesh_2d(1, 1, device='cpu'))
    got = ranks.pose_run(ranks.pose_trainer(case, mesh, 10), case['batches'])
    for a, b in zip(got['parts'] + got['pose_grads'],
                    want['parts'] + want['pose_grads']):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), k
    for k in want['pose']:
        assert got['pose'][k].tobytes() == want['pose'][k].tobytes(), k
    assert got['table'].tobytes() == want['table'].tobytes()


@pytest.mark.parametrize('world', [2, 4])
def test_sum_grad_over_model_counts_each_part_once(pose_runs, world):
    """A loss of a part every rank computes whole (x^2, as the frequency
    encode is) and model index j's slice part ((j + 1) x): x's gradient is
    2 x + m (m + 1) / 2 on every rank, the same bits across the model
    group; summing the whole part too would give 2 m x."""
    m = 2 if world == 4 else 1
    grads = {}
    for r in pose_runs[3][world]:
        x, g = r['sum_once']
        np.testing.assert_allclose(g, 2 * x + m * (m + 1) / 2, rtol=1e-6,
                                   atol=1e-6)
        assert not np.allclose(g, 2 * m * x + m * (m + 1) / 2) or m == 1
        grads.setdefault(r['model_index'], g)
        assert g.tobytes() == grads[r['model_index']].tobytes()
    assert len(grads) == m


@pytest.mark.parametrize('world', [2, 4])
def test_field_point_gradient_on_a_sharded_table(pose_runs, world):
    """The wide field (hg+freq) with its table on the mesh: the density's
    gradient for its points within fp32 summation order of the whole
    field's, the frequency encode's part counted once."""
    for r in pose_runs[3][world]:
        got, want = r['point_grad']
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
        assert np.abs(want).max() > 0


@pytest.mark.parametrize('world', [2, 4])
def test_step_without_pose_gains_no_collective(pose_runs, world):
    """A step without pose refinement never applies sum_grad_over_model
    (its points carry no gradient), so it calls the collectives it called
    before; with pose refinement the step calls one gather more for each
    sharded encode's point gradient, and one for the deltas' ordered sum
    over 'data'."""
    for r in pose_runs[3][world]:
        calls = r['collectives']
        assert calls['plain']['applied'] == 0
        assert calls['pose']['applied'] == (world == 4)
        assert calls['pose']['collectives'] == (
            calls['plain']['collectives'] + calls['pose']['applied'] + 1)


@pytest.mark.parametrize('world', [2, 4])
def test_interactive_trainer_on_a_mesh_matches_jax(pose_runs, world):
    """InteractiveTrainer on DP 2 and DP 2 x TP 2, the ranks in lockstep
    over one loader, fed JAX's draws: 3 steps' loss parts within rtol 1e-4
    of JAX's InteractiveTrainer on one device; with EMA_EVERY 2 the EMA
    ticks at the second step alone; every rank the same losses."""
    ref = pose_runs[2]
    runs = [r['interactive'] for r in pose_runs[3][world]]
    for got, want in zip(runs[0]['parts'], ref):
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=RTOL, err_msg=k)
    for run in runs:
        assert run['parts'] == runs[0]['parts']
        assert run['ticks'] == [False, True, False]
        assert (run['step'], run['global_step']) == (3, 3)


# -- the train CLI on a mesh ---------------------------------------------------

@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('scenes') / 'sphere')
    fixtures.make_synthetic_scene(path, n_frames=12, width=48, height=36)
    return path


def test_cli_mesh_pose_refine_matches_one_device(scene, tmp_path):
    """--mesh-devices 4 --mesh-model 2 --pose-refine-experimental on 4
    spawned ranks: step 1's loss parts within rtol 1e-5 of the one-device
    CLI's on the same seeded batches; rank 0 alone writes
    poses_refined.npz, with the one-device run's frames and shapes."""
    argv = [scene, '--iters', '1', '--pose-refine-experimental'] + CLI
    one = port_cli.main(argv + ['--workspace', str(tmp_path / 'one')],
                        device='cpu', seed=7)
    mesh = port_cli.main(argv + ['--workspace', str(tmp_path / 'mesh'),
                                 '--mesh-devices', '4', '--mesh-model', '2'],
                         device='cpu', seed=7)
    assert mesh.trainer is None
    (want,), (got,) = _metrics(one.model_dir), _metrics(mesh.model_dir)
    assert got.keys() == want.keys() and got['step'] == 1
    for k, v in want.items():
        if k not in ('epoch', 'step', 'wall_s'):
            np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
    assert mesh.poses_refined == os.path.join(mesh.model_dir,
                                              'poses_refined.npz')
    ours, ref = np.load(mesh.poses_refined), np.load(one.poses_refined)
    assert sorted(ours.files) == sorted(ref.files) == ['R', 'frames', 't']
    np.testing.assert_array_equal(ours['frames'], ref['frames'])
    for k in ('R', 't'):
        assert ours[k].shape == ref[k].shape
        np.testing.assert_allclose(ours[k], ref[k], atol=1e-6)
