"""The port's GUI backend (backend.TrainingLoop, InteractiveTrainer,
gui.BackendClient) against autolabel_tpu/backend.py, on the CPU.

Both packages' TrainingLoops run on copies of the port's sphere fixture
(12 frames of 48 x 36 at dataset factor 1) with the GUI's flags (batch
512) and TPU_GRID shrunk to 2 levels x 8 features x 2^10 rows in both
packages, so the flagship step (simplex, sampled backward 2, a quarter of
the points) runs at a small size; JAX keeps grid_impl 'xla'. The JAX
loop's params (its table drawn from N(0, 0.5), so density is not trivial)
are carried into the port by bridge, and each port step is fed the
uniforms JAX's step draws from its key. Tolerances: _fetch_frame and the
payload assembly bit-equal; loss parts within rtol 1e-3 (as the trainer
tests: Adam moves a parameter by about 2 lr where a gradient's sign is
decided by rounding); the preview by the render limits (rgb within one
uint8 step and its mean within 5e-3, depth's mean and 99.9th percentile
within 5e-3 and 5e-2 of its largest value), classes equal but where the
top two logits lie within 1e-3 of the largest logit.
"""
import collections
import dataclasses
import importlib
import multiprocessing
import os
import pickle
import shutil
import sys
import time

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autolabel_tpu import backend as jax_backend
from autolabel_tpu.ops import encoders as jax_encoders
from autolabel_tpu.train import trainer as jax_trainer
from autolabel_tpu_torch import backend, bridge, gui, model_utils
from autolabel_tpu_torch.ops import encoders
from autolabel_tpu_torch.render import baked
from autolabel_tpu_torch.train.trainer import InteractiveTrainer
from autolabel_tpu_torch.utils import fixtures
from autolabel_tpu_torch.utils.images import resize_nearest_pil, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_GRID = dict(n_levels=2, n_features=8, log2_hashmap_size=10,
                  base_resolution=8, per_level_scale=1.6)
BATCH = 512
FACTOR = 2.0  # 24 x 18 frames
EMA_EVERY = 2
BAKE_RESOLUTION = 32  # the backend bakes at 128; 32 keeps the sweep small


@pytest.fixture(autouse=True)
def _one_thread():
    """torch's default pool slows these CPU steps many times over under
    the suite's parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _small_grid(mp):
    mp.setattr(jax_encoders, 'TPU_GRID',
               jax_encoders.HashGridConfig(**SMALL_GRID))
    mp.setattr(model_utils, 'TPU_GRID', encoders.HashGridConfig(**SMALL_GRID))


def _scene(path):
    return fixtures.make_synthetic_scene(str(path), n_frames=12, width=48,
                                         height=36)


def _flags(scene, *extra):
    return gui.read_args([scene, '--batch-size', str(BATCH), *extra])


def _numpy(tree):
    # copies: JAX donates its buffers, and the port's arrays are views of
    # tensors that train in place
    return jax.tree.map(np.array, tree)


def _jax_step_draws(step, n_rays, options, levels):
    """The uniforms JAX's interactive step number `step` draws from
    fold_in(PRNGKey(seed + 1), step) (trainer.py:_make_step, renderer.py:
    212), as the port's render takes them."""
    key = jax.random.fold_in(jax.random.PRNGKey(1), step)
    _, k_coarse, k_fine, k_enc = jax.random.split(key, 4)
    first = options.proposal_steps or options.num_steps
    draws = {'u_coarse': jax.random.uniform(k_coarse, (n_rays, first))}
    if options.proposal_steps:
        draws['u_fine'] = jax.random.uniform(k_fine,
                                             (n_rays, options.num_steps))
    if options.sampled_backward:
        draws['u_enc'] = jax.random.uniform(k_enc, encoders.uniform_shape(
            levels, n_rays * options.num_steps,
            sampled_backward=options.sampled_backward,
            backward_points=options.backward_points))
    return {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}


def _step_both(jl, pl):
    """One take_step of each loop on its next batch; the port's with JAX's
    draws. Returns both loss dicts as floats."""
    step = int(jl.trainer.state['step'])
    draws = _jax_step_draws(step, BATCH, pl.trainer.render_options,
                            SMALL_GRID['n_levels'])
    ref = {k: float(v) for k, v in jl.trainer.take_step().items()}
    ours = {k: float(v) for k, v in pl.trainer.take_step(draws).items()}
    return ours, ref


def _request(loop, conn, *messages):
    for message in messages:
        conn.send(message)
    loop._check_messages()
    replies = []
    while conn.poll(0.05):
        replies.append(conn.recv())
    return replies


def _small_baker(module):
    class SmallBaker(module.IncrementalBaker):
        def __init__(self, field, resolution=128, **kwargs):
            super().__init__(field, resolution=BAKE_RESOLUTION, **kwargs)
    return SmallBaker


class _RecordingBaker:
    """A stand-in for JAX's IncrementalBaker after its first bake: it only
    turns the slab rotation (JAX's own bake compiles three XLA programs,
    about 18 s on the CPU)."""

    n_blocks = 16

    def __init__(self):
        self._next_block = 0

    def update_next_block(self, params):
        self._next_block = (self._next_block + 1) % self.n_blocks


@pytest.fixture(scope='module')
def loops(tmp_path_factory):
    """Both packages' TrainingLoops on copies of one scene, driven through
    the same sequence; returns what each step, message and checkpoint
    gave, for the tests below to hold."""
    root = tmp_path_factory.mktemp('backend')
    jscene = _scene(root / 'jax')
    pscene = str(root / 'port')
    shutil.copytree(jscene, pscene)
    out = {'jscene': jscene, 'pscene': pscene}
    with pytest.MonkeyPatch.context() as mp:
        _small_grid(mp)
        mp.setattr(jax_trainer.InteractiveTrainer, 'EMA_EVERY', EMA_EVERY)
        mp.setattr(InteractiveTrainer, 'EMA_EVERY', EMA_EVERY)
        mp.setattr(baked, 'IncrementalBaker', _small_baker(baked))
        jparent, jchild = multiprocessing.Pipe()
        pparent, pchild = multiprocessing.Pipe()
        jl = jax_backend.TrainingLoop(jscene, _flags(jscene), jchild,
                                      dataset_factor=FACTOR)
        pl = backend.TrainingLoop(pscene, _flags(pscene), pchild,
                                  dataset_factor=FACTOR, device='cpu')
        params = _numpy(jl.trainer.state['params'])
        grid = params['encoder']['grid']
        params['encoder']['grid'] = np.random.default_rng(0).normal(
            0.0, 0.5, grid.shape).astype(np.float32)
        jl.trainer.state = dict(
            jl.trainer.state, params=jax.tree.map(jnp.asarray, params),
            ema=jax.tree.map(jnp.asarray, params))
        bridge.load_params(pl.field, params)
        pl.trainer.ema = bridge.params_from_numpy(params, 'cpu')
        batches = [jl.train_dataset._next_train() for _ in range(6)]

        # Steps: one, then init (the local step back to 0) and two more:
        # global step 2 is a multiple of EMA_EVERY, local step 1 is not.
        losses, ema_before = [], {}
        for loop in (jl, pl):
            loop.trainer.init(iter(batches[:1]))
        losses.append(_step_both(jl, pl))
        for loop in (jl, pl):
            loop.trainer.init(iter(batches[1:]))
        ema_before['jax'] = _numpy(jl.trainer.state['ema'])
        ema_before['port'] = _numpy(bridge.state_to_numpy(pl.trainer.ema))
        losses.append(_step_both(jl, pl))
        out['ema_after_local_1'] = {
            'jax': _numpy(jl.trainer.state['ema']),
            'port': _numpy(bridge.state_to_numpy(pl.trainer.ema))}
        losses.append(_step_both(jl, pl))
        out.update(losses=losses, ema_before=ema_before, ema_after={
            'jax': _numpy(jl.trainer.state['ema']),
            'port': _numpy(bridge.state_to_numpy(pl.trainer.ema))}, params={
            'jax': _numpy(jl.trainer.state['params']),
            'port': _numpy(bridge.params_to_numpy(pl.field))},
            steps=(jl.trainer.step, pl.trainer.step),
            global_steps=(jl.trainer.global_step, pl.trainer.global_step))

        # The preview on equal params: JAX's carried into the port.
        bridge.load_params(pl.field, out['params']['jax'])
        out['preview'] = (_request(jl, jparent, ('get_image', 0)),
                          _request(pl, pparent, ('get_image', 0)))
        with torch.no_grad():
            out['logits'] = pl.trainer.test_step(
                pl.train_dataset._get_test(0))[2].numpy()
        out['coalesced'] = (
            _request(jl, jparent, ('get_image', 1), ('get_image', 2)),
            _request(pl, pparent, ('get_image', 1), ('get_image', 2)))

        # A repainted label PNG, then a checkpoint.
        name = pl.train_dataset.image_names[1]
        painted = np.zeros((36, 48), np.uint8)
        painted[:, 25:] = 2
        for scene in (jscene, pscene):
            write_png(os.path.join(scene, 'semantic', f'{name}.png'),
                      painted)
        for loop, conn in ((jl, jparent), (pl, pparent)):
            _request(loop, conn, ('update_image', 1), ('checkpoint', None))
        out['painted'] = painted
        out['semantics'] = (jl.train_dataset.semantics.copy(),
                            pl.train_dataset.semantics.copy())
        out['workspaces'] = (jl.workspace, pl.workspace)
        out['checkpointed'] = {'jax': _numpy(jl.trainer.state['params']),
                               'port': _numpy(bridge.params_to_numpy(pl.field))}

        # Each package's best.pth resumed by the other's TrainingLoop.
        out['resumed'] = {
            'jax_from_port': jax_backend.TrainingLoop(
                pscene, _flags(pscene), multiprocessing.Pipe()[1],
                dataset_factor=FACTOR).trainer,
            'port_from_jax': backend.TrainingLoop(
                jscene, _flags(jscene), multiprocessing.Pipe()[1],
                dataset_factor=FACTOR, device='cpu').trainer}

        # The baked preview: the first request bakes, then one slab a step.
        for loop in (jl, pl):
            loop.baked_preview, loop.rebake_every = True, 16
        out['baked'] = _request(pl, pparent, ('get_image', 3))
        jl._baker, jl._bake_step = _RecordingBaker(), jl.trainer.global_step
        cadence = {key: [(loop._baker._next_block, loop._bake_step)]
                   for key, loop in (('jax', jl), ('port', pl))}
        for _ in range(3):
            _step_both(jl, pl)
            for key, loop in (('jax', jl), ('port', pl)):
                loop._maybe_update_bake()
                cadence[key].append((loop._baker._next_block,
                                     loop._bake_step))
        out['cadence'] = cadence
        for loop in (jl, pl):
            loop.shutdown()
        out['done'] = (jl.done, pl.done)
    return out


def test_fetch_frame_bit_equal_to_jax():
    """uint8 rgb rounded half to even and float16 depth, back as float32:
    bit-equal to JAX's on seeded values, values whose fp32 product with
    255 is exactly k + 0.5, values out of [0, 1], and depths beyond
    float16's range."""
    rng = np.random.default_rng(3)
    rgb = rng.uniform(-0.2, 1.2, (37, 29, 3)).astype(np.float32)
    halves = (np.arange(255, dtype=np.float32) + np.float32(0.5)) \
        / np.float32(255)
    near = np.concatenate([halves, np.nextafter(halves, 2),
                           np.nextafter(halves, -2)])
    exact = near[(near * np.float32(255)) % 1 == 0.5]
    assert len(exact) > 100  # half-way products are covered
    flat = rgb.reshape(-1)
    flat[:len(exact)] = exact
    flat[-4:] = [-0.0, 1.0, 1.7, -3.0]
    depth = rng.uniform(0.0, 8.0, (37, 29)).astype(np.float32)
    depth[0, :4] = [70000.0, 65519.0, 1e-8, -2.5]
    ref = jax_backend._fetch_frame(jnp.asarray(rgb), jnp.asarray(depth))
    ours = backend._fetch_frame(torch.tensor(rgb), torch.tensor(depth))
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_classes_wrap_at_256_as_jax_does():
    logits = np.random.default_rng(4).normal(size=(9, 7, 300)).astype(
        np.float32)
    logits[0, [0, 1, 2], [3, 255, 260]] = 100.0
    ref = np.asarray(jnp.argmax(jnp.asarray(logits), axis=-1).astype(
        jnp.uint8)).astype(np.int32)
    ours = backend._classes(torch.tensor(logits))
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours, ref)
    assert list(ours[0, :3]) == [3, 255, 4]


class _Stop(Exception):
    pass


def _trainer_kwargs(mp, module, trainer_attr, run):
    """Run `run` with module's InteractiveTrainer replaced by a stand-in
    that records its arguments and stops the TrainingLoop."""
    seen = {}

    def stand_in(name, field, **kwargs):
        seen.update(kwargs, name=name, field=field)
        raise _Stop

    mp.setattr(module, trainer_attr, stand_in)
    with pytest.raises(_Stop):
        run()
    return seen


CASES = {
    'defaults': [],
    'proposal': ['--proposal', '--proposal-steps', '48', '--lr', '3e-4'],
    'reference_grid': ['--grid-preset', 'reference', '--heads-impl',
                       'pallas'],
    'occupancy_grid': ['--occupancy-grid', '--grid-interp', 'trilinear'],
}


@pytest.mark.parametrize('case', list(CASES))
def test_training_loop_configures_what_jax_does(tmp_path, case):
    """The trainer each TrainingLoop builds: name, lr, render and loss
    options, workspace, EMA decay, checkpoint use, the occupancy grid's
    trained cells, and the field's configuration."""
    scene = _scene(tmp_path / 'scene')
    argv = CASES[case]
    with pytest.MonkeyPatch.context() as mp:
        _small_grid(mp)
        ref = _trainer_kwargs(mp, jax_backend, 'InteractiveTrainer',
                              lambda: jax_backend.TrainingLoop(
                                  scene, _flags(scene, *argv), None))
        ours = _trainer_kwargs(mp, backend, 'InteractiveTrainer',
                               lambda: backend.TrainingLoop(
                                   scene, _flags(scene, *argv), None,
                                   device='cpu'))
    assert set(ours) == set(ref)
    assert ours['name'] == ref['name'] == 'ngp'
    assert ours['lr'] == ref['lr']
    assert 'iters' not in ours  # InteractiveTrainer's constant lr
    assert dataclasses.asdict(ours['render_options']) == \
        dataclasses.asdict(ref['render_options'])
    assert dataclasses.asdict(ours['loss_options']) == \
        dataclasses.asdict(ref['loss_options'])
    for key in ('workspace', 'ema_decay', 'use_checkpoint'):
        assert ours[key] == ref[key], key
    assert ours['workspace'] == os.path.join(
        scene, 'nerf', model_utils.model_hash(_flags(scene, *argv)))
    jc, pc = ref['field'].config, ours['field'].config
    for key in ('encoding', 'geo_feat_dim', 'hidden_dim_semantic',
                'semantic_classes', 'bound', 'proposal', 'grid_interp',
                'heads_impl'):
        assert getattr(pc, key) == getattr(jc, key), key
    assert (pc.grid is None) == (jc.grid is None)
    if case == 'reference_grid':
        assert ours['render_options'].sampled_backward == 0
        assert ours['render_options'].backward_points == 1.0
    if case == 'occupancy_grid':
        np.testing.assert_array_equal(ours['occupancy'].trained.numpy(),
                                      np.asarray(ref['occupancy'].trained))
        assert ours['occupancy'].bound == ref['occupancy'].bound
    else:
        assert ours['occupancy'] is None and ref['occupancy'] is None


def test_interactive_trainer_is_constant_lr(tmp_path):
    scene = _scene(tmp_path / 'scene')
    with pytest.MonkeyPatch.context() as mp:
        _small_grid(mp)
        loop = backend.TrainingLoop(scene, _flags(scene, '--lr', '2e-4'),
                                    None, device='cpu')
    assert loop.trainer.optimizer.schedule == 2e-4
    assert loop.trainer.MAX_INFLIGHT == 8
    assert InteractiveTrainer.EMA_EVERY == 100


def test_take_step_losses_match_jax(loops):
    """Three steps from the same params, batches and draws: every loss
    part within rtol 1e-3."""
    for ours, ref in loops['losses']:
        assert set(ours) == set(ref)
        for k in ref:
            np.testing.assert_allclose(ours[k], ref[k], rtol=1e-3,
                                       err_msg=k)
    assert loops['steps'] == (2, 2)
    assert loops['global_steps'] == (3, 3)


def _leaves(tree):
    return jax.tree.leaves(tree)


def test_ema_follows_the_local_step_and_matches_jax(loops):
    """With EMA_EVERY 2: no tick at global step 2 (local step 1), one at
    local step 2; the port's EMA is 0.95 ema + 0.05 params, and within
    0.05 of the two packages' params' difference of JAX's."""
    for key in ('jax', 'port'):
        for a, b in zip(_leaves(loops['ema_after_local_1'][key]),
                        _leaves(loops['ema_before'][key])):
            np.testing.assert_array_equal(a, b)
    for key in ('jax', 'port'):
        for e, e0, p in zip(_leaves(loops['ema_after'][key]),
                            _leaves(loops['ema_before'][key]),
                            _leaves(loops['params'][key])):
            np.testing.assert_allclose(e, 0.95 * e0 + 0.05 * p, rtol=1e-6,
                                       atol=1e-7)
    for ep, ej, pp, pj in zip(_leaves(loops['ema_after']['port']),
                              _leaves(loops['ema_after']['jax']),
                              _leaves(loops['params']['port']),
                              _leaves(loops['params']['jax'])):
        assert np.all(np.abs(ep - ej) <= 0.05 * np.abs(pp - pj) + 1e-6)


def test_inflight_window_holds_at_most_eight(monkeypatch):
    """The deque of in-flight steps never grows past MAX_INFLIGHT (on the
    CPU it holds no events: every step has ended when it returns)."""
    field = torch.nn.Linear(1, 1)
    field.device = torch.device('cpu')
    trainer = InteractiveTrainer.__new__(InteractiveTrainer)
    trainer.field = field
    trainer.step = 0
    trainer.iterator = iter(range(20))
    trainer._inflight = collections.deque()
    monkeypatch.setattr(InteractiveTrainer, 'train_step',
                        lambda self, data, draws=None: {'total': data})
    depths = []
    for i in range(20):
        assert trainer.take_step() == {'total': i}
        depths.append(len(trainer._inflight))
    assert max(depths) == 8 and depths[-1] == 8 and depths[:8] == list(
        range(1, 9))
    assert all(e is None for e in trainer._inflight)


def _assert_same_payload_layout(ours, ref):
    assert set(ours) == set(ref)
    for key in ref:
        if ref[key] is None:
            assert ours[key] is None, key
        elif isinstance(ref[key], np.ndarray):
            assert ours[key].shape == ref[key].shape, key
            assert ours[key].dtype == ref[key].dtype, key
        else:
            assert ours[key] == ref[key], key


def test_preview_payload_matches_jax(loops):
    """get_image on equal params: one ('image', payload) each, with JAX's
    keys, shapes and dtypes, equal within the render limits."""
    (ref_msgs, our_msgs) = loops['preview']
    assert [m[0] for m in ref_msgs] == [m[0] for m in our_msgs] == ['image']
    ref, ours = ref_msgs[0][1], our_msgs[0][1]
    _assert_same_payload_layout(ours, ref)
    assert ours['rgb'].shape == (18, 24, 3) and ours['features'] is None
    d_rgb = np.abs(ours['rgb'] - ref['rgb'])
    assert d_rgb.max() <= 1.0 / 255 + 1e-7 and d_rgb.mean() < 5e-3
    d_depth = np.abs(ours['depth'] - ref['depth'])
    scale = float(np.abs(ref['depth']).max())
    assert d_depth.mean() < 5e-3 * scale
    assert np.quantile(d_depth, 0.999) < 5e-2 * scale
    logits = loops['logits']
    top2 = np.sort(logits, axis=-1)[..., -2:]
    near = (top2[..., 1] - top2[..., 0]) <= 1e-3 * np.abs(logits).max()
    differ = ours['semantic'] != ref['semantic']
    assert not np.any(differ & ~near)


def test_only_the_newest_get_image_is_answered(loops):
    for msgs in loops['coalesced']:
        assert [(kind, p['image_index']) for kind, p in msgs] == \
            [('image', 2)]


def test_repainted_png_reaches_semantics_as_in_jax(loops):
    ref, ours = loops['semantics']
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours[1], resize_nearest_pil(
        loops['painted'], (24, 18)).reshape(-1))
    assert 0 < ours[1].mean() < 2


def test_best_checkpoint_resumes_across_packages(loops):
    """best.pth from either loop: the other package's TrainingLoop resumes
    its step and params bit for bit (and its EMA)."""
    for workspace in loops['workspaces']:
        assert os.path.exists(os.path.join(workspace, 'checkpoints',
                                           'best.pth'))
    resumed = loops['resumed']
    jt, pt = resumed['jax_from_port'], resumed['port_from_jax']
    assert jt.global_step == pt.global_step == 3
    for a, b in zip(_leaves(_numpy(jt.state['params'])),
                    _leaves(loops['checkpointed']['port'])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_leaves(bridge.params_to_numpy(pt.field)),
                    _leaves(loops['checkpointed']['jax'])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_leaves(bridge.state_to_numpy(pt.ema)),
                    _leaves(loops['ema_after']['jax'])):
        np.testing.assert_array_equal(a, b)


def test_baked_cadence_matches_jax(loops):
    """--baked-preview: the first request bakes (at 32^3 here) and answers
    with the volumetric payload's layout, features None; then at
    rebake_every 16 (16 slabs) each step refreshes one slab: _maybe_update_
    bake moves _next_block and _bake_step as JAX's loop does on the same
    steps (JAX's driving a recording stand-in baker)."""
    (ours,) = loops['baked']
    assert ours[0] == 'image' and ours[1]['image_index'] == 3
    ref = dict(loops['preview'][0][0][1], image_index=3, features=None)
    _assert_same_payload_layout(ours[1], ref)
    assert loops['cadence']['port'] == loops['cadence']['jax']
    blocks = [b for b, _ in loops['cadence']['port']]
    assert blocks == [0, 1, 2, 3]
    assert loops['done'] == (True, True)


def _features_scene(path, n_classes=2):
    """The sphere with a features.hdf of (12, 9, 12, 8) teacher features
    and the PCA attributes scripts/compute_feature_maps.py writes."""
    from sklearn import decomposition
    scene = _scene(path)
    rng = np.random.default_rng(5)
    data = rng.normal(size=(12, 9, 12, 8)).astype(np.float16)
    pca = decomposition.PCA(n_components=3)
    mapped = pca.fit_transform(data.reshape(-1, 8).astype(np.float32))
    with h5py.File(os.path.join(scene, 'features.hdf'), 'w') as f:
        dataset = f.create_dataset('features/fcn50', data=data)
        dataset.attrs['pca'] = np.void(pickle.dumps(pca))
        dataset.attrs['min'] = mapped.min(axis=0)
        dataset.attrs['range'] = mapped.max(axis=0) - mapped.min(axis=0)
    return scene


def test_payload_and_pca_tile_bit_equal_to_jax(tmp_path):
    """_get_image's payload from one test_step result (stubbed, the same
    arrays for both): rgb, depth, classes and the PCA tile of the
    features bit-equal to JAX's."""
    scene = _features_scene(tmp_path / 'scene')
    flags = _flags(scene, '--features', 'fcn50', '--feature-dim', '8')
    with pytest.MonkeyPatch.context() as mp:
        _small_grid(mp)
        jparent, jchild = multiprocessing.Pipe()
        pparent, pchild = multiprocessing.Pipe()
        jl = jax_backend.TrainingLoop(scene, flags, jchild,
                                      dataset_factor=FACTOR)
        pl = backend.TrainingLoop(scene, flags, pchild, dataset_factor=FACTOR,
                                  device='cpu')
    rng = np.random.default_rng(6)
    arrays = (rng.uniform(-0.1, 1.1, (36, 48, 3)),
              rng.uniform(0, 3, (36, 48)), rng.normal(size=(36, 48, 2)),
              rng.normal(size=(36, 48, 8)))
    arrays = [a.astype(np.float32) for a in arrays]
    jl.trainer.test_step = lambda data: tuple(map(jnp.asarray, arrays))
    pl.trainer.test_step = lambda data: tuple(map(torch.tensor, arrays))
    ref = _request(jl, jparent, ('get_image', 4))[0][1]
    ours = _request(pl, pparent, ('get_image', 4))[0][1]
    _assert_same_payload_layout(ours, ref)
    assert ours['features'].shape == (36, 48, 3)
    for key in ('rgb', 'depth', 'semantic', 'features'):
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


def test_pca_tile_needs_h5py(tmp_path, monkeypatch):
    scene = _features_scene(tmp_path / 'scene')
    monkeypatch.setitem(sys.modules, 'h5py', None)
    with pytest.raises(RuntimeError, match='h5py'):
        backend.TrainingLoop(scene, _flags(scene, '--features', 'fcn50'),
                             None, device='cpu')


def test_entry_points_need_the_card_or_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    scene = _scene(tmp_path / 'scene')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        backend.TrainingLoop(scene, _flags(scene), None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gui.run_backend(_flags(scene), None)


def _jax_gui(monkeypatch):
    """scripts/gui.py with Qt stubbed (tests/qt_stub.py)."""
    from tests import qt_stub
    qt_stub.install()
    monkeypatch.syspath_prepend(os.path.join(REPO, 'scripts'))
    sys.modules.pop('gui', None)
    return importlib.import_module('gui')


@pytest.mark.parametrize('argv', [
    [], ['--baked-preview', '--rebake-every', '320', '--occupancy-grid'],
    ['--dry', '--lr', '0.01', '--batch-size', '1024', '--proposal']])
def test_read_args_match_scripts_gui(monkeypatch, argv):
    jax_gui = _jax_gui(monkeypatch)
    monkeypatch.setattr(sys, 'argv', ['gui.py', 'scene'] + argv)
    assert vars(gui.read_args(['scene'] + argv)) == vars(jax_gui.read_args())


def test_backend_client_spawns_a_cpu_child(tmp_path):
    """A spawned CPU child, at the GUI's flags with --encoding freq (no
    hash grid: small steps), answers one get_image, which the client
    forwards; it then stops on SIGTERM with exit code 0."""
    scene = _scene(tmp_path / 'scene')
    flags = _flags(scene, '--encoding', 'freq')
    previews = []
    client = gui.BackendClient(flags, previews.append, device='cpu')
    try:
        assert client.live
        client.request_preview(2)
        deadline = time.monotonic() + 240
        while not previews and time.monotonic() < deadline:
            client.poll()
            time.sleep(0.05)
    finally:
        exitcode = client.stop()
    assert len(previews) == 1 and previews[0]['image_index'] == 2
    assert previews[0]['rgb'].shape == (9, 12, 3)
    assert exitcode == 0


def test_dry_client_starts_no_child(tmp_path):
    client = gui.BackendClient(_flags(str(tmp_path), '--dry'), print)
    assert not client.live
    client.request_preview(0)  # dropped
    client.poll()
    assert client.stop() is None
