"""The port's online-mapping dataset (DynamicDataset), its LSeg stand-in
(RandomFeatureExtractor) and the user-in-the-loop simulation
(simulate_user) against the JAX package and scripts/, on the CPU.

DynamicDataset: with equal seeded rngs, the frames kept after reservoir
eviction and the training batches are bit-equal to JAX's (numpy on both
sides). The prefetch thread is also held on what the port repairs: one
lock for the frame lists (a stress test of threads adding frames while
batches are taken) and errors raised by __iter__. UserSimulation: given
the same predictions, the clicks, the labels they write and the CSV rows
equal scripts/simulate_user.py's, both after np.random.seed(0).
simulate_user.main runs end to end at a small size (TPU_GRID shrunk to 2
levels x 8 features x 2^10 rows, 8 samples a ray).
"""
import importlib.util
import os
import sys
import threading

import numpy as np
import pytest
import torch

from autolabel_tpu.core.dataset import DynamicDataset as JaxDynamicDataset
from autolabel_tpu.core.dataset import SceneDataset as JaxSceneDataset
from autolabel_tpu.features.fallback import \
    RandomFeatureExtractor as JaxRandomFeatureExtractor
from autolabel_tpu.utils import Camera as JaxCamera
from autolabel_tpu_torch import model_utils, simulate_user
from autolabel_tpu_torch.core.dataset import DynamicDataset, SceneDataset
from autolabel_tpu_torch.features.fallback import RandomFeatureExtractor
from autolabel_tpu_torch.ops import encoders
from autolabel_tpu_torch.utils import Camera, fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, D = 24, 32, 6
K = np.array([[28.0, 0.0, 16.0], [0.0, 27.0, 12.5], [0.0, 0.0, 1.0]])
SMALL_GRID = dict(n_levels=2, n_features=8, log2_hashmap_size=10,
                  base_resolution=8, per_level_scale=1.6)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(n, seed=0):
    """n keyframes (T_CW, rgb uint8, depth uint16 mm, features (H/8, W/8,
    D) float16), poses on random rotations."""
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        T_CW = np.eye(4)
        T_CW[:3, :3] = q * np.sign(np.linalg.det(q))
        T_CW[:3, 3] = rng.normal(size=3)
        frames.append((T_CW,
                       rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
                       rng.integers(0, 6000, (H, W), dtype=np.uint16),
                       rng.normal(size=(H // 8, W // 8, D)).astype(
                           np.float16)))
    return frames


def _stopped(dataset_class, camera_class, capacity, seed):
    """A dataset with its prefetch thread stopped (so every rng draw is
    the test's) and self.rng seeded."""
    ds = dataset_class(1024, camera_class(K, (W, H)), capacity=capacity)
    ds.stop()
    ds.rng = np.random.default_rng(seed)
    return ds


def test_dynamic_dataset_matches_jax():
    """9 frames into a capacity of 5: the frames kept after JAX's
    reservoir eviction, then 3 training batches, bit-equal to JAX's."""
    frames = _frames(9)
    ref = _stopped(JaxDynamicDataset, JaxCamera, 5, seed=7)
    ours = _stopped(DynamicDataset, Camera, 5, seed=7)
    for frame in frames:
        ref.add_frame(*frame)
        ours.add_frame(*frame)
    assert len(ours) == len(ref) == 5
    for key in ('poses', 'rotations', 'origins', 'images', 'depths',
                'features', 'semantics'):
        a, b = getattr(ours, key), getattr(ref, key)
        assert len(a) == len(b) == 5, key
        for x, y in zip(a, b):
            assert x.dtype == y.dtype, key
            np.testing.assert_array_equal(x, y, err_msg=key)
    assert ours.images[0].dtype == np.float64
    assert ours.semantics[0].dtype == np.uint16
    for _ in range(3):
        a, b = ours._next_train(), ref._next_train()
        assert set(a) == set(b) and 'features' in a
        for key in b:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_dynamic_dataset_prefetches_and_stops():
    """Batches come from the prefetch thread once a frame is in; stop()
    joins it, and __iter__ then ends when the buffer is empty."""
    ds = DynamicDataset(512, Camera(K, (W, H)), capacity=3)
    for frame in _frames(4):
        ds.add_frame(*frame)
    assert len(ds) == 3
    iterator = iter(ds)
    batches = [next(iterator) for _ in range(30)]
    assert all(b['features'].shape == (512, D) for b in batches)
    assert all(b['rays_o'].shape == (512, 3) for b in batches)
    assert all((b['semantic'] == -1).all() for b in batches)
    ds.stop()
    assert not ds._prefetch_thread.is_alive()
    assert len(list(iterator)) <= ds.prefetch_buffer_size


def _next_or_timeout(iterator, timeout=30.0):
    """next(iterator) on a thread: (finished, value, error)."""
    result = {}

    def run():
        try:
            result['value'] = next(iterator)
        except BaseException as e:  # handed to the test
            result['error'] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(timeout)
    return not thread.is_alive(), result.get('value'), result.get('error')


def test_prefetch_error_is_raised_by_iter(monkeypatch):
    """An error in the prefetch thread reaches the consumer (JAX's thread
    dies silently and its __iter__ then sleeps forever)."""
    ds = DynamicDataset(512, Camera(K, (W, H)))

    def fail():
        raise ValueError('a broken batch')

    monkeypatch.setattr(ds, '_next_train', fail)
    ds.add_frame(*_frames(1)[0])
    finished, _, error = _next_or_timeout(iter(ds))
    assert finished
    assert isinstance(error, RuntimeError)
    assert isinstance(error.__cause__, ValueError)
    ds.stop()


def test_add_frame_checks_dtypes():
    ds = DynamicDataset(512, Camera(K, (W, H)))
    T_CW, rgb, depth, features = _frames(1)[0]
    with pytest.raises(TypeError, match='depth'):
        ds.add_frame(T_CW, rgb, depth.astype(np.float32), features)
    with pytest.raises(TypeError, match='rgb'):
        ds.add_frame(T_CW, rgb.astype(np.float32), depth, features)
    ds.add_frame(T_CW, rgb, depth, features)
    with pytest.raises(ValueError, match='features'):
        ds.add_frame(T_CW, rgb, depth, features[:1])
    ds.stop()


def test_frames_added_while_batches_are_taken():
    """Six threads add 60 frames each into a capacity of 4 while the
    consumer takes 150 batches, the interpreter switching threads every
    microsecond: no error, every batch whole, and the seven frame lists
    the same length, at the capacity."""
    ds = DynamicDataset(512, Camera(K, (W, H)), capacity=4)
    ds.add_frame(*_frames(1)[0])
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        producers = [threading.Thread(target=lambda s=s: [
            ds.add_frame(*f) for f in _frames(60, seed=s)])
            for s in range(1, 7)]
        for p in producers:
            p.start()
        iterator = iter(ds)
        taken = []
        for _ in range(150):
            finished, batch, error = _next_or_timeout(iterator)
            assert finished and error is None
            taken.append(batch)
        for p in producers:
            p.join(60)
            assert not p.is_alive()
    finally:
        sys.setswitchinterval(interval)
    ds.stop()
    assert all(np.isfinite(b['rays_d']).all() and b['features'].shape
               == (512, D) for b in taken)
    lengths = {len(getattr(ds, k)) for k in (
        'poses', 'rotations', 'origins', 'images', 'depths', 'features',
        'semantics')}
    assert lengths == {4} and len(ds) == 4


def test_random_feature_extractor_matches_jax():
    """float16 (B, H/8, W/8, D) features bit-equal to JAX's, on images
    whose sides are not multiples of the coarse scales (edge padding)."""
    x = np.random.default_rng(2).uniform(size=(2, 3, 50, 70))
    for out_dim, seed in ((512, 0), (16, 3)):
        ours = RandomFeatureExtractor(out_dim, seed=seed)(x)
        ref = JaxRandomFeatureExtractor(out_dim, seed=seed)(x)
        assert ours.dtype == np.float16 and ours.shape == (2, 6, 8, out_dim)
        np.testing.assert_array_equal(ours, ref)


def _jax_script():
    """scripts/simulate_user.py as a module of its own name."""
    spec = importlib.util.spec_from_file_location(
        'jax_simulate_user', os.path.join(REPO, 'scripts',
                                          'simulate_user.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Predictions:
    """A trainer stand-in whose test_step gives logits of the frame's own
    pixels (so some pixels are wrong), as `to` makes them."""

    def __init__(self, to):
        self.to = to

    def test_step(self, batch):
        p = np.asarray(batch['pixels'], np.float32)
        logits = np.stack([p[..., 0] - 0.45, p[..., 1] - p[..., 2]], -1)
        return None, None, self.to(logits), None


@pytest.fixture(scope='module')
def labelled_scene(tmp_path_factory):
    """The sphere fixture with a dense semantic map for every frame."""
    return fixtures.make_synthetic_scene(
        str(tmp_path_factory.mktemp('scenes') / 'sphere'), n_frames=12,
        width=48, height=36, label_every=1)


def test_user_simulation_clicks_as_scripts_does(labelled_scene, tmp_path):
    """4 rounds (evaluate every other one, then annotate) on the same
    predictions: the evaluation frames, the clicked labels, the results
    and the CSV equal scripts/simulate_user.py's."""
    script = _jax_script()
    datasets, users = [], []
    for make, user_class, to, name in (
            (JaxSceneDataset, script.UserSimulation, np.asarray, 'jax'),
            (SceneDataset, simulate_user.UserSimulation, torch.tensor,
             'port')):
        dataset = make('train', labelled_scene, factor=1.0, batch_size=512,
                       load_semantic=False)
        np.random.seed(0)
        user = user_class(_Predictions(to), dataset,
                          str(tmp_path / f'{name}.csv'))
        for i in range(4):
            if i % 2 == 0:
                user.evaluate(i, (dataset.semantics > 0).sum())
            user.annotate()
        user.save()
        datasets.append(dataset)
        users.append(user)
    ref, ours = users
    np.testing.assert_array_equal(ours.evaluation_frames,
                                  ref.evaluation_frames)
    np.testing.assert_array_equal(datasets[1].semantics,
                                  datasets[0].semantics)
    assert 0 < (datasets[1].semantics > 0).sum() <= 20
    assert ours.results == ref.results and len(ours.results) == 2
    with open(ours.result_path) as a, open(ref.result_path) as b:
        assert a.read() == b.read()
    assert (datasets[1].index_sampler.has_semantics
            == datasets[0].index_sampler.has_semantics)


@pytest.mark.parametrize('argv', [
    [], ['--warmup', '10', '-b', '1024', '--vis', '--workspace', 'ws',
         '--iters-per-round', '7', '--num-steps', '16']])
def test_read_args_match_scripts(monkeypatch, argv):
    script = _jax_script()
    monkeypatch.setattr(sys, 'argv', ['simulate_user.py', 'scene'] + argv)
    assert vars(simulate_user.read_args(['scene'] + argv)) == \
        vars(script.read_args())


def test_main_runs_end_to_end_on_the_cpu(labelled_scene, tmp_path,
                                         monkeypatch):
    """Warmup, then rounds until 12 pixels are labelled; the CSV lands in
    the workspace's model directory with the first round's mIoU."""
    monkeypatch.setattr(model_utils, 'TPU_GRID',
                        encoders.HashGridConfig(**SMALL_GRID))
    workspace = str(tmp_path / 'ws')
    argv = [labelled_scene, '--warmup', '3', '--iters-per-round', '1',
            '--max-annotations', '12', '-b', '512', '--num-steps', '8',
            '--workspace', workspace]
    user = simulate_user.main(argv, device='cpu')
    flags = simulate_user.read_args(argv)
    path = os.path.join(model_utils.model_dir(labelled_scene, flags),
                        'user_simulation.csv')
    assert user.result_path == path and os.path.exists(path)
    rows = np.atleast_2d(np.loadtxt(path))
    assert rows.shape == (1, 3) and rows[0, 0] == 0 and rows[0, 1] == 0
    assert 0.0 <= rows[0, 2] <= 1.0
    assert user.trainer.global_step == 3 + 4
    assert 0 < (user.dataset.semantics > 0).sum() <= 20


def test_vis_needs_matplotlib(labelled_scene, monkeypatch):
    monkeypatch.setitem(sys.modules, 'matplotlib.pyplot', None)
    with pytest.raises(RuntimeError, match='matplotlib'):
        simulate_user.main([labelled_scene, '--vis'], device='cpu')


def test_main_needs_the_card_or_cpu(labelled_scene):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate_user.main([labelled_scene])
