"""The port's render CLI (python -m autolabel_tpu_torch.render) against
scripts/render.py, on the CPU.

The depth colormap and the class colours are bit-equal to matplotlib's
through the JAX package's functions; the 2x2 tile is bit-equal to
scripts/render.py's render() and render_baked() fed the same outputs,
with and without a FeatureTransformer read from a features.hdf fixture;
the hash text stand-in gives the JAX package's classes. End to end, on a
workspace trained by the JAX CLI and on one trained by the port's (48 x
36 frames, 8 iterations; 8 samples a ray, 16 proposal samples), the
port's frames() yields tiles within the render path's limits of the JAX
CLI's (mean |d| < 5e-3, 99.9th percentile < 5e-2 of the largest
magnitude, 1), with the semantic classes equal except where JAX's top
two logits lie within that limit, on the dense, proposal and --baked
paths; main() writes the mp4. The refusals: no card, no cv2, no h5py, a
teacher without --allow-fallback.
"""
import importlib.util
import os
import pickle
import sys

import h5py
import numpy as np
import pytest
import torch
from matplotlib import cm
from sklearn.decomposition import PCA

from autolabel_tpu import constants as jax_constants
from autolabel_tpu import visualization as jax_visualization
from autolabel_tpu.features.fallback import \
    HashTextEncoder as JaxHashTextEncoder
from autolabel_tpu_torch import constants, visualization
from autolabel_tpu_torch.features import feature_utils
from autolabel_tpu_torch.features.fallback import HashTextEncoder
from autolabel_tpu_torch.render import __main__ as port_cli
from autolabel_tpu_torch.train import __main__ as port_train
from autolabel_tpu_torch.utils import fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ['--iters', '8', '--batch-size', '512', '--num-steps', '16',
         '--factor-train', '1']
RENDER = ['--size', '48', '36', '--stride', '6']
MEAN_LIMIT, TAIL_LIMIT = 5e-3, 5e-2  # the render path's limits


def _script(name):
    """scripts/<name>.py as a module of its own name."""
    spec = importlib.util.spec_from_file_location(
        f'jax_{name}_cli', os.path.join(REPO, 'scripts', f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: the suite runs in several
    worker processes at once, and torch's CPU thread pools, each as wide
    as the machine, slow one another down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def jax_render():
    return _script('render')


# -- colormaps, tiles, semantics --------------------------------------------

def test_colormap_tables_are_matplotlibs():
    assert np.array_equal(visualization.INFERNO, np.array(cm.inferno.colors))
    assert np.array_equal(constants.TAB10, np.array(cm.tab10.colors))


def _depths():
    rng = np.random.default_rng(0)
    d = rng.uniform(0.0, 12.0, (36, 48)).astype(np.float32)
    edge = np.array([[0.0, 7.5, 7.5 * (1 - 2 ** -24), 15.0, 1e-9]],
                    np.float32)
    return {'random': (d, 7.5), 'above_max': (d * 3, 7.5),
            'edges': (edge, 7.5), 'zeros': (np.zeros((4, 5), np.float32),
                                            7.5),
            'max_none': (d, None), 'max_zero': (d, 0.0),
            'max_negative': (d, -2.0), 'float64': (d.astype(np.float64),
                                                   10.0),
            'all_zero_none': (np.zeros((3, 3), np.float32), None)}


@pytest.mark.parametrize('case', list(_depths()))
def test_visualize_depth_bit_equal(case):
    depth, maxdepth = _depths()[case]
    ours = visualization.visualize_depth(depth, maxdepth=maxdepth)
    ref = jax_visualization.visualize_depth(depth, maxdepth=maxdepth)
    assert ours.dtype == ref.dtype == np.uint8
    assert np.array_equal(ours, ref)


def test_apply_colormap_matches_matplotlib():
    """Below 0, from 1 up, NaN and every bin edge i / 256."""
    x = np.concatenate([np.random.default_rng(1).uniform(-0.5, 1.5, 4000),
                        np.arange(257) / 256.0, [np.nan, -1e-9, 1.0]])
    for dtype in (np.float32, np.float64):
        ours = visualization.apply_colormap(visualization.INFERNO,
                                            x.astype(dtype))
        assert np.array_equal(ours, cm.inferno(x.astype(dtype))[:, :3])


def test_colors_bit_equal():
    assert constants.COLORS.dtype == jax_constants.COLORS.dtype
    assert np.array_equal(constants.COLORS, jax_constants.COLORS)


def _outputs(h=36, w=48, features=8, classes=5, seed=2):
    rng = np.random.default_rng(seed)
    return {'image': rng.uniform(-0.1, 1.1, (h, w, 3)).astype(np.float32),
            'depth': rng.uniform(0.0, 9.0, (h, w)).astype(np.float32),
            'semantic': rng.normal(size=(h, w, classes)).astype(np.float32),
            'semantic_features': rng.normal(size=(h, w, features)).astype(
                np.float32)}


class _Model:
    """Returns fixed outputs from render(), as InferenceModel would."""

    def __init__(self, outputs):
        self.outputs = outputs

    def render(self, batch):
        return self.outputs


@pytest.fixture(scope='module')
def features_scene(tmp_path_factory):
    """A directory with a features.hdf whose 'lseg' features carry a
    pickled sklearn PCA and its min and range (the compute_feature_maps
    contract)."""
    path = str(tmp_path_factory.mktemp('features'))
    data = np.random.default_rng(3).normal(size=(2, 9, 12, 8)).astype(
        np.float32)
    pca = PCA(n_components=3).fit(data.reshape(-1, 8))
    projected = pca.transform(data.reshape(-1, 8))
    with h5py.File(os.path.join(path, 'features.hdf'), 'w') as f:
        ds = f.create_dataset('features/lseg', data=data)
        ds.attrs['pca'] = np.void(pickle.dumps(pca))
        ds.attrs['min'] = projected.min(axis=0)
        ds.attrs['range'] = np.ptp(projected, axis=0)
    return path


@pytest.mark.parametrize('with_features', [False, True])
def test_tile_matches_scripts_render(jax_render, features_scene,
                                     with_features):
    outputs = _outputs()
    ours_t = ref_t = None
    if with_features:
        ours_t = port_cli.FeatureTransformer(features_scene, 'lseg', None)
        ref_t = jax_render.FeatureTransformer(features_scene, 'lseg', None)
    for size in ((960, 720), (96, 72)):
        ours = port_cli.render(_Model(outputs), {}, ours_t, size=size,
                               maxdepth=7.5)
        ref = jax_render.render(_Model(outputs), {}, ref_t, size=size,
                                maxdepth=7.5)
        assert ours.dtype == np.uint8 and ours.shape == (size[1], size[0],
                                                         3)
        assert np.array_equal(ours, ref)
    assert ours[36:, 48:].any() == with_features


class _Renderer:
    def __init__(self, outputs, wrap):
        self.outputs, self.wrap = outputs, wrap

    def render(self, intrinsics, T_CW, size):
        return {'image': self.wrap(self.outputs['image']),
                'depth': self.wrap(self.outputs['depth']),
                'semantic': self.wrap(self.outputs['semantic'].argmax(-1))}


class _Dataset:
    def __init__(self):
        from autolabel_tpu_torch.utils import Camera
        self.camera = Camera(np.array([[40.0, 0, 24], [0, 40, 18],
                                       [0, 0, 1]]), (48, 36))
        self.poses = np.stack([np.eye(4)] * 2)


def test_baked_tile_matches_scripts_render(jax_render):
    outputs = _outputs()
    ours = port_cli.render_baked(_Renderer(outputs, torch.as_tensor),
                                 _Dataset(), 1, maxdepth=7.5)
    ref = jax_render.render_baked(_Renderer(outputs, np.asarray),
                                  _Dataset(), 1, maxdepth=7.5)
    assert np.array_equal(ours, ref)
    assert not ours[360:, 480:].any()


def test_hash_text_encoder_matches():
    prompts = ['a chair', 'the floor', 'wall', '']
    assert np.array_equal(HashTextEncoder().encode_text(prompts),
                          JaxHashTextEncoder().encode_text(prompts))
    assert np.array_equal(HashTextEncoder(64).encode_text(prompts),
                          JaxHashTextEncoder(64).encode_text(prompts))


def test_compute_semantics_with_hash_classes(jax_render, features_scene,
                                             monkeypatch):
    """--classes with --allow-fallback on lseg features: the stand-in's
    text features, and the classes per pixel, are JAX's."""
    monkeypatch.delenv('AUTOLABEL_CLIP_WEIGHTS', raising=False)
    monkeypatch.delenv('AUTOLABEL_LSEG_WEIGHTS', raising=False)
    classes = ['chair', 'table', 'floor']
    ours_t = port_cli.FeatureTransformer(features_scene, 'lseg', classes,
                                         allow_fallback=True)
    with pytest.warns(UserWarning):
        ref_t = jax_render.FeatureTransformer(features_scene, 'lseg',
                                              classes, allow_fallback=True)
    assert np.array_equal(ours_t.text_features, ref_t.text_features)
    outputs = _outputs()
    ours = port_cli.compute_semantics(outputs, classes, ours_t)
    ref = jax_render.compute_semantics(outputs, classes, ref_t)
    assert np.array_equal(ours, ref) and len(np.unique(ours)) > 1
    assert np.array_equal(port_cli.compute_semantics(outputs, None, None),
                          jax_render.compute_semantics(outputs, None, None))


@pytest.mark.parametrize('teacher', ['fcn50', 'dino', 'lseg', 'demo'])
def test_unported_teachers_raise(teacher, monkeypatch):
    monkeypatch.delenv('AUTOLABEL_CLIP_WEIGHTS', raising=False)
    with pytest.raises(NotImplementedError, match='queue 1 item 6'):
        feature_utils.get_feature_extractor(teacher)
    if teacher == 'lseg':
        stand_in = feature_utils.get_feature_extractor(
            teacher, allow_fallback=True)
        assert stand_in.encode_text(['x']).shape == (1, 512)
        monkeypatch.setenv('AUTOLABEL_CLIP_WEIGHTS', '/nowhere')
    with pytest.raises(NotImplementedError, match='queue 1 item 6'):
        feature_utils.get_feature_extractor(teacher, allow_fallback=True)


def test_teacher_without_fallback_raises_in_the_feature_tile(
        features_scene):
    with pytest.raises(NotImplementedError, match='queue 1 item 6'):
        port_cli.FeatureTransformer(features_scene, 'lseg', ['chair'])


def test_feature_tile_without_h5py_raises(features_scene, monkeypatch):
    monkeypatch.setitem(sys.modules, 'h5py', None)
    with pytest.raises(RuntimeError, match='h5py'):
        port_cli.FeatureTransformer(features_scene, 'lseg', None)


def test_label_map_selects_the_scene_classes(tmp_path):
    path = tmp_path / 'labels.csv'
    path.write_text('id,prompt\n1,chair\n2,table\n5,floor\n')

    class Scene:
        metadata = {'classes': [1, 5]}

    dataset = type('D', (), {'scene': Scene()})()
    flags = port_cli.read_args(['s', '--model-dir', 'm', '--out', 'o',
                                '--label-map', str(path)])
    assert list(port_cli._classes(flags, dataset)) == ['chair', 'floor']
    Scene.metadata = {}
    assert list(port_cli._classes(flags, dataset)) == ['chair', 'table',
                                                       'floor']


# -- the CLI end to end -----------------------------------------------------

@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('scenes') / 'sphere')
    fixtures.make_synthetic_scene(path, n_frames=12, width=48, height=36)
    return path


@pytest.fixture(scope='module')
def workspaces(scene, tmp_path_factory):
    """{'jax': a model directory scripts/train.py trained (dense), 'port':
    one the port's train CLI trained with --proposal}."""
    root = tmp_path_factory.mktemp('ws')
    argv = [scene, '--workspace', str(root / 'jax')] + TRAIN
    saved = sys.argv
    sys.argv = ['train.py'] + argv
    try:
        _script('train').main()
    finally:
        sys.argv = saved
    jax_dir = os.path.join(str(root / 'jax'), 'sphere', os.listdir(
        os.path.join(str(root / 'jax'), 'sphere'))[0])
    run = port_train.main([scene, '--proposal', '--workspace',
                           str(root / 'port')] + TRAIN, device='cpu')
    return {'jax': jax_dir, 'port': run.model_dir}


def _jax_frames(module, argv, monkeypatch):
    """scripts/render.py's tiles (RGB) and each frame's logits."""
    tiles, logits = [], []

    class Writer:
        def __init__(self, *args):
            pass

        def write(self, frame):
            tiles.append(frame[..., ::-1].copy())

        def release(self):
            pass

    compute = module.compute_semantics
    monkeypatch.setattr(module.cv2, 'VideoWriter', Writer)
    monkeypatch.setattr(module, 'compute_semantics', lambda o, c, t: (
        logits.append(o['semantic']), compute(o, c, t))[1])
    monkeypatch.setattr(sys, 'argv', ['render.py'] + argv)
    module.main()
    return tiles, logits


def _port_frames(argv, monkeypatch):
    logits = []
    compute = port_cli.compute_semantics
    monkeypatch.setattr(port_cli, 'compute_semantics', lambda o, c, t: (
        logits.append(o['semantic']), compute(o, c, t))[1])
    tiles = [tile for _, tile in port_cli.frames(port_cli.read_args(argv),
                                                 device='cpu')]
    return tiles, logits


def _assert_within_limits(ours, ref):
    d = np.abs(ours.astype(np.float64) - ref.astype(np.float64)) / 255.0
    assert d.mean() < MEAN_LIMIT and np.percentile(d, 99.9) < TAIL_LIMIT, (
        d.mean(), np.percentile(d, 99.9))


PATHS = {'dense': ['--num-steps', '8'],
         'proposal': ['--proposal', '--num-steps', '8', '--proposal-steps',
                      '16'],
         'baked': ['--baked', '--bake-resolution', '48', '--max-splats',
                   '16384']}


@pytest.mark.parametrize('trained_by, path', [
    ('jax', 'dense'), ('port', 'dense'), ('port', 'proposal'),
    ('jax', 'baked'), ('port', 'baked')])
def test_cli_frames_match_scripts_render(jax_render, scene, workspaces,
                                         monkeypatch, trained_by, path):
    argv = [scene, '--model-dir', workspaces[trained_by], '--out',
            os.devnull] + RENDER + PATHS[path]
    ref, ref_logits = _jax_frames(jax_render, argv, monkeypatch)
    ours, our_logits = _port_frames(argv, monkeypatch)
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        assert a.shape == b.shape == (720, 960, 3) and a.dtype == np.uint8
        _assert_within_limits(a[:360], b[:360])  # rgb | depth
        if path == 'baked':
            _assert_within_limits(a[360:], b[360:])
    assert len(our_logits) == len(ref_logits) == (0 if path == 'baked'
                                                  else 2)
    for a, b, tile_a, tile_b in zip(our_logits, ref_logits, ours, ref):
        top2 = np.sort(b, axis=-1)[..., -2:]
        near = (top2[..., 1] - top2[..., 0]) <= TAIL_LIMIT * np.abs(b).max()
        same = a.argmax(-1) == b.argmax(-1)
        assert (same | near).all()
        if same.all():
            assert np.array_equal(tile_a[360:, :480], tile_b[360:, :480])


def test_cli_writes_the_video(scene, workspaces, tmp_path):
    for trained_by in ('jax', 'port'):
        out = str(tmp_path / f'{trained_by}.mp4')
        port_cli.main([scene, '--model-dir', workspaces[trained_by],
                       '--out', out, '--num-steps', '8', '--size', '48',
                       '36', '--stride', '12'], device='cpu')
        assert os.path.getsize(out) > 1000


class _Stop(Exception):
    pass


def _until_model(monkeypatch, module, run):
    """Run `run` with module.InferenceModel.from_checkpoint replaced by a
    stand-in that records its arguments and stops the CLI."""
    seen = {}

    def stand_in(field, model_dir, **kwargs):
        seen.update(kwargs, model_dir=model_dir,
                    proposal=field.config.proposal)
        raise _Stop

    monkeypatch.setattr(module.InferenceModel, 'from_checkpoint', stand_in)
    with pytest.raises(_Stop):
        run()
    return seen


@pytest.mark.parametrize('trained_by, extra', [
    ('jax', ['--proposal']), ('jax', []), ('port', ['--proposal']),
    ('port', []), ('port', ['--proposal', '--num-steps', '8',
                            '--proposal-steps', '24'])])
def test_cli_builds_the_model_as_scripts_render(
        jax_render, scene, workspaces, capsys, monkeypatch, trained_by,
        extra):
    """The proposal fallback (its message, on a checkpoint without a
    proposal net) and the step defaults (32 with the proposal net, 512
    without): InferenceModel.from_checkpoint gets the JAX CLI's
    arguments."""
    argv = [scene, '--model-dir', workspaces[trained_by], '--out',
            os.devnull] + RENDER + extra
    ours = _until_model(monkeypatch, port_cli, lambda: next(
        port_cli.frames(port_cli.read_args(argv), device='cpu')))
    our_out = capsys.readouterr().out
    monkeypatch.setattr(sys, 'argv', ['render.py'] + argv)
    ref = _until_model(monkeypatch, jax_render, jax_render.main)
    assert ours == ref
    fallback = trained_by == 'jax' and '--proposal' in extra
    assert ('falling back to the dense volumetric path' in our_out) == \
        fallback
    assert ('falling back to the dense volumetric path' in
            capsys.readouterr().out) == fallback
    if '--num-steps' not in extra:
        assert ours['num_steps'] == (32 if ours['proposal_steps'] else 512)
    assert ours['max_ray_batch'] == 16384


def test_baked_with_classes_prints_the_note(scene, workspaces, capsys,
                                            monkeypatch):
    argv = [scene, '--model-dir', workspaces['port'], '--out', os.devnull,
            '--classes', 'chair', 'floor'] + RENDER + PATHS['baked']
    tiles, _ = _port_frames(argv, monkeypatch)
    assert len(tiles) == 2
    assert ('--baked renders closed-set semantics only; --classes/'
            '--label-map need the volumetric path.') in \
        capsys.readouterr().out


@pytest.mark.parametrize('argv', [
    [], ['--fps', '9', '--max-depth', '3', '--checkpoint', 'c',
         '--allow-fallback', '--classes', 'a', 'b', '--size', '64', '48',
         '--baked', '--bake-resolution', '32', '--max-splats', '1024',
         '--proposal', '--proposal-steps', '16', '--heads-impl', 'pallas'],
    ['--label-map', 'l.csv', '--num-steps', '64', '--stride', '3']])
def test_cli_flags_match_scripts_render(jax_render, monkeypatch, argv):
    argv = ['scene', '--model-dir', 'm', '--out', 'o.mp4'] + argv
    monkeypatch.setattr(sys, 'argv', ['render.py'] + argv)
    assert vars(port_cli.read_args(argv)) == vars(jax_render.read_args())


def test_cli_without_a_card_raises(scene, workspaces):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    argv = [scene, '--model-dir', workspaces['port'], '--out', os.devnull]
    with pytest.raises(RuntimeError, match='CUDA'):
        port_cli.main(argv)
    with pytest.raises(RuntimeError, match='CUDA'):
        next(port_cli.frames(port_cli.read_args(argv)))


def test_cli_without_cv2_raises(scene, workspaces, monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, 'cv2', None)
    out = tmp_path / 'v.mp4'
    with pytest.raises(RuntimeError, match='cv2'):
        port_cli.main([scene, '--model-dir', workspaces['port'], '--out',
                       str(out)], device='cpu')
    assert not out.exists()
