"""The port's feature CLIs against scripts/, on the CPU: python -m
autolabel_tpu_torch.compute_feature_maps against
scripts/compute_feature_maps.py, and the language CLI on a --features demo
workspace against scripts/language/evaluate.py.

Both compute_feature_maps CLIs run on the same small scene (4 frames of
48 x 36, resized to a 242 or 720 px short side as the CLI does) through
the same teacher (a DemoCLIP .npz, a tiny lang-seg checkpoint in
AUTOLABEL_LSEG_WEIGHTS, a tiny fcn_resnet50 state dict in
AUTOLABEL_FCN50_WEIGHTS): the features.hdf maps agree within two fp16
roundings (the input resize: cv2's float blend against the port's in
float64; the towers: fp32 in another order) but where HDF5 halves an fp32
LSeg value that rounds up to a power of two in the JAX CLI's file (under
0.1% of them), and so do the PCA attrs
(mean, components up to sign, min and range within 1e-3 of their scale).
The language CLI gives the same per-class scores as JAX's with the same
DemoCLIP checkpoint; the port's renders replayed through JAX's CLI give
its scores exactly.
"""
import importlib.util
import json
import os
import pickle
import sys
import warnings

import h5py
import numpy as np
import pandas
import pytest
import torch

from autolabel_tpu.features import demo_clip as jax_demo
from autolabel_tpu_torch import bridge, model_utils
from autolabel_tpu_torch import compute_feature_maps as port_cli
from autolabel_tpu_torch.language import evaluate as port_language
from autolabel_tpu_torch.train import checkpoints
from autolabel_tpu_torch.utils import fixtures
from tests.test_fcn_jax import _random_torchvision_state
from tests.test_lseg_jax import _random_lseg_state
from tests.test_torch_port_demo_clip import _jax_init
from tests.test_torch_port_eval_cli import (_classes_equal_but_at_near_ties,
                                            _replay, _run_script, record)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
assert record  # the fixture, imported for the language test


@pytest.fixture(scope='module', autouse=True)
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f'jax_{name.replace("/", "_")}_feature_cli',
        os.path.join(REPO, 'scripts', f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module')
def teachers(tmp_path_factory):
    """The scene, a DemoCLIP checkpoint (JAX's init for seed 0), a tiny
    lang-seg checkpoint and a tiny fcn_resnet50 state dict."""
    root = tmp_path_factory.mktemp('teachers')
    scene = str(root / 'sphere')
    fixtures.make_synthetic_scene(scene, n_frames=4, width=48, height=36,
                                  annotate=True, mesh_points=500)
    demo = str(root / 'teacher.npz')
    jax_demo.save_checkpoint(demo, _jax_init(0), jax_demo.ROOM_PROMPT_BANK)
    lseg = str(root / 'lseg.ckpt')
    torch.save({'state_dict': {k: torch.as_tensor(v) for k, v in
                               _random_lseg_state(
                                   np.random.default_rng(1)).items()}},
               lseg)
    fcn = str(root / 'fcn.pth')
    torch.save({k: torch.as_tensor(v) for k, v in
                _random_torchvision_state(np.random.default_rng(2)).items()},
               fcn)
    return {'scene': scene, 'demo': demo, 'lseg': lseg, 'fcn50': fcn}


def _script_flags(module, argv, monkeypatch):
    monkeypatch.setattr(sys, 'argv', ['compute_feature_maps.py'] + argv)
    return vars(module.read_args())


@pytest.mark.parametrize('argv', [
    ['scene'],
    ['scene', '--vis', '--video', 'v.mp4', '--features', 'lseg',
     '--checkpoint', 'c.ckpt', '--dim', '16', '--autoencode',
     '--allow-fallback']])
def test_flags_match_script(argv, monkeypatch):
    module = _script('compute_feature_maps')
    assert vars(port_cli.read_args(argv)) == _script_flags(module, argv,
                                                           monkeypatch)


def _read(scene, name):
    with h5py.File(os.path.join(scene, 'features.hdf'), 'r') as f:
        dataset = f[f'features/{name}']
        return (dataset[:], pickle.loads(dataset.attrs['pca'].tobytes()),
                dataset.attrs['min'], dataset.attrs['range'])


@pytest.mark.parametrize('teacher,dim', [('demo', 64), ('lseg', 16),
                                         ('fcn50', 16)])
def test_features_hdf_matches_script(teachers, teacher, dim, monkeypatch):
    scene = teachers['scene']
    argv = [scene, '--features', teacher, '--dim', str(dim)]
    if teacher == 'demo':
        argv += ['--checkpoint', teachers['demo']]
    else:
        var = {'lseg': 'AUTOLABEL_LSEG_WEIGHTS',
               'fcn50': 'AUTOLABEL_FCN50_WEIGHTS'}[teacher]
        monkeypatch.setenv(var, teachers[teacher])
    module = _script('compute_feature_maps')
    monkeypatch.setattr(sys, 'argv', ['compute_feature_maps.py'] + argv)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        module.main()
    ref, ref_pca, ref_min, ref_range = _read(scene, teacher)
    assert port_cli.main(argv, device='cpu') == os.path.join(
        scene, 'features.hdf')
    ours, pca, minimum, span = _read(scene, teacher)
    assert ours.dtype == ref.dtype == np.float16
    assert ours.shape == ref.shape and ours.shape[0] == 4
    assert ours.shape[1] == {'demo': 121, 'lseg': 121, 'fcn50': 90}[teacher]
    scale = np.abs(ref.astype(np.float32)).max()
    a, b = ours.astype(np.float32), ref.astype(np.float32)
    off = ~np.isclose(a, b, rtol=2e-3, atol=1e-3 * scale)
    # scripts/ hands h5py the fp32 LSeg maps, and HDF5's conversion to
    # fp16 halves a few values just below a power of two that round up to
    # it (-0.12499498 is stored as -0.0625); the port rounds in torch
    assert off.mean() < 1e-3 and (teacher == 'lseg' or not off.any())
    np.testing.assert_allclose(a[off], 2 * b[off], rtol=2e-3)
    assert (np.log2(np.abs(b[off])) % 1 == 0).all()
    np.testing.assert_allclose(pca.mean_, ref_pca.mean_,
                               atol=1e-3 * scale)
    dots = np.abs(np.sum(pca.components_ * ref_pca.components_, axis=1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-3)
    width = np.abs(ref_range).max()
    np.testing.assert_allclose(np.sort(np.abs([minimum, minimum + span]),
                                       axis=0),
                               np.sort(np.abs([ref_min, ref_min + ref_range]),
                                       axis=0), atol=1e-3 * width)


def test_autoencode_compresses(teachers, monkeypatch):
    """--autoencode: every 512-d DemoCLIP map through the bottleneck to
    --dim codes (ReLU, so non-negative), written with their PCA."""
    scene = teachers['scene']
    compress = port_cli.compress_features
    # one epoch of large batches on the CPU
    monkeypatch.setattr(port_cli, 'compress_features',
                        lambda maps, dim, **kw: compress(
                            maps, dim, epochs=1, batch_size=16384, **kw))
    port_cli.main([scene, '--features', 'demo', '--checkpoint',
                   teachers['demo'], '--dim', '8', '--autoencode'],
                  device='cpu')
    codes, pca, _, span = _read(scene, 'demo')
    assert codes.shape == (4, 121, 161, 8) and (codes >= 0).all()
    assert np.isfinite(codes.astype(np.float32)).all()
    assert pca.components_.shape == (3, 8) and (span > 0).all()


def test_compression_learns(teachers):
    """The autoencoder's loss falls over its epochs on real teacher maps."""
    from autolabel_tpu_torch.features.demo_clip import DemoCLIPFE
    fe = DemoCLIPFE(teachers['demo'], device='cpu')
    x = np.random.default_rng(0).random((2, 3, 32, 48), np.float32)
    maps = fe(x)
    codes = port_cli.compress_features(maps, 8, epochs=3, batch_size=256)
    assert codes.shape == (2, 16, 24, 8) and codes.dtype == torch.float16


def test_main_names_what_is_missing(teachers, monkeypatch):
    """Without h5py (or sklearn) main raises naming it before it
    extracts anything."""
    real = port_cli.require

    def missing(module, what):
        if module == 'h5py':
            raise RuntimeError(f'{what} needs h5py, which is not installed')
        return real(module, what)

    monkeypatch.setattr(port_cli, 'require', missing)
    monkeypatch.setattr(port_cli, 'extract_features',
                        lambda *a, **k: pytest.fail('extracted'))
    with pytest.raises(RuntimeError, match='h5py'):
        port_cli.main([teachers['scene'], '--features', 'demo',
                       '--checkpoint', teachers['demo']], device='cpu')


@pytest.mark.parametrize('feature', ['demo', 'lseg', 'dino', 'fcn50'])
def test_compute_size_is_scripts(feature, tmp_path):
    from autolabel_tpu_torch.utils.images import write_png
    module = _script('compute_feature_maps')
    for w, h in ((1280, 960), (48, 36), (640, 481), (333, 1000)):
        path = str(tmp_path / f'{w}x{h}.png')
        write_png(path, np.zeros((h, w, 3), np.uint8))
        assert port_cli.compute_size(path, feature) == module.compute_size(
            path, feature)


# -- the language CLI on a --features demo workspace --------------------------


@pytest.fixture(scope='module')
def demo_workspace(teachers, tmp_path_factory):
    """A --features demo --feature-dim 512 workspace of seeded weights
    with the language CLI's 606-class head, and a label map."""
    root = str(tmp_path_factory.mktemp('language'))
    flags = model_utils.model_flag_parser().parse_args(
        ['--features', 'demo', '--feature-dim', '512'])
    bbox = np.loadtxt(os.path.join(teachers['scene'], 'bbox.txt'))
    gen = torch.Generator().manual_seed(5)
    field = model_utils.create_model(bbox[:3], bbox[3:6],
                                     port_language.SCANNET_N_CLASSES, flags,
                                     device='cpu', generator=gen)
    with torch.no_grad():
        field.encoder['grid'].copy_(
            torch.randn(field.encoder['grid'].shape, generator=gen) * 0.5)
    ws = os.path.join(root, 'sphere', model_utils.model_hash(flags))
    tree = bridge.params_to_numpy(field)
    checkpoints.save_checkpoint(os.path.join(ws, 'checkpoints', 'best.pth'),
                                {'params': tree, 'ema': tree, 'step': 0},
                                include_optimizer=False)
    model_utils.write_params(ws, flags)
    label_map = os.path.join(root, 'label_map.csv')
    pandas.DataFrame({'id': [1, 2], 'prompt': ['background',
                                                'sphere|ball']}).to_csv(
        label_map, index=False)
    return {'root': root, 'label_map': label_map}


def test_language_cli_with_demo_matches_script(teachers, demo_workspace,
                                               record, tmp_path,
                                               monkeypatch, capsys):
    argv = [teachers['scene'], '--workspace', demo_workspace['root'],
            '--label-map', demo_workspace['label_map'],
            '--feature-checkpoint', teachers['demo'], '--stride', '2']
    module = _script('language/evaluate')
    _run_script(module, argv + ['--out', str(tmp_path / 'ref.json')],
                monkeypatch)
    port_language.main(argv + ['--out', str(tmp_path / 'ours.json')],
                       device='cpu')
    assert 'Total' in capsys.readouterr().out
    ours = json.load(open(tmp_path / 'ours.json'))
    ref = json.load(open(tmp_path / 'ref.json'))
    assert [sorted(d) for d in ours['iou']] == [sorted(d) for d in ref['iou']]
    values = [v for d in ours['iou'] + ours['acc'] for v in d.values()]
    assert values and all(v is None or 0.0 <= v <= 1.0 for v in values)
    # the text side: DemoCLIP's embeddings of the label map's phrasings
    from autolabel_tpu_torch.features.demo_clip import DemoCLIPFE
    ours_fe = DemoCLIPFE(teachers['demo'], device='cpu')
    ref_fe = jax_demo.DemoCLIPFE(teachers['demo'])
    phrasings = ['background', 'sphere', 'ball']
    text = ours_fe.encode_text(phrasings)
    np.testing.assert_allclose(text, ref_fe.encode_text(phrasings), atol=1e-5)
    rows = np.stack([text[0], text[1:].mean(0)])
    rows /= np.linalg.norm(rows, axis=-1, keepdims=True) + 1e-6
    assert len(record['port']) == len(record['jax']) == 2
    equal = True
    for a, b in zip(record['port'], record['jax']):
        fa, fb = a['semantic_features'], b['semantic_features']
        sa, sb = fa @ rows.T, fb @ rows.T
        equal &= _classes_equal_but_at_near_ties(sa.argmax(-1),
                                                 sb.argmax(-1), sb)
    _replay(monkeypatch, 'render', record['port'])
    _run_script(module, argv + ['--out', str(tmp_path / 'replay.json')],
                monkeypatch)
    assert ours == json.load(open(tmp_path / 'replay.json'))
    if equal:
        assert ours == ref
