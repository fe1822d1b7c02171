"""The port's evaluation CLIs against scripts/, on the CPU.

On workspaces trained for 8 iterations by scripts/train.py and by the
port's train CLI on the port's annotated sphere fixture (48 x 36 frames,
gt_masks, gt_semantic and a mesh), the port's evaluate,
language.evaluate (2D and --pc), export and language.pointcloud give the
JSON, PNG pixels and PLY points of scripts/evaluate.py,
scripts/language/evaluate.py, scripts/export.py and
scripts/language/pointcloud.py: the predicted classes equal but at near
ties (JAX's top two logits or similarities within 5e-2 of the largest
magnitude, the render path's limit), and the scores equal wherever the
classes are; the point clouds' points and colours within the render
path's limits (mean |d| < 5e-3, 99.9th percentile < 5e-2 of the largest
magnitude). Every output is also held against scripts/' own on the port's
renders (or 3D query) replayed to it, so a near tie cannot skip the check:
the JSON and PNG pixels equal, the points within the render limits.
The language CLIs read a workspace whose params.pkl says --features lseg
(the trained weights, with the hash text stand-in of --allow-fallback);
their 3D query is fed JAX's draws. The refusals: no
card, and JPEG figures without cv2 or PIL.
"""
import importlib.util
import json
import os
import pickle
import shutil
import sys
import warnings

import cv2
import numpy as np
import pandas
import pytest
import torch

from autolabel_tpu import inference as jax_inference
from autolabel_tpu.utils.ply import read_ply_vertices
from autolabel_tpu_torch import evaluate as port_evaluate
from autolabel_tpu_torch import export as port_export
from autolabel_tpu_torch import inference
from autolabel_tpu_torch.language import evaluate as port_language
from autolabel_tpu_torch.language import pointcloud as port_pointcloud
from autolabel_tpu_torch.train import __main__ as port_train
from autolabel_tpu_torch.utils import fixtures
from tests.test_torch_port_evaluation import jax_noise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ['--iters', '8', '--batch-size', '512', '--num-steps', '16',
         '--factor-train', '1']
TIE = 5e-2
MEAN_LIMIT, TAIL_LIMIT = 5e-3, 5e-2


def _script(name):
    """scripts/<name>.py as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f'jax_{name.replace("/", "_")}_cli',
        os.path.join(REPO, 'scripts', f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """The module's torch work on one thread (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """The scene and {'jax': workspace root, 'port': workspace root}, each
    with one model trained for 8 iterations; and 'jax_lseg' / 'port_lseg'
    roots holding the same models with --features lseg in params.pkl."""
    root = tmp_path_factory.mktemp('evalcli')
    scene = str(root / 'sphere')
    fixtures.make_synthetic_scene(scene, n_frames=12, width=48, height=36,
                                  annotate=True, mesh_points=2000)
    saved = sys.argv
    sys.argv = ['train.py', scene, '--workspace', str(root / 'jax')] + TRAIN
    try:
        _script('train').main()
    finally:
        sys.argv = saved
    port_train.main([scene, '--workspace', str(root / 'port')] + TRAIN,
                    device='cpu')
    roots = {'scene': scene}
    for who in ('jax', 'port'):
        roots[who] = str(root / who)
        (model,) = os.listdir(os.path.join(roots[who], 'sphere'))
        lseg = os.path.join(str(root / f'{who}_lseg'), 'sphere', model)
        shutil.copytree(os.path.join(roots[who], 'sphere', model), lseg)
        with open(os.path.join(lseg, 'params.pkl'), 'rb') as f:
            params = pickle.load(f)
        params.features = 'lseg'
        with open(os.path.join(lseg, 'params.pkl'), 'wb') as f:
            pickle.dump(params, f)
        roots[f'{who}_lseg'] = str(root / f'{who}_lseg')
    label_map = str(root / 'label_map.csv')
    pandas.DataFrame({'id': [1, 2], 'prompt': ['background',
                                                'sphere|ball']}).to_csv(
        label_map, index=False)
    roots['label_map'] = label_map
    return roots


@pytest.fixture
def record(monkeypatch):
    """Every render's outputs, by package."""
    outputs = {'jax': [], 'port': []}
    for who, cls in (('jax', jax_inference.InferenceModel),
                     ('port', inference.InferenceModel)):
        render = cls.render

        def wrapped(self, batch, render=render, who=who):
            out = render(self, batch)
            outputs[who].append(out)
            return out

        monkeypatch.setattr(cls, 'render', wrapped)
    return outputs


def _replay(monkeypatch, name, outputs):
    """The JAX InferenceModel's `name` hands out the port's recorded
    `outputs` in turn: scripts/ then score the port's own renders."""
    it = iter(list(outputs))
    monkeypatch.setattr(jax_inference.InferenceModel, name,
                        lambda self, *args, **kwargs: next(it))


def _classes_equal_but_at_near_ties(ours, ref, ref_scores):
    top2 = np.sort(ref_scores, axis=-1)[..., -2:]
    near = (top2[..., 1] - top2[..., 0]) <= TIE * np.abs(ref_scores).max()
    same = ours == ref
    assert (same | near).all()
    return bool(same.all())


def _run_script(module, argv, monkeypatch):
    """Run scripts/<name>.py's main on argv (its own read_args parses
    sys.argv; export's main reads them itself)."""
    import inspect
    monkeypatch.setattr(sys, 'argv', ['script.py'] + argv)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        if inspect.signature(module.main).parameters:
            return module.main(module.read_args())
        return module.main()


@pytest.mark.parametrize('trained_by', ['jax', 'port'])
def test_evaluate_matches_scripts(trained, record, trained_by, tmp_path,
                                  monkeypatch, capsys):
    argv = [trained['scene'], '--workspace', trained[trained_by]]
    _run_script(_script('evaluate'), argv + ['--out',
                                             str(tmp_path / 'ref.json')],
                monkeypatch)
    ref_out = capsys.readouterr().out
    run = port_evaluate.main(argv + ['--out', str(tmp_path / 'ours.json')],
                             device='cpu')
    ours_out = capsys.readouterr().out
    ours = json.load(open(tmp_path / 'ours.json'))
    ref = json.load(open(tmp_path / 'ref.json'))
    assert len(ours) == len(ref) == 1
    assert len(record['port']) == len(record['jax']) == 4  # 4 gt masks
    equal = all(_classes_equal_but_at_near_ties(
        a['semantic'].argmax(-1), b['semantic'].argmax(-1), b['semantic'])
        for a, b in zip(record['port'], record['jax']))
    _replay(monkeypatch, 'render', record['port'])
    _run_script(_script('evaluate'), argv + ['--out',
                                             str(tmp_path / 'replay.json')],
                monkeypatch)
    capsys.readouterr()
    assert ours == json.load(open(tmp_path / 'replay.json'))
    iou, ref_iou = ours[0].pop('iou'), ref[0].pop('iou')
    assert ours == ref and ours[0]['scene'] == 'sphere'
    if equal:
        assert iou == ref_iou
    # the table: the scene's row and the Total row, as rich printed them
    assert f'{iou:.03f}' in ours_out and ours_out.count(f'{iou:.03f}') == 2
    assert f'{ref_iou:.03f}' in ref_out and 'Total' in ours_out
    assert run.model_hashes[0] in ours_out


def _text_features():
    """The label map's ensembled stand-in text features (background;
    sphere|ball), as both evaluators build them."""
    from autolabel_tpu_torch.features.fallback import HashTextEncoder
    embedded = HashTextEncoder().encode_text(['background', 'sphere',
                                              'ball'])
    rows = [embedded[0], embedded[1:].mean(0)]
    return np.stack([r / (np.linalg.norm(r) + 1e-6) for r in rows])


def _similarities(features, text):
    f = features / np.maximum(np.linalg.norm(features, axis=-1,
                                             keepdims=True), 1e-9)
    return f @ text[:, :f.shape[-1]].T


@pytest.mark.parametrize('trained_by,pc', [('jax', False), ('port', False),
                                           ('jax', True), ('port', True)])
def test_language_evaluate_matches_scripts(trained, record, trained_by, pc,
                                           tmp_path, monkeypatch, capsys):
    """The 3D query of the port fed JAX's draws (noise=); the features
    each side's query returns are recorded for the near-tie rule."""
    argv = [trained['scene'], '--workspace', trained[f'{trained_by}_lseg'],
            '--label-map', trained['label_map'], '--allow-fallback']
    argv += ['--pc'] if pc else ['--stride', '3']
    queried = {'jax': [], 'port': []}
    jax_jittered = jax_inference.InferenceModel.jittered_semantic_features
    jittered = inference.InferenceModel.jittered_semantic_features

    def jax_side(self, points, n, sigma, seed=0):
        out = jax_jittered(self, points, n, sigma, seed=seed)
        queried['jax'].append(out)
        return out

    def port_side(self, points, n, sigma, seed=0):
        out = jittered(self, points, n, sigma,
                       noise=jax_noise(len(points), n, sigma, seed, 50000))
        queried['port'].append(out)
        return out

    monkeypatch.setattr(jax_inference.InferenceModel,
                        'jittered_semantic_features', jax_side)
    monkeypatch.setattr(inference.InferenceModel,
                        'jittered_semantic_features', port_side)
    _run_script(_script('language/evaluate'),
                argv + ['--out', str(tmp_path / 'ref.json')], monkeypatch)
    port_language.main(argv + ['--out', str(tmp_path / 'ours.json')],
                       device='cpu')
    out = capsys.readouterr().out
    ours = json.load(open(tmp_path / 'ours.json'))
    ref = json.load(open(tmp_path / 'ref.json'))
    assert sorted(ours) == sorted(ref) == ['acc', 'iou']
    assert [sorted(d) for d in ours['iou']] == [sorted(d) for d in ref['iou']]
    assert 'sphere' in ours['iou'][0] and 'Total' in out
    text = _text_features()
    if pc:
        pairs = list(zip(queried['port'], queried['jax']))
        assert len(pairs) == 1 and len(pairs[0][0]) == 2000
    else:
        pairs = [(a['semantic_features'], b['semantic_features'])
                 for a, b in zip(record['port'], record['jax'])]
        assert len(pairs) == 4
    equal = True
    for a, b in pairs:
        equal &= _classes_equal_but_at_near_ties(
            _similarities(a, text).argmax(-1),
            _similarities(b, text).argmax(-1), _similarities(b, text))
    if pc:
        _replay(monkeypatch, 'jittered_semantic_features', queried['port'])
    else:
        _replay(monkeypatch, 'render', record['port'])
    _run_script(_script('language/evaluate'),
                argv + ['--out', str(tmp_path / 'replay.json')], monkeypatch)
    assert ours == json.load(open(tmp_path / 'replay.json'))
    if equal:
        assert ours == ref


def test_label_map_reader_matches_pandas(tmp_path):
    """id and evaluated as int64, prompts as str: the values
    pandas.read_csv gives, for label maps as convert_scannet writes them
    (id, prompt; synonyms, quoted commas) and with an evaluated column."""
    cases = {
        'plain': pandas.DataFrame({'id': [1, 2, 40], 'prompt': [
            'wall', 'floor', 'otherprop']}),
        'synonyms': pandas.DataFrame({'id': [3, 7], 'prompt': [
            'chair|seat', 'table, desk|counter']}),
        'evaluated': pandas.DataFrame({'id': [1, 2, 3], 'prompt': [
            'a', 'b "quoted"', 'c'], 'evaluated': [1, 0, 1]}),
    }
    for name, frame in cases.items():
        path = str(tmp_path / f'{name}.csv')
        frame.to_csv(path, index=False)
        ref = pandas.read_csv(path)
        ours = port_language.read_label_map(path)
        assert list(ours) == list(ref.columns)
        for column in ref.columns:
            a, b = ours[column], ref[column]
            if column in ('id', 'evaluated'):
                assert a.dtype == b.dtype == np.int64, column
            else:
                assert all(type(v) is str for v in a), column
            assert list(a) == list(b), column


@pytest.mark.parametrize('objects', [None, 1])
def test_export_matches_scripts(trained, record, tmp_path, monkeypatch,
                                objects):
    scenes = {}
    for who in ('jax', 'port', 'replay'):
        scenes[who] = str(tmp_path / who / 'sphere')
        shutil.copytree(trained['scene'], scenes[who])
    extra = ['--num-steps', '16'] + (['--objects', str(objects)]
                                     if objects else [])
    _run_script(_script('export'), [scenes['jax'], '--workspace',
                                    trained['port']] + extra, monkeypatch)
    port_export.main([scenes['port'], '--workspace', trained['port']]
                     + extra, device='cpu')
    _replay(monkeypatch, 'render', record['port'])
    _run_script(_script('export'), [scenes['replay'], '--workspace',
                                    trained['port']] + extra, monkeypatch)
    out = {who: os.path.join(scenes[who], 'output', 'semantic')
           for who in scenes}
    names = sorted(os.listdir(out['jax']))
    assert names == sorted(os.listdir(out['port'])) and len(names) == 12
    assert names == sorted(os.listdir(out['replay']))
    assert len(record['port']) == len(record['jax']) == 12
    for name, a, b in zip(sorted(names, key=lambda n: int(n[:-4])),
                          record['port'], record['jax']):
        ours = cv2.imread(os.path.join(out['port'], name), -1)
        ref = cv2.imread(os.path.join(out['jax'], name), -1)
        assert ours.dtype == ref.dtype == np.uint8
        assert ours.shape == ref.shape == (36, 48)
        assert np.array_equal(ours, cv2.imread(
            os.path.join(out['replay'], name), -1))
        same = _classes_equal_but_at_near_ties(
            a['semantic'].argmax(-1), b['semantic'].argmax(-1),
            b['semantic'])
        if same:
            assert np.array_equal(ours, ref)


def test_pointcloud_matches_scripts(trained, record, tmp_path, monkeypatch):
    argv = [trained['scene'], '--workspace', trained['port'],
            '--num-steps', '16', '--stride', '4']
    _run_script(_script('language/pointcloud'),
                argv + ['--out', str(tmp_path / 'ref.ply')], monkeypatch)
    port_pointcloud.main(argv + ['--out', str(tmp_path / 'ours.ply')],
                         device='cpu')
    _replay(monkeypatch, 'render', record['port'])
    _run_script(_script('language/pointcloud'),
                argv + ['--out', str(tmp_path / 'replay.ply')], monkeypatch)
    ours = read_ply_vertices(str(tmp_path / 'ours.ply'))
    ref = read_ply_vertices(str(tmp_path / 'ref.ply'))
    replayed = read_ply_vertices(str(tmp_path / 'replay.ply'))
    assert ours.shape == replayed.shape
    d = np.abs(ours - replayed)
    assert d.mean() < MEAN_LIMIT * np.abs(replayed).max()
    assert np.percentile(d, 99.9) < TAIL_LIMIT * np.abs(replayed).max()
    assert len(record['port']) == len(record['jax']) == 3
    masks = []
    for a, b in zip(record['port'], record['jax']):
        va, vb = a['depth_variance'], b['depth_variance']
        ma = va < np.percentile(va, 50)
        mb = vb < np.percentile(vb, 50)
        # a point enters or leaves only where its variance is at the
        # frame's median, within the render limit of it
        median = np.percentile(vb, 50)
        near = np.abs(vb - median) <= TAIL_LIMIT * np.abs(vb).max()
        assert ((ma == mb) | near).all()
        masks.append(ma == mb)
    if all(m.all() for m in masks):
        assert ours.shape == ref.shape
        d = np.abs(ours - ref)
        scale = np.abs(ref).max()
        assert d.mean() < MEAN_LIMIT * scale
        assert np.percentile(d, 99.9) < TAIL_LIMIT * scale


def test_clis_raise_without_a_card(trained, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    calls = [
        lambda: port_evaluate.main([trained['scene']]),
        lambda: port_language.main([trained['scene'], '--label-map',
                                    trained['label_map']]),
        lambda: port_export.main([trained['scene']]),
        lambda: port_pointcloud.main([trained['scene'], '--out',
                                      str(tmp_path / 'x.ply')]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match='CUDA'):
            call()


def test_evaluate_figures_need_cv2_and_pil(trained, tmp_path, monkeypatch,
                                           capsys):
    for missing in ('cv2', 'PIL.Image'):
        monkeypatch.setitem(sys.modules, missing, None)
        run = port_evaluate.main([trained['scene'], '--workspace',
                                  trained['port'], '--write-images',
                                  str(tmp_path / 'figs')], device='cpu')
        out = capsys.readouterr().out
        assert not run.json_entries
        assert 'Skipping' in out and missing.split('.')[0] in out
        monkeypatch.undo()
    run = port_evaluate.main([trained['scene'], '--workspace',
                              trained['port'], '--write-images',
                              str(tmp_path / 'figs')], device='cpu')
    assert len(run.json_entries) == 1
    assert len(os.listdir(tmp_path / 'figs' / 'sphere')) == 4


def test_only_scene_classes_selects_as_scripts(trained):
    """--only-scene-classes keeps the label map's rows whose ids the
    scene's metadata lists, as the JAX CLI's pandas filter does."""
    import types
    module = _script('language/evaluate')
    path = trained['label_map']
    dataset = types.SimpleNamespace(scene=types.SimpleNamespace(
        metadata={'classes': [2]}))
    for only in ([], ['--only-scene-classes']):
        flags = port_language.read_args(['s', '--label-map', path] + only)
        ours = port_language.scene_label_map(
            flags, port_language.read_label_map(path), dataset)
        ref = module.scene_label_map(flags, pandas.read_csv(path), dataset)
        assert list(ours['id']) == list(ref['id'])
        assert list(ours['prompt']) == list(ref['prompt'])
        assert len(ours['id']) == (1 if only else 2)
