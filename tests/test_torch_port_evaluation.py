"""The port's inference and evaluation modules against the JAX package's,
on the CPU.

jittered_semantic_features is fed JAX's own jitter: sigma times
jax.random.normal(fold_in(fold_in(PRNGKey(seed), start), i)) drawn at the
padded bucket shape JAX's chunk loop draws it at, and sliced to the
chunk. End to end it is held
to the JAX package's within the heads' fp32 limits (rtol 1e-4, atol
1e-5); its accumulation order, on its own queries, within 2 R 2^-24 of the
terms' magnitudes (R the queries a point) of JAX's jitted loop on the same
queries, since XLA fuses each product into its sum.

The evaluators run on a JAX field's seeded params carried across with
bridge, on the port's annotated sphere fixture: the predicted maps (and
point labels) equal the JAX package's except at near ties (JAX's top two
logits or similarities within 5e-2 of the largest magnitude, the render
path's limit), and the per-class results equal wherever the maps are
equal. The results are always held against the JAX evaluators' own
scoring of the port's maps (its recorded renders or point labels replayed
to them), so a near tie cannot skip the check of the scores. The 3D
evaluator's fused query gets JAX's draws through the noise argument; its host-loop branch draws with numpy's default_rng(0), which
the port reproduces. A label map given as a DataFrame and as a dict of
lists gives the same results; synonym ensembling and the `evaluated`
subset equal JAX's.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pandas
import pytest
import torch

from autolabel_tpu import evaluation as jax_evaluation
from autolabel_tpu.core.dataset import SceneDataset as JaxSceneDataset
from autolabel_tpu.inference import InferenceModel as JaxInferenceModel
from autolabel_tpu.models.field import Field as JaxField
from autolabel_tpu.models.field import FieldConfig as JaxFieldConfig
from autolabel_tpu.ops.encoders import HashGridConfig as JaxGridConfig
from autolabel_tpu_torch import bridge, evaluation
from autolabel_tpu_torch.core.dataset import SceneDataset
from autolabel_tpu_torch.inference import InferenceModel
from autolabel_tpu_torch.models.field import Field, FieldConfig
from autolabel_tpu_torch.ops.encoders import HashGridConfig
from autolabel_tpu_torch.utils import fixtures

RTOL, ATOL = 1e-4, 1e-5
TIE = 5e-2  # the render path's limit, of the largest magnitude
GRID = dict(n_levels=4, n_features=8, log2_hashmap_size=10,
            base_resolution=8, per_level_scale=1.6)
CONFIG = dict(encoding='hg+freq', hidden_dim=32, hidden_dim_color=32,
              hidden_dim_semantic=32, semantic_classes=3, bound=1.0,
              heads_impl='xla')
RENDER = dict(num_steps=16, max_ray_batch=1024)


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """The module's torch work on one thread (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('eval') / 'sphere')
    fixtures.make_synthetic_scene(path, n_frames=12, width=48, height=36,
                                  annotate=True, mesh_points=3000)
    return path


def _params(seed=0, **overrides):
    config = JaxFieldConfig(grid=JaxGridConfig(**GRID),
                            **dict(CONFIG, **overrides))
    field = JaxField(config)
    params = jax.tree.map(np.asarray, field.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    params['encoder']['grid'] = rng.normal(
        0.0, 0.5, params['encoder']['grid'].shape).astype(np.float32)
    return field, params


@pytest.fixture(scope='module')
def models():
    """(JAX InferenceModel, the port's) on the same params."""
    jax_field, params = _params()
    field = bridge.load_params(
        Field(FieldConfig(grid=HashGridConfig(**GRID), **CONFIG),
              device='cpu'), params)
    return (JaxInferenceModel(jax_field, params, **RENDER),
            InferenceModel(field, **RENDER))


def jax_noise(n_points, n_samples, sigma, seed, chunk):
    """The jitter JAX's jittered_semantic_features adds, (n_samples - 1,
    n_points, 3): per chunk, drawn at its padded bucket shape and sliced."""
    key = jax.random.PRNGKey(seed)
    out = []
    for start in range(0, n_points, chunk):
        n = min(chunk, n_points - start)
        padded = min(chunk, 1 << max(n - 1, 1).bit_length())
        chunk_key = jax.random.fold_in(key, start)
        draws = [np.asarray(sigma * jax.random.normal(
            jax.random.fold_in(chunk_key, i), (padded, 3),
            dtype=jnp.float32))[:n] for i in range(n_samples - 1)]
        out.append(np.stack(draws))
    return np.concatenate(out, axis=1)


def _points(n, seed=3):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)


@pytest.mark.parametrize('n,chunk', [(1300, 500), (37, 50000), (1, 64)])
def test_jittered_features_match_jax(models, n, chunk):
    """1,300 points in chunks of 500: the last chunk's draws come from a
    512-row bucket."""
    jax_model, model = models
    jax_model._chunk, model._chunk = chunk, chunk
    try:
        points = _points(n)
        ref = jax_model.jittered_semantic_features(points, 10, 0.02, seed=4)
        noise = jax_noise(n, 10, 0.02, 4, chunk)
        ours = model.jittered_semantic_features(points, 10, 0.02, seed=4,
                                                noise=noise)
    finally:
        jax_model._chunk = model._chunk = 50000
    assert ours.shape == ref.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(ours, axis=-1), 1.0,
                               rtol=1e-5)


def test_jittered_accumulation_order_matches_jax(models):
    """On the port's own queries: its output against JAX's jitted loop (the
    JAX package's jittered_semantic_features with the query replaced by
    the port's values), within 2 R 2^-24 of the sum of the terms'
    magnitudes over the norm, plus 4 ulps of the normalization."""
    _, model = models
    n, n_samples, sigma = 700, 10, 0.02
    points = _points(n, seed=5)
    noise = jax_noise(n, n_samples, sigma, 6, 50000)
    ours = model.jittered_semantic_features(points, n_samples, sigma,
                                            noise=noise)
    with torch.no_grad():
        queries = np.stack([model._query_features(torch.from_numpy(
            points if i == 0 else points + noise[i - 1])).numpy()
            for i in range(n_samples)])

    @jax.jit
    def averaged(q):
        scale = 1.0 / n_samples

        def body(i, acc):
            return acc + q[i + 1] * scale

        feats = jax.lax.fori_loop(0, n_samples - 1, body, q[0])
        norm = jnp.linalg.norm(feats, axis=-1, keepdims=True)
        return feats / jnp.maximum(norm, 1e-9)

    ref = np.asarray(averaged(jnp.asarray(queries)))
    weights = np.array([1.0] + [1.0 / n_samples] * (n_samples - 1))
    terms = (np.abs(queries) * weights[:, None, None]).sum(axis=0)
    feats = queries[0] + (queries[1:] * np.float32(1.0 / n_samples)).sum(0)
    norm = np.linalg.norm(feats, axis=-1, keepdims=True)
    bound = 2 * n_samples * 2.0 ** -24 * terms / norm \
        + 4 * 2.0 ** -24 * np.abs(ref)
    assert (np.abs(ours - ref) <= bound).all()


def test_jittered_draws_its_own_noise(models):
    """Without noise: seeded per chunk on the field's device, so one seed
    repeats, another differs, and the result is still unit-norm."""
    _, model = models
    points = _points(300)
    a = model.jittered_semantic_features(points, 4, 0.02, seed=0)
    b = model.jittered_semantic_features(points, 4, 0.02, seed=0)
    c = model.jittered_semantic_features(points, 4, 0.02, seed=1)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    np.testing.assert_allclose(np.linalg.norm(a, axis=-1), 1.0, rtol=1e-5)
    with pytest.raises(ValueError, match='noise'):
        model.jittered_semantic_features(points, 4, noise=np.zeros((4, 300,
                                                                    3)))


# -- the evaluators ----------------------------------------------------------

class _Recorder:
    """Wraps an InferenceModel: records every render's outputs; with
    `noise_for`, feeds jittered_semantic_features JAX's draws."""

    def __init__(self, model, noise_for=None, fused=True):
        self.model, self.noise_for = model, noise_for
        self.outputs = []
        if not fused:
            self.jittered = None
        self.density, self.semantic = model.density, model.semantic

    def render(self, batch):
        out = self.model.render(batch)
        self.outputs.append(out)
        return out

    def __getattr__(self, name):
        if name == 'jittered_semantic_features' and self.__dict__.get(
                'jittered', True) is not None:
            return self._jittered
        raise AttributeError(name)

    def _jittered(self, points, n_samples, sigma, seed=0):
        if self.noise_for is None:
            return self.model.jittered_semantic_features(points, n_samples,
                                                         sigma, seed=seed)
        return self.model.jittered_semantic_features(
            points, n_samples, sigma,
            noise=self.noise_for(len(points), n_samples, sigma, seed))


class _Replay:
    """Hands a JAX evaluator the port's recorded renders in turn: JAX's
    scoring of the port's own maps."""

    def __init__(self, outputs):
        self.outputs = iter(outputs)

    def render(self, batch):
        return next(self.outputs)


def _near_ties(scores, scale=None):
    """Where the two largest scores lie within TIE of the largest |score|
    (of `scale` if given)."""
    top2 = np.sort(scores, axis=-1)[..., -2:]
    scale = np.abs(scores).max() if scale is None else scale
    return (top2[..., 1] - top2[..., 0]) <= TIE * scale


def _assert_maps_equal_but_at_near_ties(ours, ref, ref_scores):
    same = ours == ref
    assert (same | _near_ties(ref_scores)).all()
    return bool(same.all())


def _datasets(scene):
    return (JaxSceneDataset('test', scene, factor=1.0, lazy=True),
            SceneDataset('test', scene, factor=1.0, lazy=True))


def test_evaluator_matches_jax(models, scene):
    jax_model, model = models
    ref_data, data = _datasets(scene)
    ref_rec, rec = _Recorder(jax_model), _Recorder(model)
    names = ['Background', 'Class 1']
    ref = jax_evaluation.Evaluator(ref_rec, names).eval(ref_data)
    ours = evaluation.Evaluator(rec, names).eval(data)
    assert len(rec.outputs) == len(ref_rec.outputs) == 4
    equal = all(_assert_maps_equal_but_at_near_ties(
        a['semantic'].argmax(-1), b['semantic'].argmax(-1), b['semantic'])
        for a, b in zip(rec.outputs, ref_rec.outputs))
    assert sorted(ours) == sorted(ref) == [1]
    assert ours == jax_evaluation.Evaluator(_Replay(rec.outputs),
                                            names).eval(ref_data)
    if equal:
        assert ours == ref
    assert evaluation.compute_iou(np.array([1, 1, 0]), np.array([1, 0, 0]),
                                  1) == 0.5
    assert evaluation.compute_iou(np.zeros(3), np.zeros(3), 1) == 0.0


def _label_map(kind, evaluated=False, synonyms=False):
    prompts = ['background', 'sphere|ball|red ball' if synonyms else 'sphere']
    columns = {'id': [1, 2], 'prompt': prompts}
    if evaluated:
        columns['evaluated'] = [0, 1]
    return pandas.DataFrame(columns) if kind == 'frame' else columns


def _open_vocab(module, cls_name, model, label_map, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        evaluator = getattr(module, cls_name)(features='lseg', name='s',
                                              allow_fallback=True, **kwargs)
    evaluator.reset(model, label_map)
    return evaluator


@pytest.mark.parametrize('evaluated,synonyms', [(False, False),
                                                (True, True)])
def test_open_vocab_2d_matches_jax(models, scene, evaluated, synonyms):
    jax_model, model = models
    ref_data, data = _datasets(scene)
    ref_rec, rec = _Recorder(jax_model), _Recorder(model)
    ref_eval = _open_vocab(jax_evaluation, 'OpenVocabEvaluator2D', ref_rec,
                           _label_map('frame', evaluated, synonyms),
                           stride=3)
    ours_eval = _open_vocab(evaluation, 'OpenVocabEvaluator2D', rec,
                            _label_map('dict', evaluated, synonyms),
                            stride=3)
    ref = ref_eval.eval(ref_data)
    ours = ours_eval.eval(data)
    assert len(rec.outputs) == len(ref_rec.outputs) == 4
    text = ref_eval.text_features
    equal = True
    for a, b in zip(rec.outputs, ref_rec.outputs):
        def sims(out):
            f = out['semantic_features']
            f = f / np.maximum(np.linalg.norm(f, axis=-1, keepdims=True),
                               1e-9)
            return f @ text[:, :f.shape[-1]].T
        equal &= _assert_maps_equal_but_at_near_ties(
            sims(a).argmax(-1), sims(b).argmax(-1), sims(b))
    assert [sorted(d) for d in ours] == [sorted(d) for d in ref]
    assert 'sphere' in ours[0] and ('background' in ours[0]) != evaluated
    replay = _open_vocab(jax_evaluation, 'OpenVocabEvaluator2D',
                         _Replay(rec.outputs),
                         _label_map('frame', evaluated, synonyms), stride=3)
    assert ours == replay.eval(ref_data)
    if equal:
        assert ours == ref


def _host_loop_features(model, points, n_samples=10, sigma=0.02):
    """JAX's host-loop branch of OpenVocabEvaluator3D, on a model."""
    rng = np.random.default_rng(0)
    _, features = model.semantic(model.density(points)['geo_feat'])
    features = features.astype(np.float32)
    for _ in range(n_samples - 1):
        noise = rng.normal(scale=sigma, size=points.shape).astype(np.float32)
        _, f = model.semantic(model.density(points + noise)['geo_feat'])
        features += f * (1.0 / n_samples)
    return features / np.maximum(
        np.linalg.norm(features, axis=-1, keepdims=True), 1e-9)


@pytest.mark.parametrize('fused', [True, False])
@pytest.mark.parametrize('kind', ['frame', 'dict'])
def test_open_vocab_3d_matches_jax(models, scene, fused, kind):
    """The fused query fed JAX's draws, or the host loop (numpy's draws on
    both sides); the label map as a DataFrame or a dict."""
    jax_model, model = models
    ref_data, data = _datasets(scene)
    noise = (lambda n, k, s, seed: jax_noise(n, k, s, seed, 50000))
    ref_rec = _Recorder(jax_model, fused=fused)
    rec = _Recorder(model, noise_for=noise, fused=fused)
    assert hasattr(rec, 'jittered_semantic_features') == fused
    ref_eval = _open_vocab(jax_evaluation, 'OpenVocabEvaluator3D', ref_rec,
                           _label_map('frame', synonyms=True))
    ours_eval = _open_vocab(evaluation, 'OpenVocabEvaluator3D', rec,
                            _label_map(kind, synonyms=True))
    points, labels = ours_eval._read_gt_pointcloud(data)
    ref_points, ref_labels = ref_eval._read_gt_pointcloud(ref_data)
    assert np.array_equal(points, ref_points)
    assert np.array_equal(labels, ref_labels) and (labels == 2).all()
    ours_pred = ours_eval._predict_semantic(points)
    ref_pred = ref_eval._predict_semantic(ref_points)
    if fused:
        feats = jax_model.jittered_semantic_features(ref_points, 10, 0.02)
    else:
        feats = _host_loop_features(jax_model, ref_points)
    sims = feats @ ref_eval.text_features[:, :feats.shape[-1]].T
    equal = _assert_maps_equal_but_at_near_ties(ours_pred, ref_pred, sims)
    ours, ref = ours_eval.eval(data), ref_eval.eval(ref_data)
    assert sorted(ours[0]) == sorted(ref[0]) == ['sphere', 'total']
    replay = _open_vocab(jax_evaluation, 'OpenVocabEvaluator3D', None,
                         _label_map('frame', synonyms=True))
    replay._predict_semantic = lambda points: ours_pred
    assert ours == replay.eval(ref_data)
    if equal:
        assert ours == ref


def test_open_vocab_3d_splits_at_50000_points(tmp_path):
    """Beyond 50,000 points the rest is queried at seed 1, from 0: JAX's
    draws for each part fed to the port give JAX's labels."""
    jax_field, params = _params(seed=2, hidden_dim=16, hidden_dim_color=16,
                                hidden_dim_semantic=16)
    field = bridge.load_params(
        Field(FieldConfig(grid=HashGridConfig(**GRID),
                          **dict(CONFIG, hidden_dim=16, hidden_dim_color=16,
                                 hidden_dim_semantic=16)), device='cpu'),
        params)
    jax_model = JaxInferenceModel(jax_field, params, **RENDER)
    model = InferenceModel(field, **RENDER)
    seeds = []

    def noise(n, k, s, seed):
        seeds.append((n, seed))
        return jax_noise(n, k, s, seed, 50000)

    label_map = _label_map('dict')
    ref_eval = _open_vocab(jax_evaluation, 'OpenVocabEvaluator3D', jax_model,
                           pandas.DataFrame(label_map))
    ours_eval = _open_vocab(evaluation, 'OpenVocabEvaluator3D',
                            _Recorder(model, noise_for=noise), label_map)
    points = _points(50600, seed=7)
    ours = ours_eval._predict_semantic(points)
    ref = ref_eval._predict_semantic(points)
    assert seeds == [(50000, 0), (600, 1)]
    feats = np.concatenate([
        jax_model.jittered_semantic_features(points[:50000], seed=0),
        jax_model.jittered_semantic_features(points[50000:], seed=1)])
    sims = feats @ ref_eval.text_features[:, :feats.shape[-1]].T
    _assert_maps_equal_but_at_near_ties(ours, ref, sims)


@pytest.mark.parametrize('evaluated,synonyms', [(False, False), (True, False),
                                                (False, True), (True, True)])
def test_reset_matches_jax(evaluated, synonyms):
    """Text features (synonyms ensembled), the display names, the colour
    ids, the evaluated subset and the collapsed prompts; a DataFrame and a
    dict give the same."""
    frame = pandas.DataFrame({
        'id': [3, 7, 12],
        'prompt': ['wall|a wall', 'chair' if not synonyms
                   else 'chair | seat|stool', 'floor'],
        **({'evaluated': [1, 0, 1]} if evaluated else {})})
    ref = _open_vocab(jax_evaluation, 'OpenVocabEvaluator2D', None, frame)
    for label_map in (frame, {k: list(v) for k, v in frame.items()}):
        ours = _open_vocab(evaluation, 'OpenVocabEvaluator2D', None,
                           label_map)
        assert np.array_equal(ours.text_features, ref.text_features)
        assert ours.label_mapping == ref.label_mapping
        assert np.array_equal(ours.label_to_color_id, ref.label_to_color_id)
        assert np.array_equal(ours.evaluated_labels, ref.evaluated_labels)
        assert np.array_equal(ours.label_id_map, ref.label_id_map)
        assert list(ours.label_map['prompt']) == list(ref.label_map['prompt'])
        assert list(ours.label_map['id']) == list(ref.label_map['id'])


def test_figures(models, scene, tmp_path, monkeypatch):
    """The 2D evaluator's PNG figures decode equal to the JAX package's
    PIL-written ones; Evaluator's JPEG figures and visualize=True raise
    without cv2, PIL or matplotlib, naming them."""
    from PIL import Image
    jax_model, model = models
    ref_data, data = _datasets(scene)
    for module, m, d, out in ((jax_evaluation, jax_model, ref_data, 'ref'),
                              (evaluation, model, data, 'ours')):
        evaluator = _open_vocab(module, 'OpenVocabEvaluator2D', m,
                                _label_map('frame'), stride=6)
        evaluator.reset(m, _label_map('frame'), str(tmp_path / out))
        evaluator.eval(d)
    for sub in ('rgb', 'p_semantic', 'gt_semantic'):
        for name in ('000000.png', '000006.png'):
            a = np.asarray(Image.open(tmp_path / 'ours' / sub / name))
            b = np.asarray(Image.open(tmp_path / 'ref' / sub / name))
            assert a.dtype == b.dtype and a.shape == b.shape
            if sub != 'p_semantic':
                assert np.array_equal(a, b)
    for missing in ('cv2', 'PIL.Image'):
        monkeypatch.setitem(__import__('sys').modules, missing, None)
        with pytest.raises(RuntimeError, match=missing.split('.')[0]):
            evaluation.Evaluator(model, ['a', 'b'],
                                 save_figures=str(tmp_path / 'j')).eval(data)
        monkeypatch.undo()
    monkeypatch.setitem(__import__('sys').modules, 'matplotlib.pyplot', None)
    with pytest.raises(RuntimeError, match='matplotlib'):
        evaluation.Evaluator(model, ['a', 'b']).eval(data, visualize=True)
