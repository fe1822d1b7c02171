"""The port's DemoCLIP teacher (autolabel_tpu_torch/features/demo_clip.py)
and its trainer against the JAX package's, on the CPU.

The optimiser written out (FlatAdam: clip_by_global_norm(1), adam,
apply_if_finite(100), the warmup-cosine schedule) is held to optax's
chain update for update, non-finite gradients included (2e-6 of the
largest parameter), and its schedule value for value (both fp32, within
1e-6 of the peak). The trainer draws JAX's batches from the same numpy
generator, so from JAX's own init (carried across) both packages' first
four losses agree within 1e-4 relative (fp32 sums in another order, over
one update). A checkpoint either package writes loads and encodes in the
other: text within 1e-5, pixels within one fp16 rounding. The CLI takes
scripts/train_demo_teacher.py's flags and defaults.
"""
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autolabel_tpu.features import clip_text_jax
from autolabel_tpu.features import demo_clip as jax_demo
from autolabel_tpu_torch import bridge
from autolabel_tpu_torch import train_demo_teacher as port_cli
from autolabel_tpu_torch.features import demo_clip
from autolabel_tpu_torch.utils import fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = dict(iters=4, crop=32, frames_stride=1, seed=3)
PROMPTS = ['red ball', 'a green box', 'sphere colored blue', 'the wall']


@pytest.fixture(scope='module', autouse=True)
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _jax_init(seed):
    """train_demo_teacher's initial params for `seed`."""
    k_pix, k_txt, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    config = clip_text_jax.CLIPTextConfig(**jax_demo._TEXT_CONFIG)
    return jax.tree_util.tree_map(np.asarray, {
        'pixel': jax_demo.init_pixel_params(k_pix),
        'text': clip_text_jax.init_params(k_txt, config),
        'logit_scale': jnp.asarray(2.0)})


@pytest.fixture(scope='module')
def room(tmp_path_factory):
    scene = str(tmp_path_factory.mktemp('demo') / 'room')
    fixtures.make_room_scene(scene, n_frames=4, width=80, height=60,
                             label_every=1)
    return scene


@pytest.fixture(scope='module')
def jax_run(room, tmp_path_factory):
    """JAX's train_demo_teacher for TRAIN: its losses (recorded from the
    jitted step) and its checkpoint."""
    out = str(tmp_path_factory.mktemp('jax') / 'teacher.npz')
    losses = []
    jit = jax.jit

    def recording_jit(fun=None, **kwargs):
        jitted = jit(fun, **kwargs)
        if getattr(fun, '__name__', '') != 'step':
            return jitted

        def step(*args):
            result = jitted(*args)
            losses.append(float(result[-1]))
            return result
        return step

    jax.jit = recording_jit
    try:
        jax_demo.train_demo_teacher(room, out, log_every=0, **TRAIN)
    finally:
        jax.jit = jit
    return {'losses': losses, 'checkpoint': out}


def test_schedule_matches_optax():
    for iters in (1500, 40, 3):
        warmup = max(iters // 20, 1)
        schedule = optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=2e-3, warmup_steps=warmup,
            decay_steps=iters)
        counts = np.arange(iters + 3)
        ref = np.asarray([schedule(c) for c in counts], np.float64)
        got = demo_clip.warmup_cosine_lr(
            torch.tensor(counts, dtype=torch.float32), 2e-3, warmup, iters)
        # both in fp32: within 1e-6 of the peak
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-9)
    with pytest.raises(ValueError):
        demo_clip.warmup_cosine_lr(torch.zeros(1), 1e-3, 1, 1)


def test_flat_adam_matches_optax():
    """Updates on gradients some of which are not finite (rejected) or
    far above the clip norm (scaled)."""
    rng = np.random.default_rng(0)
    n, iters = 257, 12
    params = rng.normal(size=n).astype(np.float32)
    schedule = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, iters)
    tx = optax.apply_if_finite(
        optax.chain(optax.clip_by_global_norm(1.0), optax.adam(schedule)),
        max_consecutive_errors=100)
    state = tx.init(jnp.asarray(params))
    ref = jnp.asarray(params)
    flat = torch.tensor(params)
    ours = demo_clip.FlatAdam(flat, lambda c: demo_clip.warmup_cosine_lr(
        c, 1e-2, 2, iters))
    for it in range(iters):
        grad = (rng.normal(size=n) * (0.01 if it % 3 else 5.0)).astype(
            np.float32)
        if it in (4, 5):
            grad[7] = np.nan if it == 4 else np.inf
        updates, state = tx.update(jnp.asarray(grad), state, ref)
        ref = optax.apply_updates(ref, updates)
        ours.step(torch.tensor(grad))
        np.testing.assert_allclose(flat.numpy(), np.asarray(ref),
                                   rtol=0, atol=2e-6 * np.abs(params).max())
    assert float(ours.count) == iters - 2


def test_training_losses_from_jax_init(room, jax_run):
    trainer = demo_clip.DemoTeacherTrainer(
        room, device='cpu', init=_jax_init(TRAIN['seed']), **TRAIN)
    losses = [float(trainer.step()) for _ in range(TRAIN['iters'])]
    assert len(jax_run['losses']) == TRAIN['iters']
    np.testing.assert_allclose(losses, jax_run['losses'], rtol=1e-4)
    # the first update is scaled by lr(0) = 0: the second loss is the
    # init's, on the second batch
    assert losses[0] != losses[1]


def test_batches_are_jax_draws(room):
    """draw_batches gives the frames, crops, synonyms and negatives that
    the JAX loop draws from the same generator, in its order."""
    trainer = demo_clip.DemoTeacherTrainer(room, device='cpu', **TRAIN)
    images, labels = demo_clip._read_scene(room, 1)
    rng = np.random.default_rng(TRAIN['seed'])
    crop = TRAIN['crop']
    n_syn = np.asarray([len(trainer.prompt_bank[c])
                        for c in sorted(trainer.prompt_bank)])
    _, negatives = demo_clip.compositional_prompts(demo_clip.ROOM_ATTRIBUTES)
    for it in range(TRAIN['iters']):
        fi = rng.integers(0, len(images), 8)
        ys = rng.integers(0, 60 - crop + 1, 8)
        xs = rng.integers(0, 80 - crop + 1, 8)
        syn = rng.integers(0, n_syn)
        neg = rng.integers(0, len(negatives), 8)
        crops, lab, got_syn, got_neg = trainer.batch(it)
        want = np.stack([images[f, y:y + crop, x:x + crop]
                         for f, y, x in zip(fi, ys, xs)])
        assert np.array_equal(crops.numpy(), want)
        cells = np.stack([labels[f, y:y + crop, x:x + crop][::2, ::2]
                          for f, y, x in zip(fi, ys, xs)])
        assert np.array_equal(lab.numpy(), np.where(cells > 0, cells - 1,
                                                    -1))
        assert np.array_equal(got_syn.numpy(), syn)
        assert np.array_equal(got_neg.numpy(), neg)


def _encodings(fe, seed=0):
    x = np.random.default_rng(seed).random((2, 3, 20, 30), np.float32)
    pixels = fe(x)
    if isinstance(pixels, torch.Tensor):
        pixels = pixels.numpy()
    return fe.encode_text(PROMPTS), pixels


@pytest.mark.parametrize('written_by', ['jax', 'port'])
def test_checkpoints_load_both_ways(room, jax_run, written_by, tmp_path):
    if written_by == 'jax':
        path = jax_run['checkpoint']
    else:
        path = str(tmp_path / 'teacher.npz')
        params = demo_clip.train_demo_teacher(room, path, log_every=0,
                                              device='cpu', **TRAIN)
        assert set(params) == {'pixel', 'text', 'logit_scale'}
    ours = demo_clip.DemoCLIPFE(path, device='cpu')
    ref = jax_demo.DemoCLIPFE(path)
    assert ours.meta == ref.meta
    (text, pixels), (ref_text, ref_pixels) = _encodings(ours), _encodings(
        ref)
    assert pixels.dtype == np.float16 and pixels.shape == (2, 10, 15, 512)
    np.testing.assert_allclose(text, ref_text, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pixels.astype(np.float32),
                               ref_pixels.astype(np.float32), rtol=1e-3,
                               atol=1e-5)
    assert ours.shape((20, 30)) == (10, 15)
    leaves = bridge.tree_leaves(demo_clip.load_checkpoint(path)[0])
    assert [a.shape for a in leaves] == [
        a.shape for a in jax.tree_util.tree_leaves(ref.params)]


def test_teacher_needs_a_checkpoint(monkeypatch, tmp_path):
    monkeypatch.delenv('AUTOLABEL_DEMO_TEACHER', raising=False)
    with pytest.raises(RuntimeError, match='checkpoint'):
        demo_clip.DemoCLIPFE(device='cpu')
    bad = tmp_path / 'bad.npz'
    np.savez(bad, meta='{"text_config": {"vocab_size": 514, "width": 192, '
             '"depth": 3, "heads": 6, "context_length": 32, "embed_dim": '
             '512}, "prompt_bank": {}, "n_leaves": 1}', leaf_0=np.zeros(3))
    with pytest.raises(ValueError, match='do not match'):
        demo_clip.load_checkpoint(str(bad))


def _script_flags(argv):
    spec = importlib.util.spec_from_file_location(
        'jax_train_demo_teacher_cli',
        os.path.join(REPO, 'scripts', 'train_demo_teacher.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    saved = sys.argv
    sys.argv = ['train_demo_teacher.py'] + argv
    try:
        return vars(module.read_args())
    finally:
        sys.argv = saved


@pytest.mark.parametrize('argv', [
    ['scene'],
    ['scene', '--out', 't.npz', '--prompts', 'p.json', '--iters', '7',
     '--crop', '48', '--lr', '0.01', '--frames-stride', '2', '--seed', '5']])
def test_cli_flags_match_script(argv):
    assert vars(port_cli.read_args(argv)) == _script_flags(argv)


def test_cli_trains_and_writes(room, tmp_path, capsys):
    prompts = tmp_path / 'prompts.json'
    prompts.write_text('{"1": ["wall"], "2": ["red ball", "crimson ball"], '
                       '"3": ["green box"], "4": ["blue ball"], '
                       '"5": ["yellow pillar"]}')
    out = port_cli.main([room, '--iters', '2', '--crop', '32',
                         '--frames-stride', '2', '--prompts', str(prompts)],
                        device='cpu')
    assert out == os.path.join(room, 'demo_teacher.npz')
    assert 'demo-teacher iter 1: loss' in capsys.readouterr().out
    fe = demo_clip.DemoCLIPFE(out, device='cpu')
    assert fe.meta['prompt_bank']['2'] == ['red ball', 'crimson ball']
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            port_cli.main([room, '--iters', '1'])
