"""The port's train CLI (python -m autolabel_tpu_torch.train) against
scripts/train.py, on the CPU.

For a set of argvs, both CLIs run up to the trainer's construction (a
stand-in that records its arguments and stops): the parsed flags, the
model-hash directory, params.pkl, the render and loss options, the
trainer's settings and the occupancy grid's trained cells are equal.
Every flag the port does not cover raises; the stochastic-corner estimator
(--sampled-backward 0, the reference grid) configures as in the JAX CLI. A short run of each CLI (batch
512, 16 samples a ray) leaves a workspace the other package's trainer
resumes, with metrics.jsonl and TensorBoard events the other package
reads. A longer sphere run, whose held-out PSNR rises, is marked slow.
"""
import dataclasses
import importlib.util
import json
import os
import sys

import h5py
import jax
import numpy as np
import pytest
import torch

from autolabel_tpu import model_utils as jax_model_utils
from autolabel_tpu.train import tb_events as jax_tb_events
from autolabel_tpu.train.trainer import SimpleTrainer as JaxSimpleTrainer
from autolabel_tpu_torch import bridge, model_utils
from autolabel_tpu_torch.render.renderer import RenderOptions
from autolabel_tpu_torch.train import __main__ as port_cli
from autolabel_tpu_torch.train import tb_events
from autolabel_tpu_torch.train.trainer import SimpleTrainer
from autolabel_tpu_torch.utils import fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHORT = ['--proposal', '--batch-size', '512', '--num-steps', '16',
         '--factor-train', '1', '--tensorboard']


def _jax_cli():
    """scripts/train.py as a module of its own name."""
    spec = importlib.util.spec_from_file_location(
        'jax_train_cli', os.path.join(REPO, 'scripts', 'train.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    """The port's sphere fixture (12 frames of 48 x 36), with a
    features.hdf of 12 x 9 teacher features."""
    path = str(tmp_path_factory.mktemp('scenes') / 'sphere')
    fixtures.make_synthetic_scene(path, n_frames=12, width=48, height=36)
    with h5py.File(os.path.join(path, 'features.hdf'), 'w') as f:
        f.create_dataset('features/fcn50', data=np.random.default_rng(
            0).normal(size=(12, 9, 12, 8)).astype(np.float32))
    return path


class _Stop(Exception):
    pass


def _until_trainer(monkeypatch, module, run):
    """Run `run` with module.SimpleTrainer replaced by a stand-in that
    records its arguments and stops the CLI."""
    seen = {}

    def stand_in(name, field, **kwargs):
        seen.update(kwargs, name=name, field=field)
        raise _Stop

    monkeypatch.setattr(module, 'SimpleTrainer', stand_in)
    with pytest.raises(_Stop):
        run()
    return seen


ARGVS = {
    'readme': ['--proposal'],
    'trilinear_exact': ['--grid-interp', 'trilinear', '--heads-impl',
                        'pallas', '--sampled-backward', '0',
                        '--no-stochastic-corners', '--lr', '1e-3'],
    'per_level_rows': ['--sampled-backward', '4,4,2,2',
                       '--backward-points', '1.0', '--occupancy-grid',
                       '--occupancy-near-far', '--upsample-steps', '8'],
    'schedule': ['--sampled-warmup-fraction', '0.1',
                 '--exact-final-fraction', '0.2', '--iters', '500',
                 '--no-metrics', '--tensorboard', '--save-optimizer',
                 '-w', '3'],
    'features': ['--features', 'fcn50', '--feature-dim', '32', '-g', '7',
                 '--encoding', 'hg', '--rgb-weight', '0.5',
                 '--factor-train', '1.5'],
    'reference_grid': ['--grid-preset', 'reference',
                       '--no-stochastic-corners', '--proposal',
                       '--proposal-steps', '32'],
    'stochastic': ['--sampled-backward', '0', '--stochastic-corners', '3',
                   '--exact-final-fraction', '0.1'],
    'residual': ['--sampled-backward', '0', '--stochastic-residual',
                 '--stochastic-exact-levels', '1'],
    'reference_stochastic': ['--grid-preset', 'reference',
                             '--stochastic-exact-levels', '4'],
}


@pytest.mark.parametrize('workspace', [False, True])
@pytest.mark.parametrize('case', list(ARGVS))
def test_cli_configures_what_scripts_train_does(scene, tmp_path,
                                                monkeypatch, case,
                                                workspace):
    argv = [scene] + ARGVS[case]
    if workspace:
        argv += ['--workspace', str(tmp_path / 'ws')]
    jax_cli = _jax_cli()
    monkeypatch.setattr(sys, 'argv', ['train.py'] + argv)
    ref = _until_trainer(monkeypatch, jax_cli, jax_cli.main)
    ref_params = jax_model_utils.read_params(ref['workspace'])
    os.remove(os.path.join(ref['workspace'], 'params.pkl'))
    ours = _until_trainer(monkeypatch, port_cli,
                          lambda: port_cli.main(argv, device='cpu'))
    assert vars(port_cli.read_args(argv)) == vars(jax_cli.read_args())
    assert ours['workspace'] == ref['workspace']
    assert ours['workspace'].startswith(str(tmp_path) if workspace
                                        else os.path.join(scene, 'nerf'))
    # params.pkl: the same Namespace, and each package reads the other's
    assert vars(model_utils.read_params(ours['workspace'])) == vars(
        ref_params) == vars(jax_model_utils.read_params(ours['workspace']))
    for key in ('render_options', 'loss_options'):
        assert dataclasses.asdict(ours[key]) == dataclasses.asdict(ref[key])
    for key in ('lr', 'iters', 'ema_decay', 'use_checkpoint',
                'exact_final_fraction', 'sampled_warmup_fraction',
                'metrics', 'tensorboard'):
        assert ours[key] == ref[key], key
    assert ours['name'] == ref['name'] == 'ngp'
    ref_config = dataclasses.asdict(ref['field'].config)
    our_config = dataclasses.asdict(ours['field'].config)
    assert our_config == ref_config
    assert (ours['occupancy'] is None) == (ref['occupancy'] is None)
    if ref['occupancy'] is not None:
        assert ours['occupancy'].density.shape == (128, 128, 128)
        assert np.array_equal(ours['occupancy'].trained.numpy(),
                              np.asarray(ref['occupancy'].trained))


@pytest.mark.parametrize('argv', [
    ['--mesh-devices', '1', '--pose-refine-experimental'],
    ['--mesh-devices', '2', '--pose-refine-experimental'],
    ['--mesh-devices', '4', '--mesh-model', '2',
     '--pose-refine-experimental']])
def test_cli_refuses_what_is_not_ported(scene, argv):
    """Each flag combination whose path the port lacks raises before any
    work: joint pose refinement on a device mesh. (The device mesh trains:
    tests/test_torch_port_parallel.py; the stochastic-corner estimator, on
    by default wherever the sampled backward is off, trains:
    tests/test_torch_port_stochastic.py; joint pose refinement trains:
    tests/test_torch_port_register.py.)"""
    with pytest.raises(NotImplementedError):
        port_cli.main([scene] + argv, device='cpu')


def test_cli_pose_refine_errors_as_the_jax_cli(scene, capsys):
    with pytest.raises(SystemExit):
        port_cli.read_args([scene, '--pose-refine'])
    assert 'register.py' in capsys.readouterr().err
    assert port_cli.read_args([scene, '--pose-refine-experimental']
                              ).pose_refine


def test_cli_without_a_card_raises(scene):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        port_cli.main([scene, '--proposal'])


@pytest.fixture(scope='module')
def port_run(scene, tmp_path_factory):
    """20 iterations of the port's CLI into a workspace of its own, with
    --eval."""
    ws = str(tmp_path_factory.mktemp('port_ws'))
    return port_cli.main([scene, '--iters', '20', '--workspace', ws,
                          '--eval', '--factor-test', '1.5'] + SHORT,
                         device='cpu')


def test_port_workspace_resumes_in_jax(port_run, scene):
    """The JAX package's SimpleTrainer, built as scripts/train.py builds
    it, resumes the port's workspace at its step with its params; the
    metrics line and the TensorBoard event (read by the JAX reader) carry
    the same loss parts."""
    model_dir = port_run.model_dir
    assert sorted(os.listdir(model_dir)) == ['checkpoints', 'metrics.jsonl',
                                             'params.pkl', 'run']
    assert os.listdir(os.path.join(model_dir, 'checkpoints')) == [
        'ngp_ep0001.pth']
    flags = jax_model_utils.read_params(model_dir)
    dataset = port_run.dataset
    field = jax_model_utils.create_model(dataset.min_bounds,
                                         dataset.max_bounds, 2, flags)
    jt = JaxSimpleTrainer('ngp', field, workspace=model_dir,
                          use_checkpoint='latest', metrics=False)
    assert jt.global_step == 20 and jt.epoch == 1
    ours = bridge.params_to_numpy(port_run.trainer.field)
    for a, b in zip(jax.tree.leaves(ours),
                    jax.tree.leaves(jt.state['params'])):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    with open(os.path.join(model_dir, 'metrics.jsonl')) as f:
        (line,) = [json.loads(x) for x in f]
    assert line['epoch'] == 1 and line['step'] == 20
    (events_file,) = os.listdir(os.path.join(model_dir, 'run', 'ngp'))
    path = os.path.join(model_dir, 'run', 'ngp', events_file)
    ((step, scalars),) = jax_tb_events.read_events(path)
    assert tb_events.read_events(path) == [(step, scalars)]
    assert step == 20 and scalars.keys() == {f'train/{k}' for k in line
                                             if k not in ('epoch', 'step',
                                                          'wall_s')}
    for key, value in scalars.items():
        assert value == np.float32(line[key[len('train/'):]])
        assert np.isfinite(value)


def test_jax_workspace_resumes_in_the_port(scene, tmp_path, monkeypatch):
    """A workspace scripts/train.py trained (2 iterations) resumes in the
    port's trainer at its step with its params, and the port's CLI trains
    it on; its TensorBoard events read in the port."""
    ws = str(tmp_path / 'jws')
    argv = [scene, '--iters', '2', '--workspace', ws] + SHORT
    monkeypatch.setattr(sys, 'argv', ['train.py'] + argv)
    _jax_cli().main()
    model_dir = model_utils.model_dir(scene, port_cli.read_args(argv))
    flags = model_utils.read_params(model_dir)
    field = model_utils.create_model(np.full(3, -1.0), np.full(3, 1.0), 2,
                                     flags, device='cpu')
    pt = SimpleTrainer('ngp', field, workspace=model_dir, metrics=False,
                       render_options=RenderOptions(
                           perturb=True, sampled_backward=2,
                           backward_points=0.25, num_steps=16,
                           proposal_steps=64))
    assert pt.global_step == 2 and pt.epoch == 1
    payload = jax_model_utils.load_checkpoint(
        os.path.join(model_dir, 'checkpoints'))[0]
    for a, b in zip(jax.tree.leaves(bridge.params_to_numpy(field)),
                    jax.tree.leaves(payload)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    (events_file,) = os.listdir(os.path.join(model_dir, 'run', 'ngp'))
    ((step, scalars),) = tb_events.read_events(
        os.path.join(model_dir, 'run', 'ngp', events_file))
    assert step == 2 and 'train/total' in scalars
    run = port_cli.main(argv, device='cpu')
    assert run.trainer.global_step == 4 and run.trainer.epoch == 2
    assert 'ngp_ep0002.pth' in os.listdir(os.path.join(model_dir,
                                                       'checkpoints'))


def test_cli_eval_prints_the_test_split_mse(port_run, capsys):
    assert np.isfinite(port_run.eval_mse) and 0 < port_run.eval_mse < 1
    assert port_run.train_s > 0


def test_cli_profile_writes_a_trace(scene, tmp_path):
    """--profile: a torch.profiler trace of the first epoch."""
    trace = tmp_path / 'trace'
    port_cli.main([scene, '--iters', '2', '--workspace', str(tmp_path / 'ws'),
                   '--profile', str(trace), '--no-metrics'] + SHORT,
                  device='cpu')
    with open(trace / 'first_epoch.pt.trace.json') as f:
        assert json.load(f)['traceEvents']


def test_prefetched_batches_are_moved_once(port_run):
    """_device_batch is idempotent: a batch it made (as PrefetchIterator's
    thread makes them) goes through it again without a copy."""
    trainer, dataset = port_run.trainer, port_run.dataset
    batch = trainer._device_batch(dataset._next_train())
    again = trainer._device_batch(batch)
    assert again.keys() == batch.keys()
    for key in batch:
        assert again[key].data_ptr() == batch[key].data_ptr()
        assert again[key].shape == batch[key].shape
    assert batch['direction_norms'].shape == (512, 1)


@pytest.mark.slow
def test_sphere_psnr_rises(scene, tmp_path):
    """300 iterations against 1, each from the same init: the held-out
    PSNR of the longer run is at least 3 dB higher."""
    argv = [scene, '--proposal', '--batch-size', '1024', '--num-steps', '32',
            '--factor-train', '1', '--factor-test', '1', '--eval']
    short = port_cli.main(argv + ['--iters', '1', '--workspace',
                                  str(tmp_path / 'a')], device='cpu')
    long = port_cli.main(argv + ['--iters', '300', '--workspace',
                                 str(tmp_path / 'b')], device='cpu')
    assert -10 * np.log10(long.eval_mse) > -10 * np.log10(short.eval_mse) + 3
