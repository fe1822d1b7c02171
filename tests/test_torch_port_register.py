"""The register CLI and the train CLI's joint pose refinement end to end
on the CPU, against scripts/register.py and the JAX package.

A room scene of 6 frames at 48 x 36 is trained by the port's train CLI for
a few iterations (TPU_GRID shrunk to 2 levels x 8 features x 2^10 rows in
both packages, as in test_torch_port_backend). Then the port's register
CLI runs beside scripts/register.py at --iters 5 on the same workspace
(where cv2 is installed; only that comparison skips without it), the
external-frame path reads PNGs as cv2 does, and the train CLI's
--pose-refine-experimental writes poses_refined.npz with frame 0 pinned.
"""
import importlib
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from autolabel_tpu.ops import encoders as jax_encoders
from autolabel_tpu.train import checkpoints as jax_checkpoints
from autolabel_tpu.train import pose_refine as jax_pose_refine
from autolabel_tpu_torch import model_utils, register
from autolabel_tpu_torch.core.dataset import SceneDataset
from autolabel_tpu_torch.mapping.ba import rodrigues
from autolabel_tpu_torch.ops import encoders
from autolabel_tpu_torch.train import __main__ as train_cli
from autolabel_tpu_torch.utils import fixtures
from autolabel_tpu_torch.utils import images

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_GRID = dict(n_levels=2, n_features=8, log2_hashmap_size=10,
                  base_resolution=8, per_level_scale=1.6)
TRAIN = ['--iters', '12', '--batch-size', '512', '--factor-train', '1',
         '--num-steps', '16', '--proposal', '--no-metrics']
REGISTER = ['--frame-index', '2', '--perturb-deg', '2', '--perturb-cm', '3',
            '--rays', '256', '--iters', '5', '--num-steps', '16',
            '--proposal-steps', '16']


@pytest.fixture(scope='module', autouse=True)
def _small_grid():
    """One torch thread and the small grid in both packages for the whole
    module, the workspace's training included: a model trained at another
    thread count sums in another order and differs in its last bits."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_encoders, 'TPU_GRID',
               jax_encoders.HashGridConfig(**SMALL_GRID))
    mp.setattr(model_utils, 'TPU_GRID', encoders.HashGridConfig(**SMALL_GRID))
    yield
    mp.undo()
    torch.set_num_threads(threads)


def _train(root, seed=0):
    """(scene, model dir): the room scene under root, trained by the
    port's train CLI, the same model in every run at a seed: the dataset's
    draws (its rng and its class-balanced sampler's, unseeded in the CLI)
    are seeded."""
    scene = os.path.join(str(root), 'room')
    fixtures.make_room_scene(scene, n_frames=6, width=48, height=36,
                             label_every=2)
    init = SceneDataset.__init__

    def seeded(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.rng = np.random.default_rng(seed)
        self.index_sampler.random_state = np.random.RandomState(seed)

    mp = pytest.MonkeyPatch()
    mp.setattr(SceneDataset, '__init__', seeded)
    try:
        run = train_cli.main([scene] + TRAIN, device='cpu')
    finally:
        mp.undo()
    return scene, run.model_dir


@pytest.fixture(scope='module')
def workspace(tmp_path_factory):
    return _train(tmp_path_factory.mktemp('register'))


def _nudged(direction, what='t0'):
    """scripts/register.py's register_camera with the init's t0 or R0
    moved one fp32 ulp towards +inf (direction 1) or -inf (-1): a change
    of every ray at the level of its rounding."""
    inner = jax_pose_refine.register_camera

    def register_camera(field, params, pixels, dirs_cam, norms, R0, t0,
                        *args, **kwargs):
        init = {'R0': R0, 't0': t0}
        init[what] = np.nextafter(np.asarray(init[what], np.float32),
                                  np.float32(direction * np.inf))
        return inner(field, params, pixels, dirs_cam, norms, init['R0'],
                     init['t0'], *args, **kwargs)
    return register_camera


def _pose_and_loss(out, log):
    return np.loadtxt(out), float(log.split('loss=')[1].split()[0])


# Where the two CLIs part beyond 2e-5 in T_CW or 1e-4 in the loss, the
# port is held within this factor of JAX's own spread: scripts/register.py
# against itself with the init's t0 one fp32 ulp up and one down. The
# loss is not smooth in the pose (a sample that crosses a cell or a
# proposal bin moves the gradient by a step), so rays that differ in their
# last bits can take the two CLIs to two sides of such a step: on one model
# of 30 the gradient of the second iteration parted by 40% in one
# coordinate, at poses equal to an ulp, and JAX went to the port's side
# when its pose moved by 1e-5 of itself. `python -m
# tests.test_torch_port_register` measures the spread and the port's
# distance on 30 models (seeds 0-9 trained at 1, 2 and 4 threads): the
# port lay at 0.00-1.37 times JAX's largest move under t0 or R0 one ulp up
# or down, and where it parted beyond 2e-5 (2.763e-4), JAX with t0 one ulp
# down moved just as far.
SPREAD_ROOM = 4.0


def _scripts_register(monkeypatch, argv):
    monkeypatch.syspath_prepend(os.path.join(REPO, 'scripts'))
    sys.modules.pop('register', None)
    module = importlib.import_module('register')
    monkeypatch.setattr(sys, 'argv', ['register.py'] + argv)
    module.main()
    return module


def test_register_cli_matches_scripts_register(workspace, tmp_path,
                                               monkeypatch, capsys):
    """Both CLIs on the same workspace, frame, perturbation and rays at
    --iters 5: the perturbed init equal to cv2.Rodrigues's within 1e-6
    (the unnormalised form against cv2's, in float64), the written T_CW
    within 2e-5 (Adam's first steps move each coordinate by about the
    lr, 3e-3, whatever the gradient's size, so the two agree to fp32
    rounding unless the loss's steps part them: see SPREAD_ROOM) and the
    loss within 1e-4; or, each of the two, within SPREAD_ROOM times JAX's
    own move when the init's t0 moves one ulp up or down."""
    cv2 = pytest.importorskip('cv2')
    scene, model_dir = workspace
    runs = ('ours', 'ref', 'up', 'down')
    outs = {k: str(tmp_path / f'{k}.txt') for k in runs}
    ours = register.main([scene, '--model-dir', model_dir, '--out',
                          outs['ours']] + REGISTER, device='cpu')
    logs = {'ours': capsys.readouterr().out}
    for k, direction in (('ref', 0), ('up', 1), ('down', -1)):
        with monkeypatch.context() as m:
            if direction:
                m.setattr(jax_pose_refine, 'register_camera',
                          _nudged(direction))
            _scripts_register(m, [scene, '--model-dir', model_dir, '--out',
                                  outs[k]] + REGISTER)
        logs[k] = capsys.readouterr().out
    # the init: the same rng draws, cv2.Rodrigues in the JAX CLI
    ds = SceneDataset('test', scene, factor=1.0, batch_size=512, lazy=True,
                      load_semantic=False)
    rng = np.random.default_rng(0)
    axis = rng.normal(size=3)
    axis *= np.radians(2.0) / np.linalg.norm(axis)
    np.testing.assert_allclose(
        ours.R0, np.array(ds.rotations[2]) @ cv2.Rodrigues(axis)[0],
        atol=1e-6)
    T, loss = zip(*(_pose_and_loss(outs[k], logs[k]) for k in runs))
    pose_err = np.abs(T[0] - T[1]).max()
    pose_spread = max(np.abs(t - T[1]).max() for t in T[2:])
    assert pose_err <= max(2e-5, SPREAD_ROOM * pose_spread), \
        (pose_err, pose_spread)
    loss_err = abs(loss[0] - loss[1]) / abs(loss[1])
    loss_spread = max(abs(v - loss[1]) for v in loss[2:]) / abs(loss[1])
    assert loss_err <= max(1e-4, SPREAD_ROOM * loss_spread), \
        (loss_err, loss_spread)
    assert logs['ours'].split('\n')[0].split(' moved')[1] == \
        logs['ref'].split('\n')[0].split(' moved')[1]


def test_register_cli_takes_its_init_and_writes_the_pose(workspace,
                                                         tmp_path):
    """--init-pose (a scene T_CW file) sets the init; the written T_CW is a
    rotation and maps back near the init; the returned pose matches the
    file."""
    scene, model_dir = workspace
    pose_file = os.path.join(scene, 'pose', sorted(
        os.listdir(os.path.join(scene, 'pose')))[3])
    out = str(tmp_path / 'pose.txt')
    run = register.main([scene, '--model-dir', model_dir, '--init-pose',
                         pose_file, '--rays', '128', '--iters', '2',
                         '--num-steps', '8', '--proposal-steps', '8',
                         '--no-depth', '--out', out], device='cpu')
    T_CW = np.loadtxt(out)
    np.testing.assert_allclose(T_CW, run.T_CW, atol=1e-12)
    R = T_CW[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    np.testing.assert_allclose(T_CW, np.loadtxt(pose_file), atol=0.05)
    assert np.isfinite(run.loss)


def test_register_cli_reads_external_pngs_as_cv2(workspace, tmp_path,
                                                 monkeypatch):
    """--image and --depth: PNGs of another size read and resized as
    scripts/register.py's cv2 does (rgb bilinear within 1 of cv2's 8-bit
    values, depth nearest bit-equal); a file that is not a PNG raises,
    naming cv2."""
    scene, model_dir = workspace
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)
    depth = rng.integers(0, 4000, (60, 80)).astype(np.uint16)
    image, depth_path = str(tmp_path / 'f.png'), str(tmp_path / 'd.png')
    images.write_png(image, rgb)
    images.write_png(depth_path, depth)
    flags = register.read_args([scene, '--model-dir', model_dir, '--image',
                                image, '--depth', depth_path])
    run = register.main([scene, '--model-dir', model_dir, '--image', image,
                         '--depth', depth_path, '--rays', '64', '--iters',
                         '1', '--num-steps', '8', '--proposal-steps', '8'],
                        device='cpu')
    assert np.isfinite(run.loss)
    jpeg = str(tmp_path / 'f.jpg')
    with open(jpeg, 'wb') as f:
        f.write(b'\xff\xd8\xff\xe0 not a png')
    with pytest.raises(RuntimeError, match='cv2'):
        register.main([scene, '--model-dir', model_dir, '--image', jpeg],
                      device='cpu')
    pytest.importorskip('cv2')  # the comparison alone needs it
    ds = SceneDataset('test', scene, factor=1.0, batch_size=512, lazy=True,
                      load_semantic=False)
    ours_rgb, ours_depth = register._load_external(flags, ds)
    monkeypatch.syspath_prepend(os.path.join(REPO, 'scripts'))
    sys.modules.pop('register', None)
    ref_rgb, ref_depth = importlib.import_module('register')._load_external(
        flags, ds)
    assert float(np.abs(ours_rgb - ref_rgb).max()) <= 1.0 / 255 + 1e-7
    np.testing.assert_array_equal(ours_depth, ref_depth)


def test_perturbation_uses_the_ported_rodrigues():
    """The --perturb-deg rotation: rodrigues of the same axis as
    cv2.Rodrigues gives, to float64 rounding."""
    cv2 = pytest.importorskip('cv2')
    axis = np.random.default_rng(4).normal(size=3)
    axis *= np.radians(5.0) / np.linalg.norm(axis)
    np.testing.assert_allclose(rodrigues(torch.as_tensor(axis)).numpy(),
                               cv2.Rodrigues(axis)[0], atol=1e-12)


def test_train_cli_refines_poses_jointly(workspace, tmp_path):
    """python -m autolabel_tpu_torch.train --pose-refine-experimental:
    the window phases entered, poses_refined.npz written (R, t, the
    frames' stems) with frame 0 pinned to its pose and the others moved
    and finite; the checkpoint's 'pose' entry read by the JAX package."""
    scene, _ = workspace
    ws = str(tmp_path / 'ws')
    run = train_cli.main([scene, '--workspace', ws, '--iters', '40',
                          '--pose-refine-experimental'] + TRAIN[2:],
                         device='cpu')
    trainer = run.trainer
    assert [o.level_window for _, o in trainer.phases] == [
        (1.0, 0.0), (1.0, 1.0), None]
    assert [s for s, _ in trainer.phases] == [0, 10, 20]
    saved = np.load(os.path.join(run.model_dir, 'poses_refined.npz'))
    R0 = np.asarray(run.dataset.rotations)
    t0 = np.asarray(run.dataset.origins)
    assert saved['R'].shape == R0.shape and saved['t'].shape == t0.shape
    np.testing.assert_allclose(saved['R'][0], R0[0], atol=1e-6)
    np.testing.assert_allclose(saved['t'][0], t0[0], atol=1e-6)
    assert np.isfinite(saved['R']).all() and np.isfinite(saved['t']).all()
    assert np.abs(saved['t'][1:] - t0[1:]).max() > 0
    stems = [os.path.basename(p).split('.')[0]
             for p in run.dataset.scene.rgb_paths()]
    assert list(saved['frames']) == [stems[i] for i in run.dataset.indices]
    payload = jax_checkpoints.load_checkpoint(
        os.path.join(run.model_dir, 'checkpoints'))
    np.testing.assert_array_equal(
        payload['model']['pose']['t'],
        trainer.pose['t'].detach().numpy())


def spread_study(work, seeds=range(10), threads=(1, 2, 4)):
    """On models trained at each dataset seed and torch thread count (a
    model trained at another count differs in its last bits): the port's
    register CLI against scripts/register.py, and scripts/register.py
    against itself with the init's t0, then its R0, one fp32 ulp up and
    one down, each CLI at one torch thread; prints each one's largest T_CW
    difference and relative loss difference from JAX's run on the
    unchanged init."""
    import contextlib
    import io
    import itertools
    shutil.rmtree(work, ignore_errors=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_encoders, 'TPU_GRID',
               jax_encoders.HashGridConfig(**SMALL_GRID))
    mp.setattr(model_utils, 'TPU_GRID', encoders.HashGridConfig(**SMALL_GRID))
    nudges = {'t0 up': (1, 't0'), 't0 down': (-1, 't0'), 'R0 up': (1, 'R0'),
              'R0 down': (-1, 'R0')}
    for seed, count in itertools.product(seeds, threads):
        root = os.path.join(work, f'{seed}_{count}')
        torch.set_num_threads(count)
        with contextlib.redirect_stdout(io.StringIO()):
            scene, model_dir = _train(root, seed)
        torch.set_num_threads(1)
        runs = {}
        for k in ['ref', 'port', *nudges]:
            out, log = os.path.join(root, f'{k}.txt'), io.StringIO()
            argv = [scene, '--model-dir', model_dir, '--out', out] + REGISTER
            with contextlib.redirect_stdout(log), mp.context() as m:
                if k == 'port':
                    register.main(argv, device='cpu')
                else:
                    if k in nudges:
                        m.setattr(jax_pose_refine, 'register_camera',
                                  _nudged(*nudges[k]))
                    _scripts_register(m, argv)
            runs[k] = _pose_and_loss(out, log.getvalue())
        T0, loss0 = runs['ref']
        print(f'seed {seed}, trained at {count} threads: ' + '; '.join(
            f'{k} T_CW {np.abs(runs[k][0] - T0).max():.3e} loss '
            f'{abs(runs[k][1] - loss0) / abs(loss0):.3e}'
            for k in ['port', *nudges]), flush=True)
    mp.undo()


if __name__ == '__main__':
    # python -m tests.test_torch_port_register [work dir]
    spread_study(sys.argv[1] if len(sys.argv) > 1
                 else os.path.join('build', 'register_spread'))
