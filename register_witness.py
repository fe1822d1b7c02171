#!/usr/bin/env python3
"""Register frames of chip_smoke.py phase 16's room with the port, and hand
the same trained field to the JAX package's register CLI.

    python3 register_witness.py train OUT                  # on the card
    python3 register_witness.py unpack OUT ROOT            # on any host
    python3 register_witness.py register ROOT FRAME RAYS [--device cpu]
    python3 register_witness.py error ROOT FRAME T_CW.txt

`train` writes phase 16's room (16 frames of 160 x 120), trains it through
the train CLI with phase 16's flags and iterations, registers frames 3 and
8 from 5 degrees and 7 cm at 2,048 and 512 rays, and writes OUT/field.pkl:
the trained params without the rows that a dense level never reads, the
workspace's flags and name. `unpack` writes the room again under ROOT (it
is drawn without randomness; both commands print its md5) and the
workspace, ROOT/room/nerf/<name>, whose checkpoint either package reads.
`register` runs the port's register CLI on ROOT's workspace from 5
degrees and 7 cm and prints both errors. The JAX package's CLI takes the
same flags:

    python scripts/register.py ROOT/room --model-dir ROOT/room/nerf/<name>
        --frame-index 3 --rays 512 --perturb-deg 5 --perturb-cm 7
        --out T.txt

and `error` prints the errors of the T_CW it wrote.
"""
import argparse
import glob
import hashlib
import os
import pickle
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
PERTURB = ['--perturb-deg', '5', '--perturb-cm', '7']


def _room(root):
    import chip_smoke
    from autolabel_tpu_torch.utils import fixtures
    scene = os.path.join(root, 'room')
    fixtures.make_room_scene(scene, **chip_smoke.POSE_SCENE)
    digest = hashlib.md5()
    for path in sorted(glob.glob(os.path.join(scene, '*', '*'))):
        if os.path.isfile(path) and '/nerf/' not in path:
            digest.update(open(path, 'rb').read())
    print(f'room {scene}: md5 {digest.hexdigest()}')
    return scene


def _rows_read(config):
    """Rows of each level a point can read: (stride + 1)^3 on a dense
    level (its largest index is stride (1 + stride + stride^2)), all of
    a hashed one."""
    from autolabel_tpu_torch.ops import encoders
    _, strides, sizes, dense = encoders.level_geometry(config)
    return [int(min(size, (s + 1) ** 3)) if d else int(size)
            for s, size, d in zip(strides, sizes, dense)]


def errors(scene, frame, R, t):
    """(rotation error in degrees, translation error in m) of an ngp pose
    against the frame's own."""
    from autolabel_tpu_torch.core.dataset import SceneDataset
    ds = SceneDataset('test', scene, factor=1.0, batch_size=512, lazy=True,
                      load_semantic=False)
    R_gt = np.asarray(ds.rotations[frame], np.float64)
    t_gt = np.asarray(ds.origins[frame], np.float64)
    cos = (np.trace(np.asarray(R, np.float64) @ R_gt.T) - 1) / 2
    return (float(np.degrees(np.arccos(np.clip(cos, -1, 1)))),
            float(np.linalg.norm(np.asarray(t, np.float64) - t_gt)))


def register(scene, model_dir, frame, rays, device=None):
    from autolabel_tpu_torch import register as register_cli
    t0 = time.perf_counter()
    reg = register_cli.main([scene, '--model-dir', model_dir,
                             '--frame-index', str(frame), '--rays',
                             str(rays)] + PERTURB, device=device)
    before, after = (errors(scene, frame, reg.R0, reg.t0),
                     errors(scene, frame, reg.R, reg.t))
    print(f'port register frame {frame} rays {rays} ({device or "cuda"}): '
          f'rotation {before[0]:.4f} -> {after[0]:.4f} deg, translation '
          f'{before[1] * 100:.3f} -> {after[1] * 100:.3f} cm, loss '
          f'{reg.loss:.6f}, {time.perf_counter() - t0:.1f} s')


def train(out, device=None):
    import chip_smoke
    from autolabel_tpu_torch import model_utils
    from autolabel_tpu_torch.ops import _kernels
    from autolabel_tpu_torch.ops.encoders import TPU_GRID
    from autolabel_tpu_torch.train import __main__ as train_cli
    from autolabel_tpu_torch.train import checkpoints
    os.makedirs(out, exist_ok=True)
    if device is None:
        print(f'build: {_kernels.build_all():.1f} s')
    scene = _room(os.path.join(HERE, 'build', 'register_witness'))
    t0 = time.perf_counter()
    trained = train_cli.main([scene, '--iters',
                              str(chip_smoke.POSE_TRAIN_ITERS)]
                             + chip_smoke.POSE_TRAIN, device=device)
    print(f'trained {chip_smoke.POSE_TRAIN_ITERS} iterations '
          f'({" ".join(chip_smoke.POSE_TRAIN)}) in '
          f'{time.perf_counter() - t0:.1f} s')
    for frame in (3, 8):
        for rays in (2048, 512):
            register(scene, trained.model_dir, frame, rays, device)
    payload = checkpoints.load_checkpoint_file(checkpoints.find_checkpoint(
        os.path.join(trained.model_dir, 'checkpoints')))
    model = payload['model']
    grid = model['encoder']['grid']
    assert grid.shape == (TPU_GRID.n_levels, TPU_GRID.table_size,
                          TPU_GRID.n_features), grid.shape
    model['encoder']['grid'] = [grid[l, :k] for l, k in
                                enumerate(_rows_read(TPU_GRID))]
    with open(os.path.join(out, 'field.pkl'), 'wb') as f:
        pickle.dump(dict(model=model, step=payload['global_step'],
                         rows=grid.shape[1],
                         flags=model_utils.read_params(trained.model_dir),
                         name=os.path.basename(trained.model_dir)), f)
    print(f'wrote {out}/field.pkl')


def unpack(out, root):
    from autolabel_tpu_torch import model_utils
    from autolabel_tpu_torch.train import checkpoints
    scene = _room(root)
    with open(os.path.join(out, 'field.pkl'), 'rb') as f:
        field = pickle.load(f)
    levels = field['model']['encoder']['grid']
    grid = np.zeros((len(levels), field['rows'], levels[0].shape[1]),
                    np.float32)
    for l, rows in enumerate(levels):
        grid[l, :len(rows)] = rows
    field['model']['encoder']['grid'] = grid
    model_dir = os.path.join(scene, 'nerf', field['name'])
    model_utils.write_params(model_dir, field['flags'])
    checkpoints.save_checkpoint(
        os.path.join(model_dir, 'checkpoints', 'final.pth'),
        dict(params=field['model'], ema=field['model'], step=field['step']),
        include_optimizer=False)
    print(f'workspace {model_dir}')


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('mode', choices=('train', 'unpack', 'register',
                                         'error'))
    parser.add_argument('args', nargs='+')
    parser.add_argument('--device', default=None)
    a = parser.parse_args()
    if a.mode == 'train':
        train(a.args[0], a.device)
    elif a.mode == 'unpack':
        unpack(*a.args)
    elif a.mode == 'register':
        root, frame, rays = a.args
        scene = os.path.join(root, 'room')
        model_dir, = glob.glob(os.path.join(scene, 'nerf', '*'))
        register(scene, model_dir, int(frame), int(rays), a.device)
    else:
        from autolabel_tpu_torch.core.rays import convert_pose
        root, frame, path = a.args
        T = convert_pose(np.loadtxt(path))
        rot, t = errors(os.path.join(root, 'room'), int(frame), T[:3, :3],
                        T[:3, 3])
        print(f'{path}: rotation {rot:.4f} deg, translation '
              f'{t * 100:.3f} cm')


if __name__ == '__main__':
    main()
