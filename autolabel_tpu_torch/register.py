"""Register (localise) a camera frame against a trained scene: the register
CLI.

    python -m autolabel_tpu_torch.register <scene> --model-dir <scene>/nerf/<hash> [flags]

Counterpart of scripts/register.py, flag for flag: one SE(3) pose is
optimised through the frozen field (train/pose_refine.register_camera:
photometric plus, where the frame has sensor depth, a depth term; Adam
with cosine decay) from an initial guess (the frame's own pose, another
frame's, or a 4 x 4 T_CW pose file in the scene's pose/*.txt convention),
optionally perturbed by --perturb-deg / --perturb-cm for a demonstration.
Prints the loss, how far the pose moved and the refined T_CW, and writes
it to --out.

It runs on the card; tests call main([...], device='cpu'). Without cv2:
--image and --depth are read as PNGs (utils/images; any other format
raises, naming cv2); the image is resized to the scene camera as cv2.resize
does (bilinear, utils/images.resize_linear_cv2, within 1 of cv2's 8-bit
values) and the depth as cv2.INTER_NEAREST does; --perturb-deg rotates by
the ported rodrigues where the JAX CLI calls cv2.Rodrigues, on the same
rng.normal draws.
"""
import argparse
import os
import types

import numpy as np
import torch

from autolabel_tpu_torch import bridge, model_utils
from autolabel_tpu_torch.core.dataset import SceneDataset
from autolabel_tpu_torch.core.rays import (compute_directions, convert_pose,
                                           ngp_pose_to_scene)
from autolabel_tpu_torch.device import resolve_device
from autolabel_tpu_torch.mapping.ba import rodrigues
from autolabel_tpu_torch.render.renderer import RenderOptions
from autolabel_tpu_torch.train.pose_refine import register_camera
from autolabel_tpu_torch.utils import images as image_io


def read_args(argv=None):
    """scripts/register.py's flags; argv defaults to sys.argv[1:]."""
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('scene')
    parser.add_argument('--model-dir', type=str, required=True)
    parser.add_argument('--image', type=str, default=None,
                        help="External RGB frame to register (a PNG, "
                        "resized to the scene camera; assumes the scene "
                        "intrinsics). Default: use --frame-index from the "
                        "scene.")
    parser.add_argument('--depth', type=str, default=None,
                        help="Optional depth PNG (mm) for --image.")
    parser.add_argument('--frame-index', type=int, default=0,
                        help="Scene frame to register (ignored with "
                        "--image).")
    parser.add_argument('--init-frame', type=int, default=None,
                        help="Initialize from this scene frame's pose "
                        "(default: the registered frame's own pose, or "
                        "frame 0 for --image).")
    parser.add_argument('--init-pose', type=str, default=None,
                        help="Initialize from a 4x4 T_CW pose file "
                        "(scene pose/*.txt convention); overrides "
                        "--init-frame.")
    parser.add_argument('--perturb-deg', type=float, default=0.0,
                        help="Demo/eval: rotate the init away by this "
                        "many degrees before registering.")
    parser.add_argument('--perturb-cm', type=float, default=0.0,
                        help="Demo/eval: translate the init away by this "
                        "many centimeters (ngp units ~ meters).")
    parser.add_argument('--rays', type=int, default=2048)
    parser.add_argument('--iters', type=int, default=400)
    parser.add_argument('--lr', type=float, default=3e-3)
    parser.add_argument('--num-steps', type=int, default=64)
    parser.add_argument('--proposal-steps', type=int, default=32)
    parser.add_argument('--no-depth', action='store_true',
                        help="Photometric-only (skip the depth term even "
                        "when sensor depth exists).")
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--out', type=str, default=None,
                        help="Write the refined 4x4 T_CW here "
                        "(default: print only).")
    return parser.parse_args(argv)


def _read_png(path):
    if not image_io.is_png(path):
        raise RuntimeError(f'{path} is not a PNG: reading other formats '
                           'needs cv2 (scripts/register.py), which the port '
                           'does not use')
    return image_io.read_png(path)


def _load_external(flags, dataset):
    """The --image frame (and --depth map) at the scene camera's size, as
    scripts/register.py's cv2 reads and resizes them: rgb (H W, 3) in [0,
    1], depth (H W,) in meters or None."""
    w, h = dataset.camera.size
    rgb = _read_png(flags.image)
    if rgb.ndim == 2:
        rgb = np.repeat(rgb[..., None], 3, axis=2)
    rgb = rgb[..., :3]
    if rgb.dtype != np.uint8:
        raise ValueError(f'{flags.image}: an 8-bit image is expected')
    rgb = image_io.resize_linear_cv2(rgb, (w, h)).reshape(-1, 3)
    rgb = rgb.astype(np.float32) / 255.0
    depth = None
    if flags.depth is not None:
        d = image_io.resize_nearest_cv2(_read_png(flags.depth), (w, h))
        depth = d.reshape(-1).astype(np.float32) / 1000.0
    return rgb, depth


def main(argv=None, device=None):
    """Register one frame as scripts/register.py does. device: None (the
    card; raises without one) or a torch device ('cpu' in the tests).
    Returns a namespace of the refined (R, t) in the ngp frame, the
    initial (R0, t0), the final loss and T_CW."""
    flags = read_args(argv)
    device = resolve_device(device)
    model_params = model_utils.read_params(flags.model_dir)
    dataset = SceneDataset('test', flags.scene, factor=1.0, batch_size=512,
                           lazy=True, load_semantic=False)
    n_classes = dataset.n_classes if dataset.n_classes is not None else 2
    field = model_utils.create_model(dataset.min_bounds, dataset.max_bounds,
                                     n_classes, model_params, device=device)
    field, params, _ = model_utils.load_into_field(
        field, os.path.join(flags.model_dir, 'checkpoints'))
    bridge.load_params(field, params)

    if flags.image is not None:
        pixels_flat, depth_flat = _load_external(flags, dataset)
        default_init = 0
    else:
        f = flags.frame_index
        pixels_flat = np.asarray(dataset.images[f]).reshape(-1, 3)
        if pixels_flat.max() > 1.5:
            pixels_flat = pixels_flat.astype(np.float32) / 255.0
        depth_flat = (np.asarray(dataset.depths[f]).reshape(-1)
                      .astype(np.float32) / 1000.0)
        default_init = f

    # Initial pose (ngp frame: R cam->world, t camera center).
    if flags.init_pose is not None:
        T = convert_pose(np.loadtxt(flags.init_pose))
        R0, t0 = T[:3, :3].copy(), T[:3, 3].copy()
    else:
        init = flags.init_frame if flags.init_frame is not None \
            else default_init
        R0 = np.array(dataset.rotations[init])
        t0 = np.array(dataset.origins[init])

    rng = np.random.default_rng(flags.seed)
    if flags.perturb_deg > 0:
        axis = rng.normal(size=3)
        axis *= np.radians(flags.perturb_deg) / np.linalg.norm(axis)
        R0 = R0 @ rodrigues(torch.as_tensor(axis)).numpy()
    if flags.perturb_cm > 0:
        off = rng.normal(size=3)
        t0 = t0 + off / np.linalg.norm(off) * (flags.perturb_cm / 100.0)

    idx = rng.choice(dataset.resolution, size=min(flags.rays,
                                                  dataset.resolution),
                     replace=False)
    dirs_cam, norms = compute_directions(np.eye(3), idx, dataset.w,
                                         dataset.camera.fx,
                                         dataset.camera.fy,
                                         dataset.camera.cx,
                                         dataset.camera.cy)
    pixels = pixels_flat[idx]
    depth = None
    if depth_flat is not None and not flags.no_depth:
        depth = depth_flat[idx]

    R1, t1, loss = register_camera(
        field, pixels, dirs_cam, norms, R0, t0,
        options=RenderOptions(num_steps=flags.num_steps,
                              proposal_steps=(flags.proposal_steps
                                              if field.config.proposal
                                              else 0),
                              perturb=False),
        iters=flags.iters, lr=flags.lr, depth=depth)

    T_ngp = np.eye(4)
    T_ngp[:3, :3] = R1
    T_ngp[:3, 3] = t1
    T_CW = ngp_pose_to_scene(T_ngp)
    rot_moved = np.degrees(np.arccos(np.clip(
        (np.trace(R1 @ R0.T) - 1) / 2, -1, 1)))
    print(f"registered: loss={loss:.5f} moved {rot_moved:.2f} deg / "
          f"{np.linalg.norm(t1 - t0) * 100:.1f} cm from the init")
    print(T_CW)
    if flags.out is not None:
        np.savetxt(flags.out, T_CW)
        print(f"T_CW (scene pose convention) -> {flags.out}")
    return types.SimpleNamespace(R=R1, t=t1, R0=R0, t0=t0, loss=loss,
                                 T_CW=T_CW)


if __name__ == '__main__':
    main()
