"""Fused RGB point cloud from a trained field.

    python -m autolabel_tpu_torch.language.pointcloud <scene> --out cloud.ply

Counterpart of scripts/language/pointcloud.py, with its flags: renders
every --stride-th test frame at factor 4, keeps each frame's points whose
depth variance lies below the frame's median (the confident surface
crossings) and writes them with their colours as a binary PLY
(utils.ply.write_ply_pointcloud).

It runs on the card; tests call main([...], device='cpu').
"""
import argparse
import os
import sys

import numpy as np

from autolabel_tpu_torch import model_utils
from autolabel_tpu_torch.core.dataset import SceneDataset
from autolabel_tpu_torch.device import resolve_device
from autolabel_tpu_torch.inference import InferenceModel
from autolabel_tpu_torch.utils.ply import write_ply_pointcloud

SCANNET_N_CLASSES = 606


def read_args(argv=None):
    """scripts/language/pointcloud.py's flags; argv defaults to
    sys.argv[1:]."""
    parser = argparse.ArgumentParser()
    parser.add_argument('scene')
    parser.add_argument('--batch-size', default=8182, type=int)
    parser.add_argument('--workspace', type=str, default=None)
    parser.add_argument('--out',
                        type=str,
                        help="Resulting pointcloud path.",
                        required=True)
    parser.add_argument('--feature-checkpoint', '-f', type=str, default=None)
    parser.add_argument(
        '--stride',
        type=int,
        default=1,
        help="Only evaluate every Nth frame to save time or for debugging.")
    parser.add_argument('--vis', action='store_true')
    parser.add_argument('--features', type=str, default='lseg')
    parser.add_argument('--num-steps', type=int, default=512)
    return parser.parse_args(argv)


def get_nerf_dir(scene, flags):
    scene_name = os.path.basename(os.path.normpath(scene))
    if flags.workspace is None:
        return os.path.join(scene, 'nerf')
    return os.path.join(flags.workspace, scene_name)


def get_model(flags, scene_dir):
    nerf_dir = get_nerf_dir(scene_dir, flags)
    for model in os.listdir(nerf_dir):
        if os.path.exists(os.path.join(nerf_dir, model, 'checkpoints')):
            return model


def render(model, batch):
    """Returns confident surface points + colors for one frame."""
    output = model.render(batch)
    variance = output['depth_variance']
    mask = variance < np.percentile(variance, 50)
    points = output['coordinates_map'][mask]
    rgb = np.clip(output['image'][mask], 0.0, 1.0)
    return points[:, :3], rgb


def main(argv=None, device=None):
    """Write the point cloud as scripts/language/pointcloud.py does.
    device: None (the card; raises without one) or a torch device ('cpu'
    in the tests)."""
    flags = read_args(argv)
    device = resolve_device(device)
    scene = flags.scene
    scene_name = os.path.basename(os.path.normpath(scene))
    print(f"Evaluating scene {scene_name}")
    nerf_dir = get_nerf_dir(scene, flags)
    model_hash = get_model(flags, scene)
    model_path = os.path.join(nerf_dir, model_hash)
    params = model_utils.read_params(model_path)
    dataset = SceneDataset('test',
                           scene,
                           factor=4.0,
                           batch_size=flags.batch_size,
                           lazy=True)

    field = model_utils.create_model(dataset.min_bounds, dataset.max_bounds,
                                     SCANNET_N_CLASSES, params,
                                     device=device)
    checkpoint_dir = os.path.join(model_path, 'checkpoints')
    if (not os.path.exists(checkpoint_dir)
            or len(os.listdir(checkpoint_dir)) == 0):
        print("No checkpoint path")
        sys.exit(1)
    model = InferenceModel.from_checkpoint(field, model_path,
                                           num_steps=flags.num_steps,
                                           max_ray_batch=flags.batch_size)

    points, colors = [], []
    for frame_index in dataset.indices[::flags.stride]:
        batch = dataset._get_test(frame_index)
        points_W, rgb = render(model, batch)
        points.append(points_W)
        colors.append(rgb)
    write_ply_pointcloud(flags.out, np.concatenate(points),
                         np.concatenate(colors))


if __name__ == "__main__":
    main()
