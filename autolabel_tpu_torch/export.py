"""Export dense semantic segmentation maps from trained scenes.

    python -m autolabel_tpu_torch.export <scene1> <scene2> ... [--workspace ws]

Counterpart of scripts/export.py, with its flags: each scene's (first)
trained model renders every frame at most 640 pixels wide, the argmax of
its semantic head is optionally cut to the --objects largest connected
components per class (scipy.ndimage.label, as the JAX CLI), and the maps
are written as 8-bit PNGs (utils.images.write_png, whose pixels decode
equal to cv2.imwrite's) to <scene>/output/semantic/<frame>.png.

It runs on the card; tests call main([...], device='cpu').
"""
import os

import numpy as np
from scipy import ndimage

from autolabel_tpu_torch import model_utils
from autolabel_tpu_torch.core.dataset import SceneDataset
from autolabel_tpu_torch.device import resolve_device
from autolabel_tpu_torch.inference import InferenceModel
from autolabel_tpu_torch.utils import Scene
from autolabel_tpu_torch.utils.images import write_png

MAX_WIDTH = 640


def read_args(argv=None):
    """scripts/export.py's flags; argv defaults to sys.argv[1:]."""
    parser = model_utils.model_flag_parser()
    parser.add_argument('scenes', nargs='+')
    parser.add_argument('--workspace', type=str)
    parser.add_argument('--objects',
                        type=int,
                        default=None,
                        help="""
            If specified, find the specified number of largest connected
            components per class in the produced semantic maps as a
            post-processing step, removing noise from the maps.""")
    parser.add_argument('--num-steps', type=int, default=512)
    return parser.parse_args(argv)


def lookup_frame_size(scene):
    width, height = Scene(scene).peak_image_size()
    if width > MAX_WIDTH:
        scale = MAX_WIDTH / width
        width *= scale
        height *= scale
    return (int(np.round(width)), int(np.round(height)))


def find_largest_components(p_semantic, class_id, object_count):
    mask = (p_semantic == class_id).astype(np.int32)
    labels, n = ndimage.label(mask)
    if n == 0:
        return []
    counts = np.bincount(labels.ravel())[1:]
    order = np.argsort(counts)[::-1]
    return [labels == (order[i] + 1) for i in range(min(object_count, n))]


def post_process(flags, p_semantic):
    out = np.zeros_like(p_semantic)
    for class_id in np.unique(p_semantic):
        if class_id == 0:
            continue  # background
        for component in find_largest_components(p_semantic, class_id,
                                                 flags.objects):
            out[component] = class_id
    return out


def export_labels(flags, scene, device):
    scene = scene.rstrip(os.path.sep)
    scene_name = os.path.basename(scene)
    if flags.workspace is not None:
        model_dir = os.path.join(flags.workspace, scene_name)
    else:
        model_dir = os.path.join(scene, 'nerf')
    models = os.listdir(model_dir) if os.path.exists(model_dir) else []
    if len(models) > 1:
        print(f"Warning: scene {scene} has more than 1 model directory. "
              f"Using {models[0]}.")
    elif len(models) == 0:
        print(f"Warning: scene {scene} has no trained models. Skipping.")
        return
    model_dir = os.path.join(model_dir, models[0])
    model_params = model_utils.read_params(model_dir)

    dataset = SceneDataset('train',
                           scene,
                           size=lookup_frame_size(scene),
                           batch_size=16384,
                           features=model_params.features,
                           load_semantic=False)

    n_classes = dataset.n_classes if dataset.n_classes is not None else 2
    field = model_utils.create_model(dataset.min_bounds, dataset.max_bounds,
                                     n_classes, model_params, device=device)
    model = InferenceModel.from_checkpoint(field, model_dir,
                                           num_steps=flags.num_steps,
                                           max_ray_batch=16384)

    output_path = os.path.join(scene, 'output', 'semantic')
    os.makedirs(output_path, exist_ok=True)

    for frame_index, rgb_path in zip(dataset.indices,
                                     dataset.scene.rgb_paths()):
        batch = dataset._get_test(frame_index)
        frame = model.render(batch)['semantic'].argmax(axis=-1)
        if flags.objects is not None:
            frame = post_process(flags, frame)
        frame_name = os.path.splitext(os.path.basename(rgb_path))[0]
        write_png(os.path.join(output_path, f"{frame_name}.png"),
                  frame.astype(np.uint8))


def main(argv=None, device=None):
    """Export as scripts/export.py does. device: None (the card; raises
    without one) or a torch device ('cpu' in the tests)."""
    flags = read_args(argv)
    device = resolve_device(device)
    for scene in flags.scenes:
        export_labels(flags, scene, device)


if __name__ == "__main__":
    main()
