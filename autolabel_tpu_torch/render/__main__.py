"""Render a trained scene to a 2x2-tiled video (rgb | depth / semantic |
feature PCA): the render CLI.

    python -m autolabel_tpu_torch.render <scene> --model-dir <dir> --out <mp4>

Counterpart of scripts/render.py, with exactly its flags: it reads a
workspace that either package's train CLI wrote (params.pkl and the
checkpoint of the model-hash directory), renders the test split's frames
(every --stride-th) at --size through InferenceModel (dense, 512 samples
a ray by default, or 32 placed by the proposal net with --proposal) or,
with --baked, from a splat cache baked once (render/baked.py), and writes
960 x 720 tiles to an mp4.

`frames(flags, device)` yields (index, tile) for each frame and `main`
writes them; the tiles need neither cv2 nor matplotlib (utils.images'
copy of cv2's nearest resize, the port's own colormaps). Packages the
port does not depend on are imported at the call that needs them, and
raise there naming what is missing: the mp4 writer needs cv2; a scene
trained with --features needs h5py for its features.hdf and sklearn for
the pickled PCA of the feature tile; --label-map needs pandas. --classes
and --label-map encode text with the scene's teacher through the port's
dispatch (--checkpoint: DemoCLIP's .npz or LSeg's weights; the stand-ins
only with --allow-fallback).

It runs on the card; tests call main([...], device='cpu').
"""
import os
import time

import numpy as np

from autolabel_tpu_torch import model_utils, visualization
from autolabel_tpu_torch.constants import COLORS
from autolabel_tpu_torch.core.dataset import SceneDataset
from autolabel_tpu_torch.device import resolve_device
from autolabel_tpu_torch.features.feature_utils import get_feature_extractor
from autolabel_tpu_torch.inference import InferenceModel
from autolabel_tpu_torch.utils import require
from autolabel_tpu_torch.utils.images import resize_nearest_cv2

TILE = (960, 720)  # the video's frame (width, height), whatever --size is
MAX_RAY_BATCH = 16384


def read_args(argv=None):
    """scripts/render.py's flags and defaults; argv defaults to
    sys.argv[1:]."""
    parser = model_utils.model_flag_parser()
    parser.add_argument('scene')
    parser.add_argument('--fps', type=int, default=5)
    parser.add_argument('--stride', type=int, default=1)
    parser.add_argument('--model-dir', type=str, required=True)
    parser.add_argument(
        '--max-depth',
        type=float,
        default=7.5,
        help="The maximum depth used in colormapping the depth frames.")
    parser.add_argument('--checkpoint', type=str)
    parser.add_argument('--allow-fallback', action='store_true',
                        help="Permit stand-in text embeddings when "
                        "teacher weights are unavailable (testing).")
    parser.add_argument('--out',
                        type=str,
                        required=True,
                        help="Where to save the video.")
    parser.add_argument('--classes',
                        default=None,
                        type=str,
                        nargs='+',
                        help="Which classes to segment the scene into.")
    parser.add_argument('--label-map',
                        default=None,
                        type=str,
                        help="Path to list of labels.")
    parser.add_argument('--num-steps', type=int, default=None,
                        help="Volumetric samples per ray. Default 512, or "
                        "32 main samples when --proposal is set (the "
                        "proposal net places them); the CLI prints a "
                        "wall-clock estimate after the first frame.")
    parser.add_argument('--size', type=int, nargs=2, default=(480, 360),
                        help="Render resolution (width height).")
    parser.add_argument('--baked', action='store_true',
                        help="Render from a baked surface-splat cache "
                        "(render/baked.py) instead of the volumetric "
                        "path: one bake sweep up front, then every frame "
                        "is a projection and z-buffer scatter. "
                        "Preview-grade: canonical-view color, no "
                        "feature-PCA tile.")
    parser.add_argument('--bake-resolution', type=int, default=192,
                        help="Bake grid resolution per axis (--baked).")
    parser.add_argument('--max-splats', type=int, default=2 ** 19,
                        help="Splat budget of the baked cache (--baked).")
    return parser.parse_args(argv)


class FeatureTransformer:
    """PCA visualisation and text features from the features.hdf attrs
    contract (the features' pickled PCA, min and range)."""

    def __init__(self, scene_path, feature_name, classes, checkpoint=None,
                 allow_fallback=False, device=None):
        import pickle
        h5py = require('h5py', 'the feature tile (features.hdf)')
        with h5py.File(os.path.join(scene_path, 'features.hdf'), 'r') as f:
            features = f[f'features/{feature_name}']
            try:
                self.pca = pickle.loads(features.attrs['pca'].tobytes())
            except ImportError as e:
                raise RuntimeError('the feature tile needs sklearn to read '
                                   'its pickled PCA, which is not '
                                   'installed') from e
            self.feature_min = features.attrs['min']
            self.feature_range = features.attrs['range']
        self.text_features = None
        if classes is not None:
            extractor = get_feature_extractor(
                feature_name, checkpoint, allow_fallback=allow_fallback,
                device=device)
            self.text_features = extractor.encode_text(classes)

    def __call__(self, p_features):
        H, W, C = p_features.shape
        features = self.pca.transform(p_features.reshape(H * W, C))
        features = np.clip(
            (features - self.feature_min) / self.feature_range, 0.0, 1.0)
        return (features.reshape(H, W, 3) * 255.0).astype(np.uint8)


def compute_semantics(outputs, classes, feature_transform):
    """Class ids per pixel: the argmax of the text similarities with
    `classes`, else of the semantic head's logits."""
    if classes is not None:
        features = outputs['semantic_features']
        features = features / np.maximum(
            np.linalg.norm(features, axis=-1, keepdims=True), 1e-9)
        text = feature_transform.text_features[:, :features.shape[-1]]
        H, W, D = features.shape
        similarities = features.reshape(H * W, D) @ text.T
        return similarities.argmax(-1).reshape(H, W)
    return outputs['semantic'].argmax(axis=-1)


def _tile(size, image, depth, semantic, maxdepth, features=None):
    """The 2x2 tile: rgb | depth / semantic | feature PCA (black when
    None), each quadrant resized by cv2's nearest rule."""
    frame = np.zeros((size[1], size[0], 3), dtype=np.uint8)
    sw, sh = size[0] // 2, size[1] // 2

    def fit(img):
        return resize_nearest_cv2(img, (sw, sh))

    frame[:sh, :sw] = fit((np.clip(image, 0, 1) * 255.0).astype(np.uint8))
    frame[:sh, sw:] = fit(visualization.visualize_depth(depth,
                                                        maxdepth=maxdepth))
    frame[sh:, :sw] = fit(
        (COLORS[semantic % COLORS.shape[0]] * 255).astype(np.uint8))
    if features is not None:
        frame[sh:, sw:] = fit(features)
    return frame


def render(model, batch, feature_transform, size=TILE, maxdepth=10.0,
           classes=None):
    """The tile of one test batch through the volumetric renderer."""
    outputs = model.render(batch)
    p_semantic = compute_semantics(outputs, classes, feature_transform)
    features = None
    if feature_transform is not None:
        features = feature_transform(outputs['semantic_features'])
    return _tile(size, outputs['image'], outputs['depth'], p_semantic,
                 maxdepth, features)


def render_baked(renderer, dataset, frame_index, size=TILE, maxdepth=10.0):
    """The tile from the splat cache: rgb | depth / semantic | (blank: the
    cache stores no distillation features)."""
    camera = dataset.camera
    T_CW = np.linalg.inv(dataset.poses[frame_index])
    outputs = renderer.render(camera.camera_matrix, T_CW, camera.size)
    return _tile(size, outputs['image'].cpu().numpy(),
                 outputs['depth'].cpu().numpy(),
                 outputs['semantic'].cpu().numpy(), maxdepth)


def _classes(flags, dataset):
    """--classes, or the prompts of --label-map's rows whose ids the scene
    holds."""
    if flags.label_map is None:
        return flags.classes
    pandas = require('pandas', '--label-map')
    label_map = pandas.read_csv(flags.label_map)
    classes_in_scene = dataset.scene.metadata.get('classes', None)
    if classes_in_scene is not None:
        label_map = label_map[label_map['id'].isin(classes_in_scene)]
    return label_map['prompt'].values


def frames(flags, device=None):
    """Yield (i, tile) for every --stride-th test frame of the scene: the
    uint8 (720, 960, 3) RGB tiles scripts/render.py writes, in its order.
    device: None (the card; raises without one) or a torch device."""
    device = resolve_device(device)
    model_params = model_utils.read_params(flags.model_dir)
    dataset = SceneDataset('test',
                           flags.scene,
                           size=tuple(flags.size),
                           batch_size=16384,
                           features=model_params.features,
                           load_semantic=False,
                           lazy=True)
    classes = _classes(flags, dataset)

    feature_transform = None
    if model_params.features is not None:
        feature_transform = FeatureTransformer(
            flags.scene, model_params.features, classes, flags.checkpoint,
            allow_fallback=flags.allow_fallback, device=device)

    n_classes = dataset.n_classes if dataset.n_classes is not None else 2
    field = model_utils.create_model(dataset.min_bounds, dataset.max_bounds,
                                     n_classes, model_params, device=device)

    use_proposal = flags.proposal
    if use_proposal and not getattr(model_params, 'proposal', False):
        print("--proposal needs a proposal-trained checkpoint (train with "
              "--proposal); falling back to the dense volumetric path.")
        use_proposal = False
    num_steps = flags.num_steps
    if num_steps is None:
        num_steps = 32 if use_proposal else 512
    model = InferenceModel.from_checkpoint(
        field, flags.model_dir, num_steps=num_steps,
        proposal_steps=flags.proposal_steps if use_proposal else 0,
        max_ray_batch=MAX_RAY_BATCH)

    baked_renderer = None
    if flags.baked:
        from autolabel_tpu_torch.render.baked import BakedRenderer, bake
        if classes is not None:
            print("--baked renders closed-set semantics only; "
                  "--classes/--label-map need the volumetric path.")
        baked_renderer = BakedRenderer(
            bake(field, resolution=flags.bake_resolution,
                 max_points=flags.max_splats))

    indices = dataset.indices[::flags.stride]
    for i, frame_index in enumerate(indices):
        if baked_renderer is not None:
            yield i, render_baked(baked_renderer, dataset, frame_index,
                                  maxdepth=flags.max_depth)
            continue
        start = time.perf_counter()
        batch = dataset._get_test(frame_index)
        frame = render(model, batch, feature_transform,
                       maxdepth=flags.max_depth, classes=classes)
        if i == 0:
            # The first frame includes the kernels' first calls; still a
            # fair upper bound.
            per_frame = time.perf_counter() - start
            total = per_frame * len(indices)
            print(f"\n~{per_frame:.0f} s/frame -> estimated "
                  f"{total / 60.0:.0f} min for {len(indices)} frames "
                  f"at {num_steps} samples/ray.")
            if total > 600:
                hints = []
                if not use_proposal and getattr(model_params, 'proposal',
                                                False):
                    hints.append("--proposal (32 proposal-placed "
                                 "samples, ~16x fewer field queries)")
                hints.append("--baked (one bake sweep, then "
                             "projection-only frames)")
                print("This exceeds 10 min; consider "
                      + " or ".join(hints) + ".")
        yield i, frame


def main(argv=None, device=None):
    """Render the video as scripts/render.py does. device: None (the card;
    raises without one) or a torch device ('cpu' in the tests)."""
    flags = read_args(argv)
    resolve_device(device)
    cv2 = require('cv2', 'the mp4 writer')
    writer = cv2.VideoWriter(flags.out, cv2.VideoWriter_fourcc(*'mp4v'),
                             flags.fps, TILE)
    try:
        for _, frame in frames(flags, device):
            writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    finally:
        writer.release()


if __name__ == '__main__':
    main()
