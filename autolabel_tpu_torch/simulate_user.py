"""User-in-the-loop simulation: a scripted annotator clicks wrongly
predicted pixels, the model refits, and the accuracy learning curve is
logged.

    python -m autolabel_tpu_torch.simulate_user <scene> [flags]

Counterpart of scripts/simulate_user.py, with its flags and its global
np.random.seed(0) draws, so given the same predictions it clicks the same
pixels. Requires dense ground-truth semantic maps in <scene>/semantic/,
read as PNGs without cv2. Results go to
<model-dir>/user_simulation.csv as (step, annotated pixels, miou) rows.
It runs on the card; tests call main([...], device='cpu'). --vis needs
matplotlib, imported at the call.
"""
import os

import numpy as np

from autolabel_tpu_torch import model_utils
from autolabel_tpu_torch.constants import COLORS
from autolabel_tpu_torch.core.dataset import SceneDataset
from autolabel_tpu_torch.device import resolve_device
from autolabel_tpu_torch.render.renderer import RenderOptions
from autolabel_tpu_torch.train.losses import LossOptions
from autolabel_tpu_torch.train.trainer import SimpleTrainer
from autolabel_tpu_torch.utils import images as image_io
from autolabel_tpu_torch.utils import require


def read_args(argv=None):
    """scripts/simulate_user.py's flags and defaults; argv defaults to
    sys.argv[1:]."""
    parser = model_utils.model_flag_parser()
    parser.add_argument('scene')
    parser.add_argument('--batch-size', '-b', type=int, default=2048)
    parser.add_argument('--workers', '-w', type=int, default=0)
    parser.add_argument('--workspace', type=str, default=None)
    parser.add_argument('--vis', action='store_true')
    parser.add_argument('--warmup', type=int, default=15000)
    parser.add_argument('--max-annotations', type=int, default=1500)
    parser.add_argument('--iters-per-round', type=int, default=250)
    parser.add_argument('--num-steps', type=int, default=128)
    return parser.parse_args(argv)


class UserSimulation:
    """Pick a frame, click a few wrongly classified pixels, feed the gt
    labels back into the sampler (scripts/simulate_user.py:44-150)."""

    def __init__(self, trainer, dataset, result_path, clicks_per_step=5,
                 visualize=False):
        self.trainer = trainer
        self.result_path = result_path
        self.dataset = dataset
        self.clicks_per_step = clicks_per_step
        self.visualize = visualize
        self.semantic_paths = dataset.scene.semantic_paths()
        self.frame_indices = np.arange(len(dataset.poses))
        self.evaluation_frames = np.random.choice(
            self.frame_indices, min(10, len(self.frame_indices)),
            replace=False)
        self.results = []  # (step, annotated pixels, miou)

    def annotate(self):
        frame_index = int(np.random.choice(self.frame_indices))
        gt_semantic = self._load_semantic(self.semantic_paths[frame_index])
        p_semantic = self._infer_semantics(frame_index)
        where_defined = gt_semantic >= 0
        where_wrong = p_semantic != gt_semantic
        for _ in range(self.clicks_per_step):
            chosen_pixel = self._choose_pixel(where_wrong, where_defined)
            self._annotate_pixel(frame_index, chosen_pixel, gt_semantic)
        self.dataset.update_sampler()

    def evaluate(self, current_step, annotated_pixels):
        ious = []
        for index in self.evaluation_frames:
            gt_semantic = self._load_semantic(self.semantic_paths[index])
            p_semantic = self._infer_semantics(index)
            where_defined = gt_semantic >= 0
            correct = np.bitwise_and(where_defined,
                                     gt_semantic == p_semantic)
            ious.append(correct.sum() / max(where_defined.sum(), 1))
        miou = float(np.mean(ious))
        self.results.append((current_step, int(annotated_pixels), miou))
        return miou

    def save(self):
        np.savetxt(self.result_path, np.array(self.results))

    def _choose_pixel(self, where_wrong, where_defined):
        where_wrong = np.bitwise_and(where_defined, where_wrong)
        if where_wrong.sum() > 0:
            incorrect = np.argwhere(where_wrong)
        else:
            incorrect = np.argwhere(np.ones_like(where_wrong, dtype=bool))
        return incorrect[np.random.randint(0, len(incorrect))]

    def _infer_semantics(self, frame_index):
        batch = self.dataset._get_test(frame_index)
        _, _, p_semantic, _ = self.trainer.test_step(batch)
        # One host fetch of the argmax.
        return p_semantic.argmax(dim=-1).cpu().numpy()

    def _annotate_pixel(self, frame_index, yx, gt_semantic):
        # Counteract the -1 shift applied by _load_semantic.
        semantic_class = gt_semantic[yx[0], yx[1]] + 1
        if semantic_class < 0:
            raise ValueError(f'gt class {semantic_class} below 0')
        index = yx[0] * self.dataset.w + yx[1]
        self.dataset.semantics[frame_index][index] = semantic_class

    def _load_semantic(self, path):
        gt = image_io.read_image(path).astype(int)
        if gt.shape[:2] != (self.dataset.h, self.dataset.w):
            gt = image_io.resize_nearest_cv2(gt, (self.dataset.w,
                                                  self.dataset.h))
        return gt - 1

    def visualize_examples(self):
        pyplot = require('matplotlib.pyplot', 'simulate_user --vis')
        indices = np.random.randint(0, len(self.dataset.poses), 3)
        for i, index in enumerate(indices):
            batch = self.dataset._get_test(int(index))
            p_rgb, _, p_sem, _ = self.trainer.test_step(batch)
            p_rgb = p_rgb.cpu().numpy()
            p_semantic = p_sem.argmax(dim=-1).cpu().numpy()
            gt_semantic = self._load_semantic(self.semantic_paths[index])
            gt_semantic[gt_semantic < 0] = 0
            rgb = (batch['pixels'] * 255).astype(np.uint8)
            axis = pyplot.subplot2grid((3, 2), loc=(i, 0))
            axis.set_title("GT")
            axis.imshow(rgb)
            axis.imshow(COLORS[gt_semantic], alpha=0.5)
            axis.axis('off')
            axis = pyplot.subplot2grid((3, 2), loc=(i, 1))
            axis.set_title("Predicted")
            axis.imshow((np.clip(p_rgb, 0, 1) * 255).astype(np.uint8))
            axis.imshow(COLORS[p_semantic], alpha=0.5)
            axis.axis('off')
        pyplot.tight_layout()
        pyplot.show()


def main(argv=None, device=None):
    """Warm up, then annotate and refit until --max-annotations pixels are
    labelled, as scripts/simulate_user.py does. device: None (the card;
    raises without one) or a torch device ('cpu' in the tests). Returns
    the UserSimulation (its results and result_path)."""
    flags = read_args(argv)
    device = resolve_device(device)
    if flags.vis:
        require('matplotlib.pyplot', 'simulate_user --vis')

    dataset = SceneDataset('train',
                           flags.scene,
                           factor=1.0,
                           batch_size=flags.batch_size,
                           features=flags.features,
                           load_semantic=False)

    n_classes = dataset.n_classes if dataset.n_classes is not None else 2
    field = model_utils.create_model(dataset.min_bounds, dataset.max_bounds,
                                     n_classes, flags, device=device)
    loss_options = LossOptions(rgb_weight=flags.rgb_weight,
                               depth_weight=flags.depth_weight,
                               semantic_weight=flags.semantic_weight,
                               feature_weight=flags.feature_weight,
                               feature_loss=flags.features is not None)
    model_dir = model_utils.model_dir(flags.scene, flags)
    trainer = SimpleTrainer('ngp',
                            field,
                            lr=flags.lr,
                            iters=flags.warmup,
                            loss_options=loss_options,
                            render_options=RenderOptions(
                                num_steps=flags.num_steps, perturb=True),
                            workspace=model_dir,
                            ema_decay=0.95,
                            use_checkpoint='latest')
    # Warmup: fit geometry and radiance before any labels exist.
    trainer.train_iterations(dataset, flags.warmup)

    result_file = os.path.join(model_dir, 'user_simulation.csv')
    np.random.seed(0)
    user = UserSimulation(trainer, dataset, result_file,
                          visualize=flags.vis)
    if flags.vis:
        print("Visualizing at start")
        user.visualize_examples()

    annotated = 0
    i = 0
    while annotated < flags.max_annotations:
        annotated = (dataset.semantics > 0).sum()
        if i % 5 == 0:
            if flags.vis:
                user.visualize_examples()
            iou = user.evaluate(i, annotated)
            print(f"iou: {iou:.3f}")
        user.annotate()
        print(f"{annotated} annotated pixels")
        trainer.train_iterations(dataset, flags.iters_per_round)
        i += 1

    user.save()
    return user


if __name__ == "__main__":
    main()
