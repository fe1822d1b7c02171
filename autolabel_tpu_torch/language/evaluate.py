"""Open-vocabulary (vision-language) segmentation benchmark.

    python -m autolabel_tpu_torch.language.evaluate <scenes> --label-map m.csv
        [--pc] [--allow-fallback] [--out r.json]

Counterpart of scripts/language/evaluate.py, with its flags: renders
feature maps (or, with --pc, queries the field at the gt mesh's vertices)
and scores the argmax of their cosine similarities with the label map's
text embeddings against ground truth, printing per-class mIoU / mAcc
tables (formatted here, no rich). It keeps the JAX CLI's 606-class
semantic head (the reference's ScanNet checkpoints,
scripts/language/evaluate.py:133). The label map is read with the csv
module into the columns pandas.read_csv gives: id (int), prompt (str) and
evaluated (int) where present. The label map's prompts are embedded by
the workspace's teacher (params.features) through the port's dispatch:
--feature-checkpoint names DemoCLIP's .npz (demo) or LSeg's weights
(lseg); the other towers read their AUTOLABEL_* weights, and a teacher
without weights raises unless --allow-fallback picks its stand-in.

It runs on the card; tests call main([...], device='cpu').
"""
import argparse
import csv
import json
import os

import numpy as np

from autolabel_tpu_torch import model_utils
from autolabel_tpu_torch.core.dataset import SceneDataset
from autolabel_tpu_torch.device import resolve_device
from autolabel_tpu_torch.evaluate import format_table
from autolabel_tpu_torch.evaluation import (OpenVocabEvaluator2D,
                                            OpenVocabEvaluator3D)
from autolabel_tpu_torch.inference import InferenceModel

SCANNET_N_CLASSES = 606
INT_COLUMNS = ('id', 'evaluated')


def read_args(argv=None):
    """scripts/language/evaluate.py's flags; argv defaults to
    sys.argv[1:]."""
    parser = argparse.ArgumentParser()
    parser.add_argument('scenes', nargs='+')
    parser.add_argument('--batch-size', default=8182, type=int)
    parser.add_argument('--vis', default=None, type=str)
    parser.add_argument('--workspace', type=str, default=None)
    parser.add_argument('--out',
                        default=None,
                        type=str,
                        help="Where to write results as json, if anywhere.")
    parser.add_argument('--label-map', type=str, required=True)
    parser.add_argument('--feature-checkpoint', '-f', type=str,
                        default=None)
    parser.add_argument('--allow-fallback', action='store_true',
                        help="Permit deterministic stand-in features/text "
                        "embeddings when real teacher weights are "
                        "unavailable (testing only).")
    parser.add_argument(
        '--stride',
        type=int,
        default=1,
        help="Only evaluate every Nth frame to save time or for debugging.")
    parser.add_argument(
        '--pc',
        action='store_true',
        help="Evaluate point cloud segmentation accuracy instead of 2D "
        "segmentation maps.")
    parser.add_argument('--debug', action='store_true')
    parser.add_argument('--only-scene-classes', action='store_true')
    parser.add_argument('--random',
                        action='store_true',
                        help="Randomize the order of the scenes.")
    parser.add_argument('--time', action='store_true')
    return parser.parse_args(argv)


def read_label_map(path):
    """The label-map CSV as {column: numpy array}: id and evaluated as
    int64, every other column as str (the values pandas.read_csv gives a
    label map)."""
    with open(path, newline='') as f:
        rows = list(csv.DictReader(f))
    if not rows:
        raise ValueError(f'{path}: the label map has no rows')
    columns = {}
    for name in rows[0]:
        values = [row[name] for row in rows]
        if name in INT_COLUMNS:
            columns[name] = np.asarray([int(v) for v in values], np.int64)
        else:
            columns[name] = np.asarray(values, dtype=object)
    return columns


class ScoreBoard:
    """Accumulates per-class IoU/accuracy dicts across scenes.

    Each entry maps class-name -> value-or-None; 'total' rows are kept
    separate so the per-class table never averages them in.
    """

    def __init__(self):
        self.ious = []
        self.accs = []

    def add(self, iou, acc):
        self.ious.append(iou)
        self.accs.append(acc)

    def _class_means(self, records):
        by_class = {}
        for record in records:
            for name, value in record.items():
                if name != 'total':
                    by_class.setdefault(name, []).append(value)
        return {name: (np.mean([v for v in vals if v is not None])
                       if any(v is not None for v in vals) else None)
                for name, vals in by_class.items()}

    def _total(self, records):
        totals = [r['total'] for r in records if 'total' in r]
        return np.mean(totals) if totals else None

    def table(self):
        fmt = lambda v: "N/A" if v is None else f"{v * 100:.1f}"
        iou_means = self._class_means(self.ious)
        acc_means = self._class_means(self.accs)
        rows = [[name, fmt(iou_means[name]), fmt(acc_means.get(name))]
                for name in iou_means]
        rows.append(['Total', fmt(self._total(self.ious)),
                     fmt(self._total(self.accs))])
        return format_table(['Class', 'mIoU', 'mAcc'], rows)

    def render(self):
        print(self.table())

    def dump(self, path):
        with open(path, 'wt') as f:
            json.dump({'iou': self.ious, 'acc': self.accs}, f, indent=2)


def expand_scene_args(scene_args):
    """One arg without an rgb/ dir means "a directory of scenes"."""
    def is_scene(path):
        return os.path.exists(os.path.join(path, 'rgb'))

    if len(scene_args) == 1 and not is_scene(scene_args[0]):
        root = scene_args[0]
        return [os.path.join(root, name) for name in os.listdir(root)
                if is_scene(os.path.join(root, name))]
    return list(scene_args)


def nerf_dir_for(scene, workspace):
    name = os.path.basename(os.path.normpath(scene))
    return (os.path.join(scene, 'nerf') if workspace is None
            else os.path.join(workspace, name))


def iter_scene_runs(flags):
    """Yield (scene_dir, scene_name, model_path, params) for every scene
    that has a trained model with at least one checkpoint."""
    scene_dirs = expand_scene_args(flags.scenes)
    runs = sorted((os.path.basename(os.path.normpath(d)), d)
                  for d in scene_dirs)
    if flags.random:
        import random
        random.shuffle(runs)
    for scene_name, scene in runs:
        nerf_dir = nerf_dir_for(scene, flags.workspace)
        hashes = [h for h in (os.listdir(nerf_dir)
                              if os.path.exists(nerf_dir) else [])
                  if os.path.exists(os.path.join(nerf_dir, h,
                                                 'checkpoints'))]
        if not hashes:
            print(f"Skipping scene {scene_name} because no models were "
                  "found.")
            continue
        model_path = os.path.join(nerf_dir, hashes[0])
        ckpts = os.path.join(model_path, 'checkpoints')
        if not os.listdir(ckpts):
            continue
        print(f"Using model {hashes[0]}")
        print(f"Evaluating scene {scene_name}")
        yield scene, scene_name, model_path, model_utils.read_params(
            model_path)


def scene_label_map(flags, labels, dataset):
    if flags.only_scene_classes:
        in_scene = dataset.scene.metadata.get('classes', None)
        if in_scene is not None:
            keep = np.isin(labels['id'], in_scene)
            return {name: column[keep] for name, column in labels.items()}
    return labels


def main(argv=None, device=None):
    """Evaluate as scripts/language/evaluate.py does; returns the
    ScoreBoard. device: None (the card; raises without one) or a torch
    device ('cpu' in the tests)."""
    flags = read_args(argv)
    device = resolve_device(device)
    labels = read_label_map(flags.label_map)
    board = ScoreBoard()
    evaluator = None

    for scene, scene_name, model_path, params in iter_scene_runs(flags):
        dataset = SceneDataset('test',
                               scene,
                               factor=4.0,
                               batch_size=flags.batch_size,
                               lazy=True)
        # the reference's ScanNet checkpoints carry a 606-class semantic
        # head whatever the scene
        field = model_utils.create_model(dataset.min_bounds,
                                         dataset.max_bounds,
                                         SCANNET_N_CLASSES, params,
                                         device=device)
        model = InferenceModel.from_checkpoint(
            field, model_path, max_ray_batch=flags.batch_size)

        vis_path = (os.path.join(flags.vis, scene_name)
                    if flags.vis is not None else None)
        if evaluator is None:
            cls = OpenVocabEvaluator3D if flags.pc else OpenVocabEvaluator2D
            evaluator = cls(features=params.features,
                            name=scene_name,
                            checkpoint=flags.feature_checkpoint,
                            stride=flags.stride,
                            debug=flags.debug,
                            save_figures=vis_path,
                            time=flags.time,
                            allow_fallback=flags.allow_fallback,
                            device=device)
        if evaluator.features != params.features:
            raise ValueError(
                f'{model_path} was trained with --features '
                f'{params.features}, the evaluator encodes '
                f'{evaluator.features}')
        evaluator.reset(model, scene_label_map(flags, labels, dataset),
                        vis_path)
        iou, acc = evaluator.eval(dataset)
        board.add(iou, acc)

        per_scene = ScoreBoard()
        per_scene.add(iou, acc)
        per_scene.render()

    board.render()
    if flags.out is not None:
        board.dump(flags.out)
    return board


if __name__ == "__main__":
    main()
