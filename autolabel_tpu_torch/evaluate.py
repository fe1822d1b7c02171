"""Closed-set benchmark: per-scene x per-model IoU against labelme gt_masks.

    python -m autolabel_tpu_torch.evaluate <scene> [<scene> ...] [--out r.json]

Counterpart of scripts/evaluate.py, with exactly its flags: every trained
model of each scene (<scene>/nerf/<hash>, or <workspace>/<scene>/<hash>)
is loaded through InferenceModel.from_checkpoint (a workspace of either
package's train CLI, or a reference torch checkpoint) and scored by
evaluation.Evaluator on the test split at factor 4. --out gets the same
JSON entries (the model's params, the scene and its mIoU), and the same
table of scenes x model hashes with its Total row is printed, formatted
here (no rich). --write-images needs cv2 and PIL (JPEG figures) and
--vis matplotlib; both raise without them.

It runs on the card; tests call main([...], device='cpu').
"""
import argparse
import json
import os
import traceback

import numpy as np

from autolabel_tpu_torch import model_utils
from autolabel_tpu_torch.core.dataset import SceneDataset
from autolabel_tpu_torch.device import resolve_device
from autolabel_tpu_torch.evaluation import Evaluator
from autolabel_tpu_torch.inference import InferenceModel

CLASS_NAMES = ['Background', 'Class 1']


def read_args(argv=None):
    """scripts/evaluate.py's flags; argv defaults to sys.argv[1:]."""
    parser = argparse.ArgumentParser()
    parser.add_argument('scenes', nargs='+')
    parser.add_argument('--batch-size', default=8182, type=int)
    parser.add_argument('--vis', action='store_true')
    parser.add_argument('--workspace', type=str, default=None)
    parser.add_argument('--write-images', type=str, default=None)
    parser.add_argument('--out',
                        default=None,
                        type=str,
                        help="Where to write results as json, if anywhere.")
    return parser.parse_args(argv)


def format_table(header, rows):
    """A plain text table: columns padded to their widest cell, a rule
    under the header and one above each row whose first cell is 'Total'."""
    widths = [max(len(str(r[i])) for r in [header] + rows)
              for i in range(len(header))]

    def line(cells):
        return '| ' + ' | '.join(str(c).ljust(w) for c, w in
                                 zip(cells, widths)) + ' |'

    rule = '+' + '+'.join('-' * (w + 2) for w in widths) + '+'
    out = [rule, line(header), rule]
    for row in rows:
        if row[0] == 'Total':
            out.append(rule)
        out.append(line(row))
    out.append(rule)
    return '\n'.join(out)


def nerf_dir_for(scene, workspace):
    """Model workspaces live under <scene>/nerf or <workspace>/<scene>."""
    if workspace is None:
        return os.path.join(scene, 'nerf')
    return os.path.join(workspace, os.path.basename(os.path.normpath(scene)))


def iter_model_workspaces(scene, workspace):
    """Yield (model_hash, model_path) for every trained model of a scene."""
    nerf_dir = nerf_dir_for(scene, workspace)
    if not os.path.isdir(nerf_dir):
        return
    for model_hash in sorted(os.listdir(nerf_dir)):
        checkpoint_dir = os.path.join(nerf_dir, model_hash, 'checkpoints')
        if os.path.isdir(checkpoint_dir) and os.listdir(checkpoint_dir):
            yield model_hash, os.path.join(nerf_dir, model_hash)


class EvaluationRun:
    """Collects mIoU per (scene, model hash) and renders the report."""

    def __init__(self):
        self.miou = {}  # (scene_name, model_hash) -> float
        self.scene_names = []
        self.model_hashes = []
        self.json_entries = []

    def record(self, scene_name, model_hash, params, per_class_iou):
        if not per_class_iou:
            return
        value = float(np.mean(list(per_class_iou.values())))
        self.miou[(scene_name, model_hash)] = value
        if scene_name not in self.scene_names:
            self.scene_names.append(scene_name)
        if model_hash not in self.model_hashes:
            self.model_hashes.append(model_hash)
        entry = dict(vars(params))
        entry['scene'] = scene_name
        entry['iou'] = value
        self.json_entries.append(entry)

    def row(self, scene_name):
        return [self.miou.get((scene_name, h), -1.0)
                for h in self.model_hashes]

    def table(self):
        rows = []
        values = []
        for scene_name in self.scene_names:
            row = self.row(scene_name)
            values.append(row)
            rows.append([scene_name] + [f'{v:.03f}' for v in row])
        if values:
            totals = np.asarray(values).mean(axis=0)
            rows.append(['Total'] + [f'{v:.03f}' for v in totals])
        return format_table(['Scene'] + self.model_hashes, rows)

    def print_table(self):
        print(self.table())


def evaluate_workspace(scene, model_hash, model_path, flags, device):
    """Load one trained model and compute per-class IoU on its scene."""
    params = model_utils.read_params(model_path)
    dataset = SceneDataset('test',
                           scene,
                           factor=4.0,
                           batch_size=flags.batch_size,
                           lazy=True)
    n_classes = dataset.n_classes if dataset.n_classes is not None else 2
    field = model_utils.create_model(dataset.min_bounds, dataset.max_bounds,
                                     n_classes, params, device=device)
    model = InferenceModel.from_checkpoint(field, model_path,
                                           max_ray_batch=flags.batch_size)
    figure_dir = None
    if flags.write_images is not None:
        scene_name = os.path.basename(os.path.normpath(scene))
        figure_dir = os.path.join(flags.write_images, scene_name)
    evaluator = Evaluator(model, CLASS_NAMES, name=model_hash,
                          save_figures=figure_dir)
    return params, evaluator.eval(dataset, flags.vis)


def main(argv=None, device=None):
    """Evaluate as scripts/evaluate.py does; returns the EvaluationRun.
    device: None (the card; raises without one) or a torch device ('cpu'
    in the tests)."""
    flags = read_args(argv)
    device = resolve_device(device)
    run = EvaluationRun()
    for scene in sorted(flags.scenes,
                        key=lambda p: os.path.basename(os.path.normpath(p))):
        scene_name = os.path.basename(os.path.normpath(scene))
        print(f'Evaluating scene {scene_name}')
        for model_hash, model_path in iter_model_workspaces(
                scene, flags.workspace):
            try:
                params, per_class_iou = evaluate_workspace(
                    scene, model_hash, model_path, flags, device)
            except Exception as e:
                # A workspace that cannot be evaluated is skipped, as the
                # JAX CLI skips it; the traceback says why.
                traceback.print_exc()
                print(f'Skipping {model_hash}: cannot load ({e!r})')
                continue
            run.record(scene_name, model_hash, params, per_class_iou)

    if flags.out is not None:
        with open(flags.out, 'wt') as f:
            json.dump(run.json_entries, f, indent=2)
    run.print_table()
    return run


if __name__ == '__main__':
    main()
