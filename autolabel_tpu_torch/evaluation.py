"""Closed-set and open-vocabulary evaluation.

Counterpart of autolabel_tpu/evaluation.py, with the same classes, flow
and quirks: Evaluator (per-class IoU against labelme gt_masks; its figure
is written once per class), OpenVocabEvaluator2D (rendered feature maps
against text embeddings, intersections and unions summed over frames) and
OpenVocabEvaluator3D (the jitter-averaged feature query at the gt mesh's
vertices, the first 50,000 points at seed 0 and the rest at seed 1, the
ngp axis permutation, and the host loop for models without the fused
query). Prompt cells may hold `|`-separated synonyms, which are ensembled.

The JAX package reads gt semantic maps with PIL and writes figures with
PIL and cv2; here the maps are read by utils.images (read_image and PIL's
nearest rule) and the PNG figures written by write_png. What still needs
a package the port does not depend on imports it at the call and raises
naming it: Evaluator's JPEG figures (cv2 and PIL) and visualize=True
(matplotlib).
"""
import os
import time

import numpy as np

from autolabel_tpu_torch.constants import COLORS
from autolabel_tpu_torch.features.feature_utils import get_feature_extractor
from autolabel_tpu_torch.utils import require
from autolabel_tpu_torch.utils.images import (read_image, resize_nearest_pil,
                                              write_png)
from autolabel_tpu_torch.utils.ply import read_ply_vertices


def compute_iou(p_semantic, gt_semantic, class_index):
    p = p_semantic == class_index
    gt = gt_semantic == class_index
    union = np.bitwise_or(p, gt).sum()
    if union == 0:
        return 0.0
    return float(np.bitwise_and(p, gt).sum()) / float(union)


class Evaluator:
    """Closed-set per-class IoU against labelme-annotated gt_masks."""

    def __init__(self, model, classes, name="model", save_figures=None):
        self.model = model
        self.classes = classes
        self.name = name
        self.save_figures = save_figures

    def eval(self, dataset, visualize=False):
        ious = {}
        gt_masks = dataset.scene.gt_masks(dataset.camera.size)
        for index, gt_semantic in gt_masks:
            batch = dataset._get_test(index)
            outputs = self.model.render(batch)
            p_semantic = outputs['semantic'].argmax(axis=-1)
            for class_index in range(1, len(self.classes)):
                if visualize or self.save_figures is not None:
                    self._visualize_frame(batch, p_semantic, gt_semantic,
                                          index, show=visualize)
                iou = compute_iou(p_semantic, gt_semantic, class_index)
                ious.setdefault(class_index, []).append(iou)
        return {k: float(np.mean(v)) for k, v in ious.items()}

    def _visualize_frame(self, batch, semantic, gt_semantic, example_index,
                         show=False):
        rgb = (batch['pixels'] * 255).astype(np.uint8)
        p_semantic = (COLORS[semantic % COLORS.shape[0]] * 255).astype(
            np.uint8)
        if show:
            pyplot = require('matplotlib.pyplot', 'visualize=True')
            axis = pyplot.subplot2grid((1, 2), loc=(0, 0))
            axis.imshow(rgb)
            axis.imshow(p_semantic, alpha=0.5)
            axis.set_title(self.name)
            axis = pyplot.subplot2grid((1, 2), loc=(0, 1))
            axis.imshow(COLORS[gt_semantic % COLORS.shape[0]])
            axis.set_title("GT")
            pyplot.tight_layout()
            pyplot.show()
        if self.save_figures is not None:
            cv2 = require('cv2', "Evaluator's JPEG figures")
            image_module = require('PIL.Image', "Evaluator's JPEG figures")
            os.makedirs(self.save_figures, exist_ok=True)
            image = cv2.addWeighted(rgb, 0.5, p_semantic, 0.5, 0.0)
            image_module.fromarray(image).save(
                os.path.join(self.save_figures,
                             self.name + f"_{example_index}.jpg"))


class OpenVocabEvaluator:
    """Base: match rendered CLIP-space features against text prompts."""

    def __init__(self,
                 name="model",
                 features=None,
                 checkpoint=None,
                 debug=False,
                 stride=1,
                 save_figures=None,
                 time=False,
                 allow_fallback=False,
                 device=None):
        self.name = name
        self.debug = debug
        self.stride = stride
        self.model = None
        self.label_map = None
        self.features = features
        self.extractor = get_feature_extractor(
            features, checkpoint, allow_fallback=allow_fallback,
            device=device)
        self.save_figures = save_figures
        self.time = time

    def reset(self, model, label_map, figure_path=None):
        """label_map: a mapping of columns id, prompt [, evaluated] (a
        pandas DataFrame, or a dict of lists), each read through
        np.asarray.

        A prompt cell may hold several `|`-separated phrasings of one
        class: each is embedded, and the class is matched against their
        renormalized mean. The first phrasing is the class's display name,
        and the per-class results are keyed by it.
        """
        self.model = model
        ids = np.asarray(label_map['id'])
        prompts = np.asarray(label_map['prompt'])
        self.label_id_map = ids
        self.text_features = self._ensemble_text_features(prompts)
        self.label_mapping = {0: 'void'}
        self.label_to_color_id = np.zeros(int(ids.max()) + 1, dtype=int)
        for index, (i, prompt) in enumerate(zip(ids, prompts)):
            self.label_mapping[i] = str(prompt).split('|')[0].strip()
            self.label_to_color_id[i] = index + 1
        self.label_map = {'id': ids,
                          'prompt': [str(p).split('|')[0].strip()
                                     for p in prompts]}
        self.save_figures = figure_path
        if 'evaluated' in label_map:
            evaluated = np.asarray(label_map['evaluated'])
            self.label_map['evaluated'] = evaluated
            self.evaluated_labels = ids[evaluated == 1]
        else:
            self.evaluated_labels = ids

    def _ensemble_text_features(self, prompt_cells):
        """Encode every `|`-separated phrasing once, then average each
        class's unit-norm embeddings and renormalize."""
        groups = [[s.strip() for s in str(cell).split('|') if s.strip()]
                  for cell in prompt_cells]
        flat = [p for group in groups for p in group]
        embedded = np.asarray(self.extractor.encode_text(flat))
        features = np.empty((len(groups), embedded.shape[-1]),
                            dtype=embedded.dtype)
        offset = 0
        for row, group in enumerate(groups):
            mean = embedded[offset:offset + len(group)].mean(axis=0)
            features[row] = mean / (np.linalg.norm(mean) + 1e-6)
            offset += len(group)
        return features

    def eval(self, dataset, visualize=False):
        raise NotImplementedError()


class OpenVocabEvaluator2D(OpenVocabEvaluator):
    """Per-frame: render the feature map, argmax cosine similarity against
    text prompts, accumulate I/U across frames."""

    def eval(self, dataset):
        ious, accs = [], []
        gt_paths = dataset.scene.gt_semantic()
        for i, gt_path in enumerate(gt_paths):
            if i % self.stride != 0:
                continue
            batch = dataset._get_test(i)
            gt_semantic = self._read_gt_semantic(gt_path, dataset.camera)
            mask = np.isin(gt_semantic, self.evaluated_labels)
            p_semantic = self._predict_semantic(batch)

            if self.save_figures is not None:
                self._save_figure(p_semantic, gt_semantic, batch, i)

            iou, acc = {}, {}
            for label_id, prompt in zip(self.label_map['id'],
                                        self.label_map['prompt']):
                if label_id not in self.evaluated_labels:
                    continue
                gt_mask = gt_semantic[mask] == label_id
                if gt_mask.sum() <= 0:
                    continue
                p_mask = p_semantic[mask] == label_id
                tp = np.bitwise_and(p_mask, gt_mask).sum()
                fp = np.bitwise_and(p_mask, ~gt_mask).sum()
                fn = np.bitwise_and(~p_mask, gt_mask).sum()
                iou[prompt] = (tp, tp + fp + fn)
                acc[prompt] = (tp, tp + fp)
            ious.append(iou)
            accs.append(acc)

        if len(ious) == 0:
            print(f"Scene {self.name} has no labels in the evaluation set")
            return {}
        out_iou, out_acc = {}, {}
        for key in ious[0].keys():
            iou_values = [d[key] for d in ious if d.get(key) is not None]
            acc_values = [d[key] for d in accs if d.get(key) is not None]
            if not iou_values:
                out_iou[key] = None
                out_acc[key] = None
                continue
            intersection = sum(v[0] for v in iou_values)
            union = sum(v[1] for v in iou_values)
            out_iou[key] = intersection / union if union else 0.0
            num = sum(v[0] for v in acc_values)
            den = sum(v[1] for v in acc_values)
            out_acc[key] = num / den if den else 0.0
        out_iou['total'] = float(np.mean(
            [v for v in out_iou.values() if v is not None]))
        out_acc['total'] = float(np.mean(
            [v for v in out_acc.values() if v is not None]))
        return out_iou, out_acc

    def _predict_semantic(self, batch):
        if self.time:
            start = time.time()
        outputs = self.model.render(batch)
        features = outputs['semantic_features']
        features = features / np.maximum(
            np.linalg.norm(features, axis=-1, keepdims=True), 1e-9)
        H, W, D = features.shape
        text = self.text_features[:, :D]
        similarities = features.reshape(H * W, D) @ text.T
        prediction = self.label_id_map[similarities.argmax(-1).reshape(H, W)]
        if self.time:
            n_pixels = H * W
            elapsed = time.time() - start
            print(f"Semantic prediction for {n_pixels} took {elapsed} "
                  f"seconds. {n_pixels / elapsed} pixels per second.")
        return prediction

    def _save_figure(self, p_semantic, gt_semantic, batch, example_index):
        for sub in ('rgb', 'p_semantic', 'gt_semantic'):
            os.makedirs(os.path.join(self.save_figures, sub), exist_ok=True)
        rgb = (batch['pixels'] * 255).astype(np.uint8)
        write_png(os.path.join(self.save_figures, 'rgb',
                               f"{example_index:06}.png"), rgb)
        p_sem = self.label_to_color_id[p_semantic]
        p_vis = (COLORS[p_sem % COLORS.shape[0]] * 255).astype(np.uint8)
        write_png(os.path.join(self.save_figures, 'p_semantic',
                               f"{example_index:06}.png"), p_vis)
        gt_sem = self.label_to_color_id[gt_semantic]
        gt_vis = (COLORS[gt_sem % COLORS.shape[0]] * 255).astype(np.uint8)
        gt_vis[gt_semantic == 0] = (0, 0, 0)
        write_png(os.path.join(self.save_figures, 'gt_semantic',
                               f"{example_index:06}.png"), gt_vis)

    def _read_gt_semantic(self, path, camera):
        return resize_nearest_pil(read_image(path),
                                  camera.size).astype(np.int64)


class OpenVocabEvaluator3D(OpenVocabEvaluator):
    """Query the field at gt mesh vertices (10 jittered density/feature
    samples per point, sigma 0.02) and score against mesh labels."""

    JITTER_SAMPLES = 10
    JITTER_SIGMA = 0.02

    def eval(self, dataset, visualize=False):
        point_cloud, gt_semantic = self._read_gt_pointcloud(dataset)
        p_semantic = self._predict_semantic(point_cloud)
        mask = np.isin(gt_semantic, self.evaluated_labels)
        if mask.sum() == 0:
            print(f"Skipping {self.name} because no labels are in the list "
                  "of valid labels.")
            return {}, {}

        iou, acc = {}, {}
        for label_id, prompt in zip(self.label_map['id'],
                                    self.label_map['prompt']):
            if label_id not in self.evaluated_labels:
                continue
            object_mask = gt_semantic[mask] == label_id
            if object_mask.sum() == 0:
                continue
            p_mask = p_semantic[mask]
            tp = np.bitwise_and(p_mask == label_id, object_mask).sum()
            fp = np.bitwise_and(p_mask == label_id, ~object_mask).sum()
            fn = np.bitwise_and(p_mask != label_id, object_mask).sum()
            iou[prompt] = float(tp) / (tp + fp + fn)
            acc[prompt] = float(tp) / (tp + fn)
        iou['total'] = float(np.mean(list(iou.values()))) if iou else 0.0
        acc['total'] = float(np.mean(list(acc.values()))) if acc else 0.0
        return iou, acc

    def _predict_semantic(self, points):
        if self.time:
            start = time.time()
        if hasattr(self.model, 'jittered_semantic_features'):
            # the whole average per 50,000-point chunk on the device
            first = self.model.jittered_semantic_features(
                points[:50000], self.JITTER_SAMPLES, self.JITTER_SIGMA,
                seed=0)
            first_batch = time.time() if self.time else None
            if points.shape[0] > 50000:
                rest = self.model.jittered_semantic_features(
                    points[50000:], self.JITTER_SAMPLES,
                    self.JITTER_SIGMA, seed=1)
                features = np.concatenate([first, rest])
            else:
                features = first
        else:
            # the reference's host loop, two round trips a jitter sample,
            # its weight-1 first sample included
            rng = np.random.default_rng(0)
            density = self.model.density(points)
            _, features = self.model.semantic(density['geo_feat'])
            first_batch = time.time() if self.time else None
            scale = 1.0 / self.JITTER_SAMPLES
            features = features.astype(np.float32)
            for _ in range(self.JITTER_SAMPLES - 1):
                noise = rng.normal(scale=self.JITTER_SIGMA,
                                   size=points.shape).astype(np.float32)
                density = self.model.density(points + noise)
                _, f = self.model.semantic(density['geo_feat'])
                features += f * scale
            features /= np.maximum(
                np.linalg.norm(features, axis=-1, keepdims=True), 1e-9)
        if self.time:
            duration = time.time() - start
            count = points.shape[0] * self.JITTER_SAMPLES
            print(f"Semantic prediction took {duration:.2f} seconds for "
                  f"{count} points. {count / duration:.2f} points per "
                  "second.")
            print(f"Query latency: {(first_batch - start) * 1000:.4f} ms")
        text = self.text_features[:, :features.shape[-1]]
        similarities = features @ text.T
        return self.label_id_map[similarities.argmax(-1)]

    def _read_gt_pointcloud(self, dataset):
        scene_path = dataset.scene.path
        points = read_ply_vertices(os.path.join(scene_path, 'mesh.ply'))
        semantic = np.load(os.path.join(scene_path,
                                        'mesh_labels.npy')).astype(int)
        # ngp axis permutation (x, y, z) -> (y, z, x)
        fixed = np.stack([points[:, 1], points[:, 2], points[:, 0]], axis=-1)
        return fixed.astype(np.float32), semantic
