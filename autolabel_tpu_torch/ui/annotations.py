"""Annotation state for the interactive labeller: numpy, no Qt.

Counterpart of autolabel_tpu/ui/annotations.py. The labels live here as
uint8 bitmaps (0 = unlabelled, class_id + 1 otherwise), painted with cv2
strokes and kept as grayscale PNGs under <scene>/semantic/<frame>.png:
the files the training backend re-reads. cv2 is imported at the call that
needs it.
"""
import os

import numpy as np

from autolabel_tpu_torch.constants import COLORS
from autolabel_tpu_torch.utils import require

# Overlay opacities (0-255): user paint strokes render stronger than the
# model's predicted segmentation underneath.
PAINT_ALPHA = 175
PREDICTION_ALPHA = 120
DEFAULT_BRUSH_RADIUS = 5


def _cv2():
    return require('cv2', 'the annotation store')


def paint_overlay_rgba(bitmap):
    """Label bitmap (H, W) uint8 -> RGBA (H, W, 4): value v > 0 shows
    COLORS[v - 1] at PAINT_ALPHA, value 0 is fully transparent."""
    lut = np.zeros((COLORS.shape[0] + 1, 4), dtype=np.uint8)
    lut[1:, :3] = COLORS
    lut[1:, 3] = PAINT_ALPHA
    return lut[bitmap]


def prediction_overlay_rgba(class_map):
    """Predicted class map (H, W) int -> RGBA colored overlay."""
    rgba = np.empty((*class_map.shape, 4), dtype=np.uint8)
    rgba[..., :3] = COLORS[class_map % len(COLORS)]
    rgba[..., 3] = PREDICTION_ALPHA
    return rgba


class AnnotationStore:
    """Per-frame label bitmaps with stroke painting and PNG persistence.

    Bitmaps are (height, width) uint8 in canvas resolution; strokes write
    class_id + 1 so pixel 0 stays "unlabelled" (the -1 shift happens in
    the dataset loader).
    """

    def __init__(self, scene_path, canvas_size):
        self.semantic_dir = os.path.join(scene_path, 'semantic')
        self.width, self.height = int(canvas_size[0]), int(canvas_size[1])
        self._bitmaps = {}

    # -- state ---------------------------------------------------------

    def frames(self):
        return list(self._bitmaps.keys())

    def get(self, frame):
        bitmap = self._bitmaps.get(frame)
        if bitmap is None:
            bitmap = np.zeros((self.height, self.width), np.uint8)
            self._bitmaps[frame] = bitmap
        return bitmap

    def is_empty(self, frame):
        bitmap = self._bitmaps.get(frame)
        return bitmap is None or not bitmap.any()

    def clear(self, frame):
        self._bitmaps[frame] = np.zeros((self.height, self.width), np.uint8)

    # -- painting --------------------------------------------------------

    def paint_stroke(self, frame, p0, p1, class_id,
                     radius=DEFAULT_BRUSH_RADIUS):
        """Round-capped line segment from p0 to p1 ((x, y) in canvas
        coordinates), writing class_id + 1 into the bitmap."""
        cv2 = _cv2()
        bitmap = self.get(frame)
        a = (int(round(p0[0])), int(round(p0[1])))
        b = (int(round(p1[0])), int(round(p1[1])))
        value = int(class_id) + 1
        cv2.line(bitmap, a, b, value, thickness=2 * radius,
                 lineType=cv2.LINE_8)
        # Round caps: cv2 lines are butt-capped; stamp the endpoints.
        cv2.circle(bitmap, a, radius, value, thickness=-1)
        cv2.circle(bitmap, b, radius, value, thickness=-1)
        return bitmap

    # -- persistence -------------------------------------------------------

    def save(self, frame):
        """Write the frame's bitmap as a grayscale PNG; empty canvases are
        skipped. Returns the path written or None."""
        if self.is_empty(frame):
            return None
        os.makedirs(self.semantic_dir, exist_ok=True)
        path = os.path.join(self.semantic_dir, f'{frame}.png')
        _cv2().imwrite(path, self._bitmaps[frame])
        return path

    def save_all(self):
        return [p for p in (self.save(f) for f in self._bitmaps) if p]

    def load_existing(self):
        """Pick up label PNGs from a previous session, rescaling to the
        canvas resolution with nearest-neighbor (labels, not colors)."""
        if not os.path.isdir(self.semantic_dir):
            return
        cv2 = _cv2()
        for filename in sorted(os.listdir(self.semantic_dir)):
            stem, ext = os.path.splitext(filename)
            if ext.lower() != '.png':
                continue
            array = cv2.imread(os.path.join(self.semantic_dir, filename),
                               cv2.IMREAD_GRAYSCALE)
            if array is None:
                continue
            if array.shape != (self.height, self.width):
                array = cv2.resize(array, (self.width, self.height),
                                   interpolation=cv2.INTER_NEAREST)
            self._bitmaps[stem] = array.astype(np.uint8)
