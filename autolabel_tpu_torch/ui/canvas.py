"""Paint canvas widget for the interactive labeller.

Counterpart of autolabel_tpu/ui/canvas.py: shows the photo with the
model's predicted segmentation blended under the user's paint strokes,
and turns mouse drags into class-id strokes. The label state is numpy
(ui/annotations.AnnotationStore); one widget composites three layers in
paintEvent (photo, prediction overlay, paint overlay); widget->image
coordinates are an explicit affine from the letterboxed target rect, so
resizing never changes stored labels.

PaintCanvas (a QWidget) is made on first use against the PyQt6 present
then (see ui/__init__.py).
"""
import numpy as np

from autolabel_tpu_torch.ui import lazy_qt_classes, qt_modules
from autolabel_tpu_torch.ui.annotations import (DEFAULT_BRUSH_RADIUS,
                                                paint_overlay_rgba,
                                                prediction_overlay_rgba)


def _to_qimage(array):
    """RGB888 or RGBA8888 numpy array -> QImage (copies; keeps Qt from
    referencing freed numpy memory)."""
    QtGui = qt_modules()[1]
    array = np.ascontiguousarray(array)
    height, width = array.shape[:2]
    if array.shape[2] == 3:
        fmt = QtGui.QImage.Format.Format_RGB888
    else:
        fmt = QtGui.QImage.Format.Format_RGBA8888
    return QtGui.QImage(array.data, width, height, array.strides[0],
                        fmt).copy()


def _build(QtCore, QtGui, QtWidgets):

    class PaintCanvas(QtWidgets.QWidget):
        """Composites photo + prediction + strokes; reports strokes
        upstream.

        stroke_callback(p0, p1) is invoked per drag segment with
        canvas-space endpoints; release_callback() on mouse-up (the window
        saves + notifies the trainer there).
        """

        def __init__(self, canvas_size, stroke_callback, release_callback):
            super().__init__()
            self.canvas_width, self.canvas_height = (int(canvas_size[0]),
                                                     int(canvas_size[1]))
            self._stroke_cb = stroke_callback
            self._release_cb = release_callback
            self._photo = None          # QImage, canvas-sized
            self._prediction = None     # QImage RGBA or None
            self._paint_layer = None    # QImage RGBA or None
            self._dragging = False
            self._last_pos = None
            self.brush_radius = DEFAULT_BRUSH_RADIUS
            self.setMinimumSize(self.canvas_width // 2,
                                self.canvas_height // 2)
            self.setMouseTracking(False)

        # -- content updates -------------------------------------------

        def show_photo(self, rgb_array):
            """(H, W, 3) uint8 photo; rescaled to canvas size once here."""
            img = _to_qimage(rgb_array)
            self._photo = img.scaled(self.canvas_width, self.canvas_height)
            self.update()

        def show_prediction(self, class_map):
            """Predicted (h, w) class map from the backend (any
            resolution)."""
            rgba = prediction_overlay_rgba(np.asarray(class_map))
            self._prediction = _to_qimage(rgba).scaled(self.canvas_width,
                                                       self.canvas_height)
            self.update()

        def clear_prediction(self):
            self._prediction = None
            self.update()

        def show_labels(self, bitmap):
            """Current paint bitmap (canvas-sized uint8) -> overlay."""
            self._paint_layer = _to_qimage(paint_overlay_rgba(bitmap))
            self.update()

        # -- geometry ----------------------------------------------------

        def _target_rect(self):
            """Letterboxed destination rect preserving the canvas
            aspect."""
            w, h = self.width(), self.height()
            scale = min(w / self.canvas_width, h / self.canvas_height)
            tw, th = self.canvas_width * scale, self.canvas_height * scale
            return QtCore.QRectF((w - tw) / 2, (h - th) / 2, tw, th)

        def _widget_to_canvas(self, pos):
            rect = self._target_rect()
            x = (pos.x() - rect.x()) / rect.width() * self.canvas_width
            y = (pos.y() - rect.y()) / rect.height() * self.canvas_height
            return (float(np.clip(x, 0, self.canvas_width - 1)),
                    float(np.clip(y, 0, self.canvas_height - 1)))

        # -- painting ----------------------------------------------------

        def paintEvent(self, event):
            painter = QtGui.QPainter(self)
            painter.fillRect(self.rect(), QtGui.QColor(40, 40, 40))
            rect = self._target_rect()
            for layer in (self._photo, self._prediction, self._paint_layer):
                if layer is not None:
                    painter.drawImage(rect, layer)
            painter.end()

        # -- mouse -------------------------------------------------------

        def mousePressEvent(self, event):
            if event.button() != QtCore.Qt.MouseButton.LeftButton:
                return
            self._dragging = True
            point = self._widget_to_canvas(event.position())
            self._last_pos = point
            self._stroke_cb(point, point)

        def mouseMoveEvent(self, event):
            if not self._dragging:
                return
            point = self._widget_to_canvas(event.position())
            self._stroke_cb(self._last_pos, point)
            self._last_pos = point

        def mouseReleaseEvent(self, event):
            if not self._dragging:
                return
            self._dragging = False
            self._release_cb()

    return {'PaintCanvas': PaintCanvas}


_classes = lazy_qt_classes(_build)


def __getattr__(name):
    if name == 'PaintCanvas':
        return _classes()[name]
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
