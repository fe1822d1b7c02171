"""The interactive labeller's window.

Counterpart of the Qt half of scripts/gui.py (PreviewStrip, LabelerWindow,
main): paint sparse class strokes over a scene's frames while a field
trains in the backend child (gui.BackendClient, gui.run_backend) and
streams back dense predictions. The labels are numpy
(ui/annotations.py), saved as grayscale PNGs that the trainer re-reads;
one composited PaintCanvas (ui/canvas.py) draws them; the client drops
stale previews, so a slow render never blocks painting.

    python -m autolabel_tpu_torch.gui <scene> [--dry]

PyQt6 and cv2 are imported at the call; PreviewStrip and LabelerWindow are
made on first use (see ui/__init__.py). The backend child runs on the
card unless the window is given device='cpu'; without a card it raises.
"""
import os

import numpy as np

from autolabel_tpu_torch import gui, visualization
from autolabel_tpu_torch.device import resolve_device
from autolabel_tpu_torch.ui import canvas, lazy_qt_classes, qt_modules
from autolabel_tpu_torch.ui.annotations import AnnotationStore
from autolabel_tpu_torch.utils import Scene, require

PREVIEW_INTERVAL_MS = 5000
PIPE_POLL_MS = 50
CANVAS_WIDTH = 720
CLASS_KEYS = '0123456789'


def _build(QtCore, QtGui, QtWidgets):

    class PreviewStrip(QtWidgets.QWidget):
        """Vertical strip of live renders: rgb / depth / feature-PCA."""

        def __init__(self):
            super().__init__()
            layout = QtWidgets.QVBoxLayout(self)
            self.views = {}
            for name in ('rgb', 'depth', 'features'):
                label = QtWidgets.QLabel(name)
                label.setScaledContents(True)
                label.setMinimumSize(160, 120)
                layout.addWidget(label)
                self.views[name] = label

        def update_preview(self, payload):
            rgb = (np.clip(payload['rgb'], 0, 1) * 255).astype(np.uint8)
            self._set('rgb', rgb)
            self._set('depth',
                      visualization.visualize_depth(payload['depth']))
            if payload.get('features') is not None:
                feat = (np.clip(payload['features'], 0, 1) *
                        255).astype(np.uint8)
                self._set('features', feat)

        def _set(self, name, array):
            array = np.ascontiguousarray(array)
            h, w = array.shape[:2]
            image = QtGui.QImage(array.data, w, h, array.strides[0],
                                 QtGui.QImage.Format.Format_RGB888)
            self.views[name].setPixmap(QtGui.QPixmap.fromImage(image.copy()))

        def clear(self):
            for label in self.views.values():
                label.setPixmap(QtGui.QPixmap())

    class LabelerWindow(QtWidgets.QMainWindow):
        """flags: gui.read_args's; device: the backend child's (the card
        unless device='cpu')."""

        def __init__(self, flags, device=None):
            super().__init__()
            self.backend_device = resolve_device(device)
            self.setWindowTitle('autolabel-tpu')
            self.scene = Scene(flags.scene)
            self.frame_names = self.scene.image_names()
            self.frame_paths = self.scene.rgb_paths()

            cam_w, cam_h = self.scene.camera.size
            canvas_size = (CANVAS_WIDTH,
                           int(round(CANVAS_WIDTH * cam_h / cam_w)))
            self.annotations = AnnotationStore(flags.scene, canvas_size)
            self.annotations.load_existing()

            self.n_classes = self.scene.n_classes or 2
            self.active_class = 1
            self.frame_index = 0
            self._photo_cache = {}

            self.canvas = canvas.PaintCanvas(canvas_size, self._on_stroke,
                                             self._on_stroke_end)
            self.previews = PreviewStrip()

            splitter = QtWidgets.QSplitter()
            splitter.addWidget(self.canvas)
            splitter.addWidget(self.previews)
            splitter.setStretchFactor(0, 3)
            splitter.setStretchFactor(1, 1)
            self.setCentralWidget(splitter)

            self.frame_slider = QtWidgets.QSlider(
                QtCore.Qt.Orientation.Horizontal)
            self.frame_slider.setRange(0, len(self.frame_names) - 1)
            self.frame_slider.valueChanged.connect(self.show_frame)
            toolbar = self.addToolBar('frames')
            toolbar.addWidget(self.frame_slider)
            self.class_indicator = QtWidgets.QLabel()
            toolbar.addWidget(self.class_indicator)
            self._update_class_indicator()

            self.backend = gui.BackendClient(flags, self._on_preview,
                                             device=self.backend_device)
            self.preview_timer = QtCore.QTimer(self)
            self.preview_timer.timeout.connect(self._request_preview)
            self.preview_timer.start(PREVIEW_INTERVAL_MS)
            self.poll_timer = QtCore.QTimer(self)
            self.poll_timer.timeout.connect(self.backend.poll)
            self.poll_timer.start(PIPE_POLL_MS)

            self.show_frame(0)

        # -- frame navigation ------------------------------------------

        @property
        def frame_name(self):
            return self.frame_names[self.frame_index]

        def show_frame(self, index):
            self.frame_index = int(index)
            photo = self._photo_cache.get(self.frame_index)
            if photo is None:
                cv2 = require('cv2', 'the labelling window')
                bgr = cv2.imread(self.frame_paths[self.frame_index])
                photo = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
                self._photo_cache[self.frame_index] = photo
            self.canvas.show_photo(photo)
            self.canvas.clear_prediction()
            self.canvas.show_labels(self.annotations.get(self.frame_name))
            self.previews.clear()
            self._request_preview()
            self.preview_timer.start(PREVIEW_INTERVAL_MS)

        # -- painting ----------------------------------------------------

        def _on_stroke(self, p0, p1):
            bitmap = self.annotations.paint_stroke(self.frame_name, p0, p1,
                                                   self.active_class,
                                                   self.canvas.brush_radius)
            self.canvas.show_labels(bitmap)

        def _on_stroke_end(self):
            if self.annotations.save(self.frame_name):
                self.backend.labels_changed(self.frame_index)

        def select_class(self, class_id):
            # Re-selecting the active class flips back to background.
            self.active_class = (0 if class_id == self.active_class
                                 else class_id)
            self._update_class_indicator()

        def _update_class_indicator(self):
            self.class_indicator.setText(f'  class: {self.active_class}  ')

        def clear_current_frame(self):
            self.annotations.clear(self.frame_name)
            path = os.path.join(self.annotations.semantic_dir,
                                f'{self.frame_name}.png')
            if os.path.exists(path):
                os.remove(path)
            self.canvas.show_labels(self.annotations.get(self.frame_name))
            self.backend.labels_changed(self.frame_index)

        # -- backend -----------------------------------------------------

        def _request_preview(self):
            self.backend.request_preview(self.frame_index)

        def _on_preview(self, payload):
            self.canvas.show_prediction(payload['semantic'])
            self.previews.update_preview(payload)

        def save_session(self):
            self.annotations.save_all()
            self.backend.save_checkpoint()

        # -- keys / lifecycle --------------------------------------------

        def keyPressEvent(self, event):
            key = event.key()
            ctrl = (event.modifiers()
                    & QtCore.Qt.KeyboardModifier.ControlModifier)
            if key in (QtCore.Qt.Key.Key_Escape, QtCore.Qt.Key.Key_Q):
                self.close()
            elif key == QtCore.Qt.Key.Key_S and ctrl:
                self.save_session()
            elif key == QtCore.Qt.Key.Key_C:
                self.clear_current_frame()
            else:
                text = event.text()
                if text in CLASS_KEYS and int(text) < self.n_classes:
                    self.select_class(int(text))

        def closeEvent(self, event):
            self.backend.stop()
            event.accept()

    return {'PreviewStrip': PreviewStrip, 'LabelerWindow': LabelerWindow}


_classes = lazy_qt_classes(_build)


def __getattr__(name):
    if name in ('PreviewStrip', 'LabelerWindow'):
        return _classes()[name]
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


def main(argv=None, device=None):
    """Open the window over the scene of argv (gui.read_args's flags) and
    run Qt's event loop until it closes."""
    flags = gui.read_args(argv)
    QtWidgets = qt_modules()[2]
    app = QtWidgets.QApplication([])
    window = _classes()['LabelerWindow'](flags, device=device)
    window.show()
    return app.exec()
