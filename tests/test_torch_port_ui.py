"""The port's labelling front end (ui/annotations.py, ui/canvas.py,
ui/window.py, gui.main) against autolabel_tpu/ui/annotations.py and
scripts/gui.py, on the CPU.

Inputs are drawn from seeded numpy generators. Tolerances: none. Stroke
bitmaps (radii 1-12, classes 0-39, endpoints off the canvas included),
both overlays, the PNGs save writes, load_existing's nearest rescale and
clear are bit-equal (byte-equal for the files) to JAX's. The window runs
with PyQt6 (no dependency of either package) stood in for by
tests/qt_stub.py, --dry over the sphere fixture, through the steps of
tests/test_gui.py::test_gui_dry_structural; the PNG its strokes write is
byte-equal to the one scripts/gui.py's window writes for the same strokes.
"""
import argparse
import importlib
import os
import shutil
import sys

import cv2
import numpy as np
import pytest
import torch

from autolabel_tpu.ui import annotations as jax_annotations
from autolabel_tpu_torch import gui
from autolabel_tpu_torch.ui import annotations, canvas, window
from autolabel_tpu_torch.utils import MissingDependency
from tests import qt_stub

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (0, 1, 2, 3)


def _strokes(seed, size, n=24):
    """Seeded strokes: (p0, p1, class_id, radius), a quarter of the
    endpoints off the canvas, some of them points (p0 == p1)."""
    rng = np.random.default_rng(seed)
    w, h = size
    out = []
    for i in range(n):
        lo, hi = np.array([-0.25 * w, -0.25 * h]), np.array([1.25 * w,
                                                             1.25 * h])
        p0 = rng.uniform(lo, hi)
        p1 = p0 if i % 7 == 0 else rng.uniform(lo, hi)
        out.append(((float(p0[0]), float(p0[1])),
                    (float(p1[0]), float(p1[1])), int(rng.integers(0, 40)),
                    int(rng.integers(1, 13))))
    return out


def _stores(tmp_path, size):
    return (jax_annotations.AnnotationStore(str(tmp_path / 'jax'), size),
            annotations.AnnotationStore(str(tmp_path / 'port'), size))


@pytest.mark.parametrize('seed', SEEDS)
def test_strokes_bit_equal(tmp_path, seed):
    size = ((64, 48), (97, 31), (160, 120), (33, 77))[seed]
    ref, ours = _stores(tmp_path, size)
    for p0, p1, class_id, radius in _strokes(seed, size):
        want = ref.paint_stroke('f', p0, p1, class_id, radius).copy()
        got = ours.paint_stroke('f', p0, p1, class_id, radius)
        np.testing.assert_array_equal(got, want)
    assert ours.get('f').any()
    # the default brush
    np.testing.assert_array_equal(
        ours.paint_stroke('g', (3.4, 5.6), (20.5, 9.5), 2),
        ref.paint_stroke('g', (3.4, 5.6), (20.5, 9.5), 2))


@pytest.mark.parametrize('seed', SEEDS)
def test_overlays_bit_equal(seed):
    rng = np.random.default_rng(10 + seed)
    bitmap = rng.integers(0, 41, (23, 31)).astype(np.uint8)
    np.testing.assert_array_equal(annotations.paint_overlay_rgba(bitmap),
                                  jax_annotations.paint_overlay_rgba(bitmap))
    classes = rng.integers(-50, 300, (19, 27))
    np.testing.assert_array_equal(
        annotations.prediction_overlay_rgba(classes),
        jax_annotations.prediction_overlay_rgba(classes))
    assert (annotations.PAINT_ALPHA, annotations.PREDICTION_ALPHA,
            annotations.DEFAULT_BRUSH_RADIUS) == (
        jax_annotations.PAINT_ALPHA, jax_annotations.PREDICTION_ALPHA,
        jax_annotations.DEFAULT_BRUSH_RADIUS)


@pytest.mark.parametrize('seed', SEEDS[:2])
def test_save_load_clear_bit_equal(tmp_path, seed):
    size = (72, 54)
    ref, ours = _stores(tmp_path, size)
    for frame in ('a', 'b', 'c'):
        ref.get(frame), ours.get(frame)  # 'c' stays empty
    for frame, strokes in (('a', _strokes(seed, size, 6)),
                           ('b', _strokes(seed + 5, size, 3))):
        for p0, p1, class_id, radius in strokes:
            ref.paint_stroke(frame, p0, p1, class_id, radius)
            ours.paint_stroke(frame, p0, p1, class_id, radius)
    paths = ours.save_all()
    want = ref.save_all()
    assert [os.path.basename(p) for p in paths] == ['a.png', 'b.png']
    assert [os.path.basename(p) for p in want] == ['a.png', 'b.png']
    assert ours.save('c') is None and ref.save('c') is None
    for got, exp in zip(paths, want):
        with open(got, 'rb') as f, open(exp, 'rb') as g:
            assert f.read() == g.read()

    # Label PNGs of other sizes (and a non-PNG, and an unreadable PNG)
    # picked up at the canvas size by nearest rescale.
    rng = np.random.default_rng(20 + seed)
    labels = {stem: rng.integers(0, 9, shape).astype(np.uint8)
              for stem, shape in (('d', (100, 200)), ('e', (17, 13)),
                                  ('f', (54, 72)))}
    for root in ('jax', 'port'):
        semantic = tmp_path / root / 'semantic'
        for stem, label in labels.items():
            cv2.imwrite(str(semantic / f'{stem}.png'), label)
        (semantic / 'notes.txt').write_text('not a label')
        (semantic / 'broken.png').write_bytes(b'not a png')
    fresh_ref = jax_annotations.AnnotationStore(str(tmp_path / 'jax'), size)
    fresh = annotations.AnnotationStore(str(tmp_path / 'port'), size)
    fresh_ref.load_existing()
    fresh.load_existing()
    assert fresh.frames() == fresh_ref.frames()
    assert sorted(fresh.frames()) == ['a', 'b', 'd', 'e', 'f']
    for frame in fresh.frames():
        assert fresh.get(frame).shape == (54, 72)
        np.testing.assert_array_equal(fresh.get(frame),
                                      fresh_ref.get(frame))
    np.testing.assert_array_equal(fresh.get('a'), ours.get('a'))
    for store in (fresh, fresh_ref):
        store.clear('a')
        assert store.is_empty('a') and store.get('a').shape == (54, 72)
    assert fresh.is_empty('never') and not fresh.is_empty('b')


# -- tests/test_gui.py's annotation cases, on the port ------------------------

def test_paint_stroke_writes_class_plus_one(tmp_path):
    store = annotations.AnnotationStore(str(tmp_path), (64, 48))
    bitmap = store.paint_stroke('frame0', (10, 10), (30, 10), class_id=1,
                                radius=3)
    assert bitmap.shape == (48, 64)
    assert bitmap[10, 20] == 2  # class 1 -> pixel value 2
    assert bitmap[40, 50] == 0  # untouched pixels stay unlabeled
    assert bitmap[10, 8] == 2  # round caps extend past the endpoints


def test_save_load_roundtrip(tmp_path):
    store = annotations.AnnotationStore(str(tmp_path), (32, 24))
    assert store.save('f1') is None  # empty canvases are not persisted
    store.paint_stroke('f1', (5, 5), (20, 5), class_id=0)
    path = store.save('f1')
    assert path and os.path.exists(path)
    png = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    assert png.shape == (24, 32)
    assert png[5, 10] == 1  # class 0 -> value 1
    fresh = annotations.AnnotationStore(str(tmp_path), (32, 24))
    fresh.load_existing()
    np.testing.assert_array_equal(fresh.get('f1'), store.get('f1'))


def test_load_existing_rescales(tmp_path):
    semantic = tmp_path / 'semantic'
    semantic.mkdir()
    big = np.zeros((100, 200), np.uint8)
    big[:50] = 3
    cv2.imwrite(str(semantic / 'f2.png'), big)
    store = annotations.AnnotationStore(str(tmp_path), (20, 10))
    store.load_existing()
    bitmap = store.get('f2')
    assert bitmap.shape == (10, 20)
    assert bitmap[0, 0] == 3 and bitmap[9, 0] == 0


def test_clear(tmp_path):
    store = annotations.AnnotationStore(str(tmp_path), (16, 16))
    store.paint_stroke('f', (4, 4), (8, 8), class_id=2)
    assert not store.is_empty('f')
    store.clear('f')
    assert store.is_empty('f')


def test_overlays():
    bitmap = np.array([[0, 1], [2, 0]], np.uint8)
    rgba = annotations.paint_overlay_rgba(bitmap)
    assert rgba.shape == (2, 2, 4)
    assert rgba[0, 0, 3] == 0  # unlabeled -> transparent
    assert rgba[0, 1, 3] == 175 and rgba[1, 0, 3] == 175
    pred = annotations.prediction_overlay_rgba(np.array([[0, 1]]))
    assert pred.shape == (1, 2, 4)
    assert (pred[..., 3] == 120).all()


# -- the window, with Qt stood in for ----------------------------------------

@pytest.fixture()
def jax_gui():
    """scripts/gui.py imported under the Qt stand-in."""
    qt_stub.install()
    sys.path.insert(0, os.path.join(REPO, 'scripts'))
    try:
        sys.modules.pop('gui', None)
        module = importlib.import_module('gui')
        yield module
    finally:
        sys.modules.pop('gui', None)
        sys.path.remove(os.path.join(REPO, 'scripts'))


def _dry_flags(scene):
    return gui.read_args([scene, '--dry', '--batch-size', '512'])


def _unlabelled(sphere_scene, path):
    shutil.copytree(sphere_scene, path)
    shutil.rmtree(os.path.join(path, 'semantic'))  # start unlabelled
    return str(path)


def _paint(win, strokes):
    for p0, p1, class_id, radius in strokes:
        win.active_class = class_id
        win.canvas.brush_radius = radius
        win._on_stroke(p0, p1)
    win._on_stroke_end()


def test_window_dry_matches_scripts_gui(jax_gui, sphere_scene, tmp_path):
    """The port's LabelerWindow through test_gui_dry_structural's steps,
    beside scripts/gui.py's window fed the same strokes."""
    scene = _unlabelled(sphere_scene, tmp_path / 'port')
    jscene = _unlabelled(sphere_scene, tmp_path / 'jax')
    win = window.LabelerWindow(_dry_flags(scene), device='cpu')
    ref = jax_gui.LabelerWindow(argparse.Namespace(
        scene=jscene, batch_size=512, dry=True, lr=1e-4, features=None))
    assert win.frame_names == ref.frame_names and len(win.frame_names) == 12
    assert win.active_class == 1 and win.n_classes == ref.n_classes
    assert (win.annotations.width, win.annotations.height) == (
        ref.annotations.width, ref.annotations.height)

    # A stroke on frame 0; mouse-up writes the PNG.
    for w in (win, ref):
        w.show_frame(0)
        w._on_stroke((100.0, 100.0), (200.0, 100.0))
        w._on_stroke_end()
    name = win.frame_name
    png_path = os.path.join(scene, 'semantic', f'{name}.png')
    saved = cv2.imread(png_path, cv2.IMREAD_GRAYSCALE)
    assert saved.max() == 2  # active class 1 -> value 2
    np.testing.assert_array_equal(win._photo_cache[0], ref._photo_cache[0])

    # Seeded strokes of other classes and brushes on frame 5: both
    # windows write the same bytes.
    strokes = [(p0, p1, c % win.n_classes, r) for p0, p1, c, r in
               _strokes(7, (win.annotations.width, win.annotations.height),
                        12)]
    for w in (win, ref):
        w.show_frame(5)
        _paint(w, strokes)
        w.canvas.brush_radius = annotations.DEFAULT_BRUSH_RADIUS
        w.active_class = 1
    for frame in (name, win.frame_name):
        with open(os.path.join(scene, 'semantic', f'{frame}.png'), 'rb') as f:
            got = f.read()
        with open(os.path.join(jscene, 'semantic', f'{frame}.png'),
                  'rb') as f:
            assert got == f.read(), frame

    # Class toggle: selecting the active class flips to background.
    win.select_class(1)
    assert win.active_class == 0
    win.select_class(1)
    assert win.active_class == 1

    # Navigation keeps per-frame annotations separate.
    win.show_frame(3)
    assert win.annotations.is_empty(win.frame_name)
    win.show_frame(0)
    assert not win.annotations.is_empty(win.frame_name)

    # Clear removes the persisted PNG.
    win.clear_current_frame()
    assert not os.path.exists(png_path)
    assert win.annotations.is_empty(win.frame_name)

    # Preview dispatch renders without a live backend.
    rng = np.random.default_rng(0)
    h, w = 36, 48
    for features in (None, rng.random((h, w, 3)).astype(np.float32)):
        win._on_preview({
            'image_index': 0,
            'rgb': rng.random((h, w, 3)).astype(np.float32),
            'depth': rng.random((h, w)).astype(np.float32),
            'semantic': rng.integers(0, 2, (h, w)),
            'features': features,
        })
    win.save_session()  # dry backend: must not raise
    win.closeEvent(qt_stub._Stub())
    assert not win.backend.live


def test_backend_client_dry_is_inert():
    client = gui.BackendClient(argparse.Namespace(dry=True),
                               on_preview=lambda p: None)
    assert not client.live
    client.request_preview(0)
    client.labels_changed(0)
    client.save_checkpoint()
    client.poll()
    assert client.stop() is None


def test_window_raises_without_a_card(sphere_scene, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    qt_stub.install()
    scene = _unlabelled(sphere_scene, tmp_path / 'scene')
    with pytest.raises(RuntimeError, match='CUDA'):
        window.LabelerWindow(_dry_flags(scene))


def test_qt_classes_follow_the_modules_present(monkeypatch):
    """Without PyQt6 the widget classes raise naming it, at first use; a
    stand-in put in later is picked up then."""
    for name in ('PyQt6', 'PyQt6.QtCore', 'PyQt6.QtGui', 'PyQt6.QtWidgets'):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(MissingDependency, match='PyQt6'):
        canvas.PaintCanvas
    with pytest.raises(MissingDependency, match='PyQt6'):
        window.LabelerWindow
    with pytest.raises(MissingDependency, match='PyQt6'):
        gui.main(['scene', '--dry'], device='cpu')
    with pytest.raises(AttributeError):
        canvas.NoSuchWidget
    for name in ('PyQt6', 'PyQt6.QtCore', 'PyQt6.QtGui', 'PyQt6.QtWidgets'):
        monkeypatch.delitem(sys.modules, name)
    qt_stub.install()
    first = canvas.PaintCanvas
    assert first is canvas.PaintCanvas  # made once for these modules
    assert isinstance(first((64, 48), None, None), qt_stub._Stub)


def test_annotations_without_cv2_raise_naming_it(tmp_path, monkeypatch):
    store = annotations.AnnotationStore(str(tmp_path), (8, 8))
    monkeypatch.setitem(sys.modules, 'cv2', None)
    with pytest.raises(MissingDependency, match='cv2'):
        store.paint_stroke('f', (1, 1), (4, 4), 0)
    assert store.save('f') is None  # nothing to write needs no cv2
