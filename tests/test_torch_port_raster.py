"""The port's polygon fill (utils/raster.py) against cv2.fillPoly, and
Scene.gt_masks against the JAX package's, on the CPU.

fill_poly is held bit-equal to cv2.fillPoly(mask, polygon[None], value)
(LINE_8, shift 0) on polygons drawn by hypothesis: concave and
self-intersecting ones, horizontal edges, vertices on and beyond the
border, 1- and 2-vertex shapes, several shapes drawn into one mask in
turn. Scene.gt_masks is bit-equal to the JAX package's on the scenes of
tests/synthetic.py and tests/room.py (polygons traced by
cv2.findContours) and on the port's annotated fixtures (the analytic
outlines, float vertices).
"""
import json
import os

import cv2
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from autolabel_tpu import utils as jax_utils
from autolabel_tpu_torch import utils
from autolabel_tpu_torch.utils import fixtures
from autolabel_tpu_torch.utils.raster import fill_poly
from tests.room import make_room_scene
from tests.synthetic import make_synthetic_scene

SETTINGS = settings(max_examples=300, deadline=None, database=None,
                    derandomize=True,
                    suppress_health_check=[HealthCheck.too_slow])


def _both(shape, polygons):
    """The mask cv2 fills and the one fill_poly fills, polygons in turn
    (value k + 1 for the k-th)."""
    ref = np.zeros(shape, np.uint8)
    ours = np.zeros(shape, np.uint8)
    for k, polygon in enumerate(polygons):
        polygon = np.asarray(polygon, np.int32)
        ref = cv2.fillPoly(ref, polygon[None], k + 1)
        got = fill_poly(ours, polygon, k + 1)
        assert got is ours
    return ours, ref


def _vertices(lo, hi, min_size=1, max_size=10):
    return st.lists(st.tuples(st.integers(lo, hi), st.integers(lo, hi)),
                    min_size=min_size, max_size=max_size)


@st.composite
def _scenes(draw, lo=-30, hi=70):
    """(h, w) and 1 to 3 polygons; a polygon's y may be pinned to one
    value on runs of vertices, which makes horizontal edges."""
    h = draw(st.integers(1, 48))
    w = draw(st.integers(1, 48))
    polygons = []
    for _ in range(draw(st.integers(1, 3))):
        points = draw(_vertices(lo, hi))
        if len(points) > 1 and draw(st.booleans()):
            y = points[0][1]
            points = [(x, y) if i % 2 == 0 else (x, py)
                      for i, (x, py) in enumerate(points)]
        polygons.append(points)
    return (h, w), polygons


@SETTINGS
@given(_scenes())
def test_fill_poly_bit_equal_to_cv2(scene):
    shape, polygons = scene
    ours, ref = _both(shape, polygons)
    assert np.array_equal(ours, ref)


@SETTINGS
@given(_scenes(lo=0, hi=47))
def test_fill_poly_bit_equal_to_cv2_inside(scene):
    """Vertices inside or on the border of the frame (mostly)."""
    shape, polygons = scene
    ours, ref = _both(shape, polygons)
    assert np.array_equal(ours, ref)


@SETTINGS
@given(st.integers(1, 40), st.integers(1, 40), _vertices(-10, 50, 1, 2))
def test_fill_poly_points_and_segments(h, w, polygon):
    ours, ref = _both((h, w), [polygon])
    assert np.array_equal(ours, ref)


@pytest.mark.parametrize('polygon', [
    [(0, 0), (10, 0), (10, 10), (0, 10)],             # the square
    [(0, 0), (10, 10), (10, 0), (0, 10)],             # a bow tie
    [(2, 2), (20, 2), (20, 20), (11, 5), (2, 20)],    # concave
    [(5, 0), (5, 30), (6, 0), (6, 30), (20, 15)],     # crossing spikes
    [(-5, -5), (40, -5), (40, 40), (-5, 40)],         # over the whole frame
    [(0, 0), (31, 0), (31, 23), (0, 23)],             # on the border
    [(3, 3), (3, 3), (3, 3)],                         # one point, thrice
    [(-100, 10), (100, 12), (0, 20)],                 # far beyond both sides
    [(10, -100), (12, 100), (20, 0)],                 # far above and below
])
def test_fill_poly_cases(polygon):
    ours, ref = _both((24, 32), [polygon])
    assert np.array_equal(ours, ref)


def test_fill_poly_draws_shapes_in_turn():
    shapes = [[(0, 0), (20, 0), (20, 20)], [(5, 5), (30, 5), (5, 20)],
              [(10, 0), (10, 23)]]
    ours, ref = _both((24, 32), shapes)
    assert np.array_equal(ours, ref) and set(np.unique(ours)) == {0, 1, 2, 3}


def test_fill_poly_refuses_non_integer_vertices():
    with pytest.raises(ValueError):
        fill_poly(np.zeros((4, 4), np.uint8), np.array([[0.5, 1.0]]), 1)
    with pytest.raises(ValueError):
        fill_poly(np.zeros((4, 4), np.uint8), np.zeros((0, 2), np.int32), 1)


# -- Scene.gt_masks ----------------------------------------------------------

def _assert_gt_masks_equal(scene_dir, sizes):
    ours_scene, ref_scene = utils.Scene(scene_dir), jax_utils.Scene(scene_dir)
    for size in sizes:
        ours, ref = ours_scene.gt_masks(size), ref_scene.gt_masks(size)
        assert [i for i, _ in ours] == [i for i, _ in ref]
        assert ours
        for (_, a), (_, b) in zip(ours, ref):
            assert a.dtype == b.dtype == np.uint8
            assert a.shape == b.shape == (size[1], size[0])
            assert np.array_equal(a, b)
    return ours


@pytest.fixture(scope='module')
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp('gt_masks')
    paths = {'synthetic': str(root / 'synthetic'), 'room': str(root / 'room'),
             'fixture_sphere': str(root / 'fixture_sphere'),
             'fixture_room': str(root / 'fixture_room')}
    make_synthetic_scene(paths['synthetic'], n_frames=12, width=48,
                         height=36)
    make_room_scene(paths['room'], n_frames=24, width=64, height=48)
    fixtures.make_synthetic_scene(paths['fixture_sphere'], n_frames=12,
                                  width=48, height=36, annotate=True)
    fixtures.make_room_scene(paths['fixture_room'], n_frames=24, width=64,
                             height=48, annotate=True)
    return paths


@pytest.mark.parametrize('name', ['synthetic', 'room', 'fixture_sphere',
                                  'fixture_room'])
def test_gt_masks_bit_equal_to_jax(scenes, name):
    """At the frame size, at the CLIs' factor 4 and at a size that scales
    the polygons up."""
    _assert_gt_masks_equal(scenes[name], [(48, 36), (12, 9), (160, 120)])


def test_gt_masks_of_the_fixture_cover_the_sphere(scenes):
    """The analytic outline covers the rendered silhouette but for its
    rim."""
    from autolabel_tpu_torch.utils.images import read_png
    path = scenes['fixture_sphere']
    for index, mask in utils.Scene(path).gt_masks((48, 36)):
        silhouette = read_png(os.path.join(path, 'gt_semantic',
                                           f'{index}.png')) == 2
        inside = mask.astype(bool)
        assert (silhouette & inside).sum() >= 0.98 * silhouette.sum()
        assert (inside & ~silhouette).sum() <= 0.2 * silhouette.sum()


def test_gt_masks_without_the_directory(tmp_path):
    fixtures.make_synthetic_scene(str(tmp_path / 's'), n_frames=3)
    assert utils.Scene(str(tmp_path / 's')).gt_masks((48, 36)) == []


def test_gt_mask_scales_polygons_as_jax(tmp_path):
    """A polygon given at another annotation size is scaled and truncated
    to int32 as the JAX reader does."""
    scene = str(tmp_path / 's')
    fixtures.make_synthetic_scene(scene, n_frames=3, annotate=True)
    with open(os.path.join(scene, 'gt_masks', '0.json'), 'w') as f:
        json.dump({'imageWidth': 97, 'imageHeight': 71, 'shapes': [
            {'label': 'a', 'points': [[3.7, 2.2], [90.1, 10.9],
                                      [50.5, 70.99]]},
            {'label': 'b', 'points': [[-4.5, 30.0], [20.0, 30.0]]}]}, f)
    _assert_gt_masks_equal(scene, [(48, 36), (97, 71), (33, 20)])
