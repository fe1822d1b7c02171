"""The port's IncrementalSfM against autolabel_tpu.mapping.sfm on the CPU.

The stages that need no cv2 on equal constructed states (the track
bookkeeping, bundle adjustment, pruning, pose-outlier and tear removal,
the COLMAP model), the cv2 front end on a small tests/room.py capture
(cv2 is on this host), the COLMAP text model read back by both packages,
and, in a fresh interpreter where cv2 cannot be imported, the mapping
package and bundle adjustment working while the front end raises naming
cv2.
"""
import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from autolabel_tpu.mapping import sfm as jsfm
from autolabel_tpu.utils import colmap_text as jcolmap
from autolabel_tpu_torch.mapping import sfm
from autolabel_tpu_torch.utils import colmap_text

cv2 = pytest.importorskip('cv2')
sys.path.insert(0, os.path.dirname(__file__))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATE = ('registered', 'tracks', 'points', 'kps', 'track_of_kp', 'failed')


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(n, K=np.eye(3), shape=(8, 8)):
    images = [(f'{i}.png', np.zeros(shape, np.uint8)) for i in range(n)]
    return jsfm.IncrementalSfM(images, K), sfm.IncrementalSfM(images, K,
                                                              device='cpu')


def _copy_state(src, *dsts):
    for dst in dsts:
        for key in STATE:
            setattr(dst, key, copy.deepcopy(getattr(src, key)))


def _assert_same_state(a, b, atol=0.0):
    assert sorted(a.registered) == sorted(b.registered)
    for f in a.registered:
        for x, y in zip(a.registered[f], b.registered[f]):
            np.testing.assert_allclose(x, y, rtol=0, atol=atol)
    assert a.tracks == b.tracks
    assert sorted(a.points) == sorted(b.points)
    for t in a.points:
        np.testing.assert_allclose(a.points[t], b.points[t], rtol=0,
                                   atol=atol)
    assert a.track_of_kp == b.track_of_kp
    assert a.failed == b.failed


def _look_at(center, target=(0.0, 0.0, 0.0)):
    z = np.asarray(target) - center
    z /= np.linalg.norm(z)
    x = np.cross(np.array([0, 0, 1.0]), z)
    x /= np.linalg.norm(x)
    R = np.stack([x, np.cross(z, x), z])
    return R, -R @ center


def _constructed(seed, n_frames=10, n_points=150, noise=0.3, outliers=0.0,
                 ghost=False):
    """A registered state from known geometry: frames on an arc around
    points near the origin, tracks of 3 to 6 consecutive frames with
    keypoints at the projections plus noise (and a share of outliers), the
    poses and points perturbed (world -> camera, COLMAP's convention).
    ghost: frames 7.. displaced by 2 units (a torn sub-map)."""
    rng = np.random.default_rng(seed)
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    js, ts = _pair(n_frames, K, (240, 320))
    poses = []
    for i in range(n_frames):
        a = 0.8 * i / n_frames
        poses.append(_look_at(np.array([3 * np.cos(a), 3 * np.sin(a),
                                        0.5 + 0.1 * i / n_frames])))
    pts = rng.uniform(-1, 1, size=(n_points, 3))
    kps = [[] for _ in range(n_frames)]
    tracks, track_of_kp = {}, {}
    for t in range(n_points):
        first = rng.integers(0, n_frames - 2)
        frames = range(first, min(n_frames, first + rng.integers(3, 7)))
        tracks[t] = {}
        for f in frames:
            R, tv = poses[f]
            xc = R @ pts[t] + tv
            uv = (K @ xc)[:2] / xc[2] + rng.normal(scale=noise, size=2)
            if rng.random() < outliers:
                uv += rng.uniform(20, 40, 2) * rng.choice([-1, 1], 2)
            tracks[t][f] = len(kps[f])
            track_of_kp[(f, len(kps[f]))] = t
            kps[f].append(uv)
    js.kps = [np.array(k, np.float64).reshape(-1, 2) for k in kps]
    js.tracks, js.track_of_kp = tracks, track_of_kp
    js.registered = {}
    for f, (R, tv) in enumerate(poses):
        dR = cv2.Rodrigues(rng.normal(scale=0.002, size=3))[0]
        shift = np.array([0.0, 2.0 if ghost and f >= 7 else 0.0, 0.0])
        js.registered[f] = (dR @ R, tv + rng.normal(scale=0.01, size=3)
                            - dR @ R @ shift)
    js.points = {t: pts[t] + rng.normal(scale=0.01, size=3)
                 for t in range(n_points)}
    _copy_state(js, ts)
    return js, ts


def test_drop_tear_frames_excises_displaced_branch_as_jax():
    """tests/test_mapping_sfm.py's torn trajectory, in both packages."""
    n = 12
    js, ts = _pair(n)
    for i in range(n):
        c = np.array([0.1 * i, 0.0, 0.0])
        if i >= 8:
            c = c + np.array([0.0, 5.0, 0.0])
        js.registered[i] = (np.eye(3), -c)
    js.tracks = {0: {8: 0, 9: 0}, 1: {0: 0, 1: 0}}
    js.points = {0: np.zeros(3), 1: np.ones(3)}
    _copy_state(js, ts)
    assert ts._drop_tear_frames() == js._drop_tear_frames() == 4
    assert sorted(ts.registered) == list(range(8))
    assert 0 not in ts.points and 1 in ts.points
    _assert_same_state(js, ts)


def test_drop_tear_frames_keeps_smooth_trajectory_as_jax():
    js, ts = _pair(10)
    rng = np.random.default_rng(3)
    for i in range(10):
        if i == 4:
            continue
        c = np.array([0.1 * i, 0.02 * rng.normal(), 0.0])
        js.registered[i] = (np.eye(3), -c)
    js.tracks, js.points = {}, {}
    _copy_state(js, ts)
    assert ts._drop_tear_frames() == js._drop_tear_frames() == 0
    assert len(ts.registered) == 9
    _assert_same_state(js, ts)


def test_observations_order_as_jax():
    js, ts = _constructed(0)
    for f in (2, 5):  # holes: tracks with unregistered frames
        del js.registered[f]
        del ts.registered[f]
    cams_j, pids_j, (ci_j, pi_j, xy_j) = js._observations()
    cams_t, pids_t, (ci_t, pi_t, xy_t) = ts._observations()
    assert cams_t == cams_j and pids_t == pids_j
    np.testing.assert_array_equal(ci_t, ci_j)
    np.testing.assert_array_equal(pi_t, pi_j)
    np.testing.assert_array_equal(xy_t, xy_j)


def _deviation(a, b):
    """The largest difference of two states' poses and points."""
    dev = 0.0
    for f in a.registered:
        for x, y in zip(a.registered[f], b.registered[f]):
            dev = max(dev, float(np.abs(x - y).max()))
    for t in a.points:
        dev = max(dev, float(np.abs(a.points[t] - b.points[t]).max()))
    return dev


def _ulp_moved(js):
    """A copy of a JAX state with every point moved up by one fp32 ulp
    (the solve reads fp32): the rounding-level change that sizes JAX's
    own sensitivity."""
    moved = copy.deepcopy(js)
    moved.K = js.K.copy()
    moved.points = {t: np.nextafter(np.float32(p), np.float32(np.inf))
                    .astype(np.float64) for t, p in js.points.items()}
    return moved


# The port's _run_ba lies within this factor of JAX's own spread: 15
# fp32 LM steps of 50 CG iterations do not converge on these problems, so
# a one-ulp change of JAX's input moves JAX's result by 1e-4 to 7e-3; the
# port's result differs from JAX's by 0.2 to 1.1 times that (measured on
# these seeds).
SPREAD_ROOM = 4.0


@pytest.mark.parametrize('outliers', [0.0, 0.05])
def test_run_ba_then_prune_as_jax(outliers):
    """`_run_ba` (K9's arithmetic on the CPU against XLA's autodiff) on a
    constructed state: poses and points no further from JAX's than
    SPREAD_ROOM times JAX's own spread (`_ulp_moved`), the rms within 1e-4
    of JAX's (relative); then `_prune_outliers` and `_drop_pose_outliers`
    on the JAX result, copied into both: equal decisions and states."""
    js, ts = _constructed(1, outliers=outliers)
    jm = _ulp_moved(js)
    for state in (js, ts, jm):
        state._run_ba(max_iters=15)
    spread = _deviation(js, jm)
    assert 0 < _deviation(js, ts) <= SPREAD_ROOM * spread
    assert abs(ts.ba_rms_px - js.ba_rms_px) <= 1e-4 * js.ba_rms_px
    np.testing.assert_array_equal(ts.K, js.K)
    assert ts.tracks == js.tracks
    _copy_state(js, ts)
    pruned = js._prune_outliers()
    assert ts._prune_outliers() == pruned
    assert (pruned > 0) == (outliers > 0)
    assert ts._drop_pose_outliers() == js._drop_pose_outliers()
    _assert_same_state(js, ts)


def test_run_ba_refine_focal_as_jax():
    """A focal 10% wrong: the refined focal within 1e-4 of JAX's
    (relative), pulled more than halfway to the truth, poses and points as
    in test_run_ba_then_prune_as_jax."""
    js, ts = _constructed(2)
    js.K[0, 0] = js.K[1, 1] = 330.0
    ts.K = js.K.copy()
    jm = _ulp_moved(js)
    for state in (js, ts, jm):
        state._run_ba(refine_focal=True, max_iters=15)
    assert abs(ts.K[0, 0] - js.K[0, 0]) <= 1e-4 * js.K[0, 0]
    assert abs(ts.K[0, 0] - 300.0) < 0.5 * abs(330.0 - 300.0)
    assert _deviation(js, ts) <= SPREAD_ROOM * _deviation(js, jm)


def test_drop_pose_outliers_drops_a_ghost_as_jax():
    """A displaced tail reprojects the shared structure badly: the median
    error rule drops the same frames in both packages."""
    js, ts = _constructed(3, ghost=True)
    dropped = js._drop_pose_outliers()
    assert ts._drop_pose_outliers() == dropped > 0
    _assert_same_state(js, ts)


def test_write_colmap_model_and_read_back_both_ways(tmp_path):
    js, ts = _constructed(4)
    js.names = ts.names = [f'frame_{i}.png' for i in range(len(js.images))]
    js.write_colmap_model(str(tmp_path / 'jax'))
    ts.write_colmap_model(str(tmp_path / 'port'))
    for name in ('cameras.txt', 'images.txt', 'points3D.txt'):
        assert (tmp_path / 'jax' / name).read_bytes() \
            == (tmp_path / 'port' / name).read_bytes(), name
    a = colmap_text.ColmapTextModel(str(tmp_path / 'jax'))
    b = jcolmap.ColmapTextModel(str(tmp_path / 'port'))
    assert a.cameras.keys() == b.cameras.keys()
    np.testing.assert_array_equal(a.cameras[1].params, b.cameras[1].params)
    assert a.images.keys() == b.images.keys()
    for k in a.images:
        ia, ib = a.images[k], b.images[k]
        assert ia.name == ib.name
        np.testing.assert_array_equal(ia.rotmat(), ib.rotmat())
        np.testing.assert_array_equal(ia.tvec, ib.tvec)
        assert [(tuple(p.xy), p.point3D_id) for p in ia.get_valid_points2D()] \
            == [(tuple(p.xy), p.point3D_id) for p in ib.get_valid_points2D()]
    assert a.points3D.keys() == b.points3D.keys()
    for k in a.points3D:
        np.testing.assert_array_equal(a.points3D[k].xyz, b.points3D[k].xyz)
    # the port's model holds what it wrote
    R, t = ts.registered[0]
    img = a.images[1]
    np.testing.assert_allclose(img.rotmat(), R, atol=1e-12)
    np.testing.assert_allclose(img.tvec, t, atol=0)


def test_colmap_text_helpers_as_jax(tmp_path):
    rng = np.random.default_rng(5)
    for _ in range(10):
        Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        Q *= np.sign(np.linalg.det(Q))
        np.testing.assert_array_equal(colmap_text.rotmat_to_qvec(Q),
                                      jcolmap.rotmat_to_qvec(Q))
    for R in (np.eye(3), np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1])):
        np.testing.assert_array_equal(colmap_text.rotmat_to_qvec(R),
                                      jcolmap.rotmat_to_qvec(R))
    # An image with no keypoints writes an empty body line, read back by
    # both parsers without losing the pairing.
    cam = colmap_text.ColmapCamera(1, 'OPENCV', 64, 48,
                                   np.array([50.0, 50, 32, 24, 0, 0, 0, 0]))
    images = [colmap_text.ColmapImage(1, [1, 0, 0, 0], [0, 0, 0], 1, 'a.png',
                                      []),
              colmap_text.ColmapImage(2, [1, 0, 0, 0], [1, 2, 3], 1, 'b.png',
                                      [colmap_text.ColmapPoint2D(
                                          np.array([1.5, 2.5]), 7)])]
    points = {7: colmap_text.ColmapPoint3D(7, np.array([0.1, 0.2, 0.3]),
                                           np.array([1, 2, 3]), 0.5)}
    colmap_text.write_text_model(str(tmp_path), cam, images, points)
    for parser in (colmap_text.ColmapTextModel, jcolmap.ColmapTextModel):
        model = parser(str(tmp_path))
        assert [len(model.images[k].points2D) for k in (1, 2)] == [0, 1]
        assert model.images[2].points2D[0].point3D_id == 7
    assert type(colmap_text.load_reconstruction(str(tmp_path))).__name__ \
        == type(jcolmap.load_reconstruction(str(tmp_path))).__name__


def test_union_find_as_jax():
    rng = np.random.default_rng(6)
    a, b = jsfm._UnionFind(), sfm._UnionFind()
    for _ in range(300):
        x = (int(rng.integers(0, 6)), int(rng.integers(0, 20)))
        y = (int(rng.integers(0, 6)), int(rng.integers(0, 20)))
        a.union(x, y)
        b.union(x, y)
    assert a.parent == b.parent and a.frames == b.frames


def _room_capture(n=10, w=320, h=240, arc=np.pi / 4):
    from room import _look_at as room_look_at, render_room_frame
    focal = 0.75 * w
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1.0]])
    imgs = []
    for i in range(n):
        ang = arc * i / n
        pos = np.array([0.95 * np.cos(ang), 0.95 * np.sin(ang), 0.9])
        T_WC = room_look_at(pos, np.array([-0.8, -0.3, 0.7]))
        rgb, _, _ = render_room_frame(T_WC, K, w, h)
        imgs.append((f'{i}.png', cv2.cvtColor((rgb * 255).astype(np.uint8),
                                              cv2.COLOR_RGB2GRAY)))
    return imgs, K


def test_klt_front_end_and_init_pair_as_jax():
    """`_build_tracks_klt` (with its wide-baseline pass) and `_init_pair`
    on tests/test_mapping_sfm.py's init-pair capture: the same cv2 calls on
    the same images, so tracks, keypoints and pair matches are equal, the
    same pair is chosen (at least 3 frames apart, as JAX's test asks) with
    its relative pose, and the same tracks are triangulated."""
    imgs, K = _room_capture()
    js = jsfm.IncrementalSfM(imgs, K, detector='klt')
    ts = sfm.IncrementalSfM(imgs, K, detector='klt', device='cpu')
    js._build_tracks_klt()
    ts._build_tracks_klt()
    assert ts.tracks == js.tracks and ts.track_of_kp == js.track_of_kp
    for a, b in zip(ts.kps, js.kps):
        np.testing.assert_array_equal(a, b)
    assert ts.pair_matches.keys() == js.pair_matches.keys()
    for key in js.pair_matches:
        np.testing.assert_array_equal(ts.pair_matches[key],
                                      js.pair_matches[key])
    pair = js._init_pair()
    assert ts._init_pair() == pair and pair[1] - pair[0] >= 3
    _assert_same_state(js, ts)


def test_descriptor_front_end_as_jax():
    """The SIFT path: `_extract`, `_match_pair` and the conflict-refusing
    union-find give equal tracks (on 6 frames of the same capture)."""
    imgs, K = _room_capture(n=6)
    js = jsfm.IncrementalSfM(imgs, K, detector='sift')
    ts = sfm.IncrementalSfM(imgs, K, detector='sift', device='cpu')
    for s in (js, ts):
        s._extract()
        s._build_tracks()
    assert ts.tracks == js.tracks and len(ts.tracks) > 50
    assert ts.pair_matches.keys() == js.pair_matches.keys()


_NO_CV2 = r'''
import sys
sys.modules['cv2'] = None  # `import cv2` raises ImportError
import numpy as np
import autolabel_tpu_torch.mapping as mapping
from autolabel_tpu_torch.mapping import IncrementalSfM, bundle_adjust
import autolabel_tpu_torch.mapping.__main__ as cli
from autolabel_tpu_torch.undistort import ImageUndistorter
from autolabel_tpu_torch.mapping.ba import rotmat_to_rvec
assert sys.modules['cv2'] is None
rng = np.random.default_rng(0)
pts = rng.uniform(-1, 1, (40, 3))
rv = np.array([[0.0, 0, 0], [0.0, 0.3, 0.0]])
tv = np.array([[0.0, 0, 4], [-1.0, 0, 4]])
from autolabel_tpu_torch.mapping.ba import rodrigues
import torch
R = rodrigues(torch.tensor(rv)).numpy()
ci, pi = np.repeat([0, 1], 40), np.tile(np.arange(40), 2)
Xc = np.einsum('nij,nj->ni', R[ci], pts[pi]) + tv[ci]
xy = Xc[:, :2] / Xc[:, 2:3] * 300 + 160
out = bundle_adjust(rv, tv, pts + 0.01, (300, 300, 160, 160), ci, pi, xy,
                    max_iters=5, device='cpu')
assert out[4] < 5, out[4]
assert np.allclose(rotmat_to_rvec(R[1]), rv[1], atol=1e-6)
sfm = IncrementalSfM([('0.png', np.zeros((8, 8), np.uint8))] * 3, np.eye(3),
                     detector='sift', device='cpu')
sfm.registered = {i: (np.eye(3), np.array([0.1 * i, 0, 0])) for i in range(3)}
sfm.tracks, sfm.points = {}, {}
assert sfm._drop_tear_frames() == 0
sfm.write_colmap_model(sys.argv[1])
for call in (sfm._build_tracks_klt, sfm._extract, sfm._init_pair,
             lambda: sfm._register(0),
             lambda: ImageUndistorter(np.eye(3), np.zeros(4), (8, 8)),
             lambda: cli.CV2Mapping(sys.argv[1], None, None).run()):
    try:
        call()
    except ImportError as e:
        assert 'cv2' in str(e), e
    else:
        raise AssertionError(f'{call} ran without cv2')
print('ok')
'''


def test_mapping_runs_without_cv2_and_front_end_names_it(tmp_path):
    """In a fresh interpreter where `import cv2` fails: the mapping
    package, its CLI module and the undistorter import; bundle adjustment,
    the constructor, tear removal and the COLMAP model run; every front-end
    stage raises ImportError naming cv2."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', _NO_CV2, str(tmp_path)],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith('ok')
    assert (tmp_path / 'images.txt').exists()
