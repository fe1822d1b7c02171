"""The port's mapping CLI against scripts/mapping.py on the CPU.

`python -m autolabel_tpu_torch.mapping` flag for flag; the HLoc backend
under tests/test_mapping_hloc.py's stub hloc/pycolmap modules on both of
its branches, with the undistorted frames bit-equal to JAX's;
`ransac_scale`, `ScaleEstimation`, `oriented_bounding_frame` and
`PoseSaver` equal to JAX's at equal seeds; and the whole slice: the CLI
with --backend cv2 against scripts/mapping.py's Pipeline on one small
synthetic capture.
"""
import os
import shutil
import itertools
import sys
import types

import numpy as np
import pytest
import torch

from autolabel_tpu.mapping import sfm as jsfm
from autolabel_tpu.utils import Scene as JScene
from autolabel_tpu.utils import colmap_text as jcolmap
from autolabel_tpu_torch.mapping import __main__ as cli
from autolabel_tpu_torch.utils import Scene, fixtures

cv2 = pytest.importorskip('cv2')

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)
sys.path.insert(0, os.path.join(os.path.dirname(TESTS), 'scripts'))
import mapping as jcli  # noqa: E402  scripts/mapping.py
from test_mapping_hloc import _install_stubs, _make_raw_scene  # noqa: E402
from test_mapping_sfm import _umeyama  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize('argv', [
    ['scene'],
    ['scene', '--backend', 'cv2', '--features', 'sift'],
    ['s', '--debug', '--vis', '--backend', 'hloc', '--features', 'orb'],
    ['s', '--backend', 'auto', '--features', 'klt'],
])
def test_flags_as_scripts_mapping(argv, monkeypatch):
    monkeypatch.setattr(sys, 'argv', ['mapping.py'] + argv)
    assert vars(cli.read_args(argv)) == vars(jcli.read_args())


@pytest.mark.parametrize('argv', [['s', '--backend', 'colmap'],
                                  ['s', '--features', 'akaze'], []])
def test_bad_flags_refused_as_scripts_mapping(argv, monkeypatch):
    monkeypatch.setattr(sys, 'argv', ['mapping.py'] + argv)
    with pytest.raises(SystemExit):
        jcli.read_args()
    with pytest.raises(SystemExit):
        cli.read_args(argv)


def _decoded(path):
    return cv2.imread(str(path), cv2.IMREAD_UNCHANGED)


def test_hloc_exhaustive_and_undistortion_as_jax(tmp_path, monkeypatch):
    """< 250 images: superpoint, exhaustive pairs, superglue, COLMAP
    SINGLE/OPENCV; intrinsics and distortion written; rgb and depth
    undistorted at their own sizes, pixel for pixel JAX's."""
    params = (61.5, 62.5, 33.0, 23.0, 0.01, -0.002, 0.0005, -0.0005)
    outs = {}
    for name, module, scene_class in (('jax', jcli, JScene),
                                      ('port', cli, Scene)):
        hloc, pycolmap = _install_stubs(monkeypatch, params)
        scene_dir = tmp_path / name
        _make_raw_scene(scene_dir)
        backend = module.HLoc(str(tmp_path / f'work_{name}'),
                              scene_class(str(scene_dir)),
                              types.SimpleNamespace(debug=False))
        assert backend.exhaustive
        os.makedirs(tmp_path / f'work_{name}', exist_ok=True)
        backend.run()
        assert len(hloc.extract_features.calls) == 1
        assert len(hloc.pairs_from_exhaustive.calls) == 1
        assert not hloc.pairs_from_retrieval.calls
        (_, kwargs) = hloc.reconstruction.calls[0]
        assert kwargs['camera_mode'] == pycolmap.CameraMode.SINGLE
        assert kwargs['image_options'] == {'camera_model': 'OPENCV'}
        assert len(kwargs['image_list']) == 3
        outs[name] = scene_dir
    for name in ('intrinsics.txt', 'distortion_parameters.txt'):
        assert (outs['jax'] / name).read_bytes() \
            == (outs['port'] / name).read_bytes()
    for sub in ('rgb', 'depth'):
        files = sorted(os.listdir(outs['jax'] / sub))
        assert files == sorted(os.listdir(outs['port'] / sub))
        assert len(files) == 3
        for f in files:
            a, b = _decoded(outs['jax'] / sub / f), \
                _decoded(outs['port'] / sub / f)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    depth = _decoded(outs['port'] / 'depth' / '0.png')
    assert depth.shape == (24, 32) and depth.dtype == np.uint16


def test_hloc_retrieval_branch_as_jax(tmp_path, monkeypatch):
    """>= 250 images: NetVLAD retrieval with num_matched=50, then local
    features; the same calls as scripts/mapping.py's."""
    params = (61.5, 62.5, 33.0, 23.0, 0.0, 0.0, 0.0, 0.0)
    calls = {}
    for name, module, scene_class in (('jax', jcli, JScene),
                                      ('port', cli, Scene)):
        hloc, _ = _install_stubs(monkeypatch, params)
        scene_dir = tmp_path / name
        _make_raw_scene(scene_dir)
        scene = scene_class(str(scene_dir))
        scene.raw_rgb_paths = lambda d=scene_dir: [
            str(d / 'raw_rgb' / f'{i}.png') for i in range(300)]
        backend = module.HLoc(str(tmp_path / 'work'), scene,
                              types.SimpleNamespace(debug=False))
        assert not backend.exhaustive
        os.makedirs(tmp_path / 'work', exist_ok=True)
        backend._run_sfm()
        confs = [c[0][0] for c in hloc.extract_features.calls]
        assert confs == [hloc.extract_features.confs['netvlad'],
                         hloc.extract_features.confs['superpoint_aachen']]
        assert hloc.pairs_from_retrieval.calls[0][1]['num_matched'] == 50
        calls[name] = [(m, len(getattr(hloc, m).calls)) for m in
                       ('extract_features', 'match_features',
                        'pairs_from_exhaustive', 'pairs_from_retrieval',
                        'reconstruction')]
    assert calls['jax'] == calls['port']


def test_hloc_missing_raises_naming_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'hloc', None)
    _make_raw_scene(tmp_path / 's', n=1)
    with pytest.raises(ImportError, match='hloc'):
        cli.HLoc(str(tmp_path), Scene(str(tmp_path / 's')),
                 types.SimpleNamespace(debug=False))


def test_pipeline_auto_picks_backend_as_jax(tmp_path, monkeypatch):
    _install_stubs(monkeypatch, (1, 1, 0, 0, 0, 0, 0, 0))
    _make_raw_scene(tmp_path / 's', n=1)
    flags = types.SimpleNamespace(scene=str(tmp_path / 's'), debug=False,
                                  backend='auto')
    port, jax_ = cli.Pipeline(flags, device='cpu'), jcli.Pipeline(flags)
    assert port._pick_backend() is cli.HLoc
    assert jax_._pick_backend() is jcli.HLoc
    monkeypatch.delitem(sys.modules, 'hloc')
    monkeypatch.delitem(sys.modules, 'pycolmap')
    assert port._pick_backend() is cli.CV2Mapping
    assert jax_._pick_backend() is jcli.CV2Mapping
    for backend, want in (('cv2', cli.CV2Mapping), ('hloc', cli.HLoc)):
        flags.backend = backend
        assert cli.Pipeline(flags, device='cpu')._pick_backend() is want


@pytest.mark.parametrize('seed', [0, 1, 7])
def test_ransac_scale_as_jax(seed):
    rng = np.random.default_rng(seed)
    scales = np.concatenate([rng.normal(3.0, 0.01, 300),
                             rng.uniform(0.5, 6.0, 200)])
    assert cli.ransac_scale(scales, iterations=2000, seed=seed) \
        == jcli.ransac_scale(scales, iterations=2000, seed=seed)


def test_oriented_bounding_frame_as_jax():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(500, 3)) * [3.0, 1.0, 0.3] + [1.0, 2.0, 3.0]
    for a, b in zip(cli.oriented_bounding_frame(pts),
                    jcli.oriented_bounding_frame(pts)):
        np.testing.assert_array_equal(a, b)


def _seeded(monkeypatch, seed=0):
    """Both packages' ScaleEstimation take ransac_scale with seed=None;
    equal seeds make them comparable."""
    for module in (cli, jcli):
        orig = module.ransac_scale
        monkeypatch.setattr(
            module, 'ransac_scale',
            lambda s, iterations=10000, seed=None, o=orig: o(
                s, iterations, seed=0))


def _model_of_room(scene_dir, model_dir, sfm_scale, n_points=400):
    """A COLMAP text model of the fixture room at 1 / sfm_scale of its
    metric size: its ground-truth poses and points back-projected from
    frame 0's depth, observed in every frame that sees them."""
    scene = Scene(str(scene_dir))
    K = scene.camera.camera_matrix
    from autolabel_tpu_torch.utils.images import read_png
    depth0 = read_png(scene.depth_paths()[0]) / 1000.0
    rng = np.random.default_rng(3)
    h, w = depth0.shape
    ys, xs = rng.integers(0, h, n_points), rng.integers(0, w, n_points)
    z = depth0[ys, xs]
    pc = np.stack([(xs + 0.5 - K[0, 2]) * z / K[0, 0],
                   (ys + 0.5 - K[1, 2]) * z / K[1, 1], z], -1)
    T0 = np.linalg.inv(scene.poses[0])
    world = pc @ T0[:3, :3].T + T0[:3, 3]
    images, obs = [], {i: [] for i in range(n_points)}
    for f, T_CW in enumerate(scene.poses):
        xc = world @ T_CW[:3, :3].T + T_CW[:3, 3]
        uv = xc[:, :2] / xc[:, 2:3] * [K[0, 0], K[1, 1]] + K[:2, 2]
        ok = (xc[:, 2] > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < w) \
            & (uv[:, 1] >= 0) & (uv[:, 1] < h)
        p2d = [colmap_p2d(uv[i], i) for i in np.nonzero(ok)[0]]
        images.append(jcolmap.ColmapImage(
            f + 1, jcolmap.rotmat_to_qvec(T_CW[:3, :3]),
            T_CW[:3, 3] / sfm_scale, 1, f'{f}.png', p2d))
    camera = jcolmap.ColmapCamera(1, 'OPENCV', w, h, np.array(
        [K[0, 0], K[1, 1], K[0, 2], K[1, 2], 0, 0, 0, 0]))
    points = {i: jcolmap.ColmapPoint3D(i, world[i] / sfm_scale,
                                       np.array([128] * 3), 1.0)
              for i in range(n_points)}
    jcolmap.write_text_model(str(model_dir), camera, images, points)


def colmap_p2d(xy, pid):
    return jcolmap.ColmapPoint2D(xy=np.asarray(xy, np.float64),
                                 point3D_id=int(pid))


def test_scale_estimation_and_pose_saver_as_jax(tmp_path, monkeypatch):
    """On the fixture room (the port's PNG writer) with a model at a third
    of its metric size: both ScaleEstimations read the same depth (the
    port through utils.images.read_png, JAX's through cv2) and give the
    same scaled poses (about 3 times the model's); both PoseSavers write
    the same pose/*.txt and bbox.txt."""
    _seeded(monkeypatch)
    base = tmp_path / 'room'
    fixtures.make_room_scene(str(base), n_frames=8)
    _model_of_room(base, tmp_path / 'model', sfm_scale=3.0)
    shutil.copytree(base, tmp_path / 'jax')
    shutil.copytree(base, tmp_path / 'port')
    port = cli.ScaleEstimation(Scene(str(tmp_path / 'port')),
                               str(tmp_path / 'model')).run()
    want = jcli.ScaleEstimation(JScene(str(tmp_path / 'jax')),
                                str(tmp_path / 'model')).run()
    assert port.keys() == want.keys() and len(port) == 8
    for k in want:
        np.testing.assert_array_equal(port[k], want[k])
    gt = Scene(str(base)).poses
    np.testing.assert_allclose(port['3'][:3, 3], gt[3][:3, 3], atol=0.01)
    cli.PoseSaver(Scene(str(tmp_path / 'port')), port).run()
    jcli.PoseSaver(JScene(str(tmp_path / 'jax')), want).run()
    assert (tmp_path / 'port' / 'bbox.txt').read_bytes() \
        == (tmp_path / 'jax' / 'bbox.txt').read_bytes()
    for f in os.listdir(tmp_path / 'jax' / 'pose'):
        assert (tmp_path / 'port' / 'pose' / f).read_bytes() \
            == (tmp_path / 'jax' / 'pose' / f).read_bytes()


# The whole slice: tests/test_mapping_sfm.py's end-to-end capture (the
# room seen along an arc, poses withheld, depth given) cut from 26 frames
# of 400 x 300 along 60 degrees to 20 frames of 320 x 240 along 48, so
# that JAX's pipeline and the port's each take under a minute here.
SLICE_FRAMES, SLICE_SIZE, SLICE_ARC = 20, (320, 240), np.pi / 3 * 0.8


def _capture(scene):
    from room import _look_at, render_room_frame
    (scene / 'raw_rgb').mkdir(parents=True)
    (scene / 'raw_depth').mkdir()
    w, h = SLICE_SIZE
    focal = 0.75 * w
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1.0]])
    np.savetxt(scene / 'intrinsics.txt', K)
    gt_T_CW = {}
    for i in range(SLICE_FRAMES):
        ang = SLICE_ARC * i / SLICE_FRAMES
        pos = np.array([0.95 * np.cos(ang), 0.95 * np.sin(ang),
                        0.9 + 0.1 * np.sin(2 * ang)])
        T_WC = _look_at(pos, np.array([-0.8, -0.3, 0.7]))
        rgb, depth, _ = render_room_frame(T_WC, K, w, h)
        cv2.imwrite(str(scene / 'raw_rgb' / f'{i}.png'),
                    cv2.cvtColor((rgb * 255).astype(np.uint8),
                                 cv2.COLOR_RGB2BGR))
        cv2.imwrite(str(scene / 'raw_depth' / f'{i}.png'),
                    (depth * 1000).astype(np.uint16))
        gt_T_CW[i] = np.linalg.inv(T_WC)
    return gt_T_CW


def _centres(scene):
    out = {}
    for p in sorted((scene / 'pose').glob('*.txt'), key=lambda p: int(p.stem)):
        T = np.loadtxt(p)
        out[int(p.stem)] = -T[:3, :3].T @ T[:3, 3]
    return out


def _run_jax(scene):
    jcli.Pipeline(types.SimpleNamespace(
        scene=str(scene), debug=False, vis=False, backend='cv2',
        features='klt')).run()


def _moved_ba(kind):
    """JAX's bundle_adjust with every call's points changed at the
    rounding level: 'up' / 'down' one fp32 ulp, an int a seeded draw of
    1e-7 relative (one or two ulps)."""
    ba = jsfm.bundle_adjust
    calls = itertools.count()

    def run(rvecs, tvecs, points, *args, **kwargs):
        pts = np.asarray(points, np.float32)
        if kind in ('up', 'down'):
            pts = np.nextafter(pts, np.float32(np.inf if kind == 'up'
                                               else -np.inf))
        else:
            rng = np.random.default_rng([kind, next(calls)])
            pts = (pts * (1 + 1e-7 * rng.normal(size=pts.shape))) \
                .astype(np.float32)
        return ba(rvecs, tvecs, pts, *args, **kwargs)
    return run


def _deviation(scene, ref):
    """How far one run's output lies from another's on the same capture:
    the largest and the mean camera-centre difference after a Sim(3)
    alignment (m), that alignment's |scale - 1|, and bbox.txt's largest
    difference relative to its largest coordinate."""
    got, want = _centres(scene), _centres(ref)
    assert sorted(got) == sorted(want)
    frames = sorted(want)
    a = np.stack([got[i] for i in frames])
    b = np.stack([want[i] for i in frames])
    s, R, t = _umeyama(a, b)
    err = np.linalg.norm(b - (s * a @ R.T + t), axis=1)
    box_a, box_b = (np.loadtxt(d / 'bbox.txt')[:6] for d in (scene, ref))
    return dict(max=err.max(), mean=err.mean(), scale=abs(s - 1),
                bbox=np.abs(box_a - box_b).max() / np.abs(box_b).max())


# The port's output lies within this factor of JAX's own spread, JAX's
# pipeline against itself with every bundle adjustment's points one fp32
# ulp up (`_moved_ba('up')`). The SfM's bundle adjustments end
# unconverged, so rounding decides their last digits and the pipeline
# carries them on. Over five such changes (`python -m
# tests.test_torch_port_mapping_cli`: one ulp up, one down, three seeded
# draws) JAX's own spread on this capture ranges 0.050-0.946 cm in the
# largest centre difference, 0.026-0.217 cm in the mean, 1.3e-4-1.3e-2 in
# the scale and 1.2e-4-1.5e-3 in the bbox; the port's (0.283 cm, 0.056
# cm, 4.9e-4, 3.9e-4) lies inside each range, at 0.46 to 1.48 times the
# one-ulp-up spread (measured).
SPREAD_ROOM = 4.0


def test_mapping_cli_as_scripts_mapping(tmp_path, monkeypatch):
    """python -m autolabel_tpu_torch.mapping --backend cv2 and
    scripts/mapping.py's Pipeline on one capture (the RANSAC of both
    ScaleEstimations seeded alike).

    Each meets tests/test_mapping_sfm.py's bars against the truth (at
    least n - 4 frames, Sim(3) scale in (0.6, 1.5), mean centre error
    below 0.15 m, a room-sized bbox). Against each other: the same frames
    registered, every camera centre after Sim(3) within 1 cm, the scale
    and bbox within 2%, and each of the largest and the mean centre
    difference, the scale and the bbox within SPREAD_ROOM times JAX's own
    spread, measured here with every bundle adjustment's points one ulp
    up."""
    _seeded(monkeypatch)
    gt = _capture(tmp_path / 'jax')
    for k in ('port', 'moved'):
        shutil.copytree(tmp_path / 'jax', tmp_path / k)
    _run_jax(tmp_path / 'jax')
    with monkeypatch.context() as m:
        m.setattr(jsfm, 'bundle_adjust', _moved_ba('up'))
        _run_jax(tmp_path / 'moved')
    flags = cli.main([str(tmp_path / 'port'), '--backend', 'cv2'],
                     device='cpu')
    assert flags.backend == 'cv2' and flags.features == 'klt'
    centres = {k: _centres(tmp_path / k) for k in ('jax', 'port')}
    assert sorted(centres['port']) == sorted(centres['jax'])
    frames = sorted(centres['jax'])
    assert len(frames) >= SLICE_FRAMES - 4, frames
    truth = np.stack([-gt[i][:3, :3].T @ gt[i][:3, 3] for i in frames])
    bboxes = {}
    for k in ('jax', 'port'):
        est = np.stack([centres[k][i] for i in frames])
        s, R, t = _umeyama(est, truth)
        err = np.linalg.norm(truth - (s * est @ R.T + t), axis=1)
        assert 0.6 < s < 1.5, (k, s)
        assert err.mean() < 0.15, (k, err.mean())
        bboxes[k] = np.loadtxt(tmp_path / k / 'bbox.txt')[:6].reshape(2, 3)
        extent = bboxes[k][1] - bboxes[k][0]
        assert (extent > 1.0).all() and (extent < 6.0).all(), (k, extent)
        np.testing.assert_array_equal(
            np.loadtxt(tmp_path / k / 'distortion_parameters.txt'),
            np.zeros(4))
    port = _deviation(tmp_path / 'port', tmp_path / 'jax')
    spread = _deviation(tmp_path / 'moved', tmp_path / 'jax')
    assert port['max'] <= 0.01, port
    assert port['scale'] <= 0.02, port
    np.testing.assert_allclose(bboxes['port'], bboxes['jax'], rtol=0.02)
    for key in port:
        assert port[key] <= SPREAD_ROOM * spread[key], (key, port, spread)
    np.testing.assert_allclose(
        np.loadtxt(tmp_path / 'port' / 'intrinsics.txt'),
        np.loadtxt(tmp_path / 'jax' / 'intrinsics.txt'))
    for k in ('jax', 'port'):
        assert sorted(os.listdir(tmp_path / k / 'rgb')) \
            == sorted(os.listdir(tmp_path / k / 'raw_rgb'))


def spread_study(work):
    """JAX's pipeline against itself under five rounding-level changes of
    every bundle adjustment's points (one ulp up, one down, three seeded
    draws), and the port against JAX, on the whole-slice capture: prints
    each one's `_deviation` from JAX's unchanged run."""
    import pathlib
    work = pathlib.Path(work)
    shutil.rmtree(work, ignore_errors=True)
    for module in (cli, jcli):
        orig = module.ransac_scale
        module.ransac_scale = (lambda s, iterations=10000, seed=None,
                               o=orig: o(s, iterations, seed=0))
    _capture(work / 'jax')
    kinds = ['up', 'down', 1, 2, 3]
    for k in ['port'] + kinds:
        shutil.copytree(work / 'jax', work / str(k))
    _run_jax(work / 'jax')
    original = jsfm.bundle_adjust
    for kind in kinds:
        jsfm.bundle_adjust = _moved_ba(kind)
        try:
            _run_jax(work / str(kind))
        finally:
            jsfm.bundle_adjust = original
    torch.set_num_threads(1)
    cli.main([str(work / 'port'), '--backend', 'cv2'], device='cpu')
    for k in kinds + ['port']:
        d = _deviation(work / str(k), work / 'jax')
        print(f'{"JAX, points " + str(k) if k != "port" else "the port":18s}'
              f' centres max {d["max"] * 100:.4f} cm, mean '
              f'{d["mean"] * 100:.4f} cm; |scale - 1| {d["scale"]:.6f}; '
              f'bbox {d["bbox"]:.6f}')


if __name__ == '__main__':
    # python -m tests.test_torch_port_mapping_cli [work dir]
    spread_study(sys.argv[1] if len(sys.argv) > 1
                 else os.path.join('build', 'mapping_spread'))
