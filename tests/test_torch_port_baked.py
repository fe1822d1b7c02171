"""The port's baked preview (render/baked.py) and the plain version of its
splat render (ops/splat_cuda.py, K8's oracle) against the JAX package on
the CPU.

The splat render's plain version computes what XLA computes for JAX's
`_splat_render` on the CPU, operation for operation (the camera
transform, the camera centre, the view norm and the SH dot product as
fused multiply-add chains), so its outputs are held bit-equal: a stricter
form of the rules K8 is held to on the card (pixels flip only at a .5
boundary, ties' colours within (count - 1) ulp). The scenes: random splat
clouds with and without SH, JAX's two-plane footprint scene, splats on
the frame's edges (the fill passes read across them as jnp.roll wraps),
and JAX's own bake of a field trained for 200 steps.

bake() reads the field's densities through the port's heads, whose fp32
products round in another order than XLA's: the candidate cells are the
same except where a cell's alpha lies within that rounding of the
threshold. IncrementalBaker, GovernedPreviewRenderer (on an injected
clock) and the footprint propagation mirror the JAX package's tests.
"""
import itertools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autolabel_tpu.models.field import Field as JaxField
from autolabel_tpu.models.field import FieldConfig as JaxFieldConfig
from autolabel_tpu.ops.encoders import HashGridConfig as JaxGridConfig
from autolabel_tpu.render import baked as jax_baked
from autolabel_tpu_torch import bridge, model_utils
from autolabel_tpu_torch.core.dataset import SceneDataset
from autolabel_tpu_torch.core.rays import convert_pose
from autolabel_tpu_torch.models.field import Field, FieldConfig
from autolabel_tpu_torch.ops import splat_cuda
from autolabel_tpu_torch.ops.encoders import HashGridConfig
from autolabel_tpu_torch.render import baked
from autolabel_tpu_torch.render.renderer import RenderOptions
from autolabel_tpu_torch.train.losses import LossOptions
from autolabel_tpu_torch.train.trainer import SimpleTrainer
from autolabel_tpu_torch.utils import fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = dict(n_levels=6, log2_hashmap_size=14, per_level_scale=1.6)
HEADS = dict(encoding='hg+freq', hidden_dim=32, hidden_dim_color=32,
             hidden_dim_semantic=16)
BAKE = dict(resolution=48, max_points=2 ** 14)


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: the suite runs in several
    worker processes at once, and torch's CPU thread pools, each as wide
    as the machine, slow one another down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """A small field trained for 200 steps on the port's sphere fixture
    (12 frames of 48 x 36), its params as a JAX tree, the JAX field of the
    same config, and the dataset."""
    scene = str(tmp_path_factory.mktemp('scenes') / 'sphere')
    fixtures.make_synthetic_scene(scene, n_frames=12, width=48, height=36)
    dataset = SceneDataset('train', scene, factor=1.0, batch_size=512)
    # every draw seeded (the class-balanced sampler draws from numpy's
    # global state unless given one), so the trained field is the same in
    # every run
    dataset.rng = np.random.default_rng(0)
    dataset.index_sampler.random_state = np.random.RandomState(0)
    bound = model_utils.compute_bound(dataset.min_bounds, dataset.max_bounds)
    kw = dict(HEADS, semantic_classes=dataset.n_classes, bound=bound)
    field = Field(FieldConfig(grid=HashGridConfig(**GRID), **kw),
                  device='cpu', generator=torch.Generator().manual_seed(0))
    trainer = SimpleTrainer('ngp', field, iters=1000,
                            loss_options=LossOptions(),
                            render_options=RenderOptions(num_steps=32,
                                                         perturb=True),
                            workspace=None)
    trainer.train_iterations(iter(dataset), 200, progress=False)
    params = bridge.params_to_numpy(field)
    jfield = JaxField(JaxFieldConfig(grid=JaxGridConfig(**GRID), **kw))
    return field, params, jfield, dataset


def _pose(dataset, index):
    """A frame's world -> camera transform in the field's world space."""
    path = os.path.join(dataset.scene.path, 'pose', f'{index}.txt')
    return np.linalg.inv(convert_pose(np.loadtxt(path)))


# -- the splat render's plain version against JAX ---------------------------

def _random_cloud(k, seed, with_sh):
    rng = np.random.default_rng(seed)
    points = rng.uniform(-1.0, 1.0, (k, 3)).astype(np.float32)
    points[:, 2] += 2.5
    rgb = rng.uniform(0.0, 1.0, (k, 3)).astype(np.float32)
    sh = (rng.normal(size=(k, 3, 3)) * 0.3).astype(np.float32) \
        if with_sh else None
    semantic = rng.integers(0, 5, k).astype(np.int32)
    valid = rng.uniform(size=k) < 0.9
    return points, rgb, sh, semantic, valid, 0.05


def _two_plane_cloud(with_sh, cell=0.1):
    """JAX's footprint scene: a sparse near plane (class 1) at z = 2 in
    front of a dense far plane (class 2) at z = 6, camera at the origin."""
    near = np.array([[x, y, 2.0] for x, y in itertools.product(
        np.arange(-0.8, 0.81, cell), repeat=2)], np.float32)
    far_step = 6.0 / 120.0
    far = np.array([[x, y, 6.0] for x, y in itertools.product(
        np.arange(-6.0, 6.01, far_step), repeat=2)], np.float32)
    points = np.concatenate([near, far])
    rgb = np.concatenate([np.tile([1.0, 0.0, 0.0], (len(near), 1)),
                          np.tile([0.0, 0.0, 1.0], (len(far), 1))]
                         ).astype(np.float32)
    semantic = np.concatenate([np.ones(len(near)), np.full(len(far), 2)]
                              ).astype(np.int32)
    sh = (np.random.default_rng(3).normal(size=(len(points), 3, 3)) * 0.2
          ).astype(np.float32) if with_sh else None
    return points, rgb, sh, semantic, np.ones(len(points), bool), cell


def _edge_cloud(with_sh):
    """A few splats just inside the frame's four edges (64 x 48 frame,
    focal 60, z 3), with footprints of several pixels and nothing else:
    the fill passes grow them across the edges, where jnp.roll wraps."""
    rng = np.random.default_rng(5)
    u = np.concatenate([np.zeros(6), np.full(6, 63), rng.uniform(0, 63, 12)])
    v = np.concatenate([rng.uniform(0, 47, 12), np.zeros(6), np.full(6, 47)])
    z = rng.uniform(2.5, 3.5, len(u))
    points = np.stack([(u - 32) * z / 60, (v - 24) * z / 60, z], 1).astype(
        np.float32)
    rgb = rng.uniform(0, 1, (len(u), 3)).astype(np.float32)
    sh = (rng.normal(size=(len(u), 3, 3)) * 0.2).astype(np.float32) \
        if with_sh else None
    semantic = np.arange(len(u)).astype(np.int32) % 7
    return points, rgb, sh, semantic, np.ones(len(u), bool), 0.3


_K = {'random': np.array([[50.0, 0, 24], [0, 52.0, 18], [0, 0, 1]]),
      'two_plane': np.array([[120.0, 0, 32], [0, 120.0, 32], [0, 0, 1]]),
      'edge': np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]])}
_SIZE = {'random': (48, 36), 'two_plane': (64, 64), 'edge': (64, 48)}


def _camera_pose(kind):
    if kind != 'random':
        return np.eye(4)
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(1)
    T = np.eye(4)
    T[:3, :3] = Rotation.from_rotvec(rng.normal(size=3) * 0.1).as_matrix()
    T[:3, 3] = rng.normal(size=3) * 0.1
    return T


def _clouds(kind, with_sh):
    if kind == 'random':
        return _random_cloud(16384, 0, with_sh)
    if kind == 'two_plane':
        return _two_plane_cloud(with_sh)
    return _edge_cloud(with_sh)


def _both(cloud, K, T, size, passes):
    """(JAX's outputs, the plain version's) as numpy, same inputs."""
    points, rgb, sh, semantic, valid, cell = cloud
    w, h = size
    ref = jax_baked._splat_render(
        jnp.asarray(points), jnp.asarray(rgb),
        None if sh is None else jnp.asarray(sh), jnp.asarray(semantic),
        jnp.asarray(valid), jnp.asarray(K, jnp.float32),
        jnp.asarray(T, jnp.float32), h, w, passes, float(cell))
    ours = splat_cuda.splat_render(
        torch.as_tensor(points), torch.as_tensor(rgb),
        None if sh is None else torch.as_tensor(sh),
        torch.as_tensor(semantic), torch.as_tensor(valid), K, T, h, w,
        passes, float(cell))
    return [np.asarray(a) for a in ref], [a.numpy() for a in ours]


@pytest.mark.parametrize('passes', [0, 4, 8])
@pytest.mark.parametrize('with_sh', [True, False])
@pytest.mark.parametrize('kind', ['random', 'two_plane', 'edge'])
def test_splat_render_plain_matches_jax(kind, with_sh, passes):
    ref, ours = _both(_clouds(kind, with_sh), _K[kind], _camera_pose(kind),
                      _SIZE[kind], passes)
    for name, a, b in zip(('image', 'depth', 'classes', 'splat_hit'), ours,
                          ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), (name, int((a != b).sum()))
    assert ref[3].any() and (passes == 0 or ref[1].astype(bool).sum()
                              >= ref[3].sum())


def test_edge_scene_fills_across_the_wrap():
    """The edge scene's fill passes reach pixels only through the frame's
    edges: with JAX's wrap-around, pixels of column 0 take splats that
    landed in column W - 1 (and rows likewise); the plain version agrees
    bit for bit (test above), so it wraps too."""
    cloud = _edge_cloud(False)
    ref, ours = _both(cloud, _K['edge'], np.eye(4), _SIZE['edge'], 4)
    depth = ours[1]
    hit0 = ours[3]
    # a pixel of the first column with depth from a last-column splat
    last_col = depth[:, -1][hit0[:, -1]]
    assert np.isin(depth[:, 0], last_col).any()
    first_row = depth[0][hit0[0]]
    assert np.isin(depth[-1], first_row).any()


@pytest.mark.parametrize('with_sh', [True, False])
def test_splat_render_plain_matches_jax_on_jax_bake(trained, with_sh):
    """On JAX's own BakedScene of the trained field, at two frame widths
    (4 and 8 passes, BakedRenderer's rule)."""
    _, params, jfield, dataset = trained
    scene = jax_baked.bake(jfield, params, view_dependent=with_sh, **BAKE)
    K = dataset.scene.camera.camera_matrix
    T = _pose(dataset, 0)
    cloud = (np.asarray(scene.points), np.asarray(scene.rgb),
             None if scene.sh is None else np.asarray(scene.sh),
             np.asarray(scene.semantic), np.asarray(scene.valid),
             scene.cell_size)
    for scale in (1, 14):  # 48 x 36 and 672 x 504
        Ks = K.copy()
        Ks[:2] *= scale
        size = (48 * scale, 36 * scale)
        passes = baked.fill_passes_for(size[0], 2)
        ref, ours = _both(cloud, Ks, T, size, passes)
        for a, b in zip(ours, ref):
            assert np.array_equal(a, b)
        assert ref[3].sum() > 200  # splats landed in the frame


def test_win_factor_and_big_are_the_kernels_constants():
    """The winners' factor is JAX's weak-typed 1.0 + 1e-4 rounded to fp32,
    and the kernel's bit patterns are those of the plain version's."""
    with open(os.path.join(REPO, 'autolabel_tpu_torch', 'csrc',
                           'splat_render.cu')) as f:
        source = f.read()
    bits = {name: int(value, 16) for name, value in re.findall(
        r'#define (\w+_BITS) (0x[0-9a-f]+)', source)}
    assert bits['WIN_FACTOR_BITS'] == int(np.float32(1.0 + 1e-4).view(
        np.uint32))
    assert splat_cuda.WIN_FACTOR == np.float32(jnp.float32(1.0) *
                                               (1.0 + 1e-4))
    assert bits['BIG_BITS'] == int(np.float32(splat_cuda.BIG).view(
        np.uint32))


def _kernel_defines():
    with open(os.path.join(REPO, 'autolabel_tpu_torch', 'csrc',
                           'splat_render.cu')) as f:
        return {name: int(value) for name, value in re.findall(
            r'#define (\w+) (\d+)\n', f.read())}


def test_tile_and_halo_are_the_kernels_constants():
    """The plain mirror of the fill's tiles and launch rule use the
    kernel's tile and halo cap."""
    defines = _kernel_defines()
    assert defines['TILE'] == splat_cuda.TILE
    assert defines['HALO_MAX'] == splat_cuda.HALO_MAX


@pytest.mark.parametrize('passes, want', [
    (0, 4), (1, 4), (4, 4), (splat_cuda.HALO_MAX, 4),
    (splat_cuda.HALO_MAX + 1, 5), (2 * splat_cuda.HALO_MAX, 5),
    (2 * splat_cuda.HALO_MAX + 1, 6)])
def test_launches_for(passes, want):
    """The memset, project, winners and a fill launch a HALO_MAX passes,
    at least one (with no pass it is the resolve)."""
    assert splat_cuda.launches_for(passes) == want


def _resolved(kind, width, height):
    """A scene's resolved state (the fill passes' input) on a camera of its
    own scaled to a width x height frame, with its cell size."""
    points, rgb, sh, semantic, valid, cell = _clouds(kind, False)
    w0, h0 = _SIZE[kind]
    K = _K[kind] * np.array([[width / w0], [height / h0], [1.0]])
    z, _, _, pid, ok, shaded = splat_cuda.project_plain(
        torch.as_tensor(points), torch.as_tensor(rgb), None,
        torch.as_tensor(valid), K, _camera_pose(kind), height, width)
    zbuf, sums, sem = splat_cuda.scatter_plain(
        z, pid, ok, shaded, torch.as_tensor(semantic), height * width)
    return splat_cuda.resolve_plain(zbuf, sums, sem, height, width), K, cell


@pytest.mark.parametrize('passes', [0, 1, 4, 8, splat_cuda.HALO_MAX + 1])
@pytest.mark.parametrize('width, height', [(1, 1), (5, 3), (33, 17),
                                           (64, 48)])
@pytest.mark.parametrize('kind', ['random', 'two_plane', 'edge'])
def test_fill_tiled_plain_matches_fill_plain(kind, width, height, passes):
    """K8's fill scheme (tiles of TILE pixels with a halo read modulo H
    and W, a (depth, source) state, passes in groups of HALO_MAX), mirrored
    in torch, gives fill_plain's outputs bit for bit: on frames of one
    pixel, smaller than the halo (wrapping several times), not a multiple
    of the tile, and of 2 x 2 tiles; also on tiles of 8 with a cap of 3,
    where more tiles and groups meet."""
    state, K, cell = _resolved(kind, width, height)
    want = splat_cuda.fill_plain(state, K, passes, cell)
    for tile, halo_max in ((splat_cuda.TILE, splat_cuda.HALO_MAX), (8, 3)):
        got = splat_cuda.fill_tiled_plain(state, K, passes, cell, tile,
                                          halo_max)
        for name, a, b in zip(('image', 'depth', 'classes'), got, want):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert torch.equal(a, b), (name, tile, int((a != b).sum()))
    assert width * height < 100 or state[3].any()


def test_bound_bytes_counts_what_the_frame_needs():
    """A frame of 4 x 3 pixels and 5 splat rows, counted by hand: rows 0-3
    valid (row 4 padding), row 3 behind the camera, rows 0 and 1 on pixel
    (1, 1) with row 1 nearer (row 0 loses), row 2 alone on pixel (2, 0).
    So 5 bytes of valid flags, 4 valid points of 12 bytes, 2 winners of
    rgb 12, SH 36 and class 4, and 12 pixels of 21 bytes."""
    K = np.array([[10.0, 0, 2], [0, 10.0, 1], [0, 0, 1]])
    points = torch.tensor([[-0.1, 0.0, 1.0], [-0.2, 0.0, 2.0],
                           [0.0, -0.1, 1.0], [0.0, 0.0, -1.0],
                           [0.0, 0.0, 0.0]])
    rgb = torch.rand(5, 3, generator=torch.Generator().manual_seed(0))
    sh = torch.zeros(5, 3, 3)
    semantic = torch.tensor([1, 2, 3, 4, 0], dtype=torch.int32)
    valid = torch.tensor([True, True, True, True, False])
    z, _, _, pid, ok, _ = splat_cuda.project_plain(points, rgb, None, valid,
                                                   K, np.eye(4), 3, 4)
    assert pid[:3].tolist() == [5, 5, 2] and ok.tolist() == [
        True, True, True, False, False]
    nbytes, counts = splat_cuda.bound_bytes(points, rgb, sh, semantic, valid,
                                            K, np.eye(4), 3, 4)
    assert counts == dict(n_valid=4, winners=2, splat_bytes=5 + 48 + 104,
                          pixel_bytes=252)
    assert nbytes == 5 + 48 + 2 * (12 + 36 + 4) + 12 * 21
    nbytes, counts = splat_cuda.bound_bytes(points, rgb, None, semantic,
                                            valid, K, np.eye(4), 3, 4)
    assert nbytes == 5 + 48 + 2 * (12 + 4) + 12 * 21


def test_near_half_marks_only_boundary_values():
    x = torch.tensor([0.5, 1.5, np.nextafter(np.float32(2.5), 3),
                      2.5 + 4 * 2 ** -22, 3.2, -0.5, 100.5, 100.25],
                     dtype=torch.float32)
    assert splat_cuda.near_half(x).tolist() == [True, True, True, False,
                                                False, True, True, False]


def _emulated_call(points, rgb, sh, semantic, valid, intrinsics, T_CW,
                   height, width, fill_passes, cell_size, tamper=None):
    """What K8 returns, computed with the plain version: its outputs and
    a workspace holding each splat's pixel (-1 for none) and z."""
    z, _, _, pid, ok, _ = splat_cuda.project_plain(
        points, rgb, sh, valid, intrinsics, T_CW, height, width)
    out = list(splat_cuda.splat_render_plain(
        points, rgb, sh, semantic, valid, intrinsics, T_CW, height, width,
        fill_passes, cell_size))
    pid = torch.where(ok, pid, torch.full_like(pid, -1))
    if tamper is not None:
        tamper(out, pid, z)
    work = torch.cat([pid.int(), z.view(torch.int32)])
    return (*out, work)


@pytest.mark.parametrize('tamper', [None, 'image', 'classes', 'pixel'])
def test_check_splat_holds_k8_by_its_rules(monkeypatch, tamper):
    """check_splat (what the card's tests and chip_smoke.py run) passes a
    K8 that computes the plain version's outputs and fails one whose
    image, classes or splat pixels are off."""
    def change(out, pid, z):
        if tamper == 'image':
            hit = out[3]
            out[0][hit] += 1e-3
        elif tamper == 'classes':
            out[2][out[3]] += 1
        elif tamper == 'pixel':
            moved = torch.nonzero(pid >= 0)[0, 0]
            pid[moved] = (pid[moved] + 1) % 100

    monkeypatch.setattr(splat_cuda, '_splat_call', lambda *a: _emulated_call(
        *a, tamper=change))
    points, rgb, sh, semantic, valid, cell = _two_plane_cloud(True)
    result = splat_cuda.check_splat(
        torch.as_tensor(points), torch.as_tensor(rgb), torch.as_tensor(sh),
        torch.as_tensor(semantic), torch.as_tensor(valid), _K['two_plane'],
        np.eye(4), 64, 64, 4, cell)
    assert result['ok'] == (tamper is None), result
    assert result['in_frame'] > 0 and result['splats'] == len(points)


@pytest.mark.parametrize('row', ['padding', 'valid'])
def test_check_splat_reads_z_of_valid_splats_only(monkeypatch, row):
    """K8 skips the splats that are not valid (the bake's padding) without
    writing their z: check_splat ignores that z and holds every valid
    splat's."""
    points, rgb, sh, semantic, valid, cell = _random_cloud(4096, 2, True)
    pick = np.flatnonzero(valid == (row == 'valid'))[:50]

    def change(out, pid, z):
        z[torch.as_tensor(pick)] = float('nan')

    monkeypatch.setattr(splat_cuda, '_splat_call', lambda *a: _emulated_call(
        *a, tamper=change))
    result = splat_cuda.check_splat(
        torch.as_tensor(points), torch.as_tensor(rgb), torch.as_tensor(sh),
        torch.as_tensor(semantic), torch.as_tensor(valid), _K['random'],
        _camera_pose('random'), 36, 48, 4, cell)
    assert result['z_equal'] == (row == 'padding'), result
    assert result['ok'] == (row == 'padding'), result


def test_camera_words_carry_the_plain_versions_centre():
    """K8 takes the camera centre -R^T t from the host, the fp32 chain the
    plain version uses, after fx, fy, cx, cy, R and t."""
    K, T = _K['random'], _camera_pose('random')
    words = splat_cuda._camera_words(K, T)
    T32 = T.astype(np.float32)
    assert words.dtype == np.float32 and words.shape == (19,)
    assert np.array_equal(words[4:13], T32[:3, :3].ravel())
    assert np.array_equal(words[13:16], T32[:3, 3])
    assert words[16:].tolist() == splat_cuda._centre(T32)
    chain = [float(splat_cuda._fma_chain([(torch.tensor(-T32[i, j]),
                                           torch.tensor(T32[i, 3]))
                                          for i in range(3)]))
             for j in range(3)]
    assert splat_cuda._centre(T32) == chain
    centre = -T32[:3, :3].astype(np.float64).T @ T32[:3, 3]
    assert np.allclose(words[16:], centre, rtol=1e-6, atol=1e-7)


def test_splat_render_raises_on_other_devices():
    points = torch.zeros((4, 3), device='meta')
    with pytest.raises(Exception):
        splat_cuda.splat_render(points, points, None,
                                torch.zeros(4, dtype=torch.int32,
                                            device='meta'),
                                torch.ones(4, dtype=torch.bool,
                                           device='meta'),
                                np.eye(3), np.eye(4), 8, 8, 4, 0.1)


# -- bake -------------------------------------------------------------------

def _alpha(jfield, params, resolution):
    """JAX's alpha of every bake cell and its adaptive threshold."""
    bound = jfield.config.bound
    cell = 2.0 * bound / resolution
    c = np.linspace(-bound + cell / 2, bound - cell / 2, resolution,
                    dtype=np.float32)
    grid = np.stack(np.meshgrid(c, c, c, indexing='ij'),
                    axis=-1).reshape(-1, 3)
    sigma = np.asarray(jax.jit(lambda p, x: jfield.density(p, x)[0])(
        params, jnp.asarray(grid)))
    alpha = 1.0 - np.exp(-sigma * cell)
    return grid, alpha, max(0.5 * np.percentile(alpha, 99.9), 0.01)


def _point_set(points, valid):
    return {tuple(p) for p in np.asarray(points)[np.asarray(valid)]}


@pytest.mark.parametrize('view_dependent', [True, False])
def test_bake_keeps_jax_cells(trained, view_dependent):
    field, params, jfield, _ = trained
    ref = jax_baked.bake(jfield, params, view_dependent=view_dependent,
                         **BAKE)
    ours = baked.bake(field, view_dependent=view_dependent, **BAKE)
    assert ours.points.shape == (BAKE['max_points'], 3)
    assert (ours.sh is None) == (not view_dependent)
    grid, alpha, thr = _alpha(jfield, params, BAKE['resolution'])
    with torch.no_grad():
        port_sigma = field.density(torch.as_tensor(grid))[0].numpy()
    cell = 2.0 * jfield.config.bound / BAKE['resolution']
    rounding = float(np.abs((1.0 - np.exp(-port_sigma * cell)) - alpha).max())
    near = {tuple(p) for p in grid[np.abs(alpha - thr) <= 4 * rounding
                                   + 1e-7]}
    a, b = _point_set(ref.points, ref.valid), _point_set(ours.points,
                                                         ours.valid)
    assert (a ^ b) <= near, (len(a ^ b), len(near))
    assert abs(ref.n_valid - ours.n_valid) <= len(near)
    assert 100 < ours.n_valid < BAKE['max_points']
    # the shading of the cells both kept: fp32 heads in another order
    ref_rows = {tuple(p): i for i, p in enumerate(np.asarray(ref.points))
                if i < ref.n_valid}
    rows = [(i, ref_rows[tuple(p)]) for i, p in
            enumerate(ours.points.numpy()[:ours.n_valid])
            if tuple(p) in ref_rows]
    mine, theirs = map(np.array, zip(*rows))
    np.testing.assert_allclose(ours.rgb.numpy()[mine],
                               np.asarray(ref.rgb)[theirs], atol=1e-5)
    if view_dependent:
        np.testing.assert_allclose(ours.sh.numpy()[mine],
                                   np.asarray(ref.sh)[theirs], atol=1e-5)
    same = ours.semantic.numpy()[mine] == np.asarray(ref.semantic)[theirs]
    assert same.mean() > 0.99


def test_shade_matches_jax(trained):
    field, params, jfield, _ = trained
    x = np.random.default_rng(2).uniform(-0.5, 0.5, (512, 3)).astype(
        np.float32)
    dc, lin, sem = baked._make_shade_fn(field, True)(torch.as_tensor(x))
    jdc, jlin, jsem = jax_baked._make_shade_fn(jfield, True)(
        params, jnp.asarray(x))
    np.testing.assert_allclose(dc.numpy(), np.asarray(jdc), atol=1e-5)
    np.testing.assert_allclose(lin.numpy(), np.asarray(jlin), atol=1e-5)
    assert (sem.numpy() == np.asarray(jsem)).mean() > 0.99
    assert sem.dtype == torch.int32


def test_bake_and_render_sees_the_sphere(trained):
    """The JAX package's bake-and-render check, on the port: the sphere
    projects into view at the ground truth's depth."""
    field, _, _, dataset = trained
    scene = baked.bake(field, **BAKE)
    K = dataset.scene.camera.camera_matrix
    w, h = dataset.scene.camera.size
    out = baked.BakedRenderer(scene).render(K, _pose(dataset, 0), (w, h))
    depth = out['depth'].numpy()
    assert out['image'].shape == (h, w, 3) and depth.shape == (h, w)
    hit = depth > 0
    assert hit.mean() > 0.05
    gt_depth = np.asarray(dataset._get_test(0)['depth']).reshape(h, w)
    both = hit & (gt_depth > 0)
    assert both.sum() > 50
    assert np.median(np.abs(depth[both] - gt_depth[both])) < 0.3
    image = out['image'].numpy()
    assert image.min() >= 0.0 and image.max() <= 1.0


# -- IncrementalBaker -------------------------------------------------------

def test_incremental_baker_matches_jax(trained):
    """update_all keeps JAX's slab rows, up to cells within rounding of
    the threshold."""
    field, params, jfield, _ = trained
    kw = dict(resolution=48, max_points=2 ** 14, n_blocks=8)
    ours = baked.IncrementalBaker(field, **kw)
    ref = jax_baked.IncrementalBaker(jfield, **kw)
    ours.update_all()
    ref.update_all(params)
    assert ours._alpha_scale == pytest.approx(ref._alpha_scale, rel=1e-4)
    a = _point_set(ref.scene().points, ref.scene().valid)
    b = _point_set(ours.scene().points, ours.scene().valid)
    assert len(a ^ b) <= 0.01 * len(a)
    assert ours.scene().n_valid > 100


def test_incremental_baker_matches_full_bake(trained):
    """JAX's test on the port: after update_all the rendered depth agrees
    with a full bake's, each slab's splats stay inside its x-range, and
    update_next_block rotates."""
    field, _, _, dataset = trained
    baker = baked.IncrementalBaker(field, resolution=96, max_points=2 ** 15,
                                   n_blocks=8)
    baker.update_all()
    scene = baker.scene()
    assert scene.n_valid > 0
    pts, valid = scene.points.numpy(), scene.valid.numpy()
    bound = field.config.bound
    slab_w = 2 * bound / baker.n_blocks
    ppb = baker.points_per_block
    for b in range(baker.n_blocks):
        rows = slice(b * ppb, (b + 1) * ppb)
        m = valid[rows]
        if m.any():
            x = pts[rows][m, 0]
            assert (x >= -bound + b * slab_w - 1e-5).all()
            assert (x <= -bound + (b + 1) * slab_w + 1e-5).all()
    full = baked.bake(field, resolution=96, max_points=2 ** 15)
    K = dataset.scene.camera.camera_matrix
    w, h = dataset.scene.camera.size
    T = _pose(dataset, 0)
    d_inc = baked.BakedRenderer(scene).render(K, T, (w, h))['depth'].numpy()
    d_full = baked.BakedRenderer(full).render(K, T, (w, h))['depth'].numpy()
    both = (d_inc > 0) & (d_full > 0)
    assert both.sum() > 50
    assert np.median(np.abs(d_inc[both] - d_full[both])) < 0.1
    order = [baker.update_next_block() for _ in range(baker.n_blocks)]
    assert order == list(range(baker.n_blocks))
    assert baker._next_block == 0


def test_incremental_baker_commits_slabs_to_the_device_cache(trained):
    """After scene() the cache lives on the device; a slab update rewrites
    only its own rows there (_slab_write)."""
    field, _, _, _ = trained
    baker = baked.IncrementalBaker(field, resolution=48, max_points=2 ** 12,
                                   n_blocks=4)
    baker.update_all()
    first = baker.scene()
    before = first.points.clone()
    baker._points[:] = 0.0  # host rows the next commit must not upload
    baker.update_block(1)
    after = baker.scene()
    assert after.points is first.points  # written in place
    ppb = baker.points_per_block
    outside = torch.ones(len(before), dtype=torch.bool)
    outside[ppb:2 * ppb] = False
    assert torch.equal(after.points[outside], before[outside])
    assert torch.equal(after.points[ppb:2 * ppb],
                       torch.as_tensor(baker._points[ppb:2 * ppb]))


def test_incremental_baker_cold_start_uses_global_scale(trained):
    """A fresh baker driven only by update_next_block sweeps every slab's
    densities first, so its scale is global from the start, and the
    per-block decay keeps it within 0.9x over a rotation."""
    field, _, _, _ = trained
    baker = baked.IncrementalBaker(field, resolution=96, max_points=2 ** 15,
                                   n_blocks=8)
    baker.update_next_block()
    cold_scale = baker._alpha_scale
    assert cold_scale > 0.0
    global_scale = max(
        float(np.percentile(baker._slab_alpha(b)[1], 99.9))
        for b in range(baker.n_blocks))
    assert cold_scale == pytest.approx(global_scale, rel=1e-6)
    for _ in range(baker.n_blocks - 1):
        baker.update_next_block()
        assert baker._alpha_scale >= 0.9 * global_scale - 1e-9


# -- GovernedPreviewRenderer (injected clock) -------------------------------

def _governed_with_fake_clock(scene, costs):
    state = {'t': 0.0}
    renderer = baked.GovernedPreviewRenderer(scene, target_fps=30.0,
                                             sync_every=2,
                                             time_fn=lambda: state['t'])
    orig_render = renderer._renderer

    class _Timed:
        def __init__(self, inner):
            self.inner = inner

        def render(self, K, T, size):
            out = self.inner.render(K, T, size)
            state['t'] += costs[renderer.level]
            return out

    renderer._renderer = lambda: _Timed(orig_render())
    return renderer, costs


_CAM_K = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]])
_CAM_T = np.eye(4)
_CAM_T[2, 3] = 2.0


def test_governed_preview_steps_down_when_profitable(trained):
    field, _, _, _ = trained
    scene = baked.bake(field, resolution=96, max_points=2 ** 14)
    renderer, costs = _governed_with_fake_clock(
        scene, {0: 0.05, 1: 0.028, 2: 0.02})
    assert renderer.level == 0
    for _ in range(12):
        out = renderer.render(_CAM_K, _CAM_T, (64, 48))
    assert renderer.level == 1
    costs.update({0: 0.01, 1: 0.0056, 2: 0.004})
    for _ in range(24):
        out = renderer.render(_CAM_K, _CAM_T, (64, 48))
        if renderer.level == 0:
            break
    assert renderer.level == 0
    assert out['image'].shape == (48, 64, 3)
    assert 'splat_level' in out


def test_governed_preview_reverts_unprofitable_downstep(trained):
    field, _, _, _ = trained
    scene = baked.bake(field, resolution=96, max_points=2 ** 14)
    renderer, _ = _governed_with_fake_clock(scene,
                                            {0: 0.05, 1: 0.05, 2: 0.05})
    levels_seen, occupancy = set(), []
    for i in range(60):
        renderer.render(_CAM_K, _CAM_T, (64, 48))
        levels_seen.add(renderer.level)
        occupancy.append(renderer.level)
        if i >= 39 and renderer.level == 0:
            break
    assert 1 in levels_seen
    assert renderer.level == 0
    assert np.mean(np.asarray(occupancy) == 0) > 0.6


def test_governed_levels_are_contiguous_strides(trained):
    field, _, _, _ = trained
    scene = baked.bake(field, resolution=48, max_points=2 ** 12)
    renderer = baked.GovernedPreviewRenderer(scene)
    for k, level in enumerate(renderer._levels):
        assert level.points.is_contiguous() and level.valid.is_contiguous()
        assert torch.equal(level.points, scene.points[::1 << k])
        assert level.cell_size == scene.cell_size * (1 << k)
    renderer.warmup(_CAM_K, (64, 48))
    assert len(renderer._rendered) == renderer.n_levels


# -- footprint propagation and the pass rule --------------------------------

def _two_plane_scene():
    points, rgb, _, semantic, valid, cell = _two_plane_cloud(False)
    return baked.BakedScene(points=torch.as_tensor(points),
                            rgb=torch.as_tensor(rgb),
                            semantic=torch.as_tensor(semantic),
                            valid=torch.as_tensor(valid), cell_size=cell)


def test_footprint_propagation_stops_piercing():
    """Pixels between near-plane splat centres show the near surface, and
    the near plane does not dilate past its footprint (JAX's test)."""
    intrinsics = np.array([[120.0, 0, 32], [0, 120.0, 32], [0, 0, 1]],
                          np.float32)
    renderer = baked.BakedRenderer(_two_plane_scene())
    out = renderer.render(intrinsics, np.eye(4, dtype=np.float32), (64, 64))
    sem, depth = out['semantic'].numpy(), out['depth'].numpy()
    inner = np.s_[32 - 30:32 + 30, 32 - 30:32 + 30]
    assert (sem[inner] == 1).all(), (sem[inner] == 1).mean()
    assert np.abs(depth[inner] - 2.0).max() < 0.2
    out_wide = renderer.render(
        np.array([[40.0, 0, 64], [0, 40.0, 64], [0, 0, 1]], np.float32),
        np.eye(4, dtype=np.float32), (128, 128))
    far_band = out_wide['semantic'].numpy()[64 + 24:64 + 30, 64 - 30:64 + 30]
    assert (far_band == 2).all(), (far_band == 2).mean()


@pytest.mark.parametrize('width, fill_passes, want', [
    (64, 2, 4), (639, 2, 4), (640, 2, 8), (1280, 2, 8), (64, 6, 6),
    (1280, 12, 12)])
def test_baked_renderer_pass_rule(monkeypatch, width, fill_passes, want):
    """max(fill_passes, 4 if width < 640 else 8), as JAX's BakedRenderer."""
    seen = []

    def record(*args):
        seen.append(args[9])
        return splat_cuda.splat_render_plain(*args)

    monkeypatch.setattr(splat_cuda, 'splat_render', record)
    baked.BakedRenderer(_two_plane_scene(), fill_passes).render(
        _K['two_plane'], np.eye(4), (width, 8))
    assert seen == [want]
