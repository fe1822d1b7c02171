"""The port's field, params bridge, model_utils and rays against the JAX
package on the CPU, and the import contract of autolabel_tpu_torch.

Same params on both sides (helpers shared with test_torch_port_render.py);
both compute in fp32, so rtol=1e-4 covers the products' summation order.
"""
import dataclasses
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from autolabel_tpu import model_utils as jax_model_utils
from autolabel_tpu_torch import bridge, model_utils
from autolabel_tpu_torch.core import rays
from autolabel_tpu_torch.models.field import Field, FieldConfig
from autolabel_tpu_torch.ops.encoders import HashGridConfig
from autolabel_tpu_torch.render.renderer import sample_pdf
from tests.test_torch_port_render import (ATOL, GRID, REPO, RTOL,
                                          _jax_field, _params, _port_field)


def test_bridge_round_trip():
    params = _params()
    params['pose'] = np.zeros((6,), np.float32)  # not Field state
    field = _port_field(params)
    back = bridge.params_to_numpy(field)
    del params['pose']
    assert set(back) == set(params)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    state = bridge.params_from_numpy(params, 'cpu')
    assert state['sigma_net.0'].shape == params['sigma_net'][0].shape
    assert state['encoder.grid'].shape == params['encoder']['grid'].shape
    with pytest.raises(ValueError):
        bridge.params_from_numpy({'bogus': []}, 'cpu')


@torch.no_grad()  # the serving form: no graph
def test_field_heads_match_jax():
    params = _params()
    jf, pf = _jax_field(), _port_field(params)
    rng = np.random.default_rng(2)
    x = rng.uniform(-1.0, 1.0, (300, 3)).astype(np.float32)
    d = rng.normal(size=(300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    xt, dt = torch.tensor(x), torch.tensor(d)

    sigma, geo = pf.density(xt)
    rs, rg = jf.density(params, x)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(rs), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(geo.numpy(), np.asarray(rg), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(pf.encode(xt).numpy(),
                               np.asarray(jf.encode(params, x)), atol=1e-5)
    assert pf.fused_heads_available() and jf.fused_heads_available(params)
    for a, b in zip(pf.all_heads(xt, dt), jf.all_heads(params, x, d)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(pf.color(dt, geo).numpy(),
                               np.asarray(jf.color(params, d, rg)),
                               rtol=RTOL, atol=ATOL)
    for a, b in zip(pf.semantic(geo), jf.semantic(params, rg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(pf.proposal_sigma(xt).numpy(),
                               np.asarray(jf.proposal_sigma(params, x)),
                               rtol=RTOL, atol=ATOL)


@torch.no_grad()  # the serving form: no graph
def test_kernel_packing_is_built_once_and_rebuilt_on_load():
    """The packed head and proposal weights are reused across chunks and
    rebuilt when new params are loaded, so the heads follow the new
    params."""
    params, other = _params(), _params(seed=3)
    jf, pf = _jax_field(), _port_field(params)
    rng = np.random.default_rng(7)
    x = rng.uniform(-1.0, 1.0, (50, 3)).astype(np.float32)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    xt, dt = torch.tensor(x), torch.tensor(d)
    pf.all_heads(xt, dt)
    pf.proposal_sigma(xt)
    packs = {k: v[2] for k, v in pf._packs.items()}
    assert set(packs) == {'heads', 'proposal'}
    pf.all_heads(xt, dt)
    pf.proposal_sigma(xt)
    assert all(pf._packs[k][2] is packs[k] for k in packs)
    bridge.load_params(pf, other)
    for a, b in zip(pf.all_heads(xt, dt), jf.all_heads(other, x, d)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(pf.proposal_sigma(xt).numpy(),
                               np.asarray(jf.proposal_sigma(other, x)),
                               rtol=RTOL, atol=ATOL)
    assert all(pf._packs[k][2] is not packs[k] for k in packs)


def test_sample_pdf_with_u_matches_jax():
    from autolabel_tpu.render.renderer import sample_pdf as jax_sample_pdf
    rng = np.random.default_rng(3)
    z_mid = np.sort(rng.uniform(0.1, 2.0, (20, 15)), -1).astype(np.float32)
    w = rng.uniform(0.0, 1.0, (20, 15)).astype(np.float32)
    ours = sample_pdf(torch.tensor(z_mid), torch.tensor(w), 8)
    ref = jax_sample_pdf(z_mid, w, 8, None)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6)
    u = rng.uniform(0.0, 1.0, (20, 8)).astype(np.float32)
    ours = sample_pdf(torch.tensor(z_mid), torch.tensor(w), 8,
                      u=torch.tensor(u))
    assert ours.shape == (20, 8)
    assert torch.isin(ours, torch.tensor(z_mid)).all()


@pytest.mark.parametrize('argv', [
    [],
    ['--proposal', '--heads-impl', 'pallas', '--grid-interp', 'trilinear'],
    ['--grid-preset', 'reference', '--features', 'lseg', '-g', '31'],
    ['--encoding', 'hg', '--rgb-weight', '0.5', '--depth-weight', '0.0',
     '--feature-dim', '512', '--proposal'],
])
def test_model_hash_and_config_match_jax(argv):
    ours = model_utils.model_flag_parser().parse_args(argv)
    ref = jax_model_utils.model_flag_parser().parse_args(argv)
    assert vars(ours) == vars(ref)
    assert model_utils.model_hash(ours) == jax_model_utils.model_hash(ref)
    assert model_utils.model_dir('/s', ours) == \
        jax_model_utils.model_dir('/s', ref)
    assert model_utils.effective_grid_interp(ours) == \
        jax_model_utils.effective_grid_interp(ref)
    lo, hi = np.array([-1.0, -2.0, 0.0]), np.array([1.0, 1.5, 3.0])
    assert model_utils.compute_bound(lo, hi) == \
        jax_model_utils.compute_bound(lo, hi)
    ref_cfg = jax_model_utils.create_model(lo, hi, 5, ref).config
    ours_cfg = model_utils.model_config(lo, hi, 5, ours)
    assert dataclasses.asdict(ours_cfg) == dataclasses.asdict(ref_cfg)


def test_rays_match_jax():
    from autolabel_tpu.core import rays as jax_rays
    rng = np.random.default_rng(6)
    T = np.eye(4)
    T[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    T[:3, 3] = rng.normal(size=3)
    np.testing.assert_allclose(rays.convert_pose(T),
                               jax_rays.convert_pose(T), rtol=1e-6)
    idx = rng.integers(0, 640 * 480, 100)
    for a, b in zip(rays.compute_directions(T[:3, :3], idx, 640, 500, 510,
                                            320, 240),
                    jax_rays.compute_directions(T[:3, :3], idx, 640, 500,
                                                510, 320, 240)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_entry_points_without_cpu_request_raise_when_no_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    cfg = FieldConfig(grid=HashGridConfig(**GRID))
    with pytest.raises(RuntimeError):
        Field(cfg)
    with pytest.raises(RuntimeError):
        bridge.params_from_numpy(_params(), None)
    flags = model_utils.model_flag_parser().parse_args([])
    with pytest.raises(RuntimeError):
        model_utils.create_model(np.zeros(3) - 1, np.ones(3), 2, flags)


def test_import_loads_neither_jax_nor_the_jax_package():
    code = '''
import importlib, pkgutil, sys
before = set(sys.modules)
import autolabel_tpu_torch
for info in pkgutil.walk_packages(autolabel_tpu_torch.__path__,
                                  'autolabel_tpu_torch.'):
    importlib.import_module(info.name)
from autolabel_tpu_torch.ops import _kernels
new = set(sys.modules) - before
# JAX and the JAX package never; cv2, PIL, h5py, matplotlib, sklearn,
# pandas (which a CUDA host may lack), ROS 1 and PyQt6 only at the call
# that needs them
bad = sorted(m for m in new if m.split('.')[0] in (
    'jax', 'autolabel_tpu', 'cv2', 'PIL', 'h5py', 'matplotlib', 'sklearn',
    'pandas', 'rospy', 'tf', 'cv_bridge', 'geometry_msgs', 'sensor_msgs',
    'std_msgs', 'std_srvs', 'PyQt6'))
print('BAD', bad)
print('BUILT', len(_kernels._libs))
print('MODULES', sorted(m for m in new if m.startswith('autolabel_tpu_torch')))
'''
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert 'BAD []' in out, out
    assert 'BUILT 0' in out, out  # importing compiles nothing
    for module in ('ops.hashgrid_cuda', 'ops.heads_cuda', 'render.renderer',
                   'render.occupancy', 'train.losses', 'train.optim',
                   'train.metrics', 'train.trainer', 'train.checkpoints',
                   'train.loader', 'train.tb_events', 'train.__main__',
                   'core.dataset', 'core.sampler', 'utils', 'utils.images',
                   'utils.fixtures', 'bridge', 'render.__main__',
                   'render.baked', 'ops.splat_cuda', 'visualization',
                   'constants', 'features.fallback',
                   'features.feature_utils', 'backend', 'gui',
                   'simulate_user', 'mapping', 'mapping.ba', 'register',
                   'train.pose_refine', 'features.layers',
                   'features.clip_text', 'features.demo_clip',
                   'features.vit', 'features.dino', 'features.fcn',
                   'features.fcn50', 'features.lseg_tower', 'features.lseg',
                   'utils.feature_utils', 'models.autoencoder',
                   'compute_feature_maps', 'train_demo_teacher',
                   'parallel', 'utils.ros_utils', 'ros', 'ros.node',
                   'ros.class_input', 'ui', 'ui.annotations', 'ui.canvas',
                   'ui.window'):
        assert f"'autolabel_tpu_torch.{module}'" in out, (module, out)


@pytest.mark.parametrize('script', ['chip_smoke.py', 'bench_torch.py',
                                    'register_witness.py'])
def test_card_scripts_import_only_the_port(script):
    """The card's scripts import nothing of JAX or the JAX package, at any
    depth: every import statement of their source, read as a syntax
    tree."""
    import ast
    with open(f"{REPO}/{script}") as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert any(n.startswith('autolabel_tpu_torch') for n in names)
    bad = [n for n in names if n.split('.')[0] in ('jax', 'autolabel_tpu')]
    assert not bad, bad
