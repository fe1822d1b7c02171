"""The port's render (serving) path against the JAX package on the CPU.

render_rays, StagedRenderer, InferenceModel and checkpoints, with the same
params on both sides. The
JAX reference runs with grid_impl='xla': its Pallas encode has no
interpret switch through hashgrid_encode_hybrid, and
tests/test_hashgrid_pallas.py proves that path equal to the kernel. Its
fused heads run in interpret mode. Both compute in fp32; rtol=1e-4 covers
the summation order of the products and of the compositing sums.
"""
import dataclasses
import os

import jax
import numpy as np
import optax
import pytest
import torch

from autolabel_tpu import model_utils as jax_model_utils
from autolabel_tpu.inference import InferenceModel as JaxInferenceModel
from autolabel_tpu.models.field import Field as JaxField
from autolabel_tpu.models.field import FieldConfig as JaxFieldConfig
from autolabel_tpu.ops.encoders import HashGridConfig as JaxGridConfig
from autolabel_tpu.render.renderer import RenderOptions as JaxRenderOptions
from autolabel_tpu.render.renderer import render_rays as jax_render_rays
from autolabel_tpu.train import checkpoints as jax_checkpoints
from autolabel_tpu_torch import bridge, model_utils
from autolabel_tpu_torch.core import rays
from autolabel_tpu_torch.inference import InferenceModel
from autolabel_tpu_torch.models.field import Field, FieldConfig
from autolabel_tpu_torch.ops import _kernels
from autolabel_tpu_torch.ops.encoders import HashGridConfig
from autolabel_tpu_torch.render.renderer import RenderOptions, render_rays
from autolabel_tpu_torch.train import checkpoints

RTOL, ATOL = 1e-4, 1e-5
GRID = dict(n_levels=4, n_features=8, log2_hashmap_size=10,
            base_resolution=8, per_level_scale=1.6)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_KEYS = ('image', 'depth', 'depth_variance', 'semantic',
            'semantic_features', 'coordinates_map', 'weights_sum')


def _config_kwargs(**overrides):
    kw = dict(encoding='hg+freq', hidden_dim=64, hidden_dim_color=64,
              hidden_dim_semantic=32, semantic_classes=4, bound=1.0,
              proposal=True, heads_impl='pallas')
    kw.update(overrides)
    return kw


def _jax_field(**overrides):
    return JaxField(JaxFieldConfig(grid=JaxGridConfig(**GRID),
                                   **_config_kwargs(**overrides)))


def _port_field(params, **overrides):
    kw = _config_kwargs(**overrides)
    kw.setdefault('grid_impl', 'pallas')
    field = Field(FieldConfig(grid=HashGridConfig(**GRID), **kw),
                  device='cpu')
    return bridge.load_params(field, params)


def _params(seed=0):
    """JAX-initialized params with a table scaled up so that density,
    color and semantics are far from their init values."""
    params = jax.tree.map(np.asarray,
                          _jax_field().init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    grid = params['encoder']['grid']
    params['encoder']['grid'] = rng.normal(
        0.0, 0.5, grid.shape).astype(np.float32)
    return params


def _rays(n, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    norms = rng.uniform(1.0, 1.3, (n, 1)).astype(np.float32)
    return o, d, norms


def _assert_outputs_close(ours, ref, keys=OUT_KEYS):
    for k in keys:
        np.testing.assert_allclose(np.asarray(ours[k]), np.asarray(ref[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@torch.no_grad()  # the eval form: no graph, no interlevel loss
@pytest.mark.parametrize('branch', ['proposal_fused', 'uniform_unfused',
                                    'upsample'])
def test_render_rays_matches_jax(branch):
    params = _params()
    if branch == 'proposal_fused':
        overrides, opts = {}, dict(num_steps=8, proposal_steps=16)
    elif branch == 'uniform_unfused':
        overrides, opts = dict(heads_impl='xla'), dict(num_steps=16)
    else:
        overrides, opts = dict(heads_impl='xla'), dict(num_steps=8,
                                                       upsample_steps=8)
    o, d, norms = _rays(16)
    ours = render_rays(_port_field(params, **overrides), torch.tensor(o),
                       torch.tensor(d), torch.tensor(norms),
                       options=RenderOptions(**opts))
    ref = jax_render_rays(_jax_field(**overrides), params, o, d, norms,
                          options=JaxRenderOptions(**opts))
    assert set(ours) == set(OUT_KEYS)
    _assert_outputs_close(ours, ref)
    assert float(ref['weights_sum'].max()) > 0.2  # non-trivial density


def test_render_options_defaults_match_jax():
    assert dataclasses.asdict(RenderOptions()) == \
        dataclasses.asdict(JaxRenderOptions())


def _frame_batch(h=6, w=8):
    R = np.linalg.qr(np.random.default_rng(4).normal(size=(3, 3)))[0]
    dirs, norms = rays.compute_directions(R, np.arange(h * w), w, 5.0, 5.0,
                                          w / 2, h / 2)
    origin = np.array([0.1, -0.2, 0.05], np.float32)
    return {'rays_o': np.broadcast_to(origin, (h, w, 3)).astype(np.float32),
            'rays_d': dirs.reshape(h, w, 3),
            'direction_norms': norms.reshape(h, w, 1)}


def test_jax_checkpoint_renders_the_same_through_the_port(tmp_path):
    params = _params()
    model_dir = str(tmp_path / 'model')
    jax_checkpoints.save_checkpoint(
        os.path.join(model_dir, 'checkpoints', 'best.pth'),
        {'params': params, 'ema': params, 'step': 7,
         'opt_state': optax.adam(1e-3).init(params)})
    batch = _frame_batch()
    kwargs = dict(num_steps=16, proposal_steps=32, max_ray_batch=32)
    ref = JaxInferenceModel.from_checkpoint(_jax_field(), model_dir,
                                            **kwargs).render(batch)
    cfg = FieldConfig(grid=HashGridConfig(**GRID), grid_impl='pallas',
                      **_config_kwargs())
    _kernels.reset_launches()
    model = InferenceModel.from_checkpoint(Field(cfg, device='cpu'),
                                           model_dir, **kwargs)
    ours = model.render(batch)
    assert sum(_kernels.launches.values()) == 0  # plain versions on the CPU
    assert ours['image'].shape == (6, 8, 3)
    _assert_outputs_close(ours, ref)

    pts = np.random.default_rng(5).uniform(-1, 1, (70, 3)).astype(
        np.float32)
    jm = JaxInferenceModel.from_checkpoint(_jax_field(), model_dir, **kwargs)
    for key in ('sigma', 'geo_feat'):
        np.testing.assert_allclose(model.density(pts)[key],
                                   jm.density(pts)[key], rtol=RTOL,
                                   atol=ATOL)
    geo = jm.density(pts)['geo_feat']
    for a, b in zip(model.semantic(geo), jm.semantic(geo)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_port_checkpoint_loads_in_jax(tmp_path):
    params = _params()
    field = _port_field(params)
    tree = bridge.params_to_numpy(field)
    path = str(tmp_path / 'checkpoints' / 'ep0001.pth')
    checkpoints.save_checkpoint(path, {'params': tree, 'ema': tree,
                                       'step': 3}, include_optimizer=False)
    assert checkpoints.find_checkpoint(str(tmp_path / 'checkpoints')) == path
    loaded, ema = jax_model_utils.load_checkpoint(str(tmp_path /
                                                      'checkpoints'))
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    ours, _ = model_utils.load_checkpoint(str(tmp_path / 'checkpoints'))
    assert checkpoints.load_checkpoint(str(tmp_path / 'nothing')) is None
    with pytest.raises(FileNotFoundError):
        model_utils.load_checkpoint(str(tmp_path / 'nothing'))
    np.testing.assert_array_equal(ours['encoder']['grid'],
                                  params['encoder']['grid'])
