"""The port's leaf ops (autolabel_tpu_torch.ops) against the JAX package.

Same inputs, made with numpy, go through both; on the CPU both compute in
fp32. The hash-grid encode is also held against the Pallas kernel run in
interpret mode, as tests/test_hashgrid_pallas.py runs it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autolabel_tpu.ops import activation as jax_activation
from autolabel_tpu.ops import encoders as jax_encoders
from autolabel_tpu.ops.hashgrid_pallas import hashgrid_encode_pallas
from autolabel_tpu_torch.ops import _kernels, encoders, hashgrid_cuda
from autolabel_tpu_torch.ops.activation import trunc_exp

# Same gathers and products in the same order: only fp32 rounding of the
# summation order may differ.
ENCODE_ATOL = 1e-5


def _grid(variant='native', n_features=8, **kwargs):
    base = dict(n_levels=4, n_features=n_features, log2_hashmap_size=10,
                base_resolution=8, per_level_scale=1.6, variant=variant)
    base.update(kwargs)
    return base


def _table(rng, cfg):
    return rng.uniform(-1.0, 1.0, (cfg['n_levels'],
                                   1 << cfg['log2_hashmap_size'],
                                   cfg['n_features'])).astype(np.float32)


def _points(rng, n, domain='unit'):
    """Points in the unit cube with its corners and faces, or (domain
    'outside') points up to 0.05 outside it: negative cell coordinates,
    where dense indices wrap floor-mod the level size and hashes wrap in
    uint32."""
    if domain == 'outside':
        x = rng.uniform(-0.05, 1.05, (n, 3)).astype(np.float32)
        x[:3] = [[-1e-3, -1e-3, -1e-3], [-0.02, 0.5, 1.02],
                 [1.001, -0.3, 0.0]]
        return x
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    x[:4] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 0.5],
             [1.0, 0.0, 0.999999]]
    return x


def test_trunc_exp_forward_and_gradient():
    x = np.linspace(-30.0, 30.0, 61, dtype=np.float32)
    xt = torch.tensor(x, requires_grad=True)
    y = trunc_exp(xt)
    (y * torch.arange(61.0)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jax_activation.trunc_exp(x)),
                               rtol=1e-6)
    g = jax.grad(lambda v: jnp.sum(jax_activation.trunc_exp(v)
                                   * jnp.arange(61.0)))(x)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g), rtol=1e-6)


@pytest.mark.parametrize('n_freq', [2, 6, 10])
def test_frequency_encode(n_freq):
    x = np.random.default_rng(0).uniform(-2, 2, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        encoders.frequency_encode(torch.tensor(x), n_freq).numpy(),
        np.asarray(jax_encoders.frequency_encode(x, n_freq)),
        atol=1e-5)


def test_sh_encode():
    d = np.random.default_rng(1).normal(size=(50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(encoders.sh_encode(torch.tensor(d)).numpy(),
                               np.asarray(jax_encoders.sh_encode(d)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('variant', ['native', 'tcnn', 'torch_ngp'])
def test_hashgrid_config_properties(variant):
    for kwargs in (dict(), dict(n_levels=4, n_features=128,
                                log2_hashmap_size=15, per_level_scale=5.04),
                   dict(n_levels=8, base_resolution=4,
                        per_level_scale=1.37, log2_hashmap_size=12)):
        ours = encoders.HashGridConfig(variant=variant, **kwargs)
        ref = jax_encoders.HashGridConfig(variant=variant, **kwargs)
        for prop in ('table_size', 'resolutions', 'scales', 'pos_offset',
                     'dense_strides', 'level_sizes', 'out_dim'):
            assert getattr(ours, prop) == getattr(ref, prop), prop
    ours = encoders.HashGridConfig.from_desired_resolution(2 ** 18,
                                                           variant=variant)
    ref = jax_encoders.HashGridConfig.from_desired_resolution(
        2 ** 18, variant=variant)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert dataclasses.asdict(encoders.TPU_GRID) == \
        dataclasses.asdict(jax_encoders.TPU_GRID)


def test_hashgrid_init_shape_and_range():
    cfg = encoders.HashGridConfig(**_grid())
    t = encoders.hashgrid_init(torch.Generator().manual_seed(0), cfg)
    assert t.shape == (4, 1024, 8) and t.dtype == torch.float32
    assert float(t.abs().max()) <= 1e-4


@pytest.mark.parametrize('domain', ['unit', 'outside'])
@pytest.mark.parametrize('variant', ['native', 'tcnn', 'torch_ngp'])
@pytest.mark.parametrize('n_features', [8, 16, 2])
def test_plain_encode_matches_jax(variant, n_features, domain):
    rng = np.random.default_rng(2)
    cfg = _grid(variant, n_features)
    table, x = _table(rng, cfg), _points(rng, 300, domain)
    ours = hashgrid_cuda.hashgrid_encode(
        torch.tensor(table), torch.tensor(x), encoders.HashGridConfig(**cfg))
    ref = jax_encoders.hashgrid_encode(table, x,
                                       jax_encoders.HashGridConfig(**cfg))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                               atol=ENCODE_ATOL)


@pytest.mark.parametrize('n_features', [16, 2])
def test_plain_encode_matches_pallas_interpret(n_features):
    rng = np.random.default_rng(3)
    cfg = _grid('native', n_features, log2_hashmap_size=12)
    table, x = _table(rng, cfg), _points(rng, 200)
    ours = hashgrid_cuda.hashgrid_encode_plain(
        torch.tensor(table), torch.tensor(x), encoders.HashGridConfig(**cfg))
    ref = hashgrid_encode_pallas(table, x,
                                 jax_encoders.HashGridConfig(**cfg),
                                 interpret=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                               atol=ENCODE_ATOL)


def _reference_lattice(variant):
    """The reference presets at full size: 16 levels of up to 2^19 rows of
    2 features, tcnn (`--grid-preset reference` imported from tcnn) or
    torch-ngp (desired resolution 2^18: level sizes not powers of two)."""
    if variant == 'tcnn':
        return dict(variant='tcnn')
    return dataclasses.asdict(encoders.HashGridConfig.from_desired_resolution(
        2 ** 18, variant='torch_ngp'))


@pytest.mark.parametrize('domain', ['unit', 'outside'])
@pytest.mark.parametrize('variant', ['tcnn', 'torch_ngp'])
def test_plain_encode_matches_jax_on_the_reference_lattices(variant, domain,
                                                            monkeypatch):
    """The port's plain encode (K1's plain version) against JAX's
    encoders.hashgrid_encode on the full reference lattices, rows beyond a
    level's size zero as torch_import packs them. XLA computes a position
    x * scale + 0.5 as one fma; the port rounds the product first, so a
    position differs by up to one ulp of it, each of a corner's 3 weight
    factors by as much, and an output by up to 8 corners x 3 ulp(pos) x
    the level's largest |row|. With the position taken as XLA takes it
    (the product and sum in float64, rounded once to fp32), the blend
    agrees within ENCODE_ATOL: XLA may contract a product into the next
    sum, a rounding of each."""
    config = encoders.HashGridConfig(**_reference_lattice(variant))
    rng = np.random.default_rng(24)
    table = rng.normal(0.0, 0.5, (config.n_levels, config.table_size,
                                  config.n_features)).astype(np.float32)
    for level, size in enumerate(config.level_sizes):
        table[level, size:] = 0.0
    x = _points(rng, 300, domain)
    ref = np.asarray(jax_encoders.hashgrid_encode(
        table, x, jax_encoders.HashGridConfig(**_reference_lattice(variant))))
    t, xt = torch.tensor(table), torch.tensor(x)
    ours = hashgrid_cuda.hashgrid_encode_plain(t, xt, config).numpy()
    assert ours.shape == ref.shape == (300, 32)
    scales = np.asarray(config.scales, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(scales + 1.0)) - 23)
    bound = np.repeat(24 * ulp * np.abs(table).max(axis=(1, 2)),
                      config.n_features) + ENCODE_ATOL
    assert (np.abs(ours - ref) <= bound).all()
    geometry = encoders._grid_geometry

    def fused(x, config):
        _, _, stride, use_dense, size = geometry(x, config)
        s = torch.as_tensor(scales, dtype=torch.float64)
        pos = (s[None, :, None] * x.T[:, None, :].double()
               + config.pos_offset).float()
        cell = torch.floor(pos)
        return cell.to(torch.int64), pos - cell, stride, use_dense, size

    monkeypatch.setattr(encoders, '_grid_geometry', fused)
    ours = hashgrid_cuda.hashgrid_encode_plain(t, xt, config).numpy()
    np.testing.assert_allclose(ours, ref, atol=ENCODE_ATOL, rtol=0)


def test_tcnn_hash_wraps_uint32_for_non_power_of_two_levels():
    """'tcnn' level sizes are multiples of 8, not always powers of two. A
    hash taken in int64 without the uint32 wrap agrees with JAX's uint32
    hash modulo a power of two but not modulo such a size; the corner
    index must match JAX's for every level size, and the encode of a grid
    mixing both kinds of level must match too."""
    cfg = _grid('tcnn', 2, n_levels=4, base_resolution=16,
                per_level_scale=1.5, log2_hashmap_size=14)
    config = encoders.HashGridConfig(**cfg)
    sizes = config.level_sizes
    assert any(s & (s - 1) for s in sizes)  # some not powers of two
    assert not all(st ** 3 <= s for st, s in zip(config.dense_strides,
                                                 sizes))  # some hashed
    rng = np.random.default_rng(4)
    table, x = _table(rng, cfg), _points(rng, 400)
    ours = encoders.hashgrid_encode(torch.tensor(table), torch.tensor(x),
                                    config)
    ref = jax_encoders.hashgrid_encode(table, x,
                                       jax_encoders.HashGridConfig(**cfg))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                               atol=ENCODE_ATOL)
    cell = torch.tensor([[1000, 70001, 3], [2047, 5, 99999]]).T
    for size in sizes:
        ours_idx = encoders._corner_index(cell, (1, 1, 1), 0, False, size)
        ref_idx = jax_encoders._corner_index(
            jnp.asarray(cell.numpy(), jnp.int32), (1, 1, 1), 0, False,
            jnp.asarray(size, jnp.int32))
        np.testing.assert_array_equal(ours_idx.numpy(), np.asarray(ref_idx))


def test_encode_modes_outside_the_slice_raise():
    """A PRNG key raises (the port takes every estimator's uniforms as u:
    the stochastic and residual encodes' cases are in
    test_torch_port_stochastic); simplex and the sampled backward refuse
    narrow rows and row counts other than 1, 2 or A, as the JAX package
    does."""
    cfg = encoders.HashGridConfig(**_grid())
    table = torch.zeros((4, 1024, 8))
    x = torch.zeros((4, 3))
    u = torch.zeros((4, 4))
    with pytest.raises(NotImplementedError):
        encoders.hashgrid_encode(table, x, cfg, key=1)
    with pytest.raises(NotImplementedError):
        encoders.hashgrid_encode(table, x, cfg, sampled_backward=3, u=u)
    narrow = encoders.HashGridConfig(**_grid(n_features=4))
    with pytest.raises(NotImplementedError):
        encoders.hashgrid_encode(torch.zeros((4, 1024, 4)), x, narrow,
                                 interp='simplex')
    with pytest.raises(NotImplementedError):
        encoders.hashgrid_encode(torch.zeros((4, 1024, 4)), x, narrow,
                                 sampled_backward=2, u=u)


def test_cpu_encode_launches_no_kernel():
    _kernels.reset_launches()
    cfg = encoders.HashGridConfig(**_grid())
    hashgrid_cuda.hashgrid_encode(torch.zeros((4, 1024, 8)),
                                  torch.zeros((5, 3)), cfg)
    assert _kernels.launches[hashgrid_cuda.NAME] == 0
