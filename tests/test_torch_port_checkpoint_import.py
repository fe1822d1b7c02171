"""Reference (torch-ngp) checkpoints in the port against the JAX package,
on the CPU.

Archives in the reference's torch.save format, zip and legacy: the freq
model of tests/test_torch_import.py, and hg+freq and hg models at the
reference's own grid (16 levels of up to 2^19 rows of 2 features, on the
tcnn and torch-ngp lattices). The port's model_utils.load_into_field gives
the JAX package's field config (geo_relu, the grid and its variant, the
'xla' heads) and bit-equal param and EMA arrays; the imported field's
density, colour and semantic heads match the JAX field's within the
port's fp32 limits (rtol 1e-4, atol 1e-5: the same products, summed in
another order). Checkpoints travel both ways: the port's export imports
bit-equal in the JAX package and the JAX package's export in the port, and
the port's import and export functions are bit-equal to the JAX
package's. An archive holding an nn.Module is refused.
"""
import dataclasses
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from autolabel_tpu import model_utils as jax_model_utils
from autolabel_tpu import torch_export as jax_torch_export
from autolabel_tpu import torch_import as jax_torch_import
from autolabel_tpu.models.field import Field as JaxField
from autolabel_tpu.models.field import FieldConfig as JaxFieldConfig
from autolabel_tpu.ops.encoders import HashGridConfig as JaxGridConfig
from autolabel_tpu.utils.torch_zip import load_torch_file
from autolabel_tpu_torch import bridge, model_utils, torch_export, torch_import
from autolabel_tpu_torch.inference import InferenceModel
from autolabel_tpu_torch.models.field import Field, FieldConfig
from autolabel_tpu_torch.train import checkpoints
from tests.test_torch_import import _reference_freq_checkpoint

RTOL, ATOL = 1e-4, 1e-5
N_CLASSES, BOUND = 3, 1.5


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """The module's torch work on one thread (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference_payload(encoding):
    """A reference-format payload (tensors) of a random model: the freq
    model of tests/test_torch_import.py, or an hg+freq / hg model at the
    reference's grid with an EMA, its state dict laid out by the JAX
    package's export (the ALNetwork keys and tcnn layouts)."""
    if encoding == 'freq':
        return _reference_freq_checkpoint(torch, n_classes=N_CLASSES)
    grid = dataclasses.replace(
        JaxFieldConfig(encoding=encoding).grid_config,
        variant='tcnn' if encoding == 'hg+freq' else 'torch_ngp')
    config = JaxFieldConfig(encoding=encoding, semantic_classes=N_CLASSES,
                            bound=BOUND, grid=grid, geo_relu=True)
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          JaxField(config).init(jax.random.PRNGKey(7)))
    rng = np.random.default_rng(8)
    params['encoder']['grid'] = rng.normal(
        size=params['encoder']['grid'].shape).astype(np.float32) * 0.3
    ema = jax.tree.map(lambda x: x * np.float32(0.5), params)
    payload = jax_torch_export.convert_to_torch_state(
        params, config, ema=ema, global_step=4000, epoch=4)
    return torch_export._to_tensors(payload)


@pytest.fixture(scope='module')
def archives(tmp_path_factory):
    """{(encoding, zipped): checkpoints dir holding one archive}."""
    root = tmp_path_factory.mktemp('reference')
    out = {}
    for encoding, zipped in (('freq', True), ('freq', False),
                             ('hg+freq', True), ('hg', False)):
        path = root / f'{encoding}_{int(zipped)}' / 'checkpoints'
        path.mkdir(parents=True)
        torch.save(_reference_payload(encoding), path / 'ngp_ep0004.pth',
                   _use_new_zipfile_serialization=zipped)
        out[encoding, zipped] = str(path)
    return out


def _configs(encoding):
    """The (JAX, port) config a CLI would build for the scene before the
    import (the TPU grid preset, whose grid the import replaces)."""
    from autolabel_tpu.ops.encoders import TPU_GRID as JAX_TPU_GRID
    from autolabel_tpu_torch.ops.encoders import TPU_GRID
    grid = encoding != 'freq'
    return (JaxFieldConfig(encoding=encoding, semantic_classes=N_CLASSES,
                           bound=BOUND, grid=JAX_TPU_GRID if grid else None),
            FieldConfig(encoding=encoding, semantic_classes=N_CLASSES,
                        bound=BOUND, grid=TPU_GRID if grid else None))


def _assert_trees_equal(ours, ref):
    assert sorted(ours) == sorted(ref)
    for key in ref:
        if isinstance(ref[key], dict):
            _assert_trees_equal(ours[key], ref[key])
        else:
            assert len(ours[key]) == len(ref[key]), key
            for a, b in zip(ours[key], ref[key]):
                a, b = np.asarray(a), np.asarray(b)
                assert a.dtype == b.dtype == np.float32, key
                assert np.array_equal(a, b), key


@pytest.mark.parametrize('encoding,zipped', [
    ('freq', True), ('freq', False), ('hg+freq', True), ('hg', False)])
def test_load_into_field_matches_jax(archives, encoding, zipped):
    directory = archives[encoding, zipped]
    jax_config, config = _configs(encoding)
    ref_field, ref_params, ref_ema = jax_model_utils.load_into_field(
        JaxField(jax_config), directory)
    field, params, ema = model_utils.load_into_field(
        Field(config, device='cpu'), directory)
    ours_c, ref_c = field.config, ref_field.config
    assert ours_c.geo_relu and ref_c.geo_relu
    assert ours_c.heads_impl == ref_c.heads_impl == 'xla'
    assert ours_c.grid_impl == ref_c.grid_impl == 'xla'
    assert ours_c.semantic_classes == ref_c.semantic_classes == N_CLASSES
    if encoding == 'freq':
        assert ours_c.grid_config is None and ref_c.grid_config is None
    else:
        assert (dataclasses.asdict(ours_c.grid_config)
                == dataclasses.asdict(ref_c.grid_config))
        assert ours_c.grid_config.variant == (
            'tcnn' if encoding == 'hg+freq' else 'torch_ngp')
    assert field.device.type == 'cpu'
    _assert_trees_equal(params, ref_params)
    _assert_trees_equal(ema, ref_ema)
    if encoding != 'freq':
        # the archive's EMA is its own (half the live params)
        assert not np.array_equal(ema['sigma_net'][0], params['sigma_net'][0])


def _encode_bound(config, table):
    """How far the port's grid encode may lie from the JAX package's, per
    output column. On the tcnn and torch-ngp lattices a position is
    x * scale + 0.5; XLA fuses that into one fma, the port (and K1) round
    the product first, so a position differs by up to one ulp of it, a
    trilinear weight by up to 3 of those (one per axis) and an encode
    value by up to 8 corners x 3 ulp(scale) x the level's largest |row|."""
    grid = config.grid_config
    bounds = []
    for l, scale in enumerate(grid.scales):
        ulp = 2.0 ** (np.floor(np.log2(scale + 1.0)) - 23)
        bounds += [24 * ulp * float(np.abs(table[l]).max())] * grid.n_features
    return np.asarray(bounds) + ATOL


@pytest.mark.parametrize('encoding,zipped', [
    ('freq', False), ('hg+freq', True), ('hg', False)])
def test_imported_heads_match_jax(archives, encoding, zipped):
    """The encode within _encode_bound (the frequency columns within
    ATOL); the heads on the same inputs (JAX's encode, geo features and
    directions) within RTOL, ATOL; the freq model's density and the
    serving handle's chunked density query end to end."""
    from autolabel_tpu_torch.ops.activation import trunc_exp
    from autolabel_tpu_torch.ops.mlp import mlp_apply
    directory = archives[encoding, zipped]
    jax_config, config = _configs(encoding)
    ref_field, ref_params, _ = jax_model_utils.load_into_field(
        JaxField(jax_config), directory)
    model = InferenceModel.from_checkpoint(
        Field(config, device='cpu'), os.path.dirname(directory))
    field = model.field
    assert field.config.geo_relu
    rng = np.random.default_rng(9)
    x = (rng.uniform(-1.0, 1.0, (512, 3)) * BOUND).astype(np.float32)
    d = rng.normal(size=(512, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    enc_r = np.asarray(ref_field.encode(ref_params, x))
    sigma_r, geo_r = ref_field.density(ref_params, x)
    rgb_r = ref_field.color(ref_params, d, geo_r)
    logits_r, feats_r = ref_field.semantic(ref_params, geo_r)
    with torch.no_grad():
        enc = field.encode(torch.from_numpy(x)).numpy()
        h = mlp_apply(list(field.sigma_net), torch.from_numpy(enc_r))
        sigma, geo = trunc_exp(h[:, 0]), h[:, 1:]
        rgb = field.color(torch.from_numpy(d),
                          torch.from_numpy(np.asarray(geo_r)))
        logits, feats = field.semantic(torch.from_numpy(np.asarray(geo_r)))
    if encoding == 'freq':
        np.testing.assert_allclose(enc, enc_r, atol=ATOL, rtol=0)
    else:
        freq = 12 if encoding == 'hg+freq' else 0
        np.testing.assert_allclose(enc[:, :freq], enc_r[:, :freq],
                                   atol=ATOL, rtol=0)
        bound = _encode_bound(field.config, ref_params['encoder']['grid'])
        assert (np.abs(enc[:, freq:] - enc_r[:, freq:]) <= bound).all()
    for got, want in ((sigma, sigma_r), (geo, geo_r), (rgb, rgb_r),
                      (logits, logits_r), (feats, feats_r)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
    if encoding == 'freq':
        out = model.density(x)
        np.testing.assert_allclose(out['sigma'], np.asarray(sigma_r),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(out['geo_feat'], np.asarray(geo_r),
                                   rtol=RTOL, atol=ATOL)


def test_import_functions_bit_equal_to_jax():
    rng = np.random.default_rng(10)
    assert np.array_equal(torch_import.sh_quirk_fold(),
                          jax_torch_import.sh_quirk_fold())
    for dims, freqs in ((3, 2), (3, 10)):
        assert np.array_equal(torch_import._freq_row_perm(dims, freqs),
                              jax_torch_import._freq_row_perm(dims, freqs))
    for in_dim, hidden, out_dim, n_hidden in ((44, 128, 16, 2),
                                              (31, 128, 3, 2),
                                              (79, 64, 606, 1)):
        flat = rng.normal(size=torch_import._next16(in_dim) * hidden
                          + hidden * hidden * (n_hidden - 1)
                          + torch_import._next16(out_dim) * hidden)
        flat = flat.astype(np.float32)
        ours = torch_import.unpack_tcnn_mlp(flat, in_dim, hidden, out_dim,
                                            n_hidden)
        ref = jax_torch_import.unpack_tcnn_mlp(flat, in_dim, hidden,
                                               out_dim, n_hidden)
        for a, b in zip(ours, ref):
            assert np.array_equal(a, b)
        weights = [rng.normal(size=w.shape).astype(np.float32)
                   for w in ours]
        assert np.array_equal(
            torch_export.pack_tcnn_mlp(weights, in_dim, hidden, out_dim,
                                       n_hidden),
            jax_torch_export.pack_tcnn_mlp(weights, in_dim, hidden,
                                           out_dim, n_hidden))
    payload = {'model': {'sigma_net.params': np.zeros(3)}}
    assert torch_import.looks_like_torch_state(payload)
    assert not torch_import.looks_like_torch_state({'model': {
        'sigma_net': [np.zeros(3)]}})


def _port_reference_field(encoding):
    """A port field of the reference's form at a small grid (the export
    takes any size)."""
    from autolabel_tpu_torch.ops.encoders import HashGridConfig
    grid = None
    if encoding == 'hg+freq':
        grid = HashGridConfig(n_levels=4, log2_hashmap_size=8,
                              variant='tcnn')
    elif encoding == 'hg':
        grid = HashGridConfig.from_desired_resolution(
            2 ** 10, n_levels=4, log2_hashmap_size=8, variant='torch_ngp')
    return Field(FieldConfig(encoding=encoding, semantic_classes=N_CLASSES,
                             bound=BOUND, grid=grid, geo_relu=True),
                 device='cpu', generator=torch.Generator().manual_seed(3))


def _jax_config(config):
    grid = None
    if config.grid is not None:
        grid = JaxGridConfig(**dataclasses.asdict(config.grid))
    return JaxFieldConfig(**dict(dataclasses.asdict(config), grid=grid))


@pytest.mark.parametrize('encoding', ['hg+freq', 'hg', 'freq'])
def test_checkpoints_travel_both_ways(tmp_path, encoding):
    field = _port_reference_field(encoding)
    params = bridge.params_to_numpy(field)
    ema = {k: ([w + np.float32(0.01) for w in v] if isinstance(v, list)
               else {n: w + np.float32(0.01) for n, w in v.items()})
           for k, v in params.items()}
    config, jax_config = field.config, _jax_config(field.config)

    # the payload dicts are bit-equal before they are written
    ours = torch_export.convert_to_torch_state(params, config, ema=ema,
                                               global_step=7, epoch=1)
    ref = jax_torch_export.convert_to_torch_state(params, jax_config,
                                                  ema=ema, global_step=7,
                                                  epoch=1)
    assert list(ours['model']) == list(ref['model'])
    for key in ref['model']:
        a, b = ours['model'][key], ref['model'][key]
        assert a.dtype == b.dtype and np.array_equal(a, b), key
    for a, b in zip(ours['ema']['shadow_params'],
                    ref['ema']['shadow_params']):
        assert np.array_equal(a, b)

    # the port's archive in the JAX package
    ours_dir, ref_dir = tmp_path / 'ours', tmp_path / 'ref'
    ours_dir.mkdir()
    ref_dir.mkdir()
    torch_export.export_torch_checkpoint(str(ours_dir / 'ngp.pth'), params,
                                         config, ema=ema, global_step=7)
    jax_torch_export.export_torch_checkpoint(str(ref_dir / 'ngp.pth'),
                                             params, jax_config, ema=ema,
                                             global_step=7)
    jax_side = jax_torch_import.convert_torch_payload(
        load_torch_file(str(ours_dir / 'ngp.pth')), jax_config)
    port_side = torch_import.convert_torch_payload(
        checkpoints.load_checkpoint_file(str(ref_dir / 'ngp.pth')), config)
    same_side = torch_import.convert_torch_payload(
        checkpoints.load_checkpoint_file(str(ours_dir / 'ngp.pth')), config)
    for a in (jax_side, port_side, same_side):
        assert a['global_step'] == 7
        _assert_trees_equal(a['model'], same_side['model'])
        _assert_trees_equal(a['ema'], same_side['ema'])
    # and the round trip gives the params back (the colour net's 16
    # SH-folded rows within the fold's fp32 rounding, as in the JAX tests)
    for name in ('sigma_net', 'semantic_features', 'semantic_out'):
        for a, b in zip(same_side['model'][name], params[name]):
            assert np.array_equal(a, b)
    np.testing.assert_allclose(same_side['model']['color_net'][0][:16],
                               params['color_net'][0][:16], rtol=1e-4,
                               atol=1e-7)
    if encoding != 'freq':
        assert np.array_equal(same_side['model']['encoder']['grid'],
                              params['encoder']['grid'])


def test_export_refusals_match_jax():
    field = Field(FieldConfig(encoding='freq', semantic_classes=2),
                  device='cpu')
    params = bridge.params_to_numpy(field)
    with pytest.raises(ValueError, match='geo_relu'):
        torch_export.convert_to_torch_state(params, field.config)
    assert 'sigma_net.params' in torch_export.convert_to_torch_state(
        params, field.config, force=True)['model']
    from autolabel_tpu_torch.ops.encoders import HashGridConfig
    field = Field(FieldConfig(encoding='hg+freq', semantic_classes=2,
                              geo_relu=True,
                              grid=HashGridConfig(n_levels=2,
                                                  log2_hashmap_size=6)),
                  device='cpu')
    with pytest.raises(ValueError, match='tcnn'):
        torch_export.convert_to_torch_state(bridge.params_to_numpy(field),
                                            field.config)


def test_archive_with_a_module_is_refused(tmp_path):
    (tmp_path / 'checkpoints').mkdir()
    path = tmp_path / 'checkpoints' / 'evil.pth'
    torch.save({'model': torch.nn.Linear(2, 2)}, path)
    with pytest.raises(pickle.UnpicklingError):
        checkpoints.load_checkpoint_file(str(path))
    torch.save({'m': torch.nn.Linear(2, 2)}, path,
               _use_new_zipfile_serialization=False)
    with pytest.raises(pickle.UnpicklingError):
        checkpoints.load_checkpoint_file(str(path))


def test_torch_reads_keep_values_and_widen_bfloat16(tmp_path):
    """The archive's non-tensor entries come back as they were; bf16
    tensors as their float32 values."""
    path = tmp_path / 'a.pth'
    state = {'f': torch.randn(3, 2), 'b': torch.randn(4).bfloat16(),
             'n': 5, 's': 'ngp', 'none': None, 'l': [1, torch.ones(2)]}
    torch.save(state, path)
    out = checkpoints.load_checkpoint_file(str(path))
    assert np.array_equal(out['f'], state['f'].numpy())
    assert out['b'].dtype == np.float32
    assert np.array_equal(out['b'], state['b'].float().numpy())
    assert out['n'] == 5 and out['s'] == 'ngp' and out['none'] is None
    assert out['l'][0] == 1 and np.array_equal(out['l'][1], np.ones(2))


def test_load_checkpoint_needs_the_config(archives):
    with pytest.raises(ValueError, match='FieldConfig'):
        model_utils.load_checkpoint(archives['freq', True])
    _, config = _configs('freq')
    params, _ = model_utils.load_checkpoint(
        archives['freq', True], config=dataclasses.replace(config,
                                                           geo_relu=True))
    ref, _ = jax_model_utils.load_checkpoint(
        archives['freq', True],
        config=dataclasses.replace(_configs('freq')[0], geo_relu=True))
    _assert_trees_equal(params, ref)


def test_numpy_checkpoints_keep_their_field(tmp_path):
    """A checkpoint of either package's trainer loads into `field` as it
    is, but for a semantic head of another class count, whose field is
    rebuilt at the checkpoint's count (as the JAX package's params carry
    their shapes)."""
    field = _port_reference_field('freq')
    params = bridge.params_to_numpy(field)
    (tmp_path / 'checkpoints').mkdir()
    checkpoints.save_checkpoint(str(tmp_path / 'checkpoints' / 'a.pth'),
                                {'params': params, 'ema': params, 'step': 3},
                                include_optimizer=False)
    same, loaded, _ = model_utils.load_into_field(
        field, str(tmp_path / 'checkpoints'))
    assert same is field
    _assert_trees_equal(loaded, params)
    wide = Field(dataclasses.replace(field.config, semantic_classes=606),
                 device='cpu')
    rebuilt, _, _ = model_utils.load_into_field(
        wide, str(tmp_path / 'checkpoints'))
    assert rebuilt.config.semantic_classes == N_CLASSES
    assert rebuilt.config == field.config
