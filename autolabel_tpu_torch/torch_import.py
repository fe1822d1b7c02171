"""Import reference-trained torch checkpoints onto the field's param tree.

Counterpart of autolabel_tpu/torch_import.py, kept as the port's own copy
(numpy in, numpy out, bit-equal to the JAX package's). The reference
saves ALNetwork state (autolabel/models.py:62-265) through torch-ngp's
Trainer as torch.save archives; train/checkpoints.py reads them with
torch.load(weights_only=True) and `convert_torch_payload` maps the state
dict onto a Field params tree.

What transfers and how:

  * tcnn MLPs (`sigma_net.params`, `color_net.params`,
    `semantic_features.params`, `semantic_out.params`) transfer EXACTLY:
    each is one flat buffer of row-major (outputs x inputs) matrices,
    layer by layer, with input and output widths padded to multiples of
    16; the padding is stripped.
  * The frequency encoding's columns: tcnn interleaves [sin f0, cos f0,
    sin f1, ...] per input dim, the field groups [sin f0..fN, cos
    f0..fN]; the first weight matrix's rows are permuted (exact).
  * The reference feeds raw [-1, 1] view directions to tcnn's
    SphericalHarmonics, which remaps them to 2d-1 (models.py:161), so its
    colour net is trained against SH(2d-1) = SH(d) M for a fixed 16x16 M
    on the unit sphere; M is folded into the colour net's SH rows.
  * The reference relus the geometric features before the colour and
    semantic heads (models.py:159): imported fields set
    FieldConfig(geo_relu=True).
  * Hash grids transfer entry for entry under the source lattice
    (HashGridConfig variant 'tcnn' for hg+freq, 'torch_ngp' for hg): each
    level's table slots into the uniform (n_levels, 2^19, F) table
    unchanged. model_utils.load_into_field builds the matching field.
"""
import warnings

import numpy as np
import torch

from autolabel_tpu_torch.ops.encoders import sh_encode


def _next16(n):
    return (n + 15) // 16 * 16


def unpack_tcnn_mlp(flat, in_dim, hidden_dim, out_dim, n_hidden):
    """tcnn Network flat param buffer -> list of (in, out) fp32 matrices
    (our mlp_apply orientation), padding stripped."""
    flat = np.asarray(flat, np.float32).reshape(-1)
    shapes = [(hidden_dim, _next16(in_dim))]
    shapes += [(hidden_dim, hidden_dim)] * (n_hidden - 1)
    shapes += [(_next16(out_dim), hidden_dim)]
    real = [(hidden_dim, in_dim)] + [(hidden_dim, hidden_dim)] * (
        n_hidden - 1) + [(out_dim, hidden_dim)]
    total = sum(r * c for r, c in shapes)
    if flat.size != total:
        raise ValueError(
            f'tcnn buffer has {flat.size} params, expected {total} for '
            f'{in_dim}->{hidden_dim}x{n_hidden}->{out_dim} '
            '(padded to 16); wrong layout assumption or config')
    weights = []
    offset = 0
    for (rows, cols), (r_real, c_real) in zip(shapes, real):
        mat = flat[offset:offset + rows * cols].reshape(rows, cols)
        weights.append(np.ascontiguousarray(mat[:r_real, :c_real].T))
        offset += rows * cols
    return weights


def _freq_row_perm(n_dims, n_freqs):
    """Row permutation taking tcnn's interleaved [sin f, cos f] columns
    to our grouped [sins..., cosines...] order: perm[ours] = theirs."""
    perm = np.empty(n_dims * 2 * n_freqs, np.int64)
    for i in range(n_dims):
        for f in range(n_freqs):
            perm[i * 2 * n_freqs + f] = i * 2 * n_freqs + 2 * f
            perm[i * 2 * n_freqs + n_freqs + f] = i * 2 * n_freqs + 2 * f + 1
    return perm


def _sh_basis(d):
    """The 16 SH values of fp32 directions (ops/encoders.sh_encode on the
    CPU; bit-equal to the JAX package's on the same input)."""
    return sh_encode(torch.from_numpy(d)).numpy()


def sh_quirk_fold():
    """16x16 matrix M with SH(2d-1) == SH(d) @ M on the unit sphere."""
    rng = np.random.default_rng(7)
    d = rng.normal(size=(512, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    A = _sh_basis(d.astype(np.float32))
    B = _sh_basis((2.0 * d - 1.0).astype(np.float32))
    M, residuals, _, _ = np.linalg.lstsq(A, B, rcond=None)
    err = np.abs(A @ M - B).max()
    if err > 1e-3:
        raise AssertionError(
            f'SH quirk fold residual {err} — the degree-3 identity '
            'should be exact on the sphere')
    return M


# -- grid table packing --------------------------------------------------------


def pack_grid_table(embeddings, offsets, config):
    """Slot per-level source tables into our uniform (n_levels,
    table_size, F) layout; the config's variant reproduces the source's
    indexing so entries are reused verbatim."""
    if config.variant == 'native':
        raise ValueError(
            "imported grids need a source-convention HashGridConfig "
            "(variant='tcnn' or 'torch_ngp'), not 'native'")
    sizes = config.level_sizes
    expected = np.concatenate([[0], np.cumsum(sizes)])
    if not np.array_equal(np.asarray(offsets, np.int64), expected):
        raise ValueError(
            f'checkpoint grid offsets {list(offsets)} do not match the '
            f'{config.variant} level sizes {list(expected)}; layout '
            'assumption violated — refusing a silently-wrong import')
    out = np.zeros((config.n_levels, config.table_size, config.n_features),
                   np.float32)
    for l, size in enumerate(sizes):
        out[l, :size] = embeddings[offsets[l]:offsets[l] + size]
    return out


# -- full-model mapping --------------------------------------------------------


def convert_torch_payload(payload, config):
    """Loaded torch checkpoint dict (torch-ngp Trainer layout: 'model' =
    ALNetwork state dict, optional 'ema') -> {'model': params pytree,
    'ema': params pytree} matching Field(config).init's structure."""
    state = payload['model']
    params = {
        'sigma_net': _import_mlp(state, 'sigma_net', config.encoder_dim,
                                 config.hidden_dim,
                                 1 + config.geo_feat_dim, config.num_layers),
        'color_net': _import_color_net(state, config),
        'semantic_features': _import_mlp(
            state, 'semantic_features', config.geo_feat_dim,
            config.hidden_dim_semantic, config.hidden_dim_semantic, 2),
        'semantic_out': _import_mlp(
            state, 'semantic_out',
            config.hidden_dim_semantic + config.geo_feat_dim, 64,
            config.semantic_classes, 1),
    }
    _apply_freq_perm(params['sigma_net'], config)
    params['encoder'] = _import_encoder(state, config)

    ema = params
    shadow = payload.get('ema', {}).get('shadow_params') \
        if isinstance(payload.get('ema'), dict) else None
    if shadow is not None:
        ema_payload = dict(payload, model=_shadow_state(state, shadow))
        if ema_payload['model'] is not None:
            ema = convert_torch_payload(
                {'model': ema_payload['model']}, config)['model']
    return {'model': params, 'ema': ema,
            'global_step': int(payload.get('global_step', 0))}


def _import_mlp(state, name, in_dim, hidden, out_dim, n_hidden):
    return unpack_tcnn_mlp(state[f'{name}.params'], in_dim, hidden,
                           out_dim, n_hidden)


def _import_color_net(state, config):
    weights = _import_mlp(state, 'color_net', 16 + config.geo_feat_dim,
                          config.hidden_dim_color, 3,
                          config.num_layers_color)
    # Fold the tcnn-SH direction quirk into the SH rows (see module
    # docstring): reference color nets see SH(2d-1), ours feed SH(d).
    M = sh_quirk_fold().astype(np.float64)
    folded = (M @ weights[0][:16].astype(np.float64)).astype(np.float32)
    weights[0] = np.concatenate([folded, weights[0][16:]], axis=0)
    return weights


def _apply_freq_perm(sigma_weights, config):
    if config.encoding == 'hg+freq':
        sigma_weights[0] = _permute_rows(sigma_weights[0],
                                         _freq_row_perm(3, 2), 12)
    elif config.encoding == 'freq':
        perm = _freq_row_perm(3, 10)
        sigma_weights[0] = _permute_rows(sigma_weights[0], perm,
                                         len(perm))


def _permute_rows(w0, perm, n):
    """Our row o reads the feature tcnn stored at row perm[o]."""
    out = w0.copy()
    out[:n] = w0[:n][perm[:n]]
    return out


def _import_encoder(state, config):
    grid_config = config.grid_config
    if grid_config is None:
        return {}
    if 'encoder.grid_encoding.params' in state:  # hg+freq: tcnn grid
        if grid_config.variant != 'tcnn':
            raise ValueError(
                "tcnn grid checkpoint needs HashGridConfig(variant="
                f"'tcnn'), got {grid_config.variant!r} — use "
                "model_utils.load_into_field")
        flat = np.asarray(state['encoder.grid_encoding.params'],
                          np.float32)
        offsets = np.concatenate([[0],
                                  np.cumsum(grid_config.level_sizes)])
        if flat.size != offsets[-1] * grid_config.n_features:
            raise ValueError(
                f'tcnn grid buffer has {flat.size} params, expected '
                f'{offsets[-1] * grid_config.n_features}')
        embeddings = flat.reshape(-1, grid_config.n_features)
    elif 'encoder.embeddings' in state:  # hg: torch-ngp GridEncoder
        if grid_config.variant != 'torch_ngp':
            raise ValueError(
                "torch-ngp grid checkpoint needs HashGridConfig(variant="
                f"'torch_ngp'), got {grid_config.variant!r} — use "
                "model_utils.load_into_field")
        embeddings = np.asarray(state['encoder.embeddings'], np.float32)
        offsets = np.asarray(state['encoder.offsets'], np.int64)
    else:
        raise ValueError(
            'no grid parameters in checkpoint (expected '
            'encoder.grid_encoding.params or encoder.embeddings) for '
            f'encoding={config.encoding}')
    return {'grid': pack_grid_table(embeddings, offsets, grid_config)}


def _shadow_state(state, shadow_params):
    """torch-ngp's EMA stores shadow tensors in model.parameters() order;
    rebuild a state dict by matching shapes against the trainable keys.
    Returns None (caller falls back to live params) on any mismatch."""
    trainable = [k for k in state
                 if k.endswith('.params') or k.endswith('embeddings')]
    if len(trainable) != len(shadow_params):
        warnings.warn('EMA shadow_params count mismatch; using live '
                      'params as EMA')
        return None
    out = dict(state)
    for key, shadow in zip(trainable, shadow_params):
        if np.shape(state[key]) != np.shape(shadow):
            warnings.warn(f'EMA shadow shape mismatch at {key}; using '
                          'live params as EMA')
            return None
        out[key] = shadow
    return out


def looks_like_torch_state(payload):
    """True when a checkpoint payload holds a torch-ngp/ALNetwork state
    dict (flat dotted keys) instead of our params pytree."""
    model = payload.get('model')
    return (isinstance(model, dict)
            and any(k.endswith('.params') or k == 'encoder.embeddings'
                    for k in model))
