"""Export field checkpoints in the reference's torch format.

Counterpart of autolabel_tpu/torch_export.py, kept as the port's own copy:
the inverse of torch_import.convert_torch_payload. It maps a Field params
tree onto an ALNetwork state dict (reference autolabel/models.py:62-265)
and writes it with torch.save, so the reference's
`model_utils.load_checkpoint` (autolabel/model_utils.py:9-18) can
torch.load + load_state_dict it, and either package imports it.

Every transform of torch_import is inverted:

  * MLP weights repack into tcnn's padded row-major flat buffers
    (pack_tcnn_mlp);
  * the sigma net's frequency-encoding rows go back to tcnn's interleaved
    [sin f, cos f] order;
  * the colour net's SH rows fold through M^-1;
  * grid tables unpack from the uniform (n_levels, table_size, F) layout
    into the source conventions ('tcnn' -> one flat
    encoder.grid_encoding.params buffer; 'torch_ngp' ->
    encoder.embeddings + encoder.offsets).

Only geo_relu=True fields export losslessly: the reference's forward
always relus the geometric features (models.py:159), so exporting a
natively trained (geo_relu=False) field raises unless force=True.

The state dict includes the tcnn modules' zero-size encoding `params` and
the NeRFRenderer `aabb_train`/`aabb_infer` buffers, as the JAX package's
export writes them.
"""
import collections
import os

import numpy as np
import torch

from autolabel_tpu_torch import torch_import


def pack_tcnn_mlp(weights, in_dim, hidden_dim, out_dim, n_hidden):
    """(in, out) fp32 matrices -> tcnn Network flat buffer (row-major
    (outputs x inputs) layer by layer, dims padded to 16 with zeros).
    Exact inverse of torch_import.unpack_tcnn_mlp."""
    shapes = [(hidden_dim, torch_import._next16(in_dim))]
    shapes += [(hidden_dim, hidden_dim)] * (n_hidden - 1)
    shapes += [(torch_import._next16(out_dim), hidden_dim)]
    if len(weights) != len(shapes):
        raise ValueError(
            f'expected {len(shapes)} weight matrices for n_hidden='
            f'{n_hidden}, got {len(weights)}')
    chunks = []
    for w, (rows, cols) in zip(weights, shapes):
        w = np.asarray(w, np.float32)
        mat = np.zeros((rows, cols), np.float32)
        mat[:w.shape[1], :w.shape[0]] = w.T
        chunks.append(mat.reshape(-1))
    return np.concatenate(chunks)


def _unapply_freq_perm(w0, perm, n):
    """Inverse of torch_import._permute_rows: theirs[perm[o]] = ours[o]."""
    out = np.asarray(w0, np.float32).copy()
    out[:n][perm[:n]] = np.asarray(w0[:n], np.float32)
    return out


def _export_sigma_net(params, config):
    weights = [np.asarray(w, np.float32) for w in params['sigma_net']]
    if config.encoding == 'hg+freq':
        weights[0] = _unapply_freq_perm(
            weights[0], torch_import._freq_row_perm(3, 2), 12)
    elif config.encoding == 'freq':
        perm = torch_import._freq_row_perm(3, 10)
        weights[0] = _unapply_freq_perm(weights[0], perm, len(perm))
    return pack_tcnn_mlp(weights, config.encoder_dim, config.hidden_dim,
                         1 + config.geo_feat_dim, config.num_layers)


def _export_color_net(params, config):
    weights = [np.asarray(w, np.float32) for w in params['color_net']]
    # Float64 unfold: exact inverse of the import fold up to the fp32
    # storage rounding of the folded rows (everything else round-trips
    # bit-identically; these 16 rows round-trip to ~cond(M) ulps).
    M = torch_import.sh_quirk_fold().astype(np.float64)
    unfolded = np.linalg.solve(
        M, weights[0][:16].astype(np.float64)).astype(np.float32)
    weights[0] = np.concatenate([unfolded, weights[0][16:]], axis=0)
    return pack_tcnn_mlp(weights, 16 + config.geo_feat_dim,
                         config.hidden_dim_color, 3,
                         config.num_layers_color)


def _export_encoder(params, config, state):
    grid_config = config.grid_config
    if grid_config is None:
        state['encoder.encoder.params'] = np.zeros(0, np.float32)
        return
    grid = np.asarray(params['encoder']['grid'], np.float32)
    sizes = grid_config.level_sizes
    flat = np.concatenate([grid[l, :size] for l, size in enumerate(sizes)])
    if config.encoding == 'hg+freq':
        if grid_config.variant != 'tcnn':
            raise ValueError(
                "a reference hg+freq checkpoint needs HashGridConfig("
                f"variant='tcnn'), this field uses {grid_config.variant!r}"
                ' — the table entries index differently and would render '
                'wrong there')
        state['encoder.encoder.params'] = np.zeros(0, np.float32)
        state['encoder.grid_encoding.params'] = flat.reshape(-1)
    else:  # 'hg'
        if grid_config.variant != 'torch_ngp':
            raise ValueError(
                "a reference hg checkpoint needs HashGridConfig("
                f"variant='torch_ngp'), this field uses "
                f'{grid_config.variant!r}')
        state['encoder.embeddings'] = flat
        state['encoder.offsets'] = np.concatenate(
            [[0], np.cumsum(sizes)]).astype(np.int32)


def convert_to_torch_state(params, config, ema=None, global_step=0,
                           epoch=0, force=False):
    """Field params pytree -> torch-ngp Trainer payload dict (numpy
    tensors) with the reference ALNetwork state-dict keys."""
    if not config.geo_relu and not force:
        raise ValueError(
            'this field was trained with geo_relu=False; the reference '
            "ALNetwork always relu's the geometric features "
            '(models.py:159), so the exported checkpoint would render '
            'differently there. Pass force=True to export anyway.')
    bound = float(config.bound)
    state = collections.OrderedDict()
    state['aabb_train'] = np.array([-bound] * 3 + [bound] * 3, np.float32)
    state['aabb_infer'] = state['aabb_train'].copy()
    _export_encoder(params, config, state)
    state['sigma_net.params'] = _export_sigma_net(params, config)
    state['encoder_dir.params'] = np.zeros(0, np.float32)
    state['color_net.params'] = _export_color_net(params, config)
    state['semantic_features.params'] = pack_tcnn_mlp(
        params['semantic_features'], config.geo_feat_dim,
        config.hidden_dim_semantic, config.hidden_dim_semantic, 2)
    state['semantic_out.params'] = pack_tcnn_mlp(
        params['semantic_out'],
        config.hidden_dim_semantic + config.geo_feat_dim, 64,
        config.semantic_classes, 1)
    if 'proposal' in params:
        # The reference has no proposal sampler; its renderer places
        # samples itself (num_steps/upsample_steps), so dropping the
        # proposal net loses nothing on their side.
        pass

    payload = {'model': state, 'epoch': int(epoch),
               'global_step': int(global_step),
               'stats': {'loss': [], 'results': [],
                         'checkpoints': [], 'best_result': None}}
    if ema is not None:
        ema_state = convert_to_torch_state(ema, config,
                                           global_step=global_step,
                                           force=True)['model']
        trainable = [k for k in state
                     if k.endswith('.params') or k.endswith('embeddings')]
        payload['ema'] = {
            'decay': 0.95, 'num_updates': int(global_step),
            'shadow_params': [ema_state[k] for k in trainable],
            'collected_params': [],
        }
    return payload


def _to_tensors(tree):
    """numpy arrays -> CPU tensors, containers rebuilt, other values kept."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree))
    if isinstance(tree, dict):
        return type(tree)((k, _to_tensors(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_tensors(v) for v in tree)
    return tree


def export_torch_checkpoint(path, params, config, ema=None, global_step=0,
                            epoch=0, force=False):
    """Write a reference-format .pth (a torch.save zip archive) the
    reference can torch.load."""
    payload = convert_to_torch_state(params, config, ema=ema,
                                     global_step=global_step, epoch=epoch,
                                     force=force)
    tmp = str(path) + '.tmp'
    torch.save(_to_tensors(payload), tmp)
    os.replace(tmp, str(path))
    return path
