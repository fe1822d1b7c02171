"""Model configuration, hashing and workspace resolution.

Counterpart of autolabel_tpu/model_utils.py. The model-hash directory name
is load-bearing (evaluation and export tools glob <scene>/nerf/* and
decode the training configuration from it), so the strings are identical
to the JAX package's and both packages share workspaces.
"""
import argparse
import dataclasses
import os
import pickle

from autolabel_tpu_torch import torch_import
from autolabel_tpu_torch.models.field import Field, FieldConfig
from autolabel_tpu_torch.ops.encoders import TPU_GRID
from autolabel_tpu_torch.train import checkpoints


def model_flag_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument('--lr', type=float, default=5e-3)
    parser.add_argument('--geometric-features', '-g', type=int, default=15)
    parser.add_argument('--encoding',
                        default='hg+freq',
                        choices=['freq', 'hg', 'hg+freq'],
                        type=str,
                        help="Network positional encoding to use.")
    parser.add_argument('--features',
                        type=str,
                        default=None,
                        choices=[None, 'fcn50', 'dino', 'lseg', 'demo'],
                        help="Use semantic feature supervision.")
    parser.add_argument('--rgb-weight', default=1.0, type=float)
    parser.add_argument('--semantic-weight', default=1.0, type=float)
    parser.add_argument('--feature-weight', default=0.5, type=float)
    parser.add_argument('--depth-weight', default=0.1, type=float)
    parser.add_argument('--feature-dim', default=64, type=int)
    parser.add_argument('--grid-preset',
                        default='tpu',
                        choices=['reference', 'tpu'],
                        help="Hash-grid shape: 'tpu' = the wide-row layout "
                        "4 x 2^15 x 128 (default), 'reference' = the "
                        "reference's 16 x 2^19 x 2.")
    parser.add_argument('--proposal',
                        action='store_true',
                        help="Proposal-network sampling: a tiny density "
                        "MLP places the main field's samples.")
    parser.add_argument('--proposal-steps', type=int, default=64,
                        help="Uniform proposal samples per ray.")
    parser.add_argument('--heads-impl',
                        default='xla',
                        choices=['xla', 'pallas'],
                        help="Head-stack implementation: 'pallas' runs the "
                        "fused head and proposal kernels (CUDA in this "
                        "package). Same math, so checkpoints are "
                        "interchangeable and this is not part of the "
                        "model hash.")
    parser.add_argument('--grid-interp',
                        default='simplex',
                        choices=['trilinear', 'simplex'],
                        help="Hash-grid interpolation: 'simplex' "
                        "(tetrahedral, 4 corners; default) or 'trilinear' "
                        "(8 cell corners, reference parity).")
    return parser


def parse_sampled_backward(spec):
    """--sampled-backward's value -> RenderOptions.sampled_backward: '2' ->
    2, '4,4,2,2' -> a per-level tuple of scatter rows (coarsest level
    first), '0' -> 0 (JAX encoders.parse_sampled_backward, as
    scripts/train.py reads the flag)."""
    if isinstance(spec, (int, tuple)):
        return spec
    parts = [int(p) for p in str(spec).split(',')]
    return parts[0] if len(parts) == 1 else tuple(parts)


def effective_grid_interp(flags):
    """The interpolant a flags object actually trains with: the narrow
    reference-preset grid always interpolates trilinearly."""
    interp = getattr(flags, 'grid_interp', 'trilinear')
    if getattr(flags, 'grid_preset', 'reference') != 'tpu':
        return 'trilinear'
    return interp


def model_hash(flags):
    features = flags.features if flags.features is not None else 'plain'
    string = f"g{flags.geometric_features}_{flags.encoding}_{features}"
    string += (f"_rgb{flags.rgb_weight}_d{flags.depth_weight}"
               f"_s{flags.semantic_weight}")
    string += f"_f{flags.feature_weight}"
    if getattr(flags, 'grid_preset', 'reference') == 'tpu':
        string += "_tpugrid"
    if getattr(flags, 'proposal', False):
        string += "_prop"
    if effective_grid_interp(flags) == 'simplex':
        string += "_simplex"
    return string


def model_dir(scene_path, flags):
    mhash = model_hash(flags)
    if getattr(flags, 'workspace', None) is None:
        return os.path.join(scene_path, 'nerf', mhash)
    scene_name = os.path.basename(os.path.normpath(flags.scene))
    return os.path.join(flags.workspace, scene_name, mhash)


def compute_bound(min_bounds, max_bounds):
    """The reference's normalization-volume rule:
    bound = (extents - center).max()."""
    extents = max_bounds - min_bounds
    return float((extents - (min_bounds + max_bounds) * 0.5).max())


def model_config(min_bounds, max_bounds, n_classes, flags):
    """The FieldConfig create_model builds for a scene and flags."""
    return FieldConfig(encoding=flags.encoding,
                       num_layers=2,
                       num_layers_color=2,
                       hidden_dim=128,
                       hidden_dim_color=128,
                       geo_feat_dim=flags.geometric_features,
                       hidden_dim_semantic=flags.feature_dim,
                       semantic_classes=n_classes,
                       bound=compute_bound(min_bounds, max_bounds),
                       grid=(TPU_GRID if getattr(flags, 'grid_preset',
                                                 'reference') == 'tpu'
                             else None),
                       proposal=getattr(flags, 'proposal', False),
                       grid_interp=effective_grid_interp(flags),
                       heads_impl=getattr(flags, 'heads_impl', 'xla'))


def create_model(min_bounds, max_bounds, n_classes, flags, device=None,
                 generator=None):
    """Build the Field for a scene, its parameters drawn from `generator`
    (see Field) on `device` (the card unless device='cpu')."""
    return Field(model_config(min_bounds, max_bounds, n_classes, flags),
                 device=device, generator=generator)


def _read_payload(checkpoint_dir):
    """The checkpoint dir's payload (best.pth preferred)."""
    payload = checkpoints.load_checkpoint(checkpoint_dir)
    if payload is None:
        raise FileNotFoundError(f"No checkpoints in {checkpoint_dir}")
    return payload


def _trees(payload, config, checkpoint_dir):
    """(params, ema_params) of a payload; a reference torch checkpoint's
    imported onto the param tree of `config`."""
    if torch_import.looks_like_torch_state(payload):
        if config is None:
            raise ValueError(
                f'{checkpoint_dir} holds a reference torch checkpoint; '
                'pass the FieldConfig (or use load_into_field) to '
                'import it')
        payload = torch_import.convert_torch_payload(payload, config)
    return payload['model'], payload.get('ema', payload['model'])


def load_checkpoint(checkpoint_dir, config=None):
    """(params, ema_params) numpy trees from a checkpoint dir; prefers
    best.pth. A reference torch checkpoint is imported onto the param tree
    of `config` (torch_import.convert_torch_payload), whose field must
    have geo_relu and the source lattice: load_into_field builds it."""
    return _trees(_read_payload(checkpoint_dir), config, checkpoint_dir)


def load_into_field(field, checkpoint_dir):
    """(field, params, ema) from a checkpoint dir. For a reference torch
    checkpoint the field is rebuilt on its device with the reference's
    conventions: geo_relu, the 'xla' heads (the fused kernel does not
    relu the geometric features) and the reference's own grid under the
    source lattice, variant 'tcnn' for hg+freq and 'torch_ngp' for hg,
    whatever grid preset `field` has; its params are then the imported
    tables and weights. A checkpoint whose semantic head has another class
    count than `field` gets a field of its count."""
    payload = _read_payload(checkpoint_dir)
    if torch_import.looks_like_torch_state(payload):
        config = field.config
        grid = dataclasses.replace(config, grid=None).grid_config
        if grid is not None:
            variant = ('tcnn' if config.encoding == 'hg+freq'
                       else 'torch_ngp')
            grid = dataclasses.replace(grid, variant=variant)
        field = Field(dataclasses.replace(config, geo_relu=True,
                                          heads_impl='xla',
                                          grid_impl='xla', grid=grid),
                      device=field.device)
    params, ema = _trees(payload, field.config, checkpoint_dir)
    classes = params['semantic_out'][-1].shape[1]
    if classes != field.config.semantic_classes:
        # The checkpoint's head sets the class count, as the JAX package's
        # params carry their own shapes (its language CLIs build a
        # 606-class field whatever the workspace holds).
        field = Field(dataclasses.replace(field.config,
                                          semantic_classes=classes),
                      device=field.device)
    return field, params, ema


def read_params(workspace):
    """The flags a workspace was trained with (<workspace>/params.pkl, the
    argparse Namespace pickled, as the JAX package writes it: either
    package reads the other's)."""
    with open(os.path.join(workspace, 'params.pkl'), 'rb') as f:
        return pickle.load(f)


def write_params(workspace, flags):
    os.makedirs(workspace, exist_ok=True)
    with open(os.path.join(workspace, 'params.pkl'), 'wb') as f:
        pickle.dump(flags, f)
