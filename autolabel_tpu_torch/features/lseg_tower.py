"""LSeg's image tower: a ViT-L/16 backbone, the DPT decoder and a 512-d
CLIP-space pixel projection.

Counterpart of autolabel_tpu/features/lseg_jax.py: the same parameter tree
(the lang-seg checkpoint loader and the overlay of an HF DPTNeck), the
backbone hooked after blocks (5, 11, 17, 23) (raw block outputs, before
the final LayerNorm), the DPT neck (project readout, reassemble to
(256, 512, 1024, 1024) channels at x4, x2, x1 and x0.5 of the patch grid,
RefineNet fusion to 256 channels at half the input's size), the 1x1 head
to 512, unit norm at that half size, and an align_corners bilinear
upsample to the input's size. Resizes are the JAX package's resize
matrices (torch semantics with the clamp); the non-overlapping transposed
convs are one contraction each.
"""
import dataclasses
import os
import pickle

import numpy as np
import torch

from autolabel_tpu_torch.bridge import tree_from_numpy
from autolabel_tpu_torch.device import resolve_device
from autolabel_tpu_torch.features import vit
from autolabel_tpu_torch.features.clip_text import _t
from autolabel_tpu_torch.features.layers import (as_images, bilinear_resize,
                                                 conv_nhwc, dense,
                                                 full_precision, gelu,
                                                 nearest_indices)
from autolabel_tpu_torch.features.vit import ViTConfig


@dataclasses.dataclass(frozen=True)
class LSegConfig:
    vit: ViTConfig = ViTConfig(patch_size=16, width=1024, depth=24,
                               heads=16)
    hooks: tuple = (5, 11, 17, 23)
    neck_dims: tuple = (256, 512, 1024, 1024)
    # the reassemble's output strides against the patch grid
    factors: tuple = (4, 2, 1, 0.5)
    features: int = 256
    out_dim: int = 512


LSEG_VITL16 = LSegConfig()


def default_hooks(depth):
    """lang-seg's hooks: the last block of each quarter of the depth."""
    return tuple((i + 1) * depth // 4 - 1 for i in range(4))


def init_params(generator, config=LSEG_VITL16, pos_grid=24, device='cpu'):
    """A random tree in the loaders' layout: the ViT as vit.init_params
    draws it (pos_grid 24: lang-seg's 384 / 16), the neck and head with
    fan-in scaled normal weights. For runs at full width without weights
    from outside."""
    w, f = config.vit.width, config.features

    def normal(*shape, fan_in):
        return torch.randn(shape, generator=generator) * fan_in ** -0.5

    def dense_init(d_in, d_out):
        return {'w': normal(d_in, d_out, fan_in=d_in),
                'b': torch.zeros(d_out)}

    def conv(k, cin, cout, bias=True):
        kernel = normal(k, k, cin, cout, fan_in=k * k * cin)
        return {'w': kernel, 'b': torch.zeros(cout)} if bias else kernel

    params = vit.init_params(generator, config.vit, pos_grid)
    params.update(readout=[], project=[], resize=[], layer_rn=[],
                  fusion=[])
    for dim, factor in zip(config.neck_dims, config.factors):
        params['readout'].append(dense_init(2 * w, w))
        params['project'].append(dense_init(w, dim))
        if factor > 1:
            params['resize'].append(
                {'w': normal(dim, dim, int(factor), int(factor), fan_in=dim),
                 'b': torch.zeros(dim)})
        elif factor < 1:
            params['resize'].append(conv(3, dim, dim))
        else:
            params['resize'].append(None)
        params['layer_rn'].append(conv(3, dim, f, bias=False))
    for _ in range(4):
        params['fusion'].append({
            'res1': {'conv1': conv(3, f, f), 'conv2': conv(3, f, f)},
            'res2': {'conv1': conv(3, f, f), 'conv2': conv(3, f, f)},
            'proj': dense_init(f, f)})
    params['head1'] = dense_init(f, config.out_dim)
    return tree_from_numpy(params, device)


# -- primitives ---------------------------------------------------------------


def conv_transpose_exact(x, p, factor):
    """ConvTranspose2d with kernel == stride: each input pixel expands
    into its own factor x factor block, one contraction. p['w']: torch's
    (Cin, Cout, f, f)."""
    b, h, w, _ = x.shape
    cout = p['w'].shape[1]
    y = torch.einsum('bhwc,codf->bhdwfo', x, p['w'])
    return y.reshape(b, h * factor, w * factor, cout) + p['b']


# -- backbone -----------------------------------------------------------------


def backbone_hooks(params, images, config=LSEG_VITL16, ln_eps=1e-6):
    """images (B, 3, H, W), normalised, sides multiples of the patch ->
    (the hooked blocks' token arrays (B, 1 + hp * wp, width), hp, wp)."""
    x, hp, wp = vit.patch_tokens(params, images, config.vit)
    hooked = []
    for i, block in enumerate(params['blocks']):
        x = vit.block_forward(x, block, config.vit, ln_eps)
        if i in config.hooks:
            hooked.append(x)
    return hooked, hp, wp


# -- DPT decoder --------------------------------------------------------------


def _conv3(x, w, bias=None, stride=1):
    return conv_nhwc(x, w, bias, stride, 1)


def residual_unit(x, p):
    """Pre-activation residual conv unit (DPT ResidualConvUnit, no BN)."""
    h = _conv3(torch.relu(x), p['conv1']['w'], p['conv1']['b'])
    h = _conv3(torch.relu(h), p['conv2']['w'], p['conv2']['b'])
    return x + h


def fusion_layer(hidden, lateral, p):
    """DPT FeatureFusionBlock: add the refined lateral feature, refine,
    upsample x2 (align_corners), 1x1 project."""
    if lateral is not None:
        if lateral.shape != hidden.shape:
            lateral = bilinear_resize(lateral, hidden.shape[1:3],
                                      align_corners=False)
        hidden = hidden + residual_unit(lateral, p['res1'])
    hidden = residual_unit(hidden, p['res2'])
    hidden = bilinear_resize(
        hidden, (2 * hidden.shape[1], 2 * hidden.shape[2]),
        align_corners=True)
    return dense(hidden, p['proj'])


def neck(params, hooked, hp, wp, config=LSEG_VITL16):
    """Project-readout reassemble + RefineNet fusion -> (B, 2 hp, 2 wp,
    features)."""
    b = hooked[0].shape[0]
    feats = []
    for i, tokens in enumerate(hooked):
        cls, patches = tokens[:, :1], tokens[:, 1:]
        h = torch.cat([patches, cls.expand_as(patches)], dim=-1)
        h = gelu(dense(h, params['readout'][i])).reshape(b, hp, wp, -1)
        h = dense(h, params['project'][i])
        factor = config.factors[i]
        if factor > 1:
            h = conv_transpose_exact(h, params['resize'][i], int(factor))
        elif factor < 1:
            h = _conv3(h, params['resize'][i]['w'], params['resize'][i]['b'],
                       stride=2)
        feats.append(_conv3(h, params['layer_rn'][i]))
    fused = None
    for j, lateral in enumerate(reversed(feats)):
        fused = fusion_layer(lateral if fused is None else fused,
                             None if fused is None else lateral,
                             params['fusion'][j])
    return fused


def compute_features(params, images, config=LSEG_VITL16, ln_eps=1e-6):
    """images (B, 3, H, W), normalised -> unit-norm CLIP-space pixel
    features (B, H, W, out_dim). Sides that are not multiples of the patch
    are edge-padded before the backbone and cropped after; the features
    are normalised at the decoder's half size, then upsampled."""
    h, w = images.shape[2:]
    p = config.vit.patch_size
    pad_h, pad_w = -h % p, -w % p
    if pad_h or pad_w:
        images = torch.nn.functional.pad(images, (0, pad_w, 0, pad_h),
                                         mode='replicate')
    hooked, hp, wp = backbone_hooks(params, images, config, ln_eps)
    x = dense(neck(params, hooked, hp, wp, config), params['head1'])
    x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                        min=1e-8)
    x = bilinear_resize(x, images.shape[2:], align_corners=True)
    return x[:, :h, :w]


def flops(config, batch, height, width):
    """Multiply-adds x 2 of compute_features' backbone, neck, head and
    resizes on a batch of height x width images."""
    p = config.vit.patch_size
    hp, wp = -(-height // p), -(-width // p)
    total = vit.flops(config.vit, 1, hp, wp)
    w, f = config.vit.width, config.features
    n = hp * wp
    sizes = []
    for dim, factor in zip(config.neck_dims, config.factors):
        total += 2 * n * (2 * w * w + w * dim)
        sh, sw = (hp * factor, wp * factor) if factor >= 1 else (
            -(-hp // 2), -(-wp // 2))
        sh, sw = int(sh), int(sw)
        if factor > 1:
            total += 2 * hp * wp * dim * dim * factor * factor
        elif factor < 1:
            total += 2 * sh * sw * 9 * dim * dim
        total += 2 * sh * sw * 9 * dim * f
        sizes.append((sh, sw))
    hh, ww = sizes[-1]
    for j, (sh, sw) in enumerate(reversed(sizes)):
        if j:
            total += 2 * hh * ww * 2 * 9 * f * f  # res1 on the lateral
        total += 2 * hh * ww * 2 * 9 * f * f  # res2
        hh, ww = 2 * hh, 2 * ww
        total += 2 * hh * ww * f * f  # the 1x1 projection
    total += 2 * hh * ww * f * config.out_dim
    return batch * total


# -- weight import ------------------------------------------------------------


def _hwio(conv):
    return _t(conv).permute(2, 3, 1, 0).contiguous()


def _dense_p(w, b):
    return {'w': _t(w).T.contiguous(), 'b': _t(b)}


def _conv1x1_p(w, b):
    return {'w': _t(w)[:, :, 0, 0].T.contiguous(), 'b': _t(b)}


def _infer_config(state, vit_pre):
    depth = 0
    while any(k.startswith(f'{vit_pre}blocks.{depth}.') for k in state):
        depth += 1
    width, _, patch, _ = np.shape(state[f'{vit_pre}patch_embed.proj.weight'])
    neck_dims = tuple(int(np.shape(state[f'act_postprocess{k}.3.weight'])[0])
                      for k in range(1, 5))
    return LSegConfig(
        vit=ViTConfig(patch_size=int(patch), width=int(width), depth=depth,
                      heads=max(int(width) // 64, 1)),
        hooks=default_hooks(depth), neck_dims=neck_dims,
        features=int(np.shape(state['scratch.layer1_rn.weight'])[0]),
        out_dim=int(np.shape(state['scratch.head1.weight'])[0]))


def _resize_p(w, b, factor):
    if factor > 1:
        return {'w': _t(w), 'b': _t(b)}  # (Cin, Cout, f, f)
    if factor < 1:
        return {'w': _hwio(w), 'b': _t(b)}
    return None


def _residual_p(s, pre):
    return {f'conv{j}': {'w': _hwio(s[f'{pre}.conv{j}.weight']),
                         'b': _t(s[f'{pre}.conv{j}.bias'])} for j in (1, 2)}


def load_lseg_state_dict(state_dict, config=None):
    """lang-seg naming (the LSegModule lightning checkpoint or its net.*
    state dict): pretrained.model.* the timm ViT, pretrained.
    act_postprocessK.* the reassemble (0.project.0 the readout, 3 the 1x1
    projection, 4 the resize), scratch.layerK_rn / refinenetK / head1 the
    decoder. config=None infers all but the hooks (lang-seg's schedule)
    from the shapes. Returns (params on the CPU, config)."""
    state = dict(state_dict)
    if 'state_dict' in state and not any('.' in k for k in state):
        state = dict(state['state_dict'])
    for pre in ('module.', 'net.', 'pretrained.'):
        if any(k.startswith(pre) for k in state):
            state = {k[len(pre):] if k.startswith(pre) else k: v
                     for k, v in state.items()}
    vit_pre = 'model.' if any(k.startswith('model.') for k in state) else ''
    if config is None:
        config = _infer_config(state, vit_pre)
    vit_keys = ('patch_embed', 'cls_token', 'pos_embed', 'blocks', 'norm')
    vit_state = {k[len(vit_pre):]: v for k, v in state.items()
                 if k.startswith(vit_pre)
                 and k[len(vit_pre):].split('.')[0] in vit_keys}
    params = vit.load_timm_state_dict(vit_state, config.vit)
    params.update(readout=[], project=[], resize=[], layer_rn=[],
                  fusion=[])
    for k in range(1, 5):
        pre = f'act_postprocess{k}.'
        params['readout'].append(_dense_p(state[pre + '0.project.0.weight'],
                                          state[pre + '0.project.0.bias']))
        params['project'].append(_conv1x1_p(state[pre + '3.weight'],
                                            state[pre + '3.bias']))
        params['resize'].append(_resize_p(state.get(pre + '4.weight'),
                                          state.get(pre + '4.bias'),
                                          config.factors[k - 1]))
        params['layer_rn'].append(_hwio(state[f'scratch.layer{k}_rn.weight']))
    # refinenet4 (the deepest) is applied first
    for k in (4, 3, 2, 1):
        pre = f'scratch.refinenet{k}.'
        params['fusion'].append({
            'res1': _residual_p(state, pre + 'resConfUnit1'),
            'res2': _residual_p(state, pre + 'resConfUnit2'),
            'proj': _conv1x1_p(state[pre + 'out_conv.weight'],
                               state[pre + 'out_conv.bias'])})
    params['head1'] = _conv1x1_p(state['scratch.head1.weight'],
                                 state['scratch.head1.bias'])
    return params, config


def load_hf_dpt_neck_state_dict(state_dict, params, config):
    """An HF DPTNeck state dict laid over a params tree (the backbone kept);
    HF's fusion layer N takes the N-th deepest feature, as here."""
    s = state_dict
    params = dict(params, readout=[], project=[], resize=[], layer_rn=[],
                  fusion=[])
    for i in range(4):
        pre = f'reassemble_stage.layers.{i}.'
        params['readout'].append(
            _dense_p(s[f'reassemble_stage.readout_projects.{i}.0.weight'],
                     s[f'reassemble_stage.readout_projects.{i}.0.bias']))
        params['project'].append(_conv1x1_p(s[pre + 'projection.weight'],
                                            s[pre + 'projection.bias']))
        params['resize'].append(_resize_p(s.get(pre + 'resize.weight'),
                                          s.get(pre + 'resize.bias'),
                                          config.factors[i]))
        params['layer_rn'].append(_hwio(s[f'convs.{i}.weight']))
    for i in range(4):
        pre = f'fusion_stage.layers.{i}.'

        def unit(name):
            return {f'conv{j}': {
                'w': _hwio(s[f'{pre}{name}.convolution{j}.weight']),
                'b': _t(s[f'{pre}{name}.convolution{j}.bias'])}
                for j in (1, 2)}

        params['fusion'].append({
            'res1': unit('residual_layer1'), 'res2': unit('residual_layer2'),
            'proj': _conv1x1_p(s[pre + 'projection.weight'],
                               s[pre + 'projection.bias'])})
    return params


# -- extractor ----------------------------------------------------------------


def half_size(x):
    """(B, 3, H, W) -> (B, 3, H // 2, W // 2): every other pixel on even
    sides, else jax.image's nearest rule."""
    h, w = x.shape[2] // 2, x.shape[3] // 2
    if x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
        return x[:, :, ::2, ::2]
    rows = torch.as_tensor(nearest_indices(x.shape[2], h), device=x.device)
    cols = torch.as_tensor(nearest_indices(x.shape[3], w), device=x.device)
    return x[:, :, rows][:, :, :, cols]


class LSegImageEncoder:
    """(B, 3, H, W) in [0, 1] -> (B, H//2, W//2, out_dim) unit-norm
    CLIP-space features, an fp32 tensor on the device: the image scaled
    to [-1, 1], taken at half size, through compute_features. device:
    None (the card; raises without one) or a torch device."""

    def __init__(self, params, config=LSEG_VITL16, device=None):
        self.device = resolve_device(device)
        self.params = tree_from_numpy(params, self.device)
        self.config = config
        self.out_dim = config.out_dim

    def shape(self, input_shape):
        return (input_shape[0] // 2, input_shape[1] // 2)

    def __call__(self, x):
        x = half_size(as_images(x, self.device) * 2.0 - 1.0)
        with torch.no_grad(), full_precision():
            return compute_features(self.params, x, self.config)


def read_lseg_state(path):
    """A lang-seg checkpoint on disk (a lightning .ckpt or state dict, or
    an .npz) as a flat state dict."""
    if path.endswith('.npz'):
        with np.load(path) as archive:
            return dict(archive)
    try:
        payload = torch.load(path, map_location='cpu', weights_only=True)
    except pickle.UnpicklingError:
        # lightning checkpoints pickle their hyper-parameters
        payload = torch.load(path, map_location='cpu', weights_only=False)
    return (payload.get('state_dict', payload)
            if isinstance(payload, dict) else payload)


def load(path, device=None):
    """LSegImageEncoder from a lang-seg checkpoint file."""
    params, config = load_lseg_state_dict(read_lseg_state(path))
    return LSegImageEncoder(params, config, device)


def from_env(device=None):
    """LSegImageEncoder from AUTOLABEL_LSEG_WEIGHTS, else None."""
    path = os.environ.get('AUTOLABEL_LSEG_WEIGHTS')
    if not path or not os.path.exists(path):
        return None
    return load(path, device)
