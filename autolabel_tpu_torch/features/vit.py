"""ViT-S/8, the DINO feature teacher's tower.

Counterpart of autolabel_tpu/features/vit_jax.py: the same parameter tree
(init_params, the DINO/timm loader and the HF ViTModel loader) and
forward (patch embedding as a matmul over channel-major patches, the CLS
token, position embeddings resized by jax.image's cubic rule, pre-LN
blocks with exact GELU, the final LayerNorm; patch tokens out).
"""
import dataclasses

import torch

from autolabel_tpu_torch.bridge import tree_from_numpy
from autolabel_tpu_torch.features.clip_text import _t, infer_depth
from autolabel_tpu_torch.features.layers import (attention, cubic_resize,
                                                 dense, gelu, layer_norm)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 8
    width: int = 384
    depth: int = 12
    heads: int = 6
    mlp_ratio: int = 4

    @property
    def head_dim(self):
        return self.width // self.heads

    @property
    def mlp_dim(self):
        return self.width * self.mlp_ratio


DINO_VITS8 = ViTConfig()


def init_params(generator, config=DINO_VITS8, pos_grid=28, device='cpu'):
    """Random tree in the loaders' layout (vit_jax.init_params' scales);
    pos_grid: the side of the position grid (28 = DINO's 224 / 8)."""
    w = config.width

    def normal(*shape):
        return torch.randn(shape, generator=generator)

    def dense_init(d_in, d_out):
        return {'w': normal(d_in, d_out) * (2.0 / (d_in + d_out)) ** 0.5,
                'b': torch.zeros(d_out)}

    def norm():
        return {'scale': torch.ones(w), 'bias': torch.zeros(w)}

    params = {
        'patch_embed': dense_init(3 * config.patch_size ** 2, w),
        'cls_token': normal(1, 1, w) * 0.02,
        'pos_embed': normal(1, pos_grid * pos_grid + 1, w) * 0.02,
        'norm': norm(),
        'blocks': [{'ln1': norm(), 'ln2': norm(),
                    'qkv': dense_init(w, 3 * w), 'proj': dense_init(w, w),
                    'fc1': dense_init(w, config.mlp_dim),
                    'fc2': dense_init(config.mlp_dim, w)}
                   for _ in range(config.depth)],
    }
    return tree_from_numpy(params, device)


# -- weight import -----------------------------------------------------------


def _patch_embed(conv, bias, config):
    w, p = config.width, config.patch_size
    return {'w': _t(conv).reshape(w, 3 * p * p).T.contiguous(),
            'b': _t(bias)}


def _linear(s, key):
    return {'w': _t(s[key + '.weight']).T.contiguous(),
            'b': _t(s[key + '.bias'])}


def _norm(s, key):
    return {'scale': _t(s[key + '.weight']), 'bias': _t(s[key + '.bias'])}


def load_timm_state_dict(state_dict, config=None):
    """DINO/timm naming: patch_embed.proj, blocks.N.attn.qkv, mlp.fc1, ...
    config=None infers the depth. Returns params on the CPU."""
    s = state_dict
    if config is None:
        config = dataclasses.replace(DINO_VITS8,
                                     depth=infer_depth(s, 'blocks.'))
    params = {
        'patch_embed': _patch_embed(s['patch_embed.proj.weight'],
                                    s['patch_embed.proj.bias'], config),
        'cls_token': _t(s['cls_token']),
        'pos_embed': _t(s['pos_embed']),
        'norm': _norm(s, 'norm'),
        'blocks': [],
    }
    for i in range(config.depth):
        pre = f'blocks.{i}.'
        params['blocks'].append({
            'ln1': _norm(s, pre + 'norm1'), 'ln2': _norm(s, pre + 'norm2'),
            'qkv': _linear(s, pre + 'attn.qkv'),
            'proj': _linear(s, pre + 'attn.proj'),
            'fc1': _linear(s, pre + 'mlp.fc1'),
            'fc2': _linear(s, pre + 'mlp.fc2')})
    return params


def load_hf_state_dict(state_dict, config=None):
    """HuggingFace ViTModel naming (embeddings.*, encoder.layer.N.*,
    layernorm). Returns params on the CPU."""
    s = state_dict
    if config is None:
        config = dataclasses.replace(DINO_VITS8,
                                     depth=infer_depth(s, 'encoder.layer.'))
    params = {
        'patch_embed': _patch_embed(
            s['embeddings.patch_embeddings.projection.weight'],
            s['embeddings.patch_embeddings.projection.bias'], config),
        'cls_token': _t(s['embeddings.cls_token']),
        'pos_embed': _t(s['embeddings.position_embeddings']),
        'norm': _norm(s, 'layernorm'),
        'blocks': [],
    }
    for i in range(config.depth):
        pre = f'encoder.layer.{i}.'
        qkv = [_linear(s, pre + f'attention.attention.{k}')
               for k in ('query', 'key', 'value')]
        params['blocks'].append({
            'ln1': _norm(s, pre + 'layernorm_before'),
            'ln2': _norm(s, pre + 'layernorm_after'),
            'qkv': {'w': torch.cat([q['w'] for q in qkv], dim=1),
                    'b': torch.cat([q['b'] for q in qkv])},
            'proj': _linear(s, pre + 'attention.output.dense'),
            'fc1': _linear(s, pre + 'intermediate.dense'),
            'fc2': _linear(s, pre + 'output.dense')})
    return params


# -- forward ------------------------------------------------------------------


def interpolate_pos_embed(pos_embed, h_patches, w_patches):
    """The (1, 1 + side^2, W) position embeddings on an h x w patch grid:
    the CLS entry kept, the grid resized as jax.image.resize(method=
    'cubic') resizes it (upsampled, or shrunk with antialiasing)."""
    n = pos_embed.shape[1] - 1
    side = int(round(n ** 0.5))
    if (h_patches, w_patches) == (side, side):
        return pos_embed
    grid = pos_embed[0, 1:].reshape(side, side, -1)
    grid = cubic_resize(grid, (h_patches, w_patches))
    return torch.cat([pos_embed[:, :1],
                      grid.reshape(1, h_patches * w_patches, -1)], dim=1)


def patch_tokens(params, images, config):
    """(B, 3, H, W) -> (B, 1 + hp * wp, width) tokens with the CLS token
    and position embeddings added, and (hp, wp)."""
    b, _, h, w = images.shape
    p = config.patch_size
    hp, wp = h // p, w // p
    x = images.reshape(b, 3, hp, p, wp, p)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(b, hp * wp, 3 * p * p)
    x = dense(x, params['patch_embed'])
    cls = params['cls_token'].expand(b, 1, config.width)
    x = torch.cat([cls, x], dim=1)
    return x + interpolate_pos_embed(params['pos_embed'], hp, wp), hp, wp


def block_forward(x, block, config, ln_eps):
    """One pre-LN block: attention and the exact-GELU MLP, each residual."""
    x = x + attention(layer_norm(x, block['ln1'], ln_eps), block,
                      config.heads)
    h = dense(layer_norm(x, block['ln2'], ln_eps), block['fc1'])
    return x + dense(gelu(h), block['fc2'])


def encode_image(params, images, config=DINO_VITS8, ln_eps=1e-6):
    """images: (B, 3, H, W) normalised, H and W multiples of the patch
    size -> (B, H/p, W/p, width) patch features after the final LayerNorm
    (DINO's get_intermediate_layers). Runs where params live."""
    b = images.shape[0]
    x, hp, wp = patch_tokens(params, images, config)
    for block in params['blocks']:
        x = block_forward(x, block, config, ln_eps)
    x = layer_norm(x, params['norm'], ln_eps)
    return x[:, 1:].reshape(b, hp, wp, config.width)


def flops(config, batch, h_patches, w_patches):
    """Multiply-adds x 2 of encode_image: the patch embedding, each
    block's four projections and its two attention products."""
    n = 1 + h_patches * w_patches
    w = config.width
    embed = 2 * (n - 1) * 3 * config.patch_size ** 2 * w
    block = 2 * n * w * (3 * w + w + 2 * config.mlp_dim) + 4 * n * n * w
    return batch * (embed + config.depth * block)

