"""FCN-ResNet50, the dense-feature teacher's tower.

Counterpart of autolabel_tpu/features/fcn_jax.py: the same parameter tree
(eval-mode batch norms folded into their convolutions at load time, HWIO
kernels with biases), both loaders (torchvision's fcn_resnet50 naming and
HF's ResNetModel naming), and the forward: ResNet-50 v1.5 with the
segmentation dilations (stages 3 and 4 at stride 1 and dilations 2 and 4,
output stride 8; a stage's first block keeps the previous dilation on its
3x3), then the FCN head's 3x3 conv and ReLU, torchvision's 'classifier.2'
node.
"""
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from autolabel_tpu_torch.bridge import tree_from_numpy
from autolabel_tpu_torch.device import resolve_device
from autolabel_tpu_torch.features.layers import (as_images, conv_nhwc,
                                                 full_precision, normalise)

RESNET50_DEPTHS = (3, 4, 6, 3)
SEG_STRIDES = (1, 2, 1, 1)
SEG_DILATIONS = (1, 1, 2, 4)
CLS_STRIDES = (1, 2, 2, 2)
CLS_DILATIONS = (1, 1, 1, 1)
_BN_EPS = 1e-5


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def fold_bn(conv_w, gamma, beta, mean, var, eps=_BN_EPS):
    """An eval-mode BatchNorm folded into the bias-free conv before it.
    conv_w: torch layout (cout, cin, kh, kw). Returns {'w' HWIO, 'b'} as
    fp32 numpy, computed as fcn_jax._fold_bn computes them."""
    conv_w = _np(conv_w)
    scale = _np(gamma) / np.sqrt(_np(var) + eps)
    w = conv_w * scale[:, None, None, None]
    b = _np(beta) - _np(mean) * scale
    return {'w': np.ascontiguousarray(w.transpose(2, 3, 1, 0)), 'b': b}


def _conv_bn(state, conv_key, bn_key):
    return fold_bn(state[f'{conv_key}.weight'], state[f'{bn_key}.weight'],
                   state[f'{bn_key}.bias'], state[f'{bn_key}.running_mean'],
                   state[f'{bn_key}.running_var'])


def load_torchvision_state_dict(state_dict, depths=None):
    """fcn_resnet50 naming: backbone.conv1/bn1, backbone.layerL.B.convN /
    bnN (+ .downsample.0/.1), classifier.0/.1 (the aux and final
    classifier convs are ignored). depths=None infers the blocks a stage.
    Returns a tree of numpy arrays."""
    state = dict(state_dict)
    if depths is None:
        depths = []
        for stage in range(4):
            depth = 0
            while (f'backbone.layer{stage + 1}.{depth}.conv1.weight'
                   in state):
                depth += 1
            depths.append(depth)
    params = {'stem': _conv_bn(state, 'backbone.conv1', 'backbone.bn1'),
              'stages': []}
    for stage, depth in enumerate(depths):
        blocks = []
        for i in range(depth):
            pre = f'backbone.layer{stage + 1}.{i}.'
            block = {f'conv{j}': _conv_bn(state, pre + f'conv{j}',
                                          pre + f'bn{j}') for j in (1, 2, 3)}
            if pre + 'downsample.0.weight' in state:
                block['shortcut'] = _conv_bn(state, pre + 'downsample.0',
                                             pre + 'downsample.1')
            blocks.append(block)
        params['stages'].append(blocks)
    if 'classifier.0.weight' in state:
        params['head'] = _conv_bn(state, 'classifier.0', 'classifier.1')
    return params


def load_hf_resnet_state_dict(state_dict, depths):
    """transformers ResNetModel naming; the backbone only, no FCN head.
    Returns a tree of numpy arrays."""
    state = dict(state_dict)
    params = {'stem': _conv_bn(state, 'embedder.embedder.convolution',
                               'embedder.embedder.normalization'),
              'stages': []}
    for stage, depth in enumerate(depths):
        blocks = []
        for i in range(depth):
            pre = f'encoder.stages.{stage}.layers.{i}.'
            block = {name: _conv_bn(state, pre + f'layer.{j}.convolution',
                                    pre + f'layer.{j}.normalization')
                     for j, name in enumerate(('conv1', 'conv2', 'conv3'))}
            if pre + 'shortcut.convolution.weight' in state:
                block['shortcut'] = _conv_bn(
                    state, pre + 'shortcut.convolution',
                    pre + 'shortcut.normalization')
            blocks.append(block)
        params['stages'].append(blocks)
    return params


def init_params(generator, depths=RESNET50_DEPTHS, width=64, head=512,
                device='cpu'):
    """A random folded tree of ResNet-50's shapes (stage widths 4 x 64,
    128, 256, 512 at `width` 64) with the FCN head: He-normal kernels,
    each block's last 1x1 scaled by 0.2 so the residual sums stay near
    unit scale, small random biases. For runs at full width without
    weights from outside."""
    def conv(k, cin, cout, gain=1.0):
        w = torch.randn((k, k, cin, cout), generator=generator)
        return {'w': w * gain * (2.0 / (k * k * cin)) ** 0.5,
                'b': torch.randn(cout, generator=generator) * 0.01}

    params = {'stem': conv(7, 3, width), 'stages': []}
    cin = width
    for stage, depth in enumerate(depths):
        mid = width * 2 ** stage
        cout = 4 * mid
        blocks = []
        for i in range(depth):
            block = {'conv1': conv(1, cin if i == 0 else cout, mid),
                     'conv2': conv(3, mid, mid),
                     'conv3': conv(1, mid, cout, 0.2)}
            if i == 0:
                block['shortcut'] = conv(1, cin, cout)
            blocks.append(block)
        params['stages'].append(blocks)
        cin = cout
    params['head'] = conv(3, cin, head)
    return tree_from_numpy(params, device)


# -- forward ------------------------------------------------------------------


def conv(x, p, stride=1, dilation=1):
    """NHWC conv padded k // 2 * dilation on each side, plus its bias."""
    k = p['w'].shape[0]
    return conv_nhwc(x, p['w'], p['b'], stride, (k - 1) // 2 * dilation,
                     dilation)


def bottleneck(x, block, stride, dilation):
    """1x1 -> 3x3 (stride, dilation) -> 1x1, with the projection
    shortcut when the block has one."""
    h = torch.relu(conv(x, block['conv1']))
    h = torch.relu(conv(h, block['conv2'], stride=stride,
                        dilation=dilation))
    h = conv(h, block['conv3'])
    if 'shortcut' in block:
        x = conv(x, block['shortcut'], stride=stride)
    return torch.relu(h + x)


def max_pool_3x3_s2(x):
    """3x3 max pool at stride 2, padded 1 with -inf, of NHWC x."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1)
    return y.permute(0, 2, 3, 1)


def backbone_forward(params, x, strides=SEG_STRIDES,
                     dilations=SEG_DILATIONS):
    """x: (B, H, W, 3) normalised NHWC -> the last stage's features. A
    stage's first block keeps the previous stage's dilation on its 3x3
    (torchvision's replace_stride_with_dilation)."""
    h = torch.relu(conv(x, params['stem'], stride=2))
    h = max_pool_3x3_s2(h)
    prev_dilation = 1
    for blocks, stride, dilation in zip(params['stages'], strides,
                                        dilations):
        for i, block in enumerate(blocks):
            h = bottleneck(h, block, stride if i == 0 else 1,
                           prev_dilation if i == 0 else dilation)
        prev_dilation = dilation
    return h


def fcn_features(params, images):
    """images: (B, 3, H, W) in [0, 1], normalised here -> (B, H/8, W/8,
    head channels): the head conv + ReLU, in the params' dtype."""
    x = normalise(images.to(params['stem']['w'].dtype)).permute(0, 2, 3, 1)
    return torch.relu(conv(backbone_forward(params, x), params['head']))


def flops(params, batch, height, width, strides=SEG_STRIDES,
          dilations=SEG_DILATIONS):
    """Multiply-adds x 2 of fcn_features' convolutions on a batch of
    height x width images (the pool, the ReLUs and sums left out)."""
    total = 0

    def add(p, h, w, stride):
        nonlocal total
        k, _, cin, cout = p['w'].shape
        h, w = -(-h // stride), -(-w // stride)
        total += 2 * h * w * k * k * cin * cout
        return h, w

    h, w = add(params['stem'], height, width, 2)
    h, w = -(-h // 2), -(-w // 2)
    for blocks, stride in zip(params['stages'], strides):
        for i, block in enumerate(blocks):
            s = stride if i == 0 else 1
            add(block['conv1'], h, w, 1)
            h2, w2 = add(block['conv2'], h, w, s)
            add(block['conv3'], h2, w2, 1)
            if 'shortcut' in block:
                add(block['shortcut'], h, w, s)
            h, w = h2, w2
    add(params['head'], h, w, 1)
    return batch * total


@dataclasses.dataclass
class FCN:
    """The FCN50 extractor's contract on a params tree: (B, 3, H, W) in
    [0, 1] -> (B, H/8, W/8, 512) fp16 on the device (fcn_jax.FCNJax).
    device: None (the card; raises without one) or a torch device."""
    params: dict
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.params = tree_from_numpy(self.params, self.device)

    def __call__(self, x):
        with torch.no_grad(), full_precision():
            return fcn_features(self.params, as_images(
                x, self.device)).to(torch.float16)
