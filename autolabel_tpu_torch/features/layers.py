"""Tensor primitives shared by the teacher towers.

The towers keep the JAX package's parameter trees as they are: dicts and
lists of tensors with the same keys, dense weights (in, out) and
convolution weights HWIO (kh, kw, cin, cout), so a tree carries across
with bridge.tree_from_numpy / tree_to_numpy. Activations are NHWC as in
the JAX towers; a convolution hands cuDNN the channels-last view of its
NHWC input (no copy) and returns the NHWC view of its output.

Every tower computes in the dtype of its params and input: fp32, or
float64 for a witness. On the card, fp32 products are full fp32:
`full_precision()` turns TF32 off for cuBLAS and cuDNN while a tower runs
and restores the caller's flags after.
"""
import contextlib

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def full_precision(allow_tf32=False):
    """fp32 matmuls and convolutions without TF32 inside the block (with
    it when allow_tf32, to time or measure what TF32 would cost)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def as_images(x, device, dtype=torch.float32):
    """A (B, 3, H, W) batch (numpy or tensor) as a tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalise(x):
    """(B, 3, H, W) in [0, 1] -> ImageNet-normalised, per channel."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean[None, :, None, None]) / std[None, :, None, None]


def layer_norm(x, p, eps):
    """LayerNorm over the last axis with p = {'scale', 'bias'}."""
    return F.layer_norm(x, x.shape[-1:], p['scale'], p['bias'], eps)


def dense(x, p):
    return x @ p['w'] + p['b']


def gelu(x):
    """jax.nn.gelu(approximate=False): the erf form."""
    return F.gelu(x, approximate='none')


def attention(x, block, heads, causal=False):
    """Multi-head self-attention of a pre-normed (B, N, W) block input:
    the fused qkv projection, softmax(q k^T / sqrt(d)) v, the output
    projection. The product runs in F.scaled_dot_product_attention."""
    b, n, w = x.shape
    qkv = dense(x, block['qkv']).reshape(b, n, 3, heads, w // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # (b, h, n, d) each
    out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    return dense(out.transpose(1, 2).reshape(b, n, w), block['proj'])


def conv_nhwc(x, w, bias=None, stride=1, padding=0, dilation=1):
    """Convolution of NHWC x with an HWIO kernel; padding an int (both
    sides) or ((top, bottom), (left, right))."""
    if not isinstance(padding, int):
        (top, bottom), (left, right) = padding
        if top == bottom and left == right:
            padding = (top, left)
        else:
            x = F.pad(x, (0, 0, left, right, top, bottom))
            padding = 0
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), bias,
                 stride, padding, dilation)
    return y.permute(0, 2, 3, 1)


def same_padding(size, kernel, stride, dilation=1):
    """XLA's 'SAME' (low, high) padding of one axis: the output has
    ceil(size / stride) rows and the odd pad goes to the high side (an
    even size at stride 2 pads (0, 1))."""
    extent = (kernel - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + extent - size, 0)
    return total // 2, total - total // 2


def resize_matrix(n_out, n_in, align_corners, dtype=torch.float32,
                  device='cpu'):
    """(n_out, n_in) bilinear interpolation matrix, torch's source
    positions clamped to the edge (lseg_jax._resize_matrix), computed in
    `dtype` as the JAX package computes it in fp32."""
    npd = np.float64 if dtype == torch.float64 else np.float32
    if align_corners and n_out > 1:
        src = np.arange(n_out).astype(npd) * npd(
            (n_in - 1) / max(n_out - 1, 1))
    else:
        src = ((np.arange(n_out).astype(npd) + npd(0.5))
               * npd(n_in / n_out) - npd(0.5))
        src = np.clip(src, 0, n_in - 1).astype(npd)
    lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
    hi = np.minimum(lo + 1, n_in - 1)
    w_hi = (src - lo).astype(npd)
    m = np.zeros((n_out, n_in), npd)
    rows = np.arange(n_out)
    np.add.at(m, (rows, lo), npd(1.0) - w_hi)
    np.add.at(m, (rows, hi), w_hi)
    return torch.as_tensor(m, device=device)


def bilinear_resize(x, size, align_corners):
    """NHWC x -> (B, size[0], size[1], C) by two resize matrices."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    mh = resize_matrix(size[0], x.shape[1], align_corners, x.dtype,
                       x.device)
    mw = resize_matrix(size[1], x.shape[2], align_corners, x.dtype,
                       x.device)
    x = torch.einsum('oh,bhwc->bowc', mh, x)
    return torch.einsum('pw,bhwc->bhpc', mw, x)


def _keys_cubic(x):
    """Keys' cubic kernel with a = -0.5, jax.image's 'cubic'."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def cubic_matrix(n_out, n_in, dtype=torch.float32, device='cpu'):
    """(n_out, n_in) weights of jax.image.resize(method='cubic') along one
    axis: Keys a = -0.5, the kernel widened by n_in / n_out when shrinking
    (antialias), each row normalised to sum 1 (jax.image.
    compute_weight_mat). torch's bicubic (a = -0.75, no antialias) is a
    different map."""
    npd = np.float64 if dtype == torch.float64 else np.float32
    inv_scale = npd(n_in / n_out)
    kernel_scale = max(inv_scale, npd(1.0))
    sample = ((np.arange(n_out).astype(npd) + npd(0.5)) * inv_scale
              - npd(0.5))
    x = (np.abs(sample[None, :] - np.arange(n_in).astype(npd)[:, None])
         / npd(kernel_scale)).astype(npd)
    weights = _keys_cubic(x).astype(npd)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    weights = np.where(inside[None, :], weights, 0).astype(npd)
    return torch.as_tensor(weights.T.copy(), device=device)


def cubic_resize(grid, size):
    """(H, W, C) grid -> (size[0], size[1], C) as jax.image.resize(...,
    method='cubic') resizes it."""
    h, w = grid.shape[:2]
    out = grid
    if size[0] != h:
        out = torch.einsum('oh,hwc->owc',
                           cubic_matrix(size[0], h, grid.dtype, grid.device),
                           out)
    if size[1] != w:
        out = torch.einsum('pw,hwc->hpc',
                           cubic_matrix(size[1], w, grid.dtype, grid.device),
                           out)
    return out


def nearest_indices(n_in, n_out):
    """jax.image.resize(method='nearest')'s source rows: floor((i + 0.5)
    n_in / n_out) in fp32 (torch's 'nearest-exact', not 'nearest')."""
    offsets = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
               * np.float32(n_in) / np.float32(n_out))
    return np.floor(offsets.astype(np.float32)).astype(np.int64)
