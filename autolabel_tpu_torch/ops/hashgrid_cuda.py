"""The hash-grid encode kernel (csrc/hashgrid_encode.cu) and its wrapper.

Counterpart of autolabel_tpu/ops/hashgrid_pallas.py: the exact trilinear
forward encode. On CPU tensors the wrapper computes the plain PyTorch
version (ops/encoders.hashgrid_encode); on CUDA tensors it launches the
kernel or raises. The backward (the table scatter-add) belongs to the
training slice.
"""
import ctypes

import numpy as np
import torch

from autolabel_tpu_torch.ops import _kernels, encoders

NAME = 'hashgrid_encode'
_SOURCE = 'hashgrid_encode.cu'
_MAX_LEVELS = 32  # MAX_LEVELS in the kernel source


def hashgrid_encode_plain(table, x, config):
    """The plain PyTorch version of the kernel, on any device."""
    return encoders.hashgrid_encode(table, x, config)


def _entry():
    fn = _kernels.library(_SOURCE).hashgrid_encode_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_float, ctypes.c_longlong,
                                            ctypes.c_int, ctypes.c_longlong,
                                            ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(table, x, config):
    if x.device.type != 'cuda' or table.device != x.device:
        raise ValueError(f'{NAME}: table and x must be on one CUDA device')
    if x.dtype != torch.float32 or table.dtype != torch.float32:
        raise ValueError(f'{NAME}: table and x must be float32')
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f'{NAME}: x must be (N, 3), got {tuple(x.shape)}')
    expected = (config.n_levels, config.table_size, config.n_features)
    if tuple(table.shape) != expected:
        raise ValueError(f'{NAME}: table shape {tuple(table.shape)} does not '
                         f'match the config {expected}')
    if not (x.is_contiguous() and table.is_contiguous()):
        raise ValueError(f'{NAME}: table and x must be contiguous')
    if config.n_levels > _MAX_LEVELS:
        raise ValueError(f'{NAME}: at most {_MAX_LEVELS} levels')
    if max(config.level_sizes) > config.table_size:
        raise ValueError(f'{NAME}: a level size exceeds the table')
    if table.data_ptr() % 16:
        raise ValueError(f'{NAME}: table must be 16-byte aligned')


def _launch(table, x, config):
    _check_inputs(table, x, config)
    n = x.shape[0]
    out = torch.empty((n, config.out_dim), dtype=torch.float32,
                      device=x.device)
    scales, strides, sizes, use_dense = encoders.level_geometry(config)
    scales = np.ascontiguousarray(scales, np.float32)
    strides = np.ascontiguousarray(strides, np.int32)
    sizes = np.ascontiguousarray(sizes, np.int32)
    dense = np.ascontiguousarray(use_dense, np.int32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _entry()(x.data_ptr(), table.data_ptr(), out.data_ptr(),
                      scales.ctypes.data, strides.ctypes.data,
                      sizes.ctypes.data, dense.ctypes.data,
                      float(config.pos_offset), n, config.n_levels,
                      config.table_size, config.n_features, stream)
    _kernels.check(status, NAME)
    _kernels.launches[NAME] += 1
    return out


class _Encode(torch.autograd.Function):
    """The kernel's forward; its gradient (the hash-grid scatter-add) is a
    kernel of the training slice."""

    @staticmethod
    def forward(ctx, table, x, config):
        return _launch(table, x, config)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            'the hash-grid encode backward is not ported yet')


def hashgrid_encode(table, x, config):
    """Exact trilinear encode of (N, 3) points in [0, 1] -> (N, L * F):
    the plain version on the CPU, the CUDA kernel on the card."""
    if x.device.type == 'cpu' and table.device.type == 'cpu':
        return hashgrid_encode_plain(table, x, config)
    return _Encode.apply(table, x, config)
