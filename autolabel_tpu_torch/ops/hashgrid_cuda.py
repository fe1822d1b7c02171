"""The hash-grid encode kernels (csrc/hashgrid_encode.cu, forward;
csrc/hashgrid_bwd.cu, the table gradient) and their wrappers.

Counterpart of autolabel_tpu/ops/hashgrid_pallas.py: the exact trilinear
encode (`hashgrid_encode_pallas`) and its VJP (`hashgrid_encode_hybrid`,
whose table gradient the JAX package leaves to XLA's scatter-add). On CPU
tensors the wrapper computes the plain PyTorch version
(ops/encoders.hashgrid_encode, differentiated by autograd); on CUDA
tensors the forward launches the encode kernel and autograd's backward
launches the scatter kernel, or they raise. The gradient for x, which only
pose refinement needs, is not ported: asking for it on the card raises.
"""
import ctypes

import numpy as np
import torch

from autolabel_tpu_torch.ops import _kernels, encoders

NAME = 'hashgrid_encode'
BWD_NAME = 'hashgrid_encode_bwd'
_SOURCE = 'hashgrid_encode.cu'
_BWD_SOURCE = 'hashgrid_bwd.cu'
_MAX_LEVELS = 32  # MAX_LEVELS in hashgrid_common.cuh


def hashgrid_encode_plain(table, x, config):
    """The plain PyTorch version of the encode kernel, on any device."""
    return encoders.hashgrid_encode(table, x, config)


def hashgrid_encode_backward_plain(g, x, config):
    """The plain PyTorch version of the scatter kernel, on any device."""
    return encoders.hashgrid_encode_backward_plain(g, x, config)


def backward_tolerance(g, x, config):
    """Per element of the table gradient, how far two fp32 sums of its
    terms g * w in different orders (the scatter kernel's atomics and
    in-tile groups against index_add_'s) can lie apart: 2 k 2^-24 times
    the sum of the terms' magnitudes, k the terms of the element's row
    (each order's error is at most (k - 1) 2^-24 of that sum)."""
    cell, _, stride, use_dense, size = encoders._grid_geometry(x, config)
    terms = torch.zeros((config.n_levels, config.table_size),
                        dtype=torch.float32, device=x.device)
    ones = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    for l in range(config.n_levels):
        for corner in encoders._CORNERS:
            terms[l].index_add_(0, encoders._corner_index(
                cell[:, l], corner, stride[l], use_dense[l], size[l]), ones)
    magnitude = hashgrid_encode_backward_plain(g.abs(), x, config)
    return 2.0 * terms[..., None] * 2.0 ** -24 * magnitude


def _entry(source, symbol):
    """A C entry point taking x, src, dst and the six per-level arrays."""
    fn = getattr(_kernels.library(source), symbol)
    fn.argtypes = ([ctypes.c_void_p] * 9
                   + [ctypes.c_float, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(name, x, config, rows, rows_shape):
    """x (N, 3) and `rows` (the table, or the encode's cotangent, read or
    written by float4) of `rows_shape`: float32, contiguous, on one CUDA
    device."""
    if x.device.type != 'cuda' or rows.device != x.device:
        raise ValueError(f'{name}: inputs must be on one CUDA device')
    if x.dtype != torch.float32 or rows.dtype != torch.float32:
        raise ValueError(f'{name}: inputs must be float32')
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f'{name}: x must be (N, 3), got {tuple(x.shape)}')
    if tuple(rows.shape) != rows_shape:
        raise ValueError(f'{name}: shape {tuple(rows.shape)} does not match '
                         f'{rows_shape}')
    if not (x.is_contiguous() and rows.is_contiguous()):
        raise ValueError(f'{name}: inputs must be contiguous')
    if config.n_levels > _MAX_LEVELS:
        raise ValueError(f'{name}: at most {_MAX_LEVELS} levels')
    if max(config.level_sizes) > config.table_size:
        raise ValueError(f'{name}: a level size exceeds the table')
    if rows.data_ptr() % 16:
        raise ValueError(f'{name}: inputs must be 16-byte aligned')


def _table_shape(config):
    return (config.n_levels, config.table_size, config.n_features)


def level_divisors(sizes):
    """Per level size d, the constants (magic, shift) with which the
    kernels take h % d without a division (hashgrid_common.cuh
    level_mod): magic 0 where d is a power of two (h & (d - 1)), else
    Granlund and Montgomery's multiplier for shift = ceil(log2 d),
    magic = floor(2^32 (2^shift - d) / d) + 1, with which
    q = (t + ((h - t) >> 1)) >> (shift - 1), t = (h * magic) >> 32, is
    h // d for every uint32 h."""
    magic, shift = [], []
    for d in (int(v) for v in sizes):
        if d < 1 or d >= 1 << 31:
            raise ValueError(f'level size {d} is outside the kernel')
        s = (d - 1).bit_length()  # ceil(log2 d)
        magic.append(0 if d & (d - 1) == 0 else
                     ((1 << 32) * ((1 << s) - d)) // d + 1)
        shift.append(s)
    return np.asarray(magic, np.uint32), np.asarray(shift, np.int32)


def _geometry(config):
    """The per-level arrays the kernels take (kept alive by the caller
    until the launch returns: the launcher copies them): scales, dense
    strides, sizes, use_dense and the sizes' divisor constants."""
    scales, strides, sizes, use_dense = encoders.level_geometry(config)
    magic, shift = level_divisors(sizes)
    return (np.ascontiguousarray(scales, np.float32),
            np.ascontiguousarray(strides, np.int32),
            np.ascontiguousarray(sizes, np.int32),
            np.ascontiguousarray(use_dense, np.int32), magic, shift)


def _call(source, symbol, name, x, src, dst, config):
    """Launch symbol of source on x, src, dst and the per-level arrays;
    count the launch."""
    geometry = _geometry(config)
    fn = _entry(source, symbol)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = fn(x.data_ptr(), src.data_ptr(), dst.data_ptr(),
                *[a.ctypes.data for a in geometry],
                float(config.pos_offset), x.shape[0], config.n_levels,
                config.table_size, config.n_features, stream)
    _kernels.check(status, name)
    _kernels.launches[name] += 1


def _launch(table, x, config):
    _check_inputs(NAME, x, config, table, _table_shape(config))
    out = torch.empty((x.shape[0], config.out_dim), dtype=torch.float32,
                      device=x.device)
    _call(_SOURCE, 'hashgrid_encode_fwd', NAME, x, table, out, config)
    return out


def encode_launch_shapes(config, n):
    """K1's launch shape for n points, as the C library plans it: blocks,
    threads, static shared bytes, blocks per SM, registers per thread and
    points per warp, keyed by the kernel the feature width selects."""
    fn = _kernels.library(_SOURCE).hashgrid_encode_shape
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    _kernels.check(fn(config.n_levels, config.n_features, n, out), NAME)
    wide = config.n_features % 4 == 0 and config.n_features >= 32
    keys = ('blocks', 'threads', 'smem_bytes', 'blocks_per_sm', 'registers',
            'points_per_warp')
    return {'encode_rows_kernel' if wide else 'encode_lanes_kernel':
            dict(zip(keys, out))}


def encode_backward_launch_shapes(config, n):
    """K2's launch shape for n points, as the C library plans it: blocks,
    threads, static shared bytes, blocks per SM, registers per thread and
    points per tile, keyed by the kernel the feature width selects."""
    fn = _kernels.library(_BWD_SOURCE).hashgrid_encode_bwd_shape
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    _kernels.check(fn(config.n_levels, config.n_features, n, out), BWD_NAME)
    wide = config.n_features % 4 == 0 and config.n_features >= 32
    keys = ('blocks', 'threads', 'smem_bytes', 'blocks_per_sm', 'registers',
            'points_per_tile')
    return {'scatter_rows_kernel' if wide else 'scatter_lanes_kernel':
            dict(zip(keys, out))}


def atomic_rows(buf, updates):
    """Add 1 to `updates` rows of buf (rows, F fp32, F a multiple of 4) drawn
    by a fixed hash, a warp of float4 atomics a row: the floor K2's atomics
    stand on, which chip_smoke.py times into a buffer L2 holds and one it
    does not. A measurement, on no path, and not counted as a launch."""
    if buf.device.type != 'cuda' or buf.dtype != torch.float32 \
            or buf.dim() != 2 or not buf.is_contiguous():
        raise ValueError('atomic_rows: buf must be a contiguous 2-D float32 '
                         'CUDA tensor')
    fn = _kernels.library(_BWD_SOURCE).hashgrid_bwd_atomic_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _kernels.check(fn(buf.data_ptr(), buf.shape[0], updates, buf.shape[1],
                      torch.cuda.current_stream(buf.device).cuda_stream),
                   'atomic_rows')


def _launch_backward(g, x, config):
    """K2: the table gradient of the encode of x, for its cotangent g."""
    g = g.contiguous()
    _check_inputs(BWD_NAME, x, config, g, (x.shape[0], config.out_dim))
    dtable = torch.empty(_table_shape(config), dtype=torch.float32,
                         device=x.device)
    _call(_BWD_SOURCE, 'hashgrid_encode_bwd', BWD_NAME, x, g, dtable, config)
    return dtable


def hashgrid_encode_backward(g, x, config):
    """The table gradient (L, T, F) of the exact trilinear encode of x for
    the cotangent g (N, L * F): the plain version on the CPU, the scatter
    kernel on the card."""
    if x.device.type == 'cpu' and g.device.type == 'cpu':
        return hashgrid_encode_backward_plain(g, x, config)
    return _launch_backward(g, x, config)


class _Encode(torch.autograd.Function):
    """The encode kernel, and the scatter kernel as its table gradient."""

    @staticmethod
    def forward(ctx, table, x, config):
        ctx.config = config
        ctx.save_for_backward(x)
        return _launch(table, x, config)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        if ctx.needs_input_grad[1]:
            raise NotImplementedError(
                'the gradient of the hash-grid encode for x (pose '
                'refinement) is not ported')
        dtable = None
        if ctx.needs_input_grad[0]:
            dtable = _launch_backward(g, x, ctx.config)
        return dtable, None, None


def hashgrid_encode(table, x, config):
    """Exact trilinear encode of (N, 3) points in [0, 1] -> (N, L * F):
    the plain version on the CPU, the CUDA kernels on the card."""
    if x.device.type == 'cpu' and table.device.type == 'cpu':
        return hashgrid_encode_plain(table, x, config)
    return _Encode.apply(table, x, config)
