"""The hash-grid kernels and their wrappers.

Counterpart of autolabel_tpu/ops/hashgrid_pallas.py (the exact trilinear
encode `hashgrid_encode_pallas` and its VJP `hashgrid_encode_hybrid`) and
of the functions of autolabel_tpu/ops/encoders.py that XLA compiles for
the TPU: the simplex encode, the sampled backward's interpolation atoms,
its point subsample and its scatter, and the stochastic-corner and
residual encodes with their table gradient.

- K1 (csrc/hashgrid_encode.cu) and K2 (csrc/hashgrid_bwd.cu): the exact
  trilinear encode and its table gradient (`_Encode`).
- K1s (csrc/hashgrid_atoms.cu): the simplex or trilinear encode from
  each point's interpolation atoms (A = 4 or 8 table rows and weights a
  level), written out as (L, A, N) indices and weights where a backward
  needs them; fp32 out for the exact encode, the compute dtype (bf16) for
  the sampled one.
- K5 (csrc/select_points.cu): the sampled backward's point subsample;
  under a device mesh (parallel.py) over the global batch, split at its
  norms (`_select_global_call`).
- K2s (csrc/hashgrid_sampled_bwd.cu): the sampled (or, with every level
  at A rows, exact) table gradient from the atoms.
- K6 (csrc/hashgrid_stochastic.cu) and K7 (csrc/hashgrid_stochastic_bwd.cu):
  the stochastic-corner and residual encodes (fp32 out, the drawn rows
  written as (S, N) indices and weights in training) and their table
  gradient, the scatter of those rows (`_StochasticEncode`), in the rows
  format of csrc/hashgrid_stochastic.cuh (encoders.plan_starts).

- K2x (csrc/hashgrid_point_grad.cu): the encode's gradient for the points,
  which camera registration and pose refinement need, for the exact
  trilinear and simplex encodes and the stochastic and residual ones
  (`point_grad`, which each Function above calls; on wide rows a
  levels-slowest kernel writing per-level partials and their ordered sum,
  one call); the sampled encode's is zero, as in the JAX package.

On CPU tensors the wrappers compute the plain PyTorch versions
(ops/encoders.py); on CUDA tensors they launch the kernels or raise.
"""
import ctypes
import functools

import numpy as np
import torch

from autolabel_tpu_torch import parallel
from autolabel_tpu_torch.ops import _kernels, encoders

NAME = 'hashgrid_encode'
BWD_NAME = 'hashgrid_encode_bwd'
ATOMS_NAME = 'hashgrid_encode_atoms'
SELECT_NAME = 'select_points'
SAMPLED_BWD_NAME = 'hashgrid_sampled_bwd'
STOCHASTIC_NAME = 'hashgrid_stochastic'
STOCHASTIC_BWD_NAME = 'hashgrid_stochastic_bwd'
POINT_GRAD_NAME = 'hashgrid_point_grad'
_SOURCE = 'hashgrid_encode.cu'
_BWD_SOURCE = 'hashgrid_bwd.cu'
_ATOMS_SOURCE = 'hashgrid_atoms.cu'
_SELECT_SOURCE = 'select_points.cu'
_SAMPLED_BWD_SOURCE = 'hashgrid_sampled_bwd.cu'
_STOCHASTIC_SOURCE = 'hashgrid_stochastic.cu'
_STOCHASTIC_BWD_SOURCE = 'hashgrid_stochastic_bwd.cu'
_POINT_GRAD_SOURCE = 'hashgrid_point_grad.cu'
_MAX_LEVELS = 32  # MAX_LEVELS in hashgrid_common.cuh
# K6's parts (K6_PART_* in hashgrid_stochastic.cu): the encode, or one part
# of its work alone for timing it
K6_PARTS = {'all': 7, 'draws': 1, 'gathers': 3, 'stores': 4}
# K2x's parts (K2X_PART_* in hashgrid_point_grad.cu): the gradient, or on
# wide rows one part alone for timing it: g's stream, the table gathers,
# the reduction with the partials' stores, the level sum
K2X_PARTS = {'all': 7, 'g': 1, 'gathers': 2, 'reduce': 4, 'sum': 8}


def hashgrid_encode_plain(table, x, config, **kwargs):
    """The plain PyTorch version of the encode kernels, on any device:
    encoders.hashgrid_encode with the same options as hashgrid_encode."""
    return encoders.hashgrid_encode(table, x, config, **kwargs)


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


@functools.cache
def _entry(source, symbol, n_ints=0):
    """A C entry point taking x, src, dst, the six per-level arrays, the
    grid's sizes and `n_ints` ints more, its signature set once, when it
    loads."""
    fn = getattr(_kernels.library(source), symbol)
    fn.argtypes = ([ctypes.c_void_p] * 9
                   + [ctypes.c_float, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
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


@functools.lru_cache(maxsize=None)
def _geometry(config):
    """The per-level arrays the kernels take (the launcher copies them),
    made once per grid config: scales, dense strides, sizes, use_dense and
    the sizes' divisor constants."""
    scales, strides, sizes, use_dense = encoders.level_geometry(config)
    magic, shift = level_divisors(sizes)
    return (np.ascontiguousarray(scales, np.float32),
            np.ascontiguousarray(strides, np.int32),
            np.ascontiguousarray(sizes, np.int32),
            np.ascontiguousarray(use_dense, np.int32), magic, shift)


def _call(source, symbol, name, x, src, dst, config, *ints):
    """Launch symbol of source on x, src, dst, the per-level arrays and
    the ints after the grid's sizes; count the launch."""
    geometry = _geometry(config)
    fn = _entry(source, symbol, len(ints))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = fn(x.data_ptr(), src.data_ptr(), dst.data_ptr(),
                *[a.ctypes.data for a in geometry],
                float(config.pos_offset), x.shape[0], config.n_levels,
                config.table_size, config.n_features, *ints, stream)
    _kernels.check(status, name)
    _kernels.launches[name] += 1


def _wide_rows(features):
    """The wide-row kernels' feature widths (wide_rows in the sources)."""
    return features % 4 == 0 and features >= 32


def _launch(table, x, config, group=0):
    """K1 on the card. group: on narrow rows the levels a thread walks, 0
    for the library's choice (the levels whose rows fill a 32-byte
    sector); another value times or tests another grouping."""
    _check_inputs(NAME, x, config, table, _table_shape(config))
    out = torch.empty((x.shape[0], config.out_dim), dtype=torch.float32,
                      device=x.device)
    _call(_SOURCE, 'hashgrid_encode_fwd', NAME, x, table, out, config,
          int(group))
    return out


def encode_launch_shapes(config, n):
    """K1's launch shape for n points, as the C library plans it: blocks,
    threads, shared bytes (static and dynamic), blocks per SM, registers
    per thread, points per warp (on narrow rows the points whose rows a
    warp stores whole, 0 where each thread stores its own) and the levels
    a thread walks (1 on wide rows), keyed by the kernel the feature width
    selects."""
    fn = _kernels.library(_SOURCE).hashgrid_encode_shape
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 7)()
    _kernels.check(fn(config.n_levels, config.n_features, n, out), NAME)
    keys = ('blocks', 'threads', 'smem_bytes', 'blocks_per_sm', 'registers',
            'points_per_warp', 'levels_per_thread')
    return {'encode_rows_kernel' if _wide_rows(config.n_features)
            else 'encode_lanes_kernel': dict(zip(keys, out))}


def gather_sectors(x, config, points=None, sector=32):
    """The distinct `sector`-byte sectors of the fp32 (L, T, F) table that
    the exact trilinear encode of x gathers, level by level: over the whole
    launch (points None), K1 narrow's floor of bytes from device memory
    beside its byte bound, which charges every row of a level; or summed
    over tiles of `points` consecutive points, the requests a warp of that
    many points makes of L2 at the least. A row that straddles two
    sectors touches both. Computed with torch on x's device."""
    cell, _, stride, use_dense, size = encoders._grid_geometry(x, config)
    row_bytes = config.n_features * 4
    n = x.shape[0]
    counts = []
    for l in range(config.n_levels):
        idx = torch.stack([encoders._corner_index(
            cell[:, l], corner, stride[l], use_dense[l], size[l])
            for corner in encoders._CORNERS], dim=1)  # (N, 8)
        start = (l * config.table_size + idx) * row_bytes
        secs = torch.cat([start // sector,
                          (start + row_bytes - 1) // sector], dim=1)
        if points is None:
            counts.append(int(torch.unique(secs).numel()))
            continue
        pad = (-n) % points
        if pad:
            secs = torch.cat([secs, secs[-1:].expand(pad, secs.shape[1])])
        s = secs.reshape(-1, points * secs.shape[1]).sort(dim=1).values
        counts.append(int((s[:, 1:] != s[:, :-1]).sum()) + s.shape[0])
    return counts


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
    keys = ('blocks', 'threads', 'smem_bytes', 'blocks_per_sm', 'registers',
            'points_per_tile')
    return {'scatter_rows_kernel' if _wide_rows(config.n_features)
            else 'scatter_lanes_kernel':
            dict(zip(keys, out))}


def atoms_launch_shape(config, n, interp='simplex', write=1, bf16=1):
    """K1s's launch shape for n points, as its C library plans it: blocks,
    threads, static shared bytes, blocks per SM, registers and points, the
    points a warp takes."""
    fn = _kernels.library(_ATOMS_SOURCE).hashgrid_atoms_shape
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    _kernels.check(fn(config.n_levels, n, _atom_count(interp), write, bf16,
                      out), ATOMS_NAME)
    return dict(zip(('blocks', 'threads', 'smem_bytes', 'blocks_per_sm',
                     'registers', 'points'), out))


def tile_rows(idx, points, table_size):
    """The distinct rows each tile of `points` consecutive points needs,
    level by level, from the (L, A, N) atom indices: (the count per
    level, the rows as int64 indices into the flattened (L * T) table,
    tile by tile, levels slowest). A K1s warp takes a tile of 32 / A
    points and needs each of them from L2 at least once; the last tile's
    missing points repeat its last point."""
    n_levels, a, n = idx.shape
    pad = (-n) % points
    counts, rows = [], []
    for l in range(n_levels):
        ids = idx[l].t()
        if pad:
            ids = torch.cat([ids, ids[-1:].expand(pad, a)])
        s = ids.reshape(-1, points * a).sort(dim=1).values
        first = torch.ones_like(s, dtype=torch.bool)
        first[:, 1:] = s[:, 1:] != s[:, :-1]
        counts.append(int(first.sum()))
        rows.append(s[first].long() + l * table_size)
    return counts, torch.cat(rows)


def gather_rows(table, rows):
    """Read the listed rows of the (L, T, F) fp32 table (int64 indices
    into its L * T rows), a warp a row float4 wide, 4 rows of a warp in
    flight: timed on tile_rows' list, the floor under K1s's L2 gathers,
    which chip_smoke.py reports beside K1s's DRAM bound. A measurement,
    on no path, and not counted as a launch."""
    if table.device.type != 'cuda' or table.dtype != torch.float32 \
            or table.dim() != 3 or not table.is_contiguous() \
            or rows.dtype != torch.int64 or rows.device != table.device \
            or not rows.is_contiguous():
        raise ValueError('gather_rows: a contiguous (L, T, F) float32 CUDA '
                         'table and int64 rows on its device')
    sink = torch.zeros(1, device=table.device)
    fn = _kernels.library(_ATOMS_SOURCE).hashgrid_atoms_gather_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _kernels.check(fn(table.data_ptr(), rows.data_ptr(), rows.numel(),
                      table.shape[2], sink.data_ptr(),
                      torch.cuda.current_stream(table.device).cuda_stream),
                   'gather_rows')


def sampled_launch_shapes(config, n, slots, rows, interp='simplex'):
    """The launch shapes of K1s (training form: atoms, bf16 out; eval
    form: fp32 out), K5's four kernels (N x out_dim bf16 cotangent) and
    K2s (bf16 cotangent, `slots` selected points, `rows` per level), as
    the C libraries plan them: blocks, threads, shared bytes (static;
    K2s's dynamic), blocks per SM, registers, points per warp, tile (at
    most, for K2s) or block."""
    keys = ('blocks', 'threads', 'smem_bytes', 'blocks_per_sm', 'registers',
            'points')
    a = _atom_count(interp)
    shapes = {f'K1s atoms_rows_kernel ({form})':
              atoms_launch_shape(config, n, interp, write, bf16)
              for form, write, bf16 in (('training', 1, 1), ('eval', 0, 0))}
    fn = _select_library().select_points_shape
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 24)()
    _kernels.check(fn(n, config.out_dim, out), SELECT_NAME)
    for i, name in enumerate(('norms_kernel', 'scan_kernel', 'counts_kernel',
                              'compact_kernel')):
        shapes[f'K5 {name}'] = dict(zip(keys, out[6 * i:6 * i + 6]))
    fn = _kernels.library(_SAMPLED_BWD_SOURCE).hashgrid_sampled_bwd_shape
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    _kernels.check(fn(config.n_levels, config.n_features, a,
                      (ctypes.c_int * config.n_levels)(*rows),
                      config.table_size, slots, 1, out), SAMPLED_BWD_NAME)
    shapes['K2s sampled_rows_kernel'] = dict(zip(keys, out))
    return shapes


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


# -- K2x: the encode's gradient for the points -----------------------------

def hashgrid_encode_point_grad_plain(g, table, x, config, interp='trilinear',
                                     plan=None, rows=None):
    """The plain PyTorch version of K2x, on any device."""
    return encoders.hashgrid_encode_point_grad_plain(g, table, x, config,
                                                     interp, plan, rows)


@functools.cache
def _point_grad_launcher():
    """K2x's C entry point, its signature set once, when it loads."""
    fn = _kernels.library(_POINT_GRAD_SOURCE).hashgrid_point_grad
    fn.argtypes = ([ctypes.c_void_p] * 14
                   + [ctypes.c_float, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _point_grad_partials(features):
    """The fp32 partials K2x needs a point and level that carries a
    gradient: 3 on wide rows, 0 on narrow rows."""
    fn = _kernels.library(_POINT_GRAD_SOURCE).hashgrid_point_grad_workspace
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(features)


def _point_grad_call(g, table, x, config, interp, plan, rows, parts='all'):
    """K2x: dx (N, 3) fp32 for the encode's fp32 cotangent g. On wide rows
    one level kernel writes each level's scaled cotangent to a partial
    (levels carrying a gradient, N, 3) and a second launch sums them in
    level order; one call, counted once. `parts` other than 'all' runs one
    part of the work alone (K2X_PARTS) for timing it."""
    _check_inputs(POINT_GRAD_NAME, x, config, table, _table_shape(config))
    n = x.shape[0]
    if g.dtype != torch.float32 or tuple(g.shape) != (n, config.out_dim) \
            or not g.is_contiguous() or g.device != x.device \
            or g.data_ptr() % 16:
        raise ValueError(f'{POINT_GRAD_NAME}: g must be a contiguous, '
                         f'16-byte aligned ({n}, {config.out_dim}) float32 '
                         'tensor on the device of x')
    if plan is None:  # every level exact, its rows from the cell
        plan = ((encoders.EXACT, 0),) * config.n_levels
    starts = encoders.plan_starts(plan)
    if rows is not None:
        if rows.device != x.device or rows.dtype != torch.int32 \
                or rows.dim() != 2 or rows.shape[1] != n \
                or rows.shape[0] != sum(r for _, r in plan) \
                or not rows.is_contiguous():
            raise ValueError(f'{POINT_GRAD_NAME}: rows must be contiguous '
                             f'int32 (S, {n}) on the device of x, S the '
                             'plan\'s rows')
    elif any(k == encoders.RESIDUAL for k, _ in plan):
        raise ValueError(f'{POINT_GRAD_NAME}: a residual level needs its '
                         'drawn rows')
    levels = config.n_levels
    kinds = (ctypes.c_int * levels)(*[k for k, *_ in starts])
    firsts = (ctypes.c_int * levels)(*[first for _, _, first, _ in starts])
    active = sum(k != encoders.DRAWS for k, *_ in starts)
    dx = torch.empty((n, 3), dtype=torch.float32, device=x.device)
    partials = torch.empty(
        _point_grad_partials(config.n_features) * active * n,
        dtype=torch.float32, device=x.device)
    status = _point_grad_launcher()(
        x.data_ptr(), table.data_ptr(), g.data_ptr(),
        None if rows is None else rows.data_ptr(), dx.data_ptr(),
        partials.data_ptr() if partials.numel() else None,
        *[a.ctypes.data for a in _geometry(config)], kinds, firsts,
        float(config.pos_offset), n, levels, config.table_size,
        config.n_features, _atom_count(interp), K2X_PARTS[parts],
        torch.cuda.current_stream(x.device).cuda_stream)
    _kernels.check(status, POINT_GRAD_NAME)
    _kernels.launches[POINT_GRAD_NAME] += 1
    return dx


def point_grad(g, table, x, config, interp='trilinear', plan=None, rows=None):
    """The encode's gradient for x (N, 3), for its cotangent g (N, L * F):
    K2x on the card, its plain version on the CPU. plan: the stochastic
    encode's (encoders.stochastic_plan), None for the exact encode; rows:
    the (S, N) int32 rows a forward kernel wrote in the plan's layout
    (K1s's atoms as (L * A, N), K6's drawn rows), which the kernel reads in
    place of hashing; a RESIDUAL level needs them."""
    if x.device.type == 'cpu' and table.device.type == 'cpu':
        return hashgrid_encode_point_grad_plain(g, table, x, config, interp,
                                                plan, rows)
    return _point_grad_call(g.float().contiguous(), table.detach(), x,
                            config, interp, plan, rows)


def point_grad_launch_shape(config, n, interp='trilinear', plan=None):
    """K2x's launches for n points, as its C library plans them: blocks,
    threads, shared bytes, blocks per SM, registers and points a block
    (the level sum's: elements), keyed by kernel: on wide rows the level
    kernel (a block of 4 warps of P = 32 / A points of one level, the
    levels carrying a gradient slowest) and the level sum; on narrow rows
    the points kernel (a thread a point)."""
    fn = _kernels.library(_POINT_GRAD_SOURCE).hashgrid_point_grad_shape
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    a = _atom_count(interp)
    active = config.n_levels if plan is None else sum(
        k != encoders.DRAWS for k, _ in plan)
    out = (ctypes.c_int * 15)()
    _kernels.check(fn(config.n_features, a, config.n_levels, active, n, out),
                   POINT_GRAD_NAME)
    keys = ('blocks', 'threads', 'smem_bytes', 'blocks_per_sm', 'registers',
            'points')
    names = (f'point_grad_levels_kernel<{a}>', 'level_sum_kernel',
             f'point_grad_points_kernel<{a}>')
    return {f'K2x {names[out[1 + 7 * i]]}':
            dict(zip(keys, out[2 + 7 * i:8 + 7 * i])) for i in range(out[0])}


class _Encode(torch.autograd.Function):
    """The encode kernel; the scatter kernel as its table gradient and K2x
    as its gradient for x."""

    @staticmethod
    def forward(ctx, table, x, config):
        ctx.config = config
        ctx.save_for_backward(table, x)
        return _launch(table.detach(), x, config)

    @staticmethod
    def backward(ctx, g):
        table, x = ctx.saved_tensors
        dtable = dx = None
        if ctx.needs_input_grad[0]:
            dtable = _launch_backward(g, x, ctx.config)
        if ctx.needs_input_grad[1]:
            dx = point_grad(g, table, x, ctx.config)
        return dtable, dx, None


# -- K1s, K5, K2s: the simplex encode and the sampled backward -------------

def _atom_count(interp):
    return 4 if interp == 'simplex' else 8


def _atoms_call(table, x, config, interp, out_dtype, atoms):
    """K1s: the encode of x from its interpolation atoms, out_dtype fp32 or
    bf16, and with atoms the (L, A, N) int32 indices and fp32 weights."""
    _check_inputs(ATOMS_NAME, x, config, table, _table_shape(config))
    if config.n_features % 4:
        raise ValueError(f'{ATOMS_NAME}: features must be a multiple of 4')
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'{ATOMS_NAME}: output must be float32 or bfloat16')
    n, a = x.shape[0], _atom_count(interp)
    dev = x.device
    out = torch.empty((n, config.out_dim), dtype=out_dtype, device=dev)
    idx = w = None
    if atoms:
        idx = torch.empty((config.n_levels, a, n), dtype=torch.int32,
                          device=dev)
        w = torch.empty((config.n_levels, a, n), dtype=torch.float32,
                        device=dev)
    fn = _kernels.library(_ATOMS_SOURCE).hashgrid_atoms_fwd
    fn.argtypes = ([ctypes.c_void_p] * 11
                   + [ctypes.c_float, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    geometry = _geometry(config)
    status = fn(x.data_ptr(), table.data_ptr(), out.data_ptr(),
                idx.data_ptr() if atoms else None,
                w.data_ptr() if atoms else None,
                *[g.ctypes.data for g in geometry], float(config.pos_offset),
                n, config.n_levels, config.table_size, config.n_features, a,
                int(out_dtype == torch.bfloat16),
                torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(status, ATOMS_NAME)
    _kernels.launches[ATOMS_NAME] += 1
    return out, idx, w


def encode_atoms_plain(table, x, config, interp, out_dtype, atoms=True):
    """The plain version of K1s, on any device: (out, idx, w), the atoms
    None without `atoms`. fp32 out is the exact encode; another dtype
    interpolates from the atoms in it (encoders._gather_from_atoms)."""
    idx, w = encoders._corner_idx_weights(x, config, interp)
    if out_dtype == torch.float32:
        out = (encoders._encode_rows_simplex(table, x, config)
               if interp == 'simplex' else
               encoders.hashgrid_encode(table, x, config))
    else:
        out = encoders._gather_from_atoms(table, idx, w, config, out_dtype)
    return (out, idx, w) if atoms else (out, None, None)


def encode_atoms(table, x, config, interp='simplex',
                 out_dtype=torch.float32, atoms=True):
    """K1s on the card, its plain version on the CPU."""
    if x.device.type == 'cpu' and table.device.type == 'cpu':
        return encode_atoms_plain(table, x, config, interp, out_dtype, atoms)
    return _atoms_call(table.detach(), x, config, interp, out_dtype, atoms)


def _g_dtype(name, g, n, width):
    if g.dtype not in (torch.float32, torch.bfloat16) or g.dim() != 2 \
            or tuple(g.shape) != (n, width) or not g.is_contiguous() \
            or g.data_ptr() % 16:
        raise ValueError(f'{name}: g must be a contiguous, 16-byte aligned '
                         f'({n}, {width}) float32 or bfloat16 tensor')
    return int(g.dtype == torch.bfloat16)


@functools.lru_cache(maxsize=64)
def select_workspace_bytes(n):
    """The scratch K5 needs for n points, as its C library counts it."""
    fn = _select_library().select_points_workspace
    fn.argtypes = [ctypes.c_longlong]
    fn.restype = ctypes.c_longlong
    return fn(n)


# The constants that fix K5's order of fp32 additions (select_points.cu
# select_points_order): points a tile, and consecutive points a thread
# scans before the threads' totals chain along the lanes (32) and the
# warps' along the tile.
SELECT_TILE = 1024
SELECT_ROWS = 4
_SELECT_MAX_DIM = 4096  # 16 16-byte chunks a lane per row


@functools.lru_cache(maxsize=1)
def _select_library():
    """K5's library, once its order is checked against SELECT_TILE and
    SELECT_ROWS, which select_chain reproduces."""
    lib = _kernels.library(_SELECT_SOURCE)
    out = (ctypes.c_int * 2)()
    lib.select_points_order.argtypes = [ctypes.c_void_p]
    lib.select_points_order.restype = None
    lib.select_points_order(out)
    if tuple(out) != (SELECT_TILE, SELECT_ROWS):
        raise RuntimeError(f'{SELECT_NAME}: the library\'s order (tile, '
                           f'rows) {tuple(out)} is not select_chain\'s '
                           f'{(SELECT_TILE, SELECT_ROWS)}')
    return lib


def select_workspace_views(work, n):
    """K5's workspace of n points as its kernels leave it: the row norms s,
    each tile's inclusive scan loc, the counts, the tiles' totals and the
    total (as select_points.cu lays them out)."""
    tiles = -(-n // SELECT_TILE)
    f, i = work.view(torch.float32), work.view(torch.int32)
    return dict(s=f[:n], loc=f[n:2 * n], counts=i[2 * n:3 * n],
                tile_total=f[3 * n:3 * n + tiles],
                total=f[3 * n + 2 * tiles])


def _select_inputs(g, u, k, total):
    """Check K5's inputs: g (n, D) bf16 on the card, u (L, n + 1) and k
    draws among `total` points."""
    n = g.shape[0]
    dev = g.device
    if g.device.type != 'cuda' or u.device != dev:
        raise ValueError(f'{SELECT_NAME}: inputs must be on one CUDA device')
    if g.dtype != torch.bfloat16 or g.dim() != 2 or not g.is_contiguous() \
            or g.data_ptr() % 16 or g.shape[1] % 8 \
            or g.shape[1] > _SELECT_MAX_DIM:
        raise ValueError(f'{SELECT_NAME}: g must be a contiguous, 16-byte '
                         'aligned (N, D) bfloat16 tensor, D a multiple of 8 '
                         f'and at most {_SELECT_MAX_DIM}')
    if u.dtype != torch.float32 or u.dim() != 2 or u.shape[1] != n + 1 \
            or not u.is_contiguous():
        raise ValueError(f'{SELECT_NAME}: u must be contiguous float32 '
                         f'(L, {n + 1})')
    if not 1 <= k <= total:
        raise ValueError(f'{SELECT_NAME}: k={k} outside [1, {total}]')


def _select_call(g, u, k, work=None):
    """K5: (sel (k,) int32, coef (k,) fp32, count (1,) int32) on the card;
    the first count entries are the selected points. `work`, if given,
    is the workspace (select_workspace_bytes(n) uint8), left for the
    caller to read (select_workspace_views)."""
    n = g.shape[0]
    dev = g.device
    _select_inputs(g, u, k, n)
    sel = torch.empty(k, dtype=torch.int32, device=dev)
    coef = torch.empty(k, dtype=torch.float32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    if work is None:
        work = torch.empty(select_workspace_bytes(n), dtype=torch.uint8,
                           device=dev)
    elif work.dtype != torch.uint8 or work.device != dev \
            or work.numel() != select_workspace_bytes(n):
        raise ValueError(f'{SELECT_NAME}: the workspace must be '
                         f'{select_workspace_bytes(n)} bytes on the card')
    fn = _select_library().select_points
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    status = fn(g.data_ptr(), n, g.shape[1], u[0, n:].data_ptr(), k,
                work.data_ptr(), sel.data_ptr(), coef.data_ptr(),
                count.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(status, SELECT_NAME)
    _kernels.launches[SELECT_NAME] += 1
    return sel, coef, count


def select_norms(g, root=True):
    """K5's first kernel alone: the fp32 norms of g's rows (N, D) bf16 on
    the card, or with root False their squares."""
    n = g.shape[0]
    s = torch.empty(n, dtype=torch.float32, device=g.device)
    fn = _select_library().select_points_norms
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(g.data_ptr(), n, g.shape[1], int(root), s.data_ptr(),
                torch.cuda.current_stream(g.device).cuda_stream)
    _kernels.check(status, SELECT_NAME)
    return s


def select_scan(work, total, u_sys, k, lo, hi):
    """K5's scan, counts and compaction on the norms of `total` points in
    the workspace's s (select_workspace_views): the k draws among them, of
    which those in [lo, hi) are returned as (sel, coef, count), sel
    numbered from lo. u_sys: a one-element fp32 tensor on the card."""
    dev = work.device
    if work.dtype != torch.uint8 or work.numel() != \
            select_workspace_bytes(total) or dev.type != 'cuda' \
            or u_sys.device != dev or u_sys.dtype != torch.float32:
        raise ValueError(f'{SELECT_NAME}: the workspace must be '
                         f'{select_workspace_bytes(total)} bytes on the card'
                         ' and u_sys fp32 on it')
    cap = min(k, hi - lo)
    sel = torch.empty(cap, dtype=torch.int32, device=dev)
    coef = torch.empty(cap, dtype=torch.float32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    fn = _select_library().select_points_scan
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int] \
        + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    status = fn(total, u_sys.data_ptr(), k, lo, hi, cap, work.data_ptr(),
                sel.data_ptr(), coef.data_ptr(), count.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(status, SELECT_NAME)
    return sel, coef, count


def _select_global_call(g, u, k, mesh, work=None):
    """K5 over the global batch of a device mesh (parallel.py), from this
    rank's rows g (a block of the global rows; under 'model' a feature
    slice of each): its norms kernel on the rank's rows (their squares
    under 'model', summed over the model group in rank order, then the
    root), the norms gathered over 'data' into the workspace of the global
    points, then its scan, counts and compaction there with the one u_sys,
    keeping the draws in the rank's rows. Every rank scans the same norms,
    so the ranks' selections partition the global one. Returns (sel,
    coef, count) as _select_call, sel numbered from the rank's first row;
    `work`, if given, the workspace of the global points."""
    n = g.shape[0]
    total = n * parallel.axis_size(mesh, parallel.DATA)
    _select_inputs(g, u, k, total)
    whole_rows = parallel.axis_size(mesh, parallel.MODEL) == 1
    s = select_norms(g, root=whole_rows)
    if not whole_rows:
        s = torch.sqrt(parallel.sum_over_model(s, mesh))
    if work is None:
        work = torch.empty(select_workspace_bytes(total), dtype=torch.uint8,
                           device=g.device)
    select_workspace_views(work, total)['s'].copy_(
        parallel.gather_rows(s, mesh))
    lo = parallel.axis_index(mesh, parallel.DATA) * n
    out = select_scan(work, total, u[0, n:], k, lo, lo + n)
    _kernels.launches[SELECT_NAME] += 1
    return out


def select_points(g, u, k, mesh=None):
    """The point subsample of the sampled backward: (sel, coef, count), the
    count first entries of sel the points drawn (K5 on the card, in
    ascending order within each block of points), or on the CPU the plain
    version's (sel, coef) and their count. With a device mesh, k draws
    among the global batch's points, those in this rank's rows
    (_select_global_call)."""
    if g.device.type == 'cpu':
        n = g.shape[0]
        if mesh is None:
            sel, coef = encoders._select_backward_points(g, u[0, n], k)
        else:
            sel, coef = encoders.select_backward_points_global(
                g, u[0, n], k, mesh)
        return sel, coef, torch.tensor([sel.shape[0]], dtype=torch.int32)
    if mesh is None:
        return _select_call(g.contiguous(), u, k)
    return _select_global_call(g.contiguous(), u, k, mesh)


def _sampled_scatter_call(g, idx, w, u, rows, config, sel, coef, count):
    """K2s: the table gradient from the atoms, every level's points (or the
    count first of sel, scaled by coef) scattered into rows[l] rows."""
    dev = g.device
    n_levels, a, n = idx.shape
    for t in (idx, w, u, sel, coef, count):
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError(f'{SAMPLED_BWD_NAME}: inputs must be '
                             f'contiguous on one CUDA device')
    if dev.type != 'cuda' or idx.dtype != torch.int32 \
            or w.dtype != torch.float32 or tuple(w.shape) != tuple(idx.shape) \
            or n_levels != config.n_levels or a not in (4, 8):
        raise ValueError(f'{SAMPLED_BWD_NAME}: atoms must be (L, 4 or 8, N) '
                         f'int32 indices and fp32 weights on the card')
    bf16 = _g_dtype(SAMPLED_BWD_NAME, g, n, config.out_dim)
    if config.n_features % 4 or len(rows) != n_levels \
            or any(r not in (1, 2, a) for r in rows):
        raise ValueError(f'{SAMPLED_BWD_NAME}: rows {rows} or features '
                         f'{config.n_features} outside the kernel')
    if any(r < a for r in rows) and (
            u is None or u.dtype != torch.float32 or u.dim() != 2
            or u.shape[0] != n_levels or u.shape[1] < n):
        raise ValueError(f'{SAMPLED_BWD_NAME}: the draws need u (L, >= N)')
    if (sel is None) != (coef is None) or (sel is None) != (count is None):
        raise ValueError(f'{SAMPLED_BWD_NAME}: sel, coef and count go '
                         'together')
    if sel is not None and (sel.dtype != torch.int32
                            or coef.dtype != torch.float32
                            or count.dtype != torch.int32
                            or coef.shape != sel.shape):
        raise ValueError(f'{SAMPLED_BWD_NAME}: sel and count int32, coef '
                         'float32')
    slots = n if sel is None else sel.shape[0]
    dtable = torch.empty(_table_shape(config), dtype=torch.float32,
                         device=dev)
    fn = _kernels.library(_SAMPLED_BWD_SOURCE).hashgrid_sampled_bwd
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_longlong] + [ctypes.c_void_p] * 5
                   + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rows_arr = (ctypes.c_int * n_levels)(*rows)
    status = fn(g.data_ptr(), bf16, idx.data_ptr(), w.data_ptr(),
                None if u is None else u.data_ptr(),
                0 if u is None else u.shape[1],
                None if sel is None else sel.data_ptr(),
                None if sel is None else coef.data_ptr(),
                None if sel is None else count.data_ptr(), rows_arr,
                dtable.data_ptr(), slots, n, n_levels, config.table_size,
                config.n_features, a,
                torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(status, SAMPLED_BWD_NAME)
    _kernels.launches[SAMPLED_BWD_NAME] += 1
    return dtable


def sampled_scatter(g, idx, w, u, rows, config, sel=None, coef=None,
                    count=None):
    """The sampled table gradient from the atoms (K2s on the card, the plain
    version on the CPU): with (sel, coef, count) the count first selected
    points scatter, scaled by coef; rows[l] = A is the exact scatter."""
    if g.device.type == 'cpu':
        if sel is not None:
            m = int(count[0])
            sel, coef = sel[:m].long(), coef[:m]
        return encoders.sampled_scatter_plain(g, idx, w, u, rows, config,
                                              sel, coef)
    return _sampled_scatter_call(g.contiguous(), idx, w, u, rows, config,
                                 sel, coef, count)


def sampled_backward_tolerance(g, idx, w, u, rows, config, sel=None,
                               coef=None):
    """Per element of the sampled table gradient, how far two fp32 sums of
    its terms in different orders can lie apart (as backward_tolerance):
    2 k 2^-24 times the sum of the terms' magnitudes, k the terms of the
    element's row under the same draws. sel: the selected points (the
    plain version's, or the kernel's first count)."""
    n = idx.shape[2]
    uc = u[:, :n] if u is not None else None
    terms = torch.zeros((config.n_levels, config.table_size),
                        dtype=torch.float32, device=g.device)
    idx_s, w_s = idx, w
    if sel is not None:
        sel = sel.long()
        idx_s, w_s = idx[:, :, sel], w[:, :, sel]
        uc = uc[:, sel] if uc is not None else None
    for l in range(config.n_levels):
        u_l = uc[l] if uc is not None else None
        for row, _ in encoders._draw_rows(idx_s[l].long(), w_s[l], u_l,
                                          rows[l]):
            terms[l].index_add_(0, row, torch.ones_like(row,
                                                        dtype=torch.float32))
    magnitude = encoders.sampled_scatter_plain(
        g.float().abs(), idx, w, u, rows, config, sel,
        None if coef is None else coef.abs())
    return 2.0 * terms[..., None] * 2.0 ** -24 * magnitude


def _select_roundings(n, dim):
    """The fp32 roundings in K5's p_i = s_i / total, each at most 2^-24 of
    the quantity: every norm of a dim-wide row carries at most dim / 32
    products a lane, 5 shuffles and the root (norm); every partial sum of
    the norms, and the total, a chain of at most 4 (a thread's rows) + 32
    (lanes) + 8 (warps) + n / 1024 (tiles) additions of non-negative
    terms (chain)."""
    return -(-dim // 32) + 6, 4 + 32 + 8 + -(-n // 1024)


def select_scan_bound(n, k, dim):
    """How far K5 can move k cum_i - u from the float64 value, in counts:
    cum_i = P_i / total, the partial sum and the total each a chain of
    roundings of sums no larger than the total, then the division, k cum
    and - u; every norm's rounding moves cum by twice its own (through
    P_i and the total)."""
    norm, chain = _select_roundings(n, dim)
    return (2 * chain + 3 + 2 * norm) * 2.0 ** -24 * k


def select_coef_bound(n, dim):
    """How far K5's coef = counts / (k p) can lie from counts / (k p_64),
    relative: the norm's rounding twice (s_i, and the total through its
    terms), the total's chain, the division p = s / total, k p and the
    last division."""
    norm, chain = _select_roundings(n, dim)
    return (2 * norm + chain + 3) * 2.0 ** -24


# float64's rounding of the distances of values up to k from integers, in
# counts, far above it for any k below 2^30
_F64_SLACK = 1e-6


def _draws(cum, k, u_sys):
    """v = k cum - u, rounded as cum's dtype rounds it, and the counts
    diff(floor(v)) with floor(v_{-1}) = -1."""
    v = cum * k - u_sys
    c = torch.floor(v)
    return v, torch.diff(c, prepend=c.new_full((1,), -1.0))


def select_chain(g):
    """K5's norms and scans recomputed on the CPU in its own fp32 order, for
    g (N, D) bf16: (s, loc, tile_total) as its norms and scan kernels
    write them (select_chain_norms, then select_chain_scan)."""
    s = select_chain_norms(g)
    return (s, *select_chain_scan(s))


def select_chain_norms(g, root=True):
    """K5's norms kernel on the CPU: a lane adds the squares of its 16-byte
    chunks of a row in order, each by one fused multiply-add (here the
    exact float64 square and sum rounded to fp32: the same, since a bf16
    square has 16 bits), a butterfly of shuffles sums the lanes, then the
    root (or, without root, the squares' sum)."""
    n, dim = g.shape
    width = -(-dim // 256) * 256  # 32 lanes of 8 bf16 values a chunk
    s = np.empty(n, np.float32)
    for r0 in range(0, n, 1 << 16):  # rows in blocks, to bound the memory
        x = np.zeros((min(n - r0, 1 << 16), width), np.float64)
        x[:, :dim] = g[r0:r0 + x.shape[0]].double().cpu().numpy()
        sq = (x * x).reshape(x.shape[0], width // 256, 32, 8)
        acc = np.zeros((x.shape[0], 32), np.float32)
        for j in range(sq.shape[1]):
            for e in range(8):
                acc = (acc + sq[:, j, :, e]).astype(np.float32)
        for o in (16, 8, 4, 2, 1):
            acc = acc + acc[:, np.arange(32) ^ o]
        s[r0:r0 + x.shape[0]] = np.sqrt(acc[:, 0]) if root else acc[:, 0]
    return s


def select_chain_scan(s):
    """K5's scan kernel on the CPU, from the fp32 norms s: (loc,
    tile_total). In a tile of SELECT_TILE points each thread scans its
    SELECT_ROWS rows, the threads' totals chain along the 32 lanes and the
    warps' along the tile."""
    tile = SELECT_TILE
    n = s.shape[0]
    tiles = -(-n // tile)
    sn = np.zeros(tiles * tile, np.float32)
    sn[:n] = s
    run = np.add.accumulate(sn.reshape(tiles, tile // SELECT_ROWS,
                                       SELECT_ROWS), axis=2)
    lanes = np.add.accumulate(run[:, :, -1].reshape(tiles, -1, 32), axis=2)
    mine = np.concatenate([np.zeros_like(lanes[:, :, :1]),
                           lanes[:, :, :-1]], axis=2).reshape(tiles, -1, 1)
    warps = np.add.accumulate(lanes[:, :, 31], axis=1)
    w = np.concatenate([np.zeros_like(warps[:, :1]), warps[:, :-1]], axis=1)
    w = np.repeat(w, 32, axis=1)[:, :, None]
    loc = (w + (mine + run)).reshape(-1)[:n]
    return loc, warps[:, -1]


def check_selection(g, u_sys, k, sel, coef, count, views, norms=None):
    """Hold one K5 call of (g (N, D) bf16, u_sys, k) with its outputs
    (sel, coef, count) and workspace views (select_workspace_views) against
    itself, the float64 truth and the plain version. norms: for a call
    split at its norms (_select_global_call, every row the rank's), the
    fp32 norms it scanned, which stand in for g's: the chain, the truth
    and the plain version then start from them. Returns a dict:

    - norms_off, scan_off: K5's norms, and its tiles' scans and totals,
      that differ in their bits from select_chain's (must be 0);
    - chain_equal: the tiles' totals chained in fp32 in tile order (as every
      counts_kernel block chains them) give the total K5 wrote, bit-equal;
    - counts_equal: K5's counts are exactly diff(floor(k cum - u)) of its
      own cum = (offset + loc) / total, recomputed here in fp32 with the
      kernel's roundings;
    - selection_equal: sel[:count] is the points with counts > 0 in
      ascending order, and coef bit-equal to counts / (k max(s / total,
      1e-30));
    - norm_rel: the largest relative deviation of s from the float64 norms,
      relative to norms of at least 2^-50 (bounded by _select_roundings'
      norm times 2^-24; below 2^-50 the squares' underflow in fp32, at most
      2^-149 a rounding, can move a norm by more than that relative
      amount, and by less absolute);
    - scan_dev: the largest distance in counts of the fp32 k cum - u that
      K5 floors from the float64 one (bounded by select_scan_bound);
    - coef_rel, compared: the largest relative deviation of coef from
      counts / (k p_64) over the selected points, and their number
      (bounded by select_coef_bound);
    - truth_off, truth_dist: the points whose count differs from the
      float64 count, and the largest distance in counts of k cum_64 - u
      from an integer among them (at or below scan_dev);
    - plain_off, plain_dev, plain_unexplained: the points one of K5 and
      the plain version selects and the other not or with another count;
      the plain version's scan_dev; and the differing points
      where k cum_64 - u lies farther than max(scan_dev, plain_dev) from
      an integer (must be 0: an integer lies between the two scans' values);
      plain_consistent: the plain selection is its counts' compaction;
    - plain_coef_rel, plain_compared, plain_coef_dev: the largest relative
      coef difference from the plain version's on every point both give
      the same count, their number, and the plain coefs' own largest
      relative deviation from counts / (k p_64)."""
    cpu = torch.device('cpu')
    n = views['s'].shape[0]
    m = int(count[0])
    sel = sel[:m].to(cpu).long()
    coef = coef[:m].to(cpu)
    s = views['s'].to(cpu)
    loc = views['loc'].to(cpu)
    counts = views['counts'].to(cpu).long()
    total = views['total'].to(cpu)
    u = torch.as_tensor(u_sys, dtype=torch.float32).to(cpu)
    # K5's own chain, in fp32 with its roundings
    tt = views['tile_total'].to(cpu).numpy()
    if norms is None:
        s_ref, loc_ref, tt_ref = select_chain(g)
    else:
        s_ref = np.asarray(norms, np.float32)
        loc_ref, tt_ref = select_chain_scan(s_ref)
    norms_off = int((s_ref.view(np.int32)
                     != s.numpy().view(np.int32)).sum())
    scan_off = int((loc_ref.view(np.int32)
                    != loc.numpy().view(np.int32)).sum()
                   + (tt_ref.view(np.int32) != tt.view(np.int32)).sum())
    offsets = np.empty(tt.shape[0], np.float32)
    acc = np.float32(0.0)
    for b, t in enumerate(tt):
        offsets[b] = acc
        acc = np.float32(acc + t)
    chain_equal = acc.tobytes() == total.numpy().tobytes()
    uniform = not float(total) > 0.0
    if uniform:
        cum = (torch.arange(1, n + 1, dtype=torch.float32)
               / torch.tensor(float(n), dtype=torch.float32))
        p = torch.full((n,), 1.0) / torch.tensor(float(n))
    else:
        off = torch.from_numpy(offsets).repeat_interleave(SELECT_TILE)[:n]
        cum = (off + loc) / total
        p = s / torch.clamp(total, min=1e-30)
    v_k5, want = _draws(cum, k, u)
    counts_equal = torch.equal(counts, want.long())
    flagged = torch.nonzero(counts > 0).squeeze(1)
    want_coef = (counts[flagged].float()
                 / (torch.clamp(p[flagged], min=1e-30) * float(k)))
    selection_equal = (m == min(flagged.numel(), k)
                       and torch.equal(sel, flagged[:m])
                       and torch.equal(coef, want_coef[:m]))
    # the float64 truth
    s64 = (g.double().pow(2).sum(dim=-1).sqrt().to(cpu) if norms is None
           else torch.from_numpy(s_ref).double())
    tot64 = s64.sum()
    p64 = s64 / tot64 if float(tot64) > 0 else torch.full_like(s64, 1.0 / n)
    cum64 = p64.cumsum(0)
    norm_rel = float(((s.double() - s64).abs()
                      / s64.clamp(min=2.0 ** -50)).max())
    v, truth = _draws(cum64, k, float(u))
    scan_dev = float((v_k5.double() - v).abs().max())
    coef_rel = float(((coef.double() * k * p64[sel] / counts[sel].double())
                      - 1.0).abs().max()) if m else 0.0
    dist = (v - v.round()).abs()
    dist = torch.minimum(dist, torch.cat([dist.new_full((1,), 1.0),
                                          dist[:-1]]))
    wrong = counts.double() != truth
    # the plain version (encoders._select_backward_points) on g's device,
    # its scan kept (torch.cumsum on the card need not repeat its bits)
    p_p, cum_p = (encoders._select_scan(g) if norms is None else
                  encoders._scan_norms(torch.from_numpy(s_ref).to(g.device)))
    plain_sel, plain_coef = encoders._select_from_scan(p_p, cum_p, u.to(
        g.device), k)
    plain_sel, plain_coef = plain_sel.to(cpu), plain_coef.to(cpu)
    v_p, counts_p = _draws(cum_p.to(cpu), k, u)
    counts_p = counts_p.long()
    plain_consistent = torch.equal(plain_sel,
                                   torch.nonzero(counts_p > 0).squeeze(1))
    plain_dev = float((v_p.double() - v).abs().max())
    differ = counts != counts_p
    same = torch.zeros(n, dtype=torch.bool)
    same[sel] = True
    same &= ~differ
    ck = torch.zeros(n, dtype=torch.float64)
    cp = torch.zeros(n, dtype=torch.float64)
    ck[sel] = coef.double()
    cp[plain_sel] = plain_coef.double()
    plain_coef_rel = float(((ck - cp).abs() / cp.clamp(min=1e-300))[same]
                           .max()) if bool(same.any()) else 0.0
    plain_coef_dev = float(((plain_coef.double() * k * p64[plain_sel]
                             / counts_p[plain_sel].double()) - 1.0)
                           .abs().max()) if plain_sel.numel() else 0.0
    return dict(
        norms_off=norms_off, scan_off=scan_off,
        chain_equal=chain_equal, counts_equal=counts_equal,
        selection_equal=selection_equal, norm_rel=norm_rel,
        scan_dev=scan_dev, coef_rel=coef_rel, compared=m,
        truth_off=int(wrong.sum()),
        truth_dist=float(dist[wrong].max()) if bool(wrong.any()) else 0.0,
        plain_off=int(differ.sum()), plain_dev=plain_dev,
        plain_consistent=plain_consistent,
        plain_unexplained=int((differ & (dist > max(scan_dev, plain_dev)
                                         + _F64_SLACK)).sum()),
        plain_coef_rel=plain_coef_rel, plain_compared=int(same.sum()),
        plain_coef_dev=plain_coef_dev)


def selection_failures(check, n, k, dim):
    """The failed conditions of a check_selection result for n points of
    width dim and k draws, each with its numbers; empty when K5 holds."""
    norm, _ = _select_roundings(n, dim)
    scan_bound = select_scan_bound(n, k, dim)
    coef_bound = select_coef_bound(n, dim)
    c = check
    conditions = [
        (f'norms bit-equal to K5\'s order ({c["norms_off"]} off)',
         c['norms_off'] == 0),
        (f'scans bit-equal to K5\'s order ({c["scan_off"]} off)',
         c['scan_off'] == 0),
        ('the tiles\' chain gives the total', c['chain_equal']),
        ('counts are the floors of K5\'s own cum', c['counts_equal']),
        ('sel and coef are the compaction of the counts',
         c['selection_equal']),
        (f'norms within {norm} roundings of float64 '
         f'({c["norm_rel"]:.3e})', c['norm_rel'] <= norm * 2.0 ** -24),
        (f'scan within {scan_bound:.3e} counts of float64 '
         f'({c["scan_dev"]:.3e})', c['scan_dev'] <= scan_bound),
        (f'coefs within {coef_bound:.3e} of float64 on {c["compared"]} '
         f'points ({c["coef_rel"]:.3e})',
         c['compared'] > 0 and c['coef_rel'] <= coef_bound),
        (f'counts off float64 only within the scan\'s deviation '
         f'({c["truth_dist"]:.3e})',
         c['truth_dist'] <= c['scan_dev'] + _F64_SLACK),
        ('the plain version\'s selection is its counts\' compaction',
         c['plain_consistent']),
        (f'{c["plain_off"]} counts off the plain version\'s, '
         f'{c["plain_unexplained"]} unexplained',
         c['plain_unexplained'] == 0),
        (f'coefs within {coef_bound:.3e} + {c["plain_coef_dev"]:.3e} of the '
         f'plain version\'s on {c["plain_compared"]} points '
         f'({c["plain_coef_rel"]:.3e})',
         c['plain_compared'] > 0 and c['plain_coef_rel']
         <= coef_bound + c['plain_coef_dev'])]
    return [text for text, ok in conditions if not ok]


class _SimplexEncode(torch.autograd.Function):
    """The exact simplex encode while autograd records: K1s (fp32 out, the
    atoms written for the backward), K2s with every level at its 4 rows
    as the table gradient."""

    @staticmethod
    def forward(ctx, table, x, config):
        out, idx, w = _atoms_call(table.detach(), x, config, 'simplex',
                                  torch.float32, True)
        ctx.config = config
        ctx.save_for_backward(idx, w, table, x)
        return out

    @staticmethod
    def backward(ctx, g):
        idx, w, table, x = ctx.saved_tensors
        c = ctx.config
        dtable = dx = None
        if ctx.needs_input_grad[0]:
            dtable = _sampled_scatter_call(g.contiguous(), idx, w, None,
                                           (4,) * c.n_levels, c, None, None,
                                           None)
        if ctx.needs_input_grad[1]:
            dx = point_grad(g, table, x, c, 'simplex',
                            ((encoders.EXACT, 4),) * c.n_levels,
                            idx.view(-1, idx.shape[2]))
        return dtable, dx, None


class _SampledEncode(torch.autograd.Function):
    """Exact forward / sampled backward (JAX encoders._encode_sampled_bwd):
    K1s writes the atoms and the bf16 encode; the backward runs K5 when
    the points are subsampled (over the global batch of a device mesh),
    then K2s. The x and u cotangents are zero."""

    @staticmethod
    def forward(ctx, table, x, u, config, interp, rows, point_frac, mesh):
        out, idx, w = _atoms_call(table, x, config, interp, torch.bfloat16,
                                  True)
        ctx.save_for_backward(idx, w, u)
        ctx.args = (config, rows, point_frac, mesh)
        return out

    @staticmethod
    def backward(ctx, g):
        dtable = None
        if ctx.needs_input_grad[0]:
            idx, w, u = ctx.saved_tensors
            config, rows, point_frac, mesh = ctx.args
            g = g.contiguous()
            k = encoders.backward_subsample(
                idx.shape[2] * parallel.axis_size(mesh, parallel.DATA),
                point_frac)
            sel = coef = count = None
            if k is not None:
                sel, coef, count = (
                    _select_call(g, u, k) if mesh is None
                    else _select_global_call(g, u, k, mesh))
            dtable = _sampled_scatter_call(g, idx, w, u, rows, config, sel,
                                           coef, count)
        return dtable, None, None, None, None, None, None, None


# -- K6, K7: the stochastic-corner and residual encodes ---------------------

def _plan_arrays(plan):
    """The plan's per-level kinds and rows as the C libraries take them."""
    levels = len(plan)
    return ((ctypes.c_int * levels)(*[k for k, _ in plan]),
            (ctypes.c_int * levels)(*[r for _, r in plan]))


def _weighted_rows(plan):
    """SW: the rows of the plan's RESIDUAL and EXACT levels, whose weights
    K6 stores for K7."""
    return sum(r for k, r in plan if k != encoders.DRAWS)


def _stochastic_call(table, x, u, config, interp, n_samples, plan, rows,
                     parts='all', group=0):
    """K6: the stochastic or residual encode of x (fp32 out) and, with
    `rows`, the drawn rows as (S, N) int32 indices and the weighted rows'
    (SW, N) fp32 weights (encoders.stochastic_rows' format). `parts` other
    than 'all' runs one part of the work alone (K6_PARTS: the draws with
    their rows written, the gathers and blend, or the stores) for timing
    it; `group` sets the levels a narrow-rows thread walks (0: the
    library's choice)."""
    _check_inputs(STOCHASTIC_NAME, x, config, table, _table_shape(config))
    dev = x.device
    if u.device != dev or u.dtype != torch.float32 or not u.is_contiguous():
        raise ValueError(f'{STOCHASTIC_NAME}: u must be contiguous float32 '
                         'on the device of x')
    n, s = x.shape[0], sum(r for _, r in plan)
    out = torch.empty((n, config.out_dim), dtype=torch.float32, device=dev)
    idx = w = None
    if rows:
        idx = torch.empty((s, n), dtype=torch.int32, device=dev)
        w = torch.empty((_weighted_rows(plan), n), dtype=torch.float32,
                        device=dev)
    fn = _kernels.library(_STOCHASTIC_SOURCE).hashgrid_stochastic_fwd
    fn.argtypes = ([ctypes.c_void_p] * 14
                   + [ctypes.c_float, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    kinds, counts = _plan_arrays(plan)
    status = fn(x.data_ptr(), table.data_ptr(), u.data_ptr(), out.data_ptr(),
                idx.data_ptr() if rows else None,
                w.data_ptr() if rows and w.numel() else None,
                *[a.ctypes.data for a in _geometry(config)], kinds, counts,
                float(config.pos_offset), n, config.n_levels,
                config.table_size, config.n_features, _atom_count(interp),
                n_samples, K6_PARTS[parts], group,
                torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(status, STOCHASTIC_NAME)
    _kernels.launches[STOCHASTIC_NAME] += 1
    return out, idx, w


def _stochastic_scatter_call(g, idx, w, plan, config, n_samples, level=None,
                             dtable=None):
    """K7: the table gradient (L, T, F) fp32 from K6's rows, for the
    encode's fp32 cotangent g. With `level`, that level's scatter alone,
    added into `dtable` (not zeroed), for timing a level's atomics."""
    dev = g.device
    n = idx.shape[1]
    if dev.type != 'cuda' or idx.device != dev or w.device != dev \
            or idx.dtype != torch.int32 or w.dtype != torch.float32 \
            or tuple(idx.shape) != (sum(r for _, r in plan), n) \
            or tuple(w.shape) != (_weighted_rows(plan), n) \
            or not idx.is_contiguous() or not w.is_contiguous() \
            or len(plan) != config.n_levels:
        raise ValueError(f'{STOCHASTIC_BWD_NAME}: the rows must be (S, N) '
                         'contiguous int32 indices and (SW, N) fp32 weights '
                         'on the card, S the plan\'s rows and SW its '
                         'weighted ones')
    if g.dtype != torch.float32 or tuple(g.shape) != (n, config.out_dim) \
            or not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError(f'{STOCHASTIC_BWD_NAME}: g must be a contiguous, '
                         f'16-byte aligned ({n}, {config.out_dim}) float32 '
                         'tensor')
    if (level is None) != (dtable is None):
        raise ValueError(f'{STOCHASTIC_BWD_NAME}: a level alone adds into a '
                         'given dtable')
    if dtable is None:
        dtable = torch.empty(_table_shape(config), dtype=torch.float32,
                             device=dev)
    fn = _kernels.library(_STOCHASTIC_BWD_SOURCE).hashgrid_stochastic_bwd
    fn.argtypes = ([ctypes.c_void_p] * 6
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    kinds, counts = _plan_arrays(plan)
    status = fn(g.data_ptr(), idx.data_ptr(),
                w.data_ptr() if w.numel() else None, kinds, counts,
                dtable.data_ptr(), n,
                config.n_levels, config.table_size, config.n_features,
                n_samples, -1 if level is None else level,
                torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(status, STOCHASTIC_BWD_NAME)
    _kernels.launches[STOCHASTIC_BWD_NAME] += 1
    return dtable


def stochastic_encode_plain(table, x, u, config, interp, n_samples, plan):
    """The plain version of K6, on any device: (out, idx, w), the encode
    and its rows (encoders.stochastic_rows, blend_drawn_rows)."""
    idx, w = encoders.stochastic_rows(x, config, u, plan, interp, n_samples)
    return (encoders.blend_drawn_rows(table, idx, w, plan, n_samples), idx,
            w)


def stochastic_backward_tolerance(g, idx, w, plan, config, n_samples):
    """Per element of the stochastic table gradient, how far two fp32 sums of
    its terms in different orders can lie apart (as backward_tolerance):
    2 k 2^-24 times the sum of the terms' magnitudes, k the terms of the
    element's row."""
    terms = torch.zeros((config.n_levels, config.table_size),
                        dtype=torch.float32, device=g.device)
    start = 0
    for l, (_, count) in enumerate(plan):
        for r in range(count):
            row = idx[start + r].long()
            terms[l].index_add_(0, row, torch.ones_like(row,
                                                        dtype=torch.float32))
        start += count
    magnitude = encoders.stochastic_scatter_plain(g.float().abs(), idx,
                                                  w.abs(), plan, config,
                                                  n_samples)
    return 2.0 * terms[..., None] * 2.0 ** -24 * magnitude


def _ulps(v, b):
    """|v - b| in units of b's fp32 spacing."""
    spacing = (torch.nextafter(b, torch.full_like(b, float('inf'))) - b)
    return (v - b).abs() / spacing.clamp(min=2.0 ** -149)


def draw_margins(x, config, u, plan, interp='trilinear', n_samples=1):
    """For each drawn row (S, N): how many fp32 ulps the value its draw
    compares lies from the nearest boundary it is compared with (the
    fraction of each axis, the simplex partial sums, the residual's
    renormalized sums; the runner-up weight for the residual's max-weight
    atom); inf on EXACT rows, which draw nothing. A kernel whose geometry
    or sums differed from the plain version's by an ulp could flip a draw
    only where this is at most 1."""
    geometry = encoders._grid_geometry(x, config)
    frac = geometry[1]
    out = []
    for l, (kind, count) in enumerate(plan):
        if kind == encoders.EXACT:
            out += [torch.full_like(frac[0, l], float('inf'))] * count
            continue
        if kind == encoders.RESIDUAL:
            _, w = encoders._level_atoms(*geometry, l, interp)
            top2 = w.topk(2, dim=0).values
            out.append(_ulps(top2[1], top2[0]))
            m = w.argmax(dim=0)
            wr = torch.where(torch.arange(w.shape[0], device=w.device)[:, None]
                             == m[None], torch.zeros_like(w), w)
            cum = encoders._atom_cumsum(wr)
            cum = cum[:-1] / torch.clamp(cum[-1], min=1e-12)
            out.append(_ulps(u[l][None], cum).amin(dim=0))
            continue
        if interp == 'simplex':
            _, w = encoders._simplex_corners(frac[:, l])
            bounds = encoders._atom_cumsum(w[:3])
        else:
            bounds = frac[:, l]
        for r in range(count):
            s, flip = encoders._draw_set(r, n_samples)
            v = u[s, l] if interp == 'simplex' else u[s, :, l]
            v = 1.0 - v if flip else v
            out.append(_ulps(v[None] if interp == 'simplex' else v,
                             bounds).amin(dim=0))
    return torch.stack(out)


def check_stochastic(table, x, u, config, interp, n_samples, plan, g):
    """Hold K6 (training form) and K7 against their plain versions on one
    input: (failures, details), the failures empty when both hold.

    - K6's rows: indices equal to the plain version's, except where a draw
      lies within 1 ulp of a boundary it is compared with (draw_margins):
      such flips are counted (`flips`) and any other is a failure
      (`unexplained`); the weighted rows' weights bit-equal where their
      indices agree;
    - K6's encode bit-equal to the plain version's on every point none of
      whose rows flipped, and its eval form (no rows written) bit-equal to
      its training form;
    - K7, fed K6's rows and the cotangent g, within
      stochastic_backward_tolerance of the plain scatter of the same rows
      (`k7_used`: the worst element's share of its tolerance)."""
    out, idx, w = _stochastic_call(table, x, u, config, interp, n_samples,
                                   plan, True)
    want, want_idx, want_w = stochastic_encode_plain(table, x, u, config,
                                                     interp, n_samples, plan)
    differ = idx != want_idx
    flips = int(differ.sum())
    unexplained = 0
    if flips:
        margins = draw_margins(x, config, u, plan, interp, n_samples)
        unexplained = int((differ & (margins > 1.0)).sum())
    same_points = ~differ.any(dim=0)
    out_equal = torch.equal(out[same_points], want[same_points])
    k6_err = float((out[same_points] - want[same_points]).abs().max()) \
        if bool(same_points.any()) else 0.0
    weighted = [first + r for _, rows, first, wfirst
                in encoders.plan_starts(plan) if wfirst is not None
                for r in range(rows)]
    agree = ~differ[weighted]
    w_equal = torch.equal(w[agree], want_w[agree])
    eval_equal = torch.equal(_stochastic_call(
        table, x, u, config, interp, n_samples, plan, False)[0], out)
    del want, want_idx, want_w
    got = _stochastic_scatter_call(g, idx, w, plan, config, n_samples)
    ref = encoders.stochastic_scatter_plain(g, idx, w, plan, config,
                                            n_samples)
    tol = stochastic_backward_tolerance(g, idx, w, plan, config, n_samples)
    err = (got - ref).abs()
    k7_ok = bool((err <= tol).all())
    k7_used = float((err / tol.clamp(min=1e-38)).max())
    details = dict(flips=flips, unexplained=unexplained, out_equal=out_equal,
                   k6_max_abs_err=k6_err,
                   w_equal=w_equal, eval_equal=eval_equal,
                   k7_max_abs_err=float(err.max()), k7_used=k7_used,
                   out=out, idx=idx, w=w)
    conditions = [
        (f'{unexplained} of {flips} index flips not within 1 ulp of a '
         'boundary', unexplained == 0),
        ('weights bit-equal on the rows that agree', w_equal),
        ('the encode bit-equal on the points without flips', out_equal),
        ('the eval form bit-equal to the training form', eval_equal),
        (f'K7 within its term-count tolerance (worst uses {k7_used:.3f})',
         k7_ok)]
    return [text for text, ok in conditions if not ok], details


def stochastic_launch_shapes(config, n, plan, interp='trilinear',
                             n_samples=1):
    """K6's and K7's launch shapes for n points and this plan, as the C
    libraries plan them: blocks, threads, shared bytes, blocks per SM,
    registers and points (a warp's for K6's wide kernel, 1 for its narrow
    one; a block's for K7), K6's levels a narrow thread walks, each kernel
    named as the library picks it (wide or narrow rows)."""
    keys = ('blocks', 'threads', 'smem_bytes', 'blocks_per_sm', 'registers',
            'points', 'wide', 'levels_a_thread')
    kinds, counts = _plan_arrays(plan)
    fn = _kernels.library(_STOCHASTIC_SOURCE).hashgrid_stochastic_shape
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 8)()
    _kernels.check(fn(kinds, counts, config.n_levels, config.n_features, n,
                      _atom_count(interp), n_samples, out), STOCHASTIC_NAME)
    shape = dict(zip(keys, out))
    shapes = {'K6 stochastic_rows_kernel' if shape.pop('wide') else
              'K6 stochastic_lanes_kernel': shape}
    fn = _kernels.library(_STOCHASTIC_BWD_SOURCE) \
        .hashgrid_stochastic_bwd_shape
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 7)()
    _kernels.check(fn(config.n_levels, config.n_features, n, out),
                   STOCHASTIC_BWD_NAME)
    shapes['K7 stochastic_scatter_rows_kernel' if out[6] else
           'K7 stochastic_scatter_lanes_kernel'] = dict(zip(keys[:6], out))
    return shapes


class _StochasticEncode(torch.autograd.Function):
    """The stochastic or residual encode while autograd records: K6 (fp32
    out, the drawn rows written for the backward), K7 as the table
    gradient."""

    @staticmethod
    def forward(ctx, table, x, u, config, interp, n_samples, plan):
        out, idx, w = _stochastic_call(table.detach(), x, u, config, interp,
                                       n_samples, plan, True)
        ctx.save_for_backward(idx, w, table, x)
        ctx.args = (plan, config, interp, n_samples)
        return out

    @staticmethod
    def backward(ctx, g):
        idx, w, table, x = ctx.saved_tensors
        plan, config, interp, n_samples = ctx.args
        dtable = dx = None
        if ctx.needs_input_grad[0]:
            dtable = _stochastic_scatter_call(g.float().contiguous(), idx, w,
                                              plan, config, n_samples)
        if ctx.needs_input_grad[1]:
            dx = point_grad(g, table, x, config, interp, plan, idx)
        return dtable, dx, None, None, None, None, None


def _records(table, x):
    """Whether autograd records the encode: the table's gradient (training)
    or the points' (registration, with the table frozen) is wanted."""
    return torch.is_grad_enabled() and (table.requires_grad
                                        or x.requires_grad)


def hashgrid_encode(table, x, config, interp='trilinear', u=None,
                    sampled_backward=0, backward_points=1.0, n_samples=1,
                    exact_levels=0, residual=False, mesh=None):
    """Encode (N, 3) points in [0, 1] -> (N, L * F): the plain versions on
    the CPU, the CUDA kernels on the card, whatever the field's grid_impl.

    With sampled_backward and u (the uniforms, (L, N) or (L, N + 1)) the
    exact-forward / sampled-backward encode (K1s, K5, K2s; bf16 out on the
    card); with u alone the stochastic-corner or (residual) residual encode
    (K6, K7; u of encoders.uniform_shape, fp32 out); otherwise the exact
    simplex (K1s, K2s) or trilinear (K1, K2) interpolation, fp32.

    mesh: a device mesh (parallel.py) when table and config are this rank's
    feature slice of the grid and x its rows of the global batch: the
    sampled backward's subsample is then the global batch's.
    """
    if x.device.type == 'cpu' and table.device.type == 'cpu':
        return hashgrid_encode_plain(table, x, config, interp=interp, u=u,
                                     sampled_backward=sampled_backward,
                                     backward_points=backward_points,
                                     n_samples=n_samples,
                                     exact_levels=exact_levels,
                                     residual=residual, mesh=mesh)
    whole = config.n_features * parallel.axis_size(mesh, parallel.MODEL)
    if sampled_backward and u is not None:
        rows, pf = encoders.sampled_rows(config, interp, sampled_backward,
                                         backward_points, whole)
        encoders.check_uniforms(u, encoders.uniform_shape(
            config.n_levels, x.shape[0], sampled_backward=sampled_backward,
            backward_points=pf))
        return _SampledEncode.apply(table, x, u.contiguous(), config, interp,
                                    rows, pf, mesh)
    if u is not None:
        plan = encoders.stochastic_plan(config, interp, n_samples,
                                        exact_levels, residual)
        encoders.check_uniforms(u, encoders.uniform_shape(
            config.n_levels, x.shape[0], interp, n_samples, residual))
        if _records(table, x):
            return _StochasticEncode.apply(table, x, u.contiguous(), config,
                                           interp, n_samples, plan)
        return _stochastic_call(table.detach(), x, u.contiguous(), config,
                                interp, n_samples, plan, False)[0]
    if interp == 'simplex':
        if whole % 8:
            raise NotImplementedError(
                "simplex interpolation is implemented for the wide-row "
                "(TPU_GRID-shaped) layout only")
        if _records(table, x):
            return _SimplexEncode.apply(table, x, config)
        # serving: K1s without atoms
        return _atoms_call(table.detach(), x, config, 'simplex',
                           torch.float32, False)[0]
    return _Encode.apply(table, x, config)
