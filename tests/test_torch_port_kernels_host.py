"""The host-side arithmetic of the port's kernels, on the CPU: the
hash-grid kernels' division-free corner index (per-level constants from
hashgrid_cuda.level_divisors, emulated in numpy as hashgrid_common.cuh
computes it), the distinct rows each of K1s's warps needs
(hashgrid_cuda.tile_rows, which its L2 gather floor reads) and the
distinct 32-byte sectors K1's gathers touch (hashgrid_cuda.gather_sectors,
K1 narrow's sector floor). No card needed."""
import numpy as np
import pytest
import torch

from autolabel_tpu_torch.ops import encoders
from autolabel_tpu_torch.ops.encoders import TPU_GRID, HashGridConfig
from autolabel_tpu_torch.ops.hashgrid_cuda import (gather_sectors,
                                                   level_divisors, tile_rows)

_M32 = np.uint64(0xFFFFFFFF)


def _level_mod(h, magic, shift, size):
    """hashgrid_common.cuh level_mod in uint64 numpy: h & (size - 1) where
    magic is 0, else q = (t + ((h - t) >> 1)) >> (shift - 1) with
    t = umulhi(h, magic), and h - q * size (all uint32 arithmetic)."""
    h = h.astype(np.uint64)
    if magic == 0:
        return h & np.uint64(size - 1)
    t = (h * np.uint64(magic)) >> np.uint64(32)
    q = ((t + ((h - t) >> np.uint64(1))) & _M32) >> np.uint64(shift - 1)
    return (h - q * np.uint64(size)) & _M32


def _dense_floor_mod(v, magic, shift, size):
    """hashgrid_common.cuh level_corner_index's dense branch for linear
    indices in (-2^32, 2^32): v mod size for v >= 0, else
    size - 1 - ((-v - 1) mod size)."""
    neg = v < 0
    u = np.where(neg, -v - 1, v).astype(np.uint64)
    r = _level_mod(u, magic, shift, size).astype(np.int64)
    return np.where(neg, size - 1 - r, r)


def _sweep(rng, size):
    """uint32 values: random, the ends, and multiples of size and their
    neighbours."""
    k = np.arange(0, 4096, dtype=np.uint64) * np.uint64(size)
    edges = np.array([0, 1, 2, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 2,
                      2 ** 32 - 1], np.uint64)
    return np.concatenate([
        rng.integers(0, 2 ** 32, 100000, dtype=np.uint64), edges,
        k & _M32, (k + np.uint64(1)) & _M32, (k - np.uint64(1)) & _M32])


CONFIGS = {
    'tpu_grid': TPU_GRID,
    'reference': HashGridConfig(),
    'native_small': HashGridConfig(n_levels=4, log2_hashmap_size=12,
                                   base_resolution=8, per_level_scale=1.6),
    'tcnn': HashGridConfig(variant='tcnn'),
    'torch_ngp': HashGridConfig(variant='torch_ngp'),
    'tcnn_small': HashGridConfig(n_levels=4, log2_hashmap_size=12,
                                 base_resolution=8, per_level_scale=1.6,
                                 variant='tcnn'),
    'torch_ngp_small': HashGridConfig(n_levels=4, log2_hashmap_size=12,
                                      base_resolution=8, per_level_scale=1.6,
                                      variant='torch_ngp'),
}


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_level_modulo_equals_remainder(name):
    """The kernel's modulo equals % for every level of the configuration
    over a sweep of uint32 values."""
    config = CONFIGS[name]
    magic, shift = level_divisors(config.level_sizes)
    rng = np.random.default_rng(0)
    for size, m, s in zip(config.level_sizes, magic, shift):
        h = _sweep(rng, size)
        np.testing.assert_array_equal(_level_mod(h, int(m), int(s), size),
                                      h % np.uint64(size))


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_dense_floor_mod_equals_python_modulo(name):
    """The dense index's 32-bit floor-mod equals Python's floor-mod for
    linear indices on both sides of 0 (points outside [0, 1])."""
    config = CONFIGS[name]
    magic, shift = level_divisors(config.level_sizes)
    rng = np.random.default_rng(1)
    for size, m, s in zip(config.level_sizes, magic, shift):
        v = np.concatenate([
            rng.integers(-2 ** 32 + 1, 2 ** 32, 50000, dtype=np.int64),
            np.arange(-3 * size, 3 * size, max(1, size // 512)),
            np.array([-2 ** 32 + 1, -1, 0, 2 ** 32 - 1], np.int64)])
        np.testing.assert_array_equal(
            _dense_floor_mod(v, int(m), int(s), size), np.mod(v, size))


def test_level_divisors_mask_powers_of_two():
    """magic is 0 (a mask) exactly where the size is a power of two, and
    shift is ceil(log2 size); the multiplier fits in 32 bits."""
    sizes = [1, 2, 3, 8, 736, 4096, 4920, 35944, 2 ** 19, 2 ** 31 - 1]
    magic, shift = level_divisors(sizes)
    for size, m, s in zip(sizes, magic, shift):
        assert (m == 0) == (size & (size - 1) == 0)
        assert 2 ** int(s) >= size > 2 ** (int(s) - 1) or size == 1
        assert 0 <= int(m) < 2 ** 32


@pytest.mark.parametrize('size', [0, 2 ** 31])
def test_level_divisors_refuse_sizes_outside_the_kernel(size):
    with pytest.raises(ValueError):
        level_divisors([size])


def _level_corner_index(c, stride, size, dense, magic, shift):
    """hashgrid_common.cuh level_corner_index for int32 corner coordinates
    c (3, M): the uint32 hash through level_mod, or the dense floor-mod in
    32 bits inside (-2^32, 2^32) and in int64 outside."""
    cx, cy, cz = c
    if dense:
        v = cx + stride * (cy + stride * cz)
        small = (v > -2 ** 32) & (v < 2 ** 32)
        r = _dense_floor_mod(np.where(small, v, 0), magic, shift, size)
        return np.where(small, r, np.mod(v, size))
    u = [a.astype(np.uint32) for a in (cx, cy, cz)]
    h = u[0] ^ u[1] * np.uint32(2654435761) ^ u[2] * np.uint32(805459861)
    return _level_mod(h, magic, shift, size).astype(np.int64)


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_level_corner_index_matches_plain(name):
    """The kernels' corner index (the encode's and the backward's) equals
    the plain version's for every level and corner, on cells of points in
    and near [0, 1] and far outside it (dense linear indices beyond 2^32:
    the int64 branch)."""
    config = CONFIGS[name]
    _, strides, sizes, use_dense = encoders.level_geometry(config)
    magic, shift = level_divisors(sizes)
    rng = np.random.default_rng(2)
    for l, res in enumerate(strides):
        cell = np.concatenate([
            rng.integers(-2, int(res) + 2, (3, 2000)),
            rng.integers(-2 ** 24, 2 ** 24, (3, 2000))], axis=1)
        for corner in np.ndindex(2, 2, 2):
            c = cell + np.asarray(corner)[:, None]
            got = _level_corner_index(c, int(strides[l]), int(sizes[l]),
                                      bool(use_dense[l]), int(magic[l]),
                                      int(shift[l]))
            want = encoders._corner_index(
                torch.from_numpy(cell), corner, int(strides[l]),
                bool(use_dense[l]), int(sizes[l])).numpy()
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('n,points,atoms', [
    (1, 16, 4), (15, 16, 4), (16, 16, 4), (17, 16, 4), (35, 16, 4),
    (100, 8, 8), (64, 64, 4), (7, 1, 8)])
def test_tile_rows_lists_each_tiles_distinct_rows(n, points, atoms):
    """tile_rows against sets: per level the sum over tiles of the
    distinct rows among the tile's points' atoms (the last tile holds what
    is left), and the list, tile by tile with levels slowest, holding
    exactly each tile's set, offset by the level's first row."""
    rng = np.random.default_rng(n + points)
    levels, table_size = 3, 50
    idx = torch.from_numpy(rng.integers(0, 12, (levels, atoms, n)).astype(
        np.int32))
    counts, rows = tile_rows(idx, points, table_size)
    assert rows.dtype == torch.int64
    at = 0
    for l in range(levels):
        want = 0
        for p0 in range(0, n, points):
            tile = set(idx[l, :, p0:p0 + points].flatten().tolist())
            got = rows[at:at + len(tile)].tolist()
            assert sorted(got) == sorted(r + l * table_size for r in tile)
            at += len(tile)
            want += len(tile)
        assert counts[l] == want
    assert at == rows.numel()



def _sectors_by_hand(x, config, points, sector=32):
    """gather_sectors counted in numpy, point by point: each point's cell
    per level (pos = scale * x + offset in fp32, rounded per operation),
    its 8 corners' rows by the kernel's index arithmetic, the byte range
    of each row in the (L, T, F) fp32 table and every sector it overlaps,
    collected into a set per tile (the launch where points is None)."""
    scales, strides, sizes, use_dense = encoders.level_geometry(config)
    magic, shift = level_divisors(sizes)
    row = config.n_features * 4
    n = x.shape[0]
    tile = n if points is None else points
    counts = []
    for l in range(config.n_levels):
        pos = np.float32(scales[l]) * x + np.float32(config.pos_offset)
        cell = np.floor(pos).astype(np.int64).T  # (3, N)
        total = 0
        for p0 in range(0, n, tile):
            seen = set()
            for p in range(p0, min(p0 + tile, n)):
                for corner in np.ndindex(2, 2, 2):
                    c = cell[:, p:p + 1] + np.asarray(corner)[:, None]
                    r = int(_level_corner_index(
                        c, int(strides[l]), int(sizes[l]),
                        bool(use_dense[l]), int(magic[l]),
                        int(shift[l]))[0])
                    first = (l * config.table_size + r) * row
                    seen.update(range(first // sector,
                                      (first + row - 1) // sector + 1))
            total += len(seen)
        counts.append(total)
    return counts


@pytest.mark.parametrize('variant', ['native', 'tcnn', 'torch_ngp'])
@pytest.mark.parametrize('features', [1, 2, 3, 8])
@pytest.mark.parametrize('n,points', [(1, None), (40, None), (40, 32),
                                      (33, 5), (100, 1)])
def test_gather_sectors_counts_each_tiles_distinct_sectors(variant, features,
                                                           n, points):
    """gather_sectors against sets of sectors: per level, the distinct
    32-byte sectors of the points' corner rows over the launch or summed
    over tiles (the last tile holds what is left); 12-byte rows (F = 3)
    that straddle a sector boundary count both sectors. Points in and
    outside [0, 1] (negative dense indices)."""
    rng = np.random.default_rng(n * 10 + features)
    config = HashGridConfig(n_levels=3, n_features=features,
                            log2_hashmap_size=9, base_resolution=4,
                            per_level_scale=2.0, variant=variant)
    x = rng.uniform(-0.05, 1.05, (n, 3)).astype(np.float32)
    got = gather_sectors(torch.from_numpy(x), config, points)
    assert got == _sectors_by_hand(x, config, points)
    if points is None:
        assert all(0 < c <= 8 * n * 2 for c in got)
