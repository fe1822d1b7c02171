"""Input encodings: frequency, spherical harmonics, multiresolution hash grid.

Counterpart of autolabel_tpu/ops/encoders.py, exact paths only. The exact
trilinear encode here (_encode_rows for wide rows, _encode_lanes for
narrow ones) is the plain PyTorch version of the CUDA hash-grid kernel
(ops/hashgrid_cuda.py). The simplex, stochastic, residual and
sampled-backward modes of the JAX package are training-slice work and
raise NotImplementedError.
"""
import dataclasses
import math

import numpy as np
import torch

# instant-ngp spatial hashing primes (identity on x).
_PRIMES = (1, 2654435761, 805459861)

# Corner offsets of the trilinear interpolation cell, shape (8, 3), in the
# JAX package's meshgrid('ij') order: corner c = (c>>2 & 1, c>>1 & 1, c & 1).
_CORNERS = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1],
                                indexing='ij')).reshape(3, 8).T


def frequency_encode(x, n_frequencies):
    """NeRF positional encoding: (..., D) -> (..., D * n_frequencies * 2).

    Columns ordered [d0: sin f0..fF-1, cos f0..fF-1, d1: ...], with
    cos(t) computed as sin(t + pi/2), the JAX package's formulation.
    """
    d = x.shape[-1]
    freqs = (2.0 ** np.arange(n_frequencies, dtype=np.float64)) * np.pi
    col_dim = torch.as_tensor(np.repeat(np.arange(d), 2 * n_frequencies),
                              device=x.device)
    col_freq = torch.as_tensor(np.tile(np.concatenate([freqs, freqs]), d),
                               dtype=torch.float32, device=x.device)
    col_phase = torch.as_tensor(
        np.tile(np.concatenate([np.zeros(n_frequencies),
                                np.full(n_frequencies, np.pi / 2.0)]), d),
        dtype=torch.float32, device=x.device)
    return torch.sin(x[..., col_dim] * col_freq + col_phase)


def sh_encode(d):
    """Real spherical harmonics up to degree 4: (..., 3) -> (..., 16)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    out = [
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy,
        -1.0925484305920792 * yz,
        0.94617469575755997 * zz - 0.31539156525251999,
        -1.0925484305920792 * xz,
        0.54627421529603959 * (xx - yy),
        0.59004358992664352 * y * (-3.0 * xx + yy),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz),
        0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz),
        1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (-xx + 3.0 * yy),
    ]
    return torch.stack(out, dim=-1)


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    """Multiresolution hash grid hyperparameters (instant-ngp layout).

    variant selects the lattice/indexing convention, as in the JAX
    package: 'native' (pos = x * N_l, dense stride N_l + 1, every level
    hashed modulo the full table), 'tcnn' (tiny-cuda-nn grid.h) and
    'torch_ngp' (torch-ngp gridencoder, align_corners=False). All share
    the coherent prime hash (1, 2654435761, 805459861).
    """
    n_levels: int = 16
    n_features: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 2.0
    variant: str = 'native'

    @classmethod
    def from_desired_resolution(cls, desired_resolution, **kwargs):
        """torch-ngp get_encoder semantics: solve per-level scale so the
        finest level reaches desired_resolution."""
        base = kwargs.get('base_resolution', 16)
        n_levels = kwargs.get('n_levels', 16)
        scale = math.exp(
            math.log(desired_resolution / base) / (n_levels - 1))
        return cls(per_level_scale=scale, **kwargs)

    @property
    def table_size(self):
        return 1 << self.log2_hashmap_size

    @property
    def resolutions(self):
        if self.variant == 'native':
            return tuple(
                int(math.floor(self.base_resolution
                               * self.per_level_scale ** l))
                for l in range(self.n_levels))
        return tuple(
            int(math.ceil(self.base_resolution * self.per_level_scale ** l
                          - 1.0)) + 1
            for l in range(self.n_levels))

    @property
    def scales(self):
        """Per-level position scale: pos = x * scale + pos_offset."""
        if self.variant == 'native':
            return tuple(float(r) for r in self.resolutions)
        return tuple(
            self.base_resolution * self.per_level_scale ** l - 1.0
            for l in range(self.n_levels))

    @property
    def pos_offset(self):
        return 0.0 if self.variant == 'native' else 0.5

    @property
    def dense_strides(self):
        if self.variant == 'tcnn':
            return self.resolutions
        return tuple(r + 1 for r in self.resolutions)

    @property
    def level_sizes(self):
        """Entries per level (hash modulus)."""
        if self.variant == 'native':
            return (self.table_size,) * self.n_levels
        return tuple(
            (min(s ** 3, self.table_size) + 7) // 8 * 8
            for s in self.dense_strides)

    @property
    def out_dim(self):
        return self.n_levels * self.n_features


# The JAX package's default wide-row grid: 4 levels x 128 features x 2^15
# rows (the same 16.7M parameters as the reference's 16 x 2 x 2^19).
TPU_GRID = HashGridConfig(n_levels=4,
                          n_features=128,
                          log2_hashmap_size=15,
                          base_resolution=16,
                          per_level_scale=5.04)


def hashgrid_init(generator, config, dtype=torch.float32):
    """Hash table (n_levels, table_size, n_features), U(-1e-4, 1e-4), drawn
    on the CPU from `generator`."""
    shape = (config.n_levels, config.table_size, config.n_features)
    t = torch.rand(shape, generator=generator, dtype=dtype)
    return t * 2e-4 - 1e-4


def level_geometry(config):
    """Per-level (scales fp32, dense strides, level sizes, use_dense) as
    numpy arrays — the arguments the CUDA kernel takes."""
    scales = np.asarray(config.scales, np.float32)
    strides = np.asarray(config.dense_strides, np.int64)
    sizes = np.asarray(config.level_sizes, np.int64)
    use_dense = (strides ** 3) <= sizes
    return scales, strides, sizes, use_dense


def _corner_index(cell, corner, stride, use_dense, level_size):
    """Table index of one interpolation-cell corner.

    cell: (3, ...) int64 cell coordinates; stride, use_dense, level_size
    broadcast against cell[0]. The hash is taken in uint32 with
    wraparound (`& 0xFFFFFFFF` on int64 products: XOR is bitwise, so
    masking after the XOR equals the uint32 result), then `% level_size`.
    Dense indices wrap modulo the level size too, as in the JAX package.
    """
    ox, oy, oz = corner
    cx = cell[0] + ox
    cy = cell[1] + oy
    cz = cell[2] + oz
    hashed = ((cx * _PRIMES[0]) ^ (cy * _PRIMES[1]) ^ (cz * _PRIMES[2])) \
        & 0xFFFFFFFF
    hashed = hashed % level_size
    dense = (cx + stride * (cy + stride * cz)) % level_size
    return torch.where(torch.as_tensor(use_dense, device=hashed.device),
                       dense, hashed)


def _corner_weight(frac, corner):
    ox, oy, oz = corner
    wx = frac[0] if ox else 1.0 - frac[0]
    wy = frac[1] if oy else 1.0 - frac[1]
    wz = frac[2] if oz else 1.0 - frac[2]
    return wx * wy * wz


def _grid_geometry(x, config):
    """Cell and fraction of every point on every level, (3, L, N), plus
    (L, 1) stride / use_dense / level-size tensors."""
    scales, strides, sizes, use_dense = level_geometry(config)
    dev = x.device
    scales = torch.as_tensor(scales, device=dev)
    pos = scales[None, :, None] * x.T[:, None, :] + config.pos_offset
    cell = torch.floor(pos)
    frac = pos - cell
    stride = torch.as_tensor(strides, device=dev)[:, None]
    size = torch.as_tensor(sizes, device=dev)[:, None]
    dense = torch.as_tensor(use_dense, device=dev)[:, None]
    return cell.to(torch.int64), frac, stride, dense, size


def _encode_rows(table, x, config):
    """Exact trilinear encode, wide rows (F a multiple of 8): per level, a
    row gather of each of the 8 corners, blended in corner order."""
    n = x.shape[0]
    cell, frac, stride, use_dense, size = _grid_geometry(x, config)
    outs = []
    for l in range(config.n_levels):
        acc = torch.zeros((n, config.n_features), dtype=table.dtype,
                          device=x.device)
        for corner in _CORNERS:
            idx = _corner_index(cell[:, l], corner, stride[l], use_dense[l],
                                size[l])
            weight = _corner_weight(frac[:, l], corner)
            acc = acc + table[l][idx] * weight[:, None]
        outs.append(acc)
    return torch.cat(outs, dim=-1)


def _encode_lanes(table, x, config):
    """Exact trilinear encode, narrow rows (e.g. the reference's F=2): all
    levels at once in an (L, F, N) layout, then (N, L*F)."""
    n = x.shape[0]
    cell, frac, stride, use_dense, size = _grid_geometry(x, config)
    level = torch.arange(config.n_levels, device=x.device)[:, None]
    out = torch.zeros((config.n_levels, config.n_features, n),
                      dtype=table.dtype, device=x.device)
    for corner in _CORNERS:
        idx = _corner_index(cell, corner, stride, use_dense, size)  # (L, N)
        weight = _corner_weight(frac, corner)  # (L, N)
        feats = table[level, idx]  # (L, N, F)
        out = out + feats.permute(0, 2, 1) * weight[:, None, :]
    return out.reshape(config.out_dim, n).T


def hashgrid_encode(table, x, config, key=None, n_samples=1, exact_levels=0,
                    interp='trilinear', residual=False, sampled_backward=0,
                    backward_points=1.0):
    """Encode (N, 3) points in [0, 1] -> (N, n_levels * n_features).

    The exact trilinear interpolation (key=None), as in
    autolabel_tpu/ops/encoders.hashgrid_encode, in plain PyTorch. The
    other modes belong to the training slice.
    """
    if key is not None or sampled_backward or residual:
        raise NotImplementedError(
            "stochastic, residual and sampled-backward encodes are not "
            "ported yet (training slice)")
    if interp != 'trilinear':
        raise NotImplementedError(
            f"{interp!r} interpolation is not ported yet")
    del n_samples, exact_levels, backward_points
    if config.n_features % 8 == 0:
        return _encode_rows(table, x, config)
    return _encode_lanes(table, x, config)
