"""Input encodings: frequency, spherical harmonics, multiresolution hash grid.

Counterpart of autolabel_tpu/ops/encoders.py. Here are the plain PyTorch
versions of the CUDA hash-grid kernels (ops/hashgrid_cuda.py), on any
device: the exact trilinear encode (_encode_rows for wide rows,
_encode_lanes for narrow ones) and its table gradient
(hashgrid_encode_backward_plain); the exact simplex encode
(_encode_rows_simplex); the flagship's exact-forward / sampled-backward
encode: the interpolation atoms (_corner_idx_weights), the gather from
them (_gather_from_atoms), the point subsample (_select_backward_points)
and the sampled scatter (sampled_scatter_plain); and the stochastic-corner
and residual encodes (JAX's _encode_stochastic,
_encode_stochastic_simplex and _encode_residual): the rows they draw
(stochastic_rows), the blend of those rows (blend_drawn_rows) and its
table gradient (stochastic_scatter_plain); and the gradient of every one
of these encodes for the points (hashgrid_encode_point_grad_plain, with
its rounding bound point_grad_tolerance). The JAX package draws its
uniforms from a PRNG key; here every estimator takes them as a tensor
`u`, of the shape uniform_shape gives.
"""
import dataclasses
import math

import numpy as np
import torch

from autolabel_tpu_torch.ops.mlp import default_compute_dtype

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


def hashgrid_encode_backward_plain(g, x, config):
    """The exact table gradient of the trilinear encode: the plain version
    of the CUDA backward scatter (ops/hashgrid_cuda.py). g: (N, L * F)
    cotangent of the encode, x: (N, 3). Per level and corner, one
    index_add_ of g * w_corner into the corner's rows, with the forward's
    cells, fractions and corner indices. Returns (L, T, F) fp32."""
    cell, frac, stride, use_dense, size = _grid_geometry(x, config)
    f = config.n_features
    out = torch.zeros((config.n_levels, config.table_size, f),
                      dtype=torch.float32, device=x.device)
    for l in range(config.n_levels):
        gl = g[:, l * f:(l + 1) * f].float()
        for corner in _CORNERS:
            idx = _corner_index(cell[:, l], corner, stride[l], use_dense[l],
                                size[l])
            weight = _corner_weight(frac[:, l], corner)
            out[l].index_add_(0, idx, gl * weight[:, None])
    return out


def _simplex_corners(frac_l):
    """Tetrahedral-interpolation corners of one level (JAX
    encoders._simplex_corners). frac_l: (3, N) fractions in the cell. With
    the fractions sorted s1 >= s2 >= s3, the corners are the lattice path
    base -> +e_argmax -> +(1 - e_argmin) -> (1, 1, 1) and the weights
    (1 - s1, s1 - s2, s2 - s3, s3), in the JAX package's fp32 expression
    order (s2 = sum - s1 - s3, the sum taken in axis order). argmax and
    argmin take the first index on ties. Returns (offsets (4, 3, N) int64
    in {0, 1}, weights (4, N))."""
    s1 = frac_l.amax(dim=0)
    s3 = frac_l.amin(dim=0)
    s2 = (frac_l[0] + frac_l[1]) + frac_l[2] - s1 - s3
    axes = torch.arange(3, device=frac_l.device)[:, None]
    o1 = (axes == frac_l.argmax(dim=0)).long()
    o2 = 1 - (axes == frac_l.argmin(dim=0)).long()
    offsets = torch.stack([torch.zeros_like(o1), o1, o2,
                           torch.ones_like(o1)])
    weights = torch.stack([1.0 - s1, s1 - s2, s2 - s3, s3])
    return offsets, weights


def _exact_level_rows_simplex(table, l, cell, frac, stride, use_dense,
                              size, config):
    """4-corner tetrahedral interpolation of one level (rows layout),
    blended in corner order."""
    offsets, weights = _simplex_corners(frac[:, l])
    acc = torch.zeros((cell.shape[-1], config.n_features), dtype=table.dtype,
                      device=table.device)
    for ci in range(4):
        idx = _corner_index(cell[:, l], offsets[ci], stride[l], use_dense[l],
                            size[l])
        acc = acc + table[l][idx] * weights[ci][:, None]
    return acc


def _encode_rows_simplex(table, x, config):
    """Exact simplex encode (the plain version of the simplex encode
    kernel's eval form), differentiable by autograd."""
    cell, frac, stride, use_dense, size = _grid_geometry(x, config)
    return torch.cat([
        _exact_level_rows_simplex(table, l, cell, frac, stride, use_dense,
                                  size, config)
        for l in range(config.n_levels)], dim=-1)


def _corner_idx_weights(x, config, interp):
    """Every level's interpolation atoms: table indices (L, A, N) int32 and
    weights (L, A, N) fp32, A = 4 (simplex) or 8 (trilinear, in _CORNERS
    order). The plain version of the atoms the simplex encode kernel
    writes for the sampled backward."""
    cell, frac, stride, use_dense, size = _grid_geometry(x, config)
    atoms = [_level_atoms(cell, frac, stride, use_dense, size, l, interp)
             for l in range(config.n_levels)]
    return (torch.stack([i for i, _ in atoms]).to(torch.int32),
            torch.stack([w for _, w in atoms]))


def _gather_from_atoms(table, idx, w, config, dtype):
    """Exact interpolation from the atoms, in `dtype` (the MLP compute
    dtype: bf16 on the card, fp32 on the CPU): each product and partial
    sum rounded to it, in atom order, as the JAX package computes it."""
    n = idx.shape[2]
    outs = []
    for l in range(config.n_levels):
        table_l = table[l].to(dtype)
        acc = torch.zeros((n, config.n_features), dtype=dtype,
                          device=table.device)
        for ci in range(idx.shape[1]):
            acc = acc + table_l[idx[l, ci].long()] \
                * w[l, ci].to(dtype)[:, None]
        outs.append(acc)
    return torch.cat(outs, dim=-1)


def _select_scan(g):
    """p_i ∝ ||g_i|| (uniform when the total is 0) and its inclusive scan
    normalized to end at 1, in fp32: what _select_backward_points draws
    from."""
    n = g.shape[0]
    g32 = g.float()
    s = torch.sqrt((g32 * g32).sum(dim=-1))
    tot = s.sum()
    p = torch.where(tot > 0, s / torch.clamp(tot, min=1e-30),
                    torch.full_like(s, 1.0 / n))
    cum = torch.cumsum(p, dim=0)
    return p, cum / cum[-1]


def _select_backward_points(g, u_sys, k):
    """Systematic resample of k points from p_i ∝ ||g_i|| (JAX
    encoders._select_backward_points): counts_i = #{grid positions
    (j + u_sys) / k in (cum_{i-1}, cum_i]}, coef = counts / (k p). Returns
    the points with counts > 0 in ascending order and their coefs; JAX
    pads the same set to k with coef-0 rows (top_k's order), which
    scatter nothing. The plain version of the point-subsample kernel."""
    return _select_from_scan(*_select_scan(g), u_sys, k)


def _select_from_scan(p, cum, u_sys, k):
    """_select_backward_points from its scan (p, cum): the same scan read
    twice selects the same points, where torch.cumsum on the card may not
    give the same bits twice."""
    c = torch.floor(k * cum - u_sys)
    counts = torch.diff(c, prepend=c.new_full((1,), -1.0))
    sel = torch.nonzero(counts > 0).squeeze(1)
    coef = counts[sel] / (k * torch.clamp(p[sel], min=1e-30))
    return sel, coef


def _pick_rows(rows, i):
    """rows (A, N) -> (N,): rows[i[n], n]."""
    return rows.gather(0, i[None].long())[0]


def _atom_cumsum(w):
    """Partial sums of w (A, N) over atoms, each in fp32 and in atom order
    (as the JAX package's cumsum and sum; torch.cumsum on the CPU would
    accumulate in float64)."""
    out = [w[0]]
    for a in range(1, w.shape[0]):
        out.append(out[-1] + w[a])
    return torch.stack(out)


def _draw_rows(idx_l, w_l, u_l, rows):
    """The (row, weight) pairs one level's points scatter into: every atom
    at its weight (rows = A); the max-weight atom (first on ties) at w_m
    and a draw from the rest at 1 - w_m (rows = 2); or one draw J ~ w at
    weight 1 (rows = 1). Draws by inverse CDF of u_l over the atoms'
    fp32 partial sums. Returns a list of ((N,) rows, (N,) weights or None
    for 1)."""
    n_atoms = w_l.shape[0]
    if rows >= n_atoms:
        return [(idx_l[a], w_l[a]) for a in range(n_atoms)]
    if rows == 2:
        m = w_l.argmax(dim=0)
        w_m = _pick_rows(w_l, m)
        wr = torch.where(torch.arange(n_atoms, device=w_l.device)[:, None]
                         == m[None], torch.zeros_like(w_l), w_l)
        cum = _atom_cumsum(wr)
        cum = cum / torch.clamp(cum[-1], min=1e-12)
        j = (u_l[None] > cum[:-1]).sum(dim=0)
        return [(_pick_rows(idx_l, m), w_m),
                (_pick_rows(idx_l, j), 1.0 - w_m)]
    j = (u_l[None] > _atom_cumsum(w_l[:-1])).sum(dim=0)
    return [(_pick_rows(idx_l, j), None)]


def sampled_scatter_plain(g, idx, w, u, rows, config, sel=None, coef=None):
    """The sampled table gradient (JAX encoders._encode_sampled_bwd_bwd
    after its point subsample), the plain version of the sampled scatter
    kernel. g: (N, L * F) cotangent of the encode; idx, w: the (L, A, N)
    atoms; u: (L, N[+1]) uniforms (None when every level scatters all A
    rows); rows: per-level scatter rows (1, 2 or A). With (sel, coef),
    only the selected points scatter, their cotangents scaled by coef.
    Returns (L, T, F) fp32."""
    f = config.n_features
    n = idx.shape[2]
    g = g.float()
    uc = None if u is None else u[:, :n]
    if sel is not None:
        g = g[sel] * coef[:, None]
        idx, w = idx[:, :, sel], w[:, :, sel]
        uc = None if uc is None else uc[:, sel]
    cot = torch.zeros((config.n_levels, config.table_size, f),
                      dtype=torch.float32, device=g.device)
    for l in range(config.n_levels):
        g_l = g[:, l * f:(l + 1) * f]
        u_l = None if uc is None else uc[l]
        for row, weight in _draw_rows(idx[l].long(), w[l], u_l, rows[l]):
            cot[l].index_add_(0, row,
                              g_l if weight is None else weight[:, None] * g_l)
    return cot


def backward_subsample(n, point_frac):
    """The points the sampled backward scatters, k = round(frac * n) (at
    least 1), or None when every point does."""
    return max(1, int(round(point_frac * n))) if point_frac < 1.0 else None


def sampled_backward_plain(g, idx, w, u, rows, config, point_frac):
    """The whole sampled table gradient: the point subsample when
    point_frac < 1 (systematic offset u[0, N]), then the scatter."""
    k = backward_subsample(idx.shape[2], point_frac)
    if k is None:
        return sampled_scatter_plain(g, idx, w, u, rows, config)
    sel, coef = _select_backward_points(g, u[0, idx.shape[2]], k)
    return sampled_scatter_plain(g, idx, w, u, rows, config, sel, coef)


class _SampledEncodePlain(torch.autograd.Function):
    """Exact forward from the atoms, in the compute dtype; sampled table
    gradient; zero cotangents for x and u (JAX _encode_sampled_bwd)."""

    @staticmethod
    def forward(ctx, table, x, u, config, interp, rows, point_frac):
        idx, w = _corner_idx_weights(x, config, interp)
        ctx.save_for_backward(idx, w, u)
        ctx.args = (rows, config, point_frac)
        return _gather_from_atoms(table, idx, w, config,
                                  default_compute_dtype(x.device))

    @staticmethod
    def backward(ctx, g):
        idx, w, u = ctx.saved_tensors
        dtable = None
        if ctx.needs_input_grad[0]:
            dtable = sampled_backward_plain(g, idx, w, u, *ctx.args)
        return dtable, None, None, None, None, None, None


def sampled_rows(config, interp, sampled_backward, backward_points):
    """Validate the sampled-backward options as the JAX package does and
    return (per-level rows tuple, point fraction)."""
    if config.n_features % 8 != 0:
        raise NotImplementedError(
            "sampled_backward is implemented for the wide-row "
            "(TPU_GRID-shaped) layout only")
    n_atoms = 4 if interp == 'simplex' else 8
    if isinstance(sampled_backward, int):
        rows = (int(sampled_backward),) * config.n_levels
    else:
        rows = tuple(int(r) for r in sampled_backward)
    if len(rows) != config.n_levels or any(r not in (1, 2, n_atoms)
                                           for r in rows):
        raise NotImplementedError(
            "sampled_backward must be 1 (importance draw), 2 "
            f"(residual pair), or {n_atoms} (exact scatter for this "
            "interpolation), or a per-level tuple of those with one "
            f"entry per grid level; got {sampled_backward!r}")
    pf = float(backward_points)
    if not 0.0 < pf <= 1.0:
        raise ValueError(
            f"backward_points must be in (0, 1]; got {backward_points!r}")
    return rows, pf


def uniform_shape(levels, n, interp='trilinear', n_samples=1, residual=False,
                  sampled_backward=0, backward_points=1.0):
    """The shape of the float32 uniforms `u` an estimator of n points on a
    grid of `levels` levels takes, where the JAX package draws them from its
    key:

    - the sampled backward: (L, N), or (L, N + 1) when the points are
      subsampled (u[0, N] is the systematic offset);
    - the residual encode: (L, N), as jax.random.uniform(key, (L, N));
    - the stochastic trilinear encode: (D, 3, L, N) and the stochastic
      simplex encode (D, L, N), D = ceil(n_samples / 2): u[s] is
      jax.random.uniform(split(key, D)[s], ...), set s < n_samples // 2
      serving the antithetic pair (u, 1 - u) and, for odd n_samples, the
      last set the single draw."""
    if sampled_backward:
        return (levels, n + (1 if backward_points < 1.0 else 0))
    if residual:
        return (levels, n)
    sets = (n_samples + 1) // 2
    return (sets, levels, n) if interp == 'simplex' else (sets, 3, levels, n)


def check_uniforms(u, shape):
    """u must be float32 of `shape` (uniform_shape)."""
    if tuple(u.shape) != tuple(shape) or u.dtype != torch.float32:
        raise ValueError(f'u must be float32 of shape {tuple(shape)}, got '
                         f'{u.dtype} {tuple(u.shape)}')


# Kinds of level in the stochastic encodes: `DRAWS` averages n_samples drawn
# corner rows (each weight 1), `RESIDUAL` blends the max-weight atom at w_m
# with one draw from the rest at 1 - w_m, `EXACT` interpolates every atom at
# its weight (the finest exact_levels levels).
DRAWS, RESIDUAL, EXACT = 0, 1, 2


def stochastic_plan(config, interp='trilinear', n_samples=1, exact_levels=0,
                    residual=False):
    """Validate the stochastic and residual encodes' options as the JAX
    package does (hashgrid_encode's order and errors) and return each
    level's (kind, rows): the rows it gathers and, in training, scatters."""
    if residual:
        if n_samples != 2:
            raise NotImplementedError(
                "residual sampling is a 2-row estimator (n_samples=2)")
        if config.n_features % 8 != 0:
            raise NotImplementedError(
                "residual sampling is implemented for the wide-row "
                "layout only")
    elif interp == 'simplex' and config.n_features % 8 != 0:
        raise NotImplementedError(
            "simplex interpolation is implemented for the wide-row "
            "(TPU_GRID-shaped) layout only")
    if interp not in ('trilinear', 'simplex'):
        raise ValueError(f'unknown interpolation {interp!r}')
    if n_samples < 1:
        raise ValueError(f'n_samples must be at least 1; got {n_samples!r}')
    levels = config.n_levels
    n_exact = min(max(exact_levels, 0), levels)
    atoms = 4 if interp == 'simplex' else 8
    return tuple((EXACT, atoms) if l >= levels - n_exact
                 else (RESIDUAL, 2) if residual else (DRAWS, n_samples)
                 for l in range(levels))


def _draw_set(r, n_samples):
    """Row r of a DRAWS level: its draw set s and whether it draws at 1 - u
    (rows 2s and 2s + 1 are the pair (u, 1 - u) of set s; the last row of
    an odd n_samples is the single draw of the last set)."""
    pairs = n_samples // 2
    return (r // 2, bool(r % 2)) if r < 2 * pairs else (pairs, False)


def _atom_offset(offsets, i):
    """offsets (A, 3, N) -> (3, N): each point's atom i[n]'s offset."""
    return offsets.gather(0, i[None, None].expand(1, 3, -1).long())[0]


def _level_atoms(cell, frac, stride, use_dense, size, l, interp):
    """Level l's interpolation atoms: (indices (A, N) int64, weights (A, N)),
    the simplex atoms or the 8 trilinear corners in _CORNERS order."""
    if interp == 'simplex':
        offsets, w = _simplex_corners(frac[:, l])
    else:
        offsets = _CORNERS
        w = torch.stack([_corner_weight(frac[:, l], c) for c in _CORNERS])
    idx = torch.stack([_corner_index(cell[:, l], o, stride[l], use_dense[l],
                                     size[l]) for o in offsets])
    return idx, w


def _level_rows(cell, frac, stride, use_dense, size, l, u, kind, rows,
                interp, n_samples):
    """The (N,) table rows and (N,) weights level l gathers, in blend order:
    for DRAWS the n_samples draws (weight 1): per axis the upper corner
    where the uniform (or 1 - it) < frac (trilinear), or the atom
    #{k < 3 : uniform > cum_k}, cum the fp32 partial sums of the simplex
    weights; for RESIDUAL the max-weight atom (the first on ties) at w_m
    and the draw from the rest at 1 - w_m (_draw_rows); for EXACT every
    atom at its weight."""
    if kind == DRAWS:
        out = []
        if interp == 'simplex':
            offsets, w = _simplex_corners(frac[:, l])
            cum = _atom_cumsum(w[:3])
        for r in range(rows):
            s, flip = _draw_set(r, n_samples)
            if interp == 'simplex':
                v = u[s, l]
                v = 1.0 - v if flip else v
                off = _atom_offset(offsets, (v[None] > cum).sum(dim=0))
            else:
                v = u[s, :, l]
                v = 1.0 - v if flip else v
                off = (v < frac[:, l]).long()
            idx = _corner_index(cell[:, l], off, stride[l], use_dense[l],
                                size[l])
            out.append((idx, torch.ones_like(frac[0, l])))
        return out
    idx, w = _level_atoms(cell, frac, stride, use_dense, size, l, interp)
    if kind == RESIDUAL:
        return _draw_rows(idx, w, u[l], 2)
    return [(idx[a], w[a]) for a in range(rows)]


def sample_scale(n_samples, device):
    """1 / n_samples rounded once to fp32, as a 0-dim tensor: the factor by
    which XLA scales the sum of n_samples draws (its algebraic simplifier
    turns the division by a constant into this product; measured against
    JAX on the CPU, the product is bit-equal and a division is not)."""
    return torch.tensor(1.0, device=device) / torch.tensor(
        float(n_samples), device=device)


def _blend_level(table_l, kind, level_rows, n_samples):
    """One level's output from its rows, in the JAX package's fp32 order:
    DRAWS sums each antithetic pair, chains the pairs and the single draw,
    then scales by 1 / n_samples (sample_scale: XLA compiles JAX's
    `acc / n_samples` to that product); RESIDUAL is w_m f_m + (1 - w_m) f_j;
    EXACT sums w * row from zero in atom order. Every product and sum is
    rounded on its own, where XLA may fuse a product into the next sum."""
    if kind == DRAWS:
        feats = [table_l[i] for i, _ in level_rows]
        pairs = n_samples // 2
        acc = None
        for s in range(pairs):
            pair = feats[2 * s] + feats[2 * s + 1]
            acc = pair if acc is None else acc + pair
        if n_samples % 2:
            acc = feats[-1] if acc is None else acc + feats[-1]
        if n_samples > 1:
            acc = acc * sample_scale(n_samples, acc.device)
        return acc
    if kind == RESIDUAL:
        (i_m, w_m), (i_j, w_j) = level_rows
        return w_m[:, None] * table_l[i_m] + w_j[:, None] * table_l[i_j]
    acc = torch.zeros((level_rows[0][0].shape[0], table_l.shape[1]),
                      dtype=table_l.dtype, device=table_l.device)
    for i, w in level_rows:
        acc = acc + table_l[i] * w[:, None]
    return acc


def plan_starts(plan):
    """Per level of the plan: (kind, rows, first, wfirst), `first` the first
    of its rows among the S rows and `wfirst` the first of its weights among
    the SW weighted (RESIDUAL and EXACT) rows, None on DRAWS levels (a draw
    weighs 1 / n_samples, which is not stored), as hashgrid_stochastic.cuh
    lays them out."""
    out, first, wfirst = [], 0, 0
    for kind, rows in plan:
        out.append((kind, rows, first, None if kind == DRAWS else wfirst))
        first += rows
        wfirst += 0 if kind == DRAWS else rows
    return out


def stochastic_rows(x, config, u, plan, interp='trilinear', n_samples=1):
    """The rows the stochastic or residual encode gathers, as the kernel
    writes them for its backward: (indices (S, N) int32, weights (SW, N)
    fp32), S the sum of every level's rows and SW that of the RESIDUAL and
    EXACT levels', each level's rows in blend order from plan_starts."""
    cell, frac, stride, use_dense, size = _grid_geometry(x, config)
    levels = [_level_rows(cell, frac, stride, use_dense, size, l, u, kind,
                          rows, interp, n_samples)
              for l, (kind, rows) in enumerate(plan)]
    idx = torch.stack([i for lv in levels for i, _ in lv]).to(torch.int32)
    w = [w for lv, (kind, _) in zip(levels, plan) if kind != DRAWS
         for _, w in lv]
    w = torch.stack(w) if w else torch.empty(
        (0, x.shape[0]), dtype=torch.float32, device=x.device)
    return idx, w


def blend_drawn_rows(table, idx, w, plan, n_samples=1):
    """The encode (N, L * F) from stochastic_rows' (idx, w): each level's
    rows blended as its kind asks (_blend_level), differentiable in table
    by autograd."""
    outs = []
    for l, (kind, rows, first, wfirst) in enumerate(plan_starts(plan)):
        level_rows = [(idx[first + r].long(),
                       None if wfirst is None else w[wfirst + r])
                      for r in range(rows)]
        outs.append(_blend_level(table[l], kind, level_rows, n_samples))
    return torch.cat(outs, dim=-1)


def stochastic_scatter_plain(g, idx, w, plan, config, n_samples=1):
    """The table gradient of the stochastic or residual encode from its
    drawn rows (JAX: the VJP of its jnp.takes), the plain version of the
    stochastic scatter kernel. g: (N, L * F) cotangent; idx, w: the rows
    and weights of stochastic_rows. A DRAWS row takes g * sample_scale (g
    itself for one sample), any other row w * g. Returns (L, T, F) fp32."""
    f = config.n_features
    g = g.float()
    cot = torch.zeros((config.n_levels, config.table_size, f),
                      dtype=torch.float32, device=g.device)
    for l, (kind, rows, first, wfirst) in enumerate(plan_starts(plan)):
        g_l = g[:, l * f:(l + 1) * f]
        if kind == DRAWS and n_samples > 1:
            g_l = g_l * sample_scale(n_samples, g.device)
        for r in range(rows):
            cot[l].index_add_(0, idx[first + r].long(),
                              g_l if kind == DRAWS
                              else w[wfirst + r][:, None] * g_l)
    return cot


def _frac_cotangent(frac_l, coef, interp, absolute=False):
    """One level's cotangent of the fractions (3, N) from coef (A, N), the
    loss's derivative by each atom's weight, through the weights' own
    derivatives (JAX's autodiff rules): the trilinear corner products,
    or the simplex weights (1 - s1, s1 - s2, s2 - s3, s3) with s2 = sum -
    s1 - s3, s1 = max and s3 = min sharing their cotangent evenly among
    tied axes (jnp.max, jnp.min). With `absolute`, every term's magnitude
    instead (coef then holds magnitudes): the sum that bounds the
    roundings."""
    sign = (lambda v: v) if absolute else torch.neg
    if interp == 'simplex':
        c0, c1, c2, c3 = coef
        if absolute:
            d1, d2, d3 = c0 + c1, c1 + c2, c2 + c3
            ct1, ct3 = d1 + d2, d3 + d2
        else:
            d1, d2, d3 = c1 - c0, c2 - c1, c3 - c2
            ct1, ct3 = d1 - d2, d3 - d2
        is1 = (frac_l == frac_l.amax(dim=0)).float()
        is3 = (frac_l == frac_l.amin(dim=0)).float()
        return (d2 + is1 * (ct1 / is1.sum(dim=0))) \
            + is3 * (ct3 / is3.sum(dim=0))
    one = 1.0 - frac_l
    out = torch.zeros_like(frac_l)
    for a, (ox, oy, oz) in enumerate(_CORNERS):
        wx = frac_l[0] if ox else one[0]
        wy = frac_l[1] if oy else one[1]
        wz = frac_l[2] if oz else one[2]
        c = coef[a]
        # w = (wx * wy) * wz, differentiated in reverse
        cz = c * (wx * wy)
        cxy = c * wz
        cx, cy = cxy * wy, cxy * wx
        out[0] += cx if ox else sign(cx)
        out[1] += cy if oy else sign(cy)
        out[2] += cz if oz else sign(cz)
    return out


def hashgrid_encode_point_grad_plain(g, table, x, config, interp='trilinear',
                                     plan=None, rows=None, absolute=False):
    """The cotangent (N, 3) of x of the hash-grid encode for its cotangent g
    (N, L * F): JAX's VJP of encoders.hashgrid_encode for x, written out
    (not autograd), the plain version of the point-gradient kernel (K2x).

    Per level l and atom a, coef_a = <g_l, row_a>; the level's fraction
    cotangent follows from the weights' derivatives (_frac_cotangent),
    times the level's scale (pos = scale * x + offset; floor carries no
    gradient). With `plan` (stochastic_plan) the stochastic and residual
    encodes: DRAWS levels contribute nothing (a comparison picks the row);
    a RESIDUAL level's output w_m f_m + (1 - w_m) f_J gives coef_a =
    <g_l, f_m - f_J> on the atoms whose weight equals the maximum w_m,
    shared evenly among them, f_m and f_J the level's two drawn rows of
    `rows` (stochastic_rows' indices); EXACT levels as the exact encode.
    With `absolute`, the sum of every term's magnitude (|g|, |table|),
    which bounds the roundings (point_grad_tolerance)."""
    cell, frac, stride, use_dense, size = _grid_geometry(x, config)
    scales = torch.as_tensor(level_geometry(config)[0], device=x.device)
    f = config.n_features
    g = g.float()
    if absolute:
        g, table = g.abs(), table.abs()
    n_atoms = 4 if interp == 'simplex' else 8
    starts = plan_starts(plan) if plan is not None else \
        [(EXACT, n_atoms, None, None)] * config.n_levels
    dx = torch.zeros((3, x.shape[0]), dtype=torch.float32, device=x.device)
    for l, (kind, _, first, _) in enumerate(starts):
        if kind == DRAWS:
            continue
        idx, w = _level_atoms(cell, frac, stride, use_dense, size, l, interp)
        g_l = g[:, l * f:(l + 1) * f]
        if kind == EXACT:
            coef = torch.stack([(table[l][i] * g_l).sum(dim=-1) for i in idx])
        else:
            dots = [(table[l][rows[first + r].long()] * g_l).sum(dim=-1)
                    for r in range(2)]
            tie = (w == w.amax(dim=0)).float()
            diff = dots[0] + dots[1] if absolute else dots[0] - dots[1]
            coef = diff * (tie / tie.sum(dim=0))
        dx += scales[l] * _frac_cotangent(frac[:, l], coef, interp, absolute)
    return dx.T.contiguous()


def point_grad_tolerance(g, table, x, config, interp='trilinear', plan=None,
                         rows=None):
    """Per element of the point gradient, how far two fp32 evaluations of
    it in different orders can lie apart: 2 k 2^-24 times the sum of its
    terms' magnitudes, k = F + 4 A + 8 roundings a term can pass through
    (a level's dot of F products, the A atoms' sums, the weight
    derivative's products, the scale and the levels' sum)."""
    n_atoms = 4 if interp == 'simplex' else 8
    k = config.n_features + 4 * n_atoms + 8 + config.n_levels
    return 2.0 * k * 2.0 ** -24 * hashgrid_encode_point_grad_plain(
        g, table, x, config, interp, plan, rows, absolute=True)


def hashgrid_encode(table, x, config, key=None, n_samples=1, exact_levels=0,
                    interp='trilinear', residual=False, sampled_backward=0,
                    backward_points=1.0, u=None):
    """Encode (N, 3) points in [0, 1] -> (N, n_levels * n_features), as
    autolabel_tpu/ops/encoders.hashgrid_encode, in plain PyTorch.

    u: the estimator's uniforms, which JAX draws from its key (shapes:
    uniform_shape). With sampled_backward and u the encode is exact forward
    / sampled backward, its output in the compute dtype; with u alone it is
    the residual (residual=True) or stochastic-corner encode, fp32, in the
    JAX package's order of dispatch and with its errors; without u the
    exact trilinear or simplex interpolation. All differentiable by
    autograd. The port never takes a JAX key: `key` raises.
    """
    if key is not None:
        raise NotImplementedError(
            "the port takes the estimators' uniforms as u, not a PRNG key")
    if sampled_backward and u is not None:
        rows, pf = sampled_rows(config, interp, sampled_backward,
                                backward_points)
        check_uniforms(u, uniform_shape(config.n_levels, x.shape[0],
                                        sampled_backward=sampled_backward,
                                        backward_points=pf))
        return _SampledEncodePlain.apply(table, x, u, config, interp, rows,
                                         pf)
    if u is not None:
        # JAX's _encode_residual, _encode_stochastic_simplex and
        # _encode_stochastic (both of its branches: the narrow one computes
        # the same values level by level in an (L, F, N) layout) differ
        # only in how each level draws its rows: the plan's kinds.
        plan = stochastic_plan(config, interp, n_samples, exact_levels,
                               residual)
        check_uniforms(u, uniform_shape(config.n_levels, x.shape[0], interp,
                                        n_samples, residual))
        idx, w = stochastic_rows(x, config, u, plan, interp, n_samples)
        return blend_drawn_rows(table, idx, w, plan, n_samples)
    if interp == 'simplex':
        if config.n_features % 8 != 0:
            raise NotImplementedError(
                "simplex interpolation is implemented for the wide-row "
                "(TPU_GRID-shaped) layout only")
        return _encode_rows_simplex(table, x, config)
    if interp != 'trilinear':
        raise ValueError(f'unknown interpolation {interp!r}')
    if config.n_features % 8 == 0:
        return _encode_rows(table, x, config)
    return _encode_lanes(table, x, config)
