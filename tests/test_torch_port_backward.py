"""The plain versions of the port's backward kernels against the JAX
package's VJPs, on the CPU.

K2 (the hash-grid table gradient) against jax.vjp of
encoders.hashgrid_encode; K3b and K4b (the fused head and proposal-MLP
backward) against the custom VJPs of heads_pallas.fused_heads and
fused_mlp3, whose `_bwd_kernel` / `_mlp3_bwd_kernel` run in interpret
mode. Both packages compute in fp32 here. Tolerance rtol=1e-4 (the same
products summed in another order: scatter order for K2, padded against
split products for the heads) with atol=1e-6 on outputs of order 1.
"""
import jax
import numpy as np
import pytest
import torch

from autolabel_tpu.ops import encoders as jax_encoders
from autolabel_tpu.ops import heads_pallas as jax_heads
from autolabel_tpu_torch.ops import _kernels, encoders, hashgrid_cuda
from autolabel_tpu_torch.ops import heads_cuda
from tests.test_torch_port_encoders import _grid, _points, _table
from tests.test_torch_port_heads import _params, _torch_tree

RTOL, ATOL = 1e-4, 1e-6


def _close(ours, ref, rtol=RTOL, atol=ATOL):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize('domain', ['unit', 'outside'])
@pytest.mark.parametrize('variant', ['native', 'tcnn', 'torch_ngp'])
@pytest.mark.parametrize('n_features', [8, 2])
def test_encode_backward_plain_matches_jax_vjp(variant, n_features, domain):
    """Two levels x F features x 2^10 rows; F = 2 is the lanes layout.
    The unit domain holds points at x = 0 and x = 1 (an upper corner of
    weight 0, whose dense index wraps)."""
    rng = np.random.default_rng(6)
    cfg = _grid(variant, n_features, n_levels=2)
    table, x = _table(rng, cfg), _points(rng, 400, domain)
    g = rng.normal(size=(400, 2 * n_features)).astype(np.float32)
    ours = hashgrid_cuda.hashgrid_encode_backward_plain(
        torch.tensor(g), torch.tensor(x), encoders.HashGridConfig(**cfg))
    _, vjp = jax.vjp(lambda t: jax_encoders.hashgrid_encode(
        t, x, jax_encoders.HashGridConfig(**cfg)), table)
    (ref,) = vjp(g)
    assert ours.shape == ref.shape and ours.dtype == torch.float32
    _close(ours, ref)


@pytest.mark.parametrize('n_features', [8, 2])
def test_encode_backward_plain_is_the_autograd_gradient(n_features):
    rng = np.random.default_rng(7)
    cfg = encoders.HashGridConfig(**_grid('native', n_features))
    table = torch.tensor(_table(rng, _grid('native', n_features)),
                         requires_grad=True)
    x = torch.tensor(_points(rng, 300))
    g = torch.tensor(rng.normal(size=(300, cfg.out_dim)).astype(np.float32))
    _kernels.reset_launches()
    out = hashgrid_cuda.hashgrid_encode(table, x, cfg)
    (want,) = torch.autograd.grad(out, table, g)
    _close(hashgrid_cuda.hashgrid_encode_backward_plain(g, x, cfg),
           want.numpy())
    assert sum(_kernels.launches.values()) == 0  # plain versions on the CPU


def _clustered_points(rng, n, kind):
    """Duplicate-heavy points: all inside one cell of every level
    ('one_cell'), or the samples of a few rays in ray order ('rays', 32 a
    ray, as a training step's main samples come), so many terms land in
    the same rows."""
    if kind == 'one_cell':
        return (0.4321 + rng.uniform(0.0, 1e-3, (n, 3))).astype(np.float32)
    rays = n // 32
    o = rng.uniform(0.1, 0.9, (rays, 1, 3))
    d = rng.normal(size=(rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(0.0, 0.3, (rays, 32, 1)), axis=1)
    return np.clip(o + t * d, 0.0, 1.0).reshape(-1, 3).astype(np.float32)


@pytest.mark.parametrize('kind', ['one_cell', 'rays'])
@pytest.mark.parametrize('variant', ['native', 'tcnn', 'torch_ngp'])
@pytest.mark.parametrize('n_features', [8, 2])
def test_encode_backward_plain_on_clustered_points(variant, n_features,
                                                   kind):
    """The table gradient where rows sum hundreds of terms (384 points a
    row for 'one_cell'). The two packages sum them in other orders: each
    element within hashgrid_cuda.backward_tolerance (2 k 2^-24 of its
    terms' magnitudes, k its row's terms), plus 1e-4 of those magnitudes
    for the blend weights' last bits (the packages round the cell
    fractions differently)."""
    rng = np.random.default_rng(11)
    cfg = _grid(variant, n_features, n_levels=2)
    x = _clustered_points(rng, 384, kind)
    g = rng.normal(size=(384, 2 * n_features)).astype(np.float32)
    config = encoders.HashGridConfig(**cfg)
    ours = hashgrid_cuda.hashgrid_encode_backward_plain(
        torch.tensor(g), torch.tensor(x), config)
    tol = hashgrid_cuda.backward_tolerance(torch.tensor(g), torch.tensor(x),
                                           config).numpy()
    magnitude = hashgrid_cuda.hashgrid_encode_backward_plain(
        torch.tensor(np.abs(g)), torch.tensor(x), config).numpy()
    _, vjp = jax.vjp(lambda t: jax_encoders.hashgrid_encode(
        t, x, jax_encoders.HashGridConfig(**cfg)),
        _table(rng, cfg))
    (ref,) = vjp(g)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    if kind == 'one_cell':  # every level's 8 corner rows take all points
        assert int((np.abs(ref).sum(-1) > 0).sum()) <= 2 * 8
    err = np.abs(ours.numpy() - ref)
    assert np.all(err <= tol + RTOL * magnitude), float(err.max())


def _row_sums(g_abs, cell, config):
    """Per element, the sum of |g| over the terms its row takes, unweighted,
    for the cells (3, L, N) given: what a one-ulp change of every weight
    can move it by, per ulp."""
    _, _, stride, use_dense, size = encoders._grid_geometry(
        torch.zeros((1, 3)), config)
    f = config.n_features
    out = torch.zeros((config.n_levels, config.table_size, f))
    for l in range(config.n_levels):
        for corner in encoders._CORNERS:
            out[l].index_add_(0, encoders._corner_index(
                cell[:, l], corner, stride[l], use_dense[l], size[l]),
                g_abs[:, l * f:(l + 1) * f])
    return out.numpy()


@pytest.mark.parametrize('kind', ['uniform', 'rays'])
def test_encode_backward_plain_on_the_full_tcnn_lattice(kind):
    """The plain K2 on the full tcnn reference lattice (16 x 2^19 x 2:
    three dense levels, 13 hashed) at 2,048 uniform or ray-ordered
    points. Within the clustered test's rule, plus what the packages'
    positions allow: XLA contracts x * scale + offset into an fma, the
    port rounds the product first (as its kernels do), so a cell fraction
    may differ by up to one ulp of the level's positions (2^-5 at the
    finest level here, whose positions reach 2^19), and a corner weight,
    a product of three factors in [0, 1], by three; a cell may differ
    where a position lies within that of an integer, its weights then as
    close. So each element may move by 3 ulp times the sum of |g| over
    the terms its row takes in either package."""
    rng = np.random.default_rng(25)
    config = encoders.HashGridConfig(variant='tcnn')
    jax_config = jax_encoders.HashGridConfig(variant='tcnn')
    n = 2048
    x = (_points(rng, n) if kind == 'uniform'
         else _clustered_points(rng, n, 'rays'))
    g = rng.normal(size=(n, config.out_dim)).astype(np.float32)
    ours = hashgrid_cuda.hashgrid_encode_backward_plain(
        torch.tensor(g), torch.tensor(x), config).numpy()
    table = np.zeros((config.n_levels, config.table_size,
                      config.n_features), np.float32)
    _, vjp = jax.vjp(lambda t: jax_encoders.hashgrid_encode(t, x,
                                                           jax_config), table)
    (ref,) = vjp(g)
    ref = np.asarray(ref)
    mag = hashgrid_cuda.hashgrid_encode_backward_plain(
        torch.tensor(np.abs(g)), torch.tensor(x), config).numpy()
    tol = hashgrid_cuda.backward_tolerance(torch.tensor(g), torch.tensor(x),
                                           config).numpy()
    g_abs = torch.tensor(np.abs(g))
    cells = (encoders._grid_geometry(torch.tensor(x), config)[0],
             torch.tensor(np.asarray(jax.jit(
                 lambda x: jax_encoders._grid_geometry(x, jax_config)[0])(x)
             ).astype(np.int64)))
    top = np.asarray(config.scales, np.float64) + config.pos_offset
    ulp = 2.0 ** (np.floor(np.log2(top)) - 23)  # of the level's positions
    room = 3 * ulp[:, None, None] * sum(_row_sums(g_abs, c, config)
                                        for c in cells)
    assert ours.shape == ref.shape
    err = np.abs(ours - ref)
    assert np.all(err <= tol + RTOL * mag + room), float(
        (err - tol - RTOL * mag - room).max())


def _head_cotangents(rng, n, packed_ours, packed_jax):
    """Cotangents of (out1, features, logits): random in the port's
    widths, zero beyond them in the JAX package's 128-lane widths."""
    out = []
    for w_ours, w_jax in ((packed_ours[7], packed_jax[7]),
                          (packed_ours[10], packed_jax[10]),
                          (packed_ours[13], packed_jax[13])):
        g = np.zeros((n, w_jax.shape[1]), np.float32)
        g[:, :w_ours.shape[1]] = rng.normal(size=(n, w_ours.shape[1]))
        out.append(g)
    return out


def _head_blocks(rng, n, scale):
    A = (rng.normal(size=(n, 32)) * scale).astype(np.float32)
    B = np.zeros((n, 128), np.float32)
    B[:, :12] = rng.uniform(-1, 1, (n, 12))
    B[:, 16:32] = rng.normal(size=(n, 16)) * 0.3
    return A, B


@pytest.mark.parametrize('semantic_classes,scale,semantic_dim',
                         [(5, 0.1, 64), (2, 30.0, 64), (5, 0.1, 256)])
def test_fused_heads_backward_plain_matches_jax_vjp(semantic_classes,
                                                    scale, semantic_dim,
                                                    monkeypatch):
    """dA, dB and all 14 dW. scale 30 drives some raw densities S0 past
    15, where the trunc_exp VJP g * exp(clip(S0, -15, 15)) differs from
    the derivative of the forward's clamp. semantic_dim 256: the feature
    head spans two of the kernels' 128-column passes.

    Every output sums fp32 products of magnitudes up to its own largest
    one, in an order each package picks (and XLA's order depends on the
    host), so each is held, as the weight gradients are, with atol
    relative to its largest magnitude. A float64 run of the plain
    backward is the witness that the port is right where the two differ:
    its dA and dB are no further from it than the JAX package's are, up
    to one fp32 rounding of the largest magnitude."""
    params = _params(semantic_classes=semantic_classes,
                     semantic_dim=semantic_dim)
    rng = np.random.default_rng(8)
    A, B = _head_blocks(rng, 300, scale)
    ours_packed = heads_cuda.pack_head_weights(_torch_tree(params), 12)
    jax_packed = jax_heads.pack_head_weights(params, 12)
    g1, gf, gl = _head_cotangents(rng, 300, ours_packed, jax_packed)
    _, vjp = jax.vjp(jax_heads.fused_heads, jax_packed, A, B)
    ref_dws, ref_dA, ref_dB = vjp((g1, gf, gl))
    bw = ours_packed[1].shape[0]
    dA, dB, dws = heads_cuda.fused_heads_backward_plain(
        ours_packed, torch.tensor(A), torch.tensor(B[:, :bw]),
        *[torch.tensor(g[:, :w.shape[1]]) for g, w in zip(
            (g1, gf, gl), (ours_packed[7], ours_packed[10],
                           ours_packed[13]))])
    if scale > 1:
        A_p = np.pad(A, ((0, 0), (0, jax_packed[0].shape[0] - 32)))
        S0 = jax_heads._forward_blocks(A_p, B, jax_packed)[2][:, 0]
        assert float(np.max(S0)) > 15.0
    ref_dB = np.asarray(ref_dB)[:, :bw]
    for ours, ref in ((dA, ref_dA), (dB, ref_dB)):
        _close(ours, ref, atol=ATOL * max(float(np.abs(ref).max()), 1.0))
    monkeypatch.setattr(heads_cuda, 'dot',
                        lambda a, b, _: a.double() @ b.double())
    exact = heads_cuda.fused_heads_backward_plain(
        [w.double() for w in ours_packed], torch.tensor(A).double(),
        torch.tensor(B[:, :bw]).double(),
        *[torch.tensor(g[:, :w.shape[1]]).double() for g, w in zip(
            (g1, gf, gl), (ours_packed[7], ours_packed[10],
                           ours_packed[13]))], torch.float64)
    for ours, ref, want in ((dA, ref_dA, exact[0]), (dB, ref_dB, exact[1])):
        want = want.numpy()
        port_err = float(np.abs(ours.numpy() - want).max())
        jax_err = float(np.abs(np.asarray(ref) - want).max())
        assert port_err <= jax_err + 2.0 ** -23 * float(
            np.abs(want).max()), (port_err, jax_err)
    assert len(dws) == 14
    for ours, ref in zip(dws, ref_dws):
        ref = np.asarray(ref)
        scale_w = max(float(np.abs(ref).max()), 1.0)
        _close(ours, ref[:ours.shape[0], :ours.shape[1]],
               atol=ATOL * scale_w)
        # Beyond the port's 16-wide padding the JAX gradient is zero.
        assert not ref[ours.shape[0]:].any()
        assert not ref[:, ours.shape[1]:].any()


def test_fused_heads_autograd_on_the_cpu_runs_the_plain_backward():
    """fused_heads on CPU tensors that need a graph differentiates through
    the plain backward (fp32 weight gradients, no kernel launch)."""
    params = _params()
    rng = np.random.default_rng(9)
    A, B = _head_blocks(rng, 100, 0.1)
    packed = [w.requires_grad_(True) for w in
              heads_cuda.pack_head_weights(_torch_tree(params), 12)]
    At = torch.tensor(A, requires_grad=True)
    Bt = torch.tensor(B[:, :32])
    _kernels.reset_launches()
    outs = heads_cuda.fused_heads(packed, At, Bt)
    cot = [torch.tensor(rng.normal(size=o.shape).astype(np.float32))
           for o in outs]
    got = torch.autograd.grad(outs, [At, *packed], cot)
    dA, _, dws = heads_cuda.fused_heads_backward_plain(
        [w.detach() for w in packed], At.detach(), Bt, *cot)
    torch.testing.assert_close(got[0], dA)
    for a, b in zip(got[1:], dws):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b)
    assert sum(_kernels.launches.values()) == 0


@pytest.mark.parametrize('n', [257, 1])
def test_fused_mlp3_backward_plain_matches_jax_vjp(n):
    params = _params()
    rng = np.random.default_rng(10)
    X = rng.uniform(-1, 1, (n, 36)).astype(np.float32)
    ours_packed = heads_cuda.pack_mlp3([torch.tensor(w)
                                        for w in params['proposal']])
    jax_packed = jax_heads.pack_mlp3(params['proposal'])
    g = np.zeros((n, 128), np.float32)
    g[:, :16] = rng.normal(size=(n, 16))
    _, vjp = jax.vjp(jax_heads.fused_mlp3, jax_packed, X)
    ref_dws, ref_dX = vjp(g)
    dX, dws = heads_cuda.fused_mlp3_backward_plain(
        ours_packed, torch.tensor(X), torch.tensor(g[:, :16]))
    _close(dX, ref_dX)
    for ours, ref in zip(dws, ref_dws):
        ref = np.asarray(ref)
        _close(ours, ref[:ours.shape[0], :ours.shape[1]],
               atol=ATOL * max(float(np.abs(ref).max()), 1.0))
    # Autograd of fused_mlp3 on the CPU takes the same plain backward.
    packed = [w.requires_grad_(True) for w in ours_packed]
    Xt = torch.tensor(X, requires_grad=True)
    got = torch.autograd.grad(heads_cuda.fused_mlp3(packed, Xt), [Xt, *packed],
                              torch.tensor(g[:, :16]))
    torch.testing.assert_close(got[0], dX)
    for a, b in zip(got[1:], dws):
        torch.testing.assert_close(a, b)


@pytest.mark.parametrize('hidden,d_out,n', [(16, 1, 257), (16, 5, 40),
                                            (128, 3, 257), (128, 16, 33)])
def test_fused_mlp3_backward_plain_matches_jax_vjp_at_other_widths(
        hidden, d_out, n):
    """dX and the three weight gradients at hidden 16 and 128 and more
    than one output column, against the VJP of heads_pallas.fused_mlp3
    (its _mlp3_bwd_kernel in interpret mode)."""
    rng = np.random.default_rng(12)
    weights = [(rng.normal(size=(a, b)) * np.sqrt(2.0 / a)).astype(
        np.float32) for a, b in ((36, hidden), (hidden, hidden),
                                 (hidden, d_out))]
    X = rng.uniform(-1, 1, (n, 36)).astype(np.float32)
    ours_packed = heads_cuda.pack_mlp3([torch.tensor(w) for w in weights])
    jax_packed = jax_heads.pack_mlp3(weights)
    width = ours_packed[2].shape[1]
    g = np.zeros((n, jax_packed[2].shape[1]), np.float32)
    g[:, :width] = rng.normal(size=(n, width))
    _, vjp = jax.vjp(jax_heads.fused_mlp3, jax_packed, X)
    ref_dws, ref_dX = vjp(g)
    dX, dws = heads_cuda.fused_mlp3_backward_plain(
        ours_packed, torch.tensor(X), torch.tensor(g[:, :width]))
    _close(dX, ref_dX)
    for ours, ref in zip(dws, ref_dws):
        ref = np.asarray(ref)
        _close(ours, ref[:ours.shape[0], :ours.shape[1]],
               atol=ATOL * max(float(np.abs(ref).max()), 1.0))
