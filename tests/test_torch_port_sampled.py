"""The flagship's encode in the port against the JAX package, on the CPU.

The simplex encode, the sampled backward's interpolation atoms, its point
subsample and its scatter (ops/encoders.py: the plain versions of the
hash-grid kernels K1s, K5 and K2s), the perturbed render and loss
gradients with sampled_backward, and the trainer's phase schedule. Both
packages compute in fp32 here, and the port is fed JAX's uniforms. Small
grids: 4 levels x 8 features x 2^10 rows. The points include x = 0 and 1,
points on cell faces and points whose fractions tie (x0 = x1), where
argmax and argmin must take the first index.

Tolerances: atoms equal, weights bit-equal (the same fp32 expressions in
the same order); a table gradient element within rtol 1e-4 plus
2 k 2^-24 of its terms' magnitudes (k its row's terms: two summation
orders), as hashgrid_cuda.backward_tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autolabel_tpu.ops import encoders as jax_encoders
from autolabel_tpu.render.renderer import RenderOptions as JaxRenderOptions
from autolabel_tpu.render.renderer import render_rays as jax_render_rays
from autolabel_tpu.train import trainer as jax_trainer
from autolabel_tpu.train.losses import LossOptions as JaxLossOptions
from autolabel_tpu.train.losses import compute_losses as jax_compute_losses
from autolabel_tpu_torch import bridge, model_utils
from autolabel_tpu_torch.ops import _kernels, encoders, hashgrid_cuda
from autolabel_tpu_torch.render.renderer import (RenderOptions,
                                                 draw_perturbations,
                                                 render_rays)
from autolabel_tpu_torch.train.losses import LossOptions, compute_losses
from autolabel_tpu_torch.train.trainer import SimpleTrainer, phase_schedule
from tests import test_torch_port_train as train_tests

RTOL = 1e-4
N = 96


def _grid(variant='native'):
    return dict(n_levels=4, n_features=8, log2_hashmap_size=10,
                base_resolution=8, per_level_scale=1.6, variant=variant)


def _configs(variant='native'):
    return (jax_encoders.HashGridConfig(**_grid(variant)),
            encoders.HashGridConfig(**_grid(variant)))


def _points(rng, n=N):
    """Uniform points, the cube's corners, points on cell faces of every
    level (a coordinate at 0.5 or at a multiple of 1/8) and points whose
    fractions tie on every level (x0 = x1, or all three equal)."""
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    x[:4] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 0.5],
             [1.0, 0.0, 0.999999]]
    x[4:10, 2] = 0.5
    x[10:14, 0] = 0.375
    x[14:24, 1] = x[14:24, 0]
    x[24:28] = x[24:28, :1]
    return x


def _table(rng):
    return rng.uniform(-1.0, 1.0, (4, 1024, 8)).astype(np.float32)


def _cotangent(rng, n=N, width=32):
    """Cotangent rows of spread magnitudes, a third of them zero (the
    volume render's empty space), as the point subsample sees them."""
    g = rng.normal(size=(n, width)) * np.exp(rng.normal(size=(n, 1)))
    g[::3] = 0.0
    return g.astype(np.float32)


def _rows_tuple(rows):
    return rows if isinstance(rows, tuple) else (rows,) * 4


def _sum_order_tolerance(g, idx, w, u, rows, config, sel=None, coef=None):
    return hashgrid_cuda.sampled_backward_tolerance(
        torch.tensor(g), idx, w, torch.tensor(u), _rows_tuple(rows), config,
        None if sel is None else torch.tensor(np.array(sel)),
        None if coef is None else torch.tensor(np.array(coef)))


def _margin(g, u_sys, k):
    """How far every k cum_i - u_sys lies from an integer (cum from float64
    sums), against the bound n k 2^-24 within which two fp32 scans in other
    orders may move it."""
    s = np.sqrt((g.astype(np.float64) ** 2).sum(-1))
    cum = np.cumsum(s) / s.sum()
    v = k * cum - u_sys
    return float(np.abs(v - np.round(v)).min()), len(g) * k * 2.0 ** -24


@pytest.mark.parametrize('variant', ['native', 'tcnn', 'torch_ngp'])
def test_simplex_eval_forward_matches_jax(variant):
    rng = np.random.default_rng(0)
    jc, pc = _configs(variant)
    table, x = _table(rng), _points(rng)
    ref = np.asarray(jax_encoders._encode_rows_simplex(table, x, jc))
    _kernels.reset_launches()
    with torch.no_grad():
        ours = hashgrid_cuda.hashgrid_encode(torch.tensor(table),
                                             torch.tensor(x), pc,
                                             interp='simplex')
    assert sum(_kernels.launches.values()) == 0  # the plain version
    # 4 fp32 products summed in the same order: at most 2 * 4 * 2^-24 of
    # the terms' magnitudes (|table| <= 1, weights summing to 1) apart.
    np.testing.assert_allclose(ours.numpy(), ref, rtol=RTOL,
                               atol=8 * 2.0 ** -24)


@pytest.mark.parametrize('interp', ['simplex', 'trilinear'])
@pytest.mark.parametrize('variant', ['native', 'tcnn', 'torch_ngp'])
def test_atoms_match_jax(interp, variant):
    """Indices equal and weights bit-equal, ties and faces included."""
    rng = np.random.default_rng(1)
    jc, pc = _configs(variant)
    x = _points(rng)
    ref_idx, ref_w = jax_encoders._corner_idx_weights(x, jc, interp)
    idx, w = encoders._corner_idx_weights(torch.tensor(x), pc, interp)
    assert idx.dtype == torch.int32 and w.dtype == torch.float32
    assert idx.shape == (4, 4 if interp == 'simplex' else 8, N)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(w.numpy(), np.asarray(ref_w))


def test_simplex_ties_take_the_first_index():
    """Fractions (0.5, 0.5, 0) tie for the max and (0.25, 0.25, 0.75) for
    the min: the path takes the first axis, as jnp.argmax / argmin, and
    the residual pair's max-weight atom is the first of the tied ones."""
    frac = torch.tensor([[0.5, 0.25], [0.5, 0.25], [0.0, 0.75]])
    offsets, w = encoders._simplex_corners(frac)
    np.testing.assert_array_equal(offsets[1, :, 0].numpy(), [1, 0, 0])
    np.testing.assert_array_equal(offsets[2, :, 1].numpy(), [0, 1, 1])
    jax_offsets, jax_w = jax_encoders._simplex_corners(frac.numpy())
    np.testing.assert_array_equal(offsets.numpy(), np.asarray(jax_offsets))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jax_w))
    # point 0: weights (0.5, 0, 0.5, 0): atoms 0 and 2 tie for the max
    idx = torch.arange(8, dtype=torch.int64).reshape(4, 2)
    (first, w_m), _ = encoders._draw_rows(idx, w, torch.tensor([0.3, 0.3]),
                                          2)
    assert int(first[0]) == int(idx[0, 0]) and float(w_m[0]) == 0.5


@pytest.mark.parametrize('interp', ['simplex', 'trilinear'])
@pytest.mark.parametrize('point_frac', [1.0, 0.25])
def test_sampled_forward_matches_jax(interp, point_frac):
    rng = np.random.default_rng(2)
    jc, pc = _configs()
    table, x = _table(rng), _points(rng)
    u = rng.uniform(size=(4, N + (point_frac < 1))).astype(np.float32)
    ref = jax_encoders._encode_sampled_bwd(jc, interp, (2,) * 4, point_frac,
                                           table, x, u)
    ours = encoders.hashgrid_encode(
        torch.tensor(table), torch.tensor(x), pc, interp=interp,
        sampled_backward=2, backward_points=point_frac, u=torch.tensor(u))
    # the same atoms, products and sums in the same order
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=8 * 2.0 ** -24)


def _jax_and_port_gradients(rng, interp, rows, point_frac, variant='native'):
    jc, pc = _configs(variant)
    table, x, g = _table(rng), _points(rng), _cotangent(rng)
    u = rng.uniform(size=(4, N + (point_frac < 1))).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jax_encoders._encode_sampled_bwd(
        jc, interp, _rows_tuple(rows), point_frac, t, x, u), table)
    (ref,) = vjp(g)
    t = torch.tensor(table, requires_grad=True)
    out = encoders.hashgrid_encode(t, torch.tensor(x), pc, interp=interp,
                                   sampled_backward=rows,
                                   backward_points=point_frac,
                                   u=torch.tensor(u))
    (ours,) = torch.autograd.grad(out, t, torch.tensor(g))
    return np.asarray(ref), ours, (jc, pc, x, g, u)


@pytest.mark.parametrize('point_frac', [1.0, 0.25])
@pytest.mark.parametrize('interp,rows', [
    ('simplex', 1), ('simplex', 2), ('simplex', 4),
    ('simplex', (4, 4, 2, 2)), ('trilinear', 2)])
def test_sampled_table_gradient_matches_jax_vjp(interp, rows, point_frac):
    """The table gradient against jax.vjp of _encode_sampled_bwd, fed
    JAX's u. With backward_points 0.25 the inputs lie away from the
    subsample's boundaries, so both packages select the same points."""
    rng = np.random.default_rng(3)
    ref, ours, (_, pc, x, g, u) = _jax_and_port_gradients(
        rng, interp, rows, point_frac)
    idx, w = encoders._corner_idx_weights(torch.tensor(x), pc, interp)
    sel = coef = None
    if point_frac < 1.0:
        k = encoders.backward_subsample(N, point_frac)
        margin, bound = _margin(g, float(u[0, N]), k)
        assert margin > bound, (margin, bound)
        sel, coef = encoders._select_backward_points(torch.tensor(g),
                                                     float(u[0, N]), k)
    tol = _sum_order_tolerance(g, idx, w, u, rows, pc, sel, coef).numpy()
    err = np.abs(ours.numpy() - ref)
    assert np.all(err <= tol + RTOL * np.abs(ref)), float(err.max())
    assert np.abs(ref).max() > 0


def test_selection_matches_jax_as_sets():
    """(sel, coef) of the plain subsample equal JAX's top_k output as sets
    (JAX pads to k with coef-0 rows), on inputs away from the boundaries;
    and the scatter fed JAX's (sel, coef) gives JAX's table gradient."""
    rng = np.random.default_rng(4)
    jc, pc = _configs()
    x, g = _points(rng), _cotangent(rng)
    u = rng.uniform(size=(4, N + 1)).astype(np.float32)
    k = encoders.backward_subsample(N, 0.25)
    margin, bound = _margin(g, float(u[0, N]), k)
    assert margin > bound, (margin, bound)
    ref_sel, ref_coef = jax_encoders._select_backward_points(
        jnp.asarray(g), u[0, N], k)
    ref_sel, ref_coef = np.asarray(ref_sel), np.asarray(ref_coef)
    live = ref_coef > 0
    sel, coef = encoders._select_backward_points(torch.tensor(g),
                                                 float(u[0, N]), k)
    order = np.argsort(ref_sel[live])
    np.testing.assert_array_equal(sel.numpy(), ref_sel[live][order])
    np.testing.assert_allclose(coef.numpy(), ref_coef[live][order],
                               rtol=1e-5)
    assert len(sel) < k  # some points drawn more than once
    # The scatter fed one (sel, coef): JAX's, padding rows included, into
    # both packages' scatters (JAX's through its backward with every point
    # kept, on the selected points' gathered inputs).
    idx, w = jax_encoders._corner_idx_weights(x, jc, 'simplex')
    rows = (1, 2, 4, 2)
    g_sc = jnp.asarray(g)[ref_sel] * ref_coef[:, None]
    ref = jax_encoders._encode_sampled_bwd_bwd(
        jc, 'simplex', rows, 1.0, (idx[:, :, ref_sel], w[:, :, ref_sel],
                                   u[:, ref_sel]), g_sc)[0]
    ours = encoders.sampled_scatter_plain(
        torch.tensor(g), torch.tensor(np.asarray(idx)),
        torch.tensor(np.asarray(w)), torch.tensor(u), rows, pc,
        torch.tensor(ref_sel).long(), torch.tensor(ref_coef))
    tol = _sum_order_tolerance(g, torch.tensor(np.asarray(idx)),
                               torch.tensor(np.asarray(w)), u, rows, pc,
                               ref_sel, ref_coef).numpy()
    err = np.abs(ours.numpy() - np.asarray(ref))
    assert np.all(err <= tol + RTOL * np.abs(np.asarray(ref)))


_TILE = hashgrid_cuda.SELECT_TILE
_CHAIN_SHAPES = [(n, dim) for n in (1, _TILE - 1, _TILE + 1, 3 * _TILE + 17)
                 for dim in (8, 512)]


def _chain_cotangent(n, dim):
    """A bf16 cotangent as K5 reads it: rows of spread magnitudes, a third
    zero, every seventh scaled by 1e-22 (its squares underflow in fp32)."""
    rng = np.random.default_rng(n * 7 + dim)
    g = rng.normal(size=(n, dim)) * np.exp(rng.normal(size=(n, 1)))
    g[::3] = 0.0
    g[1::7] *= 1e-22
    return torch.tensor(g.astype(np.float32)).to(torch.bfloat16)


def _chain_draws(g, seed):
    """K5 emulated on the CPU from select_chain: its workspace views, the
    cum it floors, and (sel, coef, count) as its compaction writes them;
    plus k and u_sys."""
    n = g.shape[0]
    k = max(1, n // 4)
    u_sys = np.float32(np.random.default_rng(seed).uniform())
    s, loc, tile_total = hashgrid_cuda.select_chain(g)
    offsets = np.empty_like(tile_total)
    total = np.float32(0.0)
    for b, t in enumerate(tile_total):
        offsets[b] = total
        total = np.float32(total + t)
    partial = (np.repeat(offsets, _TILE)[:n] + loc).astype(np.float32)
    cum = partial / total if total > 0 else (
        np.arange(1, n + 1, dtype=np.float32) / np.float32(n))
    c = np.floor((np.float32(k) * cum - u_sys).astype(np.float32))
    counts = np.diff(c, prepend=np.float32(-1.0)).astype(np.int64)
    p = s / total if total > 0 else np.full(n, 1.0 / n, np.float32)
    sel = np.nonzero(counts > 0)[0][:k]
    coef = (counts[sel].astype(np.float32)
            / (np.float32(k) * np.maximum(p[sel], np.float32(1e-30))))
    views = dict(s=torch.from_numpy(s), loc=torch.from_numpy(loc),
                 counts=torch.from_numpy(counts.astype(np.int32)),
                 tile_total=torch.from_numpy(tile_total),
                 total=torch.tensor(total))
    return (views, partial, cum, torch.from_numpy(sel.astype(np.int32)),
            torch.from_numpy(coef.astype(np.float32)),
            torch.tensor([len(sel)], dtype=torch.int32), k, u_sys)


@pytest.mark.parametrize('n,dim', _CHAIN_SHAPES)
def test_select_chain_scan_never_decreases_and_chains_its_tiles(n, dim):
    """select_chain, K5's fp32 order on the CPU: its scan (each tile's
    offset plus its inclusive scan, over the chained total) never
    decreases within or across tiles; each tile's total is its scan's
    last value, and the tiles' totals chained in order give the last
    partial sum; the k cum - u it floors lies within select_scan_bound
    of float64's (n = 1 draws the all-zero row: the uniform branch)."""
    g = _chain_cotangent(n, dim)
    views, partial, cum, _, _, _, k, u_sys = _chain_draws(g, n + dim)
    loc, tile_total = views['loc'].numpy(), views['tile_total'].numpy()
    assert len(tile_total) == -(-n // _TILE)
    assert np.all(np.diff(partial) >= 0) and np.all(np.diff(cum) >= 0)
    assert cum[-1] == 1.0
    last = np.minimum(np.arange(1, len(tile_total) + 1) * _TILE, n) - 1
    assert np.array_equal(tile_total.view(np.int32), loc[last].view(np.int32))
    assert partial[-1].tobytes() == views['total'].numpy().tobytes()
    s64 = np.sqrt((g.double().numpy() ** 2).sum(-1))
    p64 = s64 / s64.sum() if s64.sum() > 0 else np.full(n, 1.0 / n)
    v64 = k * np.cumsum(p64) - np.float64(u_sys)
    v32 = (np.float32(k) * cum - u_sys).astype(np.float32)
    dev = float(np.abs(v32.astype(np.float64) - v64).max())
    assert dev <= hashgrid_cuda.select_scan_bound(n, k, dim), dev


@pytest.mark.parametrize('n,dim', _CHAIN_SHAPES)
def test_select_chain_selection_holds_against_float64_and_plain(n, dim):
    """The selection drawn from select_chain's scan, as K5's compaction
    writes it, passes every condition check_selection holds K5 to: its
    counts the floors of its own scan, its scan and coefs within their
    float64 bounds, and against the plain subsample
    (encoders._select_backward_points) every differing count explained by
    an integer within the two scans' deviations of the float64 value, and
    the coefs equal within their bounds wherever the counts agree."""
    g = _chain_cotangent(n, dim)
    views, _, _, sel, coef, count, k, u_sys = _chain_draws(g, n + dim)
    check = hashgrid_cuda.check_selection(g, u_sys, k, sel, coef, count,
                                          views)
    failures = hashgrid_cuda.selection_failures(check, n, k, dim)
    assert not failures, (failures, check)
    assert check['compared'] == int(count[0]) > 0
    assert check['plain_compared'] > 0


@pytest.mark.parametrize('rows,point_frac', [(2, 0.25), (1, 0.25),
                                             ((4, 4, 2, 2), 0.5)])
def test_sampled_estimator_is_unbiased(rows, point_frac):
    """The mean of the sampled table gradient over 400 draws of u is the
    exact simplex gradient: |mean - exact| within 4 standard errors in
    the norm, the standard errors from the draws' own spread (the norm's
    square is expected to be their sum)."""
    rng = np.random.default_rng(5)
    _, pc = _configs()
    x, g = torch.tensor(_points(rng)), torch.tensor(_cotangent(rng))
    idx, w = encoders._corner_idx_weights(x, pc, 'simplex')
    exact = encoders.sampled_scatter_plain(g, idx, w, None, (4,) * 4, pc)
    draws = 400
    gen = torch.Generator().manual_seed(6)
    total = torch.zeros_like(exact)
    total_sq = torch.zeros_like(exact)
    for _ in range(draws):
        u = torch.rand((4, N + 1), generator=gen)
        est = encoders.sampled_backward_plain(g, idx, w, u, _rows_tuple(rows),
                                              pc, point_frac)
        total += est
        total_sq += est * est
    mean = total / draws
    var = (total_sq / draws - mean * mean).clamp(min=0) * draws / (draws - 1)
    se = float(torch.sqrt(var.sum() / draws))
    err = float((mean - exact).norm())
    assert err <= 4.0 * se, (err, se)
    assert float((mean - exact).norm() / exact.norm()) < 0.1


def test_sampled_cotangents_of_x_and_u_are_zero():
    rng = np.random.default_rng(7)
    _, pc = _configs()
    t = torch.tensor(_table(rng), requires_grad=True)
    x = torch.tensor(_points(rng), requires_grad=True)
    u = torch.rand((4, N + 1), requires_grad=True)
    out = encoders.hashgrid_encode(t, x, pc, interp='simplex',
                                   sampled_backward=2, backward_points=0.25,
                                   u=u)
    out.backward(torch.tensor(_cotangent(rng)))
    assert x.grad is None or not bool(x.grad.any())
    assert u.grad is None or not bool(u.grad.any())
    assert bool(t.grad.any())


def test_exact_simplex_gradient_matches_jax_and_the_exact_scatter():
    """Autograd of the exact simplex encode (the CPU oracle of its card
    backward, K2s with every level at 4 rows) against JAX's."""
    rng = np.random.default_rng(8)
    jc, pc = _configs()
    table, x, g = _table(rng), _points(rng), _cotangent(rng)
    _, vjp = jax.vjp(lambda t: jax_encoders.hashgrid_encode(
        t, x, jc, interp='simplex'), table)
    (ref,) = vjp(g)
    t = torch.tensor(table, requires_grad=True)
    out = hashgrid_cuda.hashgrid_encode(t, torch.tensor(x), pc,
                                        interp='simplex')
    (ours,) = torch.autograd.grad(out, t, torch.tensor(g))
    idx, w = encoders._corner_idx_weights(torch.tensor(x), pc, 'simplex')
    scatter = hashgrid_cuda.sampled_scatter(torch.tensor(g), idx, w, None,
                                            (4,) * 4, pc)
    tol = _sum_order_tolerance(g, idx, w, np.zeros((4, N), np.float32),
                               (4,) * 4, pc).numpy()
    for got in (ours.numpy(), scatter.numpy()):
        err = np.abs(got - np.asarray(ref))
        assert np.all(err <= tol + RTOL * np.abs(np.asarray(ref)))


def _render_case(heads_impl, point_frac, rows=2, upsample=False):
    """JAX's and the port's perturbed render + losses on the same params,
    batch and uniforms (u_enc from JAX's k_enc, u_enc_upsample from
    fold_in(k_enc, 1), as JAX renderer.py:318 draws it), simplex field; with
    upsample, no proposal net and a second, importance-sampled query."""
    over = dict(heads_impl=heads_impl, grid_interp='simplex')
    steps = dict(train_tests.STEPS)
    if upsample:
        over['proposal'] = False
        steps = dict(num_steps=8, upsample_steps=8)
    params = train_tests._params(**over)
    batch = train_tests._batch()
    jf = train_tests._jax_field(**over)
    jopts = JaxRenderOptions(perturb=True, stochastic_corners=0,
                             sampled_backward=rows,
                             backward_points=point_frac, **steps)
    key = jax.random.PRNGKey(11)

    def jax_loss(p):
        out = jax_render_rays(jf, p, batch['rays_o'], batch['rays_d'],
                              batch['direction_norms'][:, None], key=key,
                              options=jopts)
        loss, parts = jax_compute_losses(out, batch, JaxLossOptions())
        return loss, (parts, out)

    (ref_loss, (ref_parts, ref_out)), ref_grads = jax.value_and_grad(
        jax_loss, has_aux=True)(params)
    pf = train_tests._port_field(params, **over)
    tb = train_tests._torch_batch(batch)
    draws = {k: torch.tensor(v) for k, v in
             train_tests._jax_draws(key, jopts).items()}
    _, _, _, k_enc = jax.random.split(key, 4)
    extra = int(point_frac < 1)
    draws['u_enc'] = torch.tensor(np.asarray(jax.random.uniform(
        k_enc, (2, train_tests.N_RAYS * steps['num_steps'] + extra))))
    if upsample:
        draws['u_enc_upsample'] = torch.tensor(np.asarray(
            jax.random.uniform(jax.random.fold_in(k_enc, 1), (
                2, train_tests.N_RAYS * steps['upsample_steps'] + extra))))
    out = render_rays(pf, tb['rays_o'], tb['rays_d'], tb['direction_norms'],
                      options=RenderOptions(perturb=True, stochastic_corners=0,
                                            sampled_backward=rows,
                                            backward_points=point_frac,
                                            **steps),
                      draws=draws)
    loss, parts = compute_losses(out, tb, LossOptions())
    names = [n for n, _ in pf.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in pf.named_parameters()])
    ours = bridge.state_to_numpy(dict(zip(names, grads)))
    return (loss, parts, out, ours), (ref_loss, ref_parts, ref_out, ref_grads)


@pytest.mark.parametrize('heads_impl,point_frac,upsample', [
    ('xla', 0.25, False), ('xla', 1.0, False), ('pallas', 0.25, False),
    ('pallas', 1.0, False), ('xla', 0.25, True)])
def test_perturbed_render_and_loss_gradients_match_jax(heads_impl,
                                                       point_frac, upsample):
    """render_rays + compute_losses with the simplex field, sampled_backward
    2 and backward_points 0.25 and 1.0, under both head implementations
    (JAX's fused heads in interpret mode), and the upsample branch's two
    sampled queries: outputs, losses and every parameter's gradient, leaf
    by leaf as in test_torch_port_train."""
    (loss, parts, out, ours), (ref_loss, ref_parts, ref_out, ref_grads) = \
        _render_case(heads_impl, point_frac, upsample=upsample)
    assert set(out) == set(ref_out)
    for k in ref_out:
        train_tests._close(out[k], ref_out[k], atol=1e-5)
    train_tests._close(loss, ref_loss)
    for k in ref_parts:
        train_tests._close(parts[k], ref_parts[k])
    train_tests._close_trees(ours, ref_grads, leaf_atol=None if upsample
                             else train_tests._proposal_atol(
                                 train_tests.STEPS))
    assert float(np.abs(ours['encoder']['grid']).max()) > 0


def test_render_draws_the_encode_uniforms():
    """draw_perturbations adds u_enc, (L, points [+ 1]), with the sampled
    backward; render_rays draws it from the generator and refuses draws
    without it."""
    opts = RenderOptions(perturb=True, stochastic_corners=2,
                         sampled_backward=2, backward_points=0.25,
                         **train_tests.STEPS)
    gen = torch.Generator().manual_seed(3)
    draws = draw_perturbations(gen, 64, opts, grid_levels=2)
    assert draws['u_enc'].shape == (2, 64 * 8 + 1)
    full = dataclasses.replace(opts, backward_points=1.0)
    assert draw_perturbations(gen, 64, full, 2)['u_enc'].shape == (2, 512)
    assert 'u_enc' not in draw_perturbations(
        gen, 64, dataclasses.replace(opts, sampled_backward=0), 2)
    params = train_tests._params(grid_interp='simplex')
    pf = train_tests._port_field(params, grid_interp='simplex')
    tb = train_tests._torch_batch(train_tests._batch())
    args = (pf, tb['rays_o'], tb['rays_d'], tb['direction_norms'])
    a = render_rays(*args, key=torch.Generator().manual_seed(3),
                    options=opts)
    b = render_rays(*args, options=opts, draws=draw_perturbations(
        torch.Generator().manual_seed(3), 64, opts, 2))
    torch.testing.assert_close(a['image'], b['image'])
    no_enc = {k: v for k, v in draws.items() if k != 'u_enc'}
    with pytest.raises(ValueError):
        render_rays(*args, options=opts, draws=no_enc)


def test_sampled_backward_flag_parses_as_scripts_train():
    for spec in ('2', '0', '4,4,2,2', 2, (1, 1, 2, 2)):
        assert model_utils.parse_sampled_backward(spec) == \
            jax_encoders.parse_sampled_backward(spec)


def _jax_phases(monkeypatch, options, iters, **fractions):
    """The JAX trainer's phases: (first_step, render options) per phase,
    read by recording the options each phase's step is built with."""
    built = []

    def record(field, tx, loss_options, render_options, **kwargs):
        built.append(render_options)
        return lambda *a: None

    monkeypatch.setattr(jax_trainer, '_make_step', record)
    jt = jax_trainer.SimpleTrainer('t', train_tests._jax_field(), lr=5e-3,
                                   iters=iters, render_options=options,
                                   **fractions)
    return [(start, o) for (start, _), o in zip(jt._phases, built)]


@pytest.mark.parametrize('fractions', [
    {}, dict(sampled_warmup_fraction=0.1),
    dict(exact_final_fraction=0.2),
    dict(sampled_warmup_fraction=0.05, exact_final_fraction=0.3)])
@pytest.mark.parametrize('sampled_backward', [2, 1, 0])
def test_phase_schedule_matches_jax(monkeypatch, fractions,
                                    sampled_backward):
    """The port picks the same render options as the JAX trainer at every
    global_step: sampled-backward-1 warm-up (only from 2), the configured
    options, then exact gathers."""
    stochastic = 0 if sampled_backward else 1
    kw = dict(num_steps=8, proposal_steps=16, perturb=True,
              stochastic_corners=stochastic,
              sampled_backward=sampled_backward, backward_points=0.25)
    iters = 1000
    ref = _jax_phases(monkeypatch, JaxRenderOptions(**kw), iters,
                      **fractions)
    ours = phase_schedule(RenderOptions(**kw), iters, **fractions)
    assert [s for s, _ in ours] == [s for s, _ in ref]
    for (_, a), (_, b) in zip(ours, ref):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    if sampled_backward:  # the stochastic-only estimator stays refused
        trainer = SimpleTrainer(
            't', train_tests._port_field(train_tests._params()), lr=5e-3,
            iters=iters, render_options=RenderOptions(**kw), **fractions)
        for step in (0, 49, 50, 99, 100, 699, 700, 999, 5000):
            want = [o for s, o in ref if step >= s][-1]
            assert dataclasses.asdict(trainer.step_options(step)) == \
                dataclasses.asdict(want)
