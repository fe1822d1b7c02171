"""The stochastic-corner and residual encodes in the port against the JAX
package, on the CPU.

The JAX package draws the estimators' uniforms from a PRNG key; the port
takes them as a tensor `u`. Each case makes JAX's own draws as its encode
makes them (jax.random.split(key, D), then uniform; the residual encode's
uniform(key, (L, N))), hands them to the port and compares with
autolabel_tpu.ops.encoders.hashgrid_encode(key=...): the plain versions of
the stochastic encode kernel (K6: stochastic_rows and blend_drawn_rows)
and of its table gradient (K7: stochastic_scatter_plain), the perturbed
render, a trainer step and the train CLI. Small grids: 4 levels x 2^10
rows x 8 features (wide rows) or x 2 (narrow), the points of
test_torch_port_sampled (cube corners, cell faces, tied fractions).

Tolerances:
- drawn rows: equal, as integers, to the rows JAX's own expressions draw
  (the same fp32 comparisons);
- a DRAWS level's output (a mean of drawn rows): bit-equal (the same fp32
  sums, then the product with 1 / n_samples that XLA makes of JAX's
  division);
- an EXACT or RESIDUAL level's output: within 2 R 2^-24 of the terms'
  magnitudes (R the level's rows), because XLA fuses a product into the
  next sum where the port rounds each;
- a table gradient element: within 2 k 2^-24 of its terms' magnitudes, k
  the terms of its row (two summation orders), as
  hashgrid_cuda.stochastic_backward_tolerance derives it.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autolabel_tpu.ops import encoders as jax_encoders
from autolabel_tpu.render.renderer import RenderOptions as JaxRenderOptions
from autolabel_tpu.render.renderer import render_rays as jax_render_rays
from autolabel_tpu.train.losses import LossOptions as JaxLossOptions
from autolabel_tpu.train.losses import compute_losses as jax_compute_losses
from autolabel_tpu.train.trainer import SimpleTrainer as JaxSimpleTrainer
from autolabel_tpu_torch import bridge
from autolabel_tpu_torch.ops import _kernels, encoders, hashgrid_cuda
from autolabel_tpu_torch.render.renderer import (RenderOptions,
                                                 draw_perturbations,
                                                 render_rays)
from autolabel_tpu_torch.train import __main__ as port_cli
from autolabel_tpu_torch.train.losses import LossOptions, compute_losses
from autolabel_tpu_torch.train.trainer import SimpleTrainer
from autolabel_tpu_torch.utils import fixtures
from tests import test_torch_port_sampled as sampled_tests
from tests import test_torch_port_train as train_tests

N = sampled_tests.N


def _configs(n_features=8, n_levels=4):
    kw = dict(n_levels=n_levels, n_features=n_features, log2_hashmap_size=10,
              base_resolution=8, per_level_scale=1.6)
    return (jax_encoders.HashGridConfig(**kw),
            encoders.HashGridConfig(**kw))


def _jax_uniforms(key, shape):
    """The uniforms JAX's encode draws from `key` for an estimator whose
    port takes u of `shape` (encoders.uniform_shape): one uniform of (L, N)
    (residual), or one of shape[1:] per key of split(key, D)."""
    if len(shape) == 2:
        return np.asarray(jax.random.uniform(key, shape))
    keys = jax.random.split(key, shape[0])
    return np.stack([np.asarray(jax.random.uniform(k, shape[1:]))
                     for k in keys])


def _jax_rows(x, jc, u, plan, interp, n_samples):
    """The (S, N) rows JAX's encodes gather, from its own expressions
    (encoders._grid_geometry, _corner_index, _simplex_corners, _CORNERS,
    jnp.cumsum, argmax): the draws of _encode_stochastic(_simplex) and
    _encode_residual, and the atoms of the exact levels."""
    cell, frac, stride, use_dense, size = jax_encoders._grid_geometry(
        jnp.asarray(x), jc)
    rows = []

    def index(l, off):
        return np.asarray(jax_encoders._corner_index(
            cell[:, l], (off[0], off[1], off[2]), stride[l], use_dense[l],
            size[l]))

    def pick(offsets, i):
        return jnp.where(i[None] == 0, offsets[0], jnp.where(
            i[None] == 1, offsets[1], jnp.where(i[None] == 2, offsets[2],
                                                offsets[3])))

    for l, (kind, count) in enumerate(plan):
        if interp == 'simplex':
            offsets, weights = jax_encoders._simplex_corners(frac[:, l])
            atom_offs = [offsets[a] for a in range(4)]
        else:
            weights = jnp.stack([jax_encoders._corner_weight(frac[:, l], c)
                                 for c in jax_encoders._CORNERS])
            atom_offs = [jnp.asarray(c)[:, None] + 0 * cell[:, l]
                         for c in jax_encoders._CORNERS]
        if kind == encoders.EXACT:
            rows += [index(l, o) for o in atom_offs]
        elif kind == encoders.RESIDUAL:
            m = jnp.argmax(weights, axis=0)
            wr = jnp.where(jnp.arange(weights.shape[0])[:, None] == m[None],
                           0.0, weights)
            cum = jnp.cumsum(wr, axis=0) / jnp.maximum(wr.sum(axis=0), 1e-12)
            j = (jnp.asarray(u[l])[None] > cum[:-1]).sum(axis=0)
            for a in (m, j):
                if interp == 'simplex':
                    rows.append(index(l, pick(offsets, a)))
                else:
                    rows.append(index(l, jnp.stack([(a >> 2) & 1,
                                                    (a >> 1) & 1, a & 1])))
        else:
            for r in range(count):
                s, flip = encoders._draw_set(r, n_samples)
                if interp == 'simplex':
                    v = jnp.asarray(u[s, l])
                    v = 1.0 - v if flip else v
                    cum = jnp.cumsum(weights[:3], axis=0)
                    rows.append(index(l, pick(offsets,
                                              (v[None] > cum).sum(axis=0))))
                else:
                    v = jnp.asarray(u[s, :, l])
                    v = 1.0 - v if flip else v
                    rows.append(index(l, (v < frac[:, l]).astype(jnp.int32)))
    return np.stack(rows)


# (interp, n_features, n_samples, residual): trilinear wide and narrow at
# 1, 2, 3 and 33 samples (more rows a level than a 32-lane warp holds:
# the kernels fold them in rounds), simplex at 1 and 2, residual with both
# interps; each at exact_levels 0, 1 and L.
MODES = [('trilinear', 8, 1, False), ('trilinear', 8, 2, False),
         ('trilinear', 8, 3, False), ('trilinear', 2, 1, False),
         ('trilinear', 2, 2, False), ('trilinear', 2, 3, False),
         ('simplex', 8, 1, False), ('simplex', 8, 2, False),
         ('trilinear', 8, 2, True), ('simplex', 8, 2, True),
         ('trilinear', 8, 33, False), ('trilinear', 2, 33, False)]


def _mode_id(mode):
    interp, f, n, residual = mode
    return f'{"residual-" if residual else ""}{interp}-F{f}-n{n}'


def _case(mode, exact_levels, seed=0):
    interp, f, n_samples, residual = mode
    rng = np.random.default_rng(seed)
    jc, pc = _configs(f)
    table = rng.uniform(-1.0, 1.0, (4, 1024, f)).astype(np.float32)
    x = sampled_tests._points(rng)
    key = jax.random.PRNGKey(seed + 5)
    shape = encoders.uniform_shape(4, N, interp, n_samples, residual)
    u = _jax_uniforms(key, shape)
    plan = encoders.stochastic_plan(pc, interp, n_samples, exact_levels,
                                    residual)
    kw = dict(n_samples=n_samples, exact_levels=exact_levels, interp=interp,
              residual=residual)
    return dict(jc=jc, pc=pc, table=table, x=x, key=key, u=u, plan=plan,
                kw=kw, g=sampled_tests._cotangent(rng, width=4 * f))


def _column_tolerance(c, idx, w):
    """Per output element: 0 on DRAWS levels, 2 R 2^-24 of the terms'
    magnitudes on EXACT and RESIDUAL levels."""
    f = c['pc'].n_features
    magnitude = encoders.blend_drawn_rows(torch.tensor(c['table']).abs(), idx,
                                          w.abs(), c['plan'],
                                          c['kw']['n_samples'])
    tol = torch.zeros_like(magnitude)
    for l, (kind, rows) in enumerate(c['plan']):
        if kind != encoders.DRAWS:
            cols = slice(l * f, (l + 1) * f)
            tol[:, cols] = 2 * rows * 2.0 ** -24 * magnitude[:, cols]
    return tol.numpy()


@pytest.mark.parametrize('exact_levels', [0, 1, 4])
@pytest.mark.parametrize('mode', MODES, ids=_mode_id)
def test_stochastic_encode_matches_jax(mode, exact_levels):
    """The rows drawn equal JAX's; the encode bit-equal to JAX's on DRAWS
    levels and within the stated bound elsewhere; the wrapper on CPU
    tensors launches no kernel."""
    c = _case(mode, exact_levels)
    ref = np.asarray(jax_encoders.hashgrid_encode(c['table'], c['x'], c['jc'],
                                                  key=c['key'], **c['kw']))
    x, u = torch.tensor(c['x']), torch.tensor(c['u'])
    idx, w = encoders.stochastic_rows(x, c['pc'], u, c['plan'],
                                      c['kw']['interp'],
                                      c['kw']['n_samples'])
    np.testing.assert_array_equal(
        idx.numpy(), _jax_rows(c['x'], c['jc'], c['u'], c['plan'],
                               c['kw']['interp'], c['kw']['n_samples']))
    _kernels.reset_launches()
    with torch.no_grad():
        ours = hashgrid_cuda.hashgrid_encode(torch.tensor(c['table']), x,
                                             c['pc'], u=u, **c['kw'])
    assert sum(_kernels.launches.values()) == 0  # the plain version
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    err = np.abs(ours.numpy() - ref)
    assert np.all(err <= _column_tolerance(c, idx, w))
    # the plain version of K6 is the rows blended
    np.testing.assert_array_equal(
        ours.numpy(), encoders.blend_drawn_rows(torch.tensor(c['table']),
                                                idx, w, c['plan'],
                                                c['kw']['n_samples']).numpy())


@pytest.mark.parametrize('exact_levels', [0, 1, 4])
@pytest.mark.parametrize('mode', MODES, ids=_mode_id)
def test_stochastic_table_gradient_matches_jax(mode, exact_levels):
    """Autograd of the plain encode and the plain scatter from its rows
    (K7's plain version) against jax.vjp, within the term-count bound."""
    c = _case(mode, exact_levels, seed=1)
    _, vjp = jax.vjp(lambda t: jax_encoders.hashgrid_encode(
        t, c['x'], c['jc'], key=c['key'], **c['kw']), c['table'])
    (ref,) = vjp(c['g'])
    ref = np.asarray(ref)
    t = torch.tensor(c['table'], requires_grad=True)
    x, u, g = (torch.tensor(c['x']), torch.tensor(c['u']),
               torch.tensor(c['g']))
    out = hashgrid_cuda.hashgrid_encode(t, x, c['pc'], u=u, **c['kw'])
    (ours,) = torch.autograd.grad(out, t, g)
    idx, w = encoders.stochastic_rows(x, c['pc'], u, c['plan'],
                                      c['kw']['interp'],
                                      c['kw']['n_samples'])
    scatter = encoders.stochastic_scatter_plain(g, idx, w, c['plan'],
                                                c['pc'],
                                                c['kw']['n_samples'])
    tol = hashgrid_cuda.stochastic_backward_tolerance(
        g, idx, w, c['plan'], c['pc'], c['kw']['n_samples']).numpy()
    for got in (ours.numpy(), scatter.numpy()):
        assert np.all(np.abs(got - ref) <= tol)
    assert float(np.abs(ref).max()) > 0


def test_uniform_shapes_are_jax_draws():
    """uniform_shape names each estimator's draws as JAX makes them."""
    _, pc = _configs()
    assert encoders.uniform_shape(4, 10, 'trilinear', 3) == (2, 3, 4, 10)
    assert encoders.uniform_shape(4, 10, 'simplex', 2) == (1, 4, 10)
    assert encoders.uniform_shape(4, 10, 'simplex', 2, True) == (4, 10)
    assert encoders.uniform_shape(4, 10, sampled_backward=2,
                                  backward_points=0.25) == (4, 11)
    u = torch.zeros((1, 3, 4, 10))
    with pytest.raises(ValueError):
        hashgrid_cuda.hashgrid_encode(torch.zeros((4, 1024, 8)),
                                      torch.zeros((10, 3)), pc, u=u,
                                      n_samples=3)


@pytest.mark.parametrize('n_samples,residual,exact_levels,weighted', [
    (2, False, 0, 0), (3, False, 1, 8), (2, True, 0, 8), (2, True, 4, 32)])
def test_stochastic_rows_store_only_the_weights_k7_reads(
        n_samples, residual, exact_levels, weighted):
    """The rows format of csrc/hashgrid_stochastic.cuh: every row's index,
    (S, N), and the weights of the RESIDUAL and EXACT rows only, (SW, N);
    a DRAWS level's weight is 1 / n_samples and is not stored."""
    _, pc = _configs()
    plan = encoders.stochastic_plan(pc, 'trilinear', n_samples, exact_levels,
                                    residual)
    starts = encoders.plan_starts(plan)
    assert [first for _, _, first, _ in starts] == list(
        np.cumsum([0] + [r for _, r in plan])[:-1])
    assert [wf is None for k, _, _, wf in starts] == [
        k == encoders.DRAWS for k, _ in plan]
    rng = np.random.default_rng(3)
    x = torch.tensor(sampled_tests._points(rng))
    u = torch.tensor(rng.uniform(size=encoders.uniform_shape(
        4, N, 'trilinear', n_samples, residual)).astype(np.float32))
    idx, w = encoders.stochastic_rows(x, pc, u, plan, 'trilinear', n_samples)
    assert idx.shape == (sum(r for _, r in plan), N)
    assert w.shape == (weighted, N) and w.dtype == torch.float32
    for kind, rows, _, wfirst in starts:
        if kind == encoders.EXACT:  # the atoms' weights sum to 1
            np.testing.assert_allclose(
                w[wfirst:wfirst + rows].sum(dim=0).numpy(), 1.0, atol=1e-6)


def _defines(source):
    with open(os.path.join(_kernels.CSRC, source)) as f:
        return dict(line.split()[1:3] for line in f
                    if line.startswith('#define '))


def test_rows_format_constants_match_the_kernels_header():
    """The kinds the host plans with are the ones
    csrc/hashgrid_stochastic.cuh defines for K6 and K7, and the parts of
    K6 the host names are hashgrid_stochastic.cu's."""
    defines = _defines('hashgrid_stochastic.cuh')
    assert int(defines['KIND_DRAWS']) == encoders.DRAWS
    assert int(defines['KIND_RESIDUAL']) == encoders.RESIDUAL
    assert int(defines['KIND_EXACT']) == encoders.EXACT
    parts = _defines('hashgrid_stochastic.cu')
    assert hashgrid_cuda.K6_PARTS == {
        'all': int(parts['K6_PART_ALL']), 'draws': int(parts['K6_PART_DRAW']),
        'gathers': int(parts['K6_PART_DRAW']) | int(parts['K6_PART_GATHER']),
        'stores': int(parts['K6_PART_STORE'])}


@pytest.mark.parametrize('kw,f', [
    (dict(residual=True, n_samples=1), 8),
    (dict(residual=True, n_samples=3), 8),
    (dict(residual=True, n_samples=2), 2),
    (dict(residual=True, n_samples=2, interp='simplex'), 2),
    (dict(interp='simplex', n_samples=2), 2)])
def test_stochastic_errors_raise_as_jax(kw, f):
    """Residual needs n_samples 2 and wide rows; the stochastic simplex
    encode wide rows: NotImplementedError in both packages."""
    jc, pc = _configs(f)
    table = np.zeros((4, 1024, f), np.float32)
    x = np.zeros((4, 3), np.float32)
    with pytest.raises(NotImplementedError):
        jax_encoders.hashgrid_encode(table, x, jc, key=jax.random.PRNGKey(0),
                                     **kw)
    u = torch.zeros(encoders.uniform_shape(
        4, 4, kw.get('interp', 'trilinear'), kw['n_samples'],
        kw.get('residual', False)))
    with pytest.raises(NotImplementedError):
        hashgrid_cuda.hashgrid_encode(torch.tensor(table), torch.tensor(x),
                                      pc, u=u, **kw)


def _stochastic_options(upsample=False, **over):
    steps = dict(num_steps=8, upsample_steps=8) if upsample \
        else dict(train_tests.STEPS)
    return dict(perturb=True, sampled_backward=0, **steps, **over)


def _port_draws(key, jopts, n_points, grid, interp, n_upsample=0):
    """JAX's render draws for `key`: u_coarse and u_fine, u_enc from its
    k_enc as the encode draws it, and u_enc_upsample from fold_in(k_enc, 1)
    (JAX renderer.py:318)."""
    draws = {k: torch.tensor(v) for k, v in
             train_tests._jax_draws(key, jopts).items()}
    _, _, _, k_enc = jax.random.split(key, 4)
    shape = dict(interp=interp, n_samples=max(1, jopts.stochastic_corners),
                 residual=jopts.stochastic_residual)
    draws['u_enc'] = torch.tensor(_jax_uniforms(
        k_enc, encoders.uniform_shape(grid.n_levels, n_points, **shape)))
    if n_upsample:
        draws['u_enc_upsample'] = torch.tensor(_jax_uniforms(
            jax.random.fold_in(k_enc, 1),
            encoders.uniform_shape(grid.n_levels, n_upsample, **shape)))
    return draws


RENDER_CASES = {
    'trilinear_fused': (dict(), dict(stochastic_corners=2), 8),
    'trilinear_narrow_exact': (dict(), dict(stochastic_corners=3,
                                            stochastic_exact_levels=1), 2),
    'simplex_unfused': (dict(grid_interp='simplex', heads_impl='xla'),
                        dict(stochastic_corners=2), 8),
    'residual_simplex': (dict(grid_interp='simplex'),
                         dict(stochastic_corners=2, stochastic_residual=True),
                         8),
    'upsample': (dict(heads_impl='xla', proposal=False),
                 dict(stochastic_corners=2, upsample=True), 8),
}


@pytest.mark.parametrize('case', list(RENDER_CASES))
def test_stochastic_render_and_loss_gradients_match_jax(case):
    """render_rays in training form with the stochastic estimators, fed
    JAX's k_enc draws (and fold_in(k_enc, 1) for the upsample query), and
    compute_losses: outputs, loss parts and every parameter's gradient."""
    over, opts, f = RENDER_CASES[case]
    opts = dict(opts)
    upsample = opts.pop('upsample', False)
    options = _stochastic_options(upsample, **opts)
    params = train_tests._params(n_features=f, **over)
    batch = train_tests._batch()
    jf = train_tests._jax_field(f, **over)
    jopts = JaxRenderOptions(**options)
    key = jax.random.PRNGKey(11)

    def jax_loss(p):
        out = jax_render_rays(jf, p, batch['rays_o'], batch['rays_d'],
                              batch['direction_norms'][:, None], key=key,
                              options=jopts)
        loss, parts = jax_compute_losses(out, batch, JaxLossOptions())
        return loss, (parts, out)

    (ref_loss, (ref_parts, ref_out)), ref_grads = jax.value_and_grad(
        jax_loss, has_aux=True)(params)
    pf = train_tests._port_field(params, f, **over)
    tb = train_tests._torch_batch(batch)
    grid = pf.config.grid_config
    draws = _port_draws(key, jopts, train_tests.N_RAYS * options['num_steps'],
                        grid, pf.config.grid_interp,
                        train_tests.N_RAYS * options.get('upsample_steps', 0))
    out = render_rays(pf, tb['rays_o'], tb['rays_d'], tb['direction_norms'],
                      options=RenderOptions(**options), draws=draws)
    assert set(out) == set(ref_out)
    for k in ref_out:
        train_tests._close(out[k], ref_out[k], atol=1e-5)
    loss, parts = compute_losses(out, tb, LossOptions())
    train_tests._close(loss, ref_loss)
    for k in ref_parts:
        train_tests._close(parts[k], ref_parts[k])
    names = [n for n, _ in pf.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in pf.named_parameters()])
    ours = bridge.state_to_numpy(dict(zip(names, grads)))
    train_tests._close_trees(ours, ref_grads, leaf_atol=None if upsample
                             else train_tests._proposal_atol(
                                 train_tests.STEPS))
    assert float(np.abs(ours['encoder']['grid']).max()) > 0


def test_render_draws_the_stochastic_uniforms():
    """draw_perturbations gives u_enc in the estimator's shape whenever
    stochastic_corners is set and sampled_backward is not (and
    u_enc_upsample for the upsample query); render_rays draws them from
    its generator and refuses draws without them; the eval form is
    exact."""
    gen = torch.Generator().manual_seed(3)
    opts = RenderOptions(**_stochastic_options(stochastic_corners=3))
    draws = draw_perturbations(gen, 64, opts, 2)
    assert draws['u_enc'].shape == (2, 3, 2, 64 * 8)
    simplex = draw_perturbations(gen, 64, opts, 2, interp='simplex')
    assert simplex['u_enc'].shape == (2, 2, 64 * 8)
    residual = dataclasses.replace(opts, stochastic_corners=2,
                                   stochastic_residual=True)
    assert draw_perturbations(gen, 64, residual, 2)['u_enc'].shape == (
        2, 64 * 8)
    up = RenderOptions(**_stochastic_options(True, stochastic_corners=2))
    assert draw_perturbations(gen, 64, up, 2)['u_enc_upsample'].shape == (
        1, 3, 2, 64 * 8)
    assert 'u_enc' not in draw_perturbations(
        gen, 64, dataclasses.replace(opts, stochastic_corners=0), 2)
    params = train_tests._params()
    pf = train_tests._port_field(params)
    tb = train_tests._torch_batch(train_tests._batch())
    args = (pf, tb['rays_o'], tb['rays_d'], tb['direction_norms'])
    with torch.no_grad():
        a = render_rays(*args, key=torch.Generator().manual_seed(3),
                        options=opts)
        b = render_rays(*args, options=opts, draws=draw_perturbations(
            torch.Generator().manual_seed(3), 64, opts, 2))
        exact = render_rays(*args, options=dataclasses.replace(
            opts, perturb=False))
        also_exact = render_rays(*args, options=dataclasses.replace(
            opts, perturb=False, stochastic_corners=0))
    torch.testing.assert_close(a['image'], b['image'])
    assert torch.equal(exact['image'], also_exact['image'])
    no_enc = {k: v for k, v in draws.items() if k != 'u_enc'}
    with pytest.raises(ValueError):
        render_rays(*args, options=opts, draws=no_enc)


def test_trainer_step_at_stochastic_corners_2_matches_jax(tmp_path):
    """Two SimpleTrainer steps at stochastic_corners=2 from the same params,
    the port fed the JAX trainer's draws (its key fold_in(PRNGKey(seed + 1),
    step)): every loss part within 1e-3, as test_torch_port_train holds
    the exact trainer."""
    params = train_tests._params()
    opts = _stochastic_options(stochastic_corners=2)
    jt = JaxSimpleTrainer('t', train_tests._jax_field(), lr=5e-3,
                          iters=20000, render_options=JaxRenderOptions(**opts),
                          workspace=str(tmp_path / 'jax'), metrics=False)
    jp = jax.tree.map(jnp.asarray, params)
    jt.state = {'params': jp, 'opt_state': jt.tx.init(jp),
                'ema': jax.tree.map(jnp.copy, jp),
                'step': jnp.zeros((), jnp.int32)}
    pt = SimpleTrainer('t', train_tests._port_field(params), lr=5e-3,
                       iters=20000, render_options=RenderOptions(**opts),
                       workspace=str(tmp_path / 'port'), metrics=False)
    grid = pt.field.config.grid_config
    for step, seed in enumerate((1, 2)):
        batch = train_tests._batch(seed=seed)
        ref = {k: float(v) for k, v in
               jt.train_iterations(iter([batch]), 1).items()}
        key = jax.random.fold_in(jax.random.PRNGKey(1), step)
        draws = _port_draws(key, JaxRenderOptions(**opts),
                            train_tests.N_RAYS * opts['num_steps'], grid,
                            'trilinear')
        ours = {k: float(v) for k, v in pt.train_step(batch, draws).items()}
        assert set(ours) == set(ref) and 'interlevel' in ours
        for k in ref:
            np.testing.assert_allclose(ours[k], ref[k], rtol=1e-3, err_msg=k)
    assert pt.step_options().stochastic_corners == 2


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('scenes') / 'sphere')
    fixtures.make_synthetic_scene(path, n_frames=6, width=32, height=24)
    return path


SHORT = ['--proposal', '--batch-size', '512', '--num-steps', '8',
         '--proposal-steps', '16', '--factor-train', '1', '--factor-test',
         '1', '--iters', '3', '--eval', '--no-metrics']


@pytest.mark.parametrize('argv', [
    ['--sampled-backward', '0'],
    ['--sampled-backward', '0', '--stochastic-residual',
     '--stochastic-exact-levels', '1'],
    ['--grid-preset', 'reference', '--stochastic-exact-levels', '4'],
    ['--grid-preset', 'reference', '--stochastic-corners', '1']],
    ids=['stochastic', 'residual', 'reference_exact4', 'reference_k1'])
def test_cli_trains_the_stochastic_estimators(scene, tmp_path, argv):
    """The train CLI at --sampled-backward 0 and on the reference preset
    runs to the end of a short run on the CPU through the stochastic
    encodes (the plain versions: no kernel launches), with a finite eval
    MSE."""
    _kernels.reset_launches()
    run = port_cli.main([scene, '--workspace', str(tmp_path)] + SHORT + argv,
                        device='cpu')
    assert sum(_kernels.launches.values()) == 0
    assert run.trainer.global_step == 3
    assert np.isfinite(run.eval_mse) and 0 < run.eval_mse < 1
    options = run.trainer.step_options()
    assert options.sampled_backward == 0 and options.stochastic_corners > 0
    assert os.path.exists(os.path.join(run.model_dir, 'checkpoints',
                                       'ngp_ep0001.pth'))


@pytest.mark.parametrize('argv', [
    ['--sampled-backward', '0', '--stochastic-corners', '1',
     '--stochastic-residual'],
    ['--grid-preset', 'reference', '--stochastic-residual']],
    ids=['residual_k1', 'residual_reference'])
def test_cli_residual_raises_as_jax(scene, tmp_path, argv):
    """--stochastic-residual with a corner count other than 2, or on the
    narrow reference grid, raises NotImplementedError in the first step's
    encode, where the JAX package raises it."""
    with pytest.raises(NotImplementedError, match='residual'):
        port_cli.main([scene, '--workspace', str(tmp_path)] + SHORT + argv,
                      device='cpu')
