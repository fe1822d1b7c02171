"""The port's occupancy grid against the JAX package's, on the CPU.

Mirrors tests/test_occupancy.py at resolution 16: cell centres and
indices, update (the field's density at every cell centre, EMA'd),
mark_untrained_grid, occupancy_mask, shrink_near_far, render_rays masked
by a grid (fused and unfused heads, eval and training forms, with and
without the near/far shrink) and SimpleTrainer with a grid, all with the
same params and inputs on both sides. Cell decisions (masks, indices,
trained cells) are compared exactly; densities and renders within the
render tests' fp32 tolerances (rtol 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autolabel_tpu.core.rays import convert_pose
from autolabel_tpu.render.occupancy import OccupancyGrid as JaxGrid
from autolabel_tpu.render.occupancy import OccupancyGridConfig as JaxGridCfg
from autolabel_tpu.render.renderer import RenderOptions as JaxRenderOptions
from autolabel_tpu.render.renderer import ray_aabb_intersect as jax_aabb
from autolabel_tpu.render.renderer import render_rays as jax_render_rays
from autolabel_tpu.render.renderer import shrink_near_far as jax_shrink
from autolabel_tpu.train.losses import LossOptions as JaxLossOptions
from autolabel_tpu.train.losses import compute_losses as jax_compute_losses
from autolabel_tpu.train.trainer import SimpleTrainer as JaxSimpleTrainer
from autolabel_tpu_torch import bridge
from autolabel_tpu_torch.render.occupancy import (OccupancyGrid,
                                                  OccupancyGridConfig)
from autolabel_tpu_torch.render.renderer import (RenderOptions,
                                                 ray_aabb_intersect,
                                                 render_rays,
                                                 shrink_near_far)
from autolabel_tpu_torch.train.losses import LossOptions, compute_losses
from autolabel_tpu_torch.train.trainer import SimpleTrainer
from tests.synthetic import look_at_cv
from tests.test_torch_port_train import (STEPS, _batch, _close,
                                         _close_trees, _jax_draws,
                                         _jax_field, _params, _port_field,
                                         _proposal_atol, _torch_batch)

R = 16
THRESHOLD = OccupancyGridConfig().threshold


def _grids(bound=1.0):
    cfg = dict(resolution=R)
    return (OccupancyGrid(OccupancyGridConfig(**cfg), bound, device='cpu'),
            JaxGrid(JaxGridCfg(**cfg), bound))


def _poses():
    """Two cameras looking at the origin, through the reference pose chain
    into ngp space."""
    return np.stack([convert_pose(np.linalg.inv(look_at_cv(
        np.array(p), np.zeros(3)))) for p in ([2.0, 0.0, 0.3],
                                              [0.0, -1.8, 0.6])])


def _random_state(seed=0, share=0.4):
    """A density grid with about `share` of its cells over the threshold,
    and a trained mask with a few holes."""
    rng = np.random.default_rng(seed)
    density = np.where(rng.random((R, R, R)) < share,
                       rng.uniform(0.02, 3.0, (R, R, R)),
                       rng.uniform(0.0, 0.009, (R, R, R))).astype(np.float32)
    trained = rng.random((R, R, R)) > 0.1
    return density, trained


def _set_state(ours, ref, density, trained):
    ours.density, ours.trained = torch.tensor(density), torch.tensor(trained)
    ref.density, ref.trained = jnp.asarray(density), jnp.asarray(trained)


@pytest.mark.parametrize('bound', [1.0, 1.3])
def test_cells_match_jax(bound):
    ours, ref = _grids(bound)
    centers = ours.cell_centers()
    want = np.asarray(ref.cell_centers())
    assert centers.shape == (R ** 3, 3)
    assert np.array_equal(centers.numpy(), want)
    pts = np.random.default_rng(1).uniform(-1.2 * bound, 1.2 * bound,
                                           (4000, 3)).astype(np.float32)
    assert np.array_equal(ours.cell_indices(torch.tensor(pts)).numpy(),
                          np.asarray(ref.cell_indices(jnp.asarray(pts))))


@pytest.mark.parametrize('overrides', [
    dict(), dict(heads_impl='xla', proposal=False)])
def test_update_matches_jax(overrides):
    """Two updates (the second after the params change): each cell's
    density is max(decay x old, sigma at its centre)."""
    ours, ref = _grids()
    jf = _jax_field(**overrides)
    for seed in (0, 1):
        params = _params(seed, **overrides)
        ref.update(jf, params)
        ours.update(_port_field(params, **overrides))
        _close(ours.density, ref.density, atol=1e-6)
    assert float(ours.density.max()) > THRESHOLD
    assert ours.density.device.type == 'cpu'


def test_mark_untrained_grid_matches_jax():
    ours, ref = _grids()
    args = (_poses(), (20.0, 20.0, 16.0, 12.0), (32, 24))
    ours.mark_untrained_grid(*args)
    ref.mark_untrained_grid(*args)
    trained = ours.trained.numpy()
    assert ours.trained.dtype == torch.bool
    assert np.array_equal(trained, np.asarray(ref.trained))
    assert trained.any() and not trained.all() and trained[8, 8, 8]


def test_occupancy_mask_matches_jax():
    ours, ref = _grids()
    _set_state(ours, ref, *_random_state())
    pts = np.random.default_rng(2).uniform(-1.1, 1.1, (5000, 3)).astype(
        np.float32)
    got = ours.occupancy_mask(torch.tensor(pts)).numpy()
    want = np.asarray(ref.occupancy_mask(jnp.asarray(pts)))
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert 0 < got.mean() < 1


def _rays(n=256, seed=3):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.9, 0.9, (n, 3))
    o[:, 0] = -1.5
    d = rng.normal(size=(n, 3)) * 0.3
    d[:, 0] = 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize('share', [0.02, 0.3, 0.0])
def test_shrink_near_far_matches_jax(share):
    """Grids from nearly empty to mostly full (and empty: nothing
    shrinks): the same rays shrink, to the same intervals."""
    density, trained = _random_state(4, share)
    o, d = _rays()
    near, far = ray_aabb_intersect(torch.tensor(o), torch.tensor(d), 1.0)
    n2, f2 = shrink_near_far((torch.tensor(density), torch.tensor(trained),
                              THRESHOLD), torch.tensor(o), torch.tensor(d),
                             near, far, 1.0)
    jn, jf = jax_aabb(jnp.asarray(o), jnp.asarray(d), 1.0)
    rn, rf = jax_shrink((jnp.asarray(density), jnp.asarray(trained),
                         THRESHOLD), jnp.asarray(o), jnp.asarray(d), jn, jf,
                        1.0)
    _close(near, jn, atol=1e-6)
    _close(n2, rn, rtol=1e-6, atol=1e-6)
    _close(f2, rf, rtol=1e-6, atol=1e-6)
    shrunk = (f2 - n2 < far - near - 1e-6).numpy()
    if share == 0.0:
        assert not shrunk.any()
    else:
        assert shrunk.any()


def test_shrink_near_far_brackets_occupied_span():
    """The reference's slab test: rays through an occupied slab get
    [near, far] tightened to it with a one-probe margin."""
    r = 64
    density = torch.zeros((r, r, r))
    density[int(1.25 / 2 * r):int(1.5 / 2 * r)] = 1.0
    occupancy = (density, torch.ones((r, r, r), dtype=torch.bool), 0.01)
    o = torch.tensor([[-1.0, 0.0, 0.0], [-1.0, 0.9, 0.9]])
    d = torch.tensor([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    near, far = ray_aabb_intersect(o, d, 1.0)
    n2, f2 = shrink_near_far(occupancy, o, d, near, far, 1.0)
    assert 1.0 <= float(n2[0, 0]) <= 1.3
    assert 1.45 <= float(f2[0, 0]) <= 1.75
    assert float(f2[1, 0] - n2[1, 0]) < float((far - near)[1, 0])


BRANCHES = {
    'fused': ({}, dict(STEPS)),
    'unfused': (dict(heads_impl='xla', proposal=False), dict(num_steps=16)),
}


@pytest.mark.parametrize('near_far', [False, True])
@pytest.mark.parametrize('branch', list(BRANCHES))
def test_masked_eval_render_matches_jax(branch, near_far):
    """The eval form with a grid (40% of the cells occupied, a trained
    mask with holes): every output within the render tests' tolerances,
    and the image not the unmasked one."""
    overrides, steps = BRANCHES[branch]
    params = _params(**overrides)
    jf = _jax_field(**overrides)
    density, trained = _random_state(6)
    occupancy = (density, trained, THRESHOLD)
    batch = _batch()
    ref = jax_render_rays(jf, params, batch['rays_o'], batch['rays_d'],
                          batch['direction_norms'][:, None],
                          options=JaxRenderOptions(
                              occupancy_near_far=near_far, **steps),
                          occupancy=(jnp.asarray(occupancy[0]),
                                     jnp.asarray(trained), THRESHOLD))
    tb = _torch_batch(batch)
    with torch.no_grad():
        out = render_rays(_port_field(params, **overrides), tb['rays_o'],
                          tb['rays_d'], tb['direction_norms'],
                          options=RenderOptions(occupancy_near_far=near_far,
                                                **steps),
                          occupancy=(torch.tensor(occupancy[0]),
                                     torch.tensor(trained), THRESHOLD))
    for k in out:  # the JAX eval render also returns its interlevel loss
        _close(out[k], ref[k], atol=1e-5)
    unmasked = jax_render_rays(jf, params, batch['rays_o'], batch['rays_d'],
                               batch['direction_norms'][:, None],
                               options=JaxRenderOptions(**steps))
    assert not np.allclose(np.asarray(unmasked['image']),
                           out['image'].numpy(), atol=1e-3)


@pytest.mark.parametrize('branch', list(BRANCHES))
def test_masked_training_render_and_gradients_match_jax(branch):
    """The training form with a grid and the near/far shrink (JAX's own
    draws fed in): outputs, loss parts and every parameter's gradient; a
    masked sample's sigma passes no gradient, through the fused head
    backward as through autograd."""
    overrides, steps = BRANCHES[branch]
    params = _params(**overrides)
    jf = _jax_field(**overrides)
    density, trained = _random_state(7, 0.5)
    jopts = JaxRenderOptions(perturb=True, stochastic_corners=0,
                             occupancy_near_far=True, **steps)
    key = jax.random.PRNGKey(12)
    batch = _batch()
    jocc = (jnp.asarray(density), jnp.asarray(trained), THRESHOLD)

    def jax_loss(p):
        out = jax_render_rays(jf, p, batch['rays_o'], batch['rays_d'],
                              batch['direction_norms'][:, None], key=key,
                              options=jopts, occupancy=jocc)
        loss, parts = jax_compute_losses(out, batch, JaxLossOptions())
        return loss, (parts, out)

    (ref_loss, (ref_parts, ref_out)), ref_grads = jax.value_and_grad(
        jax_loss, has_aux=True)(params)
    pf = _port_field(params, **overrides)
    tb = _torch_batch(batch)
    draws = {k: torch.tensor(v) for k, v in _jax_draws(key, jopts).items()}
    out = render_rays(pf, tb['rays_o'], tb['rays_d'], tb['direction_norms'],
                      options=RenderOptions(perturb=True,
                                            stochastic_corners=0,
                                            occupancy_near_far=True, **steps),
                      occupancy=(torch.tensor(density), torch.tensor(trained),
                                 THRESHOLD), draws=draws)
    for k in ref_out:
        _close(out[k], ref_out[k], atol=1e-5)
    loss, parts = compute_losses(out, tb, LossOptions())
    _close(loss, ref_loss)
    names = [n for n, _ in pf.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in pf.named_parameters()])
    _close_trees(bridge.state_to_numpy(dict(zip(names, grads))), ref_grads,
                 leaf_atol=_proposal_atol(steps)
                 if steps.get('proposal_steps') else None)


def test_trainer_with_a_grid_matches_jax(tmp_path):
    """Both trainers with a resolution-16 grid updated every 2 steps, 4
    deterministic steps from the same params and batches: the grid's
    densities and every loss part agree, and the port updated twice."""
    opts = dict(num_steps=8, proposal_steps=16, perturb=False,
                stochastic_corners=0)
    params = _params()
    jgrid = JaxGrid(JaxGridCfg(resolution=R), 1.0)
    pgrid = OccupancyGrid(OccupancyGridConfig(resolution=R), 1.0,
                          device='cpu')
    jt = JaxSimpleTrainer('t', _jax_field(), iters=20000,
                          render_options=JaxRenderOptions(**opts),
                          occupancy=jgrid, occupancy_update_every=2)
    jp = jax.tree.map(jnp.asarray, params)
    jt.state = {'params': jp, 'opt_state': jt.tx.init(jp),
                'ema': jax.tree.map(jnp.copy, jp),
                'step': jnp.zeros((), jnp.int32)}
    pt = SimpleTrainer('t', _port_field(params), iters=20000,
                       render_options=RenderOptions(**opts),
                       occupancy=pgrid, occupancy_update_every=2)
    updates = []
    update = pgrid.update
    pgrid.update = lambda field: (updates.append(pt.global_step),
                                  update(field))
    for seed in (1, 2, 3, 4):
        b = _batch(seed=seed)
        ref = jt.train_iterations(iter([b]), 1)
        got = pt.train_iterations(iter([b]), 1)
        for k in ref:
            np.testing.assert_allclose(float(got[k]), float(ref[k]),
                                       rtol=1e-3, err_msg=k)
    assert updates == [0, 2]
    _close(pgrid.density, jgrid.density, rtol=1e-3, atol=1e-5)
