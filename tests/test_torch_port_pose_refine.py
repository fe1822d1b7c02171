"""Camera registration and joint pose refinement against the JAX package
on the CPU: rodrigues, the encode's point gradient (K2x's plain version)
in every form of the encode, the point gradient through the field, the
registration objective and its Adam, refined rays and poses, the
optimizer's pose group, one SimpleTrainer step with pose refinement, the
level-window phases, emit_frame_rays batches, and pose checkpoints across
the toggle and across packages.

Same inputs on both sides, made with numpy from a seed; JAX's own draws
fed to the port as `u`. Sizes are small (2 to 3 levels, 2 to 8 features,
tables of 2^10 rows, hidden 32, 32 to 64 rays). Tolerances, each with its
reason at its test: fp32 on both sides, sums in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autolabel_tpu.core import rays as jax_rays
from autolabel_tpu.core.dataset import SceneDataset as JaxSceneDataset
from autolabel_tpu.mapping.ba import rodrigues as jax_rodrigues
from autolabel_tpu.ops import encoders as jax_encoders
from autolabel_tpu.ops import hashgrid_pallas
from autolabel_tpu.render.renderer import RenderOptions as JaxRenderOptions
from autolabel_tpu.render.renderer import render_rays as jax_render_rays
from autolabel_tpu.train import optim as jax_optim
from autolabel_tpu.train import pose_refine as jax_pose_refine
from autolabel_tpu.train.losses import LossOptions as JaxLossOptions
from autolabel_tpu.train.losses import compute_losses as jax_compute_losses
from autolabel_tpu.train.trainer import SimpleTrainer as JaxSimpleTrainer
from autolabel_tpu_torch import bridge
from autolabel_tpu_torch.core import rays
from autolabel_tpu_torch.core.dataset import SceneDataset
from autolabel_tpu_torch.mapping.ba import rodrigues
from autolabel_tpu_torch.ops import encoders, hashgrid_cuda
from autolabel_tpu_torch.render.renderer import RenderOptions
from autolabel_tpu_torch.train import optim, pose_refine
from autolabel_tpu_torch.train.trainer import SimpleTrainer, phase_schedule
from autolabel_tpu_torch.utils import fixtures
from tests.test_torch_port_train import (_flat, _jax_field, _params,
                                         _port_field)


@pytest.fixture(autouse=True)
def _one_thread():
    """The suite's parallel workers each get one torch thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_close(ours, ref, tol, what=''):
    """|ours - ref| within tol of ref's largest magnitude."""
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-12)
    assert float(np.abs(ours - ref).max()) <= tol * scale, what


# -- rodrigues ----------------------------------------------------------------

ROTATIONS = {
    'zero': [0.0, 0.0, 0.0],
    'tiny': [3e-6, -2e-6, 1e-6],          # theta^2 ~ 1.4e-11: Taylor
    'below_switch': [5.7e-5, 5.7e-5, 5.7e-5],  # theta^2 ~ 0.97e-8
    'above_switch': [5.8e-5, 5.8e-5, 5.8e-5],  # theta^2 ~ 1.01e-8
    'moderate': [0.3, -0.2, 0.1],
    'large': [1.5, 2.0, -0.7],
}


@pytest.mark.parametrize('case', sorted(ROTATIONS))
def test_rodrigues_matches_jax(case):
    """Values and the vector-Jacobian product for a random cotangent; at
    theta = 0 the gradient is finite and equal to JAX's. fp32: 1e-6 of
    the largest magnitude covers the sin/cos and sum roundings."""
    v = np.asarray(ROTATIONS[case], np.float32)
    ct = np.random.default_rng(1).normal(size=(3, 3)).astype(np.float32)
    ref, vjp = jax.vjp(jax_rodrigues, jnp.asarray(v))
    (ref_g,) = vjp(jnp.asarray(ct))
    vt = torch.tensor(v, requires_grad=True)
    ours = rodrigues(vt)
    (g,) = torch.autograd.grad(ours, vt, torch.tensor(ct))
    assert bool(torch.isfinite(g).all())
    _rel_close(ours, ref, 1e-6, 'R')
    _rel_close(g, ref_g, 1e-5, 'grad')


def test_rodrigues_batches_and_is_orthonormal():
    rng = np.random.default_rng(2)
    v = rng.normal(size=(5, 3)).astype(np.float32)
    R = rodrigues(torch.tensor(v)).numpy()
    np.testing.assert_allclose(R, np.asarray(jax_rodrigues(jnp.asarray(v))),
                               atol=1e-6)
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-5)


# -- K2x's plain version against jax.vjp ------------------------------------

WIDE = dict(n_levels=3, n_features=8, log2_hashmap_size=10,
            base_resolution=4, per_level_scale=2.0)
NARROW = dict(WIDE, n_features=2, variant='tcnn')
NGP = dict(WIDE, n_features=2, variant='torch_ngp')

# (grid, interp, n_samples, exact_levels, residual); n_samples None: the
# exact encode (no key)
POINT_GRAD_FORMS = {
    'trilinear_wide': (WIDE, 'trilinear', None, 0, False),
    'trilinear_tcnn': (NARROW, 'trilinear', None, 0, False),
    'trilinear_torch_ngp': (NGP, 'trilinear', None, 0, False),
    'simplex': (WIDE, 'simplex', None, 0, False),
    'stochastic_trilinear': (WIDE, 'trilinear', 2, 1, False),
    'stochastic_simplex': (WIDE, 'simplex', 3, 1, False),
    'stochastic_narrow': (NARROW, 'trilinear', 2, 1, False),
    'stochastic_all_drawn': (WIDE, 'simplex', 2, 0, False),
    'residual_trilinear': (WIDE, 'trilinear', 2, 1, True),
    'residual_simplex': (WIDE, 'simplex', 2, 0, True),
}


def _tie_points(rng, n, scale):
    """Points in the unit cube with 0, 1, cell faces of the coarsest level
    and tied fractions (two axes equal, all three equal)."""
    x = rng.random((n, 3)).astype(np.float32)
    x[:6] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [0.25, 0.25, 0.7],
             [0, 1, 0.5], [0.3, 0.3, 0.3]]
    x[6:14] = (rng.integers(0, int(scale), (8, 3)) / scale).astype(np.float32)
    x[14:20, 1] = x[14:20, 0]
    x[20:24] = x[20:24, :1]
    return x


def _jax_uniforms(key, grid, interp, n_samples, residual, n):
    """The uniforms JAX's stochastic and residual encodes draw from key,
    in the port's u layout (encoders.uniform_shape)."""
    if residual:
        return np.asarray(jax.random.uniform(key, (grid.n_levels, n)))
    sets = (n_samples + 1) // 2
    keys = jax.random.split(key, max(sets, 1))
    shape = ((grid.n_levels, n) if interp == 'simplex'
             else (3, grid.n_levels, n))
    return np.stack([np.asarray(jax.random.uniform(keys[s], shape))
                     for s in range(sets)])


@pytest.mark.parametrize('form', sorted(POINT_GRAD_FORMS))
def test_point_grad_plain_matches_jax_vjp(form):
    """hashgrid_encode_point_grad_plain against jax.vjp of
    encoders.hashgrid_encode for x, for the same table, points and g (and
    JAX's own draws): every element within point_grad_tolerance (2 k 2^-24
    of its terms' magnitudes, k the roundings a term passes through; the
    JAX side sums in its own order), ties split as jnp.max and jnp.min
    split them."""
    kw, interp, n_samples, exact, residual = POINT_GRAD_FORMS[form]
    jc, tc = jax_encoders.HashGridConfig(**kw), encoders.HashGridConfig(**kw)
    rng = np.random.default_rng(7)
    n = 300
    x = _tie_points(rng, n, tc.scales[0])
    table = rng.normal(size=(tc.n_levels, tc.table_size,
                             tc.n_features)).astype(np.float32)
    g = rng.normal(size=(n, tc.out_dim)).astype(np.float32)
    key = None if n_samples is None else jax.random.PRNGKey(3)
    _, vjp = jax.vjp(lambda xx: jax_encoders.hashgrid_encode(
        jnp.asarray(table), xx, jc, key=key, n_samples=n_samples or 1,
        exact_levels=exact, interp=interp, residual=residual),
        jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    plan = rows = None
    if key is not None:
        plan = encoders.stochastic_plan(tc, interp, n_samples, exact,
                                        residual)
        u = torch.tensor(_jax_uniforms(key, jc, interp, n_samples, residual,
                                       n))
        rows, _ = encoders.stochastic_rows(torch.tensor(x), tc, u, plan,
                                           interp, n_samples)
    args = (torch.tensor(g), torch.tensor(table), torch.tensor(x), tc,
            interp, plan, rows)
    got = hashgrid_cuda.hashgrid_encode_point_grad_plain(*args).numpy()
    tol = encoders.point_grad_tolerance(*args).numpy()
    assert np.all(np.abs(got - want) <= tol), np.max(np.abs(got - want)
                                                     / np.maximum(tol, 1e-30))
    if form == 'stochastic_all_drawn':
        assert not np.any(got) and not np.any(want)
    else:
        assert np.abs(want).max() > 1.0


@pytest.mark.parametrize('n_features', [8, 2])
def test_point_grad_plain_matches_the_hybrid_vjp(n_features):
    """The TPU kernel's own backward rule (hashgrid_pallas._hybrid_bwd, the
    VJP that K2x replaces), for x: within point_grad_tolerance."""
    kw = dict(WIDE, n_features=n_features)
    jc, tc = jax_encoders.HashGridConfig(**kw), encoders.HashGridConfig(**kw)
    rng = np.random.default_rng(8)
    x = _tie_points(rng, 200, tc.scales[0])
    table = rng.normal(size=(3, 1024, n_features)).astype(np.float32)
    g = rng.normal(size=(200, tc.out_dim)).astype(np.float32)
    _, want = hashgrid_pallas._hybrid_bwd(jc, (jnp.asarray(table),
                                               jnp.asarray(x)),
                                          jnp.asarray(g))
    args = (torch.tensor(g), torch.tensor(table), torch.tensor(x), tc)
    got = hashgrid_cuda.point_grad(*args)
    tol = encoders.point_grad_tolerance(*args)
    assert bool(((got - torch.tensor(np.asarray(want))).abs() <= tol).all())


@pytest.mark.parametrize('interp', ['trilinear', 'simplex'])
def test_frozen_table_still_records_the_point_gradient(interp):
    """Registration freezes the table and differentiates the points: the
    encode must still record (hashgrid_cuda._records; before, the card's
    dispatch took the serving form whenever the table did not require
    grad, a silent zero gradient), and on the CPU the plain encode's
    autograd gradient for x is the explicit plain K2x."""
    tc = encoders.HashGridConfig(**WIDE)
    rng = np.random.default_rng(9)
    table = torch.tensor(rng.normal(size=(3, 1024, 8)).astype(np.float32))
    x = torch.tensor(rng.random((100, 3)).astype(np.float32),
                     requires_grad=True)
    assert hashgrid_cuda._records(table, x)
    assert not hashgrid_cuda._records(table, x.detach())
    with torch.no_grad():
        assert not hashgrid_cuda._records(table, x)
    g = torch.tensor(rng.normal(size=(100, 24)).astype(np.float32))
    out = hashgrid_cuda.hashgrid_encode(table, x, tc, interp=interp)
    (got,) = torch.autograd.grad(out, x, g)
    want = hashgrid_cuda.point_grad(g, table, x.detach(), tc, interp)
    tol = encoders.point_grad_tolerance(g, table, x.detach(), tc, interp)
    assert bool(((got - want).abs() <= tol).all())


# -- the point gradient through the field -------------------------------------

def _bound_points(rng, n, bound=1.0):
    """Points with coordinates on +-bound (the first sample of a ray lies on
    the box's face: the clip's tie) and inside."""
    x = rng.uniform(-bound, bound, (n, 3)).astype(np.float32)
    x[:8, 0] = bound
    x[8:16, 1] = -bound
    x[16:20] = [bound, -bound, bound]
    return x


@pytest.mark.parametrize('head', ['density', 'all_heads', 'proposal_sigma'])
def test_field_point_gradient_matches_jax(head):
    """The gradient for the points of Field.density (sigma and geo),
    all_heads (through K3b's dA and dB on the card; the fused heads' plain
    backward here) and proposal_sigma (K4b's dX), with points on +-bound:
    within 1e-4 of the largest magnitude (fp32, sums in other orders;
    the clip's ties give half the gradient on both sides)."""
    params = _params()
    jf, pf = _jax_field(), _port_field(params)
    rng = np.random.default_rng(10)
    x = _bound_points(rng, 48)
    d = rng.normal(size=(48, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jp = jax.tree.map(jnp.asarray, params)

    def jax_fn(xx):
        if head == 'density':
            return jf.density(jp, xx)
        if head == 'all_heads':
            return jf.all_heads(jp, xx, jnp.asarray(d))
        return jf.proposal_sigma(jp, xx)

    ref, vjp = jax.vjp(jax.jit(jax_fn), jnp.asarray(x))
    cts = jax.tree.map(lambda r: np.random.default_rng(11).normal(
        size=r.shape).astype(np.float32), ref)
    (want,) = vjp(jax.tree.map(jnp.asarray, cts))
    xt = torch.tensor(x, requires_grad=True)
    with pose_refine.frozen(pf):
        if head == 'density':
            ours = pf.density(xt)
        elif head == 'all_heads':
            ours = pf.all_heads(xt, torch.tensor(d))
        else:
            ours = (pf.proposal_sigma(xt),)
        ref_leaves = jax.tree.leaves(cts)
        (got,) = torch.autograd.grad(
            list(ours), xt, [torch.tensor(c) for c in ref_leaves])
    _rel_close(got, want, 1e-4)
    assert float(np.abs(np.asarray(want)[:20]).max()) > 0


# -- registration -------------------------------------------------------------

REG_OPTS = dict(num_steps=8, proposal_steps=16, perturb=False)


def _registration_case(seed=12, n=32):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[:, 2] = np.abs(dirs[:, 2]) + 1.0
    norms = np.linalg.norm(dirs, axis=-1, keepdims=True).astype(np.float32)
    dirs = (dirs / norms).astype(np.float32)
    pixels = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    depth = rng.uniform(0.3, 1.2, n).astype(np.float32)
    depth[::4] = 0.0
    R0 = np.asarray(jax_rodrigues(jnp.asarray(
        rng.normal(size=3).astype(np.float32)))).astype(np.float32)
    t0 = rng.uniform(-0.2, 0.2, 3).astype(np.float32)
    return pixels, dirs, norms, R0, t0, depth


def _jax_registration_loss(jf, params, pixels, dirs, norms, R0, t0, depth):
    """The loss of JAX's register_camera (train/pose_refine.py:99-111)."""
    def loss_fn(delta):
        R = R0 @ jax_rodrigues(delta['rot'])
        rays_d = dirs @ R.T
        rays_o = jnp.broadcast_to(t0 + delta['t'], rays_d.shape)
        out = jax_render_rays(jf, params, rays_o, rays_d, norms,
                              options=JaxRenderOptions(**REG_OPTS))
        loss = jnp.mean((out['image'] - pixels) ** 2)
        if depth is not None:
            valid = (depth > 0).astype(jnp.float32)
            loss = loss + 0.1 * jnp.sum(
                valid * jnp.abs(out['depth'] - depth)) \
                / jnp.maximum(valid.sum(), 1.0)
        return loss
    return loss_fn


@pytest.mark.parametrize('delta', ['zero', 'moved'])
@pytest.mark.parametrize('with_depth', [False, True])
def test_registration_loss_and_gradient_match_jax(delta, with_depth):
    """register_camera's objective through the proposal net and fused
    heads, at delta 0 (where rodrigues' Taylor branch carries the
    gradient) and at a moved delta: the loss within 1e-4 and the gradient
    for (rot, t) within 2e-3 of its largest magnitude (fp32; the
    gradient passes through the sampled depths, the compositing sums and
    the encode's point gradient, each summed in its own order)."""
    params = _params()
    jf, pf = _jax_field(), _port_field(params)
    pixels, dirs, norms, R0, t0, depth = _registration_case()
    depth = depth if with_depth else None
    d0 = ({'rot': np.zeros(3, np.float32), 't': np.zeros(3, np.float32)}
          if delta == 'zero' else
          {'rot': np.array([0.02, -0.03, 0.01], np.float32),
           't': np.array([0.01, 0.02, -0.015], np.float32)})
    loss_fn = _jax_registration_loss(jf, jax.tree.map(jnp.asarray, params),
                                      pixels, dirs, norms, R0, t0, depth)
    ref, ref_g = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, d0))
    dt = {k: torch.tensor(v, requires_grad=True) for k, v in d0.items()}
    with pose_refine.frozen(pf):
        loss = pose_refine.registration_loss(
            pf, dt, torch.tensor(pixels), torch.tensor(dirs),
            torch.tensor(norms), torch.tensor(R0), torch.tensor(t0),
            RenderOptions(**REG_OPTS),
            None if depth is None else torch.tensor(depth))
        grads = torch.autograd.grad(loss, [dt['rot'], dt['t']])
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-4)
    for k, gk in zip(('rot', 't'), grads):
        _rel_close(gk, ref_g[k], 2e-3, k)
    assert all(p.requires_grad for p in pf.parameters())  # thawed again


def test_register_camera_matches_jax():
    """Three Adam steps of register_camera (cosine decay from lr 3e-3):
    the final loss within 1e-4 and the pose within 1e-5 of JAX's (the
    first Adam steps move each coordinate by about the lr whatever the
    gradient's size, so only a gradient sign could split them)."""
    params = _params()
    jf, pf = _jax_field(), _port_field(params)
    pixels, dirs, norms, R0, t0, depth = _registration_case(seed=13)
    ref = jax_pose_refine.register_camera(
        jf, jax.tree.map(jnp.asarray, params), pixels, dirs, norms, R0, t0,
        options=JaxRenderOptions(**REG_OPTS), iters=3, depth=depth)
    seen = []
    ours = pose_refine.register_camera(
        pf, pixels, dirs, norms, R0, t0,
        options=RenderOptions(**REG_OPTS), iters=3, depth=depth,
        callback=lambda i, loss: seen.append(i))
    assert seen == [0, 1, 2]
    np.testing.assert_allclose(ours[0], ref[0], atol=1e-5)
    np.testing.assert_allclose(ours[1], ref[1], atol=1e-5)
    np.testing.assert_allclose(ours[2], ref[2], rtol=1e-4)
    assert all(p.requires_grad for p in pf.parameters())


def test_adam_and_cosine_decay_match_optax():
    """register_camera's Adam written out against optax.adam over
    optax.cosine_decay_schedule(lr, iters, alpha=0.01), 6 updates of one
    3-vector: each step (about lr in size) to fp32 rounding, so the sum of
    steps of mixed signs within 1e-5 relative or 1e-5 of the lr."""
    import optax
    rng = np.random.default_rng(14)
    grads = rng.normal(size=(6, 3)).astype(np.float32)
    tx = optax.adam(optax.cosine_decay_schedule(3e-3, 6, alpha=0.01))
    p = jnp.zeros(3)
    state = tx.init(p)
    ours = torch.zeros(3)
    mu, nu = torch.zeros(3), torch.zeros(3)
    for i, g in enumerate(grads):
        updates, state = tx.update(jnp.asarray(g), state)
        p = optax.apply_updates(p, updates)
        pose_refine.adam_update(ours, torch.tensor(g), mu, nu, i,
                                pose_refine.cosine_decay(3e-3, 6, i))
        np.testing.assert_allclose(ours.numpy(), np.asarray(p), rtol=1e-5,
                                   atol=3e-8)


# -- refined rays and poses -----------------------------------------------------

def _pose_init(rng, n_frames):
    R0 = np.asarray(jax_rodrigues(jnp.asarray(rng.normal(
        size=(n_frames, 3)).astype(np.float32)))).astype(np.float32)
    t0 = rng.uniform(-1, 1, (n_frames, 3)).astype(np.float32)
    return R0, t0


def test_refined_rays_and_poses_match_jax():
    """Frame 0 stays the gauge anchor; rays and poses to fp32 rounding."""
    rng = np.random.default_rng(15)
    R0, t0 = _pose_init(rng, 5)
    pose = {'rot': rng.normal(size=(5, 3)).astype(np.float32) * 0.1,
            't': rng.normal(size=(5, 3)).astype(np.float32) * 0.1}
    idx = rng.integers(0, 5, 40).astype(np.int32)
    d = rng.normal(size=(40, 3)).astype(np.float32)
    ref = jax_pose_refine.refined_rays(
        jax.tree.map(jnp.asarray, pose), (jnp.asarray(R0), jnp.asarray(t0)),
        jnp.asarray(idx), jnp.asarray(d))
    ours = pose_refine.refined_rays(
        {k: torch.tensor(v) for k, v in pose.items()},
        (torch.tensor(R0), torch.tensor(t0)), torch.tensor(idx),
        torch.tensor(d))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    R, t = pose_refine.refined_poses(pose, (R0, t0))
    Rj, tj = jax_pose_refine.refined_poses(pose, (R0, t0))
    np.testing.assert_allclose(R, Rj, atol=1e-6)
    np.testing.assert_allclose(t, tj, atol=1e-7)
    np.testing.assert_array_equal(R[0], R0[0])
    np.testing.assert_array_equal(t[0], t0[0])


# -- the optimizer's pose group ---------------------------------------------------

def test_pose_group_matches_optax_over_the_warmup():
    """make_optimizer with a 'pose' entry (iters 50: warmup 5 applied
    updates at scale 0, then 0.1 of the lr, no weight decay) against the
    port's Optimizer over 9 steps, the third of them non-finite (skipped
    whole, so the warmup counts applied updates): params, pose deltas and
    counts within 1e-5 relative (fp32 Adam)."""
    params = _params()
    rng = np.random.default_rng(16)
    pose = {'rot': np.zeros((4, 3), np.float32),
            't': np.zeros((4, 3), np.float32)}
    jparams = dict(params, pose=pose)
    tx = jax_optim.make_optimizer(jparams, lr=5e-3, iters=50)
    state = tx.init(jparams)
    pf = _port_field(params)
    ptorch = {k: torch.tensor(v) for k, v in pose.items()}
    labels = dict(pf.param_labels(), **{f'pose.{k}': 'pose' for k in pose})
    opt = optim.Optimizer([*pf.named_parameters(),
                           *((f'pose.{k}', v) for k, v in ptorch.items())],
                          labels, lr=5e-3, iters=50)
    assert opt.pose_warmup == 5
    moved = []
    for i in range(9):
        g = jax.tree.map(lambda p: (rng.normal(size=np.shape(p)) * 1e-2)
                         .astype(np.float32), jparams)
        if i == 2:
            g['pose']['rot'][1, 0] = np.nan
        updates, state = tx.update(g, state, jparams)
        jparams = jax.tree.map(np.asarray, jax.tree.map(
            lambda p, u: p + u, jparams, updates))
        flat = dict(_flat(g), **{f'pose.{k}': torch.tensor(v)
                                 for k, v in g['pose'].items()})
        opt.step(flat)
        moved.append(bool(np.abs(jparams['pose']['t']).max() > 0))
        for k in ('rot', 't'):
            np.testing.assert_allclose(ptorch[k].numpy(),
                                       jparams['pose'][k], rtol=1e-5,
                                       atol=1e-9)
    # the non-finite step is skipped, so the poses start moving on the 7th
    # step, the 6th applied update
    assert moved == [False] * 6 + [True] * 3
    assert int(opt.state['count']) == 8
    for name, p in pf.named_parameters():
        ref = bridge.params_from_numpy(
            {k: v for k, v in jparams.items() if k != 'pose'}, 'cpu')[name]
        np.testing.assert_allclose(p.detach().numpy(), ref.numpy(),
                                   rtol=1e-5, atol=1e-8)


# -- SimpleTrainer with pose refinement -------------------------------------------

TRAINER_OPTS = dict(num_steps=8, proposal_steps=16, perturb=False,
                    stochastic_corners=0)


def _pose_batch(rng, n_frames, n=64):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    depth = rng.uniform(0.2, 1.5, n).astype(np.float32)
    depth[::5] = 0.0
    return {'rays_o': np.zeros((n, 3), np.float32), 'rays_d': d,
            'direction_norms': rng.uniform(1.0, 1.3, n).astype(np.float32),
            'pixels': rng.uniform(0, 1, (n, 3)).astype(np.float32),
            'depth': depth,
            'semantic': rng.integers(-1, 4, n).astype(np.int32),
            'frame_idx': rng.integers(0, n_frames, n).astype(np.int32),
            'rays_d_cam': d}


def test_trainer_step_with_pose_refine_matches_jax():
    """One step's loss parts, field gradients and pose gradients with pose
    refinement, in its first phase (the coarsest level's window alone),
    with the 'xla' heads (the fused heads' input gradients are held in
    test_field_point_gradient_matches_jax and the registration tests):
    the port's loss_and_grads against jax.value_and_grad of the JAX
    trainer's loss (refined_rays, render_rays, compute_losses) on the same
    params, deltas and batch; loss parts within 1e-4, each gradient within
    1e-3 of its largest magnitude (fp32 sums in other orders); the finer
    level's table and frame 0's deltas get none."""
    params = _params()
    rng = np.random.default_rng(17)
    R0, t0 = _pose_init(rng, 4)
    pose = {'rot': rng.normal(size=(4, 3)).astype(np.float32) * 0.01,
            't': rng.normal(size=(4, 3)).astype(np.float32) * 0.01}
    batch = _pose_batch(rng, 4)
    pt = SimpleTrainer('t', _port_field(params, heads_impl='xla'), iters=100,
                       render_options=RenderOptions(**TRAINER_OPTS),
                       pose_refine=(R0, t0))
    with torch.no_grad():
        for k, v in pose.items():
            pt.pose[k].copy_(torch.tensor(v))
    assert pt.step_options().level_window == (1.0, 0.0)
    parts, grads = pt.loss_and_grads(batch)

    jf = _jax_field(heads_impl='xla')
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb['direction_norms'] = jb['direction_norms'][:, None]
    options = JaxRenderOptions(**TRAINER_OPTS, level_window=(1.0, 0.0))
    pose_init = (jnp.asarray(R0), jnp.asarray(t0))

    def loss_fn(p):
        o, d = jax_pose_refine.refined_rays(p['pose'], pose_init,
                                            jb['frame_idx'], jb['rays_d_cam'])
        out = jax_render_rays(jf, p, o, d, jb['direction_norms'],
                              options=options)
        return jax_compute_losses(out, jb, JaxLossOptions())

    jp = jax.tree.map(jnp.asarray, dict(params, pose=pose))
    (loss, ref_parts), ref_g = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jp)
    np.testing.assert_allclose(float(parts['total']), float(loss), rtol=1e-4)
    for k, v in ref_parts.items():
        np.testing.assert_allclose(float(parts[k]), float(v), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    flat = dict(_flat({k: v for k, v in ref_g.items() if k != 'pose'}),
                **{f'pose.{k}': torch.tensor(np.asarray(v))
                   for k, v in ref_g['pose'].items()})
    assert set(flat) == set(grads)
    for name, ref in flat.items():
        _rel_close(grads[name], ref.numpy(), 1e-3, name)
    assert not bool(grads['encoder.grid'][1].any())
    assert not bool(grads['pose.rot'][0].any())
    assert float(grads['pose.t'][1:].abs().max()) > 0


def test_phase_schedule_opens_the_level_windows():
    """With pose refinement on a grid of L levels the estimator phases give
    way to L windows over the first half, then the full options (JAX
    trainer.py:191-207): the JAX trainer's phase starts, and windows
    (1, 0, ...) ... (1, ..., 1) in turn."""
    opts = RenderOptions(perturb=True, stochastic_corners=0,
                         sampled_backward=2)
    phases = phase_schedule(opts, 1000, exact_final_fraction=0.1,
                            sampled_warmup_fraction=0.2, window_levels=4)
    assert [s for s, _ in phases] == [0, 125, 250, 375, 500]
    assert [o.level_window for _, o in phases] == [
        (1.0, 0.0, 0.0, 0.0), (1.0, 1.0, 0.0, 0.0), (1.0, 1.0, 1.0, 0.0),
        (1.0, 1.0, 1.0, 1.0), None]
    assert phases[-1][1] == opts
    jt = JaxSimpleTrainer('t', _jax_field(), iters=1000,
                          render_options=JaxRenderOptions(
                              perturb=True, stochastic_corners=0,
                              sampled_backward=2),
                          exact_final_fraction=0.1,
                          sampled_warmup_fraction=0.2, metrics=False,
                          pose_refine=(np.eye(3, dtype=np.float32)[None],
                                       np.zeros((1, 3), np.float32)))
    assert [s for s, _ in jt._phases] == [0, 250, 500]
    pt = SimpleTrainer('t', _port_field(_params()), iters=1000,
                       render_options=RenderOptions(
                           perturb=True, stochastic_corners=0,
                           sampled_backward=2),
                       exact_final_fraction=0.1, sampled_warmup_fraction=0.2,
                       pose_refine=(np.eye(3)[None], np.zeros((1, 3))))
    assert [s for s, _ in pt.phases] == [0, 250, 500]
    # the estimator is turned off for pose refinement, as in JAX
    assert pt.phases[-1][1].sampled_backward == 0
    assert [o.level_window for _, o in pt.phases[:2]] == [(1.0, 0.0),
                                                          (1.0, 1.0)]


# -- datasets and checkpoints -------------------------------------------------------

@pytest.fixture(scope='module')
def room(tmp_path_factory):
    scene = str(tmp_path_factory.mktemp('pose') / 'room')
    fixtures.make_room_scene(scene, n_frames=4, width=32, height=24,
                             label_every=2)
    return scene




def test_emit_frame_rays_batches_are_bit_equal(room):
    """With emit_frame_rays, both packages' batches (frame_idx, rays_d_cam
    and the world rays from the same jittered draw) are equal bit for bit
    under equal seeded rngs."""
    ours = SceneDataset('train', room, factor=1, batch_size=1024)
    ref = JaxSceneDataset('train', room, factor=1, batch_size=1024)
    def batches(dataset):
        np.random.seed(21)  # the class-balanced chunks' sampler
        dataset.rng = np.random.default_rng(5)
        dataset.emit_frame_rays = True
        return [dataset._next_train() for _ in range(3)]

    for a, b in zip(batches(ours), batches(ref)):
        assert set(a) == set(b) and {'frame_idx', 'rays_d_cam'} <= set(a)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_ngp_pose_to_scene_inverts_convert_pose():
    rng = np.random.default_rng(18)
    T = np.eye(4)
    T[:3, :3] = np.asarray(jax_rodrigues(jnp.asarray(rng.normal(size=3))))
    T[:3, 3] = rng.normal(size=3)
    back = rays.ngp_pose_to_scene(rays.convert_pose(T))
    np.testing.assert_allclose(back, T, atol=1e-6)
    np.testing.assert_allclose(back, jax_rays.ngp_pose_to_scene(
        jax_rays.convert_pose(T)), atol=1e-12)


def _small_trainer(ws, pose_refine, classes, package='port'):
    opts = dict(num_steps=8)
    kw = dict(proposal=False, semantic_classes=classes, heads_impl='xla')
    if package == 'jax':
        return JaxSimpleTrainer('ngp', _jax_field(**kw), iters=100,
                                workspace=ws, metrics=False,
                                render_options=JaxRenderOptions(**opts),
                                pose_refine=pose_refine)
    return SimpleTrainer('ngp', _port_field(_params(**kw), **kw),
                         iters=100, workspace=ws, metrics=False,
                         render_options=RenderOptions(**opts),
                         pose_refine=pose_refine)


def test_resume_across_the_pose_refine_toggle(room, tmp_path):
    """A checkpoint without deltas resumes with zero deltas and the moments
    restarted; one with them resumes them (and their EMA) and keeps the
    moments; a plain trainer drops them (JAX trainer.py:279-292)."""
    ds = SceneDataset('train', room, factor=1, batch_size=512)
    ds.rng = np.random.default_rng(6)
    classes = ds.n_classes
    pr = (np.array(ds.rotations), np.array(ds.origins))
    ws = str(tmp_path / 'ws')
    plain = _small_trainer(ws, None, classes)
    plain.train_iterations(ds, 1)
    plain.save_checkpoint()
    ds.emit_frame_rays = True
    resumed = _small_trainer(ws, pr, classes)
    assert resumed.global_step == 1
    assert int(resumed.optimizer.state['count']) == 0
    assert not any(bool(v.any()) for v in resumed.pose.values())
    with torch.no_grad():
        resumed.pose['t'][2] = 0.25
    resumed._ema_step()
    resumed.epoch = 1
    resumed.save_checkpoint()
    again = _small_trainer(ws, pr, classes)
    assert float(again.pose['t'][2, 0].detach()) == 0.25
    assert torch.equal(again.ema['pose.t'], resumed.ema['pose.t'])
    assert int(again.optimizer.state['count']) == \
        int(resumed.optimizer.state['count'])
    again.train_iterations(ds, 1)
    ds.emit_frame_rays = False
    back = _small_trainer(ws, None, classes)
    assert back.global_step == 1 and not back.pose
    back.train_iterations(ds, 1)


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_pose_checkpoints_load_across_packages(room, tmp_path, writer):
    """A checkpoint with deltas written by either package resumes in the
    other with the same deltas; one without them gains zero deltas."""
    reader = 'port' if writer == 'jax' else 'jax'
    ds = SceneDataset('train', room, factor=1, batch_size=512)
    classes = ds.n_classes
    pr = (np.array(ds.rotations), np.array(ds.origins))
    ws = str(tmp_path / 'ws')
    w = _small_trainer(ws, pr, classes, writer)
    deltas = np.random.default_rng(19).normal(size=(4, 3)).astype(np.float32)
    if writer == 'jax':
        w.state['params']['pose']['rot'] = jnp.asarray(deltas)
    else:
        with torch.no_grad():
            w.pose['rot'].copy_(torch.tensor(deltas))
    w.epoch = 1
    w.save_checkpoint()
    r = _small_trainer(ws, pr, classes, reader)
    got = (np.asarray(r.state['params']['pose']['rot']) if reader == 'jax'
           else r.pose['rot'].detach().numpy())
    np.testing.assert_array_equal(got, deltas)
    plain_ws = str(tmp_path / 'plain')
    _small_trainer(plain_ws, None, classes, writer).save_checkpoint()
    r = _small_trainer(plain_ws, pr, classes, reader)
    got = (np.asarray(r.state['params']['pose']['t']) if reader == 'jax'
           else r.pose['t'].detach().numpy())
    assert not got.any()


def test_trainer_renders_and_serves_without_the_deltas():
    """The EMA covers the deltas, and rendering with it loads only the
    field's part."""
    rng = np.random.default_rng(20)
    R0, t0 = _pose_init(rng, 3)
    pt = SimpleTrainer('t', _port_field(_params()), iters=100,
                       render_options=RenderOptions(**TRAINER_OPTS),
                       pose_refine=(R0, t0))
    assert {'pose.rot', 'pose.t'} <= set(pt.ema)
    frame = {'rays_o': np.zeros((2, 3, 3), np.float32),
             'rays_d': np.tile(np.array([0, 0, 1], np.float32), (2, 3, 1)),
             'direction_norms': np.ones((2, 3), np.float32)}
    image = pt.test_step(frame, use_ema=True)[0]
    assert image.shape == (2, 3, 3)
    assert pt.render_options.sampled_backward == 0
