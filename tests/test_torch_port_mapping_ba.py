"""The port's bundle adjustment against autolabel_tpu.mapping.ba on the CPU.

Same seeded numpy inputs through both: the residual and its parts, the
gradient and the damped normal product of `_lm_step` (the port's plain
version, torch.func's vjp and jvp of `_residual`, and
`normal_matvec_analytic`, the torch mirror of K9's analytic arithmetic),
the conjugate-gradient delta under jax.scipy's stopping rule (the loop
that stops and the card's frozen form), one LM step, the whole solve, and
the log map that replaces cv2.Rodrigues. Problems: tests/test_mapping_sfm's
ring (6 cameras, 120 points) and a ring with outliers, an observation
behind its camera (the depth clamp), one exactly at the clamp (a tie) and
a camera at theta = 0 (rodrigues' Taylor branch).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autolabel_tpu.mapping import ba as jba
from autolabel_tpu_torch.mapping import ba
from autolabel_tpu_torch.ops import ba_cuda

cv2 = pytest.importorskip('cv2')

INTR = (500.0, 500.0, 320.0, 240.0)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ring(rng, n_cams=6, n_pts=120, noise_px=0.0):
    """tests/test_mapping_sfm.py's problem: cameras on a ring looking at
    points scattered around the origin, every point seen by every camera."""
    points = rng.uniform(-1, 1, size=(n_pts, 3))
    rvecs, tvecs = [], []
    for i in range(n_cams):
        ang = 2 * np.pi * i / n_cams
        center = np.array([3 * np.cos(ang), 3 * np.sin(ang), 1.0])
        z = -center / np.linalg.norm(center)
        x = np.cross(np.array([0, 0, 1.0]), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        rvecs.append(cv2.Rodrigues(R)[0].ravel())
        tvecs.append(-R @ center)
    rvecs, tvecs = np.stack(rvecs), np.stack(tvecs)
    R_all = np.asarray(jba.rodrigues(rvecs))
    cam_idx = np.repeat(np.arange(n_cams), n_pts)
    pt_idx = np.tile(np.arange(n_pts), n_cams)
    Xc = np.einsum('nij,nj->ni', R_all[cam_idx], points[pt_idx]) \
        + tvecs[cam_idx]
    xy = Xc[:, :2] / Xc[:, 2:3] * np.array(INTR[:2]) + np.array(INTR[2:])
    xy = xy + rng.normal(scale=noise_px, size=xy.shape)
    return rvecs, tvecs, points, INTR, cam_idx, pt_idx, xy


def _hard(rng):
    """The ring with 0.5 px noise and 5% outliers at 20-50 px, perturbed;
    camera 1 rotated to theta = 0 exactly (identity R), point 0 moved
    behind camera 1 (its observation clamped) and point 1 put exactly on
    the clamp depth of camera 1 (z = 1e-6 in fp32: a tie)."""
    rvecs, tvecs, points, intr, ci, pi, xy = _ring(rng, noise_px=0.5)
    n = len(ci)
    bad = rng.random(n) < 0.05
    ang = rng.uniform(0, 2 * np.pi, n)
    mag = rng.uniform(20, 50, n)
    xy = xy + bad[:, None] * np.stack([np.cos(ang), np.sin(ang)], 1) \
        * mag[:, None]
    rvecs = rvecs + rng.normal(scale=0.01, size=rvecs.shape)
    tvecs = tvecs + rng.normal(scale=0.05, size=tvecs.shape)
    points = points + rng.normal(scale=0.05, size=points.shape)
    rvecs[1] = 0.0
    tvecs[1] = [0.0, 0.0, float(np.float32(1e-6))]
    points[0] = [0.2, -0.1, -0.5]
    points[1] = [0.3, 0.2, 0.0]
    return rvecs, tvecs, points, intr, ci, pi, xy


def _problem(kind, seed=0):
    rng = np.random.default_rng(seed)
    return _hard(rng) if kind == 'hard' else _ring(rng, noise_px=0.5)


def _sqrt_w(n, seed):
    return np.random.default_rng(seed).uniform(0.2, 1.0, n).astype(np.float32)


def _both(prob, sqrt_w, dlog_f=0.0):
    """(JAX params, const), (port params, const) from one problem."""
    rvecs, tvecs, points, intr, ci, pi, xy = prob
    f32 = lambda a: np.asarray(a, np.float32)
    jp = (jnp.asarray(f32(rvecs)), jnp.asarray(f32(tvecs)),
          jnp.asarray(f32(points)), jnp.asarray(np.float32(dlog_f)))
    jc = (tuple(float(v) for v in intr), jnp.asarray(ci, jnp.int32),
          jnp.asarray(pi, jnp.int32), jnp.asarray(f32(xy)),
          jnp.asarray(sqrt_w))
    tp = (torch.tensor(f32(rvecs)), torch.tensor(f32(tvecs)),
          torch.tensor(f32(points)), torch.tensor(np.float32(dlog_f)))
    tc = (tuple(float(v) for v in intr), torch.tensor(ci, dtype=torch.int32),
          torch.tensor(pi, dtype=torch.int32), torch.tensor(f32(xy)),
          torch.tensor(sqrt_w))
    return (jp, jc), (tp, tc)


def _jax_products(params, const, refine_focal):
    """_lm_step's products as autolabel_tpu/mapping/ba.py:83-91 writes
    them: (cost, masked g, normal_matvec)."""
    r, pullback = jax.vjp(lambda p: jba._residual(p, const), params)
    g = jba._mask_gauge(pullback(r)[0], refine_focal)

    def matvec(lam, v):
        v = jba._mask_gauge(v, refine_focal)
        jv = jax.jvp(lambda p: jba._residual(p, const), (params,), (v,))[1]
        jtjv = jba._mask_gauge(pullback(jv)[0], refine_focal)
        return jax.tree.map(lambda a, b: a + lam * b, jtjv, v)

    return 0.5 * jnp.sum(r * r), g, matvec


def _jax_tree(v, m=6, p=120):
    """A flat vector as JAX's (rvecs, tvecs, points, dlog_f) tree."""
    return (jnp.asarray(v[:3 * m].reshape(m, 3)),
            jnp.asarray(v[3 * m:6 * m].reshape(m, 3)),
            jnp.asarray(v[6 * m:6 * m + 3 * p].reshape(p, 3)),
            jnp.asarray(v[6 * m + 3 * p]))


def _flat(tree):
    return np.concatenate([np.asarray(t, np.float64).ravel() for t in tree])


def _scale(pred, intr):
    """Each observation's magnitude (N, 1): its largest projected
    coordinate, plus the principal point that every coordinate's sum
    u fx + cx passes through."""
    return np.abs(np.asarray(pred, np.float64)).max(1, keepdims=True) \
        + max(intr[2], intr[3])


def _cost_tol(r, scale):
    """The cost's tolerance: each residual within 1e-6 of its
    observation's `scale`, so 0.5 sum r^2 within sum |r| 1e-6 scale, plus
    1e-6 of it for the sum's own order."""
    r = np.asarray(r, np.float64)
    return 1e-6 * (scale * np.abs(r)).sum() + 1e-6 * 0.5 * (r * r).sum()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def test_kernel_constants_match_the_source():
    src = open(os.path.join(os.path.dirname(ba_cuda.__file__), '..', 'csrc',
                            'ba_normal.cu')).read()
    assert f'#define BA_THREADS {ba_cuda.THREADS}' in src
    assert 'ba_normal.cu' in ba_cuda._kernels.SOURCES


@pytest.mark.parametrize('kind', ['ring', 'hard'])
def test_project_residual_cost_huber_match_jax(kind):
    """Within 1e-6 of each observation's magnitude (`_scale`): both compute
    the same fp32 operations, XLA fusing the rotation's dot into fma
    chains, so coordinates differ by a rounding or two of values of that
    size, and the residual is a difference of such coordinates (measured:
    at most 1 ulp of 557 on the ring)."""
    prob = _problem(kind, seed=3)
    sw = _sqrt_w(len(prob[4]), 4)
    (jp, jc), (tp, tc) = _both(prob, sw, dlog_f=0.02)
    intr = (500.0 * 1.02, 501.0, 320.0, 240.0)
    want = np.asarray(jba._project(*jp[:3], intr, jc[1], jc[2]))
    got = ba._project(*tp[:3], intr, tc[1], tc[2]).numpy()
    scale = _scale(want, intr)
    assert (np.abs(got - want) <= 1e-6 * scale).all()
    want_r = np.asarray(jba._residual(jp, jc))
    got_r = ba._residual(tp, tc).numpy()
    # r = (pred - xy) sqrt_w: its rounding scales with sqrt_w too.
    scale = _scale(want_r / sw[:, None] + np.asarray(jc[3]), jc[0]) \
        * sw[:, None]
    assert (np.abs(got_r - want_r) <= 1e-6 * scale).all()
    want_c = float(jba._cost(jp, jc, False))
    assert abs(float(ba._cost(tp, tc, False)) - want_c) \
        <= _cost_tol(want_r, scale)
    # w = sqrt(min(1, delta / |r|)) moves by w / 2 times |r|'s relative
    # error, |r| within 1e-6 of its observation's scale.
    ones = (jc[0], jc[1], jc[2], jc[3], jnp.ones(len(sw), jnp.float32))
    tones = (tc[0], tc[1], tc[2], tc[3], torch.ones(len(sw)))
    want_w = np.asarray(jba._huber_sqrt_weights(jp, ones, 4.0))
    got_w = ba._huber_sqrt_weights(tp, tones, 4.0).numpy()
    norm = np.linalg.norm(np.asarray(jba._residual(jp, ones)), axis=-1)
    unit = scale[:, 0] / sw
    assert (np.abs(got_w - want_w)
            <= 0.5 * want_w * 1e-6 * unit / np.maximum(norm, 1e-9)
            + 1e-6 * want_w).all()
    if kind == 'hard':
        assert (want_w < 1).mean() > 0.04  # the outliers' weights bite


def test_clamp_tie_passes_half_the_gradient():
    """torch.maximum passes half the gradient at a tie, as jnp.maximum
    does (and K9's dz = 1/2): z = 1e-6 exactly for point 1 in camera 1."""
    x = torch.tensor(np.float32(1e-6), requires_grad=True)
    z = torch.maximum(x, torch.tensor(ba.Z_MIN))
    z.backward()
    assert float(x.grad) == 0.5
    jgrad = jax.grad(lambda a: jnp.maximum(a, 1e-6))(jnp.float32(1e-6))
    assert float(jgrad) == 0.5
    _, tangent = torch.func.jvp(
        lambda a: torch.maximum(a, torch.tensor(ba.Z_MIN)),
        (torch.tensor(np.float32(1e-6)),), (torch.tensor(1.0),))
    assert float(tangent) == 0.5


def test_rodrigues_jacobian_matches_jax():
    """dR/drvec by forward mode, as K9 takes it, at random vectors and at
    theta = 0 (the Taylor branch); within 1e-6 (entries of order 1)."""
    rv = np.random.default_rng(5).normal(size=(5, 3)).astype(np.float32)
    rv[0] = 0.0
    rv[1] = [1e-5, -2e-5, 0.0]
    want = np.asarray(jax.vmap(jax.jacfwd(jba.rodrigues))(jnp.asarray(rv)))
    got = ba.rodrigues_jacobian(torch.tensor(rv)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize('refine_focal', [False, True])
@pytest.mark.parametrize('kind', ['ring', 'hard'])
def test_gradient_and_normal_matvec_match_jax(kind, refine_focal):
    """g and (J^T J + lam I) v within 1e-5 of JAX's by relative norm, from
    the plain version and from K9's arithmetic, under both gauge masks:
    sums of N terms in other orders (index_add_ and XLA's scatter), and
    at the clamped observation a derivative of 1/z = 1e6 times larger than
    the others, which fp32 carries with its relative error."""
    prob = _problem(kind, seed=6)
    sw = _sqrt_w(len(prob[4]), 7)
    (jp, jc), (tp, tc) = _both(prob, sw, dlog_f=0.03)
    jcost, jg, jmatvec = _jax_products(jp, jc, refine_focal)
    r = np.asarray(jba._residual(jp, jc))
    scale = _scale(r / sw[:, None] + np.asarray(jc[3]), jc[0])
    v = np.random.default_rng(8).normal(
        size=ba.size(6, 120)).astype(np.float32)
    tv = torch.tensor(v)
    jv = _jax_tree(v)
    lam = 0.37
    want_mv = _flat(jmatvec(jnp.float32(lam), jv))
    for products in (ba.PlainProducts, ba.AnalyticProducts):
        prod = products(tp, tc, refine_focal)
        _, cost, g = prod.residual_grad()
        assert abs(float(cost) - float(jcost)) <= _cost_tol(r, scale)
        assert _rel(g.numpy(), _flat(jg)) <= 1e-5, products.__name__
        got_mv = prod.matvec(tv, lam).numpy()
        assert _rel(got_mv, want_mv) <= 1e-5, products.__name__
        # the gauge's entries: zero in g, lam * 0 in the product
        for out in (g.numpy(), got_mv):
            assert not out[:3].any() and not out[18:21].any()
            assert (out[-1] != 0) == refine_focal
    # The module-level mirrors are the same arithmetic.
    g2 = ba.residual_grad_analytic(tp, tc, refine_focal)[2]
    mv2 = ba.normal_matvec_analytic(tp, tc, refine_focal, tv, lam)
    assert _rel(g2.numpy(), _flat(jg)) <= 1e-5
    assert _rel(mv2.numpy(), want_mv) <= 1e-5


def test_clamped_and_tied_observations_match_jax():
    """The hard problem's two special observations alone: point 0 behind
    camera 1 (z column zero) and point 1 at the clamp depth (half of it);
    each observation's own J^T J v within 1e-5 by relative norm."""
    prob = list(_problem('hard', seed=9))
    ci, pi = prob[4], prob[5]
    keep = (ci == 1) & (pi < 2)
    prob[4], prob[5], prob[6] = ci[keep], pi[keep], prob[6][keep]
    sw = np.ones(keep.sum(), np.float32)
    (jp, jc), (tp, tc) = _both(tuple(prob), sw)
    Xc_z = np.asarray(jp[2])[:2, 2] + np.float32(1e-6)
    assert Xc_z[0] < 1e-6 and Xc_z[1] == np.float32(1e-6)
    _, jg, jmatvec = _jax_products(jp, jc, True)
    v = np.random.default_rng(10).normal(
        size=ba.size(6, 120)).astype(np.float32)
    jv = _jax_tree(v)
    want = _flat(jmatvec(jnp.float32(0.0), jv))
    for products in (ba.PlainProducts, ba.AnalyticProducts):
        prod = products(tp, tc, True)
        assert _rel(prod.residual_grad()[2].numpy(), _flat(jg)) <= 1e-5
        assert _rel(prod.matvec(torch.tensor(v), 0.0).numpy(), want) <= 1e-5


def _jax_cg(jp, jc, lam, refine_focal, maxiter):
    _, jg, jmatvec = _jax_products(jp, jc, refine_focal)
    neg_g = jax.tree.map(jnp.negative, jg)
    delta, _ = jax.scipy.sparse.linalg.cg(
        lambda v: jmatvec(jnp.float32(lam), v), neg_g, maxiter=maxiter)
    return _flat(delta)


@pytest.mark.parametrize('lam,maxiter', [(1e-2, 50), (1e7, 50), (1e-2, 7)])
def test_cg_matches_jax_and_frozen_equals_break(lam, maxiter):
    """The CG delta within 1e-4 of jax.scipy's by relative norm (50 fp32
    iterations on an ill-conditioned system amplify the products'
    roundings); the frozen form (no host sync, torch.where once the test
    holds) equal to the loop that stops, and stopping as often. At lam =
    1e7 the system is well conditioned and the test stops it early."""
    prob = _problem('ring', seed=11)
    prob = (prob[0] + 0.01, prob[1] - 0.02, prob[2] * 1.01) + prob[3:]
    sw = np.ones(len(prob[4]), np.float32)
    (jp, jc), (tp, tc) = _both(prob, sw)
    want = _jax_cg(jp, jc, lam, False, maxiter)
    prod = ba.AnalyticProducts(tp, tc, False)
    g = prod.residual_grad()[2]
    stop, k_stop = ba.cg(lambda v: prod.matvec(v, lam), -g, 6, 120, maxiter)
    frozen, k_frozen = ba.cg(lambda v: prod.matvec(v, lam), -g, 6, 120,
                             maxiter, frozen=True)
    assert _rel(stop.numpy(), want) <= 1e-4
    assert _rel(frozen.numpy(), stop.numpy()) <= 1e-4
    assert int(k_frozen) == k_stop
    if lam == 1e7:
        assert k_stop < maxiter
    else:
        assert k_stop == maxiter


@pytest.mark.parametrize('refine_focal', [False, True])
def test_lm_step_matches_jax(refine_focal):
    """One LM step on the hard problem under JAX's Huber weights (as
    bundle_adjust calls it): the candidate within 1e-4 of JAX's by
    relative norm (the CG delta's tolerance), the delta itself within
    1e-3 (50 fp32 iterations), the cost within `_cost_tol`."""
    prob = _problem('hard', seed=12)
    (jp, jc), _ = _both(prob, np.ones(len(prob[4]), np.float32))
    sw = np.asarray(jba._huber_sqrt_weights(jp, jc, 4.0))
    (jp, jc), (tp, tc) = _both(prob, sw)
    jcand, jcost = jba._lm_step(jp, jc, 1e-2, refine_focal, 50)
    stats = {}
    cand, cost = ba._lm_step(tp, tc, 1e-2, refine_focal, 50, stats)
    r = np.asarray(jba._residual(jp, jc))
    scale = _scale(r / sw[:, None] + np.asarray(jc[3]), jc[0]) * sw[:, None]
    assert abs(float(cost) - float(jcost)) <= _cost_tol(r, scale)
    want, got = _flat(jcand), _flat([c.numpy() for c in cand])
    assert _rel(got, want) <= 1e-4
    assert _rel(got - _flat(jp), want - _flat(jp)) <= 1e-3
    assert 0 < stats['cg'][0] <= 50


def test_bundle_adjust_recovers_perturbed_geometry_as_jax():
    """tests/test_mapping_sfm.py's solve: perturbed poses and points, rms
    below JAX's bar of 0.05 px, focal untouched, and the parameters
    within 1e-4 of JAX's (the same LM decisions; fp32 sums in another
    order)."""
    rng = np.random.default_rng(1)
    rvecs, tvecs, points, intr, ci, pi, xy = _ring(rng)
    rv0 = rvecs + rng.normal(scale=0.01, size=rvecs.shape)
    tv0 = tvecs + rng.normal(scale=0.05, size=tvecs.shape)
    pt0 = points + rng.normal(scale=0.05, size=points.shape)
    rv0[0], tv0[0] = rvecs[0], tvecs[0]
    want = jba.bundle_adjust(rv0, tv0, pt0, intr, ci, pi, xy, max_iters=40)
    stats = {}
    got = ba.bundle_adjust(rv0, tv0, pt0, intr, ci, pi, xy, max_iters=40,
                           device='cpu', stats=stats)
    assert got[4] < 0.05, got[4]
    assert got[3] == intr
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    assert 0 < stats['lm'] <= 40 and len(stats['cg']) == stats['lm']


def test_bundle_adjust_refine_focal_as_jax():
    """A focal 10% wrong with refine_focal: the focal moves within 20% of
    the error of the truth and rms < 0.5 px (JAX's bars), the parameters
    and the focal within 1e-4 (relative, for the focal) of JAX's."""
    rng = np.random.default_rng(2)
    rvecs, tvecs, points, intr, ci, pi, xy = _ring(rng)
    wrong = (intr[0] * 1.1, intr[1] * 1.1, intr[2], intr[3])
    want = jba.bundle_adjust(rvecs, tvecs, points, wrong, ci, pi, xy,
                             max_iters=40, refine_focal=True)
    got = ba.bundle_adjust(rvecs, tvecs, points, wrong, ci, pi, xy,
                           max_iters=40, refine_focal=True, device='cpu')
    assert abs(got[3][0] - intr[0]) < abs(wrong[0] - intr[0]) * 0.2
    assert got[4] < 0.5, got[4]
    assert abs(got[3][0] - want[3][0]) <= 1e-4 * want[3][0]
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def test_bundle_adjust_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    prob = _ring(np.random.default_rng(0))
    with pytest.raises(RuntimeError, match='device'):
        ba.bundle_adjust(*prob)


def test_kernel_products_refuse_cpu_tensors():
    """On anything but CUDA tensors K9's wrapper raises; it never falls
    back to a plain version."""
    (_, _), (tp, tc) = _both(_ring(np.random.default_rng(0)),
                             np.ones(720, np.float32))
    with pytest.raises(ValueError, match='CUDA'):
        ba_cuda.KernelProducts(ba.rodrigues(tp[0]),
                               ba.rodrigues_jacobian(tp[0]), *tp[1:], tc,
                               False)
    assert isinstance(ba.products(tp, tc, False), ba.AnalyticProducts)


def _random_rotations(rng, n):
    out = []
    for _ in range(n):
        Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(Q) < 0:
            Q[:, 0] *= -1
        out.append(Q)
    return out


def _axis_angle(axis, theta):
    axis = np.asarray(axis, np.float64)
    return cv2.Rodrigues(axis / np.linalg.norm(axis) * theta)[0]


def test_rotmat_to_rvec_matches_cv2():
    """cv2.Rodrigues's log map at random rotations, near theta = 0
    (including exactly 0 and its s < 1e-5 branch) and near and at theta =
    pi (both branches, axes with negative components): within 1e-9 (both
    in float64; near pi the branch's square roots are conditioned by
    1 / s)."""
    rng = np.random.default_rng(14)
    cases = _random_rotations(rng, 20)
    for theta in (0.0, 1e-12, 1e-8, 1e-6, 1e-5, 1e-3):
        cases.append(_axis_angle(rng.normal(size=3), theta))
    for axis in ([1, 0, 0], [0, 1, 0], [0, 0, 1], [1, -2, 0.5],
                 [-0.3, 0.4, -0.8], [0.1, -0.1, 1.0], [-1, -1, 1]):
        for theta in (np.pi, np.pi - 1e-9, np.pi - 1e-6, np.pi - 1e-3):
            cases.append(_axis_angle(axis, theta))
    cases.append(np.eye(3))
    cases.append(np.diag([1.0, -1.0, -1.0]))
    cases.append(np.diag([-1.0, -1.0, 1.0]))
    for R in cases:
        want = cv2.Rodrigues(R)[0].ravel()
        got = ba.rotmat_to_rvec(R)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
