"""Bundle adjustment: a matrix-free Levenberg-Marquardt solve.

Counterpart of autolabel_tpu/mapping/ba.py. The reprojection residual of
every observation is one row of one batched computation (rotate +
project, over the observation list), and Levenberg-Marquardt needs only
Jacobian products, so the damped normal equations (J^T W J + lam I) delta =
-J^T W r are solved by conjugate gradients without forming J.

The products of one LM step come from `products`: on CUDA tensors K9
(ops/ba_cuda, csrc/ba_normal.cu), on CPU tensors `AnalyticProducts`, K9's
analytic arithmetic in torch (index_add_ for its atomics), which the CPU
tests hold against JAX's autodiff. Each has `cg_solve`: on the card K9's
whole CG solve in one launch (JAX's jitted `_lm_step` runs jax.scipy's
CG as a device loop too); on the CPU, and for the plain products, `cg`
over their matvec, the solve's plain version. `PlainProducts`,
torch.func's vjp and jvp of `_residual` (the direct mirror of JAX's
`_lm_step`), is the plain version and the oracle on the card. It is not
the CPU's because
torch.func's forward mode costs about 12 ms a product on the CPU at any
size (Python decompositions of its scalar ops), 15 times
`AnalyticProducts` on a 720-observation problem, which would make a CPU
mapping run take minutes.

Robustness is IRLS-Huber: weights from the residuals at the top of each LM
iteration, held fixed through the CG solve.

Conventions match COLMAP: poses are world -> camera (x_c = R x_w + t),
rotations as Rodrigues vectors. Camera 0 is the gauge anchor (its pose
update is masked out). Everything is fp32, as in JAX.
"""
import numpy as np
import torch

from autolabel_tpu_torch.device import resolve_device
from autolabel_tpu_torch.ops import ba_cuda

Z_MIN = 1e-6  # `_project`'s depth clamp
CG_TOL = 1e-5  # jax.scipy.sparse.linalg.cg's default tol (atol 0)


def rodrigues(rvec):
    """Rodrigues vector(s) (..., 3) -> rotation matrix (..., 3, 3).

    The unnormalised form R = I + A K + B K^2, K = skew(rvec),
    A = sin(theta) / theta, B = (1 - cos(theta)) / theta^2, switched to its
    Taylor terms where theta^2 < 1e-8, as the JAX package writes it: it is
    differentiable at theta = 0, where every pose delta starts (the
    axis-normalised form has a 0/0 in d theta / d rvec there). theta is
    taken from max(theta^2, 1e-12), so the branch not taken has a finite
    gradient too.
    """
    kx, ky, kz = rvec[..., 0], rvec[..., 1], rvec[..., 2]
    zero = torch.zeros_like(kx)
    K = torch.stack([
        torch.stack([zero, -kz, ky], dim=-1),
        torch.stack([kz, zero, -kx], dim=-1),
        torch.stack([-ky, kx, zero], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    t2 = (rvec * rvec).sum(-1)[..., None, None]
    th = torch.sqrt(torch.maximum(t2, torch.tensor(1e-12, dtype=rvec.dtype,
                                                   device=rvec.device)))
    small = t2 < 1e-8
    A = torch.where(small, 1.0 - t2 / 6.0, torch.sin(th) / th)
    B = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(th)) / (th * th))
    return eye + A * K + B * (K @ K)


def rodrigues_jacobian(rvecs):
    """dR/drvec of M cameras, (M, 3, 3, 3): [c, i, j, k] = dR_ij / drvec_k
    (forward mode through `rodrigues`, its Taylor branch included)."""
    return torch.func.vmap(torch.func.jacfwd(rodrigues))(rvecs)


def rotmat_to_rvec(R):
    """Rotation matrix -> Rodrigues vector (3,), float64: cv2.Rodrigues's
    log map (calib3d's cvRodrigues2) in numpy, including its projection
    onto the nearest rotation (the SVD's U V^T) and its branches near
    theta = 0 and theta = pi."""
    U, _, Vt = np.linalg.svd(np.asarray(R, np.float64))
    R = U @ Vt
    r = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = np.sqrt((r @ r) * 0.25)
    c = min(max((R[0, 0] + R[1, 1] + R[2, 2] - 1) * 0.5, -1.0), 1.0)
    theta = np.arccos(c)
    if s >= 1e-5:
        return r * (theta / (2 * s))
    if c > 0:
        return np.zeros(3)
    r = np.array([np.sqrt(max((R[0, 0] + 1) * 0.5, 0.0)),
                  np.sqrt(max((R[1, 1] + 1) * 0.5, 0.0))
                  * (-1.0 if R[0, 1] < 0 else 1.0),
                  np.sqrt(max((R[2, 2] + 1) * 0.5, 0.0))
                  * (-1.0 if R[0, 2] < 0 else 1.0)])
    if (abs(r[0]) < abs(r[1]) and abs(r[0]) < abs(r[2])
            and (R[1, 2] > 0) != (r[1] * r[2] > 0)):
        r[2] = -r[2]
    return r * (theta / np.linalg.norm(r))


def _project(rvecs, tvecs, points, intr, cam_idx, pt_idx):
    """Reproject each observation; returns (N, 2) pixel coordinates."""
    R = rodrigues(rvecs)[cam_idx]            # (N, 3, 3)
    X = points[pt_idx]                       # (N, 3)
    Xc = torch.einsum('nij,nj->ni', R, X) + tvecs[cam_idx]
    # torch.maximum, like jnp.maximum, passes half the gradient at a tie.
    z = torch.maximum(Xc[:, 2:3], torch.tensor(Z_MIN, dtype=Xc.dtype,
                                               device=Xc.device))
    uv = Xc[:, :2] / z
    fx, fy, cx, cy = intr
    return torch.stack([uv[:, 0] * fx + cx, uv[:, 1] * fy + cy], dim=-1)


def _residual(params, const):
    rvecs, tvecs, points, dlog_f = params
    intr0, cam_idx, pt_idx, xy, sqrt_w = const
    f_scale = torch.exp(dlog_f)
    intr = (intr0[0] * f_scale, intr0[1] * f_scale, intr0[2], intr0[3])
    pred = _project(rvecs, tvecs, points, intr, cam_idx, pt_idx)
    return (pred - xy) * sqrt_w[:, None]


def _mask_gauge(params, refine_focal):
    """Zero the gauge-anchor (camera 0) and, optionally, focal updates."""
    rvecs, tvecs, points, dlog_f = params
    mask = torch.ones((rvecs.shape[0], 1), dtype=rvecs.dtype,
                      device=rvecs.device)
    mask[0] = 0.0
    return (rvecs * mask, tvecs * mask, points,
            dlog_f if refine_focal else torch.zeros_like(dlog_f))


# ---- one LM step's products: the flat layout, the plain version, the
# dispatch


def size(m, p):
    """L, the flat vector's length: M Rodrigues vectors, M translations,
    P points and the log focal scale."""
    return 6 * m + 3 * p + 1


def flatten(tree):
    rvecs, tvecs, points, dlog_f = tree
    return torch.cat([rvecs.reshape(-1), tvecs.reshape(-1),
                      points.reshape(-1), dlog_f.reshape(1)])


def unflatten(flat, m, p):
    """The flat vector's four leaves, as views."""
    return (flat[:3 * m].view(m, 3), flat[3 * m:6 * m].view(m, 3),
            flat[6 * m:6 * m + 3 * p].view(p, 3), flat[6 * m + 3 * p])


def gauge_mask(m, p, refine_focal, device):
    """`_mask_gauge` as a flat 0/1 vector."""
    mask = torch.ones(size(m, p), dtype=torch.float32, device=device)
    mask[:3] = 0.0
    mask[3 * m:3 * m + 3] = 0.0
    if not refine_focal:
        mask[-1] = 0.0
    return mask


class _TorchSolve:
    """`cg` over the products' own matvec: the plain version of K9's
    solve (frozen on CUDA tensors, no host sync an iteration)."""

    def cg_solve(self, b, lam, maxiter, tol=CG_TOL):
        return cg(lambda v: self.matvec(v, lam), b, self.m, self.p,
                  maxiter, tol, frozen=b.device.type == 'cuda')


class PlainProducts(_TorchSolve):
    """The plain version: torch.func's vjp of `_residual` at params, kept
    for the step as JAX keeps its pullback, and a jvp a product."""

    def __init__(self, params, const, refine_focal):
        self.params, self.const = params, const
        self.refine_focal = refine_focal
        self.m, self.p = params[0].shape[0], params[2].shape[0]
        self.r, self._pullback = torch.func.vjp(self._residual, params)

    def _residual(self, params):
        return _residual(params, self.const)

    def residual_grad(self):
        r = self.r
        g = _mask_gauge(self._pullback(r)[0], self.refine_focal)
        return r, 0.5 * torch.sum(r * r), flatten(g)

    def matvec(self, v, lam):
        v = _mask_gauge(unflatten(v, self.m, self.p), self.refine_focal)
        jv = torch.func.jvp(self._residual, (self.params,), (v,))[1]
        jtjv = _mask_gauge(self._pullback(jv)[0], self.refine_focal)
        return flatten(jtjv) + lam * flatten(v)


def products(params, const, refine_focal, layout=None):
    """One LM step's products: K9's arithmetic in torch on CPU tensors
    (`AnalyticProducts`), K9 on CUDA tensors. layout: K9's solve layout
    (`ba_cuda.Layout`, built once a bundle adjustment; None: built at the
    first solve)."""
    rvecs = params[0]
    if rvecs.device.type == 'cpu':
        return AnalyticProducts(params, const, refine_focal)
    return ba_cuda.KernelProducts(
        rodrigues(rvecs).contiguous(),
        rodrigues_jacobian(rvecs).contiguous(), *params[1:], const,
        refine_focal, layout)


def residual(params, const):
    """r alone (`_cost`, `_huber_sqrt_weights`): the plain `_residual` on
    CPU tensors, K9's entry 1 without the gradient on CUDA tensors."""
    if params[0].device.type == 'cpu':
        return _residual(params, const)
    return ba_cuda.KernelProducts(
        rodrigues(params[0]).contiguous(), None, *params[1:], const,
        False).residual_grad(False)[0]


# ---- a torch mirror of K9's arithmetic


def _linearize(R, dR, tvecs, points, dlog_f, intr0, cam_idx, pt_idx):
    """Each observation's linearisation point, as K9 computes it."""
    cam, pt = cam_idx.long(), pt_idx.long()
    X = points[pt]
    Rc = R[cam]
    Xc = (Rc * X[:, None, :]).sum(-1) + tvecs[cam]
    zc = Xc[:, 2]
    z = torch.clamp(zc, min=Z_MIN)
    dz = torch.where(zc > Z_MIN, 1.0,
                     torch.where(zc == Z_MIN, 0.5, 0.0)).to(zc.dtype)
    scale = torch.exp(dlog_f)
    return dict(cam=cam, pt=pt, X=X, Rc=Rc, z=z, dz=dz, u=Xc[:, 0] / z,
                v=Xc[:, 1] / z, fx=np.float32(intr0[0]) * scale,
                fy=np.float32(intr0[1]) * scale,
                # A[n, k] = dR_c/drvec_k X_p
                A=torch.einsum('nijk,nj->nki', dR[cam], X),
                live=cam > 0)


def _scatter(lin, e0, e1, m, p, refine_focal):
    """J^T e as K9 scatters it (e = w * cot, masked)."""
    gx0 = lin['fx'] * e0 / lin['z']
    gx1 = lin['fy'] * e1 / lin['z']
    gx2 = -(gx0 * lin['u'] + gx1 * lin['v']) * lin['dz']
    gx = torch.stack([gx0, gx1, gx2], dim=-1)  # (N, 3)
    out = torch.zeros(size(m, p), dtype=torch.float32, device=gx.device)
    rv, tv, pv, _ = unflatten(out, m, p)
    live, cam = lin['live'], lin['cam']
    rv.index_add_(0, cam[live], (lin['A'] * gx[:, None, :]).sum(-1)[live])
    tv.index_add_(0, cam[live], gx[live])
    pv.index_add_(0, lin['pt'], (lin['Rc'] * gx[:, :, None]).sum(1))
    if refine_focal:
        out[-1] = (e0 * lin['u'] * lin['fx']
                   + e1 * lin['v'] * lin['fy']).sum()
    return out


class AnalyticProducts(_TorchSolve):
    """K9's analytic arithmetic in torch: the observations' linearisation
    once a step, then per product the forward J v and the scatter J^T e,
    with index_add_ for K9's atomics."""

    def __init__(self, params, const, refine_focal):
        rvecs, tvecs, points, dlog_f = params
        intr0, cam_idx, pt_idx, self.xy, self.sw = const
        self.m, self.p = rvecs.shape[0], points.shape[0]
        self.intr0, self.refine_focal = intr0, refine_focal
        R, dR = rodrigues(rvecs), rodrigues_jacobian(rvecs)
        self.lin = _linearize(R, dR, tvecs, points, dlog_f, intr0, cam_idx,
                              pt_idx)

    def residual_grad(self):
        lin, sw = self.lin, self.sw
        r = torch.stack(
            [(lin['u'] * lin['fx'] + np.float32(self.intr0[2])
              - self.xy[:, 0]) * sw,
             (lin['v'] * lin['fy'] + np.float32(self.intr0[3])
              - self.xy[:, 1]) * sw], dim=-1)
        g = _scatter(lin, sw * r[:, 0], sw * r[:, 1], self.m, self.p,
                     self.refine_focal)
        return r, 0.5 * torch.sum(r * r), g

    def matvec(self, v, lam):
        lin, m, p = self.lin, self.m, self.p
        v = v * gauge_mask(m, p, self.refine_focal, v.device)
        vr, vt, vp, vf = unflatten(v, m, p)
        cam = lin['cam']
        d = (lin['Rc'] * vp[lin['pt']][:, None, :]).sum(-1) \
            + (lin['A'] * vr[cam][:, :, None]).sum(1) + vt[cam]
        j0 = lin['fx'] * (d[:, 0] - lin['u'] * lin['dz'] * d[:, 2]) \
            / lin['z'] + lin['u'] * lin['fx'] * vf
        j1 = lin['fy'] * (d[:, 1] - lin['v'] * lin['dz'] * d[:, 2]) \
            / lin['z'] + lin['v'] * lin['fy'] * vf
        w2 = self.sw * self.sw
        out = _scatter(lin, w2 * j0, w2 * j1, m, p, self.refine_focal)
        return out + np.float32(lam) * v


def residual_grad_analytic(params, const, refine_focal):
    """(r, cost, g) by K9's formulas."""
    return AnalyticProducts(params, const, refine_focal).residual_grad()


def normal_matvec_analytic(params, const, refine_focal, v, lam):
    """(J^T J + lam I) v by K9's formulas."""
    return AnalyticProducts(params, const, refine_focal).matvec(v, lam)


def _vdot_tree(x, y, m, p):
    """jax.scipy's tree vdot: a dot per leaf (rvecs, tvecs, points,
    dlog_f), summed across the leaves in order."""
    cuts = (0, 3 * m, 6 * m, 6 * m + 3 * p, 6 * m + 3 * p + 1)
    total = 0
    for a, b in zip(cuts[:-1], cuts[1:]):
        total = total + torch.dot(x[a:b], y[a:b])
    return total


def cg(matvec, b, m, p, maxiter, tol=CG_TOL, frozen=False):
    """jax.scipy.sparse.linalg.cg's rule on a flat b: x0 = 0, r0 = b -
    A(0), and an iteration while gamma = r^T r > tol^2 b^T b and k <
    maxiter. Returns (x, k), k the iterations run.

    frozen: no host sync an iteration (the card's form). All maxiter
    products are taken; once the stopping test holds, torch.where keeps
    the iterate, so the result equals the loop that stops (then k is a
    device tensor)."""
    dot = lambda x, y: _vdot_tree(x, y, m, p)
    atol2 = torch.square(torch.tensor(tol, dtype=b.dtype,
                                      device=b.device)) * dot(b, b)
    x = torch.zeros_like(b)
    r = b - matvec(x)
    gamma = dot(r, r)
    q = r
    k = torch.zeros((), dtype=torch.int32, device=b.device) if frozen else 0
    for _ in range(maxiter):
        if not frozen and not bool(gamma > atol2):
            break
        Aq = matvec(q)
        alpha = gamma / dot(q, Aq)
        x_ = x + alpha * q
        r_ = r - alpha * Aq
        gamma_ = dot(r_, r_)
        q_ = r_ + (gamma_ / gamma) * q
        if frozen:
            live = gamma > atol2
            x, r = torch.where(live, x_, x), torch.where(live, r_, r)
            q = torch.where(live, q_, q)
            gamma = torch.where(live, gamma_, gamma)
            k = k + live.to(torch.int32)
        else:
            x, r, gamma, q, k = x_, r_, gamma_, q_, k + 1
    return x, k


def _lm_step(params, const, lam, refine_focal, cg_iters, stats=None,
             layout=None):
    """One damped Gauss-Newton step: returns (candidate params, cost).
    stats, a dict, gets the CG iterations run appended under 'cg' (a
    device tensor on the card). layout: see `products`."""
    m, p = params[0].shape[0], params[2].shape[0]
    prod = products(params, const, refine_focal, layout)
    _, cost, g = prod.residual_grad()
    delta, k = prod.cg_solve(-g, lam, cg_iters)
    if stats is not None:
        stats.setdefault('cg', []).append(k)
    delta = _mask_gauge(unflatten(delta, m, p), refine_focal)
    cand = tuple(a + b for a, b in zip(params, delta))
    return cand, cost


def _cost(params, const, _refine_focal):
    r = residual(params, const)
    return 0.5 * torch.sum(r * r)


def _huber_sqrt_weights(params, const_unit, delta):
    """IRLS sqrt-weights: w = min(1, delta / |r|) per observation."""
    r = residual(params, const_unit)
    norm = torch.linalg.norm(r, dim=-1)
    return torch.sqrt(torch.minimum(
        torch.ones_like(norm),
        np.float32(delta) / torch.clamp(norm, min=1e-9)))


def bundle_adjust(rvecs, tvecs, points, intrinsics, cam_idx, pt_idx, xy,
                  max_iters=25, huber_px=4.0, refine_focal=False,
                  cg_iters=50, verbose=False, device=None, stats=None):
    """Levenberg-Marquardt bundle adjustment.

    rvecs/tvecs: (M, 3) world->camera Rodrigues + translation.
    points: (P, 3). intrinsics: (fx, fy, cx, cy) shared pinhole.
    cam_idx/pt_idx: (N,) int observation lists; xy: (N, 2) pixels.
    device: None for the card (raises without one), or 'cpu'. On the card
    the observations are taken in camera order (sorted once), which K9's
    solve needs, and its layout (the cameras' ranges, the point CSR) is
    built once; the result does not depend on the order.
    stats, a dict, gets the LM iterations run ('lm') and each step's CG
    iterations ('cg').

    Returns (rvecs, tvecs, points, (fx, fy, cx, cy), rms_px) as numpy.
    """
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    params = (torch.as_tensor(np.asarray(rvecs), **f32),
              torch.as_tensor(np.asarray(tvecs), **f32),
              torch.as_tensor(np.asarray(points), **f32),
              torch.zeros((), **f32))
    intr0 = tuple(float(v) for v in intrinsics)
    cam_idx = torch.as_tensor(np.asarray(cam_idx), dtype=torch.int32,
                              device=dev)
    pt_idx = torch.as_tensor(np.asarray(pt_idx), dtype=torch.int32,
                             device=dev)
    xy = torch.as_tensor(np.asarray(xy), **f32)
    layout = None
    if dev.type == 'cuda':
        order = torch.argsort(cam_idx, stable=True)
        cam_idx, pt_idx, xy = cam_idx[order], pt_idx[order], xy[order]
        layout = ba_cuda.Layout(cam_idx, pt_idx, params[0].shape[0],
                                params[2].shape[0])
    ones = torch.ones(xy.shape[0], **f32)

    lam = 1e-2
    it = -1
    for it in range(max_iters):
        sqrt_w = _huber_sqrt_weights(params,
                                     (intr0, cam_idx, pt_idx, xy, ones),
                                     huber_px)
        const = (intr0, cam_idx, pt_idx, xy, sqrt_w)
        cand, cost = _lm_step(params, const, lam, refine_focal, cg_iters,
                              stats, layout)
        new_cost = _cost(cand, const, refine_focal)
        if bool(new_cost < cost):
            params, lam = cand, max(lam * 0.3, 1e-7)
        else:
            lam = min(lam * 10.0, 1e5)
        if verbose:
            print(f'BA iter {it}: cost {float(cost):.1f} -> '
                  f'{float(new_cost):.1f} lam {lam:.1e}')
        if lam >= 1e5:
            break
    if stats is not None:
        stats['lm'] = it + 1

    rvecs, tvecs, points, dlog_f = params
    f_scale = float(torch.exp(dlog_f))
    intr = (intr0[0] * f_scale, intr0[1] * f_scale, intr0[2], intr0[3])
    r = residual(params, (intr0, cam_idx, pt_idx, xy, ones))
    rms = float(torch.sqrt(torch.mean(torch.sum(r * r, dim=-1))))
    return (rvecs.cpu().numpy(), tvecs.cpu().numpy(),
            points.cpu().numpy(), intr, rms)
