"""Bundle adjustment's Levenberg-Marquardt products and its CG solve:
csrc/ba_normal.cu (K9).

Counterpart of what XLA compiles for autolabel_tpu/mapping/ba.py
`_lm_step` (:80-99): r and the gradient J^T r (a vjp of `_residual`), the
damped normal product (J^T J + lam I) v that every conjugate-gradient
iteration takes (a jvp, then the vjp), all under `_mask_gauge`, and the
whole jax.scipy.sparse.linalg.cg solve (:94-95) in one cooperative launch.

The parameters travel as one flat fp32 vector: the M Rodrigues vectors,
the M translations, the P points and the log focal scale, L = 6 M + 3 P +
1 values. The caller (mapping/ba.py) computes the cameras' R and
dR/drvec once an LM step and passes them in; this module checks its
inputs and launches K9's three entries. The solve needs the observations
in camera order and a `Layout` (the cameras' ranges and the point CSR),
built once a bundle adjustment. On anything but CUDA tensors it raises;
where the card refuses the solve's cooperative launch, it raises too.
"""
import ctypes
import functools

import numpy as np
import torch

from autolabel_tpu_torch.ops import _kernels

NAMES = ('ba_residual_grad', 'ba_normal_matvec', 'ba_cg_solve')
_SOURCE = 'ba_normal.cu'
THREADS = 256  # observations a block (BA_THREADS in the kernel)
SOLVE_THREADS = 512  # the solve's block (SOLVE_THREADS in the kernel)


def _check(name, t, dtype, shape, device):
    if t.device != device or t.device.type != 'cuda':
        raise ValueError(f'K9: inputs must be on one CUDA device ({name} is '
                         f'on {t.device})')
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f'K9: {name} must be {dtype} of shape '
                         f'{tuple(shape)}, got {t.dtype} {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'K9: {name} must be contiguous')


@functools.cache
def _launchers():
    """K9's three C entries and the solve's grid query, their signatures
    set once, when they load."""
    lib = _kernels.library(_SOURCE)
    ptr, f32, i32 = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    grad = lib.ba_residual_grad
    grad.argtypes = ([ptr] * 5 + [f32] * 4 + [ptr] * 4
                     + [ctypes.c_longlong] + [i32] * 4 + [ptr] * 4)
    grad.restype = i32
    matvec = lib.ba_normal_matvec
    matvec.argtypes = ([ptr] * 5 + [f32] * 4 + [ptr] * 3
                       + [ctypes.c_longlong] + [i32] * 3
                       + [ptr, f32, ptr, ptr, ptr])
    matvec.restype = i32
    solve = lib.ba_cg_solve
    solve.argtypes = ([ptr] * 5 + [f32] * 4 + [ptr] * 3
                      + [ctypes.c_longlong] + [i32] * 3 + [ptr] * 4
                      + [f32, f32] + [i32] * 2 + [ptr] * 4)
    solve.restype = i32
    lib.ba_cg_grid.argtypes = [ctypes.POINTER(i32)]
    lib.ba_cg_grid.restype = i32
    return grad, matvec, solve, lib.ba_cg_grid


@functools.cache
def solve_grid(device_index):
    """The blocks of the solve that the card holds resident at once (its
    cooperative grid); raises where the card has no cooperative launch."""
    grid = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        status = _launchers()[3](ctypes.byref(grid))
    _kernels.check(status, f'K9 {NAMES[2]} (cooperative grid)')
    return grid.value


class Layout:
    """What the solve reads besides the products' inputs, built once a
    bundle adjustment from the camera-sorted observations: cam_start (M +
    1), each camera's first observation; pt_start (P + 1) and pt_obs (N),
    each point's observations in ascending order (the point CSR). int32,
    on the observations' device."""

    def __init__(self, cam_idx, pt_idx, m, p):
        if cam_idx.numel() > 1 and not bool(
                (cam_idx[1:] >= cam_idx[:-1]).all()):
            raise ValueError('K9: the solve needs the observations in '
                             'camera order')
        self.cam_start = _offsets(cam_idx, m)
        self.pt_start = _offsets(pt_idx, p)
        self.pt_obs = torch.argsort(pt_idx, stable=True).to(torch.int32)


def _offsets(idx, size):
    counts = torch.bincount(idx.long(), minlength=size)
    out = torch.zeros(size + 1, dtype=torch.int32, device=idx.device)
    out[1:] = torch.cumsum(counts, 0)
    return out


class KernelProducts:
    """K9 at one LM step's linearisation point: the cameras' rotations R
    (M, 3, 3) and their Jacobians dR (M, 3, 3, 3), [c, i, j, k] = dR_ij /
    drvec_k (None: the residual alone), the other parameters and the
    observations. The indices must be int32 (JAX's dtype), every tensor
    fp32 and contiguous on one CUDA device. layout: the solve's `Layout`
    (None: built at the first solve)."""

    def __init__(self, R, dR, tvecs, points, dlog_f, const, refine_focal,
                 layout=None):
        intr0, cam_idx, pt_idx, xy, sqrt_w = const
        self.m, self.p, self.n = R.shape[0], points.shape[0], \
            cam_idx.shape[0]
        self.L = 6 * self.m + 3 * self.p + 1
        dev = R.device
        m, p, n = self.m, self.p, self.n
        checks = (() if dR is None
                  else (('dR', dR, torch.float32, (m, 3, 3, 3)),))
        for name, t, dtype, shape in (
                ('R', R, torch.float32, (m, 3, 3)), *checks,
                ('tvecs', tvecs, torch.float32, (m, 3)),
                ('points', points, torch.float32, (p, 3)),
                ('dlog_f', dlog_f, torch.float32, ()),
                ('cam_idx', cam_idx, torch.int32, (n,)),
                ('pt_idx', pt_idx, torch.int32, (n,)),
                ('xy', xy, torch.float32, (n, 2)),
                ('sqrt_w', sqrt_w, torch.float32, (n,))):
            _check(name, t, dtype, shape, dev)
        self.R, self.dR = R, dR
        self.tvecs, self.points, self.dlog_f = tvecs, points, dlog_f
        self.intr0 = [float(np.float32(v)) for v in intr0]
        self.cam, self.pt, self.xy, self.sw = cam_idx, pt_idx, xy, sqrt_w
        self.refine_focal = refine_focal
        self.layout = layout
        self.stream = torch.cuda.current_stream(dev).cuda_stream

    def _head(self):
        return (self.R.data_ptr(),
                None if self.dR is None else self.dR.data_ptr(),
                self.tvecs.data_ptr(), self.points.data_ptr(),
                self.dlog_f.data_ptr(), *self.intr0, self.cam.data_ptr(),
                self.pt.data_ptr())

    def residual_grad(self, want_grad=True):
        """(r (N, 2), cost, the masked gradient (flat) or None)."""
        if want_grad and self.dR is None:
            raise ValueError('K9: the gradient needs dR/drvec')
        dev = self.R.device
        r = torch.empty((self.n, 2), dtype=torch.float32, device=dev)
        blocks = -(-self.n // THREADS)
        # the cost's partials, then the focal's
        partials = torch.empty(2 * blocks, dtype=torch.float32, device=dev)
        g = torch.empty(self.L if want_grad else 1,
                        dtype=torch.float32, device=dev)
        status = _launchers()[0](
            *self._head(), self.xy.data_ptr(), self.sw.data_ptr(), self.n,
            self.m, self.p, int(self.refine_focal), int(want_grad),
            r.data_ptr(), partials.data_ptr(), g.data_ptr(), self.stream)
        _kernels.check(status, NAMES[0])
        _kernels.launches[NAMES[0]] += 1
        return r, 0.5 * partials[:blocks].sum(), g if want_grad else None

    def matvec(self, v, lam):
        """(J^T J + lam I) v on the masked parameters, v flat."""
        if self.dR is None:
            raise ValueError('K9: the product needs dR/drvec')
        _check('v', v, torch.float32, (self.L,), self.R.device)
        out = torch.empty_like(v)
        work = torch.empty(-(-self.n // THREADS) if self.refine_focal else 1,
                           dtype=torch.float32, device=v.device)
        status = _launchers()[1](
            *self._head(), self.sw.data_ptr(), self.n, self.m, self.p,
            int(self.refine_focal), v.data_ptr(), float(np.float32(lam)),
            work.data_ptr(), out.data_ptr(), self.stream)
        _kernels.check(status, NAMES[1])
        _kernels.launches[NAMES[1]] += 1
        return out

    def cg_solve(self, b, lam, maxiter, tol=1e-5, grid=None):
        """(x, k): x solving (J^T J + lam I) x = b on the masked
        parameters by jax.scipy.sparse.linalg.cg's rule, k (an int32
        device tensor) the iterations run; one cooperative launch, no host
        sync. grid: the blocks to launch (default: all the card holds
        resident; more are refused)."""
        x, k, _ = self._solve(b, lam, maxiter, tol, grid)
        return x, k

    def solve_product(self, v, lam):
        """(J^T J + lam I) v on the masked parameters as the solve takes
        it: its first iteration's product, read from its workspace."""
        _, _, work = self._solve(v, lam, 1, 0.0, None)
        start = work.numel() - 9 * self.n - self.L  # Aq, before obs_pt
        return work[start:start + self.L]

    def _solve(self, b, lam, maxiter, tol, grid):
        if self.dR is None:
            raise ValueError('K9: the solve needs dR/drvec')
        dev = self.R.device
        _check('b', b, torch.float32, (self.L,), dev)
        if self.layout is None:
            self.layout = Layout(self.cam, self.pt, self.m, self.p)
        lay = self.layout
        for name, t, shape in (('cam_start', lay.cam_start, (self.m + 1,)),
                               ('pt_start', lay.pt_start, (self.p + 1,)),
                               ('pt_obs', lay.pt_obs, (self.n,))):
            _check(name, t, torch.int32, shape, dev)
        grid = solve_grid(dev.index) if grid is None else grid
        x = torch.empty_like(b)
        k = torch.empty((), dtype=torch.int32, device=dev)
        work = torch.empty(9 * grid + 4 * self.L + 9 * self.n,
                           dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            status = _launchers()[2](
                *self._head(), self.sw.data_ptr(), self.n, self.m, self.p,
                int(self.refine_focal), lay.cam_start.data_ptr(),
                lay.pt_start.data_ptr(), lay.pt_obs.data_ptr(), b.data_ptr(),
                float(np.float32(lam)), float(np.float32(tol)), int(maxiter),
                int(grid), work.data_ptr(), x.data_ptr(), k.data_ptr(),
                self.stream)
        _kernels.check(status, f'K9 {NAMES[2]}')
        _kernels.launches[NAMES[2]] += 1
        return x, k, work
