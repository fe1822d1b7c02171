"""Bundle adjustment's Levenberg-Marquardt products: csrc/ba_normal.cu (K9).

Counterpart of what XLA compiles for autolabel_tpu/mapping/ba.py
`_lm_step` (:80-99): r and the gradient J^T r (a vjp of `_residual`), and
the damped normal product (J^T J + lam I) v that every conjugate-gradient
iteration takes (a jvp, then the vjp), all under `_mask_gauge`.

The parameters travel as one flat fp32 vector: the M Rodrigues vectors,
the M translations, the P points and the log focal scale, L = 6 M + 3 P +
1 values. The caller (mapping/ba.py) computes the cameras' R and
dR/drvec once an LM step and passes them in; this module checks its
inputs and launches K9's two entries. On anything but CUDA tensors it
raises.
"""
import ctypes
import functools

import numpy as np
import torch

from autolabel_tpu_torch.ops import _kernels

NAMES = ('ba_residual_grad', 'ba_normal_matvec')
_SOURCE = 'ba_normal.cu'
THREADS = 256  # observations a block (BA_THREADS in the kernel)


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
    """K9's two C entries, their signatures set once, when they load."""
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
    return grad, matvec


class KernelProducts:
    """K9 at one LM step's linearisation point: the cameras' rotations R
    (M, 3, 3) and their Jacobians dR (M, 3, 3, 3), [c, i, j, k] = dR_ij /
    drvec_k (None: the residual alone), the other parameters and the
    observations. The indices must be int32 (JAX's dtype), every tensor
    fp32 and contiguous on one CUDA device."""

    def __init__(self, R, dR, tvecs, points, dlog_f, const, refine_focal):
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
