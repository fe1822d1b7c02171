"""Rotation parametrisation shared by pose refinement and registration.

Counterpart of autolabel_tpu/mapping/ba.py's `rodrigues`; the bundle
adjustment around it is not ported.
"""
import torch


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
