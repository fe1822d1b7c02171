"""Camera-pose optimisation through the volumetric renderer.

Counterpart of autolabel_tpu/train/pose_refine.py. Two modes:

1. `register_camera`: optimise ONE camera's SE(3) delta against a trained,
   frozen field (photometric loss, plus an optional depth term), to
   localise a new frame against a trained scene or re-align a pose.
2. Joint refinement during training (SimpleTrainer(pose_refine=...)):
   per-frame deltas train beside the field's parameters, the batch
   carries camera-frame ray directions and frame indices, and the step
   rebuilds the world rays from pose_init o exp(delta) (`refined_rays`).
   Experimental, as in the JAX package: on few-frame captures the hash
   grid co-adapts to the wrong poses.

Frame 0 is the gauge anchor: its delta is masked, pinning the refined
world to the initial one. The gradient reaches the poses through the
encode's point gradient (ops/hashgrid_cuda.point_grad, K2x on the card)
and the heads' input gradients.
"""
import contextlib
import math

import numpy as np
import torch

from autolabel_tpu_torch.mapping.ba import rodrigues
from autolabel_tpu_torch.render.renderer import RenderOptions, render_rays
from autolabel_tpu_torch.train.optim import adam_update


def init_pose_params(n_frames, device=None):
    """Zero SE(3) deltas: {'rot': (N, 3) so(3), 't': (N, 3)}."""
    return {'rot': torch.zeros((n_frames, 3), device=device),
            't': torch.zeros((n_frames, 3), device=device)}


def _anchor_mask(n_frames, device):
    mask = torch.ones((n_frames, 1), device=device)
    mask[0] = 0.0
    return mask


def refined_rays(pose_params, pose_init, frame_idx, rays_d_cam):
    """World rays under the refined poses.

    pose_init: (R0 (N, 3, 3) cam->world, t0 (N, 3) camera centres) as
    tensors; frame_idx: (B,) integer; rays_d_cam: (B, 3) camera-frame
    directions. Returns (rays_o (B, 3), rays_d (B, 3))."""
    R0, t0 = pose_init
    mask = _anchor_mask(R0.shape[0], R0.device)
    R = R0 @ rodrigues(pose_params['rot'] * mask)  # (N, 3, 3) refined
    frame_idx = frame_idx.long()
    rays_d = torch.einsum('bij,bj->bi', R[frame_idx], rays_d_cam)
    rays_o = (t0 + pose_params['t'] * mask)[frame_idx]
    return rays_o, rays_d


def refined_poses(pose_params, pose_init):
    """The refined (R (N, 3, 3) cam->world, centres (N, 3)) as numpy, for
    tests and for writing the poses out after training."""
    R0, t0 = pose_init
    mask = np.ones((len(t0), 1), np.float32)
    mask[0] = 0.0
    rot = torch.as_tensor(np.asarray(pose_params['rot'], np.float32) * mask)
    R = np.asarray(R0) @ rodrigues(rot).numpy()
    t = np.asarray(t0) + np.asarray(pose_params['t']) * mask
    return R, t


def cosine_decay(lr, decay_steps, count, alpha=0.01):
    """optax.cosine_decay_schedule(lr, decay_steps, alpha) at `count`."""
    count = min(count, decay_steps)
    cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
    return lr * ((1.0 - alpha) * cosine + alpha)


@contextlib.contextmanager
def frozen(field):
    """The field's parameters without gradients (the serving form), so a
    render's backward reaches only its inputs: no table scatter."""
    params = list(field.parameters())
    saved = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, r in zip(params, saved):
            p.requires_grad_(r)


def registration_loss(field, delta, pixels, dirs_cam, norms, R0, t0,
                      options, depth=None, depth_weight=0.1):
    """register_camera's objective at `delta` ({'rot': (3,), 't': (3,)}):
    the mean squared rgb error of the render from R0 exp(rot), t0 + t,
    plus depth_weight times the mean |depth error| over pixels with depth
    (> 0)."""
    R = R0 @ rodrigues(delta['rot'])
    rays_d = dirs_cam @ R.T
    rays_o = (t0 + delta['t']).expand(rays_d.shape)
    out = render_rays(field, rays_o, rays_d, norms, options=options)
    loss = torch.mean((out['image'] - pixels) ** 2)
    if depth is not None:
        valid = (depth > 0).float()
        loss = loss + depth_weight * torch.sum(
            valid * torch.abs(out['depth'] - depth)) \
            / torch.clamp(valid.sum(), min=1.0)
    return loss


def register_camera(field, pixels, dirs_cam, norms, R0, t0, options=None,
                    iters=200, lr=3e-3, depth=None, depth_weight=0.1,
                    callback=None):
    """Register ONE camera against the trained field, its parameters
    frozen: Adam on one SE(3) delta through the volumetric renderer, as
    the JAX package's register_camera (optax.adam over
    cosine_decay_schedule(lr, iters, alpha=0.01), its count from 0 at the
    first update).

    pixels: (B, 3) observed rgb; dirs_cam: (B, 3) camera-frame ray
    directions; norms: (B, 1); R0 (3, 3) cam->world, t0 (3,) the initial
    pose; depth: optional (B,) metric z-depth (0 = invalid); arrays or
    tensors, moved to the field's device. options default to 64 main and
    32 proposal steps, unperturbed. callback(i, loss), if given, is called
    after each iteration with its loss (a 0-dim tensor on the device).
    Returns (R (3, 3), t (3,), final_loss): numpy, and the loss of the
    last iteration (before its update) as a float."""
    if options is None:
        options = RenderOptions(num_steps=64, proposal_steps=32,
                                perturb=False)
    dev = field.device

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    pixels, dirs_cam = tensor(pixels), tensor(dirs_cam)
    norms = tensor(norms).reshape(-1, 1)
    R0, t0 = tensor(R0), tensor(t0)
    depth = None if depth is None else tensor(depth)
    delta = {'rot': torch.zeros(3, device=dev, requires_grad=True),
             't': torch.zeros(3, device=dev, requires_grad=True)}
    moments = {k: (torch.zeros(3, device=dev), torch.zeros(3, device=dev))
               for k in delta}
    loss = None
    with frozen(field):
        for i in range(iters):
            loss = registration_loss(field, delta, pixels, dirs_cam, norms,
                                     R0, t0, options, depth, depth_weight)
            grads = torch.autograd.grad(loss, [delta['rot'], delta['t']])
            step_lr = cosine_decay(lr, iters, i)
            with torch.no_grad():
                for (k, p), g in zip(delta.items(), grads):
                    adam_update(p, g, *moments[k], i, step_lr)
            if callback is not None:
                callback(i, loss.detach())
    with torch.no_grad():
        R = (R0 @ rodrigues(delta['rot'])).cpu().numpy()
        t = (t0 + delta['t']).cpu().numpy()
    return R, t, float('inf') if loss is None else float(loss.detach())
