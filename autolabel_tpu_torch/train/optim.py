"""Optimizer and learning-rate schedule.

Counterpart of autolabel_tpu/train/optim.py (optax): Adam(betas=(0.9,
0.99), eps=1e-15), weight decay 1e-6 added to the gradients of the 'net'
parameters only (not the hash table), the StepLR staircase (gamma 0.5
every 1000-iteration epochs sized so the lr lands at 1e-4 by the end of
training), all under the semantics of
optax.apply_if_finite(max_consecutive_errors=100): a step whose gradients
hold a non-finite value leaves the parameters, both moments, the Adam
count and the schedule's count unchanged, until more than 100 such steps
come in a row, when the update is applied anyway. So the schedule counts
applied updates, not steps.

Camera refinement's 'pose' group (the per-frame pose deltas of
train/pose_refine.py) takes no weight decay, and its updates are scaled by
0 for the first max((iters or 10000) // 10, 1) applied updates, then by
0.1 (the JAX package's optax.masked(scale_by_schedule) after the lr): the
poses stay frozen while the field forms, then step at a tenth of its lr.
Its schedule counts applied updates too.

The whole update stays on the device (the skip is a select, not a host
branch), so a training loop never waits for the card here.
"""
import math

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.99, 1e-15


def lr_schedule(lr, iters=None):
    """The staircase keyed on the count of applied updates: a float for
    interactive training (iters None, constant lr), else a function of
    the count (an int or an integer tensor)."""
    if iters is None:
        return lr
    gamma = 0.5
    steps = math.log(1e-4 / lr, gamma)
    transition = int(max(iters // steps // 1000, 1)) * 1000

    def schedule(count):
        if isinstance(count, torch.Tensor):
            return lr * torch.pow(torch.tensor(gamma, device=count.device),
                                  torch.div(count, transition,
                                            rounding_mode='floor').float())
        return lr * gamma ** (count // transition)

    return schedule


class Optimizer:
    """Adam with the JAX package's groups and non-finite skip, over a
    field's named parameters (`Field.named_parameters()`), labelled by
    `Field.param_labels()`."""

    def __init__(self, params, labels, lr=5e-3, iters=None,
                 weight_decay=1e-6, max_consecutive_errors=100):
        self.params = dict(params)
        self.decay = {name: labels[name] == 'net' for name in self.params}
        self.pose = {name: labels[name] == 'pose' for name in self.params}
        self.pose_warmup = max((iters or 10000) // 10, 1)
        self.schedule = lr_schedule(lr, iters)
        self.weight_decay = weight_decay
        self.max_consecutive_errors = max_consecutive_errors
        self.state = self.init()

    def init(self):
        """Fresh state: zero moments and counts."""
        dev = next(iter(self.params.values())).device

        def scalar(v, dtype=torch.int32):
            return torch.tensor(v, dtype=dtype, device=dev)

        return {
            'count': scalar(0),
            'notfinite_count': scalar(0),
            'last_finite': scalar(True, torch.bool),
            'total_notfinite': scalar(0),
            'mu': {k: torch.zeros_like(p) for k, p in self.params.items()},
            'nu': {k: torch.zeros_like(p) for k, p in self.params.items()},
        }

    def lr(self, count=None):
        """The learning rate of the next applied update (a tensor)."""
        count = self.state['count'] if count is None else count
        if callable(self.schedule):
            return self.schedule(count)
        return torch.tensor(self.schedule, device=count.device)

    @torch.no_grad()
    def step(self, grads):
        """Apply one update from grads (name -> tensor, or None for a
        parameter the loss does not reach). Returns a 0-dim bool tensor on
        the device: whether the update was applied."""
        st = self.state
        grads = {k: torch.zeros_like(p) if grads.get(k) is None else grads[k]
                 for k, p in self.params.items()}
        finite = torch.stack([torch.isfinite(g).all()
                              for g in grads.values()]).all()
        notfinite = torch.where(finite, torch.zeros_like(
            st['notfinite_count']), st['notfinite_count'] + 1)
        ok = finite | (notfinite > self.max_consecutive_errors)
        count = st['count'] + 1
        b1 = torch.tensor(B1, device=count.device)
        b2 = torch.tensor(B2, device=count.device)
        bc1 = 1.0 - torch.pow(b1, count.float())
        bc2 = 1.0 - torch.pow(b2, count.float())
        step_size = -self.lr(st['count']).float()
        if any(self.pose.values()):
            pose_scale = torch.where(st['count'] < self.pose_warmup,
                                     torch.zeros_like(step_size),
                                     torch.full_like(step_size, 0.1))
        for name, p in self.params.items():
            g = grads[name]
            if self.decay[name]:
                g = g + self.weight_decay * p
            mu = (1.0 - B1) * g + B1 * st['mu'][name]
            nu = (1.0 - B2) * g ** 2 + B2 * st['nu'][name]
            update = step_size * ((mu / bc1) / (torch.sqrt(nu / bc2) + EPS))
            if self.pose[name]:
                update = update * pose_scale
            p.copy_(torch.where(ok, p + update, p))
            st['mu'][name].copy_(torch.where(ok, mu, st['mu'][name]))
            st['nu'][name].copy_(torch.where(ok, nu, st['nu'][name]))
        st['count'] = torch.where(ok, count, st['count'])
        st['notfinite_count'] = notfinite
        st['last_finite'] = finite
        st['total_notfinite'] = st['total_notfinite'] + (~finite).int()
        return ok

    def state_dict(self):
        """The state as numpy arrays (the checkpoint's 'optimizer')."""
        st = self.state
        out = {k: st[k].cpu().numpy() for k in
               ('count', 'notfinite_count', 'last_finite', 'total_notfinite')}
        for key in ('mu', 'nu'):
            out[key] = {k: v.detach().cpu().numpy() for k, v in st[key].items()}
        return out

    def load_state_dict(self, saved):
        """Load a state written by state_dict. Returns False, and keeps a
        fresh state, when `saved` has another structure (a checkpoint of
        another optimizer or package): the moments then restart."""
        fresh = self.init()
        try:
            same = (set(saved) == set(fresh) and all(
                set(saved[k]) == set(fresh[k]) and all(
                    np.shape(saved[k][n]) == tuple(fresh[k][n].shape)
                    for n in fresh[k]) for k in ('mu', 'nu')))
        except TypeError:
            same = False
        if not same:
            self.state = fresh
            return False
        for key, value in fresh.items():
            if isinstance(value, dict):
                for n, t in value.items():
                    t.copy_(torch.as_tensor(np.asarray(saved[key][n])))
            else:
                value.copy_(torch.as_tensor(np.asarray(saved[key])))
        self.state = fresh
        return True
