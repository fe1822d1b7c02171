"""The offline trainer (SimpleTrainer).

Counterpart of autolabel_tpu/train/trainer.py's SimpleTrainer: a step is
render_rays (training form) -> compute_losses -> backward -> the
optimizer (train/optim.py), with an EMA copy of the params taken once per
train_iterations call, checkpoints through the shared pickled-numpy
payload (so either package resumes or serves the other's), and staged
eval renders. The field holds the live parameters; the trainer holds the
EMA copy and the optimizer state.

The estimator phase schedule is the JAX trainer's: with
sampled_warmup_fraction (and sampled_backward == 2) the first steps
scatter one row a level, with exact_final_fraction the last steps use
exact gathers; one set of render options per phase, chosen on the host by
global_step. Not ported, and refused rather than ignored: the device mesh,
pose refinement, occupancy grids, TensorBoard events and the
stochastic-corner estimator (stochastic_corners without the sampled
backward).
"""
import contextlib
import dataclasses
import os

import numpy as np
import torch

from autolabel_tpu_torch import bridge
from autolabel_tpu_torch.render.renderer import (RenderOptions, StagedRenderer,
                                                 render_rays)
from autolabel_tpu_torch.train import checkpoints
from autolabel_tpu_torch.train.losses import LossOptions, compute_losses
from autolabel_tpu_torch.train.metrics import MetricsLogger
from autolabel_tpu_torch.train.optim import Optimizer

_BATCH_KEYS = ('rays_o', 'rays_d', 'direction_norms', 'pixels', 'depth',
               'semantic')


def _refuse_unported(mesh, occupancy, tensorboard, pose_refine, options):
    unported = {
        'a device mesh (data parallelism)': mesh is not None,
        'occupancy grids': occupancy is not None,
        'TensorBoard events': tensorboard,
        'pose refinement': pose_refine is not None,
        'the stochastic-corner estimator': (
            options.perturb and bool(options.stochastic_corners)
            and not options.sampled_backward),
    }
    for what, asked in unported.items():
        if asked:
            raise NotImplementedError(f'SimpleTrainer: {what} is not ported '
                                      'yet')


def phase_schedule(options, iters, exact_final_fraction=0.0,
                   sampled_warmup_fraction=0.0):
    """The JAX trainer's gather-annealing phases, [(first_step, render
    options)] ascending: [0, warmup) scatters one sampled row a level
    (only with sampled_warmup_fraction and sampled_backward == 2), then
    the given options, then from (1 - exact_final_fraction) * iters exact
    gathers (only when an estimator is on)."""
    phases = [(0, options)]
    if (iters is not None and sampled_warmup_fraction > 0
            and options.sampled_backward == 2):
        phases = [(0, dataclasses.replace(options, sampled_backward=1)),
                  (int(iters * sampled_warmup_fraction), options)]
    if (iters is not None and exact_final_fraction > 0
            and (options.stochastic_corners or options.sampled_backward)):
        phases.append((int(iters * (1 - exact_final_fraction)),
                       dataclasses.replace(options, stochastic_corners=0,
                                           sampled_backward=0,
                                           backward_points=1.0)))
    return phases


class SimpleTrainer:
    """Offline trainer: epochs of iterations, per-epoch EMA and metrics,
    checkpoints, staged eval renders. `field` is a Field on its device;
    `seed` seeds the generator of the render's perturbations (the JAX
    trainer's PRNG key)."""

    def __init__(self,
                 name,
                 field,
                 lr=5e-3,
                 iters=10000,
                 loss_options=None,
                 render_options=None,
                 workspace=None,
                 ema_decay=0.95,
                 use_checkpoint='latest',
                 mesh=None,
                 max_ray_batch=4096,
                 occupancy=None,
                 occupancy_update_every=100,
                 exact_final_fraction=0.0,
                 sampled_warmup_fraction=0.0,
                 metrics=True,
                 tensorboard=False,
                 pose_refine=None,
                 seed=0):
        del occupancy_update_every  # occupancy grids are refused below
        self.render_options = render_options or RenderOptions(perturb=True)
        _refuse_unported(mesh, occupancy, tensorboard, pose_refine,
                         self.render_options)
        self.phases = phase_schedule(self.render_options, iters,
                                     exact_final_fraction,
                                     sampled_warmup_fraction)
        self.name = name
        self.field = field
        self.workspace = workspace
        self.ema_decay = ema_decay
        self.loss_options = loss_options or LossOptions()
        self.epoch = 0
        self.global_step = 0
        self.metrics_logger = (MetricsLogger(workspace)
                               if metrics and workspace is not None else None)
        self.optimizer = Optimizer(field.named_parameters(),
                                   field.param_labels(), lr=lr, iters=iters)
        self.ema = {k: v.detach().clone()
                    for k, v in field.state_dict().items()}
        self.generator = torch.Generator(device=field.device).manual_seed(
            seed + 1)
        self._staged = StagedRenderer(
            field,
            RenderOptions(num_steps=self.render_options.num_steps,
                          upsample_steps=self.render_options.upsample_steps,
                          proposal_steps=self.render_options.proposal_steps,
                          perturb=False),
            max_ray_batch=max_ray_batch)
        if workspace is not None and use_checkpoint == 'latest':
            self._try_resume()

    # -- checkpointing -----------------------------------------------------

    @property
    def checkpoint_dir(self):
        return os.path.join(self.workspace, 'checkpoints')

    def _try_resume(self):
        payload = checkpoints.load_checkpoint(self.checkpoint_dir)
        if payload is None:
            return
        model = payload['model']
        ema = payload.get('ema', model)
        opt_state = payload.get('optimizer')
        if 'pose' in model:
            # Camera-refinement deltas: not field state; the saved moments
            # cover a different param set, so they restart.
            opt_state = None
        bridge.load_params(self.field, model)
        self.ema = bridge.params_from_numpy(ema, self.field.device)
        # A checkpoint of another optimizer (the JAX package's optax state,
        # or none) restarts the moments.
        if opt_state is None or not self.optimizer.load_state_dict(opt_state):
            self.optimizer.state = self.optimizer.init()
        self.global_step = int(payload['global_step'])
        self.epoch = int(payload.get('epoch', self.global_step // 1000))

    def save_checkpoint(self, name=None, include_optimizer=True):
        if self.workspace is None:
            return
        if name is None:
            name = f'{self.name}_ep{self.epoch:04d}'
        path = os.path.join(self.checkpoint_dir, f'{name}.pth')
        state = {'params': bridge.params_to_numpy(self.field),
                 'ema': bridge.state_to_numpy(self.ema),
                 'step': self.global_step,
                 'opt_state': self.optimizer.state_dict()}
        checkpoints.save_checkpoint(path, state, extra={'epoch': self.epoch},
                                    include_optimizer=include_optimizer)

    # -- training ----------------------------------------------------------

    def _device_batch(self, data):
        dev = self.field.device
        keys = _BATCH_KEYS + (('features',) if self.loss_options.feature_loss
                              else ())
        batch = {k: torch.as_tensor(data[k], device=dev) for k in keys}
        batch['direction_norms'] = batch['direction_norms'].reshape(-1)[:,
                                                                        None]
        return batch

    def step_options(self, step=None):
        """The render options of the phase that `step` (global_step by
        default) falls in."""
        step = self.global_step if step is None else step
        return [o for first, o in self.phases if step >= first][-1]

    def loss_and_grads(self, data, draws=None):
        """One step's loss parts (0-dim tensors, 'total' included) and the
        gradient of every parameter (name -> tensor or None), without an
        update, with the render options of the current phase. draws: the
        render's uniforms (renderer.draw_perturbations), drawn from the
        trainer's generator when None."""
        batch = self._device_batch(data)
        outputs = render_rays(self.field, batch['rays_o'], batch['rays_d'],
                              batch['direction_norms'], key=self.generator,
                              options=self.step_options(), draws=draws)
        loss, parts = compute_losses(outputs, batch, self.loss_options)
        params = self.optimizer.params
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        parts = {k: v.detach() for k, v in parts.items()}
        parts['total'] = loss.detach()
        return parts, dict(zip(params, grads))

    def train_step(self, data, draws=None):
        """One optimization step; returns its loss parts."""
        parts, grads = self.loss_and_grads(data, draws)
        self.optimizer.step(grads)
        self.global_step += 1
        return parts

    @torch.no_grad()
    def _ema_step(self):
        for name, p in self.field.state_dict().items():
            e = self.ema[name]
            e.copy_(self.ema_decay * e + (1.0 - self.ema_decay) * p)

    def train(self, dataloader, epochs, iters_per_epoch=1000,
              checkpoint_interval=None):
        """checkpoint_interval: save a params+ema snapshot every N epochs
        (default None: the caller saves at the end)."""
        for epoch in range(epochs):
            losses = self.train_iterations(dataloader, iters_per_epoch)
            self.epoch += 1
            if losses is not None and self.metrics_logger is not None:
                self.metrics_logger.log(
                    self.epoch, self.global_step,
                    {k: float(v) for k, v in losses.items()})
            if (checkpoint_interval is not None
                    and (epoch + 1) % checkpoint_interval == 0
                    and epoch + 1 < epochs):
                self.save_checkpoint(include_optimizer=False)

    def train_iterations(self, dataloader, iterations, progress=True):
        """Run `iterations` optimization steps, then one EMA tick. Returns
        the last step's loss parts as 0-dim tensors on the device."""
        del progress
        iterator = iter(dataloader)
        losses = None
        for _ in range(iterations):
            losses = self.train_step(next(iterator))
        self._ema_step()
        return losses

    # -- inference ---------------------------------------------------------

    @contextlib.contextmanager
    def _rendering_with(self, state):
        """The field's params temporarily replaced by `state` (the EMA)."""
        saved = {k: v.detach().clone()
                 for k, v in self.field.state_dict().items()}
        with torch.no_grad():
            self.field.load_state_dict(state)
        try:
            yield
        finally:
            with torch.no_grad():
                self.field.load_state_dict(saved)

    def _render(self, data):
        return self._staged.render(
            data['rays_o'], data['rays_d'],
            np.asarray(data['direction_norms']).reshape(
                *np.shape(data['rays_o'])[:-1]))

    def test_step(self, data, use_ema=False):
        """Full-frame staged render -> (rgb, depth, semantic logits,
        features), shapes (H, W, ...), tensors on the field's device."""
        context = (self._rendering_with(self.ema) if use_ema
                   else contextlib.nullcontext())
        with context:
            out = self._render(data)
        return out['image'], out['depth'], out['semantic'], out[
            'semantic_features']

    def eval_step(self, data):
        """Render one eval frame and compute the validation rgb loss."""
        out = self._render(data)
        gt_rgb = torch.as_tensor(np.asarray(data['pixels']),
                                 device=out['image'].device)
        return out, float(torch.mean((out['image'] - gt_rgb) ** 2))
