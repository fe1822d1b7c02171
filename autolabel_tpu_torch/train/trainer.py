"""The offline trainer (SimpleTrainer) and the interactive one
(InteractiveTrainer).

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
global_step. With an occupancy grid the grid is updated from the field
every occupancy_update_every steps (before the step) and masks the
render's sigma; with tensorboard, each epoch's loss parts go to TensorBoard
event files at <workspace>/run/<name> beside metrics.jsonl. Every
estimator of the JAX trainer trains: the exact encode, the sampled
backward and the stochastic-corner and residual encodes (stochastic_corners
without the sampled backward). Not ported, and refused rather than
ignored: the device mesh and pose refinement.

InteractiveTrainer (the GUI backend's) takes one step at a time at a
constant lr, an EMA tick every EMA_EVERY steps of its own count, and
bounds the steps queued on the card to MAX_INFLIGHT.
"""
import collections
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
from autolabel_tpu_torch.train.tb_events import TBEventWriter

_BATCH_KEYS = ('rays_o', 'rays_d', 'direction_norms', 'pixels', 'depth',
               'semantic')


def _refuse_unported(mesh, pose_refine):
    unported = {
        'a device mesh (data parallelism)': mesh is not None,
        'pose refinement': pose_refine is not None,
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
        self.render_options = render_options or RenderOptions(perturb=True)
        _refuse_unported(mesh, pose_refine)
        self.occupancy = occupancy
        self.occupancy_update_every = occupancy_update_every
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
        self.tb_writer = (TBEventWriter(os.path.join(workspace, 'run', name))
                          if tensorboard and workspace is not None else None)
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
        """The batch's tensors on the field's device, direction_norms as
        (N, 1). Idempotent, and free on a batch it already made (no copy):
        PrefetchIterator applies it on its own thread, and the step again."""
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
        occupancy = None
        if self.occupancy is not None:
            occupancy = (*self.occupancy.state(),
                         self.occupancy.config.threshold)
        outputs = render_rays(self.field, batch['rays_o'], batch['rays_d'],
                              batch['direction_norms'], key=self.generator,
                              options=self.step_options(),
                              occupancy=occupancy, draws=draws)
        loss, parts = compute_losses(outputs, batch, self.loss_options)
        params = self.optimizer.params
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        parts = {k: v.detach() for k, v in parts.items()}
        parts['total'] = loss.detach()
        return parts, dict(zip(params, grads))

    def train_step(self, data, draws=None):
        """One optimization step; returns its loss parts. With an occupancy
        grid, the grid is updated first on every occupancy_update_every-th
        step."""
        if (self.occupancy is not None
                and self.global_step % self.occupancy_update_every == 0):
            self.occupancy.update(self.field)
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
            if losses is not None and (self.metrics_logger is not None
                                       or self.tb_writer is not None):
                # One small device-to-host read per epoch, at its end.
                fetched = {k: float(v) for k, v in losses.items()}
                if self.metrics_logger is not None:
                    self.metrics_logger.log(self.epoch, self.global_step,
                                            fetched)
                if self.tb_writer is not None:
                    self.tb_writer.add_scalars(
                        self.global_step,
                        {f'train/{k}': v for k, v in fetched.items()})
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


class InteractiveTrainer(SimpleTrainer):
    """Single-step trainer for the paint -> train -> preview loop
    (autolabel_tpu/train/trainer.py:439-485): a constant lr unless `iters`
    is given, and an EMA tick whenever the local `step` (reset by init)
    reaches a multiple of EMA_EVERY."""

    EMA_EVERY = 100

    # How many launched but unfinished steps may be queued on the card.
    # Launches return at once, so the message pump could queue steps far
    # faster than the card runs them, and a preview request would then
    # wait for the whole backlog. The window keeps the host ahead of the
    # card without a sync every step, and bounds a preview's wait to
    # about MAX_INFLIGHT steps.
    MAX_INFLIGHT = 8

    def __init__(self, *args, **kwargs):
        kwargs.setdefault('iters', None)  # constant lr
        super().__init__(*args, **kwargs)
        self.iterator = None
        self.step = 0
        self._inflight = collections.deque()

    def init(self, dataloader):
        self.iterator = iter(dataloader)
        self.step = 0

    def take_step(self, draws=None):
        """One step on the next batch (the occupancy grid updated first on
        its cadence); returns its loss parts as 0-dim device tensors.
        draws: the render's uniforms, as train_step takes them."""
        losses = self.train_step(next(self.iterator), draws)
        self.step += 1
        if self.step % self.EMA_EVERY == 0:
            self._ema_step()
        # A CUDA event marks the step's end; on the CPU every step has
        # ended when it returns, and the deque only keeps its bound.
        event = None
        if self.field.device.type == 'cuda':
            event = torch.cuda.Event()
            event.record()
        self._inflight.append(event)
        while len(self._inflight) > self.MAX_INFLIGHT:
            oldest = self._inflight.popleft()
            if oldest is not None:
                oldest.synchronize()
        return losses

    def dataset_updated(self, loader):
        self.iterator = iter(loader)
