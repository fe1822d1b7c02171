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
without the sampled backward). With pose_refine=(R0, t0), joint pose
refinement (train/pose_refine.py): per-frame deltas train beside the
field's parameters under the optimizer's 'pose' group, the EMA covers
them, the step rebuilds the rays from the refined poses, the encode is
exact, and with a hash grid the estimator phases give way to the JAX
trainer's coarse-to-fine level windows.

With mesh= (parallel.make_mesh or make_mesh_2d) every rank of the mesh runs
the trainer in lockstep on the same global batches and draws, and a step
computes the JAX trainer's one-device step on the global batch: each rank
takes its rows of the batch (and of the render's uniforms), the field's
table shards on its feature axis over 'model' (parallel.shard_field: its
Adam moments and EMA copy alike), the losses are the rank's parts of the
global means, the gradients sum over 'data', and a non-finite gradient on
any rank skips the step everywhere. Rank 0 alone writes metrics, events
and checkpoints, which hold the table whole; a resume cuts the rank's slice
from a whole checkpoint (of either package). Under 'model' the eval
renders gather the table whole first, so every rank of a model group calls
them together. With pose_refine on a mesh the deltas replicate: every rank
rebuilds its rows' rays from the whole deltas, the points' gradient sums
over 'model' (each rank's encode gives it its slice's part), and the
deltas' gradient sums over 'data' in rank order, so the deltas keep the
same bits on every rank.

InteractiveTrainer (the GUI backend's) takes one step at a time at a
constant lr, an EMA tick every EMA_EVERY steps of its own count, and
bounds the steps queued on the card to MAX_INFLIGHT; on a mesh every rank
builds it and calls init, take_step and dataset_updated in lockstep over
the same seeded loader.
"""
import collections
import contextlib
import dataclasses
import os

import numpy as np
import torch

from autolabel_tpu_torch import bridge, parallel
from autolabel_tpu_torch.render.renderer import (RenderOptions, StagedRenderer,
                                                 draw_perturbations,
                                                 render_rays)
from autolabel_tpu_torch.train import checkpoints
from autolabel_tpu_torch.train.losses import LossOptions, compute_losses
from autolabel_tpu_torch.train.metrics import MetricsLogger
from autolabel_tpu_torch.train.optim import Optimizer
from autolabel_tpu_torch.train.pose_refine import (init_pose_params,
                                                   refined_rays)
from autolabel_tpu_torch.train.tb_events import TBEventWriter

_BATCH_KEYS = ('rays_o', 'rays_d', 'direction_norms', 'pixels', 'depth',
               'semantic')
_POSE_BATCH_KEYS = ('frame_idx', 'rays_d_cam')


class _Batch(dict):
    """A batch _device_batch made: this rank's rows on the field's
    device."""


def phase_schedule(options, iters, exact_final_fraction=0.0,
                   sampled_warmup_fraction=0.0, window_levels=None):
    """The JAX trainer's gather-annealing phases, [(first_step, render
    options)] ascending: [0, warmup) scatters one sampled row a level
    (only with sampled_warmup_fraction and sampled_backward == 2), then
    the given options, then from (1 - exact_final_fraction) * iters exact
    gathers (only when an estimator is on). With window_levels L (joint
    pose refinement on a grid of L levels) these phases are replaced by
    the coarse-to-fine windows: from iters * k / (2 L) levels 0..k alone,
    k < L, then from iters / 2 the given options."""
    if iters is not None and window_levels:
        L = window_levels
        phases = [(int(iters * 0.5 * k / L), dataclasses.replace(
            options, level_window=(1.0,) * (k + 1) + (0.0,) * (L - 1 - k)))
            for k in range(L)]
        return phases + [(int(iters * 0.5), options)]
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
    trainer's PRNG key). `mesh`: a device mesh (see the module docstring);
    the field is put on it in place (parallel.shard_field)."""

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
        self.mesh = mesh
        if mesh is not None:
            parallel.shard_field(field, mesh)
        self._whole = None  # (key, StagedRenderer): _whole_renderer
        self.occupancy = occupancy
        self.occupancy_update_every = occupancy_update_every
        # Joint camera refinement: pose_refine = (R0 (N, 3, 3) cam->world,
        # t0 (N, 3) centres); per-frame SE(3) deltas train beside the
        # field. The pose gradient flows through the encode's point
        # gradient, which the sampled-backward and stochastic-corner
        # encodes drop or draw, so the encode is exact, as in the JAX
        # trainer.
        self._pose_init = None
        self.pose = {}
        window_levels = None
        if pose_refine is not None:
            R0, t0 = pose_refine
            dev = field.device
            self._pose_init = (
                torch.as_tensor(np.asarray(R0, np.float32), device=dev),
                torch.as_tensor(np.asarray(t0, np.float32), device=dev))
            self.pose = {k: v.requires_grad_(True) for k, v in
                         init_pose_params(len(t0), dev).items()}
            self.render_options = dataclasses.replace(
                self.render_options, stochastic_corners=0,
                sampled_backward=0)
            grid = field.config.grid_config
            window_levels = grid.n_levels if grid is not None else None
        self.phases = phase_schedule(self.render_options, iters,
                                     exact_final_fraction,
                                     sampled_warmup_fraction, window_levels)
        self.name = name
        self.field = field
        self.workspace = workspace
        self.ema_decay = ema_decay
        self.loss_options = loss_options or LossOptions()
        self.epoch = 0
        self.global_step = 0
        writes = workspace is not None and parallel.is_writer(mesh)
        self.metrics_logger = (MetricsLogger(workspace)
                               if metrics and writes else None)
        self.tb_writer = (TBEventWriter(os.path.join(workspace, 'run', name))
                          if tensorboard and writes else None)
        labels = dict(field.param_labels(),
                      **{f'pose.{k}': 'pose' for k in self.pose})
        self.optimizer = Optimizer(
            [*field.named_parameters(),
             *((f'pose.{k}', v) for k, v in self.pose.items())],
            labels, lr=lr, iters=iters)
        self.ema = {k: v.detach().clone()
                    for k, v in self._param_state().items()}
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

    def _param_state(self):
        """The field's state dict and the pose deltas ('pose.rot',
        'pose.t'): what the EMA covers."""
        return dict(self.field.state_dict(),
                    **{f'pose.{k}': v for k, v in self.pose.items()})

    def _grid_shape(self):
        """The whole table's (L, T, F), or None without a grid."""
        grid = self.field.config.grid_config
        return None if grid is None else (grid.n_levels, grid.table_size,
                                          grid.n_features)

    def _try_resume(self):
        payload = checkpoints.load_checkpoint(self.checkpoint_dir)
        if payload is None:
            return
        model = payload['model']
        ema = payload.get('ema', model)
        opt_state = payload.get('optimizer')
        if parallel.sharded_grid(self.field):
            # The checkpoint holds the table whole: cut this rank's slice of
            # it, of its EMA and of the port's Adam moments.
            grid_shape = self._grid_shape()
            model = parallel.shard_tree(model, self.mesh, grid_shape)
            ema = parallel.shard_tree(ema, self.mesh, grid_shape)
            if isinstance(opt_state, dict) and 'mu' in opt_state:
                opt_state = parallel.shard_tree(opt_state, self.mesh,
                                                grid_shape)
        if ('pose' in model) != bool(self.pose):
            # Resumed across a pose-refinement toggle (the model hash
            # excludes the deltas): a checkpoint without them gains zero
            # deltas, one with them loses them, and the saved moments
            # cover another param set, so they restart.
            opt_state = None
        bridge.load_params(self.field, model)
        self.ema = bridge.params_from_numpy(ema, self.field.device)
        dev = self.field.device
        for k, p in self.pose.items():
            saved = model.get('pose', {}).get(k)
            with torch.no_grad():
                p.copy_(torch.zeros_like(p) if saved is None else
                        torch.as_tensor(np.asarray(saved), device=dev))
            saved_ema = ema.get('pose', {}).get(k)
            self.ema[f'pose.{k}'] = (
                torch.zeros_like(p) if saved_ema is None else
                torch.as_tensor(np.asarray(saved_ema), device=dev))
        # A checkpoint of another optimizer (the JAX package's optax state,
        # or none) restarts the moments.
        if opt_state is None or not self.optimizer.load_state_dict(opt_state):
            self.optimizer.state = self.optimizer.init()
        self.global_step = int(payload['global_step'])
        self.epoch = int(payload.get('epoch', self.global_step // 1000))

    def _whole_states(self, states):
        """State dicts with the table whole: under 'model' the rank's slices
        gathered over the model group in one collective (every rank of it
        calls this)."""
        if not parallel.sharded_grid(self.field):
            return list(states)
        tables = parallel.gather_grid(torch.stack(
            [s['encoder.grid'].detach() for s in states]), self.mesh)
        return [dict(s, **{'encoder.grid': t})
                for s, t in zip(states, tables.unbind())]

    def save_checkpoint(self, name=None, include_optimizer=True):
        """Write a checkpoint of the whole params, EMA and (with
        include_optimizer) Adam state; on a mesh every rank calls it and
        rank 0 writes."""
        if self.workspace is None:
            return
        if name is None:
            name = f'{self.name}_ep{self.epoch:04d}'
        path = os.path.join(self.checkpoint_dir, f'{name}.pth')
        moments = ('mu', 'nu') if include_optimizer else ()
        params, ema, *whole = self._whole_states(
            [self._param_state(), self.ema]
            + [self.optimizer.state[key] for key in moments])
        if parallel.is_writer(self.mesh):
            opt_state = (self.optimizer.state_dict(dict(zip(moments, whole)))
                         if include_optimizer else None)
            state = {'params': bridge.state_to_numpy(params),
                     'ema': bridge.state_to_numpy(ema),
                     'step': self.global_step, 'opt_state': opt_state}
            checkpoints.save_checkpoint(path, state,
                                        extra={'epoch': self.epoch},
                                        include_optimizer=include_optimizer)
        if self.mesh is not None:
            parallel.barrier()

    # -- training ----------------------------------------------------------

    def _device_batch(self, data):
        """The batch's tensors on the field's device, direction_norms as
        (N, 1); on a mesh, this rank's rows of the global batch `data`,
        cut before the copy. Idempotent, and free on a batch it already
        made (no copy): PrefetchIterator applies it on its own thread, and
        the step again."""
        if isinstance(data, _Batch):
            return data
        dev = self.field.device
        keys = _BATCH_KEYS + (('features',) if self.loss_options.feature_loss
                              else ()) + (_POSE_BATCH_KEYS if self.pose
                                          else ())
        rows = parallel.batch_sharding(self.mesh)
        batch = _Batch({k: torch.as_tensor(rows.take(data[k]), device=dev)
                        for k in keys})
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
        rays_o, rays_d = batch['rays_o'], batch['rays_d']
        if self.pose:
            rays_o, rays_d = refined_rays(self.pose, self._pose_init,
                                          batch['frame_idx'],
                                          batch['rays_d_cam'])
        options = self.step_options()
        if self.mesh is not None and options.perturb:
            # The global batch's draws, every rank the same, and then this
            # rank's part of them.
            n_global = rays_o.shape[0] * parallel.axis_size(self.mesh,
                                                            parallel.DATA)
            grid = self.field.config.grid_config
            if draws is None:
                draws = draw_perturbations(
                    self.generator, n_global, options,
                    grid.n_levels if grid is not None else 0,
                    self.field.config.grid_interp)
            draws = parallel.local_draws(draws, self.mesh, n_global, options)
        outputs = render_rays(self.field, rays_o, rays_d,
                              batch['direction_norms'], key=self.generator,
                              options=options, occupancy=occupancy,
                              draws=draws)
        loss, parts = compute_losses(outputs, batch, self.loss_options,
                                     self.mesh)
        params = self.optimizer.params
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()), allow_unused=True)))
        parts = {k: v.detach() for k, v in parts.items()}
        parts['total'] = loss.detach()
        if self.mesh is not None:
            parallel.reduce_gradients(grads, self.mesh,
                                      [f'pose.{k}' for k in self.pose])
            # The loss parts of the global batch: the ranks' parts summed.
            names = list(parts)
            summed = parallel.all_reduce_sum(
                torch.stack([parts[k].float() for k in names]), self.mesh,
                parallel.DATA)
            parts = dict(zip(names, summed.unbind()))
        return parts, grads

    def train_step(self, data, draws=None):
        """One optimization step; returns its loss parts. With an occupancy
        grid, the grid is updated first on every occupancy_update_every-th
        step."""
        if (self.occupancy is not None
                and self.global_step % self.occupancy_update_every == 0):
            self.occupancy.update(self.field)
        parts, grads = self.loss_and_grads(data, draws)
        self.optimizer.step(grads, self.mesh)
        self.global_step += 1
        return parts

    @torch.no_grad()
    def _ema_step(self):
        for name, p in self._param_state().items():
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
            self.field.load_state_dict({k: v for k, v in state.items()
                                        if not k.startswith('pose.')})
        try:
            yield
        finally:
            with torch.no_grad():
                self.field.load_state_dict(saved)

    def _whole_renderer(self, use_ema=False):
        """Under 'model': a staged renderer of a whole copy of the field
        (the live params or the EMA), the table gathered over the model
        group (every rank of it calls this), made anew when the table's
        slice was written since."""
        state = self.ema if use_ema else self.field.state_dict()
        key = (use_ema, state['encoder.grid']._version)
        if self._whole is None or self._whole[0] != key:
            self._whole = None
            from autolabel_tpu_torch.models.field import Field
            state = self._whole_states([state])[0]
            whole = Field(self.field.config, device=self.field.device)
            with torch.no_grad():
                whole.load_state_dict({k: v for k, v in state.items()
                                       if not k.startswith('pose.')})
            self._whole = (key, StagedRenderer(
                whole, self._staged.options, self._staged.max_ray_batch))
        return self._whole[1]

    def _render(self, data, staged=None):
        return (staged or self._staged).render(
            data['rays_o'], data['rays_d'],
            np.asarray(data['direction_norms']).reshape(
                *np.shape(data['rays_o'])[:-1]))

    def test_step(self, data, use_ema=False):
        """Full-frame staged render -> (rgb, depth, semantic logits,
        features), shapes (H, W, ...), tensors on the field's device."""
        if parallel.sharded_grid(self.field):
            out = self._render(data, self._whole_renderer(use_ema))
        else:
            context = (self._rendering_with(self.ema) if use_ema
                       else contextlib.nullcontext())
            with context:
                out = self._render(data)
        return out['image'], out['depth'], out['semantic'], out[
            'semantic_features']

    def eval_step(self, data):
        """Render one eval frame and compute the validation rgb loss."""
        out = self._render(data, self._whole_renderer()
                           if parallel.sharded_grid(self.field) else None)
        gt_rgb = torch.as_tensor(np.asarray(data['pixels']),
                                 device=out['image'].device)
        return out, float(torch.mean((out['image'] - gt_rgb) ** 2))


class InteractiveTrainer(SimpleTrainer):
    """Single-step trainer for the paint -> train -> preview loop
    (autolabel_tpu/train/trainer.py:439-485): a constant lr unless `iters`
    is given, and an EMA tick whenever the local `step` (reset by init)
    reaches a multiple of EMA_EVERY. With mesh=, the ranks step together:
    each builds the trainer over the same seeded loader and calls init,
    take_step and dataset_updated in lockstep, and a step takes the rank's
    rows and draws as SimpleTrainer.loss_and_grads does. The GUI's backend
    and the ROS node pass no mesh."""

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
