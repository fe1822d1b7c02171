"""Loss composition over rendered ray batches.

Counterpart of autolabel_tpu/train/losses.py:
  - MSE rgb (weight 1.0 default)
  - masked L1 depth where gt depth > DEPTH_EPSILON (weight 0.1)
  - L1 feature distillation on the shared leading feature channels (0.5)
  - masked cross-entropy over labeled rays (semantic >= 0) (1.0)
  - the proposal net's interlevel loss when the render returns one (1.0)
Masked means are sum / clamped count, as in the JAX package.

On a device mesh (parallel.py) each rank holds a block of the global
batch's rows, and its terms are its part of the global batch's loss: the
masked means divide by the global counts (the masks summed over 'data'),
the plain means by the data ranks too (every rank holds as many rows), so
the terms summed over 'data' are the one-device loss on the global batch,
and so are their gradients summed over 'data'.
"""
import dataclasses

import torch

from autolabel_tpu_torch import parallel

DEPTH_EPSILON = 0.01


@dataclasses.dataclass(frozen=True)
class LossOptions:
    rgb_weight: float = 1.0
    depth_weight: float = 0.1
    semantic_weight: float = 1.0
    feature_weight: float = 0.5
    feature_loss: bool = False
    interlevel_weight: float = 1.0


def _masked_mean(values, mask, mesh=None):
    count = mask.sum()
    if mesh is not None:
        count = parallel.all_reduce_sum(count.reshape(1), mesh,
                                        parallel.DATA)[0]
    count = torch.clamp(count, min=1.0)
    return (values * mask).sum() / count


def compute_losses(outputs, batch, options: LossOptions, mesh=None):
    """Returns (total_loss, dict of unweighted per-term losses); on a device
    mesh, this rank's part of each (see the module docstring)."""
    parts = parallel.axis_size(mesh, parallel.DATA)

    def mean(values):
        # The global batch's mean: every data rank holds as many rows.
        m = torch.mean(values)
        return m if mesh is None else m / parts

    losses = {}
    losses['rgb'] = mean((outputs['image'] - batch['pixels']) ** 2)

    gt_depth = batch['depth']
    has_depth = (gt_depth > DEPTH_EPSILON).float()
    losses['depth'] = _masked_mean(torch.abs(outputs['depth'] - gt_depth),
                                   has_depth, mesh)
    total = (options.rgb_weight * losses['rgb'] +
             options.depth_weight * losses['depth'])

    if options.feature_loss:
        # Distill on the shared leading channels (a teacher wider or
        # narrower than the head).
        gt_features = batch['features']
        pred = outputs['semantic_features']
        dim = min(pred.shape[-1], gt_features.shape[-1])
        losses['feature'] = mean(
            torch.abs(pred[:, :dim] - gt_features[:, :dim]))
        total = total + options.feature_weight * losses['feature']

    if 'interlevel' in outputs:
        # The render's mean over its rays' samples.
        il = outputs['interlevel']
        losses['interlevel'] = il if mesh is None else il / parts
        total = total + options.interlevel_weight * losses['interlevel']

    gt_semantic = batch['semantic']
    has_semantic = (gt_semantic >= 0).float()
    ce = torch.nn.functional.cross_entropy(
        outputs['semantic'], torch.clamp(gt_semantic, min=0).long(),
        reduction='none')
    losses['semantic'] = _masked_mean(ce, has_semantic, mesh)
    total = total + options.semantic_weight * losses['semantic']
    return total, losses
