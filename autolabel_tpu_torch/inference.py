"""Inference-time model handle: Field + trained params + staged renderer.

Counterpart of autolabel_tpu/inference.py: the serving entry point that
render and evaluation tools build through from_checkpoint. Methods take
and return numpy arrays.
"""
import os

import numpy as np
import torch

from autolabel_tpu_torch import bridge, model_utils
from autolabel_tpu_torch.render.renderer import RenderOptions, StagedRenderer


class InferenceModel:

    def __init__(self,
                 field,
                 params=None,
                 num_steps=128,
                 upsample_steps=0,
                 proposal_steps=0,
                 max_ray_batch=4096):
        """field: a Field on its device (the card, unless it was built with
        device='cpu'). params: an optional JAX-layout numpy tree loaded
        into the field. proposal_steps > 0 uses the field's proposal net
        to place num_steps main samples."""
        if proposal_steps > 0 and not field.config.proposal:
            raise ValueError(
                'proposal_steps requires a proposal-trained checkpoint '
                '(FieldConfig.proposal); this field has no proposal net')
        if params is not None:
            bridge.load_params(field, params)
        self.field = field
        self._staged = StagedRenderer(field,
                                      RenderOptions(num_steps=num_steps,
                                                    upsample_steps=upsample_steps,
                                                    proposal_steps=proposal_steps,
                                                    perturb=False),
                                      max_ray_batch=max_ray_batch)
        self._chunk = 50000

    @classmethod
    def from_checkpoint(cls, field, model_dir, **kwargs):
        """Load <model_dir>/checkpoints' params (the 'model' entry, as the
        JAX package does) into `field` and wrap it."""
        params, _ = model_utils.load_checkpoint(
            os.path.join(model_dir, 'checkpoints'))
        return cls(field, params, **kwargs)

    def render(self, batch):
        """Staged full-frame render of a batch with rays_o, rays_d (H, W, 3)
        and direction_norms; returns numpy arrays shaped (H, W, ...)."""
        lead = np.asarray(batch['rays_o']).shape[:-1]
        out = self._staged.render(
            batch['rays_o'], batch['rays_d'],
            np.asarray(batch['direction_norms']).reshape(*lead))
        return {k: v.cpu().numpy() for k, v in out.items()}

    @torch.inference_mode()
    def density(self, points):
        """Chunked density query: (N, 3) -> dict(sigma (N,), geo_feat)."""
        points = torch.as_tensor(np.asarray(points, dtype=np.float32))
        sigmas, geos = [], []
        for start in range(0, len(points), self._chunk):
            chunk = points[start:start + self._chunk].to(self.field.device)
            sigma, geo = self.field.density(chunk)
            sigmas.append(sigma.cpu().numpy())
            geos.append(geo.cpu().numpy())
        return {'sigma': np.concatenate(sigmas),
                'geo_feat': np.concatenate(geos)}

    @torch.inference_mode()
    def semantic(self, geo_feat):
        """Chunked semantic head query: (N, G) -> (logits, features)."""
        geo_feat = torch.as_tensor(np.asarray(geo_feat, dtype=np.float32))
        logits, feats = [], []
        for start in range(0, len(geo_feat), self._chunk):
            chunk = geo_feat[start:start + self._chunk].to(self.field.device)
            l, f = self.field.semantic(chunk)
            logits.append(l.cpu().numpy())
            feats.append(f.cpu().numpy())
        return np.concatenate(logits), np.concatenate(feats)
