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
        JAX package does) into `field` and wrap it. A reference torch
        checkpoint is imported, and the field swapped for its reference
        form (geo_relu, the source lattice): model_utils.load_into_field."""
        field, params, _ = model_utils.load_into_field(
            field, os.path.join(model_dir, 'checkpoints'))
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

    def _query_features(self, points):
        _, geo = self.field.density(points)
        _, features = self.field.semantic(geo)
        return features.float()

    @torch.inference_mode()
    def jittered_semantic_features(self, points, n_samples=10, sigma=0.02,
                                   seed=0, noise=None):
        """Jitter-averaged, L2-normalized semantic features at (N, 3)
        points, in the JAX package's order: the query at the points with
        weight 1, then the n_samples - 1 jittered queries added one by one
        with weight 1 / n_samples each (the reference's quirk), then
        feats / max(|feats|, 1e-9); in chunks of 50,000 points.

        The jitter is sigma times standard normals drawn on the field's
        device by a torch.Generator seeded from `seed` and the chunk's
        start. JAX's PRNG stream cannot be reproduced, so `noise`, when
        given, is the (n_samples - 1, N, 3) jitter itself, added as it is
        (sigma is then unused)."""
        points = torch.as_tensor(np.asarray(points, dtype=np.float32))
        if noise is not None:
            noise = torch.as_tensor(np.asarray(noise, dtype=np.float32))
            if tuple(noise.shape) != (n_samples - 1,) + tuple(points.shape):
                raise ValueError(
                    f'noise must be (n_samples - 1, N, 3) = '
                    f'{(n_samples - 1,) + tuple(points.shape)}, got '
                    f'{tuple(noise.shape)}')
        device = self.field.device
        # fp32(1 / n), the weight JAX's fp32 product takes
        scale = float(np.float32(1.0 / n_samples))
        out = []
        for start in range(0, len(points), self._chunk):
            chunk = points[start:start + self._chunk].to(device)
            if noise is None:
                # (seed, start) mixed into 32 bits: the CPU generator
                # keeps only the low 32 of a seed
                generator = torch.Generator(device=device)
                generator.manual_seed(int(np.random.SeedSequence(
                    [seed, start]).generate_state(1)[0]))
            feats = self._query_features(chunk)
            for i in range(n_samples - 1):
                if noise is None:
                    jitter = torch.randn(chunk.shape, generator=generator,
                                         device=device) * sigma
                else:
                    jitter = noise[i, start:start + self._chunk].to(device)
                feats = feats + self._query_features(chunk + jitter) * scale
            norm = torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
            out.append((feats / torch.clamp(norm, min=1e-9)).cpu().numpy())
        return np.concatenate(out)

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
