"""DINO ViT-S/8 feature teacher.

Counterpart of autolabel_tpu/features/dino.py on its local-weights route:
AUTOLABEL_DINO_WEIGHTS names the official dino_deitsmall8 checkpoint
(.pth, timm naming), which runs through the port's ViT (features/vit.py)
on ImageNet-normalised images, patch tokens out as fp16. Without it,
allow_fallback gives the deterministic stand-in (testing only), and
anything else raises. The torch-hub route downloads its weights and is
not ported.
"""
import dataclasses
import os
import warnings

import torch

from autolabel_tpu_torch.bridge import tree_from_numpy
from autolabel_tpu_torch.device import resolve_device
from autolabel_tpu_torch.features import vit
from autolabel_tpu_torch.features.fallback import RandomFeatureExtractor
from autolabel_tpu_torch.features.layers import (as_images, full_precision,
                                                 normalise)


def read_dino_state(path):
    """A DINO checkpoint as a timm-named state dict: the 'student' or
    'model' entry when present, 'module.' and 'backbone.' stripped."""
    state = torch.load(path, map_location='cpu', weights_only=True)
    state = state.get('student', state.get('model', state))
    return {k.replace('module.', '').replace('backbone.', ''): v
            for k, v in state.items()}


class Dino:
    """(B, 3, H, W) in [0, 1] -> (B, H/8, W/8, 384) fp16 patch features.

    params: a ViT tree (numpy or tensors) to use in place of the
    checkpoint, config its ViTConfig (DINO_VITS8 at the tree's depth by
    default). device: None (the card; raises without one) or a torch
    device.
    """

    out_dim = 384

    def __init__(self, allow_fallback=False, device=None, params=None,
                 config=None):
        self.params = None
        self._fallback = None
        weights = os.environ.get('AUTOLABEL_DINO_WEIGHTS')
        if params is None and weights and os.path.exists(weights):
            params = vit.load_timm_state_dict(read_dino_state(weights))
        if params is not None:
            self.device = resolve_device(device)
            self.params = tree_from_numpy(params, self.device)
            self.config = config or dataclasses.replace(
                vit.DINO_VITS8, depth=len(self.params['blocks']))
            return
        if not allow_fallback:
            raise RuntimeError(
                "DINO ViT-S/8 weights are unavailable: set "
                "AUTOLABEL_DINO_WEIGHTS to the dino_deitsmall8 checkpoint "
                "(.pth), or pass --allow-fallback to use deterministic "
                "random-projection stand-in features (testing only, NOT "
                "real DINO features).")
        warnings.warn("DINO weights unavailable; using deterministic "
                      "fallback features.")
        self._fallback = RandomFeatureExtractor(self.out_dim, stride=8,
                                                seed=384)

    def shape(self, input_shape):
        return (input_shape[0] // 8, input_shape[1] // 8)

    def __call__(self, x):
        if self.params is None:
            return self._fallback(x)
        x = normalise(as_images(x, self.device))
        with torch.no_grad(), full_precision():
            return vit.encode_image(self.params, x,
                                    self.config).to(torch.float16)
