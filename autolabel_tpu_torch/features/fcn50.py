"""FCN-ResNet50 feature teacher.

Counterpart of autolabel_tpu/features/fcn50.py on its local-weights
route: AUTOLABEL_FCN50_WEIGHTS names a fcn_resnet50_coco state dict
(.pth), which loads into the port's own ResNet (features/fcn.py; the
card's machine has no torchvision) and gives 512-channel maps at stride
8 as fp16. A file that is not an FCN50 checkpoint raises. Without the
variable, allow_fallback gives the deterministic stand-in (testing only),
and anything else raises. The torchvision-pretrained route downloads its
weights and is not ported.
"""
import os
import warnings

import torch

from autolabel_tpu_torch.features.fallback import RandomFeatureExtractor
from autolabel_tpu_torch.features.fcn import FCN, load_torchvision_state_dict


def read_fcn50_state(path):
    """A fcn_resnet50 checkpoint's state dict ('state_dict' or 'model'
    entry when present), checked to hold the backbone and the head."""
    state = torch.load(path, map_location='cpu', weights_only=True)
    state = state.get('state_dict', state.get('model', state))
    for key in ('backbone.conv1.weight', 'backbone.layer4.0.conv1.weight',
                'classifier.0.weight', 'classifier.1.running_var'):
        if key not in state:
            raise RuntimeError(
                f"AUTOLABEL_FCN50_WEIGHTS={path} does not match "
                f"fcn_resnet50 (no {key})")
    return state


class FCN50:
    """(B, 3, H, W) in [0, 1] -> (B, H/8, W/8, 512) fp16 features.

    device: None (the card; raises without one) or a torch device.
    """

    out_dim = 512

    def __init__(self, allow_fallback=False, device=None):
        self._model = None
        weights = os.environ.get('AUTOLABEL_FCN50_WEIGHTS')
        if weights and os.path.exists(weights):
            self._model = FCN(load_torchvision_state_dict(
                read_fcn50_state(weights)), device)
            return
        if not allow_fallback:
            raise RuntimeError(
                "FCN-ResNet50 weights are unavailable: set "
                "AUTOLABEL_FCN50_WEIGHTS to a fcn_resnet50 state dict, or "
                "pass --allow-fallback to use deterministic "
                "random-projection stand-in features (testing only, NOT "
                "real FCN features).")
        warnings.warn("FCN-ResNet50 weights unavailable; using "
                      "deterministic fallback features.")
        self._fallback = RandomFeatureExtractor(self.out_dim, stride=8,
                                                seed=512)

    def shape(self, input_shape):
        return (input_shape[0] // 8, input_shape[1] // 8)

    def __call__(self, x):
        if self._model is None:
            return self._fallback(x)
        return self._model(x)
