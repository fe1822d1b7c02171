"""Feature-compression autoencoder.

Counterpart of autolabel_tpu/models/autoencoder.py: it compresses teacher
features (LSeg's 512-d) to the feature head's width before distillation;
two one-hidden-layer MLPs of 128 (ops/mlp.py), a ReLU bottleneck and
dropout 0.1 on the code. The dropout's keep-mask is passed in as a
tensor (jax.random.bernoulli's, in the tests), or drawn from a
torch.Generator.
"""
import torch

from autolabel_tpu_torch.ops.mlp import mlp_apply, mlp_init


class Autoencoder:

    def __init__(self, in_features, bottleneck):
        self.in_features = in_features
        self.bottleneck = bottleneck

    def init(self, generator, device='cpu'):
        """He-uniform weights drawn on the CPU, moved to `device`."""
        params = {
            'encoder': mlp_init(generator, self.in_features, 128,
                                self.bottleneck, 1),
            'decoder': mlp_init(generator, self.bottleneck, 128,
                                self.in_features, 1),
        }
        return {k: [w.to(device) for w in ws] for k, ws in params.items()}

    def encode(self, params, x):
        return torch.relu(mlp_apply(params['encoder'], x))

    def decode(self, params, code):
        return mlp_apply(params['decoder'], code)

    def apply(self, params, x, keep=None, generator=None, p=0.1):
        """(reconstruction, code); dropout on the code when `keep` (a bool
        mask of the code's shape) or `generator` is given."""
        code = self.encode(params, x)
        dropped = code
        if keep is None and generator is not None:
            keep = torch.rand(code.shape, generator=generator,
                              device=generator.device) < 1.0 - p
        if keep is not None:
            dropped = torch.where(keep.to(code.device), code / (1.0 - p),
                                  0.0)
        return self.decode(params, dropped), code
