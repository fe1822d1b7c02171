"""LSeg vision-language teacher: pixel features and CLIP text embeddings.

Counterpart of autolabel_tpu/features/lseg.py's LSegFE without the
lang-seg package route (it needs lang-seg, clip and a download):

Pixel features: the port's image tower (features/lseg_tower.py) from the
`checkpoint` argument or AUTOLABEL_LSEG_WEIGHTS; else, with
allow_fallback, deterministic stand-in features (testing only).

Text embeddings: the port's CLIP text tower (features/clip_text.py) from
AUTOLABEL_CLIP_WEIGHTS + AUTOLABEL_CLIP_BPE; else, with allow_fallback,
the hash stand-in (testing only).

With neither tower and no allow_fallback it raises. The device is
resolved only for a tower that runs: the stand-ins run on the host.
"""
import os
import warnings

from autolabel_tpu_torch.device import resolve_device
from autolabel_tpu_torch.features import clip_text, lseg_tower
from autolabel_tpu_torch.features.fallback import (HashTextEncoder,
                                                   RandomFeatureExtractor)


class LSegFE:
    """device: None (the card; raises without one) or a torch device."""

    out_dim = 512

    def __init__(self, checkpoint=None, allow_fallback=False, device=None):
        self.text_tower = clip_text.from_env(device)
        self.image_tower = None
        self._fallback = None
        self._hash_text = None
        weights = checkpoint or os.environ.get('AUTOLABEL_LSEG_WEIGHTS')
        if checkpoint or (weights and os.path.exists(weights)):
            device = resolve_device(device)
            try:
                self.image_tower = lseg_tower.load(weights, device)
            except Exception as load_err:
                warnings.warn(f'LSeg tower weight load failed '
                              f'({load_err!r}); pixel features '
                              'unavailable.')
        if self.image_tower is not None:
            self.out_dim = self.image_tower.out_dim
        if (self.text_tower is None and self.image_tower is None
                and not allow_fallback):
            raise RuntimeError(
                "LSeg is unavailable: set AUTOLABEL_LSEG_WEIGHTS (or pass "
                "--checkpoint) for the image tower and "
                "AUTOLABEL_CLIP_WEIGHTS + AUTOLABEL_CLIP_BPE for the CLIP "
                "text tower, or pass --allow-fallback to use "
                "deterministic stand-in features and the hash text encoder "
                "(testing only, NOT real vision-language features).")
        if self.image_tower is None and allow_fallback:
            self._fallback = RandomFeatureExtractor(self.out_dim, stride=2,
                                                    seed=1512)
        if self.text_tower is None and allow_fallback:
            self._hash_text = HashTextEncoder(self.out_dim)

    def shape(self, input_shape):
        return (input_shape[0] // 2, input_shape[1] // 2)

    def encode_text(self, prompts):
        """list of N strings -> unit-norm (N, 512) float32 numpy."""
        if self.text_tower is not None:
            return self.text_tower.encode_text(prompts)
        if self._hash_text is None:
            raise RuntimeError(
                'LSeg text embeddings are unavailable (no '
                'AUTOLABEL_CLIP_WEIGHTS/BPE). Pass --allow-fallback for '
                'the hash stand-in (testing only).')
        return self._hash_text.encode_text(prompts)

    def __call__(self, x):
        """x: (B, 3, H, W) in [0, 1] -> (B, H/2, W/2, 512): the tower's
        fp32 tensor on the device, or the stand-in's fp16 numpy."""
        if self.image_tower is not None:
            return self.image_tower(x)
        if self._fallback is None:
            raise RuntimeError(
                'LSeg pixel features are unavailable (no '
                'AUTOLABEL_LSEG_WEIGHTS). Pass --allow-fallback to use '
                'deterministic stand-in features (testing only, NOT real '
                'LSeg features).')
        return self._fallback(x)
