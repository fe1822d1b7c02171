"""Offline stand-ins for the teacher networks.

Counterpart of autolabel_tpu/features/fallback.py, kept as the port's own
copy: deterministic extractors that need no downloaded weights, so the
distillation paths run in zero-egress environments with the shapes and
dtypes of the real teachers. RandomFeatureExtractor is the LSeg stand-in
of the online mapping node (--allow-fallback); HashTextEncoder the CLIP
text stand-in of the open-vocabulary paths. Both give the JAX package's
values for the same inputs.
"""
import hashlib

import numpy as np


class RandomFeatureExtractor:
    """Multi-scale local statistics -> fixed random projection.

    __call__ contract matches the reference extractors: float images
    (B, 3, H, W) in [0, 1] -> float16 features (B, H//stride, W//stride,
    out_dim).
    """

    def __init__(self, out_dim, stride=8, seed=0):
        self.out_dim = out_dim
        self.stride = stride
        rng = np.random.default_rng(seed)
        # 3 color channels x (mean, var) x 3 context scales = 18 raw dims.
        self._projection = rng.normal(size=(18, out_dim)).astype(
            np.float32) / np.sqrt(18)

    def shape(self, input_shape):
        return (input_shape[0] // self.stride, input_shape[1] // self.stride)

    def _pool(self, image, k):
        h, w = image.shape[1] // k, image.shape[2] // k
        patch = image[:, :h * k, :w * k].reshape(image.shape[0], h, k, w, k)
        return patch.mean(axis=(2, 4)), patch.var(axis=(2, 4))

    def __call__(self, x):
        x = np.asarray(x, dtype=np.float32)
        out = []
        for image in x:
            h_out, w_out = self.shape(image.shape[1:])
            feats = []
            for scale in (1, 2, 4):
                k = self.stride * scale
                mean, var = self._pool(image, k)
                # Upsample coarse scales back to the stride grid (edge-pad
                # when the image is not a multiple of k).
                for stat in (mean, var):
                    up = np.repeat(np.repeat(stat, scale, 1), scale, 2)
                    pad_h = max(h_out - up.shape[1], 0)
                    pad_w = max(w_out - up.shape[2], 0)
                    up = np.pad(up, ((0, 0), (0, pad_h), (0, pad_w)),
                                mode='edge')
                    feats.append(up[:, :h_out, :w_out])
            raw = np.concatenate(feats, axis=0)  # (18, h_out, w_out)
            proj = np.tensordot(raw, self._projection,
                                axes=([0], [0]))  # (h_out, w_out, D)
            out.append(proj.astype(np.float16))
        return np.stack(out)


class HashTextEncoder:
    """Deterministic pseudo text embeddings (CLIP stand-in, 512-d unit)."""

    def __init__(self, dim=512):
        self.dim = dim

    def encode_text(self, prompts):
        out = np.zeros((len(prompts), self.dim), dtype=np.float32)
        for i, prompt in enumerate(prompts):
            digest = hashlib.sha256(str(prompt).encode()).digest()
            rng = np.random.default_rng(
                int.from_bytes(digest[:8], 'little'))
            out[i] = rng.normal(size=self.dim)
        return out / np.linalg.norm(out, axis=-1, keepdims=True)
