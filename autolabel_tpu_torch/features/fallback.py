"""Offline stand-in for a teacher's text encoder.

Counterpart of HashTextEncoder in autolabel_tpu/features/fallback.py (the
image stand-ins are not ported): deterministic pseudo text embeddings for
zero-egress testing of the open-vocabulary paths, the same vectors as the
JAX package's for the same prompts.
"""
import hashlib

import numpy as np


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
