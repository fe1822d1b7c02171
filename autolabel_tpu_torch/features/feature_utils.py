"""Teacher-extractor dispatch (counterpart of
autolabel_tpu/features/feature_utils.py).

The teacher towers (DINO, FCN-ResNet50, LSeg with CLIP, the demo CLIP)
are not ported yet (ROADMAP.md, queue 1 item 6): asking for one raises.
The one exception is the JAX package's offline stand-in for LSeg's text
encoder, which allow_fallback selects there when no CLIP weights are
configured: with allow_fallback, 'lseg' returns HashTextEncoder(512)
(testing only, not real vision-language features; no image tower), the
JAX package's vectors for the same prompts. With CLIP weights configured
(AUTOLABEL_CLIP_WEIGHTS), the JAX package would encode with them, so the
port raises instead.
"""
import os

from autolabel_tpu_torch.features.fallback import HashTextEncoder

TEACHERS = ('fcn50', 'dino', 'lseg', 'demo')


def get_feature_extractor(features, checkpoint=None, allow_fallback=False):
    del checkpoint  # names real teacher weights, which are not ported
    if features not in TEACHERS:
        raise NotImplementedError(f"Unknown feature extractor {features}")
    if (features == 'lseg' and allow_fallback
            and not os.environ.get('AUTOLABEL_CLIP_WEIGHTS')):
        return HashTextEncoder(512)
    raise NotImplementedError(
        f"the '{features}' teacher is not ported yet (the teacher towers, "
        "ROADMAP.md queue 1 item 6); with --allow-fallback, 'lseg' "
        "encodes text with the hash stand-in")
