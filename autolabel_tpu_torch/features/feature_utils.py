"""Teacher-extractor dispatch (counterpart of
autolabel_tpu/features/feature_utils.py).

allow_fallback gates the offline stand-ins: without it, missing teacher
weights raise instead of writing random-projection features. device:
None (the card; a tower raises without one) or a torch device; the
stand-ins run on the host.
"""

TEACHERS = ('fcn50', 'dino', 'lseg', 'demo')


def get_feature_extractor(features, checkpoint=None, allow_fallback=False,
                          device=None):
    if features == 'fcn50':
        from autolabel_tpu_torch.features.fcn50 import FCN50
        return FCN50(allow_fallback=allow_fallback, device=device)
    if features == 'dino':
        from autolabel_tpu_torch.features.dino import Dino
        return Dino(allow_fallback=allow_fallback, device=device)
    if features == 'lseg':
        from autolabel_tpu_torch.features.lseg import LSegFE
        return LSegFE(checkpoint, allow_fallback=allow_fallback,
                      device=device)
    if features == 'demo':
        # the scene-trained text + pixel teacher (features/demo_clip.py)
        from autolabel_tpu_torch.features.demo_clip import DemoCLIPFE
        return DemoCLIPFE(checkpoint, allow_fallback=allow_fallback,
                          device=device)
    raise NotImplementedError(f"Unknown feature extractor {features}")
