"""Import-path shim: the extractor dispatch as
autolabel_tpu_torch.utils.feature_utils (autolabel_tpu/utils/
feature_utils.py's counterpart)."""
from autolabel_tpu_torch.features.feature_utils import get_feature_extractor

__all__ = ['get_feature_extractor']
