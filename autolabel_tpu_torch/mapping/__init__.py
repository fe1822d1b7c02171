"""Structure-from-motion mapping of the PyTorch port: the cv2 front end and
bundle adjustment (K9 on the card).

Counterpart of autolabel_tpu/mapping/: `bundle_adjust` (ba.py, a
matrix-free Levenberg-Marquardt solve) and `IncrementalSfM` (sfm.py).
Importing the package imports no cv2; the front end imports it where it
runs. `python -m autolabel_tpu_torch.mapping <scene>` is the mapping CLI
(scripts/mapping.py's counterpart).
"""
from autolabel_tpu_torch.mapping.ba import bundle_adjust  # noqa: F401
from autolabel_tpu_torch.mapping.sfm import IncrementalSfM  # noqa: F401
