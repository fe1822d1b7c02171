"""Mapping of the PyTorch port. Only the Rodrigues map of
autolabel_tpu/mapping/ba.py, which camera registration and pose
refinement need, is ported; bundle adjustment is not."""
