"""Shared colour map for semantic classes.

Counterpart of autolabel_tpu/constants.py: matplotlib's tab10 sampled at
linspace(0, 1, 10), tiled 4 times (40 x RGB, float64), through the port's
own copy of the table and of matplotlib's index rule, bit-equal to
matplotlib's.
"""
import numpy as np

from autolabel_tpu_torch.visualization import apply_colormap

# matplotlib's tab10 (its _tab10_data: the hex colours over 255).
TAB10 = np.array([(31, 119, 180), (255, 127, 14), (44, 160, 44),
                  (214, 39, 40), (148, 103, 189), (140, 86, 75),
                  (227, 119, 194), (127, 127, 127), (188, 189, 34),
                  (23, 190, 207)], dtype=np.float64) / 255

COLORS = np.concatenate([apply_colormap(TAB10, np.linspace(0.0, 1.0, 10))]
                        * 4, axis=0)
