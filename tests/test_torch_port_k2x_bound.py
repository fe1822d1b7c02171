"""chip_smoke._k2x_bound, K2x's least time, against a count made by hand on
a small grid: an EXACT level charges no rows (its corners follow from x), a
RESIDUAL level its two drawn rows a point, each distinct table row once,
g only on the levels that carry a gradient. No card needed."""
import numpy as np
import pytest
import torch

import chip_smoke
from autolabel_tpu_torch.ops import encoders
from autolabel_tpu_torch.ops.encoders import HashGridConfig

# Three dense levels of 4, 8 and 16 cells a side (strides 5, 9, 17: at
# most 4,913 rows of 8,192), so a cell's corners are distinct rows.
CONFIG = HashGridConfig(n_levels=3, n_features=8, log2_hashmap_size=13,
                        base_resolution=4, per_level_scale=2.0)
F, N = CONFIG.n_features, 3


def _points():
    """Three points in one cell of every level, their fractions in the
    same order there, so they share their atoms' rows on every level."""
    x = np.array([0.30, 0.45, 0.60], np.float32) + np.array(
        [[0.0], [1e-3], [2e-3]], np.float32)
    return torch.tensor(x)


def test_grid_is_dense_and_points_share_their_cells():
    scales, strides, sizes, dense = encoders.level_geometry(CONFIG)
    assert dense.all() and (strides ** 3 <= sizes).all()
    cells = torch.floor(_points()[:, None, :]
                        * torch.tensor(scales)[None, :, None]
                        + CONFIG.pos_offset)
    assert bool((cells == cells[:1]).all())


@pytest.mark.parametrize('interp,atoms', [('trilinear', 8), ('simplex', 4)])
def test_exact_levels_charge_each_distinct_row_once(interp, atoms):
    """Every level EXACT: each level's A distinct rows once (not N A), g on
    all three levels, x read and dx written; no row indices."""
    (ms, by), nbytes = chip_smoke._k2x_bound(encoders, CONFIG, _points(),
                                             interp, None, None)
    want = N * 3 * 4 * 2 + N * 3 * F * 4 + 3 * atoms * F * 4
    assert nbytes == want
    flops = 2 * F * 3 * atoms * N
    want_ms = max(want / chip_smoke.PEAK_BYTES,
                  flops / chip_smoke.PEAK_FP32) * 1e3
    assert ms == pytest.approx(want_ms, rel=1e-12)
    assert by == 'bytes'


def test_residual_and_draws_levels():
    """Level 0 EXACT (8 corners), level 1 RESIDUAL (drawn rows 3, 3, 40 and
    3, 41, 41: 3 distinct rows, 2 row indices a point read), level 2 DRAWS
    (nothing: no g, no rows). The EXACT and DRAWS levels' entries in rows
    are distinct values the bound must not count."""
    plan = ((encoders.EXACT, 8), (encoders.RESIDUAL, 2), (encoders.DRAWS, 2))
    rows = torch.arange(1000, 1000 + 12 * N, dtype=torch.int32).view(12, N)
    rows[8] = torch.tensor([3, 3, 40], dtype=torch.int32)
    rows[9] = torch.tensor([3, 41, 41], dtype=torch.int32)
    (ms, _), nbytes = chip_smoke._k2x_bound(encoders, CONFIG, _points(),
                                            'trilinear', plan, rows)
    want = (N * 3 * 4 * 2      # x read, dx written
            + N * 2 * F * 4    # g of levels 0 and 1
            + 2 * N * 4        # level 1's two drawn rows a point
            + (8 + 3) * F * 4)  # 8 corner rows, 3 distinct drawn rows
    assert nbytes == want
    assert ms == pytest.approx(want / chip_smoke.PEAK_BYTES * 1e3,
                               rel=1e-12)
