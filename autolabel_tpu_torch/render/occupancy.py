"""Occupancy grid: density-bitfield masking for the volumetric renderer.

Counterpart of autolabel_tpu/render/occupancy.py. The grid MASKS the
density of samples in empty or untrained cells (static shapes, one
gather) rather than compacting samples; EMA-decayed updates follow
instant-ngp's schedule. The state is two tensors on the field's device;
mark_untrained_grid runs in host numpy, once per dataset.

update queries field.density at all R^3 cell centres (2,097,152 at the
default R = 128) in chunks of UPDATE_CHUNK points, under no_grad: on the
card the simplex encode runs K1s in its eval form, whose fp32 output alone
would take R^3 x 512 x 4 B = 4.3 GB in one piece.
"""
import dataclasses

import numpy as np
import torch

from autolabel_tpu_torch.device import resolve_device

UPDATE_CHUNK = 1 << 19


def cell_indices(xyz, bound, resolution):
    """(..., 3) world points -> (..., 3) int32 cell indices, clipped."""
    scaled = (xyz + bound) / (2 * bound) * resolution
    return torch.clamp(scaled.to(torch.int32), 0, resolution - 1)


def occupied(occupancy, xyz, bound):
    """(..., 3) world points -> (...) bool: their cell of the grid is
    occupied (density over the threshold) and trained. occupancy:
    (density_grid, trained_mask, threshold), as render_rays takes it."""
    density_grid, trained_mask, threshold = occupancy
    idx = cell_indices(xyz, bound, density_grid.shape[0]).long()
    i, j, k = idx[..., 0], idx[..., 1], idx[..., 2]
    return (density_grid[i, j, k] > threshold) & trained_mask[i, j, k]


@dataclasses.dataclass(frozen=True)
class OccupancyGridConfig:
    resolution: int = 128
    decay: float = 0.95
    # Density threshold under which a cell is considered empty
    # (instant-ngp's 0.01 * 1024 / sqrt(3) heuristic, order-of-magnitude).
    threshold: float = 0.01


class OccupancyGrid:
    """(R, R, R) float32 EMA'd densities and a bool 'trained' mask, on
    `device` (the card unless device='cpu')."""

    def __init__(self, config: OccupancyGridConfig, bound: float,
                 device=None):
        self.config = config
        self.bound = bound
        self.device = resolve_device(device)
        r = config.resolution
        self.density = torch.zeros((r, r, r), dtype=torch.float32,
                                   device=self.device)
        # Cells never observed by any training camera are permanently
        # masked (mark_untrained_grid); default everything trainable.
        self.trained = torch.ones((r, r, r), dtype=torch.bool,
                                  device=self.device)

    # -- coordinates -------------------------------------------------------

    def cell_centers(self):
        """(R^3, 3) world-space centers of all cells (float32, the JAX
        package's expression)."""
        r = self.config.resolution
        axis = (torch.arange(r, device=self.device) + 0.5) / r \
            * (2 * self.bound) - self.bound
        grid = torch.stack(torch.meshgrid(axis, axis, axis, indexing='ij'),
                           dim=-1)
        return grid.reshape(-1, 3)

    def cell_indices(self, xyz):
        """World points -> (N, 3) int32 cell indices, clipped."""
        return cell_indices(xyz, self.bound, self.config.resolution)

    # -- updates -----------------------------------------------------------

    @torch.no_grad()
    def update(self, field):
        """EMA update of per-cell density from the field at the cell
        centres: density = max(density * decay, sigma)."""
        sigma = torch.cat([field.density(chunk)[0].float()
                           for chunk in self.cell_centers().split(
                               UPDATE_CHUNK)])
        self.density = torch.maximum(self.density * self.config.decay,
                                     sigma.reshape(self.density.shape))

    def mark_untrained_grid(self, poses, intrinsics, image_size):
        """Mask cells outside every training frustum.

        poses: (N, 4, 4) ngp-convention camera-to-world matrices (the
        dataset's .poses); intrinsics: (fx, fy, cx, cy); image_size:
        (w, h) in pixels. Host-side numpy.
        """
        fx, fy, cx, cy = intrinsics
        w, h = image_size
        centers = self.cell_centers().cpu().numpy()
        visible = np.zeros(len(centers), dtype=bool)
        for T_WC in np.asarray(poses):
            R = T_WC[:3, :3]
            t = T_WC[:3, 3]
            # Rays are (x, y, 1)-style directions rotated by R (the
            # dataset's convention): the camera looks along +z of this
            # frame, x right, y down.
            p_cam = (centers - t) @ R
            z = p_cam[:, 2]
            with np.errstate(divide='ignore', invalid='ignore'):
                u = p_cam[:, 0] / z * fx + cx
                v = p_cam[:, 1] / z * fy + cy
            in_front = z > 0
            visible |= in_front & (u >= 0) & (u < w) & (v >= 0) & (v < h)
            if visible.all():
                break
        self.trained = torch.as_tensor(visible.reshape(self.density.shape),
                                       device=self.device)

    # -- query -------------------------------------------------------------

    def occupancy_mask(self, xyz):
        """(N, 3) world points -> (N,) float32 1.0 where the cell is
        occupied and trained, else 0.0."""
        return occupied(self.state() + (self.config.threshold,), xyz,
                        self.bound).float()

    def state(self):
        """(density, trained): with config.threshold, the tuple render_rays
        takes as `occupancy`."""
        return self.density, self.trained
