"""Camera rays and pose conventions (numpy, host side).

Counterpart of autolabel_tpu/core/rays.py, kept as the port's own copy. A
scene pose T_CW (OpenCV camera convention) is inverted, flipped to
OpenGL, then axis-permuted with the instant-ngp remap; ray directions are
computed per pixel in vectorized numpy.
"""
import numpy as np

# OpenCV camera (x right, y down, z forward) -> OpenGL (y up, z backward).
CV_TO_OPENGL = np.diag([1.0, -1.0, -1.0, 1.0])

# instant-ngp axis remap: rows cycled (y, z, x) with flipped 2nd/3rd columns.
_NGP_ROW_PERM = np.array([1, 2, 0])
_NGP_COL_SIGN = np.array([1.0, -1.0, -1.0, 1.0])


def nerf_matrix_to_ngp(pose, scale=1.0, offset=(0.0, 0.0, 0.0)):
    """OpenGL camera-to-world pose -> instant-ngp's convention."""
    pose = np.asarray(pose)
    out = np.eye(4, dtype=np.float32)
    out[:3] = pose[_NGP_ROW_PERM, :] * _NGP_COL_SIGN[None, :]
    out[:3, 3] = out[:3, 3] * scale + np.asarray(offset)
    return out


def convert_pose(T_CW):
    """Scene-file T_CW (OpenCV world-to-camera) -> ngp T_WC."""
    T_WC = np.linalg.inv(T_CW) @ CV_TO_OPENGL
    return nerf_matrix_to_ngp(T_WC, scale=1.0)


def compute_directions(R_WC, ray_indices, w, fx, fy, cx, cy, rng=None):
    """World-space unit ray directions for flat pixel indices.

    R_WC: (3, 3) camera-to-world rotation; ray_indices: (N,) flat pixel
    indices (row-major); rng: np.random.Generator for intra-pixel jitter,
    or None for pixel centers. Returns directions (N, 3) float32 and the
    norms (N, 1) of the unnormalized camera-space directions (x, y, 1),
    the factor converting ray distance to z-depth.
    """
    ray_indices = np.asarray(ray_indices)
    xs = (ray_indices % w).astype(np.float32)
    ys = ((ray_indices - xs) / w).astype(np.float32)
    if rng is not None:
        xs = xs + rng.random(ray_indices.size, dtype=np.float32)
        ys = ys + rng.random(ray_indices.size, dtype=np.float32)
    else:
        xs = xs + 0.5
        ys = ys + 0.5
    directions = np.empty((ray_indices.size, 3), dtype=np.float32)
    directions[:, 0] = (xs - cx) / fx
    directions[:, 1] = (ys - cy) / fy
    directions[:, 2] = 1.0
    norms = np.linalg.norm(directions, axis=1, keepdims=True)
    directions /= norms
    return directions @ np.asarray(R_WC, dtype=np.float32).T, norms
