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


def ngp_pose_to_scene(T_ngp):
    """Inverse of convert_pose: ngp T_WC -> scene-file T_CW (OpenCV
    world-to-camera), so registered or refined poses can be written back
    in the scene's pose/*.txt convention."""
    T_ngp = np.asarray(T_ngp, np.float64)
    T_WC_gl = np.eye(4)
    # Undo nerf_matrix_to_ngp's row cycle and column flips.
    T_WC_gl[_NGP_ROW_PERM, :] = T_ngp[:3] * _NGP_COL_SIGN[None, :]
    T_WC_gl[3] = (0.0, 0.0, 0.0, 1.0)
    return np.linalg.inv(T_WC_gl @ np.linalg.inv(CV_TO_OPENGL))


def compute_directions(R_WC, ray_indices, w, fx, fy, cx, cy, rng=None):
    """World-space unit ray directions for flat pixel indices.

    R_WC: (3, 3) camera-to-world rotation; ray_indices: (N,) flat pixel
    indices (row-major); rng: np.random.Generator for intra-pixel jitter
    (two float32 draws of N: x, then y), or None for pixel centers.
    Returns directions (N, 3) float32 and the norms (N, 1) float32 of the
    unnormalized camera-space directions (x, y, 1), the factor converting
    ray distance to z-depth.

    The arithmetic is the JAX package's native kernel's
    (native/raybatch.c): float64 in its order, rounded once to float32.
    """
    ray_indices = np.asarray(ray_indices).astype(np.int64)
    if rng is not None:
        jx = rng.random(ray_indices.size, dtype=np.float32).astype(np.float64)
        jy = rng.random(ray_indices.size, dtype=np.float32).astype(np.float64)
    else:
        jx = jy = 0.5
    dx = ((ray_indices % w).astype(np.float64) + jx - cx) / fx
    dy = ((ray_indices // w).astype(np.float64) + jy - cy) / fy
    norm = np.sqrt(dx * dx + dy * dy + 1.0)
    inv = 1.0 / norm
    ux, uy, uz = dx * inv, dy * inv, inv
    r = np.asarray(R_WC, dtype=np.float64)
    directions = np.empty((ray_indices.size, 3), dtype=np.float32)
    for row in range(3):
        directions[:, row] = r[row, 0] * ux + r[row, 1] * uy + r[row, 2] * uz
    return directions, norm.astype(np.float32)[:, None]
