"""Procedural scenes written in the scene-directory format.

The port's copies of the JAX package's test fixtures, so a scene can be
made where neither cv2 nor the tests are at hand:
make_synthetic_scene is tests/synthetic.py's shaded sphere seen from a
camera ring, make_room_scene tests/room.py's textured room with four
occluding objects in five classes. Same geometry and the same uint8 and
uint16 truncations, so the files decode to the same pixels; they are
written by utils.images.write_png.

With annotate=True they also write what evaluation reads: labelme
polygons in gt_masks/*.json (the outline of the sphere, or of the room's
red ball, projected from its analytic silhouette: the JAX fixtures'
cv2.findContours polygons are not reproduced), gt_semantic/ for every
frame, and with mesh_points > 0 a mesh.ply of that many points on the
objects' surfaces with their classes in mesh_labels.npy (stored in the
ngp axis order the 3D evaluator permutes back).

Depth images are uint16 millimetre z-depth, poses OpenCV T_CW. To write an
annotated one from the shell: python -m autolabel_tpu_torch.utils.fixtures
{sphere,room} <scene dir>.
"""
import json
import os

import numpy as np

from autolabel_tpu_torch.utils.images import write_png
from autolabel_tpu_torch.utils.ply import write_ply_pointcloud

OUTLINE_VERTICES = 64


def sphere_outline(T_WC, camera_matrix, center, radius,
                   n=OUTLINE_VERTICES):
    """The (n, 2) pixel polygon of a sphere's silhouette (pixel i's centre
    at i, as labelme and cv2 index pixels), or None unless the whole
    sphere lies in front of the camera: the circle where the rays from the
    camera touch the sphere, projected."""
    position = T_WC[:3, 3] - center
    distance = np.linalg.norm(position)
    R = T_WC[:3, :3]
    if (R.T @ -position)[2] <= radius + 1e-3 or distance <= radius:
        return None
    axis = position / distance
    u = np.cross(axis, [0.0, 0.0, 1.0])
    if np.linalg.norm(u) < 1e-6:
        u = np.cross(axis, [1.0, 0.0, 0.0])
    u /= np.linalg.norm(u)
    v = np.cross(axis, u)
    theta = 2 * np.pi * np.arange(n) / n
    rho = radius * np.sqrt(1.0 - (radius / distance) ** 2)
    circle = (center + axis * radius ** 2 / distance
              + rho * (np.cos(theta)[:, None] * u
                       + np.sin(theta)[:, None] * v))
    cam = (circle - T_WC[:3, 3]) @ R
    pixels = cam[:, :2] / cam[:, 2:] * np.diag(camera_matrix)[:2] \
        + camera_matrix[:2, 2]
    return pixels - 0.5


def write_gt_mask(scene_dir, index, polygon, width, height, label):
    """A labelme annotation of one polygon."""
    with open(os.path.join(scene_dir, 'gt_masks', f'{index}.json'),
              'w') as f:
        json.dump({'imageWidth': width, 'imageHeight': height,
                   'shapes': [{'label': label,
                               'points': polygon.tolist()}]}, f)


def write_mesh(scene_dir, points, labels):
    """mesh.ply and mesh_labels.npy; the points are stored as (z, x, y),
    which the 3D evaluator's ngp permutation (x, y, z) -> (y, z, x) turns
    back into world coordinates."""
    write_ply_pointcloud(os.path.join(scene_dir, 'mesh.ply'),
                         points[:, [2, 0, 1]])
    np.save(os.path.join(scene_dir, 'mesh_labels.npy'),
            np.asarray(labels, np.int64))


def sphere_points(rng, n, center, radius):
    """n points uniform on a sphere's surface."""
    d = rng.normal(size=(n, 3))
    return center + radius * d / np.linalg.norm(d, axis=1, keepdims=True)


def box_points(rng, n, bmin, bmax):
    """n points uniform on a box's surface."""
    extent = bmax - bmin
    areas = np.array([extent[1] * extent[2], extent[0] * extent[2],
                      extent[0] * extent[1]])
    axis = rng.choice(3, size=n, p=areas / areas.sum())
    points = bmin + rng.uniform(size=(n, 3)) * extent
    side = rng.integers(0, 2, n)
    rows = np.arange(n)
    points[rows, axis] = np.where(side == 1, bmax[axis], bmin[axis])
    return points

# -- the sphere (tests/synthetic.py) ------------------------------------------

SPHERE_RADIUS = 0.5
SPHERE_COLOR = np.array([0.9, 0.3, 0.2])
BACKGROUND = np.array([0.75, 0.78, 0.8])


def look_at_cv(position, target, up=(0.0, 0.0, 1.0)):
    """OpenCV camera-to-world pose (x right, y down, z forward)."""
    position = np.asarray(position, dtype=np.float64)
    forward = target - position
    forward /= np.linalg.norm(forward)
    right = np.cross(forward, np.asarray(up, dtype=np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    T_WC = np.eye(4)
    T_WC[:3, 0] = right
    T_WC[:3, 1] = down
    T_WC[:3, 2] = forward
    T_WC[:3, 3] = position
    return T_WC


def ray_sphere(origins, dirs, radius):
    """t of first intersection with a sphere at the origin, inf if miss."""
    b = 2.0 * (origins * dirs).sum(-1)
    c = (origins * origins).sum(-1) - radius ** 2
    disc = b ** 2 - 4 * c
    hit = disc > 0
    sqrt_disc = np.sqrt(np.maximum(disc, 0.0))
    t = (-b - sqrt_disc) / 2.0
    return np.where(hit & (t > 0), t, np.inf)


def render_frame(T_WC, camera_matrix, width, height):
    fx, fy = camera_matrix[0, 0], camera_matrix[1, 1]
    cx, cy = camera_matrix[0, 2], camera_matrix[1, 2]
    xs, ys = np.meshgrid(np.arange(width) + 0.5, np.arange(height) + 0.5)
    dirs_cam = np.stack(
        [(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)], axis=-1)
    norms = np.linalg.norm(dirs_cam, axis=-1, keepdims=True)
    dirs_cam = dirs_cam / norms
    R = T_WC[:3, :3]
    origin = T_WC[:3, 3]
    dirs = dirs_cam @ R.T
    origins = np.broadcast_to(origin, dirs.shape)

    t = ray_sphere(origins.reshape(-1, 3), dirs.reshape(-1, 3),
                   SPHERE_RADIUS).reshape(height, width)
    hit = np.isfinite(t)
    t_safe = np.where(hit, t, 0.0)
    points = origins + t_safe[..., None] * dirs
    normals = points / max(SPHERE_RADIUS, 1e-9)
    light = np.array([0.5, -0.5, 0.8])
    light = light / np.linalg.norm(light)
    shade = np.clip((normals * light).sum(-1), 0.1, 1.0)

    rgb = np.where(hit[..., None], SPHERE_COLOR * shade[..., None],
                   BACKGROUND)
    # z-depth (projection onto the optical axis), meters.
    z = np.where(hit, t_safe * dirs_cam[..., 2], 0.0)
    semantic = np.where(hit, 2, 1).astype(np.uint8)
    return rgb, z, semantic


def make_synthetic_scene(scene_dir,
                         n_frames=12,
                         width=48,
                         height=36,
                         camera_distance=1.6,
                         label_every=3,
                         annotate=False,
                         mesh_points=0):
    """annotate: also gt_masks/ (the sphere's outline, every label_every
    frames) and gt_semantic/; mesh_points: that many points on the sphere
    in mesh.ply, class 2."""
    os.makedirs(scene_dir, exist_ok=True)
    subs = ('rgb', 'depth', 'pose', 'semantic')
    if annotate:
        subs += ('gt_masks', 'gt_semantic')
    for sub in subs:
        os.makedirs(os.path.join(scene_dir, sub), exist_ok=True)

    focal = 0.8 * width
    camera_matrix = np.array([[focal, 0, width / 2.0],
                              [0, focal, height / 2.0], [0, 0, 1.0]])
    np.savetxt(os.path.join(scene_dir, 'intrinsics.txt'), camera_matrix)
    bound = 1.0
    np.savetxt(os.path.join(scene_dir, 'bbox.txt'),
               np.array([-bound] * 3 + [bound] * 3))
    with open(os.path.join(scene_dir, 'metadata.json'), 'w') as f:
        json.dump({'n_classes': 2}, f)

    for i in range(n_frames):
        angle = 2 * np.pi * i / n_frames
        position = np.array([
            camera_distance * np.cos(angle),
            camera_distance * np.sin(angle),
            0.7,
        ])
        T_WC = look_at_cv(position, np.zeros(3))
        T_CW = np.linalg.inv(T_WC)
        rgb, z, semantic = render_frame(T_WC, camera_matrix, width, height)

        write_png(os.path.join(scene_dir, 'rgb', f'{i}.png'),
                  (rgb * 255).astype(np.uint8))
        write_png(os.path.join(scene_dir, 'depth', f'{i}.png'),
                  (z * 1000).astype(np.uint16))
        np.savetxt(os.path.join(scene_dir, 'pose', f'{i}.txt'), T_CW)
        if i % label_every == 0:
            write_png(os.path.join(scene_dir, 'semantic', f'{i}.png'),
                      semantic)
        if annotate:
            write_png(os.path.join(scene_dir, 'gt_semantic', f'{i}.png'),
                      semantic)
            outline = sphere_outline(T_WC, camera_matrix, np.zeros(3),
                                     SPHERE_RADIUS)
            if i % label_every == 0 and outline is not None:
                write_gt_mask(scene_dir, i, outline, width, height,
                              'sphere')
    if mesh_points:
        rng = np.random.default_rng(0)
        write_mesh(scene_dir, sphere_points(rng, mesh_points, np.zeros(3),
                                            SPHERE_RADIUS),
                   np.full(mesh_points, 2))
    return scene_dir


# -- the room (tests/room.py) ----------------------------------------------------

ROOM_MIN = np.array([-1.5, -1.5, 0.0])
ROOM_MAX = np.array([1.5, 1.5, 2.4])
LIGHT = np.array([0.3, -0.5, 0.8]) / np.linalg.norm([0.3, -0.5, 0.8])

SPHERES = [  # center, radius, color, class
    (np.array([0.7, 0.4, 0.45]), 0.45, np.array([0.85, 0.2, 0.15]), 2),
    (np.array([-0.2, -0.9, 0.3]), 0.3, np.array([0.2, 0.3, 0.85]), 4),
]
BOXES = [  # min, max, color, class
    (np.array([-1.1, -0.2, 0.0]), np.array([-0.3, 0.6, 0.9]),
     np.array([0.2, 0.7, 0.25]), 3),
    (np.array([0.2, -1.2, 0.0]), np.array([0.6, -0.8, 1.6]),
     np.array([0.85, 0.8, 0.2]), 5),
]
N_CLASSES = 5


def _wall_color(points):
    """Checkerboard + per-wall tint, evaluated at wall hit points."""
    checker = (np.floor(points[:, 0] / 0.3) + np.floor(points[:, 1] / 0.3) +
               np.floor(points[:, 2] / 0.3)) % 2
    # Tint by dominant axis of the hit position (which wall).
    rel = (points - (ROOM_MIN + ROOM_MAX) / 2) / (ROOM_MAX - ROOM_MIN)
    axis = np.argmax(np.abs(rel), axis=1)
    palette = np.array([[0.75, 0.65, 0.6], [0.6, 0.7, 0.75],
                        [0.72, 0.72, 0.66]])
    base = palette[axis]
    shade = np.where(checker[:, None] > 0, 1.0, 0.72)
    return base * shade


def _intersect_sphere(o, d, center, radius):
    oc = o - center
    b = (oc * d).sum(axis=1)
    c = (oc * oc).sum(axis=1) - radius ** 2
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    t = np.where(hit & (t > 1e-4), t, np.inf)
    return t


def _intersect_box_outside(o, d, bmin, bmax):
    """Near intersection with a solid box (from outside)."""
    inv = 1.0 / np.where(np.abs(d) < 1e-9, 1e-9, d)
    t0 = (bmin - o) * inv
    t1 = (bmax - o) * inv
    tnear = np.minimum(t0, t1).max(axis=1)
    tfar = np.maximum(t0, t1).min(axis=1)
    hit = (tnear < tfar) & (tfar > 0) & (tnear > 1e-4)
    return np.where(hit, tnear, np.inf)


def _exit_room(o, d):
    """Far intersection with the room interior (rays start inside)."""
    inv = 1.0 / np.where(np.abs(d) < 1e-9, 1e-9, d)
    t0 = (ROOM_MIN - o) * inv
    t1 = (ROOM_MAX - o) * inv
    return np.maximum(t0, t1).min(axis=1)


def _normal_sphere(points, center):
    n = points - center
    return n / np.linalg.norm(n, axis=1, keepdims=True)


def _normal_box(points, bmin, bmax):
    rel = (points - (bmin + bmax) / 2) / (bmax - bmin)
    axis = np.argmax(np.abs(rel), axis=1)
    normal = np.zeros_like(points)
    normal[np.arange(len(points)), axis] = np.sign(
        rel[np.arange(len(points)), axis])
    return normal


def render_room_frame(T_WC, camera_matrix, width, height):
    fx, fy = camera_matrix[0, 0], camera_matrix[1, 1]
    cx, cy = camera_matrix[0, 2], camera_matrix[1, 2]
    xs, ys = np.meshgrid(np.arange(width) + 0.5, np.arange(height) + 0.5)
    dirs_c = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)],
                      axis=-1).reshape(-1, 3)
    z_norm = np.linalg.norm(dirs_c, axis=1)
    rotation, origin = T_WC[:3, :3], T_WC[:3, 3]
    d = (dirs_c / z_norm[:, None]) @ rotation.T
    o = np.broadcast_to(origin, d.shape)

    best_t = _exit_room(o, d)
    color = _wall_color(o + best_t[:, None] * d)
    semantic = np.full(len(d), 1, np.uint8)
    normal = np.zeros_like(d)  # walls shaded flat

    for center, radius, obj_color, cls in SPHERES:
        t = _intersect_sphere(o, d, center, radius)
        closer = t < best_t
        best_t = np.where(closer, t, best_t)
        if closer.any():
            pts = o[closer] + t[closer, None] * d[closer]
            normal[closer] = _normal_sphere(pts, center)
            color[closer] = obj_color
            semantic[closer] = cls
    for bmin, bmax, obj_color, cls in BOXES:
        t = _intersect_box_outside(o, d, bmin, bmax)
        closer = t < best_t
        best_t = np.where(closer, t, best_t)
        if closer.any():
            pts = o[closer] + t[closer, None] * d[closer]
            normal[closer] = _normal_box(pts, bmin, bmax)
            color[closer] = obj_color
            semantic[closer] = cls

    lambert = np.clip((normal * LIGHT).sum(axis=1), 0.0, 1.0)
    shaded = color * (0.55 + 0.45 * lambert)[:, None]
    is_wall = semantic == 1
    shaded[is_wall] = color[is_wall] * 0.9

    rgb = shaded.reshape(height, width, 3)
    # z-depth (camera z): ray distance / |(u, v, 1)| — the convention the
    # depth PNGs use throughout (tests/synthetic.py, dataset loader).
    depth = (best_t / z_norm).reshape(height, width)
    sem = semantic.reshape(height, width)
    return np.clip(rgb, 0, 1), depth, sem


def make_room_scene(scene_dir, n_frames=96, width=160, height=120,
                    label_every=4, annotate=False, mesh_points=0):
    """annotate: also gt_masks/, the red ball's outline (class 2, not cut
    by what occludes it) every 2 label_every frames where the ball lies
    wholly in front of the camera; mesh_points: that many points on the
    two balls' and two boxes' surfaces, a quarter each, with their
    classes."""
    os.makedirs(scene_dir, exist_ok=True)
    subs = ('rgb', 'depth', 'pose', 'semantic', 'gt_semantic')
    if annotate:
        subs += ('gt_masks',)
    for sub in subs:
        os.makedirs(os.path.join(scene_dir, sub), exist_ok=True)

    focal = 0.75 * width
    camera_matrix = np.array([[focal, 0, width / 2.0],
                              [0, focal, height / 2.0], [0, 0, 1.0]])
    np.savetxt(os.path.join(scene_dir, 'intrinsics.txt'), camera_matrix)
    margin = 0.25
    np.savetxt(
        os.path.join(scene_dir, 'bbox.txt'),
        np.concatenate([ROOM_MIN - margin, ROOM_MAX + margin]))
    with open(os.path.join(scene_dir, 'metadata.json'), 'w') as f:
        json.dump({'n_classes': N_CLASSES}, f)

    for i in range(n_frames):
        angle = 2 * np.pi * i / n_frames
        height_wobble = 0.9 + 0.35 * np.sin(3 * angle)
        position = np.array([0.95 * np.cos(angle), 0.95 * np.sin(angle),
                             height_wobble])
        # Look through the center toward the far side of the room.
        target = np.array([-0.9 * np.cos(angle), -0.9 * np.sin(angle), 0.8])
        T_WC = look_at_cv(position, target)
        rgb, depth, semantic = render_room_frame(T_WC, camera_matrix,
                                                 width, height)
        write_png(os.path.join(scene_dir, 'rgb', f'{i}.png'),
                  (rgb * 255).astype(np.uint8))
        write_png(os.path.join(scene_dir, 'depth', f'{i}.png'),
                  (depth * 1000).astype(np.uint16))
        np.savetxt(os.path.join(scene_dir, 'pose', f'{i}.txt'),
                   np.linalg.inv(T_WC))
        write_png(os.path.join(scene_dir, 'gt_semantic', f'{i}.png'),
                  semantic)
        if i % label_every == 0:
            write_png(os.path.join(scene_dir, 'semantic', f'{i}.png'),
                      semantic)
        center, radius, _, _ = SPHERES[0]
        outline = sphere_outline(T_WC, camera_matrix, center, radius)
        if annotate and i % (2 * label_every) == 0 and outline is not None:
            write_gt_mask(scene_dir, i, outline, width, height, 'red ball')
    if mesh_points:
        rng = np.random.default_rng(0)
        counts = np.diff(np.linspace(0, mesh_points, 5).astype(int))
        points, labels = [], []
        for (center, radius, _, cls), n in zip(SPHERES, counts[:2]):
            points.append(sphere_points(rng, n, center, radius))
            labels.append(np.full(n, cls))
        for (bmin, bmax, _, cls), n in zip(BOXES, counts[2:]):
            points.append(box_points(rng, n, bmin, bmax))
            labels.append(np.full(n, cls))
        write_mesh(scene_dir, np.concatenate(points),
                   np.concatenate(labels))
    return scene_dir


if __name__ == '__main__':
    # python -m autolabel_tpu_torch.utils.fixtures {sphere,room} <scene dir>
    import sys
    kind, out = sys.argv[1], sys.argv[2]
    {'sphere': make_synthetic_scene, 'room': make_room_scene}[kind](
        out, annotate=True, mesh_points=65536)
    print('wrote', out)
