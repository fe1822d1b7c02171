"""Minimal COLMAP text-model reader/writer (cameras/images/points3D.txt).

Counterpart of autolabel_tpu/utils/colmap_text.py, kept as the port's own
copy. The mapping CLI's post-reconstruction stages (scale estimation, pose
saving) read a COLMAP reconstruction: through pycolmap where it is
installed, else through this pure-python parser of COLMAP's documented
text export, which covers the slice of the API those stages touch:
`images.values()` with `.name/.rotmat()/.tvec/.get_valid_points2D()`,
`points3D[id].xyz`, `cameras[id].params`. Files written by either package
read back equal in the other.

Format reference: colmap.github.io/format.html#text-format.
"""
import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class ColmapPoint2D:
    xy: np.ndarray
    point3D_id: int


@dataclasses.dataclass
class ColmapPoint3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float


class ColmapImage:
    """One registered image: quaternion/translation of T_CW + keypoints."""

    def __init__(self, image_id, qvec, tvec, camera_id, name, points2D):
        self.image_id = image_id
        self.qvec = np.asarray(qvec, np.float64)
        self.tvec = np.asarray(tvec, np.float64)
        self.camera_id = camera_id
        self.name = name
        self.points2D = points2D

    def rotmat(self):
        """World->camera rotation from the COLMAP (w, x, y, z) quaternion."""
        w, x, y, z = self.qvec
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
             2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
             2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x),
             1 - 2 * (x * x + y * y)],
        ])

    def get_valid_points2D(self):
        return [p for p in self.points2D if p.point3D_id != -1]


class ColmapTextModel:
    """Duck-types the pycolmap.Reconstruction slice mapping.py uses."""

    def __init__(self, model_dir):
        self.cameras = {}
        self.images = {}
        self.points3D = {}
        self._read_cameras(os.path.join(model_dir, 'cameras.txt'))
        self._read_images(os.path.join(model_dir, 'images.txt'))
        self._read_points(os.path.join(model_dir, 'points3D.txt'))

    @staticmethod
    def _data_lines(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line and not line.startswith('#'):
                    yield line

    def _read_cameras(self, path):
        for line in self._data_lines(path):
            parts = line.split()
            cid = int(parts[0])
            self.cameras[cid] = ColmapCamera(
                camera_id=cid, model=parts[1], width=int(parts[2]),
                height=int(parts[3]),
                params=np.array([float(v) for v in parts[4:]]))

    def _read_images(self, path):
        # Images come in line pairs: header, then the keypoint triplets.
        # The body line may legitimately be EMPTY (an image with no
        # keypoints), so only comment lines are dropped here — dropping
        # blank lines would desynchronize the header/body pairing.
        with open(path) as f:
            lines = [ln.strip() for ln in f
                     if not ln.lstrip().startswith('#')]
        while lines and not lines[-1]:
            lines.pop()
        for header, body in zip(lines[0::2], lines[1::2]):
            parts = header.split()
            image_id = int(parts[0])
            qvec = [float(v) for v in parts[1:5]]
            tvec = [float(v) for v in parts[5:8]]
            camera_id = int(parts[8])
            name = parts[9]
            values = body.split()
            points2D = [
                ColmapPoint2D(
                    xy=np.array([float(values[i]), float(values[i + 1])]),
                    point3D_id=int(values[i + 2]))
                for i in range(0, len(values), 3)
            ]
            self.images[image_id] = ColmapImage(image_id, qvec, tvec,
                                                camera_id, name, points2D)

    def _read_points(self, path):
        for line in self._data_lines(path):
            parts = line.split()
            pid = int(parts[0])
            self.points3D[pid] = ColmapPoint3D(
                id=pid,
                xyz=np.array([float(v) for v in parts[1:4]]),
                rgb=np.array([int(v) for v in parts[4:7]]),
                error=float(parts[7]))


def load_reconstruction(model_dir):
    """pycolmap.Reconstruction when available, text parser otherwise."""
    try:
        import pycolmap
        return pycolmap.Reconstruction(model_dir)
    except ImportError:
        return ColmapTextModel(model_dir)


def write_text_model(model_dir, camera, images, points3D):
    """Write a COLMAP text model (the fixture generator for tests).

    camera: ColmapCamera; images: iterable of ColmapImage;
    points3D: {id: ColmapPoint3D}.
    """
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, 'cameras.txt'), 'w') as f:
        f.write('# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n')
        params = ' '.join(str(v) for v in camera.params)
        f.write(f'{camera.camera_id} {camera.model} {camera.width} '
                f'{camera.height} {params}\n')
    with open(os.path.join(model_dir, 'images.txt'), 'w') as f:
        f.write('# Image list: IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID '
                'NAME / POINTS2D as (X Y POINT3D_ID)\n')
        for image in images:
            q = ' '.join(repr(float(v)) for v in image.qvec)
            t = ' '.join(repr(float(v)) for v in image.tvec)
            f.write(f'{image.image_id} {q} {t} {image.camera_id} '
                    f'{image.name}\n')
            f.write(' '.join(
                f'{float(p.xy[0])!r} {float(p.xy[1])!r} {p.point3D_id}'
                for p in image.points2D) + '\n')
    with open(os.path.join(model_dir, 'points3D.txt'), 'w') as f:
        f.write('# 3D point list: POINT3D_ID X Y Z R G B ERROR TRACK[]\n')
        for point in points3D.values():
            xyz = ' '.join(repr(float(v)) for v in point.xyz)
            rgb = ' '.join(str(int(v)) for v in point.rgb)
            f.write(f'{point.id} {xyz} {rgb} {point.error}\n')


def rotmat_to_qvec(R):
    """Rotation matrix -> COLMAP (w, x, y, z) quaternion."""
    t = np.trace(R)
    if t > 0:
        w = np.sqrt(1.0 + t) / 2.0
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2
        q = np.zeros(4)
        q[1 + i] = s / 4
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
        w, x, y, z = q
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)
