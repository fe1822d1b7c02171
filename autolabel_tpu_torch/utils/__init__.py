"""Scene-directory contract: readers for the autolabel scene layout.

Counterpart of autolabel_tpu/utils/__init__.py (Camera, Scene,
transform_points), kept as the port's own copy. A scene directory
contains::

    raw_rgb/ rgb/ raw_depth/ depth/ pose/*.txt (T_CW 4x4) semantic/
    gt_masks/ gt_semantic/ intrinsics.txt bbox.txt metadata.json
    features.hdf nerf/<model-hash>/{params.pkl, checkpoints/*.pth}

Image sizes come from utils.images (a PNG's header; PIL for other files)
in place of cv2, and labelme polygons are filled by utils.raster.fill_poly,
bit-equal to cv2.fillPoly.
"""
import importlib
import json
import os

import numpy as np

from autolabel_tpu_torch.utils import images
from autolabel_tpu_torch.utils.raster import fill_poly


class MissingDependency(ImportError, RuntimeError):
    """A package the port does not depend on is needed and not installed.
    An ImportError, as the JAX package's module-level import raises, and a
    RuntimeError."""


def require(module, what):
    """Import `module` at the call, or raise MissingDependency naming it
    and what needs it (for the packages the port does not depend on: cv2,
    PIL, pandas, h5py, matplotlib, sklearn)."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise MissingDependency(f'{what} needs {module}, which is not '
                                'installed') from e


def _numeric_sorted(names):
    """Sort filenames by their integer stem ('12.png' -> 12)."""
    return sorted(names, key=lambda n: int(os.path.basename(n).split('.')[0]))


class Camera:
    """Pinhole camera: 3x3 camera matrix + (width, height) image size."""

    def __init__(self, camera_matrix, size):
        self.camera_matrix = np.asarray(camera_matrix, dtype=np.float64)
        self.size = tuple(size)

    fx = property(lambda self: self.camera_matrix[0, 0])
    fy = property(lambda self: self.camera_matrix[1, 1])
    cx = property(lambda self: self.camera_matrix[0, 2])
    cy = property(lambda self: self.camera_matrix[1, 2])

    def scale(self, new_size):
        """Return a camera rescaled to a new (width, height)."""
        m = self.camera_matrix.copy()
        m[0, :] *= new_size[0] / self.size[0]
        m[1, :] *= new_size[1] / self.size[1]
        return Camera(m, new_size)

    @classmethod
    def from_path(cls, path, size):
        return cls(np.loadtxt(path), size)

    def write(self, path):
        np.savetxt(path, self.camera_matrix)


class Scene:
    """Reader for one scene directory (see module docstring)."""

    def __init__(self, scene_path):
        self.path = scene_path
        sub = lambda name: os.path.join(scene_path, name)
        self.rgb_path = sub('rgb')
        self.raw_rgb_path = sub('raw_rgb')
        self.depth_path = sub('depth')
        self.raw_depth_path = sub('raw_depth')
        self.pose_path = sub('pose')
        self.poses = self._read_poses()
        self._metadata = None
        if os.path.exists(sub('intrinsics.txt')):
            self.camera = Camera.from_path(sub('intrinsics.txt'),
                                           self.peak_image_size())

    def _read_poses(self):
        """Read pose/*.txt world-to-camera (T_CW) matrices in numeric
        order; records the frame stems in self.pose_frames so consumers
        can pair poses with images BY NAME (an SfM front-end may fail to
        register some frames, leaving holes in the pose sequence)."""
        self.pose_frames = []
        if not os.path.exists(self.pose_path):
            return []
        files = _numeric_sorted(f for f in os.listdir(self.pose_path)
                                if not f.startswith('.'))
        self.pose_frames = [f.split('.')[0] for f in files]
        return [np.loadtxt(os.path.join(self.pose_path, f)) for f in files]

    def _get_paths(self, directory):
        return [os.path.join(directory, f)
                for f in _numeric_sorted(os.listdir(directory))]

    # Frame-path accessors (names are the cross-repo API surface).
    def rgb_paths(self):
        return self._get_paths(self.rgb_path)

    def depth_paths(self):
        return self._get_paths(self.depth_path)

    def raw_rgb_paths(self):
        return self._get_paths(self.raw_rgb_path)

    def raw_depth_paths(self):
        return self._get_paths(self.raw_depth_path)

    def semantic_paths(self):
        return self._get_paths(os.path.join(self.path, 'semantic'))

    def gt_semantic(self):
        return self._get_paths(os.path.join(self.path, 'gt_semantic'))

    def __iter__(self):
        return iter(zip(self.poses, self.rgb_paths(), self.depth_paths()))

    def __len__(self):
        return len(self.poses)

    def image_names(self):
        """Rgb image filenames without extensions, numerically sorted."""
        return [os.path.basename(p).split('.')[0]
                for p in self.rgb_paths()]

    def peak_image_size(self):
        """(width, height) of the raw rgb frames (or rgb if no raw)."""
        for path in (self.raw_rgb_path, self.rgb_path):
            if os.path.exists(path):
                return images.image_size(
                    os.path.join(path, os.listdir(path)[0]))
        raise ValueError("Doesn't appear to be a valid scene.")

    def depth_size(self):
        """(width, height) of the depth frames."""
        paths = (self.raw_depth_paths()
                 if os.path.exists(self.raw_depth_path)
                 else self.depth_paths())
        return images.image_size(paths[0])

    def bbox(self):
        """Axis-aligned scene bounds: (2, 3) [min; max] from bbox.txt."""
        return np.loadtxt(os.path.join(self.path, 'bbox.txt'))[:6].reshape(2, 3)

    def gt_masks(self, size):
        """Labelme-annotated GT masks as (frame_number, HxW array) pairs."""
        gt_dir = os.path.join(self.path, 'gt_masks')
        if not os.path.exists(gt_dir):
            return []
        masks = [(int(f.split('.')[0]),
                  _read_gt_mask(os.path.join(gt_dir, f), size))
                 for f in os.listdir(gt_dir)]
        return sorted(masks, key=lambda m: m[0])

    @property
    def metadata(self):
        if self._metadata is None:
            path = os.path.join(self.path, 'metadata.json')
            if not os.path.exists(path):
                return None
            with open(path) as f:
                self._metadata = json.load(f)
        return self._metadata

    @property
    def n_classes(self):
        meta = self.metadata
        return meta['n_classes'] if meta else None


def transform_points(T, points):
    """Apply a 4x4 rigid transform to (..., 3) points."""
    return points @ T[:3, :3].T + T[:3, 3]


def _read_gt_mask(path, size):
    """Rasterize a labelme polygon annotation JSON into a (h, w) uint8 mask
    (every polygon filled with 1, as cv2.fillPoly does in the JAX
    package)."""
    with open(path, 'rt') as f:
        data = json.load(f)
    mask = np.zeros((size[1], size[0]), dtype=np.uint8)
    scaling = np.array(
        [size[0] / data['imageWidth'], size[1] / data['imageHeight']])
    for shape in data['shapes']:
        polygon = (np.stack(shape['points']) * scaling).astype(np.int32)
        fill_poly(mask, polygon, 1)
    return mask

