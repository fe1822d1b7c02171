"""Pinhole rectification for rgb + depth frames.

Counterpart of autolabel_tpu/undistort.py (cv2 initUndistortRectifyMap +
remap, OPENCV model k1 k2 p1 p2). cv2 is imported when an undistorter is
made: without it the constructor raises utils.MissingDependency (an
ImportError) naming cv2.
"""
import numpy as np

from autolabel_tpu_torch.utils import require


class ImageUndistorter:

    def __init__(self, camera_matrix, distortion_coefficients, size):
        cv2 = require('cv2', 'ImageUndistorter')
        self._cv2 = cv2
        self.K = np.asarray(camera_matrix)
        self.D = np.asarray(distortion_coefficients)
        self.size = tuple(size)
        # Remap onto the original K: intrinsics.txt written by the mapping
        # stage then stays valid for the rectified pixels (a new camera
        # matrix here would change the effective intrinsics of rgb and
        # depth while ray generation and ScaleEstimation keep reading the
        # SfM K).
        self.new_K = self.K.copy()
        self.map_x, self.map_y = cv2.initUndistortRectifyMap(
            self.K, self.D, None, self.new_K, self.size, cv2.CV_32FC1)

    def undistort(self, image, depth=False):
        cv2 = self._cv2
        interpolation = cv2.INTER_NEAREST if depth else cv2.INTER_LINEAR
        return cv2.remap(image, self.map_x, self.map_y, interpolation)
