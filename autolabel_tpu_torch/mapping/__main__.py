"""The mapping CLI: poses + metric scale + scene bounds from raw images.

    python -m autolabel_tpu_torch.mapping <scene> [--backend auto|hloc|cv2]
        [--features klt|sift|orb] [--debug] [--vis]

Counterpart of scripts/mapping.py, flag for flag:
  1. SfM backend (--backend):
     - HLoc: SuperPoint features + SuperGlue matches (+ NetVLAD retrieval
       for >= 250 frames) -> COLMAP reconstruction with an OPENCV camera
       and intrinsics refinement; writes intrinsics/distortion and
       undistorts rgb + depth. Needs the hloc + pycolmap stack
       (import-gated).
     - CV2Mapping (built in): KLT/SIFT front end + incremental SfM +
       bundle adjustment (autolabel_tpu_torch.mapping, K9 on the card)
       producing the same COLMAP-convention model; picked automatically
       when hloc is absent.
  2. ScaleEstimation: per-track ratio of sensor depth to SfM depth,
     1-point RANSAC with a median-relative threshold -> metric scale.
  3. PoseSaver: OBB-aligned, recentered AABB from depth point clouds ->
     pose/*.txt + bbox.txt (numpy PCA for open3d's oriented bbox).

Both SfM backends and the undistortion need cv2; where it is not
installed they raise utils.MissingDependency (an ImportError) naming it.
ScaleEstimation and PoseSaver read the depth PNGs with
utils.images.read_png and need no cv2. `main(argv, device=None)`: bundle
adjustment runs on the card unless device='cpu'.
"""
import argparse
import os
import shutil
import tempfile
from pathlib import Path

import numpy as np

from autolabel_tpu_torch.device import resolve_device
from autolabel_tpu_torch.undistort import ImageUndistorter
from autolabel_tpu_torch.utils import (Camera, Scene, require,
                                       transform_points)
from autolabel_tpu_torch.utils.images import read_png


def read_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('scene', help="Scene to infer poses for.")
    parser.add_argument('--debug', action='store_true')
    parser.add_argument('--vis', action='store_true')
    parser.add_argument('--backend', default='auto',
                        choices=['auto', 'hloc', 'cv2'],
                        help="SfM front-end: hloc (SuperPoint/SuperGlue/"
                        "COLMAP, needs the hloc stack) or cv2 (built-in "
                        "KLT/SIFT + bundle adjustment, "
                        "autolabel_tpu_torch.mapping). auto picks hloc when "
                        "importable, cv2 otherwise.")
    parser.add_argument('--features', default='klt',
                        choices=['klt', 'sift', 'orb'],
                        help="cv2 backend front-end: klt tracking for "
                        "video-like captures (default), descriptor "
                        "matching for sparse ones.")
    return parser.parse_args(argv)


class HLoc:
    """SuperPoint + SuperGlue + COLMAP mapping (needs hloc/pycolmap)."""

    def __init__(self, tmp_dir, scene, flags):
        try:
            import pycolmap  # noqa: F401
            from hloc import (extract_features, match_features,  # noqa: F401
                              pairs_from_exhaustive, pairs_from_retrieval,
                              reconstruction)
        except ImportError as e:
            raise ImportError(
                "autolabel_tpu_torch.mapping requires the hloc + pycolmap "
                "stack for structure-from-motion; install hloc "
                "(github.com/cvg/Hierarchical-Localization) to use it."
            ) from e
        self._pycolmap = pycolmap
        self._hloc = dict(extract_features=extract_features,
                          match_features=match_features,
                          reconstruction=reconstruction,
                          pairs_from_exhaustive=pairs_from_exhaustive,
                          pairs_from_retrieval=pairs_from_retrieval)
        self.flags = flags
        self.scene = scene
        self.scene_path = Path(scene.path)
        self.exhaustive = len(scene.raw_rgb_paths()) < 250
        self.tmp_dir = Path(tmp_dir)
        self.sfm_pairs = self.tmp_dir / 'sfm-pairs.txt'
        self.features = self.tmp_dir / 'features.h5'
        self.matches = self.tmp_dir / 'matches.h5'
        self.feature_conf = extract_features.confs['superpoint_aachen']
        self.retrieval_conf = extract_features.confs['netvlad']
        self.matcher_conf = match_features.confs['superglue']

    def _run_sfm(self):
        h = self._hloc
        pycolmap = self._pycolmap
        image_dir = self.scene_path / 'raw_rgb'
        image_list_path = [
            str(Path(p).relative_to(image_dir))
            for p in self.scene.raw_rgb_paths()
        ]
        mapper_options = {
            'ba_refine_principal_point': True,
            'ba_refine_extra_params': True,
            'ba_refine_focal_length': True,
        }
        if self.exhaustive:
            h['extract_features'].main(self.feature_conf,
                                       image_dir,
                                       feature_path=self.features,
                                       image_list=image_list_path)
            h['pairs_from_exhaustive'].main(self.sfm_pairs,
                                            image_list=image_list_path)
            h['match_features'].main(self.matcher_conf,
                                     self.sfm_pairs,
                                     features=self.features,
                                     matches=self.matches)
            feature_path, match_path = self.features, self.matches
        else:
            retrieval_path = h['extract_features'].main(
                self.retrieval_conf, image_dir, self.tmp_dir,
                image_list=image_list_path)
            h['pairs_from_retrieval'].main(retrieval_path, self.sfm_pairs,
                                           num_matched=50)
            feature_path = h['extract_features'].main(
                self.feature_conf, image_dir, self.tmp_dir,
                image_list=image_list_path)
            match_path = h['match_features'].main(
                self.matcher_conf, self.sfm_pairs,
                self.feature_conf['output'], self.tmp_dir,
                matches=self.matches)
        model = h['reconstruction'].main(
            self.tmp_dir,
            image_dir,
            self.sfm_pairs,
            feature_path,
            match_path,
            image_list=image_list_path,
            camera_mode=pycolmap.CameraMode.SINGLE,
            image_options={'camera_model': "OPENCV"},
            mapper_options=mapper_options)

        if self.flags.debug:
            colmap_output_dir = os.path.join(self.scene.path,
                                             'colmap_output')
            os.makedirs(colmap_output_dir, exist_ok=True)
            model.write_text(colmap_output_dir)

        assert len(model.cameras) == 1 and 1 in model.cameras
        (fx, fy, cx, cy, k1, k2, p1, p2) = model.cameras[1].params
        self.colmap_K = np.eye(3)
        self.colmap_K[0, 0] = fx
        self.colmap_K[1, 1] = fy
        self.colmap_K[0, 2] = cx
        self.colmap_K[1, 2] = cy
        self.colmap_distortion_params = np.array([k1, k2, p1, p2])
        np.savetxt(os.path.join(self.scene.path, 'intrinsics.txt'),
                   self.colmap_K)
        np.savetxt(os.path.join(self.scene.path,
                                'distortion_parameters.txt'),
                   self.colmap_distortion_params)

    def run(self):
        self._run_sfm()
        undistort_scene(self.scene, self.colmap_K,
                        self.colmap_distortion_params)


def undistort_scene(scene, K, distortion_params):
    """Rectify raw_rgb/raw_depth into rgb/depth with the SfM-estimated
    OPENCV intrinsics (the HLoc backend's post-reconstruction stage). The
    depth undistorter runs at the depth stream's own resolution via a
    scaled camera."""
    cv2 = require('cv2', 'undistort_scene')
    print("Undistorting images according to the estimated intrinsics...")
    rgb_out = os.path.join(scene.path, "rgb")
    depth_out = os.path.join(scene.path, "depth")
    os.makedirs(rgb_out, exist_ok=True)
    os.makedirs(depth_out, exist_ok=True)

    color_undistorter = ImageUndistorter(K, distortion_params,
                                         scene.camera.size)
    depth_camera = Camera(K, scene.camera.size).scale(scene.depth_size())
    depth_undistorter = ImageUndistorter(depth_camera.camera_matrix,
                                         distortion_params,
                                         depth_camera.size)

    for image_path in scene.raw_rgb_paths():
        image = cv2.imread(image_path, cv2.IMREAD_UNCHANGED)
        cv2.imwrite(os.path.join(rgb_out, os.path.basename(image_path)),
                    color_undistorter.undistort(image))
    for depth_path in scene.raw_depth_paths():
        depth = cv2.imread(depth_path, cv2.IMREAD_UNCHANGED)
        cv2.imwrite(os.path.join(depth_out, os.path.basename(depth_path)),
                    depth_undistorter.undistort(depth, depth=True))


class CV2Mapping:
    """Built-in SfM: KLT/SIFT front-end + bundle adjustment
    (autolabel_tpu_torch.mapping). Same contract as HLoc: writes
    intrinsics.txt / distortion_parameters.txt, a COLMAP text model into
    tmp_dir for the downstream stages, and the undistorted rgb/depth
    directories (this backend models a zero-distortion pinhole, so
    "undistortion" is a copy when raw directories exist)."""

    def __init__(self, tmp_dir, scene, flags, device=None):
        self.tmp_dir = Path(tmp_dir)
        self.scene = scene
        self.flags = flags
        self.device = device

    def _image_paths(self):
        if os.path.exists(self.scene.raw_rgb_path):
            return self.scene.raw_rgb_paths()
        return self.scene.rgb_paths()

    def _initial_K(self, size):
        intrinsics = os.path.join(self.scene.path, 'intrinsics.txt')
        if os.path.exists(intrinsics):
            return np.loadtxt(intrinsics)[:3, :3], False
        w, h = size
        # Standard SfM prior: focal ~ 1.2 * the larger image dimension,
        # refined by bundle adjustment.
        f = 1.2 * max(w, h)
        return np.array([[f, 0, w / 2.0], [0, f, h / 2.0],
                         [0, 0, 1.0]]), True

    def run(self):
        from autolabel_tpu_torch.mapping import IncrementalSfM
        cv2 = require('cv2', 'the cv2 mapping backend')
        paths = self._image_paths()
        images = [(os.path.basename(p),
                   cv2.imread(p, cv2.IMREAD_GRAYSCALE)) for p in paths]
        size = (images[0][1].shape[1], images[0][1].shape[0])
        K, refine_focal = self._initial_K(size)
        sfm = IncrementalSfM(images, K, detector=self.flags.features,
                             device=self.device)
        sfm.run(refine_focal=refine_focal, verbose=True)
        n = len(sfm.registered)
        if n < max(2, len(images) // 2):
            raise RuntimeError(
                f"cv2 SfM registered only {n}/{len(images)} frames; "
                "the capture may lack texture or overlap (try --backend "
                "hloc on a machine with the hloc stack).")
        sfm.write_colmap_model(str(self.tmp_dir))
        np.savetxt(os.path.join(self.scene.path, 'intrinsics.txt'), sfm.K)
        np.savetxt(os.path.join(self.scene.path,
                                'distortion_parameters.txt'), np.zeros(4))
        self._copy_raw()

    def _copy_raw(self):
        for raw_dir, out_name in ((self.scene.raw_rgb_path, 'rgb'),
                                  (self.scene.raw_depth_path, 'depth')):
            if not os.path.exists(raw_dir):
                continue
            out = os.path.join(self.scene.path, out_name)
            os.makedirs(out, exist_ok=True)
            for p in sorted(os.listdir(raw_dir)):
                shutil.copy(os.path.join(raw_dir, p), os.path.join(out, p))


def ransac_scale(scales, iterations=10000, seed=None):
    """1-point RANSAC over per-track scale ratios with a median-relative
    inlier threshold; returns the mean of the best inlier set."""
    rng = np.random.default_rng(seed)
    indices = np.arange(scales.shape[0])
    inlier_threshold = np.median(scales) * 1e-2
    best_set = None
    best_inlier_count = 0
    for _ in range(iterations):
        estimate = scales[rng.choice(indices)]
        inliers = np.abs(scales - estimate) < inlier_threshold
        count = inliers.sum()
        if count > best_inlier_count:
            best_set = scales[inliers]
            best_inlier_count = count
    print(f"Scale estimation inlier count: {best_inlier_count} / "
          f"{scales.size}")
    return float(np.mean(best_set))


class ScaleEstimation:
    """Metric scale: sensor depth vs SfM depth per reconstruction track."""

    min_depth = 0.05

    def __init__(self, scene, colmap_dir):
        # pycolmap when installed; otherwise the pure-python COLMAP
        # text-model parser.
        from autolabel_tpu_torch.utils.colmap_text import load_reconstruction
        self.scene = scene
        self.reconstruction = load_reconstruction(colmap_dir)
        self._read_trajectory()
        self._read_depth_maps()

    def _read_depth_maps(self):
        self.depth_maps = {}
        for path in self.scene.depth_paths():
            frame_name = os.path.basename(path).split('.')[0]
            self.depth_maps[frame_name] = read_png(path) / 1000.0
        depth_shape = next(iter(self.depth_maps.values())).shape
        depth_size = np.array([depth_shape[1], depth_shape[0]], np.float64)
        self.depth_to_color_ratio = depth_size / np.array(
            self.scene.camera.size, np.float64)

    def _read_trajectory(self):
        self.poses = {}
        for image in self.reconstruction.images.values():
            T_CW = np.eye(4)
            T_CW[:3, :3] = image.rotmat()
            T_CW[:3, 3] = image.tvec
            self.poses[image.name.split('.')[0]] = T_CW

    def _lookup_depth(self, frame, xy):
        xy_depth = np.floor(self.depth_to_color_ratio * xy).astype(int)
        return self.depth_maps[frame][xy_depth[1], xy_depth[0]]

    def _estimate_scale(self):
        point_depths, measured_depths = [], []
        points3D = self.reconstruction.points3D
        for image in self.reconstruction.images.values():
            frame_name = image.name.split('.')[0]
            for point in image.get_valid_points2D():
                depth_map_value = self._lookup_depth(frame_name, point.xy)
                if depth_map_value < self.min_depth:
                    continue
                T_CW = self.poses[frame_name]
                p_C = transform_points(T_CW,
                                       points3D[point.point3D_id].xyz)
                measured_depths.append(depth_map_value)
                point_depths.append(p_C[2])
        scales = np.stack(measured_depths) / np.stack(point_depths)
        return ransac_scale(scales)

    def _scale_poses(self, ratio):
        scaled = {}
        for key, pose in self.poses.items():
            new_pose = pose.copy()
            new_pose[:3, 3] *= ratio
            scaled[key] = new_pose
        return scaled

    def run(self):
        return self._scale_poses(self._estimate_scale())


def oriented_bounding_frame(points):
    """PCA-based oriented bounding box: returns the 4x4 transform into the
    box frame and the centered (2, 3) AABB in that frame (stands in for
    open3d's get_oriented_bounding_box)."""
    mean = points.mean(axis=0)
    centered = points - mean
    cov = centered.T @ centered / max(len(points) - 1, 1)
    _, vectors = np.linalg.eigh(cov)
    R = vectors[:, ::-1]  # principal axes, largest first
    if np.linalg.det(R) < 0:
        R[:, -1] *= -1
    aligned = centered @ R
    lo, hi = aligned.min(axis=0), aligned.max(axis=0)
    center_aligned = (lo + hi) / 2.0

    T = np.eye(4)
    T[:3, :3] = R.T
    T[:3, 3] = -(R.T @ mean) - center_aligned
    aabb = np.stack([lo - center_aligned, hi - center_aligned])
    return T, aabb


class PoseSaver:
    """Write metrically-scaled poses in an OBB-aligned recentered frame."""

    def __init__(self, scene, scaled_poses):
        self.scene = scene
        self.poses = scaled_poses

    def compute_bbox(self, poses):
        depth0 = read_png(self.scene.depth_paths()[0])
        depth_size = depth0.shape[::-1]
        K = self.scene.camera.scale(depth_size).camera_matrix
        depth_frames = {
            os.path.basename(p).split('.')[0]: p
            for p in self.scene.depth_paths()
        }
        items = list(poses.items())
        stride = max(len(self.scene.depth_paths()) // 100, 1)
        points = []
        for key, T_WC in items[::stride]:
            if key not in depth_frames:
                print(f"WARNING: Can't find depth image {key}.png")
                continue
            depth = read_png(depth_frames[key])
            ys, xs = np.nonzero(depth)
            z = depth[ys, xs].astype(np.float64) / 1000.0
            pc_C = np.stack([(xs + 0.5 - K[0, 2]) * z / K[0, 0],
                             (ys + 0.5 - K[1, 2]) * z / K[1, 1], z], axis=-1)
            points.append(transform_points(T_WC, pc_C)[::50])
        points = np.concatenate(points)
        # Percentile trim stands in for open3d's statistical outlier filter.
        lo = np.percentile(points, 0.5, axis=0)
        hi = np.percentile(points, 99.5, axis=0)
        keep = np.all((points >= lo) & (points <= hi), axis=1)
        return oriented_bounding_frame(points[keep])

    def _write_poses(self, poses):
        pose_dir = os.path.join(self.scene.path, 'pose')
        os.makedirs(pose_dir, exist_ok=True)
        for key, T_CW in poses.items():
            np.savetxt(os.path.join(pose_dir, f'{key}.txt'), T_CW)

    def _write_bounds(self, bounds):
        with open(os.path.join(self.scene.path, 'bbox.txt'), 'wt') as f:
            min_str = " ".join(str(x) for x in bounds[0])
            max_str = " ".join(str(x) for x in bounds[1])
            f.write(f"{min_str} {max_str} 0.01")

    def run(self):
        T_WCs = {key: np.linalg.inv(T_CW)
                 for key, T_CW in self.poses.items()}
        T, aabb = self.compute_bbox(T_WCs)
        T_CWs = {key: np.linalg.inv(T @ T_WC)
                 for key, T_WC in T_WCs.items()}
        self._write_poses(T_CWs)
        self._write_bounds(aabb)


class Pipeline:

    def __init__(self, flags, device=None):
        self.tmp_dir = tempfile.mkdtemp()
        self.flags = flags
        self.device = device
        self.scene = Scene(flags.scene)

    def _pick_backend(self):
        if self.flags.backend == 'cv2':
            return CV2Mapping
        if self.flags.backend == 'hloc':
            return HLoc
        try:
            import hloc  # noqa: F401
            import pycolmap  # noqa: F401
            return HLoc
        except ImportError:
            print("hloc/pycolmap not available; using the built-in cv2 "
                  "SfM backend (--backend cv2).")
            return CV2Mapping

    def run(self):
        backend = self._pick_backend()
        if backend is CV2Mapping:
            mapper = CV2Mapping(self.tmp_dir, self.scene, self.flags,
                                device=self.device)
        else:
            mapper = backend(self.tmp_dir, self.scene, self.flags)
        mapper.run()

        # Camera intrinsics might have changed, reload the scene.
        self.scene = Scene(self.scene.path)

        scaled_poses = ScaleEstimation(self.scene, self.tmp_dir).run()
        PoseSaver(self.scene, scaled_poses).run()

        if self.flags.debug:
            shutil.move(str(self.tmp_dir),
                        os.path.join(tempfile.gettempdir(), 'sfm_debug'))
        else:
            shutil.rmtree(self.tmp_dir)


def main(argv=None, device=None):
    flags = read_args(argv)
    Pipeline(flags, device=resolve_device(device)).run()
    return flags


if __name__ == "__main__":
    main()
