"""Host-side ray-batch datasets.

Counterpart of autolabel_tpu/core/dataset.py (LenDataset, LazyImageLoader,
BaseDataset, SceneDataset, DynamicDataset), kept as the port's own copy. These run on the
host and feed the training step: an infinite iterator over ray batches
(origins, jittered unit directions + norms, rgb, depth in meters, shifted
semantic labels, optional teacher features) assembled in 512-ray chunks;
when annotations exist, half the chunks are drawn class-balanced from
labeled pixels. The draws come in the JAX order (the chunk's coin, the
class, the image, the pixels, then the jitter), so one seed gives both
packages the same batches.

Images are read by utils.images in place of cv2 and PIL, with each
library's nearest-neighbour rule where the JAX package uses it: cv2's for
colour and depth, PIL's for semantic labels. Teacher features need h5py,
imported at the call.

DynamicDataset (online mapping) grows frame by frame and keeps a buffer of
ready batches filled by a thread. Unlike the JAX package's, one lock
guards its frame lists and rng, so the thread never reads a frame that
add_frame is evicting, and an error in the thread is raised by __iter__
instead of ending the thread silently (JAX's __iter__ then waits
forever).
"""
import collections
import os
import threading

import numpy as np

from autolabel_tpu_torch.core.rays import compute_directions, convert_pose
from autolabel_tpu_torch.core.sampler import IndexSampler
from autolabel_tpu_torch.utils import Scene
from autolabel_tpu_torch.utils import images as image_io


class LenDataset:
    """Truncate an infinite iterable dataset to a fixed length."""

    def __init__(self, dataset, length):
        self.dataset = dataset
        self.length = length

    def __iter__(self):
        iterator = iter(self.dataset)
        for _ in range(self.length):
            yield next(iterator)

    def __len__(self):
        return self.length


class LazyImageLoader:
    """Load + resize images on first access, then cache. The resize is
    cv2's nearest-neighbour rule (the only interpolation SceneDataset
    asks for)."""

    def __init__(self, images, size):
        self.images = images
        self.size = size
        self._cache = {}

    def __getitem__(self, i):
        image = self._cache.get(i)
        if image is None:
            image = np.array(image_io.read_image(self.images[i]),
                             dtype=np.float32)
            if image.ndim == 3:
                image = image[..., :3] / 255.0
            image = image_io.resize_nearest_cv2(image, self.size)
            self._cache[i] = image
        return image

    def __len__(self):
        return len(self.images)

    @property
    def shape(self):
        return [len(self)]


class BaseDataset:
    """Infinite train-batch sampler / per-frame test iterator."""

    semantic_image_sample_ratio = 0.5

    def __init__(self, batch_size, camera):
        self.split = 'train'
        self.camera = camera
        self.batch_size = batch_size
        self.pixel_indices = None
        self.features = None
        self.w = int(camera.size[0])
        self.h = int(camera.size[1])
        self.resolution = self.w * self.h
        self.intrinsics = np.array(
            [camera.fx, camera.fy, camera.cx, camera.cy])
        # Batches are assembled in whole chunks; a non-multiple batch_size
        # is truncated down (reference semantics, dataset.py:183-184).
        self.sample_chunk_size = min(512, batch_size)
        self.index_sampler = IndexSampler()
        self.rng = np.random.default_rng()
        # When set, train batches also carry 'frame_idx' and camera-frame
        # 'rays_d_cam', from which pose refinement rebuilds the world rays
        # under learnable poses (train/pose_refine.py).
        self.emit_frame_rays = False

    def __iter__(self):
        if self.split == 'train':
            while True:
                yield self._next_train()
        else:
            for i in range(len(self.poses)):
                yield self._get_test(i)

    def _next_train(self):
        chunks = self.batch_size // self.sample_chunk_size
        batch_size = chunks * self.sample_chunk_size
        cs = self.sample_chunk_size

        pixels = np.zeros((batch_size, 3), dtype=np.float32)
        depths = np.zeros(batch_size, dtype=np.float32)
        semantics = np.zeros(batch_size, dtype=np.int32)
        ray_o = np.zeros((batch_size, 3), dtype=np.float32)
        ray_d = np.zeros((batch_size, 3), dtype=np.float32)
        direction_norms = np.zeros((batch_size, 1), dtype=np.float32)
        out = {
            'rays_o': ray_o,
            'rays_d': ray_d,
            'pixels': pixels,
            'direction_norms': direction_norms,
            'depth': depths,
            'semantic': semantics,
        }
        if self.features is not None:
            features = np.zeros((batch_size, self.feature_dim),
                                dtype=np.float32)
            out['features'] = features
        if self.emit_frame_rays:
            frame_idx = np.zeros(batch_size, dtype=np.int32)
            rays_d_cam = np.zeros((batch_size, 3), dtype=np.float32)
            out['frame_idx'] = frame_idx
            out['rays_d_cam'] = rays_d_cam

        for chunk in range(chunks):
            balanced = (self.index_sampler.has_semantics and
                        self.rng.random() < self.semantic_image_sample_ratio)
            if balanced:
                class_id = self.index_sampler.sample_class()
                image_index, ray_indices = self.index_sampler.sample(
                    class_id, cs)
            else:
                image_index = int(self.rng.integers(0, self.n_examples))
                ray_indices = self.rng.choice(self.pixel_indices, size=(cs,))
            s, e = chunk * cs, (chunk + 1) * cs

            pixels[s:e] = self.images[image_index][ray_indices]
            depths[s:e] = self.depths[image_index][ray_indices] / 1000.0
            semantics[s:e] = (
                self.semantics[image_index][ray_indices].astype(np.int32) - 1)
            ray_o[s:e] = self.origins[image_index][None]
            if self.emit_frame_rays:
                # Camera-frame directions, and the world rays from the same
                # jittered draw under one rotation.
                dirs_c, norms = compute_directions(
                    np.eye(3), ray_indices, self.w, self.camera.fx,
                    self.camera.fy, self.camera.cx, self.camera.cy,
                    rng=self.rng)
                rays_d_cam[s:e] = dirs_c
                frame_idx[s:e] = image_index
                ray_d[s:e] = dirs_c @ self.rotations[image_index].T
            else:
                dirs, norms = self._compute_direction(image_index,
                                                      ray_indices,
                                                      randomize=True)
                ray_d[s:e] = dirs
            direction_norms[s:e] = norms

            if self.features is not None:
                x = ray_indices % self.w
                y = (ray_indices - x) // self.w
                xy = self._scale_to_feature_xy(np.stack([x, y], axis=-1))
                flat = xy[:, 1] * self.feature_width + xy[:, 0]
                features[s:e] = self.features[image_index][flat, :]
        return out

    def _get_test(self, image_index):
        image = np.asarray(self.images[image_index]).reshape(
            self.h, self.w, 3)
        ray_o = np.broadcast_to(self.origins[image_index],
                                (self.h, self.w, 3)).astype(np.float32)
        ray_d, norms = self._compute_direction(image_index,
                                               np.arange(self.resolution))
        depth = (np.asarray(self.depths[image_index]) / 1000.0).reshape(
            self.h, self.w)
        semantic = (self.semantics[image_index].astype(np.int32) - 1).reshape(
            self.h, self.w)
        out = {
            'pixels': image,
            'rays_o': ray_o,
            'rays_d': ray_d.reshape(self.h, self.w, 3).astype(np.float32),
            'depth': depth,
            'semantic': semantic,
            'H': self.h,
            'W': self.w,
            'direction_norms': norms,
        }
        if self.features is not None:
            out['features'] = self.features[image_index]
        return out

    def _convert_pose(self, T_CW):
        return convert_pose(T_CW)

    def _flatten_images(self):
        if self.split == 'train' and not isinstance(self.images,
                                                    LazyImageLoader):
            n = self.n_examples
            self.images = self.images.reshape(n, self.resolution, 3)
            self.depths = self.depths.reshape(n, self.resolution)
        self.semantics = self.semantics.reshape(-1, self.resolution)

    def _compute_direction(self, image_index, ray_indices, randomize=False):
        return compute_directions(self.rotations[image_index], ray_indices,
                                  self.w, self.camera.fx, self.camera.fy,
                                  self.camera.cx, self.camera.cy,
                                  self.rng if randomize else None)

    def _compute_image_mask(self, images):
        """Exclude pixels that are black in all frames (undistortion rims).

        Parity: autolabel/dataset.py:295-311.
        """
        if isinstance(images, LazyImageLoader):
            indices = self.rng.integers(0, len(images), size=5)
            images = np.stack([images[int(i)] for i in indices])
        else:
            images = images[::10]
        non_zero = np.any(images > (10.0 / 255.0), axis=3)
        non_zero = np.any(non_zero.reshape(non_zero.shape[0], -1), axis=0)
        self.pixel_indices = np.flatnonzero(non_zero)


class SceneDataset(BaseDataset):
    """Ray batches from an on-disk scene directory."""

    def __init__(self,
                 split,
                 scene,
                 factor=4.0,
                 size=None,
                 batch_size=4096,
                 lazy=False,
                 features=None,
                 load_semantic=True):
        self.lazy = lazy
        self.scene = Scene(scene)
        self.image_names = self.scene.image_names()
        self.load_semantic = load_semantic
        camera = self.scene.camera
        if size is None:
            size = (int(camera.size[0] / factor), int(camera.size[1] / factor))
        image_count = min(len(self.scene.rgb_paths()),
                          len(self.scene.depth_paths()))
        # Pair frames with poses BY NAME: an SfM front-end may fail to
        # register some frames, so pose/ can have holes — positional
        # pairing would silently misalign every later frame.
        pose_frames = set(getattr(self.scene, 'pose_frames', []))
        self.indices = np.array([
            i for i, p in enumerate(self.scene.rgb_paths()[:image_count])
            if os.path.basename(p).split('.')[0] in pose_frames
        ], dtype=np.int64)
        super().__init__(batch_size, camera.scale(size))
        self.split = split
        self._load_images()
        self._flatten_images()
        self.index_sampler.update(self.semantics)
        if features is not None:
            self._load_features(features)
        self.n_classes = self.scene.n_classes

    def _load_images(self):
        images, depths, semantics, cameras = [], [], [], []
        color_paths = self.scene.rgb_paths()
        depth_paths = self.scene.depth_paths()
        pose_of = dict(zip(self.scene.pose_frames, self.scene.poses))
        size = self.camera.size

        for index in self.indices:
            if self.lazy:
                images.append(color_paths[index])
                depths.append(depth_paths[index])
            else:
                image = np.array(image_io.read_image(color_paths[index]),
                                 dtype=np.float32)[..., :3]
                images.append(image_io.resize_nearest_cv2(image, size)
                              / 255.0)
                depth = image_io.read_image(depth_paths[index])
                depths.append(image_io.resize_nearest_cv2(depth, size))

            semantic_path = os.path.join(
                self.scene.path, 'semantic',
                os.path.basename(depth_paths[index]))
            if self.load_semantic and os.path.exists(semantic_path):
                semantics.append(image_io.resize_nearest_pil(
                    image_io.read_image(semantic_path), size))
            else:
                semantics.append(np.zeros(size[::-1], dtype=np.uint8))

            stem = os.path.basename(color_paths[index]).split('.')[0]
            cameras.append(
                self._convert_pose(pose_of[stem]).astype(np.float32))

        if self.lazy:
            self.images = LazyImageLoader(images, size)
            self.depths = LazyImageLoader(depths, size)
        else:
            self.images = np.stack(images)
            self.depths = np.stack(depths)
        self.semantics = np.stack(semantics)
        self._compute_image_mask(self.images)
        self.poses = np.stack(cameras)
        self.rotations = np.ascontiguousarray(self.poses[:, :3, :3])
        self.origins = self.poses[:, :3, 3]
        self.n_examples = len(self.indices)

        aabb = self.scene.bbox()
        self.min_bounds = aabb[0]
        self.max_bounds = aabb[1]

    def semantic_map_updated(self, image_index):
        """Re-read one repainted semantic PNG and refresh the sampler.

        The annotation PNG on disk is the GUI<->trainer protocol
        (parity: autolabel/dataset.py:420-429).
        """
        filename = f"{self.image_names[image_index]}.png"
        semantic_path = os.path.join(self.scene.path, 'semantic', filename)
        if not os.path.exists(semantic_path):
            print(f"Could not find image {semantic_path}")
            return
        image = image_io.resize_nearest_pil(
            image_io.read_image(semantic_path), self.camera.size)
        self.semantics[image_index, :] = image.reshape(self.resolution)
        self.index_sampler.update(self.semantics)

    def update_sampler(self):
        self.index_sampler.update(self.semantics)

    def _load_features(self, features):
        """Load precomputed teacher features from <scene>/features.hdf
        (h5py, imported here, so the module loads without it)."""
        try:
            import h5py
        except ImportError as e:
            raise RuntimeError(
                'teacher features (features.hdf) need h5py, which is not '
                'installed') from e
        with h5py.File(os.path.join(self.scene.path, 'features.hdf'),
                       'r') as hdf:
            data = hdf[f'features/{features}'][:]
        N, H, W, C = data.shape
        self.features = data.reshape(N, H * W, C)
        self.feature_width = W
        self.feature_height = H
        self.feature_dim = C
        scale = np.array([W / self.camera.size[0], H / self.camera.size[1]])
        self._scale_to_feature_xy = lambda xy: (xy * scale).astype(int)


class DynamicDataset(BaseDataset):
    """Incrementally growing dataset for online (SLAM keyframe) mapping
    (autolabel_tpu/core/dataset.py:361-445).

    Frames arrive through add_frame; beyond `capacity`, a frame drawn from
    self.rng is evicted (reservoir-style). A thread keeps up to
    prefetch_buffer_size batches ready. Images are float64, semantics
    uint16 (SceneDataset's are uint8). stop() ends and joins the thread.
    """

    prefetch_buffer_size = 25

    def __init__(self, batch_size, camera, capacity=None):
        super().__init__(batch_size, camera)
        self.capacity = capacity
        self.poses = []
        self.rotations = []
        self.origins = []
        self.images = []
        self.depths = []
        self.features = []
        self.semantics = []
        self.n_examples = 0
        self.prefetch_buffer = collections.deque()
        self.stopped = False
        self._error = None
        # The frame lists (and self.rng) are read by the prefetch thread
        # and changed by add_frame: one lock guards them. The buffer and
        # the flags have a condition of their own, so taking a batch never
        # waits for one being assembled.
        self._frames_lock = threading.Lock()
        self._ready = threading.Condition()
        self._prefetch_thread = threading.Thread(target=self._prefetch,
                                                 daemon=True)
        self._prefetch_thread.start()

    def stop(self):
        with self._ready:
            self.stopped = True
            self._ready.notify_all()
        self._prefetch_thread.join()

    def _prefetch(self):
        try:
            while True:
                with self._ready:
                    self._ready.wait_for(lambda: self.stopped or (
                        self.n_examples > 0 and len(self.prefetch_buffer)
                        < self.prefetch_buffer_size))
                    if self.stopped:
                        return
                with self._frames_lock:
                    batch = self._next_train()
                with self._ready:
                    self.prefetch_buffer.append(batch)
                    self._ready.notify_all()
        except Exception as e:  # raised again by __iter__
            with self._ready:
                self._error = e
                self._ready.notify_all()

    def __iter__(self):
        """The prefetched batches, waiting for each; raises the prefetch
        thread's error, and ends once the dataset is stopped and the
        buffer is empty."""
        while True:
            with self._ready:
                self._ready.wait_for(lambda: self.prefetch_buffer
                                     or self._error is not None
                                     or self.stopped)
                if self._error is not None:
                    raise RuntimeError(
                        'the prefetch thread failed') from self._error
                if not self.prefetch_buffer:
                    return
                batch = self.prefetch_buffer.popleft()
                self._ready.notify_all()
            yield batch

    def add_frame(self, T_CW, rgb, depth, features):
        """Append one frame: rgb uint8 (H, W, 3), depth uint16 (H, W) in
        millimetres, features (h, w, D) of the frame's teacher."""
        if depth.dtype != np.uint16:
            raise TypeError(f'depth must be uint16, not {depth.dtype}')
        if rgb.dtype != np.uint8:
            raise TypeError(f'rgb must be uint8, not {rgb.dtype}')
        with self._frames_lock:
            if len(self.features) == 0:
                self._init_features(features)
            if features.ndim != 3 or features.shape[0] != self.feature_height:
                raise ValueError(
                    f'features must be ({self.feature_height}, w, D), not '
                    f'{features.shape}')
            if self.pixel_indices is None:
                self.resolution = rgb.shape[0] * rgb.shape[1]
                self.pixel_indices = np.arange(self.resolution)

            T_WC = self._convert_pose(T_CW)
            self.poses.append(T_WC)
            self.rotations.append(np.ascontiguousarray(T_WC[:3, :3]))
            self.origins.append(T_WC[:3, 3])
            self.images.append(rgb.reshape(-1, 3) / 255.0)
            self.depths.append(depth.reshape(-1))
            self.features.append(
                features.reshape(self.feature_height * self.feature_width,
                                 -1))
            self.semantics.append(np.zeros(self.resolution, dtype=np.uint16))
            self.n_examples = len(self.images)

            if self.capacity is not None and len(self.poses) > self.capacity:
                drop = int(self.rng.integers(0, len(self.poses)))
                for store in (self.poses, self.rotations, self.origins,
                              self.images, self.depths, self.features,
                              self.semantics):
                    del store[drop]
                self.n_examples = len(self.images)
        with self._ready:
            self._ready.notify_all()

    def __len__(self):
        return self.n_examples

    def _init_features(self, features):
        H, W, D = features.shape
        self.feature_height = H
        self.feature_width = W
        self.feature_dim = D
        scale = np.array([W / self.camera.size[0], H / self.camera.size[1]])
        self._scale_to_feature_xy = lambda xy: (xy * scale).astype(int)
