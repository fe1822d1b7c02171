"""GUI backend: the child process that trains forever, re-reads repainted
label PNGs, and streams preview renders back over a Pipe.

Counterpart of autolabel_tpu/backend.py, with its message protocol:
receives ('update_image', idx) / ('get_image', idx) / ('checkpoint',
None); sends ('image', {image_index, rgb, depth, semantic, features}). The
disk is part of the protocol: labels travel as PNG paths, not pixels.
Previews are volumetric renders of the live field, or with
--baked-preview frames of a splat cache that one slab at a time follows
training. It runs on the card unless given device='cpu'. h5py and
pickle (the PCA tile of a --features scene) are imported at the call.
"""
import os

import numpy as np
import torch

from autolabel_tpu_torch import model_utils
from autolabel_tpu_torch.core.dataset import SceneDataset
from autolabel_tpu_torch.device import resolve_device
from autolabel_tpu_torch.render.occupancy import (OccupancyGrid,
                                                  OccupancyGridConfig)
from autolabel_tpu_torch.render.renderer import RenderOptions
from autolabel_tpu_torch.train.losses import LossOptions
from autolabel_tpu_torch.train.trainer import InteractiveTrainer
from autolabel_tpu_torch.utils import require


def _fetch_frame(rgb, depth):
    """A preview frame to the host in compact dtypes (uint8 rgb rounded
    half to even, float16 depth), restored to the payload's float32 on the
    host: the payload contract the GUI's client expects."""
    rgb8 = torch.clamp(torch.round(rgb * 255.0), 0, 255).to(torch.uint8)
    d16 = depth.to(torch.float16)
    return (rgb8.cpu().numpy().astype(np.float32) / 255.0,
            d16.cpu().numpy().astype(np.float32))


def _classes(semantic):
    """(H, W, C) logits -> (H, W) int32 classes, the argmax taken on the
    device and sent as uint8 (so classes wrap at 256, as in JAX)."""
    return torch.argmax(semantic, dim=-1).to(torch.uint8).cpu().numpy() \
        .astype(np.int32)


class TrainingLoop:

    def __init__(self, scene, flags, connection, dataset_factor=4.0,
                 device=None):
        self.scene_path = scene
        self.flags = flags
        self.device = resolve_device(device)
        model_hash = model_utils.model_hash(flags)
        self.workspace = os.path.join(scene, 'nerf', model_hash)
        self._load_pca()
        self.train_dataset = SceneDataset('train',
                                          scene,
                                          factor=dataset_factor,
                                          batch_size=flags.batch_size,
                                          features=flags.features)
        n_classes = (self.train_dataset.n_classes
                     if self.train_dataset.n_classes is not None else 2)
        self.field = model_utils.create_model(self.train_dataset.min_bounds,
                                              self.train_dataset.max_bounds,
                                              n_classes, flags,
                                              device=self.device)
        loss_options = LossOptions(rgb_weight=flags.rgb_weight,
                                   depth_weight=flags.depth_weight,
                                   semantic_weight=flags.semantic_weight,
                                   feature_weight=flags.feature_weight,
                                   feature_loss=flags.features is not None)
        # Interactive training runs the flagship sampled-backward step
        # (exact forward, 2 sampled gradient-scatter rows): no schedule
        # here, so no forward noise in the preview the user paints
        # against. Only the wide-row grid implements it; a narrow
        # reference-preset grid (or none) turns it off.
        sampled_backward = getattr(flags, 'sampled_backward', 2)
        grid_cfg = self.field.config.grid
        if grid_cfg is None or grid_cfg.n_features % 8 != 0:
            sampled_backward = 0
        # The magnitude-weighted backward point subsample, with the
        # sampled backward only.
        backward_points = (getattr(flags, 'backward_points', 0.25)
                           if sampled_backward else 1.0)
        if getattr(flags, 'proposal', False):
            render_options = RenderOptions(
                num_steps=32, perturb=True,
                sampled_backward=sampled_backward,
                backward_points=backward_points,
                proposal_steps=getattr(flags, 'proposal_steps', 64))
        else:
            render_options = RenderOptions(num_steps=128, perturb=True,
                                           sampled_backward=sampled_backward,
                                           backward_points=backward_points)
        occupancy = None
        if getattr(flags, 'occupancy_grid', False):
            occupancy = OccupancyGrid(OccupancyGridConfig(),
                                      self.field.config.bound,
                                      device=self.device)
            occupancy.mark_untrained_grid(self.train_dataset.poses,
                                          self.train_dataset.intrinsics,
                                          self.train_dataset.camera.size)
        self.trainer = InteractiveTrainer(
            'ngp',
            self.field,
            lr=flags.lr,
            loss_options=loss_options,
            render_options=render_options,
            workspace=self.workspace,
            ema_decay=0.95,
            use_checkpoint='latest',
            occupancy=occupancy)
        self.done = False
        self.connection = connection
        # --baked-preview: serve get_image from a splat cache
        # (render/baked.py) that refreshes one volume slab per
        # rebake_every // n_blocks steps, between train steps, so no pump
        # iteration pays a full bake after the first request's.
        self.baked_preview = getattr(flags, 'baked_preview', False)
        self.rebake_every = getattr(flags, 'rebake_every', 2000)
        self._baker = None
        self._governed = None
        self._bake_step = None

    def _load_pca(self):
        feature_path = os.path.join(self.scene_path, 'features.hdf')
        if self.flags.features is None or not os.path.exists(feature_path):
            self.pca = None
            return
        import pickle
        h5py = require('h5py', 'the feature preview (features.hdf)')
        with h5py.File(feature_path, 'r') as f:
            features = f[f'features/{self.flags.features}']
            # The PCA is a pickled sklearn object, which unpickling imports.
            require('sklearn', 'the feature preview (its pickled PCA)')
            self.pca = pickle.loads(features.attrs['pca'].tobytes())
            self.feature_min = features.attrs['min']
            self.feature_range = features.attrs['range']

    def run(self):
        self.trainer.init(self.train_dataset)
        while not self.done:
            self._check_messages()
            self.trainer.take_step()
            self._maybe_update_bake()

    def _maybe_update_bake(self):
        """Refresh one splat-cache slab when its share of the rebake period
        has passed."""
        if self._baker is None:
            return
        step = self.trainer.global_step
        per_block = max(self.rebake_every // self._baker.n_blocks, 1)
        if step - self._bake_step >= per_block:
            self._baker.update_next_block()
            self._bake_step = step

    def _check_messages(self):
        get_image_message = None
        while self.connection.poll():
            message_type, data = self.connection.recv()
            if message_type == 'update_image':
                self._update_image(data)
            elif message_type == 'get_image':
                # Only the latest image request is relevant.
                get_image_message = data
            elif message_type == 'checkpoint':
                self._save_checkpoint()
        if get_image_message is not None:
            self._get_image(get_image_message)

    def _get_baked_image(self, image_index):
        from autolabel_tpu_torch.render.baked import (GovernedPreviewRenderer,
                                                      IncrementalBaker)

        if self._baker is None:
            # One full population on the first request; afterwards
            # _maybe_update_bake keeps it fresh one slab at a time.
            # benchmarks/preview_fps.py's 2^18-splat budget; the governor
            # adapts the rendered subset to hold 30 fps.
            self._baker = IncrementalBaker(self.field, resolution=128,
                                           max_points=2 ** 18)
            self._baker.update_all()
            self._bake_step = self.trainer.global_step
            self._governed = GovernedPreviewRenderer(self._baker.scene())
        else:
            self._governed.set_scene(self._baker.scene())

        T_CW = np.linalg.inv(self.train_dataset.poses[image_index])
        camera = self.train_dataset.camera
        out = self._governed.render(camera.camera_matrix, T_CW,
                                    camera.size)
        rgb, depth = _fetch_frame(out['image'], out['depth'])
        semantic = out['semantic'].to(torch.uint8).cpu().numpy().astype(
            np.int32)
        self.log(f"Sending {image_index} (baked)")
        self.connection.send(('image', {
            'image_index': image_index,
            'rgb': rgb,
            'depth': depth,
            'semantic': semantic,
            'features': None,
        }))

    def _get_image(self, image_index):
        if self.baked_preview:
            return self._get_baked_image(image_index)
        data = self.train_dataset._get_test(image_index)
        p_rgb, p_depth, p_semantic, p_features = self.trainer.test_step(data)
        semantic = _classes(p_semantic)
        rgb, depth = _fetch_frame(p_rgb, p_depth)

        if self.pca is not None:
            feats = p_features.to(torch.float16).cpu().numpy()
            H, W, C = feats.shape
            features = self.pca.transform(
                feats.reshape(H * W, C).astype(np.float32))
            features = np.clip(
                (features - self.feature_min) / self.feature_range, 0.0, 1.0)
            features = features.reshape(H, W, 3)
        else:
            features = None

        self.log(f"Sending {image_index}")
        self.connection.send(('image', {
            'image_index': image_index,
            'rgb': rgb,
            'depth': depth,
            'semantic': semantic,
            'features': features,
        }))

    def _update_image(self, image_index):
        self.train_dataset.semantic_map_updated(image_index)

    def _save_checkpoint(self):
        self.trainer.save_checkpoint(name='best')

    def log(self, message):
        print(message)

    def shutdown(self, *args):
        self.done = True
