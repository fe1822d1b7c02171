"""Online incremental mapping ROS node.

Counterpart of scripts/ros/node.py, with its flags. Subscribes to
/slam/{rgb,depth,keyframe,camera_info,odometry}, matches the streams by
timestamp, extracts teacher features per keyframe, feeds them into a
DynamicDataset, and trains the field in 100-iteration bursts on a
background thread while publishing /autolabel/{image,features,depth}
previews at the current odometry pose.

    python -m autolabel_tpu_torch.ros.node [--features lseg] [--bound 2.5]

Needs ROS 1 (rospy, tf, cv_bridge and the geometry_msgs, sensor_msgs,
std_msgs and std_srvs messages), imported where a constructor or main
needs them, and cv2 for --log. It runs on the card unless given
device='cpu'; without a card it raises.
"""
import argparse
import os
import threading
import time

import numpy as np
import torch

from autolabel_tpu_torch import model_utils, visualization
from autolabel_tpu_torch.constants import COLORS
from autolabel_tpu_torch.core.dataset import DynamicDataset
from autolabel_tpu_torch.core.rays import compute_directions
from autolabel_tpu_torch.device import resolve_device
from autolabel_tpu_torch.features.feature_utils import get_feature_extractor
from autolabel_tpu_torch.render.renderer import RenderOptions
from autolabel_tpu_torch.train.losses import LossOptions
from autolabel_tpu_torch.train.trainer import SimpleTrainer
from autolabel_tpu_torch.utils import Camera, require, ros_utils

RENDER_INTRINSICS = (205.0, 205.0, 128.0, 96.0)  # fx fy cx cy @ 256x192
_NEEDS = 'the ROS node'


def _ros(module, name=None):
    """A ROS module (or a name in it), imported at the call."""
    mod = require(module, _NEEDS)
    return mod if name is None else getattr(mod, name)


def read_args(argv=None):
    """scripts/ros/node.py's flags and defaults; argv defaults to
    sys.argv[1:]."""
    parser = argparse.ArgumentParser()
    parser.add_argument('--features', type=str, default='lseg')
    parser.add_argument('--checkpoint',
                        type=str,
                        default=None,
                        help='path to feature model checkpoint')
    parser.add_argument('--allow-fallback', action='store_true',
                        help="Permit stand-in features when teacher "
                        "weights are unavailable (testing only).")
    parser.add_argument(
        '--log',
        default=None,
        type=str,
        help="Save incoming images to this directory in the autolabel "
        "format for debugging.")
    parser.add_argument(
        '--bound',
        '-b',
        type=float,
        default=2.5,
        help="The size of bounding volume of the scene. Range will be from "
        "-bound to bound in x, y and z.")
    return parser.parse_args(argv)


class Frame:

    def __init__(self, num, T_CW, image, depth, features):
        self.num = num
        self.T_CW = T_CW
        self.image = image
        self.depth = depth
        self.features = features


def _numpy(array):
    """A teacher's output (a tensor on its device, or numpy) as numpy."""
    if isinstance(array, torch.Tensor):
        return array.cpu().numpy()
    return np.asarray(array)


class Bridge:
    """ROS <-> numpy conversions + live open-vocab preview coloring.
    device: the teacher's (see features.feature_utils)."""

    def __init__(self, features, checkpoint, allow_fallback=False,
                 device=None):
        self.tf_listener = _ros('tf').TransformListener()
        self.bridge = _ros('cv_bridge').CvBridge()
        self.feature_extractor = get_feature_extractor(
            features, checkpoint, allow_fallback=allow_fallback,
            device=device)
        self.set_prompts(["background", "other"])

    def set_prompts(self, prompts):
        self.prompt_features = _numpy(
            self.feature_extractor.encode_text(list(prompts)))

    def depth_to_array(self, depth_msg):
        return self.bridge.imgmsg_to_cv2(depth_msg, 'mono16')

    def color_to_array(self, image_msg):
        return self.bridge.imgmsg_to_cv2(image_msg, 'rgb8')

    def features(self, image_array):
        """H x W x 3 rgb -> H_o x W_o x D unit-norm teacher features."""
        image = np.transpose(image_array / 255.0, [2, 0, 1])[None]
        features = _numpy(self.feature_extractor(image))[0]
        norms = np.linalg.norm(features, axis=-1, keepdims=True)
        return features / np.maximum(norms, 1e-9)

    def image_to_message(self, array):
        msg = self.bridge.cv2_to_imgmsg(array, encoding='rgb8')
        msg.header.stamp = _ros('rospy').Time.now()
        return msg

    def features_to_message(self, feature_map):
        class_map = self._feature_similarity(feature_map)
        seg_map = (COLORS[class_map % len(COLORS)] * 255).astype(np.uint8)
        msg = self.bridge.cv2_to_imgmsg(seg_map, encoding='rgb8')
        msg.header.stamp = _ros('rospy').Time.now()
        return msg

    def _feature_similarity(self, feature_map):
        norms = np.linalg.norm(feature_map, axis=-1, keepdims=True)
        feature_map = feature_map / np.maximum(norms, 1e-9)
        text = self.prompt_features[:, :feature_map.shape[-1]]
        similarities = feature_map @ text.T
        return similarities.argmax(axis=-1)


class TrainingLoop:
    """Background thread: 100-iteration training bursts interleaved with
    256x192 preview renders at the latest odometry pose. The field lives
    on `device` (the card unless device='cpu'); stop() ends the thread
    and the dataset's prefetch thread."""

    def __init__(self, bridge, bound, device=None):
        self.bridge = bridge
        self.device = resolve_device(device)
        min_bounds = np.array([-bound] * 3)
        max_bounds = np.array([bound] * 3)

        class _Opt:
            encoding = 'hg+freq'
            geometric_features = 15
            feature_dim = 512
            features = 'lseg'

        self.field = model_utils.create_model(min_bounds, max_bounds, 2,
                                              _Opt(), device=self.device)
        loss_options = LossOptions(rgb_weight=1.0,
                                   depth_weight=0.025,
                                   semantic_weight=0.0,
                                   feature_weight=0.5,
                                   feature_loss=True)
        self.trainer = SimpleTrainer(
            'ngp',
            self.field,
            lr=1e-2,
            iters=None,  # constant lr online
            loss_options=loss_options,
            render_options=RenderOptions(num_steps=128, perturb=True),
            workspace=None,
            ema_decay=0.95,
            max_ray_batch=2048)
        self.dataset = None
        self.initialized = False
        self.training = True
        self.done = False
        self.render_resolution = (256, 192)
        self.pixel_indices = np.arange(self.render_resolution[0] *
                                       self.render_resolution[1])
        self.odometry_pose = None
        Publisher = _ros('rospy', 'Publisher')
        Image = _ros('sensor_msgs.msg', 'Image')
        self.image_pub = Publisher('/autolabel/image', Image, queue_size=1)
        self.feature_pub = Publisher('/autolabel/features', Image,
                                     queue_size=1)
        self.depth_pub = Publisher('/autolabel/depth', Image, queue_size=1)
        self.training_thread = threading.Thread(target=self.train)
        self.training_thread.start()

    def set_camera(self, msg):
        if self.dataset is None:
            K = np.array(msg.K).reshape(3, 3)
            camera = Camera(K, (msg.width, msg.height))
            self.dataset = DynamicDataset(2048, camera, capacity=325)

    def train(self):
        while True:
            if self.done:
                print("Closing training loop")
                return 0
            if self.initialized:
                if self.training and len(self.dataset) > 5:
                    print(f"Fitting with {len(self.dataset)} images")
                    self.trainer.train_iterations(self.dataset, 100)
                if self.odometry_pose is not None:
                    self.render_frame()
            else:
                time.sleep(0.05)

    def render_frame(self):
        T_CW = self.odometry_pose
        width, height = self.render_resolution
        T_WC = self.dataset._convert_pose(T_CW)
        origins = np.broadcast_to(T_WC[:3, 3],
                                  (height, width, 3)).astype(np.float32)
        fx, fy, cx, cy = RENDER_INTRINSICS
        directions, norms = compute_directions(
            np.ascontiguousarray(T_WC[:3, :3]), self.pixel_indices, width,
            fx, fy, cx, cy)
        outputs = self.trainer._staged.render(
            origins, directions.reshape(height, width, 3),
            norms.reshape(height, width))
        # The finished frame to the host in one copy, for cv_bridge.
        frame = torch.cat([outputs['image'], outputs['depth'][..., None],
                           outputs['semantic_features']], dim=-1)
        frame = frame.cpu().numpy()
        image = (np.clip(frame[..., :3], 0, 1) * 255).astype(np.uint8)
        self.image_pub.publish(self.bridge.image_to_message(image))
        self.feature_pub.publish(
            self.bridge.features_to_message(frame[..., 4:]))
        depth_frame = visualization.visualize_depth(frame[..., 3],
                                                    maxdepth=10.0)
        self.depth_pub.publish(self.bridge.image_to_message(depth_frame))

    def add_frame(self, frame):
        if self.dataset is None:
            return
        self.dataset.add_frame(frame.T_CW, frame.image, frame.depth,
                               frame.features)
        self.initialized = True

    def stop(self):
        self.training = False
        self.done = True
        self.training_thread.join()
        if self.dataset is not None:
            self.dataset.stop()


class AutolabelNode:
    """Wires the SLAM topics into the training loop.

    Stream synchronization lives in ros_utils.SynchronizedStreams (the
    rgb/depth/keyframe triple-match, testable without rospy); this class
    only subscribes, converts and forwards. device: the teacher's and the
    field's (the card unless device='cpu').
    """

    SYNC_THRESHOLD = 1.0 / 60.0

    def __init__(self, flags, device=None):
        self.device = resolve_device(device)
        self.reading = True
        self.bridge = Bridge(flags.features, flags.checkpoint,
                             allow_fallback=flags.allow_fallback,
                             device=self.device)
        self.training_loop = TrainingLoop(self.bridge, flags.bound,
                                          device=self.device)
        self.streams = ros_utils.SynchronizedStreams(
            ('rgb', 'depth', 'pose'), self.SYNC_THRESHOLD, max_size=10)
        Subscriber = _ros('rospy', 'Subscriber')
        Service = _ros('rospy', 'Service')
        Image = _ros('sensor_msgs.msg', 'Image')
        PoseStamped = _ros('geometry_msgs.msg', 'PoseStamped')
        Empty = _ros('std_srvs.srv', 'Empty')
        self.subscribers = {
            name: Subscriber(f'/slam/{topic}', Image,
                             self._stream_callback(name), queue_size=20)
            for name, topic in (('rgb', 'rgb'), ('depth', 'depth'))
        }
        self.subscribers['pose'] = Subscriber(
            '/slam/keyframe', PoseStamped, self._stream_callback('pose'),
            queue_size=20)
        self.odometry_sub = Subscriber(
            '/slam/odometry', PoseStamped, lambda msg: setattr(
                self.training_loop, 'odometry_pose',
                ros_utils.pose_matrix(msg)))
        self.camera_info_sub = Subscriber(
            '/slam/camera_info', _ros('sensor_msgs.msg', 'CameraInfo'),
            self.camera_info_callback)
        self.prompt_sub = Subscriber(
            '/autolabel/segmentation_classes', _ros('std_msgs.msg', 'String'),
            lambda msg: self.bridge.set_prompts(str(msg.data).split("|")))
        self.services = [
            Service('/autolabel/train', Empty, self.toggle_training),
            Service('/autolabel/pause', Empty, self.toggle_reading),
        ]
        self.debug_log = flags.log
        if self.debug_log is not None:
            for sub in ('rgb', 'depth', 'pose'):
                os.makedirs(os.path.join(self.debug_log, sub), exist_ok=True)

    def toggle_training(self, req):
        self.training_loop.training = not self.training_loop.training
        print("toggled training")
        return []

    def toggle_reading(self, req):
        self.reading = not self.reading
        print(f"Accepting new images: {self.reading}")
        return []

    def _stream_callback(self, name):

        def callback(msg):
            if not self.reading:
                return
            matched = self.streams.offer(name, msg)
            if matched is not None:
                self._ingest(matched)

        return callback

    def _ingest(self, matched):
        image_msg, depth_msg = matched['rgb'], matched['depth']
        if np.abs(depth_msg.header.stamp.to_sec() -
                  image_msg.header.stamp.to_sec()) > self.SYNC_THRESHOLD:
            print("WARNING depth and rgb might not be synchronized")
        image = self.bridge.color_to_array(image_msg)
        frame = Frame(image_msg.header.seq,
                      ros_utils.pose_matrix(matched['pose']), image,
                      self.bridge.depth_to_array(depth_msg),
                      self.bridge.features(image))
        self.training_loop.add_frame(frame)
        if self.debug_log is not None:
            self._debug_log_frame(frame)

    def _debug_log_frame(self, frame):
        cv2 = require('cv2', 'the ROS node\'s --log')
        filename = f"{frame.num:06d}"
        cv2.imwrite(os.path.join(self.debug_log, 'rgb', f"{filename}.jpg"),
                    cv2.cvtColor(frame.image, cv2.COLOR_RGB2BGR))
        cv2.imwrite(os.path.join(self.debug_log, 'depth', f"{filename}.png"),
                    frame.depth)
        np.savetxt(os.path.join(self.debug_log, 'pose', f"{filename}.txt"),
                   frame.T_CW)

    def camera_info_callback(self, msg):
        self.training_loop.set_camera(msg)
        self.camera_info_sub.unregister()

    def run(self):
        _ros('rospy').spin()

    def stop(self):
        self.training_loop.stop()


def main(argv=None, device=None):
    flags = read_args(argv)
    _ros('rospy').init_node("autolabel")
    node = None
    try:
        node = AutolabelNode(flags, device=device)
        node.run()
    finally:
        # A node that failed to build has nothing to stop: its error stands.
        if node is not None:
            node.stop()


if __name__ == "__main__":
    main()
