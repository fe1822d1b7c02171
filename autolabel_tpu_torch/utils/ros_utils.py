"""Timestamp-matching buffers for the online ROS node.

Counterpart of autolabel_tpu/utils/ros_utils.py, kept as the port's own
copy: a bounded message buffer matching the rgb, depth and keyframe
streams by closest header timestamp within a sync threshold, and the
keyframe pose as a world-to-camera matrix. numpy only: testable without
ROS (any object with .header.stamp.to_sec()).
"""
from collections import deque

import numpy as np


class MessageBuffer:
    """Keep the last max_size messages; answer closest-in-time queries."""

    def __init__(self, sync_threshold, max_size=10):
        self.sync_threshold = sync_threshold
        self.messages = deque(maxlen=max_size)

    def add_message(self, msg):
        self.messages.append(msg)

    def closest(self, stamp):
        """The buffered message closest to `stamp` within the threshold,
        or None (of equally close messages, the newest)."""
        target = stamp.to_sec()
        best = None
        best_dt = self.sync_threshold
        for msg in self.messages:
            dt = abs(msg.header.stamp.to_sec() - target)
            if dt <= best_dt:
                best = msg
                best_dt = dt
        return best

    def __len__(self):
        return len(self.messages)


class SynchronizedStreams:
    """Match N named message streams by closest header timestamp.

    offer(name, msg) buffers the message and returns a dict
    {name: message} when every stream has a message within
    sync_threshold of the new message's stamp, else None.
    """

    def __init__(self, names, sync_threshold, max_size=10):
        self.buffers = {
            name: MessageBuffer(sync_threshold, max_size=max_size)
            for name in names
        }

    def offer(self, name, msg):
        self.buffers[name].add_message(msg)
        stamp = msg.header.stamp
        matched = {}
        for key, buffer in self.buffers.items():
            found = buffer.closest(stamp)
            if found is None:
                return None
            matched[key] = found
        return matched


def pose_matrix(pose_stamped):
    """World->camera 4x4 from a PoseStamped-like message (whose pose is
    camera->world, as the SLAM front end publishes it)."""
    qx = pose_stamped.pose.orientation.x
    qy = pose_stamped.pose.orientation.y
    qz = pose_stamped.pose.orientation.z
    qw = pose_stamped.pose.orientation.w
    T_WC = np.eye(4)
    T_WC[:3, :3] = _quat_to_rotmat(qx, qy, qz, qw)
    T_WC[:3, 3] = [
        pose_stamped.pose.position.x, pose_stamped.pose.position.y,
        pose_stamped.pose.position.z
    ]
    return np.linalg.inv(T_WC)


def _quat_to_rotmat(x, y, z, w):
    """Rotation of the quaternion (x, y, z, w) normalised (all-zero: taken
    as it is, the identity's diagonal)."""
    n = (x * x + y * y + z * z + w * w) ** 0.5 or 1.0
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
