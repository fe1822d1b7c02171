"""The online (ROS 1) side of the port: the incremental mapping node
(`python -m autolabel_tpu_torch.ros.node`) and its prompt editor
(`python -m autolabel_tpu_torch.ros.class_input`).

Counterparts of scripts/ros/node.py and scripts/ros/class_input.py.
rospy, tf, cv_bridge, the message modules and PyQt6 are imported where a
constructor or main needs them, never when a module is imported: none is
a dependency of the port, and a missing one raises naming itself.
"""
