"""The open-vocabulary CLIs: evaluate (2D and point-cloud scoring against
a label map) and pointcloud (a fused RGB point cloud)."""
