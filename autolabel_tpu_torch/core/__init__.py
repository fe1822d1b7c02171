"""Framework-free host code of the PyTorch port (rays, poses)."""
