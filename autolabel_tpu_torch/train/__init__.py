"""Training-side modules of the PyTorch port: losses, the optimizer,
metrics, SimpleTrainer and checkpoint I/O."""
