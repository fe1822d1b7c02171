"""Training-side modules of the PyTorch port (checkpoint I/O so far)."""
