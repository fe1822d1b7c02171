"""The neural field of the PyTorch port."""
