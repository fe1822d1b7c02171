"""Volumetric rendering of the PyTorch port."""
