"""Ops of the PyTorch port: encoders, MLPs and the CUDA kernel wrappers.

Importing compiles nothing; kernels build on first use on a CUDA device.
"""
