"""Kernels and tensor ops of the port (CUDA sources in ../csrc)."""
