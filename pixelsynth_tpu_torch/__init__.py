"""PixelSynth on PyTorch and CUDA (Hopper): the port of pixelsynth_tpu.

The package imports torch and numpy, never JAX or the JAX package.
Its hand-written kernels live in csrc/ and build with nvcc on first use.
"""
