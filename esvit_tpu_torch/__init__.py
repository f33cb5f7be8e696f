"""esvit_tpu_torch: the PyTorch + CUDA port of esvit_tpu for NVIDIA Hopper.

The JAX package ``esvit_tpu`` is the reference; this package mirrors its
file layout and names. It imports torch and never jax, flax, optax or
esvit_tpu. Hand-written CUDA kernels live in ``csrc/`` and are built with
nvcc at first use (ops/cuda_build.py).
"""
