"""PyTorch/CUDA port of mmvae_tpu for NVIDIA Hopper.

The package mirrors mmvae_tpu's layout and names module for module, so each
file has a counterpart there. It imports torch, numpy, scipy (the FID's
matrix square root) and the standard library only; the JAX package is the
reference it is tested against.
Hand-written CUDA kernels live in csrc/ and are built with nvcc at first use.
"""
