"""PyTorch/CUDA port of sharkshark_tpu.

A second package beside the JAX one, with the same module names: the
upscaler service and the modules under it run on an NVIDIA GPU (Hopper,
sm_90a), and the TPU's Pallas kernels become CUDA kernels written by hand
(`csrc/`, built with nvcc at first use; see ops/_build.py).  Public
functions keep the JAX package's NHWC activations and HWIO weights.  The
package imports torch and never JAX, nor anything of sharkshark_tpu.
"""
