"""kit4b_tpu_torch — PyTorch/CUDA port of kit4b_tpu for NVIDIA Hopper.

The JAX package `kit4b_tpu` is the reference; each module here is held
against it on the same inputs. Kernels are written by hand for sm_90a
(`csrc/`) and built at first use into `_build/`; each has a plain PyTorch
version that runs on CPU tensors. This package never imports jax.
"""
__version__ = "0.1.0"
