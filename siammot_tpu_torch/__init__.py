"""PyTorch/CUDA port of ``siammot_tpu`` for NVIDIA Hopper (H100).

Module names mirror ``siammot_tpu`` so each file has an obvious
counterpart.  The package imports torch, numpy and the standard library
only: it never imports JAX, flax, yaml (except lazily in
``CfgNode.merge_from_file``) or anything of ``siammot_tpu``; what it
needs from there it keeps as its own copy.

Every Pallas kernel on the inference path is a hand-written CUDA kernel
under ``ops/cuda/``, built with ``nvcc`` at first use and bound through
``ctypes``.  Each kernel's wrapper launches the kernel for CUDA tensors
and runs the plain PyTorch version beside it only for CPU tensors.
"""
