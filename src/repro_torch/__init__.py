"""GPIC on PyTorch and CUDA: the port of the JAX package ``repro``.

It imports torch and numpy, never jax, and nothing of ``repro``. The
kernels are hand-written CUDA for Hopper (``kernels/csrc``), built with
nvcc at first use; on CPU tensors each kernel's plain PyTorch version runs.
"""
from .core import AffinitySpec, GPICConfig, adjusted_rand_index, run_gpic
from .data import dataset_by_name

__all__ = [
    "AffinitySpec",
    "GPICConfig",
    "adjusted_rand_index",
    "dataset_by_name",
    "run_gpic",
]
