"""GPIC on PyTorch and CUDA: the port of the JAX package ``repro``.

It imports torch and numpy, never jax, and nothing of ``repro``. The
kernels are hand-written CUDA for Hopper (``kernels/csrc``), built with
nvcc at first use; on CPU tensors each kernel's plain PyTorch version runs.
"""
from .core import (
    AffinitySpec,
    GPICConfig,
    adjusted_rand_index,
    affinity_chunked,
    degree_guard,
    degree_matrix_free,
    empty_health,
    gpic_matrix_free,
    kmeans_objective,
    matmat_matrix_free,
    matrix_free_operator,
    matvec_matrix_free,
    pic_from_affinity,
    pic_reference,
    pic_serial_numpy,
    run_gpic,
    standardize_embedding,
)
from .data import dataset_by_name

__all__ = [
    "AffinitySpec",
    "GPICConfig",
    "adjusted_rand_index",
    "affinity_chunked",
    "dataset_by_name",
    "degree_guard",
    "degree_matrix_free",
    "empty_health",
    "gpic_matrix_free",
    "kmeans_objective",
    "matmat_matrix_free",
    "matrix_free_operator",
    "matvec_matrix_free",
    "pic_from_affinity",
    "pic_reference",
    "pic_serial_numpy",
    "run_gpic",
    "standardize_embedding",
]
