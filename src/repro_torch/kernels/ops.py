"""The kernel entry points ``core/`` calls.

Dispatch is by the tensor's device: a CPU tensor runs the plain PyTorch
version (``kernels/ref.py``), a CUDA tensor the hand-written kernel, and a
kernel that cannot build or launch raises. Nothing falls back quietly.
``launch_counts()`` reports the kernel launches since
``reset_launch_counts()``.
"""
from __future__ import annotations

from ._build import launch_counts, reset_launch_counts
from .affinity import affinity_and_degree as _affinity_and_degree
from .kmeans_assign import kmeans_assign
from .power_step import degree_normalized_matmat

__all__ = [
    "affinity_and_degree",
    "degree_normalized_matmat",
    "kmeans_assign",
    "launch_counts",
    "reset_launch_counts",
]


def affinity_and_degree(xn, xc=None, *, kind="cosine_shifted", sigma=1.0,
                        spec=None, row_offset=0, col_offset=0):
    """Fused A + D build; ``spec`` (an AffinitySpec) supplies kind/sigma."""
    if spec is not None:
        kind, sigma = spec.kind, float(spec.sigma)
    return _affinity_and_degree(xn, xc, kind=kind, sigma=sigma,
                                row_offset=row_offset, col_offset=col_offset)
