"""The kernel entry points ``core/`` calls.

Dispatch is by the tensor's device: a CPU tensor runs the plain PyTorch
version (``kernels/ref.py``), a CUDA tensor the hand-written kernel, and a
kernel that cannot build or launch raises. Nothing falls back quietly.
``launch_counts()`` reports the kernel launches since
``reset_launch_counts()``.

The entry points that take ``spec=`` (an AffinitySpec) read its kind and
sigma. The port builds dense fixed-bandwidth tiles only, so a spec with an
adaptive bandwidth or a kNN truncation, and the streaming operands that
realize those policies (``scale_r``, ``scale_c``, ``thr``, ``thr_c``),
raise NotImplementedError instead of losing the policy without a word.
"""
from __future__ import annotations

from ._build import launch_counts, reset_launch_counts
from .affinity import affinity_and_degree as _affinity_and_degree
from .gram import gram
from .kmeans_assign import kmeans_assign
from .power_step import degree_normalized_matmat
from .streaming import affinity_degree_streaming, affinity_matmat

__all__ = [
    "affinity_and_degree",
    "degree_normalized_matmat",
    "gram",
    "kmeans_assign",
    "launch_counts",
    "reset_launch_counts",
    "streaming_degree",
    "streaming_matmat",
]


def _dense_kind_sigma(spec, kind, sigma, **policy_operands):
    """(kind, sigma) from ``spec`` when given; raise NotImplementedError for
    a graph policy this slice does not build."""
    given = sorted(name for name, value in policy_operands.items() if value is not None)
    if spec is not None and not spec.dense_fixed:
        given.append(f"spec={spec}")
    if given:
        raise NotImplementedError(
            f"adaptive-bandwidth and kNN-truncated tiles are not ported yet "
            f"(ROADMAP queue 1 item 5, graph policies); got {', '.join(given)}")
    if spec is not None:
        return spec.kind, float(spec.sigma)
    return kind, sigma


def affinity_and_degree(xn, xc=None, *, kind="cosine_shifted", sigma=1.0,
                        spec=None, row_offset=0, col_offset=0):
    """Fused A + D build. See kernels/affinity.py."""
    kind, sigma = _dense_kind_sigma(spec, kind, sigma)
    return _affinity_and_degree(xn, xc, kind=kind, sigma=sigma,
                                row_offset=row_offset, col_offset=col_offset)


def streaming_matmat(x, v, d=None, xc=None, *, kind="cosine_shifted", sigma=1.0,
                     spec=None, scale_r=None, scale_c=None, thr=None, thr_c=None,
                     row_offset=0, col_offset=0):
    """U = (A V)/d with A rebuilt tile by tile, never stored. With ``xc``
    given, the stripe at (row_offset, col_offset) against the column
    features xc; ``d=None`` leaves the product unnormalized. See
    kernels/streaming.py."""
    kind, sigma = _dense_kind_sigma(spec, kind, sigma, scale_r=scale_r, scale_c=scale_c,
                                    thr=thr, thr_c=thr_c)
    return affinity_matmat(x, v, d, xc, kind=kind, sigma=sigma,
                           row_offset=row_offset, col_offset=col_offset)


def streaming_degree(x, xc=None, *, kind="cosine_shifted", sigma=1.0, spec=None,
                     scale_r=None, scale_c=None, thr=None, row_offset=0, col_offset=0):
    """Degree vector D = A 1 in one streamed sweep (the row sums of
    ``affinity_and_degree`` without A). See kernels/streaming.py."""
    kind, sigma = _dense_kind_sigma(spec, kind, sigma, scale_r=scale_r,
                                    scale_c=scale_c, thr=thr)
    return affinity_degree_streaming(x, xc, kind=kind, sigma=sigma,
                                     row_offset=row_offset, col_offset=col_offset)
