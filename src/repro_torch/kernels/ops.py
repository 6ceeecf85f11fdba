"""The kernel entry points ``core/`` calls.

Dispatch is by the tensor's device: a CPU tensor runs the plain PyTorch
version (``kernels/ref.py``), a CUDA tensor the hand-written kernel, and a
kernel that cannot build or launch raises. Nothing falls back quietly.
``launch_counts()`` reports the kernel launches since
``reset_launch_counts()``.

The entry points that take ``spec=`` (an AffinitySpec) read its kind and
sigma; the graph policies travel as operands, as in the reference:
``scale_r``/``scale_c`` (adaptive scales, from ``row_topk`` with
``stat='neg_sqdist'``), ``thr`` (the kNN row thresholds, from ``row_topk``
with ``stat='similarity'``) and ``thr_c`` (column thresholds: the
transpose product of the component probe). The block-sparse entry points
take a plan (``counts``, ``col_idx`` from ``core/affinity.py::block_plan``)
on the (16, 256) grid of ``kernels/block_sparse.py``. ``flash_attention``
is the LM's: causal grouped-query attention (kernels/flash_attention.py).
"""
from __future__ import annotations

import torch

from ._build import launch_counts, reset_launch_counts
from .affinity import affinity_and_degree as _affinity_and_degree
from .block_sparse import PLAN_TM, TN, block_sparse_matmat
from .block_sparse import block_liveness as _block_liveness
from .block_sparse import block_sparse_streaming_degree as _bs_streaming_degree
from .block_sparse import block_sparse_streaming_matmat as _bs_streaming_matmat
from .flash_attention import flash_attention
from .gram import gram
from .kmeans_assign import kmeans_assign
from .power_step import (degree_normalized_matmat, degree_normalized_matvec, power_step,
                         stored_degree)
from .row_topk import row_topk as _row_topk
from .streaming import affinity_degree_streaming, affinity_matmat

__all__ = [
    "PLAN_TM",
    "TN",
    "affinity_and_degree",
    "block_liveness",
    "block_sparse_matmat",
    "block_sparse_streaming_degree",
    "block_sparse_streaming_matmat",
    "degree_normalized_matmat",
    "degree_normalized_matvec",
    "flash_attention",
    "gram",
    "kmeans_assign",
    "launch_counts",
    "power_step",
    "reset_launch_counts",
    "row_topk",
    "stored_degree",
    "streaming_degree",
    "streaming_matmat",
]


def _spec_kind_sigma(spec, kind, sigma):
    """(kind, sigma) from ``spec`` when given, else the keywords."""
    if spec is not None:
        return spec.kind, float(spec.sigma)
    return kind, sigma


def affinity_and_degree(xn, xc=None, *, kind="cosine_shifted", sigma=1.0, spec=None,
                        scale_r=None, scale_c=None, thr=None, row_offset=0, col_offset=0,
                        out_dtype=torch.float32):
    """Fused A + D build, A stored in ``out_dtype`` (f32 or bf16). See
    kernels/affinity.py."""
    kind, sigma = _spec_kind_sigma(spec, kind, sigma)
    return _affinity_and_degree(xn, xc, kind=kind, sigma=sigma, row_offset=row_offset,
                                col_offset=col_offset, scale_r=scale_r, scale_c=scale_c,
                                thr=thr, out_dtype=out_dtype)


def streaming_matmat(x, v, d=None, xc=None, *, kind="cosine_shifted", sigma=1.0,
                     spec=None, scale_r=None, scale_c=None, thr=None, thr_c=None,
                     row_offset=0, col_offset=0):
    """U = (A V)/d with A rebuilt tile by tile, never stored. With ``xc``
    given, the stripe at (row_offset, col_offset) against the column
    features xc; ``d=None`` leaves the product unnormalized. See
    kernels/streaming.py."""
    kind, sigma = _spec_kind_sigma(spec, kind, sigma)
    return affinity_matmat(x, v, d, xc, kind=kind, sigma=sigma, row_offset=row_offset,
                           col_offset=col_offset, scale_r=scale_r, scale_c=scale_c,
                           thr=thr, thr_c=thr_c)


def streaming_degree(x, xc=None, *, kind="cosine_shifted", sigma=1.0, spec=None,
                     scale_r=None, scale_c=None, thr=None, row_offset=0, col_offset=0):
    """Degree vector D = A 1 in one streamed sweep (the row sums of
    ``affinity_and_degree`` without A). See kernels/streaming.py."""
    kind, sigma = _spec_kind_sigma(spec, kind, sigma)
    return affinity_degree_streaming(x, xc, kind=kind, sigma=sigma, row_offset=row_offset,
                                     col_offset=col_offset, scale_r=scale_r,
                                     scale_c=scale_c, thr=thr)


def row_topk(x, xc=None, *, k, stat="similarity", kind="cosine_shifted", sigma=1.0,
             spec=None, scale_r=None, scale_c=None, row_offset=0, col_offset=0):
    """(R, k) per-row descending top-k scores, streamed: pass 1 of the
    two-pass graph build. See kernels/row_topk.py."""
    kind, sigma = _spec_kind_sigma(spec, kind, sigma)
    return _row_topk(x, xc, k=k, stat=stat, kind=kind, sigma=sigma, row_offset=row_offset,
                     col_offset=col_offset, scale_r=scale_r, scale_c=scale_c)


def block_liveness(x, xc=None, *, kind="cosine_shifted", sigma=1.0, spec=None, scale_r=None,
                   scale_c=None, thr=None, row_offset=0, col_offset=0):
    """(nI, nJ) int32 live-tile map of the masked stripe, A-free: the
    streaming engine's plan source. See kernels/block_sparse.py."""
    kind, sigma = _spec_kind_sigma(spec, kind, sigma)
    return _block_liveness(x, xc, kind=kind, sigma=sigma, row_offset=row_offset,
                           col_offset=col_offset, scale_r=scale_r, scale_c=scale_c, thr=thr)


def block_sparse_streaming_matmat(x, v, d=None, xc=None, *, counts, col_idx,
                                  kind="cosine_shifted", sigma=1.0, spec=None, scale_r=None,
                                  scale_c=None, thr=None, row_offset=0, col_offset=0):
    """``streaming_matmat`` over the plan's live tiles only. See
    kernels/block_sparse.py."""
    kind, sigma = _spec_kind_sigma(spec, kind, sigma)
    return _bs_streaming_matmat(x, v, d, xc, counts=counts, col_idx=col_idx, kind=kind,
                                sigma=sigma, row_offset=row_offset, col_offset=col_offset,
                                scale_r=scale_r, scale_c=scale_c, thr=thr)


def block_sparse_streaming_degree(x, xc=None, *, counts, col_idx, kind="cosine_shifted",
                                  sigma=1.0, spec=None, scale_r=None, scale_c=None, thr=None,
                                  row_offset=0, col_offset=0):
    """``streaming_degree`` over the plan's live tiles only. See
    kernels/block_sparse.py."""
    kind, sigma = _spec_kind_sigma(spec, kind, sigma)
    return _bs_streaming_degree(x, xc, counts=counts, col_idx=col_idx, kind=kind, sigma=sigma,
                                row_offset=row_offset, col_offset=col_offset, scale_r=scale_r,
                                scale_c=scale_c, thr=thr)
