"""PowerOperator builders: each GPIC engine as one binding of the loop.

The three local engines (matrix-free: the factorable specs only):

  explicit   build A and its degrees once with the fused affinity kernel,
             then one degree-normalized mat-mat kernel per sweep;
  streaming  never store A: one streamed degree kernel, then one streaming
             mat-mat kernel per sweep that rebuilds every tile from the
             features. Peak memory O(n m + n r).
  matrix_free  the factored product A V = f(X (X^T V)) - V of the cosine
             kinds (``core/affinity.py::matmat_matrix_free``): two skinny
             f32 matmuls a sweep, O(n m r) work, no A and no sweep kernel.

A spec with a graph policy first runs pass 1 (``core/graph.py``: the
streamed row top-k for the adaptive scales and the kNN thresholds), and
both engines then apply scale and mask in the tile. A truncated spec also
binds ``matmat_t``, the transpose product that the component probe walks
(the kNN graph is directed): ``A^T V`` on the stored A (explicit), or the
streaming kernel with the column thresholds (streaming, still A-free).

A truncated spec takes the block-sparse route by default
(``block_sparse=True``, as in the reference): the sweeps visit only the
live tiles of a block plan on the (16, 256) grid (``core/affinity.py``).
The explicit engine builds A in one pass (``core/graph.py::
fused_affinity_build``) and plans from the stored A; the streaming engine
runs pass 1, then the A-free liveness kernel, and takes its degrees and
sweeps from the block-sparse streaming kernels. Both give the dense route's
results bit for bit on the card. A grid of a single column tile (n <= 256)
has nothing to skip and keeps the dense route, as in the reference.

Every engine binds the Gram kernel for the block algebra of the orthogonal
mode.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from .affinity import (AffinityKind, AffinitySpec, as_affinity_spec, block_plan,
                       dense_block_live, matmat_matrix_free)
from .graph import adaptive_scales, affinity_stats, fused_affinity_build
from .power import PowerOperator


def uses_block_sparse(n: int, spec: AffinitySpec, block_sparse: bool) -> bool:
    """Whether a run of n points takes the block-sparse route: a truncated
    spec with ``block_sparse`` on more than one column tile."""
    return block_sparse and spec.truncated and n > ops.TN


def explicit_operator(inp: torch.Tensor, *, spec: AffinitySpec | None = None,
                      kind: AffinityKind = "cosine_shifted",
                      sigma: float = 1.0,
                      a_dtype: torch.dtype = torch.float32,
                      block_sparse: bool = True) -> PowerOperator:
    """Paper-faithful: build A once, then fused degree-normalized mat-mat
    sweeps. ``inp`` is row-normalized features for the cosine kinds, raw
    features for rbf. On the block-sparse route A is built in one pass
    (the thresholds from its stored scores) and the sweeps read only its
    live tiles; the probe's transpose product is ``A.T @ v`` either way."""
    spec = as_affinity_spec(spec, kind=kind, sigma=sigma)
    if a_dtype != torch.float32:
        raise NotImplementedError(
            f"A storage in {a_dtype} is not ported yet (ROADMAP queue 1 "
            "item 13, bf16 A storage); this slice stores A in float32")
    inp = inp.contiguous()
    if uses_block_sparse(inp.shape[0], spec, block_sparse):
        scale = adaptive_scales(inp, spec)
        a, d, _ = fused_affinity_build(inp, spec=spec, scale_r=scale, scale_c=scale)
        counts, col_idx, _ = block_plan(dense_block_live(a, ops.PLAN_TM, ops.TN))

        def matmat(v):
            return ops.block_sparse_matmat(a, v.contiguous(), d, counts, col_idx)
    else:
        scale, thr = affinity_stats(inp, spec)
        a, d = ops.affinity_and_degree(inp, spec=spec, scale_r=scale, scale_c=scale, thr=thr)

        def matmat(v):
            return ops.degree_normalized_matmat(a, v.contiguous(), d)

    matmat_t = None
    if spec.truncated:
        def matmat_t(v):
            # probe-frequency work (a few hundred products at most), plain
            # torch as the reference leaves it to XLA
            return a.T @ v.float()

    return PowerOperator(matmat=matmat, degree=d, gram=ops.gram, matmat_t=matmat_t)


def streaming_operator(inp: torch.Tensor, *, spec: AffinitySpec | None = None,
                       kind: AffinityKind = "cosine_shifted",
                       sigma: float = 1.0,
                       block_sparse: bool = True) -> PowerOperator:
    """A-free: the degrees in one streamed pass, then every sweep rebuilds
    the affinity tiles from the feature rows (on the block-sparse route
    only the live ones, after one liveness pass). Same input convention as
    :func:`explicit_operator`; the same degrees and sweep outputs, bitwise,
    on the card. The probe's transpose product stays the dense-grid
    column-thresholded stream on either route, as in the reference."""
    spec = as_affinity_spec(spec, kind=kind, sigma=sigma)
    inp = inp.contiguous()
    scale, thr = affinity_stats(inp, spec)
    pol = dict(spec=spec, scale_r=scale, scale_c=scale, thr=thr)
    if uses_block_sparse(inp.shape[0], spec, block_sparse):
        counts, col_idx, _ = block_plan(ops.block_liveness(inp, **pol))
        d = ops.block_sparse_streaming_degree(inp, counts=counts, col_idx=col_idx, **pol)

        def matmat(v):
            return ops.block_sparse_streaming_matmat(inp, v.contiguous(), d, counts=counts,
                                                     col_idx=col_idx, **pol)
    else:
        d = ops.streaming_degree(inp, **pol)

        def matmat(v):
            return ops.streaming_matmat(inp, v.contiguous(), d, **pol)

    matmat_t = None
    if spec.truncated:
        def matmat_t(v):
            return ops.streaming_matmat(inp, v.contiguous(), None, spec=spec,
                                        scale_r=scale, scale_c=scale, thr_c=thr)

    return PowerOperator(matmat=matmat, degree=d, gram=ops.gram, matmat_t=matmat_t)


def matrix_free_operator(xn: torch.Tensor, *, spec: AffinitySpec | None = None,
                         kind: AffinityKind = "cosine_shifted") -> PowerOperator:
    """The factored sweep (A V) / max(d, 1e-30) with d = A 1, both from
    :func:`~repro_torch.core.affinity.matmat_matrix_free`: factorable specs
    only (the rejection lives there). ``xn`` must be row-normalized. The
    sweep is two plain f32 matmuls, as in the reference, which has no
    kernel for it; the Gram is the kernel's."""
    spec = as_affinity_spec(spec, kind=kind)
    n = xn.shape[0]
    d = matmat_matrix_free(xn, torch.ones((n,), dtype=xn.dtype, device=xn.device), spec)

    def matmat(v):
        return matmat_matrix_free(xn, v, spec) / torch.clamp_min(d, 1e-30)[:, None]

    return PowerOperator(matmat=matmat, degree=d, gram=ops.gram)
