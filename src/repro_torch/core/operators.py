"""PowerOperator builders: each GPIC engine as one binding of the loop.

The two local engines, for every affinity spec:

  explicit   build A and its degrees once with the fused affinity kernel,
             then one degree-normalized mat-mat kernel per sweep;
  streaming  never store A: one streamed degree kernel, then one streaming
             mat-mat kernel per sweep that rebuilds every tile from the
             features. Peak memory O(n m + n r).

A spec with a graph policy first runs pass 1 (``core/graph.py``: the
streamed row top-k for the adaptive scales and the kNN thresholds), and
both engines then apply scale and mask in the tile. A truncated spec also
binds ``matmat_t``, the transpose product that the component probe walks
(the kNN graph is directed): ``A^T V`` on the stored A (explicit), or the
streaming kernel with the column thresholds (streaming, still A-free).

The reference stores and sweeps a truncated graph block-sparse by default
(``block_sparse=True``); that route is not ported yet, and this module
raises for it rather than take the dense route that was not asked for.

Both engines bind the Gram kernel for the block algebra of the orthogonal
mode.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from .affinity import AffinityKind, AffinitySpec, as_affinity_spec
from .graph import affinity_stats
from .power import PowerOperator


def check_block_sparse(spec: AffinitySpec, block_sparse: bool) -> None:
    """Raise for the block-sparse route of a truncated spec (a dense spec
    has no block-sparse route and ignores the flag, as in the reference)."""
    if block_sparse and spec.truncated:
        raise NotImplementedError(
            "the block-sparse route of a kNN-truncated spec (block_sparse=True, the "
            "reference's default) is not ported yet (ROADMAP queue 1 item 7, "
            "block-sparse and row reorder); pass block_sparse=False for the "
            f"dense-storage two-pass route; got {spec}")


def explicit_operator(inp: torch.Tensor, *, spec: AffinitySpec | None = None,
                      kind: AffinityKind = "cosine_shifted",
                      sigma: float = 1.0,
                      a_dtype: torch.dtype = torch.float32,
                      block_sparse: bool = True) -> PowerOperator:
    """Paper-faithful: build A once, then fused degree-normalized mat-mat
    sweeps. ``inp`` is row-normalized features for the cosine kinds, raw
    features for rbf."""
    spec = as_affinity_spec(spec, kind=kind, sigma=sigma)
    check_block_sparse(spec, block_sparse)
    if a_dtype != torch.float32:
        raise NotImplementedError(
            f"A storage in {a_dtype} is not ported yet (ROADMAP queue 1 "
            "item 13, bf16 A storage); this slice stores A in float32")
    inp = inp.contiguous()
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
    the affinity tiles from the feature rows. Same input convention as
    :func:`explicit_operator`; the same degrees and sweep outputs, bitwise,
    on the card."""
    spec = as_affinity_spec(spec, kind=kind, sigma=sigma)
    check_block_sparse(spec, block_sparse)
    inp = inp.contiguous()
    scale, thr = affinity_stats(inp, spec)
    d = ops.streaming_degree(inp, spec=spec, scale_r=scale, scale_c=scale, thr=thr)

    def matmat(v):
        return ops.streaming_matmat(inp, v.contiguous(), d, spec=spec, scale_r=scale,
                                    scale_c=scale, thr=thr)

    matmat_t = None
    if spec.truncated:
        def matmat_t(v):
            return ops.streaming_matmat(inp, v.contiguous(), None, spec=spec,
                                        scale_r=scale, scale_c=scale, thr_c=thr)

    return PowerOperator(matmat=matmat, degree=d, gram=ops.gram, matmat_t=matmat_t)
