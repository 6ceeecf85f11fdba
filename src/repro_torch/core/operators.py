"""PowerOperator builders: each GPIC engine as one binding of the loop.

This slice ports the two local engines with a dense fixed-bandwidth spec:

  explicit   build A and its degrees once with the fused affinity kernel,
             then one degree-normalized mat-mat kernel per sweep;
  streaming  never store A: one streamed degree kernel, then one streaming
             mat-mat kernel per sweep that rebuilds every tile from the
             features. Peak memory O(n m + n r).

Both bind the Gram kernel for the block algebra of the orthogonal mode.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from .affinity import AffinityKind, AffinitySpec, as_affinity_spec
from .power import PowerOperator


def _dense_spec(spec, kind, sigma) -> AffinitySpec:
    spec = as_affinity_spec(spec, kind=kind, sigma=sigma)
    if not spec.dense_fixed:
        raise NotImplementedError(
            "adaptive-bandwidth and kNN-truncated affinity specs are not "
            "ported yet (ROADMAP queue 1 item 5, graph policies); got "
            f"{spec}")
    return spec


def explicit_operator(inp: torch.Tensor, *, spec: AffinitySpec | None = None,
                      kind: AffinityKind = "cosine_shifted",
                      sigma: float = 1.0,
                      a_dtype: torch.dtype = torch.float32) -> PowerOperator:
    """Paper-faithful: build A once, then fused degree-normalized mat-mat
    sweeps. ``inp`` is row-normalized features for the cosine kinds, raw
    features for rbf."""
    spec = _dense_spec(spec, kind, sigma)
    if a_dtype != torch.float32:
        raise NotImplementedError(
            f"A storage in {a_dtype} is not ported yet (ROADMAP queue 1 "
            "item 13, bf16 A storage); this slice stores A in float32")
    a, d = ops.affinity_and_degree(inp.contiguous(), spec=spec)

    def matmat(v):
        return ops.degree_normalized_matmat(a, v.contiguous(), d)

    return PowerOperator(matmat=matmat, degree=d, gram=ops.gram)


def streaming_operator(inp: torch.Tensor, *, spec: AffinitySpec | None = None,
                       kind: AffinityKind = "cosine_shifted",
                       sigma: float = 1.0) -> PowerOperator:
    """A-free: the degrees in one streamed pass, then every sweep rebuilds
    the affinity tiles from the feature rows. Same input convention as
    :func:`explicit_operator`; the same degrees and sweep outputs, bitwise,
    on the card."""
    spec = _dense_spec(spec, kind, sigma)
    inp = inp.contiguous()
    d = ops.streaming_degree(inp, spec=spec)

    def matmat(v):
        return ops.streaming_matmat(inp, v.contiguous(), d, spec=spec)

    return PowerOperator(matmat=matmat, degree=d, gram=ops.gram)
