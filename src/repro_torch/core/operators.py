"""PowerOperator builders: each GPIC engine as one binding of the loop.

This slice ports the local explicit engine with a dense fixed-bandwidth
spec: build A and its degrees once with the fused affinity kernel, then
one degree-normalized mat-mat kernel per sweep.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from .affinity import AffinityKind, AffinitySpec, as_affinity_spec
from .power import PowerOperator


def explicit_operator(inp: torch.Tensor, *, spec: AffinitySpec | None = None,
                      kind: AffinityKind = "cosine_shifted",
                      sigma: float = 1.0,
                      a_dtype: torch.dtype = torch.float32) -> PowerOperator:
    """Paper-faithful: build A once, then fused degree-normalized mat-mat
    sweeps. ``inp`` is row-normalized features for the cosine kinds, raw
    features for rbf."""
    spec = as_affinity_spec(spec, kind=kind, sigma=sigma)
    if not spec.dense_fixed:
        raise NotImplementedError(
            "adaptive-bandwidth and kNN-truncated affinity specs are not "
            "ported yet (ROADMAP queue 1 item 5, graph policies); got "
            f"{spec}")
    if a_dtype != torch.float32:
        raise NotImplementedError(
            f"A storage in {a_dtype} is not ported yet (ROADMAP queue 1 "
            "item 13, bf16 A storage); this slice stores A in float32")
    a, d = ops.affinity_and_degree(inp.contiguous(), spec=spec)

    def matmat(v):
        return ops.degree_normalized_matmat(a, v.contiguous(), d)

    return PowerOperator(matmat=matmat, degree=d)
