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
    """Paper-faithful: build A once, stored in ``a_dtype`` (f32, or bf16:
    the reference's O4, half the memory and the sweep's bytes; D stays
    f32), then fused degree-normalized mat-mat sweeps, which widen each
    entry to f32 as they read it. ``inp`` is row-normalized features for
    the cosine kinds, raw features for rbf. On the block-sparse route A is
    built in one pass (the thresholds from its stored scores) and the
    sweeps read only its live tiles; the probe's transpose product is
    ``A^T v`` either way."""
    spec = as_affinity_spec(spec, kind=kind, sigma=sigma)
    inp = inp.contiguous()
    if uses_block_sparse(inp.shape[0], spec, block_sparse):
        scale = adaptive_scales(inp, spec)
        a, d, _ = fused_affinity_build(inp, spec=spec, scale_r=scale, scale_c=scale,
                                       a_dtype=a_dtype)
        counts, col_idx, _ = block_plan(dense_block_live(a, ops.PLAN_TM, ops.TN))

        def matmat(v):
            return ops.block_sparse_matmat(a, v.contiguous(), d, counts, col_idx)
    else:
        scale, thr = affinity_stats(inp, spec)
        a, d = ops.affinity_and_degree(inp, spec=spec, scale_r=scale, scale_c=scale, thr=thr,
                                       out_dtype=a_dtype)

        def matmat(v):
            return ops.degree_normalized_matmat(a, v.contiguous(), d)

    matmat_t = None
    if spec.truncated:
        def matmat_t(v):
            return transpose_matmat(a, v)

    return PowerOperator(matmat=matmat, degree=d, gram=ops.gram, matmat_t=matmat_t)


def transpose_matmat(a: torch.Tensor, v: torch.Tensor, *, stripe: int = 4096) -> torch.Tensor:
    """A^T V in f32 for a stored A: the component probe's transpose product,
    probe-frequency work (a few hundred products at most), plain torch as
    the reference leaves it to XLA. An f32 A takes one ``a.T @ v``; a bf16
    A is upcast ``stripe`` rows at a time (the sum of the stripes' A_s^T
    V_s), so the f32 temporary is one stripe (0.74 GB at n = 45,000), not
    a second A."""
    v = v.float()
    if a.dtype == torch.float32:
        return a.T @ v
    out = torch.zeros((a.shape[1], v.shape[1]), dtype=torch.float32, device=a.device)
    for r0 in range(0, a.shape[0], stripe):
        out += a[r0:r0 + stripe].float().T @ v[r0:r0 + stripe]
    return out


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
