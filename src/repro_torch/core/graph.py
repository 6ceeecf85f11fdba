"""Affinity-graph construction (pass 1, the fused truncated build) and the
graph-aware row reorder.

An :class:`~repro_torch.core.affinity.AffinitySpec` with a graph policy
needs one or two per-row statistics before the build (pass 2) can apply
it in the tile:

  pass 1a  adaptive local scales   sigma_i = ||x_i - x_(scale_k)||
           from the streamed row top-k of -d2 (stat='neg_sqdist')
  pass 1b  truncation thresholds   tau_i = the row's knn_k-th largest
           similarity (stat='similarity', adaptive scales applied)

Both stream through ``kernels.ops.row_topk``: no (n, n) array is
allocated, so the streaming engine keeps its O(n m) residency. The dense
fixed-bandwidth spec skips pass 1 (``affinity_stats`` returns
(None, None)) and pass 2 runs the dense kernels unchanged. The dense plain
oracles are ``local_scales`` and ``knn_thresholds`` in core/affinity.py.

The explicit engine's block-sparse route builds a truncated A in one pass
instead (``fused_affinity_build``): the stripe unmasked, the thresholds
from its stored scores, the mask in place, then the degrees.

The row reorder (``graph_reorder_permutation``) computes a permutation of
the rows from their content only, so two orderings of the same points are
clustered as one canonical array, and neighbouring points share tiles
(the block-sparse plan skips a tile only when all its entries are dead).
"""
from __future__ import annotations

import torch

from ..kernels import ops
from ..kernels.row_topk import topk_thresholds_from_scores
from .affinity import SCALE_FLOOR, AffinitySpec
from .health import graph_component_probe


def scales_from_topk(neg_sqdist_topk: torch.Tensor) -> torch.Tensor:
    """(R,) adaptive local scales from an (R, k) neg-sq-dist top-k buffer:
    sigma_i = sqrt(k-th smallest d2), floored at ``SCALE_FLOOR`` so
    duplicated points cannot zero the sigma_i * sigma_j denominator."""
    kth = torch.clamp_min(-neg_sqdist_topk[:, -1], 0.0)
    return torch.clamp_min(torch.sqrt(kth), SCALE_FLOOR)


def adaptive_scales(x: torch.Tensor, spec: AffinitySpec) -> torch.Tensor | None:
    """(n,) f32 pass-1a local scales of ``x`` from the streamed row top-k,
    or None for a fixed bandwidth."""
    if not spec.adaptive:
        return None
    return scales_from_topk(ops.row_topk(x, k=spec.scale_k, stat="neg_sqdist", spec=spec))


def affinity_stats(x: torch.Tensor, spec: AffinitySpec
                   ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """(scale, thr) pass-1 statistics for the square self-affinity of
    ``x``, each (n,) f32 and contiguous, or None when the spec does not
    need it; the dense fixed spec launches nothing."""
    scale, thr = adaptive_scales(x, spec), None
    if spec.truncated:
        tk = ops.row_topk(x, k=spec.knn_k, stat="similarity", spec=spec,
                          scale_r=scale, scale_c=scale)
        thr = tk[:, -1].contiguous()
    return scale, thr


def fused_affinity_build(x: torch.Tensor, xc: torch.Tensor | None = None, *,
                         spec: AffinitySpec, scale_r: torch.Tensor | None = None,
                         scale_c: torch.Tensor | None = None, row_offset: int = 0,
                         col_offset: int = 0, a_dtype: torch.dtype = torch.float32
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(A, D, thr): the one-pass truncated build of the explicit engine's
    block-sparse route, the same values as the two-pass build (pass 1b,
    then the thresholded build):

      1. the stripe unmasked (the affinity kernel without ``thr``);
      2. ``thr`` from its stored scores (``topk_thresholds_from_scores``,
         the diagonal excluded by index): an exact selection of the
         entries the row top-k scores bit for bit;
      3. the mask ``a >= thr[:, None]`` applied in place, 4,096 rows at
         a time (a NaN entry or threshold drops the entry, as the kernels'
         compare does), so the build holds one A;
      4. D = A 1 in the build kernel's row-sum order
         (``ops.stored_degree``);
      5. A cast to ``a_dtype`` (bf16: O4), after D, so D is the masked
         f32 A's row sum as in the reference, not the sum of the rounded
         entries. The f32 and the bf16 A exist together during the cast
         (12.2 GB at n = 45,000), as in the reference.

    Adaptive scales stay the caller's (pass 1a has no build to fuse with)."""
    if not spec.truncated:
        raise ValueError(f"fused_affinity_build is the truncated-spec build, got {spec}")
    a, _ = ops.affinity_and_degree(x, xc, spec=spec, scale_r=scale_r, scale_c=scale_c,
                                   row_offset=row_offset, col_offset=col_offset)
    thr = topk_thresholds_from_scores(a, k=spec.knn_k, row_offset=row_offset,
                                      col_offset=col_offset)
    for r0 in range(0, a.shape[0], 4096):
        blk = a[r0:r0 + 4096]
        blk.masked_fill_(~(blk >= thr[r0:r0 + 4096, None]), 0.0)
    d = ops.stored_degree(a)
    return a.to(a_dtype), d, thr


def content_row_score(x: torch.Tensor) -> torch.Tensor:
    """(n,) per-row ordering score that depends on row content only: the
    squared distance to the per-column median. The median is the midpoint
    of the two middle values of each sorted column ((lo + hi) * 0.5, as
    ``jnp.median`` computes it; ``torch.median`` would return the lower
    one), so it depends on the value multiset only, and the row sum runs
    over the fixed column axis."""
    xf = x.float()
    srt = torch.sort(xf, dim=0).values
    n = xf.shape[0]
    med = (srt[(n - 1) // 2] + srt[n // 2]) * 0.5
    return torch.sum((xf - med) ** 2, dim=1)


def reorder_permutation(score: torch.Tensor, components: torch.Tensor | None = None, *,
                        max_components: int = 16) -> torch.Tensor:
    """The canonical row permutation from content scores, grouped by graph
    component when ``components`` (the probe's ids, -1 for rows it never
    reached) is given.

    Without components: a stable argsort of ``score``. With them, rows
    group by component and sort by score inside a group. Component ids
    follow the probe's seeding order, which depends on the input order, so
    each group is keyed by its smallest member score (content-only when the
    probe converges); unreached rows sort after every group, by score.
    This is the reference's ``lexsort((score, group_key))``: a stable sort
    by score, then a stable sort of that by group key."""
    score = score.float()
    by_score = torch.argsort(score, stable=True)
    if components is None:
        return by_score
    comp = components.long() + 1
    comp_min = torch.full((max_components + 2,), torch.inf, dtype=torch.float32,
                          device=score.device).scatter_reduce(0, comp, score, reduce="amin")
    group_key = torch.where(components < 0, torch.inf, comp_min[comp])
    return by_score[torch.argsort(group_key[by_score], stable=True)]


def graph_reorder_permutation(x: torch.Tensor, spec: AffinitySpec, *,
                              max_components: int = 16) -> torch.Tensor:
    """The row-reorder pass of one device: content scores, grouped by the
    component probe's components for a truncated spec. The probe runs on
    the dense-grid streaming operator (A-free; the block plan is what the
    reorder is for, so the permutation must not depend on it), built on
    ``x`` as given, as the reference builds it. A dense spec has one
    component and skips the probe."""
    score = content_row_score(x)
    if not spec.truncated:
        return reorder_permutation(score)
    from .operators import streaming_operator  # operators imports this module
    op = streaming_operator(x, spec=spec, block_sparse=False)
    _, comp = graph_component_probe(op, x.shape[0], max_components=max_components)
    return reorder_permutation(score, comp, max_components=max_components)
