"""Two-pass affinity-graph construction: pass 1, the per-row statistics.

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
"""
from __future__ import annotations

import torch

from ..kernels import ops
from .affinity import SCALE_FLOOR, AffinitySpec


def scales_from_topk(neg_sqdist_topk: torch.Tensor) -> torch.Tensor:
    """(R,) adaptive local scales from an (R, k) neg-sq-dist top-k buffer:
    sigma_i = sqrt(k-th smallest d2), floored at ``SCALE_FLOOR`` so
    duplicated points cannot zero the sigma_i * sigma_j denominator."""
    kth = torch.clamp_min(-neg_sqdist_topk[:, -1], 0.0)
    return torch.clamp_min(torch.sqrt(kth), SCALE_FLOOR)


def affinity_stats(x: torch.Tensor, spec: AffinitySpec
                   ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """(scale, thr) pass-1 statistics for the square self-affinity of
    ``x``, each (n,) f32 and contiguous, or None when the spec does not
    need it; the dense fixed spec launches nothing."""
    scale = thr = None
    if spec.adaptive:
        scale = scales_from_topk(ops.row_topk(x, k=spec.scale_k, stat="neg_sqdist",
                                              spec=spec))
    if spec.truncated:
        tk = ops.row_topk(x, k=spec.knn_k, stat="similarity", spec=spec,
                          scale_r=scale, scale_c=scale)
        thr = tk[:, -1].contiguous()
    return scale, thr
