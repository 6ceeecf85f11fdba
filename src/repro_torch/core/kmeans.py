"""k-means (kmeans++ init + Lloyd iterations) on the kernel entry points.

The final step of GPIC: cluster the power-iteration embedding. The Lloyd
assignment step dispatches through ``kernels.ops.kmeans_assign`` (the CUDA
kernel for a tensor on the card, its plain version on the CPU); the
centroid update is plain PyTorch. The reference's ``lax.scan`` is a Python
loop here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops


def kmeans_plus_plus_init(x: torch.Tensor, k: int, *,
                          generator: torch.Generator | None = None) -> torch.Tensor:
    """kmeans++ seeding: iteratively sample points proportional to D^2."""
    n = x.shape[0]
    first = torch.randint(0, n, (1,), generator=generator, device=x.device)
    cents = x[first].repeat(k, 1)
    mind2 = torch.full((n,), float("inf"), dtype=x.dtype, device=x.device)
    for i in range(1, k):
        d2_new = torch.sum((x - cents[i - 1]) ** 2, dim=1)
        mind2 = torch.minimum(mind2, d2_new)
        p = mind2 / torch.clamp_min(torch.sum(mind2), 1e-30)
        # all-zero weights (every point on a centroid) draw uniformly
        # instead of tripping multinomial's positive-sum check
        p = torch.where(torch.sum(p) > 0, p, torch.ones_like(p))
        idx = torch.multinomial(p, 1, generator=generator)
        cents[i] = x[idx[0]]
    return cents


def _canonicalize(labels: torch.Tensor, cents: torch.Tensor, k: int):
    """Relabel clusters in order of first appearance (point 0's cluster
    becomes id 0, the next unseen cluster id 1, ...), so that ids depend
    only on the partition. Centroids are permuted to match. Empty clusters
    sort last (stable)."""
    n = labels.shape[0]
    ar_n = torch.arange(n, device=labels.device)
    ar_k = torch.arange(k, device=labels.device)
    first = torch.amin(
        torch.where(labels[None, :] == ar_k[:, None], ar_n[None, :], n), dim=1)
    order = torch.argsort(first, stable=True)     # old ids by first appearance
    rank = torch.argsort(order, stable=True)      # old id -> canonical id
    return rank[labels.long()].to(torch.int32), cents[order]


def kmeans(x: torch.Tensor, k: int, iters: int = 25, *,
           generator: torch.Generator | None = None,
           init: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's algorithm. Returns (labels (n,) int32, centroids (k, d)).

    An emptied cluster is reseeded to the point farthest from its assigned
    centroid (the i-th emptied cluster takes the i-th farthest point).
    ``init`` overrides the kmeans++ seeding with explicit (k, d) starting
    centroids. Labels are canonicalized by first appearance.
    """
    x = x.to(torch.float32).contiguous()
    n = x.shape[0]
    if init is None:
        cents = kmeans_plus_plus_init(x, k, generator=generator)
    else:
        cents = torch.as_tensor(init, dtype=torch.float32).to(x.device)
    cents = cents.contiguous()
    for _ in range(iters):
        assign, d2 = ops.kmeans_assign(x, cents)
        onehot = F.one_hot(assign.long(), k).to(x.dtype)         # (n, k)
        counts = torch.sum(onehot, dim=0)                         # (k,)
        sums = onehot.T @ x                                       # (k, d)
        empty = counts == 0
        # farthest-point reseed: i-th empty slot takes the i-th farthest
        # point (stable sort — deterministic under ties)
        order = torch.argsort(-d2, stable=True)                   # (n,) desc
        slot = torch.clamp(torch.cumsum(empty.to(torch.int64), dim=0) - 1, 0, n - 1)
        cents = torch.where(empty[:, None], x[order[slot]],
                            sums / torch.clamp_min(counts, 1.0)[:, None]).contiguous()
    labels, _ = ops.kmeans_assign(x, cents)
    return _canonicalize(labels, cents, k)
