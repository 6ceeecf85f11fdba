"""Plain PyTorch versions of the hand-written kernels.

They are the kernels' references: a wrapper returns them for a tensor on
the CPU, and ``chip_smoke.py`` holds each CUDA kernel against them on the
card. Each mirrors its counterpart in ``repro/kernels/ref.py`` operation
for operation, stripe-general like it (``xc``, ``row_offset``,
``col_offset``).
"""
from __future__ import annotations

import torch


def _affinity_scores_ref(x: torch.Tensor, c: torch.Tensor, *, kind: str,
                         sigma: float) -> torch.Tensor:
    """Dense (R, C) similarity scores before any masking (fixed bandwidth)."""
    if kind in ("cosine", "cosine_shifted"):
        a = x @ c.T
        if kind == "cosine_shifted":
            a = 0.5 * (1.0 + a)
        return a
    if kind == "rbf":
        sqr = torch.sum(x * x, dim=1)
        sqc = torch.sum(c * c, dim=1)
        d2 = torch.clamp_min(sqr[:, None] + sqc[None, :] - 2.0 * (x @ c.T), 0.0)
        return torch.exp(-d2 / (2.0 * sigma * sigma))
    raise ValueError(kind)


def affinity_and_degree_ref(
    xn: torch.Tensor,
    xc: torch.Tensor | None = None,
    *,
    kind: str = "cosine_shifted",
    sigma: float = 1.0,
    row_offset: int = 0,
    col_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(A (R, C), D (R,)): the masked affinity stripe of ``xn`` against
    ``xc`` (``None``: itself) at global offsets, and its row sums."""
    x = xn.float()
    c = x if xc is None else xc.float()
    a = _affinity_scores_ref(x, c, kind=kind, sigma=sigma)
    grows = row_offset + torch.arange(a.shape[0], device=a.device)[:, None]
    gcols = col_offset + torch.arange(a.shape[1], device=a.device)[None, :]
    a = torch.where(grows != gcols, a, 0.0)
    return a, torch.sum(a, dim=1)


def _floored_degree_divide(u: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """u / max(d, 1e-30): zero-degree safe for a nonnegative A (d = 0 means
    the row, hence u, is exactly 0); NaN degrees propagate."""
    return u / torch.clamp_min(d.float(), 1e-30)


def degree_normalized_matmat_ref(a: torch.Tensor, v: torch.Tensor,
                                 d: torch.Tensor) -> torch.Tensor:
    """U = (A V) / d[:, None] for V of shape (C, r)."""
    u = a.float() @ v.float()
    return _floored_degree_divide(u, d[:, None])


def kmeans_assign_ref(x: torch.Tensor, cents: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(labels (n,) int32, squared distances (n,) f32): nearest centroid,
    first index on ties, by the expansion |x|^2 + |c|^2 - 2 x.c."""
    x = x.float()
    c = cents.float()
    xx = torch.sum(x * x, dim=1, keepdim=True)
    cc = torch.sum(c * c, dim=1)[None, :]
    d2 = xx + cc - 2.0 * (x @ c.T)
    return torch.argmin(d2, dim=1).to(torch.int32), torch.amin(d2, dim=1)
