"""Plain PyTorch versions of the hand-written kernels.

They are the kernels' references: a wrapper returns them for a tensor on
the CPU, and ``chip_smoke.py`` holds each CUDA kernel against them on the
card. Each mirrors its counterpart in ``repro/kernels/ref.py`` operation
for operation, stripe-general like it (``xc``, ``row_offset``,
``col_offset``), with the graph-policy operands: ``scale_r``/``scale_c``
the (R,)/(C,) adaptive local scales (rbf only: exp(-d2 / (s_i s_j))),
``thr`` the (R,) row thresholds of a kNN truncation (entries below are
zeroed) and ``thr_c`` the (C,) column thresholds of the transpose product.
The block-sparse versions take a plan (``counts``, ``col_idx``) on a
(``tm``, ``tn``) tile grid, and its dead tiles contribute nothing.
"""
from __future__ import annotations

import math

import torch

from ..core.affinity import dense_block_live, plan_to_live


def _affinity_scores_ref(x: torch.Tensor, c: torch.Tensor, *, kind: str,
                         sigma: float, scale_r: torch.Tensor | None = None,
                         scale_c: torch.Tensor | None = None) -> torch.Tensor:
    """Dense (R, C) similarity scores before any masking (fixed or adaptive
    bandwidth)."""
    if kind in ("cosine", "cosine_shifted"):
        a = x @ c.T
        if kind == "cosine_shifted":
            a = 0.5 * (1.0 + a)
        return a
    if kind == "rbf":
        sqr = torch.sum(x * x, dim=1)
        sqc = torch.sum(c * c, dim=1)
        d2 = torch.clamp_min(sqr[:, None] + sqc[None, :] - 2.0 * (x @ c.T), 0.0)
        if scale_r is not None:
            return torch.exp(-d2 / (scale_r.float()[:, None] * scale_c.float()[None, :]))
        return torch.exp(-d2 / (2.0 * sigma * sigma))
    raise ValueError(kind)


def _off_diagonal(shape, row_offset, col_offset, device) -> torch.Tensor:
    """(R, C) bool: True off the global diagonal of the stripe."""
    grows = row_offset + torch.arange(shape[0], device=device)[:, None]
    gcols = col_offset + torch.arange(shape[1], device=device)[None, :]
    return grows != gcols


def affinity_and_degree_ref(
    xn: torch.Tensor,
    xc: torch.Tensor | None = None,
    *,
    kind: str = "cosine_shifted",
    sigma: float = 1.0,
    row_offset: int = 0,
    col_offset: int = 0,
    scale_r: torch.Tensor | None = None,
    scale_c: torch.Tensor | None = None,
    thr: torch.Tensor | None = None,
    out_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(A (R, C) in ``out_dtype``, D (R,) f32): the masked affinity stripe
    of ``xn`` against ``xc`` (``None``: itself) at global offsets, and its
    row sums, taken in f32 before A is rounded to ``out_dtype`` (the
    reference's order)."""
    x = xn.float()
    c = x if xc is None else xc.float()
    a = _affinity_scores_ref(x, c, kind=kind, sigma=sigma, scale_r=scale_r, scale_c=scale_c)
    valid = _off_diagonal(a.shape, row_offset, col_offset, a.device)
    if thr is not None:
        valid = valid & (a >= thr.float()[:, None])
    a = torch.where(valid, a, 0.0)
    return a.to(out_dtype), torch.sum(a, dim=1)


def row_topk_ref(
    x: torch.Tensor,
    xc: torch.Tensor | None = None,
    *,
    k: int,
    stat: str = "similarity",
    kind: str = "cosine_shifted",
    sigma: float = 1.0,
    scale_r: torch.Tensor | None = None,
    scale_c: torch.Tensor | None = None,
    row_offset: int = 0,
    col_offset: int = 0,
) -> torch.Tensor:
    """(R, k) per-row descending top-k of the stripe's scores over its
    valid entries (global diagonal excluded): the affinity value
    (``stat='similarity'``) or -max(d2, 0) (``stat='neg_sqdist'``, any
    kind). Rows with fewer than k valid entries pad with -inf."""
    x = x.float()
    c = x if xc is None else xc.float()
    if stat == "similarity":
        s = _affinity_scores_ref(x, c, kind=kind, sigma=sigma, scale_r=scale_r,
                                 scale_c=scale_c)
    elif stat == "neg_sqdist":
        sqr = torch.sum(x * x, dim=1)
        sqc = torch.sum(c * c, dim=1)
        s = -torch.clamp_min(sqr[:, None] + sqc[None, :] - 2.0 * (x @ c.T), 0.0)
    else:
        raise ValueError(f"unknown stat {stat!r}")
    s = torch.where(_off_diagonal(s.shape, row_offset, col_offset, s.device), s, -torch.inf)
    if k > s.shape[1]:
        s = torch.cat([s, s.new_full((s.shape[0], k - s.shape[1]), -torch.inf)], dim=1)
    return torch.topk(s, k, dim=1).values


def _floored_degree_divide(u: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """u / max(d, 1e-30): zero-degree safe for a nonnegative A (d = 0 means
    the row, hence u, is exactly 0); NaN degrees propagate."""
    return u / torch.clamp_min(d.float(), 1e-30)


def degree_normalized_matvec_ref(a: torch.Tensor, v: torch.Tensor,
                                 d: torch.Tensor) -> torch.Tensor:
    """u = (A v) / d for a single vector v (C,)."""
    u = a.float() @ v.float()
    return _floored_degree_divide(u, d)


def degree_normalized_matmat_ref(a: torch.Tensor, v: torch.Tensor,
                                 d: torch.Tensor) -> torch.Tensor:
    """U = (A V) / d[:, None] for V of shape (C, r); a bf16 A is upcast
    to f32 first, as the reference's oracle does."""
    u = a.float() @ v.float()
    return _floored_degree_divide(u, d[:, None])


def affinity_matmat_ref(
    x: torch.Tensor,
    v: torch.Tensor,
    d: torch.Tensor | None = None,
    xc: torch.Tensor | None = None,
    *,
    kind: str = "cosine_shifted",
    sigma: float = 1.0,
    row_offset: int = 0,
    col_offset: int = 0,
    scale_r: torch.Tensor | None = None,
    scale_c: torch.Tensor | None = None,
    thr: torch.Tensor | None = None,
    thr_c: torch.Tensor | None = None,
) -> torch.Tensor:
    """(A V) / d for the masked stripe A of ``x`` against ``xc`` (built
    dense here); ``d=None`` leaves the product unnormalized. ``thr_c``
    zeroes each column's entries below its own threshold (the transpose
    product of the component probe)."""
    a, _ = affinity_and_degree_ref(x, xc, kind=kind, sigma=sigma, row_offset=row_offset,
                                   col_offset=col_offset, scale_r=scale_r, scale_c=scale_c,
                                   thr=thr)
    if thr_c is not None:
        a = torch.where(a >= thr_c.float()[None, :], a, 0.0)
    u = a @ v.float()
    if d is None:
        return u
    return _floored_degree_divide(u, d[:, None])


def affinity_degree_streaming_ref(
    x: torch.Tensor,
    xc: torch.Tensor | None = None,
    *,
    kind: str = "cosine_shifted",
    sigma: float = 1.0,
    row_offset: int = 0,
    col_offset: int = 0,
    scale_r: torch.Tensor | None = None,
    scale_c: torch.Tensor | None = None,
    thr: torch.Tensor | None = None,
) -> torch.Tensor:
    """D = A 1 for the masked stripe A of ``x`` against ``xc``."""
    _, deg = affinity_and_degree_ref(x, xc, kind=kind, sigma=sigma, row_offset=row_offset,
                                     col_offset=col_offset, scale_r=scale_r,
                                     scale_c=scale_c, thr=thr)
    return deg


def gram_ref(v: torch.Tensor) -> torch.Tensor:
    """G = V^T V in f32."""
    v32 = v.float()
    return v32.T @ v32


def power_step_ref(a: torch.Tensor, v: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The paper's power step on one vector: u / ||u||_1 with u = (A v) / d."""
    u = degree_normalized_matvec_ref(a, v, d)
    return u / torch.clamp_min(torch.sum(torch.abs(u)), 1e-30)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, return_lse: bool = False):
    """Oracle for kernels/flash_attention.py: q (bh, s, d), k/v (bkv, s, d),
    or the 4-D form (b, h, s, d), (b, kv, s, d). The kv heads are repeated,
    the softmax taken in f32 and the result cast to q's type. With
    ``return_lse``, also the f32 row log-sum-exp L of the scaled, masked
    logits, q's shape without d: the backward's P = exp(S / sqrt(d) - L)."""
    logits = _flash_logits(q, k, causal)
    probs = torch.softmax(logits, dim=-1)
    vv = v.repeat_interleave(q.shape[-3] // k.shape[-3], dim=-3).float()
    out = torch.einsum("...hst,...htd->...hsd", probs, vv).to(q.dtype)
    return (out, torch.logsumexp(logits, dim=-1)) if return_lse else out


def _flash_logits(q, k, causal):
    """f32 q k^T / sqrt(d) over the repeated kv heads, masked."""
    s, d = q.shape[-2:]
    kk = k.repeat_interleave(q.shape[-3] // k.shape[-3], dim=-3).float()
    logits = torch.einsum("...hsd,...htd->...hst", q.float(), kk) / math.sqrt(d)
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, -torch.inf)
    return logits


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True,
                            grads: str = "qkv"):
    """Oracle for the backward kernels of kernels/flash_attention.py:
    (dq, dk, dv) of ``flash_attention`` at (q, k, v), given its output
    ``out``, its row log-sum-exp ``lse`` and the output's gradient ``dout``,
    in the inputs' types, f32 inside:

        D = rowsum(dO * O),  P = exp(S / sqrt(d) - L),  dV = P^T dO,
        dS = P * (dO V^T - D),  dQ = dS K / sqrt(d),  dK = dS^T Q / sqrt(d),

    dK and dV summed over the query heads of each kv head (GQA).
    ``grads`` names the gradients to compute and return, in that order:
    "q" is the dQ kernel's plain version, "kv" the dK/dV kernel's."""
    d = q.shape[-1]
    hq, hk = q.shape[-3], k.shape[-3]
    rep = hq // hk
    qf, of, dof = q.float(), out.float(), dout.float()
    vv = v.repeat_interleave(rep, dim=-3).float()
    p = torch.exp(_flash_logits(q, k, causal) - lse.float()[..., None])
    delta = torch.sum(dof * of, dim=-1)
    dp = torch.einsum("...hsd,...htd->...hst", dof, vv)
    ds = p * (dp - delta[..., None])
    scale = 1.0 / math.sqrt(d)

    def per_kv_head(g):        # (..., hq, s, d) -> (..., hk, s, d), the rep heads summed
        return g.unflatten(-3, (hk, rep)).sum(dim=-3)

    result = {
        "q": lambda: (torch.einsum("...hst,...htd->...hsd", ds,
                                   k.repeat_interleave(rep, dim=-3).float()) * scale
                      ).to(q.dtype),
        "k": lambda: per_kv_head(torch.einsum("...hst,...hsd->...htd", ds, qf) * scale
                                 ).to(k.dtype),
        "v": lambda: per_kv_head(torch.einsum("...hst,...hsd->...htd", p, dof)).to(v.dtype),
    }
    return tuple(result[g]() for g in grads)


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


def _apply_plan_ref(a: torch.Tensor, counts: torch.Tensor, col_idx: torch.Tensor,
                    tm: int, tn: int) -> torch.Tensor:
    """``a`` with every tile that the plan marks dead zeroed (the (tm, tn)
    grid padded to tile multiples, as the kernels pad)."""
    n_rows, n_cols = a.shape
    live = plan_to_live(counts, col_idx)
    mask = live.repeat_interleave(tm, dim=0).repeat_interleave(tn, dim=1)
    return torch.where(mask[:n_rows, :n_cols], a, 0.0)


def block_sparse_matmat_ref(a: torch.Tensor, v: torch.Tensor, d: torch.Tensor,
                            counts: torch.Tensor, col_idx: torch.Tensor, *, tm: int,
                            tn: int) -> torch.Tensor:
    """``degree_normalized_matmat_ref`` with the plan's dead tiles of A
    contributing nothing."""
    return degree_normalized_matmat_ref(_apply_plan_ref(a.float(), counts, col_idx, tm, tn),
                                        v, d)


def block_sparse_streaming_matmat_ref(
    x: torch.Tensor,
    v: torch.Tensor,
    d: torch.Tensor | None = None,
    xc: torch.Tensor | None = None,
    *,
    counts: torch.Tensor,
    col_idx: torch.Tensor,
    tm: int,
    tn: int,
    kind: str = "cosine_shifted",
    sigma: float = 1.0,
    row_offset: int = 0,
    col_offset: int = 0,
    scale_r: torch.Tensor | None = None,
    scale_c: torch.Tensor | None = None,
    thr: torch.Tensor | None = None,
) -> torch.Tensor:
    """(A V) / d over the plan's live tiles of the masked stripe (built
    dense here); ``d=None`` leaves the product unnormalized."""
    a, _ = affinity_and_degree_ref(x, xc, kind=kind, sigma=sigma, row_offset=row_offset,
                                   col_offset=col_offset, scale_r=scale_r, scale_c=scale_c,
                                   thr=thr)
    u = _apply_plan_ref(a, counts, col_idx, tm, tn) @ v.float()
    if d is None:
        return u
    return _floored_degree_divide(u, d[:, None])


def block_sparse_streaming_degree_ref(
    x: torch.Tensor,
    xc: torch.Tensor | None = None,
    *,
    counts: torch.Tensor,
    col_idx: torch.Tensor,
    tm: int,
    tn: int,
    kind: str = "cosine_shifted",
    sigma: float = 1.0,
    row_offset: int = 0,
    col_offset: int = 0,
    scale_r: torch.Tensor | None = None,
    scale_c: torch.Tensor | None = None,
    thr: torch.Tensor | None = None,
) -> torch.Tensor:
    """D = A 1 over the plan's live tiles of the masked stripe."""
    a, _ = affinity_and_degree_ref(x, xc, kind=kind, sigma=sigma, row_offset=row_offset,
                                   col_offset=col_offset, scale_r=scale_r, scale_c=scale_c,
                                   thr=thr)
    return torch.sum(_apply_plan_ref(a, counts, col_idx, tm, tn), dim=1)


def block_liveness_ref(
    x: torch.Tensor,
    xc: torch.Tensor | None = None,
    *,
    tm: int,
    tn: int,
    kind: str = "cosine_shifted",
    sigma: float = 1.0,
    row_offset: int = 0,
    col_offset: int = 0,
    scale_r: torch.Tensor | None = None,
    scale_c: torch.Tensor | None = None,
    thr: torch.Tensor | None = None,
) -> torch.Tensor:
    """(nI, nJ) int32: 1 where a (tm, tn) tile of the masked stripe holds
    a nonzero entry, padding tiles dead."""
    a, _ = affinity_and_degree_ref(x, xc, kind=kind, sigma=sigma, row_offset=row_offset,
                                   col_offset=col_offset, scale_r=scale_r, scale_c=scale_c,
                                   thr=thr)
    return dense_block_live(a, tm, tn).to(torch.int32)
