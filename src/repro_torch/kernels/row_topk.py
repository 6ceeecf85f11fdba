"""Wrapper of the streamed row top-k kernel (``csrc/row_topk.cu``), and the
plain top-k helpers around it.

Counterpart of ``repro/kernels/row_topk.py``: ``row_topk`` is pass 1 of the
two-pass graph build (the k-th nearest-neighbour distance behind the
adaptive scales, and the k-th largest similarity behind the kNN
threshold); ``row_topk_merge`` and ``topk_thresholds_from_scores`` are the
reference's plain epilogues, ported as plain PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from ._check import check_adaptive, check_cuda_tensor, operand_ptr
from .affinity import KINDS

STATS = {"similarity": 0, "neg_sqdist": 1}

#: the kernel keeps up to 64 scores a row (two list slots per lane)
MAX_K = 64

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]


def check_k(k: int) -> None:
    """Raise for a rank the kernel cannot keep."""
    if k < 1:
        raise ValueError(f"k must be >= 1 (a neighbor rank), got {k}")
    if k > MAX_K:
        raise NotImplementedError(
            f"row top-k with k={k}: the kernel keeps at most {MAX_K} scores a row "
            "(ROADMAP queue 2, row_topk for K > 64, a per-row radix select)")


def row_topk(
    x: torch.Tensor,
    xc: torch.Tensor | None = None,
    *,
    k: int,
    stat: str = "similarity",
    kind: str = "cosine_shifted",
    sigma: float = 1.0,
    row_offset: int = 0,
    col_offset: int = 0,
    scale_r: torch.Tensor | None = None,
    scale_c: torch.Tensor | None = None,
) -> torch.Tensor:
    """(R, k) f32 descending per-row top-k scores of the stripe of ``x``
    (R, m) against ``xc`` (C, m) (``None``: the square self-stripe), the
    global diagonal excluded, -inf past a row's valid entries.
    ``stat='similarity'`` scores the affinity value (``scale_r``/
    ``scale_c`` for adaptive rbf); ``stat='neg_sqdist'`` scores
    -max(d2, 0). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    if stat not in STATS:
        raise ValueError(f"unknown stat {stat!r} (expected one of {tuple(STATS)})")
    if kind not in KINDS:
        raise ValueError(f"unknown affinity kind {kind!r} (expected one of {tuple(KINDS)})")
    check_adaptive(kind, scale_r, scale_c)
    check_k(k)
    if x.device.type == "cpu":
        return ref.row_topk_ref(x, xc, k=k, stat=stat, kind=kind, sigma=sigma,
                                scale_r=scale_r, scale_c=scale_c,
                                row_offset=row_offset, col_offset=col_offset)
    cols = x if xc is None else xc
    check_cuda_tensor("x", x, torch.float32, 2)
    check_cuda_tensor("xc", cols, torch.float32, 2, device=x.device)
    n_rows, m = x.shape
    n_cols = cols.shape[0]
    if cols.shape[1] != m:
        raise ValueError(f"x and xc feature widths differ: {m} vs {cols.shape[1]}")
    if m == 0:
        raise ValueError("row_topk needs at least one feature")
    pol = (operand_ptr("scale_r", scale_r, n_rows, x.device),
           operand_ptr("scale_c", scale_c, n_cols, x.device))
    out = torch.empty((n_rows, k), dtype=torch.float32, device=x.device)
    if n_rows == 0:
        return out
    if n_cols == 0:
        return out.fill_(-torch.inf)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(
            "row_topk", "row_topk", "gpic_row_topk", _ARGTYPES,
            x.data_ptr(), cols.data_ptr(), *pol, out.data_ptr(),
            n_rows, n_cols, m, k, int(row_offset), int(col_offset), KINDS[kind],
            STATS[stat], float(1.0 / (2.0 * sigma * sigma)), stream)
    return out


def row_topk_merge(buf: torch.Tensor, cand: torch.Tensor, k: int) -> torch.Tensor:
    """Descending top-k over the columns of [buf | cand]: k rounds of
    row-max extraction, each removing the first column that holds the max
    (one of several equal scores at a time), as the reference merges."""
    s = torch.cat([buf, cand], dim=1).float()
    cols = torch.arange(s.shape[1], device=s.device)[None, :].expand_as(s)
    out = []
    for _ in range(k):
        m = torch.amax(s, dim=1, keepdim=True)
        out.append(m)
        first = torch.amin(torch.where(s == m, cols, s.shape[1]), dim=1, keepdim=True)
        s = torch.where(cols == first, -torch.inf, s)
    return torch.cat(out, dim=1)


def topk_thresholds_from_scores(
    scores: torch.Tensor,
    *,
    k: int,
    row_offset: int = 0,
    col_offset: int = 0,
    stripe: int = 4096,
) -> torch.Tensor:
    """(R,) per-row k-th largest score of an unmasked score stripe, the
    global diagonal excluded by index (never by value: raw cosine scores
    can be negative, so a written 0 could outrank real entries). An exact
    selection, so it equals the k-th score that ``row_topk`` keeps. Works
    on ``stripe`` rows at a time, so it adds O(stripe C) memory, not a
    copy of the (R, C) scores."""
    n_rows, n_cols = scores.shape
    gcols = col_offset + torch.arange(n_cols, device=scores.device)[None, :]
    out = torch.empty((n_rows,), dtype=torch.float32, device=scores.device)
    for r0 in range(0, n_rows, stripe):
        r1 = min(r0 + stripe, n_rows)
        grows = row_offset + torch.arange(r0, r1, device=scores.device)[:, None]
        s = torch.where(grows == gcols, -torch.inf, scores[r0:r1].float())
        out[r0:r1] = torch.topk(s, k, dim=1).values[:, -1]
    return out
