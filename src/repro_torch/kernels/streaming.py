"""Wrappers of the streaming (A-free) kernels (``csrc/streaming.cu``).

Counterparts of ``repro/kernels/streaming.py::affinity_matmat`` and
``::affinity_degree_streaming`` (cosine, cosine_shifted, rbf, with the
graph-policy operands ``scale_r``/``scale_c``/``thr`` and, on the mat-mat,
``thr_c``): each affinity tile is rebuilt from the features inside the
kernel and never stored. For the cosine kinds pass L2-row-normalized
features, for rbf the raw features.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from ._check import check_adaptive, check_cuda_tensor, operand_ptr
from .affinity import KINDS
from .power_step import MAX_R

_MATMAT_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                    + [ctypes.c_float, ctypes.c_void_p])
_DEGREE_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                    + [ctypes.c_float, ctypes.c_void_p])


def _check_kind(kind, scale_r, scale_c):
    if kind not in KINDS:
        raise ValueError(f"unknown affinity kind {kind!r} (expected one of {tuple(KINDS)})")
    check_adaptive(kind, scale_r, scale_c)


def _check_features(x, xc):
    cols = x if xc is None else xc
    check_cuda_tensor("x", x, torch.float32, 2)
    check_cuda_tensor("xc", cols, torch.float32, 2, device=x.device)
    if cols.shape[1] != x.shape[1]:
        raise ValueError(f"x and xc feature widths differ: {x.shape[1]} vs {cols.shape[1]}")
    if x.shape[1] == 0:
        raise ValueError("the affinity kernels need at least one feature")
    return cols


def affinity_matmat(
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
    """U (R, r) f32 = (A V) / max(d, 1e-30) for the masked stripe A of
    ``x`` (R, m) against ``xc`` (C, m) (``None``: the square self-stripe),
    V (C, r) and d (R,); ``d=None`` leaves U unnormalized. ``scale_r``/
    ``scale_c`` and ``thr`` apply the adaptive and kNN policies as
    ``affinity_and_degree`` does; ``thr_c`` (C,) instead keeps each
    column's entries at or above the column's own threshold, which is the
    transpose product A^T V of the truncated graph (the scores are
    symmetric). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    _check_kind(kind, scale_r, scale_c)
    if x.device.type == "cpu":
        return ref.affinity_matmat_ref(x, v, d, xc, kind=kind, sigma=sigma,
                                       row_offset=row_offset, col_offset=col_offset,
                                       scale_r=scale_r, scale_c=scale_c, thr=thr,
                                       thr_c=thr_c)
    cols = _check_features(x, xc)
    check_cuda_tensor("v", v, torch.float32, 2, device=x.device)
    n_rows, m = x.shape
    n_cols, r = cols.shape[0], v.shape[1]
    if v.shape[0] != n_cols:
        raise ValueError(f"v has {v.shape[0]} rows, the stripe {n_cols} columns")
    if d is not None:
        check_cuda_tensor("d", d, torch.float32, 1, device=x.device)
        if d.shape[0] != n_rows:
            raise ValueError(f"d has {d.shape[0]} entries, the stripe {n_rows} rows")
    if not 1 <= r <= MAX_R:
        raise ValueError(f"the streaming kernel takes 1 <= r <= {MAX_R} columns, got {r}")
    pol = (operand_ptr("scale_r", scale_r, n_rows, x.device),
           operand_ptr("scale_c", scale_c, n_cols, x.device),
           operand_ptr("thr", thr, n_rows, x.device),
           operand_ptr("thr_c", thr_c, n_cols, x.device))
    u = torch.empty((n_rows, r), dtype=torch.float32, device=x.device)
    if n_rows == 0:
        return u
    if n_cols == 0:
        return u.zero_()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(
            "streaming_matmat", "streaming", "gpic_streaming_matmat", _MATMAT_ARGTYPES,
            x.data_ptr(), cols.data_ptr(), *pol, v.data_ptr(),
            None if d is None else d.data_ptr(), u.data_ptr(),
            n_rows, n_cols, m, r, int(row_offset), int(col_offset), KINDS[kind],
            float(1.0 / (2.0 * sigma * sigma)), stream)
    return u


def affinity_degree_streaming(
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
    """D (R,) f32 = A 1 for the masked stripe A of ``x`` against ``xc``
    (policy operands as ``affinity_and_degree``), summed in the order of
    ``affinity_and_degree``'s D. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    _check_kind(kind, scale_r, scale_c)
    if x.device.type == "cpu":
        return ref.affinity_degree_streaming_ref(x, xc, kind=kind, sigma=sigma,
                                                 row_offset=row_offset,
                                                 col_offset=col_offset, scale_r=scale_r,
                                                 scale_c=scale_c, thr=thr)
    cols = _check_features(x, xc)
    n_rows, m = x.shape
    n_cols = cols.shape[0]
    pol = (operand_ptr("scale_r", scale_r, n_rows, x.device),
           operand_ptr("scale_c", scale_c, n_cols, x.device),
           operand_ptr("thr", thr, n_rows, x.device))
    d = torch.empty((n_rows,), dtype=torch.float32, device=x.device)
    if n_rows == 0 or n_cols == 0:
        return d.zero_()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(
            "streaming_degree", "streaming", "gpic_streaming_degree", _DEGREE_ARGTYPES,
            x.data_ptr(), cols.data_ptr(), *pol, d.data_ptr(),
            n_rows, n_cols, m, int(row_offset), int(col_offset), KINDS[kind],
            float(1.0 / (2.0 * sigma * sigma)), stream)
    return d
