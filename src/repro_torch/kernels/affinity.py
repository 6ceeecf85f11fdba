"""Wrapper of the fused affinity + degree kernel (``csrc/affinity.cu``).

Counterpart of ``repro/kernels/affinity.py::affinity_and_degree``: the
kinds cosine, cosine_shifted and rbf, with the graph-policy operands
(adaptive scales ``scale_r``/``scale_c``, the row threshold ``thr``), A
stored in f32 or bf16 (``out_dtype``, the reference's O4). For the cosine
kinds pass L2-row-normalized features, for rbf the raw features.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from ._check import A_DTYPES, check_adaptive, check_cuda_tensor, operand_ptr

KINDS = {"cosine": 0, "cosine_shifted": 1, "rbf": 2}

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def affinity_and_degree(
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
    """(A (R, C) in ``out_dtype``, D (R,) f32) for the stripe of ``xn``
    (R, m) against ``xc`` (C, m) at the global offsets; ``xc=None`` is the
    square self-affinity. ``scale_r``/``scale_c`` (R,)/(C,) switch rbf to
    exp(-d2 / (s_i s_j)); ``thr`` (R,) zeroes each row's entries below its
    threshold. A bf16 ``out_dtype`` rounds each f32 entry to nearest even
    as it is stored; D is the f32 entries' sum either way. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    if kind not in KINDS:
        raise ValueError(f"unknown affinity kind {kind!r} (expected one of {tuple(KINDS)})")
    if out_dtype not in A_DTYPES:
        raise TypeError(f"A is stored as float32 or bfloat16, got out_dtype={out_dtype}")
    check_adaptive(kind, scale_r, scale_c)
    if xn.device.type == "cpu":
        return ref.affinity_and_degree_ref(xn, xc, kind=kind, sigma=sigma,
                                           row_offset=row_offset, col_offset=col_offset,
                                           scale_r=scale_r, scale_c=scale_c, thr=thr,
                                           out_dtype=out_dtype)
    cols = xn if xc is None else xc
    check_cuda_tensor("xn", xn, torch.float32, 2)
    check_cuda_tensor("xc", cols, torch.float32, 2, device=xn.device)
    n_rows, m = xn.shape
    n_cols = cols.shape[0]
    if cols.shape[1] != m:
        raise ValueError(f"xn and xc feature widths differ: {m} vs {cols.shape[1]}")
    if m == 0:
        raise ValueError("affinity_and_degree needs at least one feature")
    pol = (operand_ptr("scale_r", scale_r, n_rows, xn.device),
           operand_ptr("scale_c", scale_c, n_cols, xn.device),
           operand_ptr("thr", thr, n_rows, xn.device))
    a = torch.empty((n_rows, n_cols), dtype=out_dtype, device=xn.device)
    d = torch.empty((n_rows,), dtype=torch.float32, device=xn.device)
    if n_rows == 0 or n_cols == 0:
        d.zero_()
        return a, d
    with torch.cuda.device(xn.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(
            "affinity_and_degree", "affinity", "gpic_affinity_and_degree", _ARGTYPES,
            xn.data_ptr(), cols.data_ptr(), *pol, a.data_ptr(), d.data_ptr(),
            n_rows, n_cols, m, int(row_offset), int(col_offset), KINDS[kind],
            float(1.0 / (2.0 * sigma * sigma)), int(out_dtype == torch.bfloat16), stream)
    return a, d
