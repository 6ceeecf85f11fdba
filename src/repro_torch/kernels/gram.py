"""Wrapper of the tall-skinny Gram kernel (``csrc/gram.cu``).

Counterpart of ``repro/kernels/gram.py::gram``: G = V^T V in f32 for the
(n, c) power-loop state, or for [V | U] in the subspace residual.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from ._check import check_cuda_tensor
from .power_step import MAX_R

#: widest V the kernel takes: [V | U] of the residual rule at r = MAX_R
MAX_C = 2 * MAX_R

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def gram(v: torch.Tensor) -> torch.Tensor:
    """G (c, c) f32 for V (n, c), 1 <= c <= MAX_C. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    if v.device.type == "cpu":
        return ref.gram_ref(v)
    check_cuda_tensor("v", v, torch.float32, 2)
    n, c = v.shape
    if not 1 <= c <= MAX_C:
        raise ValueError(f"the Gram kernel takes 1 <= c <= {MAX_C} columns, got {c}")
    g = torch.empty((c, c), dtype=torch.float32, device=v.device)
    if n == 0:
        return g.zero_()
    rows = _build.library("gram").gpic_gram_rows_per_block()
    part = torch.empty((-(-n // rows), c * c), dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("gram", "gram", "gpic_gram", _ARGTYPES,
                      v.data_ptr(), part.data_ptr(), g.data_ptr(), n, c, stream)
    return g
