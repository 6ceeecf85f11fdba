"""Wrapper of the degree-normalized mat-mat kernel (``csrc/power_step.cu``).

Counterpart of ``repro/kernels/power_step.py::degree_normalized_matmat``:
U = (A V) / max(d, 1e-30) in one read of A for all r columns of V.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from ._check import check_cuda_tensor

#: widest V the kernel takes (its per-thread partials live in registers)
MAX_R = 32

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def degree_normalized_matmat(a: torch.Tensor, v: torch.Tensor,
                             d: torch.Tensor) -> torch.Tensor:
    """U (R, r) f32 for A (R, C), V (C, r), d (R,). A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    if a.device.type == "cpu":
        return ref.degree_normalized_matmat_ref(a, v, d)
    check_cuda_tensor("a", a, torch.float32, 2)
    check_cuda_tensor("v", v, torch.float32, 2, device=a.device)
    check_cuda_tensor("d", d, torch.float32, 1, device=a.device)
    n_rows, n_cols = a.shape
    r = v.shape[1]
    if v.shape[0] != n_cols or d.shape[0] != n_rows:
        raise ValueError(f"shape mismatch: a {tuple(a.shape)}, v {tuple(v.shape)}, "
                         f"d {tuple(d.shape)}")
    if not 1 <= r <= MAX_R:
        raise ValueError(f"the power-step kernel takes 1 <= r <= {MAX_R} columns, got {r}")
    u = torch.empty((n_rows, r), dtype=torch.float32, device=a.device)
    if n_rows == 0:
        return u
    # rows that start on 16 bytes stream through the kernel's cp.async ring
    ring = a.data_ptr() % 16 == 0 and n_cols % 4 == 0
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(
            "degree_normalized_matmat", "power_step", "gpic_degree_normalized_matmat",
            _ARGTYPES, a.data_ptr(), v.data_ptr(), d.data_ptr(), u.data_ptr(),
            n_rows, n_cols, r, int(ring), stream)
    return u


def stored_degree(a: torch.Tensor) -> torch.Tensor:
    """D (R,) f32 = A 1 of a stored A, summed in ``affinity_and_degree``'s
    row-sum order. On the card this is the sweep kernel with V = 1 and
    d = 1: thread t adds columns t, t + 256, ... and the block reduces with
    the build's tree, and fmaf(a, 1, acc) == acc + a, so D is bit for bit
    the D the build kernel makes of the same entries. On the CPU it is the
    plain build's ``torch.sum``."""
    if a.device.type == "cpu":
        return torch.sum(a.float(), dim=1)
    ones = torch.ones((a.shape[0],), dtype=torch.float32, device=a.device)
    v = torch.ones((a.shape[1], 1), dtype=torch.float32, device=a.device)
    return degree_normalized_matmat(a, v, ones)[:, 0]
