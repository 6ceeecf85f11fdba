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

#: rows each block of the kernel reduces (csrc/gram.cu: ROWS)
ROWS_PER_BLOCK = 256

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
             + [ctypes.c_longlong, ctypes.c_void_p])

#: (device index, stream) -> [ticket (1,) int32, partials scratch (f32)]
_WORKSPACE: dict[tuple[int, int], list[torch.Tensor]] = {}


def _workspace(device: torch.device, stream: int, floats: int) -> list[torch.Tensor]:
    """The kernel's ticket and partials scratch for calls on ``stream``:
    the ticket is made with zeros once (each call leaves it at 0), the
    scratch grows to the largest call's ``floats``. Calls on one stream
    run in order, so they never share either in flight; another stream
    gets its own."""
    key = (device.index, stream)
    ws = _WORKSPACE.get(key)
    if ws is None:
        ws = _WORKSPACE[key] = [torch.zeros((1,), dtype=torch.int32, device=device),
                                torch.empty((floats,), dtype=torch.float32, device=device)]
    elif ws[1].numel() < floats:
        ws[1] = torch.empty((floats,), dtype=torch.float32, device=device)
    return ws


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
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream().cuda_stream
        floats = -(-n // ROWS_PER_BLOCK) * c * c
        ticket, part = _workspace(v.device, stream, floats)
        _build.launch("gram", "gram", "gpic_gram", _ARGTYPES, v.data_ptr(), part.data_ptr(),
                      ticket.data_ptr(), g.data_ptr(), n, c, part.numel(), stream)
    return g
