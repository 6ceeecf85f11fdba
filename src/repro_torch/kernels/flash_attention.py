"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

Counterpart of ``repro/kernels/flash_attention.py::flash_attention``:
causal (or full) online-softmax attention with grouped-query heads, the
scores never stored. The reference's layout is kept: q (bh, s, d) and
k, v (bkv, s, d), b major and h minor, query head g reading kv head
g // (bh // bkv). The model passes the 4-D form instead, q (b, h, s, d)
and k, v (b, kv, s, d), as strided views of its (b, s, h, d) activations
and of the (b, S, kv, d) cache, which the kernel reads in place.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build, ref

#: widest head the kernel takes (its accumulator lives in registers)
MAX_D = 128

_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the (q, k/v) type pairs the kernel is built for
_PAIRS = ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
          (torch.bfloat16, torch.bfloat16))

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
             + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q, k, v are a shape, type and layout the kernel takes."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device (or all inputs on the CPU "
                             f"for the plain version), got {t.device}")
        if t.ndim not in (3, 4) or t.ndim != q.ndim:
            raise ValueError(f"q, k, v must all be (bh, s, d) or all (b, h, s, d), got "
                             f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dimension")
    if k.shape != v.shape or k.shape[:-3] != q.shape[:-3] or k.shape[-2:] != q.shape[-2:]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if k.shape[-3] == 0 or q.shape[-3] % k.shape[-3]:
        raise ValueError("query heads must be a multiple of kv heads")
    if not 1 <= q.shape[-1] <= MAX_D:
        raise ValueError(f"the flash-attention kernel takes head widths 1..{MAX_D}, "
                         f"got {q.shape[-1]}")
    if k.dtype != v.dtype or (q.dtype, k.dtype) not in _PAIRS:
        raise TypeError(f"the flash-attention kernel takes (q, k/v) types {_PAIRS}, got "
                        f"q {q.dtype}, k {k.dtype}, v {v.dtype}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) [causal mask]) v in q's type, f32 inside.

    q (bh, s, d), k and v (bkv, s, d) with bh a multiple of bkv, or the 4-D
    form q (b, h, s, d), k and v (b, kv, s, d); any strides with d
    contiguous. The output has q's shape (and its memory order where q is
    dense). A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel or raises."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    _check(q, k, v)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    q4, k4, v4, o4 = (t if t.ndim == 4 else t.unsqueeze(0) for t in (q, k, v, out))
    b, h, s, d = q4.shape
    if b * h > 65535:
        raise ValueError(f"the flash-attention kernel takes at most 65535 heads, got {b * h}")
    strides = [st for t in (q4, k4, v4, o4) for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("flash_attention", "flash_attention", "gpic_flash_attention",
                      _ARGTYPES, q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), o4.data_ptr(),
                      _CODES[q.dtype], _CODES[k.dtype], b, h, k4.shape[1], s, d, *strides,
                      int(causal), 1.0 / math.sqrt(d), stream)
    return out
