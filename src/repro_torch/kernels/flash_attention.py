"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``) and
of its backward (``csrc/flash_attention_bwd.cu``).

Counterpart of ``repro/kernels/flash_attention.py::flash_attention``:
causal (or full) online-softmax attention with grouped-query heads, the
scores never stored. The reference's layout is kept: q (bh, s, d) and
k, v (bkv, s, d), b major and h minor, query head g reading kv head
g // (bh // bkv). The model passes the 4-D form instead, q (b, h, s, d)
and k, v (b, kv, s, d), as strided views of its (b, s, h, d) activations
and of the (b, S, kv, d) cache, which the kernel reads in place.

Gradients: where grad mode is on and an input requires grad (a training
forward), the call goes through a ``torch.autograd.Function``: its forward
also writes the row log-sum-exp L, and its backward launches the three
backward kernels (D = rowsum(dO O), then dK and dV, then dQ) on a CUDA
tensor and runs their plain version (``ref.flash_attention_bwd_ref``) on
the CPU. A call without grad (serve) launches the forward alone, as
before. A kernel that fails to build or launch raises; nothing falls back
to autograd through the plain forward.
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

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
             + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_DELTA_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 6
                   + [ctypes.c_void_p])
_DKDV_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 18
                  + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
_DQ_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 15
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


def _rows_aligned16(t: torch.Tensor) -> bool:
    """Whether every (s, d) row of the 4-D ``t`` starts on 16 bytes and its
    d elements fill whole 16-byte chunks, so the kernel can copy it with
    16-byte ``cp.async``; otherwise it stages element by element."""
    es = t.element_size()
    return (t.data_ptr() % 16 == 0 and t.shape[-1] * es % 16 == 0
            and all(st * es % 16 == 0 for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1))


def _four_dim(*ts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    return tuple(t if t.ndim == 4 else t.unsqueeze(0) for t in ts)


def _strides(*ts: torch.Tensor) -> list[int]:
    """The (b, head, s) element strides of each 4-D tensor."""
    return [st for t in ts for st in t.stride()[:3]]


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
             with_lse: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(out, L or None): the plain version on the CPU, else the kernel."""
    if q.device.type == "cpu":
        if with_lse:
            return ref.flash_attention_ref(q, k, v, causal=causal, return_lse=True)
        return ref.flash_attention_ref(q, k, v, causal=causal), None
    _check(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device) if with_lse else None
    if q.numel() == 0:
        return out, lse
    q4, k4, v4, o4 = _four_dim(q, k, v, out)
    b, h, s, d = q4.shape
    async_copy = all(_rows_aligned16(t) for t in (q4, k4, v4))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("flash_attention", "flash_attention", "gpic_flash_attention",
                      _ARGTYPES, q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), o4.data_ptr(),
                      None if lse is None else lse.data_ptr(),
                      _CODES[q.dtype], _CODES[k.dtype], b, h, k4.shape[1], s, d,
                      *_strides(q4, k4, v4, o4), int(causal), 1.0 / math.sqrt(d),
                      int(async_copy), stream)
    return out, lse


def flash_attention_bwd_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dout * out) in f32, out's shape without d: the backward's
    pre-pass, one kernel launch on CUDA tensors (d contiguous), plain torch
    on the CPU."""
    if out.device.type == "cpu":
        return torch.sum(dout.float() * out.float(), dim=-1)
    delta = torch.empty(out.shape[:-1], dtype=torch.float32, device=out.device)
    if out.numel() == 0:
        return delta
    o4, do4 = _four_dim(out, dout)
    b, h, s, d = o4.shape
    with torch.cuda.device(out.device):
        _build.launch("flash_attention_bwd_delta", "flash_attention_bwd",
                      "gpic_flash_attention_bwd_delta", _DELTA_ARGTYPES, o4.data_ptr(),
                      do4.data_ptr(), delta.data_ptr(), _CODES[out.dtype], b, h, s, d,
                      *_strides(o4, do4), torch.cuda.current_stream().cuda_stream)
    return delta


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True):
    """(dq, dk, dv) of :func:`flash_attention` at (q, k, v), given its
    output, its row log-sum-exp ``lse`` (f32, q's shape without d) and the
    output's gradient ``dout``; each gradient in its input's type and
    memory order. The plain version on the CPU; on CUDA tensors three
    kernel launches (D, then dK and dV, then dQ), or a raise."""
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal)
    _check(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype \
            or dout.dtype != q.dtype or lse.shape != q.shape[:-1] \
            or lse.dtype != torch.float32 or not lse.is_contiguous() or out.stride(-1) != 1:
        raise ValueError("flash_attention_bwd: out and dout must have q's shape and type "
                         "(out contiguous in d), lse q's shape without d in f32, contiguous")
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = flash_attention_bwd_delta(out, dout)
    q4, k4, v4, do4, dq4, dk4, dv4 = _four_dim(q, k, v, dout, dq, dk, dv)
    b, h, s, d = q4.shape
    kv = k4.shape[1]
    codes = (_CODES[q.dtype], _CODES[k.dtype])
    scale = 1.0 / math.sqrt(d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("flash_attention_bwd_dkdv", "flash_attention_bwd",
                      "gpic_flash_attention_bwd_dkdv", _DKDV_ARGTYPES, q4.data_ptr(),
                      k4.data_ptr(), v4.data_ptr(), do4.data_ptr(), lse.data_ptr(),
                      delta.data_ptr(), dk4.data_ptr(), dv4.data_ptr(), *codes, b, h, kv, s, d,
                      *_strides(q4, k4, v4, do4, dk4, dv4), int(causal), scale, stream)
        _build.launch("flash_attention_bwd_dq", "flash_attention_bwd",
                      "gpic_flash_attention_bwd_dq", _DQ_ARGTYPES, q4.data_ptr(),
                      k4.data_ptr(), v4.data_ptr(), do4.data_ptr(), lse.data_ptr(),
                      delta.data_ptr(), dq4.data_ptr(), *codes, b, h, kv, s, d,
                      *_strides(q4, k4, v4, do4, dq4), int(causal), scale, stream)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Kernel 12 with its hand-written backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _forward(q, k, v, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, out, lse, dout, causal=ctx.causal), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) [causal mask]) v in q's type, f32 inside.

    q (bh, s, d), k and v (bkv, s, d) with bh a multiple of bkv, or the 4-D
    form q (b, h, s, d), k and v (b, kv, s, d); any strides with d
    contiguous. The output has q's shape (and its memory order where q is
    dense). A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel or raises. Differentiable: see the module's docstring."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal, with_lse=False)[0]
