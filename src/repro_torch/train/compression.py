"""Gradient compression with error feedback, the port of
``repro/train/compression.py``.

Row-wise (last dim) symmetric int8 quantization of each gradient leaf.
``compress_decompress`` is the round trip the train step applies (the
information a real int8 all-reduce would lose); ``ErrorFeedback`` keeps the
quantization error and re-injects it the next step (EF-SGD).
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ._tree import leaves, tree_map, unflatten


def quantize_int8(x: torch.Tensor):
    """Row-wise (last-dim) symmetric int8 quantization. Returns (q, scale)."""
    x32 = x.float()
    amax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_decompress(grads):
    """Round-trip every gradient leaf through int8. Returns (grads, err)."""
    def roundtrip(g):
        if g.ndim == 0:
            return g, torch.zeros_like(g)
        q, s = quantize_int8(g)
        dq = dequantize_int8(q, s).to(g.dtype)
        return dq, g - dq

    pairs = [roundtrip(g) for g in leaves(grads)]
    return unflatten(grads, [p[0] for p in pairs]), unflatten(grads, [p[1] for p in pairs])


@dataclass
class ErrorFeedback:
    residual: Any

    @staticmethod
    def init(params):
        return ErrorFeedback(residual=tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params))


def ef_compress(grads, ef: ErrorFeedback):
    """Error-feedback compression: q(g + r); r' = (g + r) - dq."""
    corrected = tree_map(lambda g, r: g.float() + r, grads, ef.residual)
    dq, err = compress_decompress(corrected)
    return dq, ErrorFeedback(residual=err)
