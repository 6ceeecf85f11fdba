"""Argument checks the kernel wrappers run before handing a pointer to C."""
from __future__ import annotations

import torch


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
                      *, device: torch.device | None = None) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``ndim``
    dimensions on a CUDA device (``device`` when given)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be on a CUDA device (or all inputs on the "
                         f"CPU for the plain version), got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dimensions, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
