"""Argument checks the kernel wrappers run before handing a pointer to C."""
from __future__ import annotations

import torch

#: the types A is stored in: f32, or bf16 (the reference's a_dtype, O4)
A_DTYPES = (torch.float32, torch.bfloat16)


def check_cuda_tensor(name: str, t: torch.Tensor, dtype, ndim: int,
                      *, device: torch.device | None = None) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor (or one of a
    tuple of dtypes) of ``ndim`` dimensions on a CUDA device (``device``
    when given)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be on a CUDA device (or all inputs on the "
                         f"CPU for the plain version), got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dimensions, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_adaptive(kind: str, scale_r, scale_c) -> None:
    """Raise unless adaptive scales come as a pair on an rbf kind (the
    reference kernels' check)."""
    if scale_r is not None and (kind != "rbf" or scale_c is None):
        raise ValueError("adaptive scaling needs kind='rbf' and both "
                         "scale_r and scale_c")


def operand_ptr(name: str, t: torch.Tensor | None, length: int,
                device: torch.device) -> int | None:
    """The device pointer of a (length,) f32 policy operand (a scale or a
    threshold vector), or None when the operand is not given."""
    if t is None:
        return None
    check_cuda_tensor(name, t, torch.float32, 1, device=device)
    if t.shape[0] != length:
        raise ValueError(f"{name} has {t.shape[0]} entries, expected {length}")
    return t.data_ptr()
