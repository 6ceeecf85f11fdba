"""Wrappers of the block-sparse kernels (``csrc/block_sparse.cu``).

Counterparts of ``repro/kernels/block_sparse.py``: the sweeps of a
truncated graph that visit only the live tiles of a block plan
(``core/affinity.py::block_plan``), and ``block_liveness``, the A-free
pass that finds those tiles for the streaming engine (the explicit engine
reads them off its stored A with ``dense_block_live``).

The plan is on the port's grid, not the reference's: row blocks of
``PLAN_TM`` = 16 rows, column tiles of ``TN`` = 256 columns, the shapes
every kernel of the port divides. ``counts`` (nI,) and ``col_idx`` (nI, nJ)
are int32 with nI = ceil(R / 16), nJ = ceil(C / 256); the kernels loop
``counts[i]`` themselves, so ``max_b`` is not an operand. On the CPU each
wrapper runs its plain version (``kernels/ref.py``), which zeroes the dead
tiles of the dense stripe, as the reference's oracles do.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from ._check import A_DTYPES, check_cuda_tensor, operand_ptr
from .affinity import KINDS
from .power_step import MAX_R
from .streaming import _check_features, _check_kind

#: rows of a plan row block and columns of a tile (csrc/block_sparse.cu)
PLAN_TM = 16
TN = 256

_MATMAT_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_STREAMING_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
_DEGREE_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                    + [ctypes.c_float, ctypes.c_void_p])
_LIVENESS_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                      + [ctypes.c_float, ctypes.c_void_p])


def plan_shape(n_rows: int, n_cols: int) -> tuple[int, int]:
    """(nI, nJ): the plan's row blocks and column tiles of an (R, C) stripe."""
    return -(-n_rows // PLAN_TM), -(-n_cols // TN)


def _check_plan(counts, col_idx, n_rows, n_cols, device):
    n_i, n_j = plan_shape(n_rows, n_cols)
    check_cuda_tensor("counts", counts, torch.int32, 1, device=device)
    check_cuda_tensor("col_idx", col_idx, torch.int32, 2, device=device)
    if counts.shape[0] != n_i or tuple(col_idx.shape) != (n_i, n_j):
        raise ValueError(f"the plan of a ({n_rows}, {n_cols}) stripe is counts ({n_i},) and "
                         f"col_idx ({n_i}, {n_j}) on the (16, 256) grid, got "
                         f"{tuple(counts.shape)} and {tuple(col_idx.shape)}")


def takes_ring(a: torch.Tensor) -> bool:
    """Whether the stored sweep streams A's live tiles through its
    ``cp.async`` ring: a bf16 A whose rows all start on 16 bytes (A's
    address and a row's bytes multiples of 16). An f32 A, on which the
    ring measured slower than the plain loads on an H100, and rows off 16
    bytes take the plain-load template, which gives the same bits."""
    return (a.dtype == torch.bfloat16 and a.data_ptr() % 16 == 0
            and (a.shape[1] * a.element_size()) % 16 == 0)


def block_sparse_matmat(a: torch.Tensor, v: torch.Tensor, d: torch.Tensor,
                        counts: torch.Tensor, col_idx: torch.Tensor) -> torch.Tensor:
    """U (R, r) f32 = (A V) / max(d, 1e-30) over the plan's live tiles of
    the stored A (R, C) f32 or bf16, V (C, r), d (R,):
    ``degree_normalized_matmat`` with the dead tiles left out, the same bits
    for a finite V. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    if a.device.type == "cpu":
        return ref.block_sparse_matmat_ref(a, v, d, counts, col_idx, tm=PLAN_TM, tn=TN)
    check_cuda_tensor("a", a, A_DTYPES, 2)
    check_cuda_tensor("v", v, torch.float32, 2, device=a.device)
    check_cuda_tensor("d", d, torch.float32, 1, device=a.device)
    n_rows, n_cols = a.shape
    r = v.shape[1]
    if v.shape[0] != n_cols or d.shape[0] != n_rows:
        raise ValueError(f"shape mismatch: a {tuple(a.shape)}, v {tuple(v.shape)}, "
                         f"d {tuple(d.shape)}")
    if not 1 <= r <= MAX_R:
        raise ValueError(f"the block-sparse sweep takes 1 <= r <= {MAX_R} columns, got {r}")
    _check_plan(counts, col_idx, n_rows, n_cols, a.device)
    u = torch.empty((n_rows, r), dtype=torch.float32, device=a.device)
    if n_rows == 0:
        return u
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(
            "block_sparse_matmat", "block_sparse", "gpic_block_sparse_matmat",
            _MATMAT_ARGTYPES, a.data_ptr(), v.data_ptr(), d.data_ptr(), counts.data_ptr(),
            col_idx.data_ptr(), u.data_ptr(), n_rows, n_cols, r, int(takes_ring(a)),
            int(a.dtype == torch.bfloat16), stream)
    return u


def block_sparse_streaming_matmat(
    x: torch.Tensor,
    v: torch.Tensor,
    d: torch.Tensor | None = None,
    xc: torch.Tensor | None = None,
    *,
    counts: torch.Tensor,
    col_idx: torch.Tensor,
    kind: str = "cosine_shifted",
    sigma: float = 1.0,
    row_offset: int = 0,
    col_offset: int = 0,
    scale_r: torch.Tensor | None = None,
    scale_c: torch.Tensor | None = None,
    thr: torch.Tensor | None = None,
) -> torch.Tensor:
    """U = (A V) / max(d, 1e-30) with the masked stripe A of ``x`` against
    ``xc`` rebuilt only on the plan's live tiles (``d=None``: unnormalized);
    ``streaming.affinity_matmat`` with the dead tiles left out, the same
    bits for a finite V. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises."""
    _check_kind(kind, scale_r, scale_c)
    if x.device.type == "cpu":
        return ref.block_sparse_streaming_matmat_ref(
            x, v, d, xc, counts=counts, col_idx=col_idx, tm=PLAN_TM, tn=TN, kind=kind,
            sigma=sigma, row_offset=row_offset, col_offset=col_offset, scale_r=scale_r,
            scale_c=scale_c, thr=thr)
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
        raise ValueError(f"the block-sparse sweep takes 1 <= r <= {MAX_R} columns, got {r}")
    _check_plan(counts, col_idx, n_rows, n_cols, x.device)
    pol = (operand_ptr("scale_r", scale_r, n_rows, x.device),
           operand_ptr("scale_c", scale_c, n_cols, x.device),
           operand_ptr("thr", thr, n_rows, x.device))
    u = torch.empty((n_rows, r), dtype=torch.float32, device=x.device)
    if n_rows == 0:
        return u
    if n_cols == 0:
        return u.zero_()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(
            "block_sparse_streaming_matmat", "block_sparse",
            "gpic_block_sparse_streaming_matmat", _STREAMING_ARGTYPES,
            x.data_ptr(), cols.data_ptr(), *pol, v.data_ptr(),
            None if d is None else d.data_ptr(), counts.data_ptr(), col_idx.data_ptr(),
            u.data_ptr(), n_rows, n_cols, m, r, int(row_offset), int(col_offset),
            KINDS[kind], float(1.0 / (2.0 * sigma * sigma)), stream)
    return u


def block_sparse_streaming_degree(
    x: torch.Tensor,
    xc: torch.Tensor | None = None,
    *,
    counts: torch.Tensor,
    col_idx: torch.Tensor,
    kind: str = "cosine_shifted",
    sigma: float = 1.0,
    row_offset: int = 0,
    col_offset: int = 0,
    scale_r: torch.Tensor | None = None,
    scale_c: torch.Tensor | None = None,
    thr: torch.Tensor | None = None,
) -> torch.Tensor:
    """D (R,) f32 = A 1 over the plan's live tiles, in the order of
    ``affinity_and_degree``'s D (the same bits). A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    _check_kind(kind, scale_r, scale_c)
    if x.device.type == "cpu":
        return ref.block_sparse_streaming_degree_ref(
            x, xc, counts=counts, col_idx=col_idx, tm=PLAN_TM, tn=TN, kind=kind, sigma=sigma,
            row_offset=row_offset, col_offset=col_offset, scale_r=scale_r, scale_c=scale_c,
            thr=thr)
    cols = _check_features(x, xc)
    n_rows, m = x.shape
    n_cols = cols.shape[0]
    _check_plan(counts, col_idx, n_rows, n_cols, x.device)
    pol = (operand_ptr("scale_r", scale_r, n_rows, x.device),
           operand_ptr("scale_c", scale_c, n_cols, x.device),
           operand_ptr("thr", thr, n_rows, x.device))
    d = torch.empty((n_rows,), dtype=torch.float32, device=x.device)
    if n_rows == 0 or n_cols == 0:
        return d.zero_()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(
            "block_sparse_streaming_degree", "block_sparse",
            "gpic_block_sparse_streaming_degree", _DEGREE_ARGTYPES,
            x.data_ptr(), cols.data_ptr(), *pol, counts.data_ptr(), col_idx.data_ptr(),
            d.data_ptr(), n_rows, n_cols, m, int(row_offset), int(col_offset), KINDS[kind],
            float(1.0 / (2.0 * sigma * sigma)), stream)
    return d


def block_liveness(
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
    """(nI, nJ) int32 live map of the masked stripe on the (16, 256) grid,
    without storing A: 1 where the tile holds a nonzero entry, padding
    never live; ``dense_block_live`` of ``affinity_and_degree``'s A,
    exactly. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel or raises."""
    _check_kind(kind, scale_r, scale_c)
    if x.device.type == "cpu":
        return ref.block_liveness_ref(x, xc, tm=PLAN_TM, tn=TN, kind=kind, sigma=sigma,
                                      row_offset=row_offset, col_offset=col_offset,
                                      scale_r=scale_r, scale_c=scale_c, thr=thr)
    cols = _check_features(x, xc)
    n_rows, m = x.shape
    n_cols = cols.shape[0]
    pol = (operand_ptr("scale_r", scale_r, n_rows, x.device),
           operand_ptr("scale_c", scale_c, n_cols, x.device),
           operand_ptr("thr", thr, n_rows, x.device))
    live = torch.zeros(plan_shape(n_rows, n_cols), dtype=torch.int32, device=x.device)
    if live.numel() == 0:
        return live
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(
            "block_liveness", "block_sparse", "gpic_block_liveness", _LIVENESS_ARGTYPES,
            x.data_ptr(), cols.data_ptr(), *pol, live.data_ptr(), n_rows, n_cols, m,
            int(row_offset), int(col_offset), KINDS[kind],
            float(1.0 / (2.0 * sigma * sigma)), stream)
    return live
