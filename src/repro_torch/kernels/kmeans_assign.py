"""Wrapper of the k-means assignment kernel (``csrc/kmeans_assign.cu``).

Counterpart of ``repro/kernels/kmeans_assign.py::kmeans_assign``. The
kernel takes any k and dim: a small form for dim <= 8 and k * dim <= 64
(the GPIC paths' embeddings), a general form with the centroids streamed
through shared memory for the rest, the same bits either way.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from ._check import check_cuda_tensor

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def kmeans_assign(x: torch.Tensor, cents: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(labels (n,) int32, squared distances (n,) f32) of points x (n, dim)
    against centroids (k, dim): the nearest centroid, the first on ties; a
    NaN distance wins, the first one, with its NaN, as argmin and min do. A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if x.device.type == "cpu":
        return ref.kmeans_assign_ref(x, cents)
    check_cuda_tensor("x", x, torch.float32, 2)
    check_cuda_tensor("cents", cents, torch.float32, 2, device=x.device)
    n, dim = x.shape
    k = cents.shape[0]
    if cents.shape[1] != dim:
        raise ValueError(f"x and cents widths differ: {dim} vs {cents.shape[1]}")
    if k < 1:
        raise ValueError("kmeans_assign needs at least one centroid")
    labels = torch.empty((n,), dtype=torch.int32, device=x.device)
    dists = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return labels, dists
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(
            "kmeans_assign", "kmeans_assign", "gpic_kmeans_assign", _ARGTYPES,
            x.data_ptr(), cents.data_ptr(), labels.data_ptr(), dists.data_ptr(),
            n, k, dim, stream)
    return labels, dists
