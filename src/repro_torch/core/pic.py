"""Paper-faithful Power Iteration Clustering (PIC), Algorithm 1 of GPIC.

The plain counterparts of the GPIC engines, and their result type:

  - ``pic_reference`` / ``pic_from_affinity``: explicit W = D^-1 A, the
    truncated power iteration with the paper's acceleration-based stopping
    rule, then k-means. Plain torch (the oracle path: the sweep is
    ``W @ V``, cuBLAS on the card), on the CUDA card unless the caller
    passes ``device="cpu"``; k-means runs the assignment kernel there.
  - ``pic_serial_numpy``: a deliberately un-fused row-loop numpy version in
    float64, standing in for the paper's serial MATLAB baseline (the
    Table 2 comparison); only its k-means runs on ``device``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .affinity import AffinityKind, AffinitySpec, affinity_matrix
from .health import HealthReport, as_f32, count_bad_rows, resolve_device
from .kmeans import kmeans
from .power import (batched_power_iteration, init_power_vectors, run_power_embedding,
                    standardize_columns)


@dataclass(frozen=True)
class PICResult:
    labels: torch.Tensor          # (n,) int32 cluster assignment
    embedding: torch.Tensor       # (n,) final power-iteration vector (column 0)
    n_iter: torch.Tensor          # iterations executed by column 0
    converged: torch.Tensor       # bool — column 0 stopped by the epsilon rule
    embeddings: torch.Tensor      # (n, c) matrix k-means clustered
    n_iter_cols: torch.Tensor     # (r,) int32 per-column iteration counts
    converged_cols: torch.Tensor  # (r,) bool per-column convergence flags
    #: which embedding mode produced ``embeddings``
    embedding_mode: str = "pic"
    #: per-run diagnostics (core/health.py)
    health: HealthReport | None = None


def make_pic_result(labels, v, t_cols, done, *, embedding="pic",
                    embeddings=None, health=None) -> PICResult:
    """Assemble a PICResult from the engine outputs: labels (n,), the final
    (n, r) state, and the per-column (r,) iteration counts / flags. Column 0
    (the paper's degree-seeded vector) backs the scalar fields."""
    return PICResult(
        labels=labels, embedding=v[:, 0], n_iter=t_cols[0], converged=done[0],
        embeddings=v if embeddings is None else embeddings,
        n_iter_cols=t_cols, converged_cols=done, embedding_mode=embedding,
        health=health,
    )


def _power_iterate(w_matvec, v0: torch.Tensor, eps: float, max_iter: int):
    """Single-vector truncated power iteration with the paper's stopping
    rule ||delta_{t+1} - delta_t||_inf <= eps, delta_{t+1} = |v_{t+1} - v_t|
    (Algorithm 1 lines 4-7): the r = 1 slice of the batched engine loop.
    Returns (v, n_iter, converged)."""
    v, t_cols, done = batched_power_iteration(
        lambda vv: w_matvec(vv[:, 0])[:, None], v0[:, None], eps, max_iter)
    return v[:, 0], t_cols[0], done[0]


def standardize_embedding(v: torch.Tensor) -> torch.Tensor:
    """Zero-mean / unit-variance rescale of the 1-D embedding before
    k-means (population std): PIC's embedding spans ~1e-5 of its magnitude
    (values cluster around 1/n)."""
    return (v - torch.mean(v)) / torch.clamp_min(torch.std(v, correction=0), 1e-30)


def pic_reference(
    x,
    k: int,
    *,
    generator: torch.Generator | None = None,
    device=None,
    eps: float | None = None,
    max_iter: int = 50,
    kmeans_iters: int = 25,
    affinity_kind: AffinityKind = "cosine_shifted",
    sigma: float | None = None,
    affinity: AffinitySpec | None = None,
    n_vectors: int = 1,
    embedding: str = "pic",
    qr_every: int = 1,
    snapshot_iters: tuple | None = None,
    residual_tol: float | None = None,
) -> PICResult:
    """Paper Algorithm 1 end to end on raw features ``x`` (n, m), a numpy
    array or a tensor, on ``device`` (None: the CUDA card, which must
    exist). ``affinity`` (an :class:`AffinitySpec`) builds the dense plain
    version of the whole graph policy; the ``affinity_kind``/``sigma``
    shorthand the classic dense builds (``sigma=None`` on rbf: the strided
    median heuristic). A is then (n, n) f32 on the device, and so is W."""
    dev = resolve_device(device, "pic_reference")
    x = as_f32(x, dev)
    if affinity is not None:
        a = affinity_matrix(x, spec=affinity)
    else:
        a = affinity_matrix(x, kind=affinity_kind, sigma=sigma)
    return pic_from_affinity(
        a, k, generator=generator, device=dev, eps=eps, max_iter=max_iter,
        kmeans_iters=kmeans_iters, n_vectors=n_vectors, embedding=embedding,
        qr_every=qr_every, snapshot_iters=snapshot_iters, residual_tol=residual_tol)


def pic_from_affinity(
    a,
    k: int,
    *,
    generator: torch.Generator | None = None,
    device=None,
    eps: float | None = None,
    max_iter: int = 50,
    kmeans_iters: int = 25,
    n_vectors: int = 1,
    embedding: str = "pic",
    qr_every: int = 1,
    snapshot_iters: tuple | None = None,
    residual_tol: float | None = None,
) -> PICResult:
    """PIC on a dense affinity matrix A (the paper-faithful path), taken as
    f32 on ``device`` (None: the CUDA card).

    W = D^-1 A is materialized, as Algorithm 1/2 do, with a zero row where
    the degree is not > 0 (an isolated row). v_0 = D / sum(D), plus random
    start columns from ``generator`` when ``n_vectors > 1``; ``generator``
    then draws the kmeans++ seeds. ``eps`` defaults to the paper's 1e-5 / n.
    The sweep is ``W @ V`` and the block algebra of ``embedding`` uses the
    plain Gram, as the reference's oracle path does; k-means runs the
    assignment kernel on the card. The component probe is not armed
    (``n_components`` -1).
    """
    dev = resolve_device(device, "pic_from_affinity")
    a = as_f32(a, dev)
    n = a.shape[0]
    if eps is None:
        eps = 1e-5 / n
    d = torch.sum(a, dim=1)
    dok = d > 0
    w = torch.where(dok[:, None], a / torch.where(dok, d, 1.0)[:, None], 0.0)

    v0 = init_power_vectors(d, n_vectors, generator=generator, dtype=a.dtype)
    v, t_cols, done, emb_raw, status = run_power_embedding(
        lambda vv: w @ vv, v0, eps, max_iter, embedding=embedding,
        qr_every=qr_every, snapshot_iters=snapshot_iters, residual_tol=residual_tol)
    emb = standardize_columns(emb_raw)
    labels, _ = kmeans(emb, k, iters=kmeans_iters, generator=generator)
    health = HealthReport(
        col_status=status, isolated_rows=count_bad_rows(d),
        n_components=torch.tensor(-1, dtype=torch.int32, device=dev),
        components=torch.full((n,), -1, dtype=torch.int32, device=dev))
    return make_pic_result(labels, v, t_cols, done, embedding=embedding,
                           embeddings=emb_raw, health=health)


# ---------------------------------------------------------------------------
# Serial baseline (stands in for the MATLAB implementation the paper times)
# ---------------------------------------------------------------------------


def pic_serial_numpy(
    x: np.ndarray,
    k: int,
    *,
    seed: int = 0,
    device=None,
    eps: float | None = None,
    max_iter: int = 50,
    kmeans_iters: int = 25,
    affinity_kind: AffinityKind = "cosine_shifted",
    sigma: float | None = None,
    return_timings: bool = False,
):
    """Row-at-a-time serial PIC in float64 numpy, with the structure the
    paper profiles: an O(n^2 m) affinity loop (its Table 1 bottleneck),
    explicit RowSum and NormMatrix passes, then an un-fused power loop.
    Deliberately not vectorized across rows, so that the affinity stage
    dominates as in the MATLAB original. Only k-means runs on ``device``
    (None: the CUDA card), from a generator seeded with ``seed``.

    Returns (labels, v) as numpy, and with ``return_timings`` the seconds
    of each stage and the sweep count as a third value.
    """
    dev = resolve_device(device, "pic_serial_numpy")
    n = x.shape[0]
    x = np.asarray(x, np.float64)
    if eps is None:
        eps = 1e-5 / n

    t0 = time.perf_counter()
    if affinity_kind in ("cosine", "cosine_shifted"):
        xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        a = np.empty((n, n), np.float64)
        for i in range(n):  # deliberate serial row loop (see docstring)
            row = xn[i] @ xn.T
            if affinity_kind == "cosine_shifted":
                row = 0.5 * (1.0 + row)
            row[i] = 0.0
            a[i] = row
    else:
        sq = np.sum(x * x, axis=1)
        if sigma is not None:
            sig = float(sigma)
        else:
            # the strided sample of core.affinity.rbf_bandwidth_heuristic
            take = min(512, n)
            xs = x[:: max(-(-n // take), 1)][:take]
            sqs = np.sum(xs * xs, axis=1)
            sig = float(np.median(np.sqrt(np.maximum(
                sqs[:, None] + sqs[None, :] - 2 * xs @ xs.T, 0)
                + np.eye(len(xs)) * 1e9)))
        a = np.empty((n, n), np.float64)
        for i in range(n):
            d2 = np.maximum(sq[i] + sq - 2.0 * (x[i] @ x.T), 0.0)
            row = np.exp(-d2 / (2.0 * sig * sig))
            row[i] = 0.0
            a[i] = row
    t_affinity = time.perf_counter() - t0

    t1 = time.perf_counter()
    d = a.sum(axis=1)                      # RowSum kernel
    w = a / np.maximum(d, 1e-30)[:, None]  # NormMatrix kernel
    t_norm = time.perf_counter() - t1

    t1 = time.perf_counter()
    v = d / max(d.sum(), 1e-30)            # Reduction + Norm
    delta = v.copy()
    it = 0
    for it in range(1, max_iter + 1):      # power loop (Multiply/Reduction/Norm)
        wv = w @ v
        v_next = wv / max(np.abs(wv).sum(), 1e-30)
        delta_next = np.abs(v_next - v)
        accel = np.max(np.abs(delta_next - delta))
        v, delta = v_next, delta_next
        if accel <= eps:
            break
    t_power = time.perf_counter() - t1

    t2 = time.perf_counter()
    v_std = (v - v.mean()) / max(v.std(), 1e-30)
    generator = torch.Generator(device=dev).manual_seed(seed)
    labels, _ = kmeans(torch.as_tensor(v_std, dtype=torch.float32, device=dev)[:, None], k,
                       iters=kmeans_iters, generator=generator)
    labels = labels.cpu().numpy()
    t_kmeans = time.perf_counter() - t2

    if return_timings:
        return labels, v, {
            "affinity_s": t_affinity,
            "norm_s": t_norm,
            "power_s": t_power,
            "kmeans_s": t_kmeans,
            "total_s": t_affinity + t_norm + t_power + t_kmeans,
            "n_iter": it,
        }
    return labels, v
