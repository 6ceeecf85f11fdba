"""GPIC — the accelerated Power Iteration Clustering pipeline (Algorithm 2).

The paper's six CUDA kernels map onto two fused kernels plus O(n) epilogues:

    paper kernel 1 AffinityMatrix ┐
    paper kernel 2 RowSum         ┴→ kernels.ops.affinity_and_degree  (fused)
    paper kernel 3 NormMatrix      → eliminated: W V = D^-1 (A V)
    paper kernel 6 Multiply       ┐
    paper kernel 4 Reduction      ┴→ kernels.ops.degree_normalized_matmat
    paper kernel 5 Norm            → O(n r) epilogue in the power loop

then k-means on the embedding (kernels.ops.kmeans_assign per Lloyd step).
``engine='streaming'`` stores no A: kernels.ops.streaming_degree builds D
once and kernels.ops.streaming_matmat rebuilds A's tiles inside every
sweep. A kNN spec's default block-sparse route sweeps only the live tiles
(kernels.ops.block_sparse_matmat on the stored A, or the block-sparse
streaming kernels after kernels.ops.block_liveness). Every embedding mode
runs on either engine ('orthogonal' prices its QR with kernels.ops.gram). An adaptive or kNN spec adds pass 1
(kernels.ops.row_topk) before the build, and a kNN spec the component
probe after the run (core/health.py). ``gpic_matrix_free`` runs the
factorable specs without A: two plain matmuls a sweep
(core/operators.py::matrix_free_operator), the Gram and k-means on the
kernels as above.

Prefer the ``run_gpic``/``GPICConfig`` front door (core/pipeline.py).
"""
from __future__ import annotations

import torch

from .affinity import (
    AffinityKind,
    AffinitySpec,
    as_affinity_spec,
    row_normalize_features,
)
from .health import HealthReport, count_bad_rows, graph_component_probe
from .kmeans import kmeans
from .operators import explicit_operator, matrix_free_operator, streaming_operator
from .pic import PICResult, make_pic_result
from .power import init_power_vectors, run_power_embedding, standardize_columns


def _build_engine_operator(x, spec, *, engine, a_dtype=torch.float32, block_sparse=True):
    """Normalize features per the spec's kind and bind the engine
    ('explicit', 'streaming' or 'matrix_free', which the callers check):
    the cosine kinds take row-normalized input, rbf the raw features; the
    matrix-free engine always takes row-normalized features."""
    if engine == "matrix_free":
        return matrix_free_operator(row_normalize_features(x), spec=spec)
    inp = x if spec.kind == "rbf" else row_normalize_features(x)
    if engine == "explicit":
        return explicit_operator(inp, spec=spec, a_dtype=a_dtype, block_sparse=block_sparse)
    return streaming_operator(inp, spec=spec, block_sparse=block_sparse)


def gpic(
    x: torch.Tensor,
    k: int,
    *,
    generator: torch.Generator | None = None,
    eps: float | None = None,
    max_iter: int = 50,
    kmeans_iters: int = 25,
    affinity_kind: AffinityKind = "cosine_shifted",
    sigma: float = 1.0,
    affinity: AffinitySpec | None = None,
    n_vectors: int = 1,
    engine: str = "explicit",
    a_dtype: torch.dtype = torch.float32,
    embedding: str = "pic",
    qr_every: int = 1,
    snapshot_iters: tuple | None = None,
    residual_tol: float | None = None,
    probe_components: bool = True,
    block_sparse: bool = True,
) -> PICResult:
    """Accelerated PIC via the multi-vector power engine, on the device of
    ``x``. ``affinity`` (an :class:`AffinitySpec`) takes precedence over the
    ``affinity_kind``/``sigma`` shorthand. ``generator`` draws the extra
    power columns and then the kmeans++ seeds. ``qr_every`` and
    ``residual_tol`` tune embedding='orthogonal', ``snapshot_iters``
    embedding='ensemble'. ``probe_components`` runs the component probe
    on a truncated graph; ``block_sparse`` picks a truncated spec's route
    (the live tiles of a block plan, or the dense storage)."""
    n = x.shape[0]
    if eps is None:
        eps = 1e-5 / n
    spec = as_affinity_spec(affinity, kind=affinity_kind, sigma=sigma)
    spec.validate_for_n(n)
    if engine not in ("explicit", "streaming"):
        raise ValueError(f"unknown engine {engine!r} "
                         "(expected 'explicit' or 'streaming')")
    op = _build_engine_operator(x, spec, engine=engine, a_dtype=a_dtype,
                                block_sparse=block_sparse)

    v0 = init_power_vectors(op.degree, n_vectors, generator=generator)
    v, t_cols, done, emb_raw, status = run_power_embedding(
        op, v0, eps, max_iter, embedding=embedding, qr_every=qr_every,
        snapshot_iters=snapshot_iters, residual_tol=residual_tol)
    emb = standardize_columns(emb_raw)
    labels, _ = kmeans(emb, k, iters=kmeans_iters, generator=generator)
    health = _local_health(op, status, n, spec, probe_components=probe_components)
    return make_pic_result(labels, v, t_cols, done, embedding=embedding,
                           embeddings=emb_raw, health=health)


def gpic_matrix_free(
    x: torch.Tensor,
    k: int,
    *,
    generator: torch.Generator | None = None,
    eps: float | None = None,
    max_iter: int = 50,
    kmeans_iters: int = 25,
    affinity_kind: AffinityKind = "cosine_shifted",
    affinity: AffinitySpec | None = None,
    n_vectors: int = 1,
    embedding: str = "pic",
    qr_every: int = 1,
    snapshot_iters: tuple | None = None,
    residual_tol: float | None = None,
) -> PICResult:
    """PIC without A (the reference's O2), on the device of ``x``, for the
    factorable specs (cosine kinds, no scaling or truncation): O(n m r)
    work a sweep and O(n m) memory, the explicit path's function on the
    same engine state. ``generator`` draws as in :func:`gpic`."""
    n = x.shape[0]
    if eps is None:
        eps = 1e-5 / n
    spec = as_affinity_spec(affinity, kind=affinity_kind)
    op = _build_engine_operator(x, spec, engine="matrix_free")

    v0 = init_power_vectors(op.degree, n_vectors, generator=generator)
    v, t_cols, done, emb_raw, status = run_power_embedding(
        op, v0, eps, max_iter, embedding=embedding, qr_every=qr_every,
        snapshot_iters=snapshot_iters, residual_tol=residual_tol)
    emb = standardize_columns(emb_raw)
    labels, _ = kmeans(emb, k, iters=kmeans_iters, generator=generator)
    # a factorable spec is never truncated: the probe cannot arm
    health = _local_health(op, status, n, spec, probe_components=False)
    return make_pic_result(labels, v, t_cols, done, embedding=embedding,
                           embeddings=emb_raw, health=health)


def _local_health(op, status, n, spec, *, probe_components=True):
    """The HealthReport of a local run: isolated rows from the operator's
    degrees, and the component probe when the spec truncates (a dense graph
    disconnects only by underflow, which the isolated-row count shows)."""
    if probe_components and spec.truncated:
        n_comp, comp = graph_component_probe(op, n)
    else:
        n_comp = torch.tensor(-1, dtype=torch.int32, device=op.degree.device)
        comp = torch.full((n,), -1, dtype=torch.int32, device=op.degree.device)
    return HealthReport(col_status=status, isolated_rows=count_bad_rows(op.degree),
                        n_components=n_comp, components=comp)
