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

The segmented entry points (``gpic_segment_start``, ``gpic_segment``,
``gpic_segment_finalize``) run the same pipeline as bounded segments of
sweeps over a :class:`~repro_torch.core.power.PowerCarry`, for the
resumable supervisor (core/pipeline.py). Each call rebuilds the operator
from the features; the kernels sum in fixed orders with no float atomics,
so a rebuilt A is the same A and the segments make the monolithic run's
sweeps bit for bit.

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
from .power import (
    backfill_snapshots,
    ensemble_embedding,
    finalize_power_carry,
    init_power_carry,
    init_power_vectors,
    init_power_vectors_local,
    power_iteration_segment,
    random_start_vectors,
    run_power_embedding,
    standardize_columns,
)


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
    u0t=None,
    kmeans_init=None,
) -> PICResult:
    """Accelerated PIC via the multi-vector power engine, on the device of
    ``x``. ``affinity`` (an :class:`AffinitySpec`) takes precedence over the
    ``affinity_kind``/``sigma`` shorthand. ``generator`` draws the extra
    power columns and then the kmeans++ seeds; ``u0t`` ((n, r-1) start
    columns) and ``kmeans_init`` ((k, c) centroids) replace those draws,
    so a run can take the reference's. ``qr_every`` and
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

    v, t_cols, done, emb_raw, status = run_power_embedding(
        op, _start_block(op, n_vectors, generator, u0t), eps, max_iter, embedding=embedding,
        qr_every=qr_every, snapshot_iters=snapshot_iters, residual_tol=residual_tol)
    emb = standardize_columns(emb_raw)
    labels, _ = kmeans(emb, k, iters=kmeans_iters, generator=generator, init=kmeans_init)
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
    u0t=None,
    kmeans_init=None,
) -> PICResult:
    """PIC without A (the reference's O2), on the device of ``x``, for the
    factorable specs (cosine kinds, no scaling or truncation): O(n m r)
    work a sweep and O(n m) memory, the explicit path's function on the
    same engine state. ``generator``, ``u0t`` and ``kmeans_init`` as in
    :func:`gpic`."""
    n = x.shape[0]
    if eps is None:
        eps = 1e-5 / n
    spec = as_affinity_spec(affinity, kind=affinity_kind)
    op = _build_engine_operator(x, spec, engine="matrix_free")

    v, t_cols, done, emb_raw, status = run_power_embedding(
        op, _start_block(op, n_vectors, generator, u0t), eps, max_iter, embedding=embedding,
        qr_every=qr_every, snapshot_iters=snapshot_iters, residual_tol=residual_tol)
    emb = standardize_columns(emb_raw)
    labels, _ = kmeans(emb, k, iters=kmeans_iters, generator=generator, init=kmeans_init)
    # a factorable spec is never truncated: the probe cannot arm
    health = _local_health(op, status, n, spec, probe_components=False)
    return make_pic_result(labels, v, t_cols, done, embedding=embedding,
                           embeddings=emb_raw, health=health)


def _start_block(op, n_vectors, generator, u0t):
    """The (n, r) start state: the degree column, then the extra columns
    drawn from ``generator``, or the given ``u0t``."""
    if u0t is None:
        u0t = random_start_vectors(generator, op.degree.shape[0], n_vectors,
                                   device=op.degree.device)
    return init_power_vectors_local(op.degree, torch.as_tensor(u0t, dtype=torch.float32))


def _components(n, spec, device, build_op, probe_components=True):
    """(n_components, components): the component probe's on a truncated
    spec (a dense graph disconnects only by underflow, which the
    isolated-row count shows), on the operator ``build_op()`` returns, called
    only then; -1 and -1s where the probe does not run."""
    if probe_components and spec.truncated:
        return graph_component_probe(build_op(), n)
    return (torch.tensor(-1, dtype=torch.int32, device=device),
            torch.full((n,), -1, dtype=torch.int32, device=device))


def _local_health(op, status, n, spec, *, probe_components=True):
    """The HealthReport of a local run: isolated rows from the operator's
    degrees, and the component probe when the spec truncates."""
    n_comp, comp = _components(n, spec, status.device, lambda: op, probe_components)
    return HealthReport(col_status=status, isolated_rows=count_bad_rows(op.degree),
                        n_components=n_comp, components=comp)


def gpic_segment_start(x, stop: int, *, generator, eps: float, affinity: AffinitySpec,
                       engine: str = "explicit", a_dtype: torch.dtype = torch.float32,
                       block_sparse: bool = True, n_vectors: int = 1, mode: str = "pic",
                       qr_every: int = 1, snapshot_iters: tuple = (),
                       residual_tol: float | None = None):
    """Build the operator, draw the start block from ``generator`` as
    :func:`gpic` does, and run the first segment to ``stop`` sweeps.
    Returns ``(carry, isolated_rows)``: the count goes with the snapshots,
    so a resumed run needs no degree pass for it. ``mode`` is the loop's
    ('pic' or 'orthogonal'; the ensemble is 'pic' with
    ``snapshot_iters``)."""
    op = _build_engine_operator(x, affinity, engine=engine, a_dtype=a_dtype,
                                block_sparse=block_sparse)
    v0 = init_power_vectors(op.degree, n_vectors, generator=generator)
    carry = power_iteration_segment(
        op, init_power_carry(v0, len(snapshot_iters)), eps, stop, mode=mode,
        qr_every=qr_every, snapshot_iters=snapshot_iters, residual_tol=residual_tol)
    return carry, count_bad_rows(op.degree)


def gpic_segment(x, carry, stop: int, *, eps: float, affinity: AffinitySpec,
                 engine: str = "explicit", a_dtype: torch.dtype = torch.float32,
                 block_sparse: bool = True, mode: str = "pic", qr_every: int = 1,
                 snapshot_iters: tuple = (), residual_tol: float | None = None):
    """Advance a carry (restored, or from the previous segment) to ``stop``
    sweeps on an operator rebuilt from the features."""
    op = _build_engine_operator(x, affinity, engine=engine, a_dtype=a_dtype,
                                block_sparse=block_sparse)
    return power_iteration_segment(op, carry, eps, stop, mode=mode, qr_every=qr_every,
                                   snapshot_iters=snapshot_iters, residual_tol=residual_tol)


def gpic_segment_finalize(x, carry, isolated_rows, k: int, *, generator,
                          kmeans_iters: int = 25, affinity: AffinitySpec,
                          engine: str = "explicit", a_dtype: torch.dtype = torch.float32,
                          block_sparse: bool = True, embedding: str = "pic",
                          snapshot_iters: tuple = (),
                          probe_components: bool = True) -> PICResult:
    """Close a finished carry into :func:`gpic`'s result: COL_MAXITER, the
    ensemble's backfill, standardize, k-means (drawing from ``generator``)
    and the health report. The operator is rebuilt only for the component
    probe of a truncated spec."""
    n = x.shape[0]
    t, v, t_cols, done, snaps, status = finalize_power_carry(carry)
    emb_raw = v
    if embedding == "ensemble":
        emb_raw = ensemble_embedding(backfill_snapshots(snaps, v, t, snapshot_iters))
    emb = standardize_columns(emb_raw)
    labels, _ = kmeans(emb, k, iters=kmeans_iters, generator=generator)
    n_comp, comp = _components(
        n, affinity, status.device,
        lambda: _build_engine_operator(x, affinity, engine=engine, a_dtype=a_dtype,
                                       block_sparse=block_sparse), probe_components)
    health = HealthReport(
        col_status=status,
        isolated_rows=torch.as_tensor(isolated_rows, dtype=torch.int32, device=status.device),
        n_components=n_comp, components=comp)
    return make_pic_result(labels, v, t_cols, done, embedding=embedding,
                           embeddings=emb_raw, health=health)
