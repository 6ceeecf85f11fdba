"""GPIC — the accelerated Power Iteration Clustering pipeline (Algorithm 2).

The paper's six CUDA kernels map onto two fused kernels plus O(n) epilogues:

    paper kernel 1 AffinityMatrix ┐
    paper kernel 2 RowSum         ┴→ kernels.ops.affinity_and_degree  (fused)
    paper kernel 3 NormMatrix      → eliminated: W V = D^-1 (A V)
    paper kernel 6 Multiply       ┐
    paper kernel 4 Reduction      ┴→ kernels.ops.degree_normalized_matmat
    paper kernel 5 Norm            → O(n r) epilogue in the power loop

then k-means on the embedding (kernels.ops.kmeans_assign per Lloyd step).
This slice ports ``engine='explicit'`` with ``embedding='pic'``.

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
from .health import HealthReport, count_bad_rows
from .kmeans import kmeans
from .operators import explicit_operator
from .pic import PICResult, make_pic_result
from .power import init_power_vectors, run_power_embedding, standardize_columns


def _build_engine_operator(x, spec, *, engine, a_dtype=torch.float32):
    """Normalize features per the spec's kind and bind the engine: the
    cosine kinds take row-normalized input, rbf the raw features."""
    if engine != "explicit":
        raise NotImplementedError(
            f"engine={engine!r} is not ported yet (ROADMAP queue 1 item 3 "
            "brings 'streaming', item 8 'matrix_free')")
    inp = x if spec.kind == "rbf" else row_normalize_features(x)
    return explicit_operator(inp, spec=spec, a_dtype=a_dtype)


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
) -> PICResult:
    """Accelerated PIC via the multi-vector power engine, on the device of
    ``x``. ``affinity`` (an :class:`AffinitySpec`) takes precedence over the
    ``affinity_kind``/``sigma`` shorthand. ``generator`` draws the extra
    power columns and then the kmeans++ seeds."""
    n = x.shape[0]
    if eps is None:
        eps = 1e-5 / n
    spec = as_affinity_spec(affinity, kind=affinity_kind, sigma=sigma)
    spec.validate_for_n(n)
    op = _build_engine_operator(x, spec, engine=engine, a_dtype=a_dtype)

    v0 = init_power_vectors(op.degree, n_vectors, generator=generator)
    v, t_cols, done, emb_raw, status = run_power_embedding(
        op, v0, eps, max_iter, embedding=embedding)
    emb = standardize_columns(emb_raw)
    labels, _ = kmeans(emb, k, iters=kmeans_iters, generator=generator)
    # a dense graph disconnects only by underflow, which the isolated-row
    # count surfaces: the component probe (truncated specs) does not arm
    health = HealthReport(
        col_status=status, isolated_rows=count_bad_rows(op.degree),
        n_components=torch.tensor(-1, dtype=torch.int32, device=x.device),
        components=torch.full((n,), -1, dtype=torch.int32, device=x.device))
    return make_pic_result(labels, v, t_cols, done, embedding=embedding,
                           embeddings=emb_raw, health=health)
