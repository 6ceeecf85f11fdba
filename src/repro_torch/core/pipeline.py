"""The GPIC front door: one config dataclass, one entry point.

    from repro_torch import GPICConfig, run_gpic

    res = run_gpic(x, k=4, config=GPICConfig(affinity_kind="rbf", sigma=0.3))

``run_gpic`` runs on the CUDA card unless the caller asks for another
device (the tests pass ``device="cpu"``, which runs the kernels' plain
versions). The port routes the local explicit and streaming engines with
every affinity spec (dense, adaptive bandwidth, kNN truncation on the
block-sparse route, the default, or the dense-storage one), the
matrix-free engine with the factorable specs, every embedding mode and
the row reorder; the settings a later slice brings raise
``NotImplementedError`` naming the ROADMAP item.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..kernels.block_sparse import TN
from ..kernels.power_step import MAX_R
from ..kernels.row_topk import check_k
from .affinity import AffinityKind, AffinitySpec, as_affinity_spec, invert_permutation
from .gpic import gpic, gpic_matrix_free
from .graph import graph_reorder_permutation
from .health import as_f32, raise_for_health, resolve_device, validate_features
from .pic import PICResult
from .power import EMBEDDINGS

ENGINES = ("explicit", "streaming", "matrix_free")


@dataclass(frozen=True)
class GPICConfig:
    """Everything that selects and tunes a GPIC run, in one hashable value.

      engine:       'explicit' (paper-faithful A build), 'streaming'
                    (A never stored: tiles rebuilt from the features in
                    every sweep) or 'matrix_free' (A never formed: the
                    factored product of the cosine kinds, factorable
                    specs only; ``tile`` and ``a_dtype`` must stay
                    unset).
      affinity:     an :class:`AffinitySpec`; None derives the dense fixed
                    spec from affinity_kind/sigma. Rejected alongside
                    non-default affinity_kind/sigma.
      affinity_kind/sigma: shorthand for the dense fixed spec (sigma only
                    read for 'rbf').
      n_vectors:    r power vectors in one engine state.
      embedding:    'pic' (classic per-column loop), 'orthogonal' (block
                    iteration: column 0 pinned to the classic trajectory,
                    columns 1..r-1 QR-orthonormalized into the invariant
                    subspace) or 'ensemble' (diffusion-time snapshots).
      qr_every:     re-orthonormalization period in sweeps ('orthogonal').
      residual_tol: arm the subspace residual stopping rule ('orthogonal'
                    with n_vectors > 1); None = off.
      snapshot_iters: ascending sweep counts to snapshot ('ensemble'; None
                    = geometric in max_iter).
      eps_scale:    convergence threshold numerator (eps = eps_scale / n).
      max_iter / kmeans_iters: loop caps.
      a_dtype:      A storage dtype ('explicit'); the port stores float32.
      tile:         kernel tile override; this slice's kernels have fixed
                    tiles, so it must stay None.
      block_sparse: the route of a truncated (kNN) spec. True, the
                    default, sweeps only the live tiles of a block plan
                    (explicit: A built in one pass, thresholds from its
                    stored scores; streaming: one liveness pass); False
                    stores and sweeps the truncated graph densely after the
                    two-pass build. The same results on the card. No effect
                    on dense specs, nor at n <= 256 (one column tile).
      row_reorder:  cluster ``x[perm]`` for a permutation computed from row
                    content only (content scores, grouped by the component
                    probe's components for a truncated spec), and map every
                    per-row output back: shuffled and sorted inputs give
                    the same (re-aligned) result where the probe converges,
                    and the block plan sees neighbouring rows together.
      component_probe: run the component probe on a truncated graph; the
                    count lands in ``PICResult.health.n_components``. False
                    skips the probe's sweeps.
      seed:         seeds the ``torch.Generator`` for the k-means init and
                    the extra power vectors when ``run_gpic`` isn't handed
                    one.
      sanitize:     zero-fill non-finite feature values at the front door
                    (recorded in ``PICResult.health.notes``) instead of
                    raising :class:`~repro_torch.core.health.NonFiniteInputError`.
    """
    engine: str = "explicit"
    affinity: AffinitySpec | None = None
    affinity_kind: AffinityKind = "cosine_shifted"
    sigma: float = 1.0
    n_vectors: int = 1
    embedding: str = "pic"
    qr_every: int = 1
    residual_tol: float | None = None
    snapshot_iters: tuple[int, ...] | None = None
    eps_scale: float = 1e-5
    max_iter: int = 50
    kmeans_iters: int = 25
    a_dtype: torch.dtype = torch.float32
    tile: int | None = None
    block_sparse: bool = True
    row_reorder: bool = False
    seed: int = 0
    sanitize: bool = False
    component_probe: bool = True

    def with_(self, **updates) -> "GPICConfig":
        """Functional update (``dataclasses.replace`` with a shorter name)."""
        return replace(self, **updates)


def check_config(cfg: GPICConfig, n: int | None = None) -> AffinitySpec:
    """The front-door checks: first the reference's ValueErrors for a bad
    value or combination, in the reference's order, so a config the
    reference refuses raises the same class here (the neighbor ranks of the
    spec are checked against ``n`` when it is given); then
    NotImplementedError for a setting a later slice routes. Returns the
    resolved affinity spec."""
    if cfg.engine not in ENGINES:
        raise ValueError(
            f"unknown engine {cfg.engine!r} (expected one of {ENGINES})")
    if cfg.embedding not in EMBEDDINGS:
        raise ValueError(
            f"unknown embedding {cfg.embedding!r} "
            f"(expected one of {EMBEDDINGS})")
    if cfg.qr_every < 1:
        raise ValueError(
            f"qr_every must be >= 1 (a period in sweeps), got {cfg.qr_every}")
    if cfg.qr_every != 1 and cfg.embedding != "orthogonal":
        raise ValueError(
            "qr_every tunes the re-orthonormalization period of "
            "embedding='orthogonal' only")
    if cfg.snapshot_iters is not None and cfg.embedding != "ensemble":
        raise ValueError(
            "snapshot_iters selects the diffusion times of "
            "embedding='ensemble' only")
    if cfg.residual_tol is not None:
        if cfg.embedding != "orthogonal":
            raise ValueError(
                "residual_tol arms the subspace residual stopping rule of "
                "embedding='orthogonal' only")
        if cfg.n_vectors < 2:
            raise ValueError(
                "residual_tol stops the QR-coupled block columns; with "
                "n_vectors=1 the orthogonal loop IS the classic one and "
                "the rule can never arm — drop it or raise n_vectors")
        if not float(cfg.residual_tol) > 0.0:
            raise ValueError(
                f"residual_tol must be > 0 (a relative residual), got "
                f"{cfg.residual_tol}")
    if cfg.affinity is not None and (
            cfg.affinity_kind != "cosine_shifted" or cfg.sigma != 1.0):
        raise ValueError(
            "set either GPICConfig.affinity (the full spec) or the legacy "
            "affinity_kind/sigma shorthand, not both")
    spec = as_affinity_spec(cfg.affinity, kind=cfg.affinity_kind,
                            sigma=cfg.sigma)
    if n is not None:
        spec.validate_for_n(n)
    if cfg.engine == "matrix_free":
        dropped = [name for name, bad in (
            ("tile", cfg.tile is not None),
            ("a_dtype", cfg.a_dtype != torch.float32),
        ) if bad]
        if dropped:
            raise ValueError(
                f"engine='matrix_free' does not use {dropped} (the factored "
                "jnp sweep has no A storage or Pallas tiles)")
        if not spec.factorable:
            raise ValueError(
                "engine='matrix_free' needs a factorable affinity spec "
                "(cosine kinds, fixed bandwidth, no truncation); got "
                f"{spec} — use the explicit or streaming engine for "
                "adaptive/kNN graphs")
    if cfg.engine == "streaming" and cfg.a_dtype != torch.float32:
        raise ValueError(
            "a_dtype (O4) selects the A *storage* dtype; the streaming "
            "engine never stores A")
    if cfg.n_vectors < 1:
        raise ValueError(f"n_vectors must be >= 1, got {cfg.n_vectors}")
    # the cap holds for the matrix-free engine too: its Gram kernel takes
    # the residual rule's [V | U] up to 2 MAX_R columns
    if cfg.n_vectors > MAX_R:
        raise NotImplementedError(
            f"n_vectors={cfg.n_vectors}: the power-step kernel takes at most "
            f"{MAX_R} columns (ROADMAP queue 2, kernel 2 follow-up)")
    if spec.adaptive:
        check_k(spec.scale_k)
    # the kNN thresholds come from the row top-k kernel on every route but
    # the explicit block-sparse one (n > 256), which selects them from its
    # stored scores; the reorder's probe runs the dense-grid streaming
    # operator
    if spec.truncated and (cfg.engine == "streaming" or cfg.row_reorder
                           or not cfg.block_sparse or (n is not None and n <= TN)):
        check_k(spec.knn_k)
    if cfg.a_dtype != torch.float32:
        raise NotImplementedError(
            f"a_dtype={cfg.a_dtype} is not ported yet (ROADMAP queue 1 item "
            "13, bf16 A storage: the reference's a_dtype through kernel 1's "
            "out_dtype and kernel 2's upcast)")
    if cfg.tile is not None:
        raise NotImplementedError(
            "tile overrides are not ported yet (ROADMAP queue 1 item 1, the "
            "tile policy); this slice's kernels use fixed tiles")
    return spec


def run_gpic(
    x,
    k: int,
    config: GPICConfig | None = None,
    *,
    device=None,
    generator: torch.Generator | None = None,
    **overrides,
) -> PICResult:
    """Run GPIC as described by ``config`` (plus keyword overrides).

    ``x`` is the (n, m) feature matrix, a numpy array or a tensor; it is
    moved to ``device`` as float32. ``device=None`` means ``"cuda"`` and
    raises when no CUDA device is present. ``generator`` (a
    ``torch.Generator`` on that device) draws the random numbers; without
    one a generator seeded from ``config.seed`` is used.

    Degenerate inputs raise a typed
    :class:`~repro_torch.core.health.GPICError` at the front door
    (non-finite features unless ``sanitize``, n < k, constant rows) or after
    the run (every row isolated, every power column dead); anything less
    total returns with the damage described in ``result.health``.
    """
    cfg = config or GPICConfig()
    if overrides:
        cfg = cfg.with_(**overrides)
    shape = np.shape(x)
    spec = check_config(cfg, shape[0] if shape else None)
    dev = resolve_device(device, "run_gpic")
    x = as_f32(x, dev)
    x, notes = validate_features(x, k, sanitize=cfg.sanitize)
    inv = None
    if cfg.row_reorder:
        perm = graph_reorder_permutation(x, spec)
        inv = invert_permutation(perm)
        x = x[perm]
        notes = tuple(notes) + ("row_reorder",)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    common = dict(generator=generator, eps=cfg.eps_scale / x.shape[0],
                  max_iter=cfg.max_iter, kmeans_iters=cfg.kmeans_iters, affinity=spec,
                  n_vectors=cfg.n_vectors, embedding=cfg.embedding,
                  qr_every=cfg.qr_every, residual_tol=cfg.residual_tol,
                  snapshot_iters=cfg.snapshot_iters)
    if cfg.engine == "matrix_free":
        res = gpic_matrix_free(x.contiguous(), k, **common)
    else:
        res = gpic(x.contiguous(), k, engine=cfg.engine, a_dtype=cfg.a_dtype,
                   probe_components=cfg.component_probe, block_sparse=cfg.block_sparse,
                   **common)
    if inv is not None:
        res = _unpermute_result(res, inv)
    if notes:
        res = replace(res, health=replace(res.health,
                                          notes=res.health.notes + notes))
    raise_for_health(res.health, x.shape[0])
    return res


def _unpermute_result(res: PICResult, inv: torch.Tensor) -> PICResult:
    """Map every per-row output of a run on ``x[perm]`` back to the
    caller's row order: the labels, the column-0 embedding, the clustered
    block and the component ids. Indexing only, hence exact."""
    health = res.health
    if health is not None:
        health = replace(health, components=health.components[inv])
    return replace(res, labels=res.labels[inv], embedding=res.embedding[inv],
                   embeddings=res.embeddings[inv], health=health)
