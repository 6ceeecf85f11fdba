"""The GPIC front door: one config dataclass, one entry point.

    from repro_torch import GPICConfig, run_gpic

    res = run_gpic(x, k=4, config=GPICConfig(affinity_kind="rbf", sigma=0.3))

``run_gpic`` runs on the CUDA card unless the caller asks for another
device (the tests pass ``device="cpu"``, which runs the kernels' plain
versions). This slice routes the local explicit engine with the classic
``embedding='pic'`` and a dense fixed-bandwidth affinity; the settings a
later slice brings raise ``NotImplementedError`` naming the ROADMAP item.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..kernels.power_step import MAX_R
from .affinity import AffinityKind, AffinitySpec, as_affinity_spec
from .gpic import gpic
from .health import raise_for_health, validate_features
from .pic import PICResult
from .power import EMBEDDINGS

ENGINES = ("explicit", "streaming", "matrix_free")


@dataclass(frozen=True)
class GPICConfig:
    """Everything that selects and tunes a GPIC run, in one hashable value.

      engine:       'explicit' (paper-faithful A build). 'streaming' and
                    'matrix_free' are not ported yet.
      affinity:     an :class:`AffinitySpec`; None derives the dense fixed
                    spec from affinity_kind/sigma. Rejected alongside
                    non-default affinity_kind/sigma.
      affinity_kind/sigma: shorthand for the dense fixed spec (sigma only
                    read for 'rbf').
      n_vectors:    r power vectors in one engine state.
      embedding:    'pic' (classic per-column loop); 'orthogonal' and
                    'ensemble' are not ported yet.
      eps_scale:    convergence threshold numerator (eps = eps_scale / n).
      max_iter / kmeans_iters: loop caps.
      a_dtype:      A storage dtype; this slice stores float32.
      tile:         kernel tile override; this slice's kernels have fixed
                    tiles, so it must stay None.
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
    eps_scale: float = 1e-5
    max_iter: int = 50
    kmeans_iters: int = 25
    a_dtype: torch.dtype = torch.float32
    tile: int | None = None
    seed: int = 0
    sanitize: bool = False

    def with_(self, **updates) -> "GPICConfig":
        """Functional update (``dataclasses.replace`` with a shorter name)."""
        return replace(self, **updates)


def _resolve_device(device) -> torch.device:
    """``None`` means the CUDA card, which must then exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "run_gpic runs on a CUDA device and none is available; pass "
            "device='cpu' to run the kernels' plain versions on the CPU")
    return dev


def check_config(cfg: GPICConfig) -> AffinitySpec:
    """The front-door checks that apply to the fields this slice keeps:
    ValueError for a bad value, NotImplementedError for one a later slice
    routes. Returns the resolved affinity spec."""
    if cfg.engine not in ENGINES:
        raise ValueError(
            f"unknown engine {cfg.engine!r} (expected one of {ENGINES})")
    if cfg.engine != "explicit":
        raise NotImplementedError(
            f"engine={cfg.engine!r} is not ported yet (ROADMAP queue 1 item "
            "3 brings 'streaming', item 8 'matrix_free')")
    if cfg.embedding not in EMBEDDINGS:
        raise ValueError(
            f"unknown embedding {cfg.embedding!r} "
            f"(expected one of {EMBEDDINGS})")
    if cfg.embedding != "pic":
        raise NotImplementedError(
            f"embedding={cfg.embedding!r} is not ported yet (ROADMAP queue 1 "
            "item 4, embedding modes)")
    if cfg.n_vectors < 1:
        raise ValueError(f"n_vectors must be >= 1, got {cfg.n_vectors}")
    if cfg.n_vectors > MAX_R:
        raise NotImplementedError(
            f"n_vectors={cfg.n_vectors}: the power-step kernel takes at most "
            f"{MAX_R} columns (ROADMAP queue 2, kernel 2 follow-up)")
    if cfg.affinity is not None and (
            cfg.affinity_kind != "cosine_shifted" or cfg.sigma != 1.0):
        raise ValueError(
            "set either GPICConfig.affinity (the full spec) or the legacy "
            "affinity_kind/sigma shorthand, not both")
    spec = as_affinity_spec(cfg.affinity, kind=cfg.affinity_kind,
                            sigma=cfg.sigma)
    if not spec.dense_fixed:
        raise NotImplementedError(
            "adaptive-bandwidth and kNN-truncated affinity specs are not "
            f"ported yet (ROADMAP queue 1 item 5, graph policies); got {spec}")
    if cfg.a_dtype != torch.float32:
        raise NotImplementedError(
            f"a_dtype={cfg.a_dtype} is not ported yet (ROADMAP queue 1 item "
            "13, bf16 A storage)")
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
    spec = check_config(cfg)
    dev = _resolve_device(device)
    if isinstance(x, torch.Tensor):
        x = x.to(device=dev, dtype=torch.float32)
    else:
        x = torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)
    x, notes = validate_features(x, k, sanitize=cfg.sanitize)
    spec.validate_for_n(x.shape[0])
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    res = gpic(x.contiguous(), k, generator=generator,
               eps=cfg.eps_scale / x.shape[0], max_iter=cfg.max_iter,
               kmeans_iters=cfg.kmeans_iters, affinity=spec,
               n_vectors=cfg.n_vectors, engine=cfg.engine,
               a_dtype=cfg.a_dtype, embedding=cfg.embedding)
    if notes:
        res = replace(res, health=replace(res.health,
                                          notes=res.health.notes + notes))
    raise_for_health(res.health, x.shape[0])
    return res
