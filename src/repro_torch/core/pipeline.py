"""The GPIC front door: one config dataclass, one entry point.

    from repro_torch import GPICConfig, run_gpic

    res = run_gpic(x, k=4, config=GPICConfig(affinity_kind="rbf", sigma=0.3))

``run_gpic`` runs on the CUDA card unless the caller asks for another
device (the tests pass ``device="cpu"``, which runs the kernels' plain
versions). The port routes the local explicit and streaming engines with
every affinity spec (dense, adaptive bandwidth, kNN truncation on the
block-sparse route, the default, or the dense-storage one), the
matrix-free engine with the factorable specs, every embedding mode, the
row reorder, A stored in bf16 (``a_dtype``) and the resumable supervisor
(``checkpoint_every``, ``straggler_timeout``, ``segment_injector``). With
``mesh`` (a ``torch.distributed`` process group) each rank passes its row
block and the run goes to the sharded engines (``core/distributed.py``),
with ``fold_shift``, ``overlap`` and ``inject_ring_fault``, the supervisor
and the row reorder included. The settings a later slice brings raise
``NotImplementedError`` naming the ROADMAP item.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, replace
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.block_sparse import TN
from ..kernels.power_step import MAX_R
from ..kernels.row_topk import check_k
from .affinity import AffinityKind, AffinitySpec, as_affinity_spec, invert_permutation
from .distributed import (CARRY_ROW_LEAVES, distributed_component_ids, distributed_gpic,
                          distributed_gpic_matrix_free, distributed_gpic_segment,
                          distributed_gpic_segment_finalize, distributed_gpic_segment_start,
                          shard_points)
from .gpic import gpic, gpic_matrix_free, gpic_segment, gpic_segment_finalize, gpic_segment_start
from .graph import content_row_score, graph_reorder_permutation, reorder_permutation
from .operators import mesh_reductions
from .health import (GPICError, StragglerTimeout, as_f32, raise_for_health, resolve_device,
                     validate_features)
from .pic import PICResult
from .power import EMBEDDINGS, power_carry_like, random_start_vectors, resolve_snapshot_iters

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
      a_dtype:      A storage dtype ('explicit'): float32, or bfloat16
                    (the reference's O4: half of A's memory and of the
                    sweep's bytes; D and the sums stay f32).
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

    Multi-GPU (see ``core/distributed.py``):
      mesh:         a ``torch.distributed`` process group (NCCL with one
                    card a rank, or gloo on the CPU), or None for one
                    device. Each rank calls ``run_gpic`` with its row block
                    (``shard_points``) and gets the whole run's result.
      fold_shift:   O5: the sharded explicit engine stores raw cosine and
                    folds the ``cosine_shifted`` transform into an O(n r)
                    epilogue (a dense fixed ``cosine_shifted`` spec only).
      overlap:      the streaming ring's schedule: sends and receives of
                    the next stage in flight during the current one
                    (True), or after it; the same bits either way.
      inject_ring_fault: ``('ring_nan', stage)`` poisons the V block the
                    sharded streaming ring consumes at that stage with NaN
                    (fault injection; mesh and engine='streaming' only).

    Resumable execution (one device or a group; see :func:`_run_supervised`):
      checkpoint_every: run the power loop in segments of this many sweeps
                    and snapshot the loop's carry after each. A segment
                    boundary moves only where the loop stops, so a run
                    interrupted at any sweep and resumed is bitwise the
                    uninterrupted run. Set with ckpt_dir (both or neither).
                    With ``mesh`` a snapshot is the global carry, as one
                    device writes it, so it resumes on any number of ranks.
      ckpt_dir:     the snapshots' directory. If it holds a valid snapshot
                    (an earlier call died), the run resumes from it (note
                    ``resumed:<sweep>``); a corrupt snapshot is quarantined
                    and the one before it used (``checkpoint_skipped:<dir>``).
      max_retries:  restarts after a retryable failure (a GPICError: an
                    injected fault, a straggler timeout) before it is
                    raised; each resumes from the last snapshot (note
                    ``retry:<n>:<ErrorClass>``).
      backoff:      base seconds of the exponential wait between retries
                    (backoff * 2^(retry - 1); 0: none).
      straggler_timeout: wall-clock seconds a segment may take; a slower one
                    raises :class:`~repro_torch.core.health.StragglerTimeout`
                    (note ``straggler:<sweep>:<sec>``), which is retried.
                    Works without snapshots (the run is then one segment).
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
    mesh: dist.ProcessGroup | None = None
    fold_shift: bool = False
    overlap: bool = True
    inject_ring_fault: tuple | None = None
    checkpoint_every: int | None = None
    ckpt_dir: str | None = None
    max_retries: int = 3
    backoff: float = 0.0
    straggler_timeout: float | None = None

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
            ("fold_shift", cfg.fold_shift),
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
    elif cfg.fold_shift and (cfg.mesh is None or cfg.engine != "explicit"
                             or spec.kind != "cosine_shifted"
                             or not spec.dense_fixed):
        raise ValueError(
            "fold_shift (O5) applies only to the sharded explicit engine "
            "with a dense fixed cosine_shifted spec (the shift being "
            "folded has no closed form on a truncated row)")
    if cfg.engine == "streaming" and cfg.a_dtype != torch.float32:
        raise ValueError(
            "a_dtype (O4) selects the A *storage* dtype; the streaming "
            "engine never stores A")
    if (cfg.checkpoint_every is None) != (cfg.ckpt_dir is None):
        raise ValueError(
            "checkpoint_every and ckpt_dir come as a pair (a snapshot "
            "cadence needs a directory and vice versa); set both or "
            "neither")
    if cfg.checkpoint_every is not None and cfg.checkpoint_every < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1 (a period in sweeps), got "
            f"{cfg.checkpoint_every}")
    if cfg.max_retries < 0:
        raise ValueError(f"max_retries must be >= 0, got {cfg.max_retries}")
    if cfg.backoff < 0:
        raise ValueError(f"backoff must be >= 0 seconds, got {cfg.backoff}")
    if cfg.straggler_timeout is not None and not cfg.straggler_timeout > 0:
        raise ValueError(
            f"straggler_timeout must be > 0 seconds, got "
            f"{cfg.straggler_timeout}")
    if cfg.inject_ring_fault is not None and (
            cfg.mesh is None or cfg.engine != "streaming"):
        raise ValueError(
            "inject_ring_fault poisons a sharded streaming ring stage; it "
            "needs mesh set and engine='streaming'")
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
    if cfg.a_dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"a_dtype={cfg.a_dtype}: kernels 1, 2 and 9 store and read A as "
            "float32 or bfloat16 (ROADMAP queue 2, kernel 1 follow-up)")
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
    segment_injector: Callable[[int], None] | None = None,
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

    ``segment_injector`` is the fault-injection hook of the resumable path:
    called with the sweep count at every segment boundary, it may raise (a
    GPICError is retried from the last snapshot). Passing it, or setting
    ``checkpoint_every`` or ``straggler_timeout``, runs the supervised
    segments, bitwise the monolithic run. On a group one rank's injector
    arms the supervisor on every rank, and what it raises is raised on
    every rank.
    """
    cfg = config or GPICConfig()
    if overrides:
        cfg = cfg.with_(**overrides)
    if cfg.mesh is not None and not isinstance(cfg.mesh, dist.ProcessGroup):
        raise TypeError(
            "GPICConfig.mesh takes a torch.distributed process group (or None for one "
            f"device), got {type(cfg.mesh).__name__}")
    shape = np.shape(x)
    n = shape[0] if shape else None
    if n is not None and cfg.mesh is not None:
        n *= dist.get_world_size(cfg.mesh)          # x is this rank's row block
    spec = check_config(cfg, n)
    dev = resolve_device(device, "run_gpic")
    x = as_f32(x, dev)
    x, notes = validate_features(
        x, k, sanitize=cfg.sanitize,
        reductions=None if cfg.mesh is None else mesh_reductions(cfg.mesh))
    inv = None
    if cfg.row_reorder:
        x_all, perm = _row_reorder_permutation(x, cfg, spec)
        inv = invert_permutation(perm)
        x = x_all[perm] if cfg.mesh is None else shard_points(x_all[perm], cfg.mesh)
        notes = tuple(notes) + ("row_reorder",)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    common = dict(generator=generator, eps=cfg.eps_scale / x.shape[0],
                  max_iter=cfg.max_iter, kmeans_iters=cfg.kmeans_iters, affinity=spec,
                  n_vectors=cfg.n_vectors, embedding=cfg.embedding,
                  qr_every=cfg.qr_every, residual_tol=cfg.residual_tol,
                  snapshot_iters=cfg.snapshot_iters)
    supervised = (cfg.checkpoint_every is not None or cfg.straggler_timeout is not None
                  or segment_injector is not None)
    injected = segment_injector is not None
    if cfg.mesh is not None:        # the ranks agree, or they would part into a hang
        supervised, injected = _on_any_rank((supervised, injected), cfg.mesh, dev)
    if supervised:
        res, sup_notes = _run_supervised(x.contiguous(), k, cfg, generator=generator,
                                         spec=spec, segment_injector=segment_injector,
                                         injected=injected)
        notes = tuple(notes) + sup_notes
    elif cfg.mesh is not None:
        res = _run_sharded_front(x.contiguous(), k, cfg, spec=spec, generator=generator)
    elif cfg.engine == "matrix_free":
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
    raise_for_health(res.health, res.labels.shape[0])
    return res


def _run_sharded_front(x_loc: torch.Tensor, k: int, cfg: GPICConfig, *, spec: AffinitySpec,
                       generator: torch.Generator) -> PICResult:
    """The unsupervised mesh route: this rank's block through the sharded
    entry point of the engine, on the device of ``x_loc``."""
    common = dict(group=cfg.mesh, device=x_loc.device, generator=generator,
                  eps_scale=cfg.eps_scale, max_iter=cfg.max_iter,
                  kmeans_iters=cfg.kmeans_iters, affinity=spec, n_vectors=cfg.n_vectors,
                  embedding=cfg.embedding, qr_every=cfg.qr_every,
                  snapshot_iters=cfg.snapshot_iters, residual_tol=cfg.residual_tol)
    if cfg.engine == "matrix_free":
        return distributed_gpic_matrix_free(x_loc, k, **common)
    return distributed_gpic(x_loc, k, engine=cfg.engine, a_dtype=cfg.a_dtype,
                            fold_shift=cfg.fold_shift, block_sparse=cfg.block_sparse,
                            overlap=cfg.overlap, probe_components=cfg.component_probe,
                            inject_ring_fault=cfg.inject_ring_fault, **common)


def _on_any_rank(flags, group, device) -> tuple[bool, ...]:
    """Each of ``flags`` ORed over the ranks of ``group``: one all-reduce."""
    t = torch.tensor([float(f) for f in flags], device=device)
    return tuple(bool(v) for v in mesh_reductions(group)[1](t).tolist())


def _row_reorder_permutation(x: torch.Tensor, cfg: GPICConfig, spec: AffinitySpec):
    """``(x_all, perm)``: the features of every row and the permutation of
    ``row_reorder``, content scores grouped by the probe's components for a
    truncated spec. One device: ``graph_reorder_permutation`` of ``x``. On a
    group ``x`` is this rank's block: the scores' column medians need every
    row, so the (n, m) features are gathered, and the components come from
    the sharded probe (``distributed_component_ids``). Neither the scores
    nor the probe's ids depend on a summation order, so the permutation is
    the one device's, exactly, on every rank."""
    if cfg.mesh is None:
        return x, graph_reorder_permutation(x, spec)
    x_all = mesh_reductions(cfg.mesh)[2](x)
    comp = None
    if spec.truncated:
        _, comp = distributed_component_ids(x, group=cfg.mesh, device=x.device, affinity=spec)
    return x_all, reorder_permutation(content_row_score(x_all), comp)


def _unpermute_result(res: PICResult, inv: torch.Tensor) -> PICResult:
    """Map every per-row output of a run on ``x[perm]`` back to the
    caller's row order: the labels, the column-0 embedding, the clustered
    block and the component ids. Indexing only, hence exact."""
    health = res.health
    if health is not None:
        health = replace(health, components=health.components[inv])
    return replace(res, labels=res.labels[inv], embedding=res.embedding[inv],
                   embeddings=res.embeddings[inv], health=health)


def _segment_plan(cfg: GPICConfig):
    """The loop arguments of the segmented engines, so that the segments'
    trajectory is the monolithic one: 'ensemble' is the classic 'pic' loop
    with its snapshot schedule (resolved as ``ensemble_power_iteration``
    resolves it), the other embeddings pass through. Returns (mode,
    qr_every, snapshot_iters, residual_tol)."""
    if cfg.embedding != "ensemble":
        return cfg.embedding, cfg.qr_every, (), cfg.residual_tol
    return "pic", 1, resolve_snapshot_iters(cfg.snapshot_iters, cfg.max_iter), None


def _run_supervised(x: torch.Tensor, k: int, cfg: GPICConfig, *, generator: torch.Generator,
                    spec: AffinitySpec, segment_injector, injected: bool):
    """The resumable supervisor, of one device or, with ``cfg.mesh``, of a
    process group.

    Runs the power loop in segments of ``checkpoint_every`` sweeps
    (``max_iter`` without snapshots) through the segmented entry points
    (core/gpic.py; on a group the sharded trio of core/distributed.py, each
    rank on its row block), snapshots the carry after each
    (``train/checkpoint.py``, written on a background thread), and retries
    a :class:`~repro_torch.core.health.GPICError` (an injected fault, a
    straggler timeout) from the newest valid snapshot, up to
    ``max_retries`` times with exponential backoff. A segment boundary
    moves only where the loop stops, so a resumed run is bitwise the
    uninterrupted one.

    On a group every branch comes from a collective, so the ranks never
    part into a hang. A snapshot is the global carry, the layout one device
    writes: every rank gathers the row leaves and rank 0 alone writes; rank
    0 alone restores, and each rank keeps its rows. ``injected`` says that
    some rank has an injector: then every rank calls its own at each
    boundary and all join one exchange, so what any rank's injector raises
    is raised on every rank. A segment's seconds are the slowest rank's.
    The stopping checks read the replicated ``t`` and ``done``. So every
    rank writes the same notes and returns the same result.

    The random stream: the monolithic run draws the extra start columns,
    then the k-means seeds, from one generator (seeded alike on every
    rank). Every attempt starts from the generator's state at entry; a
    fresh one draws the start columns, a resumed one draws them too and
    drops them, so k-means always draws from the state the uninterrupted
    run reaches.

    The port has no kernel fallback (a kernel that fails raises), so the
    reference's fallback resume has no counterpart here. Returns (result,
    notes): ``resumed:<sweep>``, ``retry:<n>:<ErrorClass>``,
    ``checkpoint_skipped:<dir>``, ``straggler:<sweep>:<sec>``.
    """
    from ..train import checkpoint as ckpt  # train imports core

    group, dev = cfg.mesh, x.device
    n = x.shape[0] * (1 if group is None else dist.get_world_size(group))
    writes = group is None or dist.get_rank(group) == 0
    mode, qr_every, si, residual_tol = _segment_plan(cfg)
    every = cfg.checkpoint_every or cfg.max_iter
    saver = ckpt.AsyncCheckpointer() if cfg.ckpt_dir is not None and writes else None
    notes: list[str] = []
    build = dict(affinity=spec, engine=cfg.engine, a_dtype=cfg.a_dtype,
                 block_sparse=cfg.block_sparse)
    loop = dict(mode=mode, qr_every=qr_every, snapshot_iters=si, residual_tol=residual_tol)
    if group is None:
        start_fn, step_fn, fin_fn = gpic_segment_start, gpic_segment, gpic_segment_finalize
        loop["eps"] = cfg.eps_scale / n
        ring, sharded = {}, {}
    else:
        start_fn, step_fn, fin_fn = (distributed_gpic_segment_start, distributed_gpic_segment,
                                     distributed_gpic_segment_finalize)
        build.update(group=group, device=dev, fold_shift=cfg.fold_shift, overlap=cfg.overlap)
        loop["eps_scale"] = cfg.eps_scale
        ring = dict(inject_ring_fault=cfg.inject_ring_fault)
        sharded = dict(group=group, row_leaves=CARRY_ROW_LEAVES)
    rng_state = generator.get_state()

    def attempt():
        generator.set_state(rng_state)
        carry = iso = None
        if cfg.ckpt_dir is not None:
            like = power_carry_like(n, cfg.n_vectors, len(si))
            carry, step, path, skipped = ckpt.restore_latest_valid(cfg.ckpt_dir, like,
                                                                   device=dev, **sharded)
            notes.extend(f"checkpoint_skipped:{os.path.basename(p)}" for p in skipped)
            if carry is not None:
                iso = ckpt.manifest_extra(path, group=group).get("isolated_rows", 0)
                notes.append(f"resumed:{step}")
                random_start_vectors(generator, n, cfg.n_vectors, device=dev)
        while True:
            t_now = 0
            if carry is not None:
                t_now = int(carry.t)
                if t_now >= cfg.max_iter or bool(carry.done.all()):
                    break
            if injected:
                _inject(segment_injector, t_now, group)
            stop = min(t_now + every, cfg.max_iter)
            t0 = time.monotonic()
            if carry is None:
                carry, iso = start_fn(x, stop, generator=generator, n_vectors=cfg.n_vectors,
                                      **build, **loop, **ring)
            else:
                carry = step_fn(x, carry, stop, **build, **loop, **ring)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            sec = time.monotonic() - t0
            if group is not None:
                sec = float(mesh_reductions(group)[1](
                    torch.tensor([sec], dtype=torch.float64, device=dev)))
            t_after = int(carry.t)
            if cfg.straggler_timeout is not None and sec > cfg.straggler_timeout:
                notes.append(f"straggler:{t_after}:{sec:.3f}")
                raise StragglerTimeout(
                    f"segment ending at sweep {t_after} took {sec:.3f}s "
                    f"(straggler_timeout={cfg.straggler_timeout}s); resuming from the "
                    "last snapshot")
            if cfg.ckpt_dir is not None:
                snap = carry if group is None else ckpt.gather_rows(carry, CARRY_ROW_LEAVES,
                                                                   group)
                if saver is not None:
                    saver.save_async(os.path.join(cfg.ckpt_dir, f"step_{t_after:06d}"), snap,
                                     step=t_after,
                                     extra={"isolated_rows": int(iso), "sweep": t_after})
        return fin_fn(x, carry, iso, k, generator=generator, kmeans_iters=cfg.kmeans_iters,
                      embedding=cfg.embedding, snapshot_iters=si,
                      probe_components=cfg.component_probe, **build)

    retries = 0
    try:
        while True:
            try:
                return attempt(), tuple(notes)
            except GPICError as e:
                if saver is not None:
                    saver.wait()     # land the pending snapshot before the restore
                if group is not None:
                    dist.barrier(group=group)
                retries += 1
                if retries > cfg.max_retries:
                    raise
                notes.append(f"retry:{retries}:{type(e).__name__}")
                if cfg.backoff:
                    time.sleep(cfg.backoff * 2 ** (retries - 1))
    finally:
        if saver is not None:
            saver.wait()


def _inject(injector, t_now: int, group) -> None:
    """Call this rank's segment injector (None: none here) at the boundary
    of sweep ``t_now``. On a group every rank joins one exchange of what its
    injector raised, and each raises the error of the lowest rank that had
    one: one rank's fault is every rank's, of the same class."""
    err = None
    try:
        if injector is not None:
            injector(t_now)
    except Exception as e:  # noqa: BLE001 - shared, then raised on every rank
        if group is None:
            raise
        err = e
    if group is None:
        return
    errs = [None] * dist.get_world_size(group)
    dist.all_gather_object(errs, err, group=group)
    first = next((e for e in errs if e is not None), None)
    if first is not None:
        raise first
