"""Multi-GPU GPIC on ``torch.distributed``: the reference's sharded engines.

Each rank holds one (n/P, m) row block of the features and calls the entry
points below with it and the process group (None: the default group). NCCL
runs one card a rank (``torch.cuda.set_device(local_rank)`` first); gloo
runs on CPU tensors, which is how the tests run it. A group whose backend
does not match the run's device raises: nothing is staged through host
copies.

There is no distributed power loop here. Every path builds a sharded
:class:`~repro_torch.core.power.PowerOperator` (``core/operators.py``)
whose ``sum``/``max``/``all_gather`` are collectives and whose sweeps run
the single-device kernels on the rank's stripe, and hands it to the one
loop of ``core/power.py``:

  explicit      the (n/P, n) stripe of A (#1, or the fused build and #9
                on the block-sparse route); V gathered each sweep;
                ``a_dtype=torch.bfloat16`` and ``fold_shift`` (O5) as in
                the reference
  streaming     A-free ring: feature blocks rotate between ranks, stage
                kernels #5-#8, #10, #11 at the stage's column offset
  matrix_free   one all-reduce of an (m, r) block and one of an (r,)
                vector a sweep

Every value the loop, the probe or the front door branches on comes out of
a collective, so all ranks take the same branches. The k-means runs on the
gathered embedding on every rank with the same draws (a
``torch.Generator`` seeded alike on every rank, or the caller's ``u0t`` and
``kmeans_init``), so every rank returns the same :class:`PICResult`.

The segmented entry points cut the loop into bounded pieces over a
:class:`~repro_torch.core.power.PowerCarry` whose (n/P, r) leaves stay on
their ranks; each call rebuilds the operator from the features, and the
pieces make the monolithic run's sweeps bit for bit; ``run_gpic``'s
supervisor (``core/pipeline.py``) snapshots, resumes and retries them on a
group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .affinity import AffinityKind, AffinitySpec, as_affinity_spec
from .health import HealthReport, as_f32, count_bad_rows, graph_component_probe, resolve_device
from .kmeans import kmeans
from .operators import (
    group_layout,
    mesh_reductions,
    sharded_explicit_operator,
    sharded_matrix_free_operator,
    sharded_streaming_operator,
)
from .pic import PICResult, make_pic_result
from .power import (
    PowerCarry,
    backfill_snapshots,
    ensemble_embedding,
    finalize_power_carry,
    init_power_carry,
    init_power_vectors_local,
    power_iteration_segment,
    random_start_vectors,
    run_power_embedding,
    standardize_columns,
)

#: the device type each backend's tensors live on
BACKEND_DEVICE = {"nccl": "cuda", "gloo": "cpu"}


def check_backend(group, device: torch.device) -> None:
    """Raise unless ``group``'s backend carries tensors of ``device``'s
    type: NCCL CUDA tensors, gloo CPU tensors."""
    backend = str(dist.get_backend(group))
    want = BACKEND_DEVICE.get(backend)
    if want != device.type:
        raise ValueError(
            f"a {backend!r} process group carries "
            f"{want + ' tensors' if want else 'no tensors the port runs on'}, and the run "
            f"is on {device}: use NCCL with one CUDA card a rank, or gloo with "
            "device='cpu' (nothing is staged through host copies)")


def _prepare(x_loc, group, device, entry: str):
    """(x_loc as contiguous f32 on the device, device, n): the rank's block
    on the run's device after the backend check; n counts every rank's
    rows (the blocks are equal, as ``shard_points`` makes them)."""
    dev = resolve_device(device, entry)
    check_backend(group, dev)
    x_loc = as_f32(x_loc, dev).contiguous()
    return x_loc, dev, x_loc.shape[0] * group_layout(group)[1]


def _generator(generator, dev: torch.device) -> torch.Generator:
    """The run's generator: the caller's, or one seeded with 0, the same on
    every rank (the k-means draws must agree across ranks)."""
    return generator if generator is not None else torch.Generator(device=dev).manual_seed(0)


def _start_columns(u0t, generator, n: int, n_vectors: int, dev) -> torch.Tensor:
    """The replicated (n, r-1) random start columns: the caller's ``u0t``
    (the reference's draws, for comparisons) or ``random_start_vectors``
    drawn from ``generator`` as the single-device ``gpic`` draws them."""
    if u0t is None:
        return random_start_vectors(generator, n, n_vectors, device=dev)
    u0t = as_f32(u0t, dev)
    if tuple(u0t.shape) != (n, n_vectors - 1):
        raise ValueError(f"u0t must be ({n}, {n_vectors - 1}) for n_vectors={n_vectors}, "
                         f"got {tuple(u0t.shape)}")
    return u0t


def _local_rows(t: torch.Tensor, n_loc: int, group) -> torch.Tensor:
    """This rank's (n_loc, ...) rows of a replicated (n, ...) tensor."""
    rank = group_layout(group)[0]
    return t[rank * n_loc:(rank + 1) * n_loc]


def _build_sharded_operator(x_loc, group, engine: str, spec: AffinitySpec, *,
                            a_dtype=torch.float32, fold_shift=False, block_sparse=True,
                            overlap=True, inject_ring_fault=None):
    """The one sharded operator construction, shared by the monolithic and
    the segmented entry points. ``overlap`` picks the streaming ring's
    schedule; the explicit and matrix-free engines have no ring and ignore
    it (as they ignore ``block_sparse`` on dense specs)."""
    if engine == "explicit":
        return sharded_explicit_operator(x_loc, group=group, spec=spec, a_dtype=a_dtype,
                                         fold_shift=fold_shift, block_sparse=block_sparse)
    if engine == "streaming":
        return sharded_streaming_operator(x_loc, group=group, spec=spec,
                                          block_sparse=block_sparse, overlap=overlap,
                                          inject_fault=inject_ring_fault)
    if engine == "matrix_free":
        return sharded_matrix_free_operator(x_loc, group=group, spec=spec)
    raise ValueError(f"unknown engine {engine!r} (expected 'explicit' or 'streaming')")


def _sharded_components(op, n: int, group, device, max_components: int = 8):
    """(n_components, (n,) component ids) of the probe on a sharded
    operator, gathered; -1 and -1s where it does not run (``op`` None)."""
    if op is None:
        return (torch.tensor(-1, dtype=torch.int32, device=device),
                torch.full((n,), -1, dtype=torch.int32, device=device))
    n_loc = op.degree.shape[0]
    n_comp, comp_loc = graph_component_probe(op, n, row_offset=group_layout(group)[0] * n_loc,
                                             max_components=max_components)
    return n_comp, op.all_gather(comp_loc)


def _finish(emb_loc, v_loc, t_cols, done, status, iso, k, *, gather, generator, kmeans_init,
            kmeans_iters, embedding, components) -> PICResult:
    """The tail every sharded entry shares: gather the embedding once,
    standardize it and run the replicated k-means."""
    emb_full = gather(emb_loc)
    v_full = emb_full if emb_loc is v_loc else gather(v_loc)
    labels, _ = kmeans(standardize_columns(emb_full), k, iters=kmeans_iters,
                       generator=generator, init=kmeans_init)
    n_comp, comp = components
    health = HealthReport(col_status=status, isolated_rows=iso, n_components=n_comp,
                          components=comp)
    return make_pic_result(labels, v_full, t_cols, done, embedding=embedding,
                           embeddings=emb_full, health=health)


def _run_sharded(op, group, *, generator, u0t, kmeans_init, k, eps, max_iter, kmeans_iters,
                 n, n_vectors, embedding="pic", qr_every=1, snapshot_iters=None,
                 residual_tol=None, probe=False) -> PICResult:
    """Seed this rank's rows of the start state from the operator's degrees
    (normalized by the global mass) and of the replicated random starts,
    run the one loop, then gather once and cluster the replicated
    embedding. The health arrays finish through the operator's
    reductions, so every rank reports the same diagnostics."""
    n_loc = op.degree.shape[0]
    u0t = _start_columns(u0t, generator, n, n_vectors, op.degree.device)
    v0_loc = init_power_vectors_local(op.degree, _local_rows(u0t, n_loc, group), sum_fn=op.sum)
    v_loc, t_cols, done, emb_loc, status = run_power_embedding(
        op, v0_loc, eps, max_iter, embedding=embedding, qr_every=qr_every,
        snapshot_iters=snapshot_iters, residual_tol=residual_tol)
    return _finish(emb_loc, v_loc, t_cols, done, status, count_bad_rows(op.degree, op.sum), k,
                   gather=op.all_gather, generator=generator, kmeans_init=kmeans_init,
                   kmeans_iters=kmeans_iters, embedding=embedding,
                   components=_sharded_components(op if probe else None, n, group,
                                                  op.degree.device))


def distributed_gpic(
    x_loc,
    k: int,
    *,
    group=None,
    device=None,
    generator: torch.Generator | None = None,
    u0t=None,
    kmeans_init=None,
    eps_scale: float = 1e-5,
    max_iter: int = 50,
    kmeans_iters: int = 25,
    affinity_kind: AffinityKind = "cosine_shifted",
    sigma: float = 1.0,
    affinity: AffinitySpec | None = None,
    a_dtype: torch.dtype = torch.float32,
    fold_shift: bool = False,
    n_vectors: int = 1,
    engine: str = "explicit",
    embedding: str = "pic",
    qr_every: int = 1,
    snapshot_iters: tuple | None = None,
    residual_tol: float | None = None,
    probe_components: bool = True,
    block_sparse: bool = True,
    overlap: bool = True,
    inject_ring_fault: tuple | None = None,
) -> PICResult:
    """Sharded GPIC: this rank's (n/P, m) row block ``x_loc`` in, the whole
    run's result out, the same on every rank of ``group``.

    ``engine='explicit'`` stores the rank's (n/P, n) stripe of A (``a_dtype``
    f32 or bf16; ``fold_shift``, the reference's O5, stores raw cosine for
    a dense ``cosine_shifted`` spec); ``engine='streaming'`` is the A-free
    ring (``overlap`` picks its schedule, with the same bits either way;
    ``inject_ring_fault=('ring_nan', s)`` poisons the V block consumed at
    stage s). The other arguments are :func:`~repro_torch.core.gpic.gpic`'s.

    ``device`` is the run's device (None: the CUDA card); the group's
    backend must carry it. ``generator`` (None: seeded with 0) draws the
    extra start columns and then the k-means seeds, as ``gpic`` draws
    them, and must be seeded alike on every rank. ``u0t`` ((n, r-1)) and
    ``kmeans_init`` ((k, c) centroids) replace those draws, so a run can
    take the reference's."""
    x_loc, dev, n = _prepare(x_loc, group, device, "distributed_gpic")
    spec = as_affinity_spec(affinity, kind=affinity_kind, sigma=sigma)
    spec.validate_for_n(n)
    if inject_ring_fault is not None and engine != "streaming":
        raise ValueError(
            "inject_ring_fault targets the streaming ring; "
            f"engine={engine!r} has no ring stages")
    if engine not in ("explicit", "streaming"):
        raise ValueError(f"unknown engine {engine!r} (expected 'explicit' or 'streaming')")
    op = _build_sharded_operator(x_loc, group, engine, spec, a_dtype=a_dtype,
                                 fold_shift=fold_shift, block_sparse=block_sparse,
                                 overlap=overlap, inject_ring_fault=inject_ring_fault)
    return _run_sharded(op, group, generator=_generator(generator, dev), u0t=u0t,
                        kmeans_init=kmeans_init, k=k, eps=eps_scale / n, max_iter=max_iter,
                        kmeans_iters=kmeans_iters, n=n, n_vectors=n_vectors,
                        embedding=embedding, qr_every=qr_every,
                        snapshot_iters=snapshot_iters, residual_tol=residual_tol,
                        probe=probe_components and spec.truncated)


def distributed_gpic_matrix_free(
    x_loc,
    k: int,
    *,
    group=None,
    device=None,
    generator: torch.Generator | None = None,
    u0t=None,
    kmeans_init=None,
    eps_scale: float = 1e-5,
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
    """Matrix-free sharded GPIC (O2): an all-reduce of an (m, r) block and
    one of an (r,) vector a sweep. Factorable specs only (cosine kinds, no
    scaling or truncation). Arguments as :func:`distributed_gpic`."""
    x_loc, dev, n = _prepare(x_loc, group, device, "distributed_gpic_matrix_free")
    spec = as_affinity_spec(affinity, kind=affinity_kind)
    if not spec.factorable:
        raise ValueError(f"matrix-free path needs a factorable affinity spec, got {spec}")
    op = _build_sharded_operator(x_loc, group, "matrix_free", spec)
    # a factorable spec is never truncated: the probe cannot arm
    return _run_sharded(op, group, generator=_generator(generator, dev), u0t=u0t,
                        kmeans_init=kmeans_init, k=k, eps=eps_scale / n, max_iter=max_iter,
                        kmeans_iters=kmeans_iters, n=n, n_vectors=n_vectors,
                        embedding=embedding, qr_every=qr_every,
                        snapshot_iters=snapshot_iters, residual_tol=residual_tol)


# ---------------------------------------------------------------------------
# Segmented execution: the sharded engines in bounded pieces
# ---------------------------------------------------------------------------

#: the fields of a sharded PowerCarry held by rows, (n/P, ...) on each rank;
#: the others (t, done, t_cols, status, best, since) are replicated. A
#: snapshot gathers these (train/checkpoint.py), so it is the global carry.
CARRY_ROW_LEAVES = ("v", "delta", "snaps")

def distributed_gpic_segment_start(
    x_loc, stop: int, *, group=None, device=None, generator: torch.Generator | None = None,
    u0t=None, eps_scale: float = 1e-5, engine: str = "explicit", affinity: AffinitySpec,
    a_dtype: torch.dtype = torch.float32, fold_shift: bool = False, block_sparse: bool = True,
    overlap: bool = True, n_vectors: int = 1, mode: str = "pic", qr_every: int = 1,
    snapshot_iters: tuple = (), residual_tol: float | None = None,
    inject_ring_fault: tuple | None = None) -> tuple[PowerCarry, torch.Tensor]:
    """Seed the sweep-0 carry as the monolithic run seeds it (this rank's
    rows of the replicated random starts, the degree column normalized by
    the global mass) and run the first segment to ``stop`` sweeps.
    ``generator`` draws the start columns as :func:`distributed_gpic` does
    (pass the same one to the finalize for the k-means draws). Returns
    ``(carry, isolated_rows)``: the carry's (n/P, r) leaves are this
    rank's, its per-column stats replicated."""
    x_loc, dev, n = _prepare(x_loc, group, device, "distributed_gpic_segment_start")
    op = _build_sharded_operator(x_loc, group, engine, affinity, a_dtype=a_dtype,
                                 fold_shift=fold_shift, block_sparse=block_sparse,
                                 overlap=overlap, inject_ring_fault=inject_ring_fault)
    u0t = _start_columns(u0t, _generator(generator, dev), n, n_vectors, dev)
    v0_loc = init_power_vectors_local(op.degree, _local_rows(u0t, x_loc.shape[0], group),
                                      sum_fn=op.sum)
    carry = power_iteration_segment(
        op, init_power_carry(v0_loc, len(snapshot_iters)), eps_scale / n, stop, mode=mode,
        qr_every=qr_every, snapshot_iters=snapshot_iters, residual_tol=residual_tol)
    return carry, count_bad_rows(op.degree, op.sum)


def distributed_gpic_segment(
    x_loc, carry: PowerCarry, stop: int, *, group=None, device=None,
    eps_scale: float = 1e-5, engine: str = "explicit", affinity: AffinitySpec,
    a_dtype: torch.dtype = torch.float32, fold_shift: bool = False, block_sparse: bool = True,
    overlap: bool = True, mode: str = "pic", qr_every: int = 1, snapshot_iters: tuple = (),
    residual_tol: float | None = None, inject_ring_fault: tuple | None = None) -> PowerCarry:
    """Advance a carry (from the previous segment, or restored) to ``stop``
    sweeps on an operator rebuilt from this rank's features."""
    x_loc, _, n = _prepare(x_loc, group, device, "distributed_gpic_segment")
    op = _build_sharded_operator(x_loc, group, engine, affinity, a_dtype=a_dtype,
                                 fold_shift=fold_shift, block_sparse=block_sparse,
                                 overlap=overlap, inject_ring_fault=inject_ring_fault)
    return power_iteration_segment(op, carry, eps_scale / n, stop, mode=mode,
                                   qr_every=qr_every, snapshot_iters=snapshot_iters,
                                   residual_tol=residual_tol)


def distributed_gpic_segment_finalize(
    x_loc, carry: PowerCarry, isolated_rows, k: int, *, group=None, device=None,
    generator: torch.Generator | None = None, kmeans_init=None, kmeans_iters: int = 25,
    engine: str = "explicit", affinity: AffinitySpec, a_dtype: torch.dtype = torch.float32,
    fold_shift: bool = False, block_sparse: bool = True, overlap: bool = True,
    embedding: str = "pic", snapshot_iters: tuple = (),
    probe_components: bool = True) -> PICResult:
    """Close a finished sharded carry into the monolithic run's result:
    COL_MAXITER, the ensemble's backfill, one gather, the replicated
    k-means, and the component probe on a rebuilt operator when it
    arms."""
    x_loc, dev, n = _prepare(x_loc, group, device, "distributed_gpic_segment_finalize")
    _, _, gather = mesh_reductions(group)
    t, v_loc, t_cols, done, snaps_loc, status = finalize_power_carry(carry)
    emb_loc = v_loc
    if embedding == "ensemble":
        emb_loc = ensemble_embedding(backfill_snapshots(snaps_loc, v_loc, t, snapshot_iters))
    op = (_build_sharded_operator(x_loc, group, engine, affinity, a_dtype=a_dtype,
                                  fold_shift=fold_shift, block_sparse=block_sparse,
                                  overlap=overlap)
          if probe_components and affinity.truncated else None)
    components = _sharded_components(op, n, group, dev)
    iso = torch.as_tensor(isolated_rows, dtype=torch.int32, device=dev)
    return _finish(emb_loc, v_loc, t_cols, done, status, iso, k, gather=gather,
                   generator=_generator(generator, dev), kmeans_init=kmeans_init,
                   kmeans_iters=kmeans_iters, embedding=embedding, components=components)


def distributed_component_ids(x_loc, *, group=None, device=None, affinity: AffinitySpec,
                              max_components: int = 16):
    """Replicated (n_components, (n,) ids) of the truncated affinity graph:
    the component probe on the dense-grid streaming ring (the block plan
    is what the row reorder exists for, so the probe must not depend on
    it). Ids in the probe's seeding order, -1 for rows never reached."""
    x_loc, _, n = _prepare(x_loc, group, device, "distributed_component_ids")
    op = _build_sharded_operator(x_loc, group, "streaming", affinity, block_sparse=False)
    return _sharded_components(op, n, group, op.degree.device, max_components=max_components)


def shard_points(x, group=None):
    """This rank's row block of the (n, m) features ``x`` (a numpy array or
    a tensor, sliced as given): rows rank * n/P to (rank + 1) * n/P. n must
    divide evenly over the group's P ranks (the ring needs equal blocks);
    trim or pad the input first."""
    rank, p = group_layout(group)
    n = x.shape[0]
    if n % p:
        raise ValueError(
            f"shard_points: n={n} rows do not divide evenly over {p} devices of the "
            "process group; pad or trim the input first")
    n_loc = n // p
    return x[rank * n_loc:(rank + 1) * n_loc]
