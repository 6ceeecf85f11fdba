"""PowerOperator builders: each GPIC engine as one binding of the loop.

The three local engines (matrix-free: the factorable specs only):

  explicit   build A and its degrees once with the fused affinity kernel,
             then one degree-normalized mat-mat kernel per sweep;
  streaming  never store A: one streamed degree kernel, then one streaming
             mat-mat kernel per sweep that rebuilds every tile from the
             features. Peak memory O(n m + n r).
  matrix_free  the factored product A V = f(X (X^T V)) - V of the cosine
             kinds (``core/affinity.py::matmat_matrix_free``): two skinny
             f32 matmuls a sweep, O(n m r) work, no A and no sweep kernel.

A spec with a graph policy first runs pass 1 (``core/graph.py``: the
streamed row top-k for the adaptive scales and the kNN thresholds), and
both engines then apply scale and mask in the tile. A truncated spec also
binds ``matmat_t``, the transpose product that the component probe walks
(the kNN graph is directed): ``A^T V`` on the stored A (explicit), or the
streaming kernel with the column thresholds (streaming, still A-free).

A truncated spec takes the block-sparse route by default
(``block_sparse=True``, as in the reference): the sweeps visit only the
live tiles of a block plan on the (16, 256) grid (``core/affinity.py``).
The explicit engine builds A in one pass (``core/graph.py::
fused_affinity_build``) and plans from the stored A; the streaming engine
runs pass 1, then the A-free liveness kernel, and takes its degrees and
sweeps from the block-sparse streaming kernels. Both give the dense route's
results bit for bit on the card. A grid of a single column tile (n <= 256)
has nothing to skip and keeps the dense route, as in the reference.

Every engine binds the Gram kernel for the block algebra of the orthogonal
mode.

The sharded engines (``core/distributed.py``) build the same operators on
one rank's row block of a ``torch.distributed`` process group: NCCL with
one card a rank, or gloo on CPU tensors. Their ``sum``/``max``/
``all_gather`` hooks are collectives (:func:`mesh_reductions`), and each
rank's stripe runs the single-device kernels at its row and column
offsets:

  sharded explicit     the (n/P, n) stripe of A against the gathered
                       features (#1, or the fused build on the block-sparse
                       route); V gathered each sweep, then #2 or #9
  sharded matrix-free  one all-reduce of an (m, r) block and one of an
                       (r,) vector a sweep
  sharded streaming    feature blocks rotate around the ring
                       (``dist.batch_isend_irecv``); stage s consumes the
                       block of rank (rank + s) % P with #5/#6/#7 (dense
                       grid) or #8/#10/#11 (a plan per stage), summed in
                       stage order. A-free and never gathering features.

The ring sums in another order than one device's row sums, so a sharded
sweep agrees with the single-device one to f32 noise, not bitwise.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..kernels import ops
from ..kernels.row_topk import row_topk_merge
from .affinity import (AffinityKind, AffinitySpec, as_affinity_spec, block_plan,
                       dense_block_live, matmat_matrix_free, row_normalize_features)
from .graph import adaptive_scales, affinity_stats, fused_affinity_build, scales_from_topk
from .power import PowerOperator


def uses_block_sparse(n: int, spec: AffinitySpec, block_sparse: bool) -> bool:
    """Whether a run of n points takes the block-sparse route: a truncated
    spec with ``block_sparse`` on more than one column tile."""
    return block_sparse and spec.truncated and n > ops.TN


def explicit_operator(inp: torch.Tensor, *, spec: AffinitySpec | None = None,
                      kind: AffinityKind = "cosine_shifted",
                      sigma: float = 1.0,
                      a_dtype: torch.dtype = torch.float32,
                      block_sparse: bool = True) -> PowerOperator:
    """Paper-faithful: build A once, stored in ``a_dtype`` (f32, or bf16:
    the reference's O4, half the memory and the sweep's bytes; D stays
    f32), then fused degree-normalized mat-mat sweeps, which widen each
    entry to f32 as they read it. ``inp`` is row-normalized features for
    the cosine kinds, raw features for rbf. On the block-sparse route A is
    built in one pass (the thresholds from its stored scores) and the
    sweeps read only its live tiles; the probe's transpose product is
    ``A^T v`` either way."""
    spec = as_affinity_spec(spec, kind=kind, sigma=sigma)
    inp = inp.contiguous()
    if uses_block_sparse(inp.shape[0], spec, block_sparse):
        scale = adaptive_scales(inp, spec)
        a, d, _ = fused_affinity_build(inp, spec=spec, scale_r=scale, scale_c=scale,
                                       a_dtype=a_dtype)
        counts, col_idx, _ = block_plan(dense_block_live(a, ops.PLAN_TM, ops.TN))

        def matmat(v):
            return ops.block_sparse_matmat(a, v.contiguous(), d, counts, col_idx)
    else:
        scale, thr = affinity_stats(inp, spec)
        a, d = ops.affinity_and_degree(inp, spec=spec, scale_r=scale, scale_c=scale, thr=thr,
                                       out_dtype=a_dtype)

        def matmat(v):
            return ops.degree_normalized_matmat(a, v.contiguous(), d)

    matmat_t = None
    if spec.truncated:
        def matmat_t(v):
            return transpose_matmat(a, v)

    return PowerOperator(matmat=matmat, degree=d, gram=ops.gram, matmat_t=matmat_t)


def transpose_matmat(a: torch.Tensor, v: torch.Tensor, *, stripe: int = 4096) -> torch.Tensor:
    """A^T V in f32 for a stored A: the component probe's transpose product,
    probe-frequency work (a few hundred products at most), plain torch as
    the reference leaves it to XLA. An f32 A takes one ``a.T @ v``; a bf16
    A is upcast ``stripe`` rows at a time (the sum of the stripes' A_s^T
    V_s), so the f32 temporary is one stripe (0.74 GB at n = 45,000), not
    a second A."""
    v = v.float()
    if a.dtype == torch.float32:
        return a.T @ v
    out = torch.zeros((a.shape[1], v.shape[1]), dtype=torch.float32, device=a.device)
    for r0 in range(0, a.shape[0], stripe):
        out += a[r0:r0 + stripe].float().T @ v[r0:r0 + stripe]
    return out


def streaming_operator(inp: torch.Tensor, *, spec: AffinitySpec | None = None,
                       kind: AffinityKind = "cosine_shifted",
                       sigma: float = 1.0,
                       block_sparse: bool = True) -> PowerOperator:
    """A-free: the degrees in one streamed pass, then every sweep rebuilds
    the affinity tiles from the feature rows (on the block-sparse route
    only the live ones, after one liveness pass). Same input convention as
    :func:`explicit_operator`; the same degrees and sweep outputs, bitwise,
    on the card. The probe's transpose product stays the dense-grid
    column-thresholded stream on either route, as in the reference."""
    spec = as_affinity_spec(spec, kind=kind, sigma=sigma)
    inp = inp.contiguous()
    scale, thr = affinity_stats(inp, spec)
    pol = dict(spec=spec, scale_r=scale, scale_c=scale, thr=thr)
    if uses_block_sparse(inp.shape[0], spec, block_sparse):
        counts, col_idx, _ = block_plan(ops.block_liveness(inp, **pol))
        d = ops.block_sparse_streaming_degree(inp, counts=counts, col_idx=col_idx, **pol)

        def matmat(v):
            return ops.block_sparse_streaming_matmat(inp, v.contiguous(), d, counts=counts,
                                                     col_idx=col_idx, **pol)
    else:
        d = ops.streaming_degree(inp, **pol)

        def matmat(v):
            return ops.streaming_matmat(inp, v.contiguous(), d, **pol)

    matmat_t = None
    if spec.truncated:
        def matmat_t(v):
            return ops.streaming_matmat(inp, v.contiguous(), None, spec=spec,
                                        scale_r=scale, scale_c=scale, thr_c=thr)

    return PowerOperator(matmat=matmat, degree=d, gram=ops.gram, matmat_t=matmat_t)


def matrix_free_operator(xn: torch.Tensor, *, spec: AffinitySpec | None = None,
                         kind: AffinityKind = "cosine_shifted") -> PowerOperator:
    """The factored sweep (A V) / max(d, 1e-30) with d = A 1, both from
    :func:`~repro_torch.core.affinity.matmat_matrix_free`: factorable specs
    only (the rejection lives there). ``xn`` must be row-normalized. The
    sweep is two plain f32 matmuls, as in the reference, which has no
    kernel for it; the Gram is the kernel's."""
    spec = as_affinity_spec(spec, kind=kind)
    n = xn.shape[0]
    d = matmat_matrix_free(xn, torch.ones((n,), dtype=xn.dtype, device=xn.device), spec)

    def matmat(v):
        return matmat_matrix_free(xn, v, spec) / torch.clamp_min(d, 1e-30)[:, None]

    return PowerOperator(matmat=matmat, degree=d, gram=ops.gram)


# ---------------------------------------------------------------------------
# Sharded operators: x_loc is this rank's (n/P, m) row block of the features
# ---------------------------------------------------------------------------

def group_layout(group=None) -> tuple[int, int]:
    """(rank, P): this process's rank in ``group`` (None: the default
    group) and the group's size."""
    return dist.get_rank(group), dist.get_world_size(group)


def mesh_reductions(group=None):
    """(sum, max, all_gather) as collectives over ``group``: an all-reduce
    of the sum, one of the maximum, and a gather of the ranks' (n_loc, ...)
    blocks into one (P n_loc, ...) tensor in rank order. The inputs are
    not changed. An all-reduce leaves the same bits on every rank, so the
    values the loop branches on agree across ranks."""
    def reduce(t, op):
        out = t.contiguous().clone()
        dist.all_reduce(out, op=op, group=group)
        return out

    def all_gather(t):
        t = t.contiguous()
        p = dist.get_world_size(group)
        out = torch.empty((p * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.all_gather(list(out.chunk(p)), t, group=group)
        return out

    return (lambda t: reduce(t, dist.ReduceOp.SUM), lambda t: reduce(t, dist.ReduceOp.MAX),
            all_gather)


def _exchange(sends, recvs, group):
    """Start one ring rotation: each tensor of ``sends`` goes to the
    previous rank while the matching tensor of ``recvs`` is filled from the
    next one. Returns the requests to wait on."""
    rank, p = group_layout(group)
    to, frm = (rank - 1) % p, (rank + 1) % p
    if group is not None:                   # P2POp takes global ranks
        to, frm = dist.get_global_rank(group, to), dist.get_global_rank(group, frm)
    p2p = []
    for snd, rcv in zip(sends, recvs):
        p2p += [dist.P2POp(dist.isend, snd, to, group),
                dist.P2POp(dist.irecv, rcv, frm, group)]
    return dist.batch_isend_irecv(p2p)


def _ring_sweep(payload, fold, acc0, *, n_stages: int, group=None, overlap: bool = True):
    """One ring sweep: ``n_stages`` stages over a rotating payload, a tuple
    of (n_loc, ...) tensors that travel together around the ranks;
    ``fold(s, acc, *payload) -> acc`` consumes stage s's blocks. The last
    stage is consumed in place: its blocks are never rotated.

    ``overlap=True``: double-buffered. Each rotated stage sends the whole
    payload to the previous rank and receives the next stage's into a
    second buffer BEFORE the fold consumes the current blocks, so the
    transfer runs while the stage's kernels do. Leaves of one type are
    packed into one (n_loc, sum of widths) tensor (a 1-D leaf as one
    column), so a stage is one send and one receive; concatenation and
    slicing move values exactly, so the folds see the same bits.

    ``overlap=False``: the sequential schedule. Fold stage s, then rotate
    each leaf with a send and receive of its own.

    Both schedules consume the same blocks at the same stages, so they
    give the same bits."""
    payload = tuple(t.contiguous() for t in payload)
    if not overlap:
        acc = acc0
        for s in range(n_stages):
            acc = fold(s, acc, *payload)
            if s < n_stages - 1:
                nxt = []
                for t in payload:
                    rcv = torch.empty_like(t)
                    for req in _exchange([t], [rcv], group):
                        req.wait()
                    nxt.append(rcv)
                payload = tuple(nxt)
        return acc
    packable = len(payload) > 1 and len({t.dtype for t in payload}) == 1
    if packable:
        parts = [t[:, None] if t.ndim == 1 else t.reshape(t.shape[0], -1) for t in payload]
        widths = [t.shape[1] for t in parts]
        cur = (torch.cat(parts, dim=1),)

        def unpack(bufs):
            out, off = [], 0
            for leaf, w in zip(payload, widths):
                out.append(bufs[0][:, off:off + w].reshape(leaf.shape).contiguous())
                off += w
            return out
    else:
        cur = payload

        def unpack(bufs):
            return list(bufs)
    # two receive buffers, alternating: the one a stage fills was sent (and
    # waited for) the stage before, and the caller's payload is never
    # written
    bufs = [tuple(torch.empty_like(t) for t in cur) for _ in range(min(n_stages - 1, 2))]
    acc = acc0
    for s in range(n_stages):
        nxt = bufs[s % 2] if s < n_stages - 1 else None
        reqs = _exchange(cur, nxt, group) if nxt is not None else []
        acc = fold(s, acc, *unpack(cur))
        for req in reqs:
            req.wait()
        cur = nxt
    return acc


def _stripe_matmat_t(a_loc, psum, row0):
    """The probe's A^T V on a stored (n_loc, n) stripe: each rank's
    transpose partial A_loc^T V_loc (``transpose_matmat``: a bf16 stripe is
    upcast 4,096 rows at a time), all-reduced into the full column sums,
    then this rank's rows sliced out. Probe-frequency work."""
    n_loc = a_loc.shape[0]

    def matmat_t(v_loc):
        return psum(transpose_matmat(a_loc, v_loc))[row0:row0 + n_loc]
    return matmat_t


def sharded_explicit_operator(x_loc: torch.Tensor, *, group=None,
                              spec: AffinitySpec | None = None,
                              kind: AffinityKind = "cosine_shifted", sigma: float = 1.0,
                              a_dtype: torch.dtype = torch.float32, fold_shift: bool = False,
                              block_sparse: bool = True) -> PowerOperator:
    """This rank's (n/P, n) stripe of A, built once against the gathered
    features at ``row_offset = rank * n/P``; each sweep gathers V (O(n r)
    bytes) and runs the stored sweep on the stripe. ``x_loc`` is raw
    features (row-normalized here for the cosine kinds).

    A spec with a graph policy runs pass 1 on the stripe: the adaptive
    scales from its row top-k (#7), gathered once for the column side; on
    the dense-storage route the kNN thresholds from #7 too. On the
    block-sparse route (a kNN spec, ``block_sparse``, n > 256) the stripe
    is built in one pass (``fused_affinity_build`` at the row offset: the
    whole row is there, so its thresholds are the single-device ones) and
    swept over its plan's live tiles with #9.

    ``fold_shift`` (the reference's O5, a dense fixed spec only) stores the
    stripe as raw ``cosine`` and folds the shift into an O(n_loc r)
    epilogue: (A V)_i = (sum V - v_i + (A_cos V)_i) / 2 with the sweep run
    with d = 1, and d_i = (n - 1 + d_cos,i) / 2.

    A truncated spec binds ``matmat_t`` (:func:`_stripe_matmat_t`) for the
    component probe."""
    spec = as_affinity_spec(spec, kind=kind, sigma=sigma)
    if fold_shift and not spec.dense_fixed:
        raise ValueError(
            "fold_shift (O5) rewrites the dense shift algebra; it cannot "
            f"be combined with adaptive/truncated specs (got {spec})")
    psum, pmax, gather = mesh_reductions(group)
    rank, _ = group_layout(group)
    n_loc = x_loc.shape[0]
    row0 = rank * n_loc
    if spec.kind != "rbf":
        x_loc = row_normalize_features(x_loc)
    x_loc = x_loc.contiguous()
    x_full = gather(x_loc)
    n = x_full.shape[0]
    hooks = dict(sum=psum, max=pmax, all_gather=gather, gram=ops.gram)

    scale_loc = scale_full = thr_loc = None
    if spec.adaptive:
        scale_loc = scales_from_topk(ops.row_topk(x_loc, x_full, k=spec.scale_k,
                                                  stat="neg_sqdist", spec=spec,
                                                  row_offset=row0))
        scale_full = gather(scale_loc)

    if uses_block_sparse(n, spec, block_sparse):
        a_loc, d_loc, _ = fused_affinity_build(x_loc, x_full, spec=spec, scale_r=scale_loc,
                                               scale_c=scale_full, row_offset=row0,
                                               a_dtype=a_dtype)
        counts, col_idx, _ = block_plan(dense_block_live(a_loc, ops.PLAN_TM, ops.TN))

        def matmat(v_loc):
            return ops.block_sparse_matmat(a_loc, gather(v_loc), d_loc, counts, col_idx)

        return PowerOperator(matmat=matmat, degree=d_loc,
                             matmat_t=_stripe_matmat_t(a_loc, psum, row0), **hooks)

    if spec.truncated:
        thr_loc = ops.row_topk(x_loc, x_full, k=spec.knn_k, stat="similarity", spec=spec,
                               scale_r=scale_loc, scale_c=scale_full,
                               row_offset=row0)[:, -1].contiguous()
    fold = fold_shift and spec.kind == "cosine_shifted"
    a_loc, d_raw = ops.affinity_and_degree(
        x_loc, x_full, kind="cosine" if fold else spec.kind, sigma=float(spec.sigma),
        scale_r=scale_loc, scale_c=scale_full, thr=thr_loc, row_offset=row0,
        out_dtype=a_dtype)
    if fold:
        d_loc = 0.5 * (n - 1.0 + d_raw)
        ones = torch.ones((n_loc,), dtype=torch.float32, device=x_loc.device)

        def matmat(v_loc):
            v_full = gather(v_loc)
            raw = ops.degree_normalized_matmat(a_loc, v_full, ones)   # A_cos V, d = 1
            av = 0.5 * (torch.sum(v_full, dim=0)[None, :] + raw - v_loc)
            return av / torch.clamp_min(d_loc, 1e-30)[:, None]
    else:
        d_loc = d_raw

        def matmat(v_loc):
            return ops.degree_normalized_matmat(a_loc, gather(v_loc), d_loc)

    return PowerOperator(matmat=matmat, degree=d_loc,
                         matmat_t=(_stripe_matmat_t(a_loc, psum, row0)
                                   if spec.truncated else None), **hooks)


def sharded_matrix_free_operator(x_loc: torch.Tensor, *, group=None,
                                 spec: AffinitySpec | None = None,
                                 kind: AffinityKind = "cosine_shifted") -> PowerOperator:
    """The factored product on this rank's rows: a sweep all-reduces one
    (m, r) block and one (r,) vector, nothing of size n. Factorable specs
    only (the rejection lives in ``matmat_matrix_free``)."""
    spec = as_affinity_spec(spec, kind=kind)
    psum, pmax, gather = mesh_reductions(group)
    xn_loc = row_normalize_features(x_loc)
    ones = torch.ones((xn_loc.shape[0],), dtype=xn_loc.dtype, device=xn_loc.device)
    d_loc = matmat_matrix_free(xn_loc, ones, spec, psum=psum)

    def matmat(v_loc):
        av = matmat_matrix_free(xn_loc, v_loc, spec, psum=psum)
        return av / torch.clamp_min(d_loc, 1e-30)[:, None]

    return PowerOperator(matmat=matmat, degree=d_loc, sum=psum, max=pmax, all_gather=gather,
                         gram=ops.gram)


def sharded_streaming_operator(x_loc: torch.Tensor, *, group=None,
                               spec: AffinitySpec | None = None,
                               kind: AffinityKind = "cosine_shifted", sigma: float = 1.0,
                               block_sparse: bool = True, overlap: bool = True,
                               inject_fault: tuple | None = None) -> PowerOperator:
    """The A-free ring: no rank stores A or gathers the features. Every
    sweep rotates the (n/P, m) feature blocks (with the V blocks) around
    the ranks; stage s consumes the block of rank (rank + s) % P, whose
    columns start at ``col0(s)``, with the streamed kernels at (row0,
    col0(s)), and the stage partials are summed in stage order from the
    rank's own block. Peak memory O(n m / P + n r / P) a rank.

    Pass 1 rings: the row top-k partials (#7) of each stage merged with
    ``row_topk_merge`` (an exact selection, so the statistics are the
    single-device ones); the adaptive scales are gathered once for the
    column side. Dense grid: the degree ring runs #6, the sweep ring #5
    with d=None, divided by max(d, 1e-30) after the last stage.
    Block-sparse route (a kNN spec, ``block_sparse``, n/P > 256, the
    stage's own column count): a liveness ring (#8) plans each stage on
    the (16, 256) grid, then the degree ring runs #11 and the sweep ring
    #10 over each stage's live tiles.

    A truncated spec binds ``matmat_t``: a ring rotating (features, V,
    thr) together, each stage #5 with the arriving block's row thresholds
    on the column side (``thr_c``), so the partials sum to this rank's
    rows of A^T V.

    ``overlap`` picks the ring's schedule (:func:`_ring_sweep`), with the
    same bits either way. ``inject_fault=('ring_nan', s)`` poisons the V
    block consumed at stage s of every sweep with NaN (the rotating copy
    stays clean): a transient corruption that the loop's COL_NONFINITE
    latch must catch."""
    psum, pmax, gather = mesh_reductions(group)
    rank, p = group_layout(group)
    if inject_fault is not None and (
            len(inject_fault) != 2 or inject_fault[0] != "ring_nan"
            or not 0 <= int(inject_fault[1]) < p):
        raise ValueError(
            f"inject_fault must be ('ring_nan', stage<{p}), got {inject_fault!r}")
    spec = as_affinity_spec(spec, kind=kind, sigma=sigma)
    n_loc = x_loc.shape[0]
    row0 = rank * n_loc
    if spec.kind != "rbf":
        x_loc = row_normalize_features(x_loc)
    x_loc = x_loc.contiguous()
    dev = x_loc.device

    def col0(s):
        return ((rank + s) % p) * n_loc

    def sweep(payload, fold, acc0):
        return _ring_sweep(payload, fold, acc0, n_stages=p, group=group, overlap=overlap)

    scale_loc = scale_full = thr_loc = None

    def pol(s):
        """The stage's policy operands: this rank's row scales and the
        column block's, and the row thresholds."""
        if scale_full is None:
            return dict(spec=spec, thr=thr_loc)
        return dict(spec=spec, scale_r=scale_loc, thr=thr_loc,
                    scale_c=scale_full[col0(s):col0(s) + n_loc])

    def topk_ring(k, stat):
        def fold(s, buf, x_ring):
            kw = pol(s)
            kw.pop("thr")
            part = ops.row_topk(x_loc, x_ring, k=k, stat=stat, row_offset=row0,
                                col_offset=col0(s), **kw)
            return row_topk_merge(buf, part, k)
        return sweep((x_loc,), fold, torch.full((n_loc, k), -torch.inf, device=dev))

    if spec.adaptive:
        scale_loc = scales_from_topk(topk_ring(spec.scale_k, "neg_sqdist"))
        scale_full = gather(scale_loc)
    if spec.truncated:
        thr_loc = topk_ring(spec.knn_k, "similarity")[:, -1].contiguous()

    def poisoned(s, v_ring):
        if inject_fault is not None and s == int(inject_fault[1]):
            return torch.full_like(v_ring, float("nan"))
        return v_ring

    matmat_t = None
    if spec.truncated:
        def matmat_t(v_loc):
            def fold(s, u, x_ring, v_ring, thr_ring):
                kw = pol(s)
                kw.pop("thr")
                return u + ops.streaming_matmat(x_loc, v_ring, None, x_ring, thr_c=thr_ring,
                                                row_offset=row0, col_offset=col0(s), **kw)
            u0 = torch.zeros((n_loc, v_loc.shape[1]), device=dev)
            return sweep((x_loc, v_loc.float(), thr_loc), fold, u0)

    if uses_block_sparse(n_loc, spec, block_sparse):
        plans = [None] * p

        def live_fold(s, acc, x_ring):
            live = ops.block_liveness(x_loc, x_ring, row_offset=row0, col_offset=col0(s),
                                      **pol(s))
            plans[s] = block_plan(live)[:2]
            return acc
        sweep((x_loc,), live_fold, None)

        def deg_fold(s, d, x_ring):
            counts, col_idx = plans[s]
            return d + ops.block_sparse_streaming_degree(
                x_loc, x_ring, counts=counts, col_idx=col_idx, row_offset=row0,
                col_offset=col0(s), **pol(s))

        def partial(s, x_ring, v_ring):
            counts, col_idx = plans[s]
            return ops.block_sparse_streaming_matmat(
                x_loc, poisoned(s, v_ring), None, x_ring, counts=counts, col_idx=col_idx,
                row_offset=row0, col_offset=col0(s), **pol(s))
    else:
        def deg_fold(s, d, x_ring):
            return d + ops.streaming_degree(x_loc, x_ring, row_offset=row0,
                                            col_offset=col0(s), **pol(s))

        def partial(s, x_ring, v_ring):
            return ops.streaming_matmat(x_loc, poisoned(s, v_ring), None, x_ring,
                                        row_offset=row0, col_offset=col0(s), **pol(s))

    d_loc = sweep((x_loc,), deg_fold, torch.zeros((n_loc,), device=dev))

    def matmat(v_loc):
        u0 = torch.zeros((n_loc, v_loc.shape[1]), device=dev)
        u = sweep((x_loc, v_loc.float()),
                  lambda s, u, x_ring, v_ring: u + partial(s, x_ring, v_ring), u0)
        return u / torch.clamp_min(d_loc, 1e-30)[:, None]

    return PowerOperator(matmat=matmat, degree=d_loc, sum=psum, max=pmax, all_gather=gather,
                         gram=ops.gram, matmat_t=matmat_t)
