"""Batched truncated power iteration: the multi-vector engine core.

One ``(n, r)`` state matrix replaces r independent loops: every iteration
performs ONE degree-normalized mat-mat (one sweep of A), however the
operator realizes it, so the per-iteration memory traffic does not depend
on the number of power vectors.

The engine is parameterized by a :class:`PowerOperator`: ``matmat``
performs the sweep and ``gram`` the V^T V products of the block algebra.
Its ``sum``/``max``/``all_gather`` hooks finish the loop's global
quantities (the column l1, the acceleration, the Grams): the identity on
one device, collectives over a process group on the sharded engines
(``core/operators.py::mesh_reductions``), where V is each rank's (n_loc, r)
row block. Every value the loop branches on comes out of those hooks, so
all ranks take the same branches.

Three embedding modes share the one loop:

  mode='pic'         the paper's per-vector Algorithm 1/2 loop: each column
                     carries its own delta and acceleration-based stopping
                     flag, and a converged column is frozen while the
                     others keep iterating.
  mode='orthogonal'  block iteration: column 0 keeps the classic pinned
                     trajectory, columns 1..r-1 are Cholesky-QR
                     re-orthonormalized against it every ``qr_every``
                     sweeps. Only column 0 freezes; the block columns'
                     done flags latch their first eps-crossing.
  ensemble           :func:`ensemble_power_iteration` snapshots the classic
                     block at a few diffusion times and stacks them.

The reference's ``while_loop`` is a Python loop here that reads
``done.all()`` on the host once per sweep; its ``lax.cond`` on the QR
cadence is a Python ``if`` on the sweep count.

The loop's whole state is a :class:`PowerCarry`. One loop body advances it
(:func:`power_iteration_segment`, up to a stop sweep), so a run cut into
segments, with the carry saved and restored between them, makes the
uninterrupted run's sweeps bit for bit: the resumable supervisor
(``core/pipeline.py``) rests on that.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import torch

from .health import COL_MAXITER, COL_NONFINITE, COL_STALLED, COL_ZERO

EMBEDDINGS = ("pic", "orthogonal", "ensemble")

#: sweeps without a strict improvement of a column's acceleration statistic
#: before COL_STALLED latches — diagnostic only, never alters the iteration
STALL_PATIENCE = 10


def _identity(x):
    return x


def _gram_plain(v):
    """V^T V in f32: the default binding; the operator builders bind the
    Gram kernel (``kernels.ops.gram``)."""
    v32 = v.float()
    return v32.T @ v32


@dataclass(frozen=True)
class PowerOperator:
    """One degree-normalized sweep of A, and the reductions that finish it.

    Attributes:
      matmat: maps the local (n_loc, r) block of V to that block of
        (A V) / d (n_loc = n on one device).
      degree: the local (n_loc,) degree backing the sweep (v0 seed and
        diagnostics; None for a bare callable).
      sum: finishes a sum over the ranks of an already locally reduced
        value (identity on one device; an all-reduce when sharded).
      max: the same for a maximum.
      all_gather: maps a local (n_loc, ...) block to the global (n, ...)
        tensor, the ranks' blocks in rank order (identity on one device).
      gram: maps a local (n_loc, c) block to its local (c, c) Gram V^T V
        (the re-orthonormalization and the subspace residual); ``sum``
        finishes it.
      matmat_t: maps the local block of V to the local block of the
        unnormalized A^T V, for the component probe of a directed
        (kNN-truncated) graph; None where A is symmetric.
    """
    matmat: Callable[[torch.Tensor], torch.Tensor]
    degree: torch.Tensor | None = None
    sum: Callable[[torch.Tensor], torch.Tensor] = field(default=_identity)
    max: Callable[[torch.Tensor], torch.Tensor] = field(default=_identity)
    all_gather: Callable[[torch.Tensor], torch.Tensor] = field(default=_identity)
    gram: Callable[[torch.Tensor], torch.Tensor] = field(default=_gram_plain)
    matmat_t: Callable[[torch.Tensor], torch.Tensor] | None = None


def as_operator(op) -> PowerOperator:
    """Wrap a bare ``matmat`` callable as an operator."""
    if isinstance(op, PowerOperator):
        return op
    return PowerOperator(matmat=op)


def orthonormalize_block(op, v):
    """Cholesky-QR of the (n, r) block with column 0 pinned.

    G = V^T V = L L^T, Q = V L^-T: column j of Q is column j of V
    orthogonalized against the earlier columns and L2-normalized. Column 0
    is returned untouched (the classic degree-seeded trajectory stays the
    block's first basis vector, bitwise). A numerically singular Gram
    (columns momentarily aligned) fails the factorization; the block then
    passes through unchanged and the next QR retries. ``cholesky_ex``
    reports the failure in ``info`` where the reference's Cholesky returns
    NaNs, and L may come back partly filled and still finite, so both are
    tested. The (r, r) algebra stays on the block's device: the skip is a
    ``torch.where``, not a host decision. The Gram is global (the local
    Grams finished by ``op.sum``), so every rank computes the same factor.
    """
    ell, info = torch.linalg.cholesky_ex(op.sum(op.gram(v)))
    ok = (info == 0) & torch.all(torch.isfinite(ell))
    q = torch.linalg.solve_triangular(ell, v.T, upper=False).T
    out = torch.cat([v[:, :1], q[:, 1:]], dim=1)
    return torch.where(ok, out, v)


def subspace_residual(op, v, u):
    """Relative invariant-subspace residual ||U - V Lam||_F / ||U||_F with
    U = W V (the sweep output) and Lam = (V^T V)^-1 V^T U, from one Gram
    of [V | U]:

        ||U - V Lam||^2_F = tr(G_uu) - tr(G_vu^T Lam).

    A singular G_vv (``solve_ex`` reports it in ``info``), a non-finite
    result or a zero U reports inf ("not converged"), as the reference's
    guard does.
    """
    r = v.shape[1]
    g = op.sum(op.gram(torch.cat([v, u], dim=1)))              # (2r, 2r)
    gvv, gvu, guu = g[:r, :r], g[:r, r:], g[r:, r:]
    lam, info = torch.linalg.solve_ex(gvv, gvu)
    denom = torch.trace(guu)
    res2 = denom - torch.trace(gvu.T @ lam)
    rel = torch.sqrt(torch.clamp_min(res2, 0.0) / torch.clamp_min(denom, 1e-30))
    ok = (info == 0) & torch.isfinite(rel) & (denom > 0)
    return torch.where(ok, rel, torch.full_like(rel, float("inf")))


def _validate_loop_args(mode, qr_every, residual_tol, r):
    """Argument checks of the loop. Returns (block, residual): whether the
    QR couples the columns, and whether the residual rule is armed."""
    if mode not in ("pic", "orthogonal"):
        raise ValueError(
            f"unknown power-loop mode {mode!r} (expected 'pic' or "
            "'orthogonal'; 'ensemble' is ensemble_power_iteration)")
    if qr_every < 1:
        raise ValueError(f"qr_every must be >= 1, got {qr_every}")
    if residual_tol is not None and not float(residual_tol) > 0.0:
        raise ValueError(
            f"residual_tol must be > 0 (a relative residual), got "
            f"{residual_tol}")
    block = mode == "orthogonal" and r > 1
    residual = residual_tol is not None
    if residual and not block:
        raise ValueError(
            "residual_tol needs a QR-coupled block (mode='orthogonal' "
            f"with r > 1); got mode={mode!r}, r={r} — the rule could "
            "never arm")
    return block, residual


@dataclass(frozen=True)
class PowerCarry:
    """The whole state of the convergence loop after ``t`` sweeps, as
    tensors on the state's device. The loop body is a function of the
    carry and the operator alone, so a carry saved after any sweep
    (``train/checkpoint.py`` keeps each field by name), restored and
    advanced with :func:`power_iteration_segment` makes the uninterrupted
    loop's sweeps bit for bit: the same eps-crossings, latches and
    per-column counts."""
    t: torch.Tensor       # () int32: completed sweeps
    v: torch.Tensor       # (n, r): the engine state
    delta: torch.Tensor   # (n, r): |v_t - v_{t-1}| (delta_0 = v_0)
    done: torch.Tensor    # (r,) bool: per-column convergence latches
    t_cols: torch.Tensor  # (r,) int32: per-column sweep counts
    snaps: torch.Tensor   # (n, r, S): the ensemble's snapshots (S = 0 outside it)
    status: torch.Tensor  # (r,) int32: COL_* latches
    best: torch.Tensor    # (r,) f32: best acceleration seen (the stall rule)
    since: torch.Tensor   # (r,) int32: sweeps since ``best`` improved


def init_power_carry(v0, n_snapshots: int = 0) -> PowerCarry:
    """The sweep-0 carry of an (n, r) start block; ``n_snapshots`` sizes
    the ensemble's snapshot stack (0: none)."""
    r, dev = v0.shape[1], v0.device
    return PowerCarry(
        t=torch.tensor(0, dtype=torch.int32, device=dev), v=v0, delta=v0,  # delta_0 <- v_0
        done=torch.zeros((r,), dtype=torch.bool, device=dev),
        t_cols=torch.zeros((r,), dtype=torch.int32, device=dev),
        snaps=torch.zeros(tuple(v0.shape) + (n_snapshots,), dtype=v0.dtype, device=dev),
        status=torch.zeros((r,), dtype=torch.int32, device=dev),
        best=torch.full((r,), float("inf"), dtype=torch.float32, device=dev),
        since=torch.zeros((r,), dtype=torch.int32, device=dev))


def power_carry_like(n: int, r: int, n_snapshots: int = 0,
                     dtype: torch.dtype = torch.float32) -> PowerCarry:
    """The carry's shapes and types for an (n, r) state, as tensors on the
    ``meta`` device (no storage): what a snapshot restore checks each
    leaf against."""
    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")
    return PowerCarry(
        t=meta((), torch.int32), v=meta((n, r), dtype), delta=meta((n, r), dtype),
        done=meta((r,), torch.bool), t_cols=meta((r,), torch.int32),
        snaps=meta((n, r, n_snapshots), dtype), status=meta((r,), torch.int32),
        best=meta((r,), torch.float32), since=meta((r,), torch.int32))


def power_iteration_segment(op, carry: PowerCarry, eps, stop: int, *, mode="pic",
                            qr_every=1, snapshot_iters=(), residual_tol=None) -> PowerCarry:
    """Advance the carry until ``stop`` sweeps are done or every column is
    done, and return the new carry (the input is not changed). The body
    below is the one definition of a sweep: the whole loop
    (:func:`_power_loop`) is one segment to ``max_iter``, so a run cut into
    segments makes its sweeps bit for bit.

    The divergence latches are always armed: a column whose L1 mass hits
    exact zero (COL_ZERO) or that produced a NaN/Inf (COL_NONFINITE) is
    zeroed and latched done, and a column whose acceleration statistic
    stops improving for STALL_PATIENCE sweeps is flagged COL_STALLED. On a
    clean run every latch predicate is False, so the values are the
    unlatched ones.

    ``residual_tol`` (block mode only) arms the subspace residual rule: on
    a QR sweep after column 0 has converged by its classic rule, a
    relative residual <= residual_tol latches every column done. The gate
    reads ``done[0]`` on the host. ``snapshot_iters`` are the sweep counts
    after which the state goes into ``snaps`` (the ensemble's).
    """
    op = as_operator(op)
    v, delta, done, t_cols = carry.v, carry.delta, carry.done, carry.t_cols
    status, best, since = carry.status, carry.best, carry.since
    r = v.shape[1]
    block, residual = _validate_loop_args(mode, qr_every, residual_tol, r)
    dev = v.device
    eps = torch.tensor(eps, dtype=torch.float32, device=dev)
    t = int(carry.t)
    pinned = torch.arange(r, device=dev) == 0
    snaps = carry.snaps.clone() if snapshot_iters else carry.snaps
    while t < stop and not bool(done.all()):
        u = op.matmat(v)                                   # (n, r)
        l1 = op.sum(torch.sum(torch.abs(u), dim=0))        # (r,)
        v_next = u / torch.clamp_min(l1, 1e-30)[None, :]
        # per-column fault latches read the reduced l1: a NaN/Inf anywhere
        # in the column propagates into its sum
        zero_col = l1 <= 0.0
        bad_col = ~torch.isfinite(l1)
        fault = (zero_col | bad_col) & ~done
        v_next = torch.where(fault[None, :], 0.0, v_next)
        status = (status
                  | torch.where(zero_col & fault, COL_ZERO, 0)
                  | torch.where(bad_col & fault, COL_NONFINITE, 0)
                  ).to(torch.int32)
        qr_now = (t + 1) % qr_every == 0
        if block and qr_now:
            v_next = orthonormalize_block(op, v_next)
        delta_next = torch.abs(v_next - v)
        accel = op.max(torch.amax(torch.abs(delta_next - delta), dim=0))  # (r,)
        # columns already done are frozen: keep prior value/delta and don't
        # count the iteration; columns converging NOW keep this update. In
        # block mode only the pinned column 0 freezes.
        freeze = done & pinned if block else done
        v_next = torch.where(freeze[None, :], v, v_next)
        delta_next = torch.where(freeze[None, :], delta, delta_next)
        t_cols = t_cols + torch.where(done, 0, 1).to(torch.int32)
        done = done | (accel <= eps) | fault
        improved = accel < best
        since = torch.where(done | improved, 0, since + 1).to(torch.int32)
        best = torch.minimum(best, accel)
        status = (status | torch.where(
            ~done & (since >= STALL_PATIENCE), COL_STALLED, 0)).to(torch.int32)
        if residual and qr_now and bool(done[0]):
            # priced at QR cadence once the pinned column has converged, so
            # column 0's classic n_iter/converged stats are kept bitwise
            done = done | (subspace_residual(op, v, u) <= residual_tol)
        t += 1
        for j, s in enumerate(snapshot_iters):
            if t == s:
                snaps[:, :, j] = v_next
        v, delta = v_next, delta_next
    return PowerCarry(t=torch.tensor(t, dtype=torch.int32, device=dev), v=v, delta=delta,
                      done=done, t_cols=t_cols, snaps=snaps, status=status, best=best,
                      since=since)


def finalize_power_carry(carry: PowerCarry):
    """Close a finished carry as the loop does on exit: COL_MAXITER on the
    columns still not done. Returns (t, V, t_cols, done, snaps, status),
    ``t`` a Python int."""
    status = (carry.status | torch.where(~carry.done, COL_MAXITER, 0)).to(torch.int32)
    return int(carry.t), carry.v, carry.t_cols, carry.done, carry.snaps, status


def _power_loop(op, v0, eps, max_iter, mode="pic", qr_every=1, snapshot_iters=(),
                residual_tol=None):
    """The one convergence loop behind every embedding mode: the sweep-0
    carry, one segment to ``max_iter``, then the close. Returns (t, V,
    t_cols, done, snaps, status): snaps the (n, r, S) states after each of
    ``snapshot_iters`` sweeps (zeros where the loop stopped earlier),
    status the (r,) int32 COL_* mask."""
    carry = power_iteration_segment(
        op, init_power_carry(v0, len(snapshot_iters)), eps, max_iter, mode=mode,
        qr_every=qr_every, snapshot_iters=snapshot_iters, residual_tol=residual_tol)
    return finalize_power_carry(carry)


def batched_power_iteration(op, v0, eps, max_iter, *, mode="pic", qr_every=1,
                            residual_tol=None, return_status=False):
    """Run the truncated power iteration on batched state.

    Args:
      op: a :class:`PowerOperator`, or a bare callable mapping V (n, r) to
        (A V) / d.
      v0: (n, r) initial vectors.
      eps: the paper's acceleration threshold (typically 1e-5 / n).
      max_iter: iteration cap.
      mode: 'pic' (classic per-column loop, frozen columns) or
        'orthogonal' (block iteration, column 0 pinned). With r = 1 both
        modes are the same classic loop.
      qr_every: re-orthonormalization period in sweeps ('orthogonal').
      residual_tol: arm the subspace residual stopping rule ('orthogonal'
        with r > 1 only).
      return_status: also return the (r,) int32 COL_* status bitmask.

    Returns:
      (V, t_cols, done) — plus the status mask when ``return_status``.
    """
    _t, v, t_cols, done, _snaps, status = _power_loop(
        op, v0, eps, max_iter, mode, qr_every, residual_tol=residual_tol)
    if return_status:
        return v, t_cols, done, status
    return v, t_cols, done


def default_snapshot_iters(max_iter, n_snapshots=4):
    """Geometrically spaced diffusion times max_iter/2^(S-1-j), ascending,
    deduplicated — the default ensemble schedule."""
    iters: list[int] = []
    for j in range(n_snapshots):
        t = max(1, max_iter // (2 ** (n_snapshots - 1 - j)))
        if not iters or t > iters[-1]:
            iters.append(t)
    return tuple(iters)


def resolve_snapshot_iters(snapshot_iters, max_iter) -> tuple[int, ...]:
    """The ensemble's diffusion times as a tuple of ints (None: the default
    geometric schedule), checked to be strictly ascending in [1,
    max_iter]."""
    si = tuple(int(s) for s in (snapshot_iters if snapshot_iters is not None
                                else default_snapshot_iters(max_iter)))
    if not si or list(si) != sorted(set(si)):
        raise ValueError(
            f"snapshot_iters must be non-empty strictly ascending ints, got {si!r}")
    if si[0] < 1 or si[-1] > max_iter:
        raise ValueError(f"snapshot_iters {si!r} must lie in [1, max_iter={max_iter}]")
    return si


def backfill_snapshots(snaps, v, t, snapshot_iters):
    """The (n, r, S) snapshot stack with the slots the loop never reached
    (it stopped after ``t`` sweeps, before their diffusion time) filled
    with the final frozen block ``v``."""
    written = torch.tensor(snapshot_iters, device=v.device) <= t          # (S,)
    return torch.where(written[None, None, :], snaps, v[:, :, None])


def ensemble_power_iteration(op, v0, eps, max_iter, *,
                             snapshot_iters: Sequence[int] | None = None):
    """Diffusion-time ensemble: the classic mode='pic' loop, with the block
    captured after each of ``snapshot_iters`` sweeps (ascending; default
    geometric in ``max_iter``). Snapshots past an early exit are the final
    (frozen) block — no extra sweeps.

    Returns (snaps, t_cols, done, v, status): the (n, r, S) snapshot stack,
    the per-column stats, the loop's final state and the (r,) COL_* mask.
    """
    snapshot_iters = resolve_snapshot_iters(snapshot_iters, max_iter)
    t, v, t_cols, done, snaps, status = _power_loop(
        op, v0, eps, max_iter, "pic", 1, snapshot_iters)
    return backfill_snapshots(snaps, v, t, snapshot_iters), t_cols, done, v, status


def ensemble_embedding(snaps):
    """Flatten an (n, r, S) snapshot stack to the (n, r*S) k-means
    embedding, column order c*S + s (the reference's layout)."""
    return snaps.reshape(snaps.shape[0], -1)


def run_power_embedding(op, v0, eps, max_iter, *, embedding="pic", qr_every=1,
                        snapshot_iters=None, residual_tol=None):
    """Run the engine in the requested embedding mode. Returns
    (v, t_cols, done, emb, status): the final (n, r) state, the per-column
    stats, the matrix to cluster (the state itself for 'pic' and
    'orthogonal', the (n, r*S) snapshot stack for 'ensemble') and the (r,)
    int32 COL_* health mask."""
    if embedding not in EMBEDDINGS:
        raise ValueError(
            f"unknown embedding {embedding!r} (expected one of {EMBEDDINGS})")
    if residual_tol is not None and embedding != "orthogonal":
        raise ValueError(
            "residual_tol arms the subspace residual stopping rule of "
            "embedding='orthogonal' only")
    if embedding == "ensemble":
        snaps, t_cols, done, v, status = ensemble_power_iteration(
            op, v0, eps, max_iter, snapshot_iters=snapshot_iters)
        return v, t_cols, done, ensemble_embedding(snaps), status
    v, t_cols, done, status = batched_power_iteration(
        op, v0, eps, max_iter, mode=embedding, qr_every=qr_every,
        residual_tol=residual_tol, return_status=True)
    return v, t_cols, done, v, status


def random_start_vectors(generator, n, n_vectors, *, device=None,
                         dtype=torch.float32):
    """(n, r-1) L1-normalized uniform random starts — columns 1..r-1 of the
    engine state (Lin & Cohen's multi-vector extension)."""
    if n_vectors <= 1:
        return torch.zeros((n, 0), dtype=dtype, device=device)
    u0 = torch.rand((n_vectors - 1, n), generator=generator, dtype=dtype,
                    device=device)
    u0 = u0 / torch.sum(u0, dim=1, keepdim=True)
    return u0.T


def init_power_vectors(d, n_vectors, *, generator=None, dtype=None):
    """The (n, r) start state: column 0 is the paper's degree start
    v_0 = D / sum(D) (Algorithm 2 lines 4-5); the rest are random starts
    drawn from ``generator``."""
    dtype = dtype or d.dtype
    return init_power_vectors_local(
        d, random_start_vectors(generator, d.shape[0], n_vectors, device=d.device,
                                dtype=dtype), dtype=dtype)


def init_power_vectors_local(d_loc, u0t_loc, sum_fn=_identity, dtype=None):
    """The local (n_loc, r) block of the start state: column 0 is the
    degree start normalized by the global degree mass (``sum_fn`` finishes
    the sum over the ranks: the identity on one device), the rest this
    rank's rows of the replicated random starts ``u0t`` (n, r-1), so every
    rank seeds its rows of the single-device state."""
    dtype = dtype or d_loc.dtype
    dsum = sum_fn(torch.sum(d_loc))
    v0 = (d_loc / torch.clamp_min(dsum, 1e-30)).to(dtype)
    return torch.cat([v0[:, None], u0t_loc.to(device=d_loc.device, dtype=dtype)], dim=1)


def standardize_columns(v):
    """Per-column zero-mean / unit-variance rescale of the (n, r) embedding
    (population std, as ``jnp.std``)."""
    mu = torch.mean(v, dim=0, keepdim=True)
    sd = torch.clamp_min(torch.std(v, dim=0, keepdim=True, correction=0), 1e-30)
    return (v - mu) / sd
