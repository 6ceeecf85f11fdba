"""Batched truncated power iteration: the multi-vector engine core.

One ``(n, r)`` state matrix replaces r independent loops: every iteration
performs ONE degree-normalized mat-mat (one sweep of A), however the
operator realizes it, so the per-iteration memory traffic does not depend
on the number of power vectors.

The engine is parameterized by a :class:`PowerOperator`: ``matmat``
performs the sweep on one device.

This slice ports ``mode='pic'``: the paper's per-vector Algorithm 1/2 loop,
where each column carries its own delta and acceleration-based stopping
flag, and a converged column is frozen while the others keep iterating.
The reference's ``while_loop`` is a Python loop here that reads
``done.all()`` on the host once per sweep.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from .health import COL_MAXITER, COL_NONFINITE, COL_STALLED, COL_ZERO

EMBEDDINGS = ("pic", "orthogonal", "ensemble")

#: sweeps without a strict improvement of a column's acceleration statistic
#: before COL_STALLED latches — diagnostic only, never alters the iteration
STALL_PATIENCE = 10


@dataclass(frozen=True)
class PowerOperator:
    """One degree-normalized sweep of A.

    Attributes:
      matmat: maps the (n, r) V to (A V) / d.
      degree: the (n,) degree backing the sweep (v0 seed and diagnostics;
        None for a bare callable).
    """
    matmat: Callable[[torch.Tensor], torch.Tensor]
    degree: torch.Tensor | None = None


def as_operator(op) -> PowerOperator:
    """Wrap a bare ``matmat`` callable as an operator."""
    if isinstance(op, PowerOperator):
        return op
    return PowerOperator(matmat=op)


def _power_loop(op, v0, eps, max_iter):
    """The convergence loop of ``mode='pic'``. Returns
    (t, V, t_cols, done, status); status is the (r,) int32 COL_* mask.

    The divergence latches are always armed: a column whose L1 mass hits
    exact zero (COL_ZERO) or that produced a NaN/Inf (COL_NONFINITE) is
    zeroed and latched done, and a column whose acceleration statistic
    stops improving for STALL_PATIENCE sweeps is flagged COL_STALLED. On a
    clean run every latch predicate is False, so the values are the
    unlatched ones.
    """
    op = as_operator(op)
    r = v0.shape[1]
    dev = v0.device
    eps = torch.tensor(eps, dtype=torch.float32, device=dev)
    t = 0
    v, delta = v0, v0                                     # delta_0 <- v_0
    done = torch.zeros((r,), dtype=torch.bool, device=dev)
    t_cols = torch.zeros((r,), dtype=torch.int32, device=dev)
    status = torch.zeros((r,), dtype=torch.int32, device=dev)
    best = torch.full((r,), float("inf"), dtype=torch.float32, device=dev)
    since = torch.zeros((r,), dtype=torch.int32, device=dev)
    while t < max_iter and not bool(done.all()):
        u = op.matmat(v)                                   # (n, r)
        l1 = torch.sum(torch.abs(u), dim=0)                # (r,)
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
        delta_next = torch.abs(v_next - v)
        accel = torch.amax(torch.abs(delta_next - delta), dim=0)  # (r,)
        # columns already done are frozen: keep prior value/delta and don't
        # count the iteration; columns converging NOW keep this update
        v_next = torch.where(done[None, :], v, v_next)
        delta_next = torch.where(done[None, :], delta, delta_next)
        t_cols = t_cols + torch.where(done, 0, 1).to(torch.int32)
        done = done | (accel <= eps) | fault
        improved = accel < best
        since = torch.where(done | improved, 0, since + 1).to(torch.int32)
        best = torch.minimum(best, accel)
        status = (status | torch.where(
            ~done & (since >= STALL_PATIENCE), COL_STALLED, 0)).to(torch.int32)
        t += 1
        v, delta = v_next, delta_next
    status = (status | torch.where(~done, COL_MAXITER, 0)).to(torch.int32)
    return t, v, t_cols, done, status


def batched_power_iteration(op, v0, eps, max_iter, *, mode="pic",
                            return_status=False):
    """Run the truncated power iteration on batched state.

    Args:
      op: a :class:`PowerOperator`, or a bare callable mapping V (n, r) to
        (A V) / d.
      v0: (n, r) initial vectors.
      eps: the paper's acceleration threshold (typically 1e-5 / n).
      max_iter: iteration cap.
      mode: 'pic' (the classic per-column loop with frozen columns); the
        reference's 'orthogonal' block mode is not ported yet.
      return_status: also return the (r,) int32 COL_* status bitmask.

    Returns:
      (V, t_cols, done) — plus the status mask when ``return_status``.
    """
    if mode != "pic":
        if mode == "orthogonal":
            raise NotImplementedError(
                "mode='orthogonal' is not ported yet (ROADMAP queue 1 item 4, "
                "embedding modes)")
        raise ValueError(f"unknown power-loop mode {mode!r} (expected 'pic')")
    _t, v, t_cols, done, status = _power_loop(op, v0, eps, max_iter)
    if return_status:
        return v, t_cols, done, status
    return v, t_cols, done


def run_power_embedding(op, v0, eps, max_iter, *, embedding="pic"):
    """Run the engine in the requested embedding mode. Returns
    (v, t_cols, done, emb, status): the final (n, r) state, the per-column
    stats, the matrix to cluster (the state itself for 'pic') and the (r,)
    int32 COL_* health mask."""
    if embedding not in EMBEDDINGS:
        raise ValueError(
            f"unknown embedding {embedding!r} (expected one of {EMBEDDINGS})")
    if embedding != "pic":
        raise NotImplementedError(
            f"embedding={embedding!r} is not ported yet (ROADMAP queue 1 "
            "item 4, embedding modes)")
    v, t_cols, done, status = batched_power_iteration(
        op, v0, eps, max_iter, return_status=True)
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
    v0 = (d / torch.clamp_min(torch.sum(d), 1e-30)).to(dtype)
    return torch.cat(
        [v0[:, None], random_start_vectors(generator, d.shape[0], n_vectors,
                                           device=d.device, dtype=dtype)],
        dim=1)


def standardize_columns(v):
    """Per-column zero-mean / unit-variance rescale of the (n, r) embedding
    (population std, as ``jnp.std``)."""
    mu = torch.mean(v, dim=0, keepdim=True)
    sd = torch.clamp_min(torch.std(v, dim=0, keepdim=True, correction=0), 1e-30)
    return (v - mu) / sd
