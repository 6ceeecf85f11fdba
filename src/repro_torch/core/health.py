"""Validation and diagnostics: typed errors, per-column health codes.

Every GPIC entry point either succeeds with a diagnosable result or fails
with a typed, actionable error, never silent garbage:

  - The :class:`GPICError` hierarchy: the exceptions the front door
    (``run_gpic``) raises for degenerate inputs and unusable runs, and the
    two the resumable supervisor classifies (a corrupt snapshot, a
    straggling segment). ``InvalidInputError`` doubles as a
    ``ValueError``.
  - :class:`HealthReport` and the ``COL_*`` per-column status codes, carried
    on ``PICResult.health``.
  - :func:`count_bad_rows`, :func:`graph_component_probe`,
    :func:`validate_features`, :func:`raise_for_health`, and the
    reference's utilities :func:`empty_health` and :func:`degree_guard`;
  - :func:`resolve_device` and :func:`as_f32`, the entry points' device
    rule and input conversion.

The loop-side latches (zero-column, non-finite, stall) live in
``core/power.py``; this module defines the vocabulary they share.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


class GPICError(Exception):
    """Base of every typed GPIC failure (catch-all for callers)."""


class InvalidInputError(GPICError, ValueError):
    """The input can never cluster: bad shape, n < k, empty, constant."""


class NonFiniteInputError(InvalidInputError):
    """The feature matrix contains NaN/Inf (opt out via sanitize=True)."""


class DegenerateGraphError(GPICError):
    """The affinity graph carries no usable structure (e.g. every row
    isolated: all similarities underflowed to exact zero)."""


class PowerDivergenceError(GPICError):
    """Every power-iteration column went non-finite or lost all mass —
    there is no embedding left to cluster."""


class CheckpointCorruptError(GPICError):
    """A convergence-carry snapshot failed its integrity check (per-leaf
    checksum mismatch, truncated or missing leaf file, unreadable
    manifest). The supervisor quarantines it and falls back to the
    previous valid snapshot (noted ``checkpoint_skipped:<dir>``)."""


class StragglerTimeout(GPICError):
    """A bounded segment of sweeps exceeded ``GPICConfig.straggler_timeout``
    seconds of wall clock; the supervisor retries it from the last
    snapshot."""


# Per-column status codes (bitmask — a column can stall AND hit max_iter)
COL_OK = 0          #: converged by the acceleration rule
COL_MAXITER = 1     #: ran to the iteration cap without converging
COL_STALLED = 2     #: acceleration stopped improving for STALL_PATIENCE
#                      sweeps — diagnostic only, the column keeps iterating
COL_NONFINITE = 4   #: NaN/Inf appeared in the column; it was zeroed+latched
COL_ZERO = 8        #: the column's L1 mass hit exact zero; latched

_STATUS_NAMES = (
    (COL_MAXITER, "maxiter"),
    (COL_STALLED, "stalled"),
    (COL_NONFINITE, "nonfinite"),
    (COL_ZERO, "zero"),
)

#: note prefixes that record a recovery (the supervisor resumed, retried or
#: skipped a corrupt snapshot), not damage to the result: a run whose only
#: notes are these and whose arrays are clean is 'recovered', not
#: 'degraded'. The reference's two kernel-fallback prefixes have no place
#: here: the port has no fallback.
RECOVERY_NOTE_PREFIXES = ("resumed:", "retry:", "straggler:", "checkpoint_skipped:")


def is_recovery_note(note: str) -> bool:
    """True when ``note`` records a supervisor recovery (resume, retry,
    corrupt-snapshot skip), not damage to the result."""
    return note.startswith(RECOVERY_NOTE_PREFIXES)


def describe_status(code: int) -> tuple[str, ...]:
    """Human-readable flag names for one column's status bitmask."""
    code = int(code)
    if code == COL_OK:
        return ("ok",)
    return tuple(name for bit, name in _STATUS_NAMES if code & bit)


@dataclass(frozen=True)
class HealthReport:
    """Per-run diagnostics carried on ``PICResult.health``."""
    col_status: torch.Tensor     # (r,) int32 COL_* bitmask per power column
    isolated_rows: torch.Tensor  # () int32 — rows whose degree is not > 0
    n_components: torch.Tensor   # () int32 — -1: component probe not run
    components: torch.Tensor     # (n,) int32 per-row component id (-1 unprobed)
    #: host-side event strings (sanitization applied, ...)
    notes: tuple = ()

    def to_dict(self) -> dict:
        """Host-side dict view, laid out as the reference's. ``status``
        classifies the whole run: 'ok' (clean arrays, no notes),
        'recovered' (clean arrays, and only the supervisor's recovery notes:
        it resumed, retried or skipped a corrupt snapshot on the way) or
        'degraded' (bad columns, isolated rows, or any other note, such as
        sanitization)."""
        codes = self.col_status.cpu().tolist()
        bad_columns = sum(1 for c in codes if c != COL_OK)
        iso = int(self.isolated_rows)
        recovery = [n for n in self.notes if is_recovery_note(n)]
        if bad_columns or iso or len(recovery) < len(self.notes):
            run_status = "degraded"
        elif recovery:
            run_status = "recovered"
        else:
            run_status = "ok"
        return {
            "status": run_status,
            "col_status": [describe_status(c) for c in codes],
            "bad_columns": bad_columns,
            "isolated_rows": iso,
            "n_components": int(self.n_components),
            "notes": list(self.notes),
            "recovery": recovery,
        }

    def summary(self) -> str:
        """One human-readable line of the run's health."""
        d = self.to_dict()
        parts = [
            f"status={d['status']}",
            f"bad_columns={d['bad_columns']}/{len(d['col_status'])}",
            f"isolated_rows={d['isolated_rows']}",
        ]
        if d["n_components"] >= 0:
            parts.append(f"n_components={d['n_components']}")
        flagged = [f"{i}:{'+'.join(f)}" for i, f in enumerate(d["col_status"])
                   if f != ("ok",)]
        if flagged:
            parts.append("cols[" + " ".join(flagged) + "]")
        if d["notes"]:
            parts.append("notes[" + "; ".join(d["notes"]) + "]")
        return "GPIC health: " + " ".join(parts)


def empty_health(r: int, n: int, *, device=None) -> HealthReport:
    """An all-OK report (for paths that compute no diagnostics), on
    ``device`` (None: the CUDA card, as :func:`resolve_device` says)."""
    dev = resolve_device(device, "empty_health")
    return HealthReport(
        col_status=torch.zeros((r,), dtype=torch.int32, device=dev),
        isolated_rows=torch.tensor(0, dtype=torch.int32, device=dev),
        n_components=torch.tensor(-1, dtype=torch.int32, device=dev),
        components=torch.full((n,), -1, dtype=torch.int32, device=dev),
    )


def degree_guard(u: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(A V) / d with the rows of non-positive or non-finite degree masked
    to an exact zero, for callers outside the sweep. ``u`` is (n, r) or
    (n,), ``d`` (n,).

    The sweeps keep the floored ``u / max(d, 1e-30)`` divide, which is
    already zero-degree safe (d = 0 means the nonnegative A row, hence u,
    is an exact 0) and lets a NaN degree reach the loop's COL_NONFINITE
    latch; this masked form is not substituted into the sweep, as in the
    reference.
    """
    ok = d > 0
    safe = torch.where(ok, d, 1.0)
    if u.ndim == 2:
        return torch.where(ok[:, None], u / safe[:, None], 0.0)
    return torch.where(ok, u / safe, 0.0)


def count_bad_rows(d: torch.Tensor, sum_fn=None) -> torch.Tensor:
    """() int32 count of rows whose degree cannot anchor them (not > 0:
    zero and non-finite degrees both count). ``sum_fn`` finishes the count
    over the ranks of a sharded ``d`` (None: one device)."""
    local = torch.sum(~(d > 0)).to(torch.int32)
    return local if sum_fn is None else sum_fn(local)


def graph_component_probe(op, n_total: int, *, row_offset: int = 0,
                          max_components: int = 8, max_sweeps: int = 32):
    """Component check of the (truncated) affinity graph on the device.

    Reachability expansion from an indicator on the lowest-index unvisited
    row: one ``op.matmat`` sweep (with one ``op.matmat_t`` sweep when the
    operator binds it) adds every row with a nonzero entry toward the
    reached set, until a fixed point or ``max_sweeps`` hops; that set is one
    component, and the next seed is the lowest unvisited row, up to
    ``max_components`` seeds. If rows remain unvisited after them, the
    count is ``max_components + 1`` ("at least").

    The kNN graph is directed, so a truncated spec's operator binds
    ``matmat_t`` and the expansion walks A + A^T: the weakly connected
    components, along which power-iteration mass can move. For a
    nonnegative A and a {0, 1} indicator the positivity of A v does not
    depend on the summation order, so the result is exact on either engine,
    on either device and on any number of ranks.

    On a sharded operator the rows are this rank's block, starting at
    global row ``row_offset``: ``op.sum`` finishes the unvisited count and
    the growth of a hop, ``op.max`` the global lowest unvisited row, so
    every rank reads the same flags and takes the same branches. The
    reference runs the two loops on the device (``while_loop``); here the
    host reads one flag per hop. Returns ``(n_components () int32,
    components (n_loc,) int32)``, ids in discovery order, -1 for rows never
    reached.
    """
    n_local = op.degree.shape[0]
    device = op.degree.device
    gidx = row_offset + torch.arange(n_local, dtype=torch.int64, device=device)
    comp = torch.full((n_local,), -1, dtype=torch.int32, device=device)
    visited = torch.zeros((n_local,), dtype=torch.bool, device=device)

    def unvisited():
        return int(op.sum(torch.sum(~visited, dtype=torch.int64)))

    count = 0
    while count < max_components and unvisited() > 0:
        # the global lowest unvisited index, as the max of the negated minima
        cand = torch.where(visited, n_total, gidx)
        seed = -op.max(-torch.amin(cand))
        reached = gidx == seed
        for _ in range(max_sweeps):
            ind = reached.to(torch.float32)[:, None]
            new = reached | (op.matmat(ind)[:, 0] > 0)
            if op.matmat_t is not None:
                new = new | (op.matmat_t(ind)[:, 0] > 0)
            grew = int(op.sum(torch.sum(new & ~reached, dtype=torch.int64))) > 0
            reached = new
            if not grew:
                break
        comp = torch.where(reached & (comp < 0), count, comp)
        visited = visited | reached
        count += 1
    leftover = 1 if unvisited() > 0 else 0
    return (torch.tensor(count + leftover, dtype=torch.int32, device=device),
            comp.to(torch.int32))


def resolve_device(device, entry: str) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card,
    which must then exist (``entry`` names the caller in the error)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{entry} runs on a CUDA device and none is available; pass "
            "device='cpu' to run the kernels' plain versions on the CPU")
    return dev


def as_f32(x, dev: torch.device) -> torch.Tensor:
    """A numpy array or a tensor as float32 on ``dev`` (no copy when it
    is one already)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)


def validate_features(x: torch.Tensor, k: int, *, sanitize: bool = False,
                      reductions=None):
    """Front-door feature checks. Returns ``(x, notes)`` — possibly
    sanitized — or raises a typed error.

    Raises :class:`InvalidInputError` for shapes that can never cluster
    (ndim != 2, empty, n < k) and for an all-identical feature matrix;
    :class:`NonFiniteInputError` for NaN/Inf features unless
    ``sanitize=True``, which zero-fills them and records a note.

    ``reductions`` — (sum, max, all_gather) over a process group, as
    ``core/operators.py::mesh_reductions`` makes them — checks the whole
    matrix when ``x`` is one rank's row block: n counts every rank's rows,
    and the non-finite count and the identical-rows test cover them all,
    so every rank raises, or passes, alike.
    """
    notes: list[str] = []
    if x.ndim != 2:
        raise InvalidInputError(
            f"features must be a (n, m) matrix, got shape {tuple(x.shape)}")
    n, m = x.shape
    if n == 0 or m == 0:
        raise InvalidInputError(f"empty feature matrix (shape {tuple(x.shape)})")
    first = x[0:1]
    if reductions is not None:
        total, _, gather = reductions
        n = int(total(torch.tensor(n, device=x.device)))
    if n < k:
        raise InvalidInputError(
            f"cannot form k={k} clusters from n={n} points")
    bad = torch.sum(~torch.isfinite(x))
    n_bad = int(bad if reductions is None else total(bad))
    if n_bad:
        if not sanitize:
            raise NonFiniteInputError(
                f"{n_bad} non-finite feature value(s); pass sanitize=True "
                "to zero-fill them (recorded in PICResult.health.notes)")
        x = torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
        notes.append(f"sanitized:{n_bad}_nonfinite_features")
        first = x[0:1]
    if reductions is None:
        identical = bool(torch.all(x == first))
    else:
        # the global first row is rank 0's; a rank differs where any row does
        differ = torch.any(x != gather(first)[0:1]).to(torch.int32)
        identical = int(total(differ)) == 0
    if identical:
        raise InvalidInputError(
            "all feature rows are identical — every pairwise affinity is "
            "equal and the power embedding is constant; clustering is "
            "undefined on this input")
    return x, tuple(notes)


def raise_for_health(health: HealthReport, n: int) -> None:
    """Post-run host check: raise when the result is unusable (ALL rows
    isolated / ALL columns dead); partial damage returns with the report
    populated instead."""
    iso = int(health.isolated_rows)
    if iso >= n:
        raise DegenerateGraphError(
            f"every one of the {n} rows is isolated (zero degree) — the "
            "affinity graph is empty; widen sigma / raise knn_k")
    status = np.asarray(health.col_status.cpu())
    fatal = COL_NONFINITE | COL_ZERO
    if status.size and bool(((status & fatal) != 0).all()):
        names = [describe_status(c) for c in status.tolist()]
        raise PowerDivergenceError(
            f"every power-iteration column went dead ({names}) — no "
            "embedding left to cluster; check feature scaling "
            f"({iso}/{n} rows isolated)")
