"""Validation and diagnostics: typed errors, per-column health codes.

Every GPIC entry point either succeeds with a diagnosable result or fails
with a typed, actionable error, never silent garbage:

  - The :class:`GPICError` hierarchy: the exceptions the front door
    (``run_gpic``) raises for degenerate inputs and unusable runs.
    ``InvalidInputError`` doubles as a ``ValueError``.
  - :class:`HealthReport` and the ``COL_*`` per-column status codes, carried
    on ``PICResult.health``.
  - :func:`count_bad_rows`, :func:`validate_features` and
    :func:`raise_for_health`.

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
        classifies the whole run: 'ok' (clean arrays, no notes) or
        'degraded' (bad columns, isolated rows, or a note). The reference's
        'recovered' status and ``recovery`` notes come from its retry
        supervisor, which is not ported: here ``recovery`` is always empty."""
        codes = self.col_status.cpu().tolist()
        bad_columns = sum(1 for c in codes if c != COL_OK)
        iso = int(self.isolated_rows)
        run_status = "degraded" if bad_columns or iso or self.notes else "ok"
        return {
            "status": run_status,
            "col_status": [describe_status(c) for c in codes],
            "bad_columns": bad_columns,
            "isolated_rows": iso,
            "n_components": int(self.n_components),
            "notes": list(self.notes),
            "recovery": [],
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


def count_bad_rows(d: torch.Tensor) -> torch.Tensor:
    """() int32 count of rows whose degree cannot anchor them (not > 0:
    zero and non-finite degrees both count)."""
    return torch.sum(~(d > 0)).to(torch.int32)


def validate_features(x: torch.Tensor, k: int, *, sanitize: bool = False):
    """Front-door feature checks. Returns ``(x, notes)`` — possibly
    sanitized — or raises a typed error.

    Raises :class:`InvalidInputError` for shapes that can never cluster
    (ndim != 2, empty, n < k) and for an all-identical feature matrix;
    :class:`NonFiniteInputError` for NaN/Inf features unless
    ``sanitize=True``, which zero-fills them and records a note.
    """
    notes: list[str] = []
    if x.ndim != 2:
        raise InvalidInputError(
            f"features must be a (n, m) matrix, got shape {tuple(x.shape)}")
    n, m = x.shape
    if n == 0 or m == 0:
        raise InvalidInputError(f"empty feature matrix (shape {tuple(x.shape)})")
    if n < k:
        raise InvalidInputError(
            f"cannot form k={k} clusters from n={n} points")
    n_bad = int(torch.sum(~torch.isfinite(x)))
    if n_bad:
        if not sanitize:
            raise NonFiniteInputError(
                f"{n_bad} non-finite feature value(s); pass sanitize=True "
                "to zero-fill them (recorded in PICResult.health.notes)")
        x = torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
        notes.append(f"sanitized:{n_bad}_nonfinite_features")
    if bool(torch.all(x == x[0:1])):
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
