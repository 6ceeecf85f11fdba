"""Fault injection and straggler timing for the resumable GPIC supervisor.

  - :class:`SimulatedFailure` and :class:`FailureInjector`: raise at chosen
    steps (a ``run_gpic`` ``segment_injector`` is ``injector.maybe_fail``,
    called with the sweep count at every segment boundary);
  - :class:`StragglerMonitor`: online per-step timing, flagging steps
    slower than ``threshold`` times the running median;
  - :func:`inject_nan_features`, :class:`ClusteringFaultHarness`,
    :class:`FaultSchedule`, :func:`apply_feature_faults` and
    :func:`run_schedule`: corrupt the input, poison a ring stage or
    interrupt the run, and classify what ``run_gpic`` returns by the
    robustness contract ('ok', 'recovered', 'degraded' or 'typed_error').

The reference's ``RestartableLoop`` (a restartable training loop) waits for
the port's training (ROADMAP queue 1 item 12b). Its ``FaultSchedule``'s
``kernel_failure`` forces a kernel onto its fallback, which the port does
not have (a kernel that fails raises), so the port's schedule has no such
field.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..core.health import COL_OK, GPICError, is_recovery_note


class SimulatedFailure(RuntimeError, GPICError):
    """An injected fault: a GPICError, so the supervisor retries it from
    the last snapshot."""


class FailureInjector:
    """Raise ``exc`` the first time :meth:`maybe_fail` sees each step of
    ``fail_at_steps``."""

    def __init__(self, fail_at_steps=(), exc=SimulatedFailure):
        self.fail_at = set(fail_at_steps)
        self.exc = exc
        self.fired: set = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise self.exc(f"injected failure at step {step}")


@dataclass
class StragglerMonitor:
    """Per-step seconds over a window; a step slower than ``threshold`` ×
    the window's median (after 5 steps) is flagged."""
    threshold: float = 2.0
    window: int = 50
    times: list = field(default_factory=list)
    flagged: list = field(default_factory=list)

    def record(self, step: int, seconds: float) -> bool:
        self.times.append(seconds)
        if len(self.times) > self.window:
            self.times.pop(0)
        med = sorted(self.times)[len(self.times) // 2]
        is_straggler = len(self.times) >= 5 and seconds > self.threshold * med
        if is_straggler:
            self.flagged.append((step, seconds, med))
        return is_straggler

    @property
    def median(self) -> float:
        return sorted(self.times)[len(self.times) // 2] if self.times else 0.0


def _rows_set(x, rows, value):
    """A copy of ``x`` (numpy or tensor) with ``rows`` set to ``value``."""
    rows = list(rows)
    if isinstance(x, torch.Tensor):
        x = x.clone()
        x[torch.as_tensor(rows, dtype=torch.long, device=x.device)] = value
        return x
    x = np.array(x, dtype=np.float32, copy=True)
    x[rows] = value
    return x


def inject_nan_features(x, rows, *, value: float = float("nan")):
    """A copy of the features with ``rows`` set to ``value`` (NaN by
    default): the non-finite-input fault class."""
    return _rows_set(x, rows, value)


def _classify(res) -> tuple[str, tuple]:
    """('ok' | 'recovered' | 'degraded', notes) of a returned result:
    'recovered' where the arrays are clean and every note records a
    supervisor recovery."""
    h = res.health
    clean = h is None or (int(h.isolated_rows) == 0
                          and bool((h.col_status == COL_OK).all()))
    notes = () if h is None else h.notes
    if clean and not notes:
        return "ok", notes
    if clean and all(is_recovery_note(n) for n in notes):
        return "recovered", notes
    return "degraded", notes


class ClusteringFaultHarness:
    """Run GPIC trials under injected faults and record what came back.

    A :class:`FailureInjector` picks the trials whose input is corrupted
    (``corrupt_fn(x, trial) -> x``, by default one NaN row), a
    :class:`StragglerMonitor` times every trial, and each outcome is
    classified: 'ok', 'recovered' (clean arrays, only recovery notes),
    'degraded' (damage described in ``result.health``) or 'typed_error' (a
    GPICError raised; anything else propagates)."""

    def __init__(self, *, fail_at_trials=(), corrupt_fn: Callable = None,
                 straggler_threshold: float = 2.0):
        self.injector = FailureInjector(fail_at_steps=fail_at_trials)
        self.corrupt_fn = corrupt_fn or (
            lambda x, trial: inject_nan_features(x, [trial % x.shape[0]]))
        self.monitor = StragglerMonitor(threshold=straggler_threshold)
        self.outcomes: list = []

    def run_trial(self, trial: int, x, k: int, config=None, **kwargs) -> dict:
        """One clustering attempt; returns its record (also kept in
        ``self.outcomes``). ``kwargs`` go to ``run_gpic`` (``device=``)."""
        from ..core.pipeline import run_gpic

        try:
            self.injector.maybe_fail(trial)
        except SimulatedFailure:
            x = self.corrupt_fn(x, trial)
        t0 = time.perf_counter()
        record: dict = {"trial": trial, "injected": trial in self.injector.fired}
        try:
            res = run_gpic(x, k, config, **kwargs)
        except GPICError as e:
            record.update(status="typed_error", error=type(e).__name__, message=str(e))
        else:
            status, _ = _classify(res)
            record.update(status=status, labels=res.labels.cpu().numpy(),
                          health=None if res.health is None else res.health.to_dict())
        record["sec"] = time.perf_counter() - t0
        self.monitor.record(trial, record["sec"])
        self.outcomes.append(record)
        return record

    def summary(self) -> dict:
        counts: dict = {}
        for r in self.outcomes:
            counts[r["status"]] = counts.get(r["status"], 0) + 1
        return {"trials": len(self.outcomes), "counts": counts,
                "stragglers": len(self.monitor.flagged)}


@dataclass(frozen=True)
class FaultSchedule:
    """Faults live in one run at once:

      nan_rows:     feature rows set to NaN (NonFiniteInputError unless the
                    config sanitizes)
      isolate_rows: feature rows moved to ``outlier_distance`` in every
                    coordinate, so an rbf affinity underflows their rows to
                    zero degree (the isolated-row latch)
      ring_stage:   poison the V block this stage of the sharded streaming
                    ring consumes with NaN (the config must set ``mesh`` and
                    engine='streaming'; ``inject_ring_fault``)
      fail_sweeps:  sweep counts at which the supervisor's segment injector
                    raises SimulatedFailure (once each: the resume path)
    """
    nan_rows: tuple = ()
    isolate_rows: tuple = ()
    ring_stage: Optional[int] = None
    fail_sweeps: tuple = ()
    outlier_distance: float = 60.0


def apply_feature_faults(x, schedule: FaultSchedule):
    """The features with the schedule's input faults applied (NaN rows,
    then isolated outlier rows); a copy, numpy or tensor as given."""
    if schedule.nan_rows:
        x = inject_nan_features(x, schedule.nan_rows)
    if schedule.isolate_rows:
        x = _rows_set(x, schedule.isolate_rows, schedule.outlier_distance)
    return x


def run_schedule(x, k: int, schedule: FaultSchedule, config=None, **kwargs) -> dict:
    """One supervised ``run_gpic`` with every fault of ``schedule`` live,
    classified by the robustness contract ('ok', 'recovered', 'degraded'
    or 'typed_error', never an unclassified crash). ``record['notes']``
    holds the supervisor's retry and resume history. ``x`` is what
    ``run_gpic`` takes: on a group (``config.mesh``) this rank's row block,
    whose rows the input faults index."""
    from ..core.pipeline import run_gpic

    x = apply_feature_faults(x, schedule)
    if schedule.ring_stage is not None:
        config = config.with_(inject_ring_fault=("ring_nan", schedule.ring_stage))
    injector = (FailureInjector(fail_at_steps=schedule.fail_sweeps)
                if schedule.fail_sweeps else None)
    record: dict = {"faults": {"nan_rows": list(schedule.nan_rows),
                               "isolate_rows": list(schedule.isolate_rows),
                               "ring_stage": schedule.ring_stage,
                               "fail_sweeps": list(schedule.fail_sweeps)}}
    try:
        res = run_gpic(x, k, config,
                       segment_injector=None if injector is None else injector.maybe_fail,
                       **kwargs)
    except GPICError as e:
        record.update(status="typed_error", error=type(e).__name__, message=str(e))
    else:
        status, notes = _classify(res)
        record.update(status=status, labels=res.labels.cpu().numpy(), notes=list(notes),
                      health=None if res.health is None else res.health.to_dict())
    return record
