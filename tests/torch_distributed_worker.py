"""One rank of the port's sharded engines on a gloo group, for
``tests/test_torch_distributed.py`` and
``tests/test_torch_distributed_supervisor.py``.

``run_rank`` is the body ``torch.multiprocessing.spawn`` runs in each
process: it joins the group through a file store, runs every case of a
pickled case file on this rank's row block of the case's features, and
writes each case's outputs, as numpy, to ``<out_dir>/<case>.rank<r>.npz``.
A case that raises on every rank records its message and the next case
runs; a collective that one rank never reaches ends in the group's
timeout. A ``steps`` case runs its steps in order with a barrier after
each (supervised runs with snapshots under ``<out_dir>``, faults on one
rank, a snapshot corrupted or copied between runs, a resume on one device
or on a subgroup). It imports torch, numpy and the port, nothing of JAX.
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import time

import numpy as np
import torch

torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

from repro_torch.core import AffinitySpec, GPICConfig, run_gpic  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core import pipeline as P  # noqa: E402
from repro_torch.interop import result_to_numpy  # noqa: E402
from repro_torch.train.fault_tolerance import (FailureInjector, FaultSchedule,  # noqa: E402
                                               run_schedule)


def port_kwargs(kw: dict) -> dict:
    """A case's keyword arguments as the port's entry points take them: the
    spec as an AffinitySpec, ``a_dtype`` as a torch type."""
    out = dict(kw)
    if "affinity" in out:
        out["affinity"] = AffinitySpec(**out["affinity"])
    if "a_dtype" in out:
        out["a_dtype"] = getattr(torch, out["a_dtype"])
    if out.get("inject_ring_fault") is not None:
        out["inject_ring_fault"] = tuple(out["inject_ring_fault"])
    return out


def _segmented(x_loc, k, kw, u0t, init, split):
    """The segment trio on ``kw``'s engine: start to ``split`` sweeps, on in
    steps of ``split`` to max_iter, then the close (``mode`` the loop's,
    the close's embedding)."""
    kw = dict(kw)
    max_iter = kw.pop("max_iter")
    probe = kw.pop("probe_components", True)
    mode = kw.pop("mode", "pic")
    n_vectors = kw.pop("n_vectors", 1)
    gen = torch.Generator().manual_seed(7)
    carry, iso = D.distributed_gpic_segment_start(x_loc, split, device="cpu", generator=gen,
                                                  u0t=u0t, n_vectors=n_vectors, mode=mode, **kw)
    while int(carry.t) < max_iter and not bool(carry.done.all()):
        carry = D.distributed_gpic_segment(x_loc, carry, min(int(carry.t) + split, max_iter),
                                           device="cpu", mode=mode, **kw)
    return D.distributed_gpic_segment_finalize(x_loc, carry, iso, k, device="cpu",
                                               generator=gen, kmeans_init=init,
                                               probe_components=probe, embedding=mode, **kw)


class _FastClock:
    """``time`` whose monotonic() runs ``jump`` seconds ahead from its second
    call on: the first segment the supervisor times on this rank looks
    ``jump`` seconds slow (a straggler on this rank alone)."""

    def __init__(self, jump: float):
        self.jump, self.calls = jump, 0

    def monotonic(self) -> float:
        self.calls += 1
        return time.monotonic() + (self.jump if self.calls > 1 else 0.0)

    def __getattr__(self, name):
        return getattr(time, name)


def _outputs(res) -> dict:
    out = result_to_numpy(res)
    out["notes"] = np.array(list(res.health.notes), dtype=str)
    return out


def _config(kw: dict, tmp: str, group) -> GPICConfig:
    """A step's GPICConfig: ``ckpt`` names its snapshot directory under
    ``tmp`` (shared by the ranks), ``mesh`` is ``group``."""
    kw = port_kwargs(kw)
    if "ckpt" in kw:
        kw["ckpt_dir"] = os.path.join(tmp, kw.pop("ckpt"))
    return GPICConfig(mesh=group, **kw)


def _supervised(step, x_loc, k, rank, tmp, group, kw=None):
    """run_gpic on this rank's block with the step's config: an injector
    raising at ``fail_at`` on the ranks of ``fail_ranks`` (every rank
    without it; the others get none), this rank's clock jumping
    ``slow_s`` seconds in its first segment where it is ``slow_rank``, and
    the generator seeded with ``seed`` where given."""
    cfg = _config(step["kw"] if kw is None else kw, tmp, group)
    fail_ranks = step.get("fail_ranks")
    injector = None
    if step.get("fail_at") and (fail_ranks is None or rank in fail_ranks):
        injector = FailureInjector(fail_at_steps=step["fail_at"]).maybe_fail
    gen = None if step.get("seed") is None else torch.Generator().manual_seed(step["seed"])
    if step.get("slow_rank") == rank:
        P.time = _FastClock(step["slow_s"])
    try:
        return run_gpic(x_loc, k, cfg, device="cpu", generator=gen, segment_injector=injector)
    finally:
        P.time = time


def _step(step, x, k, rank, tmp) -> dict | None:
    """One step of a ``steps`` case on this rank: its outputs, or None."""
    op = step["op"]
    x_loc = D.shard_points(x)
    if op == "run":
        return _outputs(_supervised(step, x_loc, k, rank, tmp, dist.group.WORLD))
    if op == "interrupts":
        # the base run, then one interrupted at 1, mid and last - 1 of its
        # sweeps, a snapshot a sweep
        base = _supervised(step, x_loc, k, rank, tmp, dist.group.WORLD)
        out = {f"base__{f}": v for f, v in _outputs(base).items()}
        t_final = int(base.n_iter_cols.max())
        sweeps = (1, t_final // 2, t_final - 1)
        out["sweeps"] = np.array(sweeps)
        for s in sweeps:
            kw = dict(step["kw"], checkpoint_every=1, ckpt=f"{step['name']}_{s}")
            res = _supervised(dict(step, fail_at=(s,)), x_loc, k, rank, tmp, dist.group.WORLD,
                              kw=kw)
            out.update({f"at{s}__{f}": v for f, v in _outputs(res).items()})
        return out
    if op == "schedule":
        rec = run_schedule(x_loc, k, FaultSchedule(**step["schedule"]),
                           _config(step["kw"], tmp, dist.group.WORLD), device="cpu")
        return {"status": np.array(rec["status"]), "error": np.array(rec.get("error", "")),
                "notes": np.array(rec.get("notes", []), dtype=str),
                "isolated_rows": np.array((rec.get("health") or {}).get("isolated_rows", -1))}
    if op == "trio":
        return result_to_numpy(_segmented(x_loc, k, port_kwargs(step["kw"]), step.get("u0t"),
                                          step.get("init"), step["split"]))
    if op == "reorder":
        cfg = _config(step["kw"], tmp, dist.group.WORLD)
        _, perm = P._row_reorder_permutation(torch.as_tensor(x_loc), cfg, cfg.affinity)
        return dict(_outputs(run_gpic(x_loc, k, cfg, device="cpu")), perm=perm.numpy())
    if op == "subgroup":       # every rank makes the group; its ranks run
        sub = dist.new_group(step["ranks"])
        if rank not in step["ranks"]:
            return None
        return _outputs(_supervised(step, D.shard_points(x, sub), k, rank, tmp, sub))
    if rank != 0:              # the steps below are rank 0's alone
        return None
    if op == "one_device":
        return _outputs(_supervised(step, x, k, rank, tmp, None))
    root = os.path.join(tmp, step["ckpt"])
    if op == "corrupt_newest":
        newest = sorted(d for d in os.listdir(root) if d.startswith("step_"))[-1]
        leaf = os.path.join(root, newest, "v.npy")
        raw = bytearray(open(leaf, "rb").read())
        raw[-32:] = b"\xff" * 32
        open(leaf, "wb").write(bytes(raw))
        return {"newest": np.array(newest)}
    if op == "copy":
        shutil.copytree(root, os.path.join(tmp, step["to"]))
        return None
    if op == "listdir":
        return {"names": np.array(sorted(os.listdir(root)), dtype=str)}
    raise ValueError(f"unknown step {op!r}")


def _steps(case: dict, rank: int, tmp: str) -> dict:
    """A ``steps`` case: each step on every rank, then a barrier; a step
    that raises records its error class and message under its name."""
    out = {}
    for step in case["steps"]:
        try:
            got = _step(step, case["x"], case["k"], rank, tmp)
        except Exception as e:  # noqa: BLE001 - recorded for the test to judge
            got = {"raised": np.array(type(e).__name__), "message": np.array(str(e))}
        if got is not None and step.get("out"):
            out.update({f"{step['out']}__{f}": v for f, v in got.items()})
        dist.barrier()
    return out


def run_case(case: dict, rank: int = 0, tmp: str = "") -> dict:
    """One case on this rank: its entry point on the rank's block of the
    case's features (``steps``: :func:`_steps`, with ``tmp`` for its
    snapshots). Returns the outputs as numpy arrays."""
    if case["entry"] == "steps":
        return _steps(case, rank, tmp)
    entry, k, kw = case["entry"], case.get("k"), port_kwargs(case.get("kw", {}))
    x = case.get("x")
    if entry == "shard_points_uneven":
        try:
            D.shard_points(np.zeros((case["n"], 2), np.float32))
        except ValueError as e:
            return {"error": np.array(str(e))}
        return {}
    if entry == "backend_mismatch":
        try:
            D.check_backend(None, torch.device("cuda"))
        except ValueError as e:
            return {"error": np.array(str(e))}
        return {}
    x_loc = D.shard_points(x)
    if entry == "component_ids":
        n_comp, ids = D.distributed_component_ids(x_loc, device="cpu", **kw)
        return {"n_components": n_comp.numpy(), "components": ids.numpy()}
    gen = torch.Generator().manual_seed(7)
    draws = dict(u0t=case.get("u0t"), kmeans_init=case.get("init"))
    if entry == "gpic":
        res = D.distributed_gpic(x_loc, k, device="cpu", generator=gen, **draws, **kw)
    elif entry == "matrix_free":
        res = D.distributed_gpic_matrix_free(x_loc, k, device="cpu", generator=gen, **draws,
                                             **kw)
    elif entry == "segments":
        res = _segmented(x_loc, k, kw, case.get("u0t"), case.get("init"), case["split"])
    elif entry == "run_gpic":
        cfg = GPICConfig(mesh=dist.group.WORLD, **kw)
        res = run_gpic(x_loc, k, cfg, device="cpu")
    else:
        raise ValueError(f"unknown case entry {entry!r}")
    return result_to_numpy(res)


def run_rank(rank: int, world: int, store: str, case_file: str, out_dir: str) -> None:
    """Join the gloo group as ``rank`` of ``world`` and run every case."""
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=90))
    with open(case_file, "rb") as f:
        cases = pickle.load(f)
    for name, case in cases.items():
        try:
            out = run_case(case, rank, out_dir)
        except Exception as e:  # recorded, so the other cases still run
            out = {"raised": np.array(f"{type(e).__name__}: {e}")}
        np.savez(os.path.join(out_dir, f"{name}.rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
