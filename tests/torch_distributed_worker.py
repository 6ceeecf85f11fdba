"""One rank of the port's sharded engines on a gloo group, for
``tests/test_torch_distributed.py``.

``run_rank`` is the body ``torch.multiprocessing.spawn`` runs in each
process: it joins the group through a file store, runs every case of a
pickled case file on this rank's row block of the case's features, and
writes each case's outputs, as numpy, to ``<out_dir>/<case>.rank<r>.npz``.
A case that raises on every rank records its message and the next case
runs; a collective that one rank never reaches ends in the group's
timeout. It imports torch, numpy and the port, nothing of JAX.
"""
from __future__ import annotations

import datetime
import os
import pickle

import numpy as np
import torch

torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

from repro_torch.core import AffinitySpec, GPICConfig, run_gpic  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.interop import result_to_numpy  # noqa: E402


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
    steps of ``split`` to max_iter, then the close."""
    kw = dict(kw)
    max_iter = kw.pop("max_iter")
    probe = kw.pop("probe_components", True)
    gen = torch.Generator().manual_seed(7)
    carry, iso = D.distributed_gpic_segment_start(x_loc, split, device="cpu", generator=gen,
                                                  u0t=u0t, **kw)
    while int(carry.t) < max_iter and not bool(carry.done.all()):
        carry = D.distributed_gpic_segment(x_loc, carry, min(int(carry.t) + split, max_iter),
                                           device="cpu", **kw)
    kw.pop("n_vectors", None)
    return D.distributed_gpic_segment_finalize(x_loc, carry, iso, k, device="cpu",
                                               generator=gen, kmeans_init=init,
                                               probe_components=probe, **kw)


def run_case(case: dict) -> dict:
    """One case on this rank: its entry point on the rank's block of the
    case's features. Returns the outputs as numpy arrays."""
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
            out = run_case(case)
        except Exception as e:  # recorded, so the other cases still run
            out = {"raised": np.array(f"{type(e).__name__}: {e}")}
        np.savez(os.path.join(out_dir, f"{name}.rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
