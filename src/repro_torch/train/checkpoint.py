"""Snapshots of the power loop's carry: atomic, checksummed, async.

Layout: a snapshot is a directory

    step_000123/
        manifest.json   step, each leaf's name, dtype, shape and crc32, extra
        <name>.npy      one file per leaf (a dataclass field or a dict key)

Leaves are named by field (``PowerCarry``'s ``t``, ``v``, ``delta``, ...),
so a restore matches them by name against the structure it is given. A
save writes a ``.tmp`` directory and renames it into place, so a failure
mid-save never corrupts the newest snapshot; each leaf's CRC32 is checked
on restore, and a snapshot that fails is quarantined (renamed out of the
``step_`` namespace, its bytes kept) while the restore falls back to the
previous one. bf16 leaves are stored as their uint16 bits.

A sharded run (a ``torch.distributed`` process group, each rank holding a
row block) snapshots the global tree, in the layout a one-device run
writes: :func:`gather_rows` gathers the row leaves, and rank 0 alone
writes. The restore onto a group (``group=``, the reference's ``mesh`` and
``specs``) reads and checks on rank 0 alone, which broadcasts what it
found; each rank keeps its rows of the leaves named in ``row_leaves`` and
the others whole. So a snapshot written on P ranks resumes on any number
of ranks, or on one device.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.health import CheckpointCorruptError
from ..core.operators import group_layout, mesh_reductions


def _leaves(tree) -> dict:
    """The named leaves of a dataclass of tensors, or of a dict."""
    if isinstance(tree, dict):
        return dict(tree)
    return {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(host array, logical dtype name) of a tensor; a bf16 tensor becomes
    its uint16 bits (numpy has no bf16)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def _leaf_crc(arr: np.ndarray) -> int:
    """CRC32 of a leaf's raw bytes: the integrity check kept in the
    manifest and checked again on restore."""
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def save(path: str, tree: Any, *, step: int, extra: Optional[dict] = None) -> None:
    """Write ``tree`` (a dataclass or a dict of tensors) as the snapshot
    ``path``, atomically."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": int(step), "leaves": [], "extra": extra or {}}
    for name, leaf in _leaves(tree).items():
        arr, dtype = _to_numpy(leaf)
        np.save(os.path.join(tmp, f"{name}.npy"), arr)
        manifest["leaves"].append({"name": name, "dtype": dtype, "shape": list(arr.shape),
                                   "crc32": _leaf_crc(arr)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


class AsyncCheckpointer:
    """Double-buffered saver: each save waits for the previous one, copies
    the leaves to the host on the caller's thread (a consistent snapshot),
    and writes them on a daemon thread."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, path: str, tree: Any, *, step: int,
                   extra: Optional[dict] = None) -> None:
        self.wait()
        host = {name: leaf.detach().to("cpu", copy=True) for name, leaf in _leaves(tree).items()}
        self._thread = threading.Thread(
            target=save, args=(path, host), kwargs=dict(step=step, extra=extra), daemon=True)
        self._thread.start()


def _tree_like(like, leaves: dict):
    """``leaves`` in the structure of ``like``: a dict, or ``like``'s type."""
    return leaves if isinstance(like, dict) else type(like)(**leaves)


def gather_rows(tree: Any, row_leaves, group) -> Any:
    """The global tree of a sharded one: each leaf named in ``row_leaves``
    (this rank's (n/P, ...) rows) all-gathered over ``group`` in rank order,
    the others (replicated) as they are. A collective: every rank calls it
    and gets the same tree."""
    gather = mesh_reductions(group)[2]
    return _tree_like(tree, {name: gather(leaf) if name in row_leaves else leaf
                             for name, leaf in _leaves(tree).items()})


def _on_rank0(group, fn):
    """``fn()`` run on ``group``'s rank 0 alone, its value broadcast to every
    rank (one collective), or the CheckpointCorruptError it raised, raised
    on every rank."""
    box = [None]
    if group_layout(group)[0] == 0:
        try:
            box[0] = (True, fn())
        except CheckpointCorruptError as e:
            box[0] = (False, str(e))
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0), group=group)
    ok, value = box[0]
    if not ok:
        raise CheckpointCorruptError(value)
    return value


def _keep_rows(tree: Any, row_leaves, group, device) -> Any:
    """This rank's tree from a global one: its rows of the ``row_leaves``
    (rank n/P to (rank + 1) n/P), the others whole, on ``device``."""
    rank, p = group_layout(group)
    out = {}
    for name, leaf in _leaves(tree).items():
        if name in row_leaves:
            if leaf.shape[0] % p:
                raise CheckpointCorruptError(
                    f"leaf {name}: {leaf.shape[0]} rows do not divide over {p} ranks")
            n_loc = leaf.shape[0] // p
            leaf = leaf[rank * n_loc:(rank + 1) * n_loc]
        out[name] = leaf.to(device)
    return _tree_like(tree, out)


def _read_manifest(path: str) -> dict:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(f"checkpoint {path}: unreadable manifest ({e})") from e


def restore(path: str, like: Any, *, device="cpu", group=None, row_leaves=()):
    """Restore the snapshot ``path`` into the structure of ``like`` (a
    dataclass or dict of tensors, e.g. on the ``meta`` device, whose names,
    shapes and dtypes each leaf must match), on ``device``. Returns
    ``(tree, step)``; raises :class:`CheckpointCorruptError` for a missing,
    truncated or mismatched leaf, a checksum mismatch or an unreadable
    manifest.

    With ``group`` (a process group; every rank calls it) rank 0 alone
    reads and checks the global snapshot and broadcasts it; each rank
    returns its rows of the leaves named in ``row_leaves`` and the others
    whole, and every rank raises where rank 0's checks fail."""
    if group is not None:
        tree, step = _on_rank0(group, lambda: restore(path, like))
        return _keep_rows(tree, row_leaves, group, device), step
    manifest = _read_manifest(path)
    want = _leaves(like)
    entries = {e["name"]: e for e in manifest.get("leaves", [])}
    if set(entries) != set(want):
        raise CheckpointCorruptError(
            f"checkpoint {path}: leaves {sorted(entries)}, expected {sorted(want)}")
    out = {}
    for name, ref in want.items():
        entry = entries[name]
        try:
            arr = np.load(os.path.join(path, f"{name}.npy"))
        except (OSError, ValueError, EOFError) as e:
            raise CheckpointCorruptError(
                f"checkpoint {path}: leaf {name} missing or truncated ({e})") from e
        if _leaf_crc(arr) != entry["crc32"]:
            raise CheckpointCorruptError(
                f"checkpoint {path}: leaf {name} checksum mismatch "
                f"(stored crc32={entry['crc32']})")
        if tuple(arr.shape) != tuple(ref.shape):
            raise CheckpointCorruptError(
                f"checkpoint {path}: leaf {name} shape {arr.shape} != expected "
                f"{tuple(ref.shape)}")
        t = torch.from_numpy(arr)
        if entry["dtype"] == "bfloat16":
            t = t.view(torch.int16).view(torch.bfloat16)
        out[name] = t.to(device=device, dtype=ref.dtype)
    return _tree_like(like, out), manifest["step"]


def latest_step(root: str) -> Optional[str]:
    """The newest ``step_*`` snapshot directory under ``root`` (None if
    there is none)."""
    if not os.path.isdir(root):
        return None
    steps = sorted(d for d in os.listdir(root)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    return os.path.join(root, steps[-1]) if steps else None


def manifest_extra(path: str, *, group=None) -> dict:
    """The ``extra`` dict a snapshot was saved with (raises
    :class:`CheckpointCorruptError` on an unreadable manifest). With
    ``group``, rank 0 reads it and every rank returns it."""
    if group is not None:
        return _on_rank0(group, lambda: manifest_extra(path))
    return _read_manifest(path).get("extra", {})


def quarantine(path: str) -> str:
    """Rename a corrupt snapshot so that :func:`latest_step` skips it,
    keeping its bytes. Returns the new path."""
    root, name = os.path.split(path)
    dst = os.path.join(root, "corrupt_" + name)
    if os.path.exists(dst):
        shutil.rmtree(dst)
    os.replace(path, dst)
    return dst


def restore_latest_valid(root: str, like: Any, *, device="cpu", group=None, row_leaves=()):
    """Restore the newest snapshot under ``root`` that passes its checks,
    quarantining each corrupt one on the way: the supervisor's resume.
    Returns ``(tree, step, path, skipped)``, ``skipped`` the quarantined
    snapshots (their original paths, newest first); ``(None, None, None,
    skipped)`` when no valid snapshot is left.

    With ``group`` rank 0 alone resolves the snapshot and quarantines, and
    broadcasts the outcome; every rank returns the same step, path and
    skipped list, and its tree as :func:`restore` gives it."""
    if group is not None:
        tree, step, path, skipped = _on_rank0(group, lambda: restore_latest_valid(root, like))
        if tree is not None:
            tree = _keep_rows(tree, row_leaves, group, device)
        return tree, step, path, skipped
    skipped: list[str] = []
    while True:
        path = latest_step(root)
        if path is None:
            return None, None, None, skipped
        try:
            tree, step = restore(path, like, device=device)
            return tree, step, path, skipped
        except CheckpointCorruptError:
            skipped.append(path)
            quarantine(path)
