"""Logical-axis sharding rules, the port of ``repro/distributed/sharding.py``.

Model code names the axes of its parameters and activations with
*logical* names ("batch", "seq", "embed", "heads", "kv_heads", "mlp",
"vocab", "experts", "layers", ...). A rules table maps each logical name
to mesh axes; ``launch/mesh.py::build_rules`` makes the reference's
Megatron-style tables (batch over ("pod", "data"); heads, kv_heads, mlp,
vocab and experts over "model"). The rules and the active mesh (a
``torch.distributed.device_mesh.DeviceMesh``) are thread-local, as in the
reference, and :func:`axis_rules` sets both for a ``with`` block.

A spec is a plain tuple with one entry per dimension: None, a mesh axis
name, or a tuple of axis names; a mesh axis appears in it at most once.

The reference's GSPMD places the collectives where its ``constrain``
calls meet a layout its operands do not have. The port holds each rank's
local shards instead and puts explicit collectives at those sites
(``distributed/collectives.py``), so :func:`constrain` has no layout to
impose: it is the identity, with rules or without, and checks only that a
tensor has one name per dimension.
"""
from __future__ import annotations

import contextlib
import functools
import os
import threading
from typing import Mapping, Optional, Sequence, Union

MeshAxis = Union[None, str, tuple[str, ...]]

#: where the sharded steps this layout cannot take yet stand
SHARDED_TODO = "ROADMAP queue 1 item 12b.4c"

_state = threading.local()


def set_axis_rules(rules: Optional[Mapping[str, MeshAxis]]) -> None:
    _state.rules = dict(rules) if rules is not None else None


def current_rules() -> Optional[dict[str, MeshAxis]]:
    return getattr(_state, "rules", None)


def naive_mode() -> bool:
    """REPRO_NAIVE=1 disables the beyond-baseline optimizations (grouped-QKV
    attention, flash decoding, expert-parallel MoE), as in the reference."""
    return os.environ.get("REPRO_NAIVE", "0") == "1"


def set_active_mesh(mesh) -> None:
    _state.mesh = mesh


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def axis_rules(rules: Optional[Mapping[str, MeshAxis]], mesh=None):
    """Set the rules (and the mesh, where given) for the block; both are
    restored on exit."""
    prev, prev_mesh = current_rules(), current_mesh()
    set_axis_rules(rules)
    if mesh is not None:
        set_active_mesh(mesh)
    try:
        yield
    finally:
        set_axis_rules(prev)
        set_active_mesh(prev_mesh)


def bind(fn):
    """``fn`` run under the rules and mesh that are current now, on any
    thread: a checkpointed layer is recomputed in the backward, which on
    the card runs on autograd's device thread, where no rules are set."""
    rules, mesh = current_rules(), current_mesh()
    if rules is None and mesh is None:
        return fn

    @functools.wraps(fn)
    def bound(*args, **kwargs):
        with axis_rules(rules, mesh=mesh):
            return fn(*args, **kwargs)

    return bound


def logical_to_spec(names: Sequence[Optional[str]]) -> tuple:
    """Resolve a tuple of logical axis names to a spec under the current
    rules: each name's mesh axes, less those an earlier dimension took."""
    rules = current_rules() or {}
    used: set = set()

    def dedup(axis):
        if axis is None:
            return None
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        keep = tuple(a for a in axes if a not in used)
        used.update(keep)
        if not keep:
            return None
        return keep[0] if len(keep) == 1 else keep

    return tuple(dedup(rules.get(n)) if n is not None else None for n in names)


def constrain(x, *names: Optional[str]):
    """The identity. Under rules, ``x`` must have one name per dimension."""
    if current_rules() is not None and x.ndim != len(names):
        raise ValueError(f"constrain: {len(names)} axis names {names} for a tensor of "
                         f"{x.ndim} dimensions")
    return x


def stacked(specs, *names: Optional[str]):
    """A tree of specs (dicts of tuples of logical names) with ``names``
    put before each leaf's: the specs of a stack of layers, as the
    reference's ``jax.tree.map(lambda s: ("layers",) + s, ...)``."""
    if isinstance(specs, dict):
        return {k: stacked(v, *names) for k, v in specs.items()}
    return tuple(names) + tuple(specs)
