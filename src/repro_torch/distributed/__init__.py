"""Logical-axis sharding rules and the collectives of the sharded LM step."""
from .sharding import (
    axis_rules,
    constrain,
    current_mesh,
    current_rules,
    logical_to_spec,
    naive_mode,
    set_active_mesh,
    set_axis_rules,
)


def shard_points(x, group=None):
    """This rank's row block of the (n, m) features, the GPIC front door
    (``core.distributed.shard_points``; imported at the call, so that the
    rules never pull in the clustering pipeline)."""
    from ..core.distributed import shard_points as _sp
    return _sp(x, group)


__all__ = [
    "axis_rules",
    "constrain",
    "current_mesh",
    "current_rules",
    "logical_to_spec",
    "naive_mode",
    "set_active_mesh",
    "set_axis_rules",
    "shard_points",
]
