"""The production mesh and the per-(arch, cell) logical-axis rules, the port
of ``repro/launch/mesh.py``.

``make_production_mesh`` is a function (importing the module touches no
process group): one pod is a (data=16, model=16) ``DeviceMesh`` of 256
ranks, two pods add a leading "pod" axis, (pod=2, data=16, model=16).

A parameter's placement on a mesh is torch's: one ``Shard(dim)`` or
``Replicate()`` for each mesh dimension, from the spec its logical names
resolve to under the current rules. :func:`local_shard` takes a rank's
block of a full tensor under a placement, as ``distribute_tensor`` lays
it out; the sharded train step runs on such blocks.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..configs.base import ModelConfig, ShapeCell
from ..distributed.sharding import logical_to_spec


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) with "pod"
    first, over the first ranks of the default process group."""
    from torch.distributed.device_mesh import DeviceMesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"production mesh needs {n} ranks, the process group has {have}: start "
            f"{n} processes (one card each) and init_process_group first")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=axes)


def _div(n: int, by: int) -> bool:
    return n > 0 and n % by == 0


def build_rules(cfg: ModelConfig, cell: Optional[ShapeCell] = None,
                *, multi_pod: bool = False,
                model_size: int = 16, data_size: int = 16,
                overrides: Optional[dict] = None) -> dict:
    """Megatron-style logical -> mesh rules, specialized per arch and cell.

    Activation axes ("*_act") map to a mesh axis only where the runtime dim
    divides it; parameter axes are flattened head*dim products. A cell whose
    batch does not divide the data axes idles them for activations and,
    for a decode cell, shards the KV cache's sequence over them instead;
    a decode cell whose KV heads cannot shard over "model" shards the cache
    sequence there (the flash-decoding layout), unless ``REPRO_NAIVE=1``.
    """
    dp = ("pod", "data") if multi_pod else ("data",)
    total_dp = data_size * (2 if multi_pod else 1)

    batch = cell.global_batch if cell else None
    rules: dict = {
        # params
        "layers": None,
        "embed": None,
        "heads": "model",        # flattened n_heads*head_dim param dim
        "kv_heads": "model",     # flattened kv*head_dim param dim
        "mlp": "model",
        "vocab": "model",
        "experts": "model",      # EP
        "expert_mlp": None,
        "ssm_inner": "model",
        "ssm_heads": "model",
        # activations
        "batch": dp,
        "seq": None,
        "cache_seq": None,
        "heads_act": "model" if _div(cfg.n_heads, model_size) else None,
        "kv_heads_act": "model" if _div(cfg.n_kv_heads, model_size) else None,
    }

    if batch is not None and not _div(batch, total_dp):
        rules["batch"] = None
        if cell and cell.kind == "decode":
            rules["cache_seq"] = dp
    naive = os.environ.get("REPRO_NAIVE", "0") == "1"
    if (cell and cell.kind == "decode" and rules["kv_heads_act"] is None
            and not naive):
        cs = rules.get("cache_seq")
        existing = () if cs is None else ((cs,) if isinstance(cs, str) else tuple(cs))
        flat = []
        for a in existing:
            flat.extend(a if isinstance(a, tuple) else (a,))
        rules["cache_seq"] = tuple(flat) + ("model",)
    if overrides:
        rules.update(overrides)
    return rules


def param_shardings(mesh, specs_tree):
    """Logical-spec tree (dicts, and lists as ``specs_like`` gives) -> a tree
    of placements (under the active rules):
    for each leaf, ``Shard(dim)`` on each mesh dimension its resolved spec
    names for ``dim``, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    def placements(spec):
        resolved = logical_to_spec(spec)
        out = []
        for axis in mesh.mesh_dim_names:
            dims = [d for d, a in enumerate(resolved)
                    if a == axis or (isinstance(a, tuple) and axis in a)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return placements(node)

    return walk(specs_tree)


def specs_like(specs, tree):
    """The spec tree ``specs`` laid over the port's tree ``tree``: where the
    reference stacks layers (a "layers" name first) the port keeps a list
    of layers, and each element takes the names after the first."""
    if isinstance(tree, list):
        if specs is None or not _leading_layers(specs):
            raise ValueError("a list of layers needs stacked specs (\"layers\" first)")
        one = _unstack(specs)
        return [specs_like(one, t) for t in tree]
    if isinstance(tree, dict):
        return {k: specs_like(specs[k], v) for k, v in tree.items()}
    return specs


def _leading_layers(specs) -> bool:
    if isinstance(specs, dict):
        return all(_leading_layers(v) for v in specs.values())
    return len(specs) > 0 and specs[0] == "layers"


def _unstack(specs):
    if isinstance(specs, dict):
        return {k: _unstack(v) for k, v in specs.items()}
    return tuple(specs[1:])


def placement_leaves(tree) -> list:
    """The placements of a tree (dicts and lists of placement tuples), in
    the leaf order of ``train/_tree.py`` (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in placement_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in placement_leaves(v)]
    return [tree]


def local_shard(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of ``full`` under ``placements`` (a contiguous
    copy): each ``Shard(dim)`` splits ``dim`` evenly over its mesh
    dimension, in the mesh's order, as ``distribute_tensor`` does. An
    uneven split raises."""
    coord = mesh.get_coordinate()
    out = full
    for j, pl in enumerate(placements):
        if not pl.is_shard():
            continue
        size = mesh.shape[j]
        if out.shape[pl.dim] % size:
            raise ValueError(f"dimension {pl.dim} of {tuple(full.shape)} does not split evenly "
                             f"over the {size} ranks of mesh axis "
                             f"{mesh.mesh_dim_names[j]!r}")
        width = out.shape[pl.dim] // size
        out = out.narrow(pl.dim, coord[j] * width, width)
    return out.contiguous().clone()


def shard_tree(tree, mesh, placements_tree):
    """:func:`local_shard` of each leaf of ``tree`` (dicts and lists) under
    the placements in its place in ``placements_tree``."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, mesh, placements_tree[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [shard_tree(v, mesh, p) for v, p in zip(tree, placements_tree, strict=True)]
    return local_shard(tree, mesh, placements_tree)
