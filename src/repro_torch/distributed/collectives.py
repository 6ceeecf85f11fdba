"""The collectives of the sharded LM step, each an autograd function with
its backward written out.

Each rank holds its local shards of the parameters, placed by
``launch/mesh.py::param_shardings``, and the layers call these at the
reference's ``constrain`` sites (Megatron's tensor parallelism over the
mesh's "model" axis):

  enter    identity forward, all-reduce backward: the input of a
           column-parallel product (wq, wk, wv, wg, wu, the LM head), whose
           gradient each rank holds only in part
  reduce   all-reduce forward, identity backward: the output of a
           row-parallel product (wo, wd) or of the vocab-sharded lookup
  gather   all-gather forward along a dimension, this rank's slice
           backward: the vocab-sharded logits, which every rank then reads
           whole and alike

:func:`group` names the process group of a logical axis under the current
rules and mesh: None without rules or a mesh, for an axis the rules leave
unsharded, or over a mesh axis of one rank, where every function here is
the identity and adds no operation.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .sharding import SHARDED_TODO, current_mesh, current_rules


def group(name: str):
    """The process group ``name`` is sharded over, or None (see above).
    A rule other than None or the mesh's "model" axis raises."""
    rules, mesh = current_rules(), current_mesh()
    if rules is None or mesh is None:
        return None
    axis = rules.get(name)
    if axis in (None, ()):
        return None
    if axis not in ("model", ("model",)):
        raise NotImplementedError(
            f"the sharded LM step takes {name!r} over the mesh's 'model' axis or "
            f"unsharded, not {axis!r} ({SHARDED_TODO})")
    if mesh.shape[mesh.mesh_dim_names.index("model")] == 1:
        return None
    return mesh.get_group("model")


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.grp)
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=grp)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp, dim):
        ctx.grp, ctx.dim, ctx.width = grp, dim, x.shape[dim]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(dist.get_world_size(grp))]
        dist.all_gather(parts, x.contiguous(), group=grp)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        lo = dist.get_rank(ctx.grp) * ctx.width
        return g.narrow(ctx.dim, lo, ctx.width), None, None


def enter(x, grp):
    return x if grp is None else _Enter.apply(x, grp)


def reduce(x, grp):
    return x if grp is None else _Reduce.apply(x, grp)


def gather(x, grp, dim: int = -1):
    return x if grp is None else _Gather.apply(x, grp, dim % x.ndim)


def rank(grp) -> int:
    return 0 if grp is None else dist.get_rank(grp)


def vocab_embedding(tokens, table, grp):
    """``F.embedding(tokens, table)`` of a table sharded by rows over
    ``grp``: each rank looks up the tokens in its rows (the others give
    zero rows) and the ranks' rows are summed, the one nonzero term of each
    sum exact. Its backward is ``F.embedding``'s, fixed in order, over the
    rank's own rows."""
    if grp is None:
        return F.embedding(tokens, table)
    rows = table.shape[0]
    local = tokens - rank(grp) * rows
    away = (local < 0) | (local >= rows)
    out = F.embedding(local.masked_fill(away, 0), table)
    return reduce(out.masked_fill(away[..., None], 0.0), grp)
