"""The collectives of the sharded LM steps, each an autograd function with
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
  gather_summed  all-gather forward along a dimension, the all-reduced
           gradient's slice backward: a tensor every rank then uses whole
           or in parts of its own, each toward its own part of the loss
           (the moe layer's rows under ``REPRO_NAIVE=1``; the mamba
           block's ``in_proj`` output and conv weights, whose shards are
           contiguous slices of z | x | B | C | dt, not the rank's heads)
  all_sum  all-reduce forward and backward: a partial sum that every rank
           then uses whole, each toward its own part of the loss (the
           mamba block's gated norm, over the rank's columns of d_inner)
  mean     all-reduce forward divided by the group's size, identity
           backward: the moe aux loss averaged over "data", which each
           rank's loss counts once and the step's gradients average
  all_max  all-reduce max, no backward: the flash decode's row maxima

:func:`group` names the process group of a logical axis under the current
rules and mesh: None without rules or a mesh, for an axis the rules leave
unsharded, or over mesh axes of one rank, where every function here is
the identity and adds no operation. "data", "model" and both (the whole
mesh, data-major) have groups; :func:`axis_index` is this rank's place
along such axes, as the reference's ``jax.lax.axis_index``.
:func:`local_zeros` makes a sharded prefill's empty cache shard.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .sharding import SHARDED_TODO, current_mesh, current_rules

MESH_AXES = ("data", "model")


def mesh_axes(name: str) -> tuple:
    """The mesh axes the rules map logical axis ``name`` to, as a tuple
    (() without rules or for an unsharded axis)."""
    axis = (current_rules() or {}).get(name)
    if axis in (None, ()):
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def group_of(axes: tuple):
    """The process group over mesh ``axes`` (a tuple in the mesh's order),
    or None where there is no mesh or the axes hold one rank. Axes the
    ("data", "model") mesh does not have, in another order, raise."""
    mesh = current_mesh()
    if mesh is None or not axes:
        return None
    names = tuple(mesh.mesh_dim_names)
    if names != MESH_AXES or len(set(axes)) != len(axes) or any(a not in names for a in axes) \
            or list(axes) != sorted(axes, key=names.index):
        raise NotImplementedError(f"the sharded LM steps take axes of a ('data', 'model') "
                                  f"mesh in its order, not {axes!r} on {names} ({SHARDED_TODO})")
    if axis_size(axes) == 1:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if not torch.equal(mesh.mesh.flatten().cpu(), torch.arange(dist.get_world_size())):
        raise NotImplementedError(f"the whole-mesh group needs a mesh of the process group's "
                                  f"ranks in order ({SHARDED_TODO})")
    return dist.group.WORLD


def group(name: str):
    """The process group ``name`` is sharded over, or None (see above)."""
    if current_rules() is None or current_mesh() is None:
        return None
    return group_of(mesh_axes(name))


def axis_index(axes: tuple) -> int:
    """This rank's index along mesh ``axes``, the first the slowest (0
    without a mesh)."""
    mesh = current_mesh()
    if mesh is None:
        return 0
    coord, names, idx = mesh.get_coordinate(), tuple(mesh.mesh_dim_names), 0
    for a in axes:
        j = names.index(a)
        idx = idx * mesh.shape[j] + coord[j]
    return idx


def axis_size(axes: tuple) -> int:
    """The ranks along mesh ``axes`` (1 without a mesh)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    return math.prod(mesh.shape[tuple(mesh.mesh_dim_names).index(a)] for a in axes)


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


class _GatherSummed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp, dim):
        ctx.grp, ctx.dim, ctx.width = grp, dim, x.shape[dim]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(dist.get_world_size(grp))]
        dist.all_gather(parts, x.contiguous(), group=grp)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.grp)
        lo = dist.get_rank(ctx.grp) * ctx.width
        # contiguous: a leaf's gradient is all-reduced in place over "data" next
        return g.narrow(ctx.dim, lo, ctx.width).contiguous(), None, None


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        out = x.contiguous().clone()
        dist.all_reduce(out, group=grp)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.grp)
        return g, None


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=grp)
        return out / dist.get_world_size(grp)

    @staticmethod
    def backward(ctx, g):
        return g, None


def enter(x, grp):
    return x if grp is None else _Enter.apply(x, grp)


def reduce(x, grp):
    return x if grp is None else _Reduce.apply(x, grp)


def gather(x, grp, dim: int = -1):
    return x if grp is None else _Gather.apply(x, grp, dim % x.ndim)


def gather_summed(x, grp, dim: int = -1):
    return x if grp is None else _GatherSummed.apply(x, grp, dim % x.ndim)


def all_sum(x, grp):
    return x if grp is None else _AllSum.apply(x, grp)


def mean(x, grp):
    return x if grp is None else _Mean.apply(x, grp)


def all_max(x, grp):
    if grp is None:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=grp)
    return out


def rank(grp) -> int:
    return 0 if grp is None else dist.get_rank(grp)


def spec_axes(entry) -> tuple:
    """A resolved spec entry (None, an axis name or a tuple of them) as a
    tuple of mesh axes."""
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def local_zeros(tree, specs, device):
    """Zeros of each leaf's shape in ``tree`` (meta tensors; dicts), cut to
    this rank's shard under the current rules and mesh: each dimension
    split by the mesh axes its logical name in ``specs`` resolves to,
    except "batch", whose rows the caller has cut already. Without rules
    or a mesh, the whole shapes. A dimension the axes do not divide
    raises, naming 12b.4c."""
    from .sharding import logical_to_spec
    if isinstance(tree, dict):
        return {k: local_zeros(v, specs[k], device) for k, v in tree.items()}
    shape = list(tree.shape)
    if current_rules() is not None and current_mesh() is not None:
        for dim, (name, axes) in enumerate(zip(specs, logical_to_spec(specs))):
            n = axis_size(spec_axes(axes))
            if name == "batch" or n == 1:
                continue
            if shape[dim] % n:
                raise NotImplementedError(f"a cache dimension of {shape[dim]} ({name}) over "
                                          f"{n} ranks ({SHARDED_TODO})")
            shape[dim] //= n
    return torch.zeros(shape, dtype=tree.dtype, device=device)


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
