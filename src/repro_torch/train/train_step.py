"""The train step and the serve steps, the port of
``repro/train/train_step.py``.

``build_train_step(cfg, tcfg)`` returns
    (params, opt_state, batch) -> (params, opt_state, metrics)
The gradients come from ``torch.autograd.grad`` over the parameter leaves
(:func:`value_and_grad`); with ``tcfg.microbatch`` > 1 the batch is split
into that many slices whose gradients are summed in order and scaled by
1/n, as the reference's scan does (activation memory ∝ one microbatch).
The AdamW update runs in place under ``torch.no_grad()``, so the returned
parameters and state are the tensors passed in, updated. The serve steps
are used by launch/serve.py.

Called under ``axis_rules(rules, mesh=mesh)`` with a ("data", "model")
``DeviceMesh``, the step is sharded, as the reference's ``jax.jit`` of it
is under the same context: each rank passes its local shards of the
parameters and of the AdamW moments (``launch/mesh.py``'s
``param_shardings`` and ``shard_tree``) and the global batch, of which it
reads its rows of the "data" axis. The layers run tensor-parallel over
"model" (``distributed/collectives.py``), the gradients are averaged over
"data", and the clipping norm sums the sharded leaves over "model". A
mesh of one rank is the one-device step, bit for bit. Every family is
routed; rules and widths this layout cannot take raise
``NotImplementedError`` on every rank before any collective. The moe
family's aux loss is the mean of each data shard's (the reference's
``pmean`` over "batch"), so over more than one data rank its step is one
device's step with ``microbatch`` equal to the data ranks.

The serve steps (:func:`build_prefill`, :func:`build_decode_step`) are
sharded the same way under the rules and a mesh, for every family
(ROADMAP 12b.4b, 12b.4c.1): the rank's rows of the global batch, its
shards of the parameters and of the cache, the logits gathered whole.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..configs.base import ModelConfig, TrainConfig
from ..distributed import collectives as C
from ..distributed.sharding import (SHARDED_TODO, axis_rules, current_mesh, current_rules,
                                    logical_to_spec)
from ..models import get_api
from ._tree import leaves, tree_map, unflatten
from .compression import compress_decompress
from .optimizer import adamw_update

def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def softmax_xent(logits, labels, z_loss=0.0):
    """Mean token cross-entropy (+ z-loss) in f32. logits (b, s, v)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = torch.mean(lse - ll)
    if z_loss:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss


def loss_fn(params, cfg: ModelConfig, batch, tcfg: TrainConfig):
    """(loss, {"xent", "aux"}): the token cross-entropy, plus for the moe
    family the router's load-balancing loss summed over its moe layers
    (the other families have none: aux 0.0)."""
    kw = dict(compute_dtype=_dtype(tcfg.compute_dtype), remat=tcfg.remat)
    api = get_api(cfg)
    if cfg.family == "moe":
        logits, aux = api.forward(params, cfg, batch, return_aux=True, **kw)
    else:
        logits, aux = api.forward(params, cfg, batch, **kw), 0.0
    loss = softmax_xent(logits, batch["labels"], tcfg.z_loss)
    return loss + aux, {"xent": loss, "aux": aux}


def value_and_grad(params, cfg: ModelConfig, batch, tcfg: TrainConfig):
    """(loss, gradients in the parameters' tree), the gradients from
    ``torch.autograd.grad`` over detached views of the leaves (the caller's
    tensors need no ``requires_grad``)."""
    live = [p.detach().requires_grad_() for p in leaves(params)]
    loss, _ = loss_fn(unflatten(params, live), cfg, batch, tcfg)
    grads = torch.autograd.grad(loss, live)
    return loss.detach(), unflatten(params, list(grads))


def _split_microbatches(batch, n):
    def f(x):
        b = x.shape[0]
        assert b % n == 0, f"batch {b} not divisible by microbatch {n}"
        return x.reshape(n, b // n, *x.shape[1:])
    return {key: f(x) for key, x in batch.items()}


@dataclass
class _Layout:
    """The sharded step's groups (None where the mesh axis has one rank)
    and which parameter leaves are split over "model"."""
    data: object
    data_rank: int
    data_size: int
    model: object
    sharded: list

    def local_batch(self, batch):
        def rows(x):
            if x.shape[0] % self.data_size:
                raise NotImplementedError(
                    f"a batch of {x.shape[0]} rows over {self.data_size} data ranks "
                    f"({SHARDED_TODO})")
            n = x.shape[0] // self.data_size
            return x.narrow(0, self.data_rank * n, n)
        return {k: rows(x) for k, x in batch.items()}

    def average(self, loss, grads):
        if self.data is None:
            return loss, grads
        inv = 1.0 / self.data_size
        for g in leaves(grads):
            dist.all_reduce(g, group=self.data)
            g.mul_(inv)
        loss = loss.clone()
        dist.all_reduce(loss, group=self.data)
        return loss * inv, grads


def _axis(rules, name):
    a = rules.get(name)
    return None if a in (None, ()) else (a,) if isinstance(a, str) else tuple(a)


def _unsupported(why: str):
    return NotImplementedError(f"the sharded train step {why} ({SHARDED_TODO})")


def sharded_layout(cfg: ModelConfig, tcfg: TrainConfig, params, opt_state=None):
    """The step's layout under the current rules and mesh (None without
    them: one device). Everything it checks is local, so a rule or a
    width it cannot take raises on every rank before any collective."""
    rules, mesh = current_rules(), current_mesh()
    if rules is None or mesh is None:
        return None
    if tuple(mesh.mesh_dim_names) != ("data", "model"):
        raise _unsupported(f"takes a ('data', 'model') mesh, not {mesh.mesh_dim_names}")
    size = dict(zip(mesh.mesh_dim_names, mesh.shape))
    for name in ("layers", "embed", "seq"):
        if _axis(rules, name) is not None:
            raise _unsupported(f"keeps {name!r} unsharded; the rules give {rules[name]!r}")
    if _axis(rules, "batch") not in (None, ("data",)):
        raise _unsupported(f"takes 'batch' over 'data', not {rules['batch']!r}")
    if _axis(rules, "batch") is None and size["data"] > 1:
        raise _unsupported("needs 'batch' over a data axis wider than one rank")
    for name in ("mlp", "vocab", "experts", "ssm_inner", "ssm_heads"):
        if _axis(rules, name) not in (None, ("model",)):
            raise _unsupported(f"takes {name!r} over 'model' or unsharded, not {rules[name]!r}")
    if _axis(rules, "expert_mlp") is not None:
        raise _unsupported(f"keeps 'expert_mlp' unsharded; the rules give {rules['expert_mlp']!r}")
    if _axis(rules, "ssm_inner") != _axis(rules, "ssm_heads"):
        raise _unsupported(f"shards 'ssm_inner' as 'ssm_heads': the rules give "
                           f"{rules.get('ssm_inner')!r} and {rules.get('ssm_heads')!r}")
    _check_head_rules(cfg, rules, _unsupported)
    m = size["model"]
    for name, width in _widths(cfg):
        if _axis(rules, name) and width % m:
            raise _unsupported(f"splits {name} ({width}) evenly over 'model' ({m} ranks)")
    if tcfg.gradient_compression and m > 1:
        raise _unsupported("compresses gradients only over 'data'")

    placements, want = _expected_layout(cfg, tuple(sorted(rules.items())),
                                        tuple(mesh.mesh_dim_names), tuple(mesh.shape))
    got = {"parameter": params}
    if opt_state is not None:
        got.update(first_moment=opt_state.mu, second_moment=opt_state.nu)
    for what, tree in got.items():
        shapes = tuple(tuple(t.shape) for t in leaves(tree))
        if shapes != want:
            bad = next((i for i, (a, b) in enumerate(zip(shapes, want)) if a != b), None)
            if bad is None:
                raise ValueError(f"the {what} tree has {len(shapes)} leaves on this rank; "
                                 f"{cfg.arch_id}'s has {len(want)}")
            raise ValueError(f"{what} leaf {bad} is {shapes[bad]} on this rank; its placement "
                             f"on the mesh {size} gives {want[bad]}")
    coord = mesh.get_coordinate()
    data = mesh.get_group("data") if size["data"] > 1 else None
    return _Layout(data=data, data_rank=coord[0], data_size=size["data"],
                   model=mesh.get_group("model") if m > 1 else None,
                   sharded=[any(p.is_shard() for p in pl) for pl in placements])


def _check_head_rules(cfg: ModelConfig, rules, refuse):
    """The attention's rules both steps take (mamba2 has none): "heads"
    and "kv_heads" (wq's and wk's, wv's flat columns) and their
    activations' "heads_act" and "kv_heads_act" each over "model" or
    unsharded; an activation sharded only with its parameter axis (a
    replicated wk, wv excepted: each rank takes its KV heads' columns)
    and the KV heads' only with the query heads'. ``refuse(why)`` makes
    the error."""
    if not cfg.n_heads:
        return
    for name in ("heads", "kv_heads", "heads_act", "kv_heads_act"):
        if _axis(rules, name) not in (None, ("model",)):
            raise refuse(f"takes {name!r} over 'model' or unsharded, not {rules[name]!r}")
    if _axis(rules, "heads_act") and not _axis(rules, "heads"):
        raise refuse("shards 'heads_act' only with 'heads'")
    if _axis(rules, "kv_heads") and not _axis(rules, "heads"):
        raise refuse("shards the KV heads only with the query heads")
    if _axis(rules, "kv_heads_act") and not _axis(rules, "heads_act"):
        raise refuse("shards 'kv_heads_act' only with 'heads_act'")


def _widths(cfg: ModelConfig) -> list:
    """(logical axis, a width of ``cfg`` it splits) for the widths the
    "model" axis must divide in the train and the serve steps alike: wq's
    and wk's, wv's flat columns (MLA's heads whole), the head counts
    where their activations are sharded, the MLPs (moe's shared experts
    too), the vocab, the routed experts, and the mamba block's SSM heads
    and the two widths its contiguous "ssm_inner" shards slice (in_proj's
    z | x | B | C | dt, conv_w's x | B | C, also the conv cache's
    width)."""
    hd = cfg.resolved_head_dim
    if cfg.mla is not None:
        widths = [("heads", cfg.n_heads)]
    else:
        widths = [("heads", cfg.n_heads * hd), ("kv_heads", cfg.n_kv_heads * hd),
                  ("heads_act", cfg.n_heads), ("kv_heads_act", cfg.n_kv_heads)]
    widths += [("mlp", cfg.d_ff), ("vocab", cfg.vocab_padded)]
    if cfg.moe is not None:
        widths += [("experts", cfg.moe.n_experts),
                   ("mlp", cfg.moe.d_ff_expert * cfg.moe.n_shared_experts)]
    if cfg.ssm is not None:
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        h = d_inner // s.head_dim
        widths += [("ssm_heads", h), ("ssm_inner", 2 * d_inner + 2 * s.d_state + h),
                   ("ssm_inner", d_inner + 2 * s.d_state)]
    return widths


@functools.lru_cache(maxsize=16)
def _expected_layout(cfg, rules_items, dim_names, mesh_shape):
    """(each parameter leaf's placements, its local shape) under the rules
    on a mesh of these dimensions; kept, so a step pays for it once."""
    from ..launch.mesh import param_shardings, placement_leaves, specs_like

    class Dims:
        mesh_dim_names = dim_names

    api = get_api(cfg)
    full = api.init_params(None, cfg)
    with axis_rules(dict(rules_items)):
        placements = placement_leaves(param_shardings(Dims, specs_like(api.param_specs(cfg),
                                                                       full)))
    shapes = ()
    for t, pl in zip(leaves(full), placements):
        shape = list(t.shape)
        for j, p in enumerate(pl):
            if p.is_shard():
                shape[p.dim] //= mesh_shape[j]
        shapes += (tuple(shape),)
    return tuple(placements), shapes


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    def train_step(params, opt_state, batch):
        layout = sharded_layout(cfg, tcfg, params, opt_state)
        if layout is not None:
            batch = layout.local_batch(batch)
        if tcfg.microbatch and tcfg.microbatch > 1:
            mb = _split_microbatches(batch, tcfg.microbatch)
            gsum, lsum = None, 0.0
            for i in range(tcfg.microbatch):
                loss, g = value_and_grad(params, cfg, {key: x[i] for key, x in mb.items()},
                                         tcfg)
                gsum = g if gsum is None else tree_map(torch.Tensor.add_, gsum, g)
                lsum = lsum + loss
            inv = 1.0 / tcfg.microbatch
            grads = tree_map(lambda g: g.mul_(inv), gsum)
            loss = lsum * inv
        else:
            loss, grads = value_and_grad(params, cfg, batch, tcfg)
        if layout is not None:
            loss, grads = layout.average(loss, grads)

        if tcfg.gradient_compression:
            grads, _ = compress_decompress(grads)
        kw = {} if layout is None else dict(sharded=layout.sharded, group=layout.model)
        params, opt_state, om = adamw_update(params, grads, opt_state, tcfg, **kw)
        return params, opt_state, {"loss": loss, **om}

    return train_step


# ---------------------------------------------------------------------------
# serve steps (used by launch/serve.py)
# ---------------------------------------------------------------------------


@dataclass
class _ServeLayout:
    """The sharded serve steps' rows: the rank's rows of the global batch
    where "batch" is sharded over "data" (data None: every rank reads
    every row), and the mesh's axis sizes."""
    data: object
    data_rank: int
    data_size: int
    size: dict

    def rows(self, x):
        n = x.shape[0] // self.data_size
        return x.narrow(0, self.data_rank * n, n)

    def gather(self, x):
        return C.gather(x, self.data, 0)


def _serve_layout(cfg: ModelConfig, params, b: int, what: str, max_len=None):
    """The sharded serve step's layout under the current rules and mesh
    (None without them: one device), the counterpart of
    :func:`sharded_layout`: the rules, the widths the "model" axis must
    divide, the batch's rows, a new cache's ``max_len`` positions (a
    prefill's) split evenly over "cache_seq", and each parameter leaf
    this rank's shard. Everything it reads is local, so what it refuses
    raises on every rank before any collective, naming 12b.4c."""
    rules, mesh = current_rules(), current_mesh()
    if rules is None or mesh is None:
        return None

    def refuse(why):
        return NotImplementedError(f"the sharded {what} {why} ({SHARDED_TODO})")

    if tuple(mesh.mesh_dim_names) != ("data", "model"):
        raise refuse(f"takes a ('data', 'model') mesh, not {mesh.mesh_dim_names}")
    size = dict(zip(mesh.mesh_dim_names, mesh.shape))
    for name in ("layers", "embed", "seq", "expert_mlp"):
        if _axis(rules, name) is not None:
            raise refuse(f"keeps {name!r} unsharded; the rules give {rules[name]!r}")
    batch = _axis(rules, "batch")
    if batch not in (None, ("data",)):
        raise refuse(f"takes 'batch' over 'data' or unsharded, not {rules['batch']!r}")
    for name in ("mlp", "vocab", "experts", "ssm_inner", "ssm_heads"):
        if _axis(rules, name) not in (None, ("model",)):
            raise refuse(f"takes {name!r} over 'model' or unsharded, not {rules[name]!r}")
    if _axis(rules, "ssm_inner") != _axis(rules, "ssm_heads"):
        raise refuse(f"shards 'ssm_inner' as 'ssm_heads': the rules give "
                     f"{rules.get('ssm_inner')!r} and {rules.get('ssm_heads')!r}")
    _check_head_rules(cfg, rules, refuse)
    seq = _axis(rules, "cache_seq") or ()
    if seq not in ((), ("data",), ("model",), ("data", "model")):
        raise refuse(f"shards 'cache_seq' over ('data',), ('model',) or ('data', 'model'), "
                     f"not {rules['cache_seq']!r}")
    m = size["model"]
    for name, width in _widths(cfg):
        if _axis(rules, name) and width % m:
            raise refuse(f"splits {name} ({width}) evenly over 'model' ({m} ranks)")
    if batch and b % size["data"]:
        raise refuse(f"splits a batch of {b} rows over {size['data']} data ranks")
    n = math.prod(size[a] for a in seq)
    if max_len is not None and max_len % n and any(
            "cache_seq" in spec for spec in _named(get_api(cfg).cache_specs(cfg)).values()):
        raise refuse(f"splits a cache of {max_len} positions evenly over 'cache_seq' "
                     f"({n} ranks)")

    _, want = _expected_layout(cfg, tuple(sorted(rules.items())),
                               tuple(mesh.mesh_dim_names), tuple(mesh.shape))
    shapes = tuple(tuple(t.shape) for t in leaves(params))
    if shapes != want:
        bad = next((i for i, (a, w) in enumerate(zip(shapes, want)) if a != w), None)
        if bad is None:
            raise ValueError(f"the parameter tree has {len(shapes)} leaves on this rank; "
                             f"{cfg.arch_id}'s has {len(want)} ({SHARDED_TODO})")
        raise ValueError(f"parameter leaf {bad} is {shapes[bad]} on this rank; its placement "
                         f"on the mesh {size} gives {want[bad]} ({SHARDED_TODO})")
    data = mesh.get_group("data") if batch and size["data"] > 1 else None
    return _ServeLayout(data=data, data_rank=mesh.get_coordinate()[0] if batch else 0,
                        data_size=size["data"] if batch else 1, size=size)


def decode_layout(cfg: ModelConfig, params, cache, tokens):
    """The sharded decode step's layout (:func:`_serve_layout`), each
    cache leaf also checked to be this rank's shard."""
    layout = _serve_layout(cfg, params, tokens.shape[0], "decode step")
    if layout is not None:
        _check_cache(cfg, cache, tokens.shape[0], layout.size)
    return layout


def prefill_layout(cfg: ModelConfig, params, batch, max_len: int):
    """The sharded prefill's layout (:func:`_serve_layout`) for a batch
    whose leaves have the same rows and a new cache of ``max_len``
    positions."""
    if current_rules() is None or current_mesh() is None:
        return None
    rows = {x.shape[0] for x in batch.values()}
    if len(rows) != 1:
        raise ValueError(f"the batch's leaves have {sorted(rows)} rows")
    return _serve_layout(cfg, params, rows.pop(), "prefill", max_len)


@functools.lru_cache(maxsize=16)
def _cache_shapes(cfg: ModelConfig, b: int) -> dict:
    """{leaf: its whole shape} of ``cfg``'s cache of ``b`` rows and one
    position."""
    cache = get_api(cfg).init_cache(cfg, b, 1, torch.float32, device="meta")
    return {name: tuple(t.shape) for name, t in _named(cache).items()}


def _check_cache(cfg, cache, b, size):
    """Each cache leaf the shape of this rank's shard under the cache
    specs: its rows, layers, KV and SSM heads and widths (its positions as
    given)."""
    specs = _named(get_api(cfg).cache_specs(cfg))
    got = _named(cache)
    if sorted(got) != sorted(specs):
        raise ValueError(f"the cache has leaves {sorted(got)}; {cfg.arch_id}'s has "
                         f"{sorted(specs)} ({SHARDED_TODO})")
    whole = _cache_shapes(cfg, b)
    for name, spec in specs.items():
        t, want = got[name], list(whole[name])
        for dim, (logical, axes) in enumerate(zip(spec, logical_to_spec(spec))):
            if logical == "cache_seq":
                want[dim] = t.shape[dim] if t.ndim == len(want) else want[dim]
            else:
                want[dim] //= math.prod(size[a] for a in C.spec_axes(axes))
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"cache leaf {name} is {tuple(t.shape)} on this rank; its shard "
                             f"on the mesh {size} is {tuple(want)} ({SHARDED_TODO})")


def _named(tree, prefix="") -> dict:
    """{dotted key: leaf} of a tree of dicts (leaves tensors or specs)."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _named(tree[key], f"{prefix}{key}.").items()}
    return {prefix[:-1]: tree}


def build_decode_step(cfg: ModelConfig, compute_dtype=torch.bfloat16, return_logits=False):
    """serve_step(params, tokens, cache, pos, extras=None) -> (next tokens,
    cache), with ``return_logits`` also the step's f32 logits (b, 1,
    vocab_size); ``extras`` goes to the family's decode step (encdec's
    ``{"enc_out": ...}``).

    Under ``axis_rules(rules, mesh=mesh)`` the step is sharded, the
    counterpart of the reference's ``jax.jit`` of its decode under the same
    context (ROADMAP 12b.4b, every family since 12b.4c.1): each rank passes
    its shards of the parameters and of the cache (the sharded prefill's,
    or ``launch/mesh.py``'s ``param_shardings`` of the param and cache
    specs, ``shard_tree``) and the global tokens and ``enc_out``, of which
    it reads its rows of "batch"; :func:`decode_layout` checks the layout
    first. The cache shards are updated in place, and the logits and
    tokens come out whole and alike on every rank."""
    api = get_api(cfg)

    def serve_step(params, tokens, cache, pos, extras=None):
        layout = decode_layout(cfg, params, cache, tokens)
        if layout is not None:
            tokens = layout.rows(tokens)
            if extras and "enc_out" in extras:
                extras = {**extras, "enc_out": layout.rows(extras["enc_out"])}
        logits, cache = api.decode_step(params, cfg, tokens, cache, pos,
                                        extras, compute_dtype=compute_dtype)
        if layout is not None:
            logits = layout.gather(logits)
        # mask vocab-padding columns (the embedding table is padded to 128)
        logits = logits[..., : cfg.vocab_size]
        # torch.argmax returns the first index of the maximum, like jnp.argmax
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return (next_tok, cache, logits) if return_logits else (next_tok, cache)

    return serve_step


def build_prefill(cfg: ModelConfig, max_len: int, compute_dtype=torch.bfloat16,
                  cache_dtype=None):
    """prefill_step(params, batch) -> (logits, cache), and for encdec a third
    output, the encoder's ``enc_out``, which the decode step takes as
    ``extras["enc_out"]``. ``cache_dtype`` None: the family's default.

    Under ``axis_rules(rules, mesh=mesh)`` the prefill is sharded
    (ROADMAP 12b.4c.1): each rank passes its shards of the parameters and
    the global batch, of which it reads its rows of "batch";
    :func:`prefill_layout` checks the layout first. The layers run as the
    sharded training forward does (kernel 12 on the rank's heads), the
    logits and ``enc_out`` come out whole and alike on every rank, and
    the cache is this rank's shard under the family's cache specs (what
    ``launch/mesh.py::local_shard`` cuts from one device's cache), for
    the sharded decode step."""
    api = get_api(cfg)
    kw = {} if cache_dtype is None else dict(cache_dtype=cache_dtype)

    def prefill_step(params, batch):
        layout = prefill_layout(cfg, params, batch, max_len)
        if layout is not None:
            batch = {k: layout.rows(x) for k, x in batch.items()}
        out = api.prefill(params, cfg, batch, max_len, compute_dtype=compute_dtype, **kw)
        if layout is None:
            return out
        logits, cache, *rest = out
        return (layout.gather(logits), cache, *(layout.gather(t) for t in rest))

    return prefill_step
