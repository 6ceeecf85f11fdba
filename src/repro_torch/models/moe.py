"""Mixture-of-Experts layers and Multi-head Latent Attention (MLA), the port
of ``repro/models/moe.py``: deepseek-v2-lite-16b and llama4-maverick-400b-a17b.

Routed experts (:func:`moe_ffn`): the router in f32, softmax, top-k, the
weights renormalised; the Switch-style auxiliary loss; the fixed-capacity
sort dispatch, every shape static: the token copies are sorted by expert
id (a stable sort, so each expert keeps its first ``cap`` copies in token
order and drops the rest), packed into an (E, cap, d) buffer, run through
three batched expert GEMMs (``torch.bmm`` on the (E, d, f) weights as they
lie), and combined weighted by the router. Nothing in it reads a device
value on the host: the counts come from ``searchsorted`` on the sorted ids,
and no boolean-mask indexing, ``bincount`` or ``one_hot`` is used. Every
gather it does reads each kept row once (dropped copies and empty slots
read a zero pad row, whose gradient is discarded), and the combine sums a
token's k copies over a dimension of their own, so the forward and the
backward sum in a fixed order: no scatter-add, no atomics.

Under rules and a mesh (the sharded train, prefill and decode steps) the
reference's expert-parallel path (:func:`_moe_ffn_ep`) where "experts" is
mapped: each
rank routes its rows over every expert, packs the copies of its own
experts at twice its rows' capacity, and y is summed over the expert axis
by one all-reduce (no all-to-all); the aux loss is averaged over "data".
Where the reference takes its local path instead (``REPRO_NAIVE=1``, no
"experts" rule, an expert count the axis does not divide), every rank
computes the local form on the gathered rows and experts
(:func:`_moe_ffn_gathered`). The shared experts run tensor-parallel over
"mlp" in both.

MLA (DeepSeek-V2): K and V compressed to a ``kv_lora_rank`` latent plus one
shared RoPE key. Without a cache the expanded form; with one (prefill and
decode, as in the reference) the absorbed form over all the cache's
positions under the causal mask, the cache (b, S, r) and (b, S, dr)
written in place. Under a mesh either runs on the rank's heads; the
cache is the rank's shard of rows and positions, a decode step's partial
softmax combined over the "cache_seq" axes where they are mapped.

The model: the reference's two stacked groups, ``dense_layers`` and
``moe_layers``, are lists of per-layer dicts, walked in
:func:`layer_schedule` order by a Python loop; ``remat`` through
``transformer.checkpointed``. Layers without MLA (llama4) take
``layers.attention``, kernel 12 in the prefill. Each layer's parameters
keep f32 leaves as they are and cast the others to the compute dtype
(the reference's moe ``_cast``), so f32 weights promote a bf16 compute to
f32 wherever they meet it, as jnp does. The cache keeps the reference's
stacked layout ``{"moe", "prefix", "dense"}`` and is updated in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, MoEConfig
from ..distributed import collectives as C
from ..distributed.sharding import (SHARDED_TODO, current_mesh, current_rules,
                                    logical_to_spec, naive_mode, stacked)
from . import layers as L
from .transformer import _save_dots, checkpointed, head_logits


def _mm(a, b):
    """``a @ b`` in the promoted dtype (3-D: ``torch.bmm`` on the operands
    as they lie)."""
    a, b = L.promoted(a, b)
    return a @ b


def _einsum(eq, a, b):
    return torch.einsum(eq, *L.promoted(a, b))


# ---------------------------------------------------------------------------
# routed experts
# ---------------------------------------------------------------------------


def init_moe_ffn(gen, cfg: ModelConfig, dtype=torch.float32):
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
    p = {
        "router": L.dense_init(gen, (d, e), d, torch.float32),   # router in f32
        "wg": L.dense_init(gen, (e, d, f), d, dtype),
        "wu": L.dense_init(gen, (e, d, f), d, dtype),
        "wd": L.dense_init(gen, (e, f, d), f, dtype),
    }
    if m.n_shared_experts:
        fs = m.d_ff_expert * m.n_shared_experts
        p["shared"] = {
            "wg": L.dense_init(gen, (d, fs), d, dtype),
            "wu": L.dense_init(gen, (d, fs), d, dtype),
            "wd": L.dense_init(gen, (fs, d), fs, dtype),
        }
    return p


def moe_ffn_specs(cfg: ModelConfig):
    s = {
        "router": ("embed", None),
        "wg": ("experts", "embed", "expert_mlp"),
        "wu": ("experts", "embed", "expert_mlp"),
        "wd": ("experts", "expert_mlp", "embed"),
    }
    if cfg.moe.n_shared_experts:
        s["shared"] = L.mlp_specs(gated=True)
    return s


def moe_capacity(n_tokens: int, cfg: MoEConfig) -> int:
    cap = int(math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor
                        / max(cfg.n_experts, 1)))
    return max(cap, 4)


def route(xf, p, cfg: ModelConfig):
    """xf (t, d) -> (probs (t, e) f32, top_w (t, k) renormalised, top_ids
    (t, k) int64): the router's softmax in f32 and its top k."""
    probs = torch.softmax(_mm(xf.float(), p["router"]), dim=-1)
    top_w, top_ids = torch.topk(probs, cfg.moe.top_k, dim=-1)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    return probs, top_w, top_ids


def dispatch(top_ids, n_experts: int, cap: int):
    """The fixed-capacity packing of the (t, k) routed copies, in static
    shapes. Returns (slot (t*k,): each copy's row of the (e*cap) buffer in
    token order, ``e*cap`` where the copy is dropped; src (e*cap,): the copy
    (an index into the t*k copies) that fills each row, ``t*k`` where the
    row is empty). Copies sort stably by expert id, and each expert keeps
    its first ``cap``, as the reference's ``jnp.argsort``."""
    dev = top_ids.device
    flat_e = top_ids.reshape(-1)
    n = flat_e.numel()
    order = torch.argsort(flat_e, stable=True)
    rank = torch.empty_like(order).scatter_(0, order, torch.arange(n, device=dev))
    # starts[i]: the copies routed below expert i; starts[e] = n
    starts = torch.searchsorted(flat_e[order],
                                torch.arange(n_experts + 1, device=dev, dtype=flat_e.dtype))
    pos = rank - starts[flat_e]
    slot = torch.where(pos < cap, flat_e * cap + pos, n_experts * cap)
    j = torch.arange(cap, device=dev)
    filled = j[None, :] < (starts[1:] - starts[:-1])[:, None]              # (e, cap)
    first = (starts[:-1, None] + j[None, :]).clamp_max(n - 1)
    src = torch.where(filled, order[first], n).reshape(-1)
    return slot, src


def _pad_row(x):
    """x (n, d) with a zero row appended at index n."""
    return torch.cat([x, x.new_zeros((1, x.shape[1]))])


def moe_ffn(x, p, cfg: ModelConfig):
    """x (b, s, d) -> (y (b, s, d), aux loss, an f32 scalar). Under rules
    and a mesh: the expert-parallel form where the rules map "experts"
    (:func:`_moe_ffn_ep`), else the local form on every row and expert
    (:func:`_moe_ffn_gathered`)."""
    if current_rules() is not None and current_mesh() is not None:
        ep_axes = C.mesh_axes("experts")
        if ep_axes and not naive_mode() and cfg.moe.n_experts % C.axis_size(ep_axes) == 0:
            return _moe_ffn_ep(x, p, cfg, ep_axes)
        return _moe_ffn_gathered(x, p, cfg)
    return _moe_ffn_local(x, p, cfg)


def _aux_loss(probs, top_ids, m: MoEConfig):
    """The Switch-style load-balancing loss of (t, e) router probabilities
    and their (t, k) top ids; the one-hot count as a compare with
    arange(e)."""
    e = m.n_experts
    me = probs.mean(0)
    hits = top_ids[..., None] == torch.arange(e, device=probs.device)        # (t, k, e)
    ce = hits.float().sum(1).mean(0)
    return (me * ce).sum() * e * m.aux_loss_weight


def _experts(he, p):
    """The batched expert GEMMs of the (e, cap, d) buffer."""
    hg = F.silu(_mm(he, p["wg"]))                                              # (e, cap, f)
    hu = _mm(he, p["wu"])
    return _mm(hg * hu, p["wd"])                                               # (e, cap, d)


def _shared(xf, sp):
    """The shared experts, tensor-parallel over "mlp" under rules and a
    mesh (``layers.mlp``'s collectives)."""
    grp = C.group("mlp")
    xf = C.enter(xf, grp)
    return C.reduce(_mm(F.silu(_mm(xf, sp["wg"])) * _mm(xf, sp["wu"]), sp["wd"]), grp)


def _moe_ffn_local(x, p, cfg: ModelConfig):
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.n_experts, m.top_k
    xf = x.reshape(t, d)

    probs, top_w, top_ids = route(xf, p, cfg)
    aux = _aux_loss(probs, top_ids, m)

    cap = moe_capacity(t, m)
    slot, src = dispatch(top_ids, e, cap)
    # each token's k copies, side by side: the backward sums them over k
    xk = xf[:, None, :].expand(t, k, d).reshape(t * k, d)
    ye = _experts(_pad_row(xk)[src].reshape(e, cap, d), p)

    yk = _pad_row(ye.reshape(e * cap, d))[slot].reshape(t, k, d)
    contrib = yk * top_w.to(x.dtype)[..., None]
    y = contrib.to(x.dtype).sum(1)

    if m.n_shared_experts:
        y = y + _shared(xf, p["shared"])
    return y.reshape(b, s, d), aux


def ep_dispatch(top_ids, e_loc: int, rank: int, cap: int):
    """:func:`dispatch` of the copies routed to expert-parallel rank
    ``rank``'s ``e_loc`` experts: the others sort after them, into a bin
    of their own, as the reference's ``jnp.where(mine, local_e, e_loc)``.
    Returns (slot (t*k,): each copy's row of the (e_loc*cap) buffer,
    ``e_loc*cap`` where the copy is another rank's or dropped; src
    (e_loc*cap,))."""
    mine = torch.div(top_ids, e_loc, rounding_mode="floor") == rank
    slot, src = dispatch(torch.where(mine, top_ids - rank * e_loc, e_loc), e_loc + 1, cap)
    n = e_loc * cap
    return torch.where(slot < n, slot, n), src[:n]


def _moe_ffn_ep(x, p, cfg: ModelConfig, ep_axes: tuple):
    """The reference's expert-parallel ``_moe_ffn_ep`` (``moe.py:145-252``)
    on this rank's rows and its ``E / ep`` experts (wg, wu, wd split by
    experts over ``ep_axes``): the router on every expert in f32, the aux
    loss averaged over "data", this rank's experts' copies packed at twice
    the capacity of its rows, y summed over ``ep_axes`` (one all-reduce of
    (t, d), no all-to-all), the shared experts tensor-parallel beside it.

    The backward: every rank routes alike, so the router's and aux's
    gradients are whole on each; a rank's experts see only their copies,
    so the copies' weights ``top_w`` and the tokens they read enter the
    experts through ``enter`` (their gradients summed over ``ep_axes``)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    k = m.top_k
    grp, ep = C.group_of(ep_axes), C.axis_size(ep_axes)
    e_loc = m.n_experts // ep
    if p["wg"].shape[0] != e_loc:
        raise ValueError(f"the expert-parallel moe_ffn takes this rank's {e_loc} of "
                         f"{m.n_experts} experts, not {p['wg'].shape[0]}")
    xf = x.reshape(t, d)
    probs, top_w, top_ids = route(xf, p, cfg)
    aux = C.mean(_aux_loss(probs, top_ids, m), C.group("batch"))
    cap = moe_capacity(t, m) * 2            # the reference's headroom for imbalance
    slot, src = ep_dispatch(top_ids, e_loc, C.axis_index(ep_axes), cap)
    xk = C.enter(xf, grp)[:, None, :].expand(t, k, d).reshape(t * k, d)
    ye = _experts(_pad_row(xk)[src].reshape(e_loc, cap, d), p)
    yk = _pad_row(ye.reshape(e_loc * cap, d))[slot].reshape(t, k, d)
    contrib = yk * C.enter(top_w, grp).to(x.dtype)[..., None]
    y = C.reduce(contrib.to(x.dtype).sum(1), grp)
    if m.n_shared_experts:
        y = y + _shared(xf, p["shared"])
    return y.reshape(b, s, d), aux


def _moe_ffn_gathered(x, p, cfg: ModelConfig):
    """The local form under a mesh, as the reference's GSPMD runs it where
    it takes no expert-parallel path (``REPRO_NAIVE=1``, no "experts"
    rule, experts the axis does not divide): every rank gathers the rows
    of "batch" and the experts of "experts", computes the local form on
    all of them, and keeps its rows; the shared experts tensor-parallel."""
    b = x.shape[0]
    rows = C.group("batch")
    ep = C.group("experts") if p["wg"].shape[0] != cfg.moe.n_experts else None
    experts = {name: C.gather(p[name], ep, 0) for name in ("wg", "wu", "wd")}
    y, aux = _moe_ffn_local(C.gather_summed(x, rows, 0), {**p, **experts}, cfg)
    return y.narrow(0, C.rank(rows) * b, b), aux


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-V2)
# ---------------------------------------------------------------------------


def init_mla(gen, cfg: ModelConfig, dtype=torch.float32):
    a = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv, r = a.nope_head_dim, a.rope_head_dim, a.v_head_dim, a.kv_lora_rank
    return {
        "wq": L.dense_init(gen, (d, h * (dn + dr)), d, dtype),
        "w_dkv": L.dense_init(gen, (d, r), d, dtype),
        "w_kr": L.dense_init(gen, (d, dr), d, dtype),
        "kv_norm": torch.ones((r,), dtype=dtype, device=L._device(gen)),
        "w_uk": L.dense_init(gen, (r, h * dn), r, dtype),
        "w_uv": L.dense_init(gen, (r, h * dv), r, dtype),
        "wo": L.dense_init(gen, (h * dv, d), h * dv, dtype),
    }


def mla_specs(cfg: ModelConfig):
    return {
        "wq": ("embed", "heads"),
        "w_dkv": ("embed", None),
        "w_kr": ("embed", None),
        "kv_norm": (None,),
        "w_uk": (None, "heads"),
        "w_uv": (None, "heads"),
        "wo": ("heads", "embed"),
    }


def _mla_rope(x, positions, theta):
    cos, sin = L.rope_table(positions, x.shape[-1], theta)
    return L.apply_rope(x, cos, sin)


def _masked_softmax(logits, ok, scale, dtype):
    """The reference's ``softmax(logits.astype(f32) * scale + mask)`` with
    the mask 0 where ``ok`` and -inf elsewhere, in place on the f32
    logits; the probabilities in ``dtype``."""
    logits = logits.float().mul_(scale).masked_fill_(~ok, -torch.inf)
    return torch.softmax(logits, dim=-1).to(dtype)


def mla_attention(x, p, cfg: ModelConfig, *, positions=None, cache=None, cache_pos=None):
    """The expanded form without a cache; with one (``{"ckv": (b, S, r),
    "kr": (b, S, dr)}``, compressed and head-free) the absorbed form over all
    S positions, the new entries written at ``cache_pos`` in place. Returns
    (y (b, s, e), cache).

    Under rules and a mesh, on the rank's heads: ``wq``, ``w_uk``, ``w_uv``
    and ``wo`` are split by heads, while ``w_dkv``, ``w_kr`` and
    ``kv_norm`` are whole on every rank, so the latent ``ckv`` and the
    shared RoPE key ``kr`` are whole too (in the training forward they
    enter the rank's heads through ``enter``, their gradients summed over
    the ranks' heads), and the output projection is summed by ``reduce``.
    The cache is the rank's shard, its rows and the positions of its
    "cache_seq" shard (``start = axis_index * S_loc``), written by the
    rank that holds each new position. The prefill (from position 0) runs
    the absorbed form over the fresh whole-sequence ``ckv`` and ``kr``; a
    decode step over the rank's positions, combined where "cache_seq" is
    mapped by a partial softmax (:func:`_mla_flash_decode`)."""
    a = cfg.mla
    b, s, _ = x.shape
    dn, dr, dv, r = a.nope_head_dim, a.rope_head_dim, a.v_head_dim, a.kv_lora_rank
    h = p["wq"].shape[1] // (dn + dr)                           # this rank's heads
    heads = C.group("heads")
    sharded = cache is not None and current_rules() is not None and current_mesh() is not None
    if positions is None:
        positions = torch.arange(s, device=x.device)

    q = _mm(C.enter(x, heads), p["wq"]).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    # back to the compute dtype: RoPE's f32 tables must not promote the
    # score products (and the compressed cache) to f32
    q_rope = _mla_rope(q_rope, positions, cfg.rope_theta).to(x.dtype)
    ckv = L.rms_norm(_mm(x, p["w_dkv"]), p["kv_norm"], cfg.norm_eps)           # (b, s, r)
    kr = _mla_rope(_mm(x, p["w_kr"])[:, :, None, :], positions,
                   cfg.rope_theta)[:, :, 0].to(x.dtype)                          # (b, s, dr)
    # the reference's f32 1 / sqrt(dn + dr), as a host number
    scale = float(1.0 / torch.sqrt(torch.tensor(float(dn + dr))))

    if cache is not None:
        pos = int(cache_pos)
        ckv_c, kr_c = cache["ckv"], cache["kr"]
        seq_axes = (C.spec_axes(logical_to_spec(mla_cache_specs(cfg)["ckv"])[1]) if sharded
                    else ())
        s_loc = ckv_c.shape[1]
        start, total = C.axis_index(seq_axes) * s_loc, s_loc * C.axis_size(seq_axes)
        if pos < 0 or pos + s > total:
            raise ValueError(f"cache_pos {pos} + {s} tokens past the cache's {total} positions")
        if sharded and s > 1 and pos:
            raise NotImplementedError(f"under a mesh MLA prefills from cache position 0, not "
                                      f"{s} tokens at {pos} ({SHARDED_TODO})")
        lo, hi = max(pos, start), min(pos + s, start + s_loc)
        if lo < hi:                                 # this rank's shard holds new positions
            ckv_c[:, lo - start:hi - start] = ckv[:, lo - pos:hi - pos].to(ckv_c.dtype)
            kr_c[:, lo - start:hi - start] = kr[:, lo - pos:hi - pos].to(kr_c.dtype)
        # absorbed: q_eff = q_nope @ W_uk, per head, into the latent space
        q_eff = _einsum("bshd,rhd->bshr", q_nope, p["w_uk"].reshape(r, h, dn))
        seq = C.group_of(seq_axes)
        if sharded and s > 1:       # the prefill: over the fresh keys, in the cache's type
            keys, rkeys, first = ckv.to(ckv_c.dtype), kr.to(kr_c.dtype), 0
        else:
            keys, rkeys, first = ckv_c, kr_c, start
        if seq is not None and s == 1:
            lat = _mla_flash_decode(q_eff, q_rope, ckv_c, kr_c, pos, start, scale, seq_axes,
                                    heads)
        else:
            # in place: at the prefill the (b, h, s, S) scores are the largest
            # tensors of the layer
            logits = _einsum("bshr,btr->bhst", q_eff, keys)
            logits.add_(_einsum("bshd,btd->bhst", q_rope, rkeys))
            qi = pos + torch.arange(s, device=x.device)[:, None]
            kj = first + torch.arange(keys.shape[1], device=x.device)[None, :]
            probs = _masked_softmax(logits, kj <= qi, scale, x.dtype)
            del logits
            lat = _einsum("bhst,btr->bshr", probs, keys)                         # (b, s, h, r)
        out = _einsum("bshr,rhd->bshd", lat, p["w_uv"].reshape(r, h, dv))
    else:
        ckv, kr = C.enter(ckv, heads), C.enter(kr, heads)
        k_nope = _mm(ckv, p["w_uk"]).reshape(b, s, h, dn)
        v = _mm(ckv, p["w_uv"]).reshape(b, s, h, dv)
        logits = _einsum("bshd,bthd->bhst", q_nope, k_nope)
        logits = logits + _einsum("bshd,btd->bhst", q_rope, kr)
        qi = torch.arange(s, device=x.device)
        probs = _masked_softmax(logits, qi[None, :] <= qi[:, None], scale, x.dtype)
        out = _einsum("bhst,bthd->bshd", probs, v)

    return C.reduce(_mm(out.reshape(b, s, h * dv), p["wo"]), heads), cache


def _mla_flash_decode(q_eff, q_rope, ckv_c, kr_c, pos, start, scale, seq_axes, heads):
    """One decode token's absorbed attention over this rank's positions of
    the cache (``start`` on), combined over the mesh axes ``seq_axes``
    as the flash decode does (``layers._flash_decode``): the scores in f32
    under the causal mask, one max and two sums over ``grp`` (the
    probabilities' and the latent's), then ``lat / max(l, 1e-30)``. Where
    the axes take "model" every rank of them combines the same heads: the
    queries are gathered over ``heads`` and the rank keeps its own.
    Returns the latent (b, 1, h, r) in the queries' type."""
    h, grp = q_eff.shape[2], C.group_of(seq_axes)
    gathered = "model" in seq_axes and heads is not None
    if gathered:
        q_eff, q_rope = C.gather(q_eff, heads, 2), C.gather(q_rope, heads, 2)
    logits = (_einsum("bshr,btr->bhst", q_eff, ckv_c)
              + _einsum("bshd,btd->bhst", q_rope, kr_c)).float() * scale    # (b, h, 1, t)
    ok = start + torch.arange(ckv_c.shape[1], device=q_eff.device) <= pos
    logits = logits.masked_fill(~ok, -torch.inf)
    m = C.all_max(logits.amax(-1, keepdim=True), grp)
    p = torch.exp(logits - m).masked_fill(~ok, 0.0)
    l = C.reduce(p.sum(-1, keepdim=True), grp)                              # (b, h, 1, 1)
    lat = C.reduce(_einsum("bhst,btr->bshr", p.to(q_eff.dtype), ckv_c).float(), grp)
    lat = (lat / torch.clamp_min(l, 1e-30).permute(0, 2, 1, 3)).to(q_eff.dtype)
    return lat.narrow(2, C.rank(heads) * h, h) if gathered else lat


def init_mla_cache(cfg: ModelConfig, batch, max_len, dtype=torch.bfloat16, device=None):
    a = cfg.mla
    return {
        "ckv": torch.zeros((batch, max_len, a.kv_lora_rank), dtype=dtype, device=device),
        "kr": torch.zeros((batch, max_len, a.rope_head_dim), dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# the MoE decoder LM (deepseek-v2-lite / llama4-maverick)
# ---------------------------------------------------------------------------


def mla_cache_specs(cfg: ModelConfig):
    return {"ckv": ("batch", "cache_seq", None), "kr": ("batch", "cache_seq", None)}


def _is_moe_layer(cfg: ModelConfig, idx: int) -> bool:
    m = cfg.moe
    if idx < m.first_dense:
        return False
    return (idx - m.first_dense) % m.moe_every == 0


def layer_schedule(cfg: ModelConfig):
    """[("dense" | "moe", position in its group)] in layer order."""
    sched = []
    nd = nm = 0
    for i in range(cfg.n_layers):
        if _is_moe_layer(cfg, i):
            sched.append(("moe", nm))
            nm += 1
        else:
            sched.append(("dense", nd))
            nd += 1
    return sched


def _plan(cfg: ModelConfig):
    """(n_prefix_dense, n_super, dense_per_super): the layers are
    [first_dense dense] + n_super x [1 moe + (moe_every - 1) dense]."""
    m = cfg.moe
    rest = cfg.n_layers - m.first_dense
    if rest % m.moe_every:
        raise ValueError(f"n_layers - first_dense ({rest}) must be a multiple of "
                         f"moe_every ({m.moe_every})")
    return m.first_dense, rest // m.moe_every, m.moe_every - 1


def init_layer(gen, cfg: ModelConfig, moe_layer: bool, dtype=torch.float32):
    dev = L._device(gen)
    p = {"ln1": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
         "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=dev)}
    p["attn"] = init_mla(gen, cfg, dtype) if cfg.mla else L.init_attention(gen, cfg, dtype)
    if moe_layer:
        p["moe"] = init_moe_ffn(gen, cfg, dtype)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, dtype, gated=True)
    return p


def layer_specs(cfg: ModelConfig, moe_layer: bool):
    s = {"ln1": ("embed",), "ln2": ("embed",),
         "attn": mla_specs(cfg) if cfg.mla else L.attention_specs(cfg)}
    if moe_layer:
        s["moe"] = moe_ffn_specs(cfg)
    else:
        s["mlp"] = L.mlp_specs(gated=True)
    return s


def init_params(gen, cfg: ModelConfig, dtype=torch.float32):
    """Random parameters drawn from ``gen`` on its device (shapes only, on
    the meta device, for ``gen=None``): ``embed``, ``ln_f`` and the layer
    lists ``dense_layers`` and ``moe_layers``, each in layer order."""
    params = {"embed": L.init_embed(gen, cfg, dtype),
              "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=L._device(gen))}
    for kind in ("dense", "moe"):
        group = [init_layer(gen, cfg, kind == "moe", dtype)
                 for k, _ in layer_schedule(cfg) if k == kind]
        if group:
            params[f"{kind}_layers"] = group
    return params


def param_specs(cfg: ModelConfig):
    specs = {"embed": L.embed_specs(cfg), "ln_f": ("embed",)}
    for kind in ("dense", "moe"):
        if any(k == kind for k, _ in layer_schedule(cfg)):
            specs[f"{kind}_layers"] = stacked(layer_specs(cfg, kind == "moe"), "layers")
    return specs


def _cast(tree, compute_dtype):
    """The reference's moe rule: f32 leaves as they are (the same tensors),
    the others in ``compute_dtype``."""
    if isinstance(tree, dict):
        return {k: _cast(v, compute_dtype) for k, v in tree.items()}
    return tree if tree.dtype == torch.float32 else tree.to(compute_dtype)


def _apply_layer(cfg, x, lp, moe_layer, *, positions, cache=None, cache_pos=None):
    """One pre-norm layer: (x, aux), aux None for a dense layer."""
    h_in = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.mla:
        h, _ = mla_attention(h_in, lp["attn"], cfg, positions=positions, cache=cache,
                             cache_pos=cache_pos)
    else:
        # jnp promotes x to the weights' dtype in x @ w; layers.attention
        # takes x in it
        h, _ = L.attention(L.promoted(h_in, lp["attn"]["wq"])[0], lp["attn"], cfg,
                           positions=positions, cache=cache, cache_pos=cache_pos)
    x = x + h
    h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if moe_layer:
        y, aux = moe_ffn(h2, lp["moe"], cfg)
    else:
        y, aux = L.mlp(L.promoted(h2, lp["mlp"]["wg"])[0], lp["mlp"]), None
    return x + y, aux


def forward(params, cfg: ModelConfig, tokens, *, compute_dtype=torch.bfloat16,
            remat: str = "full", return_aux=False):
    """tokens (b, s) -> logits (b, s, v_padded), f32; with ``return_aux``
    (logits, the moe layers' summed aux loss)."""
    _plan(cfg)
    h = L.embed_tokens(params["embed"], tokens).to(compute_dtype)
    positions = torch.arange(h.shape[1], device=h.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)

    def body(x, lp, moe_layer):
        return _apply_layer(cfg, x, _cast(lp, compute_dtype), moe_layer,
                            positions=positions)

    for kind, i in layer_schedule(cfg):
        h, aux = checkpointed(body, remat, h, params[f"{kind}_layers"][i], kind == "moe",
                              policy=_save_dots)
        if aux is not None:
            aux_total = aux_total + aux
    logits = head_logits(params, cfg, h, compute_dtype)
    return (logits, aux_total) if return_aux else logits


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch, max_len, dtype=torch.bfloat16, device=None):
    """A layer's cache (MLA's or the attention's; shapes taken on the meta
    device) stacked as the reference's: ``moe`` (n_super, ...), ``prefix``
    (n_prefix, ...) and ``dense`` (n_super, dense_per_super, ...)."""
    if cfg.mla:
        one = init_mla_cache(cfg, batch, max_len, dtype, device="meta")
    else:
        one = L.init_attention_cache(cfg, batch, max_len, dtype, device="meta")
    n_prefix, n_super, dps = _plan(cfg)

    def stacked(*lead):
        return {name: torch.zeros((*lead, *a.shape), dtype=dtype, device=device)
                for name, a in one.items()}

    cache = {"moe": stacked(n_super)}
    if n_prefix:
        cache["prefix"] = stacked(n_prefix)
    if dps:
        cache["dense"] = stacked(n_super, dps)
    return cache


def cache_specs(cfg: ModelConfig):
    base = mla_cache_specs(cfg) if cfg.mla else L.attention_cache_specs(cfg)
    n_prefix, _, dps = _plan(cfg)
    specs = {"moe": stacked(base, "layers")}
    if n_prefix:
        specs["prefix"] = stacked(base, "layers")
    if dps:
        specs["dense"] = stacked(base, "layers", None)
    return specs


def _layer_cache(cache, kind, i, n_prefix, dps):
    """Views of the stacked cache for group ``kind``'s layer ``i``."""
    if kind == "moe":
        group, idx = cache["moe"], (i,)
    elif i < n_prefix:
        group, idx = cache["prefix"], (i,)
    else:
        group, idx = cache["dense"], divmod(i - n_prefix, dps)
    return {name: t[idx] for name, t in group.items()}


def _serve(params, cfg, h, cache, pos, compute_dtype):
    n_prefix, _, dps = _plan(cfg)
    positions = pos + torch.arange(h.shape[1], device=h.device)
    for kind, i in layer_schedule(cfg):
        lp = _cast(params[f"{kind}_layers"][i], compute_dtype)
        h, _ = _apply_layer(cfg, h, lp, kind == "moe", positions=positions,
                            cache=_layer_cache(cache, kind, i, n_prefix, dps),
                            cache_pos=pos)
    return h


def decode_step(params, cfg: ModelConfig, tokens, cache, pos, *, compute_dtype=torch.bfloat16):
    """One token step at position ``pos`` (an int); the cache is updated in
    place. Returns (logits, cache)."""
    h = L.embed_tokens(params["embed"], tokens).to(compute_dtype)
    h = _serve(params, cfg, h, cache, int(pos), compute_dtype)
    return head_logits(params, cfg, h, compute_dtype), cache


def prefill(params, cfg: ModelConfig, tokens, max_len, *, compute_dtype=torch.bfloat16,
            cache_dtype=torch.bfloat16):
    """Full-sequence pass that fills a new cache of ``max_len`` positions
    (MLA: its absorbed form, as the reference's prefill). Returns (logits,
    cache)."""
    b, _ = tokens.shape
    cache = C.local_zeros(init_cache(cfg, b, max_len, cache_dtype, device="meta"),
                          cache_specs(cfg), tokens.device)
    h = L.embed_tokens(params["embed"], tokens).to(compute_dtype)
    h = _serve(params, cfg, h, cache, 0, compute_dtype)
    return head_logits(params, cfg, h, compute_dtype), cache
