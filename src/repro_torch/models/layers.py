"""Transformer building blocks, the port of ``repro/models/layers.py``.

Parameters are nested dicts of tensors, as in the reference, with the
weights in its (in, out) layout so that ``x @ w`` needs no transpose.
Initializers draw from an explicit ``torch.Generator`` and make the tensors
on its device; ``gen=None`` gives the shapes alone, on the meta device.

Attention routes self-attention: the no-cache forward, the prefill into
the KV cache at ``cache_pos=0`` and the decode over the cache, with the
reference's causal, sliding-window and prefix-LM masks. Wherever it
computes the function of kernel 12 (attention over equal query and key
lengths under a plain causal mask, or full without a cache) at a head
width the kernel takes (up to its ``MAX_D``, 128) it calls
``ops.flash_attention``: the hand-written kernel on a CUDA tensor (with its
hand-written backward when training), its plain version on the CPU. A
window that cuts into the sequence, a prefix, and the decode (queries
past the start of the cache) stay plain torch, as the reference keeps
them in jnp: its full-scores path, or, past 8,192 positions in multiples
of 1,024, its query-blockwise path; so does a head wider than ``MAX_D``,
which the reference computes at any width. The two paths part where a
window and a prefix meet, and each is mirrored as it is (ROADMAP queue 3).

Cross-attention (``x_kv``, the encoder-decoder's) projects K and V from
``x_kv``, with no RoPE and no mask: over as many keys as queries it is
kernel 12's full function (``ops.flash_attention``, ``causal=False``);
over another number of keys (the decode step, a ragged source), or at a
head past ``MAX_D``, it is the plain masked path with every key visible.
Every init has a sibling ``*_specs`` giving the reference's tree of
logical axis names (``distributed/sharding.py``). Under a rules context
with a mesh the functions run on each rank's local shards, with the
collectives of ``distributed/collectives.py`` at the reference's
``constrain`` sites: q, k and v on the rank's own heads (the local head
counts are read from the local weights), the output projection and the
MLP's down projection summed over "model", the vocab-sharded table read
by a masked lookup and the logits gathered. K and V replicated over
"model" (a ``kv_heads`` rule of None) are projected on every rank, which
takes the KV heads of its own query heads. Where the rules shard wq's or
wk's and wv's flat columns but leave the activation whole ("heads_act"
or "kv_heads_act" None, the reference's rules wherever the head count
does not divide the "model" axis, down to half a head a rank), the
rank's columns are gathered (``gather_summed``), and where q is whole
every rank attends every head and takes its own columns of the output
into its rows of wo.

Under a mesh the cache path runs on each rank's shard of the cache, laid
out by the cache spec ("batch", "cache_seq", "kv_heads_act"). The decode
step (one token a row): where the rules map "cache_seq", the reference's
flash decode (a partial softmax over each rank's positions, combined by a
max and two sums over the "cache_seq" axes); otherwise the dense decode
on the rank's query heads over a cache sharded by KV heads or whole (or
gathered over its positions under ``REPRO_NAIVE=1``). The owning rank
alone writes a new position. The prefill (from position 0): attention as
the training forward computes it, on the rank's query heads over the
fresh K and V (kernel 12 where one device calls it), while each rank
writes the prompt positions its shard holds. A cross-attention without a
cache (the encoder-decoder's training forward, prefill and decode) runs
on the rank's heads as self-attention does, K and V projected from
``x_kv`` through ``enter``, so that its gradient (the encoder's output)
is summed over the ranks' heads.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distributed import collectives as C
from ..distributed.sharding import (SHARDED_TODO, current_mesh, current_rules, logical_to_spec,
                                    naive_mode)
from ..kernels import ops
from ..kernels.flash_attention import MAX_D

# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator | None, shape) -> torch.Tensor:
    """Standard normal f32 draws on ``gen``'s device (shape only for None)."""
    if gen is None:
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device)


def _device(gen: torch.Generator | None) -> torch.device:
    return torch.device("meta") if gen is None else gen.device


def dense_init(gen, shape, in_axis_size, dtype=torch.float32):
    return _normal(gen, shape).mul_(1.0 / math.sqrt(in_axis_size)).to(dtype)


def embed_init(gen, shape, dtype=torch.float32):
    return _normal(gen, shape).mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x, gamma, eps):
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_table(positions, head_dim, theta):
    """positions (…,) int -> (…, head_dim/2) cos/sin tables (f32)."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (b, s, h, d) with cos/sin (s, d/2) or (b, s, d/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:                       # (s, half) -> broadcast b, h
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:                                   # (b, s, half)
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def init_attention(gen, cfg: ModelConfig, dtype=torch.float32):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": dense_init(gen, (d, h * hd), d, dtype),
        "wk": dense_init(gen, (d, kv * hd), d, dtype),
        "wv": dense_init(gen, (d, kv * hd), d, dtype),
        "wo": dense_init(gen, (h * hd, d), h * hd, dtype),
    }
    if cfg.qkv_bias:
        dev = _device(gen)
        p["bq"] = torch.zeros((h * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((kv * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((kv * hd,), dtype=dtype, device=dev)
    return p


def attention_specs(cfg: ModelConfig):
    s = {
        "wq": ("embed", "heads"),
        "wk": ("embed", "kv_heads"),
        "wv": ("embed", "kv_heads"),
        "wo": ("heads", "embed"),
    }
    if cfg.qkv_bias:
        s["bq"] = ("heads",)
        s["bk"] = ("kv_heads",)
        s["bv"] = ("kv_heads",)
    return s


def attention(
    x,
    p,
    cfg: ModelConfig,
    *,
    positions=None,            # (s,) int positions of x in the sequence
    causal=True,
    prefix_len=0,
    x_kv=None,                 # cross-attention source (b, s_kv, e)
    cache=None,                # dict(k, v) (b, S_max, kv, d), written in place
    cache_pos=None,            # int: write offset in the cache
    rope=True,
):
    """Returns (out (b, s, e), cache).

    With a cache, the new K and V are written into it IN PLACE (the
    reference returns an updated copy; on the card a copy of the cache per
    layer and step would cost its whole size in memory traffic), and the
    same dict is returned. Cross-attention (``x_kv``) takes no cache: the
    reference's models pass none, and its decode re-projects ``x_kv``.
    Under rules and a mesh a cached call is the sharded decode (one token)
    or prefill (from position 0) on the rank's cache shard."""
    if x_kv is not None and cache is not None:
        raise ValueError("cross-attention (x_kv) takes no cache")
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    window = cfg.sliding_window
    src = x if x_kv is None else x_kv
    s_kv = src.shape[1]
    heads, kv_heads = C.group("heads"), C.group("kv_heads")
    if cache is not None and current_rules() is not None and current_mesh() is not None:
        if s == 1:
            return _sharded_decode(x, p, cfg, positions, cache, int(cache_pos), rope)
        q, k, v = _sharded_prefill(x, p, cfg, positions, cache, int(cache_pos), rope)
        out = _attend(q, k, v, causal=True, window=window, prefix_len=prefix_len, q_offset=0,
                      cached=True)
        return C.reduce(_out_proj(out, v, p, b, s, heads), heads), cache
    if kv_heads is not None and heads is None:
        raise NotImplementedError(f"sharded attention shards the query heads wherever the KV "
                                  f"heads are ({SHARDED_TODO})")

    q_in = C.enter(x, heads)
    kv_in = src if kv_heads is None else q_in if x_kv is None else C.enter(x_kv, kv_heads)
    q = q_in @ p["wq"]
    k = kv_in @ p["wk"]
    v = kv_in @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    # an activation the rules leave whole over "model": the rank's columns
    # gathered, the ranks' gradients of the whole summed (``gather_summed``)
    q = C.gather_summed(q, _whole("heads", heads))
    kv_cols = _whole("kv_heads", kv_heads)
    k, v = C.gather_summed(k, kv_cols), C.gather_summed(v, kv_cols)
    q = q.reshape(b, s, -1, hd)
    k = k.reshape(b, s_kv, -1, hd)
    v = v.reshape(b, s_kv, -1, hd)
    if heads is not None and kv_heads is None:
        # K and V projected whole on every rank: the ranks' gradients summed
        k, v = C.enter(k, heads), C.enter(v, heads)
    k, v = _group_kv(k, v, q.shape[2], cfg, heads)

    if x_kv is not None:
        if s_kv == s and hd <= MAX_D:       # kernel 12's full function
            out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), causal=False).transpose(1, 2)
        else:
            out = _masked_attention(q, k, v, torch.ones((s, s_kv), dtype=torch.bool,
                                                        device=q.device))
        return C.reduce(_out_proj(out, v, p, b, s, heads), heads), cache

    if positions is None:
        positions = torch.arange(s, device=x.device)
    if rope:
        cos_q, sin_q = rope_table(positions, hd, cfg.rope_theta)
        # keep q/k in the compute dtype, as the reference does
        q = apply_rope(q, cos_q, sin_q).to(v.dtype)
        k = apply_rope(k, cos_q, sin_q).to(v.dtype)

    q_offset = 0
    if cache is not None:
        q_offset = int(cache_pos)
        ck, cv = cache["k"], cache["v"]
        if q_offset < 0 or q_offset + s > ck.shape[1]:
            raise ValueError(f"cache_pos {q_offset} + {s} tokens past the cache's "
                             f"{ck.shape[1]} positions")
        ck[:, q_offset:q_offset + s] = k.to(ck.dtype)
        cv[:, q_offset:q_offset + s] = v.to(cv.dtype)
        # the positions past q_offset + s are masked in the reference
        k, v = ck[:, :q_offset + s], cv[:, :q_offset + s]
        causal = True
    out = _attend(q, k, v, causal=causal, window=window, prefix_len=prefix_len,
                  q_offset=q_offset, cached=cache is not None)
    return C.reduce(_out_proj(out, v, p, b, s, heads), heads), cache


def _whole(name, grp):
    """``grp`` where the rules leave the activation of the sharded
    parameter axis ``name`` ("heads" or "kv_heads") whole, as the
    reference's rules do wherever its head count does not divide the
    "model" axis (``{name}_act`` unsharded); else None."""
    return grp if grp is not None and not C.mesh_axes(f"{name}_act") else None


def _attend(q, k, v, *, causal, window, prefix_len, q_offset, cached):
    """q (b, s, h, d) at positions ``q_offset`` on over k, v (b, t, kv, d):
    kernel 12 where its function is the mask's (from position 0, plain
    causal or full, d <= ``MAX_D``); else the reference's blockwise path
    (no cache, past 8,192 positions) or its full-scores path, under its
    ``_build_mask`` without a cache and its cache path's mask with one."""
    s, t, hd = q.shape[1], k.shape[1], q.shape[-1]
    plain_mask = not causal or (not prefix_len and (not window or t <= window))
    if q_offset == 0 and plain_mask and hd <= MAX_D:
        # kernel 12's function: (b, h, s, d) views of q and of k, v (the
        # cache slice on the prefill), read in place by the kernel
        return ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal).transpose(1, 2)
    if not cached and s > _BLOCKWISE_MIN and s % _BLOCK_Q == 0:
        return _blockwise_attention(q, k, v, window, prefix_len)
    qi = q_offset + torch.arange(s, device=q.device)[:, None]
    kj = torch.arange(t, device=q.device)[None, :]
    if not cached:      # the reference's _build_mask
        ok = _visible(qi, kj, causal=causal, window=window, prefix_len=prefix_len)
    else:               # its cache path's mask: the prefix only among prefix rows
        ok = _visible(qi, kj, window=window, prefix_len=prefix_len, prefix_rows=True)
    return _masked_attention(q, k, v, ok)


def _serve_qkv(x, p, cfg, positions, cache, rope):
    """The serve steps' projections under the rules and mesh, on the
    rank's shards of the weights: q on its query heads (b, s, h_loc, d),
    or on every head where the rules leave "heads_act" whole (its columns
    of wq gathered over "model"); K and V (b, s, kv_c, d) on the KV heads
    its cache shard holds (its columns of wk and wv gathered over "model"
    into whole heads where the cache holds every KV head, a replicated
    projection's own heads taken where it holds the rank's), each with
    RoPE at ``positions``. Also the mesh axes of the cache's positions."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    spec = logical_to_spec(("batch", "cache_seq", "kv_heads_act", None))
    seq_axes, kv_axes = C.spec_axes(spec[1]), C.spec_axes(spec[2])
    kv_cols = C.group("kv_heads")
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = C.gather(q, _whole("heads", C.group("heads")))
    if kv_cols is not None and not kv_axes:     # the cache wants whole KV heads
        k, v = C.gather(k, kv_cols), C.gather(v, kv_cols)
    q = q.reshape(b, s, -1, hd)
    k = k.reshape(b, s, -1, hd)
    v = v.reshape(b, s, -1, hd)
    n = cache["k"].shape[2]
    if k.shape[2] != n:                         # replicated wk, wv: the cache's own KV heads
        r = C.rank(C.group_of(("model",)))
        k, v = k.narrow(2, r * n, n), v.narrow(2, r * n, n)
    if rope:
        cos, sin = rope_table(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin).to(v.dtype)
        k = apply_rope(k, cos, sin).to(v.dtype)
    return q, k, v, seq_axes


def _sharded_prefill(x, p, cfg, positions, cache, pos, rope):
    """A prefill of s tokens under the rules and mesh (ROADMAP 12b.4c.1):
    the projections of :func:`_serve_qkv`; the rank writes its cache shard
    (b, S_loc, kv_c, d), the positions of the prompt its "cache_seq"
    shard holds (``start = axis_index * S_loc`` on); then (q, K, V) for
    :func:`_attend` over the fresh keys, as the training forward takes
    them: the rank's query heads over their KV heads, K and V in the
    cache's type (one device attends over its cache slice); every head
    where q holds them all."""
    b, s, _ = x.shape
    if pos:
        raise NotImplementedError(f"under a mesh attention prefills from cache position 0, "
                                  f"not {s} tokens at {pos} ({SHARDED_TODO})")
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v, seq_axes = _serve_qkv(x, p, cfg, positions, cache, rope)
    ck, cv = cache["k"], cache["v"]
    s_loc = ck.shape[1]
    if s > s_loc * C.axis_size(seq_axes):
        raise ValueError(f"a prompt of {s} tokens past the cache's "
                         f"{s_loc * C.axis_size(seq_axes)} positions")
    start = C.axis_index(seq_axes) * s_loc
    end = min(start + s_loc, s)
    if start < end:                             # this rank's shard holds prompt positions
        ck[:, :end - start] = k[:, start:end].to(ck.dtype)
        cv[:, :end - start] = v[:, start:end].to(cv.dtype)
    k, v = _group_kv(k.to(ck.dtype), v.to(cv.dtype), q.shape[2], cfg, C.group("heads"))
    return q, k, v


def _sharded_decode(x, p, cfg, positions, cache, pos, rope):
    """One decode token under the rules and mesh, on the rank's shards of
    the weights and of the cache (b, S_loc, kv_c, d), whose layout is the
    cache spec's: rows over "batch", positions over "cache_seq", KV heads
    over "kv_heads_act" (:func:`_serve_qkv`). The new K and V are written
    in place by the rank whose cache shard holds ``pos`` alone.

    With "cache_seq" mapped (and ``REPRO_NAIVE`` unset) the reference's
    flash decode (:func:`_flash_decode`); otherwise the dense decode over
    the cache, on the rank's query heads and their KV heads (a cache
    sharded by positions, under ``REPRO_NAIVE=1``, is gathered first).
    Where q holds every head (the rules leave "heads_act" whole, or the
    flash form's group spans "model") every head is attended. Either way
    the rank's columns of the heads go through its rows of wo, summed
    over "model". Returns (out (b, 1, e), cache)."""
    b = x.shape[0]
    window = cfg.sliding_window
    heads = C.group("heads")
    if positions is None:
        positions = pos + torch.arange(1, device=x.device)
    q, k, v, seq_axes = _serve_qkv(x, p, cfg, positions, cache, rope)
    ck, cv = cache["k"], cache["v"]

    s_loc = ck.shape[1]
    start = C.axis_index(seq_axes) * s_loc
    if not 0 <= pos < s_loc * C.axis_size(seq_axes):
        raise ValueError(f"cache_pos {pos} past the cache's {s_loc * C.axis_size(seq_axes)} "
                         f"positions")
    if start <= pos < start + s_loc:            # this rank's shard holds pos
        ck[:, pos - start] = k[:, 0].to(ck.dtype)
        cv[:, pos - start] = v[:, 0].to(cv.dtype)

    if seq_axes and not naive_mode():
        if "model" in seq_axes and heads is not None and q.shape[2] < cfg.n_heads:
            # every rank of the group combines the same heads: all of them
            q = C.gather(q, heads, 2)
        ck, cv = _group_kv(ck, cv, q.shape[2], cfg, heads)
        out = _flash_decode(q, ck, cv, pos, start, window, C.group_of(seq_axes))
    else:
        grp = C.group_of(seq_axes)
        ck, cv = (C.gather(ck, grp, 1), C.gather(cv, grp, 1)) if grp is not None else (ck, cv)
        ck, cv = _group_kv(ck[:, :pos + 1], cv[:, :pos + 1], q.shape[2], cfg, heads)
        # made on the device: a host tensor copied there would wait for the queue
        qi = pos + torch.arange(1, device=x.device)[:, None]
        kj = torch.arange(pos + 1, device=x.device)[None, :]
        out = _masked_attention(q, ck, cv, _visible(qi, kj, window=window, prefix_rows=True))
    return C.reduce(_out_proj(out, cv, p, b, 1, heads), heads), cache


def _group_kv(ck, cv, h, cfg, grp):
    """The KV heads (dimension 2) of this rank's ``h`` query heads, from K
    and V or a cache that hold them all (as they are where they hold the
    rank's own, or where the rank attends every head). Where the rank's
    heads part a KV group, each head's own KV head (rep 1)."""
    if grp is None or ck.shape[2] * cfg.n_heads == h * cfg.n_kv_heads:
        return ck, cv
    rep = cfg.n_heads // cfg.n_kv_heads
    first = C.rank(grp) * h
    if h % rep == 0 or rep % h == 0:            # whole KV groups, or heads of one
        lo, n = first // rep, max(h // rep, 1)
        return ck.narrow(2, lo, n), cv.narrow(2, lo, n)

    def each_head(t):
        b, s, kv, d = t.shape
        return t[:, :, :, None].expand(b, s, kv, rep, d).reshape(b, s, kv * rep, d).narrow(
            2, first, h)
    return each_head(ck), each_head(cv)


def _flash_decode(q, ck, cv, pos, start, window, grp):
    """The reference's ``_maybe_flash_decode`` (``layers.py:277-360``) on
    this rank's cache shard (positions ``start`` on): the one-token
    queries q (b, 1, h, d) over the shard's KV heads (b, S_loc, kv, d),
    the causal (and window) mask, a local partial softmax (m, l, o) in f32,
    combined over ``grp`` by a max and two sums, then ``o / max(l,
    1e-30)``. Its arithmetic: q rounded to the cache's type, the scores
    summed in f32, the unnormalized probabilities rounded to the cache's
    type for the PV product, which is rounded to it before the f32 sum."""
    b, _, h, hd = q.shape
    kv = ck.shape[2]
    rep = h // kv
    scale = float(1.0 / torch.sqrt(torch.tensor(float(hd))))
    qg = q.reshape(b, 1, kv, rep, hd).to(ck.dtype).float()
    logits = torch.einsum("bskrd,btkd->bkrst", qg, ck.float()) * scale      # (b, kv, rep, 1, t)
    ids = start + torch.arange(ck.shape[1], device=q.device)
    ok = ids <= pos
    if window:
        ok = ok & (ids > pos - window)
    logits = logits.masked_fill(~ok, -torch.inf)
    m = C.all_max(logits.amax(-1), grp)                                      # (b, kv, rep, 1)
    p = torch.exp(logits - m[..., None]).masked_fill(~ok, 0.0)
    l = C.reduce(p.sum(-1), grp)
    o = torch.einsum("bkrst,btkd->bskrd", p.to(cv.dtype).float(), cv.float())
    o = C.reduce(o.to(cv.dtype).float(), grp)                               # (b, 1, kv, rep, d)
    o = o / torch.clamp_min(l, 1e-30).permute(0, 3, 1, 2)[..., None]
    return o.reshape(b, 1, h, hd).to(cv.dtype)


def _out_proj(out, v, p, b, s, grp=None):
    """The output projection of the attention ``out`` (b, s, h, d): the
    reference's attention output is in v's dtype (the cache's on prefill
    and decode), then promoted for the product with wo. Where ``out``
    holds more heads than the rank's rows of wo take (every head, over
    "model" ``grp``), the rank's columns of it."""
    out = out.to(v.dtype).reshape(b, s, -1)
    w = p["wo"].shape[0]
    if out.shape[-1] != w:
        out = out.narrow(-1, C.rank(grp) * w, w)
    dt = torch.promote_types(out.dtype, p["wo"].dtype)
    return out.to(dt) @ p["wo"].to(dt)


_BLOCKWISE_MIN = 8192   # the reference's blockwise attention above this sequence length
_BLOCK_Q = 1024


def _visible(qi, kj, *, causal=True, window=0, prefix_len=0, prefix_rows=False):
    """Bool mask of key ``kj`` visible to query ``qi`` (broadcast): causal,
    cut to the last ``window`` keys, and the first ``prefix_len`` keys
    visible to every query (``prefix_rows``: to the prefix's own queries
    only, as the reference's cache and blockwise paths have it). Not causal:
    every key, as the reference's ``_build_mask``."""
    if not causal:
        return torch.ones(torch.broadcast_shapes(qi.shape, kj.shape), dtype=torch.bool,
                          device=qi.device)
    ok = kj <= qi
    if window:
        ok = ok & (kj > qi - window)
    if prefix_len:
        pre = kj < prefix_len
        ok = ok | ((pre & (qi < prefix_len)) if prefix_rows else pre)
    return ok


def _blockwise_attention(q, k, v, window, prefix_len):
    """The reference's ``_blockwise_causal_attention``: query blocks of
    1,024 rows, each over every key under the causal, window and (prefix
    rows) masks, so the (s, s) scores are never whole."""
    s = q.shape[1]
    kj = torch.arange(s, device=q.device)[None, :]
    outs = []
    for q0 in range(0, s, _BLOCK_Q):
        qi = q0 + torch.arange(_BLOCK_Q, device=q.device)[:, None]
        ok = _visible(qi, kj, window=window, prefix_len=prefix_len, prefix_rows=True)
        outs.append(_masked_attention(q[:, q0:q0 + _BLOCK_Q], k, v, ok))
    return torch.cat(outs, dim=1)


def _masked_attention(q, k, v, ok):
    """q (b, s, h, d) over k, v (b, t, kv, d) with ``ok`` (s, t) the visible
    keys: grouped-query attention without repeating K/V. The reference's
    arithmetic: the logits in the promoted type of q and k, an f32 softmax,
    probabilities rounded to v's type, the PV product accumulated in f32
    and rounded to v's type."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    rep = h // kv
    dt = torch.promote_types(q.dtype, k.dtype)
    # the reference's f32 1 / sqrt(hd), as a host number: a device scalar
    # made on the host would be a blocking copy in every layer of a step
    scale = float(1.0 / torch.sqrt(torch.tensor(float(hd))))
    qg = q.reshape(b, s, kv, rep, hd).to(dt)
    logits = torch.einsum("bskrd,btkd->bkrst", qg, k.to(dt)).float() * scale
    logits = logits.masked_fill(~ok, -torch.inf)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkrst,btkd->bskrd", probs.float(), v.float()).to(v.dtype)
    return out.reshape(b, s, h, hd)


def init_attention_cache(cfg: ModelConfig, batch, max_len, dtype=torch.bfloat16,
                         device=None):
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, max_len, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, kv, hd), dtype=dtype, device=device),
    }


def attention_cache_specs(cfg: ModelConfig):
    return {
        "k": ("batch", "cache_seq", "kv_heads_act", None),
        "v": ("batch", "cache_seq", "kv_heads_act", None),
    }


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(gen, cfg: ModelConfig, dtype=torch.float32, d_ff=None, gated=True):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if gated:
        return {
            "wg": dense_init(gen, (d, f), d, dtype),
            "wu": dense_init(gen, (d, f), d, dtype),
            "wd": dense_init(gen, (f, d), f, dtype),
        }
    return {
        "wu": dense_init(gen, (d, f), d, dtype),
        "wd": dense_init(gen, (f, d), f, dtype),
    }


def mlp_specs(gated=True):
    if gated:
        return {"wg": ("embed", "mlp"), "wu": ("embed", "mlp"), "wd": ("mlp", "embed")}
    return {"wu": ("embed", "mlp"), "wd": ("mlp", "embed")}


def mlp(x, p):
    grp = C.group("mlp")
    x = C.enter(x, grp)
    if "wg" in p:
        h = F.silu(x @ p["wg"]) * (x @ p["wu"])
    else:
        h = F.gelu(x @ p["wu"], approximate="tanh")   # jax.nn.gelu's default
    return C.reduce(h @ p["wd"], grp)


# ---------------------------------------------------------------------------
# embeddings / lm head
# ---------------------------------------------------------------------------


def init_embed(gen, cfg: ModelConfig, dtype=torch.float32):
    p = {"tok": embed_init(gen, (cfg.vocab_padded, cfg.d_model), dtype)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (cfg.d_model, cfg.vocab_padded), cfg.d_model, dtype)
    return p


def embed_specs(cfg: ModelConfig):
    s = {"tok": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        s["head"] = ("embed", "vocab")
    return s


def embed_tokens(p, tokens):
    """The reference's gather ``p["tok"][tokens]``, as ``F.embedding``:
    the same values, and a backward that sums each token's rows in a fixed
    order (indexing's backward accumulates with atomics, whose order varies
    from run to run, and a restarted training run would not replay bit for
    bit). A table sharded by vocab rows is read by
    ``collectives.vocab_embedding``."""
    return C.vocab_embedding(tokens, p["tok"], C.group("vocab"))


def promoted(a, b):
    """a and b in their promoted dtype, as jnp computes mixed operands (the
    same tensors where they are in it already: no copy of an f32 weight)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def lm_logits(p, x):
    """x @ the head (or the tied table's transpose), in the promoted dtype;
    a vocab-sharded head's logits gathered whole on every rank."""
    grp = C.group("vocab")
    x, w = promoted(C.enter(x, grp), p["head"] if "head" in p else p["tok"].T)
    return C.gather(x @ w, grp)
