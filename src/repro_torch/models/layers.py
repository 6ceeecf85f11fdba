"""Transformer building blocks, the port of ``repro/models/layers.py``.

Parameters are nested dicts of tensors, as in the reference, with the
weights in its (in, out) layout so that ``x @ w`` needs no transpose.
Initializers draw from an explicit ``torch.Generator`` and make the tensors
on its device; ``gen=None`` gives the shapes alone, on the meta device.

Attention routes self-attention: the no-cache forward, the prefill into
the KV cache at ``cache_pos=0`` and the decode over the cache, with the
reference's causal, sliding-window and prefix-LM masks. Wherever it
computes the function of kernel 12 (attention over equal query and key
lengths under a plain causal mask, or full without a cache) it calls
``ops.flash_attention``: the hand-written kernel on a CUDA tensor (with its
hand-written backward when training), its plain version on the CPU. A
window that cuts into the sequence, a prefix, and the decode (queries
past the start of the cache) stay plain torch, as the reference keeps
them in jnp: its full-scores path, or, past 8,192 positions in multiples
of 1,024, its query-blockwise path. The two paths part where a window and
a prefix meet, and each is mirrored as it is (ROADMAP queue 3).
Cross-attention raises. The reference's sharding constraints are the
identity on one device and are dropped.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops

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


def _unrouted(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1 item 12)")


def attention(
    x,
    p,
    cfg: ModelConfig,
    *,
    positions=None,            # (s,) int positions of x in the sequence
    causal=True,
    prefix_len=0,
    x_kv=None,                 # cross-attention source: not ported
    cache=None,                # dict(k, v) (b, S_max, kv, d), written in place
    cache_pos=None,            # int: write offset in the cache
    rope=True,
):
    """Returns (out (b, s, e), cache).

    With a cache, the new K and V are written into it IN PLACE (the
    reference returns an updated copy; on the card a copy of the cache per
    layer and step would cost its whole size in memory traffic), and the
    same dict is returned."""
    if x_kv is not None:
        raise _unrouted("cross-attention")
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    window = cfg.sliding_window

    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)

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

    t = k.shape[1]
    plain_mask = not causal or (not prefix_len and (not window or t <= window))
    if q_offset == 0 and plain_mask:
        # kernel 12's function: (b, h, s, d) views of q and of k, v (the
        # cache slice on the prefill), read in place by the kernel
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal).transpose(1, 2)
    elif cache is None and s > _BLOCKWISE_MIN and s % _BLOCK_Q == 0:
        out = _blockwise_attention(q, k, v, window, prefix_len)
    else:
        qi = q_offset + torch.arange(s, device=q.device)[:, None]
        kj = torch.arange(t, device=q.device)[None, :]
        if cache is None:   # the reference's _build_mask
            ok = _visible(qi, kj, causal=causal, window=window, prefix_len=prefix_len)
        else:               # its cache path's mask: the prefix only among prefix rows
            ok = _visible(qi, kj, window=window, prefix_len=prefix_len, prefix_rows=True)
        out = _masked_attention(q, k, v, ok)
    # the reference's attention output is in v's dtype (the cache's on
    # prefill and decode), then promoted for the output projection
    out = out.to(v.dtype).reshape(b, s, h * hd)
    dt = torch.promote_types(out.dtype, p["wo"].dtype)
    return out.to(dt) @ p["wo"].to(dt), cache


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


def mlp(x, p):
    if "wg" in p:
        h = F.silu(x @ p["wg"]) * (x @ p["wu"])
    else:
        h = F.gelu(x @ p["wu"], approximate="tanh")   # jax.nn.gelu's default
    return h @ p["wd"]


# ---------------------------------------------------------------------------
# embeddings / lm head
# ---------------------------------------------------------------------------


def init_embed(gen, cfg: ModelConfig, dtype=torch.float32):
    p = {"tok": embed_init(gen, (cfg.vocab_padded, cfg.d_model), dtype)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (cfg.d_model, cfg.vocab_padded), cfg.d_model, dtype)
    return p


def embed_tokens(p, tokens):
    """The reference's gather ``p["tok"][tokens]``, as ``F.embedding``:
    the same values, and a backward that sums each token's rows in a fixed
    order (indexing's backward accumulates with atomics, whose order varies
    from run to run, and a restarted training run would not replay bit for
    bit)."""
    return F.embedding(tokens, p["tok"])


def lm_logits(p, x):
    w = p["head"] if "head" in p else p["tok"].T
    return x @ w
