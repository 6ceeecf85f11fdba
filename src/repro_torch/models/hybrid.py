"""Zamba2-style hybrid, the port of ``repro/models/hybrid.py``: a Mamba2
backbone and one SHARED attention + MLP block, applied after every
``shared_attn_every`` SSM blocks (one weight set, reused each time; each
application keeps its own KV cache).

Execution plan: n_layers = n_groups x shared_attn_every; each group runs
its ``shared_attn_every`` mamba blocks, then the shared block. The
shared block's attention is causal self-attention with RoPE: kernel 12 in
the forward and the prefill. ``remat`` "full" or "dots" recomputes each
group in the backward (the reference's ``jax.checkpoint`` of its group
body). Under rules and a mesh (the sharded train, prefill and decode
steps) the mamba blocks run on the rank's SSM heads and the shared block
on its attention heads and MLP columns, each on its cache shard; the
shared leaves' gradients add up over the groups, as on one device.

Parameters: ``{"embed", "mamba": [block, ...] (n_layers), "shared_attn":
{"ln1", "attn", "ln2", "mlp"}, "ln_f"}``. The cache keeps the reference's
layout, stacked on the groups: ``mamba`` {conv (G, per, b, d_conv - 1,
conv_dim), state (G, per, b, h, p, n)}, f32 whatever the attention
cache's type, and ``attn`` {k, v (G, b, S, kv, hd)}; both are updated in
place.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..distributed import collectives as C
from ..distributed.sharding import stacked
from . import layers as L
from . import ssm
from .transformer import _cast, checkpointed, head_logits


def _groups(cfg: ModelConfig):
    g = cfg.shared_attn_every
    if not g or cfg.n_layers % g:
        raise ValueError(f"n_layers ({cfg.n_layers}) must be a multiple of "
                         f"shared_attn_every ({g})")
    return cfg.n_layers // g, g


def init_params(gen, cfg: ModelConfig, dtype=torch.float32):
    """Random parameters drawn from ``gen`` on its device (shapes only, on
    the meta device, for ``gen=None``)."""
    dev = L._device(gen)
    return {
        "embed": L.init_embed(gen, cfg, dtype),
        "mamba": [ssm.init_mamba_block(gen, cfg, dtype) for _ in range(cfg.n_layers)],
        "shared_attn": {
            "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
            "attn": L.init_attention(gen, cfg, dtype),
            "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
            "mlp": L.init_mlp(gen, cfg, dtype, gated=True),
        },
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }


def param_specs(cfg: ModelConfig):
    return {
        "embed": L.embed_specs(cfg),
        "mamba": stacked(ssm.mamba_block_specs(cfg), "layers"),
        "shared_attn": {
            "ln1": ("embed",),
            "attn": L.attention_specs(cfg),
            "ln2": ("embed",),
            "mlp": L.mlp_specs(gated=True),
        },
        "ln_f": ("embed",),
    }


def _shared_block(cfg, x, sp, *, positions, cache=None, cache_pos=None):
    h, nc = L.attention(L.rms_norm(x, sp["ln1"], cfg.norm_eps), sp["attn"], cfg,
                        positions=positions, cache=cache, cache_pos=cache_pos)
    x = x + h
    x = x + L.mlp(L.rms_norm(x, sp["ln2"], cfg.norm_eps), sp["mlp"])
    return x, nc


def forward(params, cfg: ModelConfig, tokens, *, compute_dtype=torch.bfloat16,
            remat: str = "full", prefix_embeds=None):
    """tokens (b, s) -> logits (b, s, v_padded), f32."""
    n_groups, per = _groups(cfg)
    h = L.embed_tokens(params["embed"], tokens).to(compute_dtype)
    positions = torch.arange(h.shape[1], device=h.device)

    def group_body(x, blocks, shared):
        for lp in blocks:
            x = ssm.mamba_forward(_cast(lp, compute_dtype), cfg, x)
        return _shared_block(cfg, x, _cast(shared, compute_dtype), positions=positions)[0]

    for g in range(n_groups):
        h = checkpointed(group_body, remat, h, params["mamba"][g * per:(g + 1) * per],
                         params["shared_attn"])
    return head_logits(params, cfg, h, compute_dtype)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _attn_cache(cfg, batch, max_len, dtype, device):
    n_groups, _ = _groups(cfg)
    one = L.init_attention_cache(cfg, batch, max_len, dtype, device="meta")
    return {name: torch.zeros((n_groups, *a.shape), dtype=dtype, device=device)
            for name, a in one.items()}


def init_cache(cfg: ModelConfig, batch, max_len, dtype=torch.bfloat16, device=None):
    """The mamba caches (f32) stacked on (groups, per) and the attention
    caches (``dtype``) on the groups."""
    n_groups, per = _groups(cfg)
    one = ssm.init_mamba_cache(cfg, batch, device="meta")
    mamba = {name: torch.zeros((n_groups, per, *a.shape), dtype=torch.float32, device=device)
             for name, a in one.items()}
    return {"mamba": mamba, "attn": _attn_cache(cfg, batch, max_len, dtype, device)}


def cache_specs(cfg: ModelConfig):
    return {"mamba": stacked(ssm.mamba_cache_specs(cfg), "layers", None),
            "attn": stacked(L.attention_cache_specs(cfg), "layers")}


def _serve(params, cfg, h, cache, pos, compute_dtype, *, prefill_mode):
    """(h, mamba caches): the blocks over h at cache position ``pos``. The
    prefill takes each mamba block's cache from its full-sequence run and
    returns them stacked; the decode steps each block's recurrence in place
    (and returns None); the shared block writes each group's KV cache in
    place."""
    n_groups, per = _groups(cfg)
    positions = pos + torch.arange(h.shape[1], device=h.device)
    shared = _cast(params["shared_attn"], compute_dtype)
    m_caches = []
    for g in range(n_groups):
        for j in range(per):
            lp = _cast(params["mamba"][g * per + j], compute_dtype)
            if prefill_mode:
                h, c = ssm.mamba_forward(lp, cfg, h, return_cache=True)
                m_caches.append(c)
            else:
                lc = {name: t[g, j] for name, t in cache["mamba"].items()}   # views
                h, _ = ssm.mamba_decode_step(lp, cfg, h, lc)
        a_cache = {name: t[g] for name, t in cache["attn"].items()}          # views
        h, _ = _shared_block(cfg, h, shared, positions=positions, cache=a_cache,
                             cache_pos=pos)
    if not prefill_mode:
        return h, None
    return h, {name: torch.stack([c[name] for c in m_caches])
               .reshape(n_groups, per, *m_caches[0][name].shape) for name in ("conv", "state")}


def decode_step(params, cfg: ModelConfig, tokens, cache, pos, *, compute_dtype=torch.bfloat16):
    """One token step at position ``pos`` (an int); the cache is updated in
    place. Returns (logits, cache)."""
    h = L.embed_tokens(params["embed"], tokens).to(compute_dtype)
    h, _ = _serve(params, cfg, h, cache, int(pos), compute_dtype, prefill_mode=False)
    return head_logits(params, cfg, h, compute_dtype), cache


def prefill(params, cfg: ModelConfig, tokens, max_len, *, compute_dtype=torch.bfloat16,
            cache_dtype=torch.bfloat16):
    """Full-sequence forward that also fills a new cache of ``max_len``
    attention positions. Returns (logits, cache)."""
    b, _ = tokens.shape
    cache = {"attn": C.local_zeros(_attn_cache(cfg, b, max_len, cache_dtype, "meta"),
                                   cache_specs(cfg)["attn"], tokens.device)}
    h = L.embed_tokens(params["embed"], tokens).to(compute_dtype)
    h, mamba = _serve(params, cfg, h, cache, 0, compute_dtype, prefill_mode=True)
    return head_logits(params, cfg, h, compute_dtype), {"mamba": mamba, "attn": cache["attn"]}
