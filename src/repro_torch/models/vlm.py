"""PaliGemma-style VLM backbone, the port of ``repro/models/vlm.py``: the
dense decoder with an image-embedding prefix.

The SigLIP vision tower is a stub: ``image_embeds`` (b, p, d_model) are
precomputed patch embeddings, prepended to the text tokens. The prefill
runs over [image prefix + text] into the KV cache at position 0, the
prefix bidirectional among its own positions (the reference's cache-path
mask), the text causal; the decode counts positions past the prefix. A
prefix is never kernel 12's function (a plain causal or full mask), so
no call here reaches it. Under rules and a mesh the prefill and decode
run on the rank's heads and cache shard (``layers.attention``).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..distributed import collectives as C
from . import layers as L
from . import transformer as T

init_params = T.init_params
param_specs = T.param_specs
init_cache = T.init_cache
cache_specs = T.cache_specs


def forward(params, cfg: ModelConfig, batch, *, compute_dtype=torch.bfloat16,
            remat: str = "full"):
    """batch = {"image_embeds": (b, p, d), "tokens": (b, s)} -> the text
    positions' logits (b, s, v_padded), f32."""
    return T.forward(params, cfg, batch["tokens"], compute_dtype=compute_dtype, remat=remat,
                     prefix_embeds=batch["image_embeds"])


def prefill(params, cfg: ModelConfig, batch, max_len, *, compute_dtype=torch.bfloat16,
            cache_dtype=torch.bfloat16):
    """Prefill over [image prefix + text tokens] into a new cache of
    ``max_len`` positions, whose first p hold the prefix's keys and values.
    Returns (the text positions' logits, cache)."""
    img, tokens = batch["image_embeds"], batch["tokens"]
    b, p = img.shape[:2]
    cache = C.local_zeros(T.init_cache(cfg, b, max_len, cache_dtype, device="meta"),
                          T.cache_specs(cfg), tokens.device)
    h = torch.cat([img.to(compute_dtype),
                   L.embed_tokens(params["embed"], tokens).to(compute_dtype)], dim=1)
    h = T._run_layers(params, cfg, h, cache, 0, compute_dtype, prefix_len=p)
    return T.head_logits(params, cfg, h[:, p:], compute_dtype), cache


def decode_step(params, cfg: ModelConfig, tokens, cache, pos, *, compute_dtype=torch.bfloat16):
    """``pos`` counts [prefix + generated] positions (the cache write offset)."""
    return T.decode_step(params, cfg, tokens, cache, pos, compute_dtype=compute_dtype)
