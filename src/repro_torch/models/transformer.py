"""Dense decoder-only transformer LM (granite / stablelm / danube / qwen), the
port of ``repro/models/transformer.py``.

Parameters: ``{"embed": {"tok", "head"}, "layers": [per-layer dict, ...],
"ln_f"}``; the reference's scan over stacked layers is a Python loop over
the list. ``remat`` selects what a differentiated forward keeps, as the
reference's ``jax.checkpoint`` around each layer does: ``"none"`` keeps
every activation, ``"full"`` recomputes each layer in the backward
(``torch.utils.checkpoint``, non-reentrant), ``"dots"`` keeps the outputs
of the projection and MLP matmuls (those with no batch dims, the
reference's ``checkpoint_dots_with_no_batch_dims``) and recomputes the
rest. The values are the same under every setting. The KV cache keeps the
reference's stacked layout, (L, b, S, kv, hd) for K and for V, and is
updated in place.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ModelConfig
from ..distributed import collectives as C
from ..distributed.sharding import bind, stacked
from . import layers as L


def gated(cfg: ModelConfig) -> bool:
    return "mlp_nogate" not in cfg.notes


def init_layer(gen, cfg: ModelConfig, dtype=torch.float32):
    dev = L._device(gen)
    return {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "attn": L.init_attention(gen, cfg, dtype),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "mlp": L.init_mlp(gen, cfg, dtype, gated=gated(cfg)),
    }


def layer_specs(cfg: ModelConfig):
    return {
        "ln1": ("embed",),
        "attn": L.attention_specs(cfg),
        "ln2": ("embed",),
        "mlp": L.mlp_specs(gated=gated(cfg)),
    }


def init_params(gen, cfg: ModelConfig, dtype=torch.float32):
    """Random parameters drawn from ``gen`` on its device (shapes only, on
    the meta device, for ``gen=None``)."""
    return {
        "embed": L.init_embed(gen, cfg, dtype),
        "layers": [init_layer(gen, cfg, dtype) for _ in range(cfg.n_layers)],
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=L._device(gen)),
    }


def param_specs(cfg: ModelConfig):
    """The reference's specs, whose layers are one stack: ("layers", ...)
    before each layer leaf's names (the port's ``params["layers"]`` is a
    list of layers, each with the names after "layers")."""
    return {
        "embed": L.embed_specs(cfg),
        "layers": stacked(layer_specs(cfg), "layers"),
        "ln_f": ("embed",),
    }


def _cast(tree, dtype):
    """The parameter dict in ``dtype`` (the same tensors where they already
    are)."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def _layer_apply(cfg, x, lp, *, positions, prefix_len=0, cache=None, cache_pos=None):
    h, new_cache = L.attention(
        L.rms_norm(x, lp["ln1"], cfg.norm_eps), lp["attn"], cfg,
        positions=positions, prefix_len=prefix_len, cache=cache, cache_pos=cache_pos,
    )
    x = x + h
    x = x + L.mlp(L.rms_norm(x, lp["ln2"], cfg.norm_eps), lp["mlp"])
    return x, new_cache


def _save_dots(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of 2-D matmuls (x @ w reaches
    ``aten.mm``; the attention einsums reach ``aten.bmm`` and are
    recomputed), recompute everything else."""
    if op == torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_REMAT = ("none", "full", "dots")


def checkpointed(body, remat: str, *args, policy=None):
    """``body(*args)`` under a ``remat`` setting: as is for "none" (or
    without grad); recomputed in the backward for "full", and for "dots",
    which keeps what ``policy`` saves (the dense layers' ``_save_dots``; the
    other families' reference wraps its blocks in a plain ``jax.checkpoint``
    for "dots" too, and passes none). The recomputation runs under the
    sharding rules of the forward."""
    if remat not in _REMAT:
        raise ValueError(f"remat must be one of {_REMAT}, got {remat!r}")
    if remat == "none" or not torch.is_grad_enabled():
        return body(*args)
    kw = {}
    if remat == "dots" and policy is not None:
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, policy)
    return checkpoint(bind(body), *args, use_reentrant=False, **kw)


def forward_embeds(params, cfg: ModelConfig, h, *, prefix_len=0,
                   compute_dtype=torch.bfloat16, remat: str = "full"):
    """(b, s, e) embeddings -> (b, s, e) final hidden states."""
    h = h.to(compute_dtype)
    positions = torch.arange(h.shape[1], device=h.device)

    def body(x, lp):
        return _layer_apply(cfg, x, _cast(lp, compute_dtype), positions=positions,
                            prefix_len=prefix_len)[0]

    for lp in params["layers"]:
        h = checkpointed(body, remat, h, lp, policy=_save_dots)
    return L.rms_norm(h, params["ln_f"].to(compute_dtype), cfg.norm_eps)


def forward(params, cfg: ModelConfig, tokens, *, compute_dtype=torch.bfloat16,
            remat: str = "full", prefix_embeds=None):
    """tokens (b, s) -> logits (b, s, v_padded), f32. ``prefix_embeds``
    (b, p, e) are prepended bidirectional positions (the VLM and audio
    front ends' stub embeddings); the logits are those of the tokens."""
    h = L.embed_tokens(params["embed"], tokens)
    prefix_len = 0
    if prefix_embeds is not None:
        prefix_len = prefix_embeds.shape[1]
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
    h = forward_embeds(params, cfg, h, prefix_len=prefix_len,
                       compute_dtype=compute_dtype, remat=remat)
    if prefix_len:
        h = h[:, prefix_len:]
    return L.lm_logits(params["embed"], h.float())


# ---------------------------------------------------------------------------
# serving: prefill + decode with a stacked KV cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch, max_len, dtype=torch.bfloat16, device=None):
    """A layer's cache (its shapes taken on the meta device) stacked on a
    leading (n_layers,) axis."""
    one = L.init_attention_cache(cfg, batch, max_len, dtype, device="meta")
    return {name: torch.zeros((cfg.n_layers, *a.shape), dtype=dtype, device=device)
            for name, a in one.items()}


def cache_specs(cfg: ModelConfig):
    return stacked(L.attention_cache_specs(cfg), "layers")


def head_logits(params, cfg: ModelConfig, h, compute_dtype):
    """The final norm ``ln_f`` and the LM head over h: f32 logits."""
    h = L.rms_norm(h, params["ln_f"].to(compute_dtype), cfg.norm_eps)
    return L.lm_logits(params["embed"], h.float())


def _run_layers(params, cfg, h, cache, pos, compute_dtype, prefix_len=0):
    positions = pos + torch.arange(h.shape[1], device=h.device)
    for i, lp in enumerate(params["layers"]):
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}   # views: written in place
        h, _ = _layer_apply(cfg, h, _cast(lp, compute_dtype), positions=positions,
                            prefix_len=prefix_len, cache=layer_cache, cache_pos=pos)
    return h


def decode_step(params, cfg: ModelConfig, tokens, cache, pos,
                *, compute_dtype=torch.bfloat16):
    """One token step. tokens (b, 1); cache stacked (L, b, S, kv, hd),
    updated in place; pos the current write position (an int). Returns
    (logits, cache)."""
    h = L.embed_tokens(params["embed"], tokens).to(compute_dtype)
    h = _run_layers(params, cfg, h, cache, int(pos), compute_dtype)
    return head_logits(params, cfg, h, compute_dtype), cache


def prefill(params, cfg: ModelConfig, tokens, max_len,
            *, compute_dtype=torch.bfloat16, cache_dtype=torch.bfloat16):
    """Full-sequence forward that also fills a new KV cache of ``max_len``
    positions. Returns (logits, cache)."""
    b, _ = tokens.shape
    # under rules and a mesh, this rank's shard of the cache
    cache = C.local_zeros(init_cache(cfg, b, max_len, cache_dtype, device="meta"),
                          cache_specs(cfg), tokens.device)
    h = L.embed_tokens(params["embed"], tokens).to(compute_dtype)
    h = _run_layers(params, cfg, h, cache, 0, compute_dtype)
    return head_logits(params, cfg, h, compute_dtype), cache
