"""Encoder-decoder backbone (seamless-m4t-large-v2), the port of
``repro/models/encdec.py``.

The audio front end is a stub: ``src_embeds`` (b, s_src, d_model) are
precomputed frame embeddings. The backbone is ``n_enc_layers`` of
bidirectional self-attention and ``n_layers`` decoder layers of causal
self-attention and cross-attention over the encoder's output, each with
the non-gated MLP. Kernel 12 runs three times a layer in the prefill: in
the encoder (full), in the decoder's self-attention (causal, into the
cache) and in its cross-attention where the source has as many frames as
the prompt has tokens. The decode step re-projects ``enc_out`` into K and
V in every layer at every step, as the reference does (no cross cache).

Parameters: ``{"embed", "enc_layers": [...], "dec_layers": [...],
"ln_enc", "ln_f"}``. The decoder's self-attention cache is stacked on
the layers, (n_layers, b, S, kv, hd) for K and for V, updated in place.
Under rules and a mesh (the sharded train, prefill and decode steps)
each attention runs on the rank's heads and the MLP on its columns; the
cross-attention's ``enter`` of ``enc_out`` sums its gradient over the
ranks' heads. The sharded prefill's ``enc_out`` is the rank's rows, whole
over "model".
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..distributed import collectives as C
from ..distributed.sharding import stacked
from . import layers as L
from . import transformer as T
from .transformer import _cast, checkpointed


def init_enc_layer(gen, cfg: ModelConfig, dtype=torch.float32):
    dev = L._device(gen)
    return {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "attn": L.init_attention(gen, cfg, dtype),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "mlp": L.init_mlp(gen, cfg, dtype, gated=False),
    }


def init_dec_layer(gen, cfg: ModelConfig, dtype=torch.float32):
    dev = L._device(gen)
    return {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "self_attn": L.init_attention(gen, cfg, dtype),
        "ln_x": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "cross_attn": L.init_attention(gen, cfg, dtype),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "mlp": L.init_mlp(gen, cfg, dtype, gated=False),
    }


def init_params(gen, cfg: ModelConfig, dtype=torch.float32):
    """Random parameters drawn from ``gen`` on its device (shapes only, on
    the meta device, for ``gen=None``)."""
    dev = L._device(gen)
    return {
        "embed": L.init_embed(gen, cfg, dtype),
        "enc_layers": [init_enc_layer(gen, cfg, dtype) for _ in range(cfg.n_enc_layers)],
        "dec_layers": [init_dec_layer(gen, cfg, dtype) for _ in range(cfg.n_layers)],
        "ln_enc": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }


def param_specs(cfg: ModelConfig):
    enc = {"ln1": ("embed",), "attn": L.attention_specs(cfg),
           "ln2": ("embed",), "mlp": L.mlp_specs(gated=False)}
    dec = {"ln1": ("embed",), "self_attn": L.attention_specs(cfg),
           "ln_x": ("embed",), "cross_attn": L.attention_specs(cfg),
           "ln2": ("embed",), "mlp": L.mlp_specs(gated=False)}
    return {"embed": L.embed_specs(cfg), "enc_layers": stacked(enc, "layers"),
            "dec_layers": stacked(dec, "layers"), "ln_enc": ("embed",), "ln_f": ("embed",)}


def encode(params, cfg: ModelConfig, src_embeds, *, compute_dtype=torch.bfloat16,
           remat: str = "full"):
    """(b, s_src, d) frame embeddings -> the encoder's output, normed by
    ``ln_enc``, in ``compute_dtype``."""
    h = src_embeds.to(compute_dtype)
    positions = torch.arange(h.shape[1], device=h.device)

    def body(x, lp):
        lp = _cast(lp, compute_dtype)
        a, _ = L.attention(L.rms_norm(x, lp["ln1"], cfg.norm_eps), lp["attn"], cfg,
                           positions=positions, causal=False)
        x = x + a
        return x + L.mlp(L.rms_norm(x, lp["ln2"], cfg.norm_eps), lp["mlp"])

    for lp in params["enc_layers"]:
        h = checkpointed(body, remat, h, lp)
    return L.rms_norm(h, params["ln_enc"].to(compute_dtype), cfg.norm_eps)


def _dec_layer(cfg, x, lp, enc_out, *, positions, cache=None, cache_pos=None):
    a, nc = L.attention(L.rms_norm(x, lp["ln1"], cfg.norm_eps), lp["self_attn"], cfg,
                        positions=positions, cache=cache, cache_pos=cache_pos)
    x = x + a
    c, _ = L.attention(L.rms_norm(x, lp["ln_x"], cfg.norm_eps), lp["cross_attn"], cfg,
                       x_kv=enc_out, rope=False)
    x = x + c
    x = x + L.mlp(L.rms_norm(x, lp["ln2"], cfg.norm_eps), lp["mlp"])
    return x, nc


def decode_train(params, cfg: ModelConfig, enc_out, tgt_tokens, *,
                 compute_dtype=torch.bfloat16, remat: str = "full"):
    """The decoder over the whole target sequence (no cache): logits (b,
    s_tgt, v_padded), f32."""
    h = L.embed_tokens(params["embed"], tgt_tokens).to(compute_dtype)
    positions = torch.arange(h.shape[1], device=h.device)

    def body(x, lp, enc):
        return _dec_layer(cfg, x, _cast(lp, compute_dtype), enc, positions=positions)[0]

    for lp in params["dec_layers"]:
        h = checkpointed(body, remat, h, lp, enc_out)
    return T.head_logits(params, cfg, h, compute_dtype)


def forward(params, cfg: ModelConfig, batch, *, compute_dtype=torch.bfloat16,
            remat: str = "full"):
    """batch = {"src_embeds": (b, s_src, d), "tokens": (b, s_tgt)}."""
    enc_out = encode(params, cfg, batch["src_embeds"], compute_dtype=compute_dtype, remat=remat)
    return decode_train(params, cfg, enc_out, batch["tokens"], compute_dtype=compute_dtype,
                        remat=remat)


# ---------------------------------------------------------------------------
# serving: the decoder's steps against the cached encoder output
# ---------------------------------------------------------------------------


#: the decoder's self-attention cache, a layer's stacked on (n_layers,)
init_cache = T.init_cache
cache_specs = T.cache_specs


def _run_decoder(params, cfg, h, cache, pos, enc_out, compute_dtype):
    positions = pos + torch.arange(h.shape[1], device=h.device)
    for i, lp in enumerate(params["dec_layers"]):
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}   # views: written in place
        h, _ = _dec_layer(cfg, h, _cast(lp, compute_dtype), enc_out, positions=positions,
                          cache=layer_cache, cache_pos=pos)
    return T.head_logits(params, cfg, h, compute_dtype)


def decode_step(params, cfg: ModelConfig, tokens, cache, pos, enc_out, *,
                compute_dtype=torch.bfloat16):
    """One token step at position ``pos`` (an int) against ``enc_out``; the
    cache is updated in place. Returns (logits, cache)."""
    h = L.embed_tokens(params["embed"], tokens).to(compute_dtype)
    return _run_decoder(params, cfg, h, cache, int(pos), enc_out, compute_dtype), cache


def prefill(params, cfg: ModelConfig, batch, max_len, *, compute_dtype=torch.bfloat16,
            cache_dtype=torch.bfloat16):
    """Encode ``src_embeds`` and prefill the decoder's self-attention cache
    with the target tokens. Returns (logits, cache, enc_out)."""
    enc_out = encode(params, cfg, batch["src_embeds"], compute_dtype=compute_dtype)
    tokens = batch["tokens"]
    cache = C.local_zeros(init_cache(cfg, tokens.shape[0], max_len, cache_dtype,
                                     device="meta"), cache_specs(cfg), tokens.device)
    h = L.embed_tokens(params["embed"], tokens).to(compute_dtype)
    return _run_decoder(params, cfg, h, cache, 0, enc_out, compute_dtype), cache, enc_out
