"""Uniform model API over the families, the port of
``repro/models/model_zoo.py``.

ModelAPI:
  init_params(gen, cfg, dtype)        -> parameter dict (on gen's device)
  param_specs(cfg)                    -> the reference's tree of logical axes
  forward(params, cfg, batch, **kw)   -> logits (b, s, v)
  init_cache(cfg, batch, max_len, dtype, device) -> decode cache
  cache_specs(cfg)                    -> the cache's logical axes
  decode_step(params, cfg, tokens, cache, pos, extras, **kw) -> (logits, cache)
  prefill(params, cfg, batch, max_len, **kw) -> (logits, cache[, enc_out])

Batch layouts (int tokens and labels):
  dense/ssm/hybrid/moe : {tokens, labels}
  encdec           : {src_embeds (b, s, d), tokens, labels}
  vlm              : {image_embeds (b, p, d), tokens, labels}

The encdec decode step takes ``extras["enc_out"]``, the prefill's third
output; the moe forward takes ``return_aux=True`` for (logits, aux loss).
A spec tree stacks a family's layers as the reference does (("layers",
...) leaves); the port keeps them as a list (``launch/mesh.py::specs_like``
lays a spec tree over a parameter tree).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..configs.base import ModelConfig
from . import encdec, hybrid, moe, ssm, transformer, vlm


@dataclass(frozen=True)
class ModelAPI:
    family: str
    init_params: Callable
    param_specs: Callable
    forward: Callable                  # (params, cfg, batch, **kw) -> logits
    init_cache: Callable
    cache_specs: Callable
    decode_step: Callable              # (params, cfg, tokens, cache, pos, extras)
    prefill: Callable


def _dense_forward(mod):
    def fwd(params, cfg, batch, **kw):
        return mod.forward(params, cfg, batch["tokens"], **kw)
    return fwd


def _dense_decode(mod):
    def step(params, cfg, tokens, cache, pos, extras=None, **kw):
        return mod.decode_step(params, cfg, tokens, cache, pos, **kw)
    return step


def _dense_prefill(mod):
    def pre(params, cfg, batch, max_len, **kw):
        return mod.prefill(params, cfg, batch["tokens"], max_len, **kw)
    return pre


def _encdec_decode(params, cfg, tokens, cache, pos, extras=None, **kw):
    return encdec.decode_step(params, cfg, tokens, cache, pos, extras["enc_out"], **kw)


def _token_family(name, mod):
    return ModelAPI(name, mod.init_params, mod.param_specs, _dense_forward(mod),
                    mod.init_cache, mod.cache_specs, _dense_decode(mod), _dense_prefill(mod))


_FAMILIES: dict[str, ModelAPI] = {
    "dense": _token_family("dense", transformer),
    "ssm": _token_family("ssm", ssm),
    "hybrid": _token_family("hybrid", hybrid),
    "encdec": ModelAPI("encdec", encdec.init_params, encdec.param_specs, encdec.forward,
                       encdec.init_cache, encdec.cache_specs, _encdec_decode, encdec.prefill),
    "vlm": ModelAPI("vlm", vlm.init_params, vlm.param_specs, vlm.forward, vlm.init_cache,
                    vlm.cache_specs, _dense_decode(vlm), vlm.prefill),
    "moe": _token_family("moe", moe),
}


def get_api(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r} ({cfg.arch_id}); "
                         f"the families are {', '.join(_FAMILIES)}")
    return _FAMILIES[cfg.family]


def train_batch_specs(cfg: ModelConfig, batch: int, seq: int) -> dict[str, torch.Tensor]:
    """A train batch's shapes and dtypes, as meta tensors (the reference's
    ShapeDtypeStructs): int32 tokens and labels, bf16 stub embeddings."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    b = {"tokens": meta((batch, seq), torch.int32), "labels": meta((batch, seq), torch.int32)}
    if cfg.family == "encdec":
        b["src_embeds"] = meta((batch, seq, cfg.d_model), torch.bfloat16)
    if cfg.family == "vlm":
        b["image_embeds"] = meta((batch, cfg.n_prefix_tokens, cfg.d_model), torch.bfloat16)
    return b


def decode_inputs_specs(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    """One decode step's inputs at a cache of ``cache_len`` positions, as
    meta tensors: tokens (batch, 1), the family's bf16 cache, pos, and for
    encdec ``extras["enc_out"]``."""
    out = {"tokens": torch.empty((batch, 1), dtype=torch.int32, device="meta"),
           "cache": get_api(cfg).init_cache(cfg, batch, cache_len, torch.bfloat16,
                                            device="meta"),
           "pos": torch.empty((), dtype=torch.int32, device="meta")}
    if cfg.family == "encdec":
        out["extras"] = {"enc_out": torch.empty((batch, cache_len, cfg.d_model),
                                                dtype=torch.bfloat16, device="meta")}
    return out


def make_train_batch(cfg: ModelConfig, batch: int, seq: int,
                     gen: torch.Generator) -> dict[str, torch.Tensor]:
    """Random int64 tokens, labels (the tokens shifted left by one) and,
    for encdec and vlm, the stub front end's embeddings (f32 normal draws
    times 0.02: ``src_embeds`` (batch, seq, d_model), ``image_embeds``
    (batch, n_prefix_tokens, d_model)), all drawn from ``gen`` on its
    device."""
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=gen.device)
    out = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    if cfg.family == "encdec":
        out["src_embeds"] = torch.randn((batch, seq, cfg.d_model), generator=gen,
                                        device=gen.device) * 0.02
    if cfg.family == "vlm":
        out["image_embeds"] = torch.randn((batch, cfg.n_prefix_tokens, cfg.d_model),
                                          generator=gen, device=gen.device) * 0.02
    return out
