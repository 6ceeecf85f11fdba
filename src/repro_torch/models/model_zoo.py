"""Uniform model API, the port of ``repro/models/model_zoo.py`` for the
dense family.

ModelAPI:
  init_params(gen, cfg, dtype)        -> parameter dict (on gen's device)
  forward(params, cfg, batch, **kw)   -> logits (b, s, v)
  init_cache(cfg, batch, max_len, dtype, device) -> decode cache
  decode_step(params, cfg, tokens, cache, pos, extras, **kw) -> (logits, cache)
  prefill(params, cfg, batch, max_len, **kw) -> (logits, cache)

The reference's sharding specs have no counterpart on one device. The
moe, ssm, hybrid, encdec and vlm families raise NotImplementedError.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..configs.base import ModelConfig
from . import transformer


@dataclass(frozen=True)
class ModelAPI:
    family: str
    init_params: Callable
    forward: Callable                  # (params, cfg, batch, **kw) -> logits
    init_cache: Callable
    decode_step: Callable              # (params, cfg, tokens, cache, pos, extras)
    prefill: Callable


def _dense_forward(params, cfg, batch, **kw):
    return transformer.forward(params, cfg, batch["tokens"], **kw)


def _dense_decode(params, cfg, tokens, cache, pos, extras=None, **kw):
    return transformer.decode_step(params, cfg, tokens, cache, pos, **kw)


def _dense_prefill(params, cfg, batch, max_len, **kw):
    return transformer.prefill(params, cfg, batch["tokens"], max_len, **kw)


_DENSE = ModelAPI("dense", transformer.init_params, _dense_forward,
                  transformer.init_cache, _dense_decode, _dense_prefill)


def get_api(cfg: ModelConfig) -> ModelAPI:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.arch_id}) is not ported yet "
            "(ROADMAP queue 1 item 12); the port routes the dense family")
    return _DENSE


def make_train_batch(cfg: ModelConfig, batch: int, seq: int,
                     gen: torch.Generator) -> dict[str, torch.Tensor]:
    """Random int64 tokens, and labels (the tokens shifted left by one),
    drawn from ``gen`` on its device: the dense family's batch. The other
    families' stub front-end embeddings come with their port."""
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=gen.device)
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
