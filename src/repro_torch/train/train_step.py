"""The serve steps, the port of ``build_prefill`` and
``build_decode_step`` in ``repro/train/train_step.py`` (used by
launch/serve.py). The loss, the optimizer step and gradient compression
wait for training (ROADMAP queue 1 item 12).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import get_api


def build_decode_step(cfg: ModelConfig, compute_dtype=torch.bfloat16):
    api = get_api(cfg)

    def serve_step(params, tokens, cache, pos, extras=None):
        logits, cache = api.decode_step(params, cfg, tokens, cache, pos,
                                        extras, compute_dtype=compute_dtype)
        # mask vocab-padding columns (the embedding table is padded to 128)
        logits = logits[..., : cfg.vocab_size]
        # torch.argmax returns the first index of the maximum, like jnp.argmax
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, cache

    return serve_step


def build_prefill(cfg: ModelConfig, max_len: int, compute_dtype=torch.bfloat16):
    api = get_api(cfg)

    def prefill_step(params, batch):
        return api.prefill(params, cfg, batch, max_len, compute_dtype=compute_dtype)

    return prefill_step
