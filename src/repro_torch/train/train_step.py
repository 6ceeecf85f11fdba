"""The train step and the serve steps, the port of
``repro/train/train_step.py``.

``build_train_step(cfg, tcfg)`` returns
    (params, opt_state, batch) -> (params, opt_state, metrics)
The gradients come from ``torch.autograd.grad`` over the parameter leaves
(:func:`value_and_grad`); with ``tcfg.microbatch`` > 1 the batch is split
into that many slices whose gradients are summed in order and scaled by
1/n, as the reference's scan does (activation memory ∝ one microbatch).
The AdamW update runs in place under ``torch.no_grad()``, so the returned
parameters and state are the tensors passed in, updated. The serve steps
are used by launch/serve.py.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig, TrainConfig
from ..models import get_api
from ._tree import leaves, tree_map, unflatten
from .compression import compress_decompress
from .optimizer import adamw_update


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def softmax_xent(logits, labels, z_loss=0.0):
    """Mean token cross-entropy (+ z-loss) in f32. logits (b, s, v)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = torch.mean(lse - ll)
    if z_loss:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss


def loss_fn(params, cfg: ModelConfig, batch, tcfg: TrainConfig):
    """(loss, {"xent", "aux"}). The dense family has no auxiliary loss (the
    reference's moe router loss comes with that family's port)."""
    logits = get_api(cfg).forward(params, cfg, batch,
                                  compute_dtype=_dtype(tcfg.compute_dtype), remat=tcfg.remat)
    loss = softmax_xent(logits, batch["labels"], tcfg.z_loss)
    return loss, {"xent": loss, "aux": 0.0}


def value_and_grad(params, cfg: ModelConfig, batch, tcfg: TrainConfig):
    """(loss, gradients in the parameters' tree), the gradients from
    ``torch.autograd.grad`` over detached views of the leaves (the caller's
    tensors need no ``requires_grad``)."""
    live = [p.detach().requires_grad_() for p in leaves(params)]
    loss, _ = loss_fn(unflatten(params, live), cfg, batch, tcfg)
    grads = torch.autograd.grad(loss, live)
    return loss.detach(), unflatten(params, list(grads))


def _split_microbatches(batch, n):
    def f(x):
        b = x.shape[0]
        assert b % n == 0, f"batch {b} not divisible by microbatch {n}"
        return x.reshape(n, b // n, *x.shape[1:])
    return {key: f(x) for key, x in batch.items()}


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    def train_step(params, opt_state, batch):
        if tcfg.microbatch and tcfg.microbatch > 1:
            mb = _split_microbatches(batch, tcfg.microbatch)
            gsum, lsum = None, 0.0
            for i in range(tcfg.microbatch):
                loss, g = value_and_grad(params, cfg, {key: x[i] for key, x in mb.items()},
                                         tcfg)
                gsum = g if gsum is None else tree_map(torch.Tensor.add_, gsum, g)
                lsum = lsum + loss
            inv = 1.0 / tcfg.microbatch
            grads = tree_map(lambda g: g.mul_(inv), gsum)
            loss = lsum * inv
        else:
            loss, grads = value_and_grad(params, cfg, batch, tcfg)

        if tcfg.gradient_compression:
            grads, _ = compress_decompress(grads)
        params, opt_state, om = adamw_update(params, grads, opt_state, tcfg)
        return params, opt_state, {"loss": loss, **om}

    return train_step


# ---------------------------------------------------------------------------
# serve steps (used by launch/serve.py)
# ---------------------------------------------------------------------------


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
