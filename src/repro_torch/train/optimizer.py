"""AdamW and its LR schedule, the port of ``repro/train/optimizer.py``.

Moments are kept in f32 whatever the parameter type. The state is a
dataclass of tensors and trees of tensors (``train/checkpoint.py`` saves
it by path). The update runs in place: at stablelm-3b's published widths
an out-of-place update would hold a second 11.2 GB copy of the
parameters. The schedule and the bias corrections are f32 tensors, as the
reference's jnp arithmetic is (Python doubles would part from it by an
ulp).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from ..configs.base import TrainConfig
from ._tree import leaves, tree_map


@dataclass
class AdamWState:
    step: torch.Tensor    # () int32: updates taken
    mu: Any               # first moments, the parameters' tree, f32
    nu: Any               # second moments, likewise


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def lr_schedule(step: torch.Tensor, cfg: TrainConfig) -> torch.Tensor:
    """Linear warmup + cosine decay to 10%, an f32 tensor."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.learning_rate * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads, max_norm):
    """Scale ``grads`` IN PLACE to a global norm of at most ``max_norm``.
    Returns (grads, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in leaves(grads):
        g.mul_(scale)
    return grads, norm


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, cfg: TrainConfig):
    """Returns (params, state, metrics). The parameters, the moments and
    the gradients (clipped) are updated IN PLACE; ``state.step`` is a new
    tensor."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.mu), leaves(state.nu)):
        g32 = g.float()
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * torch.square(g32))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + 1e-8) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), {"lr": lr, "grad_norm": gnorm}
