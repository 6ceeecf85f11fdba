"""The result of a PIC/GPIC run."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .health import HealthReport


@dataclass(frozen=True)
class PICResult:
    labels: torch.Tensor          # (n,) int32 cluster assignment
    embedding: torch.Tensor       # (n,) final power-iteration vector (column 0)
    n_iter: torch.Tensor          # iterations executed by column 0
    converged: torch.Tensor       # bool — column 0 stopped by the epsilon rule
    embeddings: torch.Tensor      # (n, c) matrix k-means clustered
    n_iter_cols: torch.Tensor     # (r,) int32 per-column iteration counts
    converged_cols: torch.Tensor  # (r,) bool per-column convergence flags
    #: which embedding mode produced ``embeddings``
    embedding_mode: str = "pic"
    #: per-run diagnostics (core/health.py)
    health: HealthReport | None = None


def make_pic_result(labels, v, t_cols, done, *, embedding="pic",
                    embeddings=None, health=None) -> PICResult:
    """Assemble a PICResult from the engine outputs: labels (n,), the final
    (n, r) state, and the per-column (r,) iteration counts / flags. Column 0
    (the paper's degree-seeded vector) backs the scalar fields."""
    return PICResult(
        labels=labels, embedding=v[:, 0], n_iter=t_cols[0], converged=done[0],
        embeddings=v if embeddings is None else embeddings,
        n_iter_cols=t_cols, converged_cols=done, embedding_mode=embedding,
        health=health,
    )
