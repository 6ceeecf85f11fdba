"""Affinity-graph specification for Power Iteration Clustering.

Three affinity kinds:

- ``cosine``          raw cosine similarity (may be negative on signed data)
- ``cosine_shifted``  (1 + cos) / 2, non-negative
- ``rbf``             exp(-||x - y||^2 / (2 sigma^2))

:class:`AffinitySpec` also names the graph-construction policies of the
reference package (adaptive bandwidth, kNN truncation). This slice of the
port builds only the dense fixed-bandwidth graph; the operators raise
``NotImplementedError`` for the other policies. All kinds zero the
diagonal (no self-loops).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

import torch

AffinityKind = Literal["cosine", "cosine_shifted", "rbf"]

AFFINITY_KINDS = ("cosine", "cosine_shifted", "rbf")
BANDWIDTHS = ("fixed", "adaptive")


@dataclass(frozen=True)
class AffinitySpec:
    """Everything that defines the affinity graph, in one hashable value.

    Fields:
      kind:      similarity ('cosine' | 'cosine_shifted' | 'rbf').
      sigma:     global bandwidth (read by 'rbf' with bandwidth='fixed').
      bandwidth: 'fixed' or 'adaptive' (per-row local scaling, rbf only):
                 sigma_i = distance to the scale_k-th nearest neighbor,
                 A_ij = exp(-d_ij^2 / (sigma_i sigma_j)).
      scale_k:   the neighbor rank defining the local scale ('adaptive').
      knn_k:     None = dense; an int truncates each row to entries >= its
                 knn_k-th largest similarity.
    """
    kind: AffinityKind = "cosine_shifted"
    sigma: float = 1.0
    bandwidth: str = "fixed"
    scale_k: int = 7
    knn_k: int | None = None

    def __post_init__(self):
        if self.kind not in AFFINITY_KINDS:
            raise ValueError(
                f"unknown affinity kind {self.kind!r} "
                f"(expected one of {AFFINITY_KINDS})")
        if self.bandwidth not in BANDWIDTHS:
            raise ValueError(
                f"unknown bandwidth policy {self.bandwidth!r} "
                f"(expected one of {BANDWIDTHS})")
        if not float(self.sigma) > 0.0:
            raise ValueError(
                f"sigma must be > 0 (a bandwidth), got {self.sigma}")
        if self.bandwidth == "adaptive":
            if self.kind != "rbf":
                raise ValueError(
                    "bandwidth='adaptive' rescales squared distances "
                    f"(exp(-d^2/(s_i s_j))) — rbf only, got kind={self.kind!r}")
            if int(self.scale_k) < 1:
                raise ValueError(
                    f"scale_k must be >= 1 (a neighbor rank), got {self.scale_k}")
        if self.knn_k is not None and int(self.knn_k) < 1:
            raise ValueError(
                f"knn_k must be >= 1 (a neighbor rank) or None, got {self.knn_k}")

    @property
    def adaptive(self) -> bool:
        return self.bandwidth == "adaptive"

    @property
    def truncated(self) -> bool:
        return self.knn_k is not None

    @property
    def dense_fixed(self) -> bool:
        """True for the classic build: global bandwidth, no truncation."""
        return not (self.adaptive or self.truncated)

    def validate_for_n(self, n: int) -> None:
        """Reject neighbor ranks that don't exist among the n-1 off-diagonal
        entries of a row."""
        if self.adaptive and not 1 <= int(self.scale_k) < n:
            raise ValueError(
                f"scale_k={self.scale_k} outside [1, n) for n={n} "
                "(each row has n-1 neighbors)")
        if self.truncated and not 1 <= int(self.knn_k) < n:
            raise ValueError(
                f"knn_k={self.knn_k} outside [1, n) for n={n} "
                "(each row has n-1 neighbors)")


def as_affinity_spec(
    spec: AffinitySpec | str | None = None,
    *,
    kind: AffinityKind = "cosine_shifted",
    sigma: float = 1.0,
) -> AffinitySpec:
    """Coerce to an :class:`AffinitySpec`: an instance passes through, a
    string is a kind; otherwise ``kind``/``sigma`` build the dense
    fixed-bandwidth spec."""
    if isinstance(spec, AffinitySpec):
        return spec
    if isinstance(spec, str):
        return AffinitySpec(kind=spec, sigma=sigma)
    if spec is not None:
        raise TypeError(
            f"spec must be an AffinitySpec, a kind string, or None; "
            f"got {type(spec).__name__}")
    return AffinitySpec(kind=kind, sigma=sigma)


def row_normalize_features(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize each row (unit-norm embeddings for cosine affinity)."""
    nrm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp_min(nrm, eps)
