"""Affinity-graph specification for Power Iteration Clustering.

Three affinity kinds:

- ``cosine``          raw cosine similarity (may be negative on signed data)
- ``cosine_shifted``  (1 + cos) / 2, non-negative
- ``rbf``             exp(-||x - y||^2 / (2 sigma^2))

:class:`AffinitySpec` also selects the graph-construction policies:

- bandwidth ``'adaptive'`` (rbf only): sigma_i is the distance to the
  ``scale_k``-th nearest neighbour and A_ij = exp(-d_ij^2 / (sigma_i
  sigma_j));
- ``knn_k``: each row keeps the entries >= its ``knn_k``-th largest
  similarity (the directed kNN graph).

All kinds zero the diagonal (no self-loops). This module holds the plain
PyTorch semantics, the oracles of the tests (``affinity_matrix`` and its
row-striped ``affinity_chunked``, ``local_scales``, ``knn_thresholds``);
the kernels realize them in two passes (``core/graph.py``: the streamed
row top-k gives the per-row statistics, the affinity and streaming kernels
apply scale and mask in the tile). The factorable specs also have the
matrix-free product (``matmat_matrix_free``), which never forms A.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

import torch

AffinityKind = Literal["cosine", "cosine_shifted", "rbf"]

AFFINITY_KINDS = ("cosine", "cosine_shifted", "rbf")
BANDWIDTHS = ("fixed", "adaptive")

#: floor for adaptive local scales (duplicated points have a zero k-th
#: neighbor distance; the floor keeps sigma_i * sigma_j away from 0)
SCALE_FLOOR = 1e-6


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

    @property
    def factorable(self) -> bool:
        """True when A V factors through the features (the matrix-free
        engine): cosine kinds only, without scaling or truncation."""
        return self.kind in ("cosine", "cosine_shifted") and self.dense_fixed

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


def rbf_bandwidth_heuristic(x: torch.Tensor, sample: int = 512) -> torch.Tensor:
    """Median pairwise distance of a strided sample of at most ``sample``
    rows (the stride spans the whole row range, so a cluster-ordered input
    is sampled in every cluster), floored at 1e-6. The median of an even
    count is the midpoint of the two middle values, as in the reference."""
    n = x.shape[0]
    take = min(sample, n)
    s = x[:: max(-(-n // take), 1)][:take]
    sq = torch.sum(s * s, dim=1)
    d2 = torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * (s @ s.T), 0.0)
    dist = torch.sqrt(d2 + torch.eye(s.shape[0], dtype=x.dtype, device=x.device) * 1e9)
    flat = torch.sort(dist.reshape(-1)).values
    mid = flat.numel() // 2
    med = flat[mid] if flat.numel() % 2 else (flat[mid - 1] + flat[mid]) * 0.5
    return torch.clamp_min(med, 1e-6)


def _zero_diag(a: torch.Tensor) -> torch.Tensor:
    n = a.shape[0]
    return a * (1.0 - torch.eye(n, dtype=a.dtype, device=a.device))


def pairwise_sq_dists(x: torch.Tensor, xc: torch.Tensor | None = None) -> torch.Tensor:
    """Dense (R, C) squared euclidean distances (clamped at 0)."""
    c = x if xc is None else xc
    sqr = torch.sum(x * x, dim=1)
    sqc = torch.sum(c * c, dim=1)
    return torch.clamp_min(sqr[:, None] + sqc[None, :] - 2.0 * (x @ c.T), 0.0)


def local_scales(x: torch.Tensor, scale_k: int) -> torch.Tensor:
    """Per-row adaptive bandwidth: the distance to the scale_k-th nearest
    neighbor (self excluded), floored at ``SCALE_FLOOR``. Dense plain
    reference of the streamed two-pass build."""
    n = x.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    d2 = torch.where(eye, torch.inf, pairwise_sq_dists(x))
    kth = -torch.topk(-d2, scale_k, dim=1).values[:, -1]     # k-th smallest d2
    return torch.clamp_min(torch.sqrt(kth), SCALE_FLOOR)


def knn_thresholds(a: torch.Tensor, knn_k: int) -> torch.Tensor:
    """Per-row truncation threshold: the knn_k-th largest off-diagonal
    similarity of each row of the (diagonal-zeroed) dense A."""
    n = a.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=a.device)
    return torch.topk(torch.where(eye, -torch.inf, a), knn_k, dim=1).values[:, -1]


def affinity_matrix(
    x: torch.Tensor,
    kind: AffinityKind = "cosine_shifted",
    sigma: float | torch.Tensor | None = None,
    *,
    spec: AffinitySpec | None = None,
) -> torch.Tensor:
    """Dense (n, n) affinity matrix, the plain oracle of the kernels.

    ``spec`` selects the whole graph policy (adaptive scales, kNN
    truncation); without it ``kind``/``sigma`` build the dense
    fixed-bandwidth graph, and ``sigma=None`` on rbf takes the strided
    median heuristic.
    """
    if spec is not None:
        spec.validate_for_n(x.shape[0])
        if spec.kind in ("cosine", "cosine_shifted"):
            xn = row_normalize_features(x)
            a = xn @ xn.T
            if spec.kind == "cosine_shifted":
                a = 0.5 * (1.0 + a)
        elif spec.adaptive:
            scl = local_scales(x, spec.scale_k)
            a = torch.exp(-pairwise_sq_dists(x) / (scl[:, None] * scl[None, :]))
        else:
            a = torch.exp(-pairwise_sq_dists(x) / (2.0 * spec.sigma * spec.sigma))
        a = _zero_diag(a)
        if spec.truncated:
            thr = knn_thresholds(a, spec.knn_k)
            a = _zero_diag(torch.where(a >= thr[:, None], a, 0.0))
        return a

    if kind in ("cosine", "cosine_shifted"):
        xn = row_normalize_features(x)
        a = xn @ xn.T
        if kind == "cosine_shifted":
            a = 0.5 * (1.0 + a)
        return _zero_diag(a)
    if kind == "rbf":
        sig = rbf_bandwidth_heuristic(x) if sigma is None else torch.as_tensor(sigma)
        a = torch.exp(-pairwise_sq_dists(x) / (2.0 * sig * sig))
        return _zero_diag(a)
    raise ValueError(f"unknown affinity kind {kind!r}")


def affinity_chunked(
    x: torch.Tensor,
    kind: AffinityKind = "cosine_shifted",
    sigma: float | None = None,
    chunk: int = 4096,
) -> torch.Tensor:
    """The dense affinity built in row stripes of ``chunk`` rows (the
    paper's host-to-device chunking), so the temporaries are (chunk, n)
    instead of (n, n). ``sigma=None`` on rbf takes the strided median
    heuristic."""
    n = x.shape[0]
    cols = torch.arange(n, device=x.device)[None, :]
    if kind in ("cosine", "cosine_shifted"):
        x = row_normalize_features(x)

        def stripe(xc, i0):
            a = xc @ x.T
            if kind == "cosine_shifted":
                a = 0.5 * (1.0 + a)
            rows = i0 + torch.arange(xc.shape[0], device=x.device)[:, None]
            return a * (cols != rows)

    else:
        sig = rbf_bandwidth_heuristic(x) if sigma is None else torch.as_tensor(sigma)
        sq = torch.sum(x * x, dim=1)

        def stripe(xc, i0):
            sqc = torch.sum(xc * xc, dim=1)
            d2 = torch.clamp_min(sqc[:, None] + sq[None, :] - 2.0 * (xc @ x.T), 0.0)
            a = torch.exp(-d2 / (2.0 * sig * sig))
            rows = i0 + torch.arange(xc.shape[0], device=x.device)[:, None]
            return a * (cols != rows)

    return torch.cat([stripe(x[i0:i0 + chunk], i0) for i0 in range(0, n, chunk)], dim=0)


# ---------------------------------------------------------------------------
# The matrix-free product (factorable specs)
# ---------------------------------------------------------------------------

def matmat_matrix_free(xn: torch.Tensor, v: torch.Tensor,
                       kind: AffinityKind | AffinitySpec = "cosine_shifted", *,
                       psum=None) -> torch.Tensor:
    """A V without A, for V (n,) or (n, r): the factored product shares the
    two O(n m r) skinny matmuls among all r columns.

        cosine:          A V = X (X^T V) - V              (diag of X X^T is 1)
        cosine_shifted:  A V = (sum V + X (X^T V)) / 2 - V

    ``xn`` must be row-normalized. ``kind`` may be an :class:`AffinitySpec`,
    which must be factorable (scaling and truncation break the low-rank
    plus diagonal structure). ``psum`` finishes the sums over the ranks
    when ``xn`` and ``v`` are a rank's row blocks of a sharded matrix: the
    (m, r) block X^T V and the (r,) column sums are all that crosses, once
    a sweep each. None means one device.
    """
    if isinstance(kind, AffinitySpec):
        if not kind.factorable:
            raise ValueError(
                "matrix-free path needs a factorable spec (cosine kinds, "
                f"fixed bandwidth, no truncation); got {kind}")
        kind = kind.kind
    if psum is None:
        def psum(t):
            return t
    if kind == "cosine":
        return xn @ psum(xn.T @ v) - v
    if kind == "cosine_shifted":
        vsum = psum(torch.sum(v, dim=0))
        return 0.5 * (vsum + xn @ psum(xn.T @ v)) - v
    raise ValueError(f"matrix-free path supports cosine affinities, got {kind!r}")


def matvec_matrix_free(xn: torch.Tensor, v: torch.Tensor,
                       kind: AffinityKind | AffinitySpec = "cosine_shifted") -> torch.Tensor:
    """Single-vector alias of :func:`matmat_matrix_free`."""
    return matmat_matrix_free(xn, v, kind)


def degree_matrix_free(xn: torch.Tensor,
                       kind: AffinityKind | AffinitySpec = "cosine_shifted") -> torch.Tensor:
    """Row sums of A (the degree vector) without A."""
    ones = torch.ones((xn.shape[0],), dtype=xn.dtype, device=xn.device)
    return matvec_matrix_free(xn, ones, kind)


# ---------------------------------------------------------------------------
# Block-index planning for truncated specs (the block-sparse route)
# ---------------------------------------------------------------------------

def block_plan(live: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(counts, col_idx, max_b) block-CSR plan from an (nI, nJ) live map.

    ``live[i, j] != 0`` iff column tile j of row block i holds a surviving
    entry. ``counts[i]`` (int32) is the number of live tiles of row block i;
    ``col_idx[i]`` (int32) lists the live tile ids in ascending order, then
    the dead ids in ascending order (the sweeps visit only the first
    ``counts[i]``, in the order the dense kernels visit them, which keeps
    the two routes bitwise equal); ``max_b`` is max(counts) clamped to at
    least 1, a 0-d int32 tensor (the kernels loop ``counts[i]`` themselves,
    so nothing needs it on the host). The reference builds the same values
    from prefix sums only to dodge a jax 0.4 miscompile of a sort."""
    live = live != 0
    counts = live.sum(dim=1, dtype=torch.int32)
    col_idx = torch.argsort((~live).to(torch.uint8), dim=1, stable=True).to(torch.int32)
    max_b = torch.clamp_min(counts.max(), 1) if counts.numel() else counts.new_tensor(1)
    return counts, col_idx.contiguous(), max_b


def plan_to_live(counts: torch.Tensor, col_idx: torch.Tensor) -> torch.Tensor:
    """The (nI, nJ) bool live map a plan came from (the tests' oracle):
    True at the first ``counts[i]`` ids of ``col_idx[i]``."""
    n_i, n_j = col_idx.shape
    slot_live = torch.arange(n_j, device=col_idx.device)[None, :] < counts[:, None]
    # uint8: the card's scatter has no bool form
    live = torch.zeros((n_i, n_j), dtype=torch.uint8, device=col_idx.device)
    return live.scatter_reduce(1, col_idx.long(), slot_live.to(torch.uint8),
                               reduce="amax").bool()


def dense_block_live(a: torch.Tensor, tm: int, tn: int, *, stripe: int = 4096) -> torch.Tensor:
    """(nI, nJ) bool live map of a stored matrix on the (tm, tn) tile grid:
    a tile is live iff it holds a nonzero entry (NaN counts as nonzero);
    the rows and columns are zero-padded up to tile multiples, so padding
    never makes a tile live. Works on about ``stripe`` rows at a time, so it
    adds O(stripe C) memory beside A."""
    n_rows, n_cols = a.shape
    n_i, n_j = -(-n_rows // tm), -(-n_cols // tn)
    live = torch.empty((n_i, n_j), dtype=torch.bool, device=a.device)
    step = max(stripe // tm, 1)
    for b0 in range(0, n_i, step):
        blk = a[b0 * tm:(b0 + step) * tm]
        nb = -(-blk.shape[0] // tm)
        nz = torch.zeros((nb * tm, n_j * tn), dtype=torch.bool, device=a.device)
        nz[:blk.shape[0], :n_cols] = blk != 0
        live[b0:b0 + nb] = nz.reshape(nb, tm, n_j, tn).any(dim=3).any(dim=1)
    return live


def invert_permutation(perm: torch.Tensor) -> torch.Tensor:
    """inv with inv[perm[i]] = i: if a run clustered ``x[perm]``, then
    ``labels[inv]`` lines up with the caller's rows again. Index arithmetic
    only, so permuting and un-permuting is exact."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype, device=perm.device)
    return inv
