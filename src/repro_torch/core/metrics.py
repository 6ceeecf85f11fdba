"""External cluster-validation indices used by the paper's Experiment II:

Adjusted Rand Index (Hubert & Arabie 1985) and the Jaccard index (pair-counting
form), plus purity. Host-side numpy — metrics are evaluation-only. The
same code as ``repro/core/metrics.py``, kept as the port's own copy.
"""
from __future__ import annotations

import numpy as np


def _contingency(labels_true: np.ndarray, labels_pred: np.ndarray) -> np.ndarray:
    labels_true = np.asarray(labels_true).ravel()
    labels_pred = np.asarray(labels_pred).ravel()
    if labels_true.shape != labels_pred.shape:
        raise ValueError("label arrays must have the same length")
    _, ti = np.unique(labels_true, return_inverse=True)
    _, pi = np.unique(labels_pred, return_inverse=True)
    c = np.zeros((ti.max() + 1, pi.max() + 1), np.int64)
    np.add.at(c, (ti, pi), 1)
    return c


def _comb2(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float64)
    return x * (x - 1.0) / 2.0


def adjusted_rand_index(labels_true, labels_pred) -> float:
    """ARI in [-1, 1]; 1 = identical partitions, ~0 = random agreement."""
    c = _contingency(labels_true, labels_pred)
    n = c.sum()
    sum_ij = _comb2(c).sum()
    a = _comb2(c.sum(axis=1)).sum()
    b = _comb2(c.sum(axis=0)).sum()
    expected = a * b / max(_comb2(np.array([n])).item(), 1.0)
    max_index = 0.5 * (a + b)
    denom = max_index - expected
    if denom == 0.0:
        return 1.0 if sum_ij == max_index else 0.0
    return float((sum_ij - expected) / denom)


def pair_confusion(labels_true, labels_pred) -> tuple[float, float, float, float]:
    """Pair counts (a, b, c, d): same/same, same/diff, diff/same, diff/diff."""
    cont = _contingency(labels_true, labels_pred)
    n = cont.sum()
    total_pairs = _comb2(np.array([n])).item()
    sum_ij = _comb2(cont).sum()                      # a: agree-positive pairs
    a_rows = _comb2(cont.sum(axis=1)).sum()          # same in true
    a_cols = _comb2(cont.sum(axis=0)).sum()          # same in pred
    b = a_rows - sum_ij                              # same-true, diff-pred
    c = a_cols - sum_ij                              # diff-true, same-pred
    d = total_pairs - sum_ij - b - c
    return float(sum_ij), float(b), float(c), float(d)


def jaccard_index(labels_true, labels_pred) -> float:
    """Pair-counting Jaccard: a / (a + b + c)."""
    a, b, c, _d = pair_confusion(labels_true, labels_pred)
    denom = a + b + c
    return float(a / denom) if denom > 0 else 1.0


def rand_index(labels_true, labels_pred) -> float:
    a, b, c, d = pair_confusion(labels_true, labels_pred)
    return float((a + d) / max(a + b + c + d, 1.0))


def purity(labels_true, labels_pred) -> float:
    c = _contingency(labels_true, labels_pred)
    return float(c.max(axis=0).sum() / max(c.sum(), 1))
