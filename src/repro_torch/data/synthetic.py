"""Synthetic datasets used by the paper (numpy only; the same generators
as ``repro/data/synthetic.py``, kept as the port's own copy so that the
port imports nothing of the reference package).

Experiment I (speed): ``two_moons``, ``three_circles``  (m = 2).
Experiment II (subsampling quality): ``cassini``, ``gaussians``, ``shapes``,
``smiley`` — mlbench-style 2-D generators with ground-truth labels.

All generators return ``(X float32 (n, 2), y int32 (n,))`` and are
deterministic given ``seed``. Class balance is as equal as n allows
(Experiment II requires balanced classes).

Ordering contract: every generator emits points CLASS-BY-CLASS (labels
are sorted), because downstream code must not depend on row order — PIC
itself is permutation-equivariant, and any sampling heuristic has to
survive cluster-sorted input (a bandwidth heuristic that samples a
leading slice sees one class only). Use :func:`shuffle_points` when a test needs the
order-randomized view of the same dataset.
"""
from __future__ import annotations

import numpy as np


def shuffle_points(x: np.ndarray, y: np.ndarray, *, seed: int = 0):
    """Deterministic row shuffle of a (X, y) dataset — the antidote to the
    generators' class-sorted ordering contract (see module doc)."""
    perm = np.random.default_rng(seed).permutation(len(y))
    return x[perm], y[perm]


def _split_counts(n: int, k: int) -> list[int]:
    base = n // k
    counts = [base] * k
    for i in range(n - base * k):
        counts[i] += 1
    return counts


def two_moons(n: int, *, noise: float = 0.06, seed: int = 0):
    rng = np.random.default_rng(seed)
    n0, n1 = _split_counts(n, 2)
    t0 = rng.uniform(0.0, np.pi, n0)
    t1 = rng.uniform(0.0, np.pi, n1)
    upper = np.stack([np.cos(t0), np.sin(t0)], axis=1)
    lower = np.stack([1.0 - np.cos(t1), 0.5 - np.sin(t1)], axis=1)
    x = np.concatenate([upper, lower], axis=0)
    x += rng.normal(0.0, noise, x.shape)
    y = np.concatenate([np.zeros(n0, np.int32), np.ones(n1, np.int32)])
    return x.astype(np.float32), y


def three_circles(n: int, *, noise: float = 0.04, seed: int = 0):
    rng = np.random.default_rng(seed)
    counts = _split_counts(n, 3)
    radii = (1.0, 2.2, 3.4)
    xs, ys = [], []
    for cls, (cnt, r) in enumerate(zip(counts, radii)):
        t = rng.uniform(0.0, 2.0 * np.pi, cnt)
        pts = r * np.stack([np.cos(t), np.sin(t)], axis=1)
        pts += rng.normal(0.0, noise, pts.shape)
        xs.append(pts)
        ys.append(np.full(cnt, cls, np.int32))
    return np.concatenate(xs).astype(np.float32), np.concatenate(ys)


def cassini(n: int, *, seed: int = 0):
    """mlbench-cassini style: two banana-shaped lobes around a central disc."""
    rng = np.random.default_rng(seed)
    counts = _split_counts(n, 3)
    xs, ys = [], []
    # two banana-shaped annular arcs (classes 0, 1), above and below the disc
    for cls, sign in ((0, 1.0), (1, -1.0)):
        cnt = counts[cls]
        t = rng.uniform(0.2 * np.pi, 0.8 * np.pi, cnt)  # arc does not wrap
        r = rng.uniform(1.6, 2.4, cnt)
        pts = np.stack([r * np.cos(t), sign * r * np.sin(t)], axis=1)
        xs.append(pts)
        ys.append(np.full(cnt, cls, np.int32))
    # central disc (class 2)
    cnt = counts[2]
    t = rng.uniform(0, 2 * np.pi, cnt)
    r = 0.45 * np.sqrt(rng.uniform(0, 1, cnt))
    xs.append(np.stack([r * np.cos(t), r * np.sin(t)], axis=1))
    ys.append(np.full(cnt, 2, np.int32))
    return np.concatenate(xs).astype(np.float32), np.concatenate(ys)


def anisotropic(n: int, *, seed: int = 0):
    """Three stretched (sheared) Gaussian blobs — the classic k-means
    failure case: isotropic distance misassigns the elongated tails, while
    affinity-graph methods follow the stretch."""
    rng = np.random.default_rng(seed)
    counts = _split_counts(n, 3)
    shear = np.array([[0.6, -0.6], [-0.4, 0.8]])
    centers = [(-2.5, 1.5), (0.0, -1.0), (2.5, 2.0)]
    xs, ys = [], []
    for cls, (cnt, center) in enumerate(zip(counts, centers)):
        pts = rng.normal(0.0, 0.45, (cnt, 2)) @ shear + np.array(center)
        xs.append(pts)
        ys.append(np.full(cnt, cls, np.int32))
    return np.concatenate(xs).astype(np.float32), np.concatenate(ys)


def gaussians(n: int, *, k: int = 4, spread: float = 0.35, seed: int = 0):
    """k well-separated isotropic Gaussian blobs on a circle."""
    rng = np.random.default_rng(seed)
    counts = _split_counts(n, k)
    xs, ys = [], []
    for cls, cnt in enumerate(counts):
        ang = 2.0 * np.pi * cls / k
        center = 3.0 * np.array([np.cos(ang), np.sin(ang)])
        xs.append(center + rng.normal(0.0, spread, (cnt, 2)))
        ys.append(np.full(cnt, cls, np.int32))
    return np.concatenate(xs).astype(np.float32), np.concatenate(ys)


def shapes(n: int, *, seed: int = 0):
    """mlbench-shapes style: gaussian blob, square, triangle and ring."""
    rng = np.random.default_rng(seed)
    counts = _split_counts(n, 4)
    xs, ys = [], []
    # 0: gaussian blob
    xs.append(np.array([-3.0, 3.0]) + rng.normal(0, 0.3, (counts[0], 2)))
    # 1: uniform square
    xs.append(np.array([3.0, 3.0]) + rng.uniform(-0.7, 0.7, (counts[1], 2)))
    # 2: triangle (uniform via sqrt trick)
    u = rng.uniform(0, 1, counts[2])
    v = rng.uniform(0, 1, counts[2])
    su = np.sqrt(u)
    a, b, c = np.array([-0.9, -0.8]), np.array([0.9, -0.8]), np.array([0.0, 0.8])
    tri = (1 - su)[:, None] * a + (su * (1 - v))[:, None] * b + (su * v)[:, None] * c
    xs.append(np.array([-3.0, -3.0]) + tri)
    # 3: ring
    t = rng.uniform(0, 2 * np.pi, counts[3])
    r = rng.normal(0.8, 0.05, counts[3])
    xs.append(np.array([3.0, -3.0]) + np.stack([r * np.cos(t), r * np.sin(t)], axis=1))
    ys = [np.full(c, i, np.int32) for i, c in enumerate(counts)]
    return np.concatenate(xs).astype(np.float32), np.concatenate(ys)


def smiley(n: int, *, seed: int = 0):
    """mlbench-smiley style: two eyes, a nose and a mouth arc (4 classes)."""
    rng = np.random.default_rng(seed)
    counts = _split_counts(n, 4)
    xs = []
    # 0, 1: eyes (gaussian blobs)
    xs.append(np.array([-0.8, 1.0]) + rng.normal(0, 0.15, (counts[0], 2)))
    xs.append(np.array([0.8, 1.0]) + rng.normal(0, 0.15, (counts[1], 2)))
    # 2: nose (triangle-ish vertical wedge)
    yy = rng.uniform(-0.4, 0.4, counts[2])
    half_w = 0.12 * (0.4 - yy) / 0.8 + 0.02
    xx = rng.uniform(-1.0, 1.0, counts[2]) * half_w
    xs.append(np.stack([xx, yy], axis=1))
    # 3: mouth (arc)
    t = rng.uniform(np.pi * 1.15, np.pi * 1.85, counts[3])
    r = rng.normal(1.3, 0.04, counts[3])
    xs.append(np.stack([r * np.cos(t), 0.3 + r * np.sin(t)], axis=1))
    ys = [np.full(c, i, np.int32) for i, c in enumerate(counts)]
    return np.concatenate(xs).astype(np.float32), np.concatenate(ys)


_REGISTRY = {
    "two_moons": (two_moons, 2),
    "three_circles": (three_circles, 3),
    "anisotropic": (anisotropic, 3),
    "cassini": (cassini, 3),
    "gaussians": (gaussians, 4),
    "shapes": (shapes, 4),
    "smiley": (smiley, 4),
}


def dataset_by_name(name: str, n: int, *, seed: int = 0):
    """Returns (X, y, k) for a registered dataset."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(_REGISTRY)}")
    fn, k = _REGISTRY[name]
    x, y = fn(n, seed=seed)
    return x, y, k


def subsample_balanced(x, y, fraction: float, *, seed: int = 0):
    """Balanced subsample used by Experiment II (equal per-class draws)."""
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    take_total = max(int(round(len(y) * fraction)), len(classes))
    per_class = max(take_total // len(classes), 1)
    idx = []
    for c in classes:
        members = np.flatnonzero(y == c)
        idx.append(rng.choice(members, size=min(per_class, len(members)),
                              replace=False))
    idx = np.concatenate(idx)
    rng.shuffle(idx)
    return x[idx], y[idx]
