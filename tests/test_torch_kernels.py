"""The port's kernel modules against the reference package's Pallas kernels.

The same numpy inputs go through ``repro.kernels.ops.<op>(mode="pallas")``
(interpret mode on the CPU, as the reference package's own tests run it)
and through the port's wrappers on CPU tensors, which run the plain
PyTorch versions. The CUDA kernels themselves run only on the card; they
are held against the same plain versions by ``chip_smoke.py``.

Tolerances: A atol 1e-6 (both sides compute the f32 dot product and the
transform with one rounding per step, so they differ by a few ulps of a
value <= 1); D rtol 1e-5 relative to the row's absolute mass sum|A_ij|
(the row sum of raw cosine entries can cancel to ~0, where a plain
relative bound means nothing); U rtol 1e-5 with atol 1e-7 (sums of a few
hundred products in two orders); k-means labels exact, distances rtol 1e-5
(NaN and Inf in the same places; on the NaN/Inf cases relative to
|d2| + |x|^2 + |c|^2, the expansion's terms, where d2 cancels).
The streamed U (no stored A) is held to rtol 1e-5 plus 1e-7 max|U_ref|
(the same sums; the atol scales with U, whose entries are ~1/n once
normalized and unbounded when ``d=None``); the streamed D to the D rule;
the Gram to rtol 1e-5 relative to max|G_ref| (sums of n products).
"""
from __future__ import annotations

import os
import stat
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one torch thread a process: the test run starts several processes at once,
# and torch using every core in each of them slows all of them down
torch.set_num_threads(1)

import repro.core as jcore
from repro.kernels import ops as jops
from repro_torch import AffinitySpec
from repro_torch.core.affinity import block_plan
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops

A_ATOL = 1e-6
D_RTOL = 1e-5
U_RTOL, U_ATOL = 1e-5, 1e-7
DIST_RTOL = 1e-5
G_RTOL = 1e-5


@pytest.fixture(autouse=True)
def pallas_really_ran():
    """Every reference call below must have run the Pallas kernel, not the
    oracle it falls back to when a kernel fails."""
    jops.reset_kernel_fallbacks()
    yield
    assert jops.kernel_fallbacks() == {}


def _features(n, m, kind, seed):
    x = np.random.default_rng(seed).normal(size=(n, m)).astype(np.float32) * 0.5
    if kind != "rbf":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
    return x


def _assert_affinity_close(a_t, d_t, a_j, d_j):
    a_j, d_j = np.asarray(a_j), np.asarray(d_j)
    np.testing.assert_allclose(a_t.numpy(), a_j, rtol=0, atol=A_ATOL)
    mass = np.abs(a_j).sum(axis=1)
    assert np.all(np.abs(d_t.numpy() - d_j) <= D_RTOL * mass)


@pytest.mark.parametrize("kind", ["cosine", "cosine_shifted", "rbf"])
@pytest.mark.parametrize("n,m", [(200, 2), (300, 2), (200, 16), (300, 16)])
def test_affinity_and_degree_matches_pallas(kind, n, m):
    x = _features(n, m, kind, seed=n + m)
    a_j, d_j = jops.affinity_and_degree(jnp.asarray(x), kind=kind, sigma=0.8,
                                        mode="pallas")
    a_t, d_t = tops.affinity_and_degree(torch.from_numpy(x), kind=kind, sigma=0.8)
    assert a_t.shape == (n, n) and a_t.dtype == torch.float32
    assert torch.all(torch.diagonal(a_t) == 0)
    _assert_affinity_close(a_t, d_t, a_j, d_j)


@pytest.mark.parametrize("kind", ["cosine", "cosine_shifted", "rbf"])
def test_affinity_off_diagonal_stripe_matches_pallas(kind):
    x = _features(300, 16, kind, seed=7)
    rows, cols = x[40:160], x[100:300]
    a_j, d_j = jops.affinity_and_degree(jnp.asarray(rows), jnp.asarray(cols),
                                        kind=kind, sigma=0.8, row_offset=40,
                                        col_offset=100, mode="pallas")
    a_t, d_t = tops.affinity_and_degree(torch.from_numpy(rows), torch.from_numpy(cols),
                                        kind=kind, sigma=0.8, row_offset=40,
                                        col_offset=100)
    assert a_t.shape == (120, 200)
    # the global diagonal runs through the stripe at local (i, i - 60)
    assert torch.all(a_t[torch.arange(60, 120), torch.arange(0, 60)] == 0)
    _assert_affinity_close(a_t, d_t, a_j, d_j)


@pytest.mark.parametrize("r", [1, 4])
@pytest.mark.parametrize("rows", [slice(None), slice(50, 170)])
def test_degree_normalized_matmat_matches_pallas(r, rows):
    rng = np.random.default_rng(r)
    x = _features(300, 2, "rbf", seed=11)
    a, d = (np.asarray(t) for t in jops.affinity_and_degree(
        jnp.asarray(x), kind="rbf", sigma=0.8, mode="reference"))
    a, d = a.copy(), d.copy()
    a[60] = 0.0          # a zero-degree row: its output must be an exact 0
    d[60] = 0.0
    a, d = np.ascontiguousarray(a[rows]), np.ascontiguousarray(d[rows])
    v = rng.random((300, r)).astype(np.float32)
    u_j = np.asarray(jops.degree_normalized_matmat(
        jnp.asarray(a), jnp.asarray(v), jnp.asarray(d), mode="pallas"))
    u_t = tops.degree_normalized_matmat(torch.from_numpy(a), torch.from_numpy(v),
                                        torch.from_numpy(d)).numpy()
    assert u_t.shape == (a.shape[0], r)
    np.testing.assert_allclose(u_t, u_j, rtol=U_RTOL, atol=U_ATOL)
    zero_row = 60 - (rows.start or 0)
    assert np.all(u_t[zero_row] == 0.0) and np.all(u_j[zero_row] == 0.0)


@pytest.mark.parametrize("k", [2, 5])
def test_kmeans_assign_matches_pallas_with_planted_tie(k):
    rng = np.random.default_rng(k)
    x = rng.normal(size=(300, 3)).astype(np.float32)
    cents = (rng.normal(size=(k, 3)) + 4.0).astype(np.float32)
    cents[0], cents[1] = (-1.0, 0.0, 0.0), (1.0, 0.0, 0.0)
    x[7] = (0.0, 0.0, 0.0)            # equidistant from centroids 0 and 1
    lab_j, dist_j = jops.kmeans_assign(jnp.asarray(x), jnp.asarray(cents), mode="pallas")
    lab_t, dist_t = tops.kmeans_assign(torch.from_numpy(x), torch.from_numpy(cents))
    assert lab_t.dtype == torch.int32
    np.testing.assert_array_equal(lab_t.numpy(), np.asarray(lab_j))
    np.testing.assert_allclose(dist_t.numpy(), np.asarray(dist_j), rtol=DIST_RTOL, atol=0)
    assert int(lab_t[7]) == 0         # ties go to the first index


def _nan_inf_case(case):
    """(x, cents) of one NaN/Inf case, and {point: label} where argmin's
    rule gives the label without the arithmetic."""
    rng = np.random.default_rng(17)
    if case == "nan centroid":
        # points (0,0), (1,1), (NaN,0), an Inf point; centroid 1 holds a NaN
        x = np.array([[0, 0], [1, 1], [np.nan, 0], [np.inf, 0], [-np.inf, 1]], np.float32)
        cents = np.array([[5, 5], [np.nan, 0], [0.1, 0.1], [1, 1]], np.float32)
        return x, cents, {0: 1, 1: 1, 2: 0, 3: 0, 4: 1}
    x = rng.normal(size=(300, 2)).astype(np.float32)
    cents = rng.normal(size=(5, 2)).astype(np.float32)
    if case == "nan point":
        x[7, 1] = np.nan                  # every distance NaN: label 0
        return x, cents, {7: 0}
    x[11] = (np.inf, 0.0)
    x[12] = (-np.inf, 1.0)
    x[13] = (np.inf, np.inf)
    return x, cents, {}


@pytest.mark.parametrize("case", ["nan centroid", "nan point", "inf point"])
def test_kmeans_assign_matches_pallas_on_nan_and_inf(case):
    """The first NaN distance wins with its NaN (argmin's and min's rule);
    a point whose distances are all NaN gets label 0."""
    x, cents, known = _nan_inf_case(case)
    lab_j, dist_j = jops.kmeans_assign(jnp.asarray(x), jnp.asarray(cents), mode="pallas")
    lab_t, dist_t = tops.kmeans_assign(torch.from_numpy(x), torch.from_numpy(cents))
    lab_j, dist_j = np.asarray(lab_j), np.asarray(dist_j)
    np.testing.assert_array_equal(lab_t.numpy(), lab_j)
    dist_t = dist_t.numpy()
    np.testing.assert_array_equal(np.isnan(dist_t), np.isnan(dist_j))
    fin = np.isfinite(dist_j)
    np.testing.assert_array_equal(dist_t[~fin], dist_j[~fin])     # NaN and +-Inf alike
    # the expansion's three terms each round relative to their own size, so
    # where d2 cancels far under |x|^2 + |c|^2 its error scales with those
    terms = ((x[fin].astype(np.float64) ** 2).sum(1)
             + (cents[lab_j[fin]].astype(np.float64) ** 2).sum(1))
    assert np.all(np.abs(dist_t[fin] - dist_j[fin])
                  <= DIST_RTOL * (np.abs(dist_j[fin]) + terms))
    for i, want in known.items():
        assert int(lab_t[i]) == want
    assert np.isnan(dist_j).any()


def test_kmeans_assign_matches_pallas_past_the_old_centroid_budget():
    """k = 100 centroids of dim 128 (past the 12,288 floats the card's kernel
    once held in shared memory), well separated: each point lies near its
    own centroid."""
    rng = np.random.default_rng(100)
    cents = rng.normal(size=(100, 128)).astype(np.float32)
    own = rng.integers(0, 100, size=300)
    x = (cents[own] + 0.7 * rng.normal(size=(300, 128))).astype(np.float32)
    lab_j, dist_j = jops.kmeans_assign(jnp.asarray(x), jnp.asarray(cents), mode="pallas")
    lab_t, dist_t = tops.kmeans_assign(torch.from_numpy(x), torch.from_numpy(cents))
    np.testing.assert_array_equal(lab_t.numpy(), np.asarray(lab_j))
    np.testing.assert_array_equal(lab_t.numpy(), own)
    np.testing.assert_allclose(dist_t.numpy(), np.asarray(dist_j), rtol=DIST_RTOL, atol=0)


#: (rows, cols, row_offset, col_offset) of the streamed stripes: the square
#: self-stripe, an off-diagonal stripe the global diagonal crosses, and one
#: whose rows come after its columns, the diagonal crossing it at an offset
#: gap (170) that is no multiple of 16 or 256, over 130 rows (no multiple of
#: 16 either)
BELOW = (slice(170, 300), slice(0, 230), 170, 0)
STRIPES = [(slice(0, 200), None, 0, 0), (slice(40, 160), slice(100, 300), 40, 100), BELOW]
STRIPE_IDS = ["square", "stripe", "below"]


def _stripe(kind, stripe):
    rows, cols, ro, co = stripe
    x = _features(300, 16, kind, seed=13)
    xc = None if cols is None else np.ascontiguousarray(x[cols])
    return np.ascontiguousarray(x[rows]), xc, ro, co


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("r", [1, 4])
@pytest.mark.parametrize("normalized", [True, False], ids=["d", "d_none"])
@pytest.mark.parametrize("stripe", STRIPES, ids=STRIPE_IDS)
@pytest.mark.parametrize("kind", ["cosine", "cosine_shifted", "rbf"])
def test_streaming_matmat_matches_pallas(kind, stripe, normalized, r):
    x, xc, ro, co = _stripe(kind, stripe)
    n_cols = x.shape[0] if xc is None else xc.shape[0]
    v = np.random.default_rng(r).random((n_cols, r)).astype(np.float32)
    d = None
    if normalized:
        d = np.array(jops.streaming_degree(_j(x), _j(xc), kind=kind, sigma=0.8,
                                           row_offset=ro, col_offset=co, mode="reference"))
    u_j = np.asarray(jops.streaming_matmat(_j(x), jnp.asarray(v), _j(d), _j(xc), kind=kind,
                                           sigma=0.8, row_offset=ro, col_offset=co))
    u_t = tops.streaming_matmat(_t(x), torch.from_numpy(v), _t(d), _t(xc), kind=kind,
                                sigma=0.8, row_offset=ro, col_offset=co).numpy()
    assert u_t.shape == (x.shape[0], r) and u_t.dtype == np.float32
    if kind != "cosine" or stripe != BELOW:
        np.testing.assert_allclose(u_t, u_j, rtol=U_RTOL, atol=U_ATOL * np.abs(u_j).max())
        return
    # Raw cosine entries take both signs, and in this stripe the r = 4 sum
    # of row 87, column 2 cancels to 5.8e-4 of its absolute mass
    # |A| V / max(d, 1e-30). There 1e-5 of |U| is finer than one f32
    # rounding of the mass, which is what bounds each package's error:
    # against a float64 sum of the same entries the port's plain version is
    # off by 5.2e-8 of the mass and Pallas by 2.2e-9 (f32 eps is 1.19e-7).
    # So each entry is held to the larger of the rule above and two f32
    # roundings of its mass (one a package); the second governs only where
    # |U| is below 0.024 of the mass.
    a_ref, _ = jops.affinity_and_degree(_j(x), _j(xc), kind=kind, sigma=0.8, row_offset=ro,
                                        col_offset=co, mode="reference")
    mass = np.abs(np.asarray(a_ref, dtype=np.float64)) @ v
    if d is not None:
        mass = mass / np.maximum(d, 1e-30)[:, None]
    eps = float(np.finfo(np.float32).eps)
    tol = np.maximum(U_RTOL * np.abs(u_j), 2 * eps * mass) + U_ATOL * np.abs(u_j).max()
    assert np.all(np.abs(u_t - u_j) <= tol)


@pytest.mark.parametrize("stripe", STRIPES, ids=STRIPE_IDS)
@pytest.mark.parametrize("kind", ["cosine", "cosine_shifted", "rbf"])
def test_streaming_degree_matches_pallas(kind, stripe):
    x, xc, ro, co = _stripe(kind, stripe)
    d_j = np.asarray(jops.streaming_degree(_j(x), _j(xc), kind=kind, sigma=0.8,
                                           row_offset=ro, col_offset=co))
    d_t = tops.streaming_degree(_t(x), _t(xc), kind=kind, sigma=0.8,
                                row_offset=ro, col_offset=co)
    a_ref, _ = jops.affinity_and_degree(_j(x), _j(xc), kind=kind, sigma=0.8, row_offset=ro,
                                        col_offset=co, mode="reference")
    mass = np.abs(np.asarray(a_ref)).sum(axis=1)
    assert d_t.shape == (x.shape[0],)
    assert np.all(np.abs(d_t.numpy() - d_j) <= D_RTOL * mass)


@pytest.mark.parametrize("n,c", [(300, 1), (300, 4), (1037, 3), (1037, 8),
                                 # across the kernel's 256-row block edge
                                 (255, 2), (256, 2), (257, 4),
                                 # the power loop's V and [V | U] at the paper's n
                                 (45_000, 2), (45_000, 4)])
def test_gram_matches_pallas(n, c):
    v = np.random.default_rng(n + c).normal(size=(n, c)).astype(np.float32)
    g_j = np.asarray(jops.gram(jnp.asarray(v), mode="pallas"))
    g_t = tops.gram(torch.from_numpy(v)).numpy()
    assert g_t.shape == (c, c)
    np.testing.assert_allclose(g_t, g_j, rtol=0, atol=G_RTOL * np.abs(g_j).max())


@pytest.mark.parametrize("op,policy", [
    (op, policy) for op in ("affinity", "streaming_matmat", "streaming_degree")
    for policy in ("knn", "adaptive", "operand") if (op, policy) != ("affinity", "operand")])
def test_graph_policies_match_the_reference(op, policy):
    """A graph policy reaches the kernel as its operands. For a spec, pass 1
    (core/graph.py::affinity_stats) gives the port the reference's
    statistics within their rules (squared scales: 1e-6 max|x|^2, the
    neg_sqdist rule; thresholds: A_ATOL plus that error carried through
    exp(-d2 / (2 sigma^2))), and each package's kernel, on its own
    statistics, gives the other's result: the same kept entries (a
    threshold is one of the package's own scores, so each package is
    consistent with itself), values within A_ATOL plus the d2 and scale
    errors carried through exp(-d2 / (s_i s_j)). 'operand' passes given
    thresholds (row, and column for the transpose product)."""
    from repro.core.graph import affinity_stats as ref_affinity_stats
    from repro_torch.core.graph import affinity_stats
    x = _features(200, 2, "rbf", seed=5)
    eps = 1e-6 * float(np.max(np.sum(x.astype(np.float64) ** 2, axis=1)))
    fields = {"knn": dict(kind="rbf", sigma=0.5, knn_k=5),
              "adaptive": dict(kind="rbf", bandwidth="adaptive", scale_k=7),
              "operand": dict(kind="rbf", sigma=0.5)}[policy]
    jspec = jcore.AffinitySpec(**fields)
    scale, thr = (np.asarray(s) if s is not None else None
                  for s in ref_affinity_stats(jnp.asarray(x), jspec))
    t_scale, t_thr = affinity_stats(torch.from_numpy(x), AffinitySpec(**fields))
    assert (t_scale is None) == (scale is None) and (t_thr is None) == (thr is None)
    if scale is not None:
        assert np.all(np.abs(t_scale.numpy().astype(np.float64) ** 2 - scale ** 2.0) <= eps)
    if thr is not None:
        assert np.all(np.abs(t_thr.numpy() - thr) <= A_ATOL + eps / (2 * 0.5 ** 2))
    thr_c = None
    if policy == "operand":
        thr = np.full(200, 0.5, np.float32)
        thr_c = np.full(200, 0.6, np.float32)
        t_thr = torch.from_numpy(thr)
    # |dA| <= A_ATOL + eps c (1 + 1/e): c = 1/(s_i s_j) <= 1/min(s)^2, and
    # each squared scale carries eps as well
    atol = A_ATOL if scale is None else A_ATOL + 2 * eps / float(np.min(scale)) ** 2
    # a sum of up to 200 entries: the D and U rules, plus 200 atol where the
    # scales differ
    sum_atol = 0.0 if scale is None else 200 * atol
    pol = dict(scale_r=scale, scale_c=scale, thr=thr)
    t_pol = dict(scale_r=t_scale, scale_c=t_scale, thr=t_thr)
    if op == "affinity":
        a_j, d_j = jops.affinity_and_degree(jnp.asarray(x), spec=jspec, mode="pallas",
                                            **{k: _j(v) for k, v in pol.items()})
        a_t, d_t = tops.affinity_and_degree(torch.from_numpy(x), spec=AffinitySpec(**fields),
                                            **t_pol)
        a_j = np.asarray(a_j)
        assert np.all(np.abs(a_t.numpy() - a_j) <= atol)
        assert np.all(np.abs(d_t.numpy() - np.asarray(d_j))
                      <= D_RTOL * np.abs(a_j).sum(axis=1) + sum_atol)
        if thr is not None:
            np.testing.assert_array_equal(a_t.numpy() != 0, a_j != 0)
    elif op == "streaming_matmat":
        v = np.random.default_rng(6).random((200, 2)).astype(np.float32)
        u_j = np.asarray(jops.streaming_matmat(jnp.asarray(x), jnp.asarray(v), None,
                                               spec=jspec, thr_c=_j(thr_c),
                                               **{k: _j(w) for k, w in pol.items()}))
        u_t = tops.streaming_matmat(torch.from_numpy(x), torch.from_numpy(v), None,
                                    spec=AffinitySpec(**fields), thr_c=_t(thr_c),
                                    **t_pol).numpy()
        np.testing.assert_allclose(u_t, u_j, rtol=U_RTOL,
                                   atol=U_ATOL * np.abs(u_j).max() + sum_atol)
    else:
        d_j = np.asarray(jops.streaming_degree(jnp.asarray(x), spec=jspec,
                                               **{k: _j(v) for k, v in pol.items()}))
        d_t = tops.streaming_degree(torch.from_numpy(x), spec=AffinitySpec(**fields),
                                    **t_pol).numpy()
        np.testing.assert_allclose(d_t, d_j, rtol=D_RTOL, atol=sum_atol)


def test_cpu_calls_launch_no_kernel():
    _build.reset_launch_counts()
    x = torch.from_numpy(_features(50, 2, "rbf", seed=3))
    a, d = tops.affinity_and_degree(x, kind="rbf")
    tops.degree_normalized_matmat(a, (d / d.sum())[:, None], d)
    tops.kmeans_assign(x, x[:3])
    d_s = tops.streaming_degree(x, kind="rbf")
    u = tops.streaming_matmat(x, (d_s / d_s.sum())[:, None], d_s, kind="rbf")
    tops.gram(torch.cat([u, u], dim=1))
    tops.row_topk(x, k=3, stat="neg_sqdist", kind="rbf")
    tops.stored_degree(a)
    plan = block_plan(tops.block_liveness(x, kind="rbf"))
    tops.block_sparse_matmat(a, u, d, plan[0], plan[1])
    tops.block_sparse_streaming_degree(x, counts=plan[0], col_idx=plan[1], kind="rbf")
    tops.block_sparse_streaming_matmat(x, u, d, counts=plan[0], col_idx=plan[1], kind="rbf")
    tops.flash_attention(x[None, :, :2], x[None, :, :2], x[None, :, :2])
    assert tops.launch_counts() == {"affinity_and_degree": 0,
                                    "degree_normalized_matmat": 0,
                                    "kmeans_assign": 0,
                                    "streaming_matmat": 0,
                                    "streaming_degree": 0,
                                    "gram": 0,
                                    "row_topk": 0,
                                    "block_liveness": 0,
                                    "block_sparse_matmat": 0,
                                    "block_sparse_streaming_matmat": 0,
                                    "block_sparse_streaming_degree": 0,
                                    "flash_attention": 0}


@pytest.mark.parametrize("op", ["affinity", "matmat", "assign", "streaming_matmat",
                                "streaming_degree", "gram", "row_topk"])
def test_non_cpu_tensor_never_takes_the_plain_version(op):
    """Off the CPU a wrapper launches its kernel or raises: a tensor on a
    device that is not CUDA is rejected before any pointer reaches C."""
    x = torch.empty((8, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        if op == "affinity":
            tops.affinity_and_degree(x)
        elif op == "matmat":
            tops.degree_normalized_matmat(torch.empty((8, 8), device="meta"), x,
                                          torch.empty((8,), device="meta"))
        elif op == "streaming_matmat":
            tops.streaming_matmat(x, x, torch.empty((8,), device="meta"))
        elif op == "streaming_degree":
            tops.streaming_degree(x)
        elif op == "gram":
            tops.gram(x)
        elif op == "row_topk":
            tops.row_topk(x, k=3)
        else:
            tops.kmeans_assign(x, x[:2])


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys\n"
                    "print('fake.cu(1): error: no such intrinsic')\nsys.exit(2)\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        _build.build(("kmeans_assign",))
    # nothing half-built is left where a later call would load it
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").rglob("*"))


def test_build_keeps_the_compiler_report_beside_the_library(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'wb').close()\n"
                    "print('ptxas info    : Used 40 registers')\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    assert "Used 40 registers" in _build.build(("kmeans_assign",))["kmeans_assign"]
    # a second build compiles nothing; the report is read back
    assert _build.build(("kmeans_assign",)) == {}
    assert "Used 40 registers" in _build.report("kmeans_assign")
    with pytest.raises(FileNotFoundError):
        _build.report("gram")


def test_build_dir_is_keyed_by_the_sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in _build.CSRC.iterdir():
        (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.build_dir()
    (csrc / "power_step.cu").write_text(
        (csrc / "power_step.cu").read_text() + "\n// edited\n")
    assert _build.build_dir() != before
    assert os.path.basename(os.path.dirname(before)) == "repro_torch_kernels"
