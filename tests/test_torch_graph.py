"""The port's graph policies (adaptive bandwidth, kNN truncation) against the
reference package, on the CPU.

The same numpy inputs go through both packages. Kernel-level calls go to
the reference's Pallas kernels with ``mode="pallas"`` (interpret mode, as
its own tests run them; ``kernel_fallbacks() == {}`` after each) and to the
port's wrappers on CPU tensors (the plain versions): the streamed row top-k
(pass 1), and the policy operands of the affinity build and the streaming
kernels. The whole runs use the reference with ``use_pallas=False`` (its
jnp oracles: interpret mode would take minutes at n = 480) and the port on
the CPU, with the reference's random draws passed in.

Tolerances:
  - similarity values (A entries, similarity top-k scores): atol 1e-6
    (f32 dot products and transforms, one rounding per step, in two
    orders), on features of norm ~1;
  - neg_sqdist scores: atol 1e-6 max|x|^2 (d2 = |x|^2 + |c|^2 - 2 x.c
    cancels for near neighbours, so its error scales with the norms);
  - squared adaptive scales follow the neg_sqdist rule; a kNN threshold
    follows the similarity rule through exp(-d2 c): |dA| <= 1e-6 +
    c 1e-6 max|x|^2 with c = 1/(2 sigma^2) or, adaptive, the bound of
    ``_rbf_atol``;
  - D and U: the rules of tests/test_torch_kernels.py.
Kept sets (the nonzero pattern of a truncated A) and component ids are held
exactly: a kept set would differ only where a row's k-th and (k+1)-th
scores lie within the similarity tolerance, and such a row would be named
by the assertion with its values.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one torch thread a process: the test run starts several processes at once,
# and torch using every core in each of them slows all of them down
torch.set_num_threads(1)

import repro.core as jcore
from repro.core import power as jpower
from repro.core.graph import affinity_stats as ref_affinity_stats
from repro.core.graph import scales_from_topk as ref_scales_from_topk
from repro.kernels import ops as jops
from repro.kernels.row_topk import row_topk_merge as ref_row_topk_merge
from repro.kernels.row_topk import topk_thresholds_from_scores as ref_topk_thresholds
from repro_torch import AffinitySpec, dataset_by_name
from repro_torch.core import affinity as taff
from repro_torch.core import power as tpower
from repro_torch.core.gpic import _build_engine_operator, _local_health
from repro_torch.core.graph import affinity_stats, scales_from_topk
from repro_torch.core.health import graph_component_probe
from repro_torch.core.kmeans import kmeans
from repro_torch.core.operators import explicit_operator, streaming_operator
from repro_torch.kernels import ops as tops
from repro_torch.kernels.row_topk import MAX_K, row_topk_merge, topk_thresholds_from_scores

A_ATOL = 1e-6
SQD_RTOL = 1e-6
D_RTOL = 1e-5
U_RTOL, U_ATOL = 1e-5, 1e-7
STATE_RTOL = 1e-4
N = 480
SIGMA = 0.8


@pytest.fixture(autouse=True)
def pallas_really_ran():
    """Every reference kernel call must have run the Pallas kernel, not the
    oracle it falls back to when a kernel fails."""
    jops.reset_kernel_fallbacks()
    yield
    assert jops.kernel_fallbacks() == {}


def _x(n, m, seed):
    return np.random.default_rng(seed).normal(size=(n, m)).astype(np.float32) * 0.5


def _positive(n, seed, lo=0.3, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, n).astype(np.float32)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _sq_norm_max(*xs):
    return max(float(np.max(np.sum(np.asarray(x, np.float64) ** 2, axis=1))) for x in xs
               if x is not None)


def _assert_scores_close(got, want, atol):
    """Equal -inf padding, finite entries within atol (a scalar or one
    bound per row)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    err = np.where(fin, np.abs(np.where(fin, got, 0.0) - np.where(fin, want, 0.0)), 0.0)
    assert np.all(err <= np.broadcast_to(np.reshape(atol, (-1, 1)) if np.ndim(atol) else atol,
                                         err.shape))


#: (rows, cols, row_offset, col_offset) of the stripes: the square
#: self-stripe, an off-diagonal stripe that crosses the diagonal, and one
#: whose rows come after its columns, crossed at an offset gap (280) that
#: is no multiple of 16 or 256, over 180 rows (no multiple of 16 either)
STRIPES = {"square": (slice(None), None, 0, 0),
           "offdiag": (slice(100, 400), slice(250, N), 100, 250),
           "below": (slice(300, N), slice(20, 420), 300, 20)}


def _stripe(x, stripe):
    rows, cols, ro, co = STRIPES[stripe]
    return np.ascontiguousarray(x[rows]), None if cols is None else np.ascontiguousarray(
        x[cols]), ro, co


# ---------------------------------------------------------------------------
# pass 1: the streamed row top-k (kernel #7)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stripe", sorted(STRIPES))
@pytest.mark.parametrize("k", [1, 7, 30])
@pytest.mark.parametrize("stat,adaptive", [("neg_sqdist", False), ("similarity", False),
                                           ("similarity", True)],
                         ids=["neg_sqdist", "similarity", "similarity_adaptive"])
def test_row_topk_matches_pallas(stat, adaptive, k, stripe):
    m = 2 if stripe == "square" else 16
    xr, xc, ro, co = _stripe(_x(N, m, seed=k), stripe)
    n_cols = xr.shape[0] if xc is None else xc.shape[0]
    scale_r = _positive(xr.shape[0], seed=1) if adaptive else None
    scale_c = (scale_r if xc is None else _positive(n_cols, seed=2)) if adaptive else None
    kw = dict(k=k, stat=stat, kind="rbf", sigma=SIGMA, row_offset=ro, col_offset=co)
    want = jops.row_topk(jnp.asarray(xr), _j(xc), scale_r=_j(scale_r), scale_c=_j(scale_c),
                         mode="pallas", **kw)
    got = tops.row_topk(_t(xr), _t(xc), scale_r=_t(scale_r), scale_c=_t(scale_c), **kw)
    assert got.shape == (xr.shape[0], k) and got.dtype == torch.float32
    assert bool((got[:, :-1] >= got[:, 1:]).all())            # descending
    if stat == "neg_sqdist":
        atol = SQD_RTOL * _sq_norm_max(xr, xc)
    elif adaptive:       # the row's worst column: exp(-d2 / (s_i s_j)) scales d2's error
        atol = np.max(_rbf_atol(xr, xc, scale_r=scale_r, scale_c=scale_c), axis=1)
    else:
        atol = A_ATOL
    _assert_scores_close(got.numpy(), want, atol)


@pytest.mark.parametrize("kind", ["cosine", "cosine_shifted"])
def test_row_topk_cosine_kinds_match_pallas(kind):
    x = _x(N, 16, seed=3)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    want = jops.row_topk(jnp.asarray(x), k=7, kind=kind, mode="pallas")
    got = tops.row_topk(torch.from_numpy(x), k=7, kind=kind)
    _assert_scores_close(got.numpy(), want, A_ATOL)


@pytest.mark.parametrize("stat", ["neg_sqdist", "similarity"])
def test_row_topk_pads_short_rows_with_neg_inf(stat):
    """5 columns, k = 7: every row keeps its 5 scores (4 where the stripe
    holds its diagonal entry) and pads with -inf."""
    x = _x(40, 2, seed=4)
    xc = np.ascontiguousarray(x[:5])
    kw = dict(k=7, stat=stat, kind="rbf", sigma=SIGMA)
    want = np.asarray(jops.row_topk(jnp.asarray(x), jnp.asarray(xc), mode="pallas", **kw))
    got = tops.row_topk(torch.from_numpy(x), torch.from_numpy(xc), **kw).numpy()
    assert np.isneginf(got[:5, 4:]).all() and np.isneginf(got[5:, 5:]).all()
    assert np.isfinite(got[:5, :4]).all() and np.isfinite(got[5:, :5]).all()
    atol = SQD_RTOL * _sq_norm_max(x) if stat == "neg_sqdist" else A_ATOL
    _assert_scores_close(got, want, atol)


@pytest.mark.parametrize("stat", ["neg_sqdist", "similarity"])
def test_row_topk_keeps_tied_scores(stat):
    """Every point three times over: each score comes in a group of equal
    values (the two copies of the row's own point, then three of each
    other point), and the values kept are the reference's, ties and all."""
    base = _x(60, 2, seed=5)
    x = np.ascontiguousarray(np.concatenate([base, base, base]))
    kw = dict(k=7, stat=stat, kind="rbf", sigma=SIGMA)
    want = np.asarray(jops.row_topk(jnp.asarray(x), mode="pallas", **kw))
    got = tops.row_topk(torch.from_numpy(x), **kw).numpy()
    assert (got[:, 0] == got[:, 1]).all()
    assert (got[:, 2] == got[:, 3]).all() and (got[:, 3] == got[:, 4]).all()
    atol = SQD_RTOL * _sq_norm_max(x) if stat == "neg_sqdist" else A_ATOL
    _assert_scores_close(got, want, atol)


@pytest.mark.parametrize("stripe", sorted(STRIPES))
@pytest.mark.parametrize("stat,adaptive", [("neg_sqdist", False), ("similarity", False),
                                           ("similarity", True)],
                         ids=["neg_sqdist", "similarity", "similarity_adaptive"])
def test_row_topk_same_bits_with_a_zero_feature_column(stat, adaptive, stripe):
    """x and x with a zero feature column appended give the same top-k bits:
    the zero feature changes no dot product, norm or score. The card check
    relies on it to hold the kernel's register template (m <= 2) against
    its staged template (m = 3)."""
    xr, xc, ro, co = _stripe(_x(N, 2, seed=9), stripe)
    n_cols = xr.shape[0] if xc is None else xc.shape[0]
    scale_r = _t(_positive(xr.shape[0], seed=1)) if adaptive else None
    scale_c = (scale_r if xc is None else _t(_positive(n_cols, seed=2))) if adaptive else None
    kw = dict(k=64, stat=stat, kind="rbf", sigma=SIGMA, row_offset=ro, col_offset=co,
              scale_r=scale_r, scale_c=scale_c)
    pad = lambda a: None if a is None else np.pad(a, ((0, 0), (0, 1)))  # noqa: E731
    got = tops.row_topk(_t(xr), _t(xc), **kw)
    assert torch.equal(got, tops.row_topk(_t(pad(xr)), _t(pad(xc)), **kw))


@pytest.mark.parametrize("stat", ["neg_sqdist", "similarity"])
def test_row_topk_k64_ties_across_a_tile_edge(stat):
    """K = 64 over 600 columns, every point three times over (at j, j + 200
    and j + 400), so equal scores lie on both sides of the 256-column tile
    edge: the values kept are the reference's, ties and all."""
    base = _x(200, 2, seed=10)
    x = np.ascontiguousarray(np.concatenate([base, base, base]))
    kw = dict(k=64, stat=stat, kind="rbf", sigma=SIGMA)
    want = np.asarray(jops.row_topk(jnp.asarray(x), mode="pallas", **kw))
    got = tops.row_topk(torch.from_numpy(x), **kw).numpy()
    # the row's two copies of its own point, then groups of three equal scores
    assert (got[:, 0] == got[:, 1]).all()
    assert (got[:, 2:62:3] == got[:, 3:63:3]).all() and (got[:, 3:63:3] == got[:, 4:64:3]).all()
    atol = SQD_RTOL * _sq_norm_max(x) if stat == "neg_sqdist" else A_ATOL
    _assert_scores_close(got, want, atol)


def test_row_topk_refuses_ranks_past_the_kernel():
    x = torch.from_numpy(_x(100, 2, seed=6))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
        tops.row_topk(x, k=MAX_K + 1, kind="rbf")
    with pytest.raises(ValueError, match="k must be >= 1"):
        tops.row_topk(x, k=0, kind="rbf")
    with pytest.raises(ValueError, match="adaptive scaling needs kind='rbf'"):
        tops.row_topk(x, k=3, kind="cosine", scale_r=torch.ones(100), scale_c=torch.ones(100))


def test_row_topk_merge_and_thresholds_from_scores_match_reference():
    rng = np.random.default_rng(7)
    buf = -np.sort(-rng.random((50, 6)).astype(np.float32), axis=1)
    cand = rng.random((50, 40)).astype(np.float32)
    cand[:, 5] = cand[:, 6]                                   # a tie in every row
    np.testing.assert_array_equal(row_topk_merge(_t(buf), _t(cand), 6).numpy(),
                                  np.asarray(ref_row_topk_merge(_j(buf), _j(cand), 6)))
    scores = rng.normal(size=(70, 90)).astype(np.float32)    # signed, like raw cosine
    for k, ro, co in ((1, 0, 0), (10, 0, 0), (10, 20, 5)):
        np.testing.assert_array_equal(
            topk_thresholds_from_scores(_t(scores), k=k, row_offset=ro, col_offset=co).numpy(),
            np.asarray(ref_topk_thresholds(_j(scores), k=k, row_offset=ro, col_offset=co)))


# ---------------------------------------------------------------------------
# the policy operands of kernels #1, #5 and #6
# ---------------------------------------------------------------------------


def _midpoint_thresholds(scores, rank=20):
    """Per-row thresholds halfway between two consecutive scores, from the
    rank-th largest down to the first pair more than 4 A_ATOL apart, so
    that no entry sits within f32 noise of its threshold (two points at the
    same distance give equal scores) and both packages keep the same
    entries. Returns (thresholds, entries kept per row)."""
    s = -np.sort(-np.asarray(scores, np.float64), axis=1)
    gap_ok = (s[:, rank - 1:-1] - s[:, rank:]) > 4 * A_ATOL
    kept = rank + np.argmax(gap_ok, axis=1)
    rows = np.arange(s.shape[0])
    return ((s[rows, kept - 1] + s[rows, kept]) / 2).astype(np.float32), kept


def _policy_operands(xr, xc, ro, co, policy):
    """(scale_r, scale_c, thr, thr_c, entries kept per row) as numpy for
    the named policy, the thresholds placed between the reference oracle's
    scores."""
    n_rows = xr.shape[0]
    n_cols = n_rows if xc is None else xc.shape[0]
    scale_r = scale_c = thr = thr_c = kept = None
    if "scales" in policy:
        scale_r = _positive(n_rows, seed=8)
        scale_c = scale_r if xc is None else _positive(n_cols, seed=9)
    a, _ = jops.affinity_and_degree(jnp.asarray(xr), _j(xc), kind="rbf", sigma=SIGMA,
                                    row_offset=ro, col_offset=co, scale_r=_j(scale_r),
                                    scale_c=_j(scale_c), mode="reference")
    if policy.endswith("thr"):
        thr, kept = _midpoint_thresholds(a)
    if policy.endswith("thr_c"):
        thr_c, _ = _midpoint_thresholds(np.asarray(a).T)
    return scale_r, scale_c, thr, thr_c, kept


def _assert_degrees_close(d_t, d_j, a_ref):
    mass = np.abs(np.asarray(a_ref)).sum(axis=1)
    assert np.all(np.abs(d_t - np.asarray(d_j)) <= D_RTOL * np.maximum(mass, 1e-30))


def _assert_u_close(u_t, u_j):
    u_j = np.asarray(u_j)
    assert u_t.shape == u_j.shape
    assert np.all(np.abs(u_t - u_j) <= U_RTOL * np.abs(u_j) + U_ATOL * np.abs(u_j).max())


POLICIES = ["scales", "thr", "scales_thr"]


@pytest.mark.parametrize("stripe", sorted(STRIPES))
@pytest.mark.parametrize("policy", POLICIES)
def test_affinity_policy_operands_match_pallas(policy, stripe):
    xr, xc, ro, co = _stripe(_x(N, 2, seed=10), stripe)
    sr, sc, thr, _, kept = _policy_operands(xr, xc, ro, co, policy)
    kw = dict(kind="rbf", sigma=SIGMA, row_offset=ro, col_offset=co)
    a_j, d_j = jops.affinity_and_degree(jnp.asarray(xr), _j(xc), scale_r=_j(sr),
                                        scale_c=_j(sc), thr=_j(thr), mode="pallas", **kw)
    a_t, d_t = tops.affinity_and_degree(_t(xr), _t(xc), scale_r=_t(sr), scale_c=_t(sc),
                                        thr=_t(thr), **kw)
    a_j = np.asarray(a_j)
    atol = A_ATOL if sr is None else _rbf_atol(xr, xc, scale_r=sr, scale_c=sc)
    assert np.all(np.abs(a_t.numpy() - a_j) <= atol)
    _assert_degrees_close(d_t.numpy(), d_j, a_j)
    if thr is not None:
        # the kept sets (elsewhere a zero may be an underflow, which the
        # reference's CPU backend flushes from subnormal to 0 and torch not)
        np.testing.assert_array_equal(a_t.numpy() != 0, a_j != 0)
        np.testing.assert_array_equal(np.count_nonzero(a_j, axis=1), kept)


@pytest.mark.parametrize("stripe", sorted(STRIPES))
@pytest.mark.parametrize("policy", POLICIES)
def test_streaming_degree_policy_operands_match_pallas(policy, stripe):
    xr, xc, ro, co = _stripe(_x(N, 16, seed=11), stripe)
    sr, sc, thr, _, _ = _policy_operands(xr, xc, ro, co, policy)
    kw = dict(kind="rbf", sigma=SIGMA, row_offset=ro, col_offset=co)
    d_j = jops.streaming_degree(jnp.asarray(xr), _j(xc), scale_r=_j(sr), scale_c=_j(sc),
                                thr=_j(thr), **kw)
    d_t = tops.streaming_degree(_t(xr), _t(xc), scale_r=_t(sr), scale_c=_t(sc), thr=_t(thr),
                                **kw)
    a_ref, _ = jops.affinity_and_degree(jnp.asarray(xr), _j(xc), scale_r=_j(sr),
                                        scale_c=_j(sc), thr=_j(thr), mode="reference", **kw)
    _assert_degrees_close(d_t.numpy(), d_j, a_ref)


@pytest.mark.parametrize("normalized", [True, False], ids=["d", "d_none"])
@pytest.mark.parametrize("stripe", sorted(STRIPES))
@pytest.mark.parametrize("policy", POLICIES + ["thr_c", "scales_thr_c"])
def test_streaming_matmat_policy_operands_match_pallas(policy, stripe, normalized):
    xr, xc, ro, co = _stripe(_x(N, 2, seed=12), stripe)
    sr, sc, thr, thr_c, _ = _policy_operands(xr, xc, ro, co, policy)
    n_cols = xr.shape[0] if xc is None else xc.shape[0]
    v = np.random.default_rng(13).random((n_cols, 3)).astype(np.float32)
    d = _positive(xr.shape[0], seed=14, lo=1.0, hi=5.0) if normalized else None
    kw = dict(kind="rbf", sigma=SIGMA, row_offset=ro, col_offset=co)
    ops_kw = dict(scale_r=sr, scale_c=sc, thr=thr, thr_c=thr_c)
    u_j = jops.streaming_matmat(jnp.asarray(xr), jnp.asarray(v), _j(d), _j(xc),
                                **{k: _j(a) for k, a in ops_kw.items()}, **kw)
    u_t = tops.streaming_matmat(_t(xr), _t(v), _t(d), _t(xc),
                                **{k: _t(a) for k, a in ops_kw.items()}, **kw)
    _assert_u_close(u_t.numpy(), u_j)


def test_thr_c_product_is_the_transpose_of_the_truncated_graph():
    """The column-thresholded streaming product is A^T V for the truncated
    A, entry for entry: the scores are symmetric."""
    x = torch.from_numpy(_x(N, 2, seed=15))
    spec = AffinitySpec(kind="rbf", sigma=SIGMA, knn_k=10)
    scale, thr = affinity_stats(x, spec)
    a, _ = tops.affinity_and_degree(x, spec=spec, thr=thr)
    v = torch.from_numpy(np.random.default_rng(16).random((N, 2)).astype(np.float32))
    u = tops.streaming_matmat(x, v, None, spec=spec, thr_c=thr)
    want = a.T @ v
    assert torch.equal(u > 0, want > 0)
    assert np.all(np.abs(u.numpy() - want.numpy())
                  <= U_RTOL * np.abs(want.numpy()) + U_ATOL * float(want.abs().max()))


# ---------------------------------------------------------------------------
# the dense oracles and pass 1 (core/affinity.py, core/graph.py)
# ---------------------------------------------------------------------------


def _rbf_atol(x, xc=None, *, sigma=None, scale_r=None, scale_c=None, computed_scales=False):
    """|dA| allowed for A = exp(-d2 c) when d2 carries eps = SQD_RTOL
    max|x|^2: c = 1/(2 sigma^2) gives A_ATOL + c eps; c = 1/(s_i s_j), an
    (R, C) bound, gives A_ATOL + c eps with the scales given alike to both
    packages, and A_ATOL + eps (c + (1/e)(1/(2 s_i^2) + 1/(2 s_j^2))) where
    each package computed its own scales (each s^2 then carries eps too,
    and A u <= 1/e for u = d2 c)."""
    eps = SQD_RTOL * _sq_norm_max(x, xc)
    if scale_r is None:
        return A_ATOL + eps / (2.0 * sigma * sigma)
    sr = np.asarray(scale_r, np.float64)
    sc = sr if scale_c is None else np.asarray(scale_c, np.float64)
    bound = 1.0 / np.outer(sr, sc)
    if computed_scales:
        bound = bound + (1.0 / (2.0 * sr * sr)[:, None] + 1.0 / (2.0 * sc * sc)[None, :]) / np.e
    return A_ATOL + eps * bound


SPECS = {
    "dense_rbf": dict(kind="rbf", sigma=0.3),
    "dense_cosine_shifted": dict(kind="cosine_shifted"),
    "knn": dict(kind="rbf", sigma=0.3, knn_k=10),
    "knn_cosine": dict(kind="cosine", knn_k=5),
    "adaptive": dict(kind="rbf", bandwidth="adaptive", scale_k=7),
    "adaptive_knn": dict(kind="rbf", bandwidth="adaptive", scale_k=7, knn_k=10),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_affinity_matrix_oracle_matches_reference(name):
    x, _, _ = dataset_by_name("two_moons", 300, seed=0)
    jspec, tspec = jcore.AffinitySpec(**SPECS[name]), AffinitySpec(**SPECS[name])
    want = np.asarray(jcore.affinity_matrix(jnp.asarray(x), spec=jspec))
    got = taff.affinity_matrix(torch.from_numpy(x), spec=tspec).numpy()
    if tspec.truncated:    # the kept sets (a dense spec's zeros are underflows)
        np.testing.assert_array_equal(got != 0, want != 0)
    if tspec.kind != "rbf":
        atol = A_ATOL
    elif tspec.adaptive:
        atol = _rbf_atol(x, scale_r=np.asarray(jcore.local_scales(jnp.asarray(x), 7)),
                         computed_scales=True)
    else:
        atol = _rbf_atol(x, sigma=tspec.sigma)
    assert np.all(np.abs(got - want) <= atol)


@pytest.mark.parametrize("sigma", [None, 0.4], ids=["heuristic", "given"])
def test_legacy_rbf_affinity_matrix_matches_reference(sigma):
    x, _, _ = dataset_by_name("gaussians", 1100, seed=0)     # > 2 x the 512-row sample
    want = np.asarray(jcore.affinity_matrix(jnp.asarray(x), "rbf", sigma))
    got = taff.affinity_matrix(torch.from_numpy(x), "rbf", sigma).numpy()
    h_ref = float(jcore.rbf_bandwidth_heuristic(jnp.asarray(x)))
    h = float(taff.rbf_bandwidth_heuristic(torch.from_numpy(x)))
    assert abs(h - h_ref) <= 1e-6 * h_ref
    assert np.all(np.abs(got - want) <= _rbf_atol(x, sigma=sigma or h_ref) * 10)


@pytest.mark.parametrize("name", ["gaussians", "two_moons"])
def test_local_scales_and_knn_thresholds_match_reference(name):
    x, _, _ = dataset_by_name(name, N, seed=0)
    eps = SQD_RTOL * _sq_norm_max(x)
    s_ref = np.asarray(jcore.local_scales(jnp.asarray(x), 7), np.float64)
    s = taff.local_scales(torch.from_numpy(x), 7).numpy().astype(np.float64)
    assert np.all(np.abs(s * s - s_ref * s_ref) <= eps)
    a = np.asarray(jcore.affinity_matrix(jnp.asarray(x), "rbf", 0.3))
    np.testing.assert_array_equal(taff.knn_thresholds(torch.from_numpy(a), 10).numpy(),
                                  np.asarray(jcore.knn_thresholds(jnp.asarray(a), 10)))


@pytest.mark.parametrize("name", ["dense", "knn", "adaptive", "adaptive_knn"])
def test_affinity_stats_match_reference(name):
    """Pass 1 in both packages, the reference through its Pallas row top-k:
    the scales by the neg_sqdist rule, the thresholds by the similarity
    rule carried through the transform."""
    fields = {"dense": SPECS["dense_rbf"], "knn": SPECS["knn"], "adaptive": SPECS["adaptive"],
              "adaptive_knn": SPECS["adaptive_knn"]}[name]
    x, _, _ = dataset_by_name("two_moons", N, seed=0)
    s_ref, t_ref = ref_affinity_stats(jnp.asarray(x), jcore.AffinitySpec(**fields))
    s, t = affinity_stats(torch.from_numpy(x), AffinitySpec(**fields))
    assert (s is None) == (s_ref is None) and (t is None) == (t_ref is None)
    eps = SQD_RTOL * _sq_norm_max(x)
    if s is not None:
        s_ref = np.asarray(s_ref, np.float64)
        assert np.all(np.abs(s.numpy().astype(np.float64) ** 2 - s_ref ** 2) <= eps)
    if t is not None:
        t_ref = np.asarray(t_ref)
        if s is None:
            atol = _rbf_atol(x, sigma=fields["sigma"])
        else:
            atol = np.max(_rbf_atol(x, scale_r=s_ref, computed_scales=True), axis=1)
        assert t.is_contiguous() and np.all(np.abs(t.numpy() - t_ref) <= atol)


def test_scales_from_topk_matches_reference():
    nk = -np.sort(np.random.default_rng(17).random((40, 7)).astype(np.float32), axis=1)
    nk[3] = 0.0                                               # duplicates: d2 = 0
    nk[4, -1] = 1e-3                                          # a rounding above 0
    np.testing.assert_array_equal(scales_from_topk(_t(nk)).numpy(),
                                  np.asarray(ref_scales_from_topk(_j(nk))))
    assert float(scales_from_topk(_t(nk))[3]) == np.float32(taff.SCALE_FLOOR)


#: the reference's TestKnnSpecQuality specs (tests/test_embedding_quality.py),
#: plus one adaptive dense spec: (dataset, spec fields)
QUALITY_CASES = {
    "blobs_knn": ("gaussians", dict(kind="rbf", sigma=0.3, knn_k=10)),
    "moons_knn": ("two_moons", dict(kind="rbf", sigma=0.25, knn_k=30)),
    "three_circles_knn": ("three_circles", dict(kind="rbf", sigma=0.3, knn_k=30)),
    "moons_adaptive_knn": ("two_moons", dict(kind="rbf", bandwidth="adaptive", scale_k=7,
                                             knn_k=10)),
    "gaussians_adaptive": ("gaussians", dict(kind="rbf", bandwidth="adaptive", scale_k=7)),
}
TRUNCATED = [c for c, (_, f) in QUALITY_CASES.items() if "knn_k" in f]


@pytest.mark.parametrize("case", TRUNCATED)
def test_kept_sets_agree(case):
    """The truncated A of both packages (pass 1 and the build, the
    reference's Pallas kernels) has the same nonzero pattern, and every row
    keeps knn_k entries (more only on an exact tie at its threshold)."""
    name, fields = QUALITY_CASES[case]
    x, _, _ = dataset_by_name(name, N, seed=0)
    jspec, tspec = jcore.AffinitySpec(**fields), AffinitySpec(**fields)
    s_ref, t_ref = ref_affinity_stats(jnp.asarray(x), jspec)
    a_ref, _ = jops.affinity_and_degree(jnp.asarray(x), spec=jspec, scale_r=s_ref,
                                        scale_c=s_ref, thr=t_ref, mode="pallas")
    s, t = affinity_stats(torch.from_numpy(x), tspec)
    a, _ = tops.affinity_and_degree(torch.from_numpy(x), spec=tspec, scale_r=s, scale_c=s,
                                    thr=t)
    kept_ref, kept = np.asarray(a_ref) != 0, a.numpy() != 0
    rows = np.flatnonzero((kept_ref != kept).any(axis=1))
    assert rows.size == 0, (
        f"kept sets differ on rows {rows.tolist()}: thresholds port "
        f"{t.numpy()[rows].tolist()} reference {np.asarray(t_ref)[rows].tolist()}")
    counts = kept.sum(axis=1)
    assert (counts >= tspec.knn_k).all()
    ties = counts > tspec.knn_k
    assert ties.sum() <= N // 100, f"{ties.sum()} rows keep more than knn_k"


# ---------------------------------------------------------------------------
# the component probe (core/health.py)
# ---------------------------------------------------------------------------


def _probe_graph(graph):
    """(features, spec) of a graph with a known component structure."""
    if graph == "four_blobs":                     # 4 weak components
        x, _, _ = dataset_by_name("gaussians", N, seed=0)
        return x, dict(kind="rbf", sigma=0.3, knn_k=10)
    rng = np.random.default_rng(18)
    if graph == "twelve_blobs":                   # past max_components = 8
        centers = np.stack(np.meshgrid(np.arange(4), np.arange(3)), -1).reshape(-1, 2) * 10.0
        x = (centers[:, None, :] + rng.normal(size=(12, 20, 2)) * 0.1).reshape(-1, 2)
        return x.astype(np.float32), dict(kind="rbf", sigma=0.5, knn_k=3)
    # a chain of 120 points: one weak component 119 hops long, past
    # max_sweeps = 32, so each seed reaches only part of it
    x = np.stack([np.arange(120) * 1.0, rng.normal(size=120) * 1e-3], axis=1)
    return x.astype(np.float32), dict(kind="rbf", sigma=1.0, knn_k=2)


@pytest.mark.parametrize("engine", ["explicit", "streaming"])
@pytest.mark.parametrize("graph", ["four_blobs", "twelve_blobs", "chain"])
def test_component_probe_matches_reference(graph, engine):
    x, fields = _probe_graph(graph)
    n = x.shape[0]
    build = {"explicit": jcore.explicit_operator, "streaming": jcore.streaming_operator}[engine]
    jop = build(jnp.asarray(x), spec=jcore.AffinitySpec(**fields), use_pallas=False,
                block_sparse=False)
    n_ref, comp_ref = jcore.graph_component_probe(jop, n)
    top = _build_engine_operator(torch.from_numpy(x), AffinitySpec(**fields), engine=engine,
                                 block_sparse=False)
    n_comp, comp = graph_component_probe(top, n)
    assert int(n_comp) == int(n_ref)
    np.testing.assert_array_equal(comp.numpy(), np.asarray(comp_ref))
    expected = {"four_blobs": 4, "twelve_blobs": 9}.get(graph)
    if expected is not None:
        assert int(n_comp) == expected
    else:
        assert int(n_comp) > 1 and (comp.numpy() >= 0).all()   # one chain, cut by the hop cap


# ---------------------------------------------------------------------------
# the two engines and the whole run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(QUALITY_CASES))
def test_truncated_engines_agree_bitwise(case):
    """Inside the port the streaming operator is the explicit one: the same
    degrees and sweeps bit for bit, and the transpose products (stored A^T
    against the column-thresholded stream) with the same positivity."""
    name, fields = QUALITY_CASES[case]
    x, _, _ = dataset_by_name(name, N, seed=0)
    spec = AffinitySpec(**fields)
    exp_op = explicit_operator(torch.from_numpy(x), spec=spec, block_sparse=False)
    str_op = streaming_operator(torch.from_numpy(x), spec=spec, block_sparse=False)
    assert torch.equal(str_op.degree, exp_op.degree)
    v = torch.from_numpy(np.random.default_rng(19).random((N, 2)).astype(np.float32))
    assert torch.equal(str_op.matmat(v), exp_op.matmat(v))
    assert (exp_op.matmat_t is None) == (str_op.matmat_t is None) == (not spec.truncated)
    if spec.truncated:
        ind = torch.zeros((N, 1))
        ind[::37] = 1.0
        assert torch.equal(exp_op.matmat_t(ind) > 0, str_op.matmat_t(ind) > 0)


def _reference_run(case, engine):
    """The reference's run_gpic on a quality case, with its random draws:
    (x, k, result, kmeans++ init, extra power columns)."""
    name, fields = QUALITY_CASES[case]
    x, y, k = dataset_by_name(name, N, seed=0)
    cfg = jcore.GPICConfig(engine=engine, affinity=jcore.AffinitySpec(**fields), max_iter=400,
                           n_vectors=2, embedding="orthogonal", use_pallas=False,
                           block_sparse=False)
    key = jax.random.key(1)
    ref = jcore.run_gpic(jnp.asarray(x), k, cfg, key=key)
    kkm, krand = jax.random.split(key)
    init = np.asarray(jcore.kmeans_plus_plus_init(
        kkm, jcore.standardize_columns(ref.embeddings), k))
    extra = np.array(jpower.random_start_vectors(krand, N, 2))
    return x, k, ref, init, extra


#: cases whose every eps-crossing sits clear of f32 noise; elsewhere
#: column 0 creeps to its crossing and the packages cross a sweep apart,
#: and the block column keeps iterating past its first crossing
#: (ROADMAP queue 3), so those hold column 0 within one sweep and the
#: states with the stopping rule off
EXACT_SWEEPS = ("blobs_knn", "moons_knn")


@pytest.mark.parametrize("engine", ["explicit", "streaming"])
@pytest.mark.parametrize("case", sorted(QUALITY_CASES))
def test_pipeline_gives_the_reference_labels_and_health(case, engine, capsys):
    """The reference's TestKnnSpecQuality runs (orthogonal, r = 2,
    max_iter = 400, block_sparse=False) in both packages, the reference's
    draws passed in: identical labels and health (column status, isolated
    rows, component count and ids), and the sweep counts. Each case's
    ARI and sweep counts are printed (pytest -s)."""
    from repro_torch import adjusted_rand_index
    x, k, ref, init, extra = _reference_run(case, engine)
    spec = AffinitySpec(**QUALITY_CASES[case][1])
    op = _build_engine_operator(torch.from_numpy(x), spec, engine=engine, block_sparse=False)
    v0 = torch.cat([tpower.init_power_vectors(op.degree, 1), torch.from_numpy(extra)], dim=1)
    _, t_cols, done, emb, status = tpower.run_power_embedding(
        op, v0, 1e-5 / N, 400, embedding="orthogonal")
    labels, _ = kmeans(tpower.standardize_columns(emb), k, iters=25,
                       init=torch.from_numpy(init.copy()))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref.labels))
    health = _local_health(op, status, N, spec).to_dict()
    assert health == ref.health.to_dict()
    np.testing.assert_array_equal(_local_health(op, status, N, spec).components.numpy(),
                                  np.asarray(ref.health.components))
    assert done.tolist() == np.asarray(ref.converged_cols).tolist()
    ref_cols = np.asarray(ref.n_iter_cols).tolist()
    y = dataset_by_name(QUALITY_CASES[case][0], N, seed=0)[1]
    with capsys.disabled():
        print(f"\n[{case} {engine}] ARI {adjusted_rand_index(y, labels.numpy()):.4f}; "
              f"n_iter_cols reference {ref_cols} port {t_cols.tolist()}")
    if case in EXACT_SWEEPS:
        assert t_cols.tolist() == ref_cols
    else:
        assert abs(int(t_cols[0]) - ref_cols[0]) <= 1


@pytest.mark.parametrize("case", sorted(QUALITY_CASES))
def test_pipeline_states_agree_without_stopping(case):
    """With the stopping rule off (eps = 0, 40 sweeps) the orthogonal states
    of both packages agree to f32 noise from the same start block."""
    name, fields = QUALITY_CASES[case]
    x, _, _ = dataset_by_name(name, N, seed=0)
    jop = jcore.explicit_operator(jnp.asarray(x), spec=jcore.AffinitySpec(**fields),
                                  use_pallas=False, block_sparse=False)
    v0 = np.array(jcore.init_power_vectors(jax.random.key(2), jop.degree, 2))
    v_ref, t_ref, _ = jcore.batched_power_iteration(jop, jnp.asarray(v0), 0.0, 40,
                                                    mode="orthogonal")
    top = explicit_operator(torch.from_numpy(x), spec=AffinitySpec(**fields),
                            block_sparse=False)
    v, t_cols, _ = tpower.batched_power_iteration(top, torch.from_numpy(v0), 0.0, 40,
                                                  mode="orthogonal")
    assert t_cols.tolist() == np.asarray(t_ref).tolist() == [40, 40]
    v_ref = np.asarray(v_ref)
    assert np.max(np.abs(v.numpy() - v_ref)) <= STATE_RTOL * np.max(np.abs(v_ref))


def test_blobs_knn_past_the_reference_size_degrades_alike(capsys):
    """E1's spec (blobs, rbf 0.3, knn_k=10, orthogonal r = 2) at n = 1,500,
    past the n = 480 of the reference's floor: the kNN graph falls apart
    into its four blobs, column 0 stops before it mixes inside them, and
    both packages cluster alike badly (the reference's ARI under its 0.95
    floor), with the same components and sweep counts. Their labels need
    not be equal: inside a blob the embedding is the slowly decaying part
    of the iterate, which the f32 rounding of d2 in A moves by a few
    percent of its spread. The numbers are printed (pytest -s)."""
    from repro_torch import adjusted_rand_index
    n = 1500
    x, y, k = dataset_by_name("gaussians", n, seed=0)
    fields = dict(kind="rbf", sigma=0.3, knn_k=10)
    cfg = jcore.GPICConfig(affinity=jcore.AffinitySpec(**fields), max_iter=400, n_vectors=2,
                           embedding="orthogonal", use_pallas=False, block_sparse=False)
    key = jax.random.key(1)
    ref = jcore.run_gpic(jnp.asarray(x), k, cfg, key=key)
    kkm, krand = jax.random.split(key)
    init = np.asarray(jcore.kmeans_plus_plus_init(
        kkm, jcore.standardize_columns(ref.embeddings), k))
    extra = np.array(jpower.random_start_vectors(krand, n, 2))
    spec = AffinitySpec(**fields)
    op = _build_engine_operator(torch.from_numpy(x), spec, engine="explicit",
                                block_sparse=False)
    v0 = torch.cat([tpower.init_power_vectors(op.degree, 1), torch.from_numpy(extra)], dim=1)
    _, t_cols, _, emb, status = tpower.run_power_embedding(op, v0, 1e-5 / n, 400,
                                                           embedding="orthogonal")
    labels, _ = kmeans(tpower.standardize_columns(emb), k, iters=25,
                       init=torch.from_numpy(init.copy()))
    health = _local_health(op, status, n, spec)
    ari_ref = adjusted_rand_index(y, np.asarray(ref.labels))
    ari = adjusted_rand_index(y, labels.numpy())
    between = adjusted_rand_index(np.asarray(ref.labels), labels.numpy())
    with capsys.disabled():
        print(f"\n[n={n} blobs knn_k=10] ARI reference {ari_ref:.4f} port {ari:.4f} "
              f"between {between:.4f}; n_iter_cols {t_cols.tolist()}; "
              f"n_components {int(health.n_components)}")
    assert int(health.n_components) == int(ref.health.n_components) == 4
    np.testing.assert_array_equal(health.components.numpy(), np.asarray(ref.health.components))
    assert t_cols.tolist() == np.asarray(ref.n_iter_cols).tolist()
    assert max(ari, ari_ref) < 0.95 and abs(ari - ari_ref) <= 0.05
    assert between >= 0.9
