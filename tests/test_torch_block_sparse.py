"""The port's block-sparse route and row reorder against the reference
package, on the CPU.

The same numpy inputs go through both packages: the plan helpers
(``block_plan``, ``plan_to_live``, ``dense_block_live``,
``invert_permutation``), the reorder's ``content_row_score`` and
``reorder_permutation``, the plain versions of the four block-sparse
kernels against the reference's oracles (and its Pallas kernels in
interpret mode at a tiny shape, ``kernel_fallbacks() == {}`` after each),
the fused one-pass build, and whole ``run_gpic`` runs with
``block_sparse=True`` and ``row_reorder=True``. The port plans on its own
(16, 256) grid; the reference's oracles take the tile sizes as arguments
and are called on the same grid and the same plan.

Tolerances (the rules of tests/test_torch_graph.py):
  - A entries and kNN thresholds: atol 1e-6 (f32 similarities in two
    orders); kept sets (the nonzero pattern), live maps, plans and
    permutations exactly;
  - D: 1e-5 of the row's absolute mass; U: rtol 1e-5 + 1e-7 max|U|; the
    fused build's D against the reference's: 1e-6 of the row mass (the
    same entries summed in two orders);
  - content scores: 1e-6 relative (m = 16 sums in two orders; at m = 2
    they agree exactly);
  - whole runs: identical labels, health and components, ``n_iter_cols``
    exactly on blobs and moons kNN (as tests/test_torch_graph.py holds
    them).
Inside the port, the block-sparse route gives the dense-storage route's
results exactly: the same values and the same sums on the CPU, and on the
card the same bits (``chip_smoke.py``).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one torch thread a process: the test run starts several processes at once,
# and torch using every core in each of them slows all of them down
torch.set_num_threads(1)

from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as jcore
from repro.core import affinity as jaff
from repro.core import graph as jgraph
from repro.core import power as jpower
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import AffinitySpec, GPICConfig, adjusted_rand_index, dataset_by_name, run_gpic
from repro_torch.core import affinity as taff
from repro_torch.core import graph as tgraph
from repro_torch.core import operators as toperators
from repro_torch.core import power as tpower
from repro_torch.core.gpic import _build_engine_operator, _local_health
from repro_torch.core.kmeans import kmeans
from repro_torch.interop import config_from_reference, result_to_numpy
from repro_torch.kernels import ops as tops
from repro_torch.kernels.row_topk import topk_thresholds_from_scores

A_ATOL = 1e-6
D_RTOL = 1e-5
U_RTOL, U_ATOL = 1e-5, 1e-7
SCORE_RTOL = 1e-6
N = 520                   # three column tiles of the port's grid
RUN_N = 480               # tests/test_torch_graph.py's whole runs
TM, TN = tops.PLAN_TM, tops.TN

SPECS = {
    "dense": dict(kind="rbf", sigma=1.0),     # no entry underflows: every tile live
    "knn": dict(kind="rbf", sigma=0.3, knn_k=10),
    "adaptive_knn": dict(kind="rbf", bandwidth="adaptive", scale_k=7, knn_k=10),
}
#: tests/test_torch_graph.py's kNN quality cases: (dataset, spec fields)
QUALITY_CASES = {
    "blobs_knn": ("gaussians", dict(kind="rbf", sigma=0.3, knn_k=10)),
    "moons_knn": ("two_moons", dict(kind="rbf", sigma=0.25, knn_k=30)),
    "moons_adaptive_knn": ("two_moons", dict(kind="rbf", bandwidth="adaptive", scale_k=7,
                                             knn_k=10)),
}


@pytest.fixture(autouse=True)
def pallas_really_ran():
    """A reference kernel call asked for Pallas must have run it, not the
    oracle it falls back to when a kernel fails."""
    jops.reset_kernel_fallbacks()
    yield
    assert jops.kernel_fallbacks() == {}


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _j(a):
    return None if a is None else jnp.asarray(np.asarray(a))


# ---------------------------------------------------------------------------
# the plan helpers (core/affinity.py)
# ---------------------------------------------------------------------------


def _random_live(n_i, n_j, seed, density=0.4):
    return np.random.default_rng(seed).random((n_i, n_j)) < density


def _assert_plan_matches_reference(live):
    counts, col_idx, max_b = taff.block_plan(torch.from_numpy(live))
    j_counts, j_col_idx, j_max_b = jaff.block_plan(jnp.asarray(live))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    np.testing.assert_array_equal(col_idx.numpy(), np.asarray(j_col_idx))
    assert int(max_b) == int(j_max_b)
    assert counts.dtype == col_idx.dtype == torch.int32
    back = taff.plan_to_live(counts, col_idx).numpy()
    np.testing.assert_array_equal(back, live)
    np.testing.assert_array_equal(back, np.asarray(jaff.plan_to_live(j_counts, j_col_idx)))


@pytest.mark.parametrize("shape,density", [((1, 1), 0.0), ((1, 1), 1.0), ((3, 7), 0.4),
                                           ((13, 17), 0.2), ((33, 3), 0.0), ((8, 5), 1.0)],
                         ids=["one_dead", "one_live", "small", "ragged", "all_dead", "all_live"])
def test_block_plan_matches_reference(shape, density):
    """Live ids ascending, then dead ids ascending; max_b clamped to 1."""
    _assert_plan_matches_reference(_random_live(*shape, seed=sum(shape), density=density))


@settings(max_examples=15, deadline=None)
@given(n_i=st.integers(1, 9), n_j=st.integers(1, 9), seed=st.integers(0, 2**16),
       density=st.floats(0.0, 1.0))
def test_block_plan_round_trip_property(n_i, n_j, seed, density):
    _assert_plan_matches_reference(_random_live(n_i, n_j, seed, density))


@pytest.mark.parametrize("shape,tiles", [((520, 520), (16, 256)), ((37, 300), (16, 256)),
                                         ((45, 29), (8, 7)), ((64, 64), (64, 64))],
                         ids=["port_grid", "ragged_port_grid", "ragged_small", "one_tile"])
def test_dense_block_live_matches_reference(shape, tiles):
    """Padding never makes a tile live; a NaN entry does."""
    rng = np.random.default_rng(shape[0])
    a = np.where(rng.random(shape) < 0.01, rng.random(shape), 0.0).astype(np.float32)
    a[-1, -1] = np.nan
    want = np.asarray(jaff.dense_block_live(jnp.asarray(a), *tiles))
    for stripe in (4096, 2 * tiles[0]):                    # one stripe, several
        got = taff.dense_block_live(torch.from_numpy(a), *tiles, stripe=stripe)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)


def test_invert_permutation_matches_reference():
    perm = np.random.default_rng(3).permutation(777).astype(np.int64)
    inv = taff.invert_permutation(torch.from_numpy(perm))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jaff.invert_permutation(
        jnp.asarray(perm, jnp.int32))))
    np.testing.assert_array_equal(perm[inv.numpy()], np.arange(777))


# ---------------------------------------------------------------------------
# the reorder's ordering (core/graph.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [481, 480], ids=["odd_n", "even_n"])
@pytest.mark.parametrize("m", [2, 16])
def test_content_row_score_matches_reference(n, m):
    """The per-column median is the midpoint of the two middle values
    (jnp.median), which torch.median is not: even n hits the midpoint."""
    x = np.random.default_rng(n + m).normal(size=(n, m)).astype(np.float32)
    x[1] = x[0]                                        # a duplicated row ties
    got = tgraph.content_row_score(torch.from_numpy(x)).numpy()
    want = np.asarray(jgraph.content_row_score(jnp.asarray(x)))
    assert np.max(np.abs(got - want)) <= SCORE_RTOL * np.max(np.abs(want))
    if m == 2:
        np.testing.assert_array_equal(got, want)
    assert got[0] == got[1]


@pytest.mark.parametrize("with_components", [False, True], ids=["scores", "components"])
def test_reorder_permutation_matches_reference(with_components):
    """Groups keyed by their smallest score, unreached rows (-1) last, ties
    in score kept in input order."""
    rng = np.random.default_rng(11)
    score = rng.random(300).astype(np.float32)
    score[10:20] = score[5]                               # ties
    comp = None
    if with_components:
        comp = rng.integers(-1, 6, 300).astype(np.int32)
        comp[:4] = -1
    got = tgraph.reorder_permutation(torch.from_numpy(score), _t(comp))
    want = jgraph.reorder_permutation(jnp.asarray(score), _j(comp))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the four kernels' plain versions (kernels/ref.py) against the oracles
# ---------------------------------------------------------------------------


def _midpoint_thresholds(scores, rank):
    """Per-row thresholds halfway between two consecutive scores, from the
    rank-th largest down to the first pair more than 4 A_ATOL apart, so no
    entry sits within f32 noise of its threshold and both packages keep the
    same entries (tests/test_torch_graph.py's rule)."""
    s = -np.sort(-np.asarray(scores, np.float64), axis=1)
    gap_ok = (s[:, rank - 1:-1] - s[:, rank:]) > 4 * A_ATOL
    kept = rank + np.argmax(gap_ok, axis=1)
    rows = np.arange(s.shape[0])
    return ((s[rows, kept - 1] + s[rows, kept]) / 2).astype(np.float32)


def _operands(spec_name, m):
    """(x (N, m), reference spec, scale, thr) as numpy on cluster-sorted
    blobs (m = 2: the paper's gaussians; m = 16: tight blobs near the
    origin, so that |x|^2, whose rounding enters d2, stays near the
    neighbours' d2 at sigma 0.3):
    the reference's adaptive scales, and kNN thresholds placed between the
    reference's scores at rank knn_k."""
    if m == 2:
        x, _, _ = dataset_by_name("gaussians", N, seed=0)
    else:
        rng = np.random.default_rng(5)
        centers = rng.uniform(-0.3, 0.3, (4, m))
        x = np.concatenate([c + 0.08 * rng.standard_normal((N // 4, m)) for c in centers])
        x = x.astype(np.float32)
    spec = jcore.AffinitySpec(**SPECS[spec_name])
    scale, thr = jgraph.affinity_stats(jnp.asarray(x), spec)
    if thr is not None:
        a, _ = jops.affinity_and_degree(jnp.asarray(x), spec=spec, scale_r=scale,
                                        scale_c=scale, mode="reference")
        thr = _midpoint_thresholds(a, spec.knn_k)
    return x, spec, None if scale is None else np.asarray(scale), thr


def _plan_of(x, spec, scale, thr):
    live = tops.block_liveness(_t(x), spec=spec, scale_r=_t(scale), scale_c=_t(scale),
                               thr=_t(thr))
    return live, taff.block_plan(live)


def _assert_u_close(u_t, u_j):
    u_j = np.asarray(u_j)
    assert u_t.shape == u_j.shape
    assert np.all(np.abs(u_t - u_j) <= U_RTOL * np.abs(u_j) + U_ATOL * np.abs(u_j).max())


@pytest.mark.parametrize("m", [2, 16])
@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_block_sparse_plain_versions_match_reference_oracles(spec_name, m):
    """Liveness exactly; D and U (r = 1, 4; d given and None) within the
    stated tolerances, on the same plan and the same (16, 256) grid. A
    truncated spec on cluster-sorted rows leaves dead tiles to skip."""
    x, jspec, scale, thr = _operands(spec_name, m)
    tspec = AffinitySpec(**SPECS[spec_name])
    live, (counts, col_idx, max_b) = _plan_of(x, tspec, scale, thr)
    pol_j = dict(kind="rbf", sigma=jspec.sigma, scale_r=_j(scale), scale_c=_j(scale),
                 thr=_j(thr))
    pol_t = dict(kind="rbf", sigma=jspec.sigma, scale_r=_t(scale), scale_c=_t(scale),
                 thr=_t(thr))
    live_ref = jref.block_liveness_ref(jnp.asarray(x), tm=TM, tn=TN, **pol_j)
    np.testing.assert_array_equal(live.numpy(), np.asarray(live_ref))
    assert live.dtype == torch.int32
    if jspec.knn_k is not None:
        assert 0 < float(live.float().mean()) < 1, "the plan skips nothing"
    plan_j = dict(counts=jnp.asarray(counts.numpy()), col_idx=jnp.asarray(col_idx.numpy()),
                  tm=TM, tn=TN)
    plan_t = dict(counts=counts, col_idx=col_idx)
    a_ref, _ = jref.affinity_and_degree_ref(jnp.asarray(x), **pol_j)
    mass = np.abs(np.asarray(a_ref)).sum(axis=1)
    d = tops.block_sparse_streaming_degree(_t(x), **plan_t, **pol_t)
    d_ref = jref.block_sparse_streaming_degree_ref(jnp.asarray(x), **plan_j, **pol_j)
    assert np.all(np.abs(d.numpy() - np.asarray(d_ref)) <= D_RTOL * np.maximum(mass, 1e-30))
    rng = np.random.default_rng(m)
    for r in (1, 4):
        v = rng.random((N, r)).astype(np.float32)
        for dd in (np.asarray(d_ref), None):
            u = tops.block_sparse_streaming_matmat(_t(x), _t(v), _t(dd), **plan_t, **pol_t)
            u_ref = jref.block_sparse_streaming_matmat_ref(jnp.asarray(x), jnp.asarray(v),
                                                           _j(dd), **plan_j, **pol_j)
            _assert_u_close(u.numpy(), u_ref)
        a = _t(a_ref)
        u = tops.block_sparse_matmat(a, _t(v), _t(d_ref), counts, col_idx)
        u_ref = jref.block_sparse_matmat_ref(jnp.asarray(a_ref), jnp.asarray(v),
                                             jnp.asarray(d_ref), **plan_j)
        _assert_u_close(u.numpy(), u_ref)


@pytest.mark.parametrize("op", ["block_liveness", "block_sparse_matmat",
                                "block_sparse_streaming_matmat",
                                "block_sparse_streaming_degree"])
def test_block_sparse_plain_versions_match_pallas(op):
    """The reference's Pallas kernels in interpret mode at a tiny shape
    (n = 300, two column tiles, E1's operands) on the port's grid and
    plan."""
    n = 300
    x, _, _ = dataset_by_name("gaussians", n, seed=1)
    jspec = jcore.AffinitySpec(**SPECS["knn"])
    scores, _ = jops.affinity_and_degree(jnp.asarray(x), spec=jspec, mode="reference")
    thr = _midpoint_thresholds(scores, jspec.knn_k)
    tspec = AffinitySpec(**SPECS["knn"])
    live, (counts, col_idx, max_b) = _plan_of(x, tspec, None, thr)
    plan_j = dict(counts=jnp.asarray(counts.numpy()), col_idx=jnp.asarray(col_idx.numpy()),
                  max_b=jnp.asarray(int(max_b)), tm=TM, tn=TN)
    v = np.random.default_rng(2).random((n, 2)).astype(np.float32)
    a_ref, d_ref = jops.affinity_and_degree(jnp.asarray(x), spec=jspec, thr=jnp.asarray(thr),
                                            mode="reference")
    if op == "block_liveness":
        want = jops.block_liveness(jnp.asarray(x), spec=jspec, thr=jnp.asarray(thr), tm=TM,
                                   tn=TN, mode="pallas")
        np.testing.assert_array_equal(live.numpy(), np.asarray(want))
        return
    if op == "block_sparse_matmat":
        got = tops.block_sparse_matmat(_t(a_ref), _t(v), _t(d_ref), counts, col_idx)
        want = jops.block_sparse_matmat(a_ref, jnp.asarray(v), d_ref, plan_j["counts"],
                                        plan_j["col_idx"], plan_j["max_b"], tm=TM, tn=TN,
                                        mode="pallas")
        _assert_u_close(got.numpy(), want)
        return
    plan_t = dict(counts=counts, col_idx=col_idx)
    if op == "block_sparse_streaming_degree":
        got = tops.block_sparse_streaming_degree(_t(x), spec=tspec, thr=_t(thr), **plan_t)
        want = jops.block_sparse_streaming_degree(jnp.asarray(x), spec=jspec,
                                                  thr=jnp.asarray(thr), mode="streaming",
                                                  **plan_j)
        mass = np.abs(np.asarray(a_ref)).sum(axis=1)
        assert np.all(np.abs(got.numpy() - np.asarray(want)) <= D_RTOL * mass)
        return
    got = tops.block_sparse_streaming_matmat(_t(x), _t(v), _t(d_ref), spec=tspec, thr=_t(thr),
                                             **plan_t)
    want = jops.block_sparse_streaming_matmat(jnp.asarray(x), jnp.asarray(v), d_ref,
                                              spec=jspec, thr=jnp.asarray(thr),
                                              mode="streaming", **plan_j)
    _assert_u_close(got.numpy(), want)


def test_dead_tiles_contribute_nothing():
    """A plan with a live tile marked dead drops exactly that tile's
    columns from the plain sweep (the plan, not the values, decides)."""
    x, _, _, thr = _operands("knn", 2)
    tspec = AffinitySpec(**SPECS["knn"])
    a, d = tops.affinity_and_degree(_t(x), spec=tspec, thr=_t(thr))
    live = taff.dense_block_live(a, TM, TN)
    live[0, 0] = False
    counts, col_idx, _ = taff.block_plan(live)
    v = torch.ones((N, 1))
    u = tops.block_sparse_matmat(a, v, d, counts, col_idx)
    a_cut = a.clone()
    a_cut[:TM, :TN] = 0.0
    torch.testing.assert_close(u, (a_cut @ v) / d.clamp_min(1e-30)[:, None], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the fused one-pass build (core/graph.py::fused_affinity_build)
# ---------------------------------------------------------------------------


def test_thresholds_from_scores_in_stripes_match_reference():
    """The fused build's thresholds, a few rows at a time and all at once,
    with the diagonal of an offset stripe excluded by index."""
    scores = np.random.default_rng(9).normal(size=(70, 90)).astype(np.float32)
    want = np.asarray(jgraph.topk_thresholds_from_scores(jnp.asarray(scores), k=10,
                                                         row_offset=20, col_offset=5))
    for stripe in (4096, 16):
        got = topk_thresholds_from_scores(torch.from_numpy(scores), k=10, row_offset=20,
                                          col_offset=5, stripe=stripe)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["blobs_knn", "moons_knn", "moons_adaptive_knn"])
def test_fused_build_matches_reference_and_two_pass(case):
    """Against the reference's fused build: A within atol, the same kept
    set, D within 1e-6 of the row mass, thresholds within atol. Against the
    port's own two-pass build (pass 1b, then the thresholded build): the
    same A, D and thresholds exactly."""
    name, fields = QUALITY_CASES[case]
    x, _, _ = dataset_by_name(name, N, seed=0)
    jspec, tspec = jcore.AffinitySpec(**fields), AffinitySpec(**fields)
    scale, _ = jgraph.affinity_stats(jnp.asarray(x), jspec)
    a_j, d_j, thr_j = jgraph.fused_affinity_build(jnp.asarray(x), spec=jspec, scale_r=scale,
                                                  scale_c=scale, tm=TM, tn=TN,
                                                  use_pallas=False)
    sc = _t(scale)
    a, d, thr = tgraph.fused_affinity_build(_t(x), spec=tspec, scale_r=sc, scale_c=sc)
    a_j = np.asarray(a_j)
    assert np.max(np.abs(a.numpy() - a_j)) <= A_ATOL
    np.testing.assert_array_equal(a.numpy() != 0, a_j != 0)
    assert np.max(np.abs(thr.numpy() - np.asarray(thr_j))) <= A_ATOL
    mass = np.abs(a_j).sum(axis=1)
    assert np.all(np.abs(d.numpy() - np.asarray(d_j)) <= 1e-6 * mass)
    sc2, thr2 = tgraph.affinity_stats(_t(x), tspec)     # the port's own pass 1
    a1, d1, thr1 = tgraph.fused_affinity_build(_t(x), spec=tspec, scale_r=sc2, scale_c=sc2)
    a2, d2 = tops.affinity_and_degree(_t(x), spec=tspec, scale_r=sc2, scale_c=sc2, thr=thr2)
    assert torch.equal(thr1, thr2) and torch.equal(a1, a2) and torch.equal(d1, d2)


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------




def _reference_run(case, engine):
    """The reference's run_gpic on a case with block_sparse=True (its jnp
    oracles), orthogonal r = 2, with its random draws: (x, k, result,
    kmeans++ init, extra power columns)."""
    name, fields = QUALITY_CASES[case]
    x, _, k = dataset_by_name(name, RUN_N, seed=0)
    cfg = jcore.GPICConfig(engine=engine, affinity=jcore.AffinitySpec(**fields), max_iter=400,
                           n_vectors=2, embedding="orthogonal", use_pallas=False)
    key = jax.random.key(1)
    ref = jcore.run_gpic(jnp.asarray(x), k, cfg, key=key)
    kkm, krand = jax.random.split(key)
    init = np.asarray(jcore.kmeans_plus_plus_init(
        kkm, jcore.standardize_columns(ref.embeddings), k))
    extra = np.array(jpower.random_start_vectors(krand, RUN_N, 2))
    return x, k, ref, init, extra


def _port_run(x, k, spec, engine, block_sparse, init, extra):
    op = _build_engine_operator(torch.from_numpy(x), spec, engine=engine,
                                block_sparse=block_sparse)
    v0 = torch.cat([tpower.init_power_vectors(op.degree, 1), torch.from_numpy(extra)], dim=1)
    n = x.shape[0]
    _, t_cols, done, emb, status = tpower.run_power_embedding(op, v0, 1e-5 / n, 400,
                                                              embedding="orthogonal")
    labels, _ = kmeans(tpower.standardize_columns(emb), k, iters=25,
                       init=torch.from_numpy(init.copy()))
    return labels, t_cols, done, emb, _local_health(op, status, n, spec)


@pytest.mark.parametrize("engine", ["explicit", "streaming"])
@pytest.mark.parametrize("case", ["blobs_knn", "moons_knn"])
def test_block_sparse_run_gives_the_reference_result(case, engine):
    """The reference's block_sparse=True run (orthogonal, r = 2,
    max_iter = 400) with its draws passed in: identical labels, health and
    component ids, and sweep counts. The port's block_sparse=False run
    from the same draws gives the same result exactly."""
    x, k, ref, init, extra = _reference_run(case, engine)
    spec = AffinitySpec(**QUALITY_CASES[case][1])
    labels, t_cols, done, emb, health = _port_run(x, k, spec, engine, True, init, extra)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref.labels))
    assert health.to_dict() == ref.health.to_dict()
    np.testing.assert_array_equal(health.components.numpy(), np.asarray(ref.health.components))
    assert t_cols.tolist() == np.asarray(ref.n_iter_cols).tolist()
    assert done.tolist() == np.asarray(ref.converged_cols).tolist()
    dense = _port_run(x, k, spec, engine, False, init, extra)
    assert torch.equal(dense[0], labels) and torch.equal(dense[1], t_cols)
    assert torch.equal(dense[3], emb)
    assert torch.equal(dense[4].components, health.components)


@pytest.mark.parametrize("engine", ["explicit", "streaming"])
def test_run_gpic_block_sparse_equals_dense_storage(engine):
    """The front door with the default block_sparse=True gives the
    block_sparse=False run exactly, and the reference's partition."""
    x, y, k = dataset_by_name("gaussians", N, seed=0)
    cfg = GPICConfig(engine=engine, affinity=AffinitySpec(kind="rbf", sigma=0.3, knn_k=10),
                     max_iter=400)
    bs = result_to_numpy(run_gpic(x, k, cfg, device="cpu"))
    dense = result_to_numpy(run_gpic(x, k, cfg.with_(block_sparse=False), device="cpu"))
    for name in bs:
        np.testing.assert_array_equal(bs[name], dense[name], err_msg=name)
    ref = jcore.run_gpic(jnp.asarray(x), k, jcore.GPICConfig(
        engine=engine, affinity=jcore.AffinitySpec(kind="rbf", sigma=0.3, knn_k=10),
        max_iter=400, use_pallas=False), key=jax.random.key(0))
    assert adjusted_rand_index(np.asarray(ref.labels), bs["labels"]) == 1.0
    assert int(ref.health.n_components) == int(bs["health_n_components"])


def test_degenerate_grid_takes_the_dense_route(monkeypatch):
    """One column tile (n <= 256) has nothing to skip: neither engine
    plans, as in the reference; at n = 257 both do."""
    def refuse(*args, **kwargs):
        raise AssertionError("the block-sparse route ran")

    monkeypatch.setattr(toperators, "fused_affinity_build", refuse)
    monkeypatch.setattr(toperators, "block_plan", refuse)
    spec = AffinitySpec(kind="rbf", sigma=0.3, knn_k=10)
    x, _, k = dataset_by_name("gaussians", 257, seed=0)
    for engine in ("explicit", "streaming"):
        run_gpic(x[:256], k, GPICConfig(engine=engine, affinity=spec), device="cpu")
        with pytest.raises(AssertionError, match="block-sparse route"):
            run_gpic(x, k, GPICConfig(engine=engine, affinity=spec), device="cpu")


def test_nan_in_v_latches_like_the_reference():
    """A NaN power column on the block-sparse operator: the plain sweep
    multiplies every masked zero, so the NaN reaches every row, as the
    reference's oracle does, and the loop's latches read the same (the
    kernel on the card skips dead tiles and spreads it less far, to the
    same COL_NONFINITE latch)."""
    x, _, _ = dataset_by_name("gaussians", N, seed=0)
    fields = QUALITY_CASES["blobs_knn"][1]
    jop = jcore.explicit_operator(jnp.asarray(x), spec=jcore.AffinitySpec(**fields),
                                  use_pallas=False)
    top = toperators.explicit_operator(torch.from_numpy(x), spec=AffinitySpec(**fields))
    v0 = np.stack([np.asarray(jop.degree) / float(np.sum(jop.degree)), np.full(N, 1.0 / N)],
                  axis=1).astype(np.float32)
    v0[7, 1] = np.nan
    _, t_ref, done_ref, st_ref = jcore.batched_power_iteration(
        jop, jnp.asarray(v0), 1e-5 / N, 50, return_status=True)
    _, t_cols, done, status = tpower.batched_power_iteration(
        top, torch.from_numpy(v0), 1e-5 / N, 50, return_status=True)
    np.testing.assert_array_equal(status.numpy(), np.asarray(st_ref))
    np.testing.assert_array_equal(t_cols.numpy(), np.asarray(t_ref))
    np.testing.assert_array_equal(done.numpy(), np.asarray(done_ref))
    assert status.tolist()[1] & jcore.COL_NONFINITE


# ---------------------------------------------------------------------------
# the row reorder
# ---------------------------------------------------------------------------


def _blobs(n, n_blobs, seed, scale=0.5):
    """Cluster-sorted 2-D blobs (tests/test_overlap_reorder.py's)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-20.0, 20.0, (n_blobs, 2))
    return np.concatenate([centers[i] + scale * rng.standard_normal((n // n_blobs, 2))
                           for i in range(n_blobs)]).astype(np.float32)


@pytest.mark.parametrize("engine", ["explicit", "streaming"])
@pytest.mark.parametrize("spec_fields", [dict(kind="rbf", sigma=1.0), dict(kind="cosine_shifted"),
                                         dict(kind="rbf", sigma=1.0, knn_k=10)],
                         ids=["rbf", "cosine_shifted", "rbf_knn"])
def test_row_reorder_round_trip(spec_fields, engine):
    """A run and a run on the shuffled rows give the same re-aligned result
    bit for bit (labels, embeddings, components), with the reference's
    permutation and partition, and note the pass."""
    x = _blobs(96, 3, seed=2, scale=0.3)
    p = np.random.default_rng(2).permutation(96)
    cfg = GPICConfig(engine=engine, affinity=AffinitySpec(**spec_fields), max_iter=40,
                     row_reorder=True)
    a = result_to_numpy(run_gpic(x, 3, cfg, device="cpu"))
    b_res = run_gpic(x[p], 3, cfg, device="cpu")
    b = result_to_numpy(b_res)
    for name in ("labels", "embedding", "embeddings", "health_components"):
        np.testing.assert_array_equal(a[name][p], b[name], err_msg=name)
    assert "row_reorder" in b_res.health.notes
    jspec = jcore.AffinitySpec(**spec_fields)
    perm = tgraph.graph_reorder_permutation(torch.from_numpy(x[p]), AffinitySpec(**spec_fields))
    perm_ref = jgraph.graph_reorder_permutation(jnp.asarray(x[p]), jspec, use_pallas=False)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_ref))
    ref = jcore.run_gpic(jnp.asarray(x[p]), 3, jcore.GPICConfig(
        engine=engine, affinity=jspec, max_iter=40, row_reorder=True, use_pallas=False),
        key=jax.random.key(0))
    assert adjusted_rand_index(np.asarray(ref.labels), b["labels"]) == 1.0
    assert ref.health.notes == b_res.health.notes


def test_row_reorder_recovers_tile_liveness():
    """The reference's liveness test on the port's (16, 256) grid: on
    shuffled cluster data every tile is live; the reorder groups the
    components back, to within 1.5x the sorted data's live fraction. The
    permutation is the reference's."""
    spec_fields = dict(kind="rbf", sigma=0.25, knn_k=30)
    spec = AffinitySpec(**spec_fields)
    x_sorted = _blobs(1024, 8, seed=0)
    x_shuf = x_sorted[np.random.default_rng(7).permutation(1024)]
    perm = tgraph.graph_reorder_permutation(torch.from_numpy(x_shuf), spec)
    perm_ref = jgraph.graph_reorder_permutation(jnp.asarray(x_shuf),
                                                jcore.AffinitySpec(**spec_fields),
                                                use_pallas=False)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_ref))

    def live_frac(xv):
        a, _, _ = tgraph.fused_affinity_build(torch.from_numpy(xv), spec=spec)
        counts, _, _ = taff.block_plan(taff.dense_block_live(a, TM, TN))
        return float(counts.sum()) / (counts.shape[0] * -(-1024 // TN))

    f_sorted, f_shuf, f_reord = map(live_frac, (x_sorted, x_shuf, x_shuf[perm.numpy()]))
    assert f_shuf >= 0.9, f"shuffle did not densify: {f_shuf:.3f}"
    assert f_reord <= 0.5 * f_shuf, (f_reord, f_shuf)
    assert f_reord <= 1.5 * f_sorted, (f_reord, f_sorted)


def test_row_reorder_config_round_trips_through_interop():
    ref_cfg = jcore.GPICConfig(row_reorder=True, affinity=jcore.AffinitySpec(
        kind="rbf", sigma=0.3, knn_k=10), use_pallas=False)
    fields = {f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(ref_cfg)}
    fields["a_dtype"] = jnp.dtype(ref_cfg.a_dtype).name
    fields["affinity"] = dataclasses.asdict(ref_cfg.affinity)
    cfg = config_from_reference(fields, n=500)
    assert cfg == GPICConfig(row_reorder=True,
                             affinity=AffinitySpec(kind="rbf", sigma=0.3, knn_k=10))
    assert config_from_reference(dict(fields, row_reorder=False)).row_reorder is False
