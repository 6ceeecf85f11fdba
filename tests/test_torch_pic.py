"""The port's paper-faithful PIC entry points and its matrix-free engine
against the reference package, on the CPU.

The same numpy inputs go through ``repro`` (its jnp oracles:
``use_pallas=False``, or the functions that have no Pallas kernel) and
``repro_torch`` with ``device="cpu"`` (the kernels' plain versions). Where
randomness enters, the reference's draws are passed in (k-means start
centroids, extra power columns), as in ``test_torch_pipeline.py``.

Agreement, as there: with the stopping rule off the embeddings agree to
max|dv| / max|v| <= 1e-4; at the default eps the sweep counts of column 0
differ by at most 1; k-means from the reference's kmeans++ centroids gives
identical labels; and the partitions agree (ARI 1.0). The serial numpy
baseline runs the same float64 numpy in both packages, so its iterate and
sweep count are equal bit for bit. The matrix-free engine takes the cosine
kinds only, so it runs on ``direction_clusters`` (three orthogonal
directions in m = 8), where the cosine labels mean something.

The last block runs the reference's property tests
(``tests/test_pic_properties.py``) on both packages' outputs for the same
inputs, at fixed draws.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one torch thread a process: the test run starts several processes at once,
# and torch using every core in each of them slows all of them down
torch.set_num_threads(1)

import repro.core as jcore
from repro.core import affinity as jaffinity
from repro.core import health as jhealth
from repro.kernels import ref as jref
from test_torch_pipeline import N, RBF_CASES, _plain_fields, direction_clusters

import repro_torch.core as tcore
from repro_torch import adjusted_rand_index, dataset_by_name, run_gpic
from repro_torch.interop import config_from_reference
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

RBF_IDS = [f"{d}-{k}" for d, k, _ in RBF_CASES]
KINDS = ["cosine", "cosine_shifted", "rbf"]
#: seeds of the direction clusters the matrix-free engine runs on
DIR_SEEDS = [0, 1]


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rel(a, b):
    """max|a - b| / max|b|."""
    a, b = _np(a), _np(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _normal(seed, shape, scale=1.0):
    """The reference tests' jax.random.normal draw, as numpy."""
    return np.asarray(jax.random.normal(jax.random.key(seed), shape)) * np.float32(scale)


# ---------------------------------------------------------------------------
# affinity_chunked and the matrix-free products
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,sigma", [(k, 0.7) for k in KINDS] + [("rbf", None)],
                         ids=KINDS + ["rbf-heuristic"])
def test_affinity_chunked_matches_reference(kind, sigma):
    """Row stripes of 33 (a ragged last stripe) against the reference's
    chunked build and the port's dense one."""
    x = _normal(3, (100, 4))
    want = jaffinity.affinity_chunked(jnp.asarray(x), kind, sigma=sigma, chunk=33)
    got = tcore.affinity_chunked(torch.from_numpy(x), kind, sigma=sigma, chunk=33)
    assert got.shape == (100, 100) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    dense = tcore.affinity_matrix(torch.from_numpy(x), kind, sigma=sigma)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-5)
    assert np.all(np.diag(got.numpy()) == 0.0)


@pytest.mark.parametrize("r", [None, 3], ids=["vector", "block_r3"])
@pytest.mark.parametrize("kind", ["cosine", "cosine_shifted"])
def test_matrix_free_product_matches_reference(kind, r):
    """The reference test's inputs (80 x 6, v uniform): the factored A v
    against the reference's and against the port's dense A v, within the
    reference test's atol 2e-4 / rtol 1e-4; an (n, r) block per column."""
    x = _normal(4, (80, 6))
    shape = (80,) if r is None else (80, r)
    v = np.asarray(jax.random.uniform(jax.random.key(5), shape))
    xn = np.asarray(jcore.row_normalize_features(jnp.asarray(x)))
    want = jaffinity.matmat_matrix_free(jnp.asarray(xn), jnp.asarray(v), kind)
    fn = tcore.matvec_matrix_free if r is None else tcore.matmat_matrix_free
    got = fn(torch.from_numpy(xn), torch.from_numpy(v), kind)
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-4)
    dense = tcore.affinity_matrix(torch.from_numpy(x), kind) @ torch.from_numpy(v)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("kind", ["cosine", "cosine_shifted"])
def test_matrix_free_degree_matches_reference(kind):
    x = _normal(6, (50, 3))
    xn = np.asarray(jcore.row_normalize_features(jnp.asarray(x)))
    want = jcore.degree_matrix_free(jnp.asarray(xn), kind)
    got = tcore.degree_matrix_free(torch.from_numpy(xn), kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-4)
    dense = torch.sum(tcore.affinity_matrix(torch.from_numpy(x), kind), dim=1)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("spec", [dict(kind="cosine_shifted", knn_k=5), dict(kind="rbf"),
                                  "rbf"], ids=["knn_spec", "rbf_spec", "rbf_kind"])
def test_matrix_free_refuses_what_the_reference_refuses(spec):
    """The same ValueError, word for word, for an unfactorable spec and for
    a kind the factorization does not cover."""
    xn = np.asarray(jcore.row_normalize_features(jnp.asarray(_normal(7, (20, 3)))))
    v = np.ones((20,), np.float32)
    ref_spec = jcore.AffinitySpec(**spec) if isinstance(spec, dict) else spec
    port_spec = tcore.AffinitySpec(**spec) if isinstance(spec, dict) else spec
    with pytest.raises(ValueError) as ref_err:
        jaffinity.matmat_matrix_free(jnp.asarray(xn), jnp.asarray(v), ref_spec)
    with pytest.raises(ValueError) as port_err:
        tcore.matmat_matrix_free(torch.from_numpy(xn), torch.from_numpy(v), port_spec)
    assert str(port_err.value) == str(ref_err.value)


# ---------------------------------------------------------------------------
# kernel 2's single-vector wrappers, k-means inertia, health utilities
# ---------------------------------------------------------------------------


@functools.cache
def _sweep_inputs():
    """A (300, 300) rbf A with a zero-degree row, its degrees, v (300,) and
    V (300, 3), as numpy (300 rows: ragged against the reference's 256
    tiles)."""
    x, _, _ = dataset_by_name("gaussians", 300, seed=0)
    a = np.array(jcore.affinity_matrix(jnp.asarray(x), "rbf", sigma=0.3))
    a[7] = 0.0
    d = a.sum(axis=1)
    rng = np.random.default_rng(0)
    v = rng.random(300).astype(np.float32)
    return a, d, v, rng.random((300, 3)).astype(np.float32)


SWEEP_CASES = {
    "matvec": (lambda a, v, vb, d: ops.degree_normalized_matvec(a, v, d),
               lambda a, v, vb, d: jref.degree_normalized_matvec_ref(a, v, d)),
    "matvec_plain": (lambda a, v, vb, d: tref.degree_normalized_matvec_ref(a, v, d),
                     lambda a, v, vb, d: jref.degree_normalized_matvec_ref(a, v, d)),
    "power_step": (lambda a, v, vb, d: ops.power_step(a, v, d),
                   lambda a, v, vb, d: jref.power_step_ref(a, v, d)),
    "power_step_plain": (lambda a, v, vb, d: tref.power_step_ref(a, v, d),
                         lambda a, v, vb, d: jref.power_step_ref(a, v, d)),
    "power_step_block": (
        lambda a, v, vb, d: ops.power_step(a, vb, d),
        lambda a, v, vb, d: jref.degree_normalized_matmat_ref(a, vb, d) / jnp.maximum(
            jnp.sum(jnp.abs(jref.degree_normalized_matmat_ref(a, vb, d)), axis=0), 1e-30)),
}


@pytest.mark.parametrize("case", list(SWEEP_CASES))
def test_power_step_wrappers_match_reference_oracles(case):
    """On CPU tensors the wrappers run their plain versions: the r = 1
    column of the sweep and the L1-normalized power step (per column for a
    block), against the reference's oracles; the zero-degree row stays an
    exact zero."""
    a, d, v, vb = _sweep_inputs()
    port, ref = SWEEP_CASES[case]
    got = port(torch.from_numpy(a), torch.from_numpy(v), torch.from_numpy(vb),
               torch.from_numpy(d))
    want = np.asarray(ref(jnp.asarray(a), jnp.asarray(v), jnp.asarray(vb), jnp.asarray(d)))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7 * np.abs(want).max())
    assert np.all(got.numpy()[7] == 0.0)


def test_matvec_is_column_zero_of_the_matmat():
    a, d, v, _ = _sweep_inputs()
    at, dt, vt = torch.from_numpy(a), torch.from_numpy(d), torch.from_numpy(v)
    assert torch.equal(ops.degree_normalized_matvec(at, vt, dt),
                       ops.degree_normalized_matmat(at, vt[:, None], dt)[:, 0])


def test_kmeans_objective_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((200, 3)).astype(np.float32)
    cents = rng.standard_normal((5, 3)).astype(np.float32)
    labels = rng.integers(0, 5, 200).astype(np.int32)
    want = jcore.kmeans_objective(jnp.asarray(x), jnp.asarray(labels), jnp.asarray(cents))
    got = tcore.kmeans_objective(torch.from_numpy(x), torch.from_numpy(labels),
                                 torch.from_numpy(cents))
    assert got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_empty_health_matches_reference():
    ref = jhealth.empty_health(3, 10)
    port = tcore.empty_health(3, 10, device="cpu")
    assert port.to_dict() == ref.to_dict()
    np.testing.assert_array_equal(port.components.numpy(), np.asarray(ref.components))
    assert port.col_status.dtype == port.components.dtype == torch.int32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tcore.empty_health(3, 10)


@pytest.mark.parametrize("ndim", [1, 2])
def test_degree_guard_matches_reference(ndim):
    """Zero, negative and NaN degrees mask their rows to an exact zero; the
    healthy rows divide as the reference does."""
    rng = np.random.default_rng(4)
    d = rng.random(8).astype(np.float32) + 0.5
    d[[1, 4, 6]] = [0.0, -2.0, np.nan]
    u = rng.standard_normal((8, 3) if ndim == 2 else (8,)).astype(np.float32)
    want = np.asarray(jcore.degree_guard(jnp.asarray(u), jnp.asarray(d)))
    got = tcore.degree_guard(torch.from_numpy(u), torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(got[[1, 4, 6]] == 0.0) and np.all(np.isfinite(got))


# ---------------------------------------------------------------------------
# pic_reference / pic_from_affinity, r = 1, on the rbf cases
# ---------------------------------------------------------------------------


def _pic_both(case, fn="pic_reference", **kw):
    """(x, y, k, reference result, port result) of one entry point on one
    case (A from the reference's affinity_matrix for pic_from_affinity).
    The port draws from a generator seeded as ``run_gpic`` seeds its own,
    the reference from the key its pipeline tests pass."""
    name, kind, sigma = case
    x, y, k = dataset_by_name(name, N, seed=0)
    if fn == "pic_reference":
        ref = jcore.pic_reference(jnp.asarray(x), k, key=jax.random.key(1), affinity_kind=kind,
                                  sigma=sigma, **kw)
        port = tcore.pic_reference(x, k, device="cpu", affinity_kind=kind, sigma=sigma,
                                   generator=torch.Generator().manual_seed(0), **kw)
    else:
        a = jcore.affinity_matrix(jnp.asarray(x), kind, sigma=sigma)
        ref = jcore.pic_from_affinity(a, k, key=jax.random.key(1), **kw)
        port = tcore.pic_from_affinity(np.asarray(a), k, device="cpu",
                                       generator=torch.Generator().manual_seed(0), **kw)
    return x, y, k, ref, port


@functools.cache
def _pic_default(case, fn):
    return _pic_both(case, fn, max_iter=400)


PIC_FNS = ["pic_reference", "pic_from_affinity"]


@pytest.mark.parametrize("fn", PIC_FNS)
@pytest.mark.parametrize("case", RBF_CASES, ids=RBF_IDS)
def test_pic_embeddings_agree_without_stopping(case, fn):
    _, _, _, ref, port = _pic_both(case, fn, eps=0.0, max_iter=20)
    assert int(ref.n_iter) == int(port.n_iter) == 20
    assert port.embedding.shape == (N,) and port.embeddings.shape == (N, 1)
    assert _rel(port.embedding, ref.embedding) <= 1e-4


@pytest.mark.parametrize("fn", PIC_FNS)
@pytest.mark.parametrize("case", RBF_CASES, ids=RBF_IDS)
def test_pic_sweep_counts_and_health_agree(case, fn):
    _, _, _, ref, port = _pic_default(case, fn)
    assert abs(int(ref.n_iter) - int(port.n_iter)) <= 1
    assert bool(port.converged)
    assert port.health.to_dict() == ref.health.to_dict()
    assert port.health.n_components.item() == -1
    assert abs(float(torch.sum(torch.abs(port.embedding))) - 1.0) < 1e-4


@pytest.mark.parametrize("case", RBF_CASES, ids=RBF_IDS)
def test_pic_kmeans_from_reference_init_gives_same_labels(case):
    _, _, k, ref, _ = _pic_default(case, "pic_reference")
    emb = jcore.standardize_columns(ref.embeddings)
    key = jax.random.key(5)
    init = jcore.kmeans_plus_plus_init(key, emb, k)
    labels_ref, _ = jcore.kmeans(key, emb, k, init=init, force_reference=True)
    labels, _ = tcore.kmeans(torch.from_numpy(np.asarray(emb)), k,
                             init=torch.from_numpy(np.asarray(init)))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(labels_ref))


@pytest.mark.parametrize("fn", PIC_FNS)
@pytest.mark.parametrize("case", RBF_CASES, ids=RBF_IDS)
def test_pic_partitions_agree(case, fn):
    _, _, _, ref, port = _pic_default(case, fn)
    assert adjusted_rand_index(np.asarray(ref.labels), port.labels.numpy()) == 1.0


@pytest.mark.parametrize("stopping", [False, True], ids=["no_stopping", "default_eps"])
def test_power_iterate_matches_reference(stopping):
    """The single-vector loop (the r = 1 slice of the engine) on the same
    W = D^-1 A and degree start: the iterate within 1e-4 of its max, and
    the sweep count within one."""
    from repro.core.pic import _power_iterate as ref_power_iterate

    from repro_torch.core.pic import _power_iterate
    a, d, _, _ = _sweep_inputs()
    w = np.where(d[:, None] > 0, a / np.where(d > 0, d, 1.0)[:, None], 0.0).astype(np.float32)
    v0 = (d / d.sum()).astype(np.float32)
    eps, max_iter = (1e-5 / len(d), 400) if stopping else (0.0, 20)
    v_ref, t_ref, done_ref = ref_power_iterate(lambda v: jnp.asarray(w) @ v, jnp.asarray(v0),
                                               eps, max_iter)
    wt = torch.from_numpy(w)
    v, t, done = _power_iterate(lambda vv: wt @ vv, torch.from_numpy(v0), eps, max_iter)
    assert v.shape == (len(d),) and bool(done) == bool(done_ref)
    assert abs(int(t) - int(t_ref)) <= (1 if stopping else 0)
    assert _rel(v, v_ref) <= 1e-4


def test_standardize_embedding_matches_reference():
    v = np.random.default_rng(5).random(77).astype(np.float32) * 1e-3 + 1.0 / 77
    want = np.asarray(jcore.pic.standardize_embedding(jnp.asarray(v)))
    got = tcore.standardize_embedding(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pic_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run there")
    x, _, k = dataset_by_name("gaussians", 40, seed=0)
    for call in (lambda: tcore.pic_reference(x, k),
                 lambda: tcore.pic_from_affinity(np.eye(40, dtype=np.float32), k),
                 lambda: tcore.pic_serial_numpy(x, k)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# ---------------------------------------------------------------------------
# pic_serial_numpy: the same float64 numpy in both packages
# ---------------------------------------------------------------------------

SERIAL_CASES = RBF_CASES + [("gaussians", "cosine_shifted", None), ("cassini", "rbf", None)]
SERIAL_IDS = RBF_IDS + ["gaussians-cosine_shifted", "cassini-rbf-heuristic"]


@functools.cache
def _serial_both(case):
    name, kind, sigma = case
    x, y, k = dataset_by_name(name, N, seed=0)
    kw = dict(affinity_kind=kind, sigma=sigma, max_iter=400, return_timings=True)
    return y, jcore.pic_serial_numpy(x, k, **kw), tcore.pic_serial_numpy(x, k, device="cpu",
                                                                         **kw)


@pytest.mark.parametrize("case", SERIAL_CASES, ids=SERIAL_IDS)
def test_serial_numpy_iterate_is_the_reference_bit_for_bit(case):
    _, (_, v_ref, t_ref), (labels, v, t) = _serial_both(case)
    assert v.dtype == np.float64 and labels.shape == (N,)
    np.testing.assert_array_equal(v, v_ref)
    assert t["n_iter"] == t_ref["n_iter"]
    assert set(t) == set(t_ref)


@pytest.mark.parametrize("case", RBF_CASES, ids=RBF_IDS)
def test_serial_numpy_partitions_agree(case):
    _, (labels_ref, _, _), (labels, _, _) = _serial_both(case)
    assert adjusted_rand_index(np.asarray(labels_ref), labels) == 1.0


def test_serial_numpy_matches_pic_from_affinity():
    """The paper's claim, within the port: the serial float64 loop and the
    f32 oracle path reach the same embedding (the reference test's
    tolerances)."""
    from repro_torch.data import gaussians
    x, _ = gaussians(160, seed=2)
    _, v_serial, _ = tcore.pic_serial_numpy(x, 4, affinity_kind="rbf", sigma=0.3, max_iter=100,
                                            return_timings=True, device="cpu")
    a = tcore.affinity_matrix(torch.from_numpy(x), "rbf", sigma=0.3)
    res = tcore.pic_from_affinity(a, 4, max_iter=100, device="cpu")
    np.testing.assert_allclose(v_serial, res.embedding.numpy(), atol=1e-5, rtol=1e-3)


# ---------------------------------------------------------------------------
# The matrix-free engine, on the direction clusters (cosine)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", DIR_SEEDS)
def test_gpic_matrix_free_embeddings_agree_without_stopping(seed):
    x, _, k = direction_clusters(N, seed)
    kw = dict(affinity_kind="cosine", eps=0.0, max_iter=20)
    ref = jcore.gpic_matrix_free(jnp.asarray(x), k, key=jax.random.key(1), use_pallas=False, **kw)
    port = tcore.gpic_matrix_free(torch.from_numpy(x), k, **kw)
    assert int(ref.n_iter) == int(port.n_iter) == 20
    assert _rel(port.embeddings, ref.embeddings) <= 1e-4
    assert port.health.to_dict() == ref.health.to_dict()


@functools.cache
def _matrix_free_run(seed, n_vectors):
    """One default-eps run_gpic(engine='matrix_free') in both packages, the
    port's config made from the reference's."""
    x, y, k = direction_clusters(N, seed)
    emb = "pic" if n_vectors == 1 else "orthogonal"
    ref_cfg = jcore.GPICConfig(engine="matrix_free", affinity_kind="cosine", max_iter=400,
                               n_vectors=n_vectors, embedding=emb, use_pallas=False)
    ref = jcore.run_gpic(jnp.asarray(x), k, ref_cfg, key=jax.random.key(1))
    port = run_gpic(x, k, config_from_reference(_plain_fields(ref_cfg)), device="cpu")
    return y, k, ref, port


@pytest.mark.parametrize("n_vectors", [1, 2], ids=["pic", "orthogonal_r2"])
@pytest.mark.parametrize("seed", DIR_SEEDS)
def test_matrix_free_run_gpic_agrees(seed, n_vectors):
    """Column 0's sweep count within one, the health report, and the same
    partition in both packages, the true one. A block column's count and
    its stall latch ride on f32 noise past its first crossing (ROADMAP
    queue 3, "Eps-crossings creep"), so at r = 2 the report is held for
    column 0 and the rows."""
    y, _, ref, port = _matrix_free_run(seed, n_vectors)
    assert abs(int(ref.n_iter_cols[0]) - int(port.n_iter_cols[0])) <= 1
    assert port.embeddings.shape == (N, n_vectors) and bool(port.converged)
    want, got = ref.health.to_dict(), port.health.to_dict()
    if n_vectors > 1:
        for h in (want, got):
            h["col_status"] = h["col_status"][:1]
            del h["status"], h["bad_columns"]
    assert got == want
    assert adjusted_rand_index(np.asarray(ref.labels), port.labels.numpy()) == 1.0
    assert adjusted_rand_index(y, port.labels.numpy()) == 1.0


@pytest.mark.parametrize("seed", DIR_SEEDS)
def test_matrix_free_kmeans_from_reference_init_gives_same_labels(seed):
    _, k, ref, _ = _matrix_free_run(seed, 1)
    emb = jcore.standardize_columns(ref.embeddings)
    key = jax.random.key(5)
    init = jcore.kmeans_plus_plus_init(key, emb, k)
    labels_ref, _ = jcore.kmeans(key, emb, k, init=init, force_reference=True)
    labels, _ = tcore.kmeans(torch.from_numpy(np.asarray(emb)), k,
                             init=torch.from_numpy(np.asarray(init)))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(labels_ref))


@pytest.mark.parametrize("stopping", [False, True], ids=["no_stopping", "default_eps"])
def test_matrix_free_orthogonal_from_reference_draws(stopping):
    """r = 2, orthogonal: the reference's random start column, passed in as
    numpy, through both matrix-free operators: each column within 1e-4 of
    its max after 20 sweeps with the stopping rule off; at the default eps
    column 0 within one sweep and every column done."""
    x, _, _ = direction_clusters(N, 0)
    xn = jcore.row_normalize_features(jnp.asarray(x))
    jop = jcore.matrix_free_operator(xn, kind="cosine", use_pallas=False)
    v0 = np.array(jcore.init_power_vectors(jax.random.key(2), jop.degree, 2))
    eps, max_iter = (1e-5 / N, 400) if stopping else (0.0, 20)
    v_ref, t_ref, done_ref = jcore.batched_power_iteration(
        jop, jnp.asarray(v0), eps, max_iter, mode="orthogonal")
    top = tcore.matrix_free_operator(torch.from_numpy(np.asarray(xn)), kind="cosine")
    np.testing.assert_allclose(top.degree.numpy(), np.asarray(jop.degree), rtol=1e-5)
    v, t_cols, done = tcore.batched_power_iteration(top, torch.from_numpy(v0), eps, max_iter,
                                                    mode="orthogonal")
    np.testing.assert_array_equal(done.numpy(), np.asarray(done_ref))
    if stopping:
        assert done.all()
        assert abs(int(t_cols[0]) - int(t_ref[0])) <= 1
    else:
        assert t_cols.tolist() == np.asarray(t_ref).tolist() == [20, 20]
        for j in range(2):
            assert _rel(v[:, j], np.asarray(v_ref)[:, j]) <= 1e-4


def test_matrix_free_operator_binds_the_gram_kernel():
    xn = torch.nn.functional.normalize(torch.from_numpy(_normal(8, (30, 4))), dim=1)
    op = tcore.matrix_free_operator(xn)
    assert op.gram is ops.gram and op.matmat_t is None
    v = torch.rand((30, 2), generator=torch.Generator().manual_seed(0))
    want = tcore.matmat_matrix_free(xn, v) / torch.clamp_min(op.degree, 1e-30)[:, None]
    assert torch.equal(op.matmat(v), want)


# ---------------------------------------------------------------------------
# The reference's properties (tests/test_pic_properties.py) on both packages
# ---------------------------------------------------------------------------


def _points(n, m, seed):
    """The property tests' features: jax normal draws times 2, as numpy."""
    return _normal(seed, (n, m), 2.0)


#: (n, m, seed): two draws of the property's range and the reference's own
#: failing draw (an isolated point at m = 1)
STOCHASTIC_CASES = [(37, 3, 4), (120, 8, 61), (8, 1, 23)]


@pytest.mark.parametrize("n,m,seed", STOCHASTIC_CASES,
                         ids=[f"n{n}-m{m}-s{s}" for n, m, s in STOCHASTIC_CASES])
def test_w_is_row_stochastic_in_both(n, m, seed):
    """W = D^-1 A has unit row sums. Where the reference's W does not (the
    draw n=8, m=1, seed=23: a point alone on its side of the origin has no
    cosine_shifted neighbor, a zero row), the port's W is the same W: the
    packages agree, and each row that fails, fails in both."""
    x = _points(n, m, seed)
    a_ref = jcore.affinity_matrix(jnp.asarray(x), "cosine_shifted")
    w_ref = np.asarray(a_ref / jnp.maximum(jnp.sum(a_ref, axis=1), 1e-30)[:, None])
    a = tcore.affinity_matrix(torch.from_numpy(x), "cosine_shifted")
    w = (a / torch.clamp_min(torch.sum(a, dim=1), 1e-30)[:, None]).numpy()
    np.testing.assert_allclose(w, w_ref, atol=1e-6)
    ok_ref = np.abs(w_ref.sum(axis=1) - 1.0) <= 1e-4
    ok = np.abs(w.sum(axis=1) - 1.0) <= 1e-4
    np.testing.assert_array_equal(ok, ok_ref)
    if (n, m, seed) == (8, 1, 23):
        assert not ok.all() and np.all(w[~ok] == 0.0)
    else:
        assert ok.all()


@pytest.mark.parametrize("n,seed", [(64, 0), (64, 11)])
def test_embedding_l1_is_one_in_both(n, seed):
    x = _points(n, 2, seed)
    ref = jcore.gpic(jnp.asarray(x), 2, key=jax.random.key(0), affinity_kind="cosine_shifted",
                     max_iter=7, use_pallas=False)
    port = tcore.gpic(torch.from_numpy(x), 2, affinity_kind="cosine_shifted", max_iter=7)
    assert abs(float(torch.sum(torch.abs(port.embedding))) - 1.0) < 1e-4
    assert _rel(port.embedding, ref.embedding) <= 1e-4


@pytest.mark.parametrize("n,m,seed", [(8, 1, 0), (150, 8, 98)])
def test_matrix_free_equals_explicit_matvec_in_both(n, m, seed):
    x = _points(n, m, seed)
    v = np.asarray(jax.random.uniform(jax.random.key(seed + 1), (n,)))
    xn = torch.nn.functional.normalize(torch.from_numpy(x), dim=1, eps=1e-12)
    got = tcore.matvec_matrix_free(xn, torch.from_numpy(v), "cosine_shifted").numpy()
    dense = (tcore.affinity_matrix(torch.from_numpy(x), "cosine_shifted")
             @ torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(dense, got, atol=5e-4, rtol=1e-3)
    want = jaffinity.matvec_matrix_free(jcore.row_normalize_features(jnp.asarray(x)),
                                        jnp.asarray(v), "cosine_shifted")
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("n,seed", [(64, 0), (64, 7)])
def test_matrix_free_labels_in_range_in_both(n, seed):
    x = _points(n, 2, seed)
    ref = jcore.gpic_matrix_free(jnp.asarray(x), 3, key=jax.random.key(1), max_iter=10,
                                 use_pallas=False)
    port = tcore.gpic_matrix_free(torch.from_numpy(x), 3, max_iter=10,
                                  generator=torch.Generator().manual_seed(1))
    for labels in (np.asarray(ref.labels), port.labels.numpy()):
        assert labels.shape == (n,) and labels.min() >= 0 and labels.max() < 3
    assert abs(int(port.n_iter) - int(ref.n_iter)) <= 1


@pytest.mark.parametrize("n,k,seed", [(64, 3, 0), (64, 3, 17)])
def test_kmeans_centroids_finite_and_labels_valid_in_both(n, k, seed):
    x = _points(n, 3, seed)
    labels_ref, cents_ref = jcore.kmeans(jax.random.key(seed), jnp.asarray(x), k, iters=10,
                                         force_reference=True)
    labels, cents = tcore.kmeans(torch.from_numpy(x), k, iters=10,
                                 generator=torch.Generator().manual_seed(seed))
    for c, lab in ((np.asarray(cents_ref), np.asarray(labels_ref)),
                   (cents.numpy(), labels.numpy())):
        assert np.isfinite(c).all() and int(lab.max()) < k
    # from the reference's start the two give the same partition
    init = jcore.kmeans_plus_plus_init(jax.random.key(seed), jnp.asarray(x), k)
    labels_ref, _ = jcore.kmeans(jax.random.key(seed), jnp.asarray(x), k, iters=10,
                                 init=init, force_reference=True)
    labels, _ = tcore.kmeans(torch.from_numpy(x), k, iters=10,
                             init=torch.from_numpy(np.asarray(init)))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(labels_ref))


@pytest.mark.parametrize("n,seed", [(64, 0), (64, 25)])
def test_degree_positive_in_both(n, seed):
    x = _points(n, 2, seed)
    xn = jcore.row_normalize_features(jnp.asarray(x))
    want = np.asarray(jcore.degree_matrix_free(xn, "cosine_shifted"))
    got = tcore.degree_matrix_free(torch.from_numpy(np.asarray(xn)), "cosine_shifted").numpy()
    assert got.min() > 0.0 and want.min() > 0.0
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("n,r,seed", [(64, 2, 0), (128, 8, 99)])
def test_qr_step_leaves_block_orthonormal_in_both(n, r, seed):
    v = np.asarray(jax.random.uniform(jax.random.key(seed), (n, r))) + np.float32(0.05)
    v = v / np.sum(np.abs(v), axis=0, keepdims=True)
    ref = np.asarray(jcore.orthonormalize_block(jcore.as_operator(lambda z: z), jnp.asarray(v)))
    out = tcore.orthonormalize_block(tcore.as_operator(lambda z: z), torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(out[:, 0], v[:, 0])
    q = np.concatenate([out[:, :1] / np.linalg.norm(out[:, 0]), out[:, 1:]], axis=1)
    np.testing.assert_allclose(q.T @ q, np.eye(r), atol=1e-5)
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("n,seed", [(64, 0), (64, 50)])
def test_orthogonal_r1_is_bitwise_classic_in_both(n, seed):
    x = torch.from_numpy(_points(n, 2, seed))
    kw = dict(affinity_kind="cosine_shifted", max_iter=30)
    rp = tcore.gpic(x, 2, embedding="pic", generator=torch.Generator().manual_seed(0), **kw)
    ro = tcore.gpic(x, 2, embedding="orthogonal", generator=torch.Generator().manual_seed(0),
                    **kw)
    assert torch.equal(rp.embeddings, ro.embeddings)
    assert int(rp.n_iter) == int(ro.n_iter) and bool(rp.converged) == bool(ro.converged)
    ref = jcore.gpic(jnp.asarray(x.numpy()), 2, key=jax.random.key(0), embedding="orthogonal",
                     use_pallas=False, **kw)
    assert abs(int(ref.n_iter) - int(ro.n_iter)) <= 1


@pytest.mark.parametrize("n,seed", [(64, 0), (64, 30)])
def test_orthogonal_pins_column0_to_classic_trajectory_in_both(n, seed):
    x = torch.from_numpy(_points(n, 2, seed))
    kw = dict(affinity_kind="cosine_shifted", max_iter=40, n_vectors=4)
    rp = tcore.gpic(x, 3, embedding="pic", generator=torch.Generator().manual_seed(1), **kw)
    ro = tcore.gpic(x, 3, embedding="orthogonal", generator=torch.Generator().manual_seed(1),
                    **kw)
    assert torch.equal(rp.embedding, ro.embedding)
    assert int(rp.n_iter) == int(ro.n_iter)
    ref = jcore.gpic(jnp.asarray(x.numpy()), 3, key=jax.random.key(1), embedding="orthogonal",
                     use_pallas=False, **kw)
    assert abs(int(ref.n_iter) - int(ro.n_iter)) <= 1


@pytest.mark.parametrize("n,seed,scale", [(64, 0, 0.1), (64, 30, 10.0)])
def test_cosine_affinity_scale_invariant_in_both(n, seed, scale):
    x = _points(n, 2, seed)
    s = np.float32(scale)
    a1 = tcore.affinity_matrix(torch.from_numpy(x), "cosine_shifted").numpy()
    a2 = tcore.affinity_matrix(torch.from_numpy(x * s), "cosine_shifted").numpy()
    np.testing.assert_allclose(a1, a2, atol=1e-4)
    ref = np.asarray(jcore.affinity_matrix(jnp.asarray(x * s), "cosine_shifted"))
    np.testing.assert_allclose(a2, ref, atol=1e-6)


@pytest.mark.parametrize("n,seed", [(64, 0), (64, 30)])
def test_permutation_equivariance_of_embedding_in_both(n, seed):
    x = _points(n, 2, seed)
    perm = np.random.default_rng(seed).permutation(n)
    a1 = tcore.affinity_matrix(torch.from_numpy(x), "cosine_shifted")
    a2 = tcore.affinity_matrix(torch.from_numpy(x[perm]), "cosine_shifted")
    r1 = tcore.pic_from_affinity(a1, 2, max_iter=6, device="cpu")
    r2 = tcore.pic_from_affinity(a2, 2, max_iter=6, device="cpu")
    np.testing.assert_allclose(r1.embedding.numpy()[perm], r2.embedding.numpy(), atol=1e-5)
    ref = jcore.pic_from_affinity(jnp.asarray(a2.numpy()), 2, key=jax.random.key(0), max_iter=6)
    np.testing.assert_allclose(r2.embedding.numpy(), np.asarray(ref.embedding), atol=1e-5)
