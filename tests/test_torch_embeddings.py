"""The streaming engine and the orthogonal / ensemble embeddings of the port
against the reference package, on the CPU.

The reference runs with ``use_pallas=False`` (its jnp oracles); the port on
CPU tensors (its kernels' plain versions). The two packages draw different
random numbers, so the reference's draws are passed in as numpy: the extra
power start columns (``random_start_vectors`` of the power key ``gpic``
splits off) and the kmeans++ start centroids (``kmeans_plus_plus_init`` of
the k-means key, on the reference's embedding).

Agreement:
  (a) inside the port, the streaming operator's D and sweep outputs are
      bitwise equal to the explicit operator's;
  (b) the orthogonal and ensemble loops from the reference's start block
      give the same per-column sweep counts and states within 1e-4 of
      max|V| (f32 sums and the Cholesky-QR in two orders). Exact sweep
      counts hold where every eps-crossing sits clear of f32 noise (smiley,
      gaussians); where a column creeps to its crossing (cassini's column 0
      over ~74 sweeps, three_circles' over ~138) the two packages cross a
      sweep apart, as the classic loop does (test_torch_pipeline.py (b)),
      so those sets are held to their states with the stopping rule off;
  (c) the whole streaming pipeline, every embedding mode, on four of the
      paper's 2-D sets at n = 480, gives the reference's labels exactly
      from the reference's k-means start.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import power as jpower
from repro_torch import GPICConfig, dataset_by_name
from repro_torch.core import power as tpower
from repro_torch.core.affinity import AffinitySpec
from repro_torch.core.gpic import _build_engine_operator
from repro_torch.core.kmeans import kmeans
from repro_torch.core.operators import explicit_operator, streaming_operator

N = 480
STATE_RTOL = 1e-4
SIGMAS = {"gaussians": 0.3, "cassini": 0.3, "smiley": 0.15, "three_circles": 0.3}
MODES = {"pic": 1, "orthogonal": 2, "ensemble": 1}


@pytest.mark.parametrize("kind", ["cosine", "cosine_shifted", "rbf"])
def test_streaming_operator_is_bitwise_the_explicit_one(kind):
    x, _, _ = dataset_by_name("cassini", 300, seed=0)
    inp = torch.from_numpy(x)
    if kind != "rbf":
        inp = inp / inp.norm(dim=1, keepdim=True)
    exp_op = explicit_operator(inp, kind=kind, sigma=0.3)
    str_op = streaming_operator(inp, kind=kind, sigma=0.3)
    assert torch.equal(str_op.degree, exp_op.degree)
    v = torch.from_numpy(np.random.default_rng(0).random((300, 3)).astype(np.float32))
    assert torch.equal(str_op.matmat(v), exp_op.matmat(v))


def _start_block(jop, r, seed=2):
    """The reference's (n, r) start block as numpy: the degree column, then
    its random columns."""
    return np.array(jcore.init_power_vectors(jax.random.key(seed), jop.degree, r))


def _loop_case(name, r):
    x, _, _ = dataset_by_name(name, N, seed=0)
    jop = jcore.streaming_operator(jnp.asarray(x), kind="rbf", sigma=SIGMAS[name],
                                   use_pallas=False)
    top = streaming_operator(torch.from_numpy(x), kind="rbf", sigma=SIGMAS[name])
    return jop, top, _start_block(jop, r)


def _assert_states_close(v_port, v_ref):
    v_ref = np.asarray(v_ref)
    assert v_port.shape == v_ref.shape
    assert np.max(np.abs(v_port.numpy() - v_ref)) <= STATE_RTOL * np.max(np.abs(v_ref))


@pytest.mark.parametrize("knobs", [dict(), dict(qr_every=3), dict(residual_tol=1e-3)],
                         ids=["qr_every_1", "qr_every_3", "residual_tol"])
@pytest.mark.parametrize("r", [2, 3])
def test_orthogonal_loop_from_reference_draws(r, knobs):
    jop, top, v0 = _loop_case("smiley", r)
    eps = 1e-5 / N
    v_ref, t_ref, done_ref, st_ref = jcore.batched_power_iteration(
        jop, jnp.asarray(v0), eps, 400, mode="orthogonal", return_status=True, **knobs)
    v, t_cols, done, status = tpower.batched_power_iteration(
        top, torch.from_numpy(v0), eps, 400, mode="orthogonal", return_status=True, **knobs)
    assert t_cols.tolist() == np.asarray(t_ref).tolist()
    assert done.tolist() == np.asarray(done_ref).tolist()
    assert status.tolist() == np.asarray(st_ref).tolist()
    _assert_states_close(v, v_ref)
    # column 0 is the classic trajectory, pinned: the 'pic' loop's column
    # (to f32 noise here: the CPU product of r columns sums in another order
    # than that of one)
    v_pic, t_pic, _ = tpower.batched_power_iteration(top, torch.from_numpy(v0[:, :1]), eps, 400)
    assert int(t_cols[0]) == int(t_pic[0])
    _assert_states_close(v[:, :1], v_pic.numpy())


@pytest.mark.parametrize("knobs", [dict(), dict(qr_every=3), dict(residual_tol=1e-3)],
                         ids=["qr_every_1", "qr_every_3", "residual_tol"])
def test_gram_runs_once_per_qr_sweep_and_residual_check(knobs):
    """The block algebra's Gram products: one per QR sweep, plus one per
    residual check (every QR sweep from column 0's convergence on)."""
    _, top, v0 = _loop_case("smiley", 2)
    calls = {"matmat": 0, "gram": 0}

    def counted(name, fn):
        def call(v):
            calls[name] += 1
            return fn(v)
        return call

    op = dataclasses.replace(top, matmat=counted("matmat", top.matmat),
                             gram=counted("gram", top.gram))
    _, t_cols, done = tpower.batched_power_iteration(
        op, torch.from_numpy(v0), 1e-5 / N, 400, mode="orthogonal", **knobs)
    sweeps = max(t_cols.tolist())
    qr_every = knobs.get("qr_every", 1)
    checks = sweeps - int(t_cols[0]) + 1 if "residual_tol" in knobs else 0
    assert calls == {"matmat": sweeps, "gram": sweeps // qr_every + checks}
    assert done.all() == ("residual_tol" in knobs)


@pytest.mark.parametrize("name", ["cassini", "three_circles"])
def test_orthogonal_loop_without_stopping(name):
    jop, top, v0 = _loop_case(name, 3)
    v_ref, t_ref, _ = jcore.batched_power_iteration(jop, jnp.asarray(v0), 0.0, 40,
                                                    mode="orthogonal")
    v, t_cols, _ = tpower.batched_power_iteration(top, torch.from_numpy(v0), 0.0, 40,
                                                  mode="orthogonal")
    assert t_cols.tolist() == np.asarray(t_ref).tolist() == [40, 40, 40]
    _assert_states_close(v, v_ref)


@pytest.mark.parametrize("snapshot_iters", [None, (1, 7, 30)], ids=["default", "custom"])
def test_ensemble_loop_from_reference_draws(snapshot_iters):
    jop, top, v0 = _loop_case("gaussians", 2)
    eps = 1e-5 / N
    snaps_ref, t_ref, done_ref, v_ref, _ = jcore.ensemble_power_iteration(
        jop, jnp.asarray(v0), eps, 400, snapshot_iters=snapshot_iters)
    snaps, t_cols, done, v, _ = tpower.ensemble_power_iteration(
        top, torch.from_numpy(v0), eps, 400, snapshot_iters=snapshot_iters)
    s = len(snapshot_iters or jpower.default_snapshot_iters(400))
    assert snaps.shape == (N, 2, s)
    assert t_cols.tolist() == np.asarray(t_ref).tolist()
    assert done.tolist() == np.asarray(done_ref).tolist()
    _assert_states_close(v, v_ref)
    _assert_states_close(snaps, snaps_ref)
    emb = tpower.ensemble_embedding(snaps)
    np.testing.assert_array_equal(emb.numpy(),
                                  np.asarray(snaps).reshape(N, 2 * s))   # column c*S + s
    _assert_states_close(emb, jpower.ensemble_embedding(snaps_ref))


def test_singular_block_passes_orthonormalize_unchanged():
    v = np.random.default_rng(3).random((64, 3)).astype(np.float32)
    v[:, 2] = v[:, 1]                          # two equal columns: G is singular
    out_ref = np.asarray(jcore.orthonormalize_block(jcore.as_operator(lambda z: z),
                                                    jnp.asarray(v)))
    np.testing.assert_array_equal(out_ref, v)
    out = tpower.orthonormalize_block(tpower.as_operator(lambda z: z), torch.from_numpy(v))
    np.testing.assert_array_equal(out.numpy(), v)


def test_singular_residual_reports_not_converged():
    v = np.random.default_rng(4).random((64, 2)).astype(np.float32)
    v[:, 1] = v[:, 0]
    op = tpower.as_operator(lambda z: z)
    rel = tpower.subspace_residual(op, torch.from_numpy(v), torch.from_numpy(v))
    assert float(rel) == float("inf")
    assert float(jcore.subspace_residual(jcore.as_operator(lambda z: z), jnp.asarray(v),
                                         jnp.asarray(v))) == float("inf")


@pytest.mark.parametrize("embedding", sorted(MODES))
@pytest.mark.parametrize("name", sorted(SIGMAS))
def test_streaming_pipeline_gives_the_reference_labels(name, embedding):
    """gpic(engine='streaming') in both packages, with the reference's
    random draws passed in: the same labels, and column 0's sweep count
    within one (a creeping eps-crossing, see (b)). A block column of the
    orthogonal mode keeps iterating after its first eps-crossing, which
    only its done flag records; the loop tests above hold those."""
    x, _, k = dataset_by_name(name, N, seed=0)
    r = MODES[embedding]
    ref_cfg = jcore.GPICConfig(engine="streaming", affinity_kind="rbf", sigma=SIGMAS[name],
                               max_iter=400, n_vectors=r, embedding=embedding,
                               use_pallas=False)
    key = jax.random.key(1)
    ref = jcore.run_gpic(jnp.asarray(x), k, ref_cfg, key=key)
    kkm, krand = jax.random.split(key)
    init = np.asarray(jcore.kmeans_plus_plus_init(
        kkm, jcore.standardize_columns(ref.embeddings), k))
    extra = np.array(jpower.random_start_vectors(krand, N, r))

    cfg = GPICConfig(engine="streaming", affinity_kind="rbf", sigma=SIGMAS[name],
                     max_iter=400, n_vectors=r, embedding=embedding)
    spec = AffinitySpec(kind="rbf", sigma=SIGMAS[name])
    op = _build_engine_operator(torch.from_numpy(x), spec, engine=cfg.engine)
    v0 = torch.cat([tpower.init_power_vectors(op.degree, 1), torch.from_numpy(extra)], dim=1)
    _v, t_cols, _done, emb, _status = tpower.run_power_embedding(
        op, v0, cfg.eps_scale / N, cfg.max_iter, embedding=embedding)
    labels, _ = kmeans(tpower.standardize_columns(emb), k, iters=cfg.kmeans_iters,
                       init=torch.from_numpy(init))
    assert abs(int(t_cols[0]) - int(ref.n_iter_cols[0])) <= 1
    assert emb.shape == np.asarray(ref.embeddings).shape
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref.labels))
