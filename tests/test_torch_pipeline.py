"""The port's main path against the reference package, on the CPU.

The same numpy features go through ``repro.core.run_gpic`` (with
``use_pallas=False``: the jnp oracles) and ``repro_torch.run_gpic(...,
device="cpu")`` (the kernels' plain versions), with the port's config made
from the reference config's fields by ``repro_torch.interop``. The two
packages draw different random numbers, so where randomness enters (the
k-means seeds, extra power columns) the reference's draws are passed in.

Agreement, at n = 400 on the paper's 2-D datasets:
  (a) with the stopping rule off (eps_scale=0, 20 sweeps) the embeddings
      agree to max|dv| / max|v| <= 1e-4 (f32 sums in two orders);
  (b) at the default eps the per-column sweep counts differ by at most 1
      (an eps-crossing can move by one sweep on f32 noise);
  (c) k-means from the reference's kmeans++ centroids gives identical
      labels on the same embedding;
  (d) on the rbf cases, ``run_gpic`` gives the same partition (ARI 1.0
      between packages).
"""
from __future__ import annotations

import dataclasses
import functools
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one torch thread a process: the test run starts several processes at once,
# and torch using every core in each of them slows all of them down
torch.set_num_threads(1)

import repro.core as jcore
from repro.data import dataset_by_name as ref_dataset_by_name
from repro_torch import (AffinitySpec, GPICConfig, adjusted_rand_index, dataset_by_name,
                         run_gpic)
from repro_torch.core import health as thealth
from repro_torch.core.kmeans import kmeans
from repro_torch.core.operators import explicit_operator
from repro_torch.core.power import batched_power_iteration
from repro_torch.interop import config_from_reference, result_to_numpy

N = 400
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (dataset, affinity kind, sigma): rbf at the bandwidths of
#: examples/quickstart.py, and the default cosine_shifted spec. On these
#: 2-D sets cosine_shifted leaves an embedding spread of ~1e-8 (f32
#: noise), so its partition is compared nowhere; everything else is.
RBF_CASES = [("gaussians", "rbf", 0.3), ("cassini", "rbf", 0.3), ("smiley", "rbf", 0.15)]
CASES = RBF_CASES + [("gaussians", "cosine_shifted", 1.0)]
IDS = [f"{d}-{k}" for d, k, _ in CASES]


def direction_clusters(n: int, seed: int, *, m: int = 8, noise: float = 0.02):
    """(x, y, k): three clusters of n/2, 3n/10 and the rest of the points
    along three orthogonal directions in m = 8 (disjoint pairs of
    coordinates), at magnitudes drawn from [0.5, 2], plus |noise| in every
    coordinate: nonnegative features that the cosine affinity separates,
    for the matrix-free engine, which takes the cosine kinds only (the 2-D
    sets give it no partition to hold)."""
    rng = np.random.default_rng(seed)
    sizes = [n // 2, 3 * n // 10]
    y = np.repeat(np.arange(3), sizes + [n - sum(sizes)]).astype(np.int32)
    dirs = np.zeros((3, m))
    for c in range(3):
        dirs[c, 2 * c:2 * c + 2] = np.sqrt(0.5)
    x = dirs[y] * rng.uniform(0.5, 2.0, (n, 1)) + noise * np.abs(rng.standard_normal((n, m)))
    return x.astype(np.float32), y, 3


def _plain_fields(cfg) -> dict:
    """A reference GPICConfig as plain values (dtype as a string)."""
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    out["a_dtype"] = jnp.dtype(cfg.a_dtype).name
    if out["affinity"] is not None:
        out["affinity"] = dataclasses.asdict(out["affinity"])
    return out


def _both(case, **cfg_kw):
    """(x, y, k, reference result as numpy, port result as numpy)."""
    name, kind, sigma = case
    x, y, k = dataset_by_name(name, N, seed=0)
    xr, yr, _ = ref_dataset_by_name(name, N, seed=0)
    np.testing.assert_array_equal(x, xr)        # the port's copy of the data
    np.testing.assert_array_equal(y, yr)
    ref_cfg = jcore.GPICConfig(**{"affinity_kind": kind, "sigma": sigma, "max_iter": 400,
                                  "use_pallas": False, **cfg_kw})
    ref = jcore.run_gpic(jnp.asarray(x), k, ref_cfg, key=jax.random.key(1))
    port = run_gpic(x, k, config_from_reference(_plain_fields(ref_cfg)), device="cpu")
    ref_np = {"labels": np.asarray(ref.labels), "embeddings": np.asarray(ref.embeddings),
              "n_iter_cols": np.asarray(ref.n_iter_cols), "health": ref.health.to_dict()}
    return x, y, k, ref_np, result_to_numpy(port), port


@functools.cache
def _default_run(case):
    """One default-eps run of a case in both packages (cached: the
    sweep-count, k-means, partition and health tests all read it)."""
    return _both(case)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_embeddings_agree_without_stopping(case):
    _, _, _, ref, port, _ = _both(case, eps_scale=0.0, max_iter=20)
    assert list(ref["n_iter_cols"]) == list(port["n_iter_cols"]) == [20]
    v_ref, v_port = ref["embeddings"], port["embeddings"]
    assert v_port.shape == v_ref.shape == (N, 1)
    assert np.max(np.abs(v_port - v_ref)) / np.max(np.abs(v_ref)) <= 1e-4


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sweep_counts_agree(case):
    _, _, _, ref, port, _ = _default_run(case)
    assert np.max(np.abs(ref["n_iter_cols"] - port["n_iter_cols"])) <= 1
    assert port["converged_cols"].all()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kmeans_from_reference_init_gives_same_labels(case):
    _, _, k, ref, _, _ = _default_run(case)
    emb = jcore.standardize_columns(jnp.asarray(ref["embeddings"]))
    key = jax.random.key(5)
    init = jcore.kmeans_plus_plus_init(key, emb, k)
    labels_ref, cents_ref = jcore.kmeans(key, emb, k, init=init, force_reference=True)
    labels, cents = kmeans(torch.from_numpy(np.asarray(emb)), k,
                           init=torch.from_numpy(np.asarray(init)))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(labels_ref))
    np.testing.assert_allclose(cents.numpy(), np.asarray(cents_ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", RBF_CASES, ids=IDS[:len(RBF_CASES)])
def test_run_gpic_partitions_agree(case):
    _, _, _, ref, port, _ = _default_run(case)
    assert adjusted_rand_index(ref["labels"], port["labels"]) == 1.0
    assert port["labels"].dtype == np.int32 and port["labels"][0] == 0


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_health_reports_agree(case):
    _, _, _, ref, _, port = _default_run(case)
    assert port.health.to_dict() == ref["health"]


@pytest.mark.parametrize("stopping", [False, True], ids=["no_stopping", "default_eps"])
def test_power_columns_from_reference_draws(stopping):
    """n_vectors=3: the reference's random start columns, passed in as
    numpy, give the same per-column trajectories in the port: the same
    states after 20 sweeps with the stopping rule off, and sweep counts
    within one of each other at the default eps."""
    x, _, _ = dataset_by_name("cassini", N, seed=0)
    jop = jcore.explicit_operator(jnp.asarray(x), kind="rbf", sigma=0.3, use_pallas=False)
    v0 = np.array(jcore.init_power_vectors(jax.random.key(2), jop.degree, 3))
    eps, max_iter = (1e-5 / N, 400) if stopping else (0.0, 20)
    v_ref, t_ref, done_ref = jcore.batched_power_iteration(jop, jnp.asarray(v0), eps, max_iter)
    top = explicit_operator(torch.from_numpy(x), kind="rbf", sigma=0.3)
    v, t_cols, done = batched_power_iteration(top, torch.from_numpy(v0), eps, max_iter)
    np.testing.assert_array_equal(done.numpy(), np.asarray(done_ref))
    if stopping:
        assert done.all()
        assert np.max(np.abs(t_cols.numpy() - np.asarray(t_ref))) <= 1
    else:
        assert t_cols.tolist() == np.asarray(t_ref).tolist() == [20, 20, 20]
        v_ref = np.asarray(v_ref)
        assert np.max(np.abs(v.numpy() - v_ref)) / np.max(np.abs(v_ref)) <= 1e-4


def _cycle_operator(n):
    """W = a directed n-cycle: the iterate rotates forever (a periodic
    trajectory whose acceleration statistic never improves)."""
    return np.roll(np.eye(n, dtype=np.float32), 1, axis=1)


@pytest.mark.parametrize("case", ["zero_and_nan_columns", "periodic"])
def test_power_loop_health_latches_match_reference(case):
    if case == "periodic":
        w = _cycle_operator(3)
        v0 = np.array([[0.5], [0.3], [0.2]], np.float32)
        max_iter = 30
    else:
        x, _, _ = dataset_by_name("gaussians", 120, seed=0)
        jop = jcore.explicit_operator(jnp.asarray(x), kind="rbf", sigma=0.3,
                                      use_pallas=False)
        w = np.asarray(jop.matmat(jnp.eye(120, dtype=jnp.float32)))  # W = D^-1 A
        v0 = np.stack([np.full(120, 1 / 120), np.zeros(120),
                       np.full(120, np.nan)], axis=1).astype(np.float32)
        max_iter = 400
    v_ref, t_ref, done_ref, st_ref = jcore.batched_power_iteration(
        lambda v: jnp.asarray(w) @ v, jnp.asarray(v0), 1e-5 / len(v0), max_iter,
        return_status=True)
    wt = torch.from_numpy(w)
    v, t_cols, done, status = batched_power_iteration(
        lambda vv: wt @ vv, torch.from_numpy(v0),
        1e-5 / len(v0), max_iter, return_status=True)
    np.testing.assert_array_equal(status.numpy(), np.asarray(st_ref))
    np.testing.assert_array_equal(done.numpy(), np.asarray(done_ref))
    np.testing.assert_array_equal(t_cols.numpy(), np.asarray(t_ref))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-4, atol=1e-7)
    if case == "periodic":
        assert status.tolist() == [thealth.COL_STALLED | thealth.COL_MAXITER]
    else:
        assert status.tolist()[1:] == [thealth.COL_ZERO, thealth.COL_NONFINITE]


def _bad_input(case):
    x, _, _ = dataset_by_name("gaussians", 60, seed=0)
    if case == "nonfinite":
        x = x.copy()
        x[3, 1] = np.nan
        return x, 4
    if case == "identical":
        return np.ones((20, 2), np.float32), 2
    if case == "n_below_k":
        return x[:3], 4
    return x[:, 0], 2                                  # one-dimensional


@pytest.mark.parametrize("case", ["nonfinite", "identical", "n_below_k", "not_a_matrix"])
def test_front_door_raises_like_the_reference(case):
    x, k = _bad_input(case)
    with pytest.raises(jcore.GPICError) as ref_err:
        jcore.run_gpic(jnp.asarray(x), k, use_pallas=False)
    with pytest.raises(thealth.GPICError) as port_err:
        run_gpic(x, k, device="cpu")
    assert type(port_err.value).__name__ == type(ref_err.value).__name__


def test_sanitize_zero_fills_and_notes_like_the_reference():
    x, _ = _bad_input("nonfinite")
    ref = jcore.run_gpic(jnp.asarray(x), 4, affinity_kind="rbf", sigma=0.3,
                         sanitize=True, use_pallas=False)
    port = run_gpic(x, 4, GPICConfig(affinity_kind="rbf", sigma=0.3, sanitize=True),
                    device="cpu")
    assert port.health.notes == ref.health.notes == ("sanitized:1_nonfinite_features",)
    assert port.health.to_dict()["status"] == "degraded"


def test_empty_graph_raises_like_the_reference():
    x = np.arange(40, dtype=np.float32).reshape(20, 2) * 10.0
    with pytest.raises(jcore.DegenerateGraphError):
        jcore.run_gpic(jnp.asarray(x), 2, affinity_kind="rbf", sigma=0.01,
                       use_pallas=False)
    with pytest.raises(thealth.DegenerateGraphError):
        run_gpic(x, 2, GPICConfig(affinity_kind="rbf", sigma=0.01), device="cpu")


def test_run_gpic_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: run_gpic() runs there")
    x, _, k = dataset_by_name("gaussians", 40, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_gpic(x, k)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_gpic(x, k, device="cuda")


def _port_override(override):
    """A reference override as the port's GPICConfig takes it (a spec given
    as a dict of fields is built here, where its constructor may raise)."""
    out = dict(override)
    if "affinity" in out:
        spec = override["affinity"]
        out["affinity"] = AffinitySpec(**(spec if isinstance(spec, dict)
                                          else dataclasses.asdict(spec)))
    if "a_dtype" in out:
        out["a_dtype"] = torch.bfloat16
    return out


def _ref_override(override):
    """The override as the reference's GPICConfig takes it."""
    out = dict(override)
    if isinstance(out.get("affinity"), dict):
        out["affinity"] = jcore.AffinitySpec(**out["affinity"])
    return out


@pytest.mark.parametrize("override,names", [
    (dict(affinity=dict(kind="rbf", bandwidth="adaptive", scale_k=65)), "K > 64"),
    (dict(affinity=dict(kind="rbf", sigma=0.3, knn_k=65), block_sparse=False), "K > 64"),
    (dict(tile=128), "item 1"),
    (dict(n_vectors=33), "kernel 2 follow-up"),
], ids=["scale_k_past_kernel_limit",
        "knn_k_past_kernel_limit", "tile", "n_vectors_past_kernel_limit"])
def test_unported_settings_raise_not_implemented(override, names):
    """Each names its ROADMAP entry: among them neighbor ranks past the row
    top-k kernel's 64 on a route that runs it."""
    ref_cfg = jcore.GPICConfig(**_ref_override(override))
    with pytest.raises(NotImplementedError, match="ROADMAP") as map_err:
        config_from_reference(_plain_fields(ref_cfg))
    x, _, k = dataset_by_name("gaussians", 100, seed=0)
    with pytest.raises(NotImplementedError, match="ROADMAP") as port_err:
        run_gpic(x, k, GPICConfig(**_port_override(override)), device="cpu")
    assert str(port_err.value) == str(map_err.value)
    assert names in str(port_err.value)


@pytest.mark.parametrize("override", [
    dict(engine="streaming"), dict(embedding="orthogonal", n_vectors=2),
    dict(embedding="ensemble"), dict(engine="matrix_free", affinity_kind="cosine"),
    dict(a_dtype=jnp.bfloat16),
], ids=["streaming", "orthogonal", "ensemble", "matrix_free", "bf16"])
def test_settings_this_port_routes_run(override):
    """Settings an earlier slice refused: the port accepts the reference's
    config and runs it on the CPU. The matrix-free engine takes a cosine
    kind, on the direction clusters; bf16 A storage (queue 1 item 13) runs
    on the explicit engine."""
    override = {"affinity_kind": "rbf", "sigma": 0.3, **override}
    ref_cfg = jcore.GPICConfig(**override)
    cfg = config_from_reference(_plain_fields(ref_cfg))
    assert cfg == GPICConfig(**_port_override(override))
    if cfg.engine == "matrix_free":
        x, y, k = direction_clusters(120, 0)
    else:
        x, y, k = dataset_by_name("gaussians", 120, seed=0)
    res = run_gpic(x, k, cfg, device="cpu")
    assert res.labels.shape == (120,) and res.embedding_mode == cfg.embedding
    assert adjusted_rand_index(y, res.labels.numpy()) == 1.0


@pytest.mark.parametrize("override", [
    dict(qr_every=0), dict(qr_every=3),
    dict(snapshot_iters=(5, 10)), dict(embedding="orthogonal", residual_tol=1e-3),
    dict(embedding="orthogonal", n_vectors=2, residual_tol=0.0),
    dict(embedding="pic", residual_tol=1e-3, n_vectors=2),
    dict(engine="streaming", a_dtype=jnp.bfloat16),
    dict(affinity=dict(kind="rbf", sigma=0.3, knn_k=40), block_sparse=False),
    dict(affinity=dict(kind="rbf", sigma=0.3, knn_k=0)),
    dict(affinity=dict(kind="rbf", bandwidth="adaptive", scale_k=40)),
    dict(affinity=dict(kind="rbf", bandwidth="adaptive", scale_k=0)),
    dict(affinity=dict(kind="cosine", bandwidth="adaptive")),
    dict(engine="matrix_free", affinity=dict(kind="cosine_shifted", knn_k=5)),
    dict(fold_shift=True), dict(engine="matrix_free", affinity_kind="cosine", fold_shift=True),
    dict(inject_ring_fault=("ring_nan", 0)),
    dict(engine="streaming", inject_ring_fault=("ring_nan", 1)),
], ids=["qr_every_0", "qr_every_outside_orthogonal", "snapshot_iters_outside_ensemble",
        "residual_tol_with_r1", "residual_tol_0", "residual_tol_outside_orthogonal",
        "streaming_bf16", "knn_k_not_below_n", "knn_k_0", "scale_k_not_below_n", "scale_k_0",
        "adaptive_cosine", "matrix_free_knn", "fold_shift_without_mesh",
        "fold_shift_on_matrix_free", "ring_fault_without_mesh",
        "ring_fault_streaming_without_mesh"])
def test_front_door_value_errors_match_the_reference(override):
    """The same class and message in both packages. The spec's own checks
    run where it is built; the neighbor ranks against n = 40 at the front
    door, before the feature checks, and through ``config_from_reference``
    when it is given n."""
    x, _, k = dataset_by_name("gaussians", 40, seed=0)
    with pytest.raises(ValueError) as ref_err:
        jcore.run_gpic(jnp.asarray(x), k,
                       jcore.GPICConfig(use_pallas=False, **_ref_override(override)))
    with pytest.raises(ValueError) as port_err:
        run_gpic(x, k, GPICConfig(**_port_override(override)), device="cpu")
    assert str(port_err.value) == str(ref_err.value)
    plain = {key: val for key, val in override.items() if key != "affinity"}
    ref_fields = _plain_fields(jcore.GPICConfig(**plain))
    if "affinity" in override:
        ref_fields["affinity"] = override["affinity"]
    with pytest.raises(ValueError) as map_err:
        config_from_reference(ref_fields, n=40)
    assert str(map_err.value) == str(ref_err.value)


def test_graph_spec_config_maps_from_reference():
    """A kNN spec on the dense-storage route maps to the port's equal
    config, which runs it: the component probe finds the reference's four
    blobs."""
    spec = jcore.AffinitySpec(kind="rbf", sigma=0.3, knn_k=10)
    ref_cfg = jcore.GPICConfig(affinity=spec, block_sparse=False, use_pallas=False)
    cfg = config_from_reference(_plain_fields(ref_cfg))
    assert cfg == GPICConfig(affinity=AffinitySpec(kind="rbf", sigma=0.3, knn_k=10),
                             block_sparse=False)
    x, y, k = dataset_by_name("gaussians", 200, seed=0)
    ref = jcore.run_gpic(jnp.asarray(x), k, ref_cfg, key=jax.random.key(1))
    res = run_gpic(x, k, cfg, device="cpu")
    assert int(res.health.n_components) == int(ref.health.n_components) == 4
    np.testing.assert_array_equal(res.health.components.numpy(),
                                  np.asarray(ref.health.components))
    assert adjusted_rand_index(y, res.labels.numpy()) == 1.0


def test_knn_spec_runs_on_the_default_block_sparse_route():
    """The reference's default route for a kNN spec (block_sparse=True)
    maps to the port's equal config, which runs it: the reference's four
    blobs and partition."""
    spec = jcore.AffinitySpec(kind="rbf", sigma=0.3, knn_k=10)
    ref_cfg = jcore.GPICConfig(affinity=spec, use_pallas=False)
    cfg = config_from_reference(_plain_fields(ref_cfg))
    assert cfg == GPICConfig(affinity=AffinitySpec(kind="rbf", sigma=0.3, knn_k=10))
    assert cfg.block_sparse
    x, y, k = dataset_by_name("gaussians", 400, seed=0)
    ref = jcore.run_gpic(jnp.asarray(x), k, ref_cfg, key=jax.random.key(1))
    for engine in ("explicit", "streaming"):
        res = run_gpic(x, k, cfg.with_(engine=engine), device="cpu")
        assert int(res.health.n_components) == int(ref.health.n_components) == 4
        np.testing.assert_array_equal(res.health.components.numpy(),
                                      np.asarray(ref.health.components))
        assert adjusted_rand_index(np.asarray(ref.labels), res.labels.numpy()) == 1.0


@pytest.mark.parametrize("override,n,raises", [
    (dict(), 400, False), (dict(engine="streaming"), 400, True),
    (dict(block_sparse=False), 400, True), (dict(row_reorder=True), 400, True),
    (dict(), 256, True),
], ids=["explicit_block_sparse", "streaming", "dense_storage", "row_reorder",
        "single_column_tile"])
def test_knn_k_past_the_row_topk_kernel_by_route(override, n, raises):
    """knn_k = 65: the explicit block-sparse route selects the thresholds
    from its stored scores and runs, as the reference does; every route
    that takes them from the row top-k kernel raises NotImplementedError
    (the streaming engine, the dense storage, the reorder's probe on the
    dense-grid streaming operator, and a single column tile, which keeps
    the dense route)."""
    spec = dict(kind="rbf", sigma=0.3, knn_k=65)
    x, y, k = dataset_by_name("gaussians", n, seed=0)
    cfg = GPICConfig(affinity=AffinitySpec(**spec), **override)
    if raises:
        with pytest.raises(NotImplementedError, match="K > 64"):
            run_gpic(x, k, cfg, device="cpu")
        return
    res = run_gpic(x, k, cfg, device="cpu")
    ref = jcore.run_gpic(jnp.asarray(x), k, jcore.GPICConfig(
        affinity=jcore.AffinitySpec(**spec), use_pallas=False), key=jax.random.key(1))
    assert int(res.health.n_components) == int(ref.health.n_components)
    assert adjusted_rand_index(np.asarray(ref.labels), res.labels.numpy()) == 1.0


def test_component_probe_off_leaves_no_count():
    spec = jcore.AffinitySpec(kind="rbf", sigma=0.3, knn_k=10)
    ref_cfg = jcore.GPICConfig(affinity=spec, block_sparse=False, component_probe=False,
                               use_pallas=False)
    cfg = config_from_reference(_plain_fields(ref_cfg))
    assert cfg.component_probe is False
    x, _, k = dataset_by_name("gaussians", 200, seed=0)
    ref = jcore.run_gpic(jnp.asarray(x), k, ref_cfg, key=jax.random.key(1))
    res = run_gpic(x, k, cfg, device="cpu")
    assert int(res.health.n_components) == int(ref.health.n_components) == -1
    assert (res.health.components.numpy() == -1).all()
    assert res.health.to_dict() == ref.health.to_dict()


def test_config_from_reference_defaults_and_rejections():
    assert config_from_reference(_plain_fields(jcore.GPICConfig())) == GPICConfig()
    fields = _plain_fields(jcore.GPICConfig(use_pallas=False, retry_on_fallback=True))
    assert config_from_reference(fields) == GPICConfig()
    # a reference mesh is a JAX object: the port takes a process group instead
    with pytest.raises(NotImplementedError, match="mesh.*process group"):
        config_from_reference(dict(fields, mesh="a mesh"))
    # the sharded engines' fields are routed (queue 1 item 10): overlap
    # crosses as is, and the ring fault and fold_shift reach check_config,
    # which refuses them without a mesh as the reference does
    assert config_from_reference(dict(fields, overlap=False)) == GPICConfig(overlap=False)
    with pytest.raises(ValueError, match="needs mesh set and engine='streaming'"):
        config_from_reference(dict(fields, engine="streaming",
                                   inject_ring_fault=("ring_nan", 0)))
    with pytest.raises(ValueError, match="applies only to the sharded explicit engine"):
        config_from_reference(dict(fields, fold_shift=True))
    # the resumable supervisor's fields are routed (queue 1 item 9)
    routed = dict(checkpoint_every=5, ckpt_dir="ck", max_retries=1, backoff=0.5,
                  straggler_timeout=30.0)
    assert config_from_reference(dict(fields, **routed)) == GPICConfig(**routed)
    with pytest.raises(ValueError, match="unknown GPICConfig field"):
        config_from_reference(dict(fields, not_a_field=1))
    with pytest.raises(ValueError, match="unknown engine"):
        config_from_reference(dict(fields, engine="warp"))


@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo process group of this process alone (the default group, torn
    down after the test)."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("override", [
    dict(checkpoint_every=5, ckpt_dir="ck"), dict(straggler_timeout=30.0),
    dict(row_reorder=True), dict(segment_injector=lambda t: None),
], ids=["checkpoint_every", "straggler_timeout", "row_reorder", "segment_injector"])
def test_mesh_with_the_supervisor_or_the_reorder_names_item_10b(one_rank_group, tmp_path,
                                                                override):
    """The settings of ROADMAP queue 1 item 10b run on a group. On one rank
    the supervised run (snapshots, the straggler watchdog, an injector) is
    bitwise the monolithic sharded run, and the reordered run is the
    one-device reordered run (the permutation from the gathered features
    and the sharded probe)."""
    x, _, k = dataset_by_name("gaussians", 200, seed=0)
    x = x[np.random.default_rng(3).permutation(x.shape[0])]
    override = dict(override)
    injector = override.pop("segment_injector", None)
    if "ckpt_dir" in override:
        override["ckpt_dir"] = str(tmp_path / override["ckpt_dir"])
    cfg = GPICConfig(affinity=AffinitySpec(kind="rbf", sigma=0.3, knn_k=10), max_iter=60,
                     mesh=one_rank_group)
    res = run_gpic(x, k, cfg.with_(**override), device="cpu", segment_injector=injector)
    got = result_to_numpy(res)
    reorder = override.get("row_reorder", False)
    want = result_to_numpy(run_gpic(x, k, cfg.with_(mesh=None, **override) if reorder else cfg,
                                    device="cpu"))
    assert res.health.notes == (("row_reorder",) if reorder else ())
    for field, value in want.items():
        np.testing.assert_array_equal(got[field], value, err_msg=field)


@pytest.mark.parametrize("engine", ["explicit", "streaming", "matrix_free"])
def test_run_gpic_on_a_one_rank_group_is_the_one_device_run(one_rank_group, engine):
    """With ``mesh`` set, run_gpic routes to the sharded engines; on one
    rank they make the one-device run's labels, sweeps and health, the
    embedding within f32 noise."""
    if engine == "matrix_free":
        x, _, k = direction_clusters(200, 0)
        cfg = GPICConfig(engine=engine, affinity_kind="cosine")
    else:
        x, _, k = dataset_by_name("gaussians", 200, seed=0)
        cfg = GPICConfig(engine=engine, affinity_kind="rbf", sigma=0.3)
    one = result_to_numpy(run_gpic(x, k, cfg, device="cpu"))
    res = run_gpic(x, k, cfg.with_(mesh=one_rank_group), device="cpu")
    got = result_to_numpy(res)
    for field in ("labels", "n_iter_cols", "health_col_status", "health_isolated_rows"):
        np.testing.assert_array_equal(got[field], one[field], err_msg=field)
    np.testing.assert_allclose(got["embeddings"], one["embeddings"], rtol=0,
                               atol=1e-6 * np.abs(one["embeddings"]).max())


def test_port_imports_no_jax_and_nothing_of_the_reference():
    code = ("import sys, repro_torch, repro_torch.interop, repro_torch.core, "
            "repro_torch.kernels.ops, repro_torch.models, repro_torch.configs, "
            "repro_torch.core.distributed, "
            "repro_torch.train, repro_torch.train.train_step, repro_torch.launch, "
            "repro_torch.launch.serve, repro_torch.launch.train, "
            "repro_torch.examples.train_lm, repro_torch.data.tokens, "
            "repro_torch.distributed, repro_torch.distributed.sharding, "
            "repro_torch.distributed.collectives, repro_torch.launch.mesh, "
            "repro_torch.testing; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.')]; "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    pattern = re.compile(r"^\s*(import jax|from jax|from repro[. ]|import repro\b)")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    offenders = [f"{path}:{i}" for path in files
                 for i, line in enumerate(open(path), 1) if pattern.match(line)]
    assert offenders == []
