"""The port's sharded engines on a 4-rank gloo group, on the CPU.

The same numpy features go through three runs:

  - the reference's ``distributed_gpic`` (and its matrix-free twin and
    ``distributed_component_ids``) on a 4-device host mesh, with the jnp
    oracles, all cases in one ``repro.testing.run_mesh_subprocess`` call;
  - the port's ``repro_torch.core.distributed`` entry points on 4 gloo
    ranks (``torch.multiprocessing.spawn``, ``tests/torch_distributed_worker.py``),
    each rank given its row block;
  - the port's single-device ``gpic`` / ``gpic_matrix_free``.

The packages draw different random numbers, so the reference's extra start
columns (``u0t``) and k-means start centroids (kmeans++ from its key on its
own embedding) go into both port runs. Held, for every case:

  - labels identical (both packages canonicalize by first appearance);
  - column 0's sweep count within one: equal, or one apart where an
    eps-crossing sits in the f32 noise of two summation orders (ROADMAP
    queue 3, "eps-crossings creep": here the adaptive + kNN spec crosses at
    67 on one device and 68 sharded, the reference's streaming ring at 19
    where the others cross at 18, the orthogonal column 0 at 18 and 19);
    block columns of the orthogonal mode are not counted;
  - the embedding columns whose sweep counts are equal within
    ``EMB_RTOL`` = 1e-5 of max|v| (f32 sums in another order: the ring
    sums stage partials from the rank's own block, one device sums rows in
    one pass); ``BF16_RTOL`` = 1e-3 with a bf16 A, where W's rows sum to 1
    only within 2^-9 and the sum-order noise grows over the sweeps (queue 3);
  - the health report: the column status, isolated rows and components.

Within the port: every rank returns the same bits; ``overlap=False`` gives
the bits of ``overlap=True``; the segment trio gives the monolithic run's
bits; ``run_gpic`` with ``mesh`` gives ``distributed_gpic``'s.

Routes: n = 512 gives n/P = 128, one column tile a ring stage, so the
streaming ring of a kNN spec keeps the dense grid (#5, #6, #7), while the
explicit engine's (128, 512) stripe takes the block-sparse route (the fused
build, #9). The block-sparse ring (#8, #10, #11, a plan per stage) needs
more than one 256-column tile a stage: n = 1,152, n/P = 288. Its spec is
gaussians rbf 0.3 with ``knn_k=30``: at n = 1,152 the two packages'
single-device runs agree (4 components, 55 sweeps), where E1's
``knn_k=10`` breaks the blobs apart past n = 480 and the packages part
(queue 3: ARI 0.5815 against 0.5646 at n = 1,500).
"""
from __future__ import annotations

import json
import os
import pickle
import re
import tempfile
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import torch.multiprocessing as mp  # noqa: E402

from repro.testing import run_mesh_subprocess  # noqa: E402
from repro_torch import dataset_by_name  # noqa: E402
from repro_torch.core import AffinitySpec, gpic, gpic_matrix_free  # noqa: E402
from repro_torch.core.health import graph_component_probe  # noqa: E402
from repro_torch.core.operators import streaming_operator  # noqa: E402
from repro_torch.interop import result_to_numpy  # noqa: E402
from test_torch_pipeline import direction_clusters  # noqa: E402

WORLD = 4
N = 512
N_BS = 1152
EMB_RTOL = 1e-5
BF16_RTOL = 1e-3
JOIN_TIMEOUT = 240          # seconds for the whole spawned group

RBF = dict(kind="rbf", sigma=0.3)
E1 = dict(kind="rbf", sigma=0.3, knn_k=10)
E2 = dict(kind="rbf", sigma=0.3, bandwidth="adaptive", scale_k=7, knn_k=10)
BS = dict(kind="rbf", sigma=0.3, knn_k=30)
#: the cosine_shifted cases stop after 3 sweeps: run to its eps, the
#: embedding of (1 + cos) / 2 keeps a spread of ~1e-6 of its size (W is
#: nearly uniform), its partition is f32 noise, and the packages' labels
#: differ (as on the 2-D sets, ROADMAP queue 3); after 3 sweeps the
#: clusters' degrees still separate them
EARLY = dict(eps_scale=0.0, max_iter=3)

#: (dataset, n) -> features and k
DATA = {"gaussians": ("gaussians", N), "gaussians_bs": ("gaussians", N_BS),
        "directions": ("directions", N)}

#: name -> (entry, data, keyword arguments): the cases held against the
#: reference's mesh run and the port's single-device run
REF_CASES = {
    "explicit-rbf": ("gpic", "gaussians", dict(engine="explicit", affinity=RBF)),
    "streaming-rbf": ("gpic", "gaussians", dict(engine="streaming", affinity=RBF)),
    "explicit-cosine_shifted": ("gpic", "directions", dict(engine="explicit", **EARLY)),
    "streaming-cosine_shifted": ("gpic", "directions", dict(engine="streaming", **EARLY)),
    "matrix_free-cosine_shifted": ("matrix_free", "directions", dict(**EARLY)),
    "matrix_free-cosine-orthogonal": ("matrix_free", "directions", dict(
        affinity_kind="cosine", embedding="orthogonal", n_vectors=2)),
    "explicit-knn-fused": ("gpic", "gaussians", dict(engine="explicit", affinity=E1)),
    "explicit-knn-dense_storage": ("gpic", "gaussians", dict(
        engine="explicit", affinity=E1, block_sparse=False)),
    "streaming-knn-dense_grid": ("gpic", "gaussians", dict(engine="streaming", affinity=E1)),
    "explicit-knn30-block_sparse": ("gpic", "gaussians_bs", dict(engine="explicit",
                                                                  affinity=BS)),
    "streaming-knn30-block_sparse_ring": ("gpic", "gaussians_bs", dict(engine="streaming",
                                                                        affinity=BS)),
    "explicit-adaptive_knn": ("gpic", "gaussians", dict(engine="explicit", affinity=E2)),
    "streaming-adaptive_knn": ("gpic", "gaussians", dict(engine="streaming", affinity=E2)),
    "explicit-orthogonal": ("gpic", "gaussians", dict(engine="explicit", affinity=RBF,
                                                      embedding="orthogonal", n_vectors=2)),
    "streaming-ensemble": ("gpic", "gaussians", dict(engine="streaming", affinity=RBF,
                                                     embedding="ensemble")),
    "explicit-bf16": ("gpic", "gaussians", dict(engine="explicit", affinity=RBF,
                                                a_dtype="bfloat16")),
    "explicit-fold_shift": ("gpic", "directions", dict(engine="explicit", fold_shift=True,
                                                        **EARLY)),
}
#: held against the reference's mesh run only: no single-device counterpart
FAULT_CASE = ("gpic", "gaussians", dict(engine="streaming", affinity=RBF,
                                        inject_ring_fault=["ring_nan", 1]))
#: port-only cases: name -> (case, the case whose bits it must give)
SAME_BITS = {
    "streaming-rbf-overlap_off": (("gpic", "gaussians", dict(
        engine="streaming", affinity=RBF, overlap=False)), "streaming-rbf"),
    "streaming-knn30-block_sparse_ring-overlap_off": (("gpic", "gaussians_bs", dict(
        engine="streaming", affinity=BS, overlap=False)), "streaming-knn30-block_sparse_ring"),
    "explicit-rbf-segments": (("segments", "gaussians", dict(
        engine="explicit", affinity=RBF)), "explicit-rbf"),
    "streaming-knn-segments": (("segments", "gaussians", dict(
        engine="streaming", affinity=E1)), "streaming-knn-dense_grid"),
}
MAX_ITER = 400


def _features():
    out = {}
    for key, (name, n) in DATA.items():
        if name == "directions":
            x, _, k = direction_clusters(n, 0)
        else:
            x, _, k = dataset_by_name(name, n, seed=0)
        out[key] = (x, k)
    return out


_REF_CODE = """
import json, numpy as np, jax, jax.numpy as jnp
from repro.core import AffinitySpec, kmeans_plus_plus_init, standardize_columns
from repro.core.power import random_start_vectors
from repro.core.distributed import (distributed_component_ids, distributed_gpic,
                                    distributed_gpic_matrix_free, shard_points)
mesh = jax.make_mesh((4,), ("data",))
feats = np.load({inp!r})
cases = json.loads({cases!r})
out = {{}}
for name, (entry, data, kw) in cases.items():
    x = feats[data]; k = int(feats[data + "_k"]); n = x.shape[0]
    kw = dict({{"max_iter": {max_iter}}}, **kw)
    if "affinity" in kw:
        kw["affinity"] = AffinitySpec(**kw["affinity"])
    if "a_dtype" in kw:
        kw["a_dtype"] = getattr(jnp, kw["a_dtype"])
    if kw.get("inject_ring_fault") is not None:
        kw["inject_ring_fault"] = tuple(kw["inject_ring_fault"])
    xs = shard_points(x, mesh)
    if entry == "component_ids":
        kw.pop("max_iter")
        n_comp, ids = distributed_component_ids(xs, mesh=mesh, use_pallas=False, **kw)
        out[name + "/n_components"] = np.asarray(n_comp)
        out[name + "/components"] = np.asarray(ids)
        continue
    key = jax.random.key(1)
    kkm, krand = jax.random.split(key)
    run = distributed_gpic if entry == "gpic" else distributed_gpic_matrix_free
    res = run(xs, k, key=key, mesh=mesh, use_pallas=False, **kw)
    out[name + "/u0t"] = np.asarray(random_start_vectors(krand, n, kw.get("n_vectors", 1)))
    out[name + "/init"] = np.asarray(kmeans_plus_plus_init(
        kkm, standardize_columns(res.embeddings), k))
    for field in ("labels", "embeddings", "n_iter_cols"):
        out[name + "/" + field] = np.asarray(getattr(res, field))
    for field in ("col_status", "isolated_rows", "n_components", "components"):
        out[name + "/health_" + field] = np.asarray(getattr(res.health, field))
np.savez({out!r}, **out)
print("done", len(cases))
"""


def _reference(tmp, feats):
    """Every reference case in one 4-device mesh subprocess: {case: {field:
    array}}, with the case's u0t and k-means init."""
    inp, out = os.path.join(tmp, "features.npz"), os.path.join(tmp, "reference.npz")
    arrays = {key: x for key, (x, _) in feats.items()}
    arrays.update({f"{key}_k": np.array(k) for key, (_, k) in feats.items()})
    np.savez(inp, **arrays)
    cases = dict(REF_CASES, **{"streaming-rbf-ring_fault": FAULT_CASE,
                               "component_ids": ("component_ids", "gaussians",
                                                 dict(affinity=E1))})
    code = _REF_CODE.format(inp=inp, out=out, cases=json.dumps(cases), max_iter=MAX_ITER)
    run_mesh_subprocess(code, devices=WORLD, timeout=JOIN_TIMEOUT)
    got: dict = {}
    with np.load(out) as f:
        for key in f.files:
            name, field = key.split("/")
            got.setdefault(name, {})[field] = f[key]
    return got


def _port_case(entry, data, kw, feats, ref=None, **extra):
    x, k = feats[data]
    case = dict(entry=entry, x=x, k=k, kw=dict({"max_iter": MAX_ITER}, **kw), **extra)
    if entry == "component_ids":
        case["kw"].pop("max_iter")
    if ref is not None and "u0t" in ref:
        case.update(u0t=ref["u0t"], init=ref["init"])
    return case


def _single_device(entry, data, kw, feats, ref):
    """The port's single-device run of a case with the reference's draws."""
    x, k = feats[data]
    kw = dict({"max_iter": MAX_ITER}, **kw)
    kw.pop("fold_shift", None)          # an explicit stripe storage detail
    if "eps_scale" in kw:
        kw["eps"] = kw.pop("eps_scale") / x.shape[0]
    if "affinity" in kw:
        kw["affinity"] = AffinitySpec(**kw["affinity"])
    if "a_dtype" in kw:
        kw["a_dtype"] = getattr(torch, kw["a_dtype"])
    run = gpic if entry == "gpic" else gpic_matrix_free
    return result_to_numpy(run(torch.from_numpy(x), k, u0t=ref["u0t"],
                               kmeans_init=torch.from_numpy(ref["init"]), **kw))


@pytest.fixture(scope="module")
def runs():
    """Every case once: the reference's mesh run, the port's 4 ranks (each
    rank's outputs) and the port's single-device run."""
    from torch_distributed_worker import run_rank

    feats = _features()
    with tempfile.TemporaryDirectory() as tmp:
        ref = _reference(tmp, feats)
        cases = {name: _port_case(*case, feats, ref.get(name))
                 for name, case in REF_CASES.items()}
        cases["streaming-rbf-ring_fault"] = _port_case(*FAULT_CASE, feats)
        cases["component_ids"] = _port_case("component_ids", "gaussians",
                                            dict(affinity=E1), feats)
        for name, (case, twin) in SAME_BITS.items():
            cases[name] = _port_case(*case, feats, ref.get(twin),
                                     **({"split": 5} if case[0] == "segments" else {}))
        cases["run_gpic-explicit-rbf"] = dict(entry="run_gpic", x=feats["gaussians"][0],
                                              k=feats["gaussians"][1],
                                              kw=dict(affinity=RBF, max_iter=MAX_ITER, seed=7))
        cases["run_gpic-generator-explicit-rbf"] = _port_case(
            "gpic", "gaussians", dict(engine="explicit", affinity=RBF), feats)
        cases["shard_points_uneven"] = dict(entry="shard_points_uneven", n=513)
        cases["backend_mismatch"] = dict(entry="backend_mismatch")
        case_file = os.path.join(tmp, "cases.pkl")
        with open(case_file, "wb") as f:
            pickle.dump(cases, f)
        ctx = mp.start_processes(run_rank, args=(WORLD, os.path.join(tmp, "store"), case_file,
                                                 tmp), nprocs=WORLD, join=False,
                                 start_method="spawn")
        single = {}
        for name, (entry, data, kw) in REF_CASES.items():
            single[name] = _single_device(entry, data, kw, feats, ref[name])
        x, _ = feats["gaussians"]
        op = streaming_operator(torch.from_numpy(x), spec=AffinitySpec(**E1), block_sparse=False)
        n_comp, comp = graph_component_probe(op, N, max_components=16)
        single["component_ids"] = {"n_components": n_comp.numpy(),
                                   "components": comp.numpy()}
        deadline = time.monotonic() + JOIN_TIMEOUT
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise TimeoutError(f"the {WORLD} ranks did not finish in {JOIN_TIMEOUT} s")
        port = {name: [dict(np.load(os.path.join(tmp, f"{name}.rank{r}.npz")))
                       for r in range(WORLD)] for name in cases}
    return dict(ref=ref, port=port, single=single, feats=feats)


def _rank0(runs, name):
    out = runs["port"][name][0]
    assert "raised" not in out, str(out["raised"])
    return out


def _hold(got, want, tol, *, block=False):
    """Labels identical; column 0's sweeps within one (equal counts are
    the rule, one apart an eps-crossing in f32 noise); the embedding columns
    of equal counts within ``tol`` of max|v|; the health's column 0 status
    and rows."""
    np.testing.assert_array_equal(got["labels"], want["labels"])
    t_got, t_want = got["n_iter_cols"], want["n_iter_cols"]
    assert abs(int(t_got[0]) - int(t_want[0])) <= 1, (t_got, t_want)
    cols = [0] if block else range(len(t_got))
    emb_got, emb_want = got["embeddings"], want["embeddings"]
    assert emb_got.shape == emb_want.shape
    per = emb_got.shape[1] // len(t_got)            # ensemble: S snapshots a column
    for c in cols:
        if t_got[c] == t_want[c]:
            sl = slice(c * per, (c + 1) * per)
            scale = np.abs(emb_want[:, sl]).max()
            assert np.abs(emb_got[:, sl] - emb_want[:, sl]).max() <= tol * scale, c
    for field in ("health_isolated_rows", "health_n_components", "health_components"):
        np.testing.assert_array_equal(got[field], want[field])
    assert int(got["health_col_status"][0]) == int(want["health_col_status"][0])


def _tol(name):
    return BF16_RTOL if "bf16" in name else EMB_RTOL


@pytest.mark.parametrize("name", list(REF_CASES))
def test_sharded_port_matches_the_reference_mesh(runs, name):
    _hold(_rank0(runs, name), runs["ref"][name], _tol(name), block="orthogonal" in name)


@pytest.mark.parametrize("name", list(REF_CASES))
def test_sharded_port_matches_the_single_device_port(runs, name):
    _hold(_rank0(runs, name), runs["single"][name], _tol(name), block="orthogonal" in name)


@pytest.mark.parametrize("name", sorted(set(REF_CASES) | set(SAME_BITS) | {
    "streaming-rbf-ring_fault", "component_ids", "run_gpic-explicit-rbf"}))
def test_every_rank_returns_the_same_result(runs, name):
    outs = runs["port"][name]
    _rank0(runs, name)
    for other in outs[1:]:
        assert sorted(other) == sorted(outs[0])
        for field, value in outs[0].items():
            np.testing.assert_array_equal(other[field], value, err_msg=field)


@pytest.mark.parametrize("name", list(SAME_BITS))
def test_overlap_and_segments_keep_the_bits(runs, name):
    """overlap=False against the double-buffered ring (the dense-grid sweep
    ring; the block-sparse ring with its liveness, degree and probe rings),
    and the segment trio cut every 5 sweeps against the monolithic run."""
    got, want = _rank0(runs, name), _rank0(runs, SAME_BITS[name][1])
    assert sorted(got) == sorted(want)
    for field, value in want.items():
        np.testing.assert_array_equal(got[field], value, err_msg=field)


def test_ring_fault_latches_nonfinite_like_the_reference(runs):
    """('ring_nan', 1) poisons the V block stage 1 consumes: column 0 latches
    COL_NONFINITE (4) after one sweep in both packages."""
    got, want = _rank0(runs, "streaming-rbf-ring_fault"), runs["ref"]["streaming-rbf-ring_fault"]
    assert int(got["health_col_status"][0]) == int(want["health_col_status"][0]) == 4
    assert list(got["n_iter_cols"]) == list(want["n_iter_cols"]) == [1]
    assert not np.isnan(got["embeddings"]).any()


def test_component_ids_match_the_reference_and_one_device(runs):
    got = _rank0(runs, "component_ids")
    for want in (runs["ref"]["component_ids"], runs["single"]["component_ids"]):
        assert int(got["n_components"]) == int(want["n_components"]) == 4
        np.testing.assert_array_equal(got["components"], want["components"])


def test_run_gpic_with_mesh_is_distributed_gpic(runs):
    """The front door with a process group routes to ``distributed_gpic``:
    with the generator seeded from ``seed``, the same bits."""
    got, want = _rank0(runs, "run_gpic-explicit-rbf"), _rank0(
        runs, "run_gpic-generator-explicit-rbf")
    for field in ("labels", "embeddings", "n_iter_cols", "health_col_status"):
        np.testing.assert_array_equal(got[field], want[field], err_msg=field)


def test_shard_points_uneven_raises_like_the_reference(runs):
    msg = str(runs["port"]["shard_points_uneven"][0]["error"])
    ref = ("shard_points: n=513 rows do not divide evenly over 4 devices on axes "
           "('data',); pad or trim the input first")
    strip = re.compile(r" (on axes \('data',\)|of the process group)")
    assert strip.sub("", msg) == strip.sub("", ref)


def test_backend_that_does_not_carry_the_device_raises(runs):
    assert "gloo" in str(runs["port"]["backend_mismatch"][0]["error"])
