"""The port's supervisor and row reorder on a 4-rank gloo group, on the CPU.

The twins of the reference's mesh tests (``tests/test_resume.py``'s
``test_mesh_*``: gaussians n = 256, k = 3, ``max_iter=24``), which fail in
the reference because its ``run_gpic`` mesh front door stops before it
returns (ROADMAP queue 3). So the port is held to:

  - its own monolithic sharded run, bitwise: runs interrupted at sweeps
    {1, mid, last - 1} and resumed, snapshots every 7 sweeps, a fault or a
    straggler on one rank retried on all four, a corrupt newest snapshot
    quarantined once; and the concurrent fault matrix's outcomes;
  - the reference's segment trio (``distributed_gpic_segment_start`` /
    ``_segment`` / ``_segment_finalize``) on a 4-device host mesh, cut at
    the same boundaries, with the reference's start columns and k-means
    start centroids passed into the port's trio, under the discipline of
    ``tests/test_torch_distributed.py``: labels identical, column 0's
    sweeps within one, the embeddings of equal counts within ``EMB_RTOL``
    of max|v|. The supervised run is bitwise the port's trio from the same
    generator, which closes the chain;
  - a snapshot written on 4 ranks resumes on one device and on 2 ranks
    (the sums then run in another order, so the same tolerance, not bits);
  - the mesh row reorder's permutation equals the reference's
    ``_row_reorder_permutation`` with a 4-device host mesh (its sharded
    probe; the features passed unsharded, since its content score stops in
    a ShardingTypeError on row-sharded features, ROADMAP queue 3) and the
    port's one-device permutation, exactly, on E1 and a dense spec.

The affinity is rbf σ 0.3, not the reference tests' default
``cosine_shifted``, whose embedding on the 2-D sets is f32 noise, so that
the two packages' partitions can be compared (ROADMAP queue 3). The ranks
run in ``tests/torch_distributed_worker.py``, spawned once for the module;
every rank must return the same outputs.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import torch.multiprocessing as mp  # noqa: E402

from repro.testing import run_mesh_subprocess  # noqa: E402
from repro_torch import GPICConfig, run_gpic  # noqa: E402
from repro_torch.core import AffinitySpec  # noqa: E402
from repro_torch.core.graph import graph_reorder_permutation  # noqa: E402
from repro_torch.data.synthetic import gaussians  # noqa: E402
from test_torch_distributed import EMB_RTOL, _hold  # noqa: E402

WORLD = 4
N, K = 256, 3
N_REORDER = 512
MAX_ITER = 24
SPLIT = 5                   # the trio's and the supervised run's segment length
JOIN_TIMEOUT = 240          # seconds for the whole spawned group

RBF = dict(kind="rbf", sigma=0.3)
E1 = dict(kind="rbf", sigma=0.3, knn_k=10)
BASE = dict(affinity=RBF, max_iter=MAX_ITER)
#: a run that is still alive at sweep 10 (eps 1e-7 / n)
LONG = dict(engine="explicit", affinity=RBF, max_iter=MAX_ITER, eps_scale=1e-7)
MATRIX = [(engine, r) for engine in ("explicit", "streaming") for r in (1, 4)]
REORDER = {"reorder-E1": E1, "reorder-dense": RBF}
#: the outputs of the steps rank 0 runs alone
RANK0_STEPS = ("corrupt__", "ls__")


def _mode(r):
    return "orthogonal" if r > 1 else "pic"


def _data():
    x = gaussians(N, k=K, seed=0)[0]
    rs = np.random.RandomState(1)
    outlier = np.concatenate([rs.randn(N - 1, 2).astype(np.float32) * 0.2,
                              np.full((1, 2), 60.0, np.float32)])
    shuffled = gaussians(N_REORDER, k=K, seed=0)[0]
    shuffled = shuffled[np.random.default_rng(5).permutation(N_REORDER)]
    return dict(gaussians=x, outlier=outlier, clean=gaussians(N, k=2, seed=3)[0],
                shuffled=shuffled)


_REF_CODE = """
import numpy as np, jax, jax.numpy as jnp
from repro.core import AffinitySpec, GPICConfig, kmeans_plus_plus_init, standardize_columns
from repro.core.power import random_start_vectors
from repro.core.distributed import (distributed_gpic_segment, distributed_gpic_segment_finalize,
                                    distributed_gpic_segment_start, shard_points)
from repro.core.pipeline import _row_reorder_permutation
mesh = jax.make_mesh((4,), ("data",))
feats = np.load({inp!r})
out = {{}}
x = feats["gaussians"]; n = x.shape[0]
xs = shard_points(x, mesh)
spec = AffinitySpec(kind="rbf", sigma=0.3)
for engine, r in {matrix!r}:
    mode = "orthogonal" if r > 1 else "pic"
    kw = dict(mesh=mesh, engine=engine, affinity=spec, use_pallas=False)
    kkm, krand = jax.random.split(jax.random.key(1))
    carry, iso = distributed_gpic_segment_start(xs, jnp.int32({split}), key=krand, n_vectors=r,
                                                mode=mode, **kw)
    while int(carry.t) < {max_iter} and not bool(jnp.all(carry.done)):
        stop = jnp.int32(min(int(carry.t) + {split}, {max_iter}))
        carry = distributed_gpic_segment(xs, carry, stop, mode=mode, **kw)
    res = distributed_gpic_segment_finalize(xs, carry, iso, {k}, key=kkm, embedding=mode, **kw)
    name = f"{{engine}}-r{{r}}"
    out[name + "/u0t"] = np.asarray(random_start_vectors(krand, n, r))
    out[name + "/init"] = np.asarray(kmeans_plus_plus_init(
        kkm, standardize_columns(res.embeddings), {k}))
    for field in ("labels", "embeddings", "n_iter_cols"):
        out[name + "/" + field] = np.asarray(getattr(res, field))
    for field in ("col_status", "isolated_rows", "n_components", "components"):
        out[name + "/health_" + field] = np.asarray(getattr(res.health, field))
for name, spec_kw in {reorder!r}.items():
    spec = AffinitySpec(**spec_kw)
    cfg = GPICConfig(mesh=mesh, row_reorder=True, affinity=spec, use_pallas=False)
    # unsharded: on a row-sharded x the reference's content_row_score stops in
    # a ShardingTypeError (its jnp.median), as its mesh reorder test does
    perm = _row_reorder_permutation(jnp.asarray(feats["shuffled"]), cfg, spec)
    out[name + "/perm"] = np.asarray(perm)
np.savez({out!r}, **out)
print("done")
"""


def _reference(tmp, feats):
    """The reference's segment trio at each (engine, r) of MATRIX and its
    mesh reorder permutations, in one 4-device mesh subprocess: {case:
    {field: array}}."""
    inp, out = os.path.join(tmp, "features.npz"), os.path.join(tmp, "reference.npz")
    np.savez(inp, **feats)
    code = _REF_CODE.format(inp=inp, out=out, matrix=MATRIX, split=SPLIT, max_iter=MAX_ITER,
                            k=K, reorder=REORDER)
    run_mesh_subprocess(code, devices=WORLD, timeout=JOIN_TIMEOUT)
    got: dict = {}
    with np.load(out) as f:
        for key in f.files:
            name, field = key.split("/")
            got.setdefault(name, {})[field] = f[key]
    return got


def _cases(feats, ref):
    """The port's cases, each a list of steps the ranks run in order."""
    x = feats["gaussians"]
    cases = {}
    for engine, r in MATRIX:
        name = f"{engine}-r{r}"
        kw = dict(BASE, engine=engine, n_vectors=r, embedding=_mode(r))
        trio = dict(BASE, engine=engine, n_vectors=r, mode=_mode(r))
        cases[name] = [
            dict(op="interrupts", name=name, kw=kw, out="m"),
            dict(op="trio", kw=trio, split=SPLIT, u0t=ref[name]["u0t"],
                 init=ref[name]["init"], out="ref_draws"),
            dict(op="trio", kw=trio, split=SPLIT, out="gen"),
            dict(op="run", kw=dict(kw, checkpoint_every=SPLIT, ckpt=f"{name}_sup"), seed=7,
                 out="sup")]
    for engine in ("explicit", "streaming"):
        kw = dict(BASE, engine=engine, n_vectors=2, embedding="ensemble")
        cases[f"checkpointed-{engine}"] = [
            dict(op="run", kw=kw, out="base"),
            dict(op="run", kw=dict(kw, checkpoint_every=7, ckpt=f"ens_{engine}"), out="sup")]
    faults = dict(engine="streaming", affinity=dict(kind="rbf", sigma=0.5), max_iter=MAX_ITER,
                  checkpoint_every=3)
    cases["faults"] = [
        dict(op="schedule", schedule=dict(ring_stage=2), kw=dict(faults, ckpt="ring"),
             out="ring"),
        dict(op="schedule", schedule=dict(fail_sweeps=(3,)), kw=dict(faults, ckpt="iso"),
             out="iso")]
    cases["faults-clean"] = [
        dict(op="schedule", schedule=dict(fail_sweeps=(6,)),
             kw=dict(faults, affinity=RBF, ckpt="clean"), out="clean")]
    every5 = dict(LONG, checkpoint_every=5)
    cases["one-rank"] = [
        dict(op="run", kw=LONG, out="base"),
        dict(op="run", kw=dict(every5, ckpt="one_fault"), fail_at=(5,), fail_ranks=[1],
             out="fault"),
        dict(op="run", kw=dict(every5, straggler_timeout=30.0, ckpt="one_slow"), slow_rank=2,
             slow_s=60.0, out="slow")]
    kill = dict(every5, max_retries=0)
    cases["corrupt"] = [
        dict(op="run", kw=LONG, out="base"),
        dict(op="run", kw=dict(kill, ckpt="cor"), fail_at=(10,), out="kill"),
        dict(op="corrupt_newest", ckpt="cor", out="corrupt"),
        dict(op="run", kw=dict(kill, ckpt="cor"), out="rerun"),
        dict(op="listdir", ckpt="cor", out="ls")]
    cases["elastic"] = [
        dict(op="run", kw=LONG, out="base"),
        dict(op="run", kw=dict(kill, ckpt="el"), fail_at=(10,), out="kill"),
        dict(op="copy", ckpt="el", to="el_one"),
        dict(op="copy", ckpt="el", to="el_two"),
        dict(op="one_device", kw=dict(kill, ckpt="el_one"), out="one"),
        dict(op="subgroup", ranks=[0, 1], kw=dict(kill, ckpt="el_two"), out="two")]
    for name, spec in REORDER.items():
        cases[name] = [dict(op="reorder", kw=dict(affinity=spec, row_reorder=True,
                                                  max_iter=MAX_ITER), out="r")]
    data = {"faults": "outlier", "faults-clean": "clean", **{n: "shuffled" for n in REORDER}}
    return {name: dict(entry="steps", steps=steps, x=feats[data.get(name, "gaussians")],
                       k=2 if name.startswith("faults") else K)
            for name, steps in cases.items()}


@pytest.fixture(scope="module")
def runs():
    """The reference's mesh subprocess, then every case once on the 4 ranks:
    {"ref": ..., "port": {case: [rank 0's outputs, ...]}, "feats": ...}."""
    from torch_distributed_worker import run_rank

    feats = _data()
    with tempfile.TemporaryDirectory() as tmp:
        ref = _reference(tmp, feats)
        cases = _cases(feats, ref)
        case_file = os.path.join(tmp, "cases.pkl")
        with open(case_file, "wb") as f:
            pickle.dump(cases, f)
        ctx = mp.start_processes(run_rank, args=(WORLD, os.path.join(tmp, "store"), case_file,
                                                 tmp), nprocs=WORLD, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + JOIN_TIMEOUT
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise TimeoutError(f"the {WORLD} ranks did not finish in {JOIN_TIMEOUT} s")
        port = {name: [dict(np.load(os.path.join(tmp, f"{name}.rank{r}.npz")))
                       for r in range(WORLD)] for name in cases}
    return dict(ref=ref, port=port, feats=feats)


def _out(runs, case, step, rank=0):
    """The outputs of ``step`` of ``case`` on ``rank``: {field: array}."""
    got = runs["port"][case][rank]
    assert "raised" not in got, str(got["raised"])
    prefix = step + "__"
    out = {key[len(prefix):]: v for key, v in got.items() if key.startswith(prefix)}
    assert out, f"{case}: no outputs of step {step}"
    assert "raised" not in out, f"{case}/{step}: {out['raised']}: {out.get('message')}"
    return out


def _sub(out, prefix):
    return {key[len(prefix):]: v for key, v in out.items() if key.startswith(prefix)}


def _bitwise(got, want, ctx):
    for field, value in want.items():
        if field != "notes":
            np.testing.assert_array_equal(got[field], value, err_msg=f"{ctx}: {field}")


def _notes(out):
    return tuple(str(n) for n in out["notes"])


@pytest.mark.parametrize("case", [f"{e}-r{r}" for e, r in MATRIX])
def test_interrupted_and_resumed_is_the_monolithic_run(runs, case):
    """Interrupted at sweeps 1, mid and last - 1 with a snapshot a sweep:
    each resumed run bitwise the uninterrupted sharded run."""
    m = _out(runs, case, "m")
    base = _sub(m, "base__")
    t_final = int(base["n_iter_cols"].max())
    assert t_final > 3, t_final
    assert list(m["sweeps"]) == [1, t_final // 2, t_final - 1]
    assert _notes(base) == ()
    for s in m["sweeps"]:
        res = _sub(m, f"at{s}__")
        _bitwise(res, base, f"{case} @{s}")
        assert _notes(res) == ("retry:1:SimulatedFailure", f"resumed:{s}"), _notes(res)


@pytest.mark.parametrize("case", [f"{e}-r{r}" for e, r in MATRIX])
def test_trio_matches_the_reference_trio(runs, case):
    """The port's trio with the reference's draws, cut every SPLIT sweeps as
    the reference's: labels, column 0's sweeps within one, the embedding."""
    got = _out(runs, case, "ref_draws")
    _hold(got, runs["ref"][case], EMB_RTOL, block=case.endswith("r4"))


@pytest.mark.parametrize("case", [f"{e}-r{r}" for e, r in MATRIX])
def test_supervised_run_is_the_trio_from_the_same_generator(runs, case):
    """run_gpic's supervised sharded run (snapshots every SPLIT sweeps) is
    bitwise the trio cut at the same boundaries, drawing from a generator
    seeded alike: the supervisor adds nothing to what the trio computes."""
    _bitwise(_out(runs, case, "sup"), _out(runs, case, "gen"), case)


@pytest.mark.parametrize("engine", ["explicit", "streaming"])
def test_checkpointed_equals_plain(runs, engine):
    """Ensemble r = 2, snapshots every 7 sweeps, undisturbed: the
    monolithic result, bitwise, and no notes."""
    base = _out(runs, f"checkpointed-{engine}", "base")
    sup = _out(runs, f"checkpointed-{engine}", "sup")
    _bitwise(sup, base, engine)
    assert _notes(sup) == ()


def test_ring_fault_is_the_typed_divergence_error(runs):
    ring = _out(runs, "faults", "ring")
    assert str(ring["status"]) == "typed_error", ring
    assert str(ring["error"]) == "PowerDivergenceError"


def test_isolated_row_with_a_transient_is_degraded_with_a_resume(runs):
    iso = _out(runs, "faults", "iso")
    assert str(iso["status"]) == "degraded"
    assert int(iso["isolated_rows"]) == 1
    assert any(n.startswith("resumed:") for n in _notes(iso)), _notes(iso)


def test_transient_on_clean_data_is_recovered(runs):
    clean = _out(runs, "faults-clean", "clean")
    assert str(clean["status"]) == "recovered", clean
    assert any(n.startswith("retry:") for n in _notes(clean))


def test_fault_on_one_rank_is_retried_on_all(runs):
    """Rank 1's injector alone fires at sweep 5 (the other ranks have
    none): every rank retries and resumes, with the same notes and the
    monolithic bits."""
    base = _out(runs, "one-rank", "base")
    for rank in range(WORLD):
        got = _out(runs, "one-rank", "fault", rank)
        _bitwise(got, base, f"rank {rank}")
        assert _notes(got) == ("retry:1:SimulatedFailure", "resumed:5"), _notes(got)


def test_straggler_on_one_rank_is_retried_on_all(runs):
    """Rank 2's first segment looks 60 s slow: the slowest rank's seconds
    are every rank's, so all four note the straggler and retry alike."""
    base = _out(runs, "one-rank", "base")
    notes = [_notes(_out(runs, "one-rank", "slow", rank)) for rank in range(WORLD)]
    assert all(n == notes[0] for n in notes), notes
    straggler, retry = notes[0]
    assert straggler.startswith("straggler:5:6") and retry == "retry:1:StragglerTimeout"
    _bitwise(_out(runs, "one-rank", "slow"), base, "straggler")


def test_corrupt_newest_snapshot_is_quarantined_once(runs):
    """A run killed at sweep 10 leaves snapshots 5 and 10; 10's ``v`` is
    damaged: the next call quarantines it once, resumes from 5 on every
    rank and gives the monolithic bits."""
    for rank in range(WORLD):
        assert str(runs["port"]["corrupt"][rank]["kill__raised"]) == "SimulatedFailure"
    newest = str(_out(runs, "corrupt", "corrupt")["newest"])
    assert newest == "step_000010"
    base = _out(runs, "corrupt", "base")
    for rank in range(WORLD):
        got = _out(runs, "corrupt", "rerun", rank)
        _bitwise(got, base, f"rank {rank}")
        assert _notes(got) == (f"checkpoint_skipped:{newest}", "resumed:5"), _notes(got)
    names = list(_out(runs, "corrupt", "ls")["names"])
    assert [n for n in names if n.startswith("corrupt_")] == [f"corrupt_{newest}"]


@pytest.mark.parametrize("where", ["one", "two"])
def test_snapshot_of_four_ranks_resumes_elsewhere(runs, where):
    """The global snapshot of a 4-rank run killed at sweep 10 resumes on one
    device ("one") and on 2 ranks ("two"): the sums run in another order,
    so held to the 4-rank run with the tolerance of the sharded tests."""
    for rank in range(WORLD):
        assert str(runs["port"]["elastic"][rank]["kill__raised"]) == "SimulatedFailure"
    got = _out(runs, "elastic", where)
    assert _notes(got) == ("resumed:10",), _notes(got)
    _hold(got, _out(runs, "elastic", "base"), EMB_RTOL)
    if where == "two":
        _bitwise(_out(runs, "elastic", "two", 1), got, "rank 1 of 2")


@pytest.mark.parametrize("name", list(REORDER))
def test_mesh_reorder_is_the_reference_and_the_one_device_permutation(runs, name):
    """The permutation of the mesh branch (gathered content scores, the
    sharded probe's components) equals the reference's mesh permutation
    and the one-device permutation exactly, and the reordered sharded run
    gives the one-device reordered run's labels."""
    got = _out(runs, name, "r")
    x = torch.from_numpy(runs["feats"]["shuffled"])
    spec = AffinitySpec(**REORDER[name])
    np.testing.assert_array_equal(got["perm"], runs["ref"][name]["perm"])
    np.testing.assert_array_equal(got["perm"], graph_reorder_permutation(x, spec).numpy())
    one = run_gpic(x, K, GPICConfig(affinity=spec, row_reorder=True, max_iter=MAX_ITER),
                   device="cpu")
    np.testing.assert_array_equal(got["labels"], one.labels.numpy())
    assert "row_reorder" in _notes(got)


@pytest.mark.parametrize("case", sorted(
    [f"{e}-r{r}" for e, r in MATRIX] + [f"checkpointed-{e}" for e in ("explicit", "streaming")]
    + ["faults", "faults-clean", "one-rank", "corrupt"] + list(REORDER)))
def test_every_rank_returns_the_same_outputs(runs, case):
    """Every output of the steps all ranks run (not rank 0's file steps)."""
    outs = [{key: v for key, v in out.items() if not key.startswith(RANK0_STEPS)}
            for out in runs["port"][case]]
    assert "raised" not in outs[0], str(outs[0]["raised"])
    for other in outs[1:]:
        assert sorted(other) == sorted(outs[0])
        for field, value in outs[0].items():
            np.testing.assert_array_equal(other[field], value, err_msg=field)
