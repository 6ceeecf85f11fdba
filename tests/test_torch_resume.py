"""Resumable execution in the port, on the CPU: the twins of
``tests/test_resume.py``'s single-device classes.

The guarantee: a segment boundary moves only where the power loop stops,
never what a sweep computes, so a run interrupted at any sweep and resumed
from its snapshot is bitwise the uninterrupted run (labels, embeddings,
per-column sweep counts and convergence, health), on every engine and on
the block-sparse route. Around it: snapshots with a checksum per leaf,
quarantined when corrupt with a fall back to the previous valid one; the
straggler watchdog's typed error; concurrent-fault schedules classified
by the robustness contract; the restore onto a process group (a 1-rank
gloo group here; 4 ranks in ``test_torch_distributed_supervisor.py``,
with the ring fault). The reference's kernel-fallback cases have no
counterpart in the port (it has no fallback). Last, the port's supervised
run against the reference's, both resumed after the same injected fault.
"""
from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one torch thread a process: the test run starts several processes at once,
# and torch using every core in each of them slows all of them down
torch.set_num_threads(1)

import repro.core as jcore
from repro.train.fault_tolerance import FailureInjector as RefFailureInjector
from repro_torch import AffinitySpec, GPICConfig, adjusted_rand_index, dataset_by_name, run_gpic
from repro_torch.core.health import (CheckpointCorruptError, StragglerTimeout,
                                     is_recovery_note)
from repro_torch.core.power import PowerCarry, init_power_carry, power_carry_like
from repro_torch.data.synthetic import gaussians
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault_tolerance import (ClusteringFaultHarness, FailureInjector,
                                               FaultSchedule, SimulatedFailure,
                                               apply_feature_faults, inject_nan_features,
                                               run_schedule)
from test_torch_pipeline import one_rank_group  # noqa: F401 - the fixture

E1 = AffinitySpec(kind="rbf", sigma=0.3, knn_k=10)


def _blobs(n=96, k=3, seed=0):
    return gaussians(n, k=k, seed=seed)[0]


def _run(x, k, cfg, **kw):
    return run_gpic(x, k, cfg, device="cpu", **kw)


def _fields(res):
    return tuple(getattr(res, name) for name in (
        "labels", "embeddings", "n_iter_cols", "converged_cols")) + (
        res.health.col_status, res.health.isolated_rows, res.health.n_components,
        res.health.components)


def _assert_bitwise(a, b, ctx=""):
    names = ("labels", "embeddings", "n_iter_cols", "converged_cols", "col_status",
             "isolated_rows", "n_components", "components")
    for name, fa, fb in zip(names, _fields(a), _fields(b)):
        assert torch.equal(fa, fb), f"{ctx}: {name} differs"


# ---------------------------------------------------------------------------
# Local: checkpointed / interrupted / resumed runs are bitwise the plain run
# ---------------------------------------------------------------------------


class TestLocalResumeParity:
    #: (engine, embedding, r, affinity spec or None, n): the reference's four
    #: cases, then E1 on the block-sparse route of each engine (n > 256)
    CASES = [
        ("explicit", "pic", 1, None, 96),
        ("explicit", "ensemble", 2, None, 96),
        ("streaming", "orthogonal", 4, None, 96),
        ("matrix_free", "pic", 2, None, 96),
        ("explicit", "orthogonal", 2, E1, 300),
        ("streaming", "orthogonal", 2, E1, 300),
    ]
    IDS = ["explicit-pic", "explicit-ensemble", "streaming-orthogonal", "matrix_free-pic",
           "explicit-E1-block_sparse", "streaming-E1-block_sparse"]

    @staticmethod
    def _case(engine, embedding, r, spec, n):
        return _blobs(n), GPICConfig(engine=engine, embedding=embedding, n_vectors=r,
                                     affinity=spec, max_iter=30)

    @pytest.mark.parametrize("case", CASES, ids=IDS)
    def test_checkpointed_equals_plain(self, tmp_path, case):
        x, cfg = self._case(*case)
        base = _run(x, 3, cfg)
        sup = _run(x, 3, cfg.with_(checkpoint_every=7, ckpt_dir=str(tmp_path / "ck")))
        _assert_bitwise(base, sup, str(case))
        assert sup.health.notes == ()  # an undisturbed run leaves no trace

    @pytest.mark.parametrize("case", CASES, ids=IDS)
    def test_interrupted_and_resumed_is_bitwise(self, tmp_path, case):
        x, cfg = self._case(*case)
        base = _run(x, 3, cfg)
        inj = FailureInjector(fail_at_steps=(7,))
        res = _run(x, 3, cfg.with_(checkpoint_every=7, ckpt_dir=str(tmp_path / "ck")),
                   segment_injector=inj.maybe_fail)
        _assert_bitwise(base, res, str(case))
        assert "retry:1:SimulatedFailure" in res.health.notes
        assert "resumed:7" in res.health.notes
        assert all(is_recovery_note(n) for n in res.health.notes)

    def test_kill_then_fresh_call_resumes(self, tmp_path):
        """A run that exhausts its retries leaves snapshots on disk; the next
        call with the same ckpt_dir resumes instead of restarting, bitwise.
        eps_scale=1e-7 keeps the run alive past the sweep-10 boundary."""
        x = _blobs()
        cfg = GPICConfig(max_iter=30, eps_scale=1e-7, checkpoint_every=5,
                         ckpt_dir=str(tmp_path / "ck"), max_retries=0)
        inj = FailureInjector(fail_at_steps=(10,))
        with pytest.raises(SimulatedFailure):
            _run(x, 3, cfg, segment_injector=inj.maybe_fail)
        res = _run(x, 3, cfg)
        base = _run(x, 3, GPICConfig(max_iter=30, eps_scale=1e-7))
        _assert_bitwise(base, res, "kill+rerun")
        assert "resumed:10" in res.health.notes

    def test_corrupt_snapshot_skips_to_previous_valid(self, tmp_path):
        """Bytes flipped in the newest snapshot's ``v`` leaf trip its
        checksum: the snapshot is quarantined (kept on disk), the run
        resumes from the previous one and still gives the baseline's bits."""
        x = _blobs()
        root = str(tmp_path / "ck")
        cfg = GPICConfig(max_iter=30, eps_scale=1e-7, checkpoint_every=5, ckpt_dir=root,
                         max_retries=0)
        inj = FailureInjector(fail_at_steps=(10,))
        with pytest.raises(SimulatedFailure):
            _run(x, 3, cfg, segment_injector=inj.maybe_fail)
        newest = sorted(d for d in os.listdir(root) if d.startswith("step_"))[-1]
        leaf = os.path.join(root, newest, "v.npy")
        raw = bytearray(open(leaf, "rb").read())
        raw[-32:] = b"\xff" * 32
        open(leaf, "wb").write(bytes(raw))
        res = _run(x, 3, cfg)
        base = _run(x, 3, GPICConfig(max_iter=30, eps_scale=1e-7))
        _assert_bitwise(base, res, "corrupt-skip")
        assert f"checkpoint_skipped:{newest}" in res.health.notes
        assert "resumed:5" in res.health.notes
        assert os.path.isdir(os.path.join(root, "corrupt_" + newest))

    def test_every_interrupt_sweep_is_bitwise(self, tmp_path):
        """A snapshot every sweep, interrupted at 1, mid and last - 1:
        parity at any boundary, not only at a coarse cadence."""
        x = _blobs()
        base_cfg = GPICConfig(max_iter=30)
        base = _run(x, 3, base_cfg)
        t_final = int(base.n_iter_cols.max())
        assert t_final > 3
        for s in (1, t_final // 2, t_final - 1):
            inj = FailureInjector(fail_at_steps=(s,))
            res = _run(x, 3, base_cfg.with_(checkpoint_every=1, ckpt_dir=str(tmp_path / f"{s}")),
                       segment_injector=inj.maybe_fail)
            _assert_bitwise(base, res, f"interrupt@{s}")
            assert f"resumed:{s}" in res.health.notes

    def test_straggler_timeout_is_typed_and_retried(self):
        with pytest.raises(StragglerTimeout):
            _run(_blobs(), 3, GPICConfig(max_iter=30, straggler_timeout=1e-9, max_retries=2))

    def test_straggler_timeout_with_headroom_passes(self):
        res = _run(_blobs(), 3, GPICConfig(max_iter=30, straggler_timeout=600.0))
        assert res.health.notes == ()

    def test_supervised_segments_reuse_rng_stream(self, tmp_path):
        """Same seed, different cadences, and a resume: identical results —
        the carry's round trip leaves the start columns' and the k-means
        draws where the uninterrupted run has them."""
        x = _blobs()
        cfg = GPICConfig(max_iter=30, n_vectors=3, embedding="orthogonal", seed=11)
        a = _run(x, 3, cfg.with_(checkpoint_every=3, ckpt_dir=str(tmp_path / "a")))
        b = _run(x, 3, cfg.with_(checkpoint_every=13, ckpt_dir=str(tmp_path / "b")))
        inj = FailureInjector(fail_at_steps=(6,))
        c = _run(x, 3, cfg.with_(checkpoint_every=3, ckpt_dir=str(tmp_path / "c")),
                 segment_injector=inj.maybe_fail)
        _assert_bitwise(a, b, "cadence-invariance")
        _assert_bitwise(a, c, "resumed")
        _assert_bitwise(a, _run(x, 3, cfg), "monolithic")


# ---------------------------------------------------------------------------
# Supervisor config contract
# ---------------------------------------------------------------------------


class TestSupervisorConfig:
    def test_checkpoint_fields_come_as_a_pair(self, tmp_path):
        with pytest.raises(ValueError, match="pair"):
            _run(_blobs(), 3, GPICConfig(checkpoint_every=5))
        with pytest.raises(ValueError, match="pair"):
            _run(_blobs(), 3, GPICConfig(ckpt_dir=str(tmp_path)))

    def test_checkpoint_every_must_be_positive(self, tmp_path):
        with pytest.raises(ValueError, match="checkpoint_every"):
            _run(_blobs(), 3, GPICConfig(checkpoint_every=0, ckpt_dir=str(tmp_path)))

    def test_straggler_timeout_must_be_positive(self):
        with pytest.raises(ValueError, match="straggler_timeout"):
            _run(_blobs(), 3, GPICConfig(straggler_timeout=0.0))

    def test_backoff_and_retries_validated(self):
        with pytest.raises(ValueError, match="max_retries"):
            _run(_blobs(), 3, GPICConfig(max_retries=-1))
        with pytest.raises(ValueError, match="backoff"):
            _run(_blobs(), 3, GPICConfig(backoff=-0.5))

    @pytest.mark.parametrize("field,value", [
        ("checkpoint_every", 0), ("max_retries", -1), ("backoff", -0.5),
        ("straggler_timeout", 0.0)])
    def test_value_errors_match_the_reference(self, tmp_path, field, value):
        """The same class and message in both packages."""
        kw = {field: value}
        if field == "checkpoint_every":
            kw["ckpt_dir"] = str(tmp_path)
        x = _blobs()
        with pytest.raises(ValueError) as ref_err:
            jcore.run_gpic(jnp.asarray(x), 3, jcore.GPICConfig(use_pallas=False, **kw))
        with pytest.raises(ValueError) as port_err:
            _run(x, 3, GPICConfig(**kw))
        assert str(port_err.value) == str(ref_err.value)


# ---------------------------------------------------------------------------
# Snapshots (train/checkpoint.py)
# ---------------------------------------------------------------------------


def _carry(n=16, r=2, s=3):
    g = torch.Generator().manual_seed(0)
    carry = init_power_carry(torch.rand((n, r), generator=g), s)
    return carry


class TestCheckpoint:
    def test_round_trip_is_exact(self, tmp_path):
        """Every leaf by name, in its dtype and shape, with the step and the
        extra dict; a dict with a bf16 leaf too."""
        carry = _carry()
        path = str(tmp_path / "step_000004")
        ckpt.save(path, carry, step=4, extra={"isolated_rows": 2})
        back, step = ckpt.restore(path, power_carry_like(16, 2, 3))
        assert step == 4 and ckpt.manifest_extra(path) == {"isolated_rows": 2}
        for name in (f.name for f in dataclasses.fields(PowerCarry)):
            assert torch.equal(getattr(back, name), getattr(carry, name)), name
            assert getattr(back, name).dtype == getattr(carry, name).dtype
        tree = {"a": torch.rand((5, 7)).to(torch.bfloat16), "b": torch.arange(3)}
        ckpt.save(str(tmp_path / "step_000001"), tree, step=1)
        got, _ = ckpt.restore(str(tmp_path / "step_000001"),
                              {name: t.to("meta") for name, t in tree.items()})
        assert torch.equal(got["a"], tree["a"]) and got["a"].dtype == torch.bfloat16
        assert torch.equal(got["b"], tree["b"])

    def test_async_saver_writes_the_snapshot_taken(self, tmp_path):
        """The leaves are copied when save_async is called: changing the
        tensor afterwards does not reach the file."""
        tree = {"v": torch.ones(4)}
        saver = ckpt.AsyncCheckpointer()
        saver.save_async(str(tmp_path / "step_000001"), tree, step=1)
        tree["v"].add_(1.0)
        saver.wait()
        got, _ = ckpt.restore(str(tmp_path / "step_000001"), {"v": torch.empty(4, device="meta")})
        assert torch.equal(got["v"], torch.ones(4))

    @pytest.mark.parametrize("damage", ["crc", "truncated", "missing_leaf", "manifest",
                                        "shape"])
    def test_corruption_is_typed(self, tmp_path, damage):
        carry = _carry()
        path = str(tmp_path / "step_000004")
        ckpt.save(path, carry, step=4)
        leaf = os.path.join(path, "delta.npy")
        like = power_carry_like(16, 2, 3)
        if damage == "crc":
            raw = bytearray(open(leaf, "rb").read())
            raw[-8:] = b"\x00\x01" * 4
            open(leaf, "wb").write(bytes(raw))
        elif damage == "truncated":
            raw = open(leaf, "rb").read()
            open(leaf, "wb").write(raw[:len(raw) // 2])
        elif damage == "missing_leaf":
            os.remove(leaf)
        elif damage == "manifest":
            open(os.path.join(path, "manifest.json"), "w").write("{not json")
        else:
            like = power_carry_like(16, 3, 3)
        with pytest.raises(CheckpointCorruptError):
            ckpt.restore(path, like)

    def test_restore_latest_valid_quarantines_and_falls_back(self, tmp_path):
        root = str(tmp_path)
        for step in (3, 6, 9):
            carry = _carry()
            ckpt.save(os.path.join(root, f"step_{step:06d}"), carry, step=step)
        ckpt.save(os.path.join(root, "step_000012.tmp"), _carry(), step=12)  # a save that died
        for step in (9, 6):
            leaf = os.path.join(root, f"step_{step:06d}", "v.npy")
            raw = bytearray(open(leaf, "rb").read())
            raw[-4:] = b"\xff" * 4
            open(leaf, "wb").write(bytes(raw))
        tree, step, path, skipped = ckpt.restore_latest_valid(root, power_carry_like(16, 2, 3))
        assert step == 3 and path.endswith("step_000003")
        assert [os.path.basename(p) for p in skipped] == ["step_000009", "step_000006"]
        assert sorted(os.listdir(root)) == ["corrupt_step_000006", "corrupt_step_000009",
                                            "step_000003", "step_000012.tmp"]
        assert ckpt.latest_step(root).endswith("step_000003")
        assert ckpt.restore_latest_valid(str(tmp_path / "none"), power_carry_like(16, 2, 3)) \
            == (None, None, None, [])


class TestCheckpointOnAGroup:
    """The restore onto a process group, on a gloo group of this process
    alone: a snapshot is the global carry in the one-device layout."""

    CFG = GPICConfig(affinity_kind="rbf", sigma=0.3, max_iter=30, eps_scale=1e-7,
                     checkpoint_every=5)

    def test_one_rank_snapshot_is_byte_identical_to_one_device(self, one_rank_group, tmp_path):
        """The same supervised run on one device and on a 1-rank group
        writes the same files, byte for byte (the row leaves gathered)."""
        x = _blobs()
        _run(x, 3, self.CFG.with_(ckpt_dir=str(tmp_path / "one")))
        _run(x, 3, self.CFG.with_(ckpt_dir=str(tmp_path / "group"), mesh=one_rank_group))
        steps = sorted(os.listdir(tmp_path / "one"))
        assert steps == sorted(os.listdir(tmp_path / "group")) and len(steps) >= 2
        for step in steps:
            names = sorted(os.listdir(tmp_path / "one" / step))
            assert names == sorted(os.listdir(tmp_path / "group" / step))
            for name in names:
                assert (tmp_path / "one" / step / name).read_bytes() == \
                    (tmp_path / "group" / step / name).read_bytes(), (step, name)

    def test_one_device_snapshot_restores_onto_the_group(self, one_rank_group, tmp_path):
        """restore_latest_valid with the group gives the one-device restore's
        tree, step and path; a one-device run killed at sweep 10 resumes on
        the group, bitwise the uninterrupted run."""
        from repro_torch.core.distributed import CARRY_ROW_LEAVES
        x, root = _blobs(), str(tmp_path / "ck")
        cfg = self.CFG.with_(ckpt_dir=root, max_retries=0)
        with pytest.raises(SimulatedFailure):
            _run(x, 3, cfg, segment_injector=FailureInjector(fail_at_steps=(10,)).maybe_fail)
        like = power_carry_like(96, 1)
        one = ckpt.restore_latest_valid(root, like)
        got = ckpt.restore_latest_valid(root, like, group=one_rank_group,
                                        row_leaves=CARRY_ROW_LEAVES)
        assert got[1:] == one[1:] and one[1] == 10
        for name in (f.name for f in dataclasses.fields(PowerCarry)):
            assert torch.equal(getattr(got[0], name), getattr(one[0], name)), name
        assert ckpt.manifest_extra(one[2], group=one_rank_group) == ckpt.manifest_extra(one[2])
        res = _run(x, 3, cfg.with_(mesh=one_rank_group))
        assert res.health.notes == ("resumed:10",)
        _assert_bitwise(_run(x, 3, GPICConfig(affinity_kind="rbf", sigma=0.3, max_iter=30,
                                              eps_scale=1e-7)), res, "one device -> group")

    def test_wrong_shape_on_the_group_is_typed(self, one_rank_group, tmp_path):
        path = str(tmp_path / "step_000004")
        ckpt.save(path, _carry(), step=4)
        with pytest.raises(CheckpointCorruptError, match="shape"):
            ckpt.restore(path, power_carry_like(16, 3, 3), group=one_rank_group,
                         row_leaves=("v", "delta", "snaps"))


# ---------------------------------------------------------------------------
# Concurrent-fault schedules (the local half of the reference's matrix)
# ---------------------------------------------------------------------------


class TestConcurrentFaults:
    def test_transient_failures_recover_clean(self, tmp_path):
        """Only transient faults (injected sweep failures): clean arrays,
        'recovered', distinct from 'degraded'."""
        rec = run_schedule(
            _blobs(), 3, FaultSchedule(fail_sweeps=(5, 10)),
            GPICConfig(max_iter=30, eps_scale=1e-7, checkpoint_every=5,
                       ckpt_dir=str(tmp_path / "ck")), device="cpu")
        assert rec["status"] == "recovered", rec
        assert any(n.startswith("resumed:") for n in rec["notes"])
        assert sum(n.startswith("retry:") for n in rec["notes"]) == 2
        assert rec["health"]["status"] == "recovered"

    def test_multi_fault_run_degrades_not_crashes(self, tmp_path):
        """An isolated row and injected sweep failures in one run: the
        supervisor absorbs the transients (its history in the notes) and
        reports the permanent damage as 'degraded'."""
        rec = run_schedule(
            _blobs(), 3, FaultSchedule(isolate_rows=(95,), fail_sweeps=(5,)),
            GPICConfig(affinity=AffinitySpec(kind="rbf", sigma=0.5), max_iter=30,
                       checkpoint_every=5, ckpt_dir=str(tmp_path / "ck")), device="cpu")
        assert rec["status"] == "degraded", rec
        assert rec["health"]["isolated_rows"] >= 1
        assert any(n.startswith("retry:") for n in rec["notes"])

    def test_nan_rows_are_the_typed_front_door_error(self):
        rec = run_schedule(_blobs(), 3, FaultSchedule(nan_rows=(2,)),
                           GPICConfig(straggler_timeout=600.0), device="cpu")
        assert rec["status"] == "typed_error" and rec["error"] == "NonFiniteInputError"

    def test_apply_feature_faults_composes(self):
        x = apply_feature_faults(np.zeros((8, 2), np.float32),
                                 FaultSchedule(nan_rows=(1,), isolate_rows=(4,)))
        assert not np.isfinite(x[1]).any()
        assert (x[4] == 60.0).all() and (x[0] == 0.0).all()
        t = apply_feature_faults(torch.zeros((8, 2)), FaultSchedule(nan_rows=(1,)))
        assert not bool(torch.isfinite(t[1]).any()) and bool((t[0] == 0).all())

    def test_health_to_dict_and_summary(self):
        res = _run(_blobs(), 3, GPICConfig(max_iter=30))
        d = res.health.to_dict()
        assert d["status"] == "ok" and d["bad_columns"] == 0 and d["recovery"] == []
        s = res.health.summary()
        assert isinstance(s, str) and "status=ok" in s

    def test_fault_harness_classifies_trials(self):
        h = ClusteringFaultHarness(fail_at_trials=(1,))
        cfg = GPICConfig(affinity_kind="rbf", sigma=0.3, max_iter=30)
        outcomes = [h.run_trial(t, _blobs(), 3, cfg, device="cpu")["status"] for t in range(3)]
        assert outcomes == ["ok", "typed_error", "ok"]
        assert h.summary()["counts"] == {"ok": 2, "typed_error": 1}
        bad = inject_nan_features(_blobs(), [0, 5])
        assert np.isnan(bad[[0, 5]]).all() and np.isfinite(np.delete(bad, [0, 5], 0)).all()


# ---------------------------------------------------------------------------
# The port's supervised run against the reference's
# ---------------------------------------------------------------------------


def test_supervised_labels_match_the_reference(tmp_path):
    """Both packages, snapshots every 5 sweeps and a failure injected at
    sweep 10, on gaussians (rbf 0.3, k = 4, r = 1, where k-means from
    either package's seeds finds the same partition): the same partition
    (ARI 1.0 between them), column 0's sweeps within one (ROADMAP
    "eps-crossings"), the same recovery notes and health."""
    x, _, k = dataset_by_name("gaussians", 200, seed=0)
    fields = dict(affinity_kind="rbf", sigma=0.3, max_iter=60, checkpoint_every=5)
    ref = jcore.run_gpic(jnp.asarray(x), k,
                         jcore.GPICConfig(use_pallas=False, ckpt_dir=str(tmp_path / "ref"),
                                          **fields),
                         key=jax.random.key(0),
                         segment_injector=RefFailureInjector(fail_at_steps=(10,)).maybe_fail)
    res = _run(x, k, GPICConfig(ckpt_dir=str(tmp_path / "port"), **fields),
               segment_injector=FailureInjector(fail_at_steps=(10,)).maybe_fail)
    assert adjusted_rand_index(np.asarray(ref.labels), res.labels.numpy()) == 1.0
    assert abs(int(res.n_iter) - int(np.asarray(ref.n_iter_cols)[0])) <= 1
    assert res.converged_cols.tolist() == np.asarray(ref.converged_cols).tolist()
    assert res.health.notes == ref.health.notes == ("retry:1:SimulatedFailure", "resumed:10")
    assert res.health.to_dict() == ref.health.to_dict()
