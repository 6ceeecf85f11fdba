"""The port's LM trainer against the reference's, on the CPU: both packages
start from one state (the reference's weights and AdamW state, carried
across by ``lm_params_from_reference`` and ``adamw_state_from_reference``)
and take the same numpy batches, at the smoke widths, f32 compute. The
port's attention is kernel 12's plain version and its plain backward.

Tolerances, and why:
- the loss: rtol 1e-5 (f32 throughout; the frameworks sum in other orders;
  measured under 3e-7).
- each gradient leaf: atol 1e-5 * max|leaf| (measured under 2.4e-6).
- after 3 AdamW steps, the moments: atol 1e-4 * max|leaf| (measured under
  2e-5); the parameters: atol 1e-4 * max|leaf| + 1e-2 * the steps' summed
  learning rate. Adam divides each gradient element by its own running
  scale, so an element whose gradient is near f32 noise moves by a
  fraction of its step that the two packages' sums set differently: qwen's
  k bias (zero at init, its gradient nearly cancelled by the softmax's
  shift invariance) parts by 1.0e-5, 0.36% of the summed rate.
- lr and grad_norm: rtol 1e-5 (f32 cos, pow and sums of squares).
- gradient compression: one int8 step of a row, on at most 2 elements of a
  leaf (a gradient within f32 noise of a rounding boundary).
- the token stream and the restarted run: bitwise.
"""
import dataclasses
import json
import os
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

from repro import configs as jconfigs
from repro.data.tokens import SyntheticTokenStream as JStream
from repro.models import get_api as jget_api
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro.train.train_step import build_train_step as jbuild_train_step
from repro.train.train_step import loss_fn as jloss_fn
from repro.train.train_step import softmax_xent as jsoftmax_xent
from repro_torch import configs
from repro_torch.data.tokens import SyntheticTokenStream
from repro_torch.interop import adamw_state_from_reference, lm_params_from_reference
from repro_torch.models import get_api
from repro_torch.train import compression, optimizer
from repro_torch.train._tree import leaves
from repro_torch.train.fault_tolerance import FailureInjector, RestartableLoop
from repro_torch.train.train_step import build_train_step, softmax_xent, value_and_grad

B = 2
ARCH_SEQ = {"stablelm-3b": 24, "qwen1.5-4b": 24, "h2o-danube-3-4b": 48}   # danube: window 16


def _tcfg(**kw):
    base = dict(seq_len=24, global_batch=B, compute_dtype="float32", remat="none",
                learning_rate=1e-3, warmup_steps=2, total_steps=10)
    base.update(kw)
    return jconfigs.TrainConfig(**base), configs.TrainConfig(**base)


def _batch(cfg, s, seed=0, b=B):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _pair(arch, n_layers=None):
    jcfg, cfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    if n_layers:
        jcfg, cfg = jcfg.replace(n_layers=n_layers), cfg.replace(n_layers=n_layers)
    jparams = jget_api(jcfg).init_params(jax.random.key(0), jcfg)
    return jcfg, cfg, jparams, lm_params_from_reference(jax.tree.map(np.asarray, jparams), cfg)


def _as_port(tree, cfg):
    return lm_params_from_reference(jax.tree.map(np.asarray, tree), cfg)


def _close_leaves(got, want, rel, extra_atol=0.0):
    for a, b in zip(leaves(got), leaves(want), strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=rel * float(b.abs().max()) + extra_atol)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_softmax_xent_matches_the_reference(z_loss):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 7, 384)) * 3).astype(np.float32)
    labels = rng.integers(0, 384, (2, 7)).astype(np.int32)
    want = float(jsoftmax_xent(jnp.asarray(logits), jnp.asarray(labels), z_loss))
    got = softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels), z_loss)
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("arch", list(ARCH_SEQ))
def test_loss_and_gradients_match_the_reference(arch):
    s = ARCH_SEQ[arch]
    jt, tt = _tcfg(seq_len=s)
    jcfg, cfg, jparams, params = _pair(arch)
    batch = _batch(cfg, s)
    (jl, _), jg = jax.value_and_grad(lambda p, b: jloss_fn(p, jcfg, b, jt), has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = value_and_grad(params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                                 tt)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert all(g is not None for g in leaves(grads))
    _close_leaves(grads, _as_port(jg, cfg), 1e-5)


def _three_steps(arch, **kw):
    s = ARCH_SEQ[arch]
    jt, tt = _tcfg(seq_len=s, **kw)
    jcfg, cfg, jparams, params = _pair(arch)
    jopt_state = jopt.adamw_init(jparams)
    opt_state = adamw_state_from_reference(jax.tree.map(np.asarray, dataclasses.asdict(jopt_state)),
                                           cfg)
    jstep, step = jax.jit(jbuild_train_step(jcfg, jt)), build_train_step(cfg, tt)
    jm, m = [], []
    for i in range(3):
        batch = _batch(cfg, s, seed=i, b=4 if tt.microbatch else B)
        jparams, jopt_state, jmet = jstep(jparams, jopt_state,
                                          {k: jnp.asarray(v) for k, v in batch.items()})
        params, opt_state, met = step(params, opt_state,
                                      {k: torch.from_numpy(v) for k, v in batch.items()})
        jm.append({k: float(v) for k, v in jmet.items()})
        m.append({k: float(v) for k, v in met.items()})
    return cfg, tt, (jparams, jopt_state, jm), (params, opt_state, m)


@pytest.mark.parametrize("arch", list(ARCH_SEQ))
def test_three_steps_match_the_reference(arch):
    cfg, tt, (jparams, jstate, jm), (params, state, m) = _three_steps(arch)
    for got, want in zip(m, jm):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)
    assert int(state.step) == int(jstate.step) == 3 and state.step.dtype == torch.int32
    _close_leaves(state.mu, _as_port(jstate.mu, cfg), 1e-4)
    _close_leaves(state.nu, _as_port(jstate.nu, cfg), 1e-4)
    assert all(t.dtype == torch.float32 for t in leaves(state.mu) + leaves(state.nu))
    lr_sum = sum(r["lr"] for r in jm)
    _close_leaves(params, _as_port(jparams, cfg), 1e-4, extra_atol=1e-2 * lr_sum)


def test_microbatches_match_the_reference():
    """microbatch=2 over a batch of 4: the two slices' gradients summed in
    order and halved, as the reference's scan does."""
    cfg, tt, (jparams, jstate, jm), (params, state, m) = _three_steps("stablelm-3b",
                                                                      microbatch=2)
    for got, want in zip(m, jm):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)
    _close_leaves(state.mu, _as_port(jstate.mu, cfg), 1e-4)
    _close_leaves(params, _as_port(jparams, cfg), 1e-4, extra_atol=1e-2 * sum(r["lr"] for r in jm))


def test_gradient_compression_matches_the_reference():
    """The int8 round trip of one step's gradients: bitwise the reference's
    on the reference's gradients; on the port's own gradients the same int8
    codes but for one step on at most 2 elements a leaf; and three steps
    with compression on match the reference's losses."""
    s = ARCH_SEQ["stablelm-3b"]
    jt, tt = _tcfg(seq_len=s, gradient_compression=True)
    jcfg, cfg, jparams, params = _pair("stablelm-3b")
    batch = _batch(cfg, s)
    _, jg = jax.value_and_grad(lambda p, b: jloss_fn(p, jcfg, b, jt), has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    jdq, jerr = jcomp.compress_decompress(jg)
    # the same gradients in both: bitwise
    dq, err = compression.compress_decompress(_as_port(jg, cfg))
    for a, b in zip(leaves(dq) + leaves(err),
                    leaves(_as_port(jdq, cfg)) + leaves(_as_port(jerr, cfg))):
        assert torch.equal(a, b)
    # the port's own gradients: the same int8 codes but one step on a few elements
    _, grads = value_and_grad(params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()}, tt)
    for g, jgl in zip(leaves(grads), leaves(_as_port(jg, cfg))):
        if g.ndim == 0:
            continue
        q, _ = compression.quantize_int8(g)
        jq, _ = jcomp.quantize_int8(jnp.asarray(jgl.numpy()))
        diff = (q.int() - torch.from_numpy(np.array(jq)).int()).abs()
        assert int(diff.max()) <= 1 and int((diff > 0).sum()) <= 2
    # and a whole step with compression on
    cfg2, tt2, (jparams, jstate, jm), (params, state, m) = _three_steps(
        "stablelm-3b", gradient_compression=True)
    for got, want in zip(m, jm):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)


def test_quantize_rounds_half_to_even_and_error_feedback_matches():
    x = np.array([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0], [3.0, -1.0, 0.0, 0.25, 1e-13, 2.0]],
                 np.float32)
    q, s = compression.quantize_int8(torch.from_numpy(x))
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    g = {"a": torch.from_numpy(x), "b": torch.tensor(3.0)}
    ef = compression.ErrorFeedback.init(g)
    jef = jcomp.ErrorFeedback.init({"a": jnp.asarray(x), "b": jnp.asarray(3.0)})
    for _ in range(2):
        dq, ef = compression.ef_compress(g, ef)
        jdq, jef = jcomp.ef_compress({"a": jnp.asarray(x), "b": jnp.asarray(3.0)}, jef)
        np.testing.assert_array_equal(dq["a"].numpy(), np.asarray(jdq["a"]))
        np.testing.assert_array_equal(ef.residual["a"].numpy(), np.asarray(jef.residual["a"]))
        assert float(dq["b"]) == float(jdq["b"]) == 3.0


def test_lr_schedule_matches_the_reference():
    jt, tt = _tcfg(warmup_steps=5, total_steps=40, learning_rate=3e-4)
    steps = np.arange(0, 45, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: jopt.lr_schedule(s, jt))(jnp.asarray(steps)))
    got = optimizer.lr_schedule(torch.from_numpy(steps), tt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["stablelm-3b", "h2o-danube-3-4b"])
def test_remat_gives_the_values_of_none(arch, remat):
    """remat only chooses what the backward recomputes: the loss and every
    gradient equal remat="none"'s, through kernel 12's autograd Function
    (stablelm) and the windowed plain path (h2o-danube, s = 48 past its
    window of 16)."""
    s = ARCH_SEQ[arch]
    _, cfg, _, params = _pair(arch)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, s).items()}
    l0, g0 = value_and_grad(params, cfg, batch, _tcfg(seq_len=s)[1])
    l1, g1 = value_and_grad(params, cfg, batch, _tcfg(seq_len=s, remat=remat)[1])
    assert torch.equal(l0, l1)
    for a, b in zip(leaves(g0), leaves(g1)):
        assert torch.equal(a, b)


def test_token_stream_is_the_reference_bitwise():
    for vocab, seed, step, b, s in ((384, 0, 0, 2, 16), (50304, 3, 7, 3, 33)):
        got = SyntheticTokenStream(vocab, seed=seed).batch_at(step, b, s)
        want = JStream(vocab, seed=seed).batch_at(step, b, s)
        for key in ("tokens", "labels"):
            assert got[key].dtype == want[key].dtype == np.int32
            np.testing.assert_array_equal(got[key], want[key])


def test_restartable_loop_replays_an_injected_failure_bitwise(tmp_path):
    """The port's train_lm example's loop at a smoke width: a failure
    injected at step 3 with a snapshot every 2 steps restores step 2 and
    replays; every step's loss and the final parameters and AdamW state are
    bitwise those of an uninterrupted run."""
    from repro_torch.launch.train import state_step, token_batches
    from repro_torch.train import adamw_init
    cfg = configs.get_smoke_config("stablelm-3b")
    tt = _tcfg(seq_len=16)[1]

    def run(inject, root):
        params = get_api(cfg).init_params(torch.Generator().manual_seed(0), cfg)
        loop = RestartableLoop(state_step(cfg, tt), token_batches(cfg, B, 16, 0, "cpu"),
                               str(root), ckpt_every=2,
                               injector=FailureInjector([3]) if inject else None)
        state, step, log = loop.run((params, adamw_init(params)), 6)
        return state, step, log, loop

    s0, n0, log0, loop0 = run(False, tmp_path / "plain")
    s1, n1, log1, loop1 = run(True, tmp_path / "restarted")
    assert n0 == n1 == 6 and loop0.restarts == 0 and loop1.restarts == 1
    assert [r["step"] for r in log1] == [0, 1, 2, 2, 3, 4, 5]
    by_step = {r["step"]: r["loss"] for r in log1}
    assert by_step == {r["step"]: r["loss"] for r in log0}
    assert log1[2]["loss"] == log1[3]["loss"]
    from repro_torch.train._tree import named_leaves
    got, want = named_leaves(s1), named_leaves(s0)
    assert got.keys() == want.keys() and "1.mu.layers.2.attn.wq" in got
    assert all(torch.equal(got[k], want[k]) for k in got)
    assert sorted(os.listdir(tmp_path / "restarted")) == [
        "step_000000", "step_000002", "step_000004", "step_000006"]


def test_train_entry_point_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke", "--device", "cpu",
         "--steps", "4", "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
         "--ckpt-every", "2", "--inject-failure-at", "3", "--log-every", "1"],
        capture_output=True, text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("arch=stablelm-3b params=") and lines[0].endswith("batch=2x16")
    assert lines[-1].startswith("done: 4 steps") and "restarts=1" in lines[-1]
    with open(tmp_path / "summary.json") as f:
        summary = json.load(f)
    assert summary["arch"] == "stablelm-3b" and summary["steps"] == 4
    assert summary["restarts"] == 1 and np.isfinite(summary["loss_last"])


def test_tree_helpers_leave_no_reference_cycle():
    """``named_leaves``, ``unflatten`` and ``tree_map`` keep no tensor
    alive past their return: a step's gradients go with its last
    reference, not when Python's cycle collector next runs (recursive
    closures made such cycles, and a full-width step held 11 GB of
    gradients in them)."""
    import gc
    import weakref

    from repro_torch.train._tree import named_leaves, tree_map, unflatten
    tree = {"a": [torch.ones(3), {"b": torch.ones(2)}], "c": (torch.ones(1),)}
    gc.collect()
    gc.disable()
    try:
        grads = tree_map(torch.zeros_like, tree)
        named = named_leaves(grads)
        again = unflatten(tree, list(named.values()))
        refs = [weakref.ref(t) for t in named.values()]
        del grads, named, again
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
