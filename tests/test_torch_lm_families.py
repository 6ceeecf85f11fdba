"""The ssm, hybrid, encdec and vlm families of the port against the
reference, on the CPU: mamba2-780m, zamba2-2.7b, seamless-m4t-large-v2 and
paligemma-3b at their smoke widths, on the reference's weights (carried
across by ``lm_params_from_reference``) and the same numpy tokens and stub
embeddings. The port's attention is kernel 12's plain version where it
computes kernel 12's function, and its plain backward when differentiated.

Tolerances, and why:
- ``ssd_chunked``: y and the final state within 1e-5 of their max. The
  reference joins the chunk states with an associative scan (a tree), the
  port with a loop in chunk order: the same terms summed in another order.
- ``forward`` at f32 compute: 1e-4 of max|logits| (f32 throughout, sums in
  other orders; measured under 2e-6).
- ``prefill`` logits and every cache leaf at ``cache_dtype=float32``, then
  8 ``decode_step``s fed the reference's greedy tokens: each step's logits
  within 1e-4 of max|logits|, each cache leaf within 1e-4 of its max.
- the same with each family's default caches (bf16 attention caches; the
  SSM states f32): the LM rule of ``test_torch_lm_serve.py``, 2e-2 of
  max|logits|, and the port's greedy token the reference's wherever the
  reference's top-2 margin is past that tolerance.
- prefill then decode against a full forward, in the port, f32 cache:
  atol 2e-3, rtol 1e-3, the reference's own test's.
- cross-attention: 1e-5 of max|out| (one layer, f32).
- loss and gradients (f32, ``remat="none"``): the loss within rtol 1e-5,
  each gradient leaf within 1e-4 of its max|leaf|.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one torch thread a process: the test run starts several processes at once,
# and torch using every core in each of them slows all of them down
torch.set_num_threads(1)

from repro import configs as jconfigs
from repro.models import get_api as jget_api
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.train.train_step import loss_fn as jloss_fn
from repro_torch import configs
from repro_torch.interop import lm_params_from_reference
from repro_torch.kernels import ops
from repro_torch.models import get_api
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.train._tree import named_leaves
from repro_torch.train.train_step import value_and_grad

ARCHS = ["mamba2-780m", "zamba2-2.7b", "seamless-m4t-large-v2", "paligemma-3b"]
B, S, GEN = 2, 20, 8            # S past one smoke chunk (16): the SSD pads
LOGIT_RTOL = 2e-2
F32_REL = 1e-4


def _numpy_batch(cfg, s, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["src_embeds"] = (rng.standard_normal((B, s, cfg.d_model)) * 0.02
                               ).astype(np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = (rng.standard_normal((B, cfg.n_prefix_tokens, cfg.d_model))
                                 * 0.02).astype(np.float32)
    return batch


def _j(batch, drop=("labels",)):
    return {k: jnp.asarray(v) for k, v in batch.items() if k not in drop}


def _t(batch, drop=("labels",)):
    return {k: torch.from_numpy(v) for k, v in batch.items() if k not in drop}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg, cfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    jparams = jax.jit(lambda key: jget_api(jcfg).init_params(key, jcfg))(jax.random.key(0))
    params = lm_params_from_reference(jax.tree.map(np.asarray, jparams), cfg)
    return dict(arch=arch, jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                batch=_numpy_batch(cfg, S), runs={})


def _max_len(cfg):
    return S + GEN + (cfg.n_prefix_tokens or 0)


def _first_pos(cfg):
    return S + (cfg.n_prefix_tokens if cfg.family == "vlm" else 0)


def _ref_run(pair, cache_dtype):
    """The reference's prefill (``cache_dtype`` None: the family's
    default) and GEN - 1 decode steps fed its own greedy tokens: (the
    prefill's logits and cache, each step's logits, the greedy tokens, the
    final cache), cached on the pair. ssm's default cache is f32, so its
    default run is its f32 run."""
    if cache_dtype is None and pair["cfg"].family == "ssm":
        cache_dtype = "float32"
    key = str(cache_dtype)
    if key in pair["runs"]:
        return pair["runs"][key]
    jcfg, jparams = pair["jcfg"], pair["jparams"]
    api = jget_api(jcfg)
    kw = dict(compute_dtype=jnp.float32)
    if cache_dtype is not None:
        kw["cache_dtype"] = getattr(jnp, cache_dtype)
    out = jax.jit(lambda p, b: api.prefill(p, jcfg, b, _max_len(jcfg), **kw))(
        jparams, _j(pair["batch"]))
    logits, cache = out[0], out[1]
    extras = {"enc_out": out[2]} if jcfg.family == "encdec" else None
    step = jax.jit(lambda p, t, c, pos, e: api.decode_step(p, jcfg, t, c, pos, e,
                                                           compute_dtype=jnp.float32))
    prefill = (np.asarray(logits), jax.tree.map(np.asarray, cache))
    tok = jnp.argmax(logits[:, -1, :jcfg.vocab_size], axis=-1).astype(jnp.int32)[:, None]
    toks, steps = [np.asarray(tok)], []
    for i in range(GEN - 1):
        lg, cache = step(jparams, tok, cache, jnp.int32(_first_pos(jcfg) + i), extras)
        steps.append(np.asarray(lg))
        tok = jnp.argmax(lg[:, -1, :jcfg.vocab_size], axis=-1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
    run = dict(prefill=prefill, steps=steps, tokens=np.concatenate(toks, axis=1),
               cache=jax.tree.map(np.asarray, cache))
    pair["runs"][key] = run
    return run


def _port_run(pair, cache_dtype, tokens):
    """The port's prefill and GEN - 1 decode steps fed ``tokens`` (the
    reference's greedy ones): (prefill logits, prefill cache leaves as f32
    numpy, each step's logits, the final cache leaves, the cache leaves'
    types)."""
    cfg, params = pair["cfg"], pair["params"]
    api = get_api(cfg)
    kw = dict(compute_dtype=torch.float32)
    if cache_dtype is not None:
        kw["cache_dtype"] = getattr(torch, cache_dtype)
    out = api.prefill(params, cfg, _t(pair["batch"]), _max_len(cfg), **kw)
    logits, cache = out[0], out[1]
    extras = {"enc_out": out[2]} if cfg.family == "encdec" else None
    first = _leaves(cache)
    types = {name: str(t.dtype).replace("torch.", "") for name, t in named_leaves(cache).items()}
    steps = []
    for i in range(GEN - 1):
        tok = torch.from_numpy(tokens[:, i:i + 1])
        lg, cache2 = api.decode_step(params, cfg, tok, cache, _first_pos(cfg) + i, extras,
                                     compute_dtype=torch.float32)
        assert cache2 is cache                         # updated in place
        steps.append(lg.numpy())
    return logits.numpy(), first, steps, _leaves(cache), types


def _leaves(cache):
    return {name: t.float().numpy().copy() for name, t in named_leaves(cache).items()}


def _ref_leaves(cache, as_f32=True):
    flat = jax.tree_util.tree_flatten_with_path(cache)[0]
    return {".".join(str(k.key) for k in path): np.asarray(a, np.float32) if as_f32 else a
            for path, a in flat}


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# the SSD and cross-attention alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [8, 16, 37])
def test_ssd_chunked_matches_the_reference(s):
    """Below, at, and padded past the chunk of 16."""
    rng = np.random.default_rng(s)
    b, h, p, n = 2, 4, 8, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)   # softplus
    a = -np.exp(np.log(np.arange(1, h + 1))).astype(np.float32)
    bb = rng.standard_normal((b, s, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, n)).astype(np.float32)
    want_y, want_st = jax.jit(functools.partial(jssm.ssd_chunked, chunk=16))(
        *map(jnp.asarray, (x, dt, a, bb, cc)))
    y, st = ssm.ssd_chunked(*map(torch.from_numpy, (x, dt, a, bb, cc)), chunk=16)
    assert tuple(y.shape) == (b, s, h, p) and tuple(st.shape) == (b, h, p, n)
    _close(y.numpy(), want_y, 1e-5)
    _close(st.numpy(), want_st, 1e-5)


@pytest.mark.parametrize("s_kv", [11, 7], ids=["equal", "unequal"])
def test_cross_attention_matches_the_reference(s_kv, monkeypatch):
    """seamless's cross-attention, one layer at f32: K and V from x_kv, no
    RoPE, no mask. Over as many keys as queries it is kernel 12's full
    function (``ops.flash_attention``, ``causal=False``); otherwise the
    plain path."""
    jcfg = jconfigs.get_smoke_config("seamless-m4t-large-v2")
    cfg = configs.get_smoke_config("seamless-m4t-large-v2")
    jp = jlayers.init_attention(jax.random.key(3), jcfg)
    p = {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((2, s_kv, cfg.d_model)).astype(np.float32)
    want, _ = jax.jit(lambda x, p, src: jlayers.attention(x, p, jcfg, x_kv=src, rope=False))(
        jnp.asarray(x), jp, jnp.asarray(src))
    calls = _spy(monkeypatch)
    got, cache = L.attention(torch.from_numpy(x), p, cfg, x_kv=torch.from_numpy(src),
                             rope=False)
    assert cache is None
    assert calls == ([False] if s_kv == 11 else [])
    _close(got.numpy(), want, 1e-5)


def test_cross_attention_takes_no_cache():
    cfg = configs.get_smoke_config("seamless-m4t-large-v2")
    params = get_api(cfg).init_params(torch.Generator().manual_seed(0), cfg)
    x = torch.zeros((1, 4, cfg.d_model))
    cache = L.init_attention_cache(cfg, 1, 8)
    with pytest.raises(ValueError, match="takes no cache"):
        L.attention(x, params["dec_layers"][0]["cross_attn"], cfg, x_kv=x, rope=False,
                    cache=cache, cache_pos=0)


# ---------------------------------------------------------------------------
# each family against the reference
# ---------------------------------------------------------------------------


def test_forward_matches_the_reference_at_f32(pair):
    jcfg, cfg = pair["jcfg"], pair["cfg"]
    want = np.asarray(jax.jit(lambda p, b: jget_api(jcfg).forward(
        p, jcfg, b, compute_dtype=jnp.float32))(pair["jparams"], _j(pair["batch"])))
    got = get_api(cfg).forward(pair["params"], cfg, _t(pair["batch"]),
                               compute_dtype=torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, cfg.vocab_padded)
    _close(got.numpy(), want, F32_REL)


def test_prefill_caches_and_decode_match_the_reference_at_f32(pair):
    ref = _ref_run(pair, "float32")
    logits, first, steps, last, _ = _port_run(pair, "float32", ref["tokens"])
    scale = np.abs(ref["prefill"][0]).max()
    np.testing.assert_allclose(logits, ref["prefill"][0], rtol=0, atol=F32_REL * scale)
    for got_cache, want_cache in ((first, ref["prefill"][1]), (last, ref["cache"])):
        want = _ref_leaves(want_cache)
        assert sorted(got_cache) == sorted(want)
        for name, w in want.items():
            _close(got_cache[name], w, F32_REL)
    for got, want in zip(steps, ref["steps"], strict=True):
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_REL * np.abs(want).max())


def test_default_caches_match_the_reference(pair):
    """The families' default caches (bf16 attention caches, f32 SSM
    states) through prefill and the decode steps, under the LM rule."""
    ref = _ref_run(pair, None)
    logits, _, steps, _, types = _port_run(pair, None, ref["tokens"])
    assert types == {name: str(a.dtype) for name, a in _ref_leaves(ref["prefill"][1],
                                                                   as_f32=False).items()}
    cfg = pair["cfg"]
    vocab = cfg.vocab_size
    all_logits = [logits] + steps
    want_logits = [ref["prefill"][0]] + ref["steps"]
    compared = 0
    for i, (got, want) in enumerate(zip(all_logits, want_logits, strict=True)):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_RTOL * scale)
        last_w = want[:, -1, :vocab]
        top2 = np.sort(last_w, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > LOGIT_RTOL * scale
        same = got[:, -1, :vocab].argmax(-1) == ref["tokens"][:, i]
        assert (same | ~clear).all(), f"greedy token differs past a near-tie at step {i}"
        compared += int(clear.sum())
    assert compared > 0


def test_prefill_then_decode_matches_full_forward(pair):
    """The reference's own serving test (tests/test_serving.py), in the
    port: the next-token logits of prefill over 16 tokens and one decode
    step equal a full forward over 17, f32 cache."""
    cfg, params = pair["cfg"], pair["params"]
    api = get_api(cfg)
    batch = _t(_numpy_batch(cfg, 17, seed=1))
    full = api.forward(params, cfg, batch, compute_dtype=torch.float32)
    batch16 = dict(batch, tokens=batch["tokens"][:, :16])   # the same source frames
    out = api.prefill(params, cfg, batch16, 32 + (cfg.n_prefix_tokens or 0),
                      compute_dtype=torch.float32, cache_dtype=torch.float32)
    extras = {"enc_out": out[2]} if cfg.family == "encdec" else None
    pos = 16 + (cfg.n_prefix_tokens if cfg.family == "vlm" else 0)
    step_logits, _ = api.decode_step(params, cfg, batch["tokens"][:, 16:17], out[1], pos,
                                     extras, compute_dtype=torch.float32)
    np.testing.assert_allclose(full[:, 16].numpy(), step_logits[:, 0].numpy(),
                               atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(full[:, :16].numpy(), out[0].numpy(), atol=2e-3, rtol=1e-3)


# kernel 12's calls a prefill at the smoke depth (the card phase checks
# the full depth's: zamba2 9, seamless 72, mamba2 and paligemma 0), and
# none in a decode step
SMOKE_FLASH_CALLS = {"mamba2-780m": 0,
                     "zamba2-2.7b": 2,              # one a group, 4 layers / 2
                     "seamless-m4t-large-v2": 6,    # 2 encoder + 2 x 2 decoder (self, cross)
                     "paligemma-3b": 0}             # a prefix is never kernel 12's function


def _spy(monkeypatch):
    """The ``causal`` flag of each ``ops.flash_attention`` call."""
    calls = []
    real = ops.flash_attention

    def spy(q, k, v, *, causal=True):
        calls.append(causal)
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(ops, "flash_attention", spy)
    return calls


def test_kernel_12_calls_per_family(pair, monkeypatch):
    cfg, params = pair["cfg"], pair["params"]
    api = get_api(cfg)
    calls = _spy(monkeypatch)
    out = api.prefill(params, cfg, _t(pair["batch"]), _max_len(cfg),
                      compute_dtype=torch.float32)
    assert len(calls) == SMOKE_FLASH_CALLS[pair["arch"]]
    if cfg.family == "encdec":      # per layer: encoder full; decoder causal self, full cross
        assert calls == [False] * cfg.n_enc_layers + [True, False] * cfg.n_layers
    calls.clear()
    extras = {"enc_out": out[2]} if cfg.family == "encdec" else None
    tok = torch.from_numpy(pair["batch"]["tokens"][:, -1:])
    for i in range(3):
        api.decode_step(params, cfg, tok, out[1], _first_pos(cfg) + i, extras,
                        compute_dtype=torch.float32)
    assert calls == []


def test_loss_and_gradients_match_the_reference(pair):
    jcfg, cfg = pair["jcfg"], pair["cfg"]
    base = dict(seq_len=S, global_batch=B, compute_dtype="float32", remat="none")
    jt, tt = jconfigs.TrainConfig(**base), configs.TrainConfig(**base)
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda p, b: jloss_fn(p, jcfg, b, jt),
                                             has_aux=True))(
        pair["jparams"], _j(pair["batch"], drop=()))
    loss, grads = value_and_grad(pair["params"], cfg, _t(pair["batch"], drop=()), tt)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = named_leaves(lm_params_from_reference(jax.tree.map(np.asarray, jg), cfg))
    got = named_leaves(grads)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].shape == w.shape and got[name].dtype == w.dtype, name
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=F32_REL * float(w.abs().max()), err_msg=name)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_same_gradients(remat):
    """zamba2's group and seamless's layer checkpoints: the values of
    ``remat="none"``."""
    for arch in ("zamba2-2.7b", "seamless-m4t-large-v2"):
        cfg = configs.get_smoke_config(arch)
        params = get_api(cfg).init_params(torch.Generator().manual_seed(0), cfg)
        batch = _t(_numpy_batch(cfg, 12), drop=())
        runs = [value_and_grad(params, cfg, batch, configs.TrainConfig(
            compute_dtype="float32", remat=r)) for r in ("none", remat)]
        assert float(runs[0][0]) == float(runs[1][0])
        for a, b in zip(named_leaves(runs[0][1]).values(), named_leaves(runs[1][1]).values()):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# shapes and entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_full_parameter_count_from_shapes(arch):
    """The published config, counted from shapes with no allocation (the
    meta device), equals the reference's ``jax.eval_shape`` count."""
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    shapes = jax.eval_shape(lambda: jget_api(jcfg).init_params(jax.random.key(0), jcfg))
    want = sum(math.prod(a.shape) for a in jax.tree.leaves(shapes))
    got = named_leaves(get_api(cfg).init_params(None, cfg))
    assert all(t.device.type == "meta" for t in got.values())
    assert sum(t.numel() for t in got.values()) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_on_the_cpu(arch):
    """launch/serve.py's ``serve`` for each family at the smoke widths, on
    the CPU: tokens in range, the same tokens from a second call, no kernel
    launch (the plain versions run on the CPU)."""
    from repro_torch.launch import serve
    cfg = configs.get_smoke_config(arch)
    kw = dict(batch=2, prompt_len=8, gen=4, device="cpu")
    res = serve.serve(cfg, **kw)
    assert tuple(res.tokens.shape) == (2, 4) and res.tokens.dtype == torch.int32
    assert 0 <= int(res.tokens.min()) and int(res.tokens.max()) < cfg.vocab_size
    assert tuple(res.prefill_logits.shape) == (2, cfg.vocab_size)
    assert torch.equal(serve.serve(cfg, **kw).tokens, res.tokens)
    assert not any(res.prefill_launches.values()) and not any(res.decode_launches.values())


def test_serve_main_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "mamba2-780m", "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--gen", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=mamba2-780m batch=2 prompt=8 gen=3"
    assert out[1].startswith("prefill: ") and "ms/token" in out[1]


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "paligemma-3b"])
def test_train_entry_point_on_the_cpu(arch, tmp_path):
    """launch/train.py at the smoke widths: the stub front ends' embeddings
    in each step's batch, two steps, finite losses."""
    from repro_torch.launch import train
    summary = train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                          "--batch", "2", "--seq", "8", "--ckpt-dir", str(tmp_path)])
    assert summary["steps"] == 2
    assert np.isfinite(summary["loss_first"]) and np.isfinite(summary["loss_last"])
