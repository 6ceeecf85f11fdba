"""The moe family of the port against the reference, on the CPU:
deepseek-v2-lite-16b (MLA, 1 dense + 2 moe layers, top-2 of 8 experts and
a shared one) and llama4-maverick-400b-a17b (GQA attention, moe and dense
layers interleaved, top-1 of 8) at their smoke widths, on the reference's
weights (carried across by ``lm_params_from_reference``) and the same
numpy inputs.

Tolerances, and why:
- f32 compute: 1e-5 of the max |value| of what is compared (logits, y,
  the aux loss, a cache leaf, a gradient leaf): f32 throughout, the same
  products, sums in other orders (the combine adds a token's k copies in
  top-k order, the reference's scatter in expert order).
- bf16 compute: 2e-2 of the max |value| for one module (the experts,
  MLA), the LM rule of ``test_torch_lm_serve.py`` (a value on the other
  side of a bf16 rounding moves by 2**-8 of itself); the whole model's
  logits 5e-2, that file's rule for its bf16 forward (the differences grow
  through the layers), on the tokens that route alike.
- routing: the expert ids are compared exactly wherever the router's k-th
  and (k+1)-th probabilities lie more than 1e-6 apart at f32 compute (2e-2
  at bf16 compute, whose router inputs differ by bf16 roundings); the
  tokens at a nearer tie are counted and printed.
- prefill then decode against a full forward, in the port, f32 cache:
  atol 2e-3, rtol 1e-3, the reference's own serving test's.
"""
import dataclasses
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
from repro.models import moe as jmoe
from repro.train.train_step import loss_fn as jloss_fn
from repro_torch import configs
from repro_torch.interop import adamw_state_from_reference, lm_params_from_reference
from repro_torch.kernels import ops
from repro_torch.models import get_api
from repro_torch.models import moe
from repro_torch.train import adamw_init
from repro_torch.train._tree import named_leaves, rebuild
from repro_torch.train.train_step import value_and_grad

ARCHS = ["deepseek-v2-lite-16b", "llama4-maverick-400b-a17b"]
B, S, GEN = 2, 20, 8
F32_REL = 1e-5
BF16_REL = 2e-2
BF16_FORWARD_REL = 5e-2     # the whole model at bf16 compute: the dense family's rule
TIE = 1e-6                  # router probabilities nearer than this are a near-tie
DEEPSEEK_PARAMS = 15_706_484_224


def _with_capacity(cfg, cf):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _numpy_batch(cfg, s, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _j(batch, drop=("labels",)):
    return {k: jnp.asarray(v) for k, v in batch.items() if k not in drop}


def _t(batch, drop=("labels",)):
    return {k: torch.from_numpy(v) for k, v in batch.items() if k not in drop}


def _close(got, want, rel):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg, cfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    jparams = jax.jit(lambda key: jget_api(jcfg).init_params(key, jcfg))(jax.random.key(0))
    params = lm_params_from_reference(jax.tree.map(np.asarray, jparams), cfg)
    return dict(arch=arch, jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                batch=_numpy_batch(cfg, S), runs={})


# ---------------------------------------------------------------------------
# the routed experts alone
# ---------------------------------------------------------------------------


def _ref_routing(x, p, jcfg):
    """The reference's router lines (``_moe_ffn_local``) on x: (top_ids
    (t, k), the gap between the k-th and (k+1)-th probabilities (t,), the
    kept copies in token order (t*k,))."""
    m = jcfg.moe
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ p["router"], axis=-1)
    _, top_ids = jax.lax.top_k(probs, m.top_k)
    ranked = np.sort(np.asarray(probs), axis=-1)[:, ::-1]
    gap = ranked[:, m.top_k - 1] - ranked[:, m.top_k]
    flat_e = top_ids.reshape(-1)
    n, e = flat_e.shape[0], m.n_experts
    order = jnp.argsort(flat_e)
    counts = jnp.bincount(flat_e, length=e)
    starts = jnp.cumsum(counts) - counts
    keep_sorted = jnp.arange(n) - starts[flat_e[order]] < jmoe.moe_capacity(xf.shape[0], m)
    keep = np.empty(n, bool)
    keep[np.asarray(order)] = np.asarray(keep_sorted)
    return np.asarray(top_ids), gap, keep


def _moe_layer(pair):
    jp = jax.tree.map(lambda a: a[0], pair["jparams"]["moe_layers"]["moe"])
    return jp, pair["params"]["moe_layers"][0]["moe"]


@pytest.mark.parametrize("cf", [8.0, 1.0, 0.5])
def test_moe_ffn_matches_the_reference(pair, cf):
    """y, aux, the routing and the kept copies: at the smoke capacity
    factor (8.0) nothing is dropped; at 1.0 and 0.5 copies are, and the
    port drops exactly the reference's."""
    jcfg, cfg = _with_capacity(pair["jcfg"], cf), _with_capacity(pair["cfg"], cf)
    jp, p = _moe_layer(pair)
    x = np.random.default_rng(5).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    want_y, want_aux = jax.jit(lambda x, p: jmoe._moe_ffn_local(x, p, jcfg))(jnp.asarray(x), jp)
    ids, gap, keep = _ref_routing(x, jp, jcfg)

    xt = torch.from_numpy(x)
    _, _, top_ids = moe.route(xt.reshape(-1, cfg.d_model), p, cfg)
    cap = moe.moe_capacity(B * S, cfg.moe)
    slot, src = moe.dispatch(top_ids, cfg.moe.n_experts, cap)
    near = gap <= TIE
    print(f"{pair['arch']} cf {cf}: {int(near.sum())} of {B * S} tokens at a router "
          f"near-tie; {int((~keep).sum())} of {keep.size} copies dropped (cap {cap})")
    assert (top_ids.numpy()[~near] == ids[~near]).all()
    assert not near.any(), "a near-tie: the routing may part (record it in ROADMAP queue 3)"
    np.testing.assert_array_equal(slot.numpy() != cfg.moe.n_experts * cap, keep)
    assert (~keep).any() == (cf < 8.0)
    # each kept copy fills one row and each row at most one copy
    kept = slot[slot < cfg.moe.n_experts * cap]
    assert torch.equal(torch.sort(kept).values, torch.nonzero(src < keep.size)[:, 0])

    y, aux = moe.moe_ffn(xt, p, cfg)
    assert y.dtype == torch.float32 and aux.dtype == torch.float32
    _close(y.numpy(), want_y, F32_REL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=F32_REL)


def test_moe_ffn_at_bf16_compute(pair):
    """bf16 activations with the f32 weights: jnp promotes the expert and
    shared products to f32, and so does the port (y f32, as the
    reference's)."""
    jcfg, cfg = pair["jcfg"], pair["cfg"]
    jp, p = _moe_layer(pair)
    x = np.random.default_rng(6).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    want_y, want_aux = jax.jit(lambda x, p: jmoe._moe_ffn_local(x, p, jcfg))(jx, jp)
    y, aux = moe.moe_ffn(torch.from_numpy(x).to(torch.bfloat16), p, cfg)
    assert str(y.dtype).replace("torch.", "") == str(want_y.dtype)
    _close(y.float().numpy(), np.asarray(want_y, np.float32), BF16_REL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=BF16_REL)


def test_dispatch_keeps_each_experts_first_copies():
    """``dispatch`` against a loop over the copies in token order: each
    expert takes its copies in order until it holds ``cap``."""
    rng = np.random.default_rng(0)
    t, k, e, cap = 50, 3, 6, 7
    ids = np.stack([rng.choice(e, k, replace=False) for _ in range(t)])
    slot, src = moe.dispatch(torch.from_numpy(ids), e, cap)
    want_slot = np.full(t * k, e * cap)
    want_src = np.full(e * cap, t * k)
    filled = [0] * e
    for c, ex in enumerate(ids.reshape(-1)):
        if filled[ex] < cap:
            want_slot[c] = ex * cap + filled[ex]
            want_src[ex * cap + filled[ex]] = c
            filled[ex] += 1
    assert (want_slot == e * cap).any()
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    np.testing.assert_array_equal(src.numpy(), want_src)


def test_cast_keeps_f32_weights_as_they_are():
    """The reference's moe ``_cast``: f32 leaves are not cast, at f32 or
    bf16 compute (on the card a copy of an expert weight, 21.5 GB in
    llama4's f32, would not fit); other leaves take the compute dtype."""
    cfg = configs.get_smoke_config("llama4-maverick-400b-a17b")
    lp = moe.init_layer(torch.Generator().manual_seed(0), cfg, True)
    for dt in (torch.float32, torch.bfloat16):
        cast = named_leaves(moe._cast(lp, dt))
        assert all(cast[name] is t for name, t in named_leaves(lp).items())
    half = {name: t.to(torch.float16) for name, t in named_leaves(lp).items()}
    cast = moe._cast(rebuild(lp, half), torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in named_leaves(cast).values())


# ---------------------------------------------------------------------------
# MLA alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["expanded", "absorbed"])
def test_mla_attention_matches_the_reference(form, dtype):
    """deepseek's MLA, one layer: the expanded form without a cache; the
    absorbed form into an f32 cache over S + 4 positions, then one decode
    token at S. bf16: bf16 activations with the f32 weights."""
    jcfg = jconfigs.get_smoke_config("deepseek-v2-lite-16b")
    cfg = configs.get_smoke_config("deepseek-v2-lite-16b")
    jp = jmoe.init_mla(jax.random.key(3), jcfg)
    p = {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    rel = F32_REL if dtype == "float32" else BF16_REL
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    attn = jax.jit(lambda x, p, c, pos: jmoe.mla_attention(x, p, jcfg, positions=pos + jnp.arange(
        x.shape[1]), cache=c, cache_pos=pos))
    if form == "expanded":
        want, _ = jax.jit(lambda x, p: jmoe.mla_attention(x, p, jcfg))(jnp.asarray(x).astype(jdt),
                                                                       jp)
        got, cache = moe.mla_attention(torch.from_numpy(x).to(tdt), p, cfg)
        assert cache is None
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        _close(got.float().numpy(), np.asarray(want, np.float32), rel)
        return
    jcache = jmoe.init_mla_cache(jcfg, B, S + 4, jnp.float32)
    cache = moe.init_mla_cache(cfg, B, S + 4, torch.float32)
    for xs, pos in ((x, 0), (x1, S)):
        want, jcache = attn(jnp.asarray(xs).astype(jdt), jp, jcache, jnp.int32(pos))
        got, cache2 = moe.mla_attention(torch.from_numpy(xs).to(tdt), p, cfg,
                                        positions=pos + torch.arange(xs.shape[1]), cache=cache,
                                        cache_pos=pos)
        assert cache2 is cache
        _close(got.float().numpy(), np.asarray(want, np.float32), rel)
        for name in ("ckv", "kr"):
            _close(cache[name].numpy(), jcache[name], rel)


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------


def _record_routing(monkeypatch):
    """Record each moe layer's routing in both packages, in layer order:
    {"ref": [(top_ids (t, k), gap (t,))], "port": [top_ids]}, the gap
    between the reference's k-th and (k+1)-th router probabilities. The
    reference's come out of its jitted scan through ``jax.debug.callback``."""
    rec = {"ref": [], "port": []}
    real_local, real_route = jmoe._moe_ffn_local, moe.route

    def keep(ids, top):
        rec["ref"].append((np.asarray(ids), np.asarray(top[:, -2] - top[:, -1])))

    def local(x, p, cfg):
        xf = x.reshape(-1, x.shape[-1])
        probs = jax.nn.softmax(xf.astype(jnp.float32) @ p["router"], axis=-1)
        top, ids = jax.lax.top_k(probs, cfg.moe.top_k + 1)
        jax.debug.callback(keep, ids[:, :-1], top, ordered=True)
        return real_local(x, p, cfg)

    def route(xf, p, cfg):
        out = real_route(xf, p, cfg)
        rec["port"].append(out[2].numpy())
        return out

    monkeypatch.setattr(jmoe, "_moe_ffn_local", local)
    monkeypatch.setattr(moe, "route", route)
    return rec


def _routing_parts(rec, tie, tag):
    """(b*s,) bool: the tokens whose experts differ between the packages
    in some moe layer. Each must be at a near-tie (gap <= ``tie``) in the
    reference; the counts are printed."""
    assert len(rec["ref"]) == len(rec["port"]) > 0
    parted = np.zeros(rec["port"][0].shape[0], bool)
    near = parted.copy()
    for (ids, gap), got in zip(rec["ref"], rec["port"], strict=True):
        differ = (got != ids).any(-1)
        assert not (differ & (gap > tie)).any(), f"{tag}: routing parts past a near-tie"
        parted |= differ
        near |= gap <= tie
    print(f"{tag}: {int(near.sum())} of {near.size} tokens at a router near-tie (gap <= "
          f"{tie}) in some moe layer, {int(parted.sum())} routed otherwise")
    return parted


def test_forward_matches_the_reference_at_f32(pair, monkeypatch):
    """Logits, the summed aux loss and every moe layer's routing."""
    jcfg, cfg = pair["jcfg"], pair["cfg"]
    rec = _record_routing(monkeypatch)
    want, want_aux = jax.jit(lambda p, b: jget_api(jcfg).forward(
        p, jcfg, b, compute_dtype=jnp.float32, return_aux=True))(pair["jparams"],
                                                                 _j(pair["batch"]))
    got, aux = get_api(cfg).forward(pair["params"], cfg, _t(pair["batch"]),
                                    compute_dtype=torch.float32, return_aux=True)
    assert not _routing_parts(rec, TIE, f"{pair['arch']} f32").any()
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, cfg.vocab_padded)
    _close(got.numpy(), want, F32_REL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=F32_REL)


def test_forward_matches_the_reference_at_bf16(pair, monkeypatch):
    """bf16 weights (the router f32) at bf16 compute. The reference's moe
    model refuses f32 weights at bf16 compute (its scanned layers' carry
    turns f32), so this is the bf16 run both packages make. The router's
    input then differs by bf16 roundings (XLA keeps a fused chain's
    intermediates in f32, torch rounds each op), so a token whose k-th and
    (k+1)-th probabilities lie within 2e-2 may take other experts: such
    tokens are counted and left out of the logits, and every other token
    must route alike. The logits are held to the dense family's bf16
    forward rule, 5e-2 of max|logits| (``test_torch_lm_serve.py``)."""
    jcfg, cfg = pair["jcfg"], pair["cfg"]
    jparams = jax.jit(lambda key: jget_api(jcfg).init_params(key, jcfg, jnp.bfloat16))(
        jax.random.key(0))
    params = lm_params_from_reference(jax.tree.map(np.asarray, jparams), cfg)
    assert params["moe_layers"][0]["moe"]["router"].dtype == torch.float32
    assert params["moe_layers"][0]["moe"]["wg"].dtype == torch.bfloat16
    rec = _record_routing(monkeypatch)
    want, want_aux = jax.jit(lambda p, b: jget_api(jcfg).forward(
        p, jcfg, b, compute_dtype=jnp.bfloat16, return_aux=True))(jparams, _j(pair["batch"]))
    got, aux = get_api(cfg).forward(params, cfg, _t(pair["batch"]),
                                    compute_dtype=torch.bfloat16, return_aux=True)
    parted = _routing_parts(rec, BF16_REL, f"{pair['arch']} bf16").reshape(B, S)
    assert got.dtype == torch.float32
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy()[~parted], want[~parted], rtol=0,
                               atol=BF16_FORWARD_REL * np.abs(want).max())
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=BF16_REL)


def _ref_run(pair, cache_dtype):
    """The reference's prefill and GEN - 1 decode steps fed its own greedy
    tokens, cached on the pair."""
    if cache_dtype in pair["runs"]:
        return pair["runs"][cache_dtype]
    jcfg, jparams = pair["jcfg"], pair["jparams"]
    api = jget_api(jcfg)
    out = jax.jit(lambda p, b: api.prefill(p, jcfg, b, S + GEN, compute_dtype=jnp.float32,
                                           cache_dtype=getattr(jnp, cache_dtype)))(
        jparams, _j(pair["batch"]))
    logits, cache = out
    step = jax.jit(lambda p, t, c, pos: api.decode_step(p, jcfg, t, c, pos,
                                                        compute_dtype=jnp.float32))
    prefill = (np.asarray(logits), jax.tree.map(np.asarray, cache))
    tok = jnp.argmax(logits[:, -1, :jcfg.vocab_size], axis=-1).astype(jnp.int32)[:, None]
    toks, steps = [np.asarray(tok)], []
    for i in range(GEN - 1):
        lg, cache = step(jparams, tok, cache, jnp.int32(S + i))
        steps.append(np.asarray(lg))
        tok = jnp.argmax(lg[:, -1, :jcfg.vocab_size], axis=-1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
    run = dict(prefill=prefill, steps=steps, tokens=np.concatenate(toks, axis=1),
               cache=jax.tree.map(np.asarray, cache))
    pair["runs"][cache_dtype] = run
    return run


def _port_run(pair, cache_dtype, tokens):
    cfg, params = pair["cfg"], pair["params"]
    api = get_api(cfg)
    logits, cache = api.prefill(params, cfg, _t(pair["batch"]), S + GEN,
                                compute_dtype=torch.float32,
                                cache_dtype=getattr(torch, cache_dtype))
    first = _leaves(cache)
    steps = []
    for i in range(GEN - 1):
        lg, cache2 = api.decode_step(params, cfg, torch.from_numpy(tokens[:, i:i + 1]), cache,
                                     S + i, compute_dtype=torch.float32)
        assert cache2 is cache                         # updated in place
        steps.append(lg.numpy())
    types = {name: str(t.dtype).replace("torch.", "") for name, t in named_leaves(cache).items()}
    return logits.numpy(), first, steps, _leaves(cache), types


def _leaves(cache):
    return {name: t.float().numpy().copy() for name, t in named_leaves(cache).items()}


def _ref_leaves(cache, as_f32=True):
    flat = jax.tree_util.tree_flatten_with_path(cache)[0]
    return {".".join(str(k.key) for k in path): np.asarray(a, np.float32) if as_f32 else a
            for path, a in flat}


def test_prefill_caches_and_decode_match_the_reference_at_f32(pair):
    """Prefill's logits and every leaf of the stacked cache ({"moe",
    "prefix"} of MLA's ckv and kr for deepseek; {"moe", "dense"} of k and v
    for llama4), then 8 decode steps fed the reference's greedy tokens."""
    ref = _ref_run(pair, "float32")
    logits, first, steps, last, _ = _port_run(pair, "float32", ref["tokens"])
    _close(logits, ref["prefill"][0], F32_REL)
    for got_cache, want_cache in ((first, ref["prefill"][1]), (last, ref["cache"])):
        want = _ref_leaves(want_cache)
        assert sorted(got_cache) == sorted(want)
        for name, w in want.items():
            assert got_cache[name].shape == w.shape, name
            _close(got_cache[name], w, F32_REL)
    for got, want in zip(steps, ref["steps"], strict=True):
        _close(got, want, F32_REL)


def test_default_caches_match_the_reference(pair):
    """The bf16 caches through prefill and the decode steps, under the LM
    rule, the port's greedy token the reference's wherever the reference's
    top-2 margin is past the tolerance."""
    ref = _ref_run(pair, "bfloat16")
    logits, _, steps, _, types = _port_run(pair, "bfloat16", ref["tokens"])
    assert types == {name: str(a.dtype) for name, a in _ref_leaves(ref["prefill"][1],
                                                                   as_f32=False).items()}
    vocab = pair["cfg"].vocab_size
    compared = 0
    for i, (got, want) in enumerate(zip([logits] + steps, [ref["prefill"][0]] + ref["steps"],
                                        strict=True)):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_REL * scale)
        top2 = np.sort(want[:, -1, :vocab], axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > BF16_REL * scale
        same = got[:, -1, :vocab].argmax(-1) == ref["tokens"][:, i]
        assert (same | ~clear).all(), f"greedy token differs past a near-tie at step {i}"
        compared += int(clear.sum())
    assert compared > 0


def test_prefill_then_decode_matches_full_forward(pair):
    """The reference's own serving test in the port: prefill over 16
    tokens (MLA's absorbed form) and one decode step equal a full forward
    over 17 (the expanded form), f32 cache."""
    cfg, params = pair["cfg"], pair["params"]
    api = get_api(cfg)
    batch = _t(_numpy_batch(cfg, 17, seed=1))
    full = api.forward(params, cfg, batch, compute_dtype=torch.float32)
    logits, cache = api.prefill(params, cfg, {"tokens": batch["tokens"][:, :16]}, 32,
                                compute_dtype=torch.float32, cache_dtype=torch.float32)
    step_logits, _ = api.decode_step(params, cfg, batch["tokens"][:, 16:17], cache, 16,
                                     compute_dtype=torch.float32)
    np.testing.assert_allclose(full[:, 16].numpy(), step_logits[:, 0].numpy(),
                               atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(full[:, :16].numpy(), logits.numpy(), atol=2e-3, rtol=1e-3)


# kernel 12's calls a prefill at the smoke depth: llama4's 4 attention
# layers (moe and dense alike), deepseek's MLA never; none in a decode step
SMOKE_FLASH_CALLS = {"deepseek-v2-lite-16b": 0, "llama4-maverick-400b-a17b": 4}


def test_kernel_12_calls(pair, monkeypatch):
    cfg, params = pair["cfg"], pair["params"]
    api = get_api(cfg)
    calls = []
    real = ops.flash_attention

    def spy(q, k, v, *, causal=True):
        calls.append(causal)
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(ops, "flash_attention", spy)
    _, cache = api.prefill(params, cfg, _t(pair["batch"]), S + GEN,
                           compute_dtype=torch.float32)
    assert calls == [True] * SMOKE_FLASH_CALLS[pair["arch"]]
    calls.clear()
    tok = torch.from_numpy(pair["batch"]["tokens"][:, -1:])
    for i in range(3):
        api.decode_step(params, cfg, tok, cache, S + i, compute_dtype=torch.float32)
    assert calls == []


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_loss_and_gradients_match_the_reference(pair, cf):
    """xent + aux and the gradient of every leaf against
    ``jax.value_and_grad`` of the reference's ``loss_fn``, f32,
    ``remat="none"``; at 1.0 copies are dropped. The reference's AdamW
    state crosses too."""
    jcfg, cfg = _with_capacity(pair["jcfg"], cf), _with_capacity(pair["cfg"], cf)
    base = dict(seq_len=S, global_batch=B, compute_dtype="float32", remat="none")
    jt, tt = jconfigs.TrainConfig(**base), configs.TrainConfig(**base)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(lambda p, b: jloss_fn(p, jcfg, b, jt),
                                                has_aux=True))(
        pair["jparams"], _j(pair["batch"], drop=()))
    loss, grads = value_and_grad(pair["params"], cfg, _t(pair["batch"], drop=()), tt)
    np.testing.assert_allclose(float(loss), float(jl), rtol=F32_REL)
    assert float(jaux["aux"]) > 0
    want = named_leaves(lm_params_from_reference(jax.tree.map(np.asarray, jg), cfg))
    got = named_leaves(grads)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].shape == w.shape and got[name].dtype == w.dtype, name
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=F32_REL * float(w.abs().max()), err_msg=name)
    state = {"step": np.int32(3), "mu": jax.tree.map(np.asarray, jg),
             "nu": jax.tree.map(lambda a: np.square(np.asarray(a)), jg)}
    opt = adamw_state_from_reference(state, cfg)
    assert int(opt.step) == 3
    assert sorted(named_leaves(opt.mu)) == sorted(named_leaves(adamw_init(grads).mu))


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_same_gradients(pair, remat):
    """Each layer recomputed in the backward (its routing too) gives the
    gradients of ``remat="none"``."""
    cfg, params = pair["cfg"], pair["params"]
    batch = _t(_numpy_batch(cfg, 12), drop=())
    runs = [value_and_grad(params, cfg, batch, configs.TrainConfig(
        compute_dtype="float32", remat=r)) for r in ("none", remat)]
    assert float(runs[0][0]) == float(runs[1][0])
    for a, b in zip(named_leaves(runs[0][1]).values(), named_leaves(runs[1][1]).values()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_backward_gives_the_same_bits_twice_on_4_threads(pair):
    """No accumulation whose order varies: two backward passes at capacity
    1.0 (copies dropped) with 4 torch threads give the same bits."""
    cfg = _with_capacity(pair["cfg"], 1.0)
    batch = _t(pair["batch"], drop=())
    tcfg = configs.TrainConfig(compute_dtype="float32", remat="none")
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        runs = [value_and_grad(pair["params"], cfg, batch, tcfg) for _ in range(2)]
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(runs[0][0], runs[1][0])
    for name, g in named_leaves(runs[0][1]).items():
        assert torch.equal(g, named_leaves(runs[1][1])[name]), name


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
    if arch == "deepseek-v2-lite-16b":
        assert want == DEEPSEEK_PARAMS


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_get_api_routes_every_arch(arch):
    """Every config of the zoo has its family's API (moe since the moe
    port): the smoke config's forward runs."""
    cfg = configs.get_smoke_config(arch)
    assert get_api(cfg).family == cfg.family
    if cfg.family == "moe":
        params = get_api(cfg).init_params(torch.Generator().manual_seed(0), cfg)
        logits = get_api(cfg).forward(params, cfg, {"tokens": torch.zeros((1, 4), dtype=torch.int64)},
                                      compute_dtype=torch.float32)
        assert tuple(logits.shape) == (1, 4, cfg.vocab_padded)


def test_unknown_family_raises():
    cfg = configs.get_smoke_config("stablelm-3b").replace(family="nonexistent")
    with pytest.raises(ValueError, match="unknown model family 'nonexistent'"):
        get_api(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_on_the_cpu(arch):
    """launch/serve.py's ``serve`` at the smoke widths on the CPU: tokens
    in range, the same tokens from a second call, no kernel launch."""
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
    serve.main(["--arch", "deepseek-v2-lite-16b", "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--gen", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=deepseek-v2-lite-16b batch=2 prompt=8 gen=3"
    assert out[1].startswith("prefill: ") and "ms/token" in out[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_entry_point_on_the_cpu(arch, tmp_path):
    """launch/train.py at the smoke widths: two steps, finite losses (the
    aux loss in them)."""
    from repro_torch.launch import train
    summary = train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                          "--batch", "2", "--seq", "8", "--ckpt-dir", str(tmp_path)])
    assert summary["steps"] == 2
    assert np.isfinite(summary["loss_first"]) and np.isfinite(summary["loss_last"])
