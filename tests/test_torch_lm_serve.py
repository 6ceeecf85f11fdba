"""The dense LM serving path of the port against the reference, on the
reference's weights (carried across by ``lm_params_from_reference``) and
tokens, for the smoke configs of stablelm-3b (MHA), qwen1.5-4b (QKV bias)
and granite-34b (MQA, no MLP gate). The port runs on the CPU, where its
attention is kernel 12's plain version.

Tolerances, and why:
- ``forward`` at f32: rtol = atol = 1e-4 (f32 throughout; the two
  frameworks sum in other orders; measured under 5e-6 on logits up to 4).
- ``forward`` at bf16 (the reference's default compute type): atol
  5e-2 * max|logits|. Every product and the residual stream round to bf16
  (8 significant bits) in both, at places that differ: the reference also
  rounds the attention logits to bf16, where kernel 12 and its plain
  version keep them f32. Measured up to 1.5% of max|logits|.
- ``prefill`` and ``decode_step`` logits, with the bf16 cache: atol
  2e-2 * max|logits|. The reference rounds each normalised attention
  probability to bf16 (v's type) before the PV product; the port's flash
  attention, like kernel 12 and its oracle, keeps them f32 to the end
  (relative 2**-9 per probability), and a bf16 value of the next layer's
  cache then rounds to a neighbour now and then. Measured up to 0.0055 *
  max|logits| at three layers. Layer 0's cache sees no attention output and
  is held to one bf16 step (rtol 2**-7); the whole cache to 2e-2 * max|K|.
- Greedy tokens: all 8 of each request equal. The smallest top-2 margin on
  the way is 0.26% of max|logits| (stablelm-3b), under the logit
  tolerance, so this pins the seeds' near-ties too: a change that moves
  the logits within tolerance may need to show that a flip is a near-tie.
- prefill + decode against a full forward, both in the port with an f32
  cache: atol 2e-3, rtol 1e-3, the reference's own test's.
- the window and prefix forwards: the forward's tolerances above, but the
  blockwise case at s = 9,216 (its docstring says why).
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
from repro.models import make_train_batch as jmake_train_batch
from repro.models import transformer as transformer_ref
from repro.train.train_step import build_decode_step as jbuild_decode_step
from repro.train.train_step import build_prefill as jbuild_prefill
from repro_torch import configs
from repro_torch.interop import lm_params_from_reference
from repro_torch.models import get_api, make_train_batch
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.train.train_step import build_decode_step, build_prefill

ARCHS = ["stablelm-3b", "qwen1.5-4b", "granite-34b"]
B, S, MAX_LEN, GEN = 2, 17, 32, 8
LOGIT_RTOL = 2e-2


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """The reference's params and tokens for one arch, and the port's
    params made from them."""
    arch = request.param
    jcfg = jconfigs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    jparams = jget_api(jcfg).init_params(jax.random.key(0), jcfg)
    params = lm_params_from_reference(jax.tree.map(np.asarray, jparams), cfg)
    tokens = np.array(jmake_train_batch(jcfg, B, S, 0)["tokens"])
    return dict(arch=arch, jcfg=jcfg, cfg=cfg, jparams=jparams, params=params, tokens=tokens)


def _ref_prefill(pair):
    fn = jax.jit(jbuild_prefill(pair["jcfg"], MAX_LEN, compute_dtype=jnp.float32))
    return fn(pair["jparams"], {"tokens": jnp.asarray(pair["tokens"])})


def _port_prefill(pair):
    fn = build_prefill(pair["cfg"], MAX_LEN, compute_dtype=torch.float32)
    return fn(pair["params"], {"tokens": torch.from_numpy(pair["tokens"])})


def _assert_logits_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_RTOL * np.abs(want).max())


def test_forward_matches_the_reference_at_f32(pair):
    want = jget_api(pair["jcfg"]).forward(pair["jparams"], pair["jcfg"],
                                          {"tokens": jnp.asarray(pair["tokens"])},
                                          compute_dtype=jnp.float32)
    got = get_api(pair["cfg"]).forward(pair["params"], pair["cfg"],
                                       {"tokens": torch.from_numpy(pair["tokens"])},
                                       compute_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_forward_matches_the_reference_at_bf16(pair):
    want = np.asarray(jget_api(pair["jcfg"]).forward(
        pair["jparams"], pair["jcfg"], {"tokens": jnp.asarray(pair["tokens"])},
        compute_dtype=jnp.bfloat16))
    got = get_api(pair["cfg"]).forward(pair["params"], pair["cfg"],
                                       {"tokens": torch.from_numpy(pair["tokens"])},
                                       compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-2 * np.abs(want).max())


def test_tied_embeddings_match_the_reference():
    """The tie_embeddings branch (no head: the logits use tok^T), at f32."""
    jcfg = jconfigs.get_smoke_config("stablelm-3b").replace(tie_embeddings=True)
    cfg = configs.get_smoke_config("stablelm-3b").replace(tie_embeddings=True)
    jparams = jget_api(jcfg).init_params(jax.random.key(0), jcfg)
    params = lm_params_from_reference(jax.tree.map(np.asarray, jparams), cfg)
    assert sorted(params["embed"]) == ["tok"]
    tokens = np.array(jmake_train_batch(jcfg, B, S, 0)["tokens"])
    want = jget_api(jcfg).forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)},
                                  compute_dtype=jnp.float32)
    got = get_api(cfg).forward(params, cfg, {"tokens": torch.from_numpy(tokens)},
                               compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_prefill_logits_and_bf16_cache_match_the_reference(pair):
    want_logits, want_cache = _ref_prefill(pair)
    logits, cache = _port_prefill(pair)
    assert logits.shape == want_logits.shape
    _assert_logits_close(logits.numpy(), want_logits)
    for name in ("k", "v"):
        assert cache[name].dtype == torch.bfloat16
        assert tuple(cache[name].shape) == want_cache[name].shape
        got, want = cache[name].float().numpy(), np.asarray(want_cache[name], np.float32)
        np.testing.assert_allclose(got[0], want[0], rtol=2.0 ** -7, atol=1e-6)
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_RTOL * np.abs(want).max())
        assert not got[:, :, S:].any()                 # nothing past the prompt


def test_one_decode_step_matches_the_reference(pair):
    jcfg = pair["jcfg"]
    _, jcache = _ref_prefill(pair)
    tok = pair["tokens"][:, -1:]
    want, _ = jget_api(jcfg).decode_step(pair["jparams"], jcfg, jnp.asarray(tok), jcache,
                                         jnp.int32(S), None, compute_dtype=jnp.float32)
    _, cache = _port_prefill(pair)
    got, cache2 = get_api(pair["cfg"]).decode_step(
        pair["params"], pair["cfg"], torch.from_numpy(tok), cache, S, None,
        compute_dtype=torch.float32)
    assert cache2 is cache                             # updated in place
    assert cache["k"][:, :, S].any() and not cache["k"][:, :, S + 1:].any()
    _assert_logits_close(got.numpy(), want)


def _greedy_ref(pair):
    """The reference's GEN greedy tokens, by its serve loop."""
    jcfg = pair["jcfg"]
    logits, cache = _ref_prefill(pair)
    decode = jax.jit(jbuild_decode_step(jcfg, compute_dtype=jnp.float32))
    tok = jnp.argmax(logits[:, -1, :jcfg.vocab_size], axis=-1).astype(jnp.int32)[:, None]
    toks = [tok]
    for i in range(GEN - 1):
        nxt, cache = decode(pair["jparams"], tok, cache, jnp.int32(S + i))
        tok = nxt[:, None]
        toks.append(tok)
    return np.asarray(jnp.concatenate(toks, axis=1))


def test_greedy_tokens_match_the_reference(pair):
    cfg = pair["cfg"]
    want = _greedy_ref(pair)
    logits, cache = _port_prefill(pair)
    decode = build_decode_step(cfg, compute_dtype=torch.float32)
    tok = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1).to(torch.int32)[:, None]
    got = [tok[:, 0]]
    for i in range(GEN - 1):
        nxt, cache = decode(pair["params"], tok, cache, S + i)
        tok = nxt[:, None]
        got.append(nxt)
    got = torch.stack(got, dim=1).numpy()
    assert got.shape == (B, GEN) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_prefill_then_decode_matches_full_forward():
    """The port's counterpart of the reference's serving test: greedy
    next-token logits from prefill + decode equal a full forward over the
    extended sequence (cache correctness), f32 cache."""
    cfg = configs.get_smoke_config("stablelm-3b")
    api = get_api(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = make_train_batch(cfg, 2, 17, torch.Generator().manual_seed(0))["tokens"]
    full = api.forward(params, cfg, {"tokens": tokens}, compute_dtype=torch.float32)
    logits_p, cache = api.prefill(params, cfg, {"tokens": tokens[:, :16]}, 32,
                                  compute_dtype=torch.float32, cache_dtype=torch.float32)
    step_logits, _ = api.decode_step(params, cfg, tokens[:, 16:17], cache, 16, None,
                                     compute_dtype=torch.float32)
    np.testing.assert_allclose(full[:, 16].numpy(), step_logits[:, 0].numpy(),
                               atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(full[:, :16].numpy(), logits_p.numpy(), atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_equal_the_reference(arch):
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for get, jget in ((configs.get_config, jconfigs.get_config),
                      (configs.get_smoke_config, jconfigs.get_smoke_config)):
        cfg, jcfg = get(arch), jget(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert (cfg.resolved_head_dim, cfg.vocab_padded) == (jcfg.resolved_head_dim,
                                                              jcfg.vocab_padded)
    assert dataclasses.asdict(configs.TrainConfig()) == dataclasses.asdict(jconfigs.TrainConfig())
    assert [dataclasses.asdict(c) for c in configs.SHAPE_CELLS] == [
        dataclasses.asdict(c) for c in jconfigs.SHAPE_CELLS]
    assert [f.name for f in dataclasses.fields(configs.ShapeCell)] == [
        f.name for f in dataclasses.fields(jconfigs.ShapeCell)]


@pytest.mark.parametrize("arch", [a for a in jconfigs.ARCH_IDS
                                  if jconfigs.get_config(a).family != "dense"])
def test_non_dense_families_raise_not_implemented(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 12"):
        get_api(configs.get_smoke_config(arch))


def _danube(n_layers=None):
    jcfg = jconfigs.get_smoke_config("h2o-danube-3-4b")      # window 16
    cfg = configs.get_smoke_config("h2o-danube-3-4b")
    if n_layers:
        jcfg, cfg = jcfg.replace(n_layers=n_layers), cfg.replace(n_layers=n_layers)
    jparams = jget_api(jcfg).init_params(jax.random.key(0), jcfg)
    return jcfg, cfg, jparams, lm_params_from_reference(jax.tree.map(np.asarray, jparams), cfg)


def _forward_both(jcfg, cfg, jparams, params, tokens, prefix=None, dtype="float32"):
    jkw = dict(compute_dtype=getattr(jnp, dtype))
    kw = dict(compute_dtype=getattr(torch, dtype))
    if prefix is not None:
        jkw["prefix_embeds"] = jnp.asarray(prefix)
        kw["prefix_embeds"] = torch.from_numpy(prefix)
    want = np.asarray(transformer_ref.forward(jparams, jcfg, jnp.asarray(tokens), **jkw))
    got = transformer.forward(params, cfg, torch.from_numpy(tokens), **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    return got.numpy(), want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_forward_matches_the_reference(dtype):
    """h2o-danube's sliding window (16 in the smoke config) cutting into a
    sequence of 48: the reference's full-scores path, at the tolerances of
    the forward tests above."""
    jcfg, cfg, jparams, params = _danube()
    tokens = np.array(jmake_train_batch(jcfg, B, 48, 0)["tokens"])
    got, want = _forward_both(jcfg, cfg, jparams, params, tokens, dtype=dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-2 * np.abs(want).max())


@pytest.mark.parametrize("arch", ["stablelm-3b", "h2o-danube-3-4b"])
def test_prefix_forward_matches_the_reference(arch):
    """forward(prefix_embeds=): 5 bidirectional prefix positions before 20
    tokens. On h2o-danube the window (16) and the prefix meet: the
    full-scores path keeps the prefix keys visible past the window."""
    jcfg, cfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    jparams = jget_api(jcfg).init_params(jax.random.key(0), jcfg)
    params = lm_params_from_reference(jax.tree.map(np.asarray, jparams), cfg)
    tokens = np.array(jmake_train_batch(jcfg, B, 20, 0)["tokens"])
    prefix = (np.random.default_rng(2).standard_normal((B, 5, cfg.d_model)) * 0.02
              ).astype(np.float32)
    got, want = _forward_both(jcfg, cfg, jparams, params, tokens, prefix)
    assert got.shape == (B, 20, cfg.vocab_padded)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_blockwise_forward_matches_the_reference():
    """Past 8,192 positions in multiples of 1,024 a window or a prefix takes
    the reference's query-blockwise path: one h2o-danube layer at the smoke
    width, 16 prefix positions and 9,200 tokens (s = 9,216), where the
    blockwise path keeps the prefix keys for the prefix's own queries only.
    atol 1e-3 * max|logits|: the frameworks' f32 RoPE tables part with the
    position (the angle pos * f carries pos times f's last-bit difference,
    about 5e-4 rad near 9,200); measured 1.8e-4 of max|logits|, where the
    full path's prefix rule here would part by 1.03 of it."""
    jcfg, cfg, jparams, params = _danube(n_layers=1)
    tokens = np.array(jmake_train_batch(jcfg, 1, 9200, 0)["tokens"])
    prefix = (np.random.default_rng(3).standard_normal((1, 16, cfg.d_model)) * 0.02
              ).astype(np.float32)
    got, want = _forward_both(jcfg, cfg, jparams, params, tokens, prefix)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max())


def test_windowed_prefill_and_decode_match_the_reference():
    """h2o-danube's window on the cache path: a prompt of 20 (past the
    window of 16) into the bf16 cache, then 4 decode steps, against the
    reference's logits (f32 compute)."""
    jcfg, cfg, jparams, params = _danube()
    tokens = np.array(jmake_train_batch(jcfg, B, 24, 0)["tokens"])
    jlogits, jcache = jax.jit(jbuild_prefill(jcfg, MAX_LEN, compute_dtype=jnp.float32))(
        jparams, {"tokens": jnp.asarray(tokens[:, :20])})
    logits, cache = build_prefill(cfg, MAX_LEN, compute_dtype=torch.float32)(
        params, {"tokens": torch.from_numpy(tokens[:, :20])})
    _assert_logits_close(logits.numpy(), jlogits)
    for i in range(20, 24):
        tok = tokens[:, i:i + 1]
        want, jcache = jget_api(jcfg).decode_step(jparams, jcfg, jnp.asarray(tok), jcache,
                                                  jnp.int32(i), None, compute_dtype=jnp.float32)
        got, cache = get_api(cfg).decode_step(params, cfg, torch.from_numpy(tok), cache, i,
                                              None, compute_dtype=torch.float32)
        _assert_logits_close(got.numpy(), want)


def test_cross_attention_raises_not_implemented():
    cfg = configs.get_smoke_config("stablelm-3b")
    params = get_api(cfg).init_params(torch.Generator().manual_seed(0), cfg)
    h = torch.zeros((1, 4, cfg.d_model))
    with pytest.raises(NotImplementedError, match="cross-attention.*item 12"):
        L.attention(h, params["layers"][0]["attn"], cfg, x_kv=h)


def test_full_stablelm_parameter_count_from_shapes():
    """The full published stablelm-3b, counted from shapes with no
    allocation (the meta device), equals the reference's jax.eval_shape
    count: 2.795 B parameters."""
    from repro.models.transformer import init_params as jinit
    jcfg = jconfigs.get_config("stablelm-3b")
    shapes = jax.eval_shape(lambda: jinit(jax.random.key(0), jcfg))
    want = sum(math.prod(a.shape) for a in jax.tree.leaves(shapes))
    params = get_api(configs.get_config("stablelm-3b")).init_params(None, configs.get_config("stablelm-3b"))
    leaves = [params["embed"]["tok"], params["embed"]["head"], params["ln_f"]]
    leaves += [t for layer in params["layers"] for t in _leaves(layer)]
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) == want
    assert 2.79e9 < want < 2.80e9


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def test_serve_entry_point_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "granite-34b", "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--gen", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=granite-34b batch=2 prompt=8 gen=3"
    assert out[1].startswith("prefill: ") and "ms/token" in out[1]
    res = serve.serve(configs.get_smoke_config("granite-34b"), batch=2, prompt_len=8, gen=3,
                      device="cpu")
    assert res.tokens.shape == (2, 3) and int(res.tokens.max()) < 512
    assert res.prefill_launches["flash_attention"] == 0    # the plain version on the CPU
