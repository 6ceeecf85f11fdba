"""Training the ssm, hybrid, encdec, vlm and moe families, and the routing
of head widths past kernel 12's, against the reference on the CPU.

Both packages start from one state (the reference's weights and AdamW
state, carried across by ``lm_params_from_reference`` and
``adamw_state_from_reference``) and take the same numpy batches (tokens,
and the stub front ends' embeddings), at the smoke widths, f32 compute,
``remat="full"`` as ``launch/train.py`` trains. The port's attention is
kernel 12's plain version and its plain backward on the CPU.

Tolerances, and why:
- three train steps: ``tests/test_torch_train.py``'s. The loss, lr and
  grad norm within rtol 1e-5; the moments within 1e-4 of each leaf's
  max; the parameters within 1e-4 of each leaf's max plus 1e-2 of the
  steps' summed learning rate (Adam divides each gradient element by its
  own running scale, so an element whose gradient is near f32 noise moves
  by a share of its step that the two packages' sums set differently).
- head widths past 128 (the plain path): ``tests/test_torch_lm_families.py``'s
  f32 rule, the logits and every gradient leaf within 1e-4 of their max,
  the loss within rtol 1e-5.
"""
import dataclasses

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
from repro.train import optimizer as jopt
from repro.train.train_step import build_train_step as jbuild_train_step
from repro.train.train_step import loss_fn as jloss_fn
from repro_torch import configs
from repro_torch.interop import adamw_state_from_reference, lm_params_from_reference
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import get_api
from repro_torch.models import layers as L
from repro_torch.train._tree import leaves, named_leaves
from repro_torch.train.train_step import build_train_step, value_and_grad

FAMILIES = ["mamba2-780m", "zamba2-2.7b", "seamless-m4t-large-v2", "paligemma-3b",
            "deepseek-v2-lite-16b"]
B, S = 2, 20                    # S past one smoke chunk (16): the SSD pads
F32_REL = 1e-4
WIDE = 160                      # a head width past kernel 12's MAX_D


def _numpy_batch(cfg, s, seed=0, prefix=None):
    """Tokens and labels, and the stub front end's embeddings (encdec's
    ``src_embeds`` of s frames, vlm's ``image_embeds`` of ``prefix``
    positions, by default the config's)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["src_embeds"] = (rng.standard_normal((B, s, cfg.d_model)) * 0.02
                               ).astype(np.float32)
    if cfg.family == "vlm":
        p = cfg.n_prefix_tokens if prefix is None else prefix
        batch["image_embeds"] = (rng.standard_normal((B, p, cfg.d_model)) * 0.02
                                 ).astype(np.float32)
    return batch


def _j(batch, drop=()):
    return {k: jnp.asarray(v) for k, v in batch.items() if k not in drop}


def _t(batch, drop=()):
    return {k: torch.from_numpy(v) for k, v in batch.items() if k not in drop}


def _pair(arch, **over):
    jcfg = jconfigs.get_smoke_config(arch).replace(**over)
    cfg = configs.get_smoke_config(arch).replace(**over)
    jparams = jax.jit(lambda key: jget_api(jcfg).init_params(key, jcfg))(jax.random.key(0))
    return jcfg, cfg, jparams, lm_params_from_reference(jax.tree.map(np.asarray, jparams), cfg)


def _close_leaves(got, want, rel, extra_atol=0.0):
    got, want = named_leaves(got), named_leaves(want)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].shape == w.shape and got[name].dtype == w.dtype, name
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=rel * float(w.abs().max()) + extra_atol, err_msg=name)


def _spy(monkeypatch):
    """Record each call of kernel 12's forward (its ``causal``) and of its
    backward (``flash_attention_bwd``, one call for each launch of D, dK/dV
    and dQ on a card)."""
    calls = {"forward": [], "backward": []}
    forward, backward = ops.flash_attention, fa.flash_attention_bwd

    def spy_forward(q, k, v, causal=True):
        calls["forward"].append(causal)
        return forward(q, k, v, causal=causal)

    def spy_backward(*args, causal=True):
        calls["backward"].append(causal)
        return backward(*args, causal=causal)

    monkeypatch.setattr(ops, "flash_attention", spy_forward)
    monkeypatch.setattr(fa, "flash_attention_bwd", spy_backward)
    return calls


# ---------------------------------------------------------------------------
# head widths past kernel 12's: the plain path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd", [WIDE, fa.MAX_D])
@pytest.mark.parametrize("form", ["self", "prefill", "cross"])
def test_kernel_12_takes_only_the_heads_it_can(form, hd, monkeypatch):
    """``layers.attention`` calls kernel 12 at a head width up to its
    MAX_D and never past it: self-attention (stablelm's smoke config), the
    prefill into a cache, and cross-attention over as many keys as queries
    (seamless's)."""
    arch = "seamless-m4t-large-v2" if form == "cross" else "stablelm-3b"
    cfg = configs.get_smoke_config(arch).replace(head_dim=hd)
    p = L.init_attention(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((2, 12, cfg.d_model), generator=torch.Generator().manual_seed(1))
    calls = _spy(monkeypatch)
    if form == "self":
        out, _ = L.attention(x, p, cfg)
    elif form == "prefill":
        cache = L.init_attention_cache(cfg, 2, 16, torch.float32)
        out, _ = L.attention(x, p, cfg, cache=cache, cache_pos=0)
    else:
        out, _ = L.attention(x, p, cfg, x_kv=x.flip(1), rope=False)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert calls["forward"] == ([] if hd > fa.MAX_D else [form != "cross"])


@pytest.mark.parametrize("arch", ["stablelm-3b", "seamless-m4t-large-v2"])
def test_wide_heads_match_the_reference(arch, monkeypatch):
    """At head_dim 160 the whole model (stablelm: causal self-attention;
    seamless: the encoder's full, the decoder's causal and the cross
    attention) computes the reference's logits, loss and gradients with no
    call of kernel 12."""
    jcfg, cfg, jparams, params = _pair(arch, head_dim=WIDE)
    batch = _numpy_batch(cfg, 12)
    calls = _spy(monkeypatch)
    want = jax.jit(lambda p, b: jget_api(jcfg).forward(p, jcfg, b, compute_dtype=jnp.float32))(
        jparams, _j(batch, drop=("labels",)))
    got = get_api(cfg).forward(params, cfg, _t(batch, drop=("labels",)),
                               compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_REL * float(np.abs(np.asarray(want)).max()))
    base = dict(seq_len=12, global_batch=B, compute_dtype="float32", remat="full")
    jt, tt = jconfigs.TrainConfig(**base), configs.TrainConfig(**base)
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda p, b: jloss_fn(p, jcfg, b, jt),
                                             has_aux=True))(jparams, _j(batch))
    loss, grads = value_and_grad(params, cfg, _t(batch), tt)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _close_leaves(grads, lm_params_from_reference(jax.tree.map(np.asarray, jg), cfg), F32_REL)
    assert calls == {"forward": [], "backward": []}


def test_paligemma_with_an_empty_prefix_matches_the_reference(monkeypatch):
    """paligemma's head of 256 (here the smoke config at 160) over an
    empty image prefix: a plain causal mask, kernel 12's function but past
    its width, so the plain path; the prefill's logits and cache are the
    reference's."""
    jcfg, cfg, jparams, params = _pair("paligemma-3b", head_dim=WIDE)
    batch = _numpy_batch(cfg, 12, prefix=0)
    calls = _spy(monkeypatch)
    jlogits, jcache = jax.jit(lambda p, b: jget_api(jcfg).prefill(
        p, jcfg, b, 16, compute_dtype=jnp.float32, cache_dtype=jnp.float32))(
        jparams, _j(batch, drop=("labels",)))
    logits, cache = get_api(cfg).prefill(params, cfg, _t(batch, drop=("labels",)), 16,
                                         compute_dtype=torch.float32,
                                         cache_dtype=torch.float32)
    want = np.asarray(jlogits)
    np.testing.assert_allclose(logits.numpy(), want, rtol=0,
                               atol=F32_REL * float(np.abs(want).max()))
    want = {".".join(str(k.key) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(jcache)[0]}
    got = named_leaves(cache)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                   atol=F32_REL * float(np.abs(w).max()), err_msg=name)
    assert calls == {"forward": [], "backward": []}


# ---------------------------------------------------------------------------
# each family's train step against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_three_steps_match_the_reference(arch):
    """Three ``build_train_step`` steps with ``remat="full"`` against the
    reference's jitted train step from the same weights and AdamW state:
    each step's loss (deepseek's with its aux loss), lr and grad norm, then
    the moments and the parameters."""
    base = dict(seq_len=S, global_batch=B, compute_dtype="float32", remat="full",
                learning_rate=1e-3, warmup_steps=2, total_steps=10)
    jt, tt = jconfigs.TrainConfig(**base), configs.TrainConfig(**base)
    jcfg, cfg, jparams, params = _pair(arch)
    jstate = jopt.adamw_init(jparams)
    state = adamw_state_from_reference(jax.tree.map(np.asarray, dataclasses.asdict(jstate)),
                                       cfg)
    jstep, step = jax.jit(jbuild_train_step(jcfg, jt)), build_train_step(cfg, tt)
    lrs = []
    for i in range(3):
        batch = _numpy_batch(cfg, S, seed=i)
        jparams, jstate, jm = jstep(jparams, jstate, _j(batch))
        params, state, m = step(params, state, _t(batch))
        for key in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, err_msg=key)
        lrs.append(float(jm["lr"]))
    assert int(state.step) == int(jstate.step) == 3
    def as_port(tree):
        return lm_params_from_reference(jax.tree.map(np.asarray, tree), cfg)

    _close_leaves(state.mu, as_port(jstate.mu), 1e-4)
    _close_leaves(state.nu, as_port(jstate.nu), 1e-4)
    _close_leaves(params, as_port(jparams), 1e-4, extra_atol=1e-2 * sum(lrs))


#: kernel 12's calls in one differentiated ``remat="full"`` step at the
#: smoke widths: (forward calls, backward calls). Each checkpoint runs its
#: forward twice (the step's and the backward's recompute) and its backward
#: once. zamba2: one shared attention a group (4 layers / 2); seamless: 2
#: encoder (full), 2 decoder self (causal) and 2 cross (full) calls.
SMOKE_TRAIN_CALLS = {"mamba2-780m": (0, 0), "zamba2-2.7b": (4, 2),
                     "seamless-m4t-large-v2": (12, 6), "paligemma-3b": (0, 0),
                     "deepseek-v2-lite-16b": (0, 0)}


@pytest.mark.parametrize("arch", FAMILIES)
def test_kernel_12_calls_in_a_train_step(arch, monkeypatch):
    """The forward and backward calls of kernel 12 in ``value_and_grad``
    under ``remat="full"``, so that a routing slip shows here before the
    card: seamless's in order (encoder full; decoder causal self, full
    cross), each recomputed once."""
    cfg = configs.get_smoke_config(arch)
    params = get_api(cfg).init_params(torch.Generator().manual_seed(0), cfg)
    calls = _spy(monkeypatch)
    loss, grads = value_and_grad(params, cfg, _t(_numpy_batch(cfg, 12)),
                                 configs.TrainConfig(compute_dtype="float32", remat="full"))
    assert bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all())
                                              for g in leaves(grads))
    fwd, bwd = SMOKE_TRAIN_CALLS[arch]
    assert (len(calls["forward"]), len(calls["backward"])) == (fwd, bwd)
    if cfg.family == "encdec":
        enc = [False] * cfg.n_enc_layers
        dec = [True, False] * cfg.n_layers
        assert sorted(calls["forward"]) == sorted(2 * (enc + dec))
        assert sorted(calls["backward"]) == sorted(enc + dec)
