"""Kernel 12, flash attention: the port's plain version against the
reference's Pallas kernel (interpret mode on the CPU) and its oracle, on the
same numpy inputs.

Tolerances: f32 atol 2e-6, rtol 1e-5, the reference's own kernel test's
(the online softmax and the one-shot softmax sum in different orders); bf16
atol = rtol = 2e-2, also the reference's (one rounding of the output to bf16
on each side, of f32 values that differ in the last bits). The CUDA kernel
is held against the same plain version on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

F32_TOL = dict(atol=2e-6, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _qkv(bh, bkv, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal((n, s, d)) * 0.5).astype(np.float32)
                 for n in (bh, bkv, bkv))


def _port(q, k, v, causal=True, dtype=torch.float32):
    out = tops.flash_attention(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)),
                               causal=causal)
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("bh,bkv,s,d", [
    (4, 4, 128, 32),      # MHA
    (8, 2, 100, 16),      # GQA rep=4, ragged seq
    (6, 1, 256, 64),      # MQA
    (2, 2, 513, 32),      # seq not divisible by blocks
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_the_pallas_kernel_and_its_oracle(bh, bkv, s, d, causal):
    q, k, v = _qkv(bh, bkv, s, d)
    got = _port(q, k, v, causal)
    pallas = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, block_q=64, block_k=64)
    oracle = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal=causal)
    np.testing.assert_allclose(got, np.asarray(pallas), **F32_TOL)
    np.testing.assert_allclose(got, np.asarray(oracle), **F32_TOL)


def test_bf16():
    q, k, v = (a.astype(ml_dtypes.bfloat16) for a in _qkv(4, 4, 128, 32))
    got = _port(*(a.astype(np.float32) for a in (q, k, v)), dtype=torch.bfloat16)
    pallas = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  block_q=64, block_k=64)
    oracle = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32), **BF16_TOL)
    np.testing.assert_allclose(got, np.asarray(oracle, np.float32), **BF16_TOL)


def test_f32_queries_over_bf16_keys_and_values():
    """The serve path's mix (f32 q over the bf16 cache) computes the f32
    function of the bf16 values, the oracle's arithmetic."""
    q, k, v = _qkv(8, 2, 100, 24, seed=3)
    kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (k, v))
    got = tops.flash_attention(torch.from_numpy(q), kb, vb)
    assert got.dtype == torch.float32
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(kb.float().numpy()),
                                    jnp.asarray(vb.float().numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_four_dim_strided_form_is_the_flattened_form():
    """(b, h, s, d) views of (b, s, h, d) tensors, as the model passes them,
    give the (bh, s, d) result: query head h of batch b reads kv head
    h // rep of the same batch."""
    b, h, kv, s, d = 2, 6, 2, 40, 16
    q, k, v = _qkv(b * h, b * kv, s, d, seed=5)
    flat = _port(q, k, v).reshape(b, h, s, d)
    q4 = torch.from_numpy(q).reshape(b, h, s, d).transpose(1, 2).contiguous().transpose(1, 2)
    k4, v4 = (torch.from_numpy(a).reshape(b, kv, s, d).transpose(1, 2).contiguous()
              .transpose(1, 2) for a in (k, v))
    assert not q4.is_contiguous()
    got = tops.flash_attention(q4, k4, v4)
    np.testing.assert_allclose(got.numpy(), flat, **F32_TOL)


def test_matches_model_attention():
    """The counterpart of the reference's test: the port's plain flash
    attention reproduces the reference zoo's grouped self-attention, on the
    reference's weights and input. atol 5e-5, rtol 1e-4: the reference's
    own tolerance for this comparison (two f32 projections around it)."""
    import jax

    from repro.configs import get_smoke_config
    from repro.models import layers as L
    cfg = get_smoke_config("h2o-danube-3-4b").replace(sliding_window=0)
    p = L.init_attention(jax.random.key(0), cfg)
    x = np.random.default_rng(1).standard_normal((2, 64, cfg.d_model)).astype(np.float32) * 0.5
    out_model, _ = L.attention(jnp.asarray(x), p, cfg, rope=False)

    b, s = 2, 64
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    w = {name: torch.from_numpy(np.array(a)) for name, a in p.items()}
    xt = torch.from_numpy(x)
    q = (xt @ w["wq"]).reshape(b, s, h, hd).transpose(1, 2)
    k = (xt @ w["wk"]).reshape(b, s, kv, hd).transpose(1, 2)
    v = (xt @ w["wv"]).reshape(b, s, kv, hd).transpose(1, 2)
    o = tops.flash_attention(q.reshape(b * h, s, hd), k.reshape(b * kv, s, hd),
                             v.reshape(b * kv, s, hd))
    o = o.reshape(b, h, s, hd).transpose(1, 2).reshape(b, s, h * hd)
    np.testing.assert_allclose((o @ w["wo"]).numpy(), np.asarray(out_model),
                               atol=5e-5, rtol=1e-4)


def test_cpu_call_launches_no_kernel_and_other_devices_raise():
    """On the CPU the plain version runs and nothing is counted; off the CPU
    the wrapper launches the kernel or raises (a tensor that is not on a
    CUDA device is refused before any pointer reaches C)."""
    tops.reset_launch_counts()
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 16, 8))
    tops.flash_attention(q, k, v)
    assert tops.launch_counts()["flash_attention"] == 0
    meta = torch.empty((2, 16, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tops.flash_attention(meta, meta, meta)


def test_plain_version_four_dim_form_is_the_three_dim_one():
    """The plain version, which chip_smoke holds the kernel against, gives
    the same bits in its 4-D form (b = 1) as in the reference's layout."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(6, 3, 33, 8, seed=7))
    want = tref.flash_attention_ref(q, k, v, causal=False)
    got4 = tref.flash_attention_ref(q[None], k[None], v[None], causal=False)[0]
    torch.testing.assert_close(got4, want, rtol=0, atol=0)
