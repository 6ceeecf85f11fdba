"""Kernel 12, flash attention: the port's plain version against the
reference's Pallas kernel (interpret mode on the CPU) and its oracle, on the
same numpy inputs.

Tolerances: f32 atol 2e-6, rtol 1e-5, the reference's own kernel test's
(the online softmax and the one-shot softmax sum in different orders); bf16
atol = rtol = 2e-2, also the reference's (one rounding of the output to bf16
on each side, of f32 values that differ in the last bits). The CUDA kernel
is held against the same plain version on the card by ``chip_smoke.py``.
The backward's plain version, which the CPU runs and the card's backward
kernels are held to, is held to jax.vjp of the reference's oracle and to
autograd through the plain forward (tolerances at ``GRAD_F32_REL``).
"""
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

# one torch thread a process: the test run starts several processes at once,
# and torch using every core in each of them slows all of them down
torch.set_num_threads(1)

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


def test_plain_version_against_the_pallas_kernel_at_the_serve_mix():
    """The serve path's mix, f32 q over bf16 K and V, at the Pallas
    kernel's 64-key tiles. The Pallas kernel rounds each tile's unnormalised
    p to v's type before its PV product (``p.astype(v.dtype)``,
    ``repro/kernels/flash_attention.py:65``); its oracle and the port (the
    plain version and kernel 12) keep p in f32. So the two differ by
    1.28e-3 here (max|o| 1.31), within the reference's bf16 tolerance and
    far outside its f32 one: the difference ROADMAP queue 3 records as
    accepted. The port's side is held to the oracle at f32 tolerance in
    ``test_f32_queries_over_bf16_keys_and_values``."""
    q, k, v = _qkv(8, 2, 256, 32, seed=3)
    kb, vb = (a.astype(ml_dtypes.bfloat16) for a in (k, v))
    got = tops.flash_attention(torch.from_numpy(q), *(torch.from_numpy(a.astype(np.float32))
                                                     .to(torch.bfloat16) for a in (kb, vb)))
    pallas = np.asarray(jops.flash_attention(jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb),
                                             block_q=64, block_k=64), np.float32)
    np.testing.assert_allclose(got.numpy(), pallas, **BF16_TOL)
    assert np.abs(got.numpy() - pallas).max() > 1e-4   # the rounding shows


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 stored mantissa bits), to nearest with ties
    away from zero: ``cvt.rna.tf32.f32``, by bit arithmetic."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _parts(x: torch.Tensor):
    """x as the kernel's TF32 operands: (hi, lo) of an f32 tensor, or one
    exact part (lo None) of a bf16 one."""
    if x.dtype == torch.bfloat16:
        return x.float(), None
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _split_matmul(a, b):
    """a @ b as the kernel's split-TF32 terms, lo hi + hi lo + hi hi (lo lo
    dropped); the products are exact in f32, the sums f32."""
    (ah, al), (bh, bl) = a, b
    out = ah @ bh
    if bl is not None:
        out = ah @ bl + out
    if al is not None:
        out = al @ bh + out
    return out


def _emulated_kernel(q, k, v, causal, tile=64):
    """Kernel 12's arithmetic on the CPU: the split-TF32 logits, then the
    online softmax over 64-key tiles with p split for the PV product.
    Returns (logits, out), both f32."""
    rep = q.shape[0] // k.shape[0]
    s, d = q.shape[-2:]
    kk, vv = (a.repeat_interleave(rep, dim=0) for a in (k, v))
    logits = _split_matmul(_parts(q), tuple(None if p is None else p.transpose(1, 2)
                                            for p in _parts(kk))) * (1.0 / math.sqrt(d))
    m = torch.full((q.shape[0], s, 1), -torch.inf)
    l = torch.zeros((q.shape[0], s, 1))
    acc = torch.zeros(q.shape)
    rows = torch.arange(s)[:, None]
    for k0 in range(0, s, tile):
        x = logits[..., k0:k0 + tile]
        if causal:
            x = x.masked_fill(torch.arange(k0, min(k0 + tile, s))[None, :] > rows, -torch.inf)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        m_safe = torch.where(m_new == -torch.inf, 0.0, m_new)
        p = torch.where(x == -torch.inf, 0.0, torch.exp(x - m_safe))
        corr = torch.where(m == -torch.inf, 0.0, torch.exp(m - m_safe))
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _split_matmul(_parts(p), _parts(vv[:, k0:k0 + tile]))
        m = m_new
    return logits, acc / l.clamp_min(1e-30)


@pytest.mark.parametrize("bh,bkv,s,d", [
    (4, 4, 128, 32),
    (8, 2, 100, 16),
    (6, 1, 256, 64),
    (2, 2, 513, 32),
    (4, 1, 130, 120),     # the GQA d = 120 of chip_smoke
    (2, 2, 70, 128),      # MAX_D, the MQA width
])
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float32])
def test_split_tf32_products_keep_f32_accuracy(bh, bkv, s, d, kv_dtype):
    """The tensor-core design of kernel 12 keeps its f32 function: with q,
    p (and f32 K, V) split into two TF32 parts, the logits and the output
    stay within F32_TOL of the plain version (f32 q over bf16 K/V: two terms
    a product; over f32 K/V: three). One TF32 term would not: its logits
    miss F32_TOL. The tensor cores' own summation order is not emulated."""
    q, k, v = _qkv(bh, bkv, s, d, seed=d)
    q = torch.from_numpy(q)
    k, v = (torch.from_numpy(a).to(kv_dtype) for a in (k, v))
    logits, out = _emulated_kernel(q, k, v, causal=True)
    kk = k.repeat_interleave(bh // bkv, dim=0).float()
    want_logits = torch.einsum("hsd,htd->hst", q, kk) / math.sqrt(d)
    np.testing.assert_allclose(logits.numpy(), want_logits.numpy(), **F32_TOL)
    np.testing.assert_allclose(out.numpy(), tref.flash_attention_ref(q, k, v).numpy(), **F32_TOL)
    one_term = torch.einsum("hsd,htd->hst", _tf32(q), _tf32(kk)) / math.sqrt(d)
    assert not torch.allclose(one_term, want_logits, **F32_TOL)


def test_wrapper_stages_unaligned_rows_element_by_element():
    """The wrapper takes the kernel's 16-byte cp.async path only where every
    row of q, k and v starts on 16 bytes and d fills whole 16-byte chunks
    (the model's activations and cache views at d = 80), and otherwise the
    scalar-staging template: a head width of 17 f32, an odd row offset."""
    from repro_torch.kernels.flash_attention import _rows_aligned16
    act = torch.zeros((2, 100, 32, 80))                        # (b, s, h, d)
    cache = torch.zeros((2, 2, 132, 32, 80), dtype=torch.bfloat16)
    assert _rows_aligned16(act.transpose(1, 2))
    assert _rows_aligned16(cache[0, :, :100].transpose(1, 2))
    assert not _rows_aligned16(torch.zeros((1, 4, 50, 17)))    # 68-byte rows
    assert not _rows_aligned16(torch.zeros((1, 4, 50, 24), dtype=torch.bfloat16)[..., 1:17])
    assert _rows_aligned16(torch.zeros((1, 1, 50, 8), dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# the backward: the plain version the CPU runs and the card's kernels are
# held to (chip_smoke.py's phase_flash_attention_backward)
# ---------------------------------------------------------------------------

#: gradients against jax.vjp of the reference oracle, relative to max|grad|:
#: f32 1e-5 (sums in other orders; measured 7.0e-7); where an input is bf16,
#: 2**-6, two bf16 steps at the top of the range: each side rounds its f32
#: gradient to bf16 once, and the f32 values differ a little more there
#: (the plain backward's D reads the output as stored in bf16, where the
#: reference's derivative uses the unrounded one; measured 8.1e-3)
GRAD_F32_REL, GRAD_BF16_REL = 1e-5, 2.0 ** -6

BWD_CASES = [
    (4, 4, 64, 32),       # MHA
    (8, 2, 100, 16),      # GQA rep 4, ragged
    (6, 1, 130, 24),      # MQA, past two 64-row tiles
]


def _bwd_inputs(bh, bkv, s, d, seed, q_dtype, kv_dtype):
    q, k, v = _qkv(bh, bkv, s, d, seed=seed)
    dout = (np.random.default_rng(seed + 100).standard_normal((bh, s, d)) * 0.5).astype(np.float32)
    q, dout = (torch.from_numpy(a).to(q_dtype) for a in (q, dout))
    k, v = (torch.from_numpy(a).to(kv_dtype) for a in (k, v))
    return q, k, v, dout


def _assert_grads_close(got, want, rel):
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w.float() if isinstance(w, torch.Tensor) else np.asarray(w, np.float32))
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=rel * np.abs(w).max())


@pytest.mark.parametrize("bh,bkv,s,d", BWD_CASES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("types", ["f32", "f32/bf16", "bf16"])
def test_plain_backward_matches_the_reference_oracle_vjp(bh, bkv, s, d, causal, types):
    """(dq, dk, dv) of the plain backward, given the plain forward's output
    and L, against jax.vjp of the reference's oracle on the same inputs and
    output gradient, in the inputs' types."""
    q_dtype, kv_dtype = {"f32": (torch.float32,) * 2, "bf16": (torch.bfloat16,) * 2,
                         "f32/bf16": (torch.float32, torch.bfloat16)}[types]
    q, k, v, dout = _bwd_inputs(bh, bkv, s, d, d + s, q_dtype, kv_dtype)
    out, lse = tref.flash_attention_ref(q, k, v, causal=causal, return_lse=True)
    got = tref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal)
    assert [g.dtype for g in got] == [q_dtype, kv_dtype, kv_dtype]
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]

    def j(t):
        return jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)

    _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(a, b, c, causal=causal),
                     j(q), j(k), j(v))
    want = [np.asarray(g, np.float32) for g in vjp(j(dout))]
    rel = GRAD_BF16_REL if torch.bfloat16 in (q_dtype, kv_dtype) else GRAD_F32_REL
    _assert_grads_close(got, want, rel)
    # L is the row log-sum-exp of the reference's scaled, masked logits
    kk = jnp.repeat(j(k), bh // bkv, axis=0).astype(jnp.float32)
    logits = jnp.einsum("hsd,htd->hst", j(q).astype(jnp.float32), kk) / np.sqrt(np.float32(d))
    if causal:
        logits = jnp.where(jnp.tril(jnp.ones((s, s), bool))[None], logits, -jnp.inf)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax.nn.logsumexp(logits, axis=-1)),
                               rtol=0, atol=2e-6)


@pytest.mark.parametrize("bh,bkv,s,d", BWD_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_is_autograd_through_the_plain_forward(bh, bkv, s, d, causal):
    q, k, v, dout = _bwd_inputs(bh, bkv, s, d, 7, torch.float32, torch.float32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tref.flash_attention_ref(*leaves, causal=causal).backward(dout)
    out, lse = tref.flash_attention_ref(q, k, v, causal=causal, return_lse=True)
    got = tref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal)
    _assert_grads_close(got, [t.grad for t in leaves], GRAD_F32_REL)


@pytest.mark.parametrize("bh,bkv,s,d", BWD_CASES)
@pytest.mark.parametrize("types", ["f32", "f32/bf16", "bf16"])
def test_each_backward_kernels_plain_version_is_its_part_of_the_whole(bh, bkv, s, d, types):
    """``grads="q"`` (the dQ kernel's plain version) and ``grads="kv"`` (the
    dK/dV kernel's) give the bits of the whole plain backward's parts."""
    q_dtype, kv_dtype = {"f32": (torch.float32,) * 2, "bf16": (torch.bfloat16,) * 2,
                         "f32/bf16": (torch.float32, torch.bfloat16)}[types]
    q, k, v, dout = _bwd_inputs(bh, bkv, s, d, 3 * d + s, q_dtype, kv_dtype)
    out, lse = tref.flash_attention_ref(q, k, v, return_lse=True)
    dq, dk, dv = tref.flash_attention_bwd_ref(q, k, v, out, lse, dout)
    (dq_part,) = tref.flash_attention_bwd_ref(q, k, v, out, lse, dout, grads="q")
    dk_part, dv_part = tref.flash_attention_bwd_ref(q, k, v, out, lse, dout, grads="kv")
    for part, whole in ((dq_part, dq), (dk_part, dk), (dv_part, dv)):
        assert part.dtype == whole.dtype and torch.equal(part, whole)


def test_the_autograd_function_on_the_cpu():
    """With grad on, ``flash_attention`` is the autograd Function: the same
    output as a call without grad, and its gradients are the plain backward's
    at its saved output and L; the (b, h, s, d) strided views of the model
    give the flattened form's gradients in the views' memory order. A call
    without grad, or on inputs that need none, builds no graph."""
    b, h, kv, s, d = 2, 6, 2, 40, 16
    q, k, v, dout = _bwd_inputs(b * h, b * kv, s, d, 11, torch.float32, torch.float32)
    with torch.no_grad():
        plain = tops.flash_attention(q, k, v)
    assert tops.flash_attention(q, k, v).grad_fn is None
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tops.flash_attention(*leaves)
    assert out.grad_fn is not None and torch.equal(out.detach(), plain)
    out.backward(dout)
    o, lse = tref.flash_attention_ref(q, k, v, return_lse=True)
    want = tref.flash_attention_bwd_ref(q, k, v, o, lse, dout)
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)
    # the model's layout: (b, s, h, d) activations seen as (b, h, s, d)
    act = [t.reshape(b, -1, s, d).transpose(1, 2).contiguous().requires_grad_()
           for t in (q, k, v)]
    out4 = tops.flash_attention(*(a.transpose(1, 2) for a in act))
    out4.backward(dout.reshape(b, h, s, d))
    for a, t in zip(act, leaves):
        assert a.grad.is_contiguous()
        np.testing.assert_allclose(a.grad.transpose(1, 2).reshape(t.shape).numpy(),
                                   t.grad.numpy(), rtol=1e-6, atol=1e-7)
