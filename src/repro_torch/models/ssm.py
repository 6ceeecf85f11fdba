"""Mamba2 (SSD, state-space duality) blocks and the mamba2 LM, the port of
``repro/models/ssm.py``.

Prefill and training use the chunked SSD (Dao & Gu 2024): the sequence is
cut into chunks of ``q`` steps; the terms within a chunk are dense (q, q)
products and the chunks are joined by a recurrence over their summary
states. The reference joins them with ``jax.lax.associative_scan`` (a
tree); here a loop over the chunks sums the same terms in order. Decode
carries (conv tail, state (b, h, p, n)): O(1) a token. The SSD is plain
torch, as the reference computes it in jnp (no Pallas kernel).

Shapes: b batch, s sequence, h SSM heads, p head width, n state width,
q chunk. The decode cache is stacked on the layers, (L, b, d_conv - 1,
conv_dim) and (L, b, h, p, n), and updated in place: a decode step writes
each layer's new conv tail and state back into it, in the cache's type
(the reference returns a new cache whose state is promoted to f32; the
two agree on the default f32 cache).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distributed import collectives as C
from ..distributed.sharding import stacked
from . import layers as L
from .transformer import _cast, checkpointed, head_logits


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.d_state          # x, B, C go through the conv
    return s, d_inner, n_heads, conv_dim


def init_mamba_block(gen, cfg: ModelConfig, dtype=torch.float32):
    s, d_inner, h, conv_dim = _dims(cfg)
    dev = L._device(gen)
    in_dim = 2 * d_inner + 2 * s.d_state + h    # z, x, B, C, dt
    u = (torch.empty((h,), device="meta") if gen is None
         else torch.rand((h,), generator=gen, device=dev))
    lo, hi = math.log(s.dt_min), math.log(s.dt_max)
    dt = torch.exp(u * (hi - lo) + lo)
    dt_bias = dt + torch.log(-torch.expm1(-dt))  # inverse softplus
    return {
        "ln": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "in_proj": L.dense_init(gen, (cfg.d_model, in_dim), cfg.d_model, dtype),
        "conv_w": L._normal(gen, (s.d_conv, conv_dim)).mul_(0.1).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "dt_bias": dt_bias.to(dtype),
        "a_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32, device=dev)).to(dtype),
        "d_skip": torch.ones((h,), dtype=dtype, device=dev),
        "norm": torch.ones((d_inner,), dtype=dtype, device=dev),
        "out_proj": L.dense_init(gen, (d_inner, cfg.d_model), d_inner, dtype),
    }


def mamba_block_specs(cfg: ModelConfig):
    return {
        "ln": ("embed",),
        "in_proj": ("embed", "ssm_inner"),
        "conv_w": (None, "ssm_inner"),
        "conv_b": ("ssm_inner",),
        "dt_bias": ("ssm_heads",),
        "a_log": ("ssm_heads",),
        "d_skip": ("ssm_heads",),
        "norm": ("ssm_inner",),
        "out_proj": ("ssm_inner", "embed"),
    }


def _split_proj(cfg, zxbcdt):
    s, d_inner, h, _ = _dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner, s.d_state, s.d_state, h], dim=-1)


def _segsum(x):
    """x (..., q, h) -> (..., h, q, q) lower-triangular pairwise sums
    seg[i, j] = sum_{j < t <= i} x_t (i >= j), -inf above the diagonal.
    The mask comes before the exp the caller takes: masking after it would
    overflow above the diagonal, and inf * 0 makes NaN gradients."""
    q = x.shape[-2]
    cs = torch.cumsum(x, dim=-2).movedim(-1, -2)            # (..., h, q)
    diff = cs[..., :, None] - cs[..., None, :]               # (..., h, q, q)
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x, dt, a, b_ssm, c_ssm, *, chunk):
    """Chunked SSD. x (b, s, h, p), dt (b, s, h), a (h,) < 0 (-exp(a_log)),
    b_ssm and c_ssm (b, s, n). Returns y (b, s, h, p) and the final state
    (b, h, p, n)."""
    bsz, s, h, p = x.shape
    n = b_ssm.shape[-1]
    q = min(chunk, s)
    s_orig = s
    if s % q:
        # pad with zero-input steps: dt = 0 gives unit decay and no state
        # contribution, so the outputs and states of real positions are unchanged
        pad = q - s % q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_ssm = F.pad(b_ssm, (0, 0, 0, pad))
        c_ssm = F.pad(c_ssm, (0, 0, 0, pad))
        s = s + pad
    nc = s // q

    xc = x.reshape(bsz, nc, q, h, p)
    dtc = dt.reshape(bsz, nc, q, h)
    bc = b_ssm.reshape(bsz, nc, q, n)
    cc = c_ssm.reshape(bsz, nc, q, n)

    da = dtc * a                                              # (b, c, q, h)
    xdt = xc * dtc[..., None]                                 # (b, c, q, h, p)

    # diagonal (within-chunk) term: dense (q, q) products
    l_mat = torch.exp(_segsum(da))                            # (b, c, h, q, q)
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)          # (b, c, q, q)
    m = scores[:, :, None] * l_mat                            # (b, c, h, q, q)
    y_diag = torch.einsum("bchij,bcjhp->bcihp", m, xdt)
    del l_mat, m

    # chunk summary states: S_c = sum_j exp(cs_end - cs_j) B_j x_j^T
    cs = torch.cumsum(da, dim=2)                              # (b, c, q, h)
    decay_end = torch.exp(cs[:, :, -1:, :] - cs)              # (b, c, q, h)
    s_chunk = torch.einsum("bcqn,bcqhp->bchpn", bc, xdt * decay_end[..., None])

    # inter-chunk recurrence, in chunk order: the state at the start of
    # chunk c is the state at the start of c - 1, decayed over it, plus its
    # summary
    chunk_decay = torch.exp(cs[:, :, -1, :])                  # (b, c, h)
    state = torch.zeros_like(s_chunk[:, 0])
    starts = []
    for c in range(nc):
        starts.append(state)
        state = state * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    h_start = torch.stack(starts, dim=1)                      # (b, c, h, p, n)

    # off-diagonal term: y_off[i] = (C_i . H_start) * exp(cs_i)
    y_off = torch.einsum("bcqn,bchpn->bcqhp", cc, h_start) * torch.exp(cs)[..., None]

    y = (y_diag + y_off).reshape(bsz, s, h, p)[:, :s_orig]
    return y, state


def _local_proj(cfg, zxbcdt, w, conv_b, grp):
    """(z, x, B, C, dt, conv_w, conv_b, zxbcdt) of this rank's SSM heads:
    z, x and dt of its heads, B and C whole, the conv's weights of its x
    columns and of B and C, and the whole projection. Under ``grp`` the
    shards of ``in_proj``, ``conv_w`` and ``conv_b`` are contiguous slices
    of z | x | B | C | dt and of x | B | C, not the rank's heads: the
    projection and the conv's weights are gathered whole
    (``gather_summed``: a rank's gradient is its heads' share, and B and C
    are every rank's) and each rank takes its own columns."""
    s, d_inner, h, _ = _dims(cfg)
    if grp is None:
        return (*_split_proj(cfg, zxbcdt), w, conv_b, zxbcdt)
    zxbcdt = C.gather_summed(zxbcdt, grp)
    w, conv_b = C.gather_summed(w, grp), C.gather_summed(conv_b, grp)
    m, r = dist.get_world_size(grp), C.rank(grp)
    di, hl, n = d_inner // m, h // m, s.d_state
    z = zxbcdt[..., r * di:(r + 1) * di]
    x = zxbcdt[..., d_inner + r * di:d_inner + (r + 1) * di]
    b_ssm, c_ssm = torch.split(zxbcdt[..., 2 * d_inner:2 * d_inner + 2 * n], n, dim=-1)
    dt = zxbcdt[..., 2 * d_inner + 2 * n + r * hl:2 * d_inner + 2 * n + (r + 1) * hl]
    return (z, x, b_ssm, c_ssm, dt, _conv_cols(w, d_inner, grp),
            _conv_cols(conv_b, d_inner, grp), zxbcdt)


def _conv_cols(t, d_inner, grp):
    """The columns of a whole x | B | C tensor (last dimension) that this
    rank's conv reads: its heads' x columns, then B and C."""
    di, r = d_inner // dist.get_world_size(grp), C.rank(grp)
    return torch.cat([t[..., r * di:(r + 1) * di], t[..., d_inner:]], dim=-1)


def _conv_shard(xbc, grp):
    """This rank's contiguous "ssm_inner" slice of a whole x | B | C
    tensor (last dimension): its shard of the conv cache."""
    width = xbc.shape[-1] // dist.get_world_size(grp)
    return xbc.narrow(-1, C.rank(grp) * width, width)


def _gated_norm(y, gamma, eps, d_inner, grp):
    """``layers.rms_norm`` over the whole d_inner of y, the rank's columns
    of it under ``grp``: their sums of squares summed over the ranks
    (``all_sum``)."""
    if grp is None:
        return L.rms_norm(y, gamma, eps)
    y32 = y.float()
    var = C.all_sum(torch.sum(torch.square(y32), dim=-1, keepdim=True), grp) / d_inner
    return (y32 * torch.rsqrt(var + eps) * gamma.float()).to(y.dtype)


def mamba_forward(params, cfg: ModelConfig, u, *, chunk=None, return_cache=False):
    """Full-sequence Mamba2 block. u (b, s, d_model) -> (b, s, d_model).

    ``return_cache`` also returns the decode cache (conv tail and final
    state, both f32) so that prefill can hand off to the recurrent decode.

    Under rules and a mesh that shard "ssm_inner" and "ssm_heads", on the
    rank's shards: the SSD on its heads (:func:`_local_proj`), the gated
    norm summed over the ranks, ``out_proj``'s rows (its heads) summed by
    ``reduce``; the cache is the rank's shard, the final state of its
    heads and its contiguous "ssm_inner" slice of the whole x | B | C
    tail (not its heads' columns)."""
    s_cfg, d_inner, _, conv_dim = _dims(cfg)
    q = chunk or s_cfg.chunk
    grp = C.group("ssm_inner")
    res = u
    u = L.rms_norm(u, params["ln"], cfg.norm_eps)
    zxbcdt = C.enter(u, grp) @ params["in_proj"]
    z, x, b_ssm, c_ssm, dt, w, conv_b, whole = _local_proj(cfg, zxbcdt, params["conv_w"],
                                                           params["conv_b"], grp)

    # depthwise causal conv over (x, B, C)
    xbc_pre = torch.cat([x, b_ssm, c_ssm], dim=-1)            # (b, s, conv_dim)
    pad = w.shape[0] - 1
    xbc_p = F.pad(xbc_pre, (0, 0, pad, 0))
    conv = sum(xbc_p[:, i:i + xbc_pre.shape[1]] * w[i][None, None]
               for i in range(w.shape[0])) + conv_b
    xbc = F.silu(conv)
    x, b_ssm, c_ssm = torch.split(xbc, [x.shape[-1], s_cfg.d_state, s_cfg.d_state], dim=-1)

    dt = F.softplus(dt.float() + params["dt_bias"].float())
    a = -torch.exp(params["a_log"].float())
    xh = x.reshape(*x.shape[:2], -1, s_cfg.head_dim)
    y, final_state = ssd_chunked(xh.float(), dt, a, b_ssm.float(), c_ssm.float(), chunk=q)
    y = y + params["d_skip"].float()[None, None, :, None] * xh.float()
    y = y.reshape(*x.shape).to(u.dtype)
    y = _gated_norm(y * F.silu(z), params["norm"], cfg.norm_eps, d_inner, grp)
    out = res + C.reduce(y @ params["out_proj"], grp)
    if return_cache:
        tail = -(s_cfg.d_conv - 1)
        conv_tail = (xbc_pre[:, tail:] if grp is None else
                     _conv_shard(whole[:, tail:, d_inner:d_inner + conv_dim], grp))
        return out, {"conv": conv_tail.float(), "state": final_state}
    return out


# ---------------------------------------------------------------------------
# decode (recurrent, O(1) a token)
# ---------------------------------------------------------------------------


def init_mamba_cache(cfg: ModelConfig, batch, dtype=torch.float32, device=None):
    s, d_inner, h, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype, device=device),
        "state": torch.zeros((batch, h, s.head_dim, s.d_state), dtype=dtype, device=device),
    }


def mamba_cache_specs(cfg: ModelConfig):
    return {
        "conv": ("batch", None, "ssm_inner"),
        "state": ("batch", "ssm_heads", None, None),
    }


def mamba_decode_step(params, cfg: ModelConfig, u, cache):
    """u (b, 1, d_model); cache {conv (b, k - 1, conv_dim), state (b, h, p,
    n)}, written in place with the new conv tail and state. Returns (out,
    cache).

    Under rules and a mesh that shard "ssm_inner", on the rank's shards of
    the weights and of the cache: ``in_proj``'s output and the conv shard
    gathered over "model", the recurrence on the rank's heads (x, dt and z
    its heads', B and C whole), the gated norm summed over the ranks,
    ``out_proj`` summed by ``reduce``; the rank writes back its own conv
    columns and state heads."""
    s_cfg, d_inner, _, conv_dim = _dims(cfg)
    grp = C.group("ssm_inner")
    res = u
    un = L.rms_norm(u, params["ln"], cfg.norm_eps)
    zxbcdt = un @ params["in_proj"]
    z, x, b_ssm, c_ssm, dt, w, conv_b, whole = _local_proj(cfg, zxbcdt, params["conv_w"],
                                                           params["conv_b"], grp)
    di = x.shape[-1]                                          # the rank's x columns

    xbc_new = torch.cat([x, b_ssm, c_ssm], dim=-1)[:, 0]      # (b, di + 2n)
    cached = cache["conv"]
    if grp is not None:     # the whole history, then the columns this rank's conv reads
        cached = C.gather(cached, grp)
        whole_new = torch.cat([cached[:, 1:], whole[:, :, d_inner:d_inner + conv_dim]
                               .to(cached.dtype)], dim=1)
        cached = _conv_cols(cached, d_inner, grp)
    hist = torch.cat([cached, xbc_new[:, None].to(cache["conv"].dtype)],
                     dim=1)                                   # (b, k, di + 2n)
    conv = torch.einsum("bkc,kc->bc", hist.float(), w.float()) + conv_b
    xbc = F.silu(conv)
    x1, b1, c1 = torch.split(xbc, [di, s_cfg.d_state, s_cfg.d_state], dim=-1)

    dt1 = F.softplus(dt[:, 0].float() + params["dt_bias"].float())   # (b, h)
    a = -torch.exp(params["a_log"].float())                          # (h,)
    da = torch.exp(dt1 * a)                                          # (b, h)
    xh = x1.reshape(-1, di // s_cfg.head_dim, s_cfg.head_dim).float()   # (b, h, p)
    # state' = exp(dt a) state + dt * x (outer) B
    new_state = cache["state"] * da[..., None, None] \
        + torch.einsum("bhp,bn,bh->bhpn", xh, b1.float(), dt1)
    y = torch.einsum("bhpn,bn->bhp", new_state, c1.float())
    y = y + params["d_skip"].float()[None, :, None] * xh
    y = y.reshape(-1, 1, di).to(u.dtype)
    y = _gated_norm(y * F.silu(z), params["norm"], cfg.norm_eps, d_inner, grp)
    out = C.reduce(y @ params["out_proj"], grp)
    cache["conv"].copy_(hist[:, 1:] if grp is None else _conv_shard(whole_new, grp))
    cache["state"].copy_(new_state)
    return res + out, cache


# ---------------------------------------------------------------------------
# the mamba2 LM (mamba2-780m)
# ---------------------------------------------------------------------------


def init_params(gen, cfg: ModelConfig, dtype=torch.float32):
    """Random parameters drawn from ``gen`` on its device (shapes only, on
    the meta device, for ``gen=None``): ``{"embed", "layers": [block, ...],
    "ln_f"}``."""
    return {
        "embed": L.init_embed(gen, cfg, dtype),
        "layers": [init_mamba_block(gen, cfg, dtype) for _ in range(cfg.n_layers)],
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=L._device(gen)),
    }


def param_specs(cfg: ModelConfig):
    return {"embed": L.embed_specs(cfg), "layers": stacked(mamba_block_specs(cfg), "layers"),
            "ln_f": ("embed",)}


def forward(params, cfg: ModelConfig, tokens, *, compute_dtype=torch.bfloat16,
            remat: str = "full", prefix_embeds=None):
    """tokens (b, s) -> logits (b, s, v_padded), f32. ``remat`` "full" or
    "dots" recomputes each block in the backward (the reference's plain
    ``jax.checkpoint``)."""
    h = L.embed_tokens(params["embed"], tokens).to(compute_dtype)

    def body(x, lp):
        return mamba_forward(_cast(lp, compute_dtype), cfg, x)

    for lp in params["layers"]:
        h = checkpointed(body, remat, h, lp)
    return head_logits(params, cfg, h, compute_dtype)


def init_cache(cfg: ModelConfig, batch, max_len, dtype=torch.float32, device=None):
    """A block's cache stacked on a leading (n_layers,) axis (O(1) state:
    ``max_len`` is not used)."""
    del max_len
    one = init_mamba_cache(cfg, batch, dtype, device="meta")
    return {name: torch.zeros((cfg.n_layers, *a.shape), dtype=dtype, device=device)
            for name, a in one.items()}


def cache_specs(cfg: ModelConfig):
    return stacked(mamba_cache_specs(cfg), "layers")


def decode_step(params, cfg: ModelConfig, tokens, cache, pos, *, compute_dtype=torch.bfloat16):
    """One token step. tokens (b, 1); the cache stacked on the layers,
    updated in place; ``pos`` is not used (the state has no position).
    Returns (logits, cache)."""
    del pos
    h = L.embed_tokens(params["embed"], tokens).to(compute_dtype)
    for i, lp in enumerate(params["layers"]):
        layer_cache = {"conv": cache["conv"][i], "state": cache["state"][i]}   # views
        h, _ = mamba_decode_step(_cast(lp, compute_dtype), cfg, h, layer_cache)
    return head_logits(params, cfg, h, compute_dtype), cache


def prefill(params, cfg: ModelConfig, tokens, max_len, *, compute_dtype=torch.bfloat16,
            cache_dtype=torch.float32):
    """Full-sequence forward returning the logits and the stacked decode
    cache (f32 unless ``cache_dtype`` says otherwise)."""
    del max_len
    h = L.embed_tokens(params["embed"], tokens).to(compute_dtype)
    caches = []
    for lp in params["layers"]:
        h, c = mamba_forward(_cast(lp, compute_dtype), cfg, h, return_cache=True)
        caches.append(c)
    cache = {name: torch.stack([c[name] for c in caches]).to(cache_dtype)
             for name in ("conv", "state")}
    return head_logits(params, cfg, h, compute_dtype), cache
