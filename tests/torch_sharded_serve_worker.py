"""One rank of the sharded decode step and the expert-parallel moe_ffn on a
gloo group, for ``tests/test_torch_sharded_serve.py`` (spawned by
``repro_torch.testing.run_ranks``).

``run_cases`` runs each case of a list on this rank against the
reference's results (numpy, computed by the test beforehand) and returns
what the test reads, as plain numbers, strings and numpy arrays:

  decode  the smoke model's weights (the reference's, carried across by
          ``interop``) placed on a ("data", "model") mesh under
          ``build_rules(cfg, cell, ...)``, the cache of a one-device
          prefill of PROMPT tokens shared out by ``local_shard``, then
          STEPS greedy steps of ``build_decode_step`` under
          ``axis_rules(rules, mesh=mesh)``: the distances of the logits
          from the reference's jitted decode under the same rules and from
          the port's one-device decode, the tokens, the distance of the
          rank's cache shard from the slice of the one-device cache, and
          which forms ran (the flash decode, the expert-parallel and the
          gathered moe_ffn)
  moe     ``moe_ffn`` of one moe layer under ``build_rules(cfg, ...)`` on
          the rank's rows and shards: y (gathered over "data"), aux, the
          dropped copies, and the gradients of the global ``sum(y**2) +
          aux`` and of aux alone against ``jax.grad`` of the reference's
          there (each leaf's (max distance, max of the reference's)). Rank
          r's loss is ``sum(y_r**2) + aux / d`` (d the data ranks): the
          aux loss's backward is the identity on each rank (the train step
          averages over "data"), so the sum over "data" of each rank's
          gradient is the global loss's
  family  the sharded prefill (``build_prefill`` under the rules, the
          global batch) and STEPS greedy steps of the sharded decode from
          its cache, of any family, against the port's one-device prefill
          and decode and the reference's jitted runs under the same rules:
          the distances of the prefill's and the steps' logits, of
          ``enc_out`` and of the rank's cache shard (after the prefill and
          after the steps) from ``local_shard`` of one device's, the
          tokens, and kernel 12's calls (``ops.flash_attention``) in each
          (a smoke config with fields ``replace``-d reads its inputs by
          the case's ``name``)
  raise   the decode (or prefill) step of a rule or a width the layout
          cannot take: its error on this rank, then a barrier, which every
          rank reaches only if none of them entered a collective first

It imports torch, numpy and the port, nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os

import torch

torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.distributed import axis_rules  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import (build_rules, local_shard, param_shardings,  # noqa: E402
                                     placement_leaves, shard_tree, specs_like)
from repro_torch.models import get_api, layers, moe  # noqa: E402
from repro_torch.train._tree import leaves, named_leaves, tree_map  # noqa: E402
from repro_torch.train.train_step import build_decode_step, build_prefill  # noqa: E402

BATCH, PROMPT, STEPS, MAX_LEN = 2, 14, 4, 32


def smoke(arch: str, **replace):
    cfg = configs.get_smoke_config(arch)
    return cfg.replace(**replace) if replace else cfg


def cell(name):
    return {c.name: c for c in configs.SHAPE_CELLS}[name] if name else None


def placements(tree, specs, mesh):
    return param_shardings(mesh, specs_like(specs, tree))


def rel(got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = torch.as_tensor(got).detach().float(), torch.as_tensor(want).float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@contextlib.contextmanager
def naive(on: bool):
    before = os.environ.get("REPRO_NAIVE")
    os.environ["REPRO_NAIVE"] = "1" if on else "0"
    try:
        yield
    finally:
        if before is None:
            del os.environ["REPRO_NAIVE"]
        else:
            os.environ["REPRO_NAIVE"] = before


@contextlib.contextmanager
def spied(calls: dict):
    """Count the calls of the flash decode and of the two mesh forms of
    moe_ffn in ``calls``."""
    real = {"flash": (layers, "_flash_decode"), "ep": (moe, "_moe_ffn_ep"),
            "gathered": (moe, "_moe_ffn_gathered")}
    saved = {k: getattr(mod, name) for k, (mod, name) in real.items()}
    for key, (mod, name) in real.items():
        def spy(*a, _key=key, **kw):
            calls[_key] = calls.get(_key, 0) + 1
            return saved[_key](*a, **kw)
        setattr(mod, name, spy)
    try:
        yield
    finally:
        for key, (mod, name) in real.items():
            setattr(mod, name, saved[key])


def greedy(step, params, cache, first, steps=STEPS, pos0=PROMPT, extras=None):
    """``steps`` greedy steps from token ``first`` (b,) at positions
    ``pos0`` on: the logits (steps, b, vocab_size) and the tokens fed
    (steps, b)."""
    tok, logits, fed = first[:, None].to(torch.int32), [], []
    for i in range(steps):
        fed.append(tok[:, 0])
        nxt, cache, lg = step(params, tok, cache, pos0 + i, extras)
        logits.append(lg[:, -1])
        tok = nxt[:, None]
    return torch.stack(logits), torch.stack(fed), cache


_ONE = {}


def one_device(arch, params, prompt):
    """The port's one-device prefill cache and its greedy decode (kept:
    every case of an arch reads them)."""
    if arch not in _ONE:
        cfg = smoke(arch)
        logits, cache = get_api(cfg).prefill(params, cfg, {"tokens": prompt}, MAX_LEN,
                                             compute_dtype=torch.float32,
                                             cache_dtype=torch.float32)
        first = logits[:, -1, :cfg.vocab_size].argmax(-1)
        start = tree_map(torch.clone, cache)
        step = build_decode_step(cfg, torch.float32, return_logits=True)
        lg, fed, cache = greedy(step, params, cache, first)
        _ONE[arch] = dict(start=start, first=first, logits=lg, fed=fed, cache=cache)
    return _ONE[arch]


def _decode_case(case, mesh, inputs):
    arch = case["arch"]
    cfg = smoke(arch)
    params, prompt = inputs["params"][arch], inputs["prompt"][arch]
    one = one_device(arch, params, prompt)
    api = get_api(cfg)
    calls = {}
    with naive(case.get("naive", False)):
        rules = build_rules(cfg, cell(case["cell"]), model_size=mesh.shape[1],
                            data_size=mesh.shape[0], overrides=case.get("overrides"))
        with axis_rules(rules, mesh=mesh), spied(calls):
            local = shard_tree(params, mesh, placements(params, api.param_specs(cfg), mesh))
            cache_pl = param_shardings(mesh, api.cache_specs(cfg))
            cache = shard_tree(one["start"], mesh, cache_pl)
            step = build_decode_step(cfg, torch.float32, return_logits=True)
            logits, fed, cache = greedy(step, local, cache, one["first"])
            want_cache = shard_tree(one["cache"], mesh, cache_pl)
    cache_rel = max(rel(g, w) for g, w in zip(leaves(cache), leaves(want_cache)))
    ref = inputs["decode"][(arch, case["cell"], tuple(case["mesh"]))]
    out = dict(rules={k: rules[k] for k in ("batch", "cache_seq", "kv_heads_act", "experts")},
               one_rel=rel(logits, one["logits"]),
               one_same_tokens=bool(torch.equal(fed, one["fed"])), cache_rel=cache_rel,
               tokens=fed.numpy(), calls=calls, ref_error=ref.get("error"))
    if "logits" in ref:
        out.update(ref_rel=rel(logits, ref["logits"]),
                   ref_same_tokens=bool((fed.numpy() == ref["tokens"]).all()))
    else:   # the reference raised under these rules: both one-device decodes
        one_ref = inputs["decode"][(arch, None, None)]
        out.update(one_ref_rel=rel(logits, one_ref["logits"]),
                   one_ref_same_tokens=bool((fed.numpy() == one_ref["tokens"]).all()))
    return out


@contextlib.contextmanager
def flash_calls(calls: list):
    """Record each call of kernel 12's wrapper (``ops.flash_attention``)
    in ``calls``."""
    real = ops.flash_attention

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    ops.flash_attention = spy
    try:
        yield
    finally:
        ops.flash_attention = real


def serve(cfg, params, batch):
    """build_prefill and STEPS greedy steps of build_decode_step (f32, an
    f32 cache of MAX_LEN positions past the prefix) under the current
    rules, from the prefill's own greedy token: (prefill logits, its
    cache cloned, enc_out, each step's logits, the tokens fed, the final
    cache, kernel 12's calls in the prefill and in the steps)."""
    prefix = cfg.n_prefix_tokens or 0
    prefill_calls, decode_calls = [], []
    with flash_calls(prefill_calls):
        out = build_prefill(cfg, MAX_LEN + prefix, torch.float32,
                            cache_dtype=torch.float32)(params, batch)
    logits, cache = out[0][..., :cfg.vocab_size], out[1]
    enc_out = out[2] if len(out) > 2 else None
    start = tree_map(torch.clone, cache)
    step = build_decode_step(cfg, torch.float32, return_logits=True)
    with flash_calls(decode_calls):
        lg, fed, cache = greedy(step, params, cache, logits[:, -1].argmax(-1),
                                pos0=PROMPT + prefix,
                                extras=None if enc_out is None else {"enc_out": enc_out})
    return dict(prefill=logits, start=start, enc_out=enc_out, logits=lg, fed=fed, cache=cache,
                prefill_calls=len(prefill_calls), decode_calls=len(decode_calls))


_ONE_SERVE = {}


def _family_case(case, mesh, inputs):
    # a case of a smoke config with fields replaced names its inputs
    arch, name = case["arch"], case.get("name", case["arch"])
    cfg = smoke(arch, **case.get("replace", {}))
    api = get_api(cfg)
    params, batch = inputs["params"][name], inputs["batch"][name]
    if name not in _ONE_SERVE:
        _ONE_SERVE[name] = serve(cfg, params, batch)
    one = _ONE_SERVE[name]
    rules = build_rules(cfg, cell(case["cell"]), model_size=mesh.shape[1],
                        data_size=mesh.shape[0], overrides=case.get("overrides"))
    with axis_rules(rules, mesh=mesh):
        local = shard_tree(params, mesh, placements(params, api.param_specs(cfg), mesh))
        got = serve(cfg, local, batch)
        cache_pl = param_shardings(mesh, api.cache_specs(cfg))
        want_start = shard_tree(one["start"], mesh, cache_pl)
        want_cache = shard_tree(one["cache"], mesh, cache_pl)
    cache_rel = max(rel(g, w) for pair in ((got["start"], want_start), (got["cache"], want_cache))
                    for g, w in zip(leaves(pair[0]), leaves(pair[1]), strict=True))
    out = dict(rules={k: rules[k] for k in ("batch", "cache_seq", "heads_act", "kv_heads_act",
                                            "ssm_inner")},
               prefill_one_rel=rel(got["prefill"], one["prefill"]),
               one_rel=rel(got["logits"], one["logits"]),
               one_same_tokens=bool(torch.equal(got["fed"], one["fed"])), cache_rel=cache_rel,
               enc_rel=None if one["enc_out"] is None else rel(got["enc_out"], one["enc_out"]),
               tokens=got["fed"].numpy(), prefill_calls=got["prefill_calls"],
               decode_calls=got["decode_calls"], one_prefill_calls=one["prefill_calls"],
               one_decode_calls=one["decode_calls"])
    ref = inputs["serve"].get((name, case["cell"], tuple(case["mesh"])))
    if ref is not None:
        # where the reference raised under these rules, its one-device run
        one_ref = inputs["serve"][(name, None, None)]
        out["ref_errors"] = {k: ref[k] for k in ("prefill_error", "decode_error") if k in ref}
        pre = one_ref if "prefill_error" in ref else ref
        dec = ref if "logits" in ref else one_ref
        out["ref_prefill_rel"] = rel(got["prefill"], pre["prefill"])
        if "logits" in dec:
            out.update(ref_rel=rel(got["logits"], dec["logits"]),
                       ref_same_tokens=bool((got["fed"].numpy() == dec["tokens"]).all()))
    return out


def _data_group(mesh, rules):
    return mesh.get_group("data") if rules.get("batch") and mesh.shape[0] > 1 else None


def _moe_case(case, mesh, inputs):
    arch, cf = case["arch"], case["cf"]
    base = smoke(arch)
    cfg = base.replace(moe=dataclasses.replace(base.moe, capacity_factor=cf))
    ref = (inputs["moe_local"][(arch, cf)] if case.get("naive") else
           inputs["moe"][(arch, cf, tuple(case["mesh"]))])
    p, x = inputs["moe_params"][arch], inputs["moe_x"][arch]
    calls = {}
    with naive(case.get("naive", False)):
        rules = build_rules(cfg, model_size=mesh.shape[1], data_size=mesh.shape[0])
        data = _data_group(mesh, rules)
        d = mesh.shape[0] if data is not None else 1
        with axis_rules(rules, mesh=mesh), spied(calls):
            pl = placements(p, moe.moe_ffn_specs(cfg), mesh)
            local = tree_map(lambda t: t.requires_grad_(), shard_tree(p, mesh, pl))
            n = x.shape[0] // d
            row0 = (mesh.get_coordinate()[0] if data is not None else 0) * n
            x_loc = x.narrow(0, row0, n).clone().requires_grad_()
            with _routing() as routed:
                y, aux = moe.moe_ffn(x_loc, local, cfg)
            wrt = [x_loc, *leaves(local)]
            grads = torch.autograd.grad((y * y).sum() + aux / d, wrt, retain_graph=True)
            grads_aux = torch.autograd.grad(aux / d, wrt, materialize_grads=True)
            dropped = _dropped(x_loc.detach(), p, cfg, mesh)
    # the size of the terms whose difference is the router's gradient through
    # w / sum(w) at top_k = 1: sum over tokens of |x| |dL/dw| / w
    xf, w, gw = routed["xf"], routed["top_w"], routed["grad"]
    scale = (xf.abs() * (gw.abs() / w).sum(-1, keepdim=True)).sum(0)
    if data is not None and xf.shape[0] < x.shape[0] * x.shape[1]:
        dist.all_reduce(scale, group=data)
    names = ["x", *named_leaves(local)]
    flat_pl = dict(zip(named_leaves(p), placement_leaves(pl)))
    out = dict(aux=float(aux.detach()), aux_ref=float(ref["aux"]), calls=calls,
               router_scale=float(scale.max()))
    for key, gs in (("grads", grads), ("grads_aux", grads_aux)):
        gs = dict(zip(names, gs))
        if data is not None:     # the parameters' over "data", x's rows gathered
            for name, g in gs.items():
                if name != "x":
                    dist.all_reduce(g, group=data)
            gs["x"] = _gather_rows(gs["x"], data)
        dists = {}
        for name, g in gs.items():
            want = torch.from_numpy(ref[key][name])
            if name != "x":
                want = local_shard(want, mesh, flat_pl[name])
            # (max |port - reference|, max |reference| over the whole leaf)
            dists[name] = (float((g - want).abs().max()),
                           float(torch.from_numpy(ref[key][name]).abs().max()))
        out[key] = dists
    if data is not None:
        y, dropped = _gather_rows(y.detach(), data), _gather_rows(dropped, data)
    return dict(out, y_rel=rel(y, ref["y"]), dropped=dropped.numpy(),
                dropped_ref=ref.get("dropped"))


@contextlib.contextmanager
def _routing():
    """Record moe.route's input rows and top_w, and top_w's gradient."""
    real, rec = moe.route, {}

    def spy(xf, p, cfg):
        probs, top_w, top_ids = real(xf, p, cfg)
        rec.update(xf=xf.detach(), top_w=top_w.detach())
        top_w.register_hook(lambda g: rec.setdefault("grad", g.detach()))
        return probs, top_w, top_ids

    moe.route = spy
    try:
        yield rec
    finally:
        moe.route = real


def _gather_rows(t, grp):
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(grp))]
    dist.all_gather(parts, t.contiguous(), group=grp)
    return torch.cat(parts)


def _dropped(x, p, cfg, mesh):
    """(b, s, k) bool: the copies of x's tokens the expert-parallel form
    drops, summed over the expert ranks (each copy is one rank's)."""
    m = cfg.moe
    xf = x.reshape(-1, x.shape[-1])
    _, _, top_ids = moe.route(xf, p, cfg)
    ep = mesh.shape[1]
    e_loc = m.n_experts // ep
    cap = moe.moe_capacity(xf.shape[0], m) * 2
    out = torch.zeros(top_ids.numel(), dtype=torch.bool)
    for r in range(ep):
        slot, _ = moe.ep_dispatch(top_ids, e_loc, r, cap)
        mine = (top_ids // e_loc == r).reshape(-1)
        out |= mine & (slot == e_loc * cap)
    return out.reshape(*x.shape[:2], m.top_k)


def _raise_case(case, mesh, inputs):
    cfg = smoke(case["arch"], **case.get("replace", {}))
    api = get_api(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    rules = build_rules(cfg, cell(case.get("cell", "decode_32k")),
                        model_size=mesh.shape[-1], data_size=mesh.shape[0] if mesh.ndim > 1 else 1,
                        overrides=case.get("overrides"))
    tokens = torch.zeros((BATCH, 1), dtype=torch.int32)
    raised = None
    with axis_rules(rules, mesh=mesh):
        try:
            if case.get("prefill"):
                build_prefill(cfg, case.get("max_len", MAX_LEN), torch.float32)(
                    params, prompt_batch(cfg))
            else:
                cache = api.init_cache(cfg, BATCH, MAX_LEN, torch.float32)
                build_decode_step(cfg, torch.float32)(params, tokens, cache, PROMPT)
        except NotImplementedError as e:
            raised = str(e)
    dist.barrier()
    return dict(raised=raised)


def prompt_batch(cfg):
    """A prefill's batch of BATCH prompts of PROMPT zero tokens, and the
    family's stub embeddings (zeros: the raise cases never read them)."""
    batch = {"tokens": torch.zeros((BATCH, PROMPT), dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.zeros((BATCH, PROMPT, cfg.d_model))
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.zeros((BATCH, cfg.n_prefix_tokens, cfg.d_model))
    return batch


_KINDS = {"decode": _decode_case, "moe": _moe_case, "raise": _raise_case,
          "family": _family_case}


def run_cases(rank, world, cases, inputs):
    meshes, out = {}, []
    for case in cases:
        shape = tuple(case["mesh"])
        names = tuple(case.get("mesh_names", ("data", "model")))
        if (shape, names) not in meshes:
            meshes[shape, names] = init_device_mesh("cpu", shape, mesh_dim_names=names)
        out.append(_KINDS[case["kind"]](case, meshes[shape, names], inputs))
    return out
