"""One rank of the sharded LM train step on a gloo group, for
``tests/test_torch_sharding.py`` and ``tests/test_torch_sharded_families.py``
(spawned by ``repro_torch.testing.run_ranks``).

``run_cases`` runs each case of a list on this rank and returns what the
test reads, as plain numbers, strings and numpy arrays:

  step    the smoke model's 3 sharded steps on a ("data", "model") mesh,
          its parameters and AdamW state placed by ``param_shardings``,
          against 3 one-device steps of the port from the same weights and
          batches (run on every rank alike; for the moe family over more
          than one data rank, with the batch split into a microbatch a
          data rank; from the reference's weights where the case names
          them in ``inputs``, and then also against the reference's
          jitted steps under the same rules): the losses, the worst
          distance of each rank's shards from the slices of the
          one-device results (and of the reference's), a digest of the
          replicated leaves, kernel 12's forward and backward calls, and
          the calls of moe_ffn's two mesh forms (``naive``: the step under
          REPRO_NAIVE=1, where moe takes its gathered local form; over
          data ranks its yardstick is one device's step on the whole
          batch, since that form's aux loss is the whole batch's)
  shard   each rank's ``local_shard`` of every parameter and whether it
          equals ``distribute_tensor``'s local block
  raise   the step of a rule or width the layout cannot take: its error on this rank,
          then a barrier, which every rank reaches only if none of them
          entered a collective first
  collective  ``gather_summed`` or ``all_sum`` over "model" of this
          rank's slice of a seeded tensor and the gradient of a loss of
          the rank's own

It imports torch, numpy and the port, nothing of JAX.
"""
from __future__ import annotations

import contextlib
import hashlib
import os

import numpy as np
import torch

torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.distributed import axis_rules  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import (build_rules, local_shard, param_shardings,  # noqa: E402
                                     placement_leaves, shard_tree, specs_like)
from repro_torch.models import get_api, moe  # noqa: E402
from repro_torch.train import adamw_init, build_train_step  # noqa: E402
from repro_torch.train._tree import leaves, named_leaves, tree_map  # noqa: E402
from repro_torch.train.optimizer import AdamWState  # noqa: E402

BATCH, SEQ, STEPS = 4, 16, 3
ATOL, RTOL = 5e-4, 2e-3     # the reference's own tolerance across mesh shapes


def smoke(arch: str, **replace):
    cfg = configs.get_smoke_config(arch)
    return cfg.replace(**replace) if replace else cfg


def tcfg(remat: str, batch: int = BATCH, **kw):
    return configs.TrainConfig(seq_len=SEQ, global_batch=batch, compute_dtype="float32",
                               remat=remat, learning_rate=1e-3, warmup_steps=2,
                               total_steps=10, **kw)


def batches(cfg, batch: int = BATCH):
    out = []
    for i in range(STEPS):
        rng = np.random.default_rng(i)
        toks = rng.integers(0, cfg.vocab_size, (batch, SEQ + 1))
        b = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
        if cfg.family == "vlm":
            b["image_embeds"] = torch.from_numpy(
                rng.standard_normal((batch, cfg.n_prefix_tokens, cfg.d_model),
                                    dtype=np.float32) * 0.02)
        if cfg.family == "encdec":      # as many frames as tokens: kernel 12's cross form
            b["src_embeds"] = torch.from_numpy(
                rng.standard_normal((batch, SEQ, cfg.d_model), dtype=np.float32) * 0.02)
        out.append(b)
    return out


def init(cfg, params=None):
    """Seed 0's weights (or a copy of ``params``) and zero AdamW state."""
    if params is None:
        params = get_api(cfg).init_params(torch.Generator().manual_seed(0), cfg)
    else:
        params = tree_map(torch.clone, params)
    return params, adamw_init(params)


def steps(cfg, tc, params, opt, data):
    step = build_train_step(cfg, tc)
    losses = []
    for b in data:
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    return params, opt, losses


_ONE = {}


def one_device(arch, remat, replace, microbatch=0, start=None, name=None):
    """One device's 3 steps (kept for the cases that share them, by
    ``name`` where they start from the weights ``start``); with
    ``microbatch`` the batch split into that many slices, the yardstick
    of the moe family over that many data ranks."""
    key = (arch, remat, tuple(sorted(replace.items())), microbatch, name)
    if key not in _ONE:
        cfg = smoke(arch, **replace)
        params, opt = init(cfg, start)
        _ONE[key] = steps(cfg, tcfg(remat, microbatch=microbatch), params, opt, batches(cfg))
    return _ONE[key]


def placements_of(cfg, mesh, params):
    return param_shardings(mesh, specs_like(get_api(cfg).param_specs(cfg), params))


def _distance(got, want):
    """(max |got - want|, max |got - want| / (ATOL + RTOL |want|))."""
    d = (got - want).abs()
    return float(d.max()), float((d / (ATOL + RTOL * want.abs())).max())


@contextlib.contextmanager
def _naive(on: bool):
    """REPRO_NAIVE set to 1 (or 0) for the block."""
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
def _moe_forms(calls: dict):
    """Count the calls of moe_ffn's expert-parallel and gathered forms."""
    saved = {name: getattr(moe, name) for name in ("_moe_ffn_ep", "_moe_ffn_gathered")}
    for name, fn in saved.items():
        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        setattr(moe, name, spy)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(moe, name, fn)


def _worst(got, want, flat, mesh):
    """{"params", "mu", "nu"}: (max |d|, max share of the tolerance) of
    each rank's shards from the slices of ``want``'s (params, AdamW
    state)."""
    worst = {}
    for what, g_tree, w_tree in (("params", got[0], want[0]), ("mu", got[1].mu, want[1].mu),
                                 ("nu", got[1].nu, want[1].nu)):
        dist_abs, dist_tol = 0.0, 0.0
        for g, w, p in zip(leaves(g_tree), leaves(w_tree), flat, strict=True):
            a, t = _distance(g, local_shard(w, mesh, p))
            dist_abs, dist_tol = max(dist_abs, a), max(dist_tol, t)
        worst[what] = (dist_abs, dist_tol)
    return worst


def _step_case(case, mesh, inputs):
    arch, remat, replace = case["arch"], case["remat"], case.get("replace", {})
    cfg = smoke(arch, **replace)
    naive = case.get("naive", False)
    with _naive(naive):
        rules = build_rules(cfg, model_size=mesh.shape[1], data_size=mesh.shape[0],
                            overrides=case.get("overrides"))
    # the reference's weights and its steps under the same rules, where given
    given = inputs.get(case.get("name"), {})
    params, opt = init(cfg, given.get("params"))
    forms = {}
    with axis_rules(rules, mesh=mesh), _naive(naive), _moe_forms(forms):
        pl = placements_of(cfg, mesh, params)
        local = shard_tree(params, mesh, pl)
        local_opt = AdamWState(step=opt.step, mu=shard_tree(opt.mu, mesh, pl),
                               nu=shard_tree(opt.nu, mesh, pl))
        calls, bwd_calls = [], []
        kernel, backward = ops.flash_attention, fa.flash_attention_bwd

        def spy(*args, **kw):
            calls.append(1)
            return kernel(*args, **kw)

        def spy_backward(*args, **kw):
            bwd_calls.append(1)
            return backward(*args, **kw)

        ops.flash_attention, fa.flash_attention_bwd = spy, spy_backward
        try:
            local, local_opt, losses = steps(cfg, tcfg(remat), local, local_opt, batches(cfg))
        finally:
            ops.flash_attention, fa.flash_attention_bwd = kernel, backward
    # moe over data ranks: its expert-parallel aux loss is each data shard's,
    # as a microbatch's
    micro = mesh.shape[0] if cfg.family == "moe" and mesh.shape[0] > 1 and not naive else 0
    one_params, one_opt, one_losses = one_device(arch, remat, replace, micro,
                                                 given.get("params"), case.get("name"))
    flat = placement_leaves(pl)
    worst = _worst((local, local_opt), (one_params, one_opt), flat, mesh)
    digest = hashlib.sha256()
    for g, p in zip(leaves(local), flat):
        if not any(x.is_shard() for x in p):
            digest.update(g.numpy().tobytes())
    out = dict(losses=losses, one_losses=one_losses, worst=worst,
               replicated=digest.hexdigest(), flash_calls=len(calls),
               flash_bwd_calls=len(bwd_calls), n_layers=cfg.n_layers, moe_forms=forms,
               coordinate=list(mesh.get_coordinate()))
    if "ref" in given:
        ref = given["ref"]
        out["ref_worst"] = _worst((local, local_opt), (ref["params"], ref["opt"]), flat, mesh)
    return out


def _shard_case(case, mesh, inputs):
    from torch.distributed.tensor import distribute_tensor
    cfg = smoke(case["arch"])
    rules = build_rules(cfg, model_size=mesh.shape[1], data_size=mesh.shape[0])
    params, _ = init(cfg)
    with axis_rules(rules, mesh=mesh):
        pl = placements_of(cfg, mesh, params)
        local = shard_tree(params, mesh, pl)
    flat = placement_leaves(pl)
    same = [torch.equal(g, distribute_tensor(w, mesh, list(p)).to_local())
            for g, w, p in zip(leaves(local), leaves(params), flat)]
    return dict(local={k: v.numpy() for k, v in named_leaves(local).items()},
                placements={k: [str(x) for x in p]
                            for k, p in zip(named_leaves(params), flat)},
                same_as_dtensor=all(same), coordinate=list(mesh.get_coordinate()))


def _raise_case(case, mesh, inputs):
    cfg = smoke(case["arch"], **case.get("replace", {}))
    rules = build_rules(cfg, model_size=mesh.shape[1], data_size=mesh.shape[0],
                        overrides=case.get("overrides"))
    params, opt = init(cfg)
    batch = case.get("batch", BATCH)
    raised = None
    with axis_rules(rules, mesh=mesh):
        try:
            build_train_step(cfg, tcfg("full", batch, **case.get("train", {})))(
                params, opt, batches(cfg, batch)[0])
        except NotImplementedError as e:
            raised = str(e)
    dist.barrier()
    return dict(raised=raised)


def _collective_case(case, mesh, inputs):
    """gather_summed or all_sum over "model" of this rank's part of a
    seeded tensor, then a loss of this rank's own (the parts it reads
    weighted by its rank): the forward, and the gradient of the rank's
    part from the sum of the ranks' losses."""
    from repro_torch.distributed import collectives as C
    m, r = mesh.shape[1], mesh.get_coordinate()[1]
    grp = mesh.get_group("model") if m > 1 else None
    full = torch.from_numpy(np.random.default_rng(7).standard_normal(case["shape"]))
    dim, width = case["dim"], case["shape"][case["dim"]] // m
    part = full.narrow(dim, r * width, width).clone().requires_grad_()
    if case["op"] == "gather_summed":
        out = C.gather_summed(part, grp, dim)
    else:
        out = C.all_sum(part, grp)
    weight = torch.from_numpy(np.random.default_rng(100 + r).standard_normal(out.shape))
    (grad,) = torch.autograd.grad((out * weight).sum(), [part])
    return dict(out=out.detach().numpy(), grad=grad.numpy(), rank=r)


_KINDS = {"step": _step_case, "shard": _shard_case, "raise": _raise_case,
          "collective": _collective_case}


def run_cases(rank, world, cases, inputs=None):
    """Each case on this rank; ``inputs`` {case name: {"params": the
    weights to start from, "ref": the reference's steps}} for the step
    cases that name them."""
    meshes, out = {}, []
    for case in cases:
        shape = tuple(case["mesh"])
        if shape not in meshes:
            meshes[shape] = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        out.append(_KINDS[case["kind"]](case, meshes[shape], inputs or {}))
    return out
