"""The sharded train step, prefill and decode under the reference's own
rules where a head count leaves the attention activations replicated
(ROADMAP 12b.4c.2a), on the CPU.

The reference's ``build_rules`` shards wq's and wk's, wv's flat columns
over "model" always ("heads", "kv_heads"), but their activations
("heads_act", "kv_heads_act") only where the head count divides the axis.
So granite-34b's and paligemma-3b's one KV head, h2o-danube's and
llama4-maverick's smoke 2 KV heads over 4 ranks, and a qwen1.5-4b smoke of
5 heads and 5 KV heads (1.25 heads a rank at model 4, 2.5 at model 2: what
qwen's 20 heads get at 8 and 16) are split in the middle of a head, with
the activation whole on every rank; zamba2 and seamless take the rules
``build_rules`` gives them on an axis their counts do not divide
(``{"heads_act": None, "kv_heads_act": None}``); and a stablelm smoke of
12 heads in 6 KV groups at model 4 gives each rank 3 heads, which part a
KV group.

One module fixture runs the reference once, in a subprocess of 4 host
devices (``repro.testing.run_mesh_subprocess``): each config's weights
(key 0), 3 jitted train steps (``tests/torch_sharding_worker.py``'s
batches and TrainConfig) under each case's rules and mesh, and a jitted
prefill of 2 prompts of 14 tokens into an f32 cache of 32 positions past
the prefix with 4 greedy decode steps, on one device and under
``build_rules(cfg, cell, model_size=m, data_size=d)``; where its step
under the rules raises (``REFERENCE_RAISES``), its one-device steps
instead. Then one spawn of 4 gloo ranks runs the port's train steps
(``torch_sharding_worker``) and one its prefill and decode
(``torch_sharded_serve_worker``'s ``family`` cases) from the same
weights. The train half and the serve half (a reference subprocess and
a spawn each) run side by side.

Tolerances, and why (those of ``tests/test_torch_sharding.py``,
``tests/test_torch_train.py`` and ``tests/test_torch_sharded_serve.py``):
- each step's loss: rtol 1e-5 of one device's, 1e-4 of the reference's
  jitted step under the same rules;
- the parameters and AdamW moments after 3 steps: atol 5e-4, rtol 2e-3 of
  one device's and of the reference's jitted steps (the reference's own
  tolerance across mesh shapes);
- the leaves every rank holds whole: bitwise alike on every rank;
- the prefill's and the decode's logits: 1e-5 of max|logits| of one
  device's, each rank's cache shard within 1e-5 of one device's, the
  tokens equal; 1e-4 of the reference's jitted runs, tokens equal;
- kernel 12's calls on every rank: one device's.
"""
import concurrent.futures
import dataclasses
import os
import pickle
import tempfile

import numpy as np
import pytest
import torch

# one torch thread a process: the test run starts several processes at once
torch.set_num_threads(1)

from repro.testing import run_mesh_subprocess  # noqa: E402

import torch_sharded_serve_worker as SW  # noqa: E402
import torch_sharding_worker as W  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import axis_rules  # noqa: E402
from repro_torch.interop import adamw_state_from_reference, lm_params_from_reference  # noqa: E402
from repro_torch.launch.mesh import build_rules, shard_tree  # noqa: E402
from repro_torch.testing import run_ranks  # noqa: E402
from repro_torch.train._tree import leaves  # noqa: E402

WORLD = 4
JOIN_TIMEOUT = 240
LOSS_RTOL, REF_LOSS_RTOL, REF_REL, ONE_REL = 1e-5, 1e-4, 1e-4, 1e-5
#: the configs: (arch, fields replaced)
CONFIGS = {
    "granite-34b": ("granite-34b", {}),
    "paligemma-3b": ("paligemma-3b", {}),
    "h2o-danube-3-4b": ("h2o-danube-3-4b", {}),
    "llama4-maverick-400b-a17b": ("llama4-maverick-400b-a17b", {}),
    "qwen1.5-4b-5-heads": ("qwen1.5-4b", {"n_heads": 5, "n_kv_heads": 5}),
    "zamba2-2.7b": ("zamba2-2.7b", {}),
    "seamless-m4t-large-v2": ("seamless-m4t-large-v2", {}),
    "stablelm-3b-12-heads-6-kv": ("stablelm-3b", {"n_heads": 12, "n_kv_heads": 6}),
}
ACT_WHOLE = {"heads_act": None, "kv_heads_act": None}
#: the train cases: (config, mesh, rules' overrides)
TRAIN = [("granite-34b", (1, 4), None), ("granite-34b", (2, 2), None),
         ("paligemma-3b", (1, 4), None), ("paligemma-3b", (2, 2), None),
         ("llama4-maverick-400b-a17b", (1, 4), None), ("h2o-danube-3-4b", (1, 4), None),
         ("qwen1.5-4b-5-heads", (1, 4), None), ("qwen1.5-4b-5-heads", (2, 2), None),
         ("zamba2-2.7b", (1, 4), ACT_WHOLE), ("zamba2-2.7b", (2, 2), ACT_WHOLE),
         ("seamless-m4t-large-v2", (1, 4), ACT_WHOLE),
         ("seamless-m4t-large-v2", (2, 2), ACT_WHOLE),
         ("stablelm-3b-12-heads-6-kv", (1, 4), None)]
#: kernel 12's calls in one forward of each config's smoke model (its
#: backward once each): one a layer; zamba2's shared attention once a group
#: of 2; seamless's 2 encoder layers and 2 decoder layers of a self- and a
#: cross-attention; h2o-danube's window of 16 covers the 16 tokens;
#: paligemma's image prefix takes the masked path
FORWARD_CALLS = {"granite-34b": 4, "paligemma-3b": 0, "h2o-danube-3-4b": 3,
                 "llama4-maverick-400b-a17b": 4, "qwen1.5-4b-5-heads": 3, "zamba2-2.7b": 2,
                 "seamless-m4t-large-v2": 6, "stablelm-3b-12-heads-6-kv": 3}
#: where the reference's jitted step under the rules raises (a
#: ShardingTypeError in the moe layer's contraction over "data", ROADMAP
#: queue 3): the port is held to its one-device steps instead
REFERENCE_RAISES = ("llama4-maverick-400b-a17b-1x4",)
#: the ids tests/test_torch_sharding.py refused until the step took these
#: rules, and the case each is now
FORMERLY_REFUSED = {"mqa-kv-heads-act-replicated": ("granite-34b", (1, 4)),
                    "paligemma-kv-heads-act-replicated": ("paligemma-3b", (2, 2)),
                    "moe": ("llama4-maverick-400b-a17b", (1, 4))}
#: the serve cases: (config, cell, mesh); None: build_rules without a cell
#: ("cache_seq" unmapped: the dense decode over the whole KV heads)
SERVE_CONFIGS = ("granite-34b", "paligemma-3b", "h2o-danube-3-4b", "qwen1.5-4b-5-heads")
SERVE = ([(c, cell, m) for c in SERVE_CONFIGS for cell in ("decode_32k", "long_500k")
          for m in ((1, 4), (2, 2))]
         + [("qwen1.5-4b-5-heads", None, (1, 4)), ("qwen1.5-4b-5-heads", None, (2, 2)),
            ("granite-34b", None, (1, 4))])
#: kernel 12's calls in one prefill: one a layer; paligemma's prefix mask none
PREFILL_CALLS = {"granite-34b": 4, "paligemma-3b": 0, "h2o-danube-3-4b": 3,
                 "qwen1.5-4b-5-heads": 3}


def _name(config, mesh, overrides):
    return f"{config}-{mesh[0]}x{mesh[1]}" + ("-act-whole" if overrides else "")


TRAIN_CASES = [dict(kind="step", arch=CONFIGS[c][0], replace=CONFIGS[c][1], mesh=m,
                    remat="full", name=_name(c, m, o), config=c,
                    **({"overrides": o} if o else {}))
               for c, m, o in TRAIN]
SERVE_CASES = [dict(kind="family", arch=CONFIGS[c][0], replace=CONFIGS[c][1], name=c, cell=cell,
                    mesh=m) for c, cell, m in SERVE]
TRAIN_IDS = [c["name"] for c in TRAIN_CASES]
SERVE_IDS = [f"{c['name']}-{c['cell']}-{c['mesh'][0]}x{c['mesh'][1]}" for c in SERVE_CASES]


def _smoke(config):
    arch, replace = CONFIGS[config]
    cfg = configs.get_smoke_config(arch)
    return cfg.replace(**replace) if replace else cfg


def _serve_batch(cfg):
    """2 prompts of 14 tokens (and paligemma's image embeddings), seeded."""
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (SW.BATCH, SW.PROMPT)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = (rng.standard_normal((SW.BATCH, cfg.n_prefix_tokens, cfg.d_model))
                                 * 0.02).astype(np.float32)
    return batch


_REFERENCE = """
import dataclasses
import pickle
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config, SHAPE_CELLS, TrainConfig
from repro.models import get_api
from repro.distributed.sharding import axis_rules
from repro.launch.mesh import build_rules
from repro.train import optimizer as jopt
from repro.train.train_step import build_train_step

with open({inputs!r}, "rb") as f:
    IN = pickle.load(f)
cells = {{c.name: c for c in SHAPE_CELLS}}
out = dict(params={{}}, train={{}}, serve={{}})


def error(e):
    return f"{{type(e).__name__}}: {{str(e)[:300]}}"


def smoke(config):
    arch, replace = IN["configs"][config]
    cfg = get_smoke_config(arch)
    return cfg.replace(**replace) if replace else cfg


params = {{}}
for config in IN["configs"]:
    cfg = smoke(config)
    params[config] = get_api(cfg).init_params(jax.random.key(0), cfg)
    out["params"][config] = jax.tree.map(np.asarray, params[config])

for name, (config, (d, m), overrides) in IN["train"].items():
    tc = TrainConfig(**IN["train_config"])
    cfg = smoke(config)
    p = params[config]
    rules = build_rules(cfg, model_size=m, data_size=d, overrides=overrides)
    mesh = jax.make_mesh((d, m), ("data", "model"))

    def steps(p):
        step = jax.jit(build_train_step(cfg, tc))
        opt, met = jopt.adamw_init(p), []
        for b in IN["batches"][config]:
            p, opt, mt = step(p, opt, {{k: jnp.asarray(v) for k, v in b.items()}})
            met.append({{k: float(v) for k, v in mt.items()}})
        return dict(losses=[x["loss"] for x in met], lrs=[x["lr"] for x in met],
                    params=jax.tree.map(np.asarray, p),
                    opt=jax.tree.map(np.asarray, dataclasses.asdict(opt)))

    try:
        with mesh, axis_rules(rules, mesh=mesh):
            out["train"][name] = steps(p)
    except Exception as e:      # its one-device steps instead
        out["train"][name] = dict(steps(p), error=error(e))

for config, cases in IN["serve"].items():
    cfg = smoke(config)
    api = get_api(cfg)
    p = params[config]
    batch = IN["serve_batch"][config]
    prefix = cfg.n_prefix_tokens or 0
    V = cfg.vocab_size

    def prefill_fn(p, b):
        return api.prefill(p, cfg, b, {max_len} + prefix, compute_dtype=jnp.float32,
                           cache_dtype=jnp.float32)

    def step_fn(p, t, c, pos):
        return api.decode_step(p, cfg, t, c, pos, None, compute_dtype=jnp.float32)

    def run():
        try:
            logits, cache = jax.jit(prefill_fn)(p, {{k: jnp.asarray(v) for k, v in batch.items()}})
        except Exception as e:
            return dict(prefill_error=error(e))
        logits = np.asarray(logits)[..., :V]
        res = dict(prefill=logits)
        step = jax.jit(step_fn)
        # host tokens: an eager argmax of mesh-sharded logits breaks the next trace
        tok = jnp.asarray(np.argmax(logits[:, -1], -1)[:, None].astype(np.int32))
        lgs, fed = [], []
        try:
            for i in range({steps}):
                fed.append(np.asarray(tok[:, 0]))
                lg, cache = step(p, tok, cache, jnp.int32({prompt} + prefix + i))
                lg = np.asarray(lg)[:, -1, :V]
                lgs.append(lg)
                tok = jnp.asarray(np.argmax(lg, -1)[:, None].astype(np.int32))
        except Exception as e:
            return dict(res, decode_error=error(e))
        return dict(res, logits=np.stack(lgs), tokens=np.stack(fed))

    out["serve"][(config, None, None)] = run()
    for cell, (d, m) in cases:
        rules = build_rules(cfg, cells[cell] if cell else None, model_size=m, data_size=d)
        mesh = jax.make_mesh((d, m), ("data", "model"))
        with mesh, axis_rules(rules, mesh=mesh):
            out["serve"][(config, cell, (d, m))] = run()
with open({path!r}, "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


def _reference(tmp, train=True):
    """The reference's weights and its train steps (``train``) or its
    prefills and decodes, run in a 4-device subprocess."""
    if train:
        cases, part = [c["config"] for c in TRAIN_CASES], dict(
            batches={c: [{k: v.numpy() for k, v in b.items()} for b in W.batches(_smoke(c))]
                     for c in CONFIGS},
            train={c["name"]: (c["config"], c["mesh"], c.get("overrides")) for c in TRAIN_CASES},
            train_config={k: getattr(W.tcfg("full"), k) for k in (
                "seq_len", "global_batch", "compute_dtype", "remat", "learning_rate",
                "warmup_steps", "total_steps")}, serve={})
    else:
        cases, part = SERVE_CONFIGS, dict(
            train={}, serve_batch={c: _serve_batch(_smoke(c)) for c in SERVE_CONFIGS}, serve={})
        for c, cell, m in SERVE:
            part["serve"].setdefault(c, []).append((cell, m))
    inputs = dict(part, configs={c: CONFIGS[c] for c in cases})
    path, in_path = os.path.join(tmp, "ref.pkl"), os.path.join(tmp, "in.pkl")
    with open(in_path, "wb") as f:
        pickle.dump(inputs, f)
    code = _REFERENCE.format(inputs=in_path, path=path, max_len=SW.MAX_LEN, steps=SW.STEPS,
                             prompt=SW.PROMPT)
    assert "OK" in run_mesh_subprocess(code, devices=WORLD, timeout=900)
    with open(path, "rb") as f:
        return pickle.load(f), inputs


def _params(ref):
    return {c: lm_params_from_reference(t, _smoke(c)) for c, t in ref["params"].items()}


def _train_half():
    """The reference's train steps, then the port's on the 4 ranks:
    ({case name: [each rank's result]}, the reference's results)."""
    with tempfile.TemporaryDirectory(prefix="act_replicated_ref_") as tmp:
        ref, _ = _reference(tmp, train=True)
    params, given = _params(ref), {}
    for case in TRAIN_CASES:
        cfg, got = _smoke(case["config"]), ref["train"][case["name"]]
        given[case["name"]] = dict(
            params=params[case["config"]],
            ref=dict(losses=got["losses"], params=lm_params_from_reference(got["params"], cfg),
                     opt=adamw_state_from_reference(got["opt"], cfg)))
    out = run_ranks(W.run_cases, WORLD, TRAIN_CASES, given, timeout=JOIN_TIMEOUT)
    return ({c["name"]: [out[r][i] for r in range(WORLD)] for i, c in enumerate(TRAIN_CASES)},
            ref["train"])


def _serve_half():
    """The reference's prefills and decodes, then the port's on the 4
    ranks: [each serve case's ranks' results]."""
    with tempfile.TemporaryDirectory(prefix="act_replicated_ref_") as tmp:
        ref, inputs = _reference(tmp, train=False)
    given = dict(params=_params(ref),
                 batch={c: {k: torch.from_numpy(v) for k, v in b.items()}
                        for c, b in inputs["serve_batch"].items()},
                 serve=ref["serve"])
    out = run_ranks(SW.run_cases, WORLD, SERVE_CASES, given, timeout=JOIN_TIMEOUT)
    return [[out[r][i] for r in range(WORLD)] for i in range(len(SERVE_CASES))]


@pytest.fixture(scope="module")
def ranks():
    """The train half and the serve half, each the reference once and then
    the port once on 4 ranks, side by side (each mostly waits on its
    subprocesses): ({train case name: [each rank's result]}, [each serve
    case's ranks' results], the reference's train results)."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        train, serve = pool.submit(_train_half), pool.submit(_serve_half)
        (train, ref), serve = train.result(), serve.result()
    return train, serve, ref


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("i", range(len(TRAIN_CASES)), ids=TRAIN_IDS)
def test_the_rules_shard_the_columns_and_leave_an_activation_whole(i):
    """"heads" and "kv_heads" over "model", and at least one of their
    activations whole: the rules this slice routes, as ``build_rules``
    gives them (the overrides: what it gives zamba2 and seamless on an
    axis their counts do not divide)."""
    case = TRAIN_CASES[i]
    cfg = _smoke(case["config"])
    d, m = case["mesh"]
    rules = build_rules(cfg, model_size=m, data_size=d, overrides=case.get("overrides"))
    assert rules["heads"] == rules["kv_heads"] == "model"
    assert rules["heads_act"] is None or rules["kv_heads_act"] is None, rules
    if not case.get("overrides"):
        assert (rules["kv_heads_act"] is None) == bool(cfg.n_kv_heads % m)
        assert (rules["heads_act"] is None) == bool(cfg.n_heads % m)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("i", range(len(TRAIN_CASES)), ids=TRAIN_IDS)
def test_sharded_step_losses_match_one_device_and_the_reference(ranks, i):
    train, _, ref = ranks
    name = TRAIN_IDS[i]
    print(f"{name}: against the reference's jitted steps under the same rules"
          + (f" (raised: {ref[name]['error'][:100]}; its one-device steps instead)"
             if "error" in ref[name] else ""))
    if name in REFERENCE_RAISES:
        assert ref[name]["error"].startswith("ShardingTypeError"), ref[name].get("error")
    else:
        assert "error" not in ref[name], ref[name]["error"]
    for r, res in enumerate(train[name]):
        np.testing.assert_allclose(res["losses"], res["one_losses"], rtol=LOSS_RTOL, atol=0,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(res["losses"], ref[name]["losses"], rtol=REF_LOSS_RTOL,
                                   atol=0, err_msg=f"rank {r}")
        assert res["one_losses"] == train[name][0]["one_losses"]


@pytest.mark.parametrize("i", range(len(TRAIN_CASES)), ids=TRAIN_IDS)
def test_sharded_step_parameters_and_adamw_state_match_one_device(ranks, i):
    res = ranks[0][TRAIN_IDS[i]]
    worst = {what: max(r["worst"][what][0] for r in res) for what in ("params", "mu", "nu")}
    ratio = {what: max(r["worst"][what][1] for r in res) for what in worst}
    print(f"{TRAIN_IDS[i]}: worst |sharded - one device| after {W.STEPS} steps {worst}; "
          f"of atol {W.ATOL} + rtol {W.RTOL} |x|: {ratio}")
    assert all(x <= 1.0 for x in ratio.values()), ratio


@pytest.mark.parametrize("i", range(len(TRAIN_CASES)), ids=TRAIN_IDS)
def test_sharded_step_parameters_and_adamw_state_match_the_reference(ranks, i):
    res = ranks[0][TRAIN_IDS[i]]
    worst = {what: max(r["ref_worst"][what][0] for r in res) for what in ("params", "mu", "nu")}
    ratio = {what: max(r["ref_worst"][what][1] for r in res) for what in worst}
    print(f"{TRAIN_IDS[i]}: worst |sharded - the reference's jitted steps| after {W.STEPS} "
          f"steps {worst}; of atol {W.ATOL} + rtol {W.RTOL} |x|: {ratio}")
    assert all(x <= 1.0 for x in ratio.values()), ratio


@pytest.mark.parametrize("i", range(len(TRAIN_CASES)), ids=TRAIN_IDS)
def test_replicated_leaves_are_bitwise_alike_on_every_rank(ranks, i):
    res = ranks[0][TRAIN_IDS[i]]
    assert len({r["replicated"] for r in res}) == 1
    d, m = TRAIN_CASES[i]["mesh"]
    assert sorted(tuple(r["coordinate"]) for r in res) == [(a, b) for a in range(d)
                                                           for b in range(m)]


@pytest.mark.parametrize("i", range(len(TRAIN_CASES)), ids=TRAIN_IDS)
def test_kernel_12_runs_once_an_attention_on_every_rank(ranks, i):
    """Kernel 12's forward twice an attention a step (remat "full": the
    forward and its recomputation) and its backward once, on every head
    where q is whole, as one device calls it."""
    forward = FORWARD_CALLS[TRAIN_CASES[i]["config"]]
    for r in ranks[0][TRAIN_IDS[i]]:
        assert r["flash_calls"] == 2 * forward * W.STEPS
        assert r["flash_bwd_calls"] == forward * W.STEPS


@pytest.mark.parametrize("old_id", list(FORMERLY_REFUSED))
def test_formerly_refused_default_rules_route(ranks, old_id):
    """The reference's default rules that the step refused before this
    slice (``tests/test_torch_sharding.py``'s raise ids of the same names):
    they route, within 1e-5 of one device's losses."""
    config, mesh = FORMERLY_REFUSED[old_id]
    for r in ranks[0][_name(config, mesh, None)]:
        np.testing.assert_allclose(r["losses"], r["one_losses"], rtol=LOSS_RTOL, atol=0)


# ---------------------------------------------------------------------------
# the prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("i", range(len(SERVE_CASES)), ids=SERVE_IDS)
def test_sharded_prefill_and_decode_match_the_references_jitted_runs(ranks, i):
    res = ranks[1][i]
    print(f"{SERVE_IDS[i]}: rules {res[0]['rules']}; against the reference's jitted runs "
          f"(raised: {res[0]['ref_errors']}): prefill "
          f"{max(r['ref_prefill_rel'] for r in res):.3e}, decode "
          f"{max(r['ref_rel'] for r in res):.3e}")
    assert res[0]["ref_errors"] == {}, res[0]["ref_errors"]
    for r in res:
        assert r["ref_prefill_rel"] <= REF_REL, r
        assert r["ref_rel"] <= REF_REL and r["ref_same_tokens"], r


@pytest.mark.parametrize("i", range(len(SERVE_CASES)), ids=SERVE_IDS)
def test_sharded_prefill_and_decode_match_one_device_on_every_rank(ranks, i):
    res = ranks[1][i]
    print(f"{SERVE_IDS[i]}: prefill {max(r['prefill_one_rel'] for r in res):.3e}, decode "
          f"{max(r['one_rel'] for r in res):.3e}, caches {max(r['cache_rel'] for r in res):.3e} "
          f"of one device's")
    for r in res:
        assert r["prefill_one_rel"] <= ONE_REL and r["one_rel"] <= ONE_REL, r
        assert r["one_same_tokens"] and r["cache_rel"] <= ONE_REL, r
        np.testing.assert_array_equal(r["tokens"], res[0]["tokens"])


@pytest.mark.parametrize("i", range(len(SERVE_CASES)), ids=SERVE_IDS)
def test_kernel_12_runs_in_the_sharded_prefill_alone(ranks, i):
    want = PREFILL_CALLS[SERVE_CASES[i]["name"]]
    for r in ranks[1][i]:
        assert r["prefill_calls"] == r["one_prefill_calls"] == want, r
        assert r["decode_calls"] == r["one_decode_calls"] == 0, r


# ---------------------------------------------------------------------------
# a mesh of one rank under rules for a model axis of 8: one device, bit for bit
# ---------------------------------------------------------------------------


@pytest.fixture
def one_rank_mesh(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("config", ["granite-34b", "qwen1.5-4b-5-heads"])
def test_one_by_one_mesh_under_model_8_rules_is_one_device_bitwise(one_rank_mesh, config):
    """``build_rules(cfg, model_size=8)`` leaves the activations whole
    (chip_smoke.py's 1 x 1 cases): on one rank the step, prefill and
    decode are one device's bit for bit."""
    cfg = _smoke(config)
    rules = build_rules(cfg, model_size=8)
    assert rules["kv_heads_act"] is None
    params, opt = W.init(cfg)
    one_params, one_opt, one_losses = W.steps(cfg, W.tcfg("full"), *W.init(cfg), W.batches(cfg))
    batch = {k: torch.from_numpy(v) for k, v in _serve_batch(cfg).items()}
    one = SW.serve(cfg, params, batch)
    with axis_rules(rules, mesh=one_rank_mesh):
        got = SW.serve(cfg, params, batch)
        pl = W.placements_of(cfg, one_rank_mesh, params)
        local = shard_tree(params, one_rank_mesh, pl)
        opt = dataclasses.replace(opt, mu=shard_tree(opt.mu, one_rank_mesh, pl),
                                  nu=shard_tree(opt.nu, one_rank_mesh, pl))
        local, opt, losses = W.steps(cfg, W.tcfg("full"), local, opt, W.batches(cfg))
    assert losses == one_losses
    for got_tree, want in ((local, one_params), (opt.mu, one_opt.mu), (opt.nu, one_opt.nu)):
        for a, b in zip(leaves(got_tree), leaves(want), strict=True):
            assert torch.equal(a, b)
    assert got["prefill_calls"] == one["prefill_calls"] == PREFILL_CALLS[config]
    for key in ("prefill", "logits", "fed"):
        assert torch.equal(got[key], one[key]), key
    for key in ("start", "cache"):
        for a, b in zip(leaves(got[key]), leaves(one[key]), strict=True):
            assert torch.equal(a, b), key

