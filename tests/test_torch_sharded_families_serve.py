"""The port's sharded prefill of every family and the sharded decode of the
ssm, hybrid, encdec, vlm and MLA families (ROADMAP 12b.4c.1), on the CPU,
under the reference's rules on 4 gloo ranks.

One module fixture runs the reference once, in a subprocess of 4 host
devices (``repro.testing.run_mesh_subprocess``): the smoke models' weights
(key 0) and a seeded batch of 2 prompts of 14 tokens (seamless with as
many source frames, paligemma with its 16 image positions), a jitted
prefill into an f32 cache of 32 positions past the prefix, then 4 greedy
decode steps (fed as host arrays), on one device and under
``build_rules(cfg, cell, model_size=m, data_size=d)`` and the mesh: for
mamba2-780m, zamba2-2.7b, seamless-m4t-large-v2, paligemma-3b and
deepseek-v2-lite-16b, and the prefill alone of stablelm-3b and
llama4-maverick, cells ``decode_32k`` and ``long_500k``, meshes (1, 4)
and (2, 2). A cache sharded over 4 ranks holds 8 positions a rank, so
its owner changes mid-prompt, and at position 16 mid-decode. Then one
spawn of 4 gloo ranks (``tests/torch_sharded_serve_worker.py``, through
``repro_torch.testing.run_ranks``) runs the port's ``build_prefill`` and
``build_decode_step`` on the same weights and batches, the same rules and
meshes, on each rank's shards, and its one-device prefill and decode.
Two more cases put MLA's cache positions over "model" (the rules'
override), so that its flash decode gathers the queries' heads.

Tolerances, and why (``tests/test_torch_sharded_serve.py``'s):
- the prefill's and the steps' logits against the reference's jitted
  runs: 1e-4 of max|logits| (two frameworks' f32 sums in other orders),
  the greedy tokens equal;
- against the port's one-device prefill and decode: 1e-5 of max|logits|
  (the ranks' partial sums), the tokens equal, and each rank's cache
  shard, after the prefill and after the steps, within 1e-5 of each
  leaf's max from ``local_shard`` of one device's cache; seamless's
  ``enc_out`` within 1e-5;
- kernel 12's calls (``ops.flash_attention``) a rank: one device's in the
  prefill, none in the decode.
Where the reference's prefill raises under the rules, the port is held to
its one-device run instead (``REFERENCE_RAISES``).
"""
import os
import pickle
import tempfile

import numpy as np
import pytest
import torch

# one torch thread a process: the test run starts several processes at once
torch.set_num_threads(1)

from repro.testing import run_mesh_subprocess  # noqa: E402

import torch_sharded_serve_worker as W  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import axis_rules  # noqa: E402
from repro_torch.interop import lm_params_from_reference  # noqa: E402
from repro_torch.launch.mesh import build_rules  # noqa: E402
from repro_torch.models import get_api  # noqa: E402
from repro_torch.testing import run_ranks  # noqa: E402
from repro_torch.train._tree import leaves  # noqa: E402

WORLD = 4
JOIN_TIMEOUT = 240
REF_REL, ONE_REL = 1e-4, 1e-5
FAMILIES = ("mamba2-780m", "zamba2-2.7b", "seamless-m4t-large-v2", "paligemma-3b",
            "deepseek-v2-lite-16b")
PREFILL_ARCHS = ("stablelm-3b", "llama4-maverick-400b-a17b")
CELLS = ("decode_32k", "long_500k")
MESHES = ((1, 4), (2, 2))
#: kernel 12's calls in one prefill of the smoke model: zamba2's shared
#: attention once a group (2 groups); seamless's 2 encoder layers, and 2
#: decoder layers of a self- and a cross-attention; one a layer for
#: stablelm (3) and llama4 (4); mamba2 has no attention, paligemma's
#: prefix mask and deepseek's MLA are never kernel 12's function
PREFILL_LAUNCHES = {"mamba2-780m": 0, "zamba2-2.7b": 2, "seamless-m4t-large-v2": 6,
                    "paligemma-3b": 0, "deepseek-v2-lite-16b": 0, "stablelm-3b": 3,
                    "llama4-maverick-400b-a17b": 4}
#: where the reference's jitted runs under the rules raise (a
#: ShardingTypeError in its GSPMD cache update, ROADMAP queue 3): llama4's
#: prefill, whose one-device run the port is held to instead; MLA's decode
#: from the cache its mesh prefill made, which it runs from the same cache
#: handed over as host arrays
REFERENCE_RAISES = {"llama4-maverick-400b-a17b": "prefill_error",
                    "deepseek-v2-lite-16b": "decode_error"}

REF_CASES = [dict(kind="family", arch=a, cell=c, mesh=m)
             for a in FAMILIES + PREFILL_ARCHS for c in CELLS for m in MESHES]
#: MLA's positions over "model" beside its heads (held to one device only)
MLA_CASES = [dict(kind="family", arch="deepseek-v2-lite-16b", cell="decode_32k", mesh=(1, 4),
                  overrides={"cache_seq": ("model",)}),
             dict(kind="family", arch="deepseek-v2-lite-16b", cell="long_500k", mesh=(2, 2),
                  overrides={"cache_seq": ("data", "model")})]
CASES = REF_CASES + MLA_CASES

_REFERENCE = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config, SHAPE_CELLS
from repro.models import get_api
from repro.distributed.sharding import axis_rules
from repro.launch.mesh import build_rules

FAMILIES, ARCHS, CELLS, MESHES = {families!r}, {archs!r}, {cells!r}, {meshes!r}
B, PROMPT, STEPS, MAX_LEN = {batch}, {prompt}, {steps}, {max_len}
cells = {{c.name: c for c in SHAPE_CELLS}}
out = dict(params={{}}, batch={{}}, serve={{}})

for arch in ARCHS:
    cfg = get_smoke_config(arch)
    api = get_api(cfg)
    params = api.init_params(jax.random.key(0), cfg)
    rng = np.random.default_rng(5)
    batch = {{"tokens": rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)}}
    if cfg.family == "encdec":
        batch["src_embeds"] = (rng.standard_normal((B, PROMPT, cfg.d_model)) * 0.02
                               ).astype(np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = (rng.standard_normal((B, cfg.n_prefix_tokens, cfg.d_model))
                                 * 0.02).astype(np.float32)
    out["params"][arch] = jax.tree.map(np.asarray, params)
    out["batch"][arch] = batch
    prefix = cfg.n_prefix_tokens or 0
    V = cfg.vocab_size

    def prefill_fn(p, b):
        return api.prefill(p, cfg, b, MAX_LEN + prefix, compute_dtype=jnp.float32,
                           cache_dtype=jnp.float32)

    def step_fn(p, t, c, pos, e):
        return api.decode_step(p, cfg, t, c, pos, e, compute_dtype=jnp.float32)

    def error(e):
        return f"{{type(e).__name__}}: {{str(e)[:300]}}"

    # the prefill's logits, and each step's and the tokens fed; an error
    # of either part in its place
    def run():
        try:
            res = jax.jit(prefill_fn)(params, {{k: jnp.asarray(v) for k, v in batch.items()}})
        except Exception as e:
            return dict(prefill_error=error(e))
        logits, cache = res[0], res[1]
        extras = {{"enc_out": res[2]}} if cfg.family == "encdec" else None
        logits = np.asarray(logits)[..., :V]
        run = dict(prefill=logits)
        if arch not in FAMILIES:
            return run
        step = jax.jit(step_fn)

        def steps(cache):
            # host tokens: an eager argmax of mesh-sharded logits breaks the next trace
            tok = jnp.asarray(np.argmax(logits[:, -1], -1)[:, None].astype(np.int32))
            lgs, fed = [], []
            for i in range(STEPS):
                fed.append(np.asarray(tok[:, 0]))
                lg, cache = step(params, tok, cache, jnp.int32(PROMPT + prefix + i), extras)
                lg = np.asarray(lg)[:, -1, :V]
                lgs.append(lg)
                tok = jnp.asarray(np.argmax(lg, -1)[:, None].astype(np.int32))
            return dict(logits=np.stack(lgs), tokens=np.stack(fed))

        try:
            return dict(run, **steps(cache))
        except Exception as e:
            first = error(e)
        # the same cache handed over as host arrays, as a one-device prefill's
        try:
            return dict(run, **steps(jax.tree.map(np.asarray, cache)), decode_error=first,
                        host_cache=True)
        except Exception as e:
            return dict(run, decode_error=first + " | from host arrays: " + error(e))

    out["serve"][(arch, None, None)] = run()
    for cell in CELLS:
        for d, m in MESHES:
            rules = build_rules(cfg, cells[cell], model_size=m, data_size=d)
            mesh = jax.make_mesh((d, m), ("data", "model"))
            with mesh, axis_rules(rules, mesh=mesh):
                out["serve"][(arch, cell, (d, m))] = run()
with open({path!r}, "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


def _reference():
    with tempfile.TemporaryDirectory(prefix="sharded_families_serve_ref_") as tmp:
        path = os.path.join(tmp, "ref.pkl")
        code = _REFERENCE.format(families=FAMILIES, archs=FAMILIES + PREFILL_ARCHS,
                                 cells=CELLS, meshes=MESHES, batch=W.BATCH, prompt=W.PROMPT,
                                 steps=W.STEPS, max_len=W.MAX_LEN, path=path)
        assert "OK" in run_mesh_subprocess(code, devices=WORLD, timeout=900)
        with open(path, "rb") as f:
            return pickle.load(f)


@pytest.fixture(scope="module")
def ranks():
    """The reference once, then every case once on the 4 ranks: {case
    index: [each rank's result]}."""
    ref = _reference()
    archs = FAMILIES + PREFILL_ARCHS
    inputs = dict(
        params={a: lm_params_from_reference(ref["params"][a], configs.get_smoke_config(a))
                for a in archs},
        batch={a: {k: torch.from_numpy(v) for k, v in ref["batch"][a].items()} for a in archs},
        serve=ref["serve"])
    out = run_ranks(W.run_cases, WORLD, CASES, inputs, timeout=JOIN_TIMEOUT)
    return {i: [out[r][i] for r in range(WORLD)] for i in range(len(CASES))}


def _id(case):
    over = "-cache-seq-" + "-".join(case["overrides"]["cache_seq"]) if "overrides" in case else ""
    return f"{case['arch']}-{case['cell']}-{case['mesh'][0]}x{case['mesh'][1]}{over}"


@pytest.mark.parametrize("i", range(len(REF_CASES)), ids=[_id(c) for c in REF_CASES])
def test_sharded_prefill_and_decode_match_the_references_jitted_runs(ranks, i):
    case, res = REF_CASES[i], ranks[i]
    errors = res[0]["ref_errors"]
    decode = (f"{max(r['ref_rel'] for r in res):.3e}" if "ref_rel" in res[0] else "not run")
    print(f"{_id(case)}: rules {res[0]['rules']}; against the reference's jitted runs "
          f"(raised: {({k: v[:100] for k, v in errors.items()})}): prefill "
          f"{max(r['ref_prefill_rel'] for r in res):.3e}, decode {decode}")
    want = REFERENCE_RAISES.get(case["arch"])
    assert list(errors) == ([want] if want else []), errors
    assert all(e.startswith("ShardingTypeError") for e in errors.values()), errors
    for r in res:
        assert r["ref_prefill_rel"] <= REF_REL, r
        if case["arch"] in FAMILIES:
            assert r["ref_rel"] <= REF_REL and r["ref_same_tokens"], r


@pytest.mark.parametrize("i", range(len(CASES)), ids=[_id(c) for c in CASES])
def test_sharded_prefill_and_decode_match_one_device_on_every_rank(ranks, i):
    """Within 1e-5 of the port's one-device prefill and decode, the same
    tokens on every rank, each rank's cache shard that of one device's
    cache after the prefill and after the steps, and seamless's
    ``enc_out`` whole on every rank."""
    res = ranks[i]
    print(f"{_id(CASES[i])}: prefill {max(r['prefill_one_rel'] for r in res):.3e}, decode "
          f"{max(r['one_rel'] for r in res):.3e}, caches {max(r['cache_rel'] for r in res):.3e} "
          f"of one device's")
    for r in res:
        assert r["prefill_one_rel"] <= ONE_REL and r["one_rel"] <= ONE_REL, r
        assert r["one_same_tokens"] and r["cache_rel"] <= ONE_REL, r
        assert r["enc_rel"] is None or r["enc_rel"] <= ONE_REL, r
        np.testing.assert_array_equal(r["tokens"], res[0]["tokens"])


@pytest.mark.parametrize("i", range(len(CASES)), ids=[_id(c) for c in CASES])
def test_kernel_12_runs_in_the_sharded_prefill_alone(ranks, i):
    """Kernel 12's wrapper once an attention of the prefill on each
    rank's heads, as on one device, and never in a decode step."""
    arch = CASES[i]["arch"]
    for r in ranks[i]:
        assert r["prefill_calls"] == r["one_prefill_calls"] == PREFILL_LAUNCHES[arch], r
        assert r["decode_calls"] == r["one_decode_calls"] == 0, r


# ---------------------------------------------------------------------------
# a mesh of one rank: the sharded path with its collectives skipped
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


def _seeded_batch(cfg):
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (W.BATCH, W.PROMPT), generator=g)}
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.randn((W.BATCH, W.PROMPT, cfg.d_model), generator=g) * 0.02
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.randn((W.BATCH, cfg.n_prefix_tokens, cfg.d_model),
                                            generator=g) * 0.02
    return batch


@pytest.mark.parametrize("arch", FAMILIES + PREFILL_ARCHS)
def test_one_rank_sharded_prefill_and_decode_match_one_device(one_rank_mesh, arch):
    """On a 1 x 1 mesh under the ``decode_32k`` rules for one rank (the
    card's ``phase_sharded_serve`` (d)): the sharded prefill and decode
    within 1e-5 of one device's, the same tokens, caches and enc_out, and
    kernel 12's calls one device's."""
    cfg = configs.get_smoke_config(arch)
    api = get_api(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    batch = _seeded_batch(cfg)
    one = W.serve(cfg, params, batch)
    rules = build_rules(cfg, W.cell("decode_32k"), model_size=1, data_size=1)
    with axis_rules(rules, mesh=one_rank_mesh):
        got = W.serve(cfg, params, batch)
    assert got["prefill_calls"] == one["prefill_calls"] == PREFILL_LAUNCHES[arch]
    assert got["decode_calls"] == one["decode_calls"] == 0
    assert torch.equal(got["fed"], one["fed"])
    assert W.rel(got["prefill"], one["prefill"]) <= ONE_REL
    assert W.rel(got["logits"], one["logits"]) <= ONE_REL
    for key in ("start", "cache"):
        for a, b in zip(leaves(got[key]), leaves(one[key]), strict=True):
            assert a.shape == b.shape and W.rel(a, b) <= ONE_REL
    if cfg.family == "encdec":
        assert W.rel(got["enc_out"], one["enc_out"]) <= ONE_REL
