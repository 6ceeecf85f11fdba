"""The port's logical-axis rules and its sharded LM train step, on the CPU.

The rules, the specs and the batch and decode specs are pure functions:
they are held to the reference's (``repro.launch.mesh``,
``repro.distributed.sharding``, each family's ``*_specs``) for every arch,
every shape cell and none, one pod and two, ``REPRO_NAIVE`` 0 and 1.

The sharded step cannot be held to the reference, whose mesh runs stop in
a ShardingTypeError on this JAX; it is held to one device's step of the
port, which ``tests/test_torch_train.py`` and
``tests/test_torch_family_train.py`` hold to the reference. One module
fixture spawns 4 gloo ranks (``tests/torch_sharding_worker.py``, through
``repro_torch.testing.run_ranks``) and runs every case there: the smoke
stablelm-3b, qwen1.5-4b (its qkv bias) and paligemma-3b (tied embeddings,
an image prefix; its one KV head replicated over "model", the rule an MQA
model needs on a model axis wider than its KV heads) on meshes (1, 4),
(2, 2) and (4, 1), remat "none" and "full", 3 AdamW steps each.

Tolerances, and why:
- each step's loss: rtol 1e-5 of one device's (f32 throughout; the ranks
  sum the row-parallel products, the gradients and the norm in another
  order; measured under 2e-7).
- the parameters and the AdamW moments after 3 steps: atol 5e-4, rtol
  2e-3, the reference's own tolerance across mesh shapes
  (``tests/test_elastic_and_drivers.py``); the worst distance is printed.
- the leaves every rank holds whole: bitwise alike on every rank (each
  all-reduce gives every rank the same bits).
- a mesh of one rank: bitwise the one-device step.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

# one torch thread a process: the test run starts several processes at once
torch.set_num_threads(1)

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402

import torch_sharding_worker as W  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import decode_inputs_specs, get_api, train_batch_specs  # noqa: E402
from repro_torch.testing import run_ranks  # noqa: E402
from repro_torch.train._tree import leaves  # noqa: E402

WORLD = 4
JOIN_TIMEOUT = 240
LOSS_RTOL = 1e-5
ARCHS = configs.ARCH_IDS
CELLS = (None, *configs.SHAPE_CELLS)
STEP_ARCHS = {"stablelm-3b": {}, "qwen1.5-4b": {},
              "paligemma-3b": {"overrides": {"kv_heads": None, "kv_heads_act": None}}}
MESHES = ((1, 4), (2, 2), (4, 1))
REMATS = ("none", "full")

STEP_CASES = [dict(kind="step", arch=a, mesh=m, remat=r, **kw)
              for a, kw in STEP_ARCHS.items() for m in MESHES for r in REMATS]
SHARD_CASES = [dict(kind="shard", arch="qwen1.5-4b", mesh=m) for m in MESHES]
_SMOKE_SSM = configs.get_smoke_config("mamba2-780m").ssm
_SMOKE_MOE = configs.get_smoke_config("deepseek-v2-lite-16b").moe
#: (id, case): for each family past dense and vlm what its step still
#: refuses, then rules the layout cannot take
RAISE_CASES = {
    # in_proj's 298 columns over 4 ranks
    "ssm": dict(arch="mamba2-780m", mesh=(1, 4),
                replace={"ssm": dataclasses.replace(_SMOKE_SSM, d_state=17)}),
    "hybrid": dict(arch="zamba2-2.7b", mesh=(2, 2), train={"gradient_compression": True}),
    "encdec": dict(arch="seamless-m4t-large-v2", mesh=(2, 2), overrides={"embed": "model"}),
    # 6 experts over 4 ranks
    "moe-mla": dict(arch="deepseek-v2-lite-16b", mesh=(1, 4),
                    replace={"moe": dataclasses.replace(_SMOKE_MOE, n_experts=6)}),
    "embed-over-model": dict(arch="stablelm-3b", mesh=(1, 4), overrides={"embed": "model"}),
    # wk's and wv's 30 columns (one KV head of 30) over 4 ranks
    "kv-flat-width-not-divided": dict(arch="granite-34b", mesh=(1, 4),
                                      replace={"head_dim": 30}),
    "vocab-over-data": dict(arch="qwen1.5-4b", mesh=(2, 2), overrides={"vocab": ("data",)}),
    "d-ff-not-divided": dict(arch="stablelm-3b", mesh=(1, 4), replace={"d_ff": 250}),
    "batch-not-divided": dict(arch="qwen1.5-4b", mesh=(4, 1), batch=6),
    "seq-sharded": dict(arch="stablelm-3b", mesh=(2, 2), overrides={"seq": "model"}),
}
CASES = (STEP_CASES + SHARD_CASES
         + [dict(kind="raise", **c) for c in RAISE_CASES.values()])


def _pair(arch):
    return jconfigs.get_config(arch), configs.get_config(arch)


# ---------------------------------------------------------------------------
# the rules, the specs and the spec resolution against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("naive", ["0", "1"])
@pytest.mark.parametrize("arch", ARCHS)
def test_build_rules_match_the_reference(arch, naive, monkeypatch):
    monkeypatch.setenv("REPRO_NAIVE", naive)
    jcfg, cfg = _pair(arch)
    for jcell, cell in zip((None, *jconfigs.SHAPE_CELLS), CELLS):
        for multi_pod in (False, True):
            want = jmesh.build_rules(jcfg, jcell, multi_pod=multi_pod)
            got = mesh.build_rules(cfg, cell, multi_pod=multi_pod)
            assert got == want, (arch, cell, multi_pod)
    assert sharding.naive_mode() == jsharding.naive_mode() == (naive == "1")


def _spec_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_spec_leaves(v, f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tuple(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_match_the_reference(arch):
    jcfg, cfg = _pair(arch)
    api, japi = get_api(cfg), jzoo.get_api(jcfg)
    assert api.param_specs(cfg) == japi.param_specs(jcfg)
    assert api.cache_specs(cfg) == japi.cache_specs(jcfg)
    # the port's meta parameters: the spec tree's keys, a layer list's
    # elements one rank below their stacked specs
    meta = api.init_params(None, cfg)
    laid = mesh.specs_like(api.param_specs(cfg), meta)
    for t, spec in zip(leaves(meta), _flat(laid), strict=True):
        assert t.ndim == len(spec), spec
    assert _keys(meta) == _keys(api.param_specs(cfg))
    cache = api.init_cache(cfg, 2, 8, device="meta")
    assert {k: v.ndim for k, v in _named(cache).items()} == {
        k: len(v) for k, v in _spec_leaves(api.cache_specs(cfg)).items()}


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def _keys(tree):
    """The dict keys of a tree, a layer list read as its first element."""
    if isinstance(tree, list):
        return _keys(tree[0])
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_named(v, f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_to_spec_of_every_leaf_matches_the_reference(arch):
    jcfg, cfg = _pair(arch)
    api = get_api(cfg)
    specs = {**_spec_leaves(api.param_specs(cfg), "params"),
             **_spec_leaves(api.cache_specs(cfg), "cache")}
    for jcell, cell in zip((None, *jconfigs.SHAPE_CELLS), CELLS):
        for multi_pod in (False, True):
            rules = mesh.build_rules(cfg, cell, multi_pod=multi_pod)
            with jsharding.axis_rules(jmesh.build_rules(jcfg, jcell, multi_pod=multi_pod)):
                want = {k: tuple(jsharding.logical_to_spec(s)) for k, s in specs.items()}
            with sharding.axis_rules(rules):
                got = {k: sharding.logical_to_spec(s) for k, s in specs.items()}
            assert got == want, (arch, cell, multi_pod)


def _as_jax_dtype(dtype):
    return {torch.int32: "int32", torch.bfloat16: "bfloat16", torch.float32: "float32"}[dtype]


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_decode_specs_match_the_reference(arch):
    jcfg, cfg = _pair(arch)
    for got, want in ((train_batch_specs(cfg, 8, 64), jzoo.train_batch_specs(jcfg, 8, 64)),
                      (decode_inputs_specs(cfg, 2, 96), jzoo.decode_inputs_specs(jcfg, 2, 96))):
        got, want = _named(got), _named(want)
        assert sorted(got) == sorted(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), k
            assert _as_jax_dtype(t.dtype) == str(want[k].dtype), k


def test_axis_rules_nest_and_restore_and_constrain_is_the_identity():
    x = torch.arange(6.0).reshape(2, 3)
    assert sharding.current_rules() is None and sharding.current_mesh() is None
    assert sharding.constrain(x, "batch", "embed") is x
    assert sharding.logical_to_spec(("batch", "heads")) == (None, None)
    outer, inner = {"batch": ("data",), "heads": "model"}, {"batch": None, "heads": "data"}
    with sharding.axis_rules(outer, mesh="outer-mesh"):
        assert sharding.current_rules() == outer and sharding.current_mesh() == "outer-mesh"
        assert sharding.logical_to_spec(("batch", "heads")) == ("data", "model")
        with sharding.axis_rules(inner):
            assert sharding.current_rules() == inner
            assert sharding.current_mesh() == "outer-mesh"
            assert sharding.logical_to_spec(("heads", "batch")) == ("data", None)
        assert sharding.current_rules() == outer
        assert sharding.constrain(x, "batch", "embed") is x
        with pytest.raises(ValueError, match="axis names"):
            sharding.constrain(x, "batch")
        # a mesh axis appears at most once: the reference's dedup
        with sharding.axis_rules({"a": ("data", "model"), "b": "model"}):
            assert sharding.logical_to_spec(("a", "b")) == (("data", "model"), None)
    assert sharding.current_rules() is None and sharding.current_mesh() is None


def test_bound_function_sees_the_rules_on_another_thread():
    """A checkpointed layer's recomputation runs on autograd's device thread
    on the card: ``bind`` carries the rules and the mesh there."""
    seen = []
    with sharding.axis_rules({"heads": "model"}, mesh="m"):
        fn = sharding.bind(lambda: seen.append((sharding.current_rules(),
                                                sharding.current_mesh())))
    t = threading.Thread(target=fn)
    t.start()
    t.join()
    assert seen == [({"heads": "model"}, "m")]
    assert sharding.bind(len) is len     # nothing to carry without rules


def test_production_mesh_raises_without_its_ranks():
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        mesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        mesh.make_production_mesh(multi_pod=True)


def test_port_specs_resolve_to_placements_of_the_reference_specs():
    """``param_shardings``' placements name the mesh dimensions of the
    reference's PartitionSpec of each leaf."""
    from torch.distributed.tensor import Replicate, Shard
    jcfg, cfg = _pair("qwen1.5-4b")

    class Mesh:
        mesh_dim_names = ("data", "model")

    rules = mesh.build_rules(cfg, model_size=4, data_size=2)
    with sharding.axis_rules(rules):
        got = mesh.param_shardings(Mesh(), get_api(cfg).param_specs(cfg))
    with jsharding.axis_rules(jmesh.build_rules(jcfg, model_size=4, data_size=2)):
        want = {k: tuple(jsharding.logical_to_spec(s))
                for k, s in _spec_leaves(jzoo.get_api(jcfg).param_specs(jcfg)).items()}
    for k, placements in _named(got).items():
        spec = want[k]
        for axis, pl in zip(Mesh.mesh_dim_names, placements):
            dims = [d for d, a in enumerate(spec) if a == axis]
            assert pl == (Shard(dims[0]) if dims else Replicate()), (k, spec, placements)


# ---------------------------------------------------------------------------
# the sharded step on 4 gloo ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks():
    """Every case once on the 4 ranks: {case index: [each rank's result]}."""
    out = run_ranks(W.run_cases, WORLD, CASES, timeout=JOIN_TIMEOUT)
    return {i: [out[r][i] for r in range(WORLD)] for i in range(len(CASES))}


def _step_id(case):
    return f"{case['arch']}-{case['mesh'][0]}x{case['mesh'][1]}-{case['remat']}"


@pytest.mark.parametrize("i", range(len(STEP_CASES)), ids=[_step_id(c) for c in STEP_CASES])
def test_sharded_step_losses_match_one_device(ranks, i):
    for r, res in enumerate(ranks[i]):
        np.testing.assert_allclose(res["losses"], res["one_losses"], rtol=LOSS_RTOL, atol=0,
                                   err_msg=f"rank {r}")
        assert res["one_losses"] == ranks[i][0]["one_losses"]


@pytest.mark.parametrize("i", range(len(STEP_CASES)), ids=[_step_id(c) for c in STEP_CASES])
def test_sharded_step_parameters_and_adamw_state_match_one_device(ranks, i):
    worst = {what: max(res["worst"][what][0] for res in ranks[i]) for what in
             ("params", "mu", "nu")}
    ratio = {what: max(res["worst"][what][1] for res in ranks[i]) for what in worst}
    print(f"{_step_id(STEP_CASES[i])}: worst |sharded - one device| after "
          f"{W.STEPS} steps {worst}; of atol {W.ATOL} + rtol {W.RTOL} |x|: {ratio}")
    assert all(x <= 1.0 for x in ratio.values()), ratio


@pytest.mark.parametrize("i", range(len(STEP_CASES)), ids=[_step_id(c) for c in STEP_CASES])
def test_replicated_leaves_are_bitwise_alike_on_every_rank(ranks, i):
    assert len({res["replicated"] for res in ranks[i]}) == 1
    coords = sorted(tuple(res["coordinate"]) for res in ranks[i])
    d, m = STEP_CASES[i]["mesh"]
    assert coords == [(a, b) for a in range(d) for b in range(m)]


@pytest.mark.parametrize("i", range(len(STEP_CASES)), ids=[_step_id(c) for c in STEP_CASES])
def test_kernel_12_runs_once_a_layer_on_every_rank(ranks, i):
    """``ops.flash_attention`` once a layer a rank in each forward (twice
    under remat "full": the forward and its recomputation), on the rank's
    own heads; paligemma's image prefix takes the masked path, never
    kernel 12."""
    case = STEP_CASES[i]
    a_layer = 0 if case["arch"] == "paligemma-3b" else 1
    forwards = 2 if case["remat"] == "full" else 1
    for res in ranks[i]:
        assert res["flash_calls"] == a_layer * forwards * res["n_layers"] * W.STEPS


@pytest.mark.parametrize("i", range(len(SHARD_CASES)),
                         ids=[f"{m[0]}x{m[1]}" for m in MESHES])
def test_local_shards_are_the_slices_of_the_full_tensor(ranks, i):
    case = SHARD_CASES[i]
    cfg = configs.get_smoke_config(case["arch"])
    full = W.init(cfg)[0]
    d, m = case["mesh"]
    for res in ranks[len(STEP_CASES) + i]:
        assert res["same_as_dtensor"]
        a, b = res["coordinate"]
        for name, t in _named_leaves(full).items():
            want = t
            spec = res["placements"][name]
            for j, (pl, k, size) in enumerate(zip(spec, (a, b), (d, m))):
                if pl.startswith("S("):
                    dim = int(pl[2:-1])
                    w = want.shape[dim] // size
                    want = want.narrow(dim, k * w, w)
            np.testing.assert_array_equal(res["local"][name], want.numpy(), err_msg=name)
        placed = res["placements"]
        if m > 1:
            assert placed["layers.0.attn.wq"] == ["R", "S(1)"]
            assert placed["layers.0.attn.wo"] == ["R", "S(0)"]
            assert placed["embed.tok"] == ["R", "S(0)"]
            assert placed["layers.0.ln1"] == ["R", "R"]


def _named_leaves(tree):
    from repro_torch.train._tree import named_leaves
    return named_leaves(tree)


@pytest.mark.parametrize("name", list(RAISE_CASES))
def test_unrouted_families_and_rules_raise_naming_12b_4c_on_every_rank(ranks, name):
    i = len(STEP_CASES) + len(SHARD_CASES) + list(RAISE_CASES).index(name)
    for res in ranks[i]:
        assert res["raised"] is not None and "12b.4c" in res["raised"], res["raised"]


# ---------------------------------------------------------------------------
# a mesh of one rank: the one-device step, bit for bit
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


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("arch", list(STEP_ARCHS))
def test_one_by_one_mesh_is_the_one_device_step_bitwise(one_rank_mesh, arch, remat):
    cfg = configs.get_smoke_config(arch)
    params, opt = W.init(cfg)
    one_params, one_opt, one_losses = W.steps(cfg, W.tcfg(remat), *W.init(cfg),
                                              W.batches(cfg))
    rules = mesh.build_rules(cfg, model_size=1, data_size=1)
    with sharding.axis_rules(rules, mesh=one_rank_mesh):
        pl = W.placements_of(cfg, one_rank_mesh, params)
        local = mesh.shard_tree(params, one_rank_mesh, pl)
        opt = dataclasses.replace(opt, mu=mesh.shard_tree(opt.mu, one_rank_mesh, pl),
                                  nu=mesh.shard_tree(opt.nu, one_rank_mesh, pl))
        local, opt, losses = W.steps(cfg, W.tcfg(remat), local, opt, W.batches(cfg))
    assert losses == one_losses
    for got, want in ((local, one_params), (opt.mu, one_opt.mu), (opt.nu, one_opt.nu)):
        for a, b in zip(leaves(got), leaves(want), strict=True):
            assert torch.equal(a, b)


@pytest.mark.parametrize("model", [1, 2, 4, 8])
@pytest.mark.parametrize("arch", ["stablelm-3b", "qwen1.5-4b", "h2o-danube-3-4b", "zamba2-2.7b",
                                  "seamless-m4t-large-v2"])
def test_local_head_views_take_kernel_12s_16_byte_staging(arch, model):
    """A rank's (b, h / model, s, d) views of its q, k and v, as
    ``layers.attention`` hands them to kernel 12 at the published head
    widths: unit stride in d and every row on 16 bytes, so the kernel reads
    them in place through its cp.async ring (``_rows_aligned16``), as it
    reads one device's."""
    from repro_torch.kernels.flash_attention import _rows_aligned16
    cfg = configs.get_config(arch)
    hd = cfg.resolved_head_dim
    for heads in (cfg.n_heads // model, max(cfg.n_kv_heads // model, 1)):
        x = torch.empty((2, 64, heads * hd))            # a local projection's output
        view = x.reshape(2, 64, heads, hd).transpose(1, 2)
        assert view.stride(-1) == 1 and _rows_aligned16(view), (heads, hd)


def test_parameters_not_placed_for_the_mesh_raise_before_any_collective():
    """The whole parameters (or another model's tree) handed to a step on a
    (1, 4) mesh: ValueError from the shape check, which reads only the
    mesh's dimensions."""
    class Mesh:
        mesh_dim_names, shape = ("data", "model"), (1, 4)

        def get_coordinate(self):
            return [0, 1]

    cfg = configs.get_smoke_config("stablelm-3b")
    params, opt = W.init(cfg)
    step = W.build_train_step(cfg, W.tcfg("none"))
    batch = W.batches(cfg)[0]
    with sharding.axis_rules(mesh.build_rules(cfg, model_size=4, data_size=1), mesh=Mesh()):
        with pytest.raises(ValueError, match="on this rank; its placement"):
            step(params, opt, batch)
        local = mesh.shard_tree(params, Mesh(), W.placements_of(cfg, Mesh(), params))
        del local["ln_f"]
        with pytest.raises(ValueError, match="leaves on this rank"):
            step(local, opt, batch)
