"""The sharded train step of the ssm, hybrid, encdec and moe families, and
the two collectives it adds, on the CPU.

As ``tests/test_torch_sharding.py`` does for the dense and vlm families,
the step under ``axis_rules(build_rules(cfg, ...), mesh=mesh)`` is held to
one device's step of the port, which ``tests/test_torch_family_train.py``
and ``tests/test_torch_moe.py`` hold to the reference. One module fixture
spawns 4 gloo ranks (``tests/torch_sharding_worker.py``, through
``repro_torch.testing.run_ranks``) and runs every case there: the smoke
mamba2-780m, zamba2-2.7b, seamless-m4t-large-v2, deepseek-v2-lite-16b and
llama4-maverick (its 2 KV heads replicated over a model axis of 4, the
rule an MQA or GQA model needs on a model axis wider than its KV heads)
on meshes (1, 4) and (2, 2), remat "full", and "none" for mamba2 and
seamless, 3 AdamW steps each; and deepseek under ``REPRO_NAIVE=1``,
whose moe layers take the gathered local form. The expert-parallel moe
family's aux loss is the mean of each data shard's, so over 2 data ranks
its yardstick is one device's step with ``microbatch=2``; the gathered
form's is the whole batch's, as one device's step; the smoke capacity
factor of 8 drops no copy in either form.

Tolerances, and why (``tests/test_torch_sharding.py``'s):
- each step's loss: rtol 1e-5 of one device's (f32 throughout; the ranks
  sum the row-parallel products, the gradients and the norms in another
  order).
- the parameters and the AdamW moments after 3 steps: atol 5e-4, rtol
  2e-3, the reference's own tolerance across mesh shapes
  (``tests/test_elastic_and_drivers.py``); the worst distance is printed.
- the leaves every rank holds whole: bitwise alike on every rank.
- a mesh of one rank: bitwise the one-device step.
- the collectives: within 1e-12 of the whole function in float64 (the
  same sums in another order).
"""
import dataclasses

import numpy as np
import pytest
import torch

# one torch thread a process: the test run starts several processes at once
torch.set_num_threads(1)

import torch_sharding_worker as W  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.testing import run_ranks  # noqa: E402
from repro_torch.train._tree import leaves, named_leaves  # noqa: E402

WORLD = 4
JOIN_TIMEOUT = 240
LOSS_RTOL = 1e-5
COLLECTIVE_ATOL = 1e-12
MESHES = ((1, 4), (2, 2))
#: each arch, the remats it runs, and kernel 12's calls in one forward of
#: its smoke model: zamba2's shared attention once a group of 2 (2 groups);
#: seamless's 2 encoder layers and 2 decoder layers of a self- and a
#: cross-attention; llama4's 4 layers; mamba2 has no attention and
#: deepseek's MLA never reaches kernel 12 (its q.k width of 40 is not v's)
ARCHS = {
    "mamba2-780m": (("full", "none"), 0),
    "zamba2-2.7b": (("full",), 2),
    "seamless-m4t-large-v2": (("full", "none"), 6),
    "deepseek-v2-lite-16b": (("full",), 0),
    "llama4-maverick-400b-a17b": (("full",), 4),
}
SSM_ARCHS = ("mamba2-780m", "zamba2-2.7b")


def _step_case(arch, shape, remat, naive=False):
    case = dict(kind="step", arch=arch, mesh=shape, remat=remat, naive=naive)
    if configs.get_smoke_config(arch).n_kv_heads % shape[1]:
        case["overrides"] = {"kv_heads": None, "kv_heads_act": None}
    return case


#: REPRO_NAIVE=1: deepseek's moe layers take the gathered local form
#: (``moe._moe_ffn_gathered``: every rank's rows and experts gathered)
NAIVE_STEP_CASES = [_step_case("deepseek-v2-lite-16b", m, "full", naive=True) for m in MESHES]
STEP_CASES = [_step_case(a, m, r) for a, (remats, _) in ARCHS.items() for m in MESHES
              for r in remats] + NAIVE_STEP_CASES
SHARD_CASES = [dict(kind="shard", arch=a, mesh=m) for a in SSM_ARCHS for m in MESHES]
#: (op, shape, dim) of the collectives' cases, each on both meshes' model axes
COLLECTIVES = (("gather_summed", (2, 3, 8), 2), ("gather_summed", (8, 3), 0),
               ("all_sum", (2, 3, 8), 2))
COLLECTIVE_CASES = [dict(kind="collective", op=op, shape=shape, dim=dim, mesh=m)
                    for op, shape, dim in COLLECTIVES for m in MESHES]
CASES = STEP_CASES + SHARD_CASES + COLLECTIVE_CASES


@pytest.fixture(scope="module")
def ranks():
    """Every case once on the 4 ranks: {case index: [each rank's result]}."""
    out = run_ranks(W.run_cases, WORLD, CASES, timeout=JOIN_TIMEOUT)
    return {i: [out[r][i] for r in range(WORLD)] for i in range(len(CASES))}


def _step_id(case):
    return (f"{case['arch']}-{case['mesh'][0]}x{case['mesh'][1]}-{case['remat']}"
            + ("-naive" if case["naive"] else ""))


STEP_IDS = [_step_id(c) for c in STEP_CASES]


@pytest.mark.parametrize("i", range(len(STEP_CASES)), ids=STEP_IDS)
def test_sharded_family_step_losses_match_one_device(ranks, i):
    for r, res in enumerate(ranks[i]):
        np.testing.assert_allclose(res["losses"], res["one_losses"], rtol=LOSS_RTOL, atol=0,
                                   err_msg=f"rank {r}")
        assert res["one_losses"] == ranks[i][0]["one_losses"]


@pytest.mark.parametrize("i", range(len(STEP_CASES)), ids=STEP_IDS)
def test_sharded_family_parameters_and_adamw_state_match_one_device(ranks, i):
    worst = {what: max(res["worst"][what][0] for res in ranks[i]) for what in
             ("params", "mu", "nu")}
    ratio = {what: max(res["worst"][what][1] for res in ranks[i]) for what in worst}
    print(f"{STEP_IDS[i]}: worst |sharded - one device| after {W.STEPS} steps {worst}; "
          f"of atol {W.ATOL} + rtol {W.RTOL} |x|: {ratio}")
    assert all(x <= 1.0 for x in ratio.values()), ratio


@pytest.mark.parametrize("i", range(len(STEP_CASES)), ids=STEP_IDS)
def test_sharded_family_replicated_leaves_are_bitwise_alike_on_every_rank(ranks, i):
    assert len({res["replicated"] for res in ranks[i]}) == 1
    coords = sorted(tuple(res["coordinate"]) for res in ranks[i])
    d, m = STEP_CASES[i]["mesh"]
    assert coords == [(a, b) for a in range(d) for b in range(m)]


@pytest.mark.parametrize("i", range(len(STEP_CASES)), ids=STEP_IDS)
def test_kernel_12_runs_on_each_ranks_heads_a_step(ranks, i):
    """Kernel 12's forward in each forward (twice under remat "full": the
    forward and its recomputation) and its backward once, for every
    attention of the model, on each rank's own heads."""
    case = STEP_CASES[i]
    a_forward = ARCHS[case["arch"]][1]
    forwards = 2 if case["remat"] == "full" else 1
    for res in ranks[i]:
        assert res["flash_calls"] == a_forward * forwards * W.STEPS
        assert res["flash_bwd_calls"] == a_forward * W.STEPS


@pytest.mark.parametrize("i", range(len(STEP_CASES)), ids=STEP_IDS)
def test_moe_layers_take_the_form_the_mode_asks_for(ranks, i):
    """The moe layers' expert-parallel form (once a forward and once a
    recomputation a moe layer a step), or under REPRO_NAIVE=1 the gathered
    local form as often; the other families call neither."""
    case = STEP_CASES[i]
    cfg = configs.get_smoke_config(case["arch"])
    n_moe = sum(k == "moe" for k, _ in moe.layer_schedule(cfg)) if cfg.moe else 0
    want = {"_moe_ffn_gathered" if case["naive"] else "_moe_ffn_ep": 2 * n_moe * W.STEPS}
    for res in ranks[i]:
        assert res["moe_forms"] == (want if n_moe else {}), res["moe_forms"]


@pytest.mark.parametrize("i", range(len(SHARD_CASES)),
                         ids=[f"{c['arch']}-{c['mesh'][0]}x{c['mesh'][1]}" for c in SHARD_CASES])
def test_mamba_shards_are_contiguous_slices_not_the_ranks_heads(ranks, i):
    """A rank's ``in_proj``, ``conv_w`` and ``conv_b`` are contiguous
    slices of z | x | B | C | dt and of x | B | C (not its heads' columns);
    its ``dt_bias``, ``norm`` and ``out_proj`` rows are its heads'."""
    case = SHARD_CASES[i]
    cfg = configs.get_smoke_config(case["arch"])
    full = named_leaves(W.init(cfg)[0])
    key = "layers" if cfg.family == "ssm" else "mamba"
    d_inner = cfg.ssm.expand * cfg.d_model
    m = case["mesh"][1]
    for res in ranks[len(STEP_CASES) + i]:
        r = res["coordinate"][1]
        for leaf in ("in_proj", "conv_w", "conv_b", "dt_bias", "norm", "out_proj"):
            name = f"{key}.1.{leaf}"
            want = full[name]
            dim = 0 if leaf == "out_proj" else want.ndim - 1
            w = want.shape[dim] // m
            np.testing.assert_array_equal(res["local"][name],
                                          want.narrow(dim, r * w, w).numpy(), err_msg=name)
        width = full[f"{key}.1.in_proj"].shape[1] // m
        # rank 1 of 4 holds the tail of z and the head of x
        if m == 4 and r == 1:
            assert width < d_inner < 2 * width


def _collective_want(case, m):
    full = np.random.default_rng(7).standard_normal(case["shape"])
    dim = case["dim"]
    out_shape = list(case["shape"])
    if case["op"] == "all_sum":
        out_shape[dim] //= m
        out = sum(np.split(full, m, axis=dim))
    else:
        out = full
    weights = sum(np.random.default_rng(100 + r).standard_normal(out_shape) for r in range(m))
    grads = np.split(weights, m, axis=dim) if case["op"] == "gather_summed" else [weights] * m
    return out, grads


@pytest.mark.parametrize("i", range(len(COLLECTIVE_CASES)),
                         ids=[f"{c['op']}-dim{c['dim']}-model{c['mesh'][1]}"
                              for c in COLLECTIVE_CASES])
def test_collectives_match_the_whole_function(ranks, i):
    """``gather_summed`` and ``all_sum`` over "model": each rank's output
    is the whole function of the ranks' parts, and the gradient of its part
    is that of the sum of every rank's loss (each rank weights the output
    by its own seeded weights)."""
    case = COLLECTIVE_CASES[i]
    out, grads = _collective_want(case, case["mesh"][1])
    for res in ranks[len(STEP_CASES) + len(SHARD_CASES) + i]:
        np.testing.assert_allclose(res["out"], out, rtol=0, atol=COLLECTIVE_ATOL)
        np.testing.assert_allclose(res["grad"], grads[res["rank"]], rtol=0,
                                   atol=COLLECTIVE_ATOL)


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


@pytest.mark.parametrize("arch", list(ARCHS))
def test_one_by_one_mesh_is_the_one_device_family_step_bitwise(one_rank_mesh, arch):
    cfg = configs.get_smoke_config(arch)
    params, opt = W.init(cfg)
    one_params, one_opt, one_losses = W.steps(cfg, W.tcfg("full"), *W.init(cfg),
                                              W.batches(cfg))
    rules = mesh.build_rules(cfg, model_size=1, data_size=1)
    with sharding.axis_rules(rules, mesh=one_rank_mesh):
        pl = W.placements_of(cfg, one_rank_mesh, params)
        local = mesh.shard_tree(params, one_rank_mesh, pl)
        opt = dataclasses.replace(opt, mu=mesh.shard_tree(opt.mu, one_rank_mesh, pl),
                                  nu=mesh.shard_tree(opt.nu, one_rank_mesh, pl))
        local, opt, losses = W.steps(cfg, W.tcfg("full"), local, opt, W.batches(cfg))
    assert losses == one_losses
    for got, want in ((local, one_params), (opt.mu, one_opt.mu), (opt.nu, one_opt.nu)):
        for a, b in zip(leaves(got), leaves(want), strict=True):
            assert torch.equal(a, b)
