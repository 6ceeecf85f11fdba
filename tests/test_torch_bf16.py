"""bf16 A storage (the reference's ``a_dtype=jnp.bfloat16``, its O4) in the
port against the reference package, on the CPU.

The reference makes every entry of A in f32, sums D from the f32 entries,
and rounds A to bf16 as it stores it (``astype``); its sweeps widen each
bf16 entry to f32 and accumulate in f32. The port's plain versions do the
same, so:

  - #1 with a bf16 ``out_dtype``: D is held to the f32 D rule (rtol 1e-5 of
    the row's absolute mass) and A to one bf16 ulp of the reference's A:
    the two f32 entries differ by a few f32 ulps and may straddle a bf16
    rounding boundary, so a few entries round one ulp apart. The count of
    such entries is recorded (``bf16_ulp_off`` in the junit report) and
    printed. The reference's CPU run (XLA) flushes subnormal f32 results to
    zero where the port keeps them (as the card does), so values up to
    bf16's smallest normal, 2^-126 (which an f32 subnormal can round up
    to), are compared as zero; the count of such entries is recorded
    beside it (``bf16_subnormal``);
  - #2 and #9 on the same bf16 A bits in both packages: U to #2's f32
    tolerance (rtol 1e-5 plus 1e-7 of max|U|);
  - the port's plain #2 and #9 on a bf16 A give the bits of the same call
    on its f32 upcast;
  - the fused one-pass build in bf16: the kept sets equal, A within one
    bf16 ulp, D by the D rule;
  - ``run_gpic(a_dtype=bf16)`` against the reference's: the port's sweeps
    and k-means on the reference's bf16 A, from its k-means seeds, give
    its labels, and column 0 crosses eps within one sweep of it (an
    eps-crossing may move by a sweep on f32 noise, ROADMAP queue 3); the
    port's whole run gives its health and sweeps. Labels are compared on
    the same A bits: an entry one bf16 ulp apart moves it by 2^-8 of
    itself, which E1's slowly converging kNN embedding carries into a few
    labels at n = 400.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

# one torch thread a process: the test run starts several processes at once,
# and torch using every core in each of them slows all of them down
torch.set_num_threads(1)

import repro.core as jcore
from repro.core import graph as jgraph
from repro.kernels import ops as jops
from repro_torch import AffinitySpec, GPICConfig, dataset_by_name, run_gpic
from repro_torch.core import power as tpower
from repro_torch.core.affinity import block_plan, dense_block_live
from repro_torch.core.gpic import _build_engine_operator
from repro_torch.core.graph import fused_affinity_build
from repro_torch.core.kmeans import kmeans
from repro_torch.core.operators import transpose_matmat
from repro_torch.interop import config_from_reference
from repro_torch.kernels import ops as tops

BF16 = torch.bfloat16
D_RTOL = 1e-5
U_RTOL, U_ATOL = 1e-5, 1e-7
N = 300
#: (rows, cols, row_offset, col_offset) of a 300-point x: the square
#: self-stripe, an off-diagonal stripe the global diagonal crosses, and one
#: whose rows come after its columns (tests/test_torch_kernels.py's STRIPES)
STRIPES = [(slice(0, 200), None, 0, 0), (slice(40, 160), slice(100, 300), 40, 100),
           (slice(170, 300), slice(0, 230), 170, 0)]
STRIPE_IDS = ["square", "stripe", "below"]
E1 = dict(kind="rbf", sigma=0.3, knn_k=10)
E2 = dict(kind="rbf", bandwidth="adaptive", scale_k=7, knn_k=10)


@pytest.fixture(autouse=True)
def pallas_really_ran():
    """Every reference call below that asks for a Pallas kernel ran it."""
    jops.reset_kernel_fallbacks()
    yield
    assert jops.kernel_fallbacks() == {}


def _features(kind, seed=13, m=16):
    x = np.random.default_rng(seed).normal(size=(N, m)).astype(np.float32) * 0.5
    if kind != "rbf":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
    return x


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _ordered_bits(a) -> tuple[np.ndarray, np.ndarray]:
    """A bf16 array (torch or jax/numpy) as ordered ints, adjacent bf16
    values 1 apart, with the values up to the smallest normal (and -0)
    taken as 0; and the mask of those tiny nonzero values."""
    if isinstance(a, torch.Tensor):
        bits = a.view(torch.int16).numpy().view(np.uint16)
    else:
        bits = np.asarray(a).view(np.uint16)
    bits = bits.astype(np.int32)
    tiny = ((bits & 0x7FFF) <= 0x0080) & ((bits & 0x7FFF) != 0)
    mag = np.where(tiny, 0, bits & 0x7FFF)
    return np.where(bits & 0x8000, -mag, mag), tiny


def _assert_within_one_ulp(a_t, a_j, record_property, tag):
    """A (bf16, both packages) within one bf16 ulp entrywise, the values up
    to the smallest normal as zero; the counts of entries one ulp apart and
    of those tiny values are recorded and printed."""
    assert a_t.dtype == BF16 and np.asarray(a_j).dtype == ml_dtypes.bfloat16
    (bt, sub_t), (bj, sub_j) = _ordered_bits(a_t), _ordered_bits(a_j)
    diff = np.abs(bt - bj)
    n_off, n_sub = int((diff != 0).sum()), int((sub_t | sub_j).sum())
    record_property(f"bf16_ulp_off_{tag}", n_off)
    record_property(f"bf16_subnormal_{tag}", n_sub)
    print(f"[{tag}] {n_off} of {diff.size} bf16 entries one ulp from the reference's, "
          f"{n_sub} subnormal")
    assert diff.max() <= 1, f"{tag}: A differs by {diff.max()} bf16 ulps"


def _assert_degrees_close(d_t, d_j, a_mass_ref):
    assert np.all(np.abs(d_t.numpy() - np.asarray(d_j)) <= D_RTOL * a_mass_ref)


def _assert_u_close(u_t, u_j):
    u_j = np.asarray(u_j)
    assert u_t.shape == u_j.shape
    assert np.all(np.abs(u_t - u_j) <= U_RTOL * np.abs(u_j) + U_ATOL * np.abs(u_j).max())


def _midpoint_thresholds(scores, rank=20, gap=4e-6):
    """Per-row thresholds halfway between two consecutive scores, from the
    rank-th largest down to the first pair more than ``gap`` apart, so no
    entry sits within f32 noise of its threshold in either package."""
    s = -np.sort(-np.asarray(scores, np.float64), axis=1)
    gap_ok = (s[:, rank - 1:-1] - s[:, rank:]) > gap
    kept = rank + np.argmax(gap_ok, axis=1)
    rows = np.arange(s.shape[0])
    return ((s[rows, kept - 1] + s[rows, kept]) / 2).astype(np.float32)


def _policy(policy, xr, xc, ro, co):
    """The policy operands (numpy) of a stripe: rbf adaptive scales drawn in
    [0.3, 1.0], or midpoint row thresholds of its f32 scores."""
    if policy == "adaptive":
        rng = np.random.default_rng(3)
        n_cols = xr.shape[0] if xc is None else xc.shape[0]
        return dict(scale_r=rng.uniform(0.3, 1.0, xr.shape[0]).astype(np.float32),
                    scale_c=rng.uniform(0.3, 1.0, n_cols).astype(np.float32))
    if policy == "thr":
        a, _ = tops.affinity_and_degree(_t(xr), _t(xc), kind="rbf", sigma=0.8, row_offset=ro,
                                        col_offset=co)
        return dict(thr=_midpoint_thresholds(a.numpy()))
    return {}


@pytest.mark.parametrize("stripe", STRIPES, ids=STRIPE_IDS)
@pytest.mark.parametrize("kind,policy", [("cosine", None), ("cosine_shifted", None),
                                         ("rbf", None), ("rbf", "thr"), ("rbf", "adaptive")],
                         ids=["cosine", "cosine_shifted", "rbf", "rbf_thr", "rbf_adaptive"])
def test_affinity_bf16_matches_pallas(kind, policy, stripe, record_property):
    """#1's plain version with a bf16 A against the reference's Pallas
    kernel (interpret mode) with out_dtype=bfloat16; the port's bf16 A is
    its f32 A rounded, bit for bit, and its D the f32 call's D."""
    rows, cols, ro, co = stripe
    x = _features(kind)
    xr, xc = np.ascontiguousarray(x[rows]), None if cols is None else np.ascontiguousarray(x[cols])
    pol = _policy(policy, xr, xc, ro, co)
    t_pol = {name: _t(v) for name, v in pol.items()}
    a_j, d_j = jops.affinity_and_degree(_j(xr), _j(xc), kind=kind, sigma=0.8, row_offset=ro,
                                        col_offset=co, out_dtype=jnp.bfloat16, mode="pallas",
                                        **{name: _j(v) for name, v in pol.items()})
    a_t, d_t = tops.affinity_and_degree(_t(xr), _t(xc), kind=kind, sigma=0.8, row_offset=ro,
                                        col_offset=co, out_dtype=BF16, **t_pol)
    a32, d32 = tops.affinity_and_degree(_t(xr), _t(xc), kind=kind, sigma=0.8, row_offset=ro,
                                        col_offset=co, **t_pol)
    assert torch.equal(a_t, a32.to(BF16)) and torch.equal(d_t, d32)
    _assert_within_one_ulp(a_t, a_j, record_property, f"{kind}-{policy}-{ro}-{co}")
    _assert_degrees_close(d_t, d_j, np.abs(a32.numpy()).sum(axis=1))


def _bf16_graph(seed=0):
    """(A bf16 torch, the same bits as a jax array, D f32, plan): E1-like
    thresholded rbf on n = 300 gaussians, so the (16, 256) plan has dead
    tiles."""
    x, _, _ = dataset_by_name("gaussians", N, seed=seed)
    scores, _ = tops.affinity_and_degree(_t(x), kind="rbf", sigma=0.3)
    thr = _midpoint_thresholds(scores.numpy(), rank=10)
    a, d = tops.affinity_and_degree(_t(x), kind="rbf", sigma=0.3, thr=_t(thr), out_dtype=BF16)
    a_j = jnp.asarray(a.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
    live = dense_block_live(a, tops.PLAN_TM, tops.TN)
    assert not bool(live.all())
    return a, a_j, d, block_plan(live)


@pytest.mark.parametrize("r", [1, 4])
@pytest.mark.parametrize("op", ["degree_normalized_matmat", "block_sparse_matmat"])
def test_sweeps_on_bf16_a_match_pallas(op, r):
    """#2 and #9 on the same bf16 A bits in both packages (the reference's
    Pallas kernels in interpret mode, #9 on the port's plan and grid)."""
    a, a_j, d, (counts, col_idx, max_b) = _bf16_graph()
    v = np.random.default_rng(r).random((N, r)).astype(np.float32)
    if op == "degree_normalized_matmat":
        got = tops.degree_normalized_matmat(a, _t(v), d)
        want = jops.degree_normalized_matmat(a_j, jnp.asarray(v), _j(d.numpy()), mode="pallas")
    else:
        got = tops.block_sparse_matmat(a, _t(v), d, counts, col_idx)
        want = jops.block_sparse_matmat(a_j, jnp.asarray(v), _j(d.numpy()),
                                        _j(counts.numpy()), _j(col_idx.numpy()),
                                        jnp.asarray(int(max_b)), tm=tops.PLAN_TM, tn=tops.TN,
                                        mode="pallas")
    assert got.dtype == torch.float32
    _assert_u_close(got.numpy(), want)


@pytest.mark.parametrize("r", [1, 3])
def test_plain_sweeps_on_bf16_a_are_bitwise_its_upcast(r):
    """The port's plain #2 and #9 on a bf16 A give the bits of the same call
    on ``a.float()``, and the stored degree of a bf16 A is the f32 sum of
    its widened entries; the probe's striped transpose product adds the
    same products as one ``a.float().T @ v``, to f32 rounding."""
    a, _, d, (counts, col_idx, _) = _bf16_graph(seed=1)
    v = torch.from_numpy(np.random.default_rng(r).random((N, r)).astype(np.float32))
    af = a.float()
    assert torch.equal(tops.degree_normalized_matmat(a, v, d),
                       tops.degree_normalized_matmat(af, v, d))
    assert torch.equal(tops.block_sparse_matmat(a, v, d, counts, col_idx),
                       tops.block_sparse_matmat(af, v, d, counts, col_idx))
    assert torch.equal(tops.stored_degree(a), tops.stored_degree(af))
    torch.testing.assert_close(transpose_matmat(a, v, stripe=64), af.T @ v,
                               rtol=1e-6, atol=1e-7)
    assert torch.equal(transpose_matmat(af, v), af.T @ v)


@pytest.mark.parametrize("spec", [E1, E2], ids=["E1", "E2"])
def test_fused_build_bf16_matches_reference(spec, record_property):
    """The one-pass truncated build with a bf16 A: the port's is its f32
    build rounded, with the f32 build's D (the masked f32 A's row sums,
    the reference's order), and against the reference's fused build the
    kept sets are equal, A within one bf16 ulp, D by the D rule."""
    x, _, _ = dataset_by_name("gaussians", N, seed=0)
    tspec, jspec = AffinitySpec(**spec), jcore.AffinitySpec(**spec)
    scale, _ = jgraph.affinity_stats(jnp.asarray(x), jcore.AffinitySpec(
        **{**spec, "knn_k": None}))
    a_j, d_j, _ = jgraph.fused_affinity_build(jnp.asarray(x), spec=jspec, scale_r=scale,
                                              scale_c=scale, use_pallas=False,
                                              a_dtype=jnp.bfloat16)
    t_scale = None if scale is None else _t(np.asarray(scale))
    a_t, d_t, _ = fused_affinity_build(_t(x), spec=tspec, scale_r=t_scale, scale_c=t_scale,
                                       a_dtype=BF16)
    a32, d32, _ = fused_affinity_build(_t(x), spec=tspec, scale_r=t_scale, scale_c=t_scale)
    assert torch.equal(a_t, a32.to(BF16)) and torch.equal(d_t, d32)
    kept_t, kept_j = a_t.float().numpy() != 0, np.asarray(a_j, np.float32) != 0
    np.testing.assert_array_equal(kept_t, kept_j)
    _assert_within_one_ulp(a_t, a_j, record_property, "fused")
    _assert_degrees_close(d_t, d_j, np.abs(a32.numpy()).sum(axis=1))


#: run_gpic cases, n = 400 gaussians: (spec fields, block_sparse, embedding,
#: r). E1 runs as its chip cell does, orthogonal r = 2.
RUN_CASES = {
    "dense_rbf": (dict(kind="rbf", sigma=0.3), True, "pic", 1),
    "E1_block_sparse": (E1, True, "orthogonal", 2),
    "E1_dense_storage": (E1, False, "orthogonal", 2),
}
#: the least ARI between the packages' E1 labels on the same bf16 A: f32
#: sum-order noise (2e-7 a sweep) grows to 1e-3 of the embedding over E1's
#: 41 sweeps, since a bf16 A over the f32 D (the reference's order) leaves
#: W's row sums off 1 by up to 2^-9, and moves a label (1 of 400 here;
#: ROADMAP queue 3)
E1_LABEL_ARI = 0.99


def _reference_operator(x, fields, block_sparse):
    """The port's explicit sweep bound to the reference's bf16 A and D
    (its jnp oracles: the fused build on the block-sparse route, pass 1
    and the thresholded build on the dense one), with the port's plan."""
    jspec = jcore.AffinitySpec(**fields)
    if block_sparse and jspec.truncated:
        a, d, _ = jgraph.fused_affinity_build(jnp.asarray(x), spec=jspec, use_pallas=False,
                                              a_dtype=jnp.bfloat16)
    else:
        scale, thr = jgraph.affinity_stats(jnp.asarray(x), jspec, use_pallas=False)
        a, d = jops.affinity_and_degree(jnp.asarray(x), spec=jspec, scale_r=scale,
                                        scale_c=scale, thr=thr, out_dtype=jnp.bfloat16,
                                        mode="reference")
    a = torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(BF16)
    d = _t(np.asarray(d))
    if block_sparse and jspec.truncated:
        counts, col_idx, _ = block_plan(dense_block_live(a, tops.PLAN_TM, tops.TN))
        return tpower.PowerOperator(
            matmat=lambda v: tops.block_sparse_matmat(a, v, d, counts, col_idx), degree=d)
    return tpower.PowerOperator(matmat=lambda v: tops.degree_normalized_matmat(a, v, d),
                                degree=d)


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_run_gpic_bf16_matches_reference(case, capsys):
    """The reference's run_gpic with a_dtype=bfloat16 (its jnp oracles)
    against the port's. On the reference's A bits, from its k-means seeds
    and extra start column, the port's sweeps and k-means give its labels
    (dense rbf: identical; E1: ARI >= E1_LABEL_ARI, the count of differing
    labels printed), column 0 crossing eps within one sweep of it; the
    port's front door routes the same config (it no longer raises) with
    the reference's health and column 0's sweeps within one."""
    from repro.core import power as jpower
    from repro_torch import adjusted_rand_index
    fields, block_sparse, embedding, r = RUN_CASES[case]
    n = 400
    x, _, k = dataset_by_name("gaussians", n, seed=0)
    ref_cfg = jcore.GPICConfig(affinity=jcore.AffinitySpec(**fields), a_dtype=jnp.bfloat16,
                               block_sparse=block_sparse, max_iter=400, use_pallas=False,
                               embedding=embedding, n_vectors=r)
    key = jax.random.key(1)
    ref = jcore.run_gpic(jnp.asarray(x), k, ref_cfg, key=key)
    kkm, krand = jax.random.split(key)
    init = np.asarray(jcore.kmeans_plus_plus_init(
        kkm, jcore.standardize_columns(ref.embeddings), k))
    plain = {f: getattr(ref_cfg, f) for f in ("max_iter", "block_sparse", "embedding",
                                              "n_vectors")}
    cfg = config_from_reference(dict(plain, a_dtype="bfloat16", affinity=fields), n)
    assert cfg.a_dtype == BF16
    op = _reference_operator(x, fields, block_sparse)
    v0 = tpower.init_power_vectors(op.degree, 1)
    if r > 1:
        v0 = torch.cat([v0, _t(np.array(jpower.random_start_vectors(krand, n, r)))], dim=1)
    _, t_cols, _, emb, _ = tpower.run_power_embedding(op, v0, 1e-5 / n, 400,
                                                       embedding=embedding)
    labels, _ = kmeans(tpower.standardize_columns(emb), k, iters=25, init=_t(init.copy()))
    ref_labels = np.asarray(ref.labels)
    ref_sweeps = int(np.asarray(ref.n_iter_cols)[0])
    with capsys.disabled():
        print(f"\n[{case}] labels differing from the reference's on its A: "
              f"{int((labels.numpy() != ref_labels).sum())} of {n}; sweeps port "
              f"{t_cols.tolist()} reference {np.asarray(ref.n_iter_cols).tolist()}")
    if fields is E1:
        assert adjusted_rand_index(ref_labels, labels.numpy()) >= E1_LABEL_ARI
    else:
        np.testing.assert_array_equal(labels.numpy(), ref_labels)
    assert abs(int(t_cols[0]) - ref_sweeps) <= 1
    res = run_gpic(x, k, cfg, device="cpu")
    assert abs(int(res.n_iter) - ref_sweeps) <= 1
    assert res.health.to_dict() == ref.health.to_dict()


@pytest.mark.parametrize("engine", ["streaming", "matrix_free"])
def test_bf16_on_engines_without_a_raises_like_the_reference(engine):
    """The streaming and matrix-free engines store no A: a bf16 a_dtype is
    the reference's ValueError, with its message, in both packages."""
    x, _, k = dataset_by_name("gaussians", 40, seed=0)
    kind = "cosine" if engine == "matrix_free" else "rbf"
    with pytest.raises(ValueError) as ref_err:
        jcore.run_gpic(jnp.asarray(x), k, jcore.GPICConfig(engine=engine, affinity_kind=kind,
                                                           a_dtype=jnp.bfloat16))
    with pytest.raises(ValueError) as port_err:
        run_gpic(x, k, GPICConfig(engine=engine, affinity_kind=kind, a_dtype=BF16),
                 device="cpu")
    assert str(port_err.value) == str(ref_err.value)
