"""The port's kernel modules against the reference package's Pallas kernels.

The same numpy inputs go through ``repro.kernels.ops.<op>(mode="pallas")``
(interpret mode on the CPU, as the reference package's own tests run it)
and through the port's wrappers on CPU tensors, which run the plain
PyTorch versions. The CUDA kernels themselves run only on the card; they
are held against the same plain versions by ``chip_smoke.py``.

Tolerances: A atol 1e-6 (both sides compute the f32 dot product and the
transform with one rounding per step, so they differ by a few ulps of a
value <= 1); D rtol 1e-5 relative to the row's absolute mass sum|A_ij|
(the row sum of raw cosine entries can cancel to ~0, where a plain
relative bound means nothing); U rtol 1e-5 with atol 1e-7 (sums of a few
hundred products in two orders); k-means labels exact, distances rtol 1e-5.
"""
from __future__ import annotations

import os
import stat
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops

A_ATOL = 1e-6
D_RTOL = 1e-5
U_RTOL, U_ATOL = 1e-5, 1e-7
DIST_RTOL = 1e-5


@pytest.fixture(autouse=True)
def pallas_really_ran():
    """Every reference call below must have run the Pallas kernel, not the
    oracle it falls back to when a kernel fails."""
    jops.reset_kernel_fallbacks()
    yield
    assert jops.kernel_fallbacks() == {}


def _features(n, m, kind, seed):
    x = np.random.default_rng(seed).normal(size=(n, m)).astype(np.float32) * 0.5
    if kind != "rbf":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
    return x


def _assert_affinity_close(a_t, d_t, a_j, d_j):
    a_j, d_j = np.asarray(a_j), np.asarray(d_j)
    np.testing.assert_allclose(a_t.numpy(), a_j, rtol=0, atol=A_ATOL)
    mass = np.abs(a_j).sum(axis=1)
    assert np.all(np.abs(d_t.numpy() - d_j) <= D_RTOL * mass)


@pytest.mark.parametrize("kind", ["cosine", "cosine_shifted", "rbf"])
@pytest.mark.parametrize("n,m", [(200, 2), (300, 2), (200, 16), (300, 16)])
def test_affinity_and_degree_matches_pallas(kind, n, m):
    x = _features(n, m, kind, seed=n + m)
    a_j, d_j = jops.affinity_and_degree(jnp.asarray(x), kind=kind, sigma=0.8,
                                        mode="pallas")
    a_t, d_t = tops.affinity_and_degree(torch.from_numpy(x), kind=kind, sigma=0.8)
    assert a_t.shape == (n, n) and a_t.dtype == torch.float32
    assert torch.all(torch.diagonal(a_t) == 0)
    _assert_affinity_close(a_t, d_t, a_j, d_j)


@pytest.mark.parametrize("kind", ["cosine", "cosine_shifted", "rbf"])
def test_affinity_off_diagonal_stripe_matches_pallas(kind):
    x = _features(300, 16, kind, seed=7)
    rows, cols = x[40:160], x[100:300]
    a_j, d_j = jops.affinity_and_degree(jnp.asarray(rows), jnp.asarray(cols),
                                        kind=kind, sigma=0.8, row_offset=40,
                                        col_offset=100, mode="pallas")
    a_t, d_t = tops.affinity_and_degree(torch.from_numpy(rows), torch.from_numpy(cols),
                                        kind=kind, sigma=0.8, row_offset=40,
                                        col_offset=100)
    assert a_t.shape == (120, 200)
    # the global diagonal runs through the stripe at local (i, i - 60)
    assert torch.all(a_t[torch.arange(60, 120), torch.arange(0, 60)] == 0)
    _assert_affinity_close(a_t, d_t, a_j, d_j)


@pytest.mark.parametrize("r", [1, 4])
@pytest.mark.parametrize("rows", [slice(None), slice(50, 170)])
def test_degree_normalized_matmat_matches_pallas(r, rows):
    rng = np.random.default_rng(r)
    x = _features(300, 2, "rbf", seed=11)
    a, d = (np.asarray(t) for t in jops.affinity_and_degree(
        jnp.asarray(x), kind="rbf", sigma=0.8, mode="reference"))
    a, d = a.copy(), d.copy()
    a[60] = 0.0          # a zero-degree row: its output must be an exact 0
    d[60] = 0.0
    a, d = np.ascontiguousarray(a[rows]), np.ascontiguousarray(d[rows])
    v = rng.random((300, r)).astype(np.float32)
    u_j = np.asarray(jops.degree_normalized_matmat(
        jnp.asarray(a), jnp.asarray(v), jnp.asarray(d), mode="pallas"))
    u_t = tops.degree_normalized_matmat(torch.from_numpy(a), torch.from_numpy(v),
                                        torch.from_numpy(d)).numpy()
    assert u_t.shape == (a.shape[0], r)
    np.testing.assert_allclose(u_t, u_j, rtol=U_RTOL, atol=U_ATOL)
    zero_row = 60 - (rows.start or 0)
    assert np.all(u_t[zero_row] == 0.0) and np.all(u_j[zero_row] == 0.0)


@pytest.mark.parametrize("k", [2, 5])
def test_kmeans_assign_matches_pallas_with_planted_tie(k):
    rng = np.random.default_rng(k)
    x = rng.normal(size=(300, 3)).astype(np.float32)
    cents = (rng.normal(size=(k, 3)) + 4.0).astype(np.float32)
    cents[0], cents[1] = (-1.0, 0.0, 0.0), (1.0, 0.0, 0.0)
    x[7] = (0.0, 0.0, 0.0)            # equidistant from centroids 0 and 1
    lab_j, dist_j = jops.kmeans_assign(jnp.asarray(x), jnp.asarray(cents), mode="pallas")
    lab_t, dist_t = tops.kmeans_assign(torch.from_numpy(x), torch.from_numpy(cents))
    assert lab_t.dtype == torch.int32
    np.testing.assert_array_equal(lab_t.numpy(), np.asarray(lab_j))
    np.testing.assert_allclose(dist_t.numpy(), np.asarray(dist_j), rtol=DIST_RTOL, atol=0)
    assert int(lab_t[7]) == 0         # ties go to the first index


def test_cpu_calls_launch_no_kernel():
    _build.reset_launch_counts()
    x = torch.from_numpy(_features(50, 2, "rbf", seed=3))
    a, d = tops.affinity_and_degree(x, kind="rbf")
    tops.degree_normalized_matmat(a, (d / d.sum())[:, None], d)
    tops.kmeans_assign(x, x[:3])
    assert tops.launch_counts() == {"affinity_and_degree": 0,
                                    "degree_normalized_matmat": 0,
                                    "kmeans_assign": 0}


@pytest.mark.parametrize("op", ["affinity", "matmat", "assign"])
def test_non_cpu_tensor_never_takes_the_plain_version(op):
    """Off the CPU a wrapper launches its kernel or raises: a tensor on a
    device that is not CUDA is rejected before any pointer reaches C."""
    x = torch.empty((8, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        if op == "affinity":
            tops.affinity_and_degree(x)
        elif op == "matmat":
            tops.degree_normalized_matmat(torch.empty((8, 8), device="meta"), x,
                                          torch.empty((8,), device="meta"))
        else:
            tops.kmeans_assign(x, x[:2])


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys\n"
                    "print('fake.cu(1): error: no such intrinsic')\nsys.exit(2)\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        _build.build(("kmeans_assign",))
    # nothing half-built is left where a later call would load it
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").rglob("*"))


def test_build_dir_is_keyed_by_the_sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in _build.CSRC.iterdir():
        (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.build_dir()
    (csrc / "power_step.cu").write_text(
        (csrc / "power_step.cu").read_text() + "\n// edited\n")
    assert _build.build_dir() != before
    assert os.path.basename(os.path.dirname(before)) == "repro_torch_kernels"
