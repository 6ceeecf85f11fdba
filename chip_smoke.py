#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of GPIC, and of its LM substrate's dense
serving path, on one CUDA card, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

  0. device     require a CUDA card; print its name and power limit.
  1. build      compile the kernels from src/repro_torch/kernels/csrc with
                nvcc (one process per source, all started together).
  2. kernels    hold each kernel against its plain PyTorch version on the
                card, at the main path's shapes (n = 45,000 points of the
                paper's 2-D gaussians, m = 2, r = 1 or 2, k = 4 on a 1-D
                embedding) and at ragged ones (n = 1,037, m = 16, r up to
                32, off-diagonal stripes, planted k-means ties); the power
                sweep's cp.async ring bitwise its plain-load template; time the
                kernel, the plain version and, where one exists, the one
                PyTorch call that computes the same function. The streamed
                D and U must be bitwise the explicit kernels' D and U, and
                the Gram the same bits on every call. The row top-k (pass 1
                of the graph policies) must equal torch.topk of the plain
                scores at the main shape for K = 1..64, both stats, with and
                without adaptive scales; with the kNN and adaptive operands
                of E1 and E2, A must be bitwise its plain version's, the
                streamed D and U bitwise the explicit kernels', the
                column-thresholded product the transpose of the stored A,
                and every row must keep knn_k entries (more only on a tie
                at its threshold).
                The block-sparse kernels (#8-#11) with E1's and E2's operands:
                the live map equal to dense_block_live of the thresholded A,
                the sweeps and the degree bitwise their dense twins (#2, #5,
                #6, #1's D), the fused one-pass build bitwise the two-pass
                build; ragged and off-diagonal stripes at m = 16; a NaN in V.
                Flash attention (#12) at the serve shape (b h = 128,
                s = 2,048, d = 80, causal, f32 q over bf16 K and V, also as
                strided views of a cache), ragged s = 1,000, GQA rep 4
                d = 120, MQA rep 48 d = 128, full (non-causal), all-bf16,
                rows off 16-byte alignment (d = 17, the scalar-staging
                template) and b h = 70,000, timed beside torch's
                scaled_dot_product_attention; its bounds with the products
                on the f32 FMA units and as the split-TF32 terms it runs on
                the tensor cores, and each template's registers (no spills
                at d = 80 and 128).
  3. end to end run_gpic on each path, with the launch counters reset just
                before it and read just after:
                - explicit, gaussians: n = 2,000 on the card against the
                  same call on the CPU (the plain versions), then the
                  paper's n = 45,000: ARI >= 0.99, affinity once, the sweep
                  once per power iteration, the assignment kmeans_iters + 1
                  times;
                - streaming, the same config: the explicit run's embedding,
                  labels and sweeps, the streamed degree once, the streamed
                  sweep once per iteration, no affinity build, peak memory
                  under 1 GB;
                - streaming at n = 150,000, where A would need 90 GB: ARI
                  >= 0.99, peak memory under 1 GB, the kernel against its
                  plain version on three 2,048-row stripes;
                - orthogonal (three_circles, r = 2) on both engines, as is
                  and with residual_tol=1e-3: the same labels and sweeps on
                  both, the ARI floor, the Gram once per QR sweep plus once
                  per residual check;
                - ensemble, streaming, gaussians: ARI >= 0.99, an (n, S)
                  embedding;
                - the graph specs, orthogonal r = 2, block_sparse=False:
                  E1 (rbf 0.3, knn_k=10) at n = 480 over the reference's
                  ARI floor of 0.95, then E1 and E2 (adaptive, scale_k=7,
                  knn_k=10) at n = 45,000 on both engines with the same
                  labels, sweeps and components, the row top-k once (E1)
                  or twice (E2), the probe's sweeps counted apart; E3
                  (adaptive dense, pic, explicit: pass 1a only, no probe);
                  two_moons with knn_k=64, reported only;
                - E1 and E2 with block_sparse=True (the default) on both
                  engines: the block_sparse=False runs bit for bit, with
                  the block-sparse launches (explicit: #1 once, #2 once for
                  the fused build's degree, #9 per sweep and probe hop;
                  streaming: #7, #8, #11 once, #10 per sweep and hop, #5
                  per probe transpose);
                - the row reorder: E1's live fraction on sorted, shuffled
                  and reordered rows, E1 on shuffled rows with and without
                  row_reorder, and the round trip of a reordered run
                  (shuffled against sorted rows, un-permuted), bit for bit
                  wherever the two canonical arrays are equal, on the dense
                  spec and on knn_k=64;
                - the dense LM serve path (launch/serve.py): stablelm-3b at
                  full width cut to 2 layers, batch 2, a prompt of 100, on
                  the card against the CPU from the same weights (prefill and
                  8 decode steps fed the same tokens: logits within 1e-2 of
                  max|logits|, greedy tokens equal past a near-tie); then
                  the full 32-layer model, 4 requests of 2,048 prompt tokens
                  and 32 generated tokens each: flash attention launched 32
                  times in prefill and 0 in decode, its prefill and 4 decode
                  steps profiled.
  4. profile    one more n = 45,000 run of each engine under torch.profiler:
                the device's busy share of the wall time and device time by
                kernel; and the graph runs E1 (explicit, block_sparse=False)
                and E1 and E2 block-sparse on both engines, each cut into
                its stages (pass 1, build, sweeps, k-means, probe, idle).

The last lines are one JSON object with every kernel's numbers, the card's
name and power limit from nvidia-smi, and the result object
``{"ok": true, "device": {...}}``. The full report also goes to
chiprun_out/chip_smoke_report.json, the traces to chiprun_out/e2e_*.json.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

N_MAIN = 45_000         # the paper's dataset size
N_BIG = 150_000         # past the card: A would need n^2 * 4 B = 90 GB
SIGMA = 0.3             # the paper's bandwidth for gaussians
ORTHO_ARI_FLOOR = 0.90  # the reference's floor for three_circles, orthogonal
MEM_LIMIT = 1e9         # peak device bytes of a streaming run
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores, H100 SXM
H100_TF32_FLOPS = 495e12     # TF32 on the tensor cores, dense, H100 SXM
KNN_K = 10              # the reference's blobs kNN spec (TestKnnSpecQuality)
SCALE_K = 7             # the reference's adaptive scale rank
BLOBS_ARI_FLOOR = 0.95  # the reference's floor for blobs under knn_k=10, at its n = 480
A_ATOL = 1e-6           # affinity entries
SQD_RTOL = 1e-6         # neg_sqdist scores, relative to max |x|^2
D_RTOL = 1e-5           # degrees, relative to the row's absolute mass
U_RTOL, U_ATOL = 1e-5, 1e-7  # power-sweep output; atol scales with max|U_ref|
KM_RTOL = 1e-5          # assignment distances (labels must be exact)
G_RTOL = 1e-5           # Gram entries, relative to max|G_ref|


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls after one
    warm-up call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of ``fn`` over ``reps`` calls after
    one warm-up call: the summed durations of the device events that
    torch.profiler records, so host time between launches is left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == DeviceType.CUDA]
    check(bool(spans), "the profiler recorded no device events")
    return sum(spans) / 1e3 / reps


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """Least time on an H100 SXM for the work: bytes over the memory rate
    or f32 operations over the f32 rate, whichever is larger."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_flops / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def affinity_flops(rows: int, cols: int, m: int, kind: str) -> float:
    """Operations of the masked affinity build: 2m per dot product, then
    the transform (rbf: norms add, 2*dot, subtract, clamp, scale, exp)."""
    per_entry = 2 * m + {"cosine": 0, "cosine_shifted": 2, "rbf": 6}[kind]
    norms = 2 * m * (rows + cols) if kind == "rbf" else 0
    return rows * cols * per_entry + norms


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is false; "
                           "this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi.splitlines()[0]


def phase_build() -> tuple[float, dict[str, str]]:
    """Seconds to build every kernel library, and nvcc's ``-Xptxas -v``
    report of each library built (empty where it was built before)."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build()
    sec = time.perf_counter() - t0
    print(f"[build] {len(logs)} kernel libraries built in {sec:.2f} s "
          f"into {_build.build_dir()}", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                print(f"[build] {name}: {entry.group(1)}")
            elif "registers" in line or "spill" in line:
                print(f"[build] {name}:   {line.strip()}")
    return sec, logs


def _features(n: int, seed: int = 0):
    from repro_torch.core.affinity import row_normalize_features
    from repro_torch.data import dataset_by_name
    x, y, k = dataset_by_name("gaussians", n, seed=seed)
    xr = torch.as_tensor(x, device="cuda")
    return {"rbf": xr, "cosine": row_normalize_features(xr),
            "cosine_shifted": row_normalize_features(xr)}, y, k


def _stripe_errors(a, d, x, kind, sigma, stripe=4096):
    """Max |A - A_ref| and max |D - D_ref| / sum|A_ref row| over row
    stripes of the plain version (peak memory stays a few GB)."""
    from repro_torch.kernels import ref
    err_a = err_d = 0.0
    for r0 in range(0, x.shape[0], stripe):
        r1 = min(r0 + stripe, x.shape[0])
        a_ref, d_ref = ref.affinity_and_degree_ref(x[r0:r1], x, kind=kind, sigma=sigma,
                                                   row_offset=r0)
        err_a = max(err_a, float((a[r0:r1] - a_ref).abs().max()))
        mass = a_ref.abs().sum(dim=1).clamp_min(1e-30)
        err_d = max(err_d, float(((d[r0:r1] - d_ref).abs() / mass).max()))
        del a_ref, d_ref, mass
    return err_a, err_d


def _plain_affinity_stripes(x, kind, sigma, stripe=4096):
    from repro_torch.kernels import ref
    for r0 in range(0, x.shape[0], stripe):
        ref.affinity_and_degree_ref(x[r0:r0 + stripe], x, kind=kind, sigma=sigma,
                                    row_offset=r0)


def phase_affinity(report):
    from repro_torch.kernels import ref
    from repro_torch.kernels.affinity import affinity_and_degree
    feats, _, _ = _features(N_MAIN)
    n, m = feats["rbf"].shape
    worst_a = worst_d = 0.0
    main = None
    for kind in ("cosine", "cosine_shifted", "rbf"):
        x = feats[kind]
        a, d = affinity_and_degree(x, kind=kind, sigma=SIGMA)
        torch.cuda.synchronize()
        err_a, err_d = _stripe_errors(a, d, x, kind, SIGMA)
        print(f"[affinity] n={n} m={m} {kind}: max|A-A_ref|={err_a:.3e} "
              f"max|D-D_ref|/mass={err_d:.3e}", flush=True)
        check(err_a <= A_ATOL and err_d <= D_RTOL, f"affinity {kind} disagrees")
        # the shared tile code (affinity_tile.cuh) rounds as the plain
        # version does, one step at a time: A is its bits exactly
        check(err_a == 0.0, f"affinity {kind}: A is not bitwise the plain version's")
        worst_a, worst_d = max(worst_a, err_a), max(worst_d, err_d)
        if kind == "rbf":
            del a, d
            ms = cuda_ms(lambda: affinity_and_degree(x, kind=kind, sigma=SIGMA), 5)
            plain = cuda_ms(lambda: _plain_affinity_stripes(x, kind, SIGMA), 2)
            b, by = bound_ms(4.0 * (n * m + n * n + n), affinity_flops(n, n, m, kind))
            main = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by)
            print(f"[affinity] n={n} rbf: kernel_ms={ms:.4f} plain_ms={plain:.4f} "
                  f"library_ms=null bound_ms={b:.4f} ({by})", flush=True)
        else:
            del a, d
        torch.cuda.empty_cache()

    # ragged edge, wide features, and an off-diagonal stripe
    g = torch.Generator(device="cuda").manual_seed(1)
    xs = torch.randn((1037, 16), generator=g, device="cuda") * 0.25
    xs_n = xs / xs.norm(dim=1, keepdim=True)
    for kind in ("cosine", "cosine_shifted", "rbf"):
        x = xs if kind == "rbf" else xs_n
        for rows, cols, ro, co in ((slice(None), None, 0, 0),
                                   (slice(100, 400), slice(300, None), 100, 300)):
            xc = None if cols is None else x[cols]
            a, d = affinity_and_degree(x[rows].contiguous(),
                                       None if xc is None else xc.contiguous(),
                                       kind=kind, sigma=1.1, row_offset=ro, col_offset=co)
            a_ref, d_ref = ref.affinity_and_degree_ref(x[rows], xc, kind=kind, sigma=1.1,
                                                       row_offset=ro, col_offset=co)
            err_a = float((a - a_ref).abs().max())
            err_d = float(((d - d_ref).abs() / a_ref.abs().sum(1).clamp_min(1e-30)).max())
            print(f"[affinity] ragged {tuple(a.shape)} m=16 {kind} offsets=({ro},{co}): "
                  f"max|A-A_ref|={err_a:.3e} max|D-D_ref|/mass={err_d:.3e}")
            check(err_a <= A_ATOL and err_d <= D_RTOL, f"ragged affinity {kind} disagrees")
            worst_a, worst_d = max(worst_a, err_a), max(worst_d, err_d)
    report["affinity_and_degree"] = dict(main, max_abs_err=worst_a, max_rel_err_d=worst_d,
                                         library_ms=None)


def _u_errors(u, u_ref, mass=None):
    """Max |U - U_ref|, and the most by which |U - U_ref| exceeds
    rtol mass + atol max|U_ref| (<= 0 where the kernel agrees). ``mass``
    defaults to |U_ref|; where the sums can cancel (raw cosine has
    negative entries) it is the absolute mass (|A| |V|) / max(d, 1e-30)
    that the rounding error scales with."""
    diff = (u - u_ref).abs()
    atol = U_ATOL * float(u_ref.abs().max())
    mass = u_ref.abs() if mass is None else mass
    return float(diff.max()), float((diff - U_RTOL * mass).max() - atol)


def phase_power_step(report):
    from repro_torch.kernels import ref
    from repro_torch.kernels.affinity import affinity_and_degree
    from repro_torch.kernels.power_step import degree_normalized_matmat
    feats, _, _ = _features(N_MAIN)
    x = feats["rbf"]
    n = x.shape[0]
    a, d = affinity_and_degree(x, kind="rbf", sigma=SIGMA)
    v = (d / d.sum())[:, None].contiguous()              # the main path's v0
    u = degree_normalized_matmat(a, v, d)
    u_ref = ref.degree_normalized_matmat_ref(a, v, d)
    abs_err, excess = _u_errors(u, u_ref)
    print(f"[power_step] n={n} r=1: max|U-U_ref|={abs_err:.3e} max|U_ref|="
          f"{float(u_ref.abs().max()):.3e} excess over tolerance={excess:.3e}", flush=True)
    check(excess <= 0.0, "power step disagrees at the main shape")
    worst, main_err = abs_err, dict(max_abs_err=abs_err, excess=excess)
    ms = cuda_ms(lambda: degree_normalized_matmat(a, v, d), 10)
    plain = cuda_ms(lambda: ref.degree_normalized_matmat_ref(a, v, d), 10)
    lib = cuda_ms(lambda: torch.matmul(a, v) / d.clamp_min(1e-30)[:, None], 10)
    b, by = bound_ms(4.0 * (n * n + 2 * n + n), 2.0 * n * n)
    print(f"[power_step] n={n} r=1: kernel_ms={ms:.4f} plain_ms={plain:.4f} "
          f"library_ms={lib:.4f} bound_ms={b:.4f} ({by})", flush=True)
    # the same A 4 bytes off 16-byte alignment takes the plain-load template:
    # the same bits as the cp.async ring's, at r = 1 and 2
    shifted = torch.empty(n * n + 1, device="cuda")[1:].view(n, n)
    shifted.copy_(a)
    for r in (1, 2):
        vr = torch.rand((n, r), device="cuda") if r > 1 else v
        ring_u = degree_normalized_matmat(a, vr, d)
        check(bool(torch.equal(degree_normalized_matmat(shifted, vr, d), ring_u)),
              f"the power step's ring and plain-load templates differ at r={r}")
    plain_load = cuda_ms(lambda: degree_normalized_matmat(shifted, v, d), 10)
    print(f"[power_step] n={n}: ring and plain-load templates bitwise equal at r=1, 2; "
          f"plain-load template (unaligned A) {plain_load:.4f} ms at r=1", flush=True)
    del a, d, u, u_ref, shifted
    torch.cuda.empty_cache()

    # ragged rows, r up to the kernel's limit, a stripe, a zero-degree row
    g = torch.Generator(device="cuda").manual_seed(2)
    xs = torch.randn((1037, 16), generator=g, device="cuda") * 0.25
    a, d = affinity_and_degree(xs, kind="rbf", sigma=1.1)
    a[5] = 0.0
    d[5] = 0.0
    for r in (4, 32):
        vs = torch.rand((1037, r), generator=g, device="cuda")
        for rows, cols in ((slice(None), 1037), (slice(100, 400), 1037), (slice(None), 1036)):
            # 1,036 columns start every row on 16 bytes: the ring, ending mid-stage
            ar, dr, vr = a[rows, :cols].contiguous(), d[rows].contiguous(), vs[:cols]
            u = degree_normalized_matmat(ar, vr, dr)
            u_ref = ref.degree_normalized_matmat_ref(ar, vr, dr)
            abs_err, excess = _u_errors(u, u_ref)
            print(f"[power_step] ragged a{tuple(ar.shape)} r={r}: max|U-U_ref|={abs_err:.3e} "
                  f"excess over tolerance={excess:.3e}")
            check(excess <= 0.0, f"power step disagrees at r={r}")
            worst = max(worst, abs_err)
        check(bool((degree_normalized_matmat(a, vs, d)[5] == 0).all()),
              "a zero-degree row must give an exact zero")
    report["degree_normalized_matmat"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                              bound_ms=b, bound_by=by, max_abs_err=worst,
                                              main_shape=main_err, plain_load_ms=plain_load)


def phase_kmeans_assign(report):
    from repro_torch.kernels import ref
    from repro_torch.kernels.kmeans_assign import kmeans_assign
    g = torch.Generator(device="cuda").manual_seed(3)
    n, dim, k = N_MAIN, 1, 4
    x = torch.randn((n, dim), generator=g, device="cuda")
    cents = x[torch.randperm(n, generator=g, device="cuda")[:k]].contiguous()
    worst = 0.0
    cases = [("main", x, cents)]
    xs = torch.randn((1037, 4), generator=g, device="cuda")
    cases.append(("ragged d=4 k=5", xs, torch.randn((5, 4), generator=g, device="cuda")))
    zeros = torch.zeros((1037, 2), device="cuda")
    tie_c = torch.tensor([[3.0, 0.0], [1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]],
                         device="cuda")
    cases.append(("planted ties", zeros, tie_c))
    for tag, xx, cc in cases:
        lab, dist = kmeans_assign(xx, cc)
        lab_ref, dist_ref = ref.kmeans_assign_ref(xx, cc)
        same = bool((lab == lab_ref).all())
        err = float((dist - dist_ref).abs().max())
        rel = float(((dist - dist_ref).abs() - KM_RTOL * dist_ref.abs()).max())
        print(f"[kmeans_assign] {tag} n={xx.shape[0]} d={xx.shape[1]} k={cc.shape[0]}: "
              f"labels equal={same} max|dist-dist_ref|={err:.3e}", flush=True)
        check(same and rel <= 0.0, f"kmeans_assign disagrees ({tag})")
        worst = max(worst, err)
        if tag == "planted ties":
            check(bool((lab == 1).all()), "ties must resolve to the first index")
    # a launch is a few microseconds on the device, far under the host's
    # cost of one wrapper call, so the times are device times per call;
    # the host-paced rate of back-to-back calls is kept beside them
    fns = {"ms": lambda: kmeans_assign(x, cents),
           "plain_ms": lambda: ref.kmeans_assign_ref(x, cents),
           "library_ms": lambda: torch.cdist(x, cents).argmin(1)}
    times = {key: device_ms(fn, 50) for key, fn in fns.items()}
    host = {key: cuda_ms(fn, 50) for key, fn in fns.items()}
    b, by = bound_ms(4.0 * (n * dim + k * dim + 2 * n), n * k * (2.0 * dim + 3) + 2.0 * n * dim)
    print(f"[kmeans_assign] n={n} d={dim} k={k}: device kernel_ms={times['ms']:.6f} "
          f"plain_ms={times['plain_ms']:.6f} library_ms={times['library_ms']:.6f} "
          f"bound_ms={b:.6f} ({by}); host-paced per call: kernel {host['ms']:.4f} "
          f"plain {host['plain_ms']:.4f} library {host['library_ms']:.4f}", flush=True)
    report["kmeans_assign"] = dict(times, bound_ms=b, bound_by=by, max_abs_err=worst,
                                   host_paced_ms=host)


def _plain_streaming_stripes(x, v, d, kind, sigma, stripe=4096, rows=None):
    """The plain streamed U and D, and the rows' absolute mass, over row
    stripes (the whole (n, n) A at once would double peak memory).
    ``rows`` selects the stripes' first rows (default: all of them)."""
    from repro_torch.kernels import ref
    n = x.shape[0]
    out = []
    for r0 in (range(0, n, stripe) if rows is None else rows):
        r1 = min(r0 + stripe, n)
        a_ref, d_ref = ref.affinity_and_degree_ref(x[r0:r1], x, kind=kind, sigma=sigma,
                                                   row_offset=r0)
        u_ref = None if v is None else ref.affinity_matmat_ref(
            x[r0:r1], v, d[r0:r1], x, kind=kind, sigma=sigma, row_offset=r0)
        out.append((r0, r1, u_ref, d_ref, a_ref.abs().sum(dim=1)))
        del a_ref
    return out


def _plain_matmat_stripes(x, v, d, kind, sigma, stripe=4096):
    from repro_torch.kernels import ref
    for r0 in range(0, x.shape[0], stripe):
        ref.affinity_matmat_ref(x[r0:r0 + stripe], v, d[r0:r0 + stripe], x, kind=kind,
                                sigma=sigma, row_offset=r0)


def _plain_degree_stripes(x, kind, sigma, stripe=4096):
    from repro_torch.kernels import ref
    for r0 in range(0, x.shape[0], stripe):
        ref.affinity_degree_streaming_ref(x[r0:r0 + stripe], x, kind=kind, sigma=sigma,
                                          row_offset=r0)


def _stripe_u_d_errors(u, d_s, stripes):
    """(max|U-U_ref|, excess over the U rule, max|D-D_ref|/mass,
    max|D-D_ref|) over the stripes of :func:`_plain_streaming_stripes`."""
    u_part = torch.cat([u[r0:r1] for r0, r1, *_ in stripes])
    u_ref = torch.cat([s[2] for s in stripes])
    abs_err, excess = _u_errors(u_part, u_ref)
    d_diff = [((d_s[r0:r1] - d_ref).abs(), mass) for r0, r1, _, d_ref, mass in stripes]
    err_d = max(float((diff / mass.clamp_min(1e-30)).max()) for diff, mass in d_diff)
    return abs_err, excess, err_d, max(float(diff.max()) for diff, _ in d_diff)


def streaming_flops(rows: int, cols: int, m: int, r: int | None) -> float:
    """Operations of one streamed sweep, n^2 (2m + 6 + 2r), or of the
    streamed degree, n^2 (2m + 7): the dot product, the rbf transform with
    its expf, then 2r for the product with V or 1 for the row sum."""
    return rows * cols * (2 * m + 6 + (1 if r is None else 2 * r))


def phase_streaming(report):
    from repro_torch.kernels import ref
    from repro_torch.kernels.affinity import affinity_and_degree
    from repro_torch.kernels.power_step import degree_normalized_matmat
    from repro_torch.kernels.streaming import affinity_degree_streaming, affinity_matmat
    feats, _, _ = _features(N_MAIN)
    x = feats["rbf"]
    n, m = x.shape
    a, d = affinity_and_degree(x, kind="rbf", sigma=SIGMA)
    d_s = affinity_degree_streaming(x, kind="rbf", sigma=SIGMA)
    torch.cuda.synchronize()
    check(torch.equal(d_s, d), "the streamed D is not bitwise the stored D")
    g = torch.Generator(device="cuda").manual_seed(4)
    v1 = (d / d.sum())[:, None].contiguous()             # the main path's v0
    v2 = torch.cat([v1, torch.rand((n, 1), generator=g, device="cuda") / n], dim=1)
    worst_u = worst_d = worst_d_abs = 0.0
    main = {}
    for v in (v1, v2):
        r = v.shape[1]
        u_s = affinity_matmat(x, v, d, kind="rbf", sigma=SIGMA)
        u_e = degree_normalized_matmat(a, v, d)
        torch.cuda.synchronize()
        check(torch.equal(u_s, u_e), f"r={r}: the streamed U is not bitwise the explicit U")
        abs_err, excess, err_d, abs_d = _stripe_u_d_errors(
            u_s, d_s, _plain_streaming_stripes(x, v, d, "rbf", SIGMA))
        print(f"[streaming] n={n} m={m} rbf r={r}: D and U bitwise the explicit kernels'; "
              f"vs plain: max|U-U_ref|={abs_err:.3e} excess over tolerance={excess:.3e} "
              f"max|D-D_ref|/mass={err_d:.3e}", flush=True)
        check(excess <= 0.0 and err_d <= D_RTOL, f"streaming r={r} disagrees with plain")
        worst_u, worst_d = max(worst_u, abs_err), max(worst_d, err_d)
        worst_d_abs = max(worst_d_abs, abs_d)
        ms = cuda_ms(lambda: affinity_matmat(x, v, d, kind="rbf", sigma=SIGMA), 10)
        plain = cuda_ms(lambda: _plain_matmat_stripes(x, v, d, "rbf", SIGMA), 2)
        b, by = bound_ms(4.0 * (n * m + 2 * n * r + n), streaming_flops(n, n, m, r))
        print(f"[streaming] matmat n={n} r={r}: kernel_ms={ms:.4f} plain_ms={plain:.4f} "
              f"library_ms=null bound_ms={b:.4f} ({by}); explicit sweep on stored A: "
              f"{cuda_ms(lambda: degree_normalized_matmat(a, v, d), 10):.4f} ms", flush=True)
        main[r] = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by)
    ms_d = cuda_ms(lambda: affinity_degree_streaming(x, kind="rbf", sigma=SIGMA), 10)
    plain_d = cuda_ms(lambda: _plain_degree_stripes(x, "rbf", SIGMA), 2)
    b_d, by_d = bound_ms(4.0 * (n * m + n), streaming_flops(n, n, m, None))
    print(f"[streaming] degree n={n}: kernel_ms={ms_d:.4f} plain_ms={plain_d:.4f} "
          f"library_ms=null bound_ms={b_d:.4f} ({by_d})", flush=True)
    del a, d, d_s
    torch.cuda.empty_cache()

    # ragged rows, wide features, all kinds, off-diagonal stripes, d=None
    xs = torch.randn((1037, 16), generator=g, device="cuda") * 0.25
    xs_n = xs / xs.norm(dim=1, keepdim=True)
    for kind in ("cosine", "cosine_shifted", "rbf"):
        x = xs if kind == "rbf" else xs_n
        for rows, cols, ro, co in ((slice(None), None, 0, 0),
                                   (slice(100, 400), slice(300, None), 100, 300)):
            xr = x[rows].contiguous()
            xc = None if cols is None else x[cols].contiguous()
            n_cols = x.shape[0] if xc is None else xc.shape[0]
            dd = affinity_degree_streaming(xr, xc, kind=kind, sigma=1.1, row_offset=ro,
                                           col_offset=co)
            a_ref, d_ref = ref.affinity_and_degree_ref(xr, xc, kind=kind, sigma=1.1,
                                                       row_offset=ro, col_offset=co)
            err_d = float(((dd - d_ref).abs() / a_ref.abs().sum(1).clamp_min(1e-30)).max())
            check(err_d <= D_RTOL, f"ragged streamed degree {kind} disagrees")
            worst_d = max(worst_d, err_d)
            worst_d_abs = max(worst_d_abs, float((dd - d_ref).abs().max()))
            for r in (4, 32):
                vs = torch.rand((n_cols, r), generator=g, device="cuda")
                for dn in (dd, None):
                    u = affinity_matmat(xr, vs, dn, xc, kind=kind, sigma=1.1,
                                        row_offset=ro, col_offset=co)
                    u_ref = ref.affinity_matmat_ref(xr, vs, dn, xc, kind=kind, sigma=1.1,
                                                    row_offset=ro, col_offset=co)
                    mass = a_ref.abs() @ vs
                    if dn is not None:      # the kernel's floored divide
                        mass = mass / dn.clamp_min(1e-30)[:, None]
                    abs_err, excess = _u_errors(u, u_ref, mass)
                    check(excess <= 0.0, f"ragged streaming {kind} r={r} "
                          f"d={'given' if dn is not None else 'None'} disagrees")
                    # raw cosine degrees can be negative, where the floored
                    # divide scales U by 1e30: its absolute error says nothing
                    if dn is None or kind != "cosine":
                        worst_u = max(worst_u, abs_err)
            print(f"[streaming] ragged {tuple(xr.shape)}x{n_cols} m=16 {kind} "
                  f"offsets=({ro},{co}) r=4,32 d=given,None: agree; "
                  f"max|D-D_ref|/mass={err_d:.3e}")
    report["streaming_matmat"] = dict(main[1], max_abs_err=worst_u, library_ms=None,
                                      r2=main[2])
    report["streaming_degree"] = dict(ms=ms_d, plain_ms=plain_d, bound_ms=b_d, bound_by=by_d,
                                      max_abs_err=worst_d_abs, max_rel_err_d=worst_d,
                                      library_ms=None)


def _stripe_scores(x, k, stat, scale, stripe=4096):
    """The plain row top-k over row stripes: yields (r0, r1, values)."""
    from repro_torch.kernels import ref
    n = x.shape[0]
    for r0 in range(0, n, stripe):
        r1 = min(r0 + stripe, n)
        yield r0, r1, ref.row_topk_ref(
            x[r0:r1], x, k=k, stat=stat, kind="rbf", sigma=SIGMA, row_offset=r0,
            scale_r=None if scale is None else scale[r0:r1], scale_c=scale)


def _topk_error(got, want):
    """Max |got - want| over the finite entries; inf if the -inf padding
    differs."""
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
        return float("inf")
    fin = torch.isfinite(want)
    return float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0


def topk_flops(rows: int, cols: int, m: int, stat: str, adaptive: bool) -> float:
    """Operations of one row top-k call: per entry 2m for the dot product,
    then neg_sqdist's d2 (add, 2*dot, subtract) and clamp, or the rbf
    transform (6, one more for the adaptive product of the scales), and
    one compare with the row's running K-th score. The selection's
    insertions are not counted (a few hundred per row, data-dependent)."""
    per_entry = 2 * m + (4 if stat == "neg_sqdist" else 6 + (1 if adaptive else 0)) + 1
    return rows * cols * per_entry + 2 * m * (rows + cols)


def phase_row_topk(report):
    """Kernel #7 against its plain version: at the main shape bit for bit
    (the scores are the build's entries, the plain version's arithmetic);
    at ragged shapes with m = 16 within the stated tolerances."""
    from repro_torch.core.graph import scales_from_topk
    from repro_torch.kernels import ref
    from repro_torch.kernels.row_topk import row_topk
    feats, _, _ = _features(N_MAIN)
    x = feats["rbf"]
    n, m = x.shape
    scale = scales_from_topk(row_topk(x, k=SCALE_K, stat="neg_sqdist", kind="rbf",
                                      sigma=SIGMA)).contiguous()
    worst = 0.0
    cases = [("neg_sqdist", k, None) for k in (1, 7, 64)]
    cases += [("similarity", k, sc) for k in (10, 30, 64) for sc in (None, scale)]
    times = {}
    for stat, k, sc in cases:
        tag = f"{stat} K={k}{' adaptive' if sc is not None else ''}"
        out = row_topk(x, k=k, stat=stat, kind="rbf", sigma=SIGMA, scale_r=sc, scale_c=sc)
        torch.cuda.synchronize()
        same, err = True, 0.0
        for r0, r1, want in _stripe_scores(x, k, stat, sc):
            same = same and torch.equal(out[r0:r1], want)
            err = max(err, _topk_error(out[r0:r1], want))
        print(f"[row_topk] n={n} m={m} {tag}: equal to the plain version={same} "
              f"max|err|={err:.3e}", flush=True)
        check(same, f"row_topk {tag} is not the plain version's top-k")
        worst = max(worst, err)
        ms = cuda_ms(lambda: row_topk(x, k=k, stat=stat, kind="rbf", sigma=SIGMA,
                                      scale_r=sc, scale_c=sc), 5)
        b, by = bound_ms(4.0 * (n * m + n * k + (2 * n if sc is not None else 0)),
                         topk_flops(n, n, m, stat, sc is not None))
        times[tag] = dict(ms=ms, bound_ms=b, bound_by=by)
        print(f"[row_topk] {tag}: kernel_ms={ms:.4f} bound_ms={b:.4f} ({by})", flush=True)
    del out

    # the plain version on the main path's call (similarity, K = knn_k), and
    # the torch.topk share of it on the stored (n, n) scores
    main = times[f"similarity K={KNN_K}"]
    main["plain_ms"] = cuda_ms(lambda: list(_stripe_scores(x, KNN_K, "similarity", None)), 2)
    scores = torch.empty((n, n), device="cuda")
    for r0 in range(0, n, 4096):
        r1 = min(r0 + 4096, n)
        scores[r0:r1] = ref._affinity_scores_ref(x[r0:r1], x, kind="rbf", sigma=SIGMA)
        scores[torch.arange(r0, r1), torch.arange(r0, r1)] = -torch.inf
    main["plain_topk_only_ms"] = cuda_ms(lambda: torch.topk(scores, KNN_K, dim=1), 3)
    del scores
    torch.cuda.empty_cache()
    print(f"[row_topk] similarity K={KNN_K}: plain_ms={main['plain_ms']:.4f} (4,096-row "
          f"stripes: scores, mask, torch.topk); torch.topk alone on the stored (n, n) "
          f"scores: {main['plain_topk_only_ms']:.4f} ms", flush=True)

    # ragged rows, wide features, a stripe off the diagonal with offsets
    g = torch.Generator(device="cuda").manual_seed(6)
    xs = torch.randn((1037, 16), generator=g, device="cuda") * 0.25
    sq_max = float((xs * xs).sum(dim=1).max())
    for rows, cols, ro, co in ((slice(None), None, 0, 0),
                               (slice(100, 400), slice(300, None), 100, 300)):
        xr = xs[rows].contiguous()
        xc = None if cols is None else xs[cols].contiguous()
        for stat in ("neg_sqdist", "similarity"):
            for k in (7, 64):
                out = row_topk(xr, xc, k=k, stat=stat, kind="rbf", sigma=1.1,
                               row_offset=ro, col_offset=co)
                want = ref.row_topk_ref(xr, xc, k=k, stat=stat, kind="rbf", sigma=1.1,
                                        row_offset=ro, col_offset=co)
                err = _topk_error(out, want)
                tol = SQD_RTOL * sq_max if stat == "neg_sqdist" else A_ATOL
                check(err <= tol, f"ragged row_topk {stat} K={k} {tuple(xr.shape)} disagrees")
                worst = max(worst, err)
        print(f"[row_topk] ragged {tuple(xr.shape)} m=16 offsets=({ro},{co}) both stats "
              f"K=7,64: agree", flush=True)
    report["row_topk"] = dict(main, max_abs_err=worst, library_ms=None, cases=times)


def phase_policy(report):
    """Kernels #1, #5 and #6 with the policy operands of E1 (kNN) and E2
    (adaptive + kNN): A bitwise its plain version's, the streamed D and U
    bitwise the explicit kernels', the column-thresholded product the
    transpose of the stored truncated A, and every row keeping knn_k
    entries (more only on a tie at its threshold)."""
    from repro_torch.core.affinity import AffinitySpec
    from repro_torch.core.graph import affinity_stats
    from repro_torch.kernels import ref
    from repro_torch.kernels.affinity import affinity_and_degree
    from repro_torch.kernels.power_step import degree_normalized_matmat
    from repro_torch.kernels.streaming import affinity_degree_streaming, affinity_matmat
    feats, _, _ = _features(N_MAIN)
    x = feats["rbf"]
    n, m = x.shape
    g = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for tag, spec in (("knn", AffinitySpec(kind="rbf", sigma=SIGMA, knn_k=KNN_K)),
                      ("adaptive_knn", AffinitySpec(kind="rbf", bandwidth="adaptive",
                                                    scale_k=SCALE_K, knn_k=KNN_K))):
        sc, thr = affinity_stats(x, spec)
        pol = dict(kind="rbf", sigma=SIGMA, scale_r=sc, scale_c=sc)
        a, d = affinity_and_degree(x, thr=thr, **pol)
        torch.cuda.synchronize()
        err_a = 0.0
        for r0 in range(0, n, 4096):
            a_ref, _ = ref.affinity_and_degree_ref(
                x[r0:r0 + 4096], x, row_offset=r0, thr=thr[r0:r0 + 4096],
                **dict(pol, scale_r=None if sc is None else sc[r0:r0 + 4096]))
            err_a = max(err_a, float((a[r0:r0 + 4096] - a_ref).abs().max()))
            del a_ref
        check(err_a == 0.0, f"{tag}: A is not bitwise the plain version's ({err_a:.3e})")
        kept = (a != 0).sum(dim=1)
        at_thr = (a == thr[:, None]).sum(dim=1)
        over = kept > KNN_K
        ties = int(over.sum())
        check(bool((kept >= KNN_K).all()), f"{tag}: a row keeps fewer than {KNN_K} entries")
        check(bool((at_thr[over] > 1).all()),
              f"{tag}: a row keeps more than {KNN_K} entries without a tie at its threshold")
        d_s = affinity_degree_streaming(x, thr=thr, **pol)
        torch.cuda.synchronize()
        check(torch.equal(d_s, d), f"{tag}: the streamed D is not bitwise the stored D")
        v1 = (d / d.sum())[:, None].contiguous()
        v2 = torch.cat([v1, torch.rand((n, 1), generator=g, device="cuda") / n], dim=1)
        for v in (v1, v2):
            u_s = affinity_matmat(x, v, d, thr=thr, **pol)
            u_e = degree_normalized_matmat(a, v, d)
            torch.cuda.synchronize()
            check(torch.equal(u_s, u_e),
                  f"{tag} r={v.shape[1]}: the streamed U is not bitwise the explicit U")
        # the probe's transpose product, on an indicator and on V
        ind = torch.zeros((n, 1), device="cuda")
        ind[::997] = 1.0
        worst_t = 0.0
        for w in (ind, v2):
            u_t = affinity_matmat(x, w, None, thr_c=thr, **pol)
            want = a.T @ w
            torch.cuda.synchronize()
            check(torch.equal(u_t > 0, want > 0),
                  f"{tag}: the thr_c product's positivity is not that of A^T V")
            abs_err, excess = _u_errors(u_t, want)
            check(excess <= 0.0, f"{tag}: the thr_c product disagrees with A^T V")
            worst_t = max(worst_t, abs_err)
        times = dict(
            affinity_ms=cuda_ms(lambda: affinity_and_degree(x, thr=thr, **pol), 5),
            degree_ms=cuda_ms(lambda: affinity_degree_streaming(x, thr=thr, **pol), 10),
            matmat_r2_ms=cuda_ms(lambda: affinity_matmat(x, v2, d, thr=thr, **pol), 10),
            matmat_thr_c_ms=cuda_ms(lambda: affinity_matmat(x, ind, None, thr_c=thr, **pol), 10),
            sweep_stored_r2_ms=cuda_ms(lambda: degree_normalized_matmat(a, v2, d), 10))
        # the dense work plus, per entry, the threshold compare and, with
        # adaptive scales, the product of the scales (the divide replaces
        # the multiply); the operands add 4 bytes a row or column each
        extra = n * n * (1 + (1 if sc is not None else 0))
        op_bytes = 4.0 * n * (1 + (2 if sc is not None else 0))
        bounds = dict(
            affinity=bound_ms(4.0 * (n * m + n * n + n) + op_bytes,
                              affinity_flops(n, n, m, "rbf") + extra),
            degree=bound_ms(4.0 * (n * m + n) + op_bytes, streaming_flops(n, n, m, None) + extra),
            matmat_r2=bound_ms(4.0 * (n * m + 2 * n * 2 + n) + op_bytes,
                               streaming_flops(n, n, m, 2) + extra),
            matmat_thr_c=bound_ms(4.0 * (n * m + 2 * n) + op_bytes,
                                  streaming_flops(n, n, m, 1) + extra))
        times.update({f"{key}_bound_ms": b for key, (b, _) in bounds.items()})
        print(f"[policy] {tag} n={n}: A bitwise the plain version's; streamed D and U "
              f"(r=1,2) bitwise the explicit kernels'; thr_c product = A^T V in positivity, "
              f"max|err|={worst_t:.3e}; kept per row min={int(kept.min())} "
              f"max={int(kept.max())}, rows over {KNN_K} (ties at the threshold)={ties}; "
              + " ".join(f"{key}={val:.4f}" for key, val in times.items()), flush=True)
        out[tag] = dict(times, tie_rows=ties, max_abs_err_thr_c=worst_t)
        del a, d, d_s
        torch.cuda.empty_cache()

    # ragged rows, wide features, off-diagonal stripes, every operand
    xs = torch.randn((1037, 16), generator=g, device="cuda") * 0.25
    scs = torch.rand((1037,), generator=g, device="cuda") * 0.7 + 0.3
    thr_all = torch.rand((1037,), generator=g, device="cuda") * 0.5 + 0.3
    for rows, cols, ro, co in ((slice(None), slice(None), 0, 0),
                               (slice(100, 400), slice(300, None), 100, 300)):
        xr, xc = xs[rows].contiguous(), xs[cols].contiguous()
        kw = dict(kind="rbf", sigma=1.1, row_offset=ro, col_offset=co,
                  scale_r=scs[rows].contiguous(), scale_c=scs[cols].contiguous())
        thr_r, thr_c = thr_all[rows].contiguous(), thr_all[cols].contiguous()
        a, d = affinity_and_degree(xr, xc, thr=thr_r, **kw)
        a_ref, d_ref = ref.affinity_and_degree_ref(xr, xc, thr=thr_r, **kw)
        # the scales are given alike, so d2's error carries through 1/(s_i s_j)
        atol = A_ATOL + SQD_RTOL * float((xs * xs).sum(1).max()) / float(scs.min()) ** 2
        check(float((a - a_ref).abs().max()) <= atol, f"ragged policy A ({ro},{co}) disagrees")
        v = torch.rand((xc.shape[0], 4), generator=g, device="cuda")
        for kw_t in (dict(thr=thr_r), dict(thr_c=thr_c)):
            u = affinity_matmat(xr, v, None, xc, **kw_t, **kw)
            u_ref = ref.affinity_matmat_ref(xr, v, None, xc, **kw_t, **kw)
            check(float((u - u_ref).abs().max()) <= U_RTOL * float(u_ref.abs().max())
                  + xc.shape[0] * atol, f"ragged policy U {list(kw_t)} ({ro},{co}) disagrees")
        dd = affinity_degree_streaming(xr, xc, thr=thr_r, **kw)
        check(torch.equal(dd, d), f"ragged policy D ({ro},{co}) is not the build's D")
    print("[policy] ragged (1037, 16) square and (300, 737) off-diagonal stripes, "
          "scales + thr / thr_c: agree", flush=True)
    report["policy"] = out


def phase_gram(report):
    from repro_torch.kernels import ref
    from repro_torch.kernels.gram import gram
    g = torch.Generator(device="cuda").manual_seed(5)
    n = N_MAIN
    v = torch.rand((n, 2), generator=g, device="cuda")
    v = v / v.sum(dim=0, keepdim=True)                   # the loop's L1 scale
    vu = torch.cat([v, v * (1.0 + 0.01 * torch.rand((n, 2), generator=g, device="cuda"))],
                   dim=1)
    cases = [("V", v), ("[V|U]", vu)]
    cases += [(f"ragged c={c}", torch.randn((1037, c), generator=g, device="cuda"))
              for c in (1, 3, 64)]
    worst = 0.0
    for tag, vv in cases:
        gk = gram(vv)
        g_ref = ref.gram_ref(vv)
        again = gram(vv)
        torch.cuda.synchronize()
        err = float((gk - g_ref).abs().max())
        scale = float(g_ref.abs().max())
        print(f"[gram] {tag} {tuple(vv.shape)}: max|G-G_ref|={err:.3e} max|G_ref|={scale:.3e} "
              f"same bits on a second call={torch.equal(gk, again)}", flush=True)
        check(err <= G_RTOL * scale, f"gram disagrees ({tag})")
        check(torch.equal(gk, again), f"gram gives other bits on a second call ({tag})")
        worst = max(worst, err)
    fns = {"ms": lambda: gram(v), "plain_ms": lambda: ref.gram_ref(v),
           "library_ms": lambda: v.T @ v}
    times = {key: device_ms(fn, 50) for key, fn in fns.items()}
    host = {key: cuda_ms(fn, 50) for key, fn in fns.items()}
    c = v.shape[1]
    b, by = bound_ms(4.0 * (n * c + c * c), 2.0 * n * c * c)
    print(f"[gram] n={n} c={c}: device kernel_ms={times['ms']:.6f} "
          f"plain_ms={times['plain_ms']:.6f} library_ms={times['library_ms']:.6f} "
          f"bound_ms={b:.6f} ({by}); host-paced per call: kernel {host['ms']:.4f} "
          f"plain {host['plain_ms']:.4f} library {host['library_ms']:.4f}", flush=True)
    report["gram"] = dict(times, bound_ms=b, bound_by=by, max_abs_err=worst,
                          host_paced_ms=host)


def _plan_entries(live, n_rows: int, n_cols: int) -> float:
    """Entries of the stripe inside the plan's live tiles (ragged edge
    tiles counted at their real size): the work of a block-sparse call."""
    n_i, n_j = live.shape
    rows = (n_rows - 16 * torch.arange(n_i, device=live.device)).clamp(max=16).double()
    cols = (n_cols - 256 * torch.arange(n_j, device=live.device)).clamp(max=256).double()
    return float(rows @ live.double() @ cols)


def _bs_plain_stripes(x, v, d, counts, col_idx, pol, stripe=4096):
    """The plain block-sparse streamed U (``v`` given) or D over row
    stripes (a multiple of the plan's 16 rows), against the whole x."""
    from repro_torch.kernels import ref
    out = []
    for r0 in range(0, x.shape[0], stripe):
        r1 = min(r0 + stripe, x.shape[0])
        plan = dict(counts=counts[r0 // 16:-(-r1 // 16)], col_idx=col_idx[r0 // 16:-(-r1 // 16)],
                    tm=16, tn=256)
        kw = dict(pol, row_offset=r0, thr=pol["thr"][r0:r1],
                  scale_r=None if pol["scale_r"] is None else pol["scale_r"][r0:r1])
        if v is None:
            out.append((r0, r1, ref.block_sparse_streaming_degree_ref(x[r0:r1], x, **plan, **kw)))
        else:
            out.append((r0, r1, ref.block_sparse_streaming_matmat_ref(
                x[r0:r1], v, None if d is None else d[r0:r1], x, **plan, **kw)))
    return out


def phase_block_sparse(report):
    """Kernels #8-#11 at the main path's shape with E1's and E2's operands:
    the liveness map equal to dense_block_live of kernel #1's thresholded A;
    #9 bitwise #2 (r = 1, 2), #10 bitwise #5 (d given and None), #11
    bitwise #6 and #1's D; the fused build's A, D and thresholds bitwise
    the two-pass build's; each against its plain version. Then ragged and
    off-diagonal stripes at m = 16, and a NaN in V."""
    from repro_torch.core.affinity import AffinitySpec, block_plan, dense_block_live
    from repro_torch.core.graph import affinity_stats, fused_affinity_build
    from repro_torch.core.power import batched_power_iteration
    from repro_torch.kernels import ref
    from repro_torch.kernels.affinity import affinity_and_degree
    from repro_torch.kernels.block_sparse import (block_liveness, block_sparse_matmat,
                                                  block_sparse_streaming_degree,
                                                  block_sparse_streaming_matmat)
    from repro_torch.kernels.power_step import degree_normalized_matmat
    from repro_torch.kernels.row_topk import row_topk, topk_thresholds_from_scores
    from repro_torch.kernels.streaming import affinity_degree_streaming, affinity_matmat
    feats, _, _ = _features(N_MAIN)
    x = feats["rbf"]
    n, m = x.shape
    g = torch.Generator(device="cuda").manual_seed(8)
    worst = dict.fromkeys(("block_liveness", "block_sparse_matmat",
                           "block_sparse_streaming_matmat", "block_sparse_streaming_degree"), 0.0)
    out = {}
    for tag, spec_kw in (("knn", E1_SPEC), ("adaptive_knn", E2_SPEC)):
        spec = AffinitySpec(**spec_kw)
        sc, thr = affinity_stats(x, spec)
        pol = dict(kind="rbf", sigma=SIGMA, scale_r=sc, scale_c=sc, thr=thr)
        a, d = affinity_and_degree(x, **pol)
        live = block_liveness(x, **pol)
        torch.cuda.synchronize()
        check(torch.equal(live.bool(), dense_block_live(a, 16, 256)),
              f"{tag}: #8's live map is not dense_block_live of #1's A")
        counts, col_idx, _ = block_plan(live)
        frac = float(live.float().mean())
        entries = _plan_entries(live, n, n)
        v1 = (d / d.sum())[:, None].contiguous()
        v2 = torch.cat([v1, torch.rand((n, 1), generator=g, device="cuda") / n], dim=1)
        plan = dict(counts=counts, col_idx=col_idx)
        for v in (v1, v2):
            r = v.shape[1]
            u_d = degree_normalized_matmat(a, v, d)
            u_b = block_sparse_matmat(a, v, d, counts, col_idx)
            u_s = block_sparse_streaming_matmat(x, v, d, **plan, **pol)
            u_n = block_sparse_streaming_matmat(x, v, None, **plan, **pol)
            u_n5 = affinity_matmat(x, v, None, **pol)
            torch.cuda.synchronize()
            check(torch.equal(u_b, u_d), f"{tag} r={r}: #9 is not bitwise #2")
            check(torch.equal(u_s, u_d), f"{tag} r={r}: #10 is not bitwise #2 (and #5)")
            check(torch.equal(u_n, u_n5), f"{tag} r={r}: #10 with d=None is not bitwise #5")
        d_b = block_sparse_streaming_degree(x, **plan, **pol)
        d_6 = affinity_degree_streaming(x, **pol)
        torch.cuda.synchronize()
        check(torch.equal(d_b, d) and torch.equal(d_b, d_6),
              f"{tag}: #11 is not bitwise #1's D and #6")
        # against the plain versions: #9 on the whole A, #10 and #11 on stripes
        u_ref = ref.block_sparse_matmat_ref(a, v2, d, counts, col_idx, tm=16, tn=256)
        err9, exc9 = _u_errors(block_sparse_matmat(a, v2, d, counts, col_idx), u_ref)
        del u_ref
        stripes_u = _bs_plain_stripes(x, v2, d, counts, col_idx, pol)
        u_s = block_sparse_streaming_matmat(x, v2, d, **plan, **pol)
        err10, exc10 = _u_errors(torch.cat([u_s[r0:r1] for r0, r1, _ in stripes_u]),
                                 torch.cat([u for *_, u in stripes_u]))
        del stripes_u
        stripes_d = _bs_plain_stripes(x, None, None, counts, col_idx, pol)
        mass = d.abs().clamp_min(1e-30)                    # A >= 0 for rbf
        err11 = max(float(((d_b[r0:r1] - dr).abs() / mass[r0:r1]).max())
                    for r0, r1, dr in stripes_d)
        check(exc9 <= 0.0 and exc10 <= 0.0 and err11 <= D_RTOL,
              f"{tag}: a block-sparse kernel disagrees with its plain version")
        worst["block_sparse_matmat"] = max(worst["block_sparse_matmat"], err9)
        worst["block_sparse_streaming_matmat"] = max(worst["block_sparse_streaming_matmat"], err10)
        worst["block_sparse_streaming_degree"] = max(
            worst["block_sparse_streaming_degree"],
            max(float((d_b[r0:r1] - dr).abs().max()) for r0, r1, dr in stripes_d))
        live_ref = torch.cat([ref.block_liveness_ref(x[r0:r0 + 4096], x, tm=16, tn=256,
                                                     row_offset=r0,
                                                     **dict(pol, thr=thr[r0:r0 + 4096],
                                                            scale_r=None if sc is None
                                                            else sc[r0:r0 + 4096]))
                              for r0 in range(0, n, 4096)])
        check(torch.equal(live_ref, live), f"{tag}: #8 is not its plain version's map")
        # the fused build of the explicit block-sparse route: the two-pass bits
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        a_f, d_f, thr_f = fused_affinity_build(x, spec=spec, scale_r=sc, scale_c=sc)
        torch.cuda.synchronize()
        fused_extra = torch.cuda.max_memory_allocated() - base
        check(torch.equal(a_f, a) and torch.equal(d_f, d) and torch.equal(thr_f, thr),
              f"{tag}: the fused build's A, D or thresholds are not the two-pass build's")
        del a_f, d_f, thr_f
        rec = dict(live_fraction=frac, live_entries=entries,
                   fused_build_extra_bytes=fused_extra, max_abs_err=dict(
                       block_sparse_matmat=err9, block_sparse_streaming_matmat=err10,
                       block_sparse_streaming_degree_rel=err11))
        if tag == "knn":
            a_raw, _ = affinity_and_degree(x, kind="rbf", sigma=SIGMA)
            rec.update(
                fused_build_ms=cuda_ms(lambda: fused_affinity_build(x, spec=spec), 3),
                two_pass_build_ms=cuda_ms(lambda: affinity_and_degree(
                    x, kind="rbf", sigma=SIGMA, thr=row_topk(
                        x, k=KNN_K, kind="rbf", sigma=SIGMA)[:, -1].contiguous()), 3),
                thresholds_from_scores_ms=cuda_ms(
                    lambda: topk_thresholds_from_scores(a_raw, k=KNN_K), 3),
                row_topk_ms=cuda_ms(lambda: row_topk(x, k=KNN_K, kind="rbf", sigma=SIGMA), 5))
            del a_raw
            r = 2
            op_bytes = 4.0 * n                             # the thresholds
            plan_bytes = 4.0 * (counts.numel() + float(counts.sum()))
            times = dict(
                block_liveness=dict(
                    ms=cuda_ms(lambda: block_liveness(x, **pol), 10),
                    plain_ms=cuda_ms(lambda: [ref.block_liveness_ref(
                        x[r0:r0 + 4096], x, tm=16, tn=256, row_offset=r0,
                        **dict(pol, thr=thr[r0:r0 + 4096])) for r0 in range(0, n, 4096)], 2),
                    library_ms=None,
                    bound=bound_ms(4.0 * (n * m + live.numel()) + op_bytes,
                                   affinity_flops(n, n, m, "rbf") + 2.0 * n * n)),
                block_sparse_matmat=dict(
                    ms=cuda_ms(lambda: block_sparse_matmat(a, v2, d, counts, col_idx), 20),
                    plain_ms=cuda_ms(lambda: ref.block_sparse_matmat_ref(
                        a, v2, d, counts, col_idx, tm=16, tn=256), 3),
                    library_ms=cuda_ms(lambda: torch.matmul(a, v2) / d.clamp_min(1e-30)[:, None],
                                       20),
                    r1_ms=cuda_ms(lambda: block_sparse_matmat(a, v1, d, counts, col_idx), 20),
                    dense_ms=cuda_ms(lambda: degree_normalized_matmat(a, v2, d), 20),
                    bound=bound_ms(4.0 * (entries + 2 * n * r + n) + plan_bytes,
                                   2.0 * r * entries)),
                block_sparse_streaming_matmat=dict(
                    ms=cuda_ms(lambda: block_sparse_streaming_matmat(x, v2, d, **plan, **pol), 20),
                    plain_ms=cuda_ms(lambda: _bs_plain_stripes(x, v2, d, counts, col_idx, pol), 2),
                    library_ms=None,
                    r1_ms=cuda_ms(lambda: block_sparse_streaming_matmat(x, v1, d, **plan, **pol),
                                  20),
                    dense_ms=cuda_ms(lambda: affinity_matmat(x, v2, d, **pol), 20),
                    bound=bound_ms(4.0 * (n * m + 2 * n * r + n) + op_bytes + plan_bytes,
                                   entries * (2 * m + 6 + 2 * r + 1))),
                block_sparse_streaming_degree=dict(
                    ms=cuda_ms(lambda: block_sparse_streaming_degree(x, **plan, **pol), 20),
                    plain_ms=cuda_ms(lambda: _bs_plain_stripes(x, None, None, counts, col_idx,
                                                               pol), 2),
                    library_ms=None,
                    dense_ms=cuda_ms(lambda: affinity_degree_streaming(x, **pol), 20),
                    bound=bound_ms(4.0 * (n * m + n) + op_bytes + plan_bytes,
                                   entries * (2 * m + 7 + 1))))
            for name, t in times.items():
                b, by = t.pop("bound")
                t.update(bound_ms=b, bound_by=by)
                report[name] = dict(t)
            rec["times"] = times
            # a NaN in V: the dense sweep reaches every row, the block-sparse
            # sweep the rows whose live tiles hold its column; the loop's
            # latch reads the same
            v_nan = v2.clone()
            v_nan[7, 1] = float("nan")
            bad_d = int((~torch.isfinite(degree_normalized_matmat(a, v_nan, d))).any(1).sum())
            bad_b = int((~torch.isfinite(block_sparse_matmat(a, v_nan, d, counts,
                                                             col_idx))).any(1).sum())
            eps = 1e-5 / n
            st_d = batched_power_iteration(lambda v: degree_normalized_matmat(a, v, d), v_nan,
                                           eps, 3, return_status=True)[3]
            st_b = batched_power_iteration(lambda v: block_sparse_matmat(a, v, d, counts,
                                                                         col_idx),
                                           v_nan, eps, 3, return_status=True)[3]
            check(torch.equal(st_d, st_b) and bool(st_b[1] != 0),
                  f"a NaN in V latches differently: dense {st_d.tolist()} block-sparse "
                  f"{st_b.tolist()}")
            rec.update(nan_rows_dense=bad_d, nan_rows_block_sparse=bad_b,
                       nan_col_status=st_b.tolist())
        print(f"[block_sparse] {tag} n={n}: #8 = dense_block_live of #1's A, live fraction "
              f"{frac:.4f}; #9 = #2, #10 = #2 and #5 (d=None), #11 = #1's D and #6, r=1,2, "
              f"bitwise; fused build = two-pass build bitwise, its own peak "
              f"{fused_extra / 1e9:.3f} GB beside x; vs plain: #9 {err9:.3e} #10 {err10:.3e} "
              f"#11 rel {err11:.3e}" + "".join(
                  f"; {key}={val}" for key, val in rec.items()
                  if key.endswith("_ms") or key.startswith("nan_")), flush=True)
        out[tag] = rec
        del a, d, d_b, d_6
        torch.cuda.empty_cache()
    for name, t in out["knn"]["times"].items():
        print(f"[block_sparse] {name}: kernel_ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
              f"library_ms={t['library_ms']} bound_ms={t['bound_ms']:.4f} ({t['bound_by']})"
              + "".join(f" {key}={val:.4f}" for key, val in t.items()
                        if key in ("r1_ms", "dense_ms")), flush=True)

    # ragged rows, wide features, off-diagonal stripes, every operand
    xs = torch.randn((1037, 16), generator=g, device="cuda") * 0.25
    scs = torch.rand((1037,), generator=g, device="cuda") * 0.7 + 0.3
    thr_all = torch.rand((1037,), generator=g, device="cuda") * 0.5 + 0.3
    atol = A_ATOL + SQD_RTOL * float((xs * xs).sum(1).max()) / float(scs.min()) ** 2
    for rows, cols, ro, co in ((slice(None), slice(None), 0, 0),
                               (slice(100, 400), slice(300, None), 100, 300)):
        xr, xc = xs[rows].contiguous(), xs[cols].contiguous()
        kw = dict(kind="rbf", sigma=1.1, row_offset=ro, col_offset=co,
                  scale_r=scs[rows].contiguous(), scale_c=scs[cols].contiguous(),
                  thr=thr_all[rows].contiguous())
        a, d = affinity_and_degree(xr, xc, **kw)
        live = block_liveness(xr, xc, **kw)
        torch.cuda.synchronize()
        check(torch.equal(live.bool(), dense_block_live(a, 16, 256)),
              f"ragged ({ro},{co}): #8 is not dense_block_live of #1's A")
        counts, col_idx, _ = block_plan(live)
        plan = dict(counts=counts, col_idx=col_idx)
        for r in (4, 32):
            v = torch.rand((xc.shape[0], r), generator=g, device="cuda")
            check(torch.equal(block_sparse_matmat(a, v, d, counts, col_idx),
                              degree_normalized_matmat(a, v, d)),
                  f"ragged ({ro},{co}) r={r}: #9 is not bitwise #2")
            for dn in (d, None):
                u = block_sparse_streaming_matmat(xr, v, dn, xc, **plan, **kw)
                check(torch.equal(u, affinity_matmat(xr, v, dn, xc, **kw)),
                      f"ragged ({ro},{co}) r={r}: #10 is not bitwise #5")
                u_ref = ref.block_sparse_streaming_matmat_ref(xr, v, dn, xc, tm=16, tn=256,
                                                              **plan, **kw)
                check(float((u - u_ref).abs().max()) <= U_RTOL * float(u_ref.abs().max())
                      + xc.shape[0] * atol, f"ragged ({ro},{co}) r={r}: #10 vs plain")
                worst["block_sparse_streaming_matmat"] = max(
                    worst["block_sparse_streaming_matmat"], float((u - u_ref).abs().max()))
        d_b = block_sparse_streaming_degree(xr, xc, **plan, **kw)
        check(torch.equal(d_b, d), f"ragged ({ro},{co}): #11 is not #1's D")
        # the fused build on the stripe: the two-pass bits
        spec = AffinitySpec(kind="rbf", sigma=1.1, knn_k=KNN_K)
        pol = dict(kind="rbf", sigma=1.1, row_offset=ro, col_offset=co)
        a_f, d_f, thr_f = fused_affinity_build(xr, xc, spec=spec, row_offset=ro, col_offset=co)
        thr_2 = row_topk(xr, xc, k=KNN_K, **pol)[:, -1].contiguous()
        a_2, d_2 = affinity_and_degree(xr, xc, thr=thr_2, **pol)
        check(torch.equal(thr_f, thr_2) and torch.equal(a_f, a_2) and torch.equal(d_f, d_2),
              f"ragged ({ro},{co}): the fused build is not the two-pass build")
    print("[block_sparse] ragged (1037, 16) square and (300, 737) off-diagonal stripes, scales "
          "+ thr: #8 = dense_block_live, #9 = #2, #10 = #5, #11 = #1's D bitwise, r=4,32; "
          "the fused build = the two-pass build", flush=True)
    for name, err in worst.items():
        report[name]["max_abs_err"] = err
    report["block_sparse"] = out


def phase_block_sparse_e2e(report, dense_runs):
    """E1 and E2 with block_sparse=True on both engines: the results of the
    block_sparse=False runs (``dense_runs``, from phase_graph_e2e) bit for
    bit, with each route's launches."""
    from repro_torch import dataset_by_name
    x, y, k = dataset_by_name("gaussians", N_MAIN, seed=0)
    runs = {}
    for tag, spec, n_topk in (("E1", E1_SPEC, 1), ("E2", E2_SPEC, 2)):
        hops = {}
        for engine in ("explicit", "streaming"):
            cfg = _graph_cfg(spec, engine=engine, embedding="orthogonal", n_vectors=2,
                             block_sparse=True)
            rec, res, labels = _graph_run(f"{tag} block_sparse", x, y, k, cfg)
            dense = dense_runs[(tag, engine)]
            bitwise = (torch.equal(res.labels, dense.labels)
                       and torch.equal(res.n_iter_cols, dense.n_iter_cols)
                       and torch.equal(res.embeddings, dense.embeddings)
                       and torch.equal(res.health.components, dense.health.components)
                       and int(res.health.n_components) == int(dense.health.n_components))
            check(bitwise, f"{tag} {engine}: the block-sparse run is not the dense-storage "
                  "run bit for bit")
            c, sweeps = rec["launches"], max(rec["n_iter_cols"])
            hops[engine] = rec["probe_sweeps"]
            if engine == "explicit":
                check(c["affinity_and_degree"] == 1 and c["degree_normalized_matmat"] == 1
                      and c["row_topk"] == n_topk - 1 and c["block_liveness"] == 0
                      and c["streaming_matmat"] == 0 and c["streaming_degree"] == 0
                      and c["block_sparse_streaming_matmat"] == 0, f"{tag} explicit {c}")
            else:
                check(c["row_topk"] == n_topk and c["block_liveness"] == 1
                      and c["block_sparse_streaming_degree"] == 1
                      and c["streaming_matmat"] == rec["probe_sweeps"]
                      and c["affinity_and_degree"] == 0 and c["block_sparse_matmat"] == 0
                      and c["streaming_degree"] == 0, f"{tag} streaming {c}")
            check(rec["probe_sweeps"] > 0, f"{tag} {engine}: the probe did not run")
            rec["bitwise_dense_storage"] = bitwise
            runs.setdefault(tag, []).append(rec)
        check(hops["explicit"] == hops["streaming"], f"{tag}: probe hops {hops}")
    report["e2e_block_sparse"] = runs
    return runs


def _tie_keeping(p, score):
    """The shuffle ``p`` with the rows of each group of equal content scores
    put back in their original relative order: the row reorder's stable
    sort then sees the same order of ties in both inputs."""
    q = p.copy()
    _, group = np.unique(score, return_inverse=True)
    sizes = np.bincount(group)
    for gid in np.flatnonzero(sizes > 1):
        pos = np.flatnonzero(group[p] == gid)          # where the group's rows landed
        q[pos] = np.sort(p[pos])
    return q


def phase_reorder(report):
    """The row reorder at n = 45,000: E1's live fraction on sorted,
    shuffled and reordered rows, E1 on shuffled rows with and without
    row_reorder, and the round trip: a reordered run of the shuffled rows,
    un-permuted, against one of the sorted rows, bit for bit wherever the
    two canonical arrays are the same."""
    from repro_torch import AffinitySpec, GPICConfig, adjusted_rand_index, dataset_by_name
    from repro_torch import run_gpic
    from repro_torch.core.graph import (affinity_stats, content_row_score,
                                        graph_reorder_permutation)
    from repro_torch.data import shuffle_points
    from repro_torch.kernels.block_sparse import block_liveness
    x, y, k = dataset_by_name("gaussians", N_MAIN, seed=0)
    xs, ys = shuffle_points(x, y, seed=0)
    spec = AffinitySpec(**E1_SPEC)

    def live_fraction(xt):
        _, thr = affinity_stats(xt, spec)
        return float(block_liveness(xt, kind="rbf", sigma=SIGMA, thr=thr).float().mean())

    xs_t = torch.as_tensor(xs, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    perm = graph_reorder_permutation(xs_t, spec)
    torch.cuda.synchronize()
    perm_s = time.perf_counter() - t0
    fractions = dict(sorted=live_fraction(torch.as_tensor(x, device="cuda")),
                     shuffled=live_fraction(xs_t), reordered=live_fraction(xs_t[perm]))
    cfg = _graph_cfg(E1_SPEC, engine="explicit", embedding="orthogonal", n_vectors=2,
                     block_sparse=True)
    runs = {}
    for name, c in (("shuffled", cfg), ("shuffled_row_reorder", cfg.with_(row_reorder=True))):
        res, labels, wall, counts, peak = _counted_run(xs, k, c)
        runs[name] = dict(wall_s=wall, n_iter_cols=res.n_iter_cols.tolist(),
                          ari=adjusted_rand_index(ys, labels),
                          n_components=int(res.health.n_components), peak_mem_bytes=peak,
                          launches=counts)
        check(bool(torch.isfinite(res.embeddings).all()), f"E1 {name}: non-finite embedding")
    check("row_reorder" in res.health.notes, "the reordered run does not note the pass")
    print(f"[reorder] E1 n={N_MAIN}: live fraction {fractions}; the permutation "
          f"{perm_s:.4f} s; " + "; ".join(
              f"{name}: wall_s={r['wall_s']:.4f} n_iter_cols={r['n_iter_cols']} "
              f"ARI={r['ari']:.4f} n_components={r['n_components']}"
              for name, r in runs.items()), flush=True)

    # the round trip: the plain shuffle (shuffle_points' permutation) and
    # one that keeps tied content scores in order
    score = content_row_score(torch.as_tensor(x, device="cuda")).cpu().numpy()
    p = np.random.default_rng(0).permutation(N_MAIN)
    shuffles = {"shuffle": p, "tie_keeping_shuffle": _tie_keeping(p, score)}
    n_tied = int(N_MAIN - np.unique(score).size)
    trips = {}
    for name, spec_kw, extra in (
            ("dense", dict(kind="rbf", sigma=SIGMA), dict(max_iter=400)),
            ("knn64", dict(kind="rbf", sigma=SIGMA, knn_k=64),
             dict(max_iter=400, embedding="orthogonal", n_vectors=2))):
        c = GPICConfig(affinity=AffinitySpec(**spec_kw), row_reorder=True, **extra)
        x_t = torch.as_tensor(x, device="cuda")
        canon = x_t[graph_reorder_permutation(x_t, c.affinity)]
        res_a, _, wall_a, _, _ = _counted_run(x, k, c)
        for sname, q in shuffles.items():
            xq = torch.as_tensor(x[q], device="cuda")
            same_canon = torch.equal(canon, xq[graph_reorder_permutation(xq, c.affinity)])
            res_b, _, wall_b, _, _ = _counted_run(x[q], k, c)
            qt = torch.as_tensor(q, device="cuda")
            bitwise = (torch.equal(res_a.labels[qt], res_b.labels)
                       and torch.equal(res_a.embedding[qt], res_b.embedding)
                       and torch.equal(res_a.embeddings[qt], res_b.embeddings)
                       and torch.equal(res_a.health.components[qt], res_b.health.components))
            if same_canon:
                check(bitwise, f"round trip {name} {sname}: the canonical arrays are equal "
                      "but the un-permuted results differ")
            trips[f"{name}_{sname}"] = dict(
                canonical_equal=same_canon, bitwise=bitwise, wall_s=[wall_a, wall_b],
                n_components=int(res_b.health.n_components),
                n_iter_cols=res_b.n_iter_cols.tolist(),
                agree_ari=adjusted_rand_index(res_a.labels[qt].cpu().numpy(),
                                              res_b.labels.cpu().numpy()))
        check(name != "dense" or trips["dense_tie_keeping_shuffle"]["canonical_equal"],
              "the dense spec's canonical order depends on the input order beyond ties")
    print(f"[reorder] round trip at n={N_MAIN} ({n_tied} content scores tied): " + "; ".join(
        f"{key}: canonical equal={t['canonical_equal']} bitwise={t['bitwise']} "
        f"n_components={t['n_components']} n_iter_cols={t['n_iter_cols']} "
        f"ARI between={t['agree_ari']:.4f} wall_s={t['wall_s'][1]:.4f}"
        for key, t in trips.items()), flush=True)
    report["reorder"] = dict(live_fraction=fractions, permutation_s=perm_s, runs=runs,
                             tied_scores=n_tied, round_trip=trips)


def _counted_run(x, k, cfg):
    """run_gpic with the launch counters set to 0 just before and read
    just after, and the peak device memory of the run. Returns (result,
    labels as numpy, wall seconds, counts, peak bytes)."""
    from repro_torch import run_gpic
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_gpic(x, k, cfg)
    labels = res.labels.cpu().numpy()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    return res, labels, wall, counts, torch.cuda.max_memory_allocated()


def phase_end_to_end(report):
    from repro_torch import GPICConfig, adjusted_rand_index, dataset_by_name, run_gpic
    cfg = GPICConfig(affinity_kind="rbf", sigma=SIGMA, max_iter=400)

    # small input: the card against the plain versions on the CPU
    x, y, k = dataset_by_name("gaussians", 2000, seed=0)
    res_gpu = run_gpic(x, k, cfg)
    res_cpu = run_gpic(x, k, cfg, device="cpu")
    emb_gpu, emb_cpu = res_gpu.embedding.cpu(), res_cpu.embedding
    rel = float((emb_gpu - emb_cpu).abs().max() / emb_cpu.abs().max())
    agree = adjusted_rand_index(res_cpu.labels.numpy(), res_gpu.labels.cpu().numpy())
    print(f"[e2e] n=2000 card vs CPU: sweeps {int(res_gpu.n_iter)} vs {int(res_cpu.n_iter)}, "
          f"max|dv|/max|v|={rel:.3e}, ARI(card, CPU)={agree:.4f}", flush=True)
    check(agree == 1.0 and rel <= 1e-4 and abs(int(res_gpu.n_iter) - int(res_cpu.n_iter)) <= 1,
          "the card and the CPU disagree on the small input")

    # the main path at the paper's size, counted
    x, y, k = dataset_by_name("gaussians", N_MAIN, seed=0)
    res, labels, wall, counts, peak = _counted_run(x, k, cfg)
    sweeps = int(res.n_iter)
    ari = adjusted_rand_index(y, labels)
    emb = res.embedding
    print(f"[e2e] explicit gaussians n={N_MAIN} rbf sigma={SIGMA}: wall_s={wall:.4f} "
          f"sweeps={sweeps} converged={bool(res.converged)} ARI={ari:.4f} "
          f"peak_mem_GB={peak / 1e9:.3f} launches={counts} health: {res.health.summary()}",
          flush=True)
    check(labels.shape == (N_MAIN,) and bool(torch.isfinite(emb).all())
          and emb.shape == (N_MAIN,), "the result has the wrong shape or is not finite")
    check(ari >= 0.99, f"ARI {ari:.4f} < 0.99")
    check(counts["affinity_and_degree"] == 1, f"affinity launched {counts}")
    check(counts["degree_normalized_matmat"] == sweeps, f"sweep launches {counts} vs {sweeps}")
    check(counts["kmeans_assign"] == cfg.kmeans_iters + 1, f"assignment launched {counts}")
    report["e2e"] = dict(n=N_MAIN, wall_s=wall, sweeps=sweeps, ari=ari,
                         peak_mem_bytes=peak, launches=counts)
    return counts, res, labels


def phase_streaming_e2e(report, explicit):
    """The streaming engine on the main path's config: the explicit run's
    result, without A."""
    from repro_torch import GPICConfig, adjusted_rand_index, dataset_by_name
    _, res_e, labels_e = explicit
    cfg = GPICConfig(engine="streaming", affinity_kind="rbf", sigma=SIGMA, max_iter=400)
    x, y, k = dataset_by_name("gaussians", N_MAIN, seed=0)
    res, labels, wall, counts, peak = _counted_run(x, k, cfg)
    sweeps = int(res.n_iter)
    ari = adjusted_rand_index(y, labels)
    bitwise = torch.equal(res.embeddings, res_e.embeddings)
    print(f"[e2e] streaming gaussians n={N_MAIN}: wall_s={wall:.4f} sweeps={sweeps} "
          f"(explicit {int(res_e.n_iter)}) ARI={ari:.4f} peak_mem_GB={peak / 1e9:.3f} "
          f"embedding bitwise the explicit run's={bitwise} labels equal="
          f"{bool((labels == labels_e).all())} launches={counts}", flush=True)
    check(bool(torch.isfinite(res.embedding).all()) and labels.shape == (N_MAIN,),
          "the streaming result has the wrong shape or is not finite")
    check(sweeps == int(res_e.n_iter) and bool((labels == labels_e).all()),
          "streaming and explicit runs disagree on sweeps or labels")
    check(ari >= 0.99, f"streaming ARI {ari:.4f} < 0.99")
    check(counts["streaming_degree"] == 1 and counts["streaming_matmat"] == sweeps
          and counts["affinity_and_degree"] == 0 and counts["degree_normalized_matmat"] == 0
          and counts["kmeans_assign"] == cfg.kmeans_iters + 1,
          f"streaming launches {counts} vs {sweeps} sweeps")
    check(peak < MEM_LIMIT, f"streaming peak memory {peak / 1e9:.3f} GB >= 1 GB")
    report["e2e_streaming"] = dict(n=N_MAIN, wall_s=wall, sweeps=sweeps, ari=ari,
                                   peak_mem_bytes=peak, launches=counts,
                                   bitwise_explicit=bitwise)
    return counts


def phase_past_memory(report):
    """Streaming where the explicit engine cannot run: A at n = 150,000
    would be 90 GB on an 80 GB card."""
    from repro_torch import GPICConfig, adjusted_rand_index, dataset_by_name
    from repro_torch.kernels.streaming import affinity_degree_streaming, affinity_matmat
    cfg = GPICConfig(engine="streaming", affinity_kind="rbf", sigma=SIGMA, max_iter=400)
    x, y, k = dataset_by_name("gaussians", N_BIG, seed=0)
    res, labels, wall, counts, peak = _counted_run(x, k, cfg)
    sweeps = int(res.n_iter)
    ari = adjusted_rand_index(y, labels)
    print(f"[e2e] streaming gaussians n={N_BIG} (A would be {4.0 * N_BIG ** 2 / 1e9:.1f} GB): "
          f"wall_s={wall:.4f} sweeps={sweeps} converged={bool(res.converged)} ARI={ari:.4f} "
          f"peak_mem_GB={peak / 1e9:.3f} launches={counts}", flush=True)
    check(ari >= 0.99, f"n={N_BIG} ARI {ari:.4f} < 0.99")
    check(peak < MEM_LIMIT, f"n={N_BIG} peak memory {peak / 1e9:.3f} GB >= 1 GB")
    check(counts["streaming_matmat"] == sweeps, f"n={N_BIG} launches {counts}")
    # one sweep of the final state against the plain version on 3 stripes
    xt = torch.as_tensor(x, device="cuda")
    v = res.embeddings.contiguous()
    d = affinity_degree_streaming(xt, kind="rbf", sigma=SIGMA)
    u = affinity_matmat(xt, v, d, kind="rbf", sigma=SIGMA)
    rows = (0, N_BIG // 2 - 1024, N_BIG - 2048)
    abs_err, excess, err_d, _ = _stripe_u_d_errors(
        u, d, _plain_streaming_stripes(xt, v, d, "rbf", SIGMA, stripe=2048, rows=rows))
    print(f"[e2e] n={N_BIG} one sweep vs plain on rows {rows} (+2,048): "
          f"max|U-U_ref|={abs_err:.3e} excess={excess:.3e} max|D-D_ref|/mass={err_d:.3e}",
          flush=True)
    check(excess <= 0.0 and err_d <= D_RTOL, f"n={N_BIG} streaming disagrees with plain")
    report["e2e_past_memory"] = dict(n=N_BIG, wall_s=wall, sweeps=sweeps, ari=ari,
                                     peak_mem_bytes=peak, launches=counts,
                                     max_abs_err=abs_err, max_rel_err_d=err_d)


def phase_orthogonal(report):
    """The orthogonal block (r = 2) on three_circles, both engines, with
    and without the residual rule. Returns the Gram's count of the first
    streaming run."""
    from repro_torch import GPICConfig, adjusted_rand_index, dataset_by_name
    x, y, k = dataset_by_name("three_circles", N_MAIN, seed=0)
    runs, gram_count = [], None
    for tol in (None, 1e-3):
        out = {}
        for engine, sweep_op in (("explicit", "degree_normalized_matmat"),
                                 ("streaming", "streaming_matmat")):
            cfg = GPICConfig(engine=engine, affinity_kind="rbf", sigma=SIGMA, n_vectors=2,
                             embedding="orthogonal", max_iter=400, residual_tol=tol)
            res, labels, wall, counts, peak = _counted_run(x, k, cfg)
            cols = res.n_iter_cols.tolist()
            sweeps = max(cols)
            # the residual is priced on every sweep from column 0's
            # convergence on (qr_every = 1) until the loop stops
            checks = sweeps - cols[0] + 1 if tol is not None and bool(res.converged_cols[0]) else 0
            ari = adjusted_rand_index(y, labels)
            print(f"[e2e] orthogonal three_circles n={N_MAIN} {engine} residual_tol={tol}: "
                  f"wall_s={wall:.4f} n_iter_cols={cols} ARI={ari:.4f} "
                  f"peak_mem_GB={peak / 1e9:.3f} launches={counts}", flush=True)
            check(counts[sweep_op] == sweeps, f"orthogonal sweep launches {counts}")
            check(counts["gram"] == sweeps + checks,
                  f"gram launched {counts['gram']}, expected {sweeps} QR sweeps + "
                  f"{checks} residual checks")
            out[engine] = (labels, cols, ari)
            runs.append(dict(engine=engine, residual_tol=tol, wall_s=wall, n_iter_cols=cols,
                             ari=ari, peak_mem_bytes=peak, launches=counts))
            if engine == "streaming" and gram_count is None:
                gram_count = counts["gram"]
        (lab_e, cols_e, ari_e), (lab_s, cols_s, ari_s) = out["explicit"], out["streaming"]
        check(bool((lab_e == lab_s).all()) and cols_e == cols_s,
              f"orthogonal engines disagree (residual_tol={tol})")
        check(min(ari_e, ari_s) >= ORTHO_ARI_FLOOR,
              f"orthogonal ARI {min(ari_e, ari_s):.4f} < {ORTHO_ARI_FLOOR}")
    report["e2e_orthogonal"] = runs
    return gram_count


def phase_ensemble(report):
    from repro_torch import GPICConfig, adjusted_rand_index, dataset_by_name
    from repro_torch.core.power import default_snapshot_iters
    cfg = GPICConfig(engine="streaming", affinity_kind="rbf", sigma=SIGMA, max_iter=400,
                     embedding="ensemble")
    x, y, k = dataset_by_name("gaussians", N_MAIN, seed=0)
    res, labels, wall, counts, peak = _counted_run(x, k, cfg)
    n_snap = len(default_snapshot_iters(cfg.max_iter))
    ari = adjusted_rand_index(y, labels)
    print(f"[e2e] ensemble streaming gaussians n={N_MAIN}: wall_s={wall:.4f} "
          f"sweeps={int(res.n_iter)} embedding={tuple(res.embeddings.shape)} ARI={ari:.4f} "
          f"launches={counts}", flush=True)
    check(tuple(res.embeddings.shape) == (N_MAIN, n_snap)
          and bool(torch.isfinite(res.embeddings).all()), "ensemble embedding shape")
    check(ari >= 0.99, f"ensemble ARI {ari:.4f} < 0.99")
    report["e2e_ensemble"] = dict(wall_s=wall, sweeps=int(res.n_iter), ari=ari,
                                  embedding_shape=list(res.embeddings.shape), launches=counts)


def _graph_cfg(spec_kw, **kw):
    from repro_torch import AffinitySpec, GPICConfig
    base = dict(affinity=AffinitySpec(**spec_kw), max_iter=400, block_sparse=False)
    return GPICConfig(**dict(base, **kw))


E1_SPEC = dict(kind="rbf", sigma=SIGMA, knn_k=KNN_K)
E2_SPEC = dict(kind="rbf", bandwidth="adaptive", scale_k=SCALE_K, knn_k=KNN_K)
E3_SPEC = dict(kind="rbf", bandwidth="adaptive", scale_k=SCALE_K)
SWEEP_OP = {"explicit": "degree_normalized_matmat", "streaming": "streaming_matmat"}
BS_SWEEP_OP = {"explicit": "block_sparse_matmat", "streaming": "block_sparse_streaming_matmat"}


def _sweep_op(cfg):
    """The op of a graph run's power sweeps (n > 256 throughout)."""
    return (BS_SWEEP_OP if cfg.block_sparse else SWEEP_OP)[cfg.engine]


def _graph_run(tag, x, y, k, cfg):
    """One counted run of a graph spec: its numbers, with the sweeps of the
    power loop and those of the component probe apart (the probe runs the
    engine's sweep op too: one forward sweep a hop, plus the streamed
    transpose product on the streaming engine)."""
    from repro_torch import adjusted_rand_index
    res, labels, wall, counts, peak = _counted_run(x, k, cfg)
    cols = res.n_iter_cols.tolist()
    sweeps = max(cols)
    ari = adjusted_rand_index(y, labels)
    probe = counts[_sweep_op(cfg)] - sweeps
    n_comp = int(res.health.n_components)
    print(f"[e2e] {tag} {cfg.engine} n={len(y)}: wall_s={wall:.4f} n_iter_cols={cols} "
          f"ARI={ari:.4f} n_components={n_comp} probe_sweeps={probe} "
          f"peak_mem_GB={peak / 1e9:.3f} launches={counts}", flush=True)
    check(labels.shape == (len(y),) and bool(torch.isfinite(res.embeddings).all()),
          f"{tag} {cfg.engine}: the result has the wrong shape or is not finite")
    check(counts["gram"] == (sweeps if cfg.embedding == "orthogonal" else 0),
          f"{tag}: gram launched {counts['gram']} times for {sweeps} QR sweeps")
    check(counts["kmeans_assign"] == cfg.kmeans_iters + 1, f"{tag}: assignment {counts}")
    return dict(engine=cfg.engine, wall_s=wall, n_iter_cols=cols, ari=ari, n_components=n_comp,
                probe_sweeps=probe, peak_mem_bytes=peak, launches=counts), res, labels


def phase_graph_e2e(report):
    """E1-E3 and the report-only two_moons run at the paper's size. E1's
    quality floor is the reference's, at the reference's n = 480: there
    both engines on the card (with the same labels) and the plain versions
    on the CPU (other random draws) must reach it."""
    from repro_torch import adjusted_rand_index, dataset_by_name, run_gpic
    xs, ys, ks = dataset_by_name("gaussians", 480, seed=0)
    small = {}
    for engine in ("explicit", "streaming"):
        cfg = _graph_cfg(E1_SPEC, engine=engine, embedding="orthogonal", n_vectors=2)
        small[engine] = run_gpic(xs, ks, cfg).labels.cpu().numpy()
        cfg_bs = _graph_cfg(E1_SPEC, engine=engine, embedding="orthogonal", n_vectors=2,
                            block_sparse=True)
        small[f"{engine}_block_sparse"] = run_gpic(xs, ks, cfg_bs).labels.cpu().numpy()
        check(bool((small[f"{engine}_block_sparse"] == small[engine]).all()),
              f"E1 at n=480 {engine}: block_sparse=True gives other labels")
    small["cpu"] = run_gpic(xs, ks, _graph_cfg(E1_SPEC, embedding="orthogonal", n_vectors=2),
                            device="cpu").labels.numpy()
    aris = {key: adjusted_rand_index(ys, lab) for key, lab in small.items()}
    print(f"[e2e] E1 n=480: ARI {aris}", flush=True)
    check(min(aris.values()) >= BLOBS_ARI_FLOOR
          and bool((small["explicit"] == small["streaming"]).all()),
          f"E1 at n=480: ARI {aris} under the reference's floor {BLOBS_ARI_FLOOR}, or the "
          "engines' labels differ")
    x, y, k = dataset_by_name("gaussians", N_MAIN, seed=0)
    runs = {"E1_n480_ari": aris}
    dense_runs = {}
    for tag, spec, n_topk in (("E1", E1_SPEC, 1), ("E2", E2_SPEC, 2)):
        out = {}
        for engine in ("explicit", "streaming"):
            cfg = _graph_cfg(spec, engine=engine, embedding="orthogonal", n_vectors=2)
            rec, res, labels = _graph_run(tag, x, y, k, cfg)
            c = rec["launches"]
            check(c["row_topk"] == n_topk, f"{tag} {engine}: row_topk launched {c['row_topk']}")
            if engine == "explicit":
                check(c["affinity_and_degree"] == 1 and c["streaming_matmat"] == 0
                      and c["streaming_degree"] == 0, f"{tag} explicit launches {c}")
            else:
                check(c["streaming_degree"] == 1 and c["affinity_and_degree"] == 0
                      and c["degree_normalized_matmat"] == 0, f"{tag} streaming launches {c}")
            check(rec["n_components"] >= 1 and rec["probe_sweeps"] > 0,
                  f"{tag} {engine}: the component probe did not run")
            out[engine] = (rec, res, labels)
            dense_runs[(tag, engine)] = res
        (re_, rese, labe), (rs, ress, labs) = out["explicit"], out["streaming"]
        check(bool((labe == labs).all()) and re_["n_iter_cols"] == rs["n_iter_cols"]
              and re_["n_components"] == rs["n_components"]
              and torch.equal(rese.health.components, ress.health.components),
              f"{tag}: the engines disagree on labels, sweeps or components")
        # the streaming probe runs a transpose product beside each forward sweep
        check(rs["probe_sweeps"] == 2 * re_["probe_sweeps"],
              f"{tag}: probe sweeps {re_['probe_sweeps']} explicit, {rs['probe_sweeps']} "
              "streaming")
        runs[tag] = [re_, rs]
        del out, rese, ress

    # E3: adaptive dense, classic, explicit: pass 1a only, no probe
    rec, res, _ = _graph_run("E3", x, y, k, _graph_cfg(E3_SPEC, engine="explicit"))
    c = rec["launches"]
    check(c["row_topk"] == 1 and rec["probe_sweeps"] == 0 and rec["n_components"] == -1,
          f"E3: launches {c}, n_components {rec['n_components']}")
    runs["E3"] = [rec]

    # report only: two_moons under the widest kNN the kernel takes
    xm, ym, km = dataset_by_name("two_moons", N_MAIN, seed=0)
    rec, _, _ = _graph_run("moons_knn64", xm, ym, km,
                           _graph_cfg(dict(kind="rbf", sigma=0.25, knn_k=64),
                                      engine="streaming", embedding="orthogonal", n_vectors=2))
    runs["moons_knn64"] = [rec]
    report["e2e_graph"] = runs
    return runs, dense_runs


# --- the LM substrate: kernel 12 and the dense serve path ------------------

FA_F32_TOL = (2e-6, 1e-5)   # (atol, rtol) f32 out: the reference's kernel test
FA_BF16_TOL = (2e-2, 2e-2)  # bf16 out: the reference's bf16 test
SERVE_ARCH = "stablelm-3b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 2048, 32
# card against CPU, 2 layers at full width, relative to max|logits|: both
# compute kernel 12's f32 function, and where a sum in another order puts a
# K, V or attention-output value on the other side of a bf16 rounding,
# that value moves by 2**-8 of itself
SERVE_LOGIT_RTOL = 1e-2


def _fa_case(b, h, kv, s, d, q_dtype, kv_dtype, seed, strided=False):
    """q, k, v (normal * 0.5, the reference's test inputs) in the (bh, s, d)
    layout or, ``strided``, as (b, h, s, d) views of the model's (b, s, h, d)
    activation and of a (b, S, kv, d) cache (S = s + 32), as the serve path
    passes them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if not strided:
        return tuple((torch.randn((n, s, d), generator=g, device="cuda") * 0.5).to(dt)
                     for n, dt in ((b * h, q_dtype), (b * kv, kv_dtype), (b * kv, kv_dtype)))
    q = (torch.randn((b, s, h, d), generator=g, device="cuda") * 0.5).to(q_dtype)
    cache = (torch.randn((2, b, s + 32, kv, d), generator=g, device="cuda") * 0.5).to(kv_dtype)
    return q.transpose(1, 2), cache[0, :, :s].transpose(1, 2), cache[1, :, :s].transpose(1, 2)


def _flash_work(q, k, causal) -> tuple[float, float]:
    """(bytes, operations) of one call: q, k, v read once and the output
    written once; the two products, 2 d each per visible (query, key) pair
    and head (s (s + 1) / 2 pairs causal, s^2 full). The softmax's few
    operations per pair are left out."""
    s, d = q.shape[-2:]
    heads = q.numel() // (s * d)
    pairs = s * (s + 1) / 2 if causal else s * s
    n_bytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
    return n_bytes, 4.0 * d * pairs * heads


def flash_bound(q, k, v, causal) -> tuple[float, str]:
    """The function's bound with its products on the f32 FMA units."""
    return bound_ms(*_flash_work(q, k, causal))


def flash_tensor_bound(q, k, v, causal) -> tuple[float, str]:
    """The bound of the arithmetic kernel 12 runs: each product as its
    split-TF32 terms at the TF32 tensor rate (q k^T: 1 term for bf16 q and
    K, 2 for f32 q over bf16 K, 3 over f32 K; p v: 2 over bf16 V, 3 over f32
    V), or the bytes if they take longer."""
    n_bytes, n_ops = _flash_work(q, k, causal)
    kv_f32 = k.dtype == torch.float32
    terms = (3 if kv_f32 else 2 if q.dtype == torch.float32 else 1) + (3 if kv_f32 else 2)
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = terms / 2 * n_ops / H100_TF32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_registers(log: str) -> dict[str, str]:
    """Registers and spills of each kernel-12 template in nvcc's report:
    ``{"<q type>/<k, v type> NT=<d / 8> <async|scalar>": "R registers, S
    bytes spilled"}``."""
    types = {"f": "f32", "13__nv_bfloat16": "bf16", "S1_": "bf16"}
    out, tmpl, spill = {}, None, "?"
    for line in log.splitlines():
        entry = re.search(r"flash_kernelI(f|13__nv_bfloat16)(f|13__nv_bfloat16|S1_)Li(\d+)ELb(\d)",
                          line)
        spilled = re.search(r"(\d+) bytes spill stores", line)
        regs = re.search(r"Used (\d+) registers", line)
        if entry:
            stage = "async" if entry.group(4) == "1" else "scalar"
            tmpl = (f"{types[entry.group(1)]}/{types[entry.group(2)]} NT={entry.group(3)} "
                    f"{stage}")
        elif spilled:
            spill = spilled.group(1)
        elif regs and tmpl:
            out[tmpl] = f"{regs.group(1)} registers, {spill} bytes spilled"
            tmpl = None
    return out


def phase_flash_attention(report, build_log=""):
    """Kernel 12 against its plain version at the serve path's shape and
    layout, and at ragged, GQA, MQA, full, bf16, unaligned (the
    scalar-staging template) and b h > 65,535 ones; timed at the serve shape
    beside SDPA (a yardstick; the port never calls it). ``build_log`` is
    nvcc's report of flash_attention.cu: no template may spill at d = 80
    (NT = 10) or d = 128 (NT = 16)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    registers = flash_registers(build_log)
    for tmpl, line in registers.items():
        print(f"[flash] {tmpl}: {line}")
    spills = [f"{tmpl}: {line}" for tmpl, line in registers.items()
              if tmpl.split()[1] in ("NT=10", "NT=16") and not line.endswith(" 0 bytes spilled")]
    check(not spills, f"flash_attention spills at d = 80 or 128: {spills}")
    if not registers:
        print("[flash] flash_attention.cu was built before this run: no register report")
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # tag, (b, h, kv, s, d), q type, k/v type, causal, strided
        ("serve", (4, 32, 32, 2048, 80), f32, bf16, True, False),
        ("serve, strided cache views", (4, 32, 32, 2048, 80), f32, bf16, True, True),
        ("ragged s=1000", (4, 32, 32, 1000, 80), f32, bf16, True, False),
        ("GQA rep 4 d=120", (2, 32, 8, 2048, 120), f32, f32, True, False),
        ("MQA rep 48 d=128", (2, 48, 1, 1024, 128), f32, f32, True, False),
        ("non-causal", (4, 32, 32, 2048, 80), f32, bf16, False, False),
        ("all-bf16", (4, 32, 32, 2048, 80), bf16, bf16, True, False),
        ("smoke d=24 s=17", (2, 4, 4, 17, 24), f32, bf16, True, True),
        ("unaligned rows d=17", (2, 4, 2, 200, 17), f32, f32, True, False),
        ("unaligned rows d=17, cache views, full", (2, 4, 2, 200, 17), f32, bf16, False, True),
        ("b h = 70,000 > 65,535, GQA rep 5", (2, 35000, 7000, 40, 16), f32, bf16, True, False),
    ]
    worst = 0.0
    for i, (tag, (b, h, kv, s, d), qt, kt, causal, strided) in enumerate(cases):
        q, k, v = _fa_case(b, h, kv, s, d, qt, kt, seed=40 + i, strided=strided)
        out = flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        atol, rtol = FA_BF16_TOL if qt == bf16 else FA_F32_TOL
        diff = (out.float() - want.float()).abs()
        err = float(diff.max())
        excess = float((diff - atol - rtol * want.float().abs()).max())
        print(f"[flash] {tag} q {tuple(q.shape)} {qt} k/v {tuple(k.shape)} {kt} "
              f"causal={causal}: max|o-o_ref|={err:.3e} max|o_ref|="
              f"{float(want.float().abs().max()):.3e} (atol {atol}, rtol {rtol})", flush=True)
        check(out.shape == want.shape and out.dtype == want.dtype,
              f"flash_attention gives the wrong shape or type ({tag})")
        check(bool(torch.isfinite(out).all()) and excess <= 0.0,
              f"flash_attention disagrees with its plain version ({tag})")
        worst = max(worst, err)
        del q, k, v, out, want, diff
    b, h, kv, s, d = 4, 32, 32, 2048, 80
    q, k, v = _fa_case(b, h, kv, s, d, f32, bf16, seed=40, strided=True)
    k32, v32 = k.float(), v.float()                 # SDPA takes one type
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fns = {"ms": lambda: flash_attention(q, k, v),
           "plain_ms": lambda: ref.flash_attention_ref(q, k, v),
           "library_ms": lambda: sdpa(q, k32, v32, is_causal=True, enable_gqa=True)}
    times = {key: cuda_ms(fn, 10) for key, fn in fns.items()}
    lib_err = float((fns["library_ms"]() - ref.flash_attention_ref(q, k, v)).abs().max())
    bnd, by = flash_tensor_bound(q, k, v, True)
    fma_bnd, fma_by = flash_bound(q, k, v, True)
    print(f"[flash] serve shape bh={b * h} s={s} d={d} causal, f32 q, bf16 cache views: "
          f"kernel_ms={times['ms']:.4f} plain_ms={times['plain_ms']:.4f} "
          f"library_ms={times['library_ms']:.4f} (SDPA on f32 copies of k, v; "
          f"max|sdpa-plain|={lib_err:.3e}) bound_ms={bnd:.4f} ({by}: the kernel's two "
          f"split-TF32 terms a product at {H100_TF32_FLOPS / 1e12:.0f} TFLOP/s) "
          f"f32_fma_bound_ms={fma_bnd:.4f} ({fma_by}: the products at "
          f"{H100_F32_FLOPS / 1e12:.0f} TFLOP/s)", flush=True)
    report["flash_attention"] = dict(times, bound_ms=bnd, bound_by=by, max_abs_err=worst,
                                     f32_fma_bound_ms=fma_bnd, registers=registers)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _top2_margin(logits):
    top2 = torch.topk(logits, 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def phase_serve_parity(report):
    """stablelm-3b at full width cut to 2 layers, batch 2, a ragged prompt
    of 100: prefill and 8 decode steps on the card against the same calls on
    the CPU (the plain versions), from the same weights. The decode steps
    are fed the CPU's greedy tokens, so each step compares the same inputs."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_api, make_train_batch
    cfg = get_config(SERVE_ARCH).replace(n_layers=2)
    api = get_api(cfg)
    t0 = time.perf_counter()
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    params_gpu = _tree_to(params, "cuda")
    tokens = make_train_batch(cfg, 2, 100, torch.Generator().manual_seed(1))["tokens"]
    kw = dict(compute_dtype=torch.float32)
    max_len, steps = 100 + 8, 8
    runs = {}
    for dev, p in (("cpu", params), ("cuda", params_gpu)):
        logits, cache = api.prefill(p, cfg, {"tokens": tokens.to(dev)}, max_len, **kw)
        runs[dev] = [logits[:, :, :cfg.vocab_size].float().cpu()], cache
    worst, flips, compared = 0.0, 0, 0
    for i in range(steps + 1):
        want, got = runs["cpu"][0][i], runs["cuda"][0][i]
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        margin = _top2_margin(want[:, -1])
        clear = margin > SERVE_LOGIT_RTOL * scale
        same = got[:, -1].argmax(-1) == want[:, -1].argmax(-1)
        flips += int((~same & clear).sum())
        compared += int(clear.sum())
        worst = max(worst, err / scale)
        print(f"[serve-parity] {'prefill' if i == 0 else f'decode {i}'}: "
              f"max|dlogits|={err:.4e} max|logits|={scale:.4f} greedy same "
              f"{same.tolist()} top-2 margin {[round(float(m), 4) for m in margin]}",
              flush=True)
        if i == steps:
            break
        tok = want[:, -1].argmax(-1).to(torch.int32)[:, None]
        for dev in ("cpu", "cuda"):
            logits, _ = api.decode_step(params if dev == "cpu" else params_gpu, cfg,
                                        tok.to(dev), runs[dev][1], 100 + i, **kw)
            runs[dev][0].append(logits[:, :, :cfg.vocab_size].float().cpu())
    cache_same = {name: float((runs["cuda"][1][name].cpu() == runs["cpu"][1][name])
                              .float().mean()) for name in ("k", "v")}
    wall = time.perf_counter() - t0
    print(f"[serve-parity] {SERVE_ARCH} 2 layers, batch 2, prompt 100, {steps} decode "
          f"steps: max|dlogits|/max|logits|={worst:.4e} (limit {SERVE_LOGIT_RTOL}), "
          f"greedy tokens compared past a near-tie {compared}, differing {flips}; "
          f"bf16 cache entries equal {cache_same}; {wall:.1f} s", flush=True)
    check(worst <= SERVE_LOGIT_RTOL, "the card and the CPU disagree on the serve logits")
    check(flips == 0, "the card's greedy tokens differ from the CPU's past a near-tie")
    report["serve_parity"] = dict(max_rel_logit_err=worst, greedy_compared=compared,
                                  greedy_flips=flips, cache_equal_fraction=cache_same,
                                  wall_s=wall)


def phase_serve(report):
    """The full 32-layer stablelm-3b through launch/serve.py's ``serve``
    with weights drawn on the card from seed 0: 4 requests of 2,048 prompt
    tokens, 32 generated tokens each, counted; then a second call on the
    same weights, for times without the first call's one-time costs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import get_api
    cfg = get_config(SERVE_ARCH)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = get_api(cfg).init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    kw = dict(batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, gen=SERVE_GEN, seed=0,
              device="cuda", params=params)
    ops.reset_launch_counts()
    res = serve.serve(cfg, **kw)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    again = serve.serve(cfg, **kw)
    check(torch.equal(again.tokens, res.tokens), "a second serve call gives other tokens")
    times = {tag: dict(prefill_ms=r.prefill_s * 1e3,
                       decode_ms_per_token=r.decode_s / (SERVE_GEN - 1) * 1e3)
             for tag, r in (("first", res), ("second", again))}
    print(f"[serve] {SERVE_ARCH} full ({cfg.n_layers} layers, d_model {cfg.d_model}), "
          f"batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, gen {SERVE_GEN}: "
          + "; ".join(f"{tag} call prefill_ms={t['prefill_ms']:.3f} decode_ms_per_token="
                      f"{t['decode_ms_per_token']:.3f}" for tag, t in times.items())
          + f"; peak_mem_GB={peak / 1e9:.3f}; flash_attention launches: prefill "
          f"{res.prefill_launches['flash_attention']}, decode "
          f"{res.decode_launches['flash_attention']}", flush=True)
    for i in range(2):
        print(f"[serve]   seq{i}: {res.tokens[i].tolist()}", flush=True)
    check(tuple(res.tokens.shape) == (SERVE_BATCH, SERVE_GEN)
          and int(res.tokens.min()) >= 0 and int(res.tokens.max()) < cfg.vocab_size,
          "the serve path's tokens have the wrong shape or range")
    check(bool(torch.isfinite(res.prefill_logits).all()), "the prefill logits are not finite")
    check(res.prefill_launches["flash_attention"] == cfg.n_layers
          and res.decode_launches["flash_attention"] == 0
          and counts["flash_attention"] == cfg.n_layers,
          f"flash_attention launches: prefill {res.prefill_launches}, decode "
          f"{res.decode_launches}")
    report["serve"] = dict(times, peak_mem_bytes=peak, launches=counts,
                           first_tokens=res.tokens[:2].tolist(),
                           profile=_serve_profile(cfg, params, res.tokens))
    return counts


def _profiled(fn, top_n=6):
    """Wall ms of ``fn`` under torch.profiler, the device's busy ms in it
    and its top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = _device_spans(prof)
    top = _by_kernel(spans)[:top_n]
    return dict(wall_ms=wall_ms, device_busy_ms=_busy_us(spans) / 1e3 if spans else None,
                top=[dict(name=l, launches=c, ms=ms) for l, (c, ms) in top])


def _serve_profile(cfg, params, tokens):
    """The serve path's prefill and 4 decode steps under torch.profiler."""
    from repro_torch.models import make_train_batch
    from repro_torch.train.train_step import build_decode_step, build_prefill
    max_len = SERVE_PROMPT + SERVE_GEN
    data = make_train_batch(cfg, SERVE_BATCH, SERVE_PROMPT, torch.Generator().manual_seed(0))
    data = {"tokens": data["tokens"].to("cuda")}
    prefill = build_prefill(cfg, max_len, compute_dtype=torch.float32)
    decode = build_decode_step(cfg, compute_dtype=torch.float32)
    state = {}

    def run_prefill():
        state["cache"] = prefill(params, data)[1]

    def run_decode():
        for i in range(4):
            decode(params, tokens[:, i:i + 1], state["cache"], SERVE_PROMPT + i)

    out = {"prefill": _profiled(run_prefill), "decode_4_steps": _profiled(run_decode)}
    for tag, rec in out.items():
        busy = rec["device_busy_ms"]
        print(f"[serve-profile] {tag}: wall_ms={rec['wall_ms']:.3f} device_busy_ms="
              + (f"{busy:.3f} busy_share={busy / rec['wall_ms']:.4f}" if busy is not None
                 else "not measured (no device events)"), flush=True)
        for t in rec["top"]:
            print(f"[serve-profile]   {t['ms']:9.3f} ms  x{t['launches']:<5d} {t['name']}")
    return out

#: device-event names of this port's kernels (always listed by the profile)
KERNEL_LABELS = ("affinity_kernel", "power_step_kernel", "kmeans_assign_kernel",
                 "streaming_matmat_kernel", "streaming_degree_kernel", "gram_",
                 "row_topk_kernel", "liveness_kernel", "bs_matmat_kernel",
                 "bs_streaming_matmat_kernel", "bs_streaming_degree_kernel")
#: the power loop's sweeps of an r = 2 run, on either engine and route
SWEEP_R2 = re.compile(r"(power_step|bs_matmat|streaming_matmat|bs_streaming_matmat)_kernel<2")


def _kernel_label(name: str) -> str:
    """A device event's name, shortened to its function (and template)."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    return name.split("(")[0][:90]


def _busy_us(spans, lo=float("-inf"), hi=float("inf")):
    """Microseconds of the union of the device spans, clipped to [lo, hi)."""
    busy, reach = 0.0, float("-inf")
    for start, end, _ in spans:
        start, end = max(start, lo, reach), min(end, hi)
        if end > start:
            busy += end - start
        reach = max(reach, min(end, hi))
    return busy


def _device_spans(prof):
    """(start, end, kernel label) of a profile's device events, in time
    order."""
    from torch.autograd import DeviceType
    return sorted((ev.time_range.start, ev.time_range.end, _kernel_label(ev.name))
                  for ev in prof.events() if ev.device_type == DeviceType.CUDA)


def _by_kernel(spans):
    """[(label, [launches, device ms]), ...], the most device time first."""
    by_name: dict[str, list] = {}
    for start, end, label in spans:
        entry = by_name.setdefault(label, [0, 0.0])
        entry[0] += 1
        entry[1] += (end - start) / 1e3
    return sorted(by_name.items(), key=lambda kv: -kv[1][1])


def _stages(spans):
    """Device busy ms of a graph run's stages, cut at kernel boundaries of
    the timeline: pass 1 (to the last row_topk launch), the build (to the
    first r = 2 sweep, the power loop's first), the power sweeps (to the
    first k-means assignment), k-means (to the last assignment) and the
    component probe (the rest)."""
    def last_end(label):
        ends = [e for _, e, lab in spans if lab.startswith(label)]
        return max(ends) if ends else None
    km = [st for st, _, lab in spans if lab.startswith("kmeans_assign_kernel")]
    t0 = spans[0][0]
    cuts = [("pass1", last_end("row_topk_kernel") or t0),
            ("build", min(st for st, _, lab in spans if SWEEP_R2.match(lab))),
            ("sweeps", min(km)),
            ("kmeans", last_end("kmeans_assign_kernel")),
            ("probe", spans[-1][1] + 1.0)]
    out, lo = {}, t0
    for name, hi in cuts:
        out[name] = _busy_us(spans, lo, hi) / 1e3
        lo = hi
    return out


def phase_profile(report, out_dir, engine, tag="classic", cfg=None):
    """One more main-path run of ``engine`` under torch.profiler, after the
    counted one: device busy share of the wall time and device time by
    kernel, and for a graph run the time of each stage. The trace of a
    classic run goes to chiprun_out/e2e_<engine>_trace.json; a graph run's
    (tens of thousands of events, past what chiprun_out may carry back) is
    summarized only."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import GPICConfig, dataset_by_name, run_gpic
    x, _, k = dataset_by_name("gaussians", N_MAIN, seed=0)
    if cfg is None:
        cfg = GPICConfig(engine=engine, affinity_kind="rbf", sigma=SIGMA, max_iter=400)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_gpic(x, k, cfg).labels.cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3
    name = engine if tag == "classic" else f"{tag}_{engine}"
    if tag == "classic":
        prof.export_chrome_trace(os.path.join(out_dir, f"e2e_{name}_trace.json"))
    spans = _device_spans(prof)
    busy_us = _busy_us(spans)
    top = [(label, v) for i, (label, v) in enumerate(_by_kernel(spans))
           if i < 10 or label.startswith(KERNEL_LABELS)]
    key = f"profile_{name}"
    if not spans:
        print(f"[profile] {tag} {engine} wall_ms={wall_ms:.3f}: the profiler recorded no "
              "device events; device time not measured", flush=True)
        report[key] = dict(wall_ms=wall_ms, device_busy_ms=None)
        return
    print(f"[profile] {tag} {engine} wall_ms={wall_ms:.3f} device_busy_ms={busy_us / 1e3:.3f} "
          f"busy_share={busy_us / 1e3 / wall_ms:.4f} device_events={len(spans)}", flush=True)
    for label, (count, ms) in top:
        print(f"[profile]   {ms:9.3f} ms  x{count:<4d} {label}")
    stages = _stages(spans) if tag != "classic" else None
    if stages is not None:
        stages["idle"] = wall_ms - busy_us / 1e3
        print("[profile] " + tag + " stages (device busy ms; idle = wall - busy): "
              + " ".join(f"{name}={ms:.3f}" for name, ms in stages.items()), flush=True)
    report[key] = dict(wall_ms=wall_ms, device_busy_ms=busy_us / 1e3, device_events=len(spans),
                       stages=stages,
                       top=[dict(name=l, launches=c, ms=ms) for l, (c, ms) in top])


SOURCES = {
    "affinity_and_degree": ("src/repro_torch/kernels/csrc/affinity.cu",
                            "src/repro/kernels/affinity.py:182"),
    "degree_normalized_matmat": ("src/repro_torch/kernels/csrc/power_step.cu",
                                 "src/repro/kernels/power_step.py:77"),
    "kmeans_assign": ("src/repro_torch/kernels/csrc/kmeans_assign.cu",
                      "src/repro/kernels/kmeans_assign.py:39"),
    "streaming_matmat": ("src/repro_torch/kernels/csrc/streaming.cu",
                         "src/repro/kernels/streaming.py:148"),
    "streaming_degree": ("src/repro_torch/kernels/csrc/streaming.cu",
                         "src/repro/kernels/streaming.py:277"),
    "gram": ("src/repro_torch/kernels/csrc/gram.cu", "src/repro/kernels/gram.py:41"),
    "row_topk": ("src/repro_torch/kernels/csrc/row_topk.cu",
                 "src/repro/kernels/row_topk.py:126"),
    "block_liveness": ("src/repro_torch/kernels/csrc/block_sparse.cu",
                       "src/repro/kernels/block_sparse.py:436"),
    "block_sparse_matmat": ("src/repro_torch/kernels/csrc/block_sparse.cu",
                            "src/repro/kernels/block_sparse.py:105"),
    "block_sparse_streaming_matmat": ("src/repro_torch/kernels/csrc/block_sparse.cu",
                                      "src/repro/kernels/block_sparse.py:210"),
    "block_sparse_streaming_degree": ("src/repro_torch/kernels/csrc/block_sparse.cu",
                                      "src/repro/kernels/block_sparse.py:339"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:80"),
}


def main() -> int:
    t_start = time.perf_counter()
    smi = phase_device()
    report = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0)}
    report["build_s"], logs = phase_build()
    kernels = {}
    phase_affinity(kernels)
    phase_power_step(kernels)
    phase_kmeans_assign(kernels)
    phase_streaming(kernels)
    phase_gram(kernels)
    phase_row_topk(kernels)
    phase_policy(kernels)
    phase_block_sparse(kernels)
    phase_flash_attention(kernels, logs.get("flash_attention", ""))
    # each kernel's launches come from the run of the path that uses it
    explicit = phase_end_to_end(report)
    counts = {name: explicit[0][name] for name in
              ("affinity_and_degree", "degree_normalized_matmat", "kmeans_assign")}
    streaming = phase_streaming_e2e(report, explicit)
    counts.update({name: streaming[name] for name in ("streaming_matmat", "streaming_degree")})
    del explicit
    phase_past_memory(report)
    counts["gram"] = phase_orthogonal(report)
    phase_ensemble(report)
    graph, dense_runs = phase_graph_e2e(report)
    counts["row_topk"] = graph["E1"][0]["launches"]["row_topk"]
    bs_runs = phase_block_sparse_e2e(report, dense_runs)
    del dense_runs
    explicit_e1, streaming_e1 = (rec["launches"] for rec in bs_runs["E1"])
    counts["block_sparse_matmat"] = explicit_e1["block_sparse_matmat"]
    counts.update({name: streaming_e1[name] for name in (
        "block_liveness", "block_sparse_streaming_matmat", "block_sparse_streaming_degree")})
    phase_reorder(report)
    phase_serve_parity(report)
    counts["flash_attention"] = phase_serve(report)["flash_attention"]
    check(all(counts[name] > 0 for name in SOURCES), f"a kernel was never launched: {counts}")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    phase_profile(report, out_dir, "explicit")
    phase_profile(report, out_dir, "streaming")
    phase_profile(report, out_dir, "explicit", tag="E1",
                  cfg=_graph_cfg(E1_SPEC, engine="explicit", embedding="orthogonal",
                                 n_vectors=2))
    for tag, spec in (("E1", E1_SPEC), ("E2", E2_SPEC)):
        for engine in ("explicit", "streaming"):
            phase_profile(report, out_dir, engine, tag=f"{tag}_block_sparse",
                          cfg=_graph_cfg(spec, engine=engine, embedding="orthogonal",
                                         n_vectors=2, block_sparse=True))
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": counts[name],
         "max_abs_err": kernels[name]["max_abs_err"], "ms": kernels[name]["ms"],
         "plain_ms": kernels[name]["plain_ms"], "bound_ms": kernels[name]["bound_ms"],
         "bound_by": kernels[name]["bound_by"], "library_ms": kernels[name]["library_ms"]}
        for name in SOURCES]}
    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, "chip_smoke_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"[done] total_s={report['total_s']:.1f}")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
