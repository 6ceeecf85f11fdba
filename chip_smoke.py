#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of GPIC on one CUDA card, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

  0. device     require a CUDA card; print its name and power limit.
  1. build      compile the kernels from src/repro_torch/kernels/csrc with
                nvcc (one process per source, all started together).
  2. kernels    hold each kernel against its plain PyTorch version on the
                card, at the main path's shapes (n = 45,000 points of the
                paper's 2-D gaussians, m = 2, r = 1, k = 4 on a 1-D
                embedding) and at ragged ones (n = 1,037, m = 16, r = 4, an
                off-diagonal stripe, planted k-means ties); time the kernel,
                the plain version and, where one exists, the one PyTorch
                call that computes the same function.
  3. end to end run_gpic on gaussians at n = 2,000 on the card against the
                same call on the CPU (the plain versions), then at the
                paper's n = 45,000 with the launch counters reset just
                before: ARI against the ground truth >= 0.99, and every
                kernel of the path launched (affinity once, the sweep once
                per power iteration, the assignment kmeans_iters + 1 times).
  4. profile    one more n = 45,000 run under torch.profiler: the device's
                busy share of the wall time and device time by kernel.

The last lines are one JSON object with every kernel's numbers, the card's
name and power limit from nvidia-smi, and the result object
``{"ok": true, "device": {...}}``. The full report also goes to
chiprun_out/chip_smoke_report.json.
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

import torch  # noqa: E402

N_MAIN = 45_000         # the paper's dataset size
SIGMA = 0.3             # the paper's bandwidth for gaussians
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores, H100 SXM
A_ATOL = 1e-6           # affinity entries
D_RTOL = 1e-5           # degrees, relative to the row's absolute mass
U_RTOL, U_ATOL = 1e-5, 1e-7  # power-sweep output; atol scales with max|U_ref|
KM_RTOL = 1e-5          # assignment distances (labels must be exact)


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


def phase_build() -> float:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build()
    sec = time.perf_counter() - t0
    print(f"[build] {len(logs)} kernel libraries built in {sec:.2f} s "
          f"into {_build.build_dir()}", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    return sec


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


def _u_errors(u, u_ref):
    """Max |U - U_ref|, and the most by which |U - U_ref| exceeds
    rtol |U_ref| + atol max|U_ref| (<= 0 where the kernel agrees)."""
    diff = (u - u_ref).abs()
    atol = U_ATOL * float(u_ref.abs().max())
    return float(diff.max()), float((diff - U_RTOL * u_ref.abs()).max() - atol)


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
    del a, d, u, u_ref
    torch.cuda.empty_cache()

    # ragged rows, r up to the kernel's limit, a stripe, a zero-degree row
    g = torch.Generator(device="cuda").manual_seed(2)
    xs = torch.randn((1037, 16), generator=g, device="cuda") * 0.25
    a, d = affinity_and_degree(xs, kind="rbf", sigma=1.1)
    a[5] = 0.0
    d[5] = 0.0
    for r in (4, 32):
        vs = torch.rand((1037, r), generator=g, device="cuda")
        for rows in (slice(None), slice(100, 400)):
            ar, dr = a[rows].contiguous(), d[rows].contiguous()
            u = degree_normalized_matmat(ar, vs, dr)
            u_ref = ref.degree_normalized_matmat_ref(ar, vs, dr)
            abs_err, excess = _u_errors(u, u_ref)
            print(f"[power_step] ragged a{tuple(ar.shape)} r={r}: max|U-U_ref|={abs_err:.3e} "
                  f"excess over tolerance={excess:.3e}")
            check(excess <= 0.0, f"power step disagrees at r={r}")
            worst = max(worst, abs_err)
        check(bool((degree_normalized_matmat(a, vs, d)[5] == 0).all()),
              "a zero-degree row must give an exact zero")
    report["degree_normalized_matmat"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                              bound_ms=b, bound_by=by, max_abs_err=worst,
                                              main_shape=main_err)


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


def phase_end_to_end(report):
    from repro_torch import GPICConfig, adjusted_rand_index, dataset_by_name, run_gpic
    from repro_torch.kernels import ops
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_gpic(x, k, cfg)
    labels = res.labels.cpu().numpy()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    sweeps = int(res.n_iter)
    ari = adjusted_rand_index(y, labels)
    emb = res.embedding
    print(f"[e2e] gaussians n={N_MAIN} rbf sigma={SIGMA}: wall_s={wall:.4f} sweeps={sweeps} "
          f"converged={bool(res.converged)} ARI={ari:.4f} peak_mem_GB={peak / 1e9:.3f} "
          f"launches={counts} health: {res.health.summary()}", flush=True)
    check(labels.shape == (N_MAIN,) and bool(torch.isfinite(emb).all())
          and emb.shape == (N_MAIN,), "the result has the wrong shape or is not finite")
    check(ari >= 0.99, f"ARI {ari:.4f} < 0.99")
    check(counts["affinity_and_degree"] == 1, f"affinity launched {counts}")
    check(counts["degree_normalized_matmat"] == sweeps, f"sweep launches {counts} vs {sweeps}")
    check(counts["kmeans_assign"] == cfg.kmeans_iters + 1, f"assignment launched {counts}")
    report["e2e"] = dict(n=N_MAIN, wall_s=wall, sweeps=sweeps, ari=ari,
                         peak_mem_bytes=peak, launches=counts)
    return counts


#: device-event names of this port's kernels (always listed by the profile)
KERNEL_LABELS = ("affinity_kernel", "power_step_kernel", "kmeans_assign_kernel")


def _kernel_label(name: str) -> str:
    """A device event's name, shortened to its function (and template)."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    return name.split("(")[0][:90]


def phase_profile(report, out_dir):
    """One more main-path run under torch.profiler, after the counted one:
    device busy share of the wall time and device time by kernel. The
    trace goes to chiprun_out/e2e_trace.json."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import GPICConfig, dataset_by_name, run_gpic
    x, _, k = dataset_by_name("gaussians", N_MAIN, seed=0)
    cfg = GPICConfig(affinity_kind="rbf", sigma=SIGMA, max_iter=400)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_gpic(x, k, cfg).labels.cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(os.path.join(out_dir, "e2e_trace.json"))
    spans = sorted((ev.time_range.start, ev.time_range.end, _kernel_label(ev.name))
                   for ev in prof.events() if ev.device_type == DeviceType.CUDA)
    busy_us, reach = 0.0, float("-inf")
    by_name: dict[str, list] = {}
    for start, end, label in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        entry = by_name.setdefault(label, [0, 0.0])
        entry[0] += 1
        entry[1] += (end - start) / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    top = [(label, v) for i, (label, v) in enumerate(ranked)
           if i < 10 or label.startswith(KERNEL_LABELS)]
    if not spans:
        print(f"[profile] wall_ms={wall_ms:.3f}: the profiler recorded no device "
              "events; device time not measured", flush=True)
    else:
        print(f"[profile] wall_ms={wall_ms:.3f} device_busy_ms={busy_us / 1e3:.3f} "
              f"busy_share={busy_us / 1e3 / wall_ms:.4f} device_events={len(spans)}",
              flush=True)
        for label, (count, ms) in top:
            print(f"[profile]   {ms:9.3f} ms  x{count:<4d} {label}")
    report["profile"] = dict(wall_ms=wall_ms, device_busy_ms=busy_us / 1e3,
                             device_events=len(spans),
                             top=[dict(name=l, launches=c, ms=ms) for l, (c, ms) in top])


SOURCES = {
    "affinity_and_degree": ("src/repro_torch/kernels/csrc/affinity.cu",
                            "src/repro/kernels/affinity.py:182"),
    "degree_normalized_matmat": ("src/repro_torch/kernels/csrc/power_step.cu",
                                 "src/repro/kernels/power_step.py:77"),
    "kmeans_assign": ("src/repro_torch/kernels/csrc/kmeans_assign.cu",
                      "src/repro/kernels/kmeans_assign.py:39"),
}


def main() -> int:
    t_start = time.perf_counter()
    smi = phase_device()
    report = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0)}
    report["build_s"] = phase_build()
    kernels = {}
    phase_affinity(kernels)
    phase_power_step(kernels)
    phase_kmeans_assign(kernels)
    counts = phase_end_to_end(report)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    phase_profile(report, out_dir)
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
