#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of GPIC, and of its LM substrate's serving
(every family) and dense training paths, on one CUDA card, end to end.

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
                sweep's cp.async ring bitwise its plain-load template, and
                its single-vector wrappers (degree_normalized_matvec
                bitwise column 0 of the mat-mat, power_step against its
                plain version, each launching #2 once); time the
                kernel, the plain version and, where one exists, the one
                PyTorch call that computes the same function. The streamed
                D and U must be bitwise the explicit kernels' D and U. The
                Gram (#4) must give the same bits on every call, be exactly
                symmetric and take one kernel launch a call (the profiler's
                device events), at the loop's V (45,000, 2) and [V | U]
                (45,000, 4), both timed, and at ragged n = 255, 256, 257 and
                1,037. The k-means assignment (#3) also on a NaN centroid
                (the first NaN wins, with its NaN), a NaN point, Inf
                points, x off 16-byte alignment, dim 2 and 4 at n = 45,000
                and k = 256 of dim 128: its small form (dim <= 8) must give
                its general form's bits (zero feature columns appended),
                and it is timed beside the launch floor (the device time
                of fill_ on one float). The row top-k (#7, pass 1
                of the graph policies) must equal torch.topk of the plain
                scores at the main shape for K = 1..64, both stats, with and
                without adaptive scales, and its register template (m <= 2,
                each warp owning 8 rows and their lists) must give its
                staged template's bits (x with a zero feature column) there
                and at ragged and below-diagonal stripes, both timed, with
                no spill in nvcc's report; with the kNN and adaptive operands
                of E1 and E2, A must be bitwise its plain version's, the
                streamed D and U bitwise the explicit kernels', the
                column-thresholded product the transpose of the stored A,
                and every row must keep knn_k entries (more only on a tie
                at its threshold).
                The block-sparse kernels (#8-#11) with E1's and E2's operands:
                the live map equal to dense_block_live of the thresholded A,
                the sweeps and the degree bitwise their dense twins (#2, #5,
                #6, #1's D), the fused one-pass build bitwise the two-pass
                build; ragged and off-diagonal stripes at m = 16; a NaN in V
                reaching exactly the rows whose plan lists its tile. The
                stored sweep (#9) bitwise #2 and its own plain-load
                template (A shifted one element off 16 bytes) at r = 1, 2,
                4, 8, 16 and 32, both templates timed.
                The affinity build (#1), the streamed sweeps (#5, #10),
                the streamed degrees (#6, #11) and the liveness pass (#8)
                have a register template (m <= 2) beside the staged-slab
                one (any m): x must give the same bits as x with zero
                feature columns appended to m = 3, which takes the staged
                template, at the main shape (r = 1, 2, d given and None,
                thr, thr_c; #1 dense in every kind, E1's and E2's thr and
                E2's scales alone, the fused build's form; #6 dense, E1
                and E2; #8 and #11 E1 and E2) and at ragged stripes (rows
                after the columns too, row counts off TM, at m = 16 and 2;
                #1, #6, #8 and #11 also with kNN thresholds at entries of
                their rows), and both are timed in the same run, with each
                template's registers from nvcc's report, kept beside each
                library (it fails on a spill of a register template at
                r <= 2, or of #1's, #6's, #8's or #11's, or where the
                report names none). The kernels that take one expf an
                entry (#1, #5-#8, #10, #11) print a second floor beside
                their bound: entries / (SMs x 16 MUFU x clock). The
                register templates of #1, #6, #8 and #11 skip the expf of
                entries provably under their row's threshold (#1 stores
                them as 0): the share they still make with it is counted
                from the stored A (over the live tiles for #11), and their
                bound and floor count that work.
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
                Kernel 12's backward (csrc/flash_attention_bwd.cu: D, dK/dV,
                dQ) and the forward's row log-sum-exp L against the plain
                backward at the training shape (b = 2, h = kv = 32,
                s = 1,024, d = 80, causal, f32), the serve mix, GQA rep 4
                d = 120 full and causal, rows off 16-byte alignment and the
                (f32, f32), (f32, bf16), (bf16, bf16) pairs (f32 gradients
                within 1e-5 of their max, bf16 ones within 2^-6); the
                forward's output the same bits with and without L; the
                gradients the same bits on a second call and through the
                autograd Function; each kernel timed beside its plain
                version (D also beside torch.linalg.vecdot) and bounded by
                the products it computes, as split-TF32 terms at the TF32
                rate and on the f32 FMA units; the whole backward timed
                beside the plain backward and SDPA's backward and bounded by
                its five distinct products; no template spills at d = 80,
                120 and 128.
                bf16 A storage (the reference's a_dtype=bfloat16, O4) in
                #1, #2 and #9, at the main shape and on ragged stripes
                (m = 16 and 2, 1,037, 1,032, 900 and 737 columns: the bulk
                stores and the cp.async ring need n_cols % 8 == 0 in bf16):
                #1's bf16 A bitwise its f32 A rounded and its plain
                version's (within one bf16 ulp at m = 16, whose f32
                entries differ by rounding), its D bitwise the f32 call's
                D, dense and with E1's thresholds; #2's and #9's U bitwise the same kernel on
                a.float(), #2's ring bitwise its plain-load template, #9
                (its ring: bf16 rows on 16 bytes) bitwise #2 on the same
                A and its plain-load template in f32 and bf16 at every r
                bucket, at E1 and on the stripes (their plan, every third
                row block emptied, every tile live), each within its
                tolerance of its plain version; the bf16 A's live tiles those of the f32
                A; no spill in a bf16 template of #2 or #9 at r <= 2; each
                timed against its bf16 bound (A at 2 bytes an entry).
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
                - the resumable supervisor on the explicit run's config
                  (checkpoint_every=5): a fault injected at sweep 10 and a
                  kill followed by a fresh call both give the explicit
                  run's result bit for bit (notes retry, resumed:10); a
                  straggler timeout raises StragglerTimeout; the
                  supervised and monolithic walls; the checkpoint overhead
                  at the reference robustness job's shape (n = 1,024,
                  50 sweeps, a snapshot every 25), recorded against its 5%
                  budget;
                - the paper-faithful oracle path on the main config:
                  pic_reference (plain A and W on the card, W @ V in
                  cuBLAS) and pic_from_affinity on #1's A against the
                  explicit run (sweeps within 1, max|dv|/max|v| <= 1e-4,
                  ARI >= 0.99, #3 the only kernel, 26 times), its peak
                  memory printed; affinity_chunked (4,096-row stripes)
                  within A_ATOL of #1's A;
                - the matrix-free engine (cosine_shifted gaussians): its
                  factored product against #1's stored A times V at
                  n = 45,000, r = 1, 2 (the reference test's 2e-4 / 1e-4,
                  scaled by max|A V|); run_gpic on it against the explicit
                  engine there (sweeps within 1, embedding within atol
                  1e-6 rtol 1e-4); quickstart's n = 100,000, k = 3,
                  max_iter=50 as pic and as the orthogonal r = 2 block:
                  peak memory under 1 GB, #3 kmeans_iters + 1 times, #4
                  once a QR sweep, no other kernel;
                - the paper's Table 2 comparison at n = 10,000: serial
                  float64 numpy PIC (its stage times) against run_gpic on
                  the card (its wall), the ratio printed; the serial
                  embedding within 1e-4 of max|v| of pic_from_affinity's,
                  ARI >= 0.99 for both;
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
                - bf16 A (a_dtype=torch.bfloat16): explicit gaussians at
                  n = 45,000, ARI >= 0.99, sweeps within one of the f32
                  run's, peak memory at most 0.55 of the f32 run's, #1 once
                  and #2 once a sweep; E1 block-sparse: the bf16 fused
                  build's live tiles and D those of the f32 build (its
                  transient peak printed), the components of the f32 run,
                  #9 once a sweep and probe hop;
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
                  steps profiled;
                - the dense LM trainer (launch/train.py's path): stablelm-3b
                  at its published widths, all 32 layers, 3 steps of 2 x
                  1,024 tokens (f32, remat="full", AdamW, z-loss): finite
                  losses, kernel 12 twice a layer forward and its three
                  backward kernels once a layer, ms a step, peak memory and
                  a profile by stage; 2 layers against the same step with
                  the attention through its plain versions (every gradient
                  leaf within 1e-4 of its max, the parameters after it); the
                  train_lm example through RestartableLoop with a failure at
                  step 3, bitwise the uninterrupted run; h2o-danube-3-4b at
                  its widths, 2 layers, forward and backward at s = 6,144
                  past its window, layer 0's attention and gradients
                  against float64;
                - the sharded LM step (build_train_step under
                  axis_rules(rules, mesh=mesh)): the same stablelm-3b
                  steps on a 1 x 1 ("data", "model") DeviceMesh over a
                  1-rank NCCL group, each loss and the parameters after 3
                  steps bit for bit the one-device step's, kernel 12's
                  launches exact, ms a step, peak and busy share; with
                  four cards, also on meshes (1, 4) and (2, 2), one card a
                  rank (phase_four_ranks); granite-34b and qwen1.5-4b at 4
                  layers under their rules for 8 model ranks (an attention
                  activation whole), bit for bit one device's, and with
                  four cards granite under its default rules;
                - the other families (FAMILY_ARCHS): mamba2-780m,
                  zamba2-2.7b, seamless-m4t-large-v2, paligemma-3b and
                  deepseek-v2-lite-16b at full width cut in depth, batch
                  2, a prompt of 100, on the card against the CPU, then
                  each served at a quarter of its depth (4 x 2,048 prompt tokens, 32
                  generated; kernel 12's launches exact), deepseek's
                  routing counted (copies dropped past the capacity,
                  tokens at a router near-tie); deepseek's routed experts
                  alone at the decode and prefill shapes under
                  torch.cuda.set_sync_debug_mode("error"), the decode
                  shape against the CPU; llama4-maverick-400b-a17b at
                  published widths, 2 of 48 layers (74 GB, the card
                  alone), 1 x 1,024 prompt tokens and 8 generated: kernel
                  12 once a layer in the prefill, the logits against the
                  same weights through the plain attention;
                - the sharded serve steps (build_prefill and
                  build_decode_step under axis_rules(rules, mesh=mesh)) on
                  a 1 x 1 mesh over a 1-rank NCCL group, each against one
                  device's prefill and decode of the same 4 x 512 prompt
                  tokens and 16 steps: llama4 (2 layers) and granite-34b
                  (4 layers) from one device's cache, stablelm-3b and the
                  five families above at FAMILY_ARCHS's depth through the
                  sharded prefill (kernel 12's launches one device's),
                  granite-34b and qwen1.5-4b under their rules for 8 model
                  ranks too, with four cards also on meshes (1, 4) and
                  (2, 2).
  4. profile    one more n = 45,000 run of each engine under torch.profiler:
                the device's busy share of the wall time and device time by
                kernel and the k-means stage; and the graph runs E1
                (explicit, block_sparse=False), E1 and E2 block-sparse
                on both engines and E1 block-sparse explicit in bf16, each
                cut into its stages (pass 1, build, sweeps, k-means, probe,
                idle).

Each phase's seconds are printed on a line of their own ("[phase] ...")
and kept in the report's ``phase_s``.

The last lines are one JSON object with every kernel's numbers (rows 1, 2
and 9 with their bf16 forms' too: ``bf16_ms``, ``bf16_bound_ms``,
``bf16_launches`` from the bf16 runs, ...), the card's name and power
limit from nvidia-smi, and the result object
``{"ok": true, "device": {...}}``. The full report also goes to
chiprun_out/chip_smoke_report.json, the traces to chiprun_out/e2e_*.json.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import math
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
N_MF = 100_000          # examples/quickstart.py's matrix-free run
N_SERIAL = 10_000       # serial PIC: its float64 A and W take 1.6 GB of host memory
SIGMA = 0.3             # the paper's bandwidth for gaussians
ORTHO_ARI_FLOOR = 0.90  # the reference's floor for three_circles, orthogonal
MEM_LIMIT = 1e9         # peak device bytes of a streaming run
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores, H100 SXM
H100_TF32_FLOPS = 495e12     # TF32 on the tensor cores, dense, H100 SXM
MUFU_PER_CLOCK = 16          # MUFU (expf's EX2) results per clock per SM, Hopper
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


TRACES = 3                  # device_events' tries at a trace the profiler lost


def device_events(fn, reps: int) -> list[tuple[str, float]]:
    """(name, device ms) of every device event that torch.profiler records
    over ``reps`` calls of ``fn``, after one warm-up call. The trace opens
    with a marker kernel (torch.cuda._sleep's spin_kernel, left out of the
    result): the profiler can miss the first kernel of a trace. A trace
    with no device event at all, the marker's neither, was lost by the
    profiler (seen once in a whole-script run): it is taken again, up to
    TRACES times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(TRACES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
        if events:
            break
    return [(ev.name, ev.time_range.elapsed_us() / 1e3) for ev in events
            if "spin_kernel" not in ev.name]


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of ``fn`` over ``reps`` calls after
    one warm-up call: the summed durations of the device events that
    torch.profiler records, so host time between launches is left out."""
    spans = device_events(fn, reps)
    check(bool(spans), "the profiler recorded no device events")
    return sum(ms for _, ms in spans) / reps


def register_m() -> int:
    """tile::MR, the widest feature count of the register templates of #1,
    #5-#8, #10 and #11, as csrc/affinity_tile.cuh defines it: a wider x takes the
    staged template."""
    with open(os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                           "affinity_tile.cuh")) as f:
        hit = re.search(r"constexpr int MR = (\d+);", f.read())
    check(hit is not None, "affinity_tile.cuh defines no MR")
    return int(hit.group(1))


def widened(x, width):
    """x with zero feature columns appended up to ``width``. A zero feature
    changes no fmaf chain or norm beyond the sign of an exact zero, which
    torch.equal ignores, so a kernel must give the same bits on x and on
    widened(x): #3 past small_dim() takes its general form (16-byte rows
    at width % 4 == 0, its cp.async16 staging, else the 4-byte one);
    staged() sends the affinity family to its staged template."""
    return torch.nn.functional.pad(x, (0, max(0, width - x.shape[1])))


def staged(x):
    """x (None stays None) widened to register_m() + 1, which sends #1,
    #5-#8, #10 and #11 to their staged template: the two templates must
    agree bit for bit on x and on staged(x)."""
    return None if x is None else widened(x, register_m() + 1)


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """Least time on an H100 SXM for the work: bytes over the memory rate
    or f32 operations over the f32 rate, whichever is larger."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_flops / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@functools.lru_cache(maxsize=None)
def _mufu_per_s() -> float:
    """The card's MUFU rate: SMs x MUFU_PER_CLOCK x the SM's maximum clock
    (nvidia-smi clocks.max.sm)."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * MUFU_PER_CLOCK * float(mhz) * 1e6


def mufu_bound_ms(entries: float) -> float:
    """The second floor of a kernel that takes one expf (one MUFU.EX2) per
    entry it makes: entries / (SMs x 16 x clock)."""
    return entries / _mufu_per_s() * 1e3


def expf_shares(a_raw, thr, stripe=4096, live=None) -> tuple[float, float]:
    """(passing, made): the shares of the stripe's entries (``live``, an
    (nI, nJ) map on the (16, 256) grid: of the entries in its live tiles)
    whose exponent the skip test of the register templates of #1, #6, #8
    and #11 cannot drop, and of those the kernel makes with their expf,
    counted from the unthresholded A ``a_raw`` and the row thresholds
    ``thr``. An entry passes where it is at or above thr_i exp(-2^-16
    (|ln thr_i| + 1)), the test's cutoff (to within the test's own
    margins); the kernel makes all 32 entries of a row in a warp (32
    columns from column 0) where one passes."""
    n_rows, n_cols = a_raw.shape
    log_thr = thr.double().log()
    floor = (log_thr - (log_thr.abs() + 1.0) * 2.0 ** -16).exp().float()
    tile_of_warp = torch.arange(-(-n_cols // 32), device=a_raw.device) // 8
    passing = made = 0.0
    for r0 in range(0, n_rows, stripe):
        need = (a_raw[r0:r0 + stripe] >= floor[r0:r0 + stripe, None]).to(torch.uint8)
        need = torch.nn.functional.pad(need, (0, -n_cols % 32))
        need = need.view(need.shape[0], -1, 32)
        if live is not None:      # a multiple of 16 rows a stripe
            rows_live = live[r0 // 16:-(-(r0 + need.shape[0]) // 16)].repeat_interleave(16, 0)
            need = need * rows_live[:need.shape[0], tile_of_warp, None].to(torch.uint8)
        passing += float(need.sum(dtype=torch.float64))
        made += 32.0 * float(need.amax(dim=2).sum(dtype=torch.float64))
    entries = n_rows * n_cols if live is None else _plan_entries(live, n_rows, n_cols)
    return passing / entries, made / entries


def skip_flops(entries: float, m: int, made: float, adaptive: bool) -> float:
    """Operations of the register templates of #1, #6, #8 and #11 with the
    skip test over ``entries`` entries, of which the ``made`` share is made
    exactly: per entry the dot product (2m), d2 (3) and the test (1; with
    adaptive scales 2, the row's bound times the column's scale); per entry
    made, the clamp, the scale (adaptive: the product of the scales, then
    the divide), the expf, the threshold compare and the sum or OR (5;
    adaptive 6)."""
    a = 1 if adaptive else 0
    return entries * (2 * m + 4 + a + made * (5 + a))


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
    report of each library (kept beside it where it was built before)."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build()
    sec = time.perf_counter() - t0
    print(f"[build] {len(built)} kernel libraries built in {sec:.2f} s "
          f"into {_build.build_dir()}", flush=True)
    logs = {name: _build.report(name) for name in _build.SOURCES}
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


def phase_affinity(report, build_log=""):
    """Kernel #1 against its plain version (A bitwise) at the main shape in
    every kind, its register template (m <= 2) bitwise its staged template
    there (A and D; both timed for rbf, the main path's call), and ragged
    stripes at m = 16. ``build_log`` is nvcc's report of affinity.cu: the
    register template may not spill."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.affinity import affinity_and_degree
    registers = entry_registers(build_log, "affinity")
    for tmpl, line in registers.items():
        print(f"[affinity] affinity_kernel {tmpl}: {line}")
    check_no_entry_spill("#1", registers, tuple(
        f"{form}{dtype}" for form in ("fixed", "policy", "fixed bulk", "policy bulk")
        for dtype in ("", " bf16")))
    feats, _, _ = _features(N_MAIN)
    n, m = feats["rbf"].shape
    worst_a = worst_d = 0.0
    main = None
    for kind in ("cosine", "cosine_shifted", "rbf"):
        x = feats[kind]
        a, d = affinity_and_degree(x, kind=kind, sigma=SIGMA)
        torch.cuda.synchronize()
        err_a, err_d = _stripe_errors(a, d, x, kind, SIGMA)
        a_st, d_st = affinity_and_degree(staged(x), kind=kind, sigma=SIGMA)
        same = torch.equal(a, a_st) and torch.equal(d, d_st)
        del a_st, d_st
        print(f"[affinity] n={n} m={m} {kind}: max|A-A_ref|={err_a:.3e} "
              f"max|D-D_ref|/mass={err_d:.3e}; register template = staged template: {same}",
              flush=True)
        check(err_a <= A_ATOL and err_d <= D_RTOL, f"affinity {kind} disagrees")
        # the shared tile code (affinity_tile.cuh) rounds as the plain
        # version does, one step at a time: A is its bits exactly
        check(err_a == 0.0, f"affinity {kind}: A is not bitwise the plain version's")
        check(same, f"affinity {kind}: the register template's A and D are not bitwise the "
              "staged template's")
        worst_a, worst_d = max(worst_a, err_a), max(worst_d, err_d)
        del a, d
        torch.cuda.empty_cache()
        if kind == "rbf":
            ms = cuda_ms(lambda: affinity_and_degree(x, kind=kind, sigma=SIGMA), 5)
            x_st = staged(x)
            staged_ms = cuda_ms(lambda: affinity_and_degree(x_st, kind=kind, sigma=SIGMA), 5)
            plain = cuda_ms(lambda: _plain_affinity_stripes(x, kind, SIGMA), 2)
            b, by = bound_ms(4.0 * (n * m + n * n + n), affinity_flops(n, n, m, kind))
            main = dict(ms=ms, staged_ms=staged_ms, plain_ms=plain, bound_ms=b, bound_by=by,
                        mufu_bound_ms=mufu_bound_ms(n * n))
            print(f"[affinity] n={n} rbf: kernel_ms={ms:.4f} staged_template_ms={staged_ms:.4f} "
                  f"plain_ms={plain:.4f} library_ms=null bound_ms={b:.4f} ({by}) "
                  f"mufu_bound_ms={main['mufu_bound_ms']:.4f}", flush=True)
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
                                         library_ms=None, registers=registers)


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
    wrappers = _single_vector_wrappers(a, v[:, 0].contiguous(), d, u)
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
                                              main_shape=main_err, plain_load_ms=plain_load,
                                              single_vector=wrappers)


def _single_vector_wrappers(a, v, d, u):
    """The paper's single-vector wrappers of #2 at the main shape:
    degree_normalized_matvec must be column 0 of the mat-mat ``u`` (made
    from v as an (n, 1) block) bit for bit, power_step its plain version
    within #2's tolerance, and each must launch #2 once."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.power_step import degree_normalized_matvec, power_step
    ops.reset_launch_counts()
    u1 = degree_normalized_matvec(a, v, d)
    after_matvec = ops.launch_counts()["degree_normalized_matmat"]
    step = power_step(a, v, d)
    after_step = ops.launch_counts()["degree_normalized_matmat"]
    bitwise = torch.equal(u1, u[:, 0])
    abs_err, excess = _u_errors(step, ref.power_step_ref(a, v, d))
    print(f"[power_step] n={a.shape[0]} single vector: degree_normalized_matvec bitwise "
          f"column 0 of the mat-mat={bitwise}; power_step max|V-V_ref|={abs_err:.3e} "
          f"excess over tolerance={excess:.3e}; #2 launches after matvec {after_matvec}, "
          f"after power_step {after_step}", flush=True)
    check(bitwise, "degree_normalized_matvec is not column 0 of the mat-mat bit for bit")
    check(excess <= 0.0, "power_step disagrees with its plain version")
    check(after_matvec == 1 and after_step == 2,
          f"the single-vector wrappers launched #2 {after_matvec}, {after_step} times")
    return dict(matvec_bitwise=bitwise, power_step_max_abs_err=abs_err,
                power_step_excess=excess, launches=after_step)


def small_dim() -> int:
    """SMALL_DIM, the widest dim of #3's small form, as
    csrc/kmeans_assign.cu defines it: a wider x takes the general form."""
    with open(os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                           "kmeans_assign.cu")) as f:
        hit = re.search(r"constexpr int SMALL_DIM = (\d+);", f.read())
    check(hit is not None, "kmeans_assign.cu defines no SMALL_DIM")
    return int(hit.group(1))


def _same_bits(a, b) -> bool:
    """a and b equal element for element, NaN where the other is NaN."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a.masked_fill(nan, 0.0), b.masked_fill(nan, 0.0)))


def _km_errors(xx, cc, lab, dist, terms):
    """(labels agree, NaN and +-Inf in the same places, max|dist - ref| over
    the finite entries, the most by which it exceeds KM_RTOL x scale, the
    points whose labels differ) of #3 against its plain version. The scale
    is |ref|, and with ``terms`` also |x|^2 + |c_label|^2: the expansion's
    three terms round relative to their own size, so where d2 cancels far
    under them its error scales with them. Labels must be equal; with
    ``terms``, a point may take another centroid where the two lie within
    that tolerance of each other (a tie at the rounding level, which two
    orders of summation can resolve either way): the exact (f64) distance
    of the kernel's choice must then lie within the tolerance of the exact
    minimum."""
    from repro_torch.kernels import ref
    lab_ref, dist_ref = ref.kmeans_assign_ref(xx, cc)
    fin = torch.isfinite(dist_ref)
    same_odd = bool(torch.equal(torch.isfinite(dist), fin)) and _same_bits(dist[~fin],
                                                                           dist_ref[~fin])
    scale = dist_ref.abs().double()
    if terms:
        scale = scale + (xx.double() ** 2).sum(1) + (cc.double() ** 2).sum(1)[lab_ref.long()]
    differ = (lab != lab_ref).nonzero()[:, 0]
    labels_ok = differ.numel() == 0
    if terms and not labels_ok:
        exact = ((xx[differ].double()[:, None, :] - cc.double()[None]) ** 2).sum(-1)
        gap = exact.gather(1, lab[differ].long()[:, None])[:, 0] - exact.min(1).values
        labels_ok = bool((gap <= KM_RTOL * scale[differ]).all())
    if not bool(fin.any()):
        return labels_ok, same_odd, 0.0, 0.0, differ.numel()
    diff = (dist - dist_ref).abs()[fin]
    return (labels_ok, same_odd, float(diff.max()),
            float((diff.double() - KM_RTOL * scale[fin]).max()), differ.numel())


def km_registers(log: str) -> dict[str, str]:
    """Registers and spills of each template of #3 in nvcc's report:
    ``{"small d=<dim> <float4|scalar>" or "general <float4|scalar>": ...}``."""
    return ptxas_registers(
        log, r"kmeans_assign_(small|general)_kernelI(?:Li(\d+)E)?Lb(\d)E",
        lambda e: (f"{e.group(1)}{' d=' + e.group(2) if e.group(2) else ''} "
                   f"{'float4' if e.group(3) == '1' else 'scalar'}"))


def phase_kmeans_assign(report, build_log=""):
    """#3 against its plain version: labels exact (on all but the first
    three cases, up to ties at the rounding level, _km_errors), distances
    within KM_RTOL (relative to |d2| on the first three cases, also to the
    expansion's terms on the others), NaN and +-Inf in the same places: the
    main shape, ragged rows, planted ties, a NaN centroid (the first NaN
    wins, with its NaN), a NaN point, Inf points, x off 16-byte alignment,
    dim 2 and 4 at n = 45,000, and k = 256 of dim 128. The small form
    (dim <= small_dim()) must give the general form's bits (widened()),
    and one launch a call; no template may spill (nvcc's report). Timed by
    device events beside the launch floor, the device time of the smallest
    kernel torch launches."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.kmeans_assign import kmeans_assign
    registers = km_registers(build_log)
    for tmpl, line in sorted(registers.items()):
        print(f"[kmeans_assign] {tmpl}: {line}")
    check({"small d=1 float4", "general float4"} <= set(registers),
          f"nvcc's report names no small (d = 1) or general template of #3: {registers}")
    spills = [f"{t}: {line}" for t, line in registers.items()
              if not line.endswith(" 0 bytes spilled")]
    check(not spills, f"a template of #3 spills: {spills}")
    g = torch.Generator(device="cuda").manual_seed(3)
    n, dim, k = N_MAIN, 1, 4
    x = torch.randn((n, dim), generator=g, device="cuda")
    cents = x[torch.randperm(n, generator=g, device="cuda")[:k]].contiguous()
    worst = 0.0
    cases = [("main", x, cents, False)]
    xs = torch.randn((1037, 4), generator=g, device="cuda")
    cases.append(("ragged d=4 k=5", xs, torch.randn((5, 4), generator=g, device="cuda"), False))
    zeros = torch.zeros((1037, 2), device="cuda")
    tie_c = torch.tensor([[3.0, 0.0], [1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]],
                         device="cuda")
    cases.append(("planted ties", zeros, tie_c, False))
    nan, inf = float("nan"), float("inf")
    probe_x = torch.tensor([[0, 0], [1, 1], [nan, 0], [inf, 0], [-inf, 1]], device="cuda")
    probe_c = torch.tensor([[5, 5], [nan, 0], [0.1, 0.1], [1, 1]], device="cuda")
    cases.append(("NaN centroid, probe", probe_x, probe_c, True))
    xn = torch.randn((n, 2), generator=g, device="cuda")
    cn = torch.randn((4, 2), generator=g, device="cuda")
    cn[2, 1] = nan
    cases.append(("NaN centroid", xn, cn, True))
    xp = torch.randn((1037, 2), generator=g, device="cuda")
    xp[7, 1] = nan
    xp[500, 0] = nan
    cases.append(("NaN point", xp, torch.randn((5, 2), generator=g, device="cuda"), True))
    xi = torch.randn((1037, 2), generator=g, device="cuda")
    xi[11] = torch.tensor([inf, 0.0])
    xi[12] = torch.tensor([-inf, 1.0])
    xi[13] = torch.tensor([inf, inf])
    cases.append(("Inf points", xi, torch.randn((5, 2), generator=g, device="cuda"), True))
    cases.append(("unaligned x", x[1:], cents, False))     # 4 bytes off 16: scalar loads
    wide = {}
    for d in (2, 4):
        xd = torch.randn((n, d), generator=g, device="cuda")
        wide[d] = (xd, xd[torch.randperm(n, generator=g, device="cuda")[:k]].contiguous())
        cases.append((f"dim={d}", *wide[d], True))
    cg = torch.randn((256, 128), generator=g, device="cuda")
    own = torch.randint(0, 256, (n,), generator=g, device="cuda")
    xg = cg[own] + 0.7 * torch.randn((n, 128), generator=g, device="cuda")
    cases.append(("k=256 dim=128", xg, cg, True))
    sd = small_dim()
    gen_w = -(-(sd + 1) // 4) * 4        # past the small form, rows of 16 bytes
    for tag, xx, cc, terms in cases:
        lab, dist = kmeans_assign(xx, cc)
        same, same_odd, err, excess, ties = _km_errors(xx, cc, lab, dist, terms)
        odd = int((~torch.isfinite(dist)).sum())
        print(f"[kmeans_assign] {tag} n={xx.shape[0]} d={xx.shape[1]} k={cc.shape[0]}: "
              f"labels agree={same} (differing at {ties} rounding-level ties) "
              f"NaN/Inf in the same places={same_odd} ({odd} entries) "
              f"max|dist-dist_ref|={err:.3e} excess over tolerance={excess:.3e}", flush=True)
        check(same and same_odd and excess <= 0.0, f"kmeans_assign disagrees ({tag})")
        worst = max(worst, err)
        # small against general (both stagings); general float4 against scalar
        widths = (sd + 1, gen_w) if xx.shape[1] <= sd else (xx.shape[1] + 1,)
        for w in widths:
            lab_w, dist_w = kmeans_assign(widened(xx, w), widened(cc, w))
            check(torch.equal(lab_w, lab) and _same_bits(dist_w, dist),
                  f"kmeans_assign at d={xx.shape[1]} and widened to {w} differ ({tag})")
        print(f"[kmeans_assign] {tag}: the same bits widened to d={list(widths)}", flush=True)
        if tag == "planted ties":
            check(bool((lab == 1).all()), "ties must resolve to the first index")
        if tag == "NaN centroid, probe":
            check(lab.tolist() == [1, 1, 0, 0, 1] and bool(dist.isnan().all()),
                  f"the first NaN must win with its NaN: {lab.tolist()} {dist.tolist()}")
        if tag == "NaN centroid":
            check(bool((lab == 2).all()) and bool(dist.isnan().all()),
                  "every point must take the NaN centroid 2 with a NaN distance")
        if tag == "k=256 dim=128":
            check(torch.equal(lab.long(), own), "k=256: a point left its own centroid")
    for xx, cc, form in ((x, cents, "small"), (xg, cg, "general")):
        names = [_kernel_label(name) for name, _ in device_events(
            lambda: kmeans_assign(xx, cc), 5)]
        print(f"[kmeans_assign] d={xx.shape[1]} k={cc.shape[0]}: device events in 5 calls "
              f"{names}", flush=True)
        check(len(names) == 5 and all(f"kmeans_assign_{form}_kernel" in nm for nm in names),
              f"kmeans_assign is not one launch of its {form} form a call: {names}")
    # a launch is a few microseconds on the device, far under the host's
    # cost of one wrapper call, so the times are device times per call;
    # the host-paced rate of back-to-back calls is kept beside them
    fns = {"ms": lambda: kmeans_assign(x, cents),
           "plain_ms": lambda: ref.kmeans_assign_ref(x, cents),
           "library_ms": lambda: torch.cdist(x, cents).argmin(1)}
    times = {key: device_ms(fn, 50) for key, fn in fns.items()}
    host = {key: cuda_ms(fn, 50) for key, fn in fns.items()}
    one = torch.zeros((1,), device="cuda")
    floor = device_ms(lambda: one.fill_(0), 50)

    def km_bound(rows, d, kk):
        return bound_ms(4.0 * (rows * d + kk * d + 2 * rows),
                        rows * kk * (2.0 * d + 3) + 2.0 * rows * d)
    b, by = km_bound(n, dim, k)
    print(f"[kmeans_assign] n={n} d={dim} k={k}: device kernel_ms={times['ms']:.6f} "
          f"plain_ms={times['plain_ms']:.6f} library_ms={times['library_ms']:.6f} "
          f"bound_ms={b:.6f} ({by}) launch floor (fill_ of one float) {floor:.6f} ms; "
          f"host-paced per call: kernel {host['ms']:.4f} plain {host['plain_ms']:.4f} "
          f"library {host['library_ms']:.4f}", flush=True)
    forms = {}
    for tag, xx, cc in (("dim=2", *wide[2]), ("dim=4", *wide[4]),
                        (f"general form, main widened to d={gen_w}",
                         widened(x, gen_w), widened(cents, gen_w)),
                        ("k=256 dim=128", xg, cg)):
        rec = dict(ms=device_ms(lambda: kmeans_assign(xx, cc), 50))
        if tag == "k=256 dim=128":
            rec["plain_ms"] = device_ms(lambda: ref.kmeans_assign_ref(xx, cc), 20)
            rec["library_ms"] = device_ms(lambda: torch.cdist(xx, cc).argmin(1), 20)
        rec["bound_ms"], rec["bound_by"] = km_bound(*xx.shape, cc.shape[0])
        forms[tag] = rec
        print(f"[kmeans_assign] {tag}: " + " ".join(
            f"{key}={val:.6f}" if isinstance(val, float) else f"{key}={val}"
            for key, val in rec.items()), flush=True)
    report["kmeans_assign"] = dict(times, bound_ms=b, bound_by=by, launch_floor_ms=floor,
                                   max_abs_err=worst, host_paced_ms=host, forms=forms,
                                   registers=registers)


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


#: (rows, cols, row_offset, col_offset) of the ragged stripes of a 1,037-row
#: x: the square self-stripe; an off-diagonal stripe of 300 rows the
#: diagonal crosses; one whose 337 rows come after its columns, crossed at
#: an offset gap (700) that is no multiple of 16 or 256
RAGGED_STRIPES = ((slice(None), slice(None), 0, 0),
                  (slice(100, 400), slice(300, None), 100, 300),
                  (slice(700, None), slice(0, 900), 700, 0))
#: the ragged checks' r: TM = 16 rows a block up to r = 4, 2 at r = 32
RAGGED_R = (1, 4, 32)


def _ragged_knn(xr, xc, ro, co, scale_r=None, scale_c=None):
    """E1's (no scales) or E2's (``scale_r``, ``scale_c``) operands on a
    ragged stripe, rbf at sigma 1.1: the row thresholds are each row's
    KNN_K-th entry (#7), entries the skip test of #6's and #8's register
    templates must keep."""
    from repro_torch.kernels.row_topk import row_topk
    kw = dict(kind="rbf", sigma=1.1, row_offset=ro, col_offset=co, scale_r=scale_r,
              scale_c=scale_c)
    return dict(kw, thr=row_topk(xr, xc, k=KNN_K, **kw)[:, -1].contiguous())


def phase_streaming(report, build_log=""):
    """Kernels #5 and #6 against the explicit kernels (bitwise) and their
    plain versions; #5's and #6's register templates bitwise their staged
    templates at the main shape and at ragged ones. ``build_log`` is
    nvcc's report of streaming.cu: no register template of the main path
    may spill."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.affinity import affinity_and_degree
    from repro_torch.kernels.power_step import degree_normalized_matmat
    from repro_torch.kernels.streaming import affinity_degree_streaming, affinity_matmat
    registers = sweep_registers(build_log, block_sparse=False)
    for tmpl, line in registers.items():
        print(f"[streaming] streaming_matmat_kernel {tmpl}: {line}")
    check_no_spill("#5", registers)
    deg_registers = entry_registers(build_log, "streaming_degree")
    for tmpl, line in deg_registers.items():
        print(f"[streaming] streaming_degree_kernel {tmpl}: {line}")
    check_no_entry_spill("#6", deg_registers)
    feats, _, _ = _features(N_MAIN)
    x = feats["rbf"]
    x_st = staged(x)
    n, m = x.shape
    a, d = affinity_and_degree(x, kind="rbf", sigma=SIGMA)
    d_s = affinity_degree_streaming(x, kind="rbf", sigma=SIGMA)
    torch.cuda.synchronize()
    check(torch.equal(d_s, d), "the streamed D is not bitwise the stored D")
    check(torch.equal(d_s, affinity_degree_streaming(x_st, kind="rbf", sigma=SIGMA)),
          "#6's register template is not bitwise its staged template")
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
        for dn in (d, None):
            check(torch.equal(affinity_matmat(x, v, dn, kind="rbf", sigma=SIGMA),
                              affinity_matmat(x_st, v, dn, kind="rbf", sigma=SIGMA)),
                  f"r={r} d={'given' if dn is not None else 'None'}: #5's register "
                  "template is not bitwise its staged template")
        abs_err, excess, err_d, abs_d = _stripe_u_d_errors(
            u_s, d_s, _plain_streaming_stripes(x, v, d, "rbf", SIGMA))
        print(f"[streaming] n={n} m={m} rbf r={r}: D and U bitwise the explicit kernels'; "
              f"vs plain: max|U-U_ref|={abs_err:.3e} excess over tolerance={excess:.3e} "
              f"max|D-D_ref|/mass={err_d:.3e}", flush=True)
        check(excess <= 0.0 and err_d <= D_RTOL, f"streaming r={r} disagrees with plain")
        worst_u, worst_d = max(worst_u, abs_err), max(worst_d, err_d)
        worst_d_abs = max(worst_d_abs, abs_d)
        ms = cuda_ms(lambda: affinity_matmat(x, v, d, kind="rbf", sigma=SIGMA), 10)
        staged_ms = cuda_ms(lambda: affinity_matmat(x_st, v, d, kind="rbf", sigma=SIGMA), 10)
        plain = cuda_ms(lambda: _plain_matmat_stripes(x, v, d, "rbf", SIGMA), 2)
        b, by = bound_ms(4.0 * (n * m + 2 * n * r + n), streaming_flops(n, n, m, r))
        mufu = mufu_bound_ms(n * n)
        print(f"[streaming] matmat n={n} r={r}: kernel_ms={ms:.4f} staged_template_ms="
              f"{staged_ms:.4f} plain_ms={plain:.4f} library_ms=null bound_ms={b:.4f} ({by}) "
              f"mufu_bound_ms={mufu:.4f}; explicit sweep on stored A: "
              f"{cuda_ms(lambda: degree_normalized_matmat(a, v, d), 10):.4f} ms", flush=True)
        main[r] = dict(ms=ms, staged_ms=staged_ms, plain_ms=plain, bound_ms=b, bound_by=by,
                       mufu_bound_ms=mufu)
    ms_d = cuda_ms(lambda: affinity_degree_streaming(x, kind="rbf", sigma=SIGMA), 10)
    staged_d = cuda_ms(lambda: affinity_degree_streaming(x_st, kind="rbf", sigma=SIGMA), 10)
    plain_d = cuda_ms(lambda: _plain_degree_stripes(x, "rbf", SIGMA), 2)
    b_d, by_d = bound_ms(4.0 * (n * m + n), streaming_flops(n, n, m, None))
    print(f"[streaming] degree n={n}: kernel_ms={ms_d:.4f} staged_template_ms={staged_d:.4f} "
          f"plain_ms={plain_d:.4f} library_ms=null bound_ms={b_d:.4f} ({by_d}) "
          f"mufu_bound_ms={mufu:.4f}", flush=True)
    del a, d, d_s
    torch.cuda.empty_cache()

    # ragged rows, wide features (the staged template) and the register
    # template's width, all kinds, off-diagonal stripes (rows after the
    # columns too), d=None
    xw = torch.randn((1037, 16), generator=g, device="cuda") * 0.25
    for m, kind, (rows, cols, ro, co) in itertools.product(
            (16, register_m()), ("cosine", "cosine_shifted", "rbf"), RAGGED_STRIPES):
        xs = xw[:, :m].contiguous()
        x = xs if kind == "rbf" else xs / xs.norm(dim=1, keepdim=True)
        xr = x[rows].contiguous()
        xc = None if ro == co == 0 else x[cols].contiguous()   # the square: xc=None
        n_cols = x.shape[0] if xc is None else xc.shape[0]
        dd = affinity_degree_streaming(xr, xc, kind=kind, sigma=1.1, row_offset=ro,
                                       col_offset=co)
        a_ref, d_ref = ref.affinity_and_degree_ref(xr, xc, kind=kind, sigma=1.1,
                                                   row_offset=ro, col_offset=co)
        err_d = float(((dd - d_ref).abs() / a_ref.abs().sum(1).clamp_min(1e-30)).max())
        check(err_d <= D_RTOL, f"ragged streamed degree {kind} disagrees")
        check(torch.equal(dd, affinity_degree_streaming(
            staged(xr), staged(xc), kind=kind, sigma=1.1, row_offset=ro, col_offset=co)),
              f"ragged streamed degree m={m} {kind} ({ro},{co}): the register template is "
              "not bitwise the staged template")
        kw1 = dict(kind=kind, sigma=1.1, row_offset=ro, col_offset=co)
        a1, d1 = affinity_and_degree(xr, xc, **kw1)
        check(torch.equal(dd, d1),
              f"ragged streamed degree m={m} {kind} ({ro},{co}) is not bitwise #1's D")
        a1_st, d1_st = affinity_and_degree(staged(xr), staged(xc), **kw1)
        check(torch.equal(a1, a1_st) and torch.equal(d1, d1_st),
              f"ragged affinity m={m} {kind} ({ro},{co}): #1's register template is not "
              "bitwise its staged template")
        check(float((a1 - a_ref).abs().max()) <= A_ATOL,
              f"ragged affinity m={m} {kind} ({ro},{co}) disagrees with its plain version")
        worst_d = max(worst_d, err_d)
        worst_d_abs = max(worst_d_abs, float((dd - d_ref).abs().max()))
        for r in RAGGED_R:
            vs = torch.rand((n_cols, r), generator=g, device="cuda")
            for dn in (dd, None):
                u = affinity_matmat(xr, vs, dn, xc, kind=kind, sigma=1.1,
                                    row_offset=ro, col_offset=co)
                check(torch.equal(u, affinity_matmat(
                    staged(xr), vs, dn, staged(xc), kind=kind, sigma=1.1, row_offset=ro,
                    col_offset=co)),
                      f"ragged streaming m={m} {kind} ({ro},{co}) r={r}: the register "
                      "template is not bitwise the staged template")
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
        print(f"[streaming] ragged {tuple(xr.shape)}x{n_cols} m={m} {kind} "
              f"offsets=({ro},{co}) r=1,4,32 d=given,None: agree, register template = "
              f"staged template (#1, #5 and #6), D = #1's D; max|D-D_ref|/mass={err_d:.3e}")
    report["streaming_matmat"] = dict(main[1], max_abs_err=worst_u, library_ms=None,
                                      r2=main[2], registers=registers)
    report["streaming_degree"] = dict(ms=ms_d, staged_ms=staged_d, plain_ms=plain_d,
                                      bound_ms=b_d, bound_by=by_d, mufu_bound_ms=mufu,
                                      max_abs_err=worst_d_abs, max_rel_err_d=worst_d,
                                      library_ms=None, registers=deg_registers)


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


def topk_registers(log: str) -> dict[str, str]:
    """Registers and spills of #7's templates in nvcc's report:
    ``{"register" | "staged <fixed|policy>": ...}`` (the register template
    is ``row_topk_reg_kernel``)."""
    return ptxas_registers(
        log, r"\d+row_topk_(reg_kernel|kernelILb(\d)E)",
        lambda e: ("register" if e.group(1) == "reg_kernel"
                   else f"staged {'policy' if e.group(2) == '1' else 'fixed'}"))


def phase_row_topk(report):
    """Kernel #7 against its plain version: at the main shape bit for bit
    (the scores are the build's entries, the plain version's arithmetic);
    at ragged shapes with m = 16, 2 and 1 within the stated tolerances. Its
    register template (m <= 2) bitwise its staged template, reached by x
    with a zero feature column appended (staged()), at the main shape and
    at ragged, off-diagonal and below-diagonal stripes; both timed. Fails
    where nvcc's report (kept beside the library) shows the register
    template spilling, or names none."""
    from repro_torch.core.graph import scales_from_topk
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.row_topk import row_topk
    registers = topk_registers(_build.report("row_topk"))
    print(f"[row_topk] templates: {registers}", flush=True)
    check("register" in registers,
          f"nvcc's report names no register template of #7: {registers}")
    check(registers["register"].endswith(" 0 bytes spilled"),
          f"#7's register template spills: {registers['register']}")
    feats, _, _ = _features(N_MAIN)
    x = feats["rbf"]
    x_st = staged(x)
    n, m = x.shape
    scale = scales_from_topk(row_topk(x, k=SCALE_K, stat="neg_sqdist", kind="rbf",
                                      sigma=SIGMA)).contiguous()
    worst = 0.0
    cases = [("neg_sqdist", k, None) for k in (1, 7, 64)]
    cases += [("similarity", k, sc) for k in (10, 30, 64) for sc in (None, scale)]
    times = {}
    for stat, k, sc in cases:
        tag = f"{stat} K={k}{' adaptive' if sc is not None else ''}"
        kw = dict(k=k, stat=stat, kind="rbf", sigma=SIGMA, scale_r=sc, scale_c=sc)
        out = row_topk(x, **kw)
        out_st = row_topk(x_st, **kw)
        torch.cuda.synchronize()
        same, err = True, 0.0
        for r0, r1, want in _stripe_scores(x, k, stat, sc):
            same = same and torch.equal(out[r0:r1], want)
            err = max(err, _topk_error(out[r0:r1], want))
        print(f"[row_topk] n={n} m={m} {tag}: equal to the plain version={same} "
              f"max|err|={err:.3e}; register template = staged template: "
              f"{torch.equal(out, out_st)}", flush=True)
        check(same, f"row_topk {tag} is not the plain version's top-k")
        check(torch.equal(out, out_st),
              f"row_topk {tag}: the register template is not bitwise the staged template")
        worst = max(worst, err)
        ms = cuda_ms(lambda: row_topk(x, **kw), 5)
        staged_ms = cuda_ms(lambda: row_topk(x_st, **kw), 5)
        b, by = bound_ms(4.0 * (n * m + n * k + (2 * n if sc is not None else 0)),
                         topk_flops(n, n, m, stat, sc is not None))
        # the similarity score takes one expf an entry; neg_sqdist none
        mufu = mufu_bound_ms(n * n) if stat == "similarity" else None
        times[tag] = dict(ms=ms, staged_ms=staged_ms, bound_ms=b, bound_by=by,
                          mufu_bound_ms=mufu)
        print(f"[row_topk] {tag}: kernel_ms={ms:.4f} staged_template_ms={staged_ms:.4f} "
              f"bound_ms={b:.4f} ({by}) mufu_bound_ms={mufu}", flush=True)
    del out, out_st

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

    # ragged rows, wide features (the staged template) and the register
    # template's widths (m = 2 and 1), stripes off the diagonal (rows after
    # the columns too), adaptive scales; at m <= 2 the register template
    # bitwise the staged one
    g = torch.Generator(device="cuda").manual_seed(6)
    xw = torch.randn((1037, 16), generator=g, device="cuda") * 0.25
    sc_w = 0.3 + 0.7 * torch.rand((1037,), generator=g, device="cuda")
    for mm, (rows, cols, ro, co) in itertools.product((16, register_m(), 1), RAGGED_STRIPES):
        xs = xw[:, :mm].contiguous()
        sq_max = float((xs * xs).sum(dim=1).max())
        xr = xs[rows].contiguous()
        xc = None if ro == co == 0 else xs[cols].contiguous()
        sr = sc_w[rows].contiguous()
        scc = sc_w if xc is None else sc_w[cols].contiguous()
        for stat, k, adaptive in itertools.product(("neg_sqdist", "similarity"), (7, 64),
                                                   (False, True)):
            if stat == "neg_sqdist" and adaptive:
                continue
            kw = dict(k=k, stat=stat, kind="rbf", sigma=1.1, row_offset=ro, col_offset=co,
                      scale_r=sr if adaptive else None, scale_c=scc if adaptive else None)
            out = row_topk(xr, xc, **kw)
            want = ref.row_topk_ref(xr, xc, **kw)
            err = _topk_error(out, want)
            # adaptive: d2's error carried through exp(-d2 / (s_i s_j))
            tol = (SQD_RTOL * sq_max if stat == "neg_sqdist"
                   else A_ATOL + (SQD_RTOL * sq_max / float(sc_w.min()) ** 2 if adaptive
                                  else 0.0))
            tag = f"{stat} K={k}{' adaptive' if adaptive else ''}"
            check(err <= tol, f"ragged row_topk {tag} {tuple(xr.shape)} m={mm} "
                              f"({ro},{co}) disagrees")
            if mm <= register_m():
                check(torch.equal(out, row_topk(staged(xr), staged(xc), **kw)),
                      f"ragged row_topk {tag} {tuple(xr.shape)} ({ro},{co}): the register "
                      "template is not bitwise the staged template")
            worst = max(worst, err)
        print(f"[row_topk] ragged {tuple(xr.shape)} m={mm} offsets=({ro},{co}) both stats, "
              f"adaptive too, K=7,64: agree"
              + (", register template = staged template" if mm <= register_m() else ""),
              flush=True)
    report["row_topk"] = dict(main, max_abs_err=worst, library_ms=None, cases=times,
                              registers=registers)


def _policy_a_error(a, x, pol, thr):
    """Max |A - A_ref| of #1's A against its plain version over row stripes,
    with the policy operands ``pol`` and the row thresholds ``thr`` (or
    None)."""
    from repro_torch.kernels import ref
    sc, n, err = pol["scale_r"], x.shape[0], 0.0
    for r0 in range(0, n, 4096):
        a_ref, _ = ref.affinity_and_degree_ref(
            x[r0:r0 + 4096], x, row_offset=r0, thr=None if thr is None else thr[r0:r0 + 4096],
            **dict(pol, scale_r=None if sc is None else sc[r0:r0 + 4096]))
        err = max(err, float((a[r0:r0 + 4096] - a_ref).abs().max()))
        del a_ref
    return err


def phase_policy(report):
    """Kernels #1, #5 and #6 with the policy operands of E1 (kNN) and E2
    (adaptive + kNN): A bitwise its plain version's, #1's, #5's and #6's
    register templates bitwise their staged templates (#1 also with E2's
    scales alone, the fused build's form), the streamed D and U bitwise
    the explicit kernels', the column-thresholded product the transpose of
    the stored truncated A, and every row keeping knn_k entries (more only
    on a tie at its threshold); the share of entries the register
    templates of #1, #6 and #8 make with their expf (and #11's, over the
    live tiles), and their bounds for that work."""
    from repro_torch.core.affinity import AffinitySpec, dense_block_live
    from repro_torch.core.graph import affinity_stats
    from repro_torch.kernels import ref
    from repro_torch.kernels.affinity import affinity_and_degree
    from repro_torch.kernels.power_step import degree_normalized_matmat
    from repro_torch.kernels.streaming import affinity_degree_streaming, affinity_matmat
    feats, _, _ = _features(N_MAIN)
    x = feats["rbf"]
    x_st = staged(x)
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
        err_a = _policy_a_error(a, x, pol, thr)
        check(err_a == 0.0, f"{tag}: A is not bitwise the plain version's ({err_a:.3e})")
        a_st, d_st = affinity_and_degree(x_st, thr=thr, **pol)
        check(torch.equal(a, a_st) and torch.equal(d, d_st),
              f"{tag}: #1's register template's A and D are not bitwise its staged template's")
        del a_st, d_st
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
        check(torch.equal(d_s, affinity_degree_streaming(x_st, thr=thr, **pol)),
              f"{tag}: #6's register template is not bitwise its staged template")
        v1 = (d / d.sum())[:, None].contiguous()
        v2 = torch.cat([v1, torch.rand((n, 1), generator=g, device="cuda") / n], dim=1)
        for v in (v1, v2):
            u_s = affinity_matmat(x, v, d, thr=thr, **pol)
            u_e = degree_normalized_matmat(a, v, d)
            torch.cuda.synchronize()
            check(torch.equal(u_s, u_e),
                  f"{tag} r={v.shape[1]}: the streamed U is not bitwise the explicit U")
            for kw_t in (dict(thr=thr), dict(thr_c=thr)):
                for dn in (d, None):
                    check(torch.equal(affinity_matmat(x, v, dn, **kw_t, **pol),
                                      affinity_matmat(x_st, v, dn, **kw_t, **pol)),
                          f"{tag} r={v.shape[1]} {list(kw_t)} d={dn is not None}: #5's "
                          "register template is not bitwise its staged template")
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
        live = dense_block_live(a, 16, 256)
        times = dict(
            affinity_ms=cuda_ms(lambda: affinity_and_degree(x, thr=thr, **pol), 5),
            affinity_staged_ms=cuda_ms(lambda: affinity_and_degree(x_st, thr=thr, **pol), 5),
            degree_ms=cuda_ms(lambda: affinity_degree_streaming(x, thr=thr, **pol), 10),
            degree_staged_ms=cuda_ms(lambda: affinity_degree_streaming(x_st, thr=thr, **pol), 10),
            matmat_r2_ms=cuda_ms(lambda: affinity_matmat(x, v2, d, thr=thr, **pol), 10),
            matmat_r2_staged_ms=cuda_ms(
                lambda: affinity_matmat(x_st, v2, d, thr=thr, **pol), 10),
            matmat_thr_c_ms=cuda_ms(lambda: affinity_matmat(x, ind, None, thr_c=thr, **pol), 10),
            matmat_thr_c_staged_ms=cuda_ms(
                lambda: affinity_matmat(x_st, ind, None, thr_c=thr, **pol), 10),
            sweep_stored_r2_ms=cuda_ms(lambda: degree_normalized_matmat(a, v2, d), 10))
        del a   # each 8.1 GB A freed before the next is built
        torch.cuda.empty_cache()
        # the unthresholded A: E1's is the dense build; E2's, with the
        # scales alone, the fused build's call of #1
        a_raw, d_raw = affinity_and_degree(x, **pol)
        passing, made = expf_shares(a_raw, thr)
        passing_live, made_live = expf_shares(a_raw, thr, live=live)
        if sc is not None:
            err_f = _policy_a_error(a_raw, x, pol, None)
            check(err_f == 0.0,
                  f"{tag}: the fused form's A is not bitwise the plain version's ({err_f:.3e})")
            a_st, d_st = affinity_and_degree(x_st, **pol)
            check(torch.equal(a_raw, a_st) and torch.equal(d_raw, d_st),
                  f"{tag}: #1's register template is not bitwise its staged template in the "
                  "fused form (scales, no thr)")
            del a_st, d_st
        del a_raw, d_raw
        torch.cuda.empty_cache()
        if sc is not None:
            times.update(
                fused_form_ms=cuda_ms(lambda: affinity_and_degree(x, **pol), 5),
                fused_form_staged_ms=cuda_ms(lambda: affinity_and_degree(x_st, **pol), 5))
        # the dense work plus, per entry, the threshold compare and, with
        # adaptive scales, the product of the scales (the divide replaces
        # the multiply); the operands add 4 bytes a row or column each
        extra = n * n * (1 + (1 if sc is not None else 0))
        op_bytes = 4.0 * n * (1 + (2 if sc is not None else 0))
        bounds = dict(
            affinity=bound_ms(4.0 * (n * m + n * n + n) + op_bytes,
                              affinity_flops(n, n, m, "rbf") + extra),
            degree=bound_ms(4.0 * (n * m + n) + op_bytes,
                            skip_flops(n * n, m, made, sc is not None)),
            matmat_r2=bound_ms(4.0 * (n * m + 2 * n * 2 + n) + op_bytes,
                               streaming_flops(n, n, m, 2) + extra),
            matmat_thr_c=bound_ms(4.0 * (n * m + 2 * n) + op_bytes,
                                  streaming_flops(n, n, m, 1) + extra))
        if sc is not None:     # the fused form: every entry's transform, scaled
            bounds["fused_form"] = bound_ms(4.0 * (n * m + n * n + 3 * n),
                                            affinity_flops(n, n, m, "rbf") + n * n)
        times.update({f"{key}_bound_ms": b for key, (b, _) in bounds.items()})
        times["mufu_bound_ms"] = mufu_bound_ms(n * n)     # #5 and #1's fused form: n^2 expf
        # #1, #6 and #8 with the skip test: the entries made exactly
        times["skip_mufu_bound_ms"] = mufu_bound_ms(made * n * n)
        print(f"[policy] {tag} n={n}: A bitwise the plain version's; streamed D and U "
              f"(r=1,2) bitwise the explicit kernels'; thr_c product = A^T V in positivity, "
              f"max|err|={worst_t:.3e}; kept per row min={int(kept.min())} "
              f"max={int(kept.max())}, rows over {KNN_K} (ties at the threshold)={ties}; "
              f"#1 and #6 = their staged templates; share of entries #1, #6 and #8 make "
              f"without expf {1.0 - made:.6f} (with it {made:.6f}; past the skip test "
              f"{passing:.6f}), of the live tiles' entries #11 makes with it {made_live:.6f} "
              f"(past the test {passing_live:.6f}); "
              + " ".join(f"{key}={val:.4f}" for key, val in times.items()), flush=True)
        out[tag] = dict(times, tie_rows=ties, max_abs_err_thr_c=worst_t,
                        expf_passing=passing, expf_made=made, expf_passing_live=passing_live,
                        expf_made_live=made_live)
        del d, d_s
        torch.cuda.empty_cache()

    # ragged rows, wide features and the register template's width,
    # off-diagonal stripes (rows after the columns too), every operand
    xw = torch.randn((1037, 16), generator=g, device="cuda") * 0.25
    scs = torch.rand((1037,), generator=g, device="cuda") * 0.7 + 0.3
    thr_all = torch.rand((1037,), generator=g, device="cuda") * 0.5 + 0.3
    for m_s, (rows, cols, ro, co) in itertools.product((16, register_m()), RAGGED_STRIPES):
        xs = xw[:, :m_s].contiguous()
        xr, xc = xs[rows].contiguous(), xs[cols].contiguous()
        kw = dict(kind="rbf", sigma=1.1, row_offset=ro, col_offset=co,
                  scale_r=scs[rows].contiguous(), scale_c=scs[cols].contiguous())
        thr_r, thr_c = thr_all[rows].contiguous(), thr_all[cols].contiguous()
        a, d = affinity_and_degree(xr, xc, thr=thr_r, **kw)
        a_ref, d_ref = ref.affinity_and_degree_ref(xr, xc, thr=thr_r, **kw)
        # the scales are given alike, so d2's error carries through 1/(s_i s_j)
        atol = A_ATOL + SQD_RTOL * float((xs * xs).sum(1).max()) / float(scs.min()) ** 2
        check(float((a - a_ref).abs().max()) <= atol, f"ragged policy A ({ro},{co}) disagrees")
        # #1 with the stripe's thresholds, and with the scales alone (the
        # fused build's form): its register template's A and D its staged
        # template's
        for kw_1 in (dict(kw, thr=thr_r), kw):
            a_1, d_1 = affinity_and_degree(xr, xc, **kw_1)
            a_1st, d_1st = affinity_and_degree(staged(xr), staged(xc), **kw_1)
            check(torch.equal(a_1, a_1st) and torch.equal(d_1, d_1st),
                  f"ragged policy m={m_s} ({ro},{co}) thr={'thr' in kw_1}: #1's register "
                  "template is not bitwise its staged template")
        check(float((a_1 - ref.affinity_and_degree_ref(xr, xc, **kw)[0]).abs().max()) <= atol,
              f"ragged policy A ({ro},{co}) with the scales alone disagrees")
        for r, kw_t in itertools.product(RAGGED_R, (dict(thr=thr_r), dict(thr_c=thr_c))):
            v = torch.rand((xc.shape[0], r), generator=g, device="cuda")
            u = affinity_matmat(xr, v, None, xc, **kw_t, **kw)
            check(torch.equal(u, affinity_matmat(staged(xr), v, None, staged(xc), **kw_t, **kw)),
                  f"ragged policy m={m_s} r={r} {list(kw_t)} ({ro},{co}): the register "
                  "template is not bitwise the staged template")
            u_ref = ref.affinity_matmat_ref(xr, v, None, xc, **kw_t, **kw)
            check(float((u - u_ref).abs().max()) <= U_RTOL * float(u_ref.abs().max())
                  + xc.shape[0] * atol, f"ragged policy U {list(kw_t)} ({ro},{co}) disagrees")
        dd = affinity_degree_streaming(xr, xc, thr=thr_r, **kw)
        check(torch.equal(dd, d), f"ragged policy D ({ro},{co}) is not the build's D")
        check(torch.equal(dd, affinity_degree_streaming(staged(xr), staged(xc), thr=thr_r, **kw)),
              f"ragged policy m={m_s} ({ro},{co}): #6's register template is not bitwise "
              "its staged template")
        # E1's and E2's forms, thresholds at entries of the rows (#7)
        for scales in ((None, None), (kw["scale_r"], kw["scale_c"])):
            kw_k = _ragged_knn(xr, xc, ro, co, *scales)
            dd = affinity_degree_streaming(xr, xc, **kw_k)
            a_k, d_k = affinity_and_degree(xr, xc, **kw_k)
            a_kst, d_kst = affinity_and_degree(staged(xr), staged(xc), **kw_k)
            check(torch.equal(dd, d_k)
                  and torch.equal(dd, affinity_degree_streaming(staged(xr), staged(xc), **kw_k)),
                  f"ragged kNN m={m_s} ({ro},{co}) scales={scales[0] is not None}: #6 is not "
                  "bitwise #1's D and its staged template")
            check(torch.equal(a_k, a_kst) and torch.equal(d_k, d_kst),
                  f"ragged kNN m={m_s} ({ro},{co}) scales={scales[0] is not None}: #1's "
                  "register template is not bitwise its staged template")
    print(f"[policy] ragged (1037, m) square, (300, 737) off-diagonal and (337, 900) "
          f"below-diagonal stripes, m=16,{register_m()}, r=1,4,32, scales + thr / thr_c: "
          "agree, register template = staged template (#1 with thr and with the scales "
          "alone, #5, #6); kNN thresholds with and without scales: #6 = #1's D, #1 and #6 = "
          "their staged templates", flush=True)
    report["policy"] = out


def phase_gram(report):
    """Kernel #4 against its plain version, within G_RTOL of max|G_ref|, at
    the power loop's shapes (V (45,000, 2) of the QR, [V | U] (45,000, 4)
    of the residual rule) and ragged ones (n = 255, 256, 257 across the
    256-row block edge; n = 1,037 at c = 1, 3, 64): the same bits on a
    second call, G exactly symmetric, and one kernel launch a call (the
    profiler's device events). Timed at c = 2 and 4 beside v.T @ v."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.gram import gram
    g = torch.Generator(device="cuda").manual_seed(5)
    n = N_MAIN
    v = torch.rand((n, 2), generator=g, device="cuda")
    v = v / v.sum(dim=0, keepdim=True)                   # the loop's L1 scale
    vu = torch.cat([v, v * (1.0 + 0.01 * torch.rand((n, 2), generator=g, device="cuda"))],
                   dim=1)
    cases = [("V", v), ("[V|U]", vu)]
    cases += [(f"ragged n={rows} c={c}", torch.randn((rows, c), generator=g, device="cuda"))
              for rows, c in ((255, 2), (256, 2), (257, 4),
                              *itertools.product((255, 256, 257, 1037), (1, 3, 64)))]
    worst = 0.0
    for tag, vv in cases:
        gk = gram(vv)
        g_ref = ref.gram_ref(vv)
        again = gram(vv)
        torch.cuda.synchronize()
        err = float((gk - g_ref).abs().max())
        scale = float(g_ref.abs().max())
        events = device_events(lambda: gram(vv), 5)
        print(f"[gram] {tag} {tuple(vv.shape)}: max|G-G_ref|={err:.3e} max|G_ref|={scale:.3e} "
              f"same bits on a second call={torch.equal(gk, again)} "
              f"symmetric={torch.equal(gk, gk.T)} device events in 5 calls="
              f"{[_kernel_label(name) for name, _ in events]}", flush=True)
        check(err <= G_RTOL * scale, f"gram disagrees ({tag})")
        check(torch.equal(gk, again), f"gram gives other bits on a second call ({tag})")
        check(torch.equal(gk, gk.T), f"gram is not exactly symmetric ({tag})")
        check(len(events) == 5 and all("gram_kernel" in name for name, _ in events),
              f"gram is not one kernel launch a call ({tag}): {events}")
        worst = max(worst, err)
    out = {}
    for vv in (v, vu):
        c = vv.shape[1]
        fns = {"ms": lambda: gram(vv), "plain_ms": lambda: ref.gram_ref(vv),
               "library_ms": lambda: vv.T @ vv}
        times = {key: device_ms(fn, 50) for key, fn in fns.items()}
        host = {key: cuda_ms(fn, 50) for key, fn in fns.items()}
        b, by = bound_ms(4.0 * (n * c + c * c), 2.0 * n * c * c)
        print(f"[gram] n={n} c={c}: device kernel_ms={times['ms']:.6f} "
              f"plain_ms={times['plain_ms']:.6f} library_ms={times['library_ms']:.6f} "
              f"bound_ms={b:.6f} ({by}); host-paced per call: kernel {host['ms']:.4f} "
              f"plain {host['plain_ms']:.4f} library {host['library_ms']:.4f}", flush=True)
        out[c] = dict(times, bound_ms=b, bound_by=by, host_paced_ms=host)
    report["gram"] = dict(out[2], max_abs_err=worst, c4=out[4])


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


def phase_block_sparse(report, build_log=""):
    """Kernels #8-#11 at the main path's shape with E1's and E2's operands:
    the liveness map equal to dense_block_live of kernel #1's thresholded A;
    #9 bitwise #2 and its plain-load template (every r bucket, a NaN of V
    reaching exactly its rows: ``check_bs_matmat_bits``), timed in both
    templates; #10 bitwise #5 (d given and None) and its
    staged template, #11 bitwise #6, #1's D and its staged template; the
    fused build's A, D and thresholds bitwise the two-pass build's; each
    against its plain version; #8's register template's map its staged
    template's; #8 and #11 timed in both templates at E1 and E2. Then
    ragged and off-diagonal stripes at m = 16 and at the register
    template's width (with E1's and E2's kNN thresholds too), and a NaN in
    V. ``build_log`` is nvcc's report of block_sparse.cu: no register
    template of the main path, and no template of #9 at r <= 2, may
    spill."""
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
    registers = sweep_registers(build_log, block_sparse=True)
    for tmpl, line in registers.items():
        print(f"[block_sparse] bs_streaming_matmat_kernel {tmpl}: {line}")
    check_no_spill("#10", registers)
    live_registers = entry_registers(build_log, "liveness")
    for tmpl, line in live_registers.items():
        print(f"[block_sparse] liveness_kernel {tmpl}: {line}")
    check_no_entry_spill("#8", live_registers)
    bs_registers = sweep_template_registers(build_log, "bs_matmat", "f32")
    for tmpl, line in bs_registers.items():
        print(f"[block_sparse] bs_matmat_kernel f32 {tmpl}: {line}")
    check_sweep_no_spill("#9 f32", bs_registers, templates=("plain",))
    deg_registers = entry_registers(build_log, "bs_streaming_degree")
    for tmpl, line in deg_registers.items():
        print(f"[block_sparse] bs_streaming_degree_kernel {tmpl}: {line}")
    check_no_entry_spill("#11", deg_registers)
    feats, _, _ = _features(N_MAIN)
    x = feats["rbf"]
    x_st = staged(x)
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
        check(torch.equal(live, block_liveness(x_st, **pol)),
              f"{tag}: #8's register template's map is not its staged template's")
        # #8's work: every entry's skip test, the made share of them exactly
        made = report["policy"][tag]["expf_made"]
        live_times = dict(
            ms=cuda_ms(lambda: block_liveness(x, **pol), 10),
            staged_ms=cuda_ms(lambda: block_liveness(x_st, **pol), 10),
            mufu_bound_ms=mufu_bound_ms(made * n * n),
            bound=bound_ms(4.0 * (n * m + live.numel() + n * (3 if sc is not None else 1)),
                           skip_flops(n * n, m, made, sc is not None)))
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
            for dn, u10 in ((d, u_s), (None, u_n)):
                check(torch.equal(u10, block_sparse_streaming_matmat(
                    x_st, v, dn, **plan, **pol)), f"{tag} r={r} d={dn is not None}: #10's "
                      "register template is not bitwise its staged template")
        # #9 in each r bucket: #2's bits, in the template A takes and the plain-load one
        tmpl9 = check_bs_matmat_bits(f"{tag} f32", a, d, counts, col_idx, g)
        d_b = block_sparse_streaming_degree(x, **plan, **pol)
        d_6 = affinity_degree_streaming(x, **pol)
        torch.cuda.synchronize()
        check(torch.equal(d_b, d) and torch.equal(d_b, d_6),
              f"{tag}: #11 is not bitwise #1's D and #6")
        check(torch.equal(d_b, block_sparse_streaming_degree(x_st, **plan, **pol)),
              f"{tag}: #11's register template is not bitwise its staged template")
        # #11's work: every live entry's skip test, the share of them made
        # exactly (counted over the live tiles of the stored A)
        made_live = report["policy"][tag]["expf_made_live"]
        deg_times = dict(
            ms=cuda_ms(lambda: block_sparse_streaming_degree(x, **plan, **pol), 20),
            staged_ms=cuda_ms(lambda: block_sparse_streaming_degree(x_st, **plan, **pol), 20),
            mufu_bound_ms=mufu_bound_ms(made_live * entries),
            bound=bound_ms(4.0 * (n * m + n * (2 if sc is not None else 0) + n)
                           + 4.0 * n + 4.0 * (counts.numel() + float(counts.sum())),
                           skip_flops(entries, m, made_live, sc is not None)))
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
                   liveness_ms=live_times["ms"], liveness_staged_ms=live_times["staged_ms"],
                   liveness_bound_ms=live_times["bound"][0],
                   liveness_mufu_bound_ms=live_times["mufu_bound_ms"],
                   degree_ms=deg_times["ms"], degree_staged_ms=deg_times["staged_ms"],
                   degree_bound_ms=deg_times["bound"][0],
                   degree_mufu_bound_ms=deg_times["mufu_bound_ms"],
                   fused_build_extra_bytes=fused_extra, max_abs_err=dict(
                       block_sparse_matmat=err9, block_sparse_streaming_matmat=err10,
                       block_sparse_streaming_degree_rel=err11))
        if tag == "knn":
            rec.update(
                fused_build_ms=cuda_ms(lambda: fused_affinity_build(x, spec=spec), 3),
                two_pass_build_ms=cuda_ms(lambda: affinity_and_degree(
                    x, kind="rbf", sigma=SIGMA, thr=row_topk(
                        x, k=KNN_K, kind="rbf", sigma=SIGMA)[:, -1].contiguous()), 3),
                row_topk_ms=cuda_ms(lambda: row_topk(x, k=KNN_K, kind="rbf", sigma=SIGMA), 5))
            # built after the timed builds above, so at most two A's live
            a_raw, _ = affinity_and_degree(x, kind="rbf", sigma=SIGMA)
            rec["thresholds_from_scores_ms"] = cuda_ms(
                lambda: topk_thresholds_from_scores(a_raw, k=KNN_K), 3)
            del a_raw
            torch.cuda.empty_cache()
            r = 2
            op_bytes = 4.0 * n                             # the thresholds
            shifted = shifted_copy(a)                      # #9's plain-load template
            plan_bytes = 4.0 * (counts.numel() + float(counts.sum()))
            times = dict(
                block_liveness=dict(
                    live_times,
                    plain_ms=cuda_ms(lambda: [ref.block_liveness_ref(
                        x[r0:r0 + 4096], x, tm=16, tn=256, row_offset=r0,
                        **dict(pol, thr=thr[r0:r0 + 4096])) for r0 in range(0, n, 4096)], 2),
                    library_ms=None),
                block_sparse_matmat=dict(
                    ms=cuda_ms(lambda: block_sparse_matmat(a, v2, d, counts, col_idx), 20),
                    plain_ms=cuda_ms(lambda: ref.block_sparse_matmat_ref(
                        a, v2, d, counts, col_idx, tm=16, tn=256), 3),
                    library_ms=cuda_ms(lambda: torch.matmul(a, v2) / d.clamp_min(1e-30)[:, None],
                                       20),
                    r1_ms=cuda_ms(lambda: block_sparse_matmat(a, v1, d, counts, col_idx), 20),
                    template=tmpl9,
                    plain_load_ms=cuda_ms(lambda: block_sparse_matmat(
                        shifted, v2, d, counts, col_idx), 20),
                    plain_load_r1_ms=cuda_ms(lambda: block_sparse_matmat(
                        shifted, v1, d, counts, col_idx), 20),
                    dense_ms=cuda_ms(lambda: degree_normalized_matmat(a, v2, d), 20),
                    bound=bound_ms(4.0 * (entries + 2 * n * r + n) + plan_bytes,
                                   2.0 * r * entries)),
                block_sparse_streaming_matmat=dict(
                    mufu_bound_ms=mufu_bound_ms(entries),
                    ms=cuda_ms(lambda: block_sparse_streaming_matmat(x, v2, d, **plan, **pol), 20),
                    staged_ms=cuda_ms(lambda: block_sparse_streaming_matmat(
                        x_st, v2, d, **plan, **pol), 20),
                    plain_ms=cuda_ms(lambda: _bs_plain_stripes(x, v2, d, counts, col_idx, pol), 2),
                    library_ms=None,
                    r1_ms=cuda_ms(lambda: block_sparse_streaming_matmat(x, v1, d, **plan, **pol),
                                  20),
                    staged_r1_ms=cuda_ms(lambda: block_sparse_streaming_matmat(
                        x_st, v1, d, **plan, **pol), 20),
                    dense_ms=cuda_ms(lambda: affinity_matmat(x, v2, d, **pol), 20),
                    bound=bound_ms(4.0 * (n * m + 2 * n * r + n) + op_bytes + plan_bytes,
                                   entries * (2 * m + 6 + 2 * r + 1))),
                block_sparse_streaming_degree=dict(
                    deg_times,
                    plain_ms=cuda_ms(lambda: _bs_plain_stripes(x, None, None, counts, col_idx,
                                                               pol), 2),
                    library_ms=None,
                    dense_ms=cuda_ms(lambda: affinity_degree_streaming(x, **pol), 20)))
            del shifted
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
            rows_b = (~torch.isfinite(block_sparse_matmat(a, v_nan, d, counts, col_idx))).any(1)
            bad_b = int(rows_b.sum())
            check(torch.equal(rows_b, live[:, 0].bool().repeat_interleave(16)[:n]),
                  "a NaN of V at column 7 does not reach exactly the rows whose plan row "
                  "holds tile 0")
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
                        if key in ("r1_ms", "dense_ms", "staged_ms", "staged_r1_ms",
                                   "plain_load_ms", "plain_load_r1_ms", "mufu_bound_ms"))
              + (f" template={t['template']}" if "template" in t else ""), flush=True)

    # ragged rows, wide features and the register template's width,
    # off-diagonal stripes (rows after the columns too), every operand
    xw = torch.randn((1037, 16), generator=g, device="cuda") * 0.25
    scs = torch.rand((1037,), generator=g, device="cuda") * 0.7 + 0.3
    thr_all = torch.rand((1037,), generator=g, device="cuda") * 0.5 + 0.3
    for m_s, (rows, cols, ro, co) in itertools.product((16, register_m()), RAGGED_STRIPES):
        xs = xw[:, :m_s].contiguous()
        atol = A_ATOL + SQD_RTOL * float((xs * xs).sum(1).max()) / float(scs.min()) ** 2
        xr, xc = xs[rows].contiguous(), xs[cols].contiguous()
        kw = dict(kind="rbf", sigma=1.1, row_offset=ro, col_offset=co,
                  scale_r=scs[rows].contiguous(), scale_c=scs[cols].contiguous(),
                  thr=thr_all[rows].contiguous())
        a, d = affinity_and_degree(xr, xc, **kw)
        live = block_liveness(xr, xc, **kw)
        torch.cuda.synchronize()
        check(torch.equal(live.bool(), dense_block_live(a, 16, 256)),
              f"ragged ({ro},{co}): #8 is not dense_block_live of #1's A")
        # #8's register template against its staged template and #1's map:
        # E2's and E1's forms with the stripe's thresholds, and with
        # thresholds at entries of the rows (#7); against its plain version
        # with the stripe's thresholds only (no entry sits at one, where the
        # plain version's other rounding could tip it)
        kw_e1 = dict(kw, scale_r=None, scale_c=None)
        for kw_l, plain in ((kw, True), (kw_e1, True), (_ragged_knn(xr, xc, ro, co), False),
                            (_ragged_knn(xr, xc, ro, co, kw["scale_r"], kw["scale_c"]), False)):
            live_l = block_liveness(xr, xc, **kw_l)
            a_l, d_l = affinity_and_degree(xr, xc, **kw_l)
            form = (f"ragged m={m_s} ({ro},{co}) scales={kw_l['scale_r'] is not None} "
                    f"kNN={not plain}")
            check(torch.equal(live_l, block_liveness(staged(xr), staged(xc), **kw_l))
                  and torch.equal(live_l.bool(), dense_block_live(a_l, 16, 256))
                  and (not plain or torch.equal(
                      live_l, ref.block_liveness_ref(xr, xc, tm=16, tn=256, **kw_l))),
                  f"{form}: #8 is not its staged template's and #1's map"
                  + (", and its plain version's" if plain else ""))
            # #11 on the form's own plan: its staged template's D, #6's, #1's
            plan_l = dict(zip(("counts", "col_idx"), block_plan(live_l)[:2]))
            d_11 = block_sparse_streaming_degree(xr, xc, **plan_l, **kw_l)
            check(torch.equal(d_11, block_sparse_streaming_degree(staged(xr), staged(xc),
                                                                  **plan_l, **kw_l))
                  and torch.equal(d_11, affinity_degree_streaming(xr, xc, **kw_l))
                  and torch.equal(d_11, d_l),
                  f"{form}: #11 is not bitwise its staged template, #6 and #1's D")
        counts, col_idx, _ = block_plan(live)
        plan = dict(counts=counts, col_idx=col_idx)
        for r in RAGGED_R:
            v = torch.rand((xc.shape[0], r), generator=g, device="cuda")
            check(torch.equal(block_sparse_matmat(a, v, d, counts, col_idx),
                              degree_normalized_matmat(a, v, d)),
                  f"ragged ({ro},{co}) r={r}: #9 is not bitwise #2")
            for dn in (d, None):
                u = block_sparse_streaming_matmat(xr, v, dn, xc, **plan, **kw)
                check(torch.equal(u, affinity_matmat(xr, v, dn, xc, **kw)),
                      f"ragged ({ro},{co}) r={r}: #10 is not bitwise #5")
                check(torch.equal(u, block_sparse_streaming_matmat(
                    staged(xr), v, dn, staged(xc), **plan, **kw)), f"ragged m={m_s} ({ro},{co}) r={r}: #10's "
                      "register template is not bitwise its staged template")
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
    print(f"[block_sparse] ragged (1037, m) square, (300, 737) off-diagonal and (337, 900) "
          f"below-diagonal stripes, m=16,{register_m()}, scales + thr: #8 = dense_block_live, "
          "#9 = #2, #10 = #5 and its staged template, #11 = #1's D bitwise, r=1,4,32; the "
          "fused build = the two-pass build; #8 = its staged template = dense_block_live "
          "(= its plain version) and #11 = its staged template = #6 = #1's D in E1's and "
          "E2's forms, with kNN thresholds too", flush=True)
    for name, err in worst.items():
        report[name]["max_abs_err"] = err
    report["block_sparse_streaming_matmat"]["registers"] = registers
    report["block_sparse_matmat"]["registers"] = bs_registers
    report["block_liveness"]["registers"] = live_registers
    report["block_sparse_streaming_degree"]["registers"] = deg_registers
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


# ---------------------------------------------------------------------------
# bf16 A storage (#1, #2, #9; the reference's a_dtype=bfloat16, its O4) and
# the resumable supervisor
# ---------------------------------------------------------------------------

#: columns of the bf16 ragged stripes: the bulk stores and the cp.async ring
#: need 16-byte rows, n_cols % 8 == 0 in bf16 (1,032); 1,037, 900 (a
#: multiple of 4, not of 8) and 737 take #1's register stores and #2's
#: plain loads
BF16_COLS = (1037, 1032, 900, 737)
#: the bf16 run's peak device memory against the f32 run's: A is half
PEAK_HALF = 0.55


def sweep_template_registers(log: str, kernel: str, dtype: str = "bf16") -> dict[str, str]:
    """Registers and spills of the templates of #2 (``power_step``) or #9
    (``bs_matmat``) on an A of ``dtype`` ("f32" or "bf16") in nvcc's report:
    ``{"RT=<r bucket> <ring|plain>": ...}``."""
    t = {"f32": "f", "bf16": "13__nv_bfloat16"}[dtype]
    return ptxas_registers(
        log, rf"{kernel}_kernelILi(\d+)ELb(\d)E{t}",
        lambda e: f"RT={e.group(1)} {'ring' if e.group(2) == '1' else 'plain'}")


def check_sweep_no_spill(tag: str, registers: dict[str, str],
                         templates=("ring", "plain")) -> None:
    """Fail on a spill of a template at r <= 2 (the main path), and where
    the report names not exactly ``templates`` at r = 1 and 2 (an f32 A
    takes #9's plain-load template alone)."""
    main = {t: line for t, line in registers.items() if t.split()[0] in ("RT=1", "RT=2")}
    check(set(main) == {f"RT={rt} {tmpl}" for rt in (1, 2) for tmpl in templates},
          f"nvcc's report names not the {templates} templates of {tag} at r = 1 and 2: "
          f"{registers}")
    spills = [f"{t}: {line}" for t, line in main.items() if not line.endswith(" 0 bytes spilled")]
    check(not spills, f"{tag}'s template spills on the main path: {spills}")


def shifted_copy(a):
    """A copy of ``a`` whose rows start one element off 16 bytes: #2's and
    #9's plain-load template."""
    out = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)[1:].view(a.shape)
    return out.copy_(a)


#: the r buckets of #9's templates, each checked for its bits
BS_R = (1, 2, 4, 8, 16, 32)


def check_bs_matmat_bits(tag, a, d, counts, col_idx, g, rs=BS_R) -> str:
    """#9 on A (f32 or bf16) bitwise #2 on the same A, #2 on ``a.float()``
    and its own plain-load template (A shifted one element off 16 bytes) at
    each r of ``rs``; and a NaN of V in a column reaches exactly the rows
    whose plan row lists that column's tile, in both templates. Returns
    the template A itself takes ("ring" or "plain")."""
    from repro_torch.kernels.block_sparse import block_sparse_matmat, takes_ring
    from repro_torch.kernels.power_step import degree_normalized_matmat
    shifted = shifted_copy(a)
    check(not takes_ring(shifted), f"{tag}: a shifted A takes #9's ring")
    tmpl = "ring" if takes_ring(a) else "plain"
    af = a.float()
    n_rows, n_cols = a.shape
    for r in rs:
        v = torch.rand((n_cols, r), generator=g, device="cuda") / n_cols
        u = block_sparse_matmat(a, v, d, counts, col_idx)
        check(torch.equal(u, degree_normalized_matmat(a, v, d)),
              f"{tag} r={r}: #9 ({tmpl}) is not bitwise #2 on the same A")
        check(torch.equal(u, degree_normalized_matmat(af, v, d)),
              f"{tag} r={r}: #9 ({tmpl}) is not bitwise #2 on a.float()")
        check(torch.equal(u, block_sparse_matmat(shifted, v, d, counts, col_idx)),
              f"{tag} r={r}: #9's {tmpl} and plain-load templates differ")
    # a NaN of V at a column of the first listed tile of the middle row block
    n_j = col_idx.shape[1]
    listed = (torch.arange(n_j, device="cuda")[None, :] < counts[:, None].clamp(max=n_j))
    rb = counts.shape[0] // 2
    tile = int(col_idx[rb, 0]) if int(counts[rb]) > 0 else 0
    j = min(tile * 256 + 7, n_cols - 1)
    want = (listed & (col_idx == j // 256)).any(1).repeat_interleave(16)[:n_rows]
    v = torch.rand((n_cols, 2), generator=g, device="cuda") / n_cols
    v[j, 1] = float("nan")
    for aa, form in ((a, tmpl), (shifted, "plain")):
        bad = ~torch.isfinite(block_sparse_matmat(aa, v, d, counts, col_idx)).all(1)
        check(torch.equal(bad, want), f"{tag}: a NaN of V at column {j} reaches "
              f"{int(bad.sum())} rows in #9's {form} template, not the {int(want.sum())} "
              "rows whose plan lists its tile")
    return tmpl


def bf16_ulps(a, b) -> int:
    """The most bf16 ulps by which two bf16 tensors differ entrywise (the
    bit patterns as ordered integers, +0 and -0 both 0)."""
    def ordered(t):
        bits = t.view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((ordered(a) - ordered(b)).abs().max())


def _plain_bf16_affinity_stripes(x, thr, stripe=4096):
    from repro_torch.kernels import ref
    for r0 in range(0, x.shape[0], stripe):
        ref.affinity_and_degree_ref(x[r0:r0 + stripe], x, kind="rbf", sigma=SIGMA,
                                    row_offset=r0, out_dtype=torch.bfloat16,
                                    thr=None if thr is None else thr[r0:r0 + stripe])


def phase_bf16_kernels(kernels, logs):
    """bf16 A through #1, #2 and #9 at the main path's shape (gaussians,
    n = 45,000, rbf sigma 0.3) and on ragged stripes (m = 16 and 2,
    ``BF16_COLS``, rows 100..400 off the diagonal too): #1's bf16 A bitwise
    its f32 A rounded (``.to(torch.bfloat16)``, round to nearest even) and
    its D bitwise the f32 call's D, dense and with E1's thresholds, and
    bitwise its plain version at m = 2 (within one bf16 ulp of it at
    m = 16, where the f32 entries differ by f32 rounding); #2's and #9's U
    on a bf16 A bitwise the
    same kernel on ``a.float()``, #2's ring bitwise its plain-load template
    (A shifted 2 bytes off 16), #9 bitwise #2 on the same A and its own
    plain-load template in f32 and bf16 in every r bucket (at E1, and on
    the stripes with their plan, every third row block emptied and every
    tile live; ``check_bs_matmat_bits``), each within its tolerance of its
    plain version; the bf16 A's live tiles (``dense_block_live``) those of
    the f32 A. Each timed beside its plain version and its bf16 bound (A's
    bytes at 2 a entry), #9 in both templates. ``logs`` holds nvcc's
    reports: no bf16 template of #2 or #9 may spill at r <= 2."""
    from repro_torch.core.affinity import AffinitySpec, block_plan, dense_block_live
    from repro_torch.core.graph import affinity_stats
    from repro_torch.kernels import ref
    from repro_torch.kernels.affinity import affinity_and_degree
    from repro_torch.kernels.block_sparse import block_sparse_matmat
    from repro_torch.kernels.power_step import degree_normalized_matmat
    bf = torch.bfloat16
    for tag, log, kernel in (("#2", logs["power_step"], "power_step"),
                             ("#9", logs["block_sparse"], "bs_matmat")):
        registers = sweep_template_registers(log, kernel)
        for tmpl, line in registers.items():
            print(f"[bf16] {tag} {tmpl}: {line}")
        check_sweep_no_spill(tag + " bf16", registers)
    feats, _, _ = _features(N_MAIN)
    x = feats["rbf"]
    n, m = x.shape
    g = torch.Generator(device="cuda").manual_seed(23)
    _, thr = affinity_stats(x, AffinitySpec(**E1_SPEC))
    made = kernels["policy"]["knn"]["expf_made"]
    rec1, stored = {}, {}
    for tag, t in (("dense", None), ("E1", thr)):
        a, d = affinity_and_degree(x, kind="rbf", sigma=SIGMA, thr=t)
        ab, db = affinity_and_degree(x, kind="rbf", sigma=SIGMA, thr=t, out_dtype=bf)
        torch.cuda.synchronize()
        check(torch.equal(ab, a.to(bf)), f"#1 bf16 {tag}: A is not the f32 A rounded")
        check(torch.equal(db, d), f"#1 bf16 {tag}: D is not the f32 call's D")
        live32 = dense_block_live(a, 16, 256) if t is not None else None
        del a
        err = 0.0
        for r0 in range(0, n, 4096):
            a_ref, _ = ref.affinity_and_degree_ref(
                x[r0:r0 + 4096], x, kind="rbf", sigma=SIGMA, row_offset=r0, out_dtype=bf,
                thr=None if t is None else t[r0:r0 + 4096])
            err = max(err, float((ab[r0:r0 + 4096].float() - a_ref.float()).abs().max()))
            del a_ref
        check(err == 0.0, f"#1 bf16 {tag}: A is not bitwise its plain version's")
        ms = cuda_ms(lambda: affinity_and_degree(x, kind="rbf", sigma=SIGMA, thr=t,
                                                 out_dtype=bf), 5)
        plain = cuda_ms(lambda: _plain_bf16_affinity_stripes(x, t), 2)
        ops = (affinity_flops(n, n, m, "rbf") if t is None
               else skip_flops(n * n, m, made, False))
        b, by = bound_ms(4.0 * (n * m + n + (0 if t is None else n)) + 2.0 * n * n, ops)
        mufu = mufu_bound_ms(n * n * (1.0 if t is None else made))
        rec1[tag] = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, mufu_bound_ms=mufu,
                         max_abs_err=err)
        print(f"[bf16] #1 n={n} rbf {tag}: A bitwise the f32 A rounded and the plain "
              f"version's, D bitwise the f32 D; kernel_ms={ms:.4f} plain_ms={plain:.4f} "
              f"bound_ms={b:.4f} ({by}) mufu_bound_ms={mufu:.4f}", flush=True)
        stored[tag] = (ab, db, live32)
        torch.cuda.empty_cache()

    # #2 on the dense bf16 A: the f32 upcast's bits, the ring's bits off 16 bytes
    a, d, _ = stored.pop("dense")
    af = a.float()
    v1 = (d / d.sum())[:, None].contiguous()
    v2 = torch.cat([v1, torch.rand((n, 1), generator=g, device="cuda") / n], dim=1)
    shifted = torch.empty(n * n + 1, dtype=bf, device="cuda")[1:].view(n, n)
    shifted.copy_(a)
    for v in (v1, v2):
        u = degree_normalized_matmat(a, v, d)
        check(torch.equal(u, degree_normalized_matmat(af, v, d)),
              f"#2 bf16 r={v.shape[1]}: U is not #2's U on the f32 upcast")
        check(torch.equal(u, degree_normalized_matmat(shifted, v, d)),
              f"#2 bf16 r={v.shape[1]}: the ring and plain-load templates differ")
    del af
    err2, exc2 = _u_errors(degree_normalized_matmat(a, v1, d),
                           ref.degree_normalized_matmat_ref(a, v1, d))
    check(exc2 <= 0.0, "#2 bf16 disagrees with its plain version")
    ms = cuda_ms(lambda: degree_normalized_matmat(a, v1, d), 10)
    plain = cuda_ms(lambda: ref.degree_normalized_matmat_ref(a, v1, d), 5)
    plain_load = cuda_ms(lambda: degree_normalized_matmat(shifted, v1, d), 10)
    ms2 = cuda_ms(lambda: degree_normalized_matmat(a, v2, d), 10)
    b, by = bound_ms(2.0 * n * n + 4.0 * (n + n + n), 2.0 * n * n)
    rec2 = dict(ms=ms, r2_ms=ms2, plain_ms=plain, plain_load_ms=plain_load, bound_ms=b,
                bound_by=by, max_abs_err=err2)
    print(f"[bf16] #2 n={n}: U bitwise #2 on a.float() and across its ring and plain-load "
          f"templates (r = 1, 2); max|U-U_ref|={err2:.3e}; kernel_ms={ms:.4f} (r=2 "
          f"{ms2:.4f}) plain_load_ms={plain_load:.4f} plain_ms={plain:.4f} bound_ms={b:.4f} "
          f"({by})", flush=True)
    del a, d, shifted
    torch.cuda.empty_cache()

    # #9 on E1's bf16 A: its live set is the f32 build's; #9 bitwise its upcast and #2
    a, d, live32 = stored.pop("E1")
    live = dense_block_live(a, 16, 256)
    check(torch.equal(live, live32), "E1: the bf16 A's live tiles are not the f32 A's")
    counts, col_idx, _ = block_plan(live)
    entries = _plan_entries(live, n, n)
    af = a.float()
    v1 = (d / d.sum())[:, None].contiguous()
    v2 = torch.cat([v1, torch.rand((n, 1), generator=g, device="cuda") / n], dim=1)
    for v in (v1, v2):
        check(torch.equal(block_sparse_matmat(a, v, d, counts, col_idx),
                          block_sparse_matmat(af, v, d, counts, col_idx)),
              f"#9 bf16 r={v.shape[1]}: U is not #9's U on the f32 upcast")
    del af
    tmpl9 = check_bs_matmat_bits("#9 bf16 E1", a, d, counts, col_idx, g)
    err9, exc9 = _u_errors(block_sparse_matmat(a, v2, d, counts, col_idx),
                           ref.block_sparse_matmat_ref(a, v2, d, counts, col_idx, tm=16, tn=256))
    check(exc9 <= 0.0, "#9 bf16 disagrees with its plain version")
    ms = cuda_ms(lambda: block_sparse_matmat(a, v2, d, counts, col_idx), 20)
    ms1 = cuda_ms(lambda: block_sparse_matmat(a, v1, d, counts, col_idx), 20)
    shifted = shifted_copy(a)
    plain_load = cuda_ms(lambda: block_sparse_matmat(shifted, v2, d, counts, col_idx), 20)
    plain_load1 = cuda_ms(lambda: block_sparse_matmat(shifted, v1, d, counts, col_idx), 20)
    del shifted
    plain = cuda_ms(lambda: ref.block_sparse_matmat_ref(a, v2, d, counts, col_idx, tm=16,
                                                        tn=256), 3)
    plan_bytes = 4.0 * (counts.numel() + float(counts.sum()))
    b, by = bound_ms(2.0 * entries + 4.0 * (2 * n * 2 + n) + plan_bytes, 2.0 * 2 * entries)
    rec9 = dict(ms=ms, r1_ms=ms1, template=tmpl9, plain_load_ms=plain_load,
                plain_load_r1_ms=plain_load1, plain_ms=plain, bound_ms=b, bound_by=by,
                max_abs_err=err9, live_fraction=float(live.float().mean()))
    print(f"[bf16] #9 E1 n={n}: live tiles equal to the f32 A's ({rec9['live_fraction']:.4f}); "
          f"U bitwise #9 on a.float(), #2 on the bf16 A and on a.float() and #9's plain-load "
          f"template (r = {', '.join(map(str, BS_R))}); max|U-U_ref|={err9:.3e}; "
          f"kernel_ms={ms:.4f} ({tmpl9}; r=1 {ms1:.4f}) plain_load_ms={plain_load:.4f} "
          f"(r=1 {plain_load1:.4f}) plain_ms={plain:.4f} bound_ms={b:.4f} ({by})", flush=True)
    del a, d
    torch.cuda.empty_cache()

    # ragged stripes: each bf16 form against the f32 call and its plain version
    xs = torch.randn((1037, 16), generator=g, device="cuda") * 0.25
    worst = dict.fromkeys(("#1", "#2", "#9"), 0.0)
    for xx in (xs, xs[:, :2].contiguous()):
        for rows, ro in ((slice(None), 0), (slice(100, 400), 100)):
            for cols in BF16_COLS:
                xr, xc = xx[rows].contiguous(), xx[:cols].contiguous()
                a, d = affinity_and_degree(xr, xc, kind="rbf", sigma=1.1, row_offset=ro)
                ab, db = affinity_and_degree(xr, xc, kind="rbf", sigma=1.1, row_offset=ro,
                                             out_dtype=bf)
                a_ref, _ = ref.affinity_and_degree_ref(xr, xc, kind="rbf", sigma=1.1,
                                                       row_offset=ro, out_dtype=bf)
                shape = f"{tuple(ab.shape)} m={xx.shape[1]}"
                check(torch.equal(ab, a.to(bf)) and torch.equal(db, d),
                      f"#1 bf16 ragged {shape}: not the f32 call rounded")
                # at m = 16 the f32 entries differ from the plain version's by
                # f32 rounding (A_ATOL), so the rounded ones by at most one ulp
                err1 = float((ab.float() - a_ref.float()).abs().max())
                ulps = bf16_ulps(ab, a_ref)
                check(ulps <= 1, f"#1 bf16 ragged {shape} is {ulps} bf16 ulps from its plain "
                      "version")
                for r in (4, 32):
                    v = torch.rand((cols, r), generator=g, device="cuda")
                    u = degree_normalized_matmat(ab, v, d)
                    check(torch.equal(u, degree_normalized_matmat(ab.float(), v, d)),
                          f"#2 bf16 ragged {shape} r={r}: not #2 on the f32 upcast")
                    err_u, exc = _u_errors(u, ref.degree_normalized_matmat_ref(ab, v, d))
                    check(exc <= 0.0, f"#2 bf16 ragged {shape} r={r} disagrees with plain")
                    worst["#2"] = worst["#9"] = max(worst["#2"], err_u)
                # #9 in f32 and bf16 on the stripe's plan, on a plan with every
                # third row block emptied (their rows of A zeroed for #2) and
                # on one with every tile live
                tmpls = set()
                for aa, dt in ((a, "f32"), (ab, "bf16")):
                    cnt, idx, _ = block_plan(dense_block_live(aa, 16, 256))
                    emptied = cnt.clone()
                    emptied[::3] = 0
                    a_e = aa.clone()
                    for rb in range(0, cnt.shape[0], 3):
                        a_e[16 * rb:16 * rb + 16] = 0
                    n_j = idx.shape[1]
                    every = (torch.full_like(cnt, n_j),
                             torch.arange(n_j, dtype=idx.dtype, device="cuda").expand_as(idx)
                             .contiguous())
                    for form, (aa_p, cnt_p, idx_p) in (("plan", (aa, cnt, idx)),
                                                       ("emptied", (a_e, emptied, idx)),
                                                       ("every tile", (aa, *every))):
                        tmpls.add(check_bs_matmat_bits(f"#9 {dt} ragged {shape} {form}", aa_p,
                                                       d, cnt_p, idx_p, g))
                worst["#1"] = max(worst["#1"], err1)
                print(f"[bf16] ragged a{shape} offsets=({ro},0): #1 bitwise the f32 call "
                      f"rounded, {ulps} bf16 ulp(s) from the plain version "
                      f"(max|A-A_ref|={err1:.3e}); #2 bitwise (r = 4, 32); #9 bitwise #2 and "
                      f"its plain-load template, f32 and bf16, r = {', '.join(map(str, BS_R))}, "
                      f"its plan, every third row block emptied and every tile live "
                      f"({'/'.join(sorted(tmpls))}), a NaN of V reaching exactly its rows")
    for rec, key in ((rec1["dense"], "#1"), (rec2, "#2"), (rec9, "#9")):
        rec["max_abs_err"] = max(rec["max_abs_err"], worst[key])
    kernels["affinity_and_degree"]["bf16"] = rec1
    kernels["degree_normalized_matmat"]["bf16"] = rec2
    kernels["block_sparse_matmat"]["bf16"] = rec9


def phase_bf16_e2e(report):
    """run_gpic with a_dtype=bfloat16 on the explicit engine: gaussians
    (rbf sigma 0.3, n = 45,000): ARI >= 0.99, column 0's sweeps within one
    of the f32 run's, peak memory at most PEAK_HALF of the f32 run's, #1
    once, #2 once a sweep; E1 block-sparse (orthogonal r = 2): the bf16
    fused build's live tiles and D those of the f32 build, its transient
    peak (f32 and bf16 A together), and the run's component count that of
    the f32 block-sparse run. Returns the launches of the two runs."""
    from repro_torch import GPICConfig, adjusted_rand_index, dataset_by_name
    from repro_torch.core.affinity import AffinitySpec, dense_block_live
    from repro_torch.core.graph import fused_affinity_build
    bf = torch.bfloat16
    f32 = report["e2e"]
    x, y, k = dataset_by_name("gaussians", N_MAIN, seed=0)
    cfg = GPICConfig(affinity_kind="rbf", sigma=SIGMA, max_iter=400, a_dtype=bf)
    res, labels, wall, counts, peak = _counted_run(x, k, cfg)
    sweeps, ari = int(res.n_iter), adjusted_rand_index(y, labels)
    print(f"[e2e] explicit gaussians bf16 A n={N_MAIN}: wall_s={wall:.4f} sweeps={sweeps} "
          f"(f32 {f32['sweeps']}) ARI={ari:.4f} peak_mem_GB={peak / 1e9:.3f} (f32 "
          f"{f32['peak_mem_bytes'] / 1e9:.3f}) launches={counts}", flush=True)
    check(labels.shape == (N_MAIN,) and bool(torch.isfinite(res.embedding).all()),
          "the bf16 result has the wrong shape or is not finite")
    check(ari >= 0.99, f"bf16 ARI {ari:.4f} < 0.99")
    check(abs(sweeps - f32["sweeps"]) <= 1, f"bf16 sweeps {sweeps} vs f32 {f32['sweeps']}")
    check(peak <= PEAK_HALF * f32["peak_mem_bytes"],
          f"bf16 peak {peak / 1e9:.3f} GB is not about half the f32 run's")
    check(counts["affinity_and_degree"] == 1 and counts["degree_normalized_matmat"] == sweeps
          and counts["kmeans_assign"] == cfg.kmeans_iters + 1, f"bf16 launches {counts}")
    out = dict(gaussians=dict(n=N_MAIN, wall_s=wall, sweeps=sweeps, ari=ari,
                              peak_mem_bytes=peak, launches=counts))

    xt = torch.as_tensor(x, device="cuda")
    spec = AffinitySpec(**E1_SPEC)
    a32, d32, _ = fused_affinity_build(xt, spec=spec)
    live32 = dense_block_live(a32, 16, 256)
    del a32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ab, db, _ = fused_affinity_build(xt, spec=spec, a_dtype=bf)
    torch.cuda.synchronize()
    fused_peak = torch.cuda.max_memory_allocated() - base
    live = dense_block_live(ab, 16, 256)
    check(torch.equal(live, live32) and torch.equal(db, d32),
          "E1: the bf16 fused build's live tiles or D are not the f32 build's")
    del ab, db, d32, xt
    torch.cuda.empty_cache()
    cfg_e1 = _graph_cfg(E1_SPEC, engine="explicit", embedding="orthogonal", n_vectors=2,
                        block_sparse=True, a_dtype=bf)
    rec, res_e1, _ = _graph_run("E1 block_sparse bf16 A", x, y, k, cfg_e1)
    c = rec["launches"]
    f32_e1 = report["e2e_block_sparse"]["E1"][0]
    check(c["affinity_and_degree"] == 1 and c["degree_normalized_matmat"] == 1
          and c["block_sparse_matmat"] > max(rec["n_iter_cols"]), f"E1 bf16 launches {c}")
    # the same kept entries: the same graph, components and probe hops
    check(rec["n_components"] == f32_e1["n_components"]
          and rec["probe_sweeps"] == f32_e1["probe_sweeps"],
          f"E1 bf16 components and probe hops {rec['n_components']}, {rec['probe_sweeps']} "
          f"vs f32 {f32_e1['n_components']}, {f32_e1['probe_sweeps']}")
    print(f"[e2e] E1 block_sparse bf16 A: live fraction {float(live.float().mean()):.4f} "
          f"(the f32 build's tiles); the fused build's transient peak "
          f"{fused_peak / 1e9:.3f} GB above its input; n_iter_cols {rec['n_iter_cols']} "
          f"(f32 {f32_e1['n_iter_cols']}); run peak {rec['peak_mem_bytes'] / 1e9:.3f} GB "
          f"(f32 {f32_e1['peak_mem_bytes'] / 1e9:.3f})", flush=True)
    out["E1_block_sparse"] = dict(rec, live_fraction=float(live.float().mean()),
                                  fused_build_peak_bytes=fused_peak)
    report["e2e_bf16"] = out
    return counts, c


def phase_resume(report, explicit):
    """The resumable supervisor on the main path's config (explicit
    gaussians, n = 45,000, ``checkpoint_every=5``): a fault injected at
    sweep 10 gives the uninterrupted run's labels, embedding, sweeps,
    convergence and health bit for bit, with the notes retry and resumed:10;
    a run killed there (max_retries=0) leaves snapshots a fresh call resumes
    from, bitwise; a straggler timeout raises StragglerTimeout. Walls of the
    supervised and monolithic runs; the checkpoint overhead at the
    reference robustness job's shape (benchmarks/bench_robustness.py:
    n = 1,024 2-D normal points, k = 3, max_iter=50, eps_scale=1e-9,
    ``checkpoint_every=25``; the median of 11 interleaved pairs; its 5%
    budget is recorded, not gated). Snapshots go under build/."""
    import shutil
    from repro_torch import GPICConfig, dataset_by_name, run_gpic
    from repro_torch.core.health import StragglerTimeout
    from repro_torch.train.fault_tolerance import FailureInjector, SimulatedFailure
    _, base, _ = explicit
    root = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    cfg = GPICConfig(affinity_kind="rbf", sigma=SIGMA, max_iter=400)
    x, _, k = dataset_by_name("gaussians", N_MAIN, seed=0)

    def same(res):
        return (all(torch.equal(getattr(res, f), getattr(base, f))
                    for f in ("labels", "embeddings", "n_iter_cols", "converged_cols"))
                and torch.equal(res.health.col_status, base.health.col_status)
                and int(res.health.isolated_rows) == int(base.health.isolated_rows))

    sup = cfg.with_(checkpoint_every=5, ckpt_dir=os.path.join(root, "fault"))
    inj = FailureInjector(fail_at_steps=(10,))
    res, _, wall_fault, counts, _ = _counted(
        lambda: run_gpic(x, k, sup, segment_injector=inj.maybe_fail))
    check(same(res), "the resumed run is not the uninterrupted run bit for bit")
    check(res.health.notes == ("retry:1:SimulatedFailure", "resumed:10"),
          f"resumed run notes {res.health.notes}")
    kill = cfg.with_(checkpoint_every=5, ckpt_dir=os.path.join(root, "kill"), max_retries=0)
    try:
        run_gpic(x, k, kill, segment_injector=FailureInjector(fail_at_steps=(10,)).maybe_fail)
        check(False, "a run with max_retries=0 survived an injected fault")
    except SimulatedFailure:
        pass
    res = run_gpic(x, k, kill)
    check(same(res) and "resumed:10" in res.health.notes,
          f"the fresh call did not resume bitwise: {res.health.notes}")
    try:
        run_gpic(x, k, cfg.with_(straggler_timeout=1e-9, max_retries=0))
        check(False, "a segment over its straggler_timeout did not raise")
    except StragglerTimeout:
        pass
    _, _, wall_mono, _, _ = _counted(lambda: run_gpic(x, k, cfg))
    _, _, wall_sup, _, _ = _counted(lambda: run_gpic(
        x, k, cfg.with_(checkpoint_every=5, ckpt_dir=os.path.join(root, "timed"))))
    print(f"[resume] explicit gaussians n={N_MAIN} checkpoint_every=5: a fault at sweep 10 "
          f"and a kill then a fresh call both bitwise the uninterrupted run; "
          f"StragglerTimeout raised; walls: monolithic {wall_mono:.4f} s, supervised "
          f"{wall_sup:.4f} s, with the fault {wall_fault:.4f} s; launches with the fault "
          f"{counts}", flush=True)

    xo = np.random.default_rng(3).normal(size=(1024, 2)).astype(np.float32)
    ocfg = GPICConfig(max_iter=50, eps_scale=1e-9)
    ock = ocfg.with_(checkpoint_every=25, ckpt_dir=os.path.join(root, "overhead"))

    def run_plain():
        return run_gpic(xo, 3, ocfg).labels.cpu()

    def run_ckpt():
        # a fresh directory a call: an old snapshot would resume past the loop
        shutil.rmtree(ock.ckpt_dir, ignore_errors=True)
        return run_gpic(xo, 3, ock).labels.cpu()

    check(torch.equal(run_ckpt(), run_plain()),
          "the supervised robustness-shape run differs from the monolithic one")
    pairs = []
    for _ in range(11):
        t0 = time.perf_counter()
        run_ckpt()
        on = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_plain()
        off = time.perf_counter() - t0
        pairs.append((100.0 * (on - off) / off, on, off))
    pct, on, off = sorted(pairs)[len(pairs) // 2]
    print(f"[resume] checkpoint overhead at n=1024 (50 sweeps, every 25): {pct:.2f}% "
          f"({on * 1e3:.3f} ms vs {off * 1e3:.3f} ms, median of 11 pairs; the reference's "
          f"budget 5%, recorded)", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    report["resume"] = dict(n=N_MAIN, wall_monolithic_s=wall_mono, wall_supervised_s=wall_sup,
                            wall_with_fault_s=wall_fault, overhead_pct=pct,
                            overhead_on_ms=on * 1e3, overhead_off_ms=off * 1e3)


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


def _counted(fn):
    """``fn()`` (a PICResult) with the launch counters set to 0 just before
    and read just after, and the peak device memory of the call. Returns
    (result, labels as numpy, wall seconds, counts, peak bytes)."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = fn()
    labels = res.labels.cpu().numpy()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    return res, labels, wall, counts, torch.cuda.max_memory_allocated()


def _counted_run(x, k, cfg):
    """run_gpic through :func:`_counted`."""
    from repro_torch import run_gpic
    return _counted(lambda: run_gpic(x, k, cfg))


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


def _launched_only(counts, expected):
    """Whether the run launched each kernel of ``expected`` as many times
    as it gives, and every other kernel never."""
    return all(counts[name] == expected.get(name, 0) for name in counts)


def _embedding_rel(res, res_e):
    """max|v - v_e| / max|v_e| of two results' column-0 embeddings."""
    return float((res.embedding - res_e.embedding).abs().max() / res_e.embedding.abs().max())


def phase_pic_reference(report, explicit):
    """The paper-faithful oracle path on the main path's config (rbf sigma
    0.3, gaussians, n = 45,000, max_iter=400): pic_reference (A by the
    plain affinity_matrix, W = D^-1 A stored, W @ V in cuBLAS, k-means on
    #3) against phase 3's explicit run; affinity_chunked against #1's A;
    pic_from_affinity on #1's A against the explicit run too."""
    from repro_torch import adjusted_rand_index, dataset_by_name
    from repro_torch.core import affinity_chunked, pic_from_affinity, pic_reference
    from repro_torch.kernels.affinity import affinity_and_degree
    _, res_e, _ = explicit
    x, y, k = dataset_by_name("gaussians", N_MAIN, seed=0)
    out = {}

    def held(tag, res, labels, wall, counts, peak):
        sweeps, rel = int(res.n_iter), _embedding_rel(res, res_e)
        ari = adjusted_rand_index(y, labels)
        print(f"[e2e] {tag} gaussians n={N_MAIN} rbf sigma={SIGMA}: wall_s={wall:.4f} "
              f"sweeps={sweeps} (explicit {int(res_e.n_iter)}) max|dv|/max|v|={rel:.3e} "
              f"ARI={ari:.4f} peak_mem_GB={peak / 1e9:.3f} launches={counts} "
              f"health: {res.health.summary()}", flush=True)
        check(bool(torch.isfinite(res.embedding).all()) and labels.shape == (N_MAIN,),
              f"{tag}: the result has the wrong shape or is not finite")
        check(abs(sweeps - int(res_e.n_iter)) <= 1 and rel <= 1e-4,
              f"{tag} disagrees with the explicit run")
        check(ari >= 0.99, f"{tag} ARI {ari:.4f} < 0.99")
        check(_launched_only(counts, {"kmeans_assign": 26}), f"{tag} launches {counts}")
        out[tag] = dict(wall_s=wall, sweeps=sweeps, rel_err=rel, ari=ari, peak_mem_bytes=peak,
                        launches=counts)

    gen = torch.Generator(device="cuda")
    held("pic_reference", *_counted(lambda: pic_reference(
        x, k, affinity_kind="rbf", sigma=SIGMA, max_iter=400, generator=gen.manual_seed(0))))
    xt = torch.as_tensor(x, device="cuda")
    a, _ = affinity_and_degree(xt, kind="rbf", sigma=SIGMA)
    chunked = affinity_chunked(xt, "rbf", sigma=SIGMA, chunk=4096)
    err = max(float((chunked[r0:r0 + 4096] - a[r0:r0 + 4096]).abs().max())
              for r0 in range(0, N_MAIN, 4096))
    del chunked
    print(f"[e2e] affinity_chunked (chunk 4,096) vs #1's A: max|A-A_1|={err:.3e}", flush=True)
    check(err <= A_ATOL, "affinity_chunked disagrees with #1's A")
    held("pic_from_affinity", *_counted(lambda: pic_from_affinity(
        a, k, max_iter=400, generator=gen.manual_seed(0))))
    del a
    torch.cuda.empty_cache()
    report["e2e_pic_reference"] = dict(out, affinity_chunked_max_abs_err=err)


def phase_matrix_free(report):
    """The matrix-free engine: its factored product against #1's stored
    cosine_shifted A at n = 45,000 (r = 1, 2), run_gpic on it against the
    explicit engine there, then quickstart's n = 100,000 run (k = 3,
    max_iter=50) as pic and as the orthogonal r = 2 block: no affinity,
    sweep or streaming kernel, #3 kmeans_iters + 1 times, #4 once a QR
    sweep, peak memory under 1 GB."""
    from repro_torch import GPICConfig, dataset_by_name
    from repro_torch.core import matmat_matrix_free, row_normalize_features
    from repro_torch.kernels.affinity import affinity_and_degree
    x, _, k = dataset_by_name("gaussians", N_MAIN, seed=0)
    xn = row_normalize_features(torch.as_tensor(x, device="cuda"))
    a, _ = affinity_and_degree(xn, kind="cosine_shifted")
    g = torch.Generator(device="cuda").manual_seed(3)
    products = {}
    for r in (1, 2):
        v = torch.rand((N_MAIN, r), generator=g, device="cuda")
        got, want = matmat_matrix_free(xn, v), torch.matmul(a, v)
        diff = (got - want).abs()
        scale = float(want.abs().max())
        # the reference test's atol 2e-4 and rtol 1e-4, scaled by max|A V|
        excess = float((diff - 1e-4 * want.abs()).max()) - 2e-4 * scale
        ms = cuda_ms(lambda: matmat_matrix_free(xn, v), 10)
        print(f"[matrix_free] n={N_MAIN} r={r}: max|AV_mf - A V|={float(diff.max()):.3e} "
              f"max|A V|={scale:.3e} excess over tolerance={excess:.3e}; "
              f"product {ms:.4f} ms", flush=True)
        check(excess <= 0.0, f"the matrix-free product disagrees with #1's A at r={r}")
        products[r] = dict(max_abs_err=float(diff.max()), scale=scale, excess=excess, ms=ms)
    del a
    torch.cuda.empty_cache()

    runs = {}
    for engine in ("explicit", "matrix_free"):
        res, labels, wall, counts, peak = _counted_run(x, k, GPICConfig(engine=engine,
                                                                          max_iter=400))
        runs[engine] = res
        print(f"[e2e] {engine} gaussians n={N_MAIN} cosine_shifted: wall_s={wall:.4f} "
              f"sweeps={int(res.n_iter)} peak_mem_GB={peak / 1e9:.3f} launches={counts}",
              flush=True)
        report[f"e2e_{engine}_cosine_shifted"] = dict(wall_s=wall, sweeps=int(res.n_iter),
                                                      peak_mem_bytes=peak, launches=counts)
    mf, ex = runs["matrix_free"], runs["explicit"]
    # the reference's rule for the two engines (tests/test_gpic.py)
    emb_ok = bool(torch.allclose(mf.embedding, ex.embedding, atol=1e-6, rtol=1e-4))
    print(f"[e2e] matrix_free vs explicit n={N_MAIN}: sweeps {int(mf.n_iter)} vs "
          f"{int(ex.n_iter)}, max|dv|={float((mf.embedding - ex.embedding).abs().max()):.3e}, "
          f"embedding within atol 1e-6 rtol 1e-4: {emb_ok}", flush=True)
    check(abs(int(mf.n_iter) - int(ex.n_iter)) <= 1 and emb_ok,
          "the matrix-free and explicit engines disagree")
    del runs, mf, ex

    x, _, _ = dataset_by_name("gaussians", N_MF, seed=0)
    big = []
    for cfg in (GPICConfig(engine="matrix_free", max_iter=50),
                GPICConfig(engine="matrix_free", max_iter=50, n_vectors=2,
                           embedding="orthogonal")):
        res, labels, wall, counts, peak = _counted_run(x, 3, cfg)
        cols = res.n_iter_cols.tolist()
        qr_sweeps = max(cols) if cfg.embedding == "orthogonal" else 0
        print(f"[e2e] matrix_free gaussians n={N_MF} k=3 {cfg.embedding} r={cfg.n_vectors}: "
              f"wall_s={wall:.4f} n_iter_cols={cols} peak_mem_GB={peak / 1e9:.3f} "
              f"launches={counts}", flush=True)
        check(bool(torch.isfinite(res.embeddings).all()) and labels.shape == (N_MF,),
              f"the n={N_MF} matrix-free result has the wrong shape or is not finite")
        check(peak < MEM_LIMIT, f"matrix-free n={N_MF} peak memory {peak / 1e9:.3f} GB >= 1 GB")
        expected = {"kmeans_assign": cfg.kmeans_iters + 1}
        if qr_sweeps:
            expected["gram"] = qr_sweeps       # no residual rule: no residual checks
        check(_launched_only(counts, expected),
              f"matrix-free n={N_MF} launches {counts}, expected {expected}")
        big.append(dict(embedding=cfg.embedding, n_vectors=cfg.n_vectors, wall_s=wall,
                        n_iter_cols=cols, peak_mem_bytes=peak, launches=counts))
    report["matrix_free"] = dict(products=products, quickstart=big)


def phase_serial_vs_gpic(report):
    """The paper's Table 2 comparison at one n: the serial float64 numpy
    PIC (row loops) against run_gpic on the card, same features (gaussians,
    rbf sigma 0.3, max_iter=50). The serial embedding must be
    pic_from_affinity's within 1e-4 of max|v|, and both partitions at
    ARI >= 0.99."""
    from repro_torch import GPICConfig, adjusted_rand_index, dataset_by_name
    from repro_torch.core import affinity_matrix, pic_from_affinity, pic_serial_numpy
    x, y, k = dataset_by_name("gaussians", N_SERIAL, seed=0)
    labels_s, v_s, tim = pic_serial_numpy(x, k, affinity_kind="rbf", sigma=SIGMA, max_iter=50,
                                          return_timings=True)
    cfg = GPICConfig(affinity_kind="rbf", sigma=SIGMA, max_iter=50)
    _counted_run(x, k, cfg)                                    # warm-up at this n
    res, labels, wall, counts, peak = _counted_run(x, k, cfg)
    a = affinity_matrix(torch.as_tensor(x, device="cuda"), "rbf", sigma=SIGMA)
    res_pa = pic_from_affinity(a, k, max_iter=50,
                               generator=torch.Generator(device="cuda").manual_seed(0))
    del a
    v_pa = res_pa.embedding.double().cpu().numpy()
    rel = float(np.abs(v_s - v_pa).max() / np.abs(v_s).max())
    ari_s, ari_g = adjusted_rand_index(y, labels_s), adjusted_rand_index(y, labels)
    ratio = tim["total_s"] / wall
    print(f"[serial] gaussians n={N_SERIAL} rbf sigma={SIGMA}: serial numpy (float64) "
          + " ".join(f"{key}={val:.4f}" for key, val in tim.items() if key != "n_iter")
          + f" sweeps={tim['n_iter']} ARI={ari_s:.4f}; GPIC on the card wall_s={wall:.4f} "
          f"sweeps={int(res.n_iter)} ARI={ari_g:.4f} launches={counts}; serial/GPIC = "
          f"{ratio:.1f}; serial vs pic_from_affinity max|dv|/max|v|={rel:.3e} "
          f"(sweeps {tim['n_iter']} vs {int(res_pa.n_iter)})", flush=True)
    check(rel <= 1e-4, "the serial embedding disagrees with pic_from_affinity's")
    check(min(ari_s, ari_g) >= 0.99, f"serial ARI {ari_s:.4f}, GPIC ARI {ari_g:.4f} < 0.99")
    report["serial_vs_gpic"] = dict(n=N_SERIAL, serial=tim, serial_ari=ari_s, gpic_wall_s=wall,
                                    gpic_sweeps=int(res.n_iter), gpic_ari=ari_g,
                                    gpic_launches=counts, ratio=ratio, rel_err=rel)


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


def ptxas_registers(log: str, entry_re: str, label) -> dict[str, str]:
    """Registers and spills of each kernel entry in nvcc's ``-Xptxas -v``
    report whose mangled name matches ``entry_re``: ``{label(match): "R
    registers, S bytes spilled"}``."""
    out, tmpl, spill = {}, None, "?"
    for line in log.splitlines():
        entry = re.search(entry_re, line) if "Compiling entry function" in line else None
        spilled = re.search(r"(\d+) bytes spill stores", line)
        regs = re.search(r"Used (\d+) registers", line)
        if entry:
            tmpl = label(entry)
        elif spilled:
            spill = spilled.group(1)
        elif regs and tmpl:
            out[tmpl] = f"{regs.group(1)} registers, {spill} bytes spilled"
            tmpl = None
    return out


def flash_registers(log: str) -> dict[str, str]:
    """Registers and spills of each kernel-12 template in nvcc's report:
    ``{"<q type>/<k, v type> NT=<d / 8> <async|scalar>": "R registers, S
    bytes spilled"}``."""
    types = {"f": "f32", "13__nv_bfloat16": "bf16", "S1_": "bf16"}
    return ptxas_registers(
        log, r"flash_kernelI(f|13__nv_bfloat16)(f|13__nv_bfloat16|S1_)Li(\d+)ELb(\d)",
        lambda e: (f"{types[e.group(1)]}/{types[e.group(2)]} NT={e.group(3)} "
                   f"{'async' if e.group(4) == '1' else 'scalar'}"))


def sweep_registers(log: str, block_sparse: bool) -> dict[str, str]:
    """Registers and spills of each template of the streamed mat-mat (#5,
    ``block_sparse``: #10) in nvcc's report: ``{"RT=<r bucket> <fixed|policy>
    <register|staged>": ...}`` (the register template is the kernel named
    ``*_reg_kernel``)."""
    name = "bs_streaming_matmat" if block_sparse else "streaming_matmat"
    return ptxas_registers(
        log, rf"\d+{name}(_reg)?_kernelILi(\d+)ELb(\d)E",
        lambda e: (f"RT={e.group(2)} {'policy' if e.group(3) == '1' else 'fixed'} "
                   f"{'register' if e.group(1) else 'staged'}"))


def entry_registers(log: str, name: str) -> dict[str, str]:
    """Registers and spills of each template of #1 (``name`` = ``affinity``),
    #6 (``streaming_degree``), #8 (``liveness``) or #11
    (``bs_streaming_degree``) in nvcc's report: ``{"<fixed|policy>[ bulk][
    bf16] <register|staged>": ...}`` (the register template is the kernel
    named ``*_reg_kernel``; #1's takes a second flag, its bulk-copy stores,
    and the type it stores A in)."""
    return ptxas_registers(
        log, rf"\d+{name}(_reg)?_kernelILb(\d)E(Lb(\d)E)?(13__nv_bfloat16)?",
        lambda e: (f"{'policy' if e.group(2) == '1' else 'fixed'}"
                   f"{' bulk' if e.group(4) == '1' else ''}"
                   f"{' bf16' if e.group(5) else ''} "
                   f"{'register' if e.group(1) else 'staged'}"))


def check_no_entry_spill(tag: str, registers: dict[str, str],
                         forms=("fixed", "policy")) -> None:
    """Fail on a spill in the register template of #1, #6, #8 or #11, in
    any of its ``forms``, and where the report names no such template."""
    reg = {tmpl: line for tmpl, line in registers.items() if tmpl.endswith("register")}
    check(set(reg) == {f"{form} register" for form in forms},
          f"nvcc's report names no register template of {tag} in the forms {forms}: "
          f"{registers}")
    spills = [f"{tmpl}: {line}" for tmpl, line in reg.items()
              if not line.endswith(" 0 bytes spilled")]
    check(not spills, f"{tag}'s register template spills: {spills}")


def check_no_spill(tag: str, registers: dict[str, str]) -> None:
    """Fail on a spill in a register template of the main path (r <= 2),
    and where the report names no such template."""
    main = {tmpl: line for tmpl, line in registers.items()
            if tmpl.split()[0] in ("RT=1", "RT=2") and tmpl.endswith("register")}
    check({t.split()[0] for t in main} == {"RT=1", "RT=2"},
          f"nvcc's report names no register template of {tag} at r = 1 and 2: {registers}")
    spills = [f"{tmpl}: {line}" for tmpl, line in main.items()
              if not line.endswith(" 0 bytes spilled")]
    check(not spills, f"{tag}'s register template spills on the main path: {spills}")


def phase_flash_attention(report, build_log=""):
    """Kernel 12 against its plain version at the serve path's shape and
    layout, and at ragged, GQA, MQA, full, bf16, unaligned (the
    scalar-staging template) and b h > 65,535 ones, and at seamless's (h 16,
    d 64: its encoder's full attention, its decoder's causal prefill over
    the cache); timed at the serve shape beside SDPA (a yardstick; the port
    never calls it). ``build_log`` is nvcc's report of flash_attention.cu:
    no template may spill at d = 64 (NT = 8), 80 (NT = 10) or 128 (NT =
    16)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    registers = flash_registers(build_log)
    for tmpl, line in registers.items():
        print(f"[flash] {tmpl}: {line}")
    main = {tmpl: line for tmpl, line in registers.items()
            if tmpl.split()[1] in ("NT=8", "NT=10", "NT=16")}
    check({t.split()[1] for t in main} == {"NT=8", "NT=10", "NT=16"},
          f"nvcc's report names no flash_attention template at d = 64, 80 and 128: "
          f"{registers}")
    spills = [f"{tmpl}: {line}" for tmpl, line in main.items()
              if not line.endswith(" 0 bytes spilled")]
    check(not spills, f"flash_attention spills at d = 64, 80 or 128: {spills}")
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
        ("seamless encoder, full, f32 views", (4, 16, 16, 2048, 64), f32, f32, False, True),
        ("seamless decoder prefill, bf16 cache views", (4, 16, 16, 2048, 64), f32, bf16, True,
         True),
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


FA_GRAD_F32_REL = 1e-5      # an f32 gradient, relative to its max|grad_ref|
FA_GRAD_BF16_REL = 2.0 ** -6  # a bf16 gradient: two bf16 steps at the top of its range
FA_LSE_TOL = (1e-5, 1e-6)   # (atol, rtol) of the forward's row log-sum-exp
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "stablelm-3b", 2, 1024, 3
#: seamless-m4t-large-v2's attention in a training step: (b, h, s, d), f32
SEAMLESS_BWD_SHAPE = (TRAIN_BATCH, 16, TRAIN_SEQ, 64)
BWD_LABELS = {"flash_attention_bwd_delta": "delta_kernel",
              "flash_attention_bwd_dkdv": "dkdv_kernel",
              "flash_attention_bwd_dq": "dq_kernel"}


def _pairs(s: int, causal: bool) -> float:
    return s * (s + 1) / 2 if causal else s * s


#: the products of the backward (S = Q K^T, dP = dO V^T, dV = P^T dO,
#: dK = dS^T Q, dQ = dS K) each kernel computes: both rebuild S and dP
BWD_PRODUCTS = {"flash_attention_bwd_dkdv": ("S", "dP", "dV", "dK"),
                "flash_attention_bwd_dq": ("S", "dP", "dQ"),
                "whole": ("S", "dP", "dV", "dK", "dQ")}


def flash_bwd_bounds(q, k, causal) -> dict[str, dict]:
    """Bounds of each backward kernel's call and of the whole backward
    (``"whole"``: its five distinct products). Bytes: each input read once
    and each output written once. ``bound_ms``: each product as its
    split-TF32 terms at the TF32 tensor rate, the forward's convention
    (``flash_tensor_bound``: 1 + one term for each f32 operand; P and dS are
    f32, dO has q's type), or the bytes if they take longer;
    ``f32_fma_bound_ms``: the products on the f32 FMA units. A product is
    2 d operations per visible (query, key) pair and query head. D (2 d a
    row, no product) is bounded by its bytes against the f32 FMA rate."""
    s, d = q.shape[-2:]
    heads = q.numel() // (s * d)
    qb, kb = q.numel() * q.element_size(), k.numel() * k.element_size()
    rows4 = 4 * heads * s                       # one f32 a row: L or D
    pair_ops = 2.0 * d * _pairs(s, causal) * heads
    fq, fk = int(q.dtype == torch.float32), int(k.dtype == torch.float32)
    terms = {"S": 1 + fq + fk, "dP": 1 + fq + fk, "dV": 2 + fq, "dK": 2 + fq, "dQ": 2 + fk}
    n_bytes = {"flash_attention_bwd_dkdv": 2 * qb + 2 * kb + 2 * rows4 + 2 * kb,
               "flash_attention_bwd_dq": 2 * qb + 2 * kb + 2 * rows4 + qb,
               "whole": 3 * qb + 2 * kb + rows4 + qb + 2 * kb}
    out = {}
    for op, products in BWD_PRODUCTS.items():
        t_bytes = n_bytes[op] / H100_BYTES_PER_S * 1e3
        t_ops = sum(terms[p] for p in products) * pair_ops / H100_TF32_FLOPS * 1e3
        out[op] = dict(zip(("bound_ms", "bound_by"), (t_bytes, "bytes") if t_bytes >= t_ops
                           else (t_ops, "operations")),
                       f32_fma_bound_ms=bound_ms(n_bytes[op], len(products) * pair_ops)[0])
    bnd, by = bound_ms(2 * qb + rows4, 2.0 * d * heads * s)
    out["flash_attention_bwd_delta"] = dict(bound_ms=bnd, bound_by=by)
    return out


def _grad_errors(got, want) -> list[float]:
    """max|g - g_ref| / max|g_ref| of each gradient, held to its type's
    tolerance (an f32 gradient f32-level, a bf16 one bf16-level)."""
    errs = []
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"a gradient has the wrong shape or type: {g.shape} {g.dtype}, {w.shape} {w.dtype}")
        check(bool(torch.isfinite(g).all()), "a backward kernel gives a non-finite gradient")
        rel = float((g.float() - w.float()).abs().max() / w.float().abs().max().clamp_min(1e-30))
        limit = FA_GRAD_BF16_REL if g.dtype == torch.bfloat16 else FA_GRAD_F32_REL
        check(rel <= limit, f"a backward kernel's gradient parts from the plain backward by "
                            f"{rel:.3e} of its max (limit {limit:.3e})")
        errs.append(rel)
    return errs


def _f64_backward(q, k, v, out, lse, dout, causal):
    """(dq, dk, dv) of kernel 12 in float64 from the same output and L:
    the backward's algebra without rounding, which the kernels and the plain
    version are each read against."""
    rep = q.shape[-3] // k.shape[-3]
    s, d = q.shape[-2:]
    qd, od, dod = q.double(), out.double(), dout.double()
    kd, vd = (t.double().repeat_interleave(rep, dim=-3) for t in (k, v))
    scale = 1.0 / math.sqrt(d)
    p = torch.exp(qd @ kd.transpose(-1, -2) * scale - lse.double()[..., None])
    if causal:
        p = p.masked_fill(torch.ones((s, s), dtype=torch.bool, device=q.device).triu(1), 0.0)
    ds = p * (dod @ vd.transpose(-1, -2) - (dod * od).sum(-1)[..., None])
    per_kv = (k.shape[-3], rep)
    return (ds @ kd * scale,
            (ds.transpose(-1, -2) @ qd * scale).unflatten(-3, per_kv).sum(-3),
            (p.transpose(-1, -2) @ dod).unflatten(-3, per_kv).sum(-3))


def _rel_errors(got, want) -> list[float]:
    """max|g - w| / max|w| of each gradient, in float64."""
    return [float((g.double() - w.double()).abs().max() / w.double().abs().max())
            for g, w in zip(got, want)]


def phase_flash_attention_backward(report, build_log=""):
    """Kernel 12's backward (dQ, dK, dV from csrc/flash_attention_bwd.cu)
    and the forward's row log-sum-exp L against the plain backward
    (``ref.flash_attention_bwd_ref``) on the card, at the training shape
    (b = 2, h = kv = 32, s = 1,024, d = 80, causal, f32), the serve shape
    and mix, GQA rep 4 at d = 120 (full and causal), rows off 16-byte
    alignment, and the (f32, f32), (f32, bf16) and (bf16, bf16) pairs; the
    forward's output bitwise with and without L; the gradients the same
    bits on a second call and through the autograd Function; the f32 ones
    of the training shape and of GQA d = 120 causal also against a float64
    backward (``_f64_backward``), beside the plain version's; no dK/dV or dQ
    template spills at d = 80 (NT = 5) or d = 120, 128 (NT = 8; its
    cp.async and scalar-staging forms); each kernel timed (device events)
    beside its plain version and its share of its split-TF32 bound, and
    the whole backward beside the plain backward and SDPA's backward, at
    the training shape and at seamless's (``SEAMLESS_BWD_SHAPE``: d = 64,
    full and causal); and the forward and the gradients against float64
    where the keys and values share a large mean
    (``_shared_mean_attention``)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import (_forward, flash_attention,
                                                     flash_attention_bwd, flash_attention_bwd_delta)
    types = {"f": "f32", "13__nv_bfloat16": "bf16", "S1_": "bf16"}
    regs = ptxas_registers(
        build_log,
        r"(dkdv|dq)_kernelI(f|13__nv_bfloat16)(f|13__nv_bfloat16|S1_)Li(\d)ELb(\d)E",
        lambda e: (f"{e.group(1)} {types[e.group(2)]}/{types[e.group(3)]} NT={e.group(4)} "
                   f"{'async' if e.group(5) == '1' else 'scalar'}"))
    for tmpl, line in sorted(regs.items()):
        print(f"[flash-bwd] {tmpl}: {line}")
    main = {f"{kernel} {pair} NT={nt} {form}" for kernel in ("dkdv", "dq")
            for pair in ("f32/f32", "f32/bf16", "bf16/bf16")
            for nt, form in ((5, "async"), (8, "async"), (8, "scalar"))}
    check(main <= set(regs), f"nvcc's report names no backward template at d = 80 (NT = 5) "
                             f"or d = 120 and 128 (NT = 8) for each type pair: {regs}")
    spills = [f"{tmpl}: {regs[tmpl]}" for tmpl in sorted(main)
              if not regs[tmpl].endswith(" 0 bytes spilled")]
    check(not spills, f"the backward kernels spill at d = 80, 120 or 128: {spills}")
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # tag, (b, h, kv, s, d), q type, k/v type, causal, strided
        ("train", (TRAIN_BATCH, 32, 32, TRAIN_SEQ, 80), f32, f32, True, True),
        ("serve mix", (4, 32, 32, 2048, 80), f32, bf16, True, True),
        ("GQA rep 4 d=120 causal", (2, 32, 8, 1024, 120), f32, f32, True, False),
        ("GQA rep 4 d=120 full", (2, 32, 8, 1024, 120), f32, f32, False, False),
        ("GQA rep 4 d=120 full, f32/bf16", (2, 32, 8, 1024, 120), f32, bf16, False, False),
        ("all-bf16", (TRAIN_BATCH, 32, 32, TRAIN_SEQ, 80), bf16, bf16, True, True),
        ("unaligned rows d=17", (2, 4, 2, 200, 17), f32, f32, True, False),
        ("unaligned rows d=17, bf16, full", (2, 4, 2, 200, 17), bf16, bf16, False, False),
        ("smoke d=24 s=17 MQA", (2, 4, 1, 17, 24), f32, bf16, True, True),
        ("seamless d=64 full", (TRAIN_BATCH, 16, 16, TRAIN_SEQ, 64), f32, f32, False, True),
        ("seamless d=64 causal", (TRAIN_BATCH, 16, 16, TRAIN_SEQ, 64), f32, f32, True, True),
    ]
    worst, worst_lse = 0.0, 0.0
    abs_err = dict.fromkeys(BWD_LABELS, 0.0)
    to_f64 = {}
    for i, (tag, (b, h, kv, s, d), qt, kt, causal, strided) in enumerate(cases):
        q, k, v = _fa_case(b, h, kv, s, d, qt, kt, seed=70 + i, strided=strided)
        g = torch.Generator(device="cuda").manual_seed(90 + i)
        dout = (torch.randn(q.shape, generator=g, device="cuda") * 0.5).to(qt)
        out, lse = _forward(q, k, v, causal, with_lse=True)
        plain_out = _forward(q, k, v, causal, with_lse=False)[0]
        check(torch.equal(out, plain_out),
              f"the forward's output moves when it also writes L ({tag})")
        want_out, want_lse = ref.flash_attention_ref(q, k, v, causal=causal, return_lse=True)
        atol, rtol = FA_LSE_TOL
        lse_excess = float(((lse - want_lse).abs() - atol - rtol * want_lse.abs()).max())
        lse_err = float((lse - want_lse).abs().max())
        check(lse.shape == want_lse.shape and lse_excess <= 0.0,
              f"the forward's L parts from the plain row log-sum-exp ({tag}): {lse_err:.3e}")
        delta = flash_attention_bwd_delta(out, dout)
        want_delta = torch.sum(dout.float() * out.float(), dim=-1)
        d_err = float((delta - want_delta).abs().max())
        check(d_err <= FA_GRAD_F32_REL * float(want_delta.abs().max()),
              f"the backward's D parts from rowsum(dO O) ({tag}): {d_err:.3e}")
        got = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
        again = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
        check(all(torch.equal(a, b_) for a, b_ in zip(got, again)),
              f"the backward kernels give other bits on a second call ({tag})")
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal)
        torch.cuda.synchronize()
        errs = _grad_errors(got, want)
        print(f"[flash-bwd] {tag} q {tuple(q.shape)} {qt} k/v {tuple(k.shape)} {kt} "
              f"causal={causal}: max|L-L_ref|={lse_err:.3e}; max|g-g_ref|/max|g_ref| "
              f"dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}", flush=True)
        worst, worst_lse = max(worst, *errs), max(worst_lse, lse_err)
        if tag in ("train", "GQA rep 4 d=120 causal"):
            exact = _f64_backward(q, k, v, out, lse, dout, causal)
            to_f64[tag] = {"kernels": _rel_errors(got, exact),
                           "plain": _rel_errors(want, exact)}
            del exact
            print(f"[flash-bwd] {tag}: max|g-g_f64|/max|g_f64| (dq, dk, dv) kernels "
                  + ", ".join(f"{e:.3e}" for e in to_f64[tag]["kernels"]) + "; plain "
                  + ", ".join(f"{e:.3e}" for e in to_f64[tag]["plain"]), flush=True)
            check(max(to_f64[tag]["kernels"]) <= FA_GRAD_F32_REL,
                  f"the backward kernels part from a float64 backward ({tag}): {to_f64[tag]}")
        diffs = [float((a.float() - w.float()).abs().max()) for a, w in zip(got, want)]
        for op, e in (("flash_attention_bwd_delta", d_err), ("flash_attention_bwd_dq", diffs[0]),
                      ("flash_attention_bwd_dkdv", max(diffs[1:]))):
            abs_err[op] = max(abs_err[op], e)
        if tag == "train":
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            ops.reset_launch_counts()
            flash_attention(*leaves, causal=causal).backward(dout)
            counts = ops.launch_counts()
            check(all(torch.equal(t.grad, w) for t, w in zip(leaves, got)),
                  "the autograd Function's gradients are not the backward kernels'")
            check(counts["flash_attention"] == 1 and all(
                counts[op] == 1 for op in BWD_LABELS), f"the Function's launches: {counts}")
        del q, k, v, dout, out, lse, got, again, want, want_out, want_lse, plain_out, delta
        torch.cuda.empty_cache()
    shared_mean = _shared_mean_attention()
    # times at the training shape, then at seamless's (d = 64, full and
    # causal): each kernel by its device events beside its plain version;
    # the whole backward beside the plain backward and SDPA's backward
    recs, whole, lib_err = _bwd_times("the training shape", TRAIN_BATCH, 32, TRAIN_SEQ, 80,
                                      True, abs_err)
    report.update(recs)
    d64 = {}
    for causal in (False, True):
        recs64, whole64, err64 = _bwd_times(f"seamless's shape ({'causal' if causal else 'full'})",
                                            *SEAMLESS_BWD_SHAPE, causal, abs_err)
        d64["causal" if causal else "full"] = dict(recs64, whole=whole64,
                                                   library_max_rel_err=err64)
    report["flash_attention_bwd"] = dict(whole, max_rel_err=worst, max_lse_err=worst_lse,
                                         library_max_rel_err=lib_err, registers=regs,
                                         rel_err_to_f64=to_f64, seamless_d64=d64,
                                         shared_mean=shared_mean)


FA_SHARED_MEAN_OUT_REL = 2e-6   # the forward's output against float64, of max|out|


def _shared_mean_attention():
    """Kernel 12 through its autograd Function where the keys and the
    values share a large mean, as seamless's cross-attention over its
    encoder's output does at initialization: the forward's output against
    float64 (FA_SHARED_MEAN_OUT_REL of its max), and the gradients
    (TRAIN_GRAD_REL of each one's max), beside the plain version's. dQ
    there is a small sum of terms whose D = rowsum(dO O) carries the
    forward's error, magnified: a forward whose P V product chains over
    every key on the tensor cores put dQ 3.8e-4 of its max from float64.
    Seamless's training shape (d = 64, full) and stablelm's (d = 80,
    causal)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    g = torch.Generator(device="cuda").manual_seed(3)
    out_rec = {}
    for tag, (b, h, s, d), causal in (("seamless d=64 full", SEAMLESS_BWD_SHAPE, False),
                                      ("train d=80 causal", (TRAIN_BATCH, 32, TRAIN_SEQ, 80),
                                       True)):
        q = torch.randn((b, h, s, d), generator=g, device="cuda")
        mk, mv = (torch.randn((1, 1, 1, d), generator=g, device="cuda") * 1.5 for _ in range(2))
        k = torch.randn((b, h, s, d), generator=g, device="cuda") + mk
        v = torch.randn((b, h, s, d), generator=g, device="cuda") + mv
        dout = torch.randn((b, h, s, d), generator=g, device="cuda") * 0.5
        exact = [t.double().requires_grad_() for t in (q, k, v)]
        out64 = _f64_attention(*exact, causal=causal)
        out64.backward(dout.double())
        errs = {}
        for name, fn in (("kernels", flash_attention), ("plain", ref.flash_attention_ref)):
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            out = fn(*leaves, causal=causal)
            out.backward(dout)
            errs[name] = [float((a.detach().double() - w.detach()).abs().max()
                                / w.detach().abs().max())
                          for a, w in zip([out] + [t.grad for t in leaves],
                                          [out64] + [t.grad for t in exact])]
        print(f"[flash-bwd] keys and values with a shared mean, {tag} (b h = {b * h}, s = {s}): "
              f"against float64, (out, dq, dk, dv) kernels "
              + ", ".join(f"{e:.3e}" for e in errs["kernels"]) + "; plain "
              + ", ".join(f"{e:.3e}" for e in errs["plain"]), flush=True)
        check(errs["kernels"][0] <= FA_SHARED_MEAN_OUT_REL
              and max(errs["kernels"][1:]) <= TRAIN_GRAD_REL,
              f"kernel 12 parts from float64 where keys and values share a mean ({tag}): "
              f"{errs['kernels']}")
        out_rec[tag] = errs
        del q, k, v, dout, exact, out64
    torch.cuda.empty_cache()
    return out_rec


def _bwd_times(tag, b, h, s, d, causal, abs_err, reps=10):
    """Kernel 12's backward at (b, h = kv, s, d), f32: each kernel timed by
    its device events beside its plain version and its bounds (D also
    beside ``torch.linalg.vecdot``), and the whole backward beside the
    plain backward and SDPA's backward. Returns ({op: record}, the whole
    backward's record, max|SDPA's - the plain gradients| / max)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (_forward, flash_attention_bwd,
                                                     flash_attention_bwd_delta)
    q, k, v = _fa_case(b, h, h, s, d, torch.float32, torch.float32, seed=70, strided=True)
    dout = (torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(90),
                        device="cuda") * 0.5)
    out, lse = _forward(q, k, v, causal, with_lse=True)
    bwd = lambda: flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)  # noqa: E731
    events = device_events(bwd, reps)
    per_kernel = {op: sum(ms for name, ms in events if label in name) / reps
                  for op, label in BWD_LABELS.items()}
    check(all(ms > 0 for ms in per_kernel.values()),
          f"the profiler missed a backward kernel: {[n for n, _ in events][:8]}")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_out = sdpa(lq, lk, lv, is_causal=causal)
    whole = {
        "ms": cuda_ms(bwd, reps),
        "plain_ms": cuda_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                                                causal=causal), reps),
        "library_ms": cuda_ms(lambda: torch.autograd.grad(lib_out, (lq, lk, lv), dout,
                                                          retain_graph=True), reps),
        "fwd_lse_ms": cuda_ms(lambda: _forward(q, k, v, causal, with_lse=True), reps),
        "fwd_ms": cuda_ms(lambda: _forward(q, k, v, causal, with_lse=False), reps),
    }
    # each kernel's plain version, and the one PyTorch call that computes D
    plain = {"flash_attention_bwd_delta": lambda: torch.sum(dout.float() * out.float(), dim=-1),
             "flash_attention_bwd_dkdv": lambda: ref.flash_attention_bwd_ref(
                 q, k, v, out, lse, dout, causal=causal, grads="kv"),
             "flash_attention_bwd_dq": lambda: ref.flash_attention_bwd_ref(
                 q, k, v, out, lse, dout, causal=causal, grads="q")}
    library = {"flash_attention_bwd_delta": lambda: torch.linalg.vecdot(out, dout)}
    lib_err = max(float((a - w).abs().max() / w.abs().max()) for a, w in zip(
        torch.autograd.grad(lib_out, (lq, lk, lv), dout, retain_graph=True),
        ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal)))
    vecdot_err = float((library["flash_attention_bwd_delta"]()
                        - flash_attention_bwd_delta(out, dout)).abs().max())
    bounds = flash_bwd_bounds(q, k, causal)
    whole.update(bounds.pop("whole"))
    mask = "causal" if causal else "full"
    recs = {}
    for op, bnd in bounds.items():
        rec = dict(ms=per_kernel[op], **bnd, plain_ms=cuda_ms(plain[op], reps),
                   library_ms=cuda_ms(library[op], reps) if op in library else None,
                   max_abs_err=abs_err[op])
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        recs[op] = rec
        fma = (f" f32_fma_bound_ms={rec['f32_fma_bound_ms']:.4f}"
               if "f32_fma_bound_ms" in rec else "")
        lib = f" library_ms={rec['library_ms']:.4f}" if rec["library_ms"] is not None else ""
        print(f"[flash-bwd] {op} at {tag} (b h = {b * h}, s = {s}, d = {d}, {mask}, f32): "
              f"kernel_ms={rec['ms']:.4f} bound_ms={rec['bound_ms']:.4f} "
              f"({rec['bound_by']}; the kernel at {100 * rec['bound_share']:.1f}% of it){fma} "
              f"plain_ms={rec['plain_ms']:.4f}{lib}; SDPA's whole backward "
              f"{whole['library_ms']:.4f}", flush=True)
    whole["bound_share"] = whole["bound_ms"] / whole["ms"]
    print(f"[flash-bwd] the whole backward at {tag}: {whole['ms']:.4f} ms (3 launches) against "
          f"the plain backward {whole['plain_ms']:.4f} and SDPA's backward "
          f"{whole['library_ms']:.4f} ({whole['ms'] / whole['library_ms']:.3f}x; f32 tensors; "
          f"max|sdpa-plain|/max = {lib_err:.3e}); bound_ms={whole['bound_ms']:.4f} "
          f"({whole['bound_by']}: the five distinct products as split-TF32 terms at "
          f"{H100_TF32_FLOPS / 1e12:.0f} TFLOP/s; the three launches at "
          f"{100 * whole['bound_share']:.1f}% of it) f32_fma_bound_ms="
          f"{whole['f32_fma_bound_ms']:.4f}; the forward {whole['fwd_ms']:.4f} ms, with L "
          f"{whole['fwd_lse_ms']:.4f}; max|vecdot-D| = {vecdot_err:.3e}", flush=True)
    del q, k, v, dout, out, lse, lq, lk, lv, lib_out
    torch.cuda.empty_cache()
    return recs, whole, lib_err


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _top2_margin(logits):
    top2 = torch.topk(logits, 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def _card_cpu_parity(tag, cfg, params, data, steps=8):
    """``cfg``'s prefill of ``data`` and ``steps`` decode steps on the card
    against the same calls on the CPU (the plain versions), from the same
    weights ``params`` (on the CPU). The decode steps are fed the CPU's
    greedy tokens, so each step compares the same inputs. Returns (the
    worst max|dlogits| / max|logits|, greedy tokens compared past a
    near-tie, flips among them, the share of equal cache entries by leaf)."""
    from repro_torch.models import get_api
    from repro_torch.train._tree import named_leaves
    api = get_api(cfg)
    params_gpu = _tree_to(params, "cuda")
    prompt = data["tokens"].shape[1]
    max_len = prompt + steps + (cfg.n_prefix_tokens or 0)
    first = prompt + (cfg.n_prefix_tokens if cfg.family == "vlm" else 0)
    kw = dict(compute_dtype=torch.float32)
    runs = {}
    for dev, p in (("cpu", params), ("cuda", params_gpu)):
        out = api.prefill(p, cfg, {key: x.to(dev) for key, x in data.items()}, max_len, **kw)
        extras = {"enc_out": out[2]} if cfg.family == "encdec" else None
        runs[dev] = [out[0][:, :, :cfg.vocab_size].float().cpu()], out[1], extras
        del out
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
        print(f"[{tag}] {'prefill' if i == 0 else f'decode {i}'}: "
              f"max|dlogits|={err:.4e} max|logits|={scale:.4f} greedy same "
              f"{same.tolist()} top-2 margin {[round(float(m), 4) for m in margin]}",
              flush=True)
        if i == steps:
            break
        tok = want[:, -1].argmax(-1).to(torch.int32)[:, None]
        for dev in ("cpu", "cuda"):
            logits, _ = api.decode_step(params if dev == "cpu" else params_gpu, cfg,
                                        tok.to(dev), runs[dev][1], first + i, runs[dev][2],
                                        **kw)
            runs[dev][0].append(logits[:, :, :cfg.vocab_size].float().cpu())
    cpu_cache = named_leaves(runs["cpu"][1])
    cache_same = {name: float((t.cpu() == cpu_cache[name]).float().mean())
                  for name, t in named_leaves(runs["cuda"][1]).items()}
    del runs, params_gpu
    torch.cuda.empty_cache()
    return worst, compared, flips, cache_same


def phase_serve_parity(report):
    """stablelm-3b at full width cut to 2 layers, batch 2, a ragged prompt
    of 100: prefill and 8 decode steps on the card against the same calls on
    the CPU (the plain versions), from the same weights. The decode steps
    are fed the CPU's greedy tokens, so each step compares the same inputs."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_api, make_train_batch
    cfg = get_config(SERVE_ARCH).replace(n_layers=2)
    t0 = time.perf_counter()
    params = get_api(cfg).init_params(torch.Generator().manual_seed(0), cfg)
    tokens = make_train_batch(cfg, 2, 100, torch.Generator().manual_seed(1))["tokens"]
    steps = 8
    worst, compared, flips, cache_same = _card_cpu_parity("serve-parity", cfg, params,
                                                          {"tokens": tokens}, steps)
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


#: the families past the dense one: each arch and the depth its card-vs-CPU
#: parity run is cut to (mamba2 has no attention; paligemma's prefix mask
#: is never kernel 12's function; deepseek's MLA is computed in plain
#: torch, as the reference computes it in jnp: its q.k width of 192 is
#: past kernel 12's 128 and unequal to v's)
FAMILY_ARCHS = {
    "mamba2-780m": dict(n_layers=2),
    "zamba2-2.7b": dict(n_layers=6),
    "seamless-m4t-large-v2": dict(n_layers=2, n_enc_layers=2),
    "paligemma-3b": dict(n_layers=2),
    "deepseek-v2-lite-16b": dict(n_layers=2),   # the dense layer 0 and one moe layer
}
#: phase_family_serve's depth, about a quarter of each family's (cut from
#: the full depth to keep the script under 720 s), and kernel 12's launches
#: in a prefill at it: zamba2 2 groups of 6, one launch each; seamless 6
#: encoder, 6 decoder self and 6 cross-attention calls; deepseek the
#: dense layer 0 and 6 moe layers
FAMILY_SERVE = {
    "mamba2-780m": (dict(n_layers=12), 0),
    "zamba2-2.7b": (dict(n_layers=12), 2),
    "seamless-m4t-large-v2": (dict(n_layers=6, n_enc_layers=6), 18),
    "paligemma-3b": (dict(n_layers=5), 0),
    "deepseek-v2-lite-16b": (dict(n_layers=7), 0),
}
ROUTE_TIE = 1e-6            # router probabilities nearer than this: a near-tie


def _route_counts(x, p, cfg):
    """A moe layer's routing of x, as device tensors (no host sync):
    [copies dropped past the capacity, tokens whose k-th and (k+1)-th
    router probabilities lie within ROUTE_TIE]."""
    from repro_torch.models import moe
    m = cfg.moe
    xf = x.reshape(-1, x.shape[-1])
    probs, _, top_ids = moe.route(xf, p, cfg)
    cap = moe.moe_capacity(xf.shape[0], m)
    slot, _ = moe.dispatch(top_ids, m.n_experts, cap)
    top = torch.topk(probs, m.top_k + 1, dim=-1).values
    return torch.stack([(slot == m.n_experts * cap).sum(),
                        (top[:, -2] - top[:, -1] <= ROUTE_TIE).sum()])


def _prefill_routing(tag, cfg, params, data, max_len):
    """One prefill of ``data`` with every moe layer's routing counted
    (``_route_counts`` beside each ``moe_ffn`` call): the copies routed,
    dropped, and the tokens at a router near-tie, summed over the layers."""
    from repro_torch.models import moe
    from repro_torch.train.train_step import build_prefill
    real, counts = moe.moe_ffn, []

    def counted(x, p, c):
        counts.append(_route_counts(x, p, c))
        return real(x, p, c)

    moe.moe_ffn = counted
    try:
        build_prefill(cfg, max_len, compute_dtype=torch.float32)(params, data)
    finally:
        moe.moe_ffn = real
    dropped, near = (int(v) for v in torch.stack(counts).sum(0))
    t = data["tokens"].numel()
    copies = t * cfg.moe.top_k * len(counts)
    print(f"[{tag}] routing over {len(counts)} moe layers of {t} tokens: {dropped} of "
          f"{copies} copies dropped (capacity {moe.moe_capacity(t, cfg.moe)} an expert), "
          f"{near} token-layers at a router near-tie (gap <= {ROUTE_TIE})", flush=True)
    return dict(moe_layers=len(counts), copies=copies, dropped=dropped, near_ties=near)


def phase_family_parity(report):
    """The ssm, hybrid, encdec, vlm and moe families at full width, cut in
    depth (``FAMILY_ARCHS``): batch 2, a ragged prompt of 100 tokens
    (paligemma's 256 image positions before it, seamless's 100 source
    frames), prefill and 8 decode steps on the card against the CPU, from
    the same weights, as ``phase_serve_parity``; deepseek's routing (dropped
    copies, near-ties) counted on the CPU's prefill."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_api, make_train_batch
    out = {}
    for arch, cut in FAMILY_ARCHS.items():
        cfg = get_config(arch).replace(**cut)
        t0 = time.perf_counter()
        params = get_api(cfg).init_params(torch.Generator().manual_seed(0), cfg)
        data = make_train_batch(cfg, 2, 100, torch.Generator().manual_seed(1))
        data.pop("labels")
        worst, compared, flips, cache_same = _card_cpu_parity(f"family-parity {arch}", cfg,
                                                              params, data)
        wall = time.perf_counter() - t0
        print(f"[family-parity] {arch} {cut}, batch 2, prompt 100: max|dlogits|/max|logits|="
              f"{worst:.4e} (limit {SERVE_LOGIT_RTOL}), greedy tokens compared past a "
              f"near-tie {compared}, differing {flips}; cache entries equal {cache_same}; "
              f"{wall:.1f} s", flush=True)
        check(worst <= SERVE_LOGIT_RTOL, f"the card and the CPU disagree on {arch}'s logits")
        check(flips == 0, f"{arch}: the card's greedy tokens differ from the CPU's past a "
              "near-tie")
        out[arch] = dict(cut=cut, max_rel_logit_err=worst, greedy_compared=compared,
                         greedy_flips=flips, cache_equal_fraction=cache_same, wall_s=wall)
        if cfg.family == "moe":
            out[arch]["routing"] = _prefill_routing(f"family-parity {arch}", cfg, params, data,
                                                    100 + 8)
        del params
    report["family_parity"] = out


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
          and counts["flash_attention"] == cfg.n_layers
          and not any(counts[op] for op in BWD_LABELS),
          f"flash_attention launches: prefill {res.prefill_launches}, decode "
          f"{res.decode_launches}")
    report["serve"] = dict(times, peak_mem_bytes=peak, launches=counts,
                           first_tokens=res.tokens[:2].tolist(),
                           profile=_serve_profile(cfg, params, res.tokens))
    return counts


def phase_family_serve(report):
    """Each family of ``FAMILY_SERVE`` at its published width and a quarter
    of its depth through launch/serve.py's ``serve``, weights drawn on the card from seed 0: 4
    requests of 2,048 prompt tokens (seamless: 2,048 source frames;
    paligemma: its 256 image positions before them), 32 generated tokens;
    then a second call, whose tokens must equal the first's, and the
    prefill and 4 decode steps under torch.profiler; for moe one more
    prefill with its routing counted. Kernel 12's launches are checked
    exactly: ``FAMILY_SERVE``'s count a prefill, none in the decode, and no
    other kernel. Returns {arch: {"prefill": n, "decode": n}} of kernel 12's
    launches in the first call."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import get_api, make_train_batch
    out, launches = {}, {}
    for arch, (depth, flash_prefill) in FAMILY_SERVE.items():
        cfg = get_config(arch).replace(**depth)
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
        times = {tag: dict(prefill_ms=r.prefill_s * 1e3,
                           decode_ms_per_token=r.decode_s / (SERVE_GEN - 1) * 1e3)
                 for tag, r in (("first", res), ("second", again))}
        pre, dec = res.prefill_launches, res.decode_launches
        print(f"[family-serve] {arch} quarter depth ({cfg.n_layers} layers"
              + (f", {cfg.n_enc_layers} encoder" if cfg.n_enc_layers else "")
              + f", d_model {cfg.d_model}), batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, "
              f"gen {SERVE_GEN}: "
              + "; ".join(f"{tag} call prefill_ms={t['prefill_ms']:.3f} decode_ms_per_token="
                          f"{t['decode_ms_per_token']:.3f}" for tag, t in times.items())
              + f"; peak_mem_GB={peak / 1e9:.3f}; flash_attention launches: prefill "
              f"{pre['flash_attention']}, decode {dec['flash_attention']}", flush=True)
        print(f"[family-serve]   seq0: {res.tokens[0].tolist()}", flush=True)
        check(torch.equal(again.tokens, res.tokens), f"{arch}: a second serve call gives "
              "other tokens")
        check(tuple(res.tokens.shape) == (SERVE_BATCH, SERVE_GEN)
              and int(res.tokens.min()) >= 0 and int(res.tokens.max()) < cfg.vocab_size,
              f"{arch}: the serve path's tokens have the wrong shape or range")
        check(bool(torch.isfinite(res.prefill_logits).all()),
              f"{arch}: the prefill logits are not finite")
        check(pre["flash_attention"] == flash_prefill and counts["flash_attention"] == flash_prefill
              and not any(n for op, n in counts.items() if op != "flash_attention")
              and not any(dec.values()),
              f"{arch}: kernel launches: prefill {pre}, decode {dec} (flash_attention "
              f"{flash_prefill} a prefill expected, nothing else)")
        launches[arch] = {"prefill": pre["flash_attention"], "decode": dec["flash_attention"]}
        out[arch] = dict(times, peak_mem_bytes=peak, launches=launches[arch],
                         first_tokens=res.tokens[:2].tolist(),
                         profile=_serve_profile(cfg, params, res.tokens,
                                                label=f"family-profile {arch}"))
        if cfg.family == "moe":
            data = make_train_batch(cfg, SERVE_BATCH, SERVE_PROMPT,
                                    torch.Generator().manual_seed(0))
            out[arch]["routing"] = _prefill_routing(
                f"family-serve {arch}", cfg, params, {"tokens": data["tokens"].to("cuda")},
                SERVE_PROMPT + SERVE_GEN)
        # kw holds the weights too: the next family's peak must not count them
        del params, res, again, kw
    report["family_serve"] = out
    return launches


MOE_ARCH = "deepseek-v2-lite-16b"
MOE_REL = 1e-5              # moe_ffn's y, the card against the CPU, of max|y|


def phase_moe_ffn(report):
    """deepseek-v2-lite-16b's routed experts alone (``moe_ffn``, one moe
    layer's weights drawn on the card from seed 0) at the decode shape (4
    tokens) and the prefill shape (4 x 2,048): a first call, then a call
    under ``torch.cuda.set_sync_debug_mode("error")``, where any host sync
    raises, whose y and aux must be the first call's bits; both timed by
    CUDA events; at the decode shape y against the CPU's ``moe_ffn`` on the
    same weights within MOE_REL of max|y|; dropped copies and router
    near-ties printed. Then the expert-parallel form on a 1 x 1 mesh
    against the local form, forward and backward (_moe_ep_vs_local)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config(MOE_ARCH)
    p = moe.init_moe_ffn(torch.Generator(device="cuda").manual_seed(0), cfg)
    out = {}
    for tag, s in (("decode", 1), ("prefill", SERVE_PROMPT)):
        x = torch.randn((SERVE_BATCH, s, cfg.d_model), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1))
        y, aux = moe.moe_ffn(x, p, cfg)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y2, aux2 = moe.moe_ffn(x, p, cfg)
        except RuntimeError as err:
            check(False, f"moe_ffn at the {tag} shape synchronizes with the host: {err}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(torch.equal(y, y2) and torch.equal(aux, aux2),
              f"moe_ffn at the {tag} shape: a second call gives other bits")
        check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(aux)),
              f"moe_ffn at the {tag} shape: y or aux is not finite")
        ms = cuda_ms(lambda: moe.moe_ffn(x, p, cfg), 5 if s > 1 else 20)
        dropped, near = (int(v) for v in _route_counts(x, p, cfg))
        t = SERVE_BATCH * s
        rec = dict(tokens=t, capacity=moe.moe_capacity(t, cfg.moe), ms=ms, dropped=dropped,
                   copies=t * cfg.moe.top_k, near_ties=near)
        if tag == "decode":
            p_cpu = _tree_to(p, "cpu")
            want, want_aux = moe.moe_ffn(x.cpu(), p_cpu, cfg)
            err = float((y.cpu() - want).abs().max() / want.abs().max())
            rec.update(max_rel_err=err, aux_rel_err=float(abs(aux.cpu() - want_aux) / want_aux))
            check(err <= MOE_REL, f"moe_ffn at the decode shape: the card against the CPU "
                  f"{err:.3e} of max|y| (limit {MOE_REL})")
            del p_cpu
        print(f"[moe-ffn] {MOE_ARCH} {tag} shape ({SERVE_BATCH} x {s} tokens, capacity "
              f"{rec['capacity']}): no host sync; {ms:.3f} ms; {dropped} of {rec['copies']} "
              f"copies dropped; {near} tokens at a router near-tie"
              + (f"; card vs CPU {rec['max_rel_err']:.3e} of max|y|" if tag == "decode" else ""),
              flush=True)
        out[tag] = rec
        del x, y, y2
    with _one_rank_mesh() as mesh:
        out["expert_parallel"] = _moe_ep_vs_local(cfg, p, mesh, "cuda")
    _check_moe_ep(MOE_ARCH, out["expert_parallel"])
    del p
    torch.cuda.empty_cache()
    report["moe_ffn"] = out


LLAMA4_ARCH = "llama4-maverick-400b-a17b"
LLAMA4_CUT = dict(n_layers=2)   # layer 0 moe (128 experts, top-1, a shared one), layer 1 dense
LLAMA4_BATCH, LLAMA4_PROMPT, LLAMA4_GEN = 1, 1024, 8


def phase_llama4(report):
    """llama4-maverick-400b-a17b at published widths, 2 of its 48 layers
    (74 GB of f32 weights: the card alone, no CPU copy), through
    launch/serve.py's ``serve``: the peak reckoned from the meta-device
    shapes printed before the draw, then 1 request of 1,024 prompt tokens
    and 8 generated, and a second call, whose tokens must equal the
    first's. Kernel 12 (GQA 40/8, d 128) must launch exactly once a layer
    in the prefill, never in a decode step, and no other kernel. The
    prefill's logits are held against the same weights with the attention
    through its plain versions (``_plain_attention``), within
    SERVE_LOGIT_RTOL of max|logits|. Returns kernel 12's launches and the
    weights, which phase_sharded_serve reads and frees."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import get_api, make_train_batch
    from repro_torch.train._tree import named_leaves
    from repro_torch.train.train_step import build_prefill
    cfg = get_config(LLAMA4_ARCH).replace(**LLAMA4_CUT)
    api = get_api(cfg)
    n_params = sum(t.numel() for t in named_leaves(api.init_params(None, cfg)).values())
    logits_bytes = LLAMA4_BATCH * LLAMA4_PROMPT * cfg.vocab_padded * 4
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[llama4] {LLAMA4_ARCH} {LLAMA4_CUT}: {n_params:,} parameters; reckoned peak "
          f"{(n_params * 4 + 2 * logits_bytes) / 1e9:.3f} GB (f32 weights "
          f"{n_params * 4 / 1e9:.3f} GB, two prefills' logits {2 * logits_bytes / 1e9:.3f} GB) "
          f"of the card's {total / 1e9:.3f} GB", flush=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    kw = dict(batch=LLAMA4_BATCH, prompt_len=LLAMA4_PROMPT, gen=LLAMA4_GEN, seed=0,
              device="cuda", params=params)
    ops.reset_launch_counts()
    res = serve.serve(cfg, **kw)
    counts = ops.launch_counts()
    again = serve.serve(cfg, **kw)
    check(torch.equal(again.tokens, res.tokens), "llama4: a second serve call gives other tokens")
    check(tuple(res.tokens.shape) == (LLAMA4_BATCH, LLAMA4_GEN)
          and int(res.tokens.min()) >= 0 and int(res.tokens.max()) < cfg.vocab_size,
          "llama4: the serve path's tokens have the wrong shape or range")
    check(bool(torch.isfinite(res.prefill_logits).all()), "llama4: the prefill logits are not finite")
    pre, dec = res.prefill_launches, res.decode_launches
    check(pre["flash_attention"] == cfg.n_layers and counts["flash_attention"] == cfg.n_layers
          and not any(n for op, n in counts.items() if op != "flash_attention")
          and not any(dec.values()),
          f"llama4: kernel launches: prefill {pre}, decode {dec} (flash_attention "
          f"{cfg.n_layers} a prefill expected, nothing else)")
    data = make_train_batch(cfg, LLAMA4_BATCH, LLAMA4_PROMPT, torch.Generator().manual_seed(0))
    data = {"tokens": data["tokens"].to("cuda")}
    prefill = build_prefill(cfg, LLAMA4_PROMPT + LLAMA4_GEN, compute_dtype=torch.float32)
    got = prefill(params, data)[0][..., :cfg.vocab_size]
    with _plain_attention():
        want = prefill(params, data)[0][..., :cfg.vocab_size]
    err = float((got - want).abs().max() / want.abs().max())
    same = bool(torch.equal(got[:, -1].argmax(-1), want[:, -1].argmax(-1)))
    del got, want
    peak = torch.cuda.max_memory_allocated()
    routing = _prefill_routing("llama4", cfg, params, data, LLAMA4_PROMPT + LLAMA4_GEN)
    times = {tag: dict(prefill_ms=r.prefill_s * 1e3,
                       decode_ms_per_token=r.decode_s / (LLAMA4_GEN - 1) * 1e3)
             for tag, r in (("first", res), ("second", again))}
    print(f"[llama4] batch {LLAMA4_BATCH}, prompt {LLAMA4_PROMPT}, gen {LLAMA4_GEN}: weights "
          f"drawn in {draw_s:.3f} s; "
          + "; ".join(f"{tag} call prefill_ms={t['prefill_ms']:.3f} decode_ms_per_token="
                      f"{t['decode_ms_per_token']:.3f}" for tag, t in times.items())
          + f"; peak_mem_GB={peak / 1e9:.3f}; flash_attention launches: prefill "
          f"{pre['flash_attention']}, decode {dec['flash_attention']}; logits against the "
          f"plain attention {err:.4e} of max|logits| (limit {SERVE_LOGIT_RTOL}), last greedy "
          f"token {'the same' if same else 'other'}", flush=True)
    print(f"[llama4]   seq0: {res.tokens[0].tolist()}", flush=True)
    check(err <= SERVE_LOGIT_RTOL, "llama4: kernel 12 and the plain attention disagree on the "
          "prefill logits")
    report["llama4"] = dict(times, cut=LLAMA4_CUT, n_params=n_params, peak_mem_bytes=peak,
                            reckoned_peak_bytes=n_params * 4 + 2 * logits_bytes,
                            draw_s=draw_s, launches={"prefill": pre["flash_attention"],
                                                     "decode": dec["flash_attention"]},
                            plain_attention_rel_err=err, routing=routing,
                            first_tokens=res.tokens.tolist())
    del res, again
    torch.cuda.empty_cache()
    return report["llama4"]["launches"], params


#: phase_sharded_serve: requests, prompt tokens and greedy steps of a case
SHARDED_SERVE_BATCH, SHARDED_SERVE_PROMPT, SHARDED_SERVE_GEN = 4, 512, 16
LLAMA4_SERVE_PROMPT, LLAMA4_SERVE_GEN = 256, 8
SHARDED_SERVE_REL = 1e-4    # a sharded decode's logits against one device's, of max|logits|
SHARDED_FAMILY_REL = 1e-5   # (d): a 1 x 1 mesh's prefill, decode and caches against one device's
PROFILE_STEPS = 4           # decode steps under torch.profiler
GRANITE_ARCH, GRANITE_CUT = "granite-34b", dict(n_layers=4)   # of its 88 layers
QWEN_ARCH, QWEN_CUT = "qwen1.5-4b", dict(n_layers=4)            # of its 40 layers
#: the dense models whose rules leave an attention activation whole (ROADMAP
#: 12b.4c.2a): granite's one KV head and qwen's 20 heads on a model axis of
#: ACT_WHOLE_MODEL (one node of eight cards), where build_rules gives
#: "kv_heads_act" None (and qwen "heads_act" None)
ACT_WHOLE_ARCHS = {GRANITE_ARCH: GRANITE_CUT, QWEN_ARCH: QWEN_CUT}
ACT_WHOLE_MODEL = 8
EP_MOE_CF = 11.0            # deepseek's capacity factor past E / k = 64 / 6: no form drops a copy
EP_MOE_TOKENS = (4, 256)    # (rows, tokens a row) of the expert-parallel check


@contextlib.contextmanager
def _one_rank_mesh():
    """A 1 x 1 ("data", "model") DeviceMesh over a 1-rank NCCL group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("nccl", init_method=f"file://{_nccl_store()}", rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _counting_forms(calls):
    """Count the calls of the flash decode and of moe_ffn's two mesh forms
    (the expert-parallel and the gathered local one) in ``calls``."""
    from repro_torch.models import layers, moe
    real = {"flash": (layers, "_flash_decode"), "ep": (moe, "_moe_ffn_ep"),
            "gathered": (moe, "_moe_ffn_gathered")}
    saved = {key: getattr(mod, name) for key, (mod, name) in real.items()}
    for key, (mod, name) in real.items():
        def counted(*args, _key=key, **kw):
            calls[_key] = calls.get(_key, 0) + 1
            return saved[_key](*args, **kw)
        setattr(mod, name, counted)
    try:
        yield
    finally:
        for key, (mod, name) in real.items():
            setattr(mod, name, saved[key])


def _decode_rules(cfg, mesh, overrides=None, model_size=None, data_size=None,
                  cell="decode_32k"):
    """build_rules for a decode cell (``decode_32k`` unless named): on
    ``mesh``'s axes, or on the production (16, 16) mesh's where no sizes
    are given."""
    from repro_torch.configs import SHAPE_CELLS
    from repro_torch.launch.mesh import build_rules
    cell = {c.name: c for c in SHAPE_CELLS}[cell]
    return build_rules(cfg, cell, model_size=model_size or 16, data_size=data_size or 16,
                       overrides=overrides)


def _drops_both(x, p, cfg):
    """[copies the local form drops, copies the expert-parallel form on one
    rank drops] of a moe layer's input x, as a device tensor."""
    from repro_torch.models import moe
    m = cfg.moe
    xf = x.reshape(-1, x.shape[-1])
    _, _, top_ids = moe.route(xf, p, cfg)
    cap = moe.moe_capacity(xf.shape[0], m)
    slot, _ = moe.dispatch(top_ids, m.n_experts, cap)
    slot_ep, _ = moe.ep_dispatch(top_ids, m.n_experts, 0, 2 * cap)
    return torch.stack([(slot == m.n_experts * cap).sum(),
                        (slot_ep == m.n_experts * 2 * cap).sum()])


def _rel(got, want) -> float:
    """max |got - want| / max |want| (a shard of zeros, positions past the
    prompt, against 1e-30), on the device (one sync)."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _tree_bytes(tree) -> int:
    from repro_torch.train._tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(tree))


@contextlib.contextmanager
def _peak(dev, own: int, peaks: list):
    """Append to ``peaks`` the most the block held on the card: its peak
    allocation less what was allocated at its start, plus ``own`` bytes
    (the path's own tensors allocated before it: its weights, its cache),
    so that the yardsticks kept for a comparison are not counted."""
    base = torch.cuda.memory_allocated(dev) - own
    torch.cuda.reset_peak_memory_stats(dev)
    yield
    peaks.append(torch.cuda.max_memory_allocated(dev) - base)


def _sharded_serve(cfg, params, rules, mesh, dev, batch, prompt, gen, profile=False,
                    drops=False, sharded_prefill=False):
    """One device's prefill (build_prefill) of ``batch`` seeded prompts of
    ``prompt`` tokens (and the family's stub embeddings, make_train_batch's)
    into an f32 cache, ``gen`` greedy steps of the one-device decode, then
    the same steps (the one-device tokens fed) through build_decode_step
    under axis_rules(rules, mesh=mesh) on this rank's shards of the
    weights (the weights themselves on a 1 x 1 mesh) and of that cache:
    shared out by local_shard, or with ``sharded_prefill`` made by the
    sharded prefill (build_prefill under the rules, ROADMAP 12b.4c.1),
    whose logits, enc_out and cache shard are held to one device's (each
    prefill then timed after an untimed one).
    Returns each form's ms a token (and prefill ms), the worst distance of
    the sharded logits from one device's as a share of max|logits|,
    whether each step's greedy tokens are equal, the distances of the
    cache shard after the prefill and after the steps from local_shard of
    one device's, the mesh forms called, kernel 12's launches in each
    prefill and in the sharded steps, and each form's peak over its
    prefill and steps with its weights and cache (``_peak``; each decode
    timed after one untimed step); with ``profile``
    the sharded form's wall and busy ms over PROFILE_STEPS more steps;
    with ``drops`` each step's [local, expert-parallel] dropped copies
    summed over the moe layers."""
    import gc

    from repro_torch.distributed import axis_rules
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import param_shardings, shard_tree, specs_like
    from repro_torch.models import get_api, make_train_batch, moe
    from repro_torch.train._tree import leaves, tree_map
    from repro_torch.train.train_step import build_decode_step, build_prefill
    api = get_api(cfg)
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    data = make_train_batch(cfg, batch, prompt, torch.Generator().manual_seed(0))
    data = {key: x.to(dev) for key, x in data.items() if key != "labels"}
    prefix = cfg.n_prefix_tokens if cfg.family == "vlm" else 0
    # positions in 64s past the prefix, which every mesh axis here divides
    max_len = prefix + -(-(prompt + gen + PROFILE_STEPS) // 64) * 64
    pos0 = prefix + prompt
    prefill = build_prefill(cfg, max_len, torch.float32, cache_dtype=torch.float32)
    if sharded_prefill:     # both prefills timed warm: the first call of a shape is not
        prefill(params, data)
    weights, one_peaks, peaks = _tree_bytes(params), [], []
    ops.reset_launch_counts()
    torch.cuda.synchronize(dev)
    with _peak(dev, weights, one_peaks):
        t0 = time.perf_counter()
        out = prefill(params, data)
        torch.cuda.synchronize(dev)
    one_prefill_ms = (time.perf_counter() - t0) * 1e3
    one_prefill_launches = ops.launch_counts()["flash_attention"]
    want_prefill, cache = out[0][..., :cfg.vocab_size], out[1]
    extras = {"enc_out": out[2]} if len(out) > 2 else None
    fed = [want_prefill[:, -1].argmax(-1).to(torch.int32)]
    del out
    start = tree_map(torch.clone, cache)
    step = build_decode_step(cfg, torch.float32, return_logits=True)
    step_drops, real_moe = [], moe.moe_ffn
    if drops:
        def counted(x, p, c):
            if step_drops:      # not in a warm-up step
                step_drops[-1] += _drops_both(x, p, c)
            return real_moe(x, p, c)
        moe.moe_ffn = counted
    try:
        want = []
        with _peak(dev, weights + _tree_bytes(cache) + _tree_bytes(extras or {}), one_peaks):
            # one step first, repeated in the timed run (it writes the same
            # entries): a process group's first collective sets up its
            # communicator, and the first call of a shape its kernels
            step(params, fed[0][:, None], cache, pos0, extras)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for i in range(gen):
                step_drops.append(torch.zeros(2, dtype=torch.int64, device=dev))
                nxt, cache, lg = step(params, fed[-1][:, None], cache, pos0 + i, extras)
                want.append(lg[:, -1])
                fed.append(nxt)
            torch.cuda.synchronize(dev)
        one_ms = (time.perf_counter() - t0) * 1e3 / gen
        one_final = cache
        calls, got = {}, []
        with axis_rules(rules, mesh=mesh):
            if all(s == 1 for s in mesh.shape):
                local = params
            else:
                local = shard_tree(params, mesh,
                                   param_shardings(mesh, specs_like(api.param_specs(cfg), params)))
            cache_pl = param_shardings(mesh, api.cache_specs(cfg))
            weights = _tree_bytes(local)
            rec = dict(one_device_ms_per_token=one_ms, one_device_prefill_ms=one_prefill_ms,
                       one_device_prefill_launches=one_prefill_launches,
                       one_device_peak_mem_bytes=max(one_peaks), sharded_prefill=sharded_prefill)
            if sharded_prefill:
                # warm, as the one-device prefill is: the first call under the
                # rules also builds the layout caches and, over several ranks,
                # the communicators (each call makes a fresh cache shard)
                prefill(local, data)
                ops.reset_launch_counts()
                torch.cuda.synchronize(dev)
                with _peak(dev, weights, peaks):
                    t0 = time.perf_counter()
                    out = prefill(local, data)
                    torch.cuda.synchronize(dev)
                rec.update(prefill_ms=(time.perf_counter() - t0) * 1e3,
                           prefill_launches=ops.launch_counts()["flash_attention"],
                           prefill_rel=_rel(out[0][..., :cfg.vocab_size], want_prefill),
                           prefill_same_token=bool(torch.equal(
                               out[0][:, -1, :cfg.vocab_size].argmax(-1).to(torch.int32),
                               fed[0])))
                cache = out[1]
                if extras is not None:
                    rec["enc_rel"] = _rel(out[2], extras["enc_out"])
                    extras = {"enc_out": out[2]}
                del out
            else:
                cache = shard_tree(start, mesh, cache_pl)
            del want_prefill
            rec["prefill_cache_rel"] = max(
                _rel(g, w) for g, w in zip(leaves(cache), leaves(shard_tree(start, mesh, cache_pl)),
                                           strict=True))
            del start
            one_device_drops, step_drops = step_drops, []
            with _peak(dev, weights + _tree_bytes(cache) + _tree_bytes(extras or {}), peaks):
                step(local, fed[0][:, None], cache, pos0, extras)
                step_drops = one_device_drops
                ops.reset_launch_counts()
                with _counting_forms(calls):
                    torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    for i in range(gen):
                        step_drops.append(torch.zeros(2, dtype=torch.int64, device=dev))
                        nxt, cache, lg = step(local, fed[i][:, None], cache, pos0 + i, extras)
                        got.append((lg[:, -1], nxt))
                    torch.cuda.synchronize(dev)
                    ms = (time.perf_counter() - t0) * 1e3 / gen
            launches = ops.launch_counts()["flash_attention"]
            rec.update(ms_per_token=ms, calls=calls, flash_launches=launches,
                       peak_mem_bytes=max(peaks),
                       final_cache_rel=max(_rel(g, w) for g, w in zip(
                           leaves(cache), leaves(shard_tree(one_final, mesh, cache_pl)),
                           strict=True)))
            del one_final
            if profile:
                def more():
                    tok = fed[-1][:, None]
                    for i in range(PROFILE_STEPS):
                        nxt, _, _ = step(local, tok, cache, pos0 + gen + i, extras)
                        tok = nxt[:, None]
                rec["profile"] = _profiled(more)
        rel = [float((lg - w).abs().max() / w.abs().max()) for (lg, _), w in zip(got, want)]
        same = [bool(torch.equal(nxt, fed[i + 1])) for i, (_, nxt) in enumerate(got)]
        rec.update(max_rel=max(rel), same_tokens=same)
        if drops:
            d = torch.stack(step_drops).cpu()
            rec.update(one_device_drops=d[:gen].sum(0)[0].item(),
                       sharded_drops=d[gen:].sum(0)[1].item(),
                       no_drop_steps=[bool((d[i] == 0).all() and (d[gen + i] == 0).all())
                                      for i in range(gen)])
    finally:
        moe.moe_ffn = real_moe
    del local, cache, got, want
    torch.cuda.empty_cache()
    return rec


def _attention_layers(cfg) -> int:
    """The cached self-attentions a decode step runs through layers.attention
    (MLA's absorbed form is its own)."""
    if cfg.family == "ssm" or cfg.mla is not None:
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    return cfg.n_layers


def _report_sharded_serve(tag, cfg, rec, expect_ep, rules=None, prefill_launches=None,
                           rel_limit=SHARDED_SERVE_REL):
    """Print a case of _sharded_serve and check it: tokens equal at each
    step (where neither moe form drops a copy), logits within
    ``rel_limit``, the flash form once a cached attention a step where
    ``rules`` map "cache_seq" (every attention where no rules are given),
    the expert-parallel form once a moe layer a step, no kernel 12 in the
    decode; with a sharded prefill, its logits within ``rel_limit`` and
    its first token equal, the cache shard after the prefill and after
    the steps within ``rel_limit`` of one device's, and kernel 12's
    launches in it one device's and ``prefill_launches``."""
    gen = len(rec["same_tokens"])
    prof = rec.get("profile")
    busy = prof and prof["device_busy_ms"]
    pre = rec["sharded_prefill"]
    print(f"[sharded-serve] {tag}: "
          + (f"sharded prefill {rec['prefill_ms']:.3f} ms (one device "
             f"{rec['one_device_prefill_ms']:.3f}), logits within {rec['prefill_rel']:.3e} of "
             f"one device's max|logits|, kernel 12 launches {rec['prefill_launches']} (one "
             f"device {rec['one_device_prefill_launches']})"
             + (f", enc_out within {rec['enc_rel']:.3e}" if "enc_rel" in rec else "") + "; "
             if pre else "")
          + f"{gen} steps, sharded {rec['ms_per_token']:.3f} ms a token "
          f"(one device {rec['one_device_ms_per_token']:.3f}); logits within "
          f"{rec['max_rel']:.3e} of one device's max|logits|; tokens equal "
          f"{sum(rec['same_tokens'])}/{gen}; cache shards within "
          f"{rec['prefill_cache_rel']:.3e} (prefill) and {rec['final_cache_rel']:.3e} (after "
          f"the steps) of one device's; forms {rec['calls']}; kernel 12 launches "
          f"{rec['flash_launches']}; peak_mem_GB={rec['peak_mem_bytes'] / 1e9:.3f} (one device "
          f"{rec['one_device_peak_mem_bytes'] / 1e9:.3f}; each path's weights, cache and "
          "temporaries)"
          + (f"; profiled {PROFILE_STEPS} steps wall_ms={prof['wall_ms']:.3f} busy="
             + (f"{busy / prof['wall_ms']:.4f}" if busy else "not measured")
             + " (top device ms: " + ", ".join(f"{t['name'][:48]} x{t['launches']} "
                                               f"{t['ms']:.3f}" for t in prof["top"][:3])
             + ")" if prof else "")
          + (f"; dropped copies: one device {rec['one_device_drops']}, expert-parallel "
             f"{rec['sharded_drops']}" if "sharded_drops" in rec else ""), flush=True)
    held = rec.get("no_drop_steps", [True] * gen)
    check(all(s for s, h in zip(rec["same_tokens"], held) if h),
          f"sharded serve {tag}: greedy tokens differ from one device's")
    check(rec["max_rel"] <= rel_limit or not all(held),
          f"sharded serve {tag}: logits {rec['max_rel']:.3e} of max from one device's "
          f"(limit {rel_limit})")
    check(max(rec["prefill_cache_rel"], rec["final_cache_rel"]) <= rel_limit or not all(held),
          f"sharded serve {tag}: a cache shard is not within {rel_limit} of one device's")
    if pre:
        check(rec["prefill_rel"] <= rel_limit and rec["prefill_same_token"]
              and rec.get("enc_rel", 0.0) <= rel_limit,
              f"sharded serve {tag}: the sharded prefill is not within {rel_limit} of one "
              f"device's")
        check(rec["prefill_launches"] == rec["one_device_prefill_launches"] == prefill_launches,
              f"sharded serve {tag}: kernel 12 launches in the prefill "
              f"{rec['prefill_launches']} (one device {rec['one_device_prefill_launches']}, "
              f"{prefill_launches} expected)")
    from repro_torch.models import moe
    n_moe = sum(k == "moe" for k, _ in moe.layer_schedule(cfg)) if cfg.moe else 0
    flash = _attention_layers(cfg) * gen if rules is None or rules["cache_seq"] else 0
    check(rec["calls"].get("flash", 0) == flash
          and rec["calls"].get("ep", 0) == (n_moe * gen if expect_ep else 0)
          and not rec["calls"].get("gathered") and rec["flash_launches"] == 0,
          f"sharded serve {tag}: forms {rec['calls']}, kernel 12 {rec['flash_launches']} "
          f"(flash {flash}, expert-parallel {n_moe * gen} expected, no kernel 12)")


#: phase_sharded_serve (d): each family at FAMILY_ARCHS's depth, the cells
#: whose production rules it runs under, and kernel 12's launches in a
#: prefill (zamba2's 6 layers one group, seamless's 2 encoder layers and 2
#: decoder layers of a self- and a cross-attention)
SHARDED_FAMILY_SERVE = {
    "mamba2-780m": (("decode_32k", "long_500k"), 0),
    "zamba2-2.7b": (("decode_32k",), 1),
    "seamless-m4t-large-v2": (("decode_32k",), 6),
    "paligemma-3b": (("decode_32k",), 0),
    "deepseek-v2-lite-16b": (("decode_32k", "long_500k"), 0),
}


def _family_serve_cut(arch):
    """``arch`` at its published widths and FAMILY_ARCHS's depth; deepseek
    at capacity factor EP_MOE_CF, where neither moe form drops a copy (the
    expert-parallel form's capacity is twice the local form's)."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch).replace(**FAMILY_ARCHS[arch])
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=EP_MOE_CF))
    return cfg


def phase_sharded_serve(report, llama4_params):
    """The sharded serve steps (build_prefill and build_decode_step under
    axis_rules(rules, mesh=mesh), ROADMAP 12b.4b and 12b.4c.1) on a 1 x 1
    ("data", "model") mesh over a 1-rank NCCL group, each case held to the
    one-device prefill and decode of the same prompt (_sharded_serve):
    (c) llama4-maverick at LLAMA4_CUT under the production decode_32k
    rules (``llama4_params``, phase_llama4's weights, freed here), from
    one device's prefill: the flash decode and the expert-parallel moe
    layer on one rank, each form's dropped copies; (a) stablelm-3b at
    full width with "cache_seq" mapped to "model": the sharded prefill
    (kernel 12 once a layer) and the flash form over the whole cache; (b)
    granite-34b at GRANITE_CUT under its production decode_32k rules (MQA:
    "cache_seq" over "model"), from one device's prefill; (d) the ssm,
    hybrid, encdec, vlm and MLA families (SHARDED_FAMILY_SERVE) at
    published widths and FAMILY_ARCHS's depth under their production
    rules, the sharded prefill and decode held to 1e-5; (e) granite-34b
    and qwen1.5-4b (ACT_WHOLE_ARCHS) under their rules for ACT_WHOLE_MODEL
    model ranks (an attention activation whole, ROADMAP 12b.4c.2a), the
    sharded prefill and decode bit for bit one device's. Returns kernel
    12's launches in the sharded prefills and in the sharded decodes."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_api
    from repro_torch.train._tree import leaves
    out = {}
    with _one_rank_mesh() as mesh:
        cfg = get_config(LLAMA4_ARCH).replace(**LLAMA4_CUT)
        rec = _sharded_serve(cfg, llama4_params, _decode_rules(cfg, mesh), mesh, "cuda",
                              LLAMA4_BATCH, LLAMA4_SERVE_PROMPT, LLAMA4_SERVE_GEN, drops=True)
        llama4_params.clear()
        _report_sharded_serve(f"(c) {LLAMA4_ARCH} {LLAMA4_CUT}", cfg, rec, expect_ep=True)
        out["llama4"] = rec
        for key, arch, cut, overrides in (("stablelm", SERVE_ARCH, None, {"cache_seq": ("model",)}),
                                          ("granite", GRANITE_ARCH, GRANITE_CUT, None)):
            cfg = get_config(arch)
            cfg = cfg.replace(**cut) if cut else cfg
            n_params = sum(t.numel() for t in leaves(get_api(cfg).init_params(None, cfg)))
            print(f"[sharded-serve] {arch} {cut or 'full'}: {n_params:,} parameters "
                  f"({n_params * 4 / 1e9:.3f} GB in f32)", flush=True)
            params = get_api(cfg).init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
            rules = (_decode_rules(cfg, mesh, overrides, model_size=1, data_size=1) if overrides
                     else _decode_rules(cfg, mesh))
            pre = key == "stablelm"
            rec = _sharded_serve(cfg, params, rules, mesh, "cuda", SHARDED_SERVE_BATCH,
                                  SHARDED_SERVE_PROMPT, SHARDED_SERVE_GEN, profile=True,
                                  sharded_prefill=pre)
            del params
            tag = "(a)" if pre else "(b)"
            _report_sharded_serve(f"{tag} {arch} {cut or 'full'}, cache_seq "
                                   f"{rules['cache_seq']}", cfg, rec, expect_ep=False,
                                   prefill_launches=cfg.n_layers if pre else None)
            out[key] = dict(rec, n_params=n_params)
        for arch, (cells, launches) in SHARDED_FAMILY_SERVE.items():
            cfg = _family_serve_cut(arch)
            params = get_api(cfg).init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
            for cell in cells:
                rules = _decode_rules(cfg, mesh, cell=cell)
                rec = _sharded_serve(cfg, params, rules, mesh, "cuda", SHARDED_SERVE_BATCH,
                                      SHARDED_SERVE_PROMPT, SHARDED_SERVE_GEN,
                                      sharded_prefill=True)
                _report_sharded_serve(f"(d) {arch} {FAMILY_ARCHS[arch]}, {cell} rules "
                                       f"(batch {rules['batch']}, cache_seq "
                                       f"{rules['cache_seq']})", cfg, rec,
                                       expect_ep=cfg.moe is not None, rules=rules,
                                       prefill_launches=launches, rel_limit=SHARDED_FAMILY_REL)
                out[f"{arch} {cell}"] = rec
            del params
        out.update(_sharded_serve_act_whole(mesh))
    torch.cuda.empty_cache()
    report["sharded_serve"] = out
    return ({"prefill": sum(r.get("prefill_launches", 0) for r in out.values()),
             "decode": sum(r["flash_launches"] for r in out.values())})


def _sharded_serve_act_whole(mesh):
    """phase_sharded_serve (e): each of ACT_WHOLE_ARCHS at its published
    widths and cut depth under its rules for ACT_WHOLE_MODEL model ranks
    (no cell: the dense decode) on the 1 x 1 ``mesh``, the sharded
    prefill and SHARDED_SERVE_GEN decode steps (_sharded_serve): kernel
    12's launches one a layer in the prefill, none in the decode, and the
    prefill's logits, the steps' logits and both caches one device's bit
    for bit. Returns {case: record}."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import build_rules
    from repro_torch.models import get_api
    out = {}
    for arch, cut in ACT_WHOLE_ARCHS.items():
        cfg = get_config(arch).replace(**cut)
        params = get_api(cfg).init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
        rules = build_rules(cfg, model_size=ACT_WHOLE_MODEL)
        rec = _sharded_serve(cfg, params, rules, mesh, "cuda", SHARDED_SERVE_BATCH,
                              SHARDED_SERVE_PROMPT, SHARDED_SERVE_GEN, sharded_prefill=True)
        del params
        tag = (f"(e) {arch} {cut}, its rules for {ACT_WHOLE_MODEL} model ranks (heads_act "
               f"{rules['heads_act']}, kv_heads_act {rules['kv_heads_act']})")
        _report_sharded_serve(tag, cfg, rec, expect_ep=False, rules=rules,
                               prefill_launches=cfg.n_layers, rel_limit=SHARDED_FAMILY_REL)
        bitwise = all(rec[k] == 0.0 for k in ("prefill_rel", "max_rel", "prefill_cache_rel",
                                               "final_cache_rel"))
        print(f"[sharded-serve] {tag}: prefill, decode and caches bitwise one device's="
              f"{bitwise}", flush=True)
        check(bitwise, f"sharded serve {tag}: the 1 x 1 mesh's prefill, decode or caches are "
              "not one device's bit for bit")
        out[f"{arch} act whole"] = dict(rec, bitwise=bitwise)
    return out


def _moe_ep_vs_local(cfg, p, mesh, dev):
    """deepseek's moe layer ``p`` (whole, on ``dev``) at EP_MOE_CF, where
    no form drops a copy: the expert-parallel form under the rules on
    ``mesh`` (this rank's rows and experts) against the local form on one
    device over each "data" block of the same seeded input (the
    expert-parallel aux loss is the mean of the blocks'): y, aux and the
    gradients of sum(y**2) + aux (rank r's loss sum(y_r**2) + aux / d, the
    parameters' gradients summed over "data"), each as a share of its max;
    the expert-parallel forward and backward run under
    set_sync_debug_mode("error"). Returns the record."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.distributed import axis_rules
    from repro_torch.launch.mesh import (build_rules, local_shard, param_shardings,
                                         placement_leaves, shard_tree)
    from repro_torch.models import moe
    from repro_torch.train._tree import leaves, named_leaves, tree_map
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=EP_MOE_CF))
    rows, s = EP_MOE_TOKENS
    x = torch.randn((rows, s, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2))
    d, m = mesh.shape
    rules = build_rules(cfg, model_size=m, data_size=d)
    n = rows // d
    # one device: the local form on each data block
    live = tree_map(lambda t: t.detach().requires_grad_(), p)
    xw = x.clone().requires_grad_()
    blocks = [moe.moe_ffn(xw[i * n:(i + 1) * n], live, cfg) for i in range(d)]
    y_one = torch.cat([b[0] for b in blocks])
    aux_one = torch.stack([b[1] for b in blocks]).mean()
    drops = torch.stack([_drops_both(xw[i * n:(i + 1) * n].detach(), p, cfg)
                         for i in range(d)]).sum(0)
    g_one = torch.autograd.grad((y_one * y_one).sum() + aux_one, [xw, *leaves(live)])
    del blocks, live
    coord = mesh.get_coordinate()
    data = mesh.get_group("data") if d > 1 else None
    with axis_rules(rules, mesh=mesh):
        pl = param_shardings(mesh, moe.moe_ffn_specs(cfg))
        local = tree_map(lambda t: t.requires_grad_(), shard_tree(p, mesh, pl))
        x_loc = x[coord[0] * n:(coord[0] + 1) * n].clone().requires_grad_()
        torch.cuda.synchronize(dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, aux = moe.moe_ffn(x_loc, local, cfg)
            grads = torch.autograd.grad((y * y).sum() + aux / d, [x_loc, *leaves(local)])
        except RuntimeError as err:
            check(False, f"the expert-parallel moe_ffn synchronizes with the host: {err}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ms = cuda_ms(lambda: moe.moe_ffn(x_loc, local, cfg), 10)
    ms_local = cuda_ms(lambda: moe.moe_ffn(x[:n], p, cfg), 10)
    y, aux = y.detach(), aux.detach()
    gx, gp = grads[0], list(grads[1:])
    if data is not None:
        for g in gp:
            dist.all_reduce(g, group=data)
    rel = {"y": float((y - y_one[coord[0] * n:(coord[0] + 1) * n]).abs().max()
                      / y_one.abs().max()),
           "x": float((gx - g_one[0][coord[0] * n:(coord[0] + 1) * n]).abs().max()
                      / g_one[0].abs().max())}
    for name, g, w, place in zip(named_leaves(local), gp, g_one[1:], placement_leaves(pl),
                                 strict=True):
        rel[name] = float((g - local_shard(w, mesh, place)).abs().max() / w.abs().max())
    return dict(mesh=[d, m], tokens=rows * s, rel=rel, aux=float(aux.detach()),
                aux_one=float(aux_one), drops=drops.tolist(), ms=ms, local_ms=ms_local)


def _check_moe_ep(tag, rec):
    worst = max(rec["rel"].values())
    print(f"[moe-ffn] {tag} expert-parallel form on a {rec['mesh'][0]} x {rec['mesh'][1]} "
          f"mesh against the local form at capacity factor {EP_MOE_CF} ({rec['tokens']} "
          f"tokens): no host sync; y and the gradients of sum(y^2) + aux within {worst:.3e} "
          f"of each leaf's max ({max(rec['rel'], key=rec['rel'].get)} the worst); aux "
          f"{rec['aux']:.8f} (local {rec['aux_one']:.8f}); dropped copies local "
          f"{rec['drops'][0]}, expert-parallel {rec['drops'][1]}; forward "
          f"{rec['ms']:.3f} ms (local {rec['local_ms']:.3f})", flush=True)
    check(rec["drops"] == [0, 0], f"moe_ffn {tag}: copies dropped at capacity factor {EP_MOE_CF}")
    check(worst <= MOE_REL and abs(rec["aux"] - rec["aux_one"]) <= 1e-6 * abs(rec["aux_one"]),
          f"moe_ffn {tag}: the expert-parallel form parts from the local form: {rec['rel']}, "
          f"aux {rec['aux']} against {rec['aux_one']}")


TRAIN_GRAD_REL = 1e-4       # a gradient leaf, kernel 12 against the plain versions, of max|leaf|


def _plain_attention(fn=None):
    """A context in which the model's attention computes kernel 12's
    function by its plain version (or by ``fn(q, k, v, causal)``),
    differentiated by autograd: the yardstick of phase_train (b). The port
    itself never routes a CUDA tensor so."""
    import contextlib

    from repro_torch.kernels import ops, ref

    @contextlib.contextmanager
    def swap():
        kernel = ops.flash_attention
        ops.flash_attention = fn or (lambda q, k, v, causal=True: ref.flash_attention_ref(
            q, k, v, causal=causal))
        try:
            yield
        finally:
            ops.flash_attention = kernel

    return swap()


def _train_profile(cfg, tcfg, params, opt, batch):
    """One train step under torch.profiler, cut into the forward and
    backward (``value_and_grad``) and the optimizer (``adamw_update``):
    device ms by kernel family in each, and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.optimizer import adamw_update
    from repro_torch.train.train_step import value_and_grad
    families = (("attention forward (kernel 12)", ("flash_kernel",)),
                ("attention backward (dkdv)", ("dkdv_kernel",)),
                ("attention backward (dq)", ("dq_kernel",)),
                ("attention backward (D)", ("delta_kernel",)),
                ("matmuls (cuBLAS)", ("gemm", "xmma", "cutlass", "sm90")))

    def profiled(stage, fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        spans = _device_spans(prof)
        by = {}
        for st, en, label in spans:
            fam = next((f for f, keys in families if any(k in label for k in keys)), "other")
            by[fam] = by.get(fam, 0.0) + (en - st) / 1e3
        busy = _busy_us(spans) / 1e3 if spans else None
        print(f"[train-profile] {stage}: wall_ms={wall:.3f} device_busy_ms="
              + (f"{busy:.3f}" if busy is not None else "not measured (no device events)")
              + "; " + ", ".join(f"{f} {ms:.3f}"
                                 for f, ms in sorted(by.items(), key=lambda t: -t[1])),
              flush=True)
        return res, dict(wall_ms=wall, device_busy_ms=busy, by_family_ms=by)

    (_, grads), fwd_bwd = profiled("forward+backward",
                                   lambda: value_and_grad(params, cfg, batch, tcfg))
    _, optim = profiled("optimizer", lambda: adamw_update(params, grads, opt, tcfg))
    return {"forward+backward": fwd_bwd, "optimizer": optim}


def _train_full_width(report):
    """(a) stablelm-3b at its published widths, all 32 layers, seed-0
    weights drawn on the card, launch/train.py's TrainConfig (f32 compute,
    remat="full", AdamW, z-loss), 3 steps of 2 x 1,024 tokens from the
    synthetic stream; the last step profiled by stage."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import token_batches, train_config
    from repro_torch.models import get_api
    from repro_torch.train import adamw_init, build_train_step
    from repro_torch.train._tree import leaves, named_leaves
    cfg = get_config(TRAIN_ARCH)
    tcfg = train_config(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = get_api(cfg).init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    opt = adamw_init(params)
    n_params = sum(t.numel() for t in leaves(params))
    data_fn = token_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 0, "cuda")
    step = build_train_step(cfg, tcfg)
    steps, total = [], dict.fromkeys(("flash_attention", *BWD_LABELS), 0)
    for i in range(TRAIN_STEPS):
        batch = data_fn(i)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        m = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        launches = {op: counts[op] for op in total}
        for op in total:
            total[op] += counts[op]
        steps.append(dict(m, ms=ms, launches=launches))
        print(f"[train] {TRAIN_ARCH} full ({cfg.n_layers} layers, {n_params:,} parameters), "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, step {i}: loss={m['loss']:.6f} "
              f"grad_norm={m['grad_norm']:.6f} lr={m['lr']:.6e} ms={ms:.3f}; kernel 12 "
              f"launches: forward {launches['flash_attention']}, backward "
              + ", ".join(f"{op.rsplit('_', 1)[1]} {launches[op]}" for op in BWD_LABELS),
              flush=True)
        check(all(np.isfinite([m["loss"], m["grad_norm"], m["lr"]])), "a train step's loss "
              "or grad norm is not finite")
        check(launches["flash_attention"] == 2 * cfg.n_layers
              and all(launches[op] == cfg.n_layers for op in BWD_LABELS),
              f"kernel 12's launches in a train step (remat full: 2 forwards and one backward "
              f"a layer): {launches}")
    peak = torch.cuda.max_memory_allocated()
    check(all(bool(torch.isfinite(t).all()) for t in leaves(params)),
          "a parameter is not finite after training")
    print(f"[train] peak_mem_GB={peak / 1e9:.3f} (parameters {4 * n_params / 1e9:.3f} GB in f32)",
          flush=True)
    # the yardstick of the sharded step: the losses and the parameters after
    # the 3 steps, on the host
    one_device = dict(losses=[rec["loss"] for rec in steps],
                      params={name: t.cpu() for name, t in named_leaves(params).items()})
    profile = _train_profile(cfg, tcfg, params, opt, data_fn(TRAIN_STEPS))
    report["train_full"] = dict(arch=TRAIN_ARCH, n_layers=cfg.n_layers, n_params=n_params,
                                batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=steps,
                                peak_mem_bytes=peak, profile=profile)
    del params, opt, step
    torch.cuda.empty_cache()
    return total, one_device


def _train_parity(report):
    """(b) the published widths cut to 2 layers, one step: every gradient
    leaf, then the parameters after the step, against the same step with
    the attention through its plain versions on the card."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import token_batches, train_config
    from repro_torch.models import get_api
    from repro_torch.train import adamw_init, build_train_step
    from repro_torch.train._tree import leaves, tree_map
    from repro_torch.train.train_step import value_and_grad
    cfg = get_config(TRAIN_ARCH).replace(n_layers=2)
    tcfg = train_config(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    params = get_api(cfg).init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    batch = token_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 0, "cuda")(0)
    ops.reset_launch_counts()
    loss_k, grads_k = value_and_grad(params, cfg, batch, tcfg)
    counts_k = ops.launch_counts()
    with _plain_attention():
        ops.reset_launch_counts()
        loss_p, grads_p = value_and_grad(params, cfg, batch, tcfg)
        counts_p = ops.launch_counts()
    check(all(g is not None for g in leaves(grads_k)), "a gradient leaf is None")
    rels = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for a, b in zip(leaves(grads_k), leaves(grads_p))]
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    check(counts_k["flash_attention"] == 4 and all(counts_k[op] == 2 for op in BWD_LABELS)
          and sum(counts_p.values()) == 0, f"launches: kernels {counts_k}, plain {counts_p}")
    check(loss_rel <= 1e-5 and max(rels) <= TRAIN_GRAD_REL,
          f"the kernels' gradients part from the plain versions': loss {loss_rel:.3e}, "
          f"worst leaf {max(rels):.3e}")
    del grads_k
    results = []
    for plain in (False, True):
        p = tree_map(torch.clone, params)
        o = adamw_init(p)
        step = build_train_step(cfg, tcfg)
        if plain:
            with _plain_attention():
                p, o, m = step(p, o, batch)
        else:
            p, o, m = step(p, o, batch)
        results.append((p, float(m["lr"])))
    (pk, lr), (pp, _) = results
    # the first AdamW step moves each element by lr g / (|g| + eps): an element
    # whose gradient lies within the gradient tolerance of 0 may step either way
    worst, flipped = 0.0, 0
    for a, b, g in zip(leaves(pk), leaves(pp), leaves(grads_p)):
        diff = (a - b).abs()
        noise = g.abs() <= TRAIN_GRAD_REL * g.abs().max()
        tol = 1e-4 * float(b.abs().max())
        worst = max(worst, float(diff[~noise].max()) / tol if bool((~noise).any()) else 0.0)
        flipped += int((diff[noise] > tol).sum())
        check(bool((diff[noise] <= 2 * lr + tol).all()), "a parameter moved past two steps")
    check(worst <= 1.0, f"the parameters after a step part: {worst:.3e} of 1e-4 max|p|")
    print(f"[train-parity] {TRAIN_ARCH} widths, 2 layers, {TRAIN_BATCH} x {TRAIN_SEQ}: loss "
          f"{float(loss_k):.6f} (plain {float(loss_p):.6f}, rel {loss_rel:.3e}); "
          f"{len(rels)} gradient leaves, worst max|g-g_plain|/max|g_plain| {max(rels):.3e} "
          f"(limit {TRAIN_GRAD_REL}); parameters after one step: worst max|dp| {worst:.3e} of "
          f"1e-4 max|p| where |g| is past the gradient tolerance, {flipped} elements within "
          f"it that stepped apart (lr {lr:.3e}); kernel 12 launches: "
          f"{ {op: counts_k[op] for op in ('flash_attention', *BWD_LABELS)} }", flush=True)
    report["train_parity"] = dict(loss=float(loss_k), loss_plain=float(loss_p),
                                  loss_rel=loss_rel, worst_grad_rel=max(rels),
                                  worst_param_rel=worst, noise_elements_apart=flipped,
                                  launches=counts_k)
    del params, results, pk, pp, grads_p
    torch.cuda.empty_cache()


def _train_restart(report):
    """(c) the port's train_lm example (about 100M parameters) through
    RestartableLoop: snapshots every 2 steps and a failure injected at
    step 3, 6 steps; the losses of every step and the final parameters and
    AdamW state bitwise an uninterrupted run's, one restart."""
    import tempfile

    from repro_torch.examples.train_lm import train
    from repro_torch.train._tree import named_leaves
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        s0, n0, log0, loop0 = train(steps=6, ckpt_dir=os.path.join(root, "plain"),
                                    ckpt_every=100, device="cuda")
        s1, n1, log1, loop1 = train(steps=6, ckpt_dir=os.path.join(root, "restarted"),
                                    ckpt_every=2, inject_failure_at=3, device="cuda")
    wall = time.perf_counter() - t0
    a, b = named_leaves(s1), named_leaves(s0)
    differ = [k for k in b if not torch.equal(a[k], b[k])]
    loss0 = {r["step"]: r["loss"] for r in log0}
    loss1 = {r["step"]: r["loss"] for r in log1}
    print(f"[train-restart] train_lm example, 6 steps, snapshots every 2, failure at step 3: "
          f"restarts={loop1.restarts}, steps logged {[r['step'] for r in log1]}, losses "
          f"{[round(loss1[i], 6) for i in sorted(loss1)]} (uninterrupted "
          f"{[round(loss0[i], 6) for i in sorted(loss0)]}); leaves differing "
          f"{len(differ)} of {len(b)} {differ[:4]}; ms a step "
          f"{[round(r['sec'] * 1e3, 1) for r in log0]}; {wall:.1f} s", flush=True)
    check(n0 == n1 == 6 and loop1.restarts == 1 and loop0.restarts == 0,
          "the restartable loop did not restart once")
    check(loss0 == loss1 and not differ,
          "the restarted run is not bitwise the uninterrupted one")
    report["train_restart"] = dict(restarts=loop1.restarts,
                                   losses=[loss1[i] for i in sorted(loss1)],
                                   ms_per_step=[r["sec"] * 1e3 for r in log0], wall_s=wall)


DANUBE_SEQ = 6144           # past h2o-danube-3-4b's window of 4,096
DANUBE_REL = 1e-5           # f32 attention and its gradients against float64, of the max


def _train_window(report):
    """(d) h2o-danube-3-4b at its published widths cut to 2 layers, a
    forward and backward at s = 6,144 past its 4,096 window (the plain
    windowed path; kernel 12 is not its function); then layer 0's windowed
    attention and its gradients against float64 masked-softmax attention
    on the card, for kv head 0 and its 4 query heads."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import token_batches, train_config
    from repro_torch.models import get_api
    from repro_torch.models import layers as L
    from repro_torch.train._tree import leaves
    from repro_torch.train.train_step import value_and_grad
    cfg = get_config("h2o-danube-3-4b").replace(n_layers=2)
    tcfg = train_config(steps=1, batch=1, seq=DANUBE_SEQ)
    params = get_api(cfg).init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    batch = token_batches(cfg, 1, DANUBE_SEQ, 0, "cuda")(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    loss, grads = value_and_grad(params, cfg, batch, tcfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in leaves(grads)),
          "h2o-danube's loss or a gradient is not finite")
    check(sum(counts.values()) == 0, f"a kernel ran on the windowed path: {counts}")
    del grads
    # layer 0's q, k, v, as the attention makes them
    lp = params["layers"][0]
    s, h, kv, hd = DANUBE_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    with torch.no_grad():
        x = L.rms_norm(L.embed_tokens(params["embed"], batch["tokens"]), lp["ln1"], cfg.norm_eps)
        q = (x @ lp["attn"]["wq"]).reshape(1, s, h, hd)
        k = (x @ lp["attn"]["wk"]).reshape(1, s, kv, hd)
        v = (x @ lp["attn"]["wv"]).reshape(1, s, kv, hd)
        cos, sin = L.rope_table(torch.arange(s, device="cuda"), hd, cfg.rope_theta)
        q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
    pos = torch.arange(s, device="cuda")
    ok = L._visible(pos[:, None], pos[None, :], window=cfg.sliding_window)
    dout = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(5),
                       device="cuda")
    ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
    out = L._masked_attention(ql, kl, vl, ok)
    out.backward(dout)
    rep = h // kv
    q64, k64, v64 = (t[:, :, :n].double().requires_grad_()
                     for t, n in ((q, rep), (k, 1), (v, 1)))
    logits = torch.einsum("bsrd,btd->brst", q64, k64[:, :, 0]) / hd ** 0.5
    probs = torch.softmax(logits.masked_fill(~ok, -torch.inf), dim=-1)
    out64 = torch.einsum("brst,btd->bsrd", probs, v64[:, :, 0])
    out64.backward(dout[:, :, :rep].double())
    errs = {name: float((got.double() - want).abs().max() / want.abs().max())
            for name, got, want in (("out", out[:, :, :rep].detach(), out64.detach()),
                                    ("dq", ql.grad[:, :, :rep], q64.grad),
                                    ("dk", kl.grad[:, :, :1], k64.grad),
                                    ("dv", vl.grad[:, :, :1], v64.grad))}
    print(f"[train-window] h2o-danube-3-4b widths, 2 layers, 1 x {DANUBE_SEQ} (window "
          f"{cfg.sliding_window}): loss {float(loss):.6f}, forward and backward {wall:.3f} s, "
          f"peak_mem_GB={peak / 1e9:.3f}, kernel launches {sum(counts.values())}; layer 0 "
          f"attention, kv head 0, against float64: "
          + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + f" of the max (limit {DANUBE_REL})", flush=True)
    check(max(errs.values()) <= DANUBE_REL, "the windowed attention parts from float64")
    report["train_window"] = dict(loss=float(loss), wall_s=wall, peak_mem_bytes=peak,
                                  float64_rel_errors=errs)
    del params, q, k, v, ql, kl, vl, out, q64, k64, v64, logits, probs, out64
    torch.cuda.empty_cache()


def phase_train(report):
    """The LM trainer (launch/train.py's path) on the card: (a) full-width
    stablelm-3b, 3 steps; (b) 2 layers against the plain attention; (c)
    the restartable example, bitwise; (d) h2o-danube past its window.
    Returns kernel 12's launches in (a), forward and backward, and (a)'s
    losses and parameters after its 3 steps (on the host)."""
    launches, one_device = _train_full_width(report)
    _train_parity(report)
    _train_restart(report)
    _train_window(report)
    return launches, one_device


#: the four-rank phase's meshes of the sharded LM step, (data, model)
SHARDED_MESHES = ((1, 4), (2, 2))
#: the reference's own tolerance across mesh shapes (its elastic reshard test)
SHARDED_ATOL, SHARDED_RTOL = 5e-4, 2e-3


def _one_device_lm(cfg, tcfg, data_fn, dev, profile=False):
    """``cfg``'s seed-0 weights drawn on ``dev`` and TRAIN_STEPS steps of
    ``data_fn`` on that card alone (phase_train (a)'s for stablelm-3b): the
    losses, each step's ms and kernel 12's launches, the peak, and the
    parameters after the steps, on the host. ``profile``: then one more
    step under torch.profiler (:func:`_profiled`)."""
    from repro_torch.kernels import ops
    from repro_torch.models import get_api
    from repro_torch.train import adamw_init, build_train_step
    from repro_torch.train._tree import named_leaves
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = get_api(cfg).init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    opt, step, losses, steps = adamw_init(params), build_train_step(cfg, tcfg), [], []
    for i in range(TRAIN_STEPS):
        batch = data_fn(i)
        torch.cuda.synchronize(dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize(dev)
        steps.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                          launches=_kernel12_counts(ops.launch_counts())))
    out = dict(losses=losses, steps=steps, peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
               params={k: t.to("cpu", copy=True) for k, t in named_leaves(params).items()})
    if profile:
        batch = data_fn(TRAIN_STEPS)
        out["profile"] = _profiled(lambda: step(params, opt, batch))
    del params, opt, step
    torch.cuda.empty_cache()
    return out


def _sharded_lm_steps(mesh, cfg, tcfg, data_fn, dev, yardstick, profile=False, rules=None):
    """``cfg``'s seed-0 weights placed on ``mesh`` by param_shardings
    (the AdamW moments with them: adamw_init's zeros of the local shards),
    then TRAIN_STEPS steps of ``data_fn`` through build_train_step under
    axis_rules(rules, mesh=mesh) (``rules`` None: build_rules for the
    mesh's axes): each step's loss, ms and kernel 12's
    launches, the peak, and each rank's shards after the steps against
    the slices of ``yardstick`` (one device's parameters, on the host): bit
    for bit, the worst distance, and its share of the tolerance; a digest
    of the replicated leaves where the mesh has more than one rank (on one
    rank every leaf is whole and the digest would compare nothing).
    ``profile``: then one more step under
    torch.profiler, its wall and the device's busy ms."""
    import hashlib

    from repro_torch.distributed import axis_rules
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import (build_rules, local_shard, param_shardings,
                                         placement_leaves, shard_tree, specs_like)
    from repro_torch.models import get_api
    from repro_torch.train import adamw_init, build_train_step
    from repro_torch.train._tree import named_leaves
    import gc
    api = get_api(cfg)
    if rules is None:
        rules = build_rules(cfg, model_size=mesh.shape[1], data_size=mesh.shape[0])
    # a process's first checkpointed forward imports parts of torch lazily,
    # and a frame cycle made there keeps that step's locals (its gradients,
    # the optimizer state) until the cycle collector runs: collect them
    # before the peak is reset
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    rec = dict(mesh=list(mesh.shape), steps=[])
    with axis_rules(rules, mesh=mesh):
        full = api.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
        placements = param_shardings(mesh, specs_like(api.param_specs(cfg), full))
        params = shard_tree(full, mesh, placements)
        del full
        opt = adamw_init(params)
        step = build_train_step(cfg, tcfg)
        for i in range(TRAIN_STEPS):
            batch = data_fn(i)
            torch.cuda.synchronize(dev)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            m = {k: float(v) for k, v in m.items()}
            torch.cuda.synchronize(dev)
            rec["steps"].append(dict(m, ms=(time.perf_counter() - t0) * 1e3,
                                     launches=_kernel12_counts(ops.launch_counts())))
        rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
        flat = dict(zip(named_leaves(params), placement_leaves(placements)))
        bitwise, worst, share, digest = True, 0.0, 0.0, hashlib.sha256()
        for name, got in named_leaves(params).items():
            want = local_shard(yardstick[name], mesh, flat[name]).to(dev)
            d = (got - want).abs()
            bitwise &= torch.equal(got, want)
            worst = max(worst, float(d.max()))
            share = max(share, float((d / (SHARDED_ATOL + SHARDED_RTOL * want.abs())).max()))
            if mesh.size() > 1 and not any(pl.is_shard() for pl in flat[name]):
                digest.update(got.cpu().numpy().tobytes())
        rec.update(bitwise=bitwise, worst_abs=worst, tolerance_share=share,
                   replicated_digest=digest.hexdigest() if mesh.size() > 1 else None,
                   finite=all(bool(torch.isfinite(t).all()) for t in named_leaves(params).values()))
        if profile:
            from torch.profiler import ProfilerActivity, profile as torch_profile
            batch = data_fn(TRAIN_STEPS)
            torch.cuda.synchronize(dev)
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step(params, opt, batch)
                torch.cuda.synchronize(dev)
                wall = (time.perf_counter() - t0) * 1e3
            spans = _device_spans(prof)
            rec["profile"] = dict(wall_ms=wall, device_busy_ms=_busy_us(spans) / 1e3
                                  if spans else None)
    del params, opt, step
    torch.cuda.empty_cache()
    return rec


def phase_sharded_train(report, one_device):
    """The sharded train step (build_train_step under axis_rules(rules,
    mesh=mesh), ROADMAP 12b.4a) of stablelm-3b at full width on a 1 x 1
    ("data", "model") DeviceMesh over a 1-rank NCCL group: phase_train
    (a)'s weights, batches and TrainConfig (f32, remat "full"), 3 steps.
    Each loss and every parameter after the 3 steps must be bit for bit
    phase_train (a)'s (``one_device``), and kernel 12's launches exactly
    2 forwards and one backward (D, dK/dV, dQ) a layer a step. Records ms
    a step, the peak and the busy share of a profiled 4th step beside
    phase_train's. Then, on the same mesh, the ssm, hybrid, encdec and moe
    families (ROADMAP 12b.4c's first part, :func:`_sharded_families`), and
    granite-34b and qwen1.5-4b under rules that leave an attention
    activation whole (12b.4c.2a, :func:`_sharded_act_whole`).
    Returns kernel 12's launches over all the sharded steps, and each
    arch's one-device losses (the four-rank phase's yardstick)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.launch.train import token_batches, train_config
    cfg = get_config(TRAIN_ARCH)
    tcfg = train_config(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    data_fn = token_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 0, "cuda")
    dist.init_process_group("nccl", init_method=f"file://{_nccl_store()}", rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        rec = _sharded_lm_steps(mesh, cfg, tcfg, data_fn, "cuda", one_device["params"],
                                profile=True)
        families = _sharded_families(mesh)
        families.update(_sharded_act_whole(mesh))
    finally:
        dist.destroy_process_group()
    losses = [st["loss"] for st in rec["steps"]]
    want = {"flash_attention": 2 * cfg.n_layers, **dict.fromkeys(BWD_LABELS, cfg.n_layers)}
    for i, st in enumerate(rec["steps"]):
        print(f"[sharded-train] {TRAIN_ARCH} full on a 1 x 1 ('data', 'model') mesh (1-rank "
              f"NCCL), step {i}: loss={st['loss']:.6f} (one device {one_device['losses'][i]:.6f}) "
              f"ms={st['ms']:.3f}; kernel 12 launches {st['launches']}", flush=True)
        check(st["launches"] == want, f"kernel 12's launches in a sharded step: "
              f"{st['launches']}, expected {want}")
    train = report["train_full"]
    prof, one_prof = rec["profile"], train["profile"]
    one_wall = sum(one_prof[k]["wall_ms"] for k in one_prof)
    one_busy = sum(one_prof[k]["device_busy_ms"] or 0.0 for k in one_prof)
    print(f"[sharded-train] losses bitwise one device's={losses == one_device['losses']}; "
          f"parameters after {TRAIN_STEPS} steps bitwise={rec['bitwise']} (worst "
          f"|d|={rec['worst_abs']:.3e}); peak_mem_GB={rec['peak_mem_bytes'] / 1e9:.3f} "
          f"(phase_train {train['peak_mem_bytes'] / 1e9:.3f}); ms a step "
          + ", ".join(f"{st['ms']:.3f}" for st in rec["steps"])
          + " (phase_train " + ", ".join(f"{st['ms']:.3f}" for st in train["steps"])
          + f"); profiled step wall_ms={prof['wall_ms']:.3f} busy={_busy(prof)}"
          + f" (phase_train's profiled stages {one_wall:.3f} ms, busy "
          + (f"{100 * one_busy / one_wall:.2f}%)" if one_busy else "not measured)"), flush=True)
    check(losses == one_device["losses"], f"the 1-rank sharded step's losses {losses} are not "
          f"one device's {one_device['losses']} bit for bit")
    check(rec["bitwise"] and rec["finite"], "the 1-rank sharded step's parameters after "
          f"{TRAIN_STEPS} steps are not one device's bit for bit")
    report["sharded_train"] = dict(rec, arch=TRAIN_ARCH, losses_bitwise=True,
                                   families=families)
    launches = {op: sum(st["launches"][op] for r in (rec, *families.values())
                        for st in r["steps"]) for op in want}
    losses = {TRAIN_ARCH: one_device["losses"],
              **{arch: r["one_device"]["losses"] for arch, r in families.items()}}
    return launches, losses


#: phase_sharded_train's other families, at FAMILY_ARCHS's depths
SHARDED_FAMILIES = ("mamba2-780m", "zamba2-2.7b", "seamless-m4t-large-v2",
                    "deepseek-v2-lite-16b")
#: the four-rank phase's families of the sharded step, beside stablelm-3b
FOUR_RANK_FAMILIES = ("zamba2-2.7b", "seamless-m4t-large-v2")


def _family_cut(arch):
    """``arch`` at its published widths cut to FAMILY_ARCHS's depth; the
    moe family at EP_MOE_CF, where no copy is dropped: on a mesh its
    routed experts take the expert-parallel form, which packs each
    expert's copies at twice the local form's capacity (the reference's
    headroom), so on a 1 x 1 mesh it gives one device's bits only where
    neither form drops a copy."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch).replace(**FAMILY_ARCHS[arch])
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=EP_MOE_CF))
    return cfg


def _family_launches(arch):
    """Kernel 12's launches in one step of ``arch`` at FAMILY_ARCHS's
    depth (remat full): FAMILY_CUT_LAUNCHES, none without kernel 12."""
    fwd, bwd = FAMILY_CUT_LAUNCHES.get(arch, (0, 0))
    return {"flash_attention": fwd, **dict.fromkeys(BWD_LABELS, bwd)}


def _busy(prof):
    """A profiled step's device busy share of its wall, as a percentage."""
    busy = prof and prof["device_busy_ms"]
    return f"{100 * busy / prof['wall_ms']:.2f}%" if busy else "not measured"


def _sharded_families(mesh):
    """The sharded train step of the ssm, hybrid, encdec and moe families
    (ROADMAP 12b.4c's first part) on the 1 x 1 ``mesh``: each of
    SHARDED_FAMILIES at its published widths and FAMILY_ARCHS's depth
    (:func:`_family_cut`), launch/train.py's TrainConfig (f32, remat
    "full"), TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens, first on
    the card alone, then placed on the mesh. Each loss and every parameter
    after the steps must be one device's bit for bit, and kernel 12's
    launches FAMILY_CUT_LAUNCHES a step in both runs (zamba2's shared
    attention at d 80, seamless's three attentions at d 64; none in mamba2
    and deepseek). Records ms a step, the peak and the busy share of a
    profiled 4th step of both runs. Returns {arch: record}."""
    from repro_torch.launch.train import token_batches, train_config
    out = {}
    for arch in SHARDED_FAMILIES:
        t0 = time.perf_counter()
        cfg = _family_cut(arch)
        tcfg = train_config(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ)
        data_fn = token_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 0, "cuda")
        one = _one_device_lm(cfg, tcfg, data_fn, "cuda", profile=True)
        t1 = time.perf_counter()
        rec = _sharded_lm_steps(mesh, cfg, tcfg, data_fn, "cuda", one.pop("params"),
                                profile=True)
        seconds = (t1 - t0, time.perf_counter() - t1)
        losses, want = [st["loss"] for st in rec["steps"]], _family_launches(arch)
        depth = f"{cfg.n_layers} layers" + (f" + {cfg.n_enc_layers} encoder"
                                            if cfg.n_enc_layers else "")
        print(f"[sharded-train] {arch} full width, {depth}, on a 1 x 1 ('data', 'model') "
              f"mesh (1-rank NCCL), {TRAIN_BATCH} x {TRAIN_SEQ} tokens: losses {losses} "
              f"(one device {one['losses']}, bitwise={losses == one['losses']}); parameters "
              f"after {TRAIN_STEPS} steps bitwise={rec['bitwise']} (worst "
              f"|d|={rec['worst_abs']:.3e}); ms a step "
              + ", ".join(f"{st['ms']:.3f}" for st in rec["steps"]) + " (one device "
              + ", ".join(f"{st['ms']:.3f}" for st in one["steps"])
              + f"); peak_mem_GB={rec['peak_mem_bytes'] / 1e9:.3f} (one device "
              f"{one['peak_mem_bytes'] / 1e9:.3f}); profiled step wall_ms="
              f"{rec['profile']['wall_ms']:.3f} busy={_busy(rec['profile'])} (one device "
              f"{one['profile']['wall_ms']:.3f} ms, busy {_busy(one['profile'])}); kernel 12 "
              f"launches a step {rec['steps'][0]['launches']}; seconds one device "
              f"{seconds[0]:.1f}, mesh {seconds[1]:.1f}", flush=True)
        check(all(st["launches"] == want for st in rec["steps"] + one["steps"]),
              f"{arch}: kernel 12's launches in a sharded step "
              f"{[st['launches'] for st in rec['steps']]} (one device "
              f"{[st['launches'] for st in one['steps']]}), expected {want}")
        check(losses == one["losses"], f"{arch}: the 1-rank sharded step's losses {losses} are "
              f"not one device's {one['losses']} bit for bit")
        check(rec["bitwise"] and rec["finite"], f"{arch}: the 1-rank sharded step's parameters "
              f"after {TRAIN_STEPS} steps are not one device's bit for bit")
        out[arch] = dict(rec, one_device=one, n_layers=cfg.n_layers,
                         n_enc_layers=cfg.n_enc_layers, losses_bitwise=True, seconds=seconds)
    return out


def _sharded_act_whole(mesh):
    """The sharded train step of ACT_WHOLE_ARCHS on the 1 x 1 ``mesh``
    under their rules for ACT_WHOLE_MODEL model ranks (ROADMAP 12b.4c.2a):
    each at its published widths and cut depth, TRAIN_STEPS steps of
    TRAIN_BATCH x TRAIN_SEQ tokens on the card alone, then placed on the
    mesh. Each loss and every parameter must be one device's bit for bit,
    and kernel 12's launches 2 forwards and one backward a layer a step in
    both runs. Returns {arch: record}."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import build_rules
    from repro_torch.launch.train import token_batches, train_config
    out = {}
    for arch, cut in ACT_WHOLE_ARCHS.items():
        t0 = time.perf_counter()
        cfg = get_config(arch).replace(**cut)
        rules = build_rules(cfg, model_size=ACT_WHOLE_MODEL)
        tcfg = train_config(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ)
        data_fn = token_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 0, "cuda")
        one = _one_device_lm(cfg, tcfg, data_fn, "cuda")
        rec = _sharded_lm_steps(mesh, cfg, tcfg, data_fn, "cuda", one.pop("params"), rules=rules)
        losses = [st["loss"] for st in rec["steps"]]
        want = {"flash_attention": 2 * cfg.n_layers, **dict.fromkeys(BWD_LABELS, cfg.n_layers)}
        print(f"[sharded-train] {arch} full width, {cfg.n_layers} layers, on a 1 x 1 ('data', "
              f"'model') mesh (1-rank NCCL) under its rules for {ACT_WHOLE_MODEL} model ranks "
              f"(heads_act {rules['heads_act']}, kv_heads_act {rules['kv_heads_act']}), "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens: losses {losses} (one device "
              f"{one['losses']}, bitwise={losses == one['losses']}); parameters after "
              f"{TRAIN_STEPS} steps bitwise={rec['bitwise']} (worst |d|={rec['worst_abs']:.3e}); "
              "ms a step " + ", ".join(f"{st['ms']:.3f}" for st in rec["steps"])
              + " (one device " + ", ".join(f"{st['ms']:.3f}" for st in one["steps"])
              + f"); peak_mem_GB={rec['peak_mem_bytes'] / 1e9:.3f} (one device "
              f"{one['peak_mem_bytes'] / 1e9:.3f}); kernel 12 launches a step "
              f"{rec['steps'][0]['launches']}; {time.perf_counter() - t0:.1f} s", flush=True)
        check(all(st["launches"] == want for st in rec["steps"] + one["steps"]),
              f"{arch}: kernel 12's launches in a sharded step "
              f"{[st['launches'] for st in rec['steps']]} (one device "
              f"{[st['launches'] for st in one['steps']]}), expected {want}")
        check(losses == one["losses"], f"{arch}: the 1-rank sharded step's losses {losses} under "
              f"the rules for {ACT_WHOLE_MODEL} model ranks are not one device's {one['losses']} "
              "bit for bit")
        check(rec["bitwise"] and rec["finite"], f"{arch}: the 1-rank sharded step's parameters "
              f"after {TRAIN_STEPS} steps are not one device's bit for bit")
        out[arch] = dict(rec, one_device=one, n_layers=cfg.n_layers, losses_bitwise=True,
                         rules={k: rules[k] for k in ("heads_act", "kv_heads_act")})
    return out


#: phase_family_train's steps: each family's depth cut (FAMILY_SERVE's,
#: cut from the full depth to keep the script under 720 s)
#: and kernel 12's launches in one step under remat="full", where
#: each checkpoint runs its forward twice and its backward once: (forward,
#: each of D, dK/dV and dQ). zamba2: one shared attention a group of 6, 2
#: groups; seamless: 6 encoder (full), 6 decoder self (causal) and 6
#: cross (full) calls; deepseek at 4 of 27 layers (the dense layer 0 and 3
#: moe layers: its 27 would need 251 GB with AdamW's moments)
#: phase_family_train (a)'s steps a family, the first of TRAIN_STEPS' schedule
#: (cut from 3 to keep the script near 700 s; phase_train keeps all 3)
FAMILY_TRAIN_STEPS = 2
FAMILY_TRAIN = {
    "mamba2-780m": (FAMILY_SERVE["mamba2-780m"][0], 0, 0),
    "zamba2-2.7b": (FAMILY_SERVE["zamba2-2.7b"][0], 4, 2),
    "seamless-m4t-large-v2": (FAMILY_SERVE["seamless-m4t-large-v2"][0], 36, 18),
    "paligemma-3b": (FAMILY_SERVE["paligemma-3b"][0], 0, 0),
    "deepseek-v2-lite-16b": (dict(n_layers=4), 0, 0),
}
#: kernel 12's launches in one value_and_grad at FAMILY_ARCHS's cut (remat
#: full): zamba2's one group, seamless's 2 + 2 layers
FAMILY_CUT_LAUNCHES = {"zamba2-2.7b": (2, 1), "seamless-m4t-large-v2": (12, 6)}
FAMILY_PARITY_SEQ = 128     # the tokens a row in the card-vs-CPU gradients
TRAIN_LOSS_REL = 1e-5       # a loss, the card against the CPU or the plain attention
WIDE_HEAD = 160             # a head width past kernel 12's MAX_D


def _kernel12_counts(counts):
    return {op: counts[op] for op in ("flash_attention", *BWD_LABELS)}


def _grad_rels(got, want):
    """max|g - w| / max|w| of each gradient leaf (``got`` moved to w's
    device), by leaf name."""
    from repro_torch.train._tree import named_leaves
    want = named_leaves(want)
    return {name: float((g.to(want[name].device) - want[name]).abs().max()
                        / want[name].abs().max().clamp_min(1e-30))
            for name, g in named_leaves(got).items()}


def _family_steps(arch, cut, fwd, bwd):
    """(a) ``arch`` at its published widths (depth ``cut``), seed-0 weights
    drawn on the card, launch/train.py's TrainConfig (f32, remat="full",
    AdamW, z-loss), FAMILY_TRAIN_STEPS steps of 2 x 1,024 tokens from
    ``token_batches``;
    the peak memory; one more step profiled by stage. Frees its weights and
    AdamW state before it returns (the record, kernel 12's launches in the
    last step)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import token_batches, train_config
    from repro_torch.models import get_api
    from repro_torch.train import adamw_init, build_train_step
    from repro_torch.train import train_step as ts
    from repro_torch.train._tree import leaves
    cfg = get_config(arch).replace(**cut)
    tcfg = train_config(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = get_api(cfg).init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    opt = adamw_init(params)
    n_params = sum(t.numel() for t in leaves(params))
    data_fn = token_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 0, "cuda")
    step = build_train_step(cfg, tcfg)
    want = {"flash_attention": fwd, **dict.fromkeys(BWD_LABELS, bwd)}
    # the loss's parts (moe: xent + the router's aux loss), read from loss_fn
    real_loss_fn, parts = ts.loss_fn, []

    def recorded(*args, **kw):
        loss, aux = real_loss_fn(*args, **kw)
        parts.append({k: float(v.detach()) if torch.is_tensor(v) else float(v)
                      for k, v in aux.items()})
        return loss, aux

    steps = []
    ts.loss_fn = recorded
    try:
        for i in range(FAMILY_TRAIN_STEPS):
            batch = data_fn(i)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            m = {k: float(v) for k, v in m.items()}
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = _kernel12_counts(ops.launch_counts())
            xent, aux = parts[-1]["xent"], parts[-1]["aux"]
            steps.append(dict(m, ms=ms, launches=launches, xent=xent, aux=aux))
            print(f"[family-train] {arch} ({cfg.n_layers} layers"
                  + (f" + {cfg.n_enc_layers} encoder" if cfg.n_enc_layers else "")
                  + f", {n_params:,} parameters), {TRAIN_BATCH} x {TRAIN_SEQ} tokens, step {i}: "
                  f"loss={m['loss']:.6f} " + (f"(xent {xent:.6f} + aux {aux:.6f}) "
                                              if cfg.family == "moe" else "")
                  + f"grad_norm={m['grad_norm']:.6f} lr={m['lr']:.6e} ms={ms:.3f}; kernel 12 "
                  f"launches: forward {launches['flash_attention']}, backward "
                  + ", ".join(f"{op.rsplit('_', 1)[1]} {launches[op]}" for op in BWD_LABELS),
                  flush=True)
            check(all(np.isfinite([m["loss"], m["grad_norm"], m["lr"]])),
                  f"{arch}: a train step's loss or grad norm is not finite")
            check(launches == want, f"{arch}: kernel 12's launches in a train step {launches}, "
                                    f"not {want}")
            if cfg.family == "moe":
                check(np.isfinite(aux) and aux > 0.0
                      and abs(xent + aux - m["loss"]) <= 1e-6 * abs(m["loss"]),
                      f"{arch}: the aux loss {aux} is not a finite positive part of the loss "
                      f"{m['loss']} (xent {xent})")
    finally:
        ts.loss_fn = real_loss_fn
    peak = torch.cuda.max_memory_allocated()
    check(all(bool(torch.isfinite(t).all()) for t in leaves(params)),
          f"{arch}: a parameter is not finite after training")
    print(f"[family-train] {arch} peak_mem_GB={peak / 1e9:.3f} (weights, gradients and AdamW's "
          f"two moments in f32 {16 * n_params / 1e9:.3f} GB)", flush=True)
    profile = _train_profile(cfg, tcfg, params, opt, data_fn(FAMILY_TRAIN_STEPS))
    rec = dict(n_layers=cfg.n_layers, n_enc_layers=cfg.n_enc_layers, n_params=n_params,
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=steps, peak_mem_bytes=peak,
               profile=profile)
    del params, opt, step, data_fn
    torch.cuda.empty_cache()
    return rec, steps[-1]["launches"]


def _family_vs_cpu(arch, cut):
    """(b) ``arch`` at FAMILY_ARCHS's cut: one value_and_grad of 2 x 128
    tokens (remat full) on the CPU and on the card from the same weights
    and batch: the loss and every gradient leaf; deepseek's router
    near-ties counted first. (d) a second call on the card: the same bits
    in every leaf."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import token_batches, train_config
    from repro_torch.models import get_api
    from repro_torch.train._tree import named_leaves
    from repro_torch.train.train_step import value_and_grad
    cfg = get_config(arch).replace(**cut)
    tcfg = train_config(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=FAMILY_PARITY_SEQ)
    params = get_api(cfg).init_params(torch.Generator().manual_seed(0), cfg)
    batch = token_batches(cfg, TRAIN_BATCH, FAMILY_PARITY_SEQ, 0, "cpu")(0)
    routing = None
    if cfg.family == "moe":
        routing = _prefill_routing(f"family-train {arch}", cfg, params,
                                   {k: v for k, v in batch.items() if k != "labels"},
                                   FAMILY_PARITY_SEQ)
    t0 = time.perf_counter()
    loss_c, grads_c = value_and_grad(params, cfg, batch, tcfg)
    cpu_s = time.perf_counter() - t0
    params_g = _tree_to(params, "cuda")
    batch_g = {k: v.to("cuda") for k, v in batch.items()}
    del params
    runs = [value_and_grad(params_g, cfg, batch_g, tcfg) for _ in range(2)]
    (loss_g, grads_g), (loss_2, grads_2) = runs
    rels = _grad_rels(grads_g, grads_c)
    loss_rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    second = named_leaves(grads_2)
    differ = [name for name, g in named_leaves(grads_g).items()
              if not torch.equal(g, second[name])]
    top = sorted(rels, key=rels.get, reverse=True)[:3]
    worst = top[0]
    print(f"[family-train] {arch} {cut}, {TRAIN_BATCH} x {FAMILY_PARITY_SEQ}: the card against "
          f"the CPU: loss {float(loss_g):.6f} (CPU {float(loss_c):.6f}, rel {loss_rel:.3e}, limit "
          f"{TRAIN_LOSS_REL}); {len(rels)} gradient leaves, worst max|g-g_cpu|/max|g_cpu| "
          + ", ".join(f"{n} {rels[n]:.3e}" for n in top)
          + f" (limit {TRAIN_GRAD_REL}); CPU side {cpu_s:.1f} s; a "
          f"second backward on the card: loss "
          f"{'the same' if torch.equal(loss_g, loss_2) else 'other'} bits, {len(differ)} leaves "
          f"with other bits {differ[:4]}", flush=True)
    check(loss_rel <= TRAIN_LOSS_REL and rels[worst] <= TRAIN_GRAD_REL,
          f"{arch}: the card's loss or gradients part from the CPU's")
    check(torch.equal(loss_g, loss_2) and not differ,
          f"{arch}: two backward passes on the card give other bits: {differ}")
    rec = dict(cut=cut, loss=float(loss_g), loss_cpu=float(loss_c), loss_rel=loss_rel,
               worst_grad_rel=rels[worst], worst_leaves={n: rels[n] for n in top}, cpu_s=cpu_s,
               second_backward_bitwise=True, routing=routing)
    del params_g, batch_g, runs, grads_g, grads_2, grads_c
    torch.cuda.empty_cache()
    return rec


def _f64_attention(q, k, v, causal=True):
    """Kernel 12's function in float64 (the kv heads repeated), rounded to
    q's type: the exact attention, differentiated by autograd in float64."""
    rep = q.shape[-3] // k.shape[-3]
    s, d = q.shape[-2:]
    kd, vd = (t.double().repeat_interleave(rep, dim=-3) for t in (k, v))
    logits = q.double() @ kd.transpose(-1, -2) / math.sqrt(d)
    if causal:
        logits = logits.masked_fill(
            torch.ones((s, s), dtype=torch.bool, device=q.device).triu(1), -torch.inf)
    return (torch.softmax(logits, dim=-1) @ vd).to(q.dtype)


def _family_kernel_vs_plain(arch, cut):
    """(c) ``arch`` at FAMILY_ARCHS's cut, one value_and_grad of 2 x 1,024
    tokens on the card with kernel 12, with its f32 plain version
    (``_plain_attention``) and with its function in float64
    (``_f64_attention``): the launches (the plain runs none), and the loss
    and every gradient leaf of the kernels held to the float64 attention's:
    TRAIN_GRAD_REL of the leaf's max, or twice the f32 plain version's own
    distance where that is larger. The f32 plain version carries rounding
    of the kernels' size, which an ill-conditioned leaf (mamba's ``a_log``:
    a sum over every position of terms of both signs) magnifies past
    TRAIN_GRAD_REL; the distances between all three are printed."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import token_batches, train_config
    from repro_torch.models import get_api
    from repro_torch.train.train_step import value_and_grad
    cfg = get_config(arch).replace(**cut)
    tcfg = train_config(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    params = get_api(cfg).init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    batch = token_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 0, "cuda")(0)
    ops.reset_launch_counts()
    loss_k, grads_k = value_and_grad(params, cfg, batch, tcfg)
    counts_k = _kernel12_counts(ops.launch_counts())
    runs, plain_counts = {}, 0
    for name, fn in (("f32", None), ("f64", _f64_attention)):
        with _plain_attention(fn):
            ops.reset_launch_counts()
            runs[name] = value_and_grad(params, cfg, batch, tcfg)
            plain_counts += sum(ops.launch_counts().values())
    fwd, bwd = FAMILY_CUT_LAUNCHES[arch]
    check(counts_k == {"flash_attention": fwd, **dict.fromkeys(BWD_LABELS, bwd)}
          and plain_counts == 0, f"{arch}: launches: kernels {counts_k}, plain {plain_counts}")
    dist, rels = {}, {}
    for tag, (loss_a, grads_a), (loss_b, grads_b) in (
            ("kernels-f64", (loss_k, grads_k), runs["f64"]),
            ("kernels-f32plain", (loss_k, grads_k), runs["f32"]),
            ("f32plain-f64", runs["f32"], runs["f64"])):
        rel = rels[tag] = _grad_rels(grads_a, grads_b)
        top = sorted(rel, key=rel.get, reverse=True)[:3]
        dist[tag] = dict(loss_rel=abs(float(loss_a) - float(loss_b)) / abs(float(loss_b)),
                         worst_grad_rel=rel[top[0]], worst_leaves={n: rel[n] for n in top})
        print(f"[family-train] {arch} {cut}, {TRAIN_BATCH} x {TRAIN_SEQ}, {tag}: loss rel "
              f"{dist[tag]['loss_rel']:.3e}; worst leaves "
              + ", ".join(f"{n} {rel[n]:.3e}" for n in top), flush=True)
    # a leaf that f32 attention itself cannot hold to TRAIN_GRAD_REL of the
    # float64 attention's (the plain version parts by more) is held to twice
    # the plain version's distance
    kern, plain = rels["kernels-f64"], rels["f32plain-f64"]
    limits = {n: max(TRAIN_GRAD_REL, 2 * plain[n]) for n in kern}
    past = {n: (kern[n], plain[n]) for n in kern if limits[n] > TRAIN_GRAD_REL}
    bad = {n: kern[n] for n in kern if kern[n] > limits[n]}
    print(f"[family-train] {arch}: kernel 12's launches {counts_k}, the plain runs' "
          f"{plain_counts}; the kernels held to the float64 attention (limits: loss "
          f"{TRAIN_LOSS_REL}, each leaf {TRAIN_GRAD_REL}, or twice the f32 plain version's "
          f"distance where that is past it: (kernels, plain) "
          + (", ".join(f"{n} ({a:.3e}, {b:.3e})" for n, (a, b) in past.items()) or "none")
          + f"); leaves past their limit {bad}", flush=True)
    check(dist["kernels-f64"]["loss_rel"] <= TRAIN_LOSS_REL and not bad,
          f"{arch}: kernel 12's gradients part from the float64 attention's: {bad}")
    rec = dict(cut=cut, launches=counts_k, f32_limited_leaves=past, **dist)
    del params, grads_k, runs
    torch.cuda.empty_cache()
    return rec


def _wide_heads(report):
    """(e) heads past kernel 12's width on the card: stablelm-3b's widths
    at 2 layers with head_dim 160, and paligemma-3b (head_dim 256) at 2
    layers over an empty image prefix (a plain causal mask): the card's
    logits (stablelm's forward, paligemma's prefill) against the CPU's,
    then a forward and backward on the card, finite, with no launch."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import token_batches, train_config
    from repro_torch.models import get_api
    from repro_torch.train._tree import leaves
    from repro_torch.train.train_step import value_and_grad
    out = {}
    for arch, over in ((SERVE_ARCH, dict(n_layers=2, head_dim=WIDE_HEAD)),
                       ("paligemma-3b", dict(n_layers=2))):
        cfg = get_config(arch).replace(**over)
        api = get_api(cfg)
        params = api.init_params(torch.Generator().manual_seed(0), cfg)
        batch = token_batches(cfg, TRAIN_BATCH, FAMILY_PARITY_SEQ, 0, "cpu")(0)
        if cfg.family == "vlm":
            batch["image_embeds"] = torch.zeros((TRAIN_BATCH, 0, cfg.d_model))
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        params_g = _tree_to(params, "cuda")
        batch_g = {k: v.to("cuda") for k, v in batch.items()}
        kw = dict(compute_dtype=torch.float32)
        ops.reset_launch_counts()
        if cfg.family == "vlm":
            want = api.prefill(params, cfg, inputs, FAMILY_PARITY_SEQ, **kw)[0]
            got = api.prefill(params_g, cfg, {k: v.to("cuda") for k, v in inputs.items()},
                              FAMILY_PARITY_SEQ, **kw)[0]
        else:
            want = api.forward(params, cfg, inputs, **kw)
            got = api.forward(params_g, cfg, {k: v.to("cuda") for k, v in inputs.items()}, **kw)
        err = float((got.cpu() - want).abs().max() / want.abs().max())
        loss, grads = value_and_grad(params_g, cfg, batch_g, train_config(
            steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=FAMILY_PARITY_SEQ))
        counts = ops.launch_counts()
        finite = (bool(torch.isfinite(got).all()) and bool(torch.isfinite(loss))
                  and all(bool(torch.isfinite(g).all()) for g in leaves(grads)))
        hd = cfg.resolved_head_dim
        print(f"[family-train] wide heads: {arch} {over} (head_dim {hd}), {TRAIN_BATCH} x "
              f"{FAMILY_PARITY_SEQ}" + (", an empty image prefix" if cfg.family == "vlm" else "")
              + f": the card's {'prefill ' if cfg.family == 'vlm' else ''}logits against the "
              f"CPU's {err:.4e} of max|logits| (limit {SERVE_LOGIT_RTOL}); loss "
              f"{float(loss):.6f}; "
              f"finite {finite}; kernel launches {sum(counts.values())}", flush=True)
        check(finite and err <= SERVE_LOGIT_RTOL and sum(counts.values()) == 0,
              f"{arch} at head_dim {hd}: finite {finite}, logits {err:.3e}, launches {counts}")
        out[arch] = dict(head_dim=hd, rel_logit_err=err, loss=float(loss), launches=0)
        del params, params_g, batch_g, grads, got, want
        torch.cuda.empty_cache()
    report["wide_heads"] = out


def phase_family_train(report):
    """The ssm, hybrid, encdec, vlm and moe families trained on the card
    through launch/train.py's path: (a) FAMILY_TRAIN_STEPS steps at published widths
    (``FAMILY_TRAIN``), (b) gradients against the CPU at FAMILY_ARCHS's
    cut, (c) zamba2's and seamless's against kernel 12's plain version,
    (d) the same bits from a second backward, (e) heads past kernel 12's
    width. Returns kernel 12's launches a step in (a), by arch."""
    out, launches = {}, {}
    for arch, (cut, fwd, bwd) in FAMILY_TRAIN.items():
        rec, launches[arch] = _family_steps(arch, cut, fwd, bwd)
        rec["vs_cpu"] = _family_vs_cpu(arch, FAMILY_ARCHS[arch])
        if arch in FAMILY_CUT_LAUNCHES:
            rec["vs_plain"] = _family_kernel_vs_plain(arch, FAMILY_ARCHS[arch])
        out[arch] = rec
    report["family_train"] = out
    _wide_heads(report)
    return launches


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


def _serve_profile(cfg, params, tokens, label="serve-profile"):
    """The serve path's prefill and 4 decode steps under torch.profiler,
    with serve's inputs (the stub embeddings of encdec and vlm too)."""
    from repro_torch.models import make_train_batch
    from repro_torch.train.train_step import build_decode_step, build_prefill
    max_len = SERVE_PROMPT + SERVE_GEN + (cfg.n_prefix_tokens or 0)
    first = SERVE_PROMPT + (cfg.n_prefix_tokens if cfg.family == "vlm" else 0)
    data = make_train_batch(cfg, SERVE_BATCH, SERVE_PROMPT, torch.Generator().manual_seed(0))
    data = {key: x.to("cuda") for key, x in data.items() if key != "labels"}
    prefill = build_prefill(cfg, max_len, compute_dtype=torch.float32)
    decode = build_decode_step(cfg, compute_dtype=torch.float32)
    state = {}

    def run_prefill():
        out = prefill(params, data)
        state["cache"] = out[1]
        state["extras"] = {"enc_out": out[2]} if cfg.family == "encdec" else None

    def run_decode():
        for i in range(4):
            decode(params, tokens[:, i:i + 1], state["cache"], first + i, state["extras"])

    out = {"prefill": _profiled(run_prefill), "decode_4_steps": _profiled(run_decode)}
    for tag, rec in out.items():
        busy = rec["device_busy_ms"]
        print(f"[{label}] {tag}: wall_ms={rec['wall_ms']:.3f} device_busy_ms="
              + (f"{busy:.3f} busy_share={busy / rec['wall_ms']:.4f}" if busy is not None
                 else "not measured (no device events)"), flush=True)
        for t in rec["top"]:
            print(f"[{label}]   {t['ms']:9.3f} ms  x{t['launches']:<5d} {t['name']}")
    return out

#: device-event names of this port's kernels (always listed by the profile)
KERNEL_LABELS = ("affinity_kernel", "affinity_reg_kernel", "power_step_kernel",
                 "kmeans_assign_", "streaming_matmat_kernel", "streaming_matmat_reg_kernel",
                 "streaming_degree_kernel", "streaming_degree_reg_kernel", "gram_", "row_topk_",
                 "liveness_kernel", "liveness_reg_kernel", "bs_matmat_kernel",
                 "bs_streaming_matmat_kernel", "bs_streaming_matmat_reg_kernel",
                 "bs_streaming_degree_kernel", "bs_streaming_degree_reg_kernel")
#: the power loop's sweeps of an r = 2 run, on either engine and route (the
#: streamed ones in their register or staged template)
SWEEP_R2 = re.compile(
    r"(power_step|bs_matmat|streaming_matmat(_reg)?|bs_streaming_matmat(_reg)?)_kernel<2")


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


def _kmeans_ms(spans):
    """Device busy ms of the k-means stage, cut as in _stages: from the
    first assignment's start to the last one's end, the Lloyd updates
    between them included (None where no assignment ran)."""
    km = [(st, e) for st, e, lab in spans if lab.startswith("kmeans_assign_")]
    if not km:
        return None
    return _busy_us(spans, min(st for st, _ in km), max(e for _, e in km)) / 1e3


def _stages(spans):
    """Device busy ms of a graph run's stages, cut at kernel boundaries of
    the timeline: pass 1 (to the last row_topk launch), the build (to the
    first r = 2 sweep, the power loop's first), the power sweeps (to the
    first k-means assignment), k-means (to the last assignment) and the
    component probe (the rest)."""
    def last_end(label):
        ends = [e for _, e, lab in spans if lab.startswith(label)]
        return max(ends) if ends else None
    km = [st for st, _, lab in spans if lab.startswith("kmeans_assign_")]
    t0 = spans[0][0]
    cuts = [("pass1", last_end("row_topk_") or t0),
            ("build", min(st for st, _, lab in spans if SWEEP_R2.match(lab))),
            ("sweeps", min(km)),
            ("kmeans", last_end("kmeans_assign_")),
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
    kmeans_ms = _kmeans_ms(spans)
    print(f"[profile] {tag} {engine} k-means stage (device busy ms, first to last "
          f"assignment): {kmeans_ms:.3f}", flush=True)
    stages = _stages(spans) if tag != "classic" else None
    if stages is not None:
        stages["idle"] = wall_ms - busy_us / 1e3
        print("[profile] " + tag + " stages (device busy ms; idle = wall - busy): "
              + " ".join(f"{name}={ms:.3f}" for name, ms in stages.items()), flush=True)
    report[key] = dict(wall_ms=wall_ms, device_busy_ms=busy_us / 1e3, device_events=len(spans),
                       kmeans_ms=kmeans_ms, stages=stages,
                       top=[dict(name=l, launches=c, ms=ms) for l, (c, ms) in top])


def _directions(n: int, seed: int = 0, m: int = 8, noise: float = 0.02):
    """(x, k): three clusters of n/2, 3n/10 and the rest of the points along
    three orthogonal directions in m = 8, at magnitudes in [0.5, 2], plus
    |noise| in every coordinate: features the cosine kinds separate (on the
    2-D sets cosine_shifted leaves an embedding of f32 noise)."""
    rng = np.random.default_rng(seed)
    sizes = [n // 2, 3 * n // 10]
    y = np.repeat(np.arange(3), sizes + [n - sum(sizes)])
    dirs = np.zeros((3, m))
    for c in range(3):
        dirs[c, 2 * c:2 * c + 2] = np.sqrt(0.5)
    x = dirs[y] * rng.uniform(0.5, 2.0, (n, 1)) + noise * np.abs(rng.standard_normal((n, m)))
    return x.astype(np.float32), 3


#: the cosine_shifted runs of the sharded phase stop after 3 sweeps: run to
#: its eps, (1 + cos) / 2 leaves an embedding spread of ~1e-6 of its size,
#: whose partition is f32 noise
EARLY = dict(eps_scale=0.0, max_iter=3)
DIST_RTOL = 1e-5        # a sharded embedding against one device's, relative to max|v|
FOUR_RANKS = 4
FOUR_RANK_S = 600       # the four-rank phase's deadline, and its ranks' collective timeout


def _sharded_runs():
    """(tag, entry, data, keyword arguments) of the sharded phase at
    n = 45,000: the main path's explicit and streaming runs, E1 on both
    engines (block-sparse, orthogonal r = 2), bf16 A, fold_shift and the
    matrix-free engine (the cosine kinds on the direction clusters)."""
    from repro_torch import AffinitySpec
    rbf = dict(affinity_kind="rbf", sigma=SIGMA, max_iter=400)
    e1 = dict(affinity=AffinitySpec(**E1_SPEC), max_iter=400, embedding="orthogonal",
              n_vectors=2)
    return (("explicit", "gpic", "gaussians", dict(engine="explicit", **rbf)),
            ("streaming", "gpic", "gaussians", dict(engine="streaming", **rbf)),
            ("E1 explicit", "gpic", "gaussians", dict(engine="explicit", **e1)),
            ("E1 streaming", "gpic", "gaussians", dict(engine="streaming", **e1)),
            ("explicit bf16", "gpic", "gaussians",
             dict(engine="explicit", a_dtype=torch.bfloat16, **rbf)),
            ("explicit fold_shift", "gpic", "directions",
             dict(engine="explicit", fold_shift=True, **EARLY)),
            ("matrix_free", "matrix_free", "directions", dict(**EARLY)))


def _one_device_twin(entry, x, k, kw):
    """The single-device entry point of a sharded run, with the same
    generator seed (fold_shift is a stripe storage detail it has no
    counterpart of)."""
    from repro_torch.core import gpic, gpic_matrix_free
    kw = dict(kw)
    kw.pop("fold_shift", None)
    eps_scale = kw.pop("eps_scale", 1e-5)
    run = gpic if entry == "gpic" else gpic_matrix_free
    return run(x, k, eps=eps_scale / x.shape[0],
               generator=torch.Generator(device="cuda").manual_seed(0), **kw)


def _sharded_call(entry, x_loc, k, kw, device="cuda"):
    from repro_torch.core import distributed as D
    run = D.distributed_gpic if entry == "gpic" else D.distributed_gpic_matrix_free
    return run(x_loc, k, device=device,
               generator=torch.Generator(device=device).manual_seed(0), **kw)


def _nccl_store():
    import tempfile
    return os.path.join(tempfile.mkdtemp(prefix="chip_smoke_nccl_"), "store")


#: the sharded runs phase_distributed repeats through run_gpic's supervisor
SUPERVISED_TAGS = ("explicit", "streaming", "E1 explicit", "explicit bf16")


def _same_result(a, b) -> bool:
    """Labels, embeddings, sweeps, convergence and health, bit for bit."""
    return (all(torch.equal(getattr(a, f), getattr(b, f)) for f in (
        "labels", "embedding", "embeddings", "n_iter_cols", "converged_cols"))
            and torch.equal(a.health.col_status, b.health.col_status)
            and torch.equal(a.health.components, b.health.components)
            and int(a.health.isolated_rows) == int(b.health.isolated_rows)
            and int(a.health.n_components) == int(b.health.n_components))


def _shuffled(x):
    """The rows of ``x`` in a fixed shuffled order (the reorder cases')."""
    return x[torch.as_tensor(np.random.default_rng(0).permutation(x.shape[0]),
                             device=x.device)]


def _overhead_pct(plain, supervised, reps=5):
    """(the median over ``reps`` interleaved pairs of the supervised run's
    wall over the plain one's, in %, and that pair's walls in s)."""
    pairs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        supervised().labels.cpu()
        on = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain().labels.cpu()
        off = time.perf_counter() - t0
        pairs.append((100.0 * (on - off) / off, on, off))
    return sorted(pairs)[len(pairs) // 2]


def _supervised_sharded(report, data, mono):
    """run_gpic's supervisor and row reorder on the 1-rank NCCL group at
    n = 45,000 (the group is up; ``mono`` holds the monolithic sharded runs
    of ``_sharded_runs`` by tag): each of SUPERVISED_TAGS with
    ``checkpoint_every=5`` bitwise its monolithic run, no notes; explicit
    interrupted at sweep 10 and resumed, bitwise, notes retry and
    resumed:10; a straggler timeout retried (an injector counts the
    attempts) and then raised; the ring fault of ``FaultSchedule``'s
    ``ring_stage`` on streaming the typed PowerDivergenceError; E1 explicit
    on shuffled rows with ``row_reorder``: the one-device permutation
    exactly and the one-device reordered run's labels. The checkpoint
    overhead of explicit gaussians on the group beside one device's,
    recorded, no gate. Snapshots go under build/. Returns the reorder's
    (permutation, labels) for the four-rank phase."""
    import shutil
    import torch.distributed as dist
    from repro_torch import AffinitySpec, GPICConfig, run_gpic
    from repro_torch.core import distributed as D
    from repro_torch.core.graph import graph_reorder_permutation
    from repro_torch.core.health import StragglerTimeout
    from repro_torch.core.pipeline import _row_reorder_permutation
    from repro_torch.train.fault_tolerance import FailureInjector, FaultSchedule, run_schedule
    group = dist.group.WORLD
    root = os.path.join(ROOT, "build", "chip_smoke_sharded_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    kws = {tag: kw for tag, _, _, kw in _sharded_runs()}
    xg, kg = data["gaussians"]
    x_loc = D.shard_points(xg, group)

    def on_group(tag, **kw):
        if "ckpt_dir" in kw:
            kw["ckpt_dir"] = os.path.join(root, kw["ckpt_dir"])
        return GPICConfig(mesh=group, **kws[tag]).with_(**kw)

    rec = {}
    for tag in SUPERVISED_TAGS:
        cfg = on_group(tag, checkpoint_every=5, ckpt_dir=tag.replace(" ", "_"))
        res, _, wall, counts, _ = _counted(lambda: run_gpic(x_loc, kg, cfg))
        bitwise = _same_result(res, mono[tag])
        print(f"[distributed] 1 rank {tag} supervised (checkpoint_every=5): wall_s={wall:.4f} "
              f"(monolithic {report['distributed']['runs'][tag]['wall_s']:.4f}) "
              f"n_iter_cols={res.n_iter_cols.tolist()} bitwise the monolithic run={bitwise} "
              f"notes={res.health.notes} launches={counts}", flush=True)
        check(bitwise and res.health.notes == (),
              f"1-rank {tag} with checkpoint_every=5 is not its monolithic run bit for bit")
        rec[tag] = dict(wall_s=wall, bitwise=bitwise, launches=counts)
    inj = FailureInjector(fail_at_steps=(10,))
    res = run_gpic(x_loc, kg, on_group("explicit", checkpoint_every=5, ckpt_dir="fault"),
                   segment_injector=inj.maybe_fail)
    resumed = _same_result(res, mono["explicit"])
    check(resumed and res.health.notes == ("retry:1:SimulatedFailure", "resumed:10"),
          f"1-rank explicit interrupted at sweep 10: bitwise={resumed} notes "
          f"{res.health.notes}")
    attempts = []
    try:
        run_gpic(x_loc, kg, on_group("explicit", straggler_timeout=1e-9, max_retries=2),
                 segment_injector=attempts.append)
        straggler = None
    except StragglerTimeout as e:
        straggler = str(e)
    check(straggler is not None and attempts == [0, 0, 0],
          f"a straggler timeout on the group was not retried twice, then raised: "
          f"attempts {attempts}, {straggler}")
    ring = run_schedule(x_loc, kg, FaultSchedule(ring_stage=0),
                        on_group("streaming", checkpoint_every=5, ckpt_dir="ring"))
    check(ring["status"] == "typed_error" and ring.get("error") == "PowerDivergenceError",
          f"the ring fault on the group: {ring['status']} {ring.get('error')}")
    print(f"[distributed] 1 rank explicit interrupted at sweep 10: bitwise={resumed} "
          f"notes={res.health.notes}; a straggler timeout: {len(attempts)} attempts, then "
          f"StragglerTimeout; FaultSchedule(ring_stage=0) on streaming: {ring['status']} "
          f"{ring.get('error')}", flush=True)

    xs = _shuffled(xg)
    cfg = on_group("E1 explicit", row_reorder=True)
    spec = AffinitySpec(**E1_SPEC)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, perm = _row_reorder_permutation(D.shard_points(xs, group), cfg, spec)
    torch.cuda.synchronize()
    perm_s = time.perf_counter() - t0
    perm_one = graph_reorder_permutation(xs, spec)
    res, labels, wall, _, _ = _counted(lambda: run_gpic(D.shard_points(xs, group), kg, cfg))
    one, labels_one, wall_one, _, _ = _counted(lambda: run_gpic(xs, kg, cfg.with_(mesh=None)))
    same_perm = torch.equal(perm, perm_one)
    print(f"[distributed] 1 rank E1 explicit, shuffled rows, row_reorder: the permutation "
          f"{perm_s:.4f} s, equal to one device's={same_perm}; wall_s={wall:.4f} (one device "
          f"{wall_one:.4f}) labels equal={bool((labels == labels_one).all())} "
          f"bitwise={_same_result(res, one)} n_iter_cols={res.n_iter_cols.tolist()}",
          flush=True)
    check(same_perm and bool((labels == labels_one).all()),
          "the reordered run on the group differs from the one-device reordered run")
    reorder = (perm.cpu(), labels)

    plain = GPICConfig(**kws["explicit"])
    every5 = dict(checkpoint_every=5, ckpt_dir=os.path.join(root, "timed"))

    def fresh(cfg, xx):
        def run():
            shutil.rmtree(every5["ckpt_dir"], ignore_errors=True)
            return run_gpic(xx, kg, cfg)
        return run

    overhead = {}
    for where, cfg, xx in (("one device", plain, xg), ("1-rank group", plain.with_(mesh=group),
                                                       x_loc)):
        pct, on, off = _overhead_pct(lambda: run_gpic(xx, kg, cfg),
                                     fresh(cfg.with_(**every5), xx))
        overhead[where] = dict(pct=pct, on_s=on, off_s=off)
    print(f"[distributed] checkpoint overhead, explicit gaussians n={N_MAIN} checkpoint_every=5 "
          "(median of 5 interleaved pairs, recorded): " + "; ".join(
              f"{where} {o['pct']:.2f}% ({o['on_s']:.4f} s vs {o['off_s']:.4f} s)"
              for where, o in overhead.items()), flush=True)
    shutil.rmtree(root, ignore_errors=True)
    report["distributed"]["supervised"] = dict(
        runs=rec, resumed_bitwise=resumed, straggler_attempts=len(attempts),
        ring_fault=ring.get("error"), reorder=dict(permutation_s=perm_s, equal=same_perm,
                                                   wall_s=wall, wall_one_device_s=wall_one),
        checkpoint_overhead=overhead)
    return reorder


def phase_distributed(report):
    """The sharded engines (core/distributed.py) on a 1-rank NCCL group at
    n = 45,000: each run of ``_sharded_runs`` through its distributed entry
    point, held to the single-device port on the card (labels equal,
    column 0's sweeps equal, the embedding within DIST_RTOL of max|v|),
    with its wall, peak memory and the launches of every kernel; then
    run_gpic's supervisor and row reorder on the group
    (:func:`_supervised_sharded`). A run on the CPU device with an NCCL
    group must raise. Returns the launches of each kernel summed over the
    monolithic sharded runs, and the four-rank phase's yardstick: the
    single-device embeddings of the explicit and streaming runs, and the
    reordered E1 run's permutation and labels."""
    import torch.distributed as dist
    from repro_torch.core import distributed as D
    from repro_torch.data import dataset_by_name
    xg, _, kg = dataset_by_name("gaussians", N_MAIN, seed=0)
    xd, kd = _directions(N_MAIN)
    data = {"gaussians": (torch.as_tensor(xg, device="cuda"), kg),
            "directions": (torch.as_tensor(xd, device="cuda"), kd)}
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{_nccl_store()}", rank=0,
                            world_size=1)
    dist.all_reduce(torch.zeros(1, device="cuda"))     # the communicator, made once
    torch.cuda.synchronize()
    print(f"[distributed] 1-rank NCCL group up in {time.perf_counter() - t0:.3f} s",
          flush=True)
    try:
        try:
            D.distributed_gpic(xg[:64], kg, device="cpu")
            raised = None
        except ValueError as e:
            raised = str(e)
        print(f"[distributed] an NCCL group asked for the CPU raises: {raised}", flush=True)
        check(raised is not None and "nccl" in raised,
              "an NCCL group ran on CPU tensors instead of raising")
        totals, runs, yardstick, mono = {}, {}, {}, {}
        report["distributed"] = dict(runs=runs)
        for tag, entry, name, kw in _sharded_runs():
            x, k = data[name]
            one, labels_one, wall_one, _, peak_one = _counted(
                lambda: _one_device_twin(entry, x, k, kw))
            res, labels, wall, counts, peak = _counted(
                lambda: _sharded_call(entry, D.shard_points(x), k, kw))
            cols, cols_one = res.n_iter_cols.tolist(), one.n_iter_cols.tolist()
            emb, emb_one = res.embeddings, one.embeddings
            rel = float((emb - emb_one).abs().max() / emb_one.abs().max())
            bitwise = torch.equal(emb, emb_one)
            print(f"[distributed] 1 rank {tag} n={N_MAIN}: wall_s={wall:.4f} (one device "
                  f"{wall_one:.4f}) peak_mem_GB={peak / 1e9:.3f} (one device "
                  f"{peak_one / 1e9:.3f}) n_iter_cols={cols} (one device {cols_one}) "
                  f"labels equal={bool((labels == labels_one).all())} "
                  f"max|dv|/max|v|={rel:.3e} bitwise={bitwise} launches={counts}", flush=True)
            check(bool(torch.isfinite(emb).all()) and labels.shape == (N_MAIN,),
                  f"1-rank {tag}: the result has the wrong shape or is not finite")
            check(bool((labels == labels_one).all()) and cols[0] == cols_one[0]
                  and rel <= DIST_RTOL,
                  f"1-rank {tag}: labels, column 0's sweeps or the embedding differ from "
                  "the single-device run")
            check(counts["kmeans_assign"] == kw.get("kmeans_iters", 25) + 1,
                  f"1-rank {tag}: assignment launches {counts}")
            for op, c in counts.items():
                totals[op] = totals.get(op, 0) + c
            runs[tag] = dict(wall_s=wall, wall_one_device_s=wall_one, peak_mem_bytes=peak,
                             peak_one_device_bytes=peak_one, n_iter_cols=cols,
                             n_iter_cols_one_device=cols_one, max_rel_err=rel,
                             bitwise=bitwise, launches=counts)
            if tag in ("explicit", "streaming"):
                yardstick[tag] = (labels, cols, emb.cpu())
            if tag in SUPERVISED_TAGS:
                mono[tag] = res
            del res, one
            torch.cuda.empty_cache()
        report["distributed"]["launches"] = totals
        yardstick["reorder"] = _supervised_sharded(report, data, mono)
    finally:
        dist.destroy_process_group()
    missing = [op for op in SOURCES  # the LM's kernels are off the GPIC path
               if not op.startswith("flash_attention") and not totals.get(op)]
    print(f"[distributed] launches on the sharded path (all monolithic runs): {totals}",
          flush=True)
    check(not missing, f"kernels never launched on the sharded path: {missing}")
    return totals, yardstick


def phase_ring_stages(report):
    """What one card can show of the ring at P = 4: for each rank's rows of
    a 4-way partition of the main shape and each ring stage s, the stage
    kernels at (row0, col0(s) = ((rank + s) % 4) n/4) on the column block
    (#1, #5 with d=None, #6, #7 with K = KNN_K, then with kNN thresholds
    #8, #10 with d=None on the stage's plan, #11), each against its plain
    version on the same stripe; and the stage sums, in ring order, against
    the single-device kernel's output on those rows (#6, #5, #7 merged
    with row_topk_merge, #11 and #10 against #6 and #5 with the same
    thresholds). A stage's errors are measured against the whole row's
    scale (its degree, its max|U|): a stripe between distant blobs holds
    only entries near the bottom of f32, where a relative error says
    nothing. The thresholds lie halfway between each row's KNN_K-th and
    next entry (from #7 with K + 1), so the plain versions, whose rounding
    differs from the kernels' at an entry, keep the same entries. The
    twins (#6 and #1's D, #10 and #5, #11 and #6 with the thresholds) must
    be bitwise on every stripe; the count and their largest difference are
    printed."""
    from repro_torch.core.affinity import block_plan, dense_block_live
    from repro_torch.kernels import ref
    from repro_torch.kernels.affinity import affinity_and_degree
    from repro_torch.kernels.block_sparse import (block_liveness,
                                                  block_sparse_streaming_degree,
                                                  block_sparse_streaming_matmat)
    from repro_torch.kernels.row_topk import row_topk, row_topk_merge
    from repro_torch.kernels.streaming import affinity_degree_streaming, affinity_matmat
    feats, _, _ = _features(N_MAIN)
    x = feats["rbf"]
    n_loc = N_MAIN // FOUR_RANKS
    kw = dict(kind="rbf", sigma=SIGMA)
    g = torch.Generator(device="cuda").manual_seed(11)
    v = torch.rand((N_MAIN, 2), generator=g, device="cuda") / N_MAIN
    top = row_topk(x, k=KNN_K + 1, stat="similarity", **kw)
    kth, nxt = top[:, KNN_K - 1], top[:, KNN_K]
    thr = torch.where(kth > nxt, 0.5 * (kth + nxt), kth).contiguous()
    full = dict(d=affinity_degree_streaming(x, **kw), u=affinity_matmat(x, v, None, **kw),
                top=row_topk(x, k=KNN_K, stat="similarity", **kw),
                d_thr=affinity_degree_streaming(x, thr=thr, **kw),
                u_thr=affinity_matmat(x, v, None, thr=thr, **kw))
    err = dict.fromkeys(("#1 A", "#1 D", "#5", "#6", "#7", "#10", "#11"), 0.0)
    sums_err = dict.fromkeys(("#6", "#5", "#7", "#11", "#10"), 0.0)
    twins = {name: [0, 0.0] for name in ("#6 = #1's D", "#10 = #5", "#11 = #6")}
    live_frac = []

    def d_err(d, d_ref, scale):
        """The largest |D - D_ref| over the row's scale."""
        return float(((d - d_ref).abs() / scale.clamp_min(1e-30)).max())

    def u_err(u, u_ref, scale):
        """The most |U - U_ref| exceeds rtol |U_ref| + atol max|U| of the
        whole rows (<= 0 where they agree)."""
        diff = (u - u_ref).abs()
        return float((diff - U_RTOL * u_ref.abs()).max()) - U_ATOL * float(scale.abs().max())

    def twin(name, a, b, scale):
        twins[name][0] += int(torch.equal(a, b))
        twins[name][1] = max(twins[name][1], d_err(a, b, scale if a.ndim == 1
                                                    else scale[:, None]))

    for rank in range(FOUR_RANKS):
        r0, r1 = rank * n_loc, (rank + 1) * n_loc
        xr, thr_r = x[r0:r1], thr[r0:r1]
        d_row, d_row_thr = full["d"][r0:r1], full["d_thr"][r0:r1]
        u_row, u_row_thr = full["u"][r0:r1], full["u_thr"][r0:r1]
        acc = dict(d=0.0, u=0.0, top=torch.full((n_loc, KNN_K), -torch.inf, device="cuda"),
                   d_thr=0.0, u_thr=0.0)
        for s in range(FOUR_RANKS):
            c0 = ((rank + s) % FOUR_RANKS) * n_loc
            xc, vc = x[c0:c0 + n_loc], v[c0:c0 + n_loc].contiguous()
            off = dict(kw, row_offset=r0, col_offset=c0)
            a, d1 = affinity_and_degree(xr, xc, **off)
            a_ref, d_ref = ref.affinity_and_degree_ref(xr, xc, **off)
            err["#1 A"] = max(err["#1 A"], float((a - a_ref).abs().max()))
            err["#1 D"] = max(err["#1 D"], d_err(d1, d_ref, d_row))
            del a, a_ref
            d6 = affinity_degree_streaming(xr, xc, **off)
            err["#6"] = max(err["#6"], d_err(d6, d_ref, d_row))
            twin("#6 = #1's D", d6, d1, d_row)
            u5 = affinity_matmat(xr, vc, None, xc, **off)
            err["#5"] = max(err["#5"], u_err(u5, ref.affinity_matmat_ref(
                xr, vc, None, xc, **off), u_row))
            t7 = row_topk(xr, xc, k=KNN_K, stat="similarity", **off)
            err["#7"] = max(err["#7"], _topk_error(t7, ref.row_topk_ref(
                xr, xc, k=KNN_K, stat="similarity", **off)))
            live = block_liveness(xr, xc, thr=thr_r, **off)
            a_thr, _ = affinity_and_degree(xr, xc, thr=thr_r, **off)
            check(torch.equal(live, ref.block_liveness_ref(xr, xc, tm=16, tn=256, thr=thr_r,
                                                           **off))
                  and torch.equal(live.bool(), dense_block_live(a_thr, 16, 256)),
                  f"stage ({rank}, {s}): #8's map is not its plain version's and #1's")
            del a_thr
            live_frac.append(float(live.float().mean()))
            counts, col_idx, _ = block_plan(live)
            plan = dict(counts=counts, col_idx=col_idx)
            u10 = block_sparse_streaming_matmat(xr, vc, None, xc, thr=thr_r, **plan, **off)
            twin("#10 = #5", u10, affinity_matmat(xr, vc, None, xc, thr=thr_r, **off),
                 u_row_thr.abs().amax(dim=1))
            err["#10"] = max(err["#10"], u_err(u10, ref.block_sparse_streaming_matmat_ref(
                xr, vc, None, xc, tm=16, tn=256, thr=thr_r, **plan, **off), u_row_thr))
            d11 = block_sparse_streaming_degree(xr, xc, thr=thr_r, **plan, **off)
            twin("#11 = #6", d11, affinity_degree_streaming(xr, xc, thr=thr_r, **off),
                 d_row_thr)
            err["#11"] = max(err["#11"], d_err(d11, ref.block_sparse_streaming_degree_ref(
                xr, xc, tm=16, tn=256, thr=thr_r, **plan, **off), d_row_thr))
            acc["d"] = acc["d"] + d6
            acc["u"] = acc["u"] + u5
            acc["top"] = row_topk_merge(acc["top"], t7, KNN_K)
            acc["d_thr"] = acc["d_thr"] + d11
            acc["u_thr"] = acc["u_thr"] + u10
        sums_err["#6"] = max(sums_err["#6"], d_err(acc["d"], d_row, d_row))
        sums_err["#5"] = max(sums_err["#5"], u_err(acc["u"], u_row, u_row))
        sums_err["#7"] = max(sums_err["#7"], _topk_error(acc["top"], full["top"][r0:r1]))
        sums_err["#11"] = max(sums_err["#11"], d_err(acc["d_thr"], d_row_thr, d_row_thr))
        sums_err["#10"] = max(sums_err["#10"], u_err(acc["u_thr"], u_row_thr, u_row_thr))
        torch.cuda.empty_cache()
    stripes = FOUR_RANKS * FOUR_RANKS
    print(f"[ring] P={FOUR_RANKS} stages of n={N_MAIN} (n/P={n_loc}), each kernel against "
          f"its plain version (max |A - A_ref|; D's error over the row's degree; U's "
          f"excess over rtol {U_RTOL} + atol {U_ATOL} max|U| of the rows, <= 0 passes; "
          f"top-k max error): {err}; stage sums in ring order against the single-device "
          f"kernel on the rows: {sums_err}; twins bitwise on (of {stripes} stripes) and "
          f"their largest difference over the row's scale: {twins}; live fraction of the "
          f"stage plans {min(live_frac):.4f}..{max(live_frac):.4f}", flush=True)
    check(err["#1 A"] <= A_ATOL and max(err["#1 D"], err["#6"], err["#11"]) <= D_RTOL
          and max(err["#5"], err["#10"]) <= 0.0 and err["#7"] <= A_ATOL,
          f"a stage kernel disagrees with its plain version: {err}")
    check(sums_err["#7"] == 0.0 and max(sums_err["#6"], sums_err["#11"]) <= D_RTOL
          and max(sums_err["#5"], sums_err["#10"]) <= 0.0,
          f"the ring's stage sums disagree with the single-device kernels: {sums_err}")
    check(all(count == stripes for count, _ in twins.values()),
          f"a twin is not bitwise on every one of the {stripes} stripes: {twins}")
    report["ring_stages"] = dict(p=FOUR_RANKS, n_loc=n_loc, kernel_errors=err,
                                 stage_sum_errors=sums_err, twins=twins,
                                 live_fraction=[min(live_frac), max(live_frac)])


def _four_rank_worker(rank, world, store, out_path, ckpt_root):
    """One rank of the four-rank NCCL phase, on card ``rank``: the explicit
    and streaming runs of the main path on its row block, each once to warm
    up and once counted; the explicit run through run_gpic's supervisor
    (snapshots every 5 sweeps under ``ckpt_root``, shared by the ranks),
    interrupted at sweep 10 on rank 1 alone and resumed; E1 explicit on
    shuffled rows with ``row_reorder``; then the sharded LM step
    (:func:`_four_rank_lm`) and the sharded serve (:func:`_four_rank_serve`).
    Rank 0 saves what it got."""
    import torch.distributed as dist
    from repro_torch import AffinitySpec, GPICConfig, run_gpic
    from repro_torch.core import distributed as D
    from repro_torch.core.pipeline import _row_reorder_permutation
    from repro_torch.data import dataset_by_name
    from repro_torch.kernels import ops
    from repro_torch.train.fault_tolerance import FailureInjector
    import datetime
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=FOUR_RANK_S))
    x, _, k = dataset_by_name("gaussians", N_MAIN, seed=0)
    x_loc = torch.as_tensor(D.shard_points(x), device=dev)
    out, mono = {}, {}
    for tag, entry, _, kw in _sharded_runs()[:2]:
        _sharded_call(entry, x_loc, k, kw, device=dev)
        dist.barrier()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = _sharded_call(entry, x_loc, k, kw, device=dev)
        labels = res.labels.cpu()
        wall = time.perf_counter() - t0
        out[tag] = dict(labels=labels, n_iter_cols=res.n_iter_cols.tolist(),
                        embeddings=res.embeddings.cpu(), wall_s=wall,
                        peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
                        launches=ops.launch_counts())
        mono[tag] = res
    group = dist.group.WORLD
    kws = {tag: kw for tag, _, _, kw in _sharded_runs()}
    cfg = GPICConfig(mesh=group, checkpoint_every=5, ckpt_dir=ckpt_root, **kws["explicit"])
    injector = FailureInjector(fail_at_steps=(10,)).maybe_fail if rank == 1 else None
    t0 = time.perf_counter()
    res = run_gpic(x_loc, k, cfg, segment_injector=injector)
    out["resumed"] = dict(bitwise=_same_result(res, mono["explicit"]),
                          notes=res.health.notes, wall_s=time.perf_counter() - t0)
    xs = _shuffled(torch.as_tensor(x, device=dev))
    cfg = GPICConfig(mesh=group, row_reorder=True, **kws["E1 explicit"])
    _, perm = _row_reorder_permutation(D.shard_points(xs, group), cfg,
                                       AffinitySpec(**E1_SPEC))
    t0 = time.perf_counter()
    res = run_gpic(D.shard_points(xs, group), k, cfg)
    out["reorder"] = dict(perm=perm.cpu(), labels=res.labels.cpu().numpy(),
                          n_iter_cols=res.n_iter_cols.tolist(),
                          wall_s=time.perf_counter() - t0)
    del mono, res
    torch.cuda.empty_cache()
    lm = _four_rank_lm(dev)
    gathered = [None] * world if rank == 0 else None
    dist.gather_object(lm, gathered, dst=0)
    out["lm"] = gathered
    serve = _four_rank_serve(dev)
    gathered = [None] * world if rank == 0 else None
    dist.gather_object(serve, gathered, dst=0)
    out["serve"] = gathered
    if rank == 0:
        torch.save(out, out_path)
    dist.barrier()
    dist.destroy_process_group()


def _four_rank_lm(dev):
    """This rank's part of the sharded LM step on four cards: for
    stablelm-3b at full width, each of FOUR_RANK_FAMILIES at its
    published widths and FAMILY_ARCHS's depth and granite-34b at
    GRANITE_CUT (its one KV head's columns split over "model", the
    activation whole: ROADMAP 12b.4c.2a), TRAIN_STEPS steps on this card
    alone (the yardstick of the parameters), then on each of
    SHARDED_MESHES through :func:`_sharded_lm_steps` under the default
    rules for the mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.train import token_batches, train_config
    tcfg = train_config(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    meshes = {shape: init_device_mesh("cuda", shape, mesh_dim_names=("data", "model"))
              for shape in SHARDED_MESHES}
    out = {}
    for arch in (TRAIN_ARCH, *FOUR_RANK_FAMILIES, GRANITE_ARCH):
        cfg = _four_rank_cfg(arch)
        data_fn = token_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 0, dev)
        one = _one_device_lm(cfg, tcfg, data_fn, dev)
        out[arch] = dict(one_losses=one["losses"], meshes={})
        for shape, mesh in meshes.items():
            out[arch]["meshes"][f"{shape[0]}x{shape[1]}"] = _sharded_lm_steps(
                mesh, cfg, tcfg, data_fn, dev, one["params"])
        del one
    return out


def _four_rank_cfg(arch):
    """The config of ``arch`` in the four-rank LM step: stablelm-3b whole,
    granite-34b at GRANITE_CUT, a family cut by :func:`_family_cut`."""
    from repro_torch.configs import get_config
    if arch == TRAIN_ARCH:
        return get_config(arch)
    if arch == GRANITE_ARCH:
        return get_config(arch).replace(**GRANITE_CUT)
    return _family_cut(arch)


#: _four_rank_serve's families: each at FAMILY_ARCHS's depth, a sharded
#: prefill (kernel 12's launches a rank: SHARDED_FAMILY_SERVE's) and
#: SHARDED_SERVE_GEN steps
FOUR_RANK_SERVE_FAMILIES = ("zamba2-2.7b", "seamless-m4t-large-v2")


def _four_rank_serve(dev):
    """This rank's part of the sharded serve on four cards, on each of
    SHARDED_MESHES, each case against the one-device prefill and decode
    on this card (_sharded_serve): phase_sharded_serve's (a) stablelm-3b
    at full width with "cache_seq" over "model", its sharded prefill and
    4 more steps profiled; (b) granite-34b at GRANITE_CUT under its
    decode_32k rules for the mesh (its KV columns gathered whole), its
    sharded prefill and its decode, profiled;
    FOUR_RANK_SERVE_FAMILIES under their decode_32k rules for the mesh,
    a sharded prefill and its decode; and phase_moe_ffn's expert-parallel
    deepseek layer (_moe_ep_vs_local)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.models import get_api, moe
    meshes = {shape: init_device_mesh("cuda", shape, mesh_dim_names=("data", "model"))
              for shape in SHARDED_MESHES}
    out = {}
    cases = [("stablelm", SERVE_ARCH, None, {"cache_seq": ("model",)}, True),
             ("granite", GRANITE_ARCH, GRANITE_CUT, None, True)]
    cases += [(arch.split("-")[0], arch, FAMILY_ARCHS[arch], None, True)
              for arch in FOUR_RANK_SERVE_FAMILIES]
    for key, arch, cut, overrides, sharded_prefill in cases:
        cfg = get_config(arch)
        cfg = cfg.replace(**cut) if cut else cfg
        params = get_api(cfg).init_params(torch.Generator(device=dev).manual_seed(0), cfg)
        for shape, mesh in meshes.items():
            rules = _decode_rules(cfg, mesh, overrides, model_size=shape[1], data_size=shape[0])
            out[f"{key} {shape[0]}x{shape[1]}"] = dict(
                _sharded_serve(cfg, params, rules, mesh, dev, SHARDED_SERVE_BATCH,
                                SHARDED_SERVE_PROMPT, SHARDED_SERVE_GEN,
                                profile=key in ("stablelm", "granite"),
                                sharded_prefill=sharded_prefill),
                arch=arch, cut=cut, rules={k: rules[k] for k in ("batch", "cache_seq")})
        del params
        torch.cuda.empty_cache()
    cfg = get_config(MOE_ARCH)
    p = moe.init_moe_ffn(torch.Generator(device=dev).manual_seed(0), cfg)
    for shape, mesh in meshes.items():
        out[f"moe {shape[0]}x{shape[1]}"] = _moe_ep_vs_local(cfg, p, mesh, dev)
    del p
    torch.cuda.empty_cache()
    return out


def _check_four_rank_serve(serve):
    """The four ranks' records of _four_rank_serve: each serve case held
    as phase_sharded_serve's (tokens equal, logits and caches within
    SHARDED_SERVE_REL of one device's, the flash form once a cached
    attention a step where "cache_seq" is mapped, no kernel 12 in the
    decode; a sharded prefill within SHARDED_SERVE_REL, with kernel 12's
    launches one device's on every rank), the expert-parallel moe_ffn as
    phase_moe_ffn's."""
    from repro_torch.configs import get_config
    rec = {}
    for name in serve[0]:
        ranks = [r[name] for r in serve]
        if name.startswith("moe"):
            for i, r in enumerate(ranks):
                _check_moe_ep(f"{MOE_ARCH} 4 ranks, rank {i}", r)
        else:
            cfg = get_config(ranks[0]["arch"])
            cfg = cfg.replace(**ranks[0]["cut"]) if ranks[0]["cut"] else cfg
            launches = (cfg.n_layers if cfg.family == "dense" else
                        SHARDED_FAMILY_SERVE[ranks[0]["arch"]][1])
            for i, r in enumerate(ranks):
                _report_sharded_serve(f"4 ranks {name} (batch {r['rules']['batch']}, cache_seq "
                                       f"{r['rules']['cache_seq']}), rank {i}", cfg, r,
                                       expect_ep=False, rules=r["rules"],
                                       prefill_launches=launches)
        rec[name] = ranks
    return rec


def _check_four_rank_lm(lm, losses_1):
    """The sharded LM step's records of the four ranks, against the 1-rank
    runs' losses ``losses_1`` (by arch): each loss within TRAIN_LOSS_REL,
    every rank's shards within the reference's tolerance of one device's
    parameters, the replicated leaves bitwise alike on every rank, kernel
    12's launches a rank a step those of one device (stablelm-3b and
    granite-34b: 2 forwards and one backward a layer; the families:
    FAMILY_CUT_LAUNCHES)."""
    rec = {}
    for arch in lm[0]:
        if arch in (TRAIN_ARCH, GRANITE_ARCH):
            layers = _four_rank_cfg(arch).n_layers
            want = {"flash_attention": 2 * layers, **dict.fromkeys(BWD_LABELS, layers)}
        else:
            want = _family_launches(arch)
        for name in lm[0][arch]["meshes"]:
            ranks = [r[arch]["meshes"][name] for r in lm]
            losses = [st["loss"] for st in ranks[0]["steps"]]
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses, losses_1[arch]))
            worst = max(r["worst_abs"] for r in ranks)
            share = max(r["tolerance_share"] for r in ranks)
            same_replicated = len({r["replicated_digest"] for r in ranks}) == 1
            launches = [st["launches"] for r in ranks for st in r["steps"]]
            ms = [[st["ms"] for st in r["steps"]] for r in ranks]
            peaks = [r["peak_mem_bytes"] for r in ranks]
            print(f"[distributed] 4 ranks sharded LM step {arch} full width"
                  + {TRAIN_ARCH: "", GRANITE_ARCH: f" {GRANITE_CUT}"}.get(
                      arch, f" {FAMILY_ARCHS.get(arch)}")
                  + f", mesh {name} (data x model): losses {losses} (1 rank "
                  f"{losses_1[arch]}; worst rel {rel:.3e}); parameters after {TRAIN_STEPS} "
                  f"steps: worst |d|={worst:.3e} against one device, {share:.3f} of atol "
                  f"{SHARDED_ATOL} + rtol {SHARDED_RTOL} |x|; replicated leaves bitwise alike "
                  f"on every rank={same_replicated}; ms a step (rank 0) {ms[0]}; peak_mem_GB a "
                  "rank " + ", ".join(f"{p / 1e9:.3f}" for p in peaks)
                  + f"; kernel 12 launches (rank 0, step 0) {launches[0]}", flush=True)
            tag = f"4 ranks {arch} {name}"
            check(rel <= TRAIN_LOSS_REL, f"{tag}: a loss is not within {TRAIN_LOSS_REL} of the "
                  f"1-rank run's")
            check(share <= 1.0 and all(r["finite"] for r in ranks),
                  f"{tag}: the parameters are not within the tolerance of one device's")
            check(same_replicated, f"{tag}: the replicated leaves differ between ranks")
            check(all(c == want for c in launches), f"{tag}: kernel 12's launches "
                  f"{launches}, expected {want} a rank a step")
            rec[f"{arch} {name}"] = dict(losses=losses, max_loss_rel=rel, worst_abs=worst,
                                         tolerance_share=share,
                                         replicated_bitwise=same_replicated, ms=ms,
                                         peak_mem_bytes=peaks, launches=launches[0])
    return rec


def phase_four_ranks(report, yardstick, lm_losses):
    """Four ranks, one card each, over NCCL, when the machine has four
    cards: the explicit and streaming runs at n = 45,000 held to the 1-rank
    runs (labels equal, column 0's sweeps within one: the ring and the
    all-reduce sum in another order, so an eps-crossing may move; the
    embedding within DIST_RTOL of max|v| where the sweeps are equal); the
    supervised explicit run, interrupted on one rank, bitwise the 4-rank
    monolithic run with the notes retry and resumed:10; the reordered E1
    run's permutation exactly the 1-rank one (its labels against the 1-rank
    run's recorded); the sharded LM step of stablelm-3b,
    FOUR_RANK_FAMILIES and granite-34b at meshes (1, 4) and (2, 2)
    against the 1-rank runs' losses ``lm_losses``, by arch
    (:func:`_check_four_rank_lm`);
    the sharded decode and the expert-parallel moe_ffn at the same meshes
    (:func:`_check_four_rank_serve`).
    On fewer cards it says so on one line and runs nothing."""
    import tempfile
    import torch.multiprocessing as mp
    cards = torch.cuda.device_count()
    if cards < FOUR_RANKS:
        print(f"[distributed] four-rank NCCL phase not run: {cards} CUDA card(s) here, it "
              f"needs {FOUR_RANKS} (one rank a card)", flush=True)
        report["four_ranks"] = dict(run=False, cards=cards)
        return
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_4r_")
    out_path = os.path.join(tmp, "four_ranks.pt")
    # NCCL's bootstrap between the ranks over the loopback interface: the
    # machine has no network to pick another one from
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_DEBUG", "WARN")
    t0 = time.perf_counter()
    ctx = mp.start_processes(_four_rank_worker, args=(FOUR_RANKS, _nccl_store(), out_path,
                                                      os.path.join(tmp, "ckpt")),
                             nprocs=FOUR_RANKS, join=False, start_method="spawn")
    while not ctx.join(timeout=5):
        if time.perf_counter() - t0 > FOUR_RANK_S:
            for proc in ctx.processes:
                proc.kill()
            check(False, f"the four ranks did not finish in {FOUR_RANK_S} s")
    got = torch.load(out_path, weights_only=False)
    rec = {}
    perm_1, labels_reorder_1 = yardstick.pop("reorder")
    for tag, (labels_1, cols_1, emb_1) in yardstick.items():
        r = got[tag]
        cols = r["n_iter_cols"]
        rel = float((r["embeddings"] - emb_1).abs().max() / emb_1.abs().max())
        same_labels = bool((r["labels"].numpy() == labels_1).all())
        print(f"[distributed] 4 ranks {tag} n={N_MAIN}: wall_s={r['wall_s']:.4f} "
              f"peak_mem_GB(rank 0)={r['peak_mem_bytes'] / 1e9:.3f} n_iter_cols={cols} "
              f"(1 rank {cols_1}) labels equal={same_labels} max|dv|/max|v|={rel:.3e} "
              f"launches(rank 0)={r['launches']}", flush=True)
        check(same_labels and abs(cols[0] - cols_1[0]) <= 1
              and (cols[0] != cols_1[0] or rel <= DIST_RTOL),
              f"4 ranks {tag}: the result differs from the 1-rank run")
        rec[tag] = dict(wall_s=r["wall_s"], peak_mem_bytes=r["peak_mem_bytes"],
                        n_iter_cols=cols, max_rel_err=rel, launches=r["launches"])
    from repro_torch import adjusted_rand_index
    resumed, reorder = got["resumed"], got["reorder"]
    same_perm = torch.equal(reorder["perm"], perm_1)
    same_labels = bool((reorder["labels"] == labels_reorder_1).all())
    agree = adjusted_rand_index(reorder["labels"], labels_reorder_1)
    print(f"[distributed] 4 ranks explicit supervised, interrupted at sweep 10 on rank 1: "
          f"bitwise the 4-rank monolithic run={resumed['bitwise']} notes={resumed['notes']} "
          f"wall_s={resumed['wall_s']:.4f}; E1 explicit shuffled with row_reorder: the "
          f"permutation equal to the 1-rank one={same_perm}, labels equal={same_labels} "
          f"(ARI between {agree:.4f}; E1 clusters at ARI 0.0143, so k-means may part on "
          "the sum-order noise of 4 ranks, recorded) "
          f"n_iter_cols={reorder['n_iter_cols']} wall_s={reorder['wall_s']:.4f}", flush=True)
    check(resumed["bitwise"]
          and resumed["notes"] == ("retry:1:SimulatedFailure", "resumed:10"),
          "the 4-rank supervised run interrupted on one rank is not its monolithic run")
    check(same_perm, "the 4-rank row reorder's permutation is not the 1-rank one")
    rec["resumed"] = dict(bitwise=resumed["bitwise"], notes=list(resumed["notes"]),
                          wall_s=resumed["wall_s"])
    rec["reorder"] = dict(permutation_equal=same_perm, labels_equal=same_labels, ari=agree,
                          n_iter_cols=reorder["n_iter_cols"], wall_s=reorder["wall_s"])
    rec["lm"] = _check_four_rank_lm(got["lm"], lm_losses)
    rec["serve"] = _check_four_rank_serve(got["serve"])
    report["four_ranks"] = dict(run=True, cards=cards, runs=rec)


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
    # the backward replaces no Pallas kernel: the reference differentiates its
    # jnp attention (models/layers.py:207-230) with XLA
    "flash_attention_bwd_delta": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                                  "src/repro/models/layers.py:207"),
    "flash_attention_bwd_dkdv": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                                 "src/repro/models/layers.py:207"),
    "flash_attention_bwd_dq": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                               "src/repro/models/layers.py:207"),
}


def _bf16_keys(rec, launches) -> dict:
    """A kernel row's bf16 numbers (#1's dense form, #2 at r = 1, #9 at
    r = 2): time, plain time, bound and the bf16 path's launches; no one
    PyTorch call reads a bf16 A with an f32 V at f32 accumulation, so no
    library time."""
    rec = rec.get("dense", rec)
    return {"bf16_ms": rec["ms"], "bf16_plain_ms": rec["plain_ms"],
            "bf16_bound_ms": rec["bound_ms"], "bf16_bound_by": rec["bound_by"],
            "bf16_max_abs_err": rec["max_abs_err"], "bf16_launches": launches,
            "bf16_library_ms": None}


#: seconds of each phase, in the order run (a phase run again gets "#2", ...)
PHASE_S: dict[str, float] = {}


def _timed(fn):
    """``fn`` with its seconds printed on a line of their own and kept in
    PHASE_S."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            key, i = fn.__name__, 2
            while key in PHASE_S:
                key, i = f"{fn.__name__}#{i}", i + 1
            PHASE_S[key] = time.perf_counter() - t0
            print(f"[phase] {key}: {PHASE_S[key]:.1f} s", flush=True)
    return run


for _name, _fn in list(globals().items()):
    if _name.startswith("phase_") and callable(_fn):
        globals()[_name] = _timed(_fn)


def _finish(t_start, smi, report, name, line) -> int:
    """Write the report to chiprun_out/``name`` and print the closing
    lines: ``line`` (a JSON object), the card's name and power limit, and
    the result object."""
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    report["total_s"] = time.perf_counter() - t_start
    report["phase_s"] = PHASE_S
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(report, f, indent=1)
    print(f"[done] total_s={report['total_s']:.1f}")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def main_distributed(t_start, smi, report) -> int:
    """``--distributed``: the sharded phases alone: phase_train (a)'s
    one-device steps (the yardstick), the 1-rank NCCL runs of the LM step
    and of GPIC, then the four-rank phase where the machine has four
    cards. Its JSON line is the sharded paths' launches."""
    _, one_device = _train_full_width(report)
    sharded_lm, lm_losses = phase_sharded_train(report, one_device)
    del one_device
    sharded, yardstick = phase_distributed(report)
    phase_four_ranks(report, yardstick, lm_losses)
    return _finish(t_start, smi, report, "chip_smoke_distributed.json",
                   {"sharded_launches": {**sharded, **sharded_lm}})


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    t_start = time.perf_counter()
    smi = phase_device()
    report = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0)}
    report["build_s"], logs = phase_build()
    if argv == ["--distributed"]:
        return main_distributed(t_start, smi, report)
    check(not argv, f"unknown arguments {argv} (the one option is --distributed)")
    kernels = {}
    phase_affinity(kernels, logs["affinity"])
    phase_power_step(kernels)
    phase_kmeans_assign(kernels, logs["kmeans_assign"])
    phase_streaming(kernels, logs["streaming"])
    phase_gram(kernels)
    phase_row_topk(kernels)
    phase_policy(kernels)
    phase_block_sparse(kernels, logs["block_sparse"])
    phase_bf16_kernels(kernels, logs)
    phase_flash_attention(kernels, logs["flash_attention"])
    phase_flash_attention_backward(kernels, logs["flash_attention_bwd"])
    # each kernel's launches come from the run of the path that uses it
    explicit = phase_end_to_end(report)
    counts = {name: explicit[0][name] for name in
              ("affinity_and_degree", "degree_normalized_matmat", "kmeans_assign")}
    streaming = phase_streaming_e2e(report, explicit)
    counts.update({name: streaming[name] for name in ("streaming_matmat", "streaming_degree")})
    phase_pic_reference(report, explicit)
    phase_resume(report, explicit)
    del explicit
    phase_past_memory(report)
    counts["gram"] = phase_orthogonal(report)
    phase_ensemble(report)
    phase_matrix_free(report)
    phase_serial_vs_gpic(report)
    graph, dense_runs = phase_graph_e2e(report)
    counts["row_topk"] = graph["E1"][0]["launches"]["row_topk"]
    bs_runs = phase_block_sparse_e2e(report, dense_runs)
    del dense_runs
    explicit_e1, streaming_e1 = (rec["launches"] for rec in bs_runs["E1"])
    counts["block_sparse_matmat"] = explicit_e1["block_sparse_matmat"]
    counts.update({name: streaming_e1[name] for name in (
        "block_liveness", "block_sparse_streaming_matmat", "block_sparse_streaming_degree")})
    bf16_gaussians, bf16_e1 = phase_bf16_e2e(report)
    bf16_counts = {"affinity_and_degree": bf16_gaussians["affinity_and_degree"],
                   "degree_normalized_matmat": bf16_gaussians["degree_normalized_matmat"],
                   "block_sparse_matmat": bf16_e1["block_sparse_matmat"]}
    phase_reorder(report)
    phase_serve_parity(report)
    counts["flash_attention"] = phase_serve(report)["flash_attention"]
    phase_family_parity(report)
    family_launches = phase_family_serve(report)
    phase_moe_ffn(report)
    family_launches[LLAMA4_ARCH], llama4_params = phase_llama4(report)
    sharded_serve = phase_sharded_serve(report, llama4_params)
    del llama4_params
    train_launches, one_device = phase_train(report)
    counts.update({op: train_launches[op] for op in BWD_LABELS})
    sharded_lm, lm_losses = phase_sharded_train(report, one_device)
    del one_device
    family_train = phase_family_train(report)
    sharded, yardstick = phase_distributed(report)
    phase_four_ranks(report, yardstick, lm_losses)
    del yardstick
    phase_ring_stages(report)
    check(all(counts[name] > 0 for name in SOURCES), f"a kernel was never launched: {counts}")
    check(all(c > 0 for c in bf16_counts.values()),
          f"a bf16 form was never launched on its path: {bf16_counts}")
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
    phase_profile(report, out_dir, "explicit", tag="E1_bf16_block_sparse",
                  cfg=_graph_cfg(E1_SPEC, engine="explicit", embedding="orthogonal",
                                 n_vectors=2, block_sparse=True, a_dtype=torch.bfloat16))
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": counts[name],
         "max_abs_err": kernels[name]["max_abs_err"], "ms": kernels[name]["ms"],
         "plain_ms": kernels[name]["plain_ms"], "bound_ms": kernels[name]["bound_ms"],
         "bound_by": kernels[name]["bound_by"], "library_ms": kernels[name]["library_ms"],
         **({"launch_floor_ms": kernels[name]["launch_floor_ms"]}
            if "launch_floor_ms" in kernels[name] else {}),
         **(_bf16_keys(kernels[name]["bf16"], bf16_counts[name])
            if name in bf16_counts else {}),
         **({"train_launches": train_launches[name]} if name in train_launches else {}),
         **({"family_launches": family_launches,
             "sharded_prefill_launches": sharded_serve["prefill"],
             "sharded_decode_launches": sharded_serve["decode"]}
            if name == "flash_attention" else {}),
         **({"family_train_launches": {arch: c[name] for arch, c in family_train.items()}}
            if name in ("flash_attention", *BWD_LABELS) else {}),
         **({"f32_fma_bound_ms": kernels[name]["f32_fma_bound_ms"]}
            if "f32_fma_bound_ms" in kernels[name] else {}),
         "sharded_launches": sharded.get(name, 0) + sharded_lm.get(name, 0)}
        for name in SOURCES]}
    report["kernels"] = kernels
    return _finish(t_start, smi, report, "chip_smoke_report.json", line)


if __name__ == "__main__":
    sys.exit(main())
