#!/usr/bin/env python3
"""Time the affinity build (#1), the k-means assignment (#3), the Gram
(#4), the row top-k (#7), the streamed degrees (#6, #11), the liveness
pass (#8), the stored block-sparse sweep (#9) and flash attention with
its backward (#12) from two checkouts on one
CUDA card, in turns, to read each kernel's before and after on the same
card.

    python3 ab_kernels.py BASE_DIR

BASE_DIR holds another checkout of this repository, for example the parent
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists. Each checkout runs in a process of its own (the two have packages of
the same name), in the order base, this checkout, this checkout, base, so
that a drift of the card between the turns shows as a difference between
the two runs of one checkout. Every turn times its own checkout's kernels
with the same code (below), at the shapes of ``chip_smoke.py``'s phase 2:
the Gram of V (45,000, 2) and of [V | U] (45,000, 4) by the device time
torch.profiler records (beside ``v.T @ v``), and by CUDA events over
back-to-back calls (the host-paced time); the k-means assignment at
n = 45,000, k = 4, dim 1, 2 and 4 by device time, with a hash of its
labels' and distances' bits, which must be the same in every turn, and
at k = 256, dim 128 (where a checkout whose kernel refuses that many
centroids records its ValueError), beside the launch floor (the device
time of fill_ on one float), and the k-means stage of three profiled
runs of explicit classic gaussians (device busy ms from the first
assignment to the last, as ``chip_smoke.py``'s profile cuts it); the
row top-k at n = 45,000,
m = 2 for each case of ``phase_row_topk``, the streamed degree (dense, and
with E1's and E2's kNN operands), the liveness pass and the block-sparse
degree on its plan (E1's and E2's), and the affinity build (dense rbf, the
main path's and E1's fused build's call; E1's and E2's thresholded
two-pass calls; E2's scales alone, its fused build's call), each 8.1 GB A
freed before the next is built, at n = 45,000, m = 2 by CUDA events; and
#6 against #1's D on the 16 stripes of a 4-way ring partition of the
main shape (how many are bitwise, and each one's D against #1's stored
entries summed in the kernels' order, the first parting rows in hex); the
stored block-sparse sweep on E1's A and plan (n = 45,000, live
fraction 0.2453) in f32 and bf16 at r = 1 and 2, on A and on a copy of it
shifted one element off 16 bytes (a checkout's plain-load template), by
CUDA events, each with a hash of U's bits, which must be the same in every
turn of both checkouts; kernel 12 (#12) at the serve shape (b h = 128,
s = 2,048, d = 80, f32 q over bf16 cache views) without and with its row
log-sum-exp L, the output's bits hashed (the same in both turns of a
checkout, and with L as without in every turn: the checkouts' forwards
may sum in other orders), and its backward at the training
shape (b h = 64, s = 1,024, d = 80, causal, f32) with a hash of dq, dk
and dv, by CUDA events: the same bits in both turns of a checkout that
has it, and between the checkouts (whose backward kernels may sum in
other orders) within ``FA_GRAD_F32_REL`` of each gradient's max (the
turns write their gradients under ``build/ab_kernels/``), and its output
and gradients against float64 where keys and values share a large mean
(recorded, not held); and a
full-width stablelm-3b training step (``chip_smoke.py``'s ``phase_train``
(a): 2 x 1,024 tokens, f32, ``remat="full"``), the mean of its steps 1
and 2 by the host clock to a synchronize.
Correctness is ``chip_smoke.py``'s to check, apart from the bits hashes
and the backward's agreement across checkouts.
Prints one line per turn and writes all of them to
``chiprun_out/ab_kernels.json``; exits non-zero if a turn fails, a hash
differs between turns where it must not, or the backward's gradients part
between the checkouts.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

_TURN = r'''
import hashlib, json, os, sys, time
import numpy as np
root, grads_path = sys.argv[1], sys.argv[2]
os.chdir(root)
sys.path.insert(0, root)
import chip_smoke as cs
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
cs.phase_device()
cs.phase_build()
from repro_torch.core.affinity import AffinitySpec, block_plan
from repro_torch.core.graph import affinity_stats, scales_from_topk
from repro_torch.kernels.affinity import affinity_and_degree
from repro_torch.kernels.block_sparse import block_liveness, block_sparse_streaming_degree
from repro_torch.kernels.gram import gram
from repro_torch.kernels.kmeans_assign import kmeans_assign
from repro_torch.kernels.row_topk import row_topk
from repro_torch.kernels.streaming import affinity_degree_streaming


def device_ms(fn, reps):
    """Device ms a call: the profiler's device events over reps calls, the
    trace opened by a marker kernel (the profiler can miss a trace's first
    kernel), which is left out."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == DeviceType.CUDA and "spin_kernel" not in ev.name]
    return sum(spans) / 1e3 / reps, len(spans)


report = {}
g = torch.Generator(device="cuda").manual_seed(5)
n = cs.N_MAIN
v = torch.rand((n, 2), generator=g, device="cuda")
v = v / v.sum(dim=0, keepdim=True)
vu = torch.cat([v, v * (1.0 + 0.01 * torch.rand((n, 2), generator=g, device="cuda"))], dim=1)
for vv in (v, vu):
    ms, events = device_ms(lambda: gram(vv), 50)
    report[f"gram c={vv.shape[1]}"] = dict(
        ms=ms, device_events_per_call=events / 50,
        library_ms=device_ms(lambda: vv.T @ vv, 50)[0],
        host_paced_ms=cs.cuda_ms(lambda: gram(vv), 50))
one = torch.zeros((1,), device="cuda")
report["launch floor"] = dict(ms=device_ms(lambda: one.fill_(0), 200)[0])
gk = torch.Generator(device="cuda").manual_seed(3)
for dim in (1, 2, 4):
    xd = torch.randn((n, dim), generator=gk, device="cuda")
    cd = xd[torch.randperm(n, generator=gk, device="cuda")[:4]].contiguous()
    lab, dist = kmeans_assign(xd, cd)
    bits = hashlib.sha256(lab.cpu().numpy().tobytes() + dist.cpu().numpy().tobytes())
    ms, events = device_ms(lambda: kmeans_assign(xd, cd), 200)
    report[f"kmeans_assign dim={dim}"] = dict(ms=ms, device_events_per_call=events / 200,
                                              bits=bits.hexdigest()[:16])
cg = torch.randn((256, 128), generator=gk, device="cuda")
xg = cg[torch.randint(0, 256, (n,), generator=gk, device="cuda")]
xg = xg + 0.7 * torch.randn((n, 128), generator=gk, device="cuda")
try:
    ms, events = device_ms(lambda: kmeans_assign(xg, cg), 50)
    report["kmeans_assign k=256 dim=128"] = dict(ms=ms, device_events_per_call=events / 50)
except ValueError as e:          # a kernel with a centroid budget refuses k = 256
    report["kmeans_assign k=256 dim=128"] = dict(ms=None, raises=str(e))
# the k-means stage of explicit classic gaussians, as chip_smoke.py's
# profile cuts it: device busy ms from the first assignment to the last
from repro_torch import GPICConfig, dataset_by_name, run_gpic
xk, _, kk = dataset_by_name("gaussians", n, seed=0)
cfg = GPICConfig(engine="explicit", affinity_kind="rbf", sigma=cs.SIGMA, max_iter=400)
run_gpic(xk, kk, cfg).labels.cpu()
stage = []
for _ in range(3):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_gpic(xk, kk, cfg).labels.cpu()
    spans = cs._device_spans(prof)
    km = [(st, e) for st, e, lab in spans if lab.startswith("kmeans_assign_")]
    stage.append(cs._busy_us(spans, min(st for st, _ in km), max(e for _, e in km)) / 1e3)
report["kmeans stage, explicit gaussians"] = dict(ms=sum(stage) / len(stage), runs=stage)
torch.cuda.empty_cache()
feats, _, _ = cs._features(n)
x = feats["rbf"]
scale = scales_from_topk(row_topk(x, k=cs.SCALE_K, stat="neg_sqdist", kind="rbf",
                                  sigma=cs.SIGMA)).contiguous()
cases = [("neg_sqdist", k, None) for k in (1, 7, 64)]
cases += [("similarity", k, sc) for k in (10, 30, 64) for sc in (None, scale)]
for stat, k, sc in cases:
    tag = f"row_topk {stat} K={k}{' adaptive' if sc is not None else ''}"
    report[tag] = dict(ms=cs.cuda_ms(lambda: row_topk(x, k=k, stat=stat, kind="rbf",
                                                      sigma=cs.SIGMA, scale_r=sc,
                                                      scale_c=sc), 5))
# #6 against #1's D on the P = 4 ring stripes of the main shape (rows
# rank n/4, columns ((rank + s) % 4) n/4, chip_smoke.py's phase_ring_stages):
# the stripes where the two are bitwise, and #1's stored entries summed in
# the kernels' order with one rounding an add (thread t adds columns t,
# t + 256, ... in order, then the warp tree, then the 8 warps in order),
# which D must equal; for the first rows where #6 or #1 part from that sum,
# the values in hex and the row's nonzero and subnormal entries
def kernel_order_sums(a):
    rows, cols = a.shape
    tiles = -(-cols // 256)
    padded = torch.zeros((rows, tiles * 256), device=a.device)
    padded[:, :cols] = a
    part = torch.zeros((rows, 256), device=a.device)
    for j in range(tiles):
        part = part + padded[:, j * 256:(j + 1) * 256]
    warp = part.view(rows, 8, 32)
    for off in (16, 8, 4, 2, 1):
        warp = warp + torch.cat([warp[:, :, off:], warp[:, :, 32 - off:]], dim=2)
    total = torch.zeros((rows,), device=a.device)
    for w in range(8):
        total = total + warp[:, w, 0]
    return total


n_loc = n // 4
ring = dict(stripes=16, bitwise=0, d1_is_the_sum=0, d6_is_the_sum=0, parting_rows=0,
            rows=[])
for rank in range(4):
    xr = x[rank * n_loc:(rank + 1) * n_loc]
    for s in range(4):
        c0 = ((rank + s) % 4) * n_loc
        xc = x[c0:c0 + n_loc]
        off = dict(kind="rbf", sigma=cs.SIGMA, row_offset=rank * n_loc, col_offset=c0)
        a, d1 = affinity_and_degree(xr, xc, **off)
        d6 = affinity_degree_streaming(xr, xc, **off)
        want = kernel_order_sums(a)
        ring["bitwise"] += int(torch.equal(d1, d6))
        ring["d1_is_the_sum"] += int(torch.equal(d1, want))
        ring["d6_is_the_sum"] += int(torch.equal(d6, want))
        parted = ((d1 != want) | (d6 != want)).nonzero().flatten()
        ring["parting_rows"] += parted.numel()
        for i in parted[:3].tolist():
            row = a[i]
            ring["rows"].append(dict(
                stripe=[rank, s], row=rank * n_loc + i, d1=float(d1[i]).hex(),
                d6=float(d6[i]).hex(), sum=float(want[i]).hex(),
                nonzero=int((row != 0).sum()),
                subnormal=int(((row != 0) & (row.abs() < 2.0 ** -126)).sum()),
                largest=float(row.max()).hex()))
        del a
torch.cuda.empty_cache()
report["ring #6 = #1's D"] = dict(ms=None, **ring)
report["degree dense"] = dict(ms=cs.cuda_ms(
    lambda: affinity_degree_streaming(x, kind="rbf", sigma=cs.SIGMA), 10))
# each call's A (8.1 GB) is dropped as it returns, before the next call
report["affinity dense"] = dict(ms=cs.cuda_ms(
    lambda: affinity_and_degree(x, kind="rbf", sigma=cs.SIGMA), 5))
for tag, spec in (("E1", AffinitySpec(kind="rbf", sigma=cs.SIGMA, knn_k=cs.KNN_K)),
                  ("E2", AffinitySpec(kind="rbf", bandwidth="adaptive", scale_k=cs.SCALE_K,
                                      knn_k=cs.KNN_K))):
    sc, thr = affinity_stats(x, spec)
    pol = dict(kind="rbf", sigma=cs.SIGMA, scale_r=sc, scale_c=sc, thr=thr)
    report[f"degree {tag}"] = dict(ms=cs.cuda_ms(lambda: affinity_degree_streaming(x, **pol), 10))
    report[f"liveness {tag}"] = dict(ms=cs.cuda_ms(lambda: block_liveness(x, **pol), 10))
    counts, col_idx, _ = block_plan(block_liveness(x, **pol))
    report[f"bs degree {tag}"] = dict(ms=cs.cuda_ms(lambda: block_sparse_streaming_degree(
        x, counts=counts, col_idx=col_idx, **pol), 20))
    report[f"affinity {tag} thr"] = dict(ms=cs.cuda_ms(lambda: affinity_and_degree(x, **pol), 5))
    if sc is not None:
        report[f"affinity {tag} fused form"] = dict(ms=cs.cuda_ms(
            lambda: affinity_and_degree(x, **dict(pol, thr=None)), 5))
    torch.cuda.empty_cache()
# the stored block-sparse sweep (#9) on E1's plan: f32 and bf16 A, r = 1
# and 2, on A itself and on a copy shifted one element off 16 bytes (the
# plain-load template where a checkout has one), with a hash of U's bits
from repro_torch.core.affinity import dense_block_live
from repro_torch.kernels.block_sparse import block_sparse_matmat
_, thr = affinity_stats(x, AffinitySpec(kind="rbf", sigma=cs.SIGMA, knn_k=cs.KNN_K))
a, d = affinity_and_degree(x, kind="rbf", sigma=cs.SIGMA, thr=thr)
counts, col_idx, _ = block_plan(dense_block_live(a, 16, 256))
gv = torch.Generator(device="cuda").manual_seed(9)
v1 = (d / d.sum())[:, None].contiguous()
v2 = torch.cat([v1, torch.rand((n, 1), generator=gv, device="cuda") / n], dim=1)
for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
    aa = a.to(dtype)
    shifted = torch.empty(n * n + 1, dtype=dtype, device="cuda")[1:].view(n, n)
    shifted.copy_(aa)
    for form, am in (("", aa), (" unaligned", shifted)):
        for vv in (v1, v2):
            u = block_sparse_matmat(am, vv, d, counts, col_idx)
            report[f"bs_matmat E1 {tag} r={vv.shape[1]}{form}"] = dict(
                ms=cs.cuda_ms(lambda: block_sparse_matmat(am, vv, d, counts, col_idx), 20),
                bits=hashlib.sha256(u.cpu().numpy().tobytes()).hexdigest()[:16])
    del aa, shifted
    torch.cuda.empty_cache()
del a
torch.cuda.empty_cache()
# kernel 12 at the serve shape (f32 q over bf16 cache views) with and
# without the row log-sum-exp L, each with a hash of the output's bits
# (equal in each checkout's turns, and with and without L in every turn:
# writing L moves no bit), and its backward at the
# training shape (f32, causal), with a hash of dq, dk, dv; a checkout whose
# kernel writes no L or has no backward records that
from repro_torch.kernels import flash_attention as fa


def bits(*ts):
    return hashlib.sha256(b"".join(t.float().cpu().numpy().tobytes() for t in ts)).hexdigest()[:16]


f32, bf16 = torch.float32, torch.bfloat16
qf, kf, vf = cs._fa_case(4, 32, 32, 2048, 80, f32, bf16, seed=40, strided=True)
report["flash serve"] = dict(ms=cs.cuda_ms(lambda: fa.flash_attention(qf, kf, vf), 10),
                             bits=bits(fa.flash_attention(qf, kf, vf)), bits_within="checkout")
if hasattr(fa, "flash_attention_bwd"):
    out, lse = fa._forward(qf, kf, vf, True, with_lse=True)
    report["flash serve with L"] = dict(
        ms=cs.cuda_ms(lambda: fa._forward(qf, kf, vf, True, with_lse=True), 10),
        bits=bits(out), same_as="flash serve")
    q, k, v = cs._fa_case(2, 32, 32, 1024, 80, f32, f32, seed=70, strided=True)
    dout = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(90),
                       device="cuda") * 0.5
    out, lse = fa._forward(q, k, v, True, with_lse=True)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, dout)
    np.savez(grads_path, **{n: t.float().cpu().numpy() for n, t in zip(("dq", "dk", "dv"), grads)})
    report["flash backward train"] = dict(
        ms=cs.cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout), 10),
        bits=bits(*grads), bits_within="checkout", grads=grads_path)
    del q, k, v, dout, out, lse, grads
    # keys and values that share a large mean (seamless's cross-attention
    # at initialization), d = 64, full: the output and the gradients
    # through the autograd Function against float64
    g = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn((2, 16, 1024, 64), generator=g, device="cuda")
    mk, mv = (torch.randn((1, 1, 1, 64), generator=g, device="cuda") * 1.5 for _ in range(2))
    k = torch.randn(q.shape, generator=g, device="cuda") + mk
    v = torch.randn(q.shape, generator=g, device="cuda") + mv
    dout = torch.randn(q.shape, generator=g, device="cuda") * 0.5
    exact = [t.double().requires_grad_() for t in (q, k, v)]
    out64 = torch.softmax(exact[0] @ exact[1].transpose(-1, -2) / 8.0, dim=-1) @ exact[2]
    out64.backward(dout.double())
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=False)
    out.backward(dout)
    report["flash shared mean"] = dict(ms=None, rel_to_f64={
        name: float((a.detach().double() - w.detach()).abs().max() / w.detach().abs().max())
        for name, a, w in zip(("out", "dq", "dk", "dv"), [out] + [t.grad for t in leaves],
                              [out64] + [t.grad for t in exact])})
    del q, k, v, dout, exact, out64, leaves, out
else:
    for name in ("flash serve with L", "flash backward train"):
        report[name] = dict(ms=None, raises="this checkout's kernel 12 writes no L and has no "
                                            "backward")
del qf, kf, vf
torch.cuda.empty_cache()
# a full-width stablelm-3b training step, chip_smoke.py's phase_train (a)
from repro_torch.configs import get_config
from repro_torch.launch.train import token_batches, train_config
from repro_torch.models import get_api
from repro_torch.train import adamw_init, build_train_step
cfg = get_config(cs.TRAIN_ARCH)
params = get_api(cfg).init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
opt = adamw_init(params)
data_fn = token_batches(cfg, cs.TRAIN_BATCH, cs.TRAIN_SEQ, 0, "cuda")
step = build_train_step(cfg, train_config(steps=cs.TRAIN_STEPS, batch=cs.TRAIN_BATCH,
                                          seq=cs.TRAIN_SEQ))
steps_ms, losses = [], []
for i in range(cs.TRAIN_STEPS):
    batch = data_fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, m = step(params, opt, batch)
    losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    steps_ms.append((time.perf_counter() - t0) * 1e3)
report["train step"] = dict(ms=sum(steps_ms[1:]) / len(steps_ms[1:]), steps_ms=steps_ms,
                            losses=losses)
del params, opt, step
print("AB_REPORT " + json.dumps(report))
'''


def run_turn(tag: str, root: str) -> dict:
    grads_dir = os.path.join(ROOT, "build", "ab_kernels")
    os.makedirs(grads_dir, exist_ok=True)
    proc = subprocess.run([sys.executable, "-c", _TURN, root,
                           os.path.join(grads_dir, f"{tag}_flash_bwd.npz")],
                          capture_output=True, text=True)
    lines = proc.stdout.splitlines()
    reports = [json.loads(line[len("AB_REPORT "):]) for line in lines
               if line.startswith("AB_REPORT ")]
    device = next((line for line in lines if line.startswith("[device]")), "[device] ?")
    if proc.returncode != 0 or not reports:
        raise SystemExit(f"ab_kernels: turn {tag} ({root}) failed with exit "
                         f"{proc.returncode}:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    print(f"[{tag}] {device}", flush=True)
    times = " ".join(f"{name}: {rec['ms']:.6f} ms;" if rec["ms"] is not None
                     else f"{name}: {rec.get('raises', rec)};"
                     for name, rec in reports[0].items())
    print(f"[{tag}] {times}", flush=True)
    return dict(reports[0], device=device)


def grads_apart(base: dict, this: dict) -> dict:
    """max|this - base| / max|base| of each gradient the two turns saved;
    raises where one parts by more than ``FA_GRAD_F32_REL`` (an f32
    gradient's tolerance in ``chip_smoke.py``). A base turn that has no
    backward gives ``{}``."""
    import numpy as np

    from chip_smoke import FA_GRAD_F32_REL
    if "grads" not in base:
        return {}
    with np.load(base["grads"]) as b, np.load(this["grads"]) as t:
        apart = {n: float(np.abs(t[n] - b[n]).max() / max(float(np.abs(b[n]).max()), 1e-30))
                 for n in ("dq", "dk", "dv")}
    if max(apart.values()) > FA_GRAD_F32_REL:
        raise SystemExit(f"ab_kernels: the backward's gradients part between the checkouts by "
                         f"more than {FA_GRAD_F32_REL} of their max: {apart}")
    return apart


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", help="another checkout of this repository")
    base = os.path.abspath(ap.parse_args().base)
    turns = [("base-1", base), ("this-1", ROOT), ("this-2", ROOT), ("base-2", base)]
    out = {tag: run_turn(tag, root) for tag, root in turns}
    # a redesign keeps its bits: an entry that hashes them must agree in every
    # turn, and #9's on A and on its shifted copy alike; an entry whose
    # arithmetic may change between the checkouts only within each checkout
    across = {}
    for name, rec in out["this-1"].items():
        if isinstance(rec, dict) and rec.get("bits_within") == "checkout":
            for side in ("base", "this"):
                got = {tag: out[tag][name].get("bits") for tag in (f"{side}-1", f"{side}-2")}
                print(f"ab_kernels: {name} bits {got}", flush=True)
                if len(set(got.values())) != 1:
                    raise SystemExit(f"ab_kernels: {name} gives other bits in another turn "
                                     f"of one checkout: {got}")
            across[name] = grads_apart(out["base-1"][name], out["this-1"][name])
            print(f"ab_kernels: {name} max|this - base| / max|base|: {across[name]}",
                  flush=True)
        elif isinstance(rec, dict) and "same_as" in rec:
            # the bits of another entry of the same turn
            for tag in out:
                if "bits" not in out[tag][name]:
                    continue
                got = {name: out[tag][name]["bits"],
                       rec["same_as"]: out[tag][rec["same_as"]]["bits"]}
                print(f"ab_kernels: {tag} bits {got}", flush=True)
                if len(set(got.values())) != 1:
                    raise SystemExit(f"ab_kernels: {name} gives other bits than "
                                     f"{rec['same_as']} in turn {tag}: {got}")
        elif isinstance(rec, dict) and "bits" in rec:
            got = {tag: out[tag][name]["bits"] for tag in out if "bits" in out[tag][name]}
            if name.startswith("bs_matmat") and name.endswith(" unaligned"):
                got.update({f"{tag} aligned": out[tag][name[:-len(" unaligned")]]["bits"]
                            for tag in out})
            print(f"ab_kernels: {name} bits {got}", flush=True)
            if len(set(got.values())) != 1:
                raise SystemExit(f"ab_kernels: {name} gives other bits in another turn: {got}")
    out["across checkouts"] = across
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ab_kernels.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(f"ab_kernels: {len(turns)} turns written to {out_dir}/ab_kernels.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
