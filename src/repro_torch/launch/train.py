"""End-to-end training driver, the port of ``repro/launch/train.py``, on the
CUDA card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \\
        --smoke --device cpu --steps 200 --batch 8 --seq 128

Random weights drawn from ``--seed`` on the device, the synthetic
Zipf-Markov token stream, the full train step (microbatching, AdamW, grad
clip, z-loss, optional int8 gradient compression) and the restartable
checkpointing loop with optional failure injection. Writes the
reference's ``summary.json`` into ``--ckpt-dir``. Every family
``get_api`` routes trains (dense, ssm, hybrid, encdec, vlm, moe, whose
loss adds its router's load-balancing loss); encdec's and vlm's batches
carry the stub front ends' embeddings, drawn anew each step, as the
reference's ``launch/train.py`` draws them.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from ..configs import ARCH_IDS, TrainConfig, get_config, get_smoke_config
from ..data.tokens import SyntheticTokenStream
from ..models import get_api
from ..train import adamw_init, build_train_step
from ..train._tree import leaves
from ..train.fault_tolerance import FailureInjector, RestartableLoop
from .serve import resolve_device


def train_config(*, steps: int, batch: int, seq: int, lr: float = 3e-4, microbatch: int = 0,
                 compress_grads: bool = False, seed: int = 0, smoke: bool = False
                 ) -> TrainConfig:
    """The reference driver's TrainConfig: f32 compute, ``remat="full"``
    (none for a smoke config), warmup a tenth of the steps (at most 50)."""
    return TrainConfig(
        seq_len=seq, global_batch=batch, microbatch=microbatch,
        learning_rate=lr, warmup_steps=min(50, steps // 10 + 1),
        total_steps=steps, compute_dtype="float32",
        gradient_compression=compress_grads, seed=seed,
        remat="none" if smoke else "full")


def token_batches(cfg, batch: int, seq: int, seed: int, device):
    """data_fn(step) -> {"tokens", "labels"}: the stream's int32 batch at
    ``step``, on ``device``; for encdec also ``src_embeds`` (batch, seq,
    d_model), for vlm ``image_embeds`` (batch, n_prefix_tokens, d_model):
    normal draws times 0.02 from a generator seeded with the step."""
    stream = SyntheticTokenStream(cfg.vocab_size, seed=seed)
    stub = {"encdec": ("src_embeds", seq), "vlm": ("image_embeds", cfg.n_prefix_tokens)}

    def data_fn(step):
        out = {k: torch.from_numpy(v).to(device)
               for k, v in stream.batch_at(step, batch, seq).items()}
        if cfg.family in stub:
            name, n = stub[cfg.family]
            gen = torch.Generator(device=device).manual_seed(step)
            out[name] = torch.randn((batch, n, cfg.d_model), generator=gen,
                                    device=device) * 0.02
        return out

    return data_fn


def state_step(cfg, tcfg):
    """step_fn((params, opt_state), batch) -> ((params, opt_state), metrics)."""
    step = build_train_step(cfg, tcfg)

    def step_fn(state, batch):
        p, o = state
        p, o, m = step(p, o, batch)
        return (p, o), m

    return step_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="stablelm-3b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-failure-at", type=int, default=-1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = train_config(steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
                        microbatch=args.microbatch, compress_grads=args.compress_grads,
                        seed=args.seed, smoke=args.smoke)

    api = get_api(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = api.init_params(gen, cfg)
    opt = adamw_init(params)
    n_params = sum(x.numel() for x in leaves(params))
    print(f"arch={cfg.arch_id} params={n_params:,} batch={args.batch}x{args.seq}")

    injector = None
    if args.inject_failure_at >= 0:
        injector = FailureInjector(fail_at_steps=[args.inject_failure_at])
    loop = RestartableLoop(state_step(cfg, tcfg),
                           token_batches(cfg, args.batch, args.seq, args.seed, dev),
                           args.ckpt_dir, ckpt_every=args.ckpt_every, injector=injector)
    t0 = time.time()
    state, step, log = loop.run((params, opt), args.steps)
    wall = time.time() - t0

    for rec in log[:: max(args.log_every, 1)]:
        print(f"step {rec['step']:5d} loss {rec['loss']:.4f} "
              f"lr {rec['lr']:.2e} gnorm {rec['grad_norm']:.2f} "
              f"{rec['sec']*1e3:.0f}ms")
    first = log[0]["loss"] if log else float("nan")
    last = log[-1]["loss"] if log else float("nan")
    print(f"done: {step} steps in {wall:.1f}s; loss {first:.4f} -> {last:.4f};"
          f" restarts={loop.restarts} stragglers={len(loop.monitor.flagged)}")
    summary = {"arch": cfg.arch_id, "steps": step, "loss_first": float(first),
               "loss_last": float(last), "wall_s": wall,
               "restarts": loop.restarts}
    os.makedirs(args.ckpt_dir, exist_ok=True)
    with open(os.path.join(args.ckpt_dir, "summary.json"), "w") as f:
        json.dump(summary, f)
    return summary


if __name__ == "__main__":
    main()
