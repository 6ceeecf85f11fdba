"""End-to-end driver: train a ~100M-parameter LM for a few hundred steps,
the port of ``examples/train_lm.py``, on the CUDA card unless ``--device
cpu`` is given.

Uses the stablelm-3b family at width 512 (10 layers, the reference
example's config), the synthetic Zipf-Markov token stream, the full train
step (AdamW, grad clip, z-loss) and the restartable checkpointing loop.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]
"""
import argparse
import os
import tempfile
import time

import torch

from ..configs import TrainConfig, get_config
from ..launch.serve import resolve_device
from ..launch.train import state_step, token_batches
from ..models import get_api
from ..train import adamw_init
from ..train._tree import leaves
from ..train.fault_tolerance import FailureInjector, RestartableLoop


def example_config():
    """The ~100M-parameter member of the stablelm family."""
    return get_config("stablelm-3b").replace(
        n_layers=10, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
        d_ff=2048, vocab_size=50304)


def train(*, steps: int, batch: int = 4, seq: int = 128, ckpt_dir: str,
          ckpt_every: int = 100, inject_failure_at: int = -1, device="cuda"):
    """Train the example's model from seed 0 for ``steps`` steps. Returns
    (state, step, metrics log, loop)."""
    dev = resolve_device(device)
    cfg = example_config()
    tcfg = TrainConfig(seq_len=seq, global_batch=batch,
                       learning_rate=1e-3, warmup_steps=30,
                       total_steps=steps, compute_dtype="float32",
                       remat="none")
    params = get_api(cfg).init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    injector = (FailureInjector(fail_at_steps=[inject_failure_at])
                if inject_failure_at >= 0 else None)
    loop = RestartableLoop(state_step(cfg, tcfg), token_batches(cfg, batch, seq, 0, dev),
                           ckpt_dir, ckpt_every=ckpt_every, injector=injector)
    state, step, log = loop.run((params, adamw_init(params)), steps)
    return state, step, log, loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--inject-failure-at", type=int, default=-1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = example_config()
    n = sum(x.numel() for x in leaves(get_api(cfg).init_params(None, cfg)))
    print(f"model: {n/1e6:.1f}M params ({cfg.n_layers}L d={cfg.d_model})")
    t0 = time.time()
    _, step, log, loop = train(steps=args.steps, batch=args.batch, seq=args.seq,
                               ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                               inject_failure_at=args.inject_failure_at, device=args.device)
    dt = time.time() - t0
    for rec in log[::25]:
        print(f"  step {rec['step']:4d}  loss {rec['loss']:.4f}  "
              f"{rec['sec']*1e3:.0f} ms/step")
    print(f"trained {step} steps in {dt:.1f}s — "
          f"loss {log[0]['loss']:.3f} -> {log[-1]['loss']:.3f}; restarts={loop.restarts}")
    assert log[-1]["loss"] < log[0]["loss"], "loss must decrease"


if __name__ == "__main__":
    main()
