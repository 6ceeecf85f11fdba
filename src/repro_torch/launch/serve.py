"""Serving entry point: prefill a batch of requests, then batched greedy decode.
The port of ``repro/launch/serve.py``, on the CUDA card unless ``--device
cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b \\
        --smoke --device cpu --batch 4 --prompt-len 32 --gen 16

Every family ``get_api`` routes serves (dense, ssm, hybrid, encdec, vlm,
moe); encdec's source frames and vlm's image prefix are the stub front
ends' random embeddings, drawn with the prompts. The weights are random,
drawn from ``--seed`` at the config's published widths; the parameters and
the compute are f32, the KV caches (moe's MLA latent cache too) bf16 and
the SSM caches f32, as in the reference. Prefill and decode are timed on
the host clock around work that ends in ``torch.cuda.synchronize()`` on
the card.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import torch

from ..configs import ARCH_IDS, ModelConfig, get_config, get_smoke_config
from ..kernels import ops
from ..models import get_api, make_train_batch
from ..train.train_step import build_decode_step, build_prefill


@dataclass
class ServeResult:
    tokens: torch.Tensor            # (batch, gen) int32 generated tokens
    prefill_logits: torch.Tensor    # (batch, vocab_size) f32 at the last prompt position
    prefill_s: float
    decode_s: float                 # all gen - 1 decode steps
    prefill_launches: dict          # kernel launches per op, by phase
    decode_launches: dict


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must then exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve runs on a CUDA device and none is available; pass "
                           "device='cpu' to run the kernels' plain versions on the CPU")
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches_since(before: dict) -> dict:
    return {op: n - before[op] for op, n in ops.launch_counts().items()}


def serve(cfg: ModelConfig, *, batch: int, prompt_len: int, gen: int, seed: int = 0,
          device="cuda", params=None) -> ServeResult:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then
    decode greedily until each request has ``gen`` tokens. ``params`` are
    drawn on the device from ``seed`` unless given."""
    dev = resolve_device(device)
    api = get_api(cfg)
    if params is None:
        params = api.init_params(torch.Generator(device=dev).manual_seed(seed), cfg)
    max_len = prompt_len + gen + (cfg.n_prefix_tokens or 0)

    data = make_train_batch(cfg, batch, prompt_len, torch.Generator().manual_seed(seed))
    data = {key: x.to(dev) for key, x in data.items() if key != "labels"}
    prefill = build_prefill(cfg, max_len, compute_dtype=torch.float32)
    decode = build_decode_step(cfg, compute_dtype=torch.float32)
    # the decode's first position: past the image prefix for vlm
    pos = prompt_len + (cfg.n_prefix_tokens if cfg.family == "vlm" else 0)

    _sync(dev)
    before = ops.launch_counts()
    t0 = time.perf_counter()
    out = prefill(params, data)
    logits, cache = out[0], out[1]
    extras = {"enc_out": out[2]} if cfg.family == "encdec" else None
    del out
    last = logits[:, -1, : cfg.vocab_size]
    tok = torch.argmax(last, dim=-1)[:, None].to(torch.int32)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    prefill_launches = _launches_since(before)
    last = last.clone()
    del logits

    before = ops.launch_counts()
    generated = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        nxt, cache = decode(params, tok, cache, pos + i, extras)
        tok = nxt[:, None]
        generated.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return ServeResult(torch.cat(generated, dim=1), last, t_prefill, t_decode,
                       prefill_launches, _launches_since(before))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="stablelm-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # full-f32 projections, MLP and LM head, as the reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
                seed=args.seed, device=args.device)
    print(f"arch={cfg.arch_id} batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen}")
    print(f"prefill: {res.prefill_s*1e3:.1f} ms   "
          f"decode: {res.decode_s/max(args.gen-1,1)*1e3:.1f} ms/token")
    for i in range(min(args.batch, 2)):
        print(f"  seq{i}: {res.tokens[i].tolist()}")


if __name__ == "__main__":
    main()
