"""Serving driver: batched prefill + decode with the concurrent two-level
request scheduler (the paper's policy at the serving layer).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
      --prompt-len 2048 --steps 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-medium \\
      --smoke --device cpu --streams 4 --requests 16 --steps 8

The requests, their groups and urgencies and the prompts are the same numpy
draws as the reference driver's (`repro.launch.serve`) for a seed, so both
print the same admissions; the weights are the port's own seeded draw.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import configs
from repro_torch.kernels.common import resolve_device
from repro_torch.models import LM
from repro_torch.serve.concurrent import (ConcurrentServeScheduler, Request,
                                          RequestStream)
from repro_torch.serve.engine import ServeEngine


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="minicpm-2b", choices=configs.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--batch-budget", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs there)")
    return ap


def set_numerics() -> None:
    """What the port's tolerances assume on the card: float32 products in
    full float32 (no TF32) and bf16 products summed in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def build_engine(args: argparse.Namespace, device=None) -> ServeEngine:
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    model = LM(cfg, device=resolve_device(device), seed=args.seed)
    return ServeEngine(model, max_len=args.prompt_len + args.steps + 8)


def make_scheduler(args: argparse.Namespace,
                   rng: np.random.Generator) -> ConcurrentServeScheduler:
    sched = ConcurrentServeScheduler(args.groups, args.batch_budget,
                                     seed=args.seed)
    for sid in range(args.streams):
        stream = RequestStream(sid)
        for _ in range(args.requests // args.streams):
            stream.add(Request(sid, int(rng.integers(args.groups)),
                               urgency=float(rng.uniform(0.1, 5.0)),
                               tokens_left=args.steps))
        sched.add_stream(stream)
    return sched


def serve(engine: ServeEngine, sched: ConcurrentServeScheduler,
          rng: np.random.Generator, *, prompt_len: int, steps: int,
          observer=None) -> int:
    """Admits and serves every request; returns how many were served.
    `observer`, where given, has `start(admitted, prompts)`,
    `logits(i, logits)` (see `ServeEngine.generate`) and `end(tokens)`,
    called around each batch."""
    cfg, dev = engine.model.cfg, engine.model.device
    served = 0
    while True:
        admitted: List[Request] = sched.schedule_step()
        if not admitted:
            break
        b = len(admitted)
        shape = (b, prompt_len) + ((cfg.n_codebooks,) if cfg.n_codebooks
                                   else ())
        prompts = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, shape).astype(np.int32)).to(dev)
        patches = None
        if cfg.patch_prefix:
            # VLM stub frontend: prepend precomputed patch embeddings
            patches = torch.from_numpy(rng.standard_normal(
                (b, cfg.patch_prefix, cfg.d_model)).astype(np.float32)).to(
                    dev, torch.bfloat16)
        if observer is not None:
            observer.start(admitted, prompts)
        out = engine.generate(
            prompts, steps, patch_embeds=patches,
            on_logits=None if observer is None else observer.logits)
        if out.shape[1] != steps:
            raise RuntimeError(f"generated {out.shape[1]} steps, not {steps}")
        if observer is not None:
            observer.end(out)
        served += b
        print(f"decode batch of {b} requests "
              f"(groups {sorted(set(r.group for r in admitted))})")
    return served


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    set_numerics()
    engine = build_engine(args, args.device)
    rng = np.random.default_rng(args.seed)
    sched = make_scheduler(args, rng)
    t0 = time.perf_counter()
    served = serve(engine, sched, rng, prompt_len=args.prompt_len,
                   steps=args.steps)
    if engine.model.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"served {served} requests from {args.streams} concurrent streams "
          f"in {dt:.1f}s ({served * args.steps / dt:.1f} tok/s wall)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
