"""End-to-end training driver (the reference's `repro.launch.train`).

Builds the mesh and the sharding rules, places the train state, and runs
the fault-tolerant training loop (async checkpoints, deterministic
resumable data) on one device:

  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \\
      --smoke --device cpu --steps 20 --batch 8 --seq-len 64

`--device` defaults to CUDA (and raises without a card).  The summary
line, the "already complete" exit on a finished checkpoint directory and
the loss-decrease assert after more than 10 steps are the reference's.
The reference also starts a `Prefetcher` that its loop never reads; this
driver starts none, since a replay after a restart asks for steps a
prefetcher has already handed out and dropped.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch import configs
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.dist.act import activation_sharding
from repro_torch.dist.fault import RestartManager
from repro_torch.dist.sharding import ShardingRules, param_shardings, reshard
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import LM
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import make_init_state, make_train_step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="xlstm-350m", choices=configs.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs there)")
    return ap


def opt_config(args: argparse.Namespace) -> AdamWConfig:
    """The reference driver's AdamW: WSD for minicpm-2b, else cosine."""
    return AdamWConfig(
        peak_lr=args.lr, total_steps=args.steps,
        warmup_steps=max(args.steps // 20, 1),
        schedule="wsd" if args.arch == "minicpm-2b" else "cosine")


def train(args: argparse.Namespace, *, cfg: Optional[ModelConfig] = None,
          failure_hook: Optional[Callable[[int], None]] = None) -> dict:
    """Run the driver's loop; returns {"cfg", "model", "state", "steps",
    "restarts", "history": [(step, loss)] in the order run (a replayed
    step appears again), "seconds"}.  `cfg` replaces the --arch config
    (a cut depth, for instance); `failure_hook(step)` runs before each
    step and may raise (injected failures)."""
    device = resolve_device(args.device)
    if cfg is None:
        cfg = (configs.get_smoke(args.arch) if args.smoke
               else configs.get(args.arch))
    model = LM(cfg, device=device, seed=args.seed)
    opt_cfg = opt_config(args)

    mesh = make_host_mesh(device=device)
    rules = ShardingRules(mesh, "dp")

    state = make_init_state(model, opt_cfg)()
    p_sh = param_shardings(rules, state["params"])
    state_sh = {"params": p_sh,
                "opt": {"mu": p_sh, "nu": p_sh, "step": rules.named((), [])}}
    state = reshard(state, state_sh)

    raw_step = make_train_step(model, opt_cfg, accum_steps=args.accum)

    def ctx_step(state, batch):
        with activation_sharding(rules):
            return raw_step(state, batch)

    data = SyntheticTokens(cfg.vocab_size, args.batch, args.seq_len,
                           n_codebooks=cfg.n_codebooks,
                           patch_prefix=cfg.patch_prefix,
                           d_model=cfg.d_model, seed=args.seed,
                           device=device)
    mgr = RestartManager(args.ckpt_dir, save_every=args.save_every)

    history: List[tuple] = []
    current = [0]

    def data_fn(step):
        current[0] = step
        return data(step)

    def step_fn(state, batch):
        state, metrics = ctx_step(state, batch)
        history.append((current[0], float(metrics["loss"])))
        return state, metrics

    t0 = time.perf_counter()
    state, steps, restarts = mgr.run(state, step_fn, data_fn, args.steps,
                                     failure_hook=failure_hook,
                                     shardings=state_sh)
    return {"cfg": cfg, "model": model, "state": state, "steps": steps,
            "restarts": restarts, "history": history,
            "seconds": time.perf_counter() - t0}


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    out = train(args)
    cfg, steps, restarts = out["cfg"], out["steps"], out["restarts"]
    losses = [loss for _, loss in out["history"]]
    if not losses:
        # resumed a checkpoint dir that already reached --steps: nothing to
        # replay (idempotent restart); report and exit clean
        print(f"arch={cfg.name} steps={steps} restarts={restarts} "
              f"(already complete in {args.ckpt_dir}; no steps run)")
        return 0
    tokens = len(losses) * args.batch * args.seq_len
    print(f"arch={cfg.name} steps={steps} restarts={restarts} "
          f"loss[0]={losses[0]:.4f} loss[-1]={losses[-1]:.4f} "
          f"({tokens / out['seconds']:.0f} tok/s wall)")
    if len(losses) > 10:
        assert np.mean(losses[-5:]) < np.mean(losses[:5]), \
            "loss did not decrease"
        print("loss decreased: OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
