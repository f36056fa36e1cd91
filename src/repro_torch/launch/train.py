"""End-to-end training driver (the reference's `repro.launch.train`).

Builds the mesh and the sharding rules, places the train state, and runs
the fault-tolerant training loop (async checkpoints, deterministic
resumable data) on one device:

  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \\
      --smoke --device cpu --steps 20 --batch 8 --seq-len 64

or on every rank of a world, FSDP-DP under the "dp" rules over a
(world, 1) mesh: each rank holds its slices of the parameters and
moments, draws the global batch and takes its rows.  `train()` runs
inside an initialized process group (`dist.world.run_world`'s ranks);
`main()` joins one from torchrun's environment:

  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch xlstm-350m --smoke --device cpu --steps 12 --lr 1e-3

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
import torch

from repro_torch import configs
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.dist.act import activation_sharding
from repro_torch.dist.fault import RestartManager
from repro_torch.dist.sharding import (ShardingRules, batch_shardings,
                                       param_shardings, reshard)
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import LM
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_step import make_train_step


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


def setup(args: argparse.Namespace, *,
          cfg: Optional[ModelConfig] = None) -> dict:
    """The set-up before the training loop: {"cfg", "model", "rules",
    "state" (placed), "shardings" (the state's), "step" (the train step
    under the rules), "data" (step -> this rank's rows of the global
    batch)}.  `cfg` replaces the --arch config (a cut depth, for
    instance).  Inside a process group every rank calls it."""
    device = resolve_device(args.device)
    if cfg is None:
        cfg = (configs.get_smoke(args.arch) if args.smoke
               else configs.get(args.arch))
    model = LM(cfg, device=device, seed=args.seed)
    opt_cfg = opt_config(args)

    mesh = make_host_mesh(device=device)
    rules = ShardingRules(mesh, "dp")

    # the moments are made on the placed parameters: whole ones would
    # hold every rank's share on each
    p_sh = param_shardings(rules, model.param_tree())
    params = reshard(model.param_tree(), p_sh)
    state = {"params": params, "opt": adamw_init(params)}
    state_sh = {"params": p_sh,
                "opt": {"mu": p_sh, "nu": p_sh, "step": rules.named((), [])}}

    raw_step = make_train_step(model, opt_cfg, accum_steps=args.accum)

    def ctx_step(state, batch):
        with activation_sharding(rules):
            return raw_step(state, batch)

    data = SyntheticTokens(cfg.vocab_size, args.batch, args.seq_len,
                           n_codebooks=cfg.n_codebooks,
                           patch_prefix=cfg.patch_prefix,
                           d_model=cfg.d_model, seed=args.seed,
                           device=device)

    def rows(step):
        # every rank draws the global batch and takes its rows
        batch = data(step)
        return reshard(batch, batch_shardings(rules, batch))
    return {"cfg": cfg, "model": model, "rules": rules, "state": state,
            "shardings": state_sh, "step": ctx_step, "data": rows}


def train(args: argparse.Namespace, *, cfg: Optional[ModelConfig] = None,
          failure_hook: Optional[Callable[[int], None]] = None) -> dict:
    """Run the training loop; returns {"cfg", "model", "state", "steps",
    "restarts", "history": [(step, loss)] in the order run (a replayed
    step appears again), "shardings" (the state's), "seconds"}.  `cfg`
    as `setup`'s; `failure_hook(step)` runs before each step and may
    raise (injected failures).  Inside a process group every rank calls
    it."""
    run = setup(args, cfg=cfg)
    cfg, model, state, state_sh = (run["cfg"], run["model"], run["state"],
                                   run["shardings"])
    ctx_step, rows = run["step"], run["data"]
    mgr = RestartManager(args.ckpt_dir, save_every=args.save_every)

    history: List[tuple] = []
    current = [0]

    def data_fn(step):
        current[0] = step
        return rows(step)

    def step_fn(state, batch):
        state, metrics = ctx_step(state, batch)
        history.append((current[0], float(metrics["loss"])))
        return state, metrics

    t0 = time.perf_counter()
    state, steps, restarts = mgr.run(state, step_fn, data_fn, args.steps,
                                     failure_hook=failure_hook,
                                     shardings=state_sh)
    return {"cfg": cfg, "model": model, "state": state, "steps": steps,
            "restarts": restarts, "history": history, "shardings": state_sh,
            "seconds": time.perf_counter() - t0}


def _join_torchrun(args) -> bool:
    """Join the process group torchrun's environment describes (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT); False outside torchrun or
    in a world of one."""
    from repro_torch.dist.world import choose_backend
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if "RANK" not in os.environ or world < 2:
        return False
    dev = torch.device("cuda" if args.device is None else args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                              % torch.cuda.device_count())
    torch.distributed.init_process_group(
        choose_backend(dev.type, world), init_method="env://")
    return True


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    joined = _join_torchrun(args)
    try:
        return _report(args, train(args))
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _report(args, out: dict) -> int:
    """The reference's summary (rank 0's, in a world) and its assert."""
    def say(line):
        if not torch.distributed.is_initialized() or \
                torch.distributed.get_rank() == 0:
            print(line)
    cfg, steps, restarts = out["cfg"], out["steps"], out["restarts"]
    losses = [loss for _, loss in out["history"]]
    if not losses:
        # resumed a checkpoint dir that already reached --steps: nothing to
        # replay (idempotent restart); report and exit clean
        say(f"arch={cfg.name} steps={steps} restarts={restarts} "
            f"(already complete in {args.ckpt_dir}; no steps run)")
        return 0
    tokens = len(losses) * args.batch * args.seq_len
    say(f"arch={cfg.name} steps={steps} restarts={restarts} "
        f"loss[0]={losses[0]:.4f} loss[-1]={losses[-1]:.4f} "
        f"({tokens / out['seconds']:.0f} tok/s wall)")
    if len(losses) > 10:
        assert np.mean(losses[-5:]) < np.mean(losses[:5]), \
            "loss did not decrease"
        say("loss decreased: OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
