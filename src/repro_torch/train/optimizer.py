"""AdamW with global-norm clipping + LR schedules (WSD for minicpm).

The reference's optimizer (`repro.train.optimizer`), written out by hand:
moments are float32 whatever the parameter dtype, the update is computed
in float32 and cast back.  It is not `torch.optim.AdamW`, which decays
before the step and adds eps after dividing by sqrt(c2): here the decay is
inside the step and eps is added to sqrt(nu / c2), as in the reference.

Trees are the reference's (`repro_torch.tree`): a `Stacked` leaf is
updated slice by slice, and the global norm sums the leaves in JAX's
flatten order.  The update writes the parameters and moments in place;
the step count is a host int and the learning rate a float32 value.

On a world of ranks the parameters may be placed slices
(`dist.sharding`): the moments are placed as they are, the update stays
elementwise on the slices, and the global norm sums the squares of every
slice once over the ranks before its square root, so clipping is the
reference's.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import math
from typing import Callable

import torch

from repro_torch.dist import comm
from repro_torch.dist.sharding import placement_of, split_dims, with_placement
from repro_torch.tree import leaves, members, tree_map, Stacked


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: str = "cosine"      # "cosine" | "wsd" | "const"
    warmup_steps: int = 100
    total_steps: int = 10000
    stable_frac: float = 0.8      # WSD: fraction of post-warmup in stable LR


def _f32(x) -> torch.Tensor:
    """A 0-d float32 CPU tensor (a Python float rounds as JAX rounds a
    weak-typed scalar that meets a float32 value)."""
    return torch.tensor(x, dtype=torch.float32)


def wsd_schedule(cfg: AdamWConfig, step: int) -> torch.Tensor:
    """Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395), in float32."""
    warm = cfg.warmup_steps
    stable_end = warm + int((cfg.total_steps - warm) * cfg.stable_frac)
    s = _f32(step)
    warm_lr = cfg.peak_lr * s / max(warm, 1)
    decay_span = max(cfg.total_steps - stable_end, 1)
    # MiniCPM uses exponential-ish rapid decay; linear-to-10% then hold
    decay_lr = cfg.peak_lr * torch.clamp(
        1.0 - (s - stable_end) / decay_span, min=0.1)
    return torch.where(s < warm, warm_lr,
                       torch.where(s < stable_end, _f32(cfg.peak_lr),
                                   decay_lr))


@functools.lru_cache(maxsize=1)
def _libm_cosf():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    lib.cosf.restype = ctypes.c_float
    lib.cosf.argtypes = [ctypes.c_float]
    return lib.cosf


def _cos32(x: torch.Tensor) -> torch.Tensor:
    """float32 cos of a 0-d float32 tensor through the C library's cosf,
    which is what XLA's CPU backend calls (torch's own float32 cos
    differs from it in the last bit for about one input in twenty)."""
    return _f32(_libm_cosf()(float(x)))


def cosine_schedule(cfg: AdamWConfig, step: int) -> torch.Tensor:
    warm = cfg.warmup_steps
    s = _f32(step)
    warm_lr = cfg.peak_lr * s / max(warm, 1)
    t = torch.clamp((s - warm) / max(cfg.total_steps - warm, 1), 0.0, 1.0)
    cos_lr = cfg.peak_lr * 0.5 * (1.0 + _cos32(math.pi * t))
    return torch.where(s < warm, warm_lr, cos_lr)


def schedule_fn(cfg: AdamWConfig) -> Callable[[int], torch.Tensor]:
    if cfg.schedule == "wsd":
        return lambda step: wsd_schedule(cfg, step)
    if cfg.schedule == "cosine":
        return lambda step: cosine_schedule(cfg, step)
    return lambda step: _f32(cfg.peak_lr)


def adamw_init(params):
    """{"mu", "nu": float32 zeros shaped (and placed) as `params`; "step":
    0}."""
    def zeros32(p):
        if isinstance(p, Stacked):
            z = Stacked(zeros32(t) for t in p)
        else:
            z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return with_placement(z, placement_of(p))
    return {"mu": tree_map(zeros32, params), "nu": tree_map(zeros32, params),
            "step": 0}


def _sum_squares(leaf) -> torch.Tensor:
    sq = None
    for g in members(leaf):
        gf = g.float()
        part = torch.sum(gf * gf)
        sq = part if sq is None else sq + part
    return sq


def _counted_here(pl) -> bool:
    """Whether this rank's copy of a leaf placed by `pl` counts in a sum
    over the world: the rank at coordinate 0 of every axis that does not
    split it (rank 0 alone for a whole leaf)."""
    if pl is None:
        return torch.distributed.get_rank() == 0
    split = {a for _, axes in split_dims(pl) for a in axes}
    c = comm.coords(pl.mesh)
    return all(i == 0 for a, i in c.items() if a not in split)


def _global_norm(tree, params=None) -> torch.Tensor:
    """sqrt of the float32 sum of squares, leaf by leaf in the tree's
    flatten order (a Stacked leaf sums its slices in order).  Where
    `params` holds placed slices, `tree`'s leaves are the matching slices:
    every slice is counted once over the ranks (an all-reduce) before the
    square root."""
    pls = [placement_of(p) for p in leaves(params)] if params is not None \
        else []
    if not any(pl is not None for pl in pls):
        total = 0
        for leaf in leaves(tree):
            total = total + _sum_squares(leaf)
        return torch.sqrt(total)
    total = None
    for leaf, pl in zip(leaves(tree), pls):
        sq = _sum_squares(leaf)
        if not _counted_here(pl):
            sq = torch.zeros_like(sq)
        total = sq if total is None else total + sq
    return torch.sqrt(comm.all_reduce(total))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, opt_state, params):
    """Returns (params, opt_state, {"grad_norm", "lr"}); the parameters
    and moments are updated in place (and returned)."""
    step = opt_state["step"] + 1
    lr = schedule_fn(cfg)(step)

    gnorm = _global_norm(grads, params)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - b1 ** _f32(step)
    c2 = 1.0 - b2 ** _f32(step)

    def upd(p, g, mu, nu):
        g32 = g.float() * scale
        mu.mul_(b1).add_((1 - b1) * g32)
        nu.mul_(b2).add_((1 - b2) * g32 * g32)
        delta = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
        p32 = p.float()
        p.copy_(p32 - lr * (delta + cfg.weight_decay * p32))

    for lp, lg, lm, ln in zip(leaves(params), leaves(grads),
                              leaves(opt_state["mu"]),
                              leaves(opt_state["nu"])):
        for p, g, mu, nu in zip(members(lp), members(lg), members(lm),
                                members(ln)):
            upd(p, g, mu, nu)
    new_state = {"mu": opt_state["mu"], "nu": opt_state["nu"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
