"""Capacity-based top-k MoE (GShard/MaxText-style dense dispatch).

Each expert takes at most `capacity` tokens a group, in token order; the
rest are dropped (their weight is zeroed).  Expert weights carry a leading
E axis.  Outside a sharding context there is one group (g = 1).  The
reference cuts the global batch's tokens into g = axis_size("fsdp")
groups; where the batch's rows are split over ranks (`act.batch_split`)
each rank's tokens are g / shards of those groups, and the load-balance
means run over every rank's tokens.

On ranks under the "tp" serve rules (`dist/tp.py`) the router and the
experts' products follow their weights' placements: no serve placement
of any configuration splits the expert dim E (E is smaller than D and
F), so the experts' F or D dim is split, every rank dispatches every
token, and no token crosses ranks.  The reference's `ep_spec` marks the
dispatch buffer as it does; they mark, they move nothing.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist import tp
from repro_torch.dist.act import (axis_size, batch_shards, constrain,
                                  is_serve, psum_batch)
from repro_torch.models.layers import dense_init, silu


def init_moe(gen, cfg, dtype, device) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def stack(i, o):
        return torch.stack([dense_init(gen, i, o, dtype, device)
                            for _ in range(e)])

    return {
        "router": dense_init(gen, d, e, torch.float32, device),
        "experts": {"w1": stack(d, f), "w3": stack(d, f), "w2": stack(f, d)},
    }


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis, ties broken by the lower
    index (as `jax.lax.top_k`; `torch.topk` promises no order on ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg, tokens_per_group: int) -> int:
    """Slots an expert has in a group; the floor keeps tiny (decode)
    batches dropless."""
    k, e = cfg.top_k, cfg.n_experts
    cap = max(1, int(cfg.capacity_factor * tokens_per_group * k / e))
    return max(cap, min(tokens_per_group * k, 16))


def moe_ffn(x: torch.Tensor, p, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], aux_loss scalar f32)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xt = x.reshape(t, d)

    logits = tp.matmul(xt.float(), p.router)                  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_k(probs, k)                             # [T, k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)            # renormalize

    # load-balance aux loss (Switch proxy): E * sum_e P_e * f, over the
    # whole batch's t_all tokens
    shards = batch_shards()
    t_all = t * shards
    me = (probs.mean(dim=0) if shards == 1
          else psum_batch(probs.sum(dim=0)) / t_all)
    ce = torch.mean(psum_batch(F.one_hot(top_i[:, 0], e).float().sum(dim=0))
                    / t_all)
    aux = e * me.sum() * ce

    # ranking and capacity per group of the whole batch (g = 1 outside a
    # mesh context); this rank's tokens are g / shards whole groups
    g = max(axis_size("fsdp"), 1)
    if t_all % g or (t_all // g) * k < 1:
        g = 1
    if g % shards:
        raise ValueError(f"{g} MoE groups over {t_all} tokens do not "
                         f"split into the {shards} ranks' rows")
    g //= shards
    tg = t // g
    cap = capacity(cfg, tg)

    xg = constrain(xt.reshape(g, tg, d), "fsdp", None, None)
    eg = top_i.reshape(g, tg * k)                              # expert ids
    pg = top_p.reshape(g, tg * k)

    # each (token, choice)'s rank among its expert's choices, token order
    oh = F.one_hot(eg, e)                                      # [G, Tg*k, E]
    pos = torch.gather(oh.cumsum(dim=1) - 1, 2, eg[..., None])[..., 0]
    keep = pos < cap
    pos_c = torch.clamp(pos, max=cap - 1)

    xg_rep = torch.repeat_interleave(xg, k, dim=1)             # [G, Tg*k, D]
    upd = torch.where(keep[..., None], xg_rep, 0.0).to(x.dtype)
    grp = torch.arange(g, device=x.device)[:, None].expand(g, tg * k)
    buf = torch.zeros((g, e, cap, d), dtype=x.dtype, device=x.device)
    buf.index_put_((grp, eg, pos_c), upd, accumulate=True)     # [G, E, C, D]
    # the reference's expert-parallel marks: experts over "tp" where E
    # divides it; otherwise per-group capacity, or (decode-scale serve
    # batches) the groups alone
    if e % max(axis_size("tp"), 1) == 0:
        ep_spec = ("fsdp", "tp", None, None)
    elif is_serve() and t_all <= 4096:
        ep_spec = ("fsdp", None, None, None)
    else:
        ep_spec = ("fsdp", None, "tp", None)
    buf = constrain(buf, *ep_spec)

    w = p.experts
    loc = tp.divides(cfg.d_ff)              # this rank's chunk of F
    h = silu(tp.matmul(buf, w.w1, local=loc)) * tp.matmul(buf, w.w3,
                                                          local=loc)
    h = constrain(h, *ep_spec)                                 # [G, E, C, F]
    out = constrain(tp.matmul(h, w.w2, x_local=loc), *ep_spec)  # [G,E,C,D]

    gathered = out[grp, eg, pos_c]                             # [G, Tg*k, D]
    weight = (pg * keep).to(x.dtype)
    y = (gathered * weight[..., None]).reshape(t, k, d).sum(dim=1)
    return y.reshape(b, s, d), aux
