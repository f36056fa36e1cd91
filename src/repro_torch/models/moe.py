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

Training under the "tp" rules (`act.seq_split`: the stream is the rank's
positions, the weights whole).  The rank gathers its rows' whole
sequence over "model", routes it, and ranks and caps every token of its
groups in the reference's (batch, position) order, so each rank
dispatches the same tokens to the same slots; the groups are
g = axis_size("fsdp"), the batch's axes alone ("data").  The rank
computes its share of the dispatch buffer as `ep_spec` marks it: its
experts where E divides "model", else its capacity rows where they
divide, else the whole buffer.  Its combine is then every token's sum of
the choices it computed, in float32, reduce-scattered onto the rank's
positions and rounded once (the one-device combine is the same float32
sum of the same rounded products); with the whole buffer it keeps its
positions of the whole combine.  The load-balance statistics count the
rank's positions and are summed over "model" (`act.psum_seq`), so every
token counts once.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist import tp
from repro_torch.dist.act import (axis_size, batch_shards, constrain,
                                  is_serve, psum_batch, psum_seq, seq_shard)
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
    e, k = cfg.n_experts, cfg.top_k
    sharded = seq_shard() is not None
    xw = tp.seq_gather(x)                  # training under "tp": every position
    b, s, d = xw.shape
    t = b * s
    xt = xw.reshape(t, d)

    logits = tp.matmul(xt.float(), p.router)                  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_k(probs, k)                             # [T, k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)            # renormalize

    # load-balance aux loss (Switch proxy): E * sum_e P_e * f, over the
    # whole batch's t_all tokens (each rank of "model" counts its positions)
    shards = batch_shards()
    t_all = t * shards
    mine_p, mine_i = probs, top_i[:, 0]
    if sharded:
        mine_p = tp.seq_take(probs.reshape(b, s, e)).reshape(-1, e)
        mine_i = tp.seq_take(mine_i.reshape(b, s)).reshape(-1)
    me = (probs.mean(dim=0) if shards == 1 and not sharded
          else psum_batch(psum_seq(mine_p.sum(dim=0))) / t_all)
    ce = torch.mean(psum_batch(psum_seq(
        F.one_hot(mine_i, e).float().sum(dim=0))) / t_all)
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
    weight = (pg * keep).to(x.dtype)
    if sharded:
        return _train_share(buf, p.experts, grp, eg, pos_c, weight, ep_spec,
                            (b, s, d), k), aux

    w = p.experts
    loc = tp.divides(cfg.d_ff)              # this rank's chunk of F
    h = silu(tp.matmul(buf, w.w1, local=loc)) * tp.matmul(buf, w.w3,
                                                          local=loc)
    h = constrain(h, *ep_spec)                                 # [G, E, C, F]
    out = constrain(tp.matmul(h, w.w2, x_local=loc), *ep_spec)  # [G,E,C,D]

    gathered = out[grp, eg, pos_c]                             # [G, Tg*k, D]
    y = (gathered * weight[..., None]).reshape(t, k, d).sum(dim=1)
    return y.reshape(b, s, d), aux


def _experts(buf, w1, w3, w2, ep_spec):
    h = silu(buf @ w1) * (buf @ w3)
    h = constrain(h, *ep_spec)                                 # [G, E, C, F]
    return constrain(h @ w2, *ep_spec)                         # [G, E, C, D]


def _train_share(buf, w, grp, eg, pos_c, weight, ep_spec, shape, k):
    """Training under "tp": the combine of this rank's share of the
    dispatch buffer `buf` [G, E, C, D] (whole on every rank), onto the
    rank's positions of the stream [B, S/n, D] (see the module's
    docstring)."""
    b, s, d = shape
    ax = tp.axis()
    e, cap = buf.shape[1], buf.shape[2]
    if ep_spec[1] == "tp" or (ep_spec[2] == "tp" and cap % ax.n == 0):
        dim = 1 if ep_spec[1] == "tp" else 2        # experts, else rows
        size = buf.shape[dim] // ax.n
        lo = ax.i * size
        ids = eg if dim == 1 else pos_c
        mine = (ids >= lo) & (ids < lo + size)
        rel = (ids - lo).clamp(0, size - 1)
        if dim == 1:
            sl = slice(lo, lo + size)
            out = _experts(buf[:, sl], w.w1[sl], w.w3[sl], w.w2[sl], ep_spec)
            got = out[grp, rel, pos_c]
        else:
            out = _experts(buf.narrow(2, lo, size), w.w1, w.w3, w.w2,
                           ep_spec)
            got = out[grp, eg, rel]
        part = (got * (weight * mine)[..., None]).float()
        part = part.reshape(b * s, k, d).sum(dim=1)
        return tp.seq_scatter32(part.reshape(b, s, d), buf.dtype)
    out = _experts(buf, w.w1, w.w3, w.w2, ep_spec)
    y = (out[grp, eg, pos_c] * weight[..., None]).reshape(b * s, k, d)
    return tp.seq_take(y.sum(dim=1).reshape(b, s, d))
