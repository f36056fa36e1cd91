"""Griffin/RecurrentGemma RG-LRU recurrent block (+ causal depthwise conv).

Recurrence: h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)
with a_t = exp(c * r_t * log sigmoid(Lambda)), r/i gates linear in the branch
input.  Train/prefill runs a log-step scan over the sequence; decode is the
same scan over one step.

On ranks under the "tp" serve rules (`dist/tp.py`) the block runs over
this rank's chunk of the R channels, as the reference marks them: the
gate and input products give the rank's channels, the conv, the gates'
elementwise math and the scan are per channel, the square gate matrices
gather their input and give the rank's channels, and the output product
and the MLP follow their weights' placements.  The cache holds the
rank's channels.

Training under the "tp" rules (`dist/tp.py`, weights whole, the stream
the rank's positions): the normed stream is gathered over "model" and
the block runs over the rank's channels of the whole sequence, its
output product summed back onto the rank's positions; where the
channels do not split, the block runs whole (`tp.seq_whole`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist import tp
from repro_torch.dist.act import constrain
from repro_torch.models.layers import (dense_init, mlp, normal, residual,
                                       rmsnorm, sigmoid, silu, vector)

_C = 8.0  # Griffin's fixed exponent scale


def init_rglru(gen, cfg, dtype, device) -> dict:
    d, r = cfg.d_model, cfg.d_rnn_eff
    p = {
        "ln": vector(d, 1.0, device),
        "w_gate": dense_init(gen, d, r, dtype, device),
        "w_in": dense_init(gen, d, r, dtype, device),
        "conv_w": normal(gen, (cfg.conv_width, r),
                         1.0 / math.sqrt(cfg.conv_width), dtype, device),
        "w_r": dense_init(gen, r, r, dtype, device),
        "b_r": vector(r, 0.0, device),
        "w_i": dense_init(gen, r, r, dtype, device),
        "b_i": vector(r, 0.0, device),
        # Lambda init so sigmoid(Lambda) ~ U(0.9, 0.999) (Griffin appendix)
        "lam": _uniform(gen, (r,), 2.0, 7.0, device),
        "w_out": dense_init(gen, r, d, dtype, device),
    }
    if cfg.d_ff:
        p.update({
            "ln2": vector(d, 1.0, device),
            "w1": dense_init(gen, d, cfg.d_ff, dtype, device),
            "w3": dense_init(gen, d, cfg.d_ff, dtype, device),
            "w2": dense_init(gen, cfg.d_ff, d, dtype, device),
        })
    return p


def _uniform(gen, shape, lo: float, hi: float, device) -> torch.Tensor:
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.rand(shape, generator=gen, dtype=torch.float32,
                      device=device) * (hi - lo) + lo


def init_rglru_cache(cfg, batch: int, dtype, device) -> dict:
    r = cfg.d_rnn_eff
    if tp.divides(r):
        r //= tp.size()                     # this rank's channels
    return {
        "h": torch.zeros((batch, r), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, r), dtype=dtype,
                            device=device),
    }


def causal_conv(u: torch.Tensor, w: torch.Tensor,
                state: Optional[torch.Tensor], *, f32: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv (a cross-correlation, no flip).  u [B, S, R];
    w [cw, R]; state [B, cw-1, R] (the previous inputs, zeros when None).
    Returns (y [B, S, R], the new state: the last cw-1 rows).  y is summed
    in float32 over the taps in order and rounded to u's dtype, or left in
    float32 with `f32=True` (where the reference upcasts the conv's output
    at once, XLA drops that rounding; see `layers.residual`)."""
    cw, s = w.shape[0], u.shape[1]
    if state is None:
        state = torch.zeros((u.shape[0], cw - 1, u.shape[2]), dtype=u.dtype,
                            device=u.device)
    full = torch.cat([state.to(u.dtype), u], dim=1)            # [B, S+cw-1, R]
    fullf, wf = full.float(), w.to(u.dtype).float()
    y = fullf[:, :s] * wf[0]
    for j in range(1, cw):
        y = y + fullf[:, j:j + s] * wf[j]
    return (y if f32 else y.to(u.dtype)), full[:, -(cw - 1):, :]


def lru_scan(a: torch.Tensor, b: torch.Tensor,
             h0: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1, initial h0. a/b [B,S,R] f32,
    h0 [B,R].  A Hillis-Steele scan: ceil(log2 S) rounds, each combining
    every step with the one `off` before it, (a, b) o (a', b') = (a a',
    a b' + b) (the reference's associative_scan combines in another
    order, so the two agree to float32 rounding)."""
    s = a.shape[1]
    off = 1
    while off < s:
        a_tail, b_tail = a[:, off:], b[:, off:]
        b = torch.cat([b[:, :off], a_tail * b[:, :-off] + b_tail], dim=1)
        a = torch.cat([a[:, :off], a_tail * a[:, :-off]], dim=1)
        off *= 2
    return a * h0[:, None, :] + b


def rglru_block(x: torch.Tensor, p, cfg, cache: Optional[dict], x32=None
                ) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """x [B, S, D] -> (x + block(x), cache written in place, the output's
    unrounded float32 value); x32 as in `model.attn_block`."""
    loc = tp.divides(cfg.d_rnn_eff)         # this rank's chunk of channels
    if tp.training() and not loc:
        return tp.seq_whole(lambda xw, xw32: rglru_block(xw, p, cfg, cache,
                                                         xw32), x, x32)
    h = tp.seq_gather(rmsnorm(x, p.ln, cfg.norm_eps, x32), loc)
    gate = constrain(silu(tp.matmul(h, p.w_gate, local=loc)), "dp", None,
                     "tp")
    u = constrain(tp.matmul(h, p.w_in, local=loc), "dp", None, "tp")
    uf, conv_state = causal_conv(
        u, tp.local(p.conv_w, loc), cache["conv"] if cache is not None else None, f32=True)

    # uf @ w_r.float(): the one-device product in float32
    r = sigmoid(tp.matmul(uf, p.w_r, x_local=loc, local=loc)
                + tp.chunk(p.b_r, loc))
    i = sigmoid(tp.matmul(uf, p.w_i, x_local=loc, local=loc)
                + tp.chunk(p.b_i, loc))
    log_a = _C * r * F.logsigmoid(tp.chunk(p.lam, loc))      # [B,S,R] (<0)
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = beta * (i * uf)

    h0 = (cache["h"] if cache is not None
          else torch.zeros((x.shape[0], u.shape[-1]), dtype=torch.float32,
                           device=x.device))
    hs = lru_scan(a, b, h0)                                   # [B,S,R] f32

    x, x32 = residual(x, tp.matmul(gate * hs.to(x.dtype), p.w_out,
                                   x_local=loc))
    if "w1" in p:  # Griffin: MLP block after every temporal-mixing block
        x, x32 = residual(x, mlp(rmsnorm(x, p.ln2, cfg.norm_eps, x32), p,
                                 cfg))
    if cache is not None:
        cache["h"].copy_(hs[:, -1, :])
        cache["conv"].copy_(conv_state)
    return constrain(x, "dp", "sp", None), cache, x32
