"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory with
recurrent gate mixing), both with exponential gating + log-space stabilizer.

Train/prefill step the recurrence over exactly the sequence's tokens and
decode takes one step on the carried state.  The reference pads a prefill
to a multiple of its 128-step chunk and carries the state through the
padded steps too, so after a prompt of any other length its cache is not
the state after the prompt; the port's is (ROADMAP C).

On ranks under the "tp" serve rules the reference marks nothing in these
blocks, so each block gathers its split weights whole at use
(`dist.tp.gathered`, counted in `tp.GATHERED`) and every rank runs the
block whole; their caches stay whole.  In training under the "tp"
rules every rank runs each block whole on the sequence gathered over
"model" and keeps its positions (`tp.seq_whole`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist import tp
from repro_torch.models.layers import (dense_init, normal, residual,
                                       rmsnorm, sigmoid, silu, silu32,
                                       vector)
from repro_torch.models.recurrent import causal_conv


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_dims(cfg):
    di = int(cfg.proj_factor * cfg.d_model)
    h = cfg.n_heads
    return di, h, di // h


def init_mlstm(gen, cfg, dtype, device) -> dict:
    d = cfg.d_model
    di, h, _ = _mlstm_dims(cfg)
    return {
        "ln": vector(d, 1.0, device),
        "w_up": dense_init(gen, d, 2 * di, dtype, device),
        "conv_w": normal(gen, (cfg.conv_width, di),
                         1.0 / math.sqrt(cfg.conv_width), dtype, device),
        "wq": dense_init(gen, di, di, dtype, device),
        "wk": dense_init(gen, di, di, dtype, device),
        "wv": dense_init(gen, di, di, dtype, device),
        "w_i": dense_init(gen, di, h, torch.float32, device),
        "b_i": vector(h, 0.0, device),
        "w_f": dense_init(gen, di, h, torch.float32, device),
        "b_f": vector(h, 3.0, device),               # forget-bias init
        "w_down": dense_init(gen, di, d, dtype, device),
    }


def init_mlstm_cache(cfg, batch: int, dtype, device) -> dict:
    di, h, dh = _mlstm_dims(cfg)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"C": z(batch, h, dh, dh), "n": z(batch, h, dh), "m": z(batch, h),
            "conv": torch.zeros((batch, cfg.conv_width - 1, di), dtype=dtype,
                                device=device)}


def _mlstm_step(carry, inp):
    """One recurrent step.  carry: (C [B,H,dv,dk], n [B,H,dk], m [B,H])."""
    C, n, m = carry
    q, k, v, i_pre, f_pre = inp     # [B,H,dh] x3, [B,H] x2
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(logf + m - m_new)
    C = f_g[..., None, None] * C + i_g[..., None, None] * \
        (v[..., :, None] * k[..., None, :])
    n = f_g[..., None] * n + i_g[..., None] * k
    denom = torch.clamp(torch.abs((n * q).sum(dim=-1)), min=1.0)
    h_t = (C @ q[..., None])[..., 0] / denom[..., None]
    return (C, n, m_new), h_t


def _mlstm_scan(q, k, v, i_pre, f_pre, state):
    """q/k/v [B,S,H,dh] (f32), gates [B,S,H] -> (h [B,S,H,dh], the state
    after the S steps)."""
    hs = []
    for t in range(q.shape[1]):
        state, h_t = _mlstm_step(state, (q[:, t], k[:, t], v[:, t],
                                         i_pre[:, t], f_pre[:, t]))
        hs.append(h_t)
    return torch.stack(hs, dim=1), state


def mlstm_block(x: torch.Tensor, p, cfg, cache: Optional[dict], x32=None
                ) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """Returns (x + block(x), cache written in place, the output's unrounded
    float32 value); x32 as in `model.attn_block`."""
    if tp.training():
        return tp.seq_whole(lambda xw, xw32: mlstm_block(xw, p, cfg, cache,
                                                         xw32), x, x32)
    b, s, d = x.shape
    di, h, dh = _mlstm_dims(cfg)
    p = tp.gathered(p)
    xn = rmsnorm(x, p.ln, cfg.norm_eps, x32)
    u, z = torch.chunk(xn @ p.w_up, 2, dim=-1)       # [B,S,di] each
    uc, conv_state = causal_conv(u, p.conv_w,
                                 cache["conv"] if cache is not None else None)
    uc32 = silu32(uc)             # the gates read the unrounded product
    uc_act = uc32.to(uc.dtype)

    q = (uc_act @ p.wq).reshape(b, s, h, dh).float()
    k = (uc_act @ p.wk).reshape(b, s, h, dh).float() / math.sqrt(dh)
    v = (u @ p.wv).reshape(b, s, h, dh).float()
    i_pre = uc32 @ p.w_i + p.b_i                     # [B,S,H]
    f_pre = uc32 @ p.w_f + p.b_f

    if cache is not None:
        state = (cache["C"], cache["n"], cache["m"])
    else:
        state = (torch.zeros((b, h, dh, dh), dtype=torch.float32,
                             device=x.device),
                 torch.zeros((b, h, dh), dtype=torch.float32,
                             device=x.device),
                 torch.zeros((b, h), dtype=torch.float32, device=x.device))
    hs, state = _mlstm_scan(q, k, v, i_pre, f_pre, state)

    hs = hs.reshape(b, s, di).to(x.dtype)
    x, x32 = residual(x, (hs * silu(z)) @ p.w_down)
    if cache is not None:
        for name, t in zip(("C", "n", "m"), state):
            cache[name].copy_(t)
        cache["conv"].copy_(conv_state)
    return x, cache, x32


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(gen, cfg, dtype, device) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    f_up = int(4 * d / 3)

    def rec():  # block-diagonal per-head recurrent matrix [H, dh, dh]
        return normal(gen, (h, dh, dh), 1.0 / math.sqrt(dh), torch.float32,
                      device)

    return {
        "ln": vector(d, 1.0, device),
        "wz": dense_init(gen, d, d, dtype, device),
        "wi": dense_init(gen, d, d, dtype, device),
        "wf": dense_init(gen, d, d, dtype, device),
        "wo": dense_init(gen, d, d, dtype, device),
        "rz": rec(), "ri": rec(), "rf": rec(), "ro": rec(),
        "bz": vector(d, 0.0, device),
        "bi": vector(d, 0.0, device),
        "bf": vector(d, 3.0, device),
        "bo": vector(d, 0.0, device),
        "ln2": vector(d, 1.0, device),
        "w1": dense_init(gen, d, f_up, dtype, device),
        "w3": dense_init(gen, d, f_up, dtype, device),
        "w2": dense_init(gen, f_up, d, dtype, device),
    }


def init_slstm_cache(cfg, batch: int, dtype, device) -> dict:
    h = cfg.n_heads
    dh = cfg.d_model // h

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"c": z(batch, h, dh), "n": z(batch, h, dh), "h": z(batch, h, dh),
            "m": z(batch, h)}


def _slstm_step(carry, inp, p):
    c, n, hid, m = carry             # [B,H,dh] x3, [B,H]
    zx, ix, fx, ox = inp             # [B,D] pre-activations from input
    b, h, dh = c.shape

    def mix(r, x_pre):               # recurrent block-diag mix + reshape
        return x_pre.reshape(b, h, dh) + torch.einsum("bhd,hde->bhe", hid, r)

    z = torch.tanh(mix(p.rz, zx))
    i_pre = mix(p.ri, ix)
    f_pre = mix(p.rf, fx)
    o = sigmoid(mix(p.ro, ox))

    # per-head scalar stabilizer (max over the head's units)
    logf = F.logsigmoid(f_pre)
    m_cand = torch.maximum(logf.amax(dim=-1) + m, i_pre.amax(dim=-1))
    i_g = torch.exp(i_pre - m_cand[..., None])
    f_g = torch.exp(logf + (m - m_cand)[..., None])
    c = f_g * c + i_g * z
    n = f_g * n + i_g
    hid = o * (c / torch.clamp(torch.abs(n), min=1e-6))
    return (c, n, hid, m_cand), hid


def slstm_block(x: torch.Tensor, p, cfg, cache: Optional[dict], x32=None
                ) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """Returns (x + block(x), cache written in place, the output's unrounded
    float32 value); x32 as in `model.attn_block`."""
    if tp.training():
        return tp.seq_whole(lambda xw, xw32: slstm_block(xw, p, cfg, cache,
                                                         xw32), x, x32)
    b, s, d = x.shape
    h = cfg.n_heads
    dh = d // h
    p = tp.gathered(p)
    xf = rmsnorm(x, p.ln, cfg.norm_eps, x32).float()
    zx = xf @ p.wz.float() + p.bz
    ix = xf @ p.wi.float() + p.bi
    fx = xf @ p.wf.float() + p.bf
    ox = xf @ p.wo.float() + p.bo

    if cache is not None:
        state = (cache["c"], cache["n"], cache["h"], cache["m"])
    else:
        z0 = torch.zeros((b, h, dh), dtype=torch.float32, device=x.device)
        state = (z0, z0, z0, torch.zeros((b, h), dtype=torch.float32,
                                         device=x.device))
    hs = []
    for t in range(s):
        state, hid = _slstm_step(state, (zx[:, t], ix[:, t], fx[:, t],
                                         ox[:, t]), p)
        hs.append(hid)

    x, x32 = residual(x, torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype))
    # block-internal gated FFN (xLSTM sLSTM post-projection, pf = 4/3)
    xn2 = rmsnorm(x, p.ln2, cfg.norm_eps, x32)
    x, x32 = residual(x, (silu(xn2 @ p.w1) * (xn2 @ p.w3)) @ p.w2)
    if cache is not None:
        for name, t in zip(("c", "n", "h", "m"), state):
            cache[name].copy_(t)
    return x, cache, x32
