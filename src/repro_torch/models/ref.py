"""A plain float32 forward pass of the port's `LM`, the yardstick of its
numerics.

`plain_forward` follows the architectures' equations in the plainest way:
float32 throughout (each layer's weights upcast as it is reached, so a
model in bf16 needs one layer's float32 copy at a time), a full softmax
under an explicit causal (and window) mask, no chunks and no cache, the
MoE as a loop over experts, the recurrences as step loops.  Nothing on
the serving path calls it; the tests hold it against the reference's
`forward_train`, and `chip_smoke.py` holds the served logits against it
at full width.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.xlstm import _mlstm_dims, _mlstm_step, _slstm_step


def _norm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def _act(a, act):
    return F.silu(a) if act == "silu" else F.gelu(a, approximate="tanh")


def _rope(x, pos, base):
    """x [B, S, N, D]; NeoX half rotation at positions pos [S]."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(base) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = pos.float()[:, None] * freqs                    # [S, D/2]
    c, s = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _moe(h, p, cfg):
    """Top-k routing with capacity (token order decides who is dropped)."""
    b, s, d = h.shape
    t, e, k = b * s, cfg.n_experts, cfg.top_k
    ht = h.reshape(t, d)
    probs = torch.softmax(ht @ p["moe.router"], dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = vals[:, :k], idx[:, :k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    cap = max(1, int(cfg.capacity_factor * t * k / e))
    cap = max(cap, min(t * k, 16))
    flat = top_i.reshape(-1)                               # token-major
    y = torch.zeros_like(ht)
    for ex in range(e):
        slots = torch.nonzero(flat == ex)[:, 0][:cap]      # the first cap
        tok = slots // k
        xe = ht[tok]
        out = (_act(xe @ p["moe.experts.w1"][ex], "silu")
               * (xe @ p["moe.experts.w3"][ex])) @ p["moe.experts.w2"][ex]
        y.index_add_(0, tok, out * top_p.reshape(-1)[slots][:, None])
    return y.reshape(b, s, d)


def _attn(x, p, cfg, kind, pos):
    b, s, _ = x.shape
    h_, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    hn = _norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = hn @ p["wq"], hn @ p["wk"], hn @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h_, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = _norm(q, p["q_norm"], cfg.norm_eps)
        k = _norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.use_rope:
        q, k = _rope(q, pos, cfg.rope_base), _rope(k, pos, cfg.rope_base)
    # query head h reads KV head h // (H / KV)
    k = k.repeat_interleave(h_ // kv, dim=2)
    v = v.repeat_interleave(h_ // kv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    seen = pos[None, :] <= pos[:, None]                    # [q, k]
    if kind == "swa":
        seen &= pos[None, :] > pos[:, None] - cfg.window
    scores = scores.masked_fill(~seen, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
    x = x + o.reshape(b, s, h_ * hd) @ p["wo"]
    h2 = _norm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe:
        return x + _moe(h2, p, cfg)
    return x + (_act(h2 @ p["w1"], cfg.act) * (h2 @ p["w3"])) @ p["w2"]


def _conv(u, w):
    """Depthwise causal conv, zero history: y_t = sum_j w_j u_{t-cw+1+j}."""
    cw = w.shape[0]
    up = F.pad(u, (0, 0, cw - 1, 0))
    return sum(up[:, j:j + u.shape[1]] * w[j] for j in range(cw))


def _rglru(x, p, cfg, pos):
    h = _norm(x, p["ln"], cfg.norm_eps)
    gate = F.silu(h @ p["w_gate"])
    u = _conv(h @ p["w_in"], p["conv_w"])
    r = torch.sigmoid(u @ p["w_r"] + p["b_r"])
    i = torch.sigmoid(u @ p["w_i"] + p["b_i"])
    log_a = 8.0 * r * F.logsigmoid(p["lam"])
    a = torch.exp(log_a)
    bt = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (
        i * u)
    hs, ht = [], torch.zeros_like(u[:, 0])
    for t in range(u.shape[1]):
        ht = a[:, t] * ht + bt[:, t]
        hs.append(ht)
    x = x + (gate * torch.stack(hs, dim=1)) @ p["w_out"]
    if "w1" in p:
        h2 = _norm(x, p["ln2"], cfg.norm_eps)
        x = x + (_act(h2 @ p["w1"], cfg.act) * (h2 @ p["w3"])) @ p["w2"]
    return x


def _mlstm(x, p, cfg, pos):
    b, s, _ = x.shape
    di, h, dh = _mlstm_dims(cfg)
    u, z = torch.chunk(_norm(x, p["ln"], cfg.norm_eps) @ p["w_up"], 2, dim=-1)
    uc = F.silu(_conv(u, p["conv_w"]))
    q = (uc @ p["wq"]).reshape(b, s, h, dh)
    k = (uc @ p["wk"]).reshape(b, s, h, dh) / math.sqrt(dh)
    v = (u @ p["wv"]).reshape(b, s, h, dh)
    gi, gf = uc @ p["w_i"] + p["b_i"], uc @ p["w_f"] + p["b_f"]
    state = (x.new_zeros(b, h, dh, dh), x.new_zeros(b, h, dh),
             x.new_zeros(b, h))
    hs = []
    for t in range(s):
        state, ht = _mlstm_step(state, (q[:, t], k[:, t], v[:, t], gi[:, t],
                                        gf[:, t]))
        hs.append(ht)
    return x + (torch.stack(hs, dim=1).reshape(b, s, di) * F.silu(z)) \
        @ p["w_down"]


class _P(dict):
    """Attribute access for `_slstm_step`'s recurrent matrices."""
    __getattr__ = dict.__getitem__


def _slstm(x, p, cfg, pos):
    b, s, d = x.shape
    h = cfg.n_heads
    xn = _norm(x, p["ln"], cfg.norm_eps)
    pre = [xn @ p[w] + p[bias] for w, bias in
           (("wz", "bz"), ("wi", "bi"), ("wf", "bf"), ("wo", "bo"))]
    z0 = x.new_zeros(b, h, d // h)
    state, hs = (z0, z0, z0, x.new_zeros(b, h)), []
    for t in range(s):
        state, hid = _slstm_step(state, tuple(a[:, t] for a in pre), _P(p))
        hs.append(hid)
    x = x + torch.stack(hs, dim=1).reshape(b, s, d)
    xn2 = _norm(x, p["ln2"], cfg.norm_eps)
    return x + (F.silu(xn2 @ p["w1"]) * (xn2 @ p["w3"])) @ p["w2"]


_BLOCKS = {"attn": lambda x, p, c, pos: _attn(x, p, c, "attn", pos),
           "swa": lambda x, p, c, pos: _attn(x, p, c, "swa", pos),
           "rglru": _rglru, "mlstm": _mlstm, "slstm": _slstm}


def plain_forward(model, tokens: torch.Tensor,
                  patch_embeds: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """float32 logits of `model` (a port `LM`) over tokens [B, S(, n_cb)]
    with no cache: [B, S(+patch_prefix), V] or [B, S, n_cb, V]."""
    cfg = model.cfg
    with torch.no_grad():
        if cfg.n_codebooks:
            x = sum(model.embed[c][tokens[..., c]].float()
                    for c in range(cfg.n_codebooks))
        else:
            x = model.embed[tokens].float()
        if patch_embeds is not None:
            x = torch.cat([patch_embeds.float(), x], dim=1)
        pos = torch.arange(x.shape[1], device=x.device)
        for blk in model.blocks:
            p: Dict[str, torch.Tensor] = {
                name: t.float() for name, t in blk.named_parameters()}
            x = _BLOCKS[blk.kind](x, p, cfg, pos)
            del p
        x = _norm(x, model.final_norm.float(), cfg.norm_eps)
        if cfg.n_codebooks:
            return torch.einsum("bsd,cdv->bscv", x, model.head.float())
        head = model.embed.T if cfg.tie_embeddings else model.head
        return x @ head.float()
