"""Core layers: RMSNorm, RoPE, chunked online-softmax attention, SwiGLU MLP.

Activations stay in the parameter dtype (bf16 in the configs); norms, the
rotation and the softmax run in float32.  Where the reference multiplies
bf16 operands with `preferred_element_type=float32` (the attention's scores
and its `p @ v`), both operands are upcast and multiplied in float32: a bf16
`torch.matmul` would round its output to bf16.  The products of two bf16
values are exact in float32, so only the summation order differs.  The
card must run these products with TF32 off.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist import tp
from repro_torch.dist.act import constrain


def _rms(xf: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return xf * torch.rsqrt(var + eps) * w.float()


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            x32: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RMSNorm in float32, rounded to x's dtype.  `x32`, where given, is
    x's float32 value before it was rounded (see `residual`) and is what
    the norm reads."""
    xf = x.float() if x32 is None else x32
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def residual(x: torch.Tensor, y: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x + y, and the float32 sum before it is rounded to x's dtype.

    XLA drops the rounding of a bf16 op whose result goes straight into an
    explicit upcast to float32, so where the reference's residual sum
    feeds a norm in the same compiled region (the second norm of a block,
    the first norm of the next block of a scanned cycle or of the
    remainder, the final norm after a remainder block) the norm reads the
    unrounded sum; the stream itself stays rounded."""
    s = x.float() + y.float()
    return s.to(x.dtype), s


def rope_tables(positions: torch.Tensor, head_dim: int,
                base: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [..., S] -> (cos, sin) [..., S, head_dim/2] (f32)."""
    half = head_dim // 2
    freqs = torch.exp(-math.log(base) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, N, D]; cos/sin [B, S, D/2] (NeoX half-rotation layout)."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# chunked online-softmax attention
# ---------------------------------------------------------------------------

_NEG = -1e30


def _mask(kv_pos, q_pos, window):
    """[B, 1, 1, Sq, Skv]: a slot is seen when it is valid (pos >= 0), not
    after the query and, under a window, within it."""
    kp = kv_pos[:, None, None, None, :]
    qp = q_pos[:, None, None, :, None]
    mask = (kp >= 0) & (kp <= qp)
    if window is not None:
        mask &= kp > (qp - window)
    return mask


def _scores(q, k, scale):
    """q [B, Sq, KV, G, D], k [B, Skv, KV, D] -> [B, KV, G, Sq, Skv] f32."""
    return torch.einsum("bqkgd,bckd->bkgqc", q.float(), k.float()) * scale


def _pv(p, v):
    """p [B, KV, G, Sq, Skv] f32 rounded to v's dtype first (as the
    reference's `p.astype(v.dtype)`), v [B, Skv, KV, D] -> f32."""
    return torch.einsum("bkgqc,bckd->bkgqd", p.to(v.dtype).float(), v.float())


def _attn_chunk_scan(q_c, q_pos_c, k, v, kv_pos, kv_chunk, window, scale):
    """One q chunk against kv chunks [0, n_kv).  Shapes:
    q_c [B, qc, KV, G, D]; q_pos_c [B, qc]; k/v [B, Skv, KV, D];
    kv_pos [B, Skv].  Returns [B, qc, KV, G, D] f32."""
    b, qc, kv_h, g, d = q_c.shape
    n_kv = k.shape[1] // kv_chunk
    dev = q_c.device
    m = torch.full((b, kv_h, g, qc), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kv_h, g, qc), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kv_h, g, qc, d), dtype=torch.float32, device=dev)
    for idx in range(n_kv):
        sl = slice(idx * kv_chunk, (idx + 1) * kv_chunk)
        k_c, v_c, kp = k[:, sl], v[:, sl], kv_pos[:, sl]
        mask = _mask(kp, q_pos_c, window)
        s = torch.where(mask, _scores(q_c, k_c, scale), _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]) * mask
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + _pv(p, v_c)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4)          # [B, qc, KV, G, D]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                    window: Optional[int] = None,
                    q_chunk: int = 512, kv_chunk: int = 1024,
                    triangular: bool = False) -> torch.Tensor:
    """Online-softmax attention with positional masking.

    q [B, Sq, H, D]; k/v [B, Skv, KV, D]; q_pos [B, Sq]; kv_pos [B, Skv]
    (kv_pos < 0 marks invalid cache slots).  Query head h reads KV head
    h // (H / KV).  `triangular=True` (self-attention where q_pos ==
    kv_pos) skips kv chunks above the causal diagonal.
    """
    b, sq, h, d = q.shape
    skv, kv_h = k.shape[1], k.shape[2]
    g = h // kv_h
    scale = 1.0 / math.sqrt(d)

    if sq == 1:
        # decode: one softmax over the whole cache, no chunk loop
        mask = _mask(kv_pos, q_pos, window)
        s = torch.where(mask, _scores(q.reshape(b, 1, kv_h, g, d), k, scale),
                        _NEG)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
        o = _pv(p, v) / torch.clamp(p.sum(dim=-1), min=1e-30)[..., None]
        return o.permute(0, 3, 1, 2, 4).reshape(b, 1, h, d).to(q.dtype)

    qc = min(q_chunk, sq)
    kc = min(kv_chunk, skv)

    # pad sequences to chunk multiples (padded kv slots get pos = -1)
    sq_p = -(-sq // qc) * qc
    skv_p = -(-skv // kc) * kc
    if sq_p != sq:
        q = F.pad(q, (0, 0, 0, 0, 0, sq_p - sq))
        q_pos = F.pad(q_pos, (0, sq_p - sq))
    if skv_p != skv:
        k = F.pad(k, (0, 0, 0, 0, 0, skv_p - skv))
        v = F.pad(v, (0, 0, 0, 0, 0, skv_p - skv))
        kv_pos = F.pad(kv_pos, (0, skv_p - skv), value=-1)

    qg = q.reshape(b, sq_p, kv_h, g, d)
    outs = []
    for i in range(sq_p // qc):
        sl = slice(i * qc, (i + 1) * qc)
        if triangular:
            # causal self-attention: kv chunks beyond this q chunk's last
            # position can never be attended
            hi = -(-min((i + 1) * qc, skv_p) // kc) * kc
        else:
            hi = skv_p
        outs.append(_attn_chunk_scan(qg[:, sl], q_pos[:, sl], k[:, :hi],
                                     v[:, :hi], kv_pos[:, :hi], kc, window,
                                     scale))
    out = torch.cat(outs, dim=1)[:, :sq]
    return out.reshape(b, sq, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A constant in `like`'s dtype, rounded as JAX rounds a weak-typed
    Python scalar."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


# The activations are spelled as JAX composes them, one elementary op
# after another.  XLA rounds a bf16 result after every op, so the same
# sequence of torch ops gives the same bits; a fused torch op (F.silu,
# torch.sigmoid) rounds once and disagrees with it in about a third of
# the elements.

def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.sigmoid`: 1 / (1 + exp(-x))."""
    return 1 / (1 + torch.exp(-x))


def silu32(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu`'s x * sigmoid(x) with its last product left in
    float32 (the product of two values of x's dtype is exact there, so
    rounding it gives `silu`); the reference upcasts it in places, and XLA
    then drops that rounding (see `residual`)."""
    return x.float() * sigmoid(x).float()


def silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu`: x * sigmoid(x)."""
    return silu32(x).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu` (approximate=True, the tanh form)."""
    inner = _const(math.sqrt(2 / math.pi), x) * (
        x + _const(0.044715, x) * (x * (x * x)))
    return x * (_const(0.5, x) * (_const(1.0, x) + torch.tanh(inner)))


def activation(a: torch.Tensor, act: str) -> torch.Tensor:
    return silu(a) if act == "silu" else gelu(a)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor, act: str = "silu") -> torch.Tensor:
    return (activation(x @ w1, act) * (x @ w3)) @ w2


def mlp(h: torch.Tensor, p, cfg) -> torch.Tensor:
    """A block's gated MLP, `swiglu` over its weights p.w1, p.w3, p.w2, its
    hidden features this rank's chunk where they split over "tp"
    (`dist/tp.py`; in training from the whole sequence, gathered, and
    back onto the rank's positions)."""
    loc = tp.divides(cfg.d_ff)
    h = tp.seq_gather(h, loc)
    h1 = constrain(activation(tp.matmul(h, p.w1, local=loc), cfg.act),
                   "dp", None, "tp")
    return tp.matmul(h1 * tp.matmul(h, p.w3, local=loc), p.w2, x_local=loc)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def normal(gen: Optional[torch.Generator], shape, scale: float, dtype,
           device) -> torch.Tensor:
    """A float32 standard normal draw times `scale`, cast to `dtype`; on
    the meta device an empty tensor of that shape (nothing is drawn)."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * scale).to(dtype)


def vector(n: int, value: float, device) -> torch.Tensor:
    """A float32 vector of n entries equal to `value` (norm weights 1,
    biases 0, forget biases 3)."""
    return torch.full((n,), value, dtype=torch.float32, device=device)


def dense_init(gen: Optional[torch.Generator], in_dim: int, out_dim: int,
               dtype, device) -> torch.Tensor:
    return normal(gen, (in_dim, out_dim), 1.0 / math.sqrt(in_dim), dtype,
                  device)
