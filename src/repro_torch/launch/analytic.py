"""Analytic FLOP model for every block kind, exact to the model code's
products (the reference's `repro.launch.analytic`, ported as it is).

`block_flops` counts one block's forward FLOPs over `tokens` tokens
attending `s_kv` keys; `cell_flops` a cell's (an architecture at a
`ShapeConfig`): the forward, the total with the backward and optimizer
update for a training cell, and the 2·N·D / 6·N·D model FLOPs.
`chip_smoke.py` takes its serving bounds from it.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.models.config import ModelConfig, ShapeConfig


def _attn_kv_effective(cfg: ModelConfig, s: int) -> float:
    """Average kv length actually computed by the triangular chunked
    attention (chunk-granular causal skipping)."""
    qc = min(cfg.q_chunk, s)
    kc = min(cfg.kv_chunk, s)
    n_q = -(-s // qc)
    total_rows = 0.0
    for i in range(n_q):
        hi = min((i + 1) * qc, s)
        hi = -(-hi // kc) * kc
        total_rows += qc * min(hi, s + (kc - s % kc) % kc)
    return total_rows / (n_q * qc)


def block_flops(cfg: ModelConfig, kind: str, tokens: float, s_kv: float,
                *, decode: bool = False) -> float:
    """Forward FLOPs of one block over `tokens` tokens attending s_kv keys."""
    d, h_, kv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    if kind in ("attn", "swa"):
        fl = 2 * tokens * d * (h_ + 2 * kv) * hd      # qkv proj
        fl += 2 * 2 * tokens * h_ * hd * s_kv         # qk^T and pV
        fl += 2 * tokens * h_ * hd * d                # out proj
        if cfg.moe:
            fl += 2 * tokens * d * cfg.n_experts      # router
            disp = tokens * cfg.top_k                 # dispatched assignments
            fl += 3 * 2 * disp * d * f                # expert swiglu
        else:
            fl += 3 * 2 * tokens * d * f              # swiglu
        return fl
    if kind == "rglru":
        r = cfg.d_rnn_eff
        fl = 2 * tokens * d * r * 2                   # w_in, w_gate
        fl += 2 * tokens * r * r * 2                  # r/i gate matmuls
        fl += 2 * tokens * cfg.conv_width * r         # conv
        fl += 10 * tokens * r                         # scan elementwise
        fl += 2 * tokens * r * d                      # w_out
        if f:
            fl += 3 * 2 * tokens * d * f              # Griffin MLP block
        return fl
    if kind == "mlstm":
        di = int(cfg.proj_factor * d)
        dh = di // h_
        fl = 2 * tokens * d * 2 * di                  # up
        fl += 3 * 2 * tokens * di * di                # q/k/v
        fl += 2 * 2 * tokens * di * h_                # gates
        fl += 2 * tokens * cfg.conv_width * di        # conv
        fl += 10 * tokens * di * dh                   # recurrence (C,n,Cq)
        fl += 2 * tokens * di * d                     # down
        return fl
    if kind == "slstm":
        dh = d // h_
        fl = 4 * 2 * tokens * d * d                   # z/i/f/o input proj
        fl += 4 * 2 * tokens * h_ * dh * dh           # recurrent mixes
        fl += 12 * tokens * d                         # gate elementwise
        f_up = int(4 * d / 3)
        fl += 3 * 2 * tokens * d * f_up               # gated ffn
        return fl
    raise ValueError(kind)


def cell_flops(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, float]:
    """Global FLOPs for the cell + MODEL_FLOPS (6*N*D convention)."""
    b = shape.global_batch
    if shape.kind == "train":
        s = shape.seq_len
        tokens = float(b * s)
        s_kv = _attn_kv_effective(cfg, s)
        decode = False
    elif shape.kind == "prefill":
        s = shape.seq_len
        tokens = float(b * s)
        s_kv = _attn_kv_effective(cfg, s)
        decode = False
    else:  # decode: one token, cache of seq_len
        tokens = float(b)
        s_kv = float(min(shape.seq_len, cfg.window)
                     if cfg.block_pattern[0] == "swa" or "swa" in
                     cfg.block_pattern else shape.seq_len)
        decode = True

    pattern = cfg.block_pattern
    n_cyc, rem = cfg.pattern_cycles, cfg.pattern_remainder
    fwd = 0.0
    for i in range(cfg.n_layers):
        kind = pattern[i % len(pattern)]
        if kind == "swa":
            kv_len = min(s_kv, cfg.window) if not decode else \
                min(shape.seq_len, cfg.window)
        else:
            kv_len = s_kv
        fwd += block_flops(cfg, kind, tokens, kv_len, decode=decode)

    # head (+ loss) and embed
    v = cfg.vocab_size * max(cfg.n_codebooks, 1)
    if shape.kind == "train":
        fwd += 2 * tokens * cfg.d_model * v
    else:
        head_tokens = tokens if shape.kind == "decode" else float(b)
        fwd += 2 * head_tokens * cfg.d_model * v

    if shape.kind == "train":
        total = 3.0 * fwd                     # fwd + 2x bwd
        n_params = cfg.n_params()
        total += 10.0 * n_params              # optimizer update
        model_flops = 6.0 * cfg.n_active_params() * tokens
    else:
        total = fwd
        model_flops = 2.0 * cfg.n_active_params() * tokens
    return {"hlo_est_flops": total, "model_flops": model_flops,
            "fwd_flops": fwd, "tokens": tokens}
