"""Architecture registry: one module per assigned architecture (the port's
own copy of `repro.configs`).

Each module exposes FULL (exact public config) and the registry builds a
reduced SMOKE variant for CPU tests.  `get(name)` / `get_smoke(name)`.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

from repro_torch.configs import (minicpm_2b, qwen3_32b, qwen2_5_14b,
                                 phi4_mini_3_8b, mixtral_8x7b,
                                 qwen3_moe_235b_a22b, recurrentgemma_9b,
                                 pixtral_12b, xlstm_350m, musicgen_medium)

_MODULES = {
    "minicpm-2b": minicpm_2b,
    "qwen3-32b": qwen3_32b,
    "qwen2.5-14b": qwen2_5_14b,
    "phi4-mini-3.8b": phi4_mini_3_8b,
    "mixtral-8x7b": mixtral_8x7b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b,
    "recurrentgemma-9b": recurrentgemma_9b,
    "pixtral-12b": pixtral_12b,
    "xlstm-350m": xlstm_350m,
    "musicgen-medium": musicgen_medium,
}

ARCH_NAMES = list(_MODULES)


def get(name: str) -> ModelConfig:
    return _MODULES[name].FULL


def make_smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config: tiny dims, same block pattern/features."""
    pat = cfg.block_pattern
    n_layers = len(pat) + min(cfg.pattern_remainder, len(pat))
    if n_layers == len(pat):
        n_layers = 2 * len(pat) if len(pat) == 1 else len(pat)
    kv = max(1, min(cfg.n_kv_heads, 2))
    heads = max(kv * min(cfg.q_per_kv, 2), kv)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=96 if cfg.d_ff else 0,
        vocab_size=128,
        window=16 if "swa" in pat else cfg.window,
        n_experts=4 if cfg.moe else 0,
        top_k=2 if cfg.moe else 0,
        capacity_factor=8.0 if cfg.moe else cfg.capacity_factor,  # dropless

        d_rnn=64 if cfg.d_rnn else 0,
        patch_prefix=4 if cfg.patch_prefix else 0,
        q_chunk=16,
        kv_chunk=16,
    )


def get_smoke(name: str) -> ModelConfig:
    return make_smoke(get(name))
