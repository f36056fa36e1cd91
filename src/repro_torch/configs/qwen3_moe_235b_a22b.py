"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3 MoE family; hf]: 128 experts top-8,
per-expert d_ff=1536, GQA kv=4, qk-norm."""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    qk_norm=True,
    rope_base=1e6,
    moe=True,
    n_experts=128,
    top_k=8,
    sub_quadratic=False,
)
