"""Mixtral-8x7B [arXiv:2401.04088; hf]: MoE 8 experts top-2, GQA kv=8,
sliding-window attention (W=4096) — SWA makes long_500k decode windowed,
so this arch runs the long-context cell."""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="mixtral-8x7b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=("swa",),
    window=4096,
    moe=True,
    n_experts=8,
    top_k=2,
    sub_quadratic=True,     # windowed cache: O(W) per token
)
