"""Qwen3-32B [hf:Qwen/Qwen3-8B family; hf]: dense, GQA kv=8, qk-norm."""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen3-32b",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_base=1e6,
    sub_quadratic=False,
)
