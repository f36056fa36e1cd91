"""Qwen2.5-14B [hf:Qwen/Qwen2.5 family; hf]: dense, GQA kv=8, QKV bias."""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2.5-14b",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_base=1e6,
    sub_quadratic=False,
)
