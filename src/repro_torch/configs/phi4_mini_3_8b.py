"""Phi-4-mini 3.8B [arXiv:2412.08905; hf]: dense, RoPE + SwiGLU + GQA kv=8,
tied embeddings (200k vocab)."""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="phi4-mini-3.8b",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    tie_embeddings=True,
    sub_quadratic=False,
)
