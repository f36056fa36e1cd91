"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409; unverified]: mistral-nemo-like
text backbone; the Pixtral-ViT frontend is a STUB — input_specs() provides
precomputed patch embeddings concatenated as a 256-token prefix."""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="pixtral-12b",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_base=1e6,
    patch_prefix=256,       # precomputed ViT patch embeddings (stub frontend)
    sub_quadratic=False,
)
