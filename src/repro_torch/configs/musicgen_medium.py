"""MusicGen-medium [arXiv:2306.05284; hf]: decoder-only over 4 EnCodec
codebook streams (delay pattern is a data-layout concern handled by the
stub frontend): summed codebook embeddings in, 4 parallel 2048-way heads out.
Positional encoding: RoPE stands in for MusicGen's sinusoidal embeddings
(recorded deviation, DESIGN.md)."""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="musicgen-medium",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,          # MHA
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    n_codebooks=4,
    sub_quadratic=False,
)
