"""MiniCPM-2B [arXiv:2404.06395; hf]: dense llama-like, MHA, tied embeddings,
trained with the WSD schedule (`repro_torch.train.optimizer.wsd_schedule`,
which `launch/train.py` picks for it)."""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="minicpm-2b",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,          # GQA kv=36 == MHA
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,
    sub_quadratic=False,    # full attention: long_500k skipped (DESIGN.md)
)

TRAIN_SCHEDULE = "wsd"
