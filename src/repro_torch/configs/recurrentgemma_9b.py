"""RecurrentGemma-9B [arXiv:2402.19427 Griffin; unverified]: RG-LRU recurrent
blocks + local attention, 2:1 pattern (recurrent, recurrent, local-attn),
MQA kv=1, window 2048.  Sub-quadratic: runs long_500k."""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="recurrentgemma-9b",
    n_layers=38,                    # 12 full cycles + (rglru, rglru) remainder
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "swa"),
    window=2048,
    d_rnn=4096,
    act="gelu",
    sub_quadratic=True,
)
