"""xLSTM-350M [arXiv:2405.04517; unverified]: xLSTM[7:1] — 7 mLSTM blocks per
sLSTM block (24 layers = 3 cycles of 8).  d_ff=0: FFN is internal to the
blocks (mLSTM pf=2 up-projection, sLSTM pf=4/3 gated FFN).  Attention-free:
runs long_500k with O(1) state."""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="xlstm-350m",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    use_rope=False,
    proj_factor=2.0,
    sub_quadratic=True,
)
