"""Model + shape configs for the architecture zoo (the port's own copy of
`repro.models.config`; the parameter counts build the port's `LM` on the
meta device, so nothing is allocated)."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # layer pattern, cycled: "attn", "swa" (sliding-window attn),
    # "rglru" (Griffin recurrent), "mlstm", "slstm" (xLSTM)
    block_pattern: Tuple[str, ...] = ("attn",)
    window: int = 4096                  # for "swa"

    # MoE (applies to the FFN of attn/swa blocks)
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_base: float = 10000.0
    use_rope: bool = True

    # recurrent options
    d_rnn: int = 0                      # rglru width (0 -> d_model)
    conv_width: int = 4                 # temporal conv (rglru / mlstm)
    proj_factor: float = 2.0            # mlstm up-projection factor

    # modality frontends (stubs: precomputed embeddings / token layouts)
    n_codebooks: int = 0                # musicgen: 4 EnCodec streams
    patch_prefix: int = 0               # pixtral: precomputed patch embeds

    # substrate
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"
    param_dtype: str = "bfloat16"
    # accumulation dtype of the wo / w2 contractions (the reference's
    # sharded reductions); both values give one rounding of a float32 sum
    # to the activation dtype in the port
    reduce_dtype: str = "float32"
    # attention activation layout: "auto" (heads-TP when divisible) or "sp"
    qkv_spec: str = "auto"
    scan_layers: bool = True
    remat: bool = True
    q_chunk: int = 512
    kv_chunk: int = 1024

    # which serve shapes this arch supports (full attention cannot do 500k)
    sub_quadratic: bool = False

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def d_rnn_eff(self) -> int:
        return self.d_rnn or self.d_model

    @property
    def pattern_cycles(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def pattern_remainder(self) -> int:
        return self.n_layers % len(self.block_pattern)

    @property
    def is_attention_free(self) -> bool:
        return all(k in ("mlstm", "slstm", "rglru") for k in self.block_pattern)

    def n_params(self) -> int:
        """Total parameter count (exact: the port's LM on the meta device)."""
        from repro_torch.models.model import LM
        return sum(p.numel() for p in LM(self, device="meta").parameters())

    def n_active_params(self) -> int:
        """Active-per-token params (MoE counts top_k of n_experts)."""
        from repro_torch.models.model import LM
        total = expert = 0
        for name, p in LM(self, device="meta").named_parameters():
            total += p.numel()
            if ".experts." in name:
                expert += p.numel()
        if not self.moe:
            return total
        return total - expert + expert * self.top_k // max(self.n_experts, 1)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int       # train/prefill: tokens per sequence; decode: KV length
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}
