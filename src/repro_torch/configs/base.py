"""Model and input-shape configs: a trimmed copy of `repro/configs/base.py`.

Only the fields that the port's copied model configs set (`llama3_2_1b`,
`rwkv6_3b`) and the `train_4k` input shape; the same names, defaults and
checks as the reference, so a copied `CONFIG` equals the reference's field
by field.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    source: str  # citation from the assignment table

    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 1024

    rope_theta: float = 1e4
    tie_embeddings: bool = False

    # --- SSM (rwkv6) ---
    ssm_kind: str = ""  # "" | rwkv6 | mamba2
    ssm_state: int = 0  # head key dim (rwkv6)
    ssm_heads: int = 0
    ssm_chunk: int = 64  # chunked-scan chunk length

    def __post_init__(self):
        assert self.family in ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
        if self.ssm_kind:
            assert self.ssm_kind in ("rwkv6", "mamba2")
            assert self.ssm_state > 0 and self.ssm_heads > 0
        if self.num_heads and not self.ssm_kind:
            assert self.num_heads % max(self.num_kv_heads, 1) == 0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
}
