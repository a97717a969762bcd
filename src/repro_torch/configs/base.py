"""Model and input-shape configs: a trimmed copy of `repro/configs/base.py`.

The fields that the port's copied model configs set (`llama3_2_1b`,
`rwkv6_3b`, `llama3_2_3b`, `qwen1_5_32b`, `chatglm3_6b`, `qwen2_vl_72b`,
`kimi_k2_1t_a32b`) and those its serving and training paths read (the
attention flavour, the MoE layer, the family switches it refuses, the input
mode, the numerics, remat and the optimizer), under the reference's names and
defaults, so a copied `CONFIG` equals the reference's field by field; the
`train_4k`, `prefill_32k` and `decode_32k` input shapes; and the registry
(`get_config`, `get_smoke_config`, `get_shape`) over the archs the port has.
"""
from __future__ import annotations

import dataclasses
import importlib


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

    # --- attention flavour ---
    rope_theta: float = 1e4
    rope_style: str = "full"  # full | half (chatglm 2d-rope) | mrope (qwen2-vl)
    qkv_bias: bool = False
    attn_logit_softcap: float = 0.0
    sliding_window: int = 0  # >0 enables sliding-window attention variant

    # --- MLA (deepseek-v2): not ported; the model refuses it ---
    use_mla: bool = False

    # --- MoE (kimi-k2) ---
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    moe_dispatch_chunk: int = 4096  # tokens per dispatch chunk (memory lever)
    moe_group_limit: int = 0  # >0: route each token to experts on <= this many
    #   model shards (DeepSeek-style group-limited routing) and DEDUPLICATE the
    #   dispatch (one copy per destination shard, not per expert)
    router_aux_coef: float = 0.01  # the loss's weight of the MoE aux term

    # --- SSM (rwkv6) ---
    ssm_kind: str = ""  # "" | rwkv6 | mamba2
    ssm_state: int = 0  # head key dim (rwkv6)
    ssm_heads: int = 0
    ssm_chunk: int = 64  # chunked-scan chunk length
    attn_every: int = 0  # hybrid: shared attention block every N layers

    # --- encoder-decoder (seamless): not ported ---
    is_encoder_decoder: bool = False

    # --- modality frontend stub (qwen2-vl: precomputed patch embeddings) ---
    input_mode: str = "tokens"  # tokens | embeddings

    # --- numerics / training ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"
    remat_policy: str = "minimal"  # none | minimal | full
    optimizer: str = "adamw"  # adamw | adafactor | sgdm | sparse_adamw

    def __post_init__(self):
        assert self.family in ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
        if self.family == "moe":
            assert self.num_experts > 0 and self.moe_top_k > 0
        if self.ssm_kind:
            assert self.ssm_kind in ("rwkv6", "mamba2")
            assert self.ssm_state > 0 and self.ssm_heads > 0
        if self.num_heads and not self.ssm_kind:
            assert self.num_heads % max(self.num_kv_heads, 1) == 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
}

# the archs the port has a copy of
PORTED_ARCHS = ("llama3.2-1b", "rwkv6-3b", "llama3.2-3b", "qwen1.5-32b",
                "chatglm3-6b", "qwen2-vl-72b", "kimi-k2-1t-a32b")


def _module(arch_id: str):
    if arch_id not in PORTED_ARCHS:
        raise KeyError(
            f"arch {arch_id!r} is not in the port, which serves {PORTED_ARCHS}; "
            "the other language models wait in ROADMAP.md queue 1, item 15c")
    return importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


def get_shape(name: str) -> ShapeConfig:
    return INPUT_SHAPES[name]
