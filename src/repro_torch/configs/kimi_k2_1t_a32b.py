"""kimi-k2-1t-a32b [moe] — trillion-param MoE [arXiv:2501.kimi2 (paper-table)].

61L d_model=7168 64H (GQA kv=8) d_ff=2048(expert) vocab=163840,
MoE 384 experts top-8, 1 shared expert, first layer dense.  The same numbers
as `repro/configs/kimi_k2_1t_a32b.py` (its source line included); GQA
attention at head dim 128, which the flash kernels take.  Adafactor, bf16
parameters and full remat, as the reference sets them for its 1T
parameters.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    source="arXiv:2501.kimi2",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab_size=163840,
    rope_theta=5e5,
    num_experts=384,
    num_shared_experts=1,
    moe_top_k=8,
    first_k_dense=1,
    capacity_factor=1.25,
    moe_dispatch_chunk=2048,
    optimizer="adafactor",
    param_dtype="bfloat16",
    remat_policy="full",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-smoke",
        family="moe",
        source=CONFIG.source,
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=128,
        vocab_size=512,
        num_experts=4,
        num_shared_experts=1,
        moe_top_k=2,
        first_k_dense=1,
        moe_dispatch_chunk=64,
        optimizer="adafactor",
    )
