"""rwkv6-3b [ssm] — Finch, data-dependent decay [arXiv:2404.05892].

32L d_model=2560 (attention-free) d_ff=8960 vocab=65536.  The same numbers
as `repro/configs/rwkv6_3b.py`; the port reads its WKV width (40 heads of
key dim 64, chunk 64) for the chunked WKV kernel.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    source="arXiv:2404.05892",
    num_layers=32,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=8960,
    vocab_size=65536,
    ssm_kind="rwkv6",
    ssm_state=64,  # head key dim
    ssm_heads=40,
    ssm_chunk=64,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke",
        family="ssm",
        source=CONFIG.source,
        num_layers=2,
        d_model=128,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=256,
        vocab_size=512,
        ssm_kind="rwkv6",
        ssm_state=32,
        ssm_heads=4,
        ssm_chunk=16,
    )
