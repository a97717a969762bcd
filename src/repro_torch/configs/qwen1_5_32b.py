"""qwen1.5-32b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B].

64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064.  The same numbers as
`repro/configs/qwen1_5_32b.py` (its source line included); ~35 B parameters,
~140 GB in fp32, so the card serves it at a cut depth.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    remat_policy="full",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-smoke",
        family="dense",
        source=CONFIG.source,
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=8,
        head_dim=32,
        d_ff=512,
        vocab_size=512,
        qkv_bias=True,
    )
