"""chatglm3-6b [dense] — RoPE 2d (half-rotary), GQA kv=2 [arXiv:2406.12793].

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.  The same numbers as
`repro/configs/chatglm3_6b.py`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    source="arXiv:2406.12793",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    rope_style="half",  # ChatGLM applies rotary to half the head dims (2d RoPE)
    qkv_bias=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-smoke",
        family="dense",
        source=CONFIG.source,
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab_size=512,
        rope_style="half",
        qkv_bias=True,
    )
