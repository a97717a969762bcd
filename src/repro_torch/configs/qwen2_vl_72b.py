"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064. Backbone only: the
ViT vision encoder + projector are stubbed; `data.pipeline.make_batch`
supplies seeded patch embeddings of shape (B, S, d_model) plus (3, B, S)
M-RoPE position triplets.  The same numbers as `repro/configs/qwen2_vl_72b.py`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    source="arXiv:2409.12191",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    rope_style="mrope",
    rope_theta=1e6,
    qkv_bias=True,  # Qwen2 family uses QKV bias
    input_mode="embeddings",
    remat_policy="full",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b-smoke",
        family="vlm",
        source=CONFIG.source,
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab_size=512,
        rope_style="mrope",
        qkv_bias=True,
        input_mode="embeddings",
    )
