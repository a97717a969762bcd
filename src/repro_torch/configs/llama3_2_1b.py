"""llama3.2-1b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B].

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.  The same numbers
as `repro/configs/llama3_2_1b.py`; the port reads its attention width
(32 query heads of dim 64) for the flash-attention kernel.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    source="hf:meta-llama/Llama-3.2-1B",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=5e5,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b-smoke",
        family="dense",
        source=CONFIG.source,
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab_size=512,
        rope_theta=5e5,
        tie_embeddings=True,
    )
