"""llama3.2-3b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B].

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256.  The same numbers
as `repro/configs/llama3_2_3b.py` (its source line included); head dim 128,
which the flash kernels take.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    source="hf:meta-llama/Llama-3.2-1B",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=5e5,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b-smoke",
        family="dense",
        source=CONFIG.source,
        num_layers=2,
        d_model=192,
        num_heads=6,
        num_kv_heads=2,
        head_dim=32,
        d_ff=384,
        vocab_size=512,
        rope_theta=5e5,
        tie_embeddings=True,
    )
