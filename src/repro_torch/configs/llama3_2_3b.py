"""llama3.2-3b [dense]: 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256 — small llama3  [hf:meta-llama/Llama-3.2-1B; unverified].

A copy of ``repro.configs.llama3_2_3b``: every config it returns is equal field for field
to the JAX package's.
"""
from ..models.config import LayerSpec, ModelConfig, uniform_groups


def full() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b",
        family="dense",
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=128256,
        groups=uniform_groups(28, LayerSpec(mixer="gqa", ffn="dense")),
        ffn_type="swiglu",
        rope_theta=500000.0,
        tie_embeddings=True,
        remat="dots",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b-reduced",
        family="dense",
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab_size=512,
        groups=uniform_groups(2, LayerSpec(mixer="gqa", ffn="dense")),
        ffn_type="swiglu",
        rope_theta=500000.0,
        tie_embeddings=True,
    )
