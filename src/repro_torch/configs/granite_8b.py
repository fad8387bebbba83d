"""granite-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=49152 — llama-arch, code  [arXiv:2405.04324; hf].

A copy of ``repro.configs.granite_8b``: every config it returns is equal field for field
to the JAX package's.
"""
from ..models.config import LayerSpec, ModelConfig, uniform_groups


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-8b",
        family="dense",
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=49152,
        groups=uniform_groups(36, LayerSpec(mixer="gqa", ffn="dense")),
        ffn_type="swiglu",
        rope_theta=10000.0,
        tie_embeddings=True,
        remat="dots",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-8b-reduced",
        family="dense",
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab_size=512,
        groups=uniform_groups(3, LayerSpec(mixer="gqa", ffn="dense")),
        ffn_type="swiglu",
        rope_theta=10000.0,
        tie_embeddings=True,
    )
