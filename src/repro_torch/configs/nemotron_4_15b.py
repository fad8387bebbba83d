"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000 — GQA, squared-ReLU  [arXiv:2402.16819; unverified].

A copy of ``repro.configs.nemotron_4_15b``: every config it returns is equal field for field
to the JAX package's.
"""
from ..models.config import LayerSpec, ModelConfig, uniform_groups


def full() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b",
        family="dense",
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=256000,
        groups=uniform_groups(32, LayerSpec(mixer="gqa", ffn="dense")),
        ffn_type="relu2",
        rope_theta=10000.0,
        tie_embeddings=False,
        remat="dots",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b-reduced",
        family="dense",
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        head_dim=16,
        d_ff=192,
        vocab_size=512,
        groups=uniform_groups(2, LayerSpec(mixer="gqa", ffn="dense")),
        ffn_type="relu2",
        rope_theta=10000.0,
        tie_embeddings=False,
    )
