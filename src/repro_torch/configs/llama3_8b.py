"""llama3-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — GQA 128k vocab  [arXiv:2407.21783; unverified].

A copy of ``repro.configs.llama3_8b``: every config it returns is equal field for field
to the JAX package's.
"""
from ..models.config import LayerSpec, ModelConfig, SableConfig, uniform_groups


def full() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b",
        family="dense",
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128256,
        groups=uniform_groups(32, LayerSpec(mixer="gqa", ffn="dense")),
        ffn_type="swiglu",
        rope_theta=500000.0,
        tie_embeddings=False,
        remat="dots",
    )


def full_sable(density: float = 0.25) -> ModelConfig:
    """llama3-8b with SABLE block-sparse FFN weights (the paper's technique
    inside the LM) — used for the technique-representative hillclimb cell.
    d_ff rounded to 14336 -> tile-aligned 14336 = 112 * 128."""
    import dataclasses

    return dataclasses.replace(
        full(),
        name="llama3-8b-sable",
        sable=SableConfig(block_m=128, block_n=128, density=density),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b-reduced",
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
        tie_embeddings=False,
    )


def reduced_sable() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        reduced(),
        name="llama3-8b-reduced-sable",
        d_model=64,
        d_ff=128,
        n_heads=4,
        n_kv_heads=2,
        sable=SableConfig(block_m=16, block_n=16, density=0.5),
    )
