"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16e top-1 — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

Every layer routes top-1 over 16 experts plus one always-on shared expert
(d_ff=8192 each).  Early-fusion multimodality enters as tokens (the vision
frontend is out of scope: text tokens only).

A copy of ``repro.configs.llama4_scout_17b_a16e``: ``full()`` and
``reduced()`` are equal field for field to the JAX package's. The dropless
MoE path is switched on with ``dataclasses.replace(cfg.moe, dropless=True)``.
"""
from ..models.config import LayerSpec, MoEConfig, ModelConfig, uniform_groups


def full() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        groups=uniform_groups(48, LayerSpec(mixer="gqa", ffn="moe")),
        moe=MoEConfig(num_experts=16, top_k=1, d_ff=8192, num_shared=1, shared_d_ff=8192),
        ffn_type="swiglu",
        rope_theta=500000.0,
        tie_embeddings=False,
        remat="dots",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e-reduced",
        family="moe",
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab_size=512,
        groups=uniform_groups(2, LayerSpec(mixer="gqa", ffn="moe")),
        moe=MoEConfig(num_experts=4, top_k=1, d_ff=96, num_shared=1, shared_d_ff=96),
        ffn_type="swiglu",
        rope_theta=500000.0,
        tie_embeddings=False,
    )
