"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887; hf].

Layout: 9 super-blocks of 8 layers (7 mamba + 1 attention at position 7);
MoE replaces the MLP on every 2nd layer (16 experts, top-2, expert
d_ff=24576), dense MLP d_ff=24576 elsewhere.

A copy of ``repro.configs.jamba_1_5_large_398b``: ``full()`` and
``reduced()`` are equal field for field to the JAX package's. The dropless
MoE path is switched on with ``dataclasses.replace(cfg.moe, dropless=True)``.
"""
from ..models.config import MoEConfig, ModelConfig, SSMConfig, jamba_groups


def full() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=65536,
        groups=jamba_groups(9, attn_pos=7, moe_stride=2),
        moe=MoEConfig(num_experts=16, top_k=2, d_ff=24576),
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=8),
        ffn_type="swiglu",
        rope_theta=10000.0,
        tie_embeddings=False,
        remat="dots",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b-reduced",
        family="hybrid",
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        groups=jamba_groups(1, attn_pos=7, moe_stride=2),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff=128),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=2, chunk=16),
        ffn_type="swiglu",
        rope_theta=10000.0,
        tie_embeddings=False,
    )
