"""chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 — early-fusion, VQ image tokens  [arXiv:2405.09818; unverified].

Early fusion: image patches are VQ-quantized into discrete codes living in
the shared 65536 vocab, so the backbone consumes one mixed token stream.
The VQ tokenizer is the modality-frontend stub (input_specs provides token
ids).  Chameleon's qk-norm is enabled (training-stability fix from the
paper).

A copy of ``repro.configs.chameleon_34b``: every config it returns is equal field for field
to the JAX package's.
"""
from ..models.config import LayerSpec, ModelConfig, uniform_groups


def full() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b",
        family="vlm",
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=22016,
        vocab_size=65536,
        groups=uniform_groups(48, LayerSpec(mixer="gqa", ffn="dense")),
        ffn_type="swiglu",
        qk_norm=True,
        rope_theta=10000.0,
        tie_embeddings=False,
        remat="dots",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b-reduced",
        family="vlm",
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab_size=512,
        groups=uniform_groups(2, LayerSpec(mixer="gqa", ffn="dense")),
        ffn_type="swiglu",
        qk_norm=True,
        rope_theta=10000.0,
        tie_embeddings=False,
    )
