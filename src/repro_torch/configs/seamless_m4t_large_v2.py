"""seamless-m4t-large-v2 [audio]: 24L d_model=1024 16H (GQA kv=16)
d_ff=8192 vocab=256206 — enc-dec, multimodal  [arXiv:2308.11596; hf].

Encoder-decoder: a 24-layer bidirectional encoder over precomputed speech
frame embeddings (the w2v-BERT frontend is a stub: the inputs are (B, S_src,
1024) frames) and a 24-layer causal decoder with cross-attention. kv=16
with 16 heads => standard MHA.

A copy of ``repro.configs.seamless_m4t_large_v2``: every config it returns
is equal field for field to the JAX package's.
"""
from ..models.config import GroupSpec, LayerSpec, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=8192,
        vocab_size=256206,
        groups=(
            GroupSpec(
                repeat=24,
                layers=(LayerSpec(mixer="gqa", ffn="dense", cross_attn=True),),
            ),
        ),
        enc_groups=(
            GroupSpec(repeat=24, layers=(LayerSpec(mixer="gqa", ffn="dense"),)),
        ),
        ffn_type="gelu",
        rope_theta=10000.0,
        tie_embeddings=True,
        frontend_dim=1024,
        remat="dots",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2-reduced",
        family="audio",
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        groups=(
            GroupSpec(
                repeat=2,
                layers=(LayerSpec(mixer="gqa", ffn="dense", cross_attn=True),),
            ),
        ),
        enc_groups=(
            GroupSpec(repeat=2, layers=(LayerSpec(mixer="gqa", ffn="dense"),)),
        ),
        ffn_type="gelu",
        rope_theta=10000.0,
        tie_embeddings=True,
        frontend_dim=64,
    )
