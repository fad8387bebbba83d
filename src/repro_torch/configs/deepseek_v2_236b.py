"""deepseek-v2-236b [moe]: 60L d_model=5120 128H (GQA kv=128) d_ff=1536
vocab=102400, MoE 160e top-6 — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434; hf].

Notes: d_ff=1536 is the per-expert hidden size; layer 0
uses a dense FFN (d_ff=12288) per the published config.  128H refers to the
MLA head count (MLA caches the 512-d compressed latent + 64-d rope key, not
per-head KV).

A copy of ``repro.configs.deepseek_v2_236b``: ``full()`` and ``reduced()``
are equal field for field to the JAX package's. The dropless MoE path is
switched on with ``dataclasses.replace(cfg.moe, dropless=True)``.
"""
from ..models.config import (
    GroupSpec,
    LayerSpec,
    MLAConfig,
    MoEConfig,
    ModelConfig,
)


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        d_ff=12288,  # dense layer-0 FFN
        vocab_size=102400,
        groups=(
            GroupSpec(repeat=1, layers=(LayerSpec(mixer="mla", ffn="dense"),)),
            GroupSpec(repeat=59, layers=(LayerSpec(mixer="mla", ffn="moe"),)),
        ),
        attn_type="mla",
        mla=MLAConfig(
            q_lora_rank=1536,
            kv_lora_rank=512,
            qk_nope_dim=128,
            qk_rope_dim=64,
            v_head_dim=128,
        ),
        moe=MoEConfig(
            num_experts=160,
            top_k=6,
            d_ff=1536,
            num_shared=2,
            shared_d_ff=1536,
        ),
        ffn_type="swiglu",
        rope_theta=10000.0,
        tie_embeddings=False,
        remat="dots",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b-reduced",
        family="moe",
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        groups=(
            GroupSpec(repeat=1, layers=(LayerSpec(mixer="mla", ffn="dense"),)),
            GroupSpec(repeat=2, layers=(LayerSpec(mixer="mla", ffn="moe"),)),
        ),
        attn_type="mla",
        mla=MLAConfig(
            q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
            v_head_dim=16,
        ),
        moe=MoEConfig(num_experts=8, top_k=2, d_ff=32, num_shared=2, shared_d_ff=32),
        ffn_type="swiglu",
        rope_theta=10000.0,
        tie_embeddings=False,
    )
