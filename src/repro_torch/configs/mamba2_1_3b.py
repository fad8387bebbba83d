"""mamba2-1.3b [ssm]: 48L d_model=2048 (attn-free) d_ff=0 vocab=50280,
ssm_state=128 — SSD (state-space duality)  [arXiv:2405.21060; unverified].

A copy of ``repro.configs.mamba2_1_3b``: ``full()`` and ``reduced()`` are
equal field for field to the JAX package's."""
from ..models.config import LayerSpec, ModelConfig, SSMConfig, uniform_groups


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        d_model=2048,
        n_heads=1,  # no attention heads; SSD heads come from SSMConfig
        n_kv_heads=1,
        head_dim=64,
        d_ff=0,
        vocab_size=50280,
        groups=uniform_groups(48, LayerSpec(mixer="mamba", ffn="none")),
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1),
        tie_embeddings=True,
        remat="dots",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b-reduced",
        family="ssm",
        d_model=64,
        n_heads=1,
        n_kv_heads=1,
        head_dim=16,
        d_ff=0,
        vocab_size=512,
        groups=uniform_groups(2, LayerSpec(mixer="mamba", ffn="none")),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1, chunk=16),
        tie_embeddings=True,
    )
