"""Model zoo of the port: configs and functional transformer/MoE forward
passes (``repro.models``' exports, for what is ported)."""
from .config import (
    GroupSpec,
    LayerSpec,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    SableConfig,
    SSMConfig,
    jamba_groups,
    param_count,
    uniform_groups,
)
from .transformer import (
    decode_step,
    encode,
    forward_train,
    init_cache,
    init_params,
    prefill,
    prefill_chunk,
)
