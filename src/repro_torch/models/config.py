"""Model configuration system (a copy of ``repro.models.config``).

The dataclasses are pure Python and identical to the JAX package's, so
``dataclasses.asdict`` of a config is the same in both packages. The port
keeps its own copy because it imports nothing of ``repro``.

A model is a stack of *groups*; each group repeats a *block* of sub-layers
(`LayerSpec`s) ``repeat`` times over stacked parameters. This single
abstraction expresses every supported architecture:

  uniform LM        [(L, [attn+ffn])]
  deepseek-v2       [(1, [attn+dense]), (59, [attn+moe])]
  jamba             [(9, [7x mamba + 1x attn, ffn/moe alternating])]
  enc-dec           encoder groups + decoder groups (cross-attn)
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int  # per-expert hidden size
    num_shared: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    aux_loss_coef: float = 0.001
    # dropless routed FFN: full-capacity buckets (nothing dropped) with the
    # expert FFN computed block-sparsely over OCCUPIED capacity blocks only
    # (kernels.bsr_ops sdd/dsd) — FLOPs track actual tokens, not E*C
    dropless: bool = False
    dropless_block: int = 8  # capacity-slot block rows per sparse block


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class SableConfig:
    """Block-sparse (SABLE-staged) weights for FFN matrices."""

    block_m: int = 128  # tile rows (input dim)
    block_n: int = 128  # tile cols (output dim)
    density: float = 0.25  # fraction of blocks kept
    target: str = "ffn"  # which matrices to sparsify
    backend: str = "grouped"  # grouped | pallas
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "gqa"  # gqa | mla | mamba | none
    ffn: str = "dense"  # dense | moe | none
    cross_attn: bool = False  # decoder cross-attention


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    repeat: int
    layers: tuple  # tuple[LayerSpec, ...]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | ssm | hybrid | moe | vlm | audio
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    groups: tuple  # tuple[GroupSpec, ...] — decoder (or decoder-only) stack
    enc_groups: tuple = ()  # encoder stack (enc-dec models)
    ffn_type: str = "swiglu"  # swiglu | relu2 | gelu
    attn_type: str = "gqa"  # gqa | mla
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    sable: Optional[SableConfig] = None
    qk_norm: bool = False
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq_len: int = 131072
    causal: bool = True
    # modality frontend stub: inputs are precomputed frame/patch embeddings
    frontend_dim: int = 0  # 0 => token ids; >0 => embeddings of this dim
    # numerics / schedule
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "none"  # none | full | dots
    logit_softcap: float = 0.0
    attn_chunk: int = 0  # >0: flash-style chunked attention (chunk size)

    # ------------------------------------------------------------------ #
    @property
    def n_layers(self) -> int:
        return sum(g.repeat * len(g.layers) for g in self.groups) + sum(
            g.repeat * len(g.layers) for g in self.enc_groups
        )

    @property
    def is_encdec(self) -> bool:
        return len(self.enc_groups) > 0

    def has_mixer(self, kind: str) -> bool:
        for g in tuple(self.groups) + tuple(self.enc_groups):
            for s in g.layers:
                if s.mixer == kind:
                    return True
        return False

    @property
    def attention_free(self) -> bool:
        return not (self.has_mixer("gqa") or self.has_mixer("mla"))

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid / linear-attn)."""
        return self.family in ("ssm", "hybrid")


def uniform_groups(n_layers: int, spec: LayerSpec) -> tuple:
    return (GroupSpec(repeat=n_layers, layers=(spec,)),)


def jamba_groups(n_super: int, attn_pos: int = 7, moe_stride: int = 2) -> tuple:
    """1 attention : 7 mamba per super-block; MoE every ``moe_stride``."""
    layers = []
    for i in range(8):
        mixer = "gqa" if i == attn_pos else "mamba"
        ffn = "moe" if (i % moe_stride == 1) else "dense"
        layers.append(LayerSpec(mixer=mixer, ffn=ffn))
    return (GroupSpec(repeat=n_super, layers=tuple(layers)),)


# ---------------------------------------------------------------------- #
# Parameter counting (for roofline MODEL_FLOPS = 6 N D)
# ---------------------------------------------------------------------- #
def _layer_params(cfg: ModelConfig, spec: LayerSpec, active: bool) -> int:
    d = cfg.d_model
    n = 0
    if spec.mixer == "gqa":
        n += d * cfg.n_heads * cfg.head_dim  # wq
        n += 2 * d * cfg.n_kv_heads * cfg.head_dim  # wk, wv
        n += cfg.n_heads * cfg.head_dim * d  # wo
    elif spec.mixer == "mla":
        m = cfg.mla
        n += d * m.q_lora_rank + m.q_lora_rank * cfg.n_heads * (
            m.qk_nope_dim + m.qk_rope_dim
        )
        n += d * (m.kv_lora_rank + m.qk_rope_dim)
        n += m.kv_lora_rank * cfg.n_heads * (m.qk_nope_dim + m.v_head_dim)
        n += cfg.n_heads * m.v_head_dim * d
    elif spec.mixer == "mamba":
        s = cfg.ssm
        di = s.d_inner(d)
        nh = s.n_heads(d)
        gs = s.n_groups * s.d_state
        n += d * (2 * di + 2 * gs + nh)  # in_proj
        n += (di + 2 * gs) * s.d_conv  # conv
        n += di * d  # out_proj
        n += 3 * nh + di  # A_log, D, dt_bias, norm
    if spec.cross_attn:
        n += 2 * d * cfg.n_heads * cfg.head_dim + 2 * d * cfg.n_kv_heads * cfg.head_dim
    if spec.ffn == "dense":
        mult = 3 if cfg.ffn_type == "swiglu" else 2
        n += mult * d * cfg.d_ff
    elif spec.ffn == "moe":
        mc = cfg.moe
        mult = 3 if cfg.ffn_type == "swiglu" else 2
        per_expert = mult * d * mc.d_ff
        routed = mc.top_k if active else mc.num_experts
        n += routed * per_expert
        n += mc.num_shared * mult * d * (mc.shared_d_ff or mc.d_ff)
        n += d * mc.num_experts  # router
    n += 2 * d  # norms
    return n


def param_count(cfg: ModelConfig, active: bool = False) -> int:
    """Total (or active, for MoE) parameter count."""
    n = cfg.vocab_size * cfg.d_model  # embed
    if not cfg.tie_embeddings:
        n += cfg.vocab_size * cfg.d_model
    for g in tuple(cfg.enc_groups) + tuple(cfg.groups):
        for spec in g.layers:
            n += g.repeat * _layer_params(cfg, spec, active)
    n += cfg.d_model  # final norm
    return n
