"""DeepSeek-V2 from its configuration file: the program's model and the
weights, made on the device from the seed.

The file holds the published ``config.json``'s keys. The port computes the
router's gates renormalized over the top k and unscaled, with greedy top-k
over all experts and plain RoPE: the file's ``as_run`` gives those keys as
run (``reference.as_run``), and a file whose keys as run ask for anything
else is refused here rather than run as something it is not.

Weights are drawn in the served dtype into one flat buffer by a few large
``normal_`` calls on a generator on the card, then each leaf (a view of the
buffer) is scaled: 1/sqrt(fan in) for projections, 0.02 for the
embedding, the head and the router. Norm weights are ones. The tree has the
port's layout (stacked ``(repeat, ...)`` groups); the reference reads the
same tensors by name.
"""
from __future__ import annotations

import math

import torch

from ..reference.deepseek_v2 import as_run

# the callees the traced run wraps in ``bench.<name>`` spans: (module, attribute, span)
SPANS = (("repro_torch.models.transformer", "mla_apply", "mla"),
         ("repro_torch.models.transformer", "moe_apply", "moe"))

RUNNABLE = {"topk_method": "greedy", "n_group": 1, "topk_group": 1,
            "routed_scaling_factor": 1.0, "norm_topk_prob": True, "rope_scaling": None,
            "scoring_func": "softmax", "hidden_act": "silu", "attention_bias": False}


_DRAW = 1 << 30


def check_runnable(c: dict) -> None:
    for key, want in RUNNABLE.items():
        if c[key] != want:
            raise ValueError(f"{key}={c[key]!r}: the port runs {want!r} only")


def model_config(c: dict):
    """The port's ``ModelConfig`` for configuration ``c``."""
    from repro_torch.models.config import GroupSpec, LayerSpec, MLAConfig, MoEConfig, ModelConfig

    c = as_run(c)
    check_runnable(c)
    k = c["first_k_dense_replace"]
    groups = []
    if k:
        groups.append(GroupSpec(repeat=k, layers=(LayerSpec(mixer="mla", ffn="dense"),)))
    groups.append(GroupSpec(repeat=c["num_hidden_layers"] - k,
                            layers=(LayerSpec(mixer="mla", ffn="moe"),)))
    dt = c["served_dtype"]
    return ModelConfig(
        name=c["name"], family="moe", d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"], n_kv_heads=c["num_key_value_heads"],
        head_dim=c["qk_nope_head_dim"], d_ff=c["intermediate_size"],
        vocab_size=c["vocab_size"], groups=tuple(groups), attn_type="mla",
        mla=MLAConfig(q_lora_rank=c["q_lora_rank"], kv_lora_rank=c["kv_lora_rank"],
                      qk_nope_dim=c["qk_nope_head_dim"], qk_rope_dim=c["qk_rope_head_dim"],
                      v_head_dim=c["v_head_dim"]),
        moe=MoEConfig(num_experts=c["n_routed_experts"], top_k=c["num_experts_per_tok"],
                      d_ff=c["moe_intermediate_size"], num_shared=c["n_shared_experts"],
                      shared_d_ff=c["moe_intermediate_size"], dropless=True),
        ffn_type="swiglu", rope_theta=float(c["rope_theta"]), norm_eps=c["rms_norm_eps"],
        tie_embeddings=c["tie_word_embeddings"], max_seq_len=c["max_position_embeddings"],
        param_dtype=dt, compute_dtype=dt,
    )


def _layer_shapes(c: dict, kind: str) -> dict:
    """Leaf shapes of one layer, and each leaf's scale (None: ones)."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    ql, kl, r = c["q_lora_rank"], c["kv_lora_rank"], c["qk_rope_head_dim"]
    dn, dv = c["qk_nope_head_dim"], c["v_head_dim"]

    def w(*shape, scale=None):
        return (shape, scale if scale is not None else 1 / math.sqrt(shape[-2]))

    mixer = {"wdq": w(d, ql), "qln": ((ql,), None), "wuq": w(ql, h * (dn + r)),
             "wdkv": w(d, kl + r), "kvln": ((kl,), None), "wukv": w(kl, h * (dn + dv)),
             "wo": w(h * dv, d)}
    layer = {"mixer": mixer, "ln_mixer": ((d,), None), "ln_ffn": ((d,), None)}
    if kind == "dense":
        f = c["intermediate_size"]
        layer["ffn"] = {"w1": w(d, f), "w2": w(f, d), "w3": w(d, f)}
    else:
        e, f = c["n_routed_experts"], c["moe_intermediate_size"]
        sf = f * c["n_shared_experts"]
        layer["moe"] = {"router": w(d, e, scale=0.02), "w1": w(e, d, f), "w2": w(e, f, d),
                        "w3": w(e, d, f), "sw1": w(d, sf), "sw2": w(sf, d), "sw3": w(d, sf)}
    return layer


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _group_runs(c: dict) -> list:
    """(kind, repeat) for each group of consecutive layers of one kind."""
    k = c["first_k_dense_replace"]
    runs = [("dense", k)] if k else []
    return runs + [("moe", c["num_hidden_layers"] - k)]


def make_weights(c: dict, seed: int, device) -> dict:
    """The weights of configuration ``c`` for ``seed``, in the served dtype."""
    d, v = c["hidden_size"], c["vocab_size"]
    plan = [(("embed",), (v, d), 0.02), (("final_norm",), (d,), None),
            (("lm_head",), (d, v), 0.02)]
    for gi, (kind, rep) in enumerate(_group_runs(c)):
        for path, (shape, scale) in _leaves(_layer_shapes(c, kind)):
            plan.append((("groups", gi, "sub0") + path, (rep,) + shape, scale))
    total = sum(math.prod(shape) for _, shape, _ in plan)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(total, dtype=getattr(torch, c["served_dtype"]), device=device)
    for lo in range(0, total, _DRAW):  # a few large draws, each under 2**31 elements
        flat[lo:lo + _DRAW].normal_(generator=gen)
    out = {"groups": [{} for _ in _group_runs(c)]}
    off = 0
    for path, shape, scale in plan:
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape)
        off += n
        if scale is None:
            leaf.fill_(1.0)
        else:
            leaf.mul_(scale)
        node = out
        for key in path[:-1]:
            node = node[key] if isinstance(node, list) else node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def weight_bytes(params: dict) -> int:
    total = 0

    def walk(t):
        nonlocal total
        if isinstance(t, dict):
            for x in t.values():
                walk(x)
        elif isinstance(t, list):
            for x in t:
                walk(x)
        else:
            total += t.numel() * t.element_size()

    walk(params)
    return total
