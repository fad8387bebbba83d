"""The yardstick: peaks of the card and the work each call needs.

Every count here comes from the inputs the harness made (the VBR's arrays,
the routing the router chose, the configuration file), never from a table
the program builds, so that a change of tiling or layout cannot move its
own bound.

Peaks are NVIDIA's published H100 SXM figures (dense, no sparsity). A
float32 product on the tensor cores runs as 3xTF32, three TF32 products for
one, so float32 work is held to a third of the TF32 rate.
"""
from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 494.7e12 / 3}
PEAK_BYTES_PER_S = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def roofline_s(ops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the operations at
    the peak rate and the bytes at the memory rate."""
    return max(ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


# ---------------------------------------------------------------------- #
# staged sparse calls (the VBR as the harness made it)
# ---------------------------------------------------------------------- #
def sparse_ops(stored: int, n_cols: int) -> int:
    """Multiply-adds of y = A x over every stored value, in-block zeros
    included, counted as two operations each."""
    return 2 * stored * n_cols


def sparse_bytes(stored: int, rows: int, cols: int, n_cols: int, itemsize: int) -> int:
    """Each stored value read once, x read once and y written once."""
    return (stored + cols * n_cols + rows * n_cols) * itemsize


def sparse_roofline(m, kernels: tuple):
    """``kernels``' share of the roofline of the staged calls of a traced
    run: one call's work from the VBR as made (``sparse_ops``,
    ``sparse_bytes``) times the calls traced, over the kernels' device time
    under the calls' spans."""
    tr, r = m.trace, m.rec
    if tr is None or not tr.count("call"):
        return None
    one = roofline_s(sparse_ops(r["stored"], r["n_cols"]),
                     sparse_bytes(r["stored"], r["rows"], r["cols"], r["n_cols"],
                                  ITEMSIZE[r["dtype"]]), r["dtype"])
    return tr.share(one * tr.count("call"), kernels, "call")


# ---------------------------------------------------------------------- #
# DeepSeek-V2 (the configuration file's keys)
# ---------------------------------------------------------------------- #
def _attn_weights(c: dict) -> int:
    """MLA's weights a token multiplies at prefill (the latent expanded to
    every head's key and value, as the materialized form does)."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    return (d * c["q_lora_rank"] + c["q_lora_rank"] * h * qk
            + d * (c["kv_lora_rank"] + c["qk_rope_head_dim"])
            + c["kv_lora_rank"] * h * (c["qk_nope_head_dim"] + c["v_head_dim"])
            + h * c["v_head_dim"] * d)


def _moe_active_weights(c: dict) -> int:
    d, f = c["hidden_size"], c["moe_intermediate_size"]
    return (3 * d * f * (c["num_experts_per_tok"] + c["n_shared_experts"])
            + d * c["n_routed_experts"])


def layer_kinds(c: dict) -> list:
    """"dense" or "moe" for each layer, in order."""
    k = c["first_k_dense_replace"]
    return ["dense" if i < k else "moe" for i in range(c["num_hidden_layers"])]


def prefill_flops(c: dict, tokens: int) -> float:
    """Model FLOPs of one prompt's prefill: every layer's weights times two
    per token, the causal score and value products of attention, and the
    head once (the prefill's logits are the last position's)."""
    d = c["hidden_size"]
    h = c["num_attention_heads"]
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    pairs = tokens * (tokens + 1) / 2
    per_layer_attn = 2 * pairs * h * (qk + c["v_head_dim"])
    total = 0.0
    for kind in layer_kinds(c):
        w = _attn_weights(c) + (3 * d * c["intermediate_size"] if kind == "dense"
                                else _moe_active_weights(c))
        total += 2 * w * tokens + per_layer_attn
    return total + 2 * d * c["vocab_size"]


def expert_projection(c: dict, assignments: int, experts_hit: int) -> tuple:
    """(ops, bytes) of one routed projection (w1 or w3 by K3, w2 by K2) in
    the served dtype: two operations per multiply-add over each assignment,
    the weights of each expert hit read once, the activations in and out."""
    d, f = c["hidden_size"], c["moe_intermediate_size"]
    item = ITEMSIZE[c["served_dtype"]]
    ops = 2 * assignments * d * f
    nbytes = (experts_hit * d * f + assignments * (d + f)) * item
    return ops, nbytes


def moe_roofline(m, kernels: tuple, projections: int, phase: str = "prefill"):
    """``kernels``' share of the roofline of ``projections`` routed
    projections of every MoE call traced in ``phase``: the router's counts
    of each call (``expert_projection``), over the kernels' device time
    under the ``phase`` spans."""
    tr, c = m.trace, m.cfg
    routes = [(a, hit) for ph, a, hit in m.rec.get("routes", ()) if ph == phase]
    if tr is None or not routes:
        return None
    bound = sum(roofline_s(*expert_projection(c, a, hit), c["served_dtype"]) for a, hit in routes)
    return tr.share(projections * bound, kernels, phase)
