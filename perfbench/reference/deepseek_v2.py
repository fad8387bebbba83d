"""A plain forward of DeepSeek-V2 (arXiv:2405.04434) in float32.

Written from the paper's equations as the configuration file states them,
over the weights the harness made (read by name), for whole sequences at
once: no cache, no batching across sequences, no kernel of the program.
The file keeps the published keys; where the port runs a key otherwise,
the file's ``as_run`` gives the value run and ``departures`` says why
(``as_run``): the router's greedy top k over all experts with its gates
renormalized and unscaled, and plain RoPE. Group-limited routing and yarn
are not written here, and a configuration that asks for them is refused.

  h = embed[tokens]
  each layer:  h += MLA(rmsnorm(h));  h += FFN(rmsnorm(h))
  MLA:  c_q = rmsnorm(h W_dq);  q = c_q W_uq = [q_nope | q_rope], q_rope = RoPE(q_rope)
        c_kv | k_r = h W_dkv;  c_kv = rmsnorm(c_kv);  k_r = RoPE(k_r), shared by every head
        [k_nope | v] = c_kv W_ukv;  softmax([q_nope|q_rope].[k_nope|k_r] / sqrt(d_nope + d_rope))
        causal, then v and W_o
  FFN:  layer < first_k_dense_replace: SwiGLU(W1, W3, W2); else the MoE:
        p = softmax(h W_router), the top k experts by p, gates p_i / sum of the top k
        (norm_topk_prob) times routed_scaling_factor, each expert a SwiGLU of width
        moe_intermediate_size, plus n_shared_experts SwiGLUs stacked side by side
  logits = rmsnorm(h) W_head

RoPE rotates the two halves of each rope vector (x1, x2) by the angles
position / rope_theta**(2i / d_rope), in float32. Matmuls run with TF32
off. ``precision="fp8"`` (the control) rounds both operands of every
projection of attention, the dense FFN and the experts to float8 e4m3, the
activations by row and the weights by output column, each scaled to its
largest magnitude; the router, the head and the softmaxes stay float32.
``precision="bf16"`` (a witness, not a control) rounds the same products'
inputs and outputs to bfloat16, as a bfloat16 program's would be.
"""
from __future__ import annotations

import torch

from .vbr import matmul_precision

FP8_MAX = 448.0
CONTROL = "fp8"  # the next precision down from bfloat16: the control's ``precision``
WITNESS = "bf16"


def as_run(c: dict) -> dict:
    """The configuration as the port runs it: the file's keys with its
    ``as_run`` keys over them."""
    c = {**c, **c.get("as_run", {})}
    if c["topk_method"] != "greedy" or c["n_group"] != 1 or c["rope_scaling"] is not None:
        raise ValueError("the reference routes greedily over all experts with plain RoPE only")
    return c


def _q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    s = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


class _Lin:
    def __init__(self, precision: str):
        if precision not in ("f32", "fp8", "bf16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        if self.precision == "fp8":
            return _q8(x, -1) @ _q8(w, 0)
        if self.precision == "bf16":
            return (x.bfloat16().float() @ w).bfloat16().float()
        return x @ w


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, ..., D) at positions pos (S,)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    ang = pos.float()[:, None] * freqs
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (half,)
    cos, sin = torch.cos(ang).view(shape), torch.sin(ang).view(shape)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _swiglu(lin, x, w1, w3, w2):
    return lin(torch.nn.functional.silu(lin(x, w1)) * lin(x, w3), w2)


def _mla(lin, p: dict, h: torch.Tensor, c: dict, head_block: int = 32) -> torch.Tensor:
    S = h.shape[0]
    H = c["num_attention_heads"]
    dn, dr, dv, kl = (c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"],
                      c["kv_lora_rank"])
    eps, theta = c["rms_norm_eps"], float(c["rope_theta"])
    pos = torch.arange(S, device=h.device)
    q = lin(rmsnorm(lin(h, p["wdq"]), p["qln"], eps), p["wuq"]).view(S, H, dn + dr)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], pos, theta)], dim=-1)
    ckv_full = lin(h, p["wdkv"])
    ckv = rmsnorm(ckv_full[:, :kl], p["kvln"], eps)
    k_r = rope(ckv_full[:, kl:], pos, theta)
    kv = lin(ckv, p["wukv"]).view(S, H, dn + dv)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    out = torch.empty(S, H, dv, device=h.device)
    scale = (dn + dr) ** -0.5
    for h0 in range(0, H, head_block):
        hs = slice(h0, h0 + head_block)
        k = torch.cat([kv[:, hs, :dn], k_r[:, None].expand(S, kv[:, hs].shape[1], dr)], -1)
        s = torch.einsum("qhd,khd->hqk", q[:, hs], k) * scale
        s = s.masked_fill(~causal, float("-inf")).softmax(-1)
        out[:, hs] = torch.einsum("hqk,khd->qhd", s, kv[:, hs, dn:])
        del s, k
    return lin(out.reshape(S, H * dv), p["wo"])


def _moe(lin, p: dict, h: torch.Tensor, c: dict) -> torch.Tensor:
    probs = torch.softmax(h @ p["router"].float(), dim=-1)
    gate, idx = torch.topk(probs, c["num_experts_per_tok"], dim=-1)
    if c["norm_topk_prob"]:
        gate = gate / gate.sum(-1, keepdim=True)
    gate = gate * c["routed_scaling_factor"]
    out = _swiglu(lin, h, p["sw1"], p["sw3"], p["sw2"])
    for e in range(c["n_routed_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if not len(tok):
            continue
        y = _swiglu(lin, h[tok], p["w1"][e], p["w3"][e], p["w2"][e])
        out.index_add_(0, tok, y * gate[tok, slot, None])
    return out


def _layers(weights: dict, c: dict):
    """(kind, params of the layer) in order, from the stacked groups."""
    k = c["first_k_dense_replace"]
    runs = ([("dense", k)] if k else []) + [("moe", c["num_hidden_layers"] - k)]
    for gi, (kind, rep) in enumerate(runs):
        g = weights["groups"][gi]["sub0"]
        for i in range(rep):
            yield kind, _index(g, i)


def _index(tree, i):
    return {k: _index(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


@torch.no_grad()
def logits_at(weights: dict, c: dict, seqs: list, want: list,
              precision: str = "f32") -> list:
    """For each token sequence ``seqs[j]`` (a (S,) integer tensor), the
    float32 logits at positions ``want[j]``: a (len(want[j]), vocab) tensor.
    Layer by layer over all the sequences."""
    c = as_run(c)
    lin = _Lin(precision)
    eps = c["rms_norm_eps"]
    with matmul_precision("highest"):
        hs = [weights["embed"][s].float() for s in seqs]
        sizes = [len(s) for s in seqs]
        for kind, p in _layers(weights, c):
            hs = [h + _mla(lin, p["mixer"], rmsnorm(h, p["ln_mixer"], eps), c) for h in hs]
            x = rmsnorm(torch.cat(hs), p["ln_ffn"], eps)  # the FFN is token by token
            if kind == "dense":
                y = _swiglu(lin, x, p["ffn"]["w1"], p["ffn"]["w3"], p["ffn"]["w2"])
            else:
                y = _moe(lin, p["moe"], x, c)
            hs = [h + part for h, part in zip(hs, y.split(sizes))]
        head = weights["lm_head"].float()
        return [rmsnorm(h[w], weights["final_norm"], eps) @ head for h, w in zip(hs, want)]
