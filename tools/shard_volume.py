"""Bytes each rank sends in the collectives of one training step under
model sharding, worked out from the shapes and the port's use sites
(``src/repro_torch/distributed/ctx.py``, ``models/``, ``train/step.py``,
``optim/adamw.py``)::

    PYTHONPATH=src python tools/shard_volume.py [--mesh 2,4] [--batch 8] [--seq 512]

The mesh is ("pod", "data", "model") with one pod: ``--mesh data,model``.
The batch's rows split over "data", which is also the fsdp axis
(``ParallelConfig``'s defaults). Ring collectives over n ranks on N
elements: all-gather and reduce-scatter send N (n - 1) / n, all-reduce
2 N (n - 1) / n; the one-chunk exchange of a dim split jointly over
(data, model) sends one chunk (on the ranks that exchange: this counts
those). Activations and gathered weights are in the compute dtype
(bfloat16), gradients in bfloat16 (``compress_grads``); the CE's
statistics, the MoE's load-balance sums, the loss and the gradient norm
are float32. Forward and backward (with the weight gradients'
reduce-scatters and dp all-reduces) per layer, in MB a rank.

``ctx.moved_bytes()`` counts the same bytes where the collectives are
issued; ``tests/test_torch_model_sharding.py`` holds ``step_bytes`` to it
on eight gloo ranks at reduced widths.
"""
from __future__ import annotations

import argparse
import math

BYTES = 2  # bfloat16; a float32 element counts as 2 of these
F32 = 2


class Mesh:
    def __init__(self, data: int, model: int):
        self.F, self.M = data, model
        self.dp = data

    @staticmethod
    def ag(n_elems, n):  # all-gather / reduce-scatter of a whole of n_elems
        return n_elems * (n - 1) / n

    def fetch_cols(self, rows, cols, split):
        """A (rows, cols) weight stored P(None, (data, model)), fetched
        whole (split False) or as this model rank's block: (fwd, bwd)."""
        F, M = self.F, self.M
        if cols % (F * M):  # sanitized: replicated, sliced at use
            return 0.0, (rows * cols * (M - 1) / M if split else 0.0)
        if split:
            xchg = rows * cols / (F * M) if F > 1 and M > 1 else 0.0
            return xchg + self.ag(rows * cols / M, F), xchg + self.ag(rows * cols / M, F)
        # whole: gather over model (backward: a slice), then over data
        return self.ag(rows * cols / F, M) + self.ag(rows * cols, F), self.ag(rows * cols, F)

    def fetch_rows(self, rows, cols):
        """A (rows, cols) weight stored P(model, data), fetched as this
        model rank's rows: the gather over data."""
        return self.ag(rows * cols / self.M, self.F), self.ag(rows * cols / self.M, self.F)

    def ar_model(self, n):
        return 2 * self.ag(n, self.M)

    def ar_dp(self, n):
        return 2 * self.ag(n, self.F)


def attention(m: Mesh, cfg, T):
    d, H, Dh, Kv = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.n_kv_heads
    if H % m.M or Kv % m.M:
        raise SystemExit("these shapes run attention whole on each model rank")
    fw = bw = 0.0
    for cols in (H * Dh, Kv * Dh, Kv * Dh):
        f, b = m.fetch_cols(d, cols, True)
        fw, bw = fw + f, bw + b
    f, b = m.fetch_rows(H * Dh, d)
    fw, bw = fw + f + m.ar_model(T * d), bw + b + m.ar_model(T * d)  # row out, model_input
    return fw, bw + m.ar_dp(d)  # the norm's gradient


def mla(m: Mesh, cfg, T):
    d, H, ml = cfg.d_model, cfg.n_heads, cfg.mla
    qk, C, dr = ml.qk_nope_dim + ml.qk_rope_dim, ml.kv_lora_rank, ml.qk_rope_dim
    fw = bw = 0.0
    for rows, cols, split in ((d, ml.q_lora_rank, False), (d, C + dr, False),
                              (ml.q_lora_rank, H * qk, True),
                              (C, H * (ml.qk_nope_dim + ml.v_head_dim), True)):
        if split:
            f, b = m.fetch_cols(rows, cols, True)
        else:  # P(None, data): gathered over data
            f = b = m.ag(rows * cols, m.F)
        fw, bw = fw + f, bw + b
    f, b = m.fetch_rows(H * ml.v_head_dim, d)
    fw = fw + f + m.ar_model(T * d)
    # model_input of cq, the latents and the rope key; the norms' gradients
    bw = bw + b + m.ar_model(T * (ml.q_lora_rank + C + dr)) + m.ar_dp(d + ml.q_lora_rank + C)
    return fw, bw


def dense_ffn(m: Mesh, d, f, T):
    fw = bw = 0.0
    for _ in range(2):  # w1, w3
        a, b = m.fetch_cols(d, f, True)
        fw, bw = fw + a, bw + b
    a, b = m.fetch_rows(f, d)
    return fw + a + m.ar_model(T * d), bw + b + m.ar_model(T * d)


def sable_ffn(m: Mesh, cfg, T):
    from repro_torch.models.layers import sable_patterns

    pats = sable_patterns(cfg)
    p_in, p_out = pats["in"], pats["out"]
    for p in (p_in, p_out):
        if p.n_tiles % m.M:
            raise SystemExit("these shapes run the SABLE FFN whole on each model rank")
    d, f = cfg.d_model, cfg.d_ff
    h = T * f
    rs = 2 * m.ag(h, m.M)  # w1, w3 partial sums reduce-scattered
    fw = rs + m.ag(h, m.M) + m.ar_model(T * d)  # h gathered for w2; w2's all-reduce
    bw = rs + m.ag(h, m.M) + m.ar_model(T * d)  # their transposes; model_input(x)
    tiles = (2 * p_in.n_tiles + p_out.n_tiles) / m.M * p_in.tm * p_in.tk
    return fw, bw + m.ar_dp(tiles) + m.ar_dp(d)  # the tiles are not fsdp-split


def moe(m: Mesh, cfg, B, S, dropless):
    mc, d = cfg.moe, cfg.d_model
    E, f, k = mc.num_experts, mc.d_ff, mc.top_k
    T = B * S / m.dp
    G = B / m.dp
    fw = bw = 0.0
    w = E * d * f
    if dropless:  # every expert gathered whole on each rank
        for _ in range(3):  # over model (backward: a slice), then over data
            fw += m.ag(w / m.F, m.M) + m.ag(w, m.F)
            bw += m.ag(w, m.F)
    else:
        if E % m.M:
            raise SystemExit("the experts do not split over the model axis")
        C = max(8, -(-math.ceil(S * k / E * mc.capacity_factor) // 8) * 8)
        buf = G * E * C * d
        for _ in range(3):  # this rank's experts, gathered over data
            fw, bw = fw + m.ag(w / m.M, m.F), bw + m.ag(w / m.M, m.F)
        fw += m.ag(buf, m.M)  # the expert outputs back to the data shards
        bw += m.ag(buf, m.M)  # the split buffer's gradient
    fw += 2 * m.ar_dp(E) * F32  # the aux loss's sums of probs and counts
    sf = (mc.shared_d_ff or f) * mc.num_shared
    a, b = dense_ffn(m, d, sf, T)
    return fw + a, bw + b + m.ar_dp(d * E + d)  # the router's and the norm's gradients


def head(m: Mesh, cfg, T):
    d, V = cfg.d_model, cfg.vocab_size
    if V % m.M:
        return 0.0, 0.0
    a, b = m.fetch_rows(V, d)  # embed P(model, data): vocab-parallel rows
    c, e = m.fetch_cols(d, V, True)  # lm_head P(None, (data, model))
    ce = 3 * m.ar_model(T) * F32  # max, sum of exps, gold
    return a + c + m.ar_model(T * d) + ce, b + e + m.ar_model(T * d)


def step_rest(m: Mesh, cfg):
    """The final norm's gradient, the loss's sum over the data shards and
    the gradient norm's sums over each mesh dim."""
    return 0.0, m.ar_dp(cfg.d_model) + (m.ar_dp(1) + m.ar_dp(1) + m.ar_model(1)) * F32


def layer_rows(m: Mesh, cfg, B, S) -> list:
    """[(layer, (fwd, bwd))] for one step of ``cfg``'s decoder, in units of
    ``BYTES``: one row a sub-layer, then the embedding and head, then the
    rest of the step."""
    T = B * S / m.dp
    rows = []
    for g in cfg.groups:
        for _ in range(g.repeat):
            for spec in g.layers:
                if spec.mixer == "gqa":
                    rows.append(("attention (GQA, heads split)", attention(m, cfg, T)))
                elif spec.mixer == "mla":
                    rows.append(("attention (MLA, heads split)", mla(m, cfg, T)))
                else:
                    raise SystemExit(f"a {spec.mixer} mixer runs whole on each model rank")
                if spec.ffn == "moe":
                    path = "dropless (experts gathered)" if cfg.moe.dropless else "capacity (EP)"
                    rows.append((f"MoE, {path}", moe(m, cfg, B, S, cfg.moe.dropless)))
                elif cfg.sable is not None:
                    rows.append(("FFN (SABLE, tile list split)", sable_ffn(m, cfg, T)))
                else:
                    fw, bw = dense_ffn(m, cfg.d_model, cfg.d_ff, T)
                    rows.append(("FFN (dense)", (fw, bw + m.ar_dp(cfg.d_model))))
    rows.append(("embed + head + CE (vocab split)", head(m, cfg, T)))
    rows.append(("final norm, loss, grad norm", step_rest(m, cfg)))
    return rows


def step_bytes(cfg, data: int, model: int, batch: int, seq: int) -> float:
    """Bytes a rank sends in one train step of ``cfg`` on a (1, data,
    model) mesh."""
    return BYTES * sum(fw + bw for _, (fw, bw) in layer_rows(Mesh(data, model), cfg, batch, seq))


def main(argv=None):
    import dataclasses

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", default="2,4", help="data,model (one pod)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.configs import llama3_8b

    m = Mesh(*(int(v) for v in args.mesh.split(",")))
    B, S = args.batch, args.seq
    mb = 1e6 / BYTES
    print(f"mesh (pod, data, model) = (1, {m.F}, {m.M}); batch {B} x {S}: {B * S // m.dp} "
          f"tokens a rank; MB a rank, forward / backward")
    ds = get_config("deepseek-v2-236b")
    for cfg in (llama3_8b.full_sable(), ds,
                dataclasses.replace(ds, moe=dataclasses.replace(ds.moe, dropless=True))):
        seen = set()
        for layer, (fw, bw) in layer_rows(m, cfg, B, S):
            if layer not in seen:
                seen.add(layer)
                print(f"{cfg.name:18s} {layer:34s} {fw / mb:10.1f} / {bw / mb:10.1f}")
        print(f"{cfg.name:18s} {'the whole step':34s} "
              f"{step_bytes(cfg, m.F, m.M, B, S) / 1e6:23.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
