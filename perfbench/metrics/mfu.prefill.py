"""Model FLOPs of the prefilled prompts (configuration file: weights x 2
per token, causal attention, the head once) over the prefills' wall time
(each ends on its first token's copy to the host) at the bf16 peak."""
from perfbench import work


def read(m):
    pre = m.rec.get("prefills")
    if not pre:
        return None
    flops = sum(work.prefill_flops(m.cfg, p) for p, _ in pre)
    return 100 * flops / (sum(s for _, s in pre) * work.PEAK_FLOPS[m.cfg["served_dtype"]])
