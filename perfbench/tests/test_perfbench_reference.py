"""The plain references agree with a tiny run of the program on the CPU."""
import json

import numpy as np
import pytest
import torch

from perfbench.drivers.closed_loop import gaps
from perfbench.models import deepseek_v2 as dsmodel
from perfbench.models import vbr as vbrmodel
from perfbench.reference import deepseek_v2 as dsref
from perfbench.reference import vbr as vbrref
from perfbench.tests.conftest import DATA, ROOT


def _json(name):
    return json.loads((DATA / name).read_text())


@pytest.mark.parametrize("n_cols", [None, 8])
def test_vbr_reference_matches_the_program(n_cols):
    from repro_torch.core.staging import StagingOptions, stage_spmm, stage_spmv

    c = _json("table1-tiny.json")
    m = vbrmodel.structure(c, 2**31 + 99)
    gen = torch.Generator().manual_seed(5)
    val = vbrmodel.values(c, m, 1, gen, "cpu")[0]
    x = torch.randn((c["cols"],) if n_cols is None else (c["cols"], n_cols), generator=gen)
    pv = vbrmodel.program_vbr(m, val)
    opts = StagingOptions(backend="cuda", tile=(32, 32))
    kern = (stage_spmv(pv, opts, device="cpu") if n_cols is None
            else stage_spmm(pv, n_cols, opts, device="cpu"))
    y = kern(val, x)
    ref = vbrref.multiply(m, val, x)
    assert vbrref.rel_err(y, ref) < 1e-6
    # the same structure as the program's synthesizer draws for the seed
    dense = np.zeros(m.shape, np.float32)
    for a in range(len(m.rpntr) - 1):
        for bi in range(m.bpntrb[a], m.bpntre[a]) if m.bpntrb[a] >= 0 else ():
            dense[m.rpntr[a]:m.rpntr[a + 1], m.cpntr[m.bindx[bi]]:m.cpntr[m.bindx[bi] + 1]] = 1
    assert m.stored == int(dense.sum())
    # TF32 (emulated here) is far off float32
    assert vbrref.rel_err(vbrref.multiply(m, val, x, "tf32"), ref) > 1e-5


def test_vbr_structure_is_the_papers():
    from repro_torch.core.vbr import synthesize_paper

    c = {"rows": 1000, "cols": 1000, "row_splits": 10, "col_splits": 10, "num_blocks": 30,
         "uniform": True}
    want = synthesize_paper(10, 10, 30, zeros_pct=20, seed=11, rows=1000, cols=1000)
    got = vbrmodel.structure(c, 11)
    for k in ("rpntr", "cpntr", "bindx", "bpntrb", "bpntre", "indx"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k


def test_deepseek_reference_matches_prefill_and_decode():
    from repro_torch.models.transformer import decode_step, init_cache, prefill

    c = dict(_json("deepseek-v2-tiny.json"), served_dtype="float32")
    cfg = dsmodel.model_config(c)
    w = dsmodel.make_weights(c, 2**33 + 1, "cpu")
    toks = torch.randint(0, c["vocab_size"], (1, 12), generator=torch.Generator().manual_seed(0))
    cache = init_cache(cfg, 1, 16, device="cpu")
    got = [prefill(w, cfg, toks, cache)[0][0, -1]]
    seq = toks[0].tolist()
    for pos in range(12, 15):
        nxt = int(got[-1].argmax())
        seq.append(nxt)
        got.append(decode_step(w, cfg, torch.tensor([[nxt]]), cache, pos)[0][0, 0])
    want = dsref.logits_at(w, c, [torch.tensor(seq[:15])], [torch.arange(11, 15)])[0]
    got = torch.stack(got).float()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    served = got.argmax(-1)
    assert gaps(want, served).max() < 1e-4
    low = dsref.logits_at(w, c, [torch.tensor(seq[:15])], [torch.arange(11, 15)], "fp8")[0]
    assert (low - want).abs().max() > 1e-3 * want.abs().max()


def test_deepseek_builder_refuses_what_the_port_cannot_run():
    c = _json("deepseek-v2-tiny.json")
    with pytest.raises(ValueError, match="routed_scaling_factor"):
        dsmodel.model_config(dict(c, routed_scaling_factor=16))
    # the cell's file keeps DeepSeek-V2's published routing and RoPE, and
    # runs the keys of its ``as_run``; without them it is refused
    cell = json.loads((ROOT / "perfbench/configs/deepseek-v2-l5-dropless.json").read_text())
    assert (cell["topk_method"], cell["n_group"], cell["topk_group"]) == (
        "group_limited_greedy", 8, 3)
    assert cell["routed_scaling_factor"] == 16 and cell["rope_scaling"]["type"] == "yarn"
    cfg = dsmodel.model_config(cell)
    assert cfg.moe.top_k == 6 and cfg.moe.num_experts == 160 and cfg.moe.dropless
    run = dsref.as_run(cell)
    assert (run["n_group"], run["routed_scaling_factor"], run["norm_topk_prob"]) == (1, 1.0, True)
    with pytest.raises(ValueError, match="greedily"):
        dsref.as_run(dict(cell, as_run={}))
