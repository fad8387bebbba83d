"""The work counts and the metric readers against hand sums on tiny inputs."""
import json

import pytest

from perfbench import harness, work
from perfbench.tests.conftest import DATA
from perfbench.trace import Trace


def _ds():
    return dict(json.loads((DATA / "deepseek-v2-tiny.json").read_text()), served_dtype="bfloat16")


def test_sparse_counts():
    assert work.sparse_ops(20_000_000, 128) == 5_120_000_000
    assert work.sparse_bytes(20_000_000, 10_000, 10_000, 128, 4) == (20e6 + 2 * 1.28e6) * 4
    # u at n = 128: 3xTF32 operations bound it (0.0310 ms), not bytes (0.0269)
    t = work.roofline_s(work.sparse_ops(20_000_000, 128),
                        work.sparse_bytes(20_000_000, 10_000, 10_000, 128, 4), "float32")
    assert t == pytest.approx(5.12e9 / (494.7e12 / 3))


def test_prefill_flops_by_hand():
    c = _ds()  # d 64, heads 4, q_lora 32, kv_lora 16, nope 16, rope 8, v 16; 1 dense + 2 MoE
    attn = 64 * 32 + 32 * 4 * 24 + 64 * 24 + 16 * 4 * 32 + 4 * 16 * 64
    dense = 3 * 64 * 96
    moe = 3 * 64 * 32 * (2 + 2) + 64 * 8
    P = 10
    per_layer_attn = 2 * (P * (P + 1) / 2) * 4 * (24 + 16)
    want = (2 * (attn + dense) * P + per_layer_attn + 2 * 2 * (attn + moe) * P
            + 2 * per_layer_attn + 2 * 64 * 512)
    assert work.prefill_flops(c, P) == pytest.approx(want)


def test_expert_projection():
    c = _ds()
    ops, nbytes = work.expert_projection(c, assignments=20, experts_hit=5)
    assert ops == 2 * 20 * 64 * 32
    assert nbytes == (5 * 64 * 32 + 20 * (64 + 32)) * 2


def _trace():
    # two calls (spans), K2 and a gather under each; one op outside any span
    spans = {"call": [(0.0, 1.0), (2.0, 3.0)], "prefill": [(2.05, 3.0)]}
    ops = [("bsr_spmm_f32_kernel", 0.5, 1.5, 0.1), ("index_gather", 1.5, 1.6, 0.2),
           ("bsr_spmm_f32_kernel", 2.5, 3.5, 2.1), ("combine_kernel", 3.4, 3.6, 2.2),
           ("other", 4.0, 4.5, 3.5)]
    return Trace(ops, spans, (0.0, 5.0))


def test_trace_masks_and_union():
    tr = _trace()
    assert tr.under("call").tolist() == [True, True, True, True, False]
    assert tr.under("call", "prefill").tolist() == [False, False, True, True, False]
    assert tr.count("call") == 2
    # union: [0.5, 1.6] + [2.5, 3.6] + [4.0, 4.5]
    assert tr.busy_s() == pytest.approx(1.1 + 1.1 + 0.5)
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["bsr_spmm_f32_kernel", pytest.approx(2.0)]
    gaps = dict(bd["idle_gaps"])
    assert gaps["call"] == pytest.approx(0.5)  # [0, 0.5]: a call is open at its start
    assert gaps["no span"] == pytest.approx(0.9 + 0.4 + 0.5)


def _read(name, rec, cfg=None, setup_s=1.0):
    return harness.read_metric(name, harness.MetricInput(rec, cfg or {}, setup_s))


def test_sparse_readers():
    rec = {"trace": _trace(), "stored": 1000, "rows": 100, "cols": 50, "n_cols": 8,
           "dtype": "float32", "calls": 40, "window_s": 2.0, "host_us_per_call": 12.5}
    assert _read("sparse_gflops", rec) == pytest.approx(2 * 1000 * 8 * 40 / 2.0 / 1e9)
    bound = max(2 * 1000 * 8 / (494.7e12 / 3), (1000 + 50 * 8 + 100 * 8) * 4 / 3.35e12)
    k2 = 1.0 + 1.0 + 0.2  # two K2 launches and the combine, all under calls
    assert _read("k2_roofline.spmm", rec) == pytest.approx(100 * 2 * bound / k2)
    assert _read("idle_share.sparse", rec) == pytest.approx(100 * (1 - 2.7 / 5.0))
    assert _read("host_us_per_call.sparse", rec) == 12.5
    # SpMV: everything under a call but K1 is the pack
    rec["trace"] = Trace([("bsr_spmv_kernel", 0.1, 0.2, 0.1), ("index", 0.2, 0.5, 0.15)],
                         {"call": [(0.0, 0.3)]}, (0.0, 1.0))
    assert _read("pack_ms_per_call.spmv", rec) == pytest.approx(0.3e3)
    assert _read("k2_roofline.spmm", {**rec, "trace": None}) is None


def test_serve_readers():
    c = _ds()
    tr = Trace([("bsr_sdd_runs_kernel", 1.0, 1.5, 0.5), ("bsr_sdd_runs_kernel", 1.5, 2.0, 0.6),
                ("bsr_spmm_runs_kernel", 2.0, 2.25, 0.7), ("mla_gemm", 0.2, 0.4, 0.3),
                ("bsr_sdd_runs_kernel", 9.0, 9.5, 8.5)],
               {"prefill": [(0.0, 3.0)], "mla": [(0.25, 0.35)], "decode": [(8.0, 9.6)]},
               (0.0, 10.0))
    rec = {"trace": tr, "routes": [("prefill", 60, 7), ("decode", 6, 5)],
           "prefills": [(30, 0.5), (10, 0.25)], "ttft_s": [0.1 * i for i in range(1, 21)],
           "window_tokens": 300, "window_s": 3.0}
    one = work.roofline_s(*work.expert_projection(c, 60, 7), "bfloat16")
    assert _read("k3_roofline.prefill", rec, c) == pytest.approx(100 * 2 * one / 1.0)
    assert _read("k2_roofline.dsd_prefill", rec, c) == pytest.approx(100 * one / 0.25)
    assert _read("attention_ms.prefill", rec, c) == pytest.approx(0.2e3)
    flops = work.prefill_flops(c, 30) + work.prefill_flops(c, 10)
    assert _read("mfu.prefill", rec, c) == pytest.approx(100 * flops / (0.75 * 989e12))
    assert _read("ttft_p95_ms", rec, c) == pytest.approx(1e3 * (1.9 + 0.05 * 0.1))
    assert _read("tokens_per_s", rec, c) == pytest.approx(100.0)
    assert _read("setup_s", rec, c, setup_s=7.5) == 7.5
