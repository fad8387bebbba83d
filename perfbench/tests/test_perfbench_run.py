"""Whole runs of the tiny cells on the CPU: the result line's keys, the
comparison with the reference, the control, and the timed path broken
underneath (each fault must make ``correct`` come out false)."""
import importlib
import inspect
import json
import subprocess
import sys
import types

import pytest
import torch

from perfbench import harness
from perfbench.tests.conftest import ROOT, tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]
SEED = 2**31 + 2**20 + 3  # over 32 signed bits, as the benchmark's seeds may be


def _run(name, trace=False, control=False, cell=None):
    return harness.run_cell(cell or tiny_cell(name), SEED, 0.3, trace, "cpu", control=control,
                            log=lambda s: None)


@pytest.mark.parametrize("name", ["u-tiny", "v-tiny", "ds-tiny"])
def test_result_line_has_the_contracts_keys(name):
    out = _run(name)[0]
    assert list(out) == KEYS
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    want = {m["name"] for m in tiny_cell(name).metrics(False)}
    assert set(out["metrics"]) == want and "setup_s" in want
    for c in out["check"].values():
        assert c["value"] <= c["limit"] and c["compared"] > 0
    json.dumps(out)


def test_traced_run_adds_the_window_and_breakdown():
    out = _run("u-tiny", trace=True)[0]
    assert list(out) == KEYS[:5] + ["breakdown", "check"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name,limits", [("u-tiny", "u-spmm-packed"), ("v-tiny", "u-spmv-newvals"),
                                         ("ds-tiny", None)])
def test_control_in_lower_precision_fails(name, limits):
    """The reference in the next precision down (TF32 for float32, fp8 for
    the model) put in the program's place comes out not correct by the
    harness's own comparison, while the program's run is correct. The
    sparse calls are held to their cell's own limit, since their error does
    not grow with size; the tiny model, served in float32 here, to its own
    limit 0.002, set from its readings on the CPU (program 0.0 on 15 seeds,
    control 0.0046-0.0194 on 7)."""
    cell = tiny_cell(name)
    if limits:
        cell.limits = json.loads((ROOT / f"perfbench/limits/{limits}.json").read_text())
    out, rec = _run(name, control=True, cell=cell)
    assert out["correct"] is False and out["failed"] > 0
    (key, c), = out["check"].items()
    assert c["value"] > c["limit"] == cell.limits[key]
    assert harness.judge(rec["checks"], cell.limits)[0] is True


def _stub(name: str, real, calls: list):
    """A module ``name`` that hands every function on to ``real``'s and
    records the call."""
    mod = types.ModuleType(name)
    for k, v in vars(real).items():
        if k.startswith("__"):
            continue
        if inspect.isfunction(v) and v.__module__ == real.__name__:
            def counted(*a, _fn=v, _k=k, **kw):
                calls.append(_k)
                return _fn(*a, **kw)
            v = counted
        setattr(mod, k, v)
    return mod


@pytest.mark.parametrize("name,real,want", [
    ("ds-tiny", "deepseek_v2", {"model_config", "make_weights", "logits_at"}),
    ("u-tiny", "vbr", {"structure", "values", "program_vbr", "multiply"})])
def test_a_family_is_found_by_its_model_type(monkeypatch, name, real, want):
    """A configuration's ``model_type`` picks ``models/<type>.py`` and
    ``reference/<type>.py``: a family that is nothing but two new modules
    (here stubs that hand on to an existing family's) runs through the
    drivers unchanged, traced, and is the one called."""
    calls = []
    for side in ("models", "reference"):
        real_mod = importlib.import_module(f"perfbench.{side}.{real}")
        monkeypatch.setitem(sys.modules, f"perfbench.{side}.stub_family",
                            _stub(f"perfbench.{side}.stub_family", real_mod, calls))
    cell = tiny_cell(name)
    cell.cfg = dict(cell.cfg, model_type="stub_family")
    out = _run(name, trace=True, cell=cell)[0]
    assert out["correct"] is True and out["metrics"]
    assert want <= set(calls)


def _broken_call(fault):
    from repro_torch.core import staging

    orig = staging.StagedKernel.__call__

    def call(self, val, x):
        y = orig(self, val, x).clone()
        if fault == "answer":
            y.view(-1)[7] += 0.5
        else:  # half of the rows left out
            y[: y.shape[0] // 2] = 0
        return y
    return staging.StagedKernel, "__call__", call


def _broken_serve(fault):
    from repro_torch.models import attention
    from repro_torch.serve import scheduler

    if fault == "token":
        orig = scheduler.lane_step

        def lane_step(*a, **k):
            nxt, rows, slices = orig(*a, **k)
            nxt = nxt.clone()
            nxt[0] = (nxt[0] + 1) % rows.shape[-1]
            return nxt, rows, slices
        return scheduler, "lane_step", lane_step
    orig = attention.write_cache

    def write_cache(cache, new, cache_pos, S):  # a decode step leaves the cache unchanged
        if S > 1:
            orig(cache, new, cache_pos, S)
    return attention, "write_cache", write_cache


@pytest.mark.parametrize("name,fault", [("u-tiny", "answer"), ("u-tiny", "half"),
                                        ("v-tiny", "answer"), ("ds-tiny", "token"),
                                        ("ds-tiny", "state")])
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    target = _broken_call(fault) if name != "ds-tiny" else _broken_serve(fault)
    monkeypatch.setattr(*target)
    out = _run(name)[0]
    assert out["correct"] is False and out["failed"] > 0


def test_without_a_card_it_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, str(ROOT / "perfbench/run.py"), "--workload",
                        "u-spmm-packed", "--seed", "1", "--seconds", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.requires_cuda
def test_cell_on_the_card_is_correct():
    p = subprocess.run([sys.executable, str(ROOT / "perfbench/run.py"), "--workload",
                        "u-spmm-packed", "--seed", str(SEED), "--seconds", "2", "--trace", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
