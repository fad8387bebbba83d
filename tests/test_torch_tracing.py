"""The port's spans and router counter (``repro_torch.tracing``) on the CPU.

Off, a span is one shared no-op and the profiler sees none of the program's
ranges; on, a tiny MLA + dropless-MoE model served through the scheduler
and a tiny staged SpMV and SpMM show each span nested in the one it belongs
to, and the router's counts of each MoE call equal the ones perfbench's
closed loop takes by wrapping the router.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs this file beside the JAX suites

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.configs import deepseek_v2_236b  # noqa: E402
from repro_torch.core import vbr as tvbr  # noqa: E402
from repro_torch.core.staging import StagingOptions, stage_spmm, stage_spmv  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
MOE_PARTS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine", "moe.shared")


@pytest.fixture(autouse=True)
def _tracing_restored():
    """Every test leaves the program's tracing as it found it."""
    was = tracing.is_enabled()
    yield
    tracing.enable(was)
    tracing.routes.clear()


@pytest.fixture(scope="module")
def engine():
    base = deepseek_v2_236b.reduced()
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, dropless=True))
    params = init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    return ServeEngine(cfg, params, max_len=32, autotune_sparse=False, device=CPU)


@pytest.fixture(scope="module")
def staged():
    v = tvbr.synthesize_paper(6, 5, 12, zeros_pct=20, uniform=False, seed=3, rows=64, cols=48)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(v.shape[1]).astype(np.float32)
    X = rng.standard_normal((v.shape[1], 4)).astype(np.float32)
    opts = StagingOptions(backend="cuda", tile=(8, 16))
    return [(stage_spmv(v, opts, device=CPU), v.val, x),
            (stage_spmm(v, 4, opts, device=CPU), v.val, X)]


def _serve_two_steps(engine):
    """A scheduler that prefills two requests in its first step, then
    decodes them in that step and the next."""
    sched = engine.make_scheduler(max_batch=2, page_size=4)
    rng = np.random.default_rng(1)
    for n in (9, 6):
        sched.submit(rng.integers(0, 512, size=n).astype(np.int32), 3)
    sched.step()
    sched.step()
    return sched


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith(tracing.PREFIX)]


def _ranges(events, name):
    return [(a, b) for n, a, b in events if n == tracing.PREFIX + name]


def _nested(events, child, *parents) -> bool:
    """Every ``child`` range lies inside a range of one of ``parents``, and
    each of ``parents`` holds at least one."""
    outer = {p: _ranges(events, p) for p in parents}
    inner = _ranges(events, child)

    def within(s, t, p):
        return any(a <= s and t <= b for a, b in outer[p])

    return (all(any(within(s, t, p) for p in parents) for s, t in inner)
            and all(any(within(s, t, p) for s, t in inner) for p in parents))


def test_off_a_span_is_one_shared_no_op_and_the_profiler_sees_none(engine, staged):
    tracing.enable(False)
    assert tracing.span("sched.step") is tracing.span("moe.route")
    with tracing.span("attn"), tracing.span("attn"):  # reentrant
        pass

    def work():
        _serve_two_steps(engine)
        for kern, val, x in staged:
            kern(val, x)

    assert _profiled(work) == []
    assert tracing.routes == []


def test_on_the_spans_nest_where_the_work_happens(engine, staged):
    tracing.enable(True)
    ev = _profiled(lambda: _serve_two_steps(engine))
    for child, *parents in [("sched.prefill", "sched.step"), ("sched.decode", "sched.step"),
                            ("model.prefill", "sched.prefill"), ("model.decode", "sched.decode"),
                            ("attn", "model.prefill", "model.decode"),
                            ("moe", "model.prefill", "model.decode"),
                            ("sched.to_host", "sched.prefill", "sched.decode"),
                            ("kv.write", "sched.prefill", "sched.decode"),
                            ("kv.gather", "sched.decode")]:
        assert _nested(ev, child, *parents), (child, parents)
    for part in MOE_PARTS:
        assert _nested(ev, part, "moe"), part
    # a prefill a request, a decode step in each step, a read to the host
    # in each of those, 2 MoE layers a forward and a route counted in each
    assert len(_ranges(ev, "sched.prefill")) == len(_ranges(ev, "sched.decode")) == 2
    assert len(_ranges(ev, "sched.to_host")) == 4
    assert len(_ranges(ev, "moe")) == 2 * 4 == len(tracing.routes)

    def staged_calls():
        for kern, val, x in staged:
            kern(val, x)
    ev = _profiled(staged_calls)
    assert len(_ranges(ev, "staged.call")) == len(_ranges(ev, "staged.kernel")) == 2
    for child in ("staged.pack", "staged.kernel"):
        assert _nested(ev, child, "staged.call"), child


def test_turned_off_again_nothing_is_recorded(engine, staged):
    tracing.enable(True)
    _serve_two_steps(engine)
    assert tracing.routes
    tracing.enable(False)
    tracing.routes.clear()

    def work():
        _serve_two_steps(engine)
        staged[0][0](*staged[0][1:])

    assert _profiled(work) == [] and tracing.routes == []
    tracing.enable(True)  # turning on starts a fresh record
    assert tracing.routes == []


def test_router_counts_match_the_closed_loops_wrap(monkeypatch):
    """perfbench's ``ds-tiny`` cell traced, with the program's tracing on
    exactly while perfbench's profiler runs: each MoE call's (assignments,
    experts hit) from ``tracing.routes`` equals perfbench's own wrap of the
    router (``rec["routes"]``), call for call. An untraced run records
    nothing."""
    sys.path[:0] = [str(ROOT)]
    from perfbench import harness
    from perfbench.tests.conftest import tiny_cell
    from perfbench.trace import Profile

    start, stop = Profile.start, Profile.stop

    def traced_start(self):
        start(self)
        tracing.enable(True)

    def traced_stop(self):
        tracing.enable(False)
        stop(self)

    monkeypatch.setattr(Profile, "start", traced_start)
    monkeypatch.setattr(Profile, "stop", traced_stop)
    seed = 2**31 + 2**20 + 3
    out, rec = harness.run_cell(tiny_cell("ds-tiny"), seed, 0.3, True, "cpu",
                                log=lambda s: None)
    assert out["correct"] is True and rec["routes"]
    mine = [(int(c.sum()), int((c.sum(0) > 0).sum())) for c in tracing.routes]
    assert mine == [(a, hit) for _, a, hit in rec["routes"]]

    tracing.routes.clear()
    out, rec = harness.run_cell(tiny_cell("ds-tiny"), seed, 0.3, False, "cpu",
                                log=lambda s: None)
    assert out["correct"] is True and not tracing.is_enabled() and tracing.routes == []
