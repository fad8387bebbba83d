"""Staged sparse calls back to back: the program's ``StagedKernel`` on a
VBR matrix, one call after another, with one scalar read to the host every
``sync_every`` calls, as a convergence check would make.

The configuration's ``model_type`` names the matrix's family: its
``models/<type>.py`` makes the structure and values and hands them to the
program (``structure``, ``values``, ``program_vbr``), its
``reference/<type>.py`` multiplies plainly (``multiply``, ``rel_err``,
``CONTROL``: the next precision down).

Mix parameters: ``kind`` ("spmv" or "spmm"), ``n_cols`` (right-hand
columns, 1 for SpMV), ``prepack`` (values packed once at set-up and the
packed tiles passed to every call, else the raw values go to every call),
``val_pool`` (value arrays of one structure that the calls take in turn),
``x_pool`` (right-hand sides taken in turn), ``sync_every``,
``warmup_calls``, ``trace_s`` (how much of the window a traced run
profiles), ``check_calls`` (calls whose answers are compared, drawn from
the seed).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..harness import family
from ..trace import Profile, span


def run(ctx) -> dict:
    c, mix, dev = ctx.cfg, ctx.mix, ctx.device
    from repro_torch.core.staging import StagingOptions, stage_spmm, stage_spmv

    vbrlib, ref = family(c)

    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    t = time.perf_counter()
    m = vbrlib.structure(c, ctx.seed)
    vals = vbrlib.values(c, m, mix["val_pool"], gen, dev)
    xshape = (c["cols"],) if mix["kind"] == "spmv" else (c["cols"], mix["n_cols"])
    xs = torch.randn((mix["x_pool"],) + xshape, generator=gen, device=dev).to(vals.dtype)
    ctx.sync()
    ctx.part("inputs", time.perf_counter() - t)

    t = time.perf_counter()
    opts = StagingOptions(backend=c["backend"], tile=tuple(c["tile"]), prepack=mix["prepack"])
    pvbr = vbrlib.program_vbr(m, vals[0])
    if mix["kind"] == "spmv":
        kern = stage_spmv(pvbr, opts, device=dev)
    else:
        kern = stage_spmm(pvbr, mix["n_cols"], opts, device=dev)
    operands = [kern.pack(v) for v in vals] if mix["prepack"] else list(vals)
    ctx.sync()
    ctx.part("staging", time.perf_counter() - t)

    t = time.perf_counter()
    for i in range(mix["warmup_calls"]):
        y = kern(operands[i % len(operands)], xs[i % len(xs)])
    float(y.reshape(-1)[0])
    ctx.part("warmup", time.perf_counter() - t)
    rate = mix["warmup_calls"] / max(time.perf_counter() - t, 1e-9)

    # the calls whose answers are compared: drawn from the seed over the
    # calls the window is expected to hold, and the window's last call
    rng = np.random.default_rng(ctx.seed)
    expect = max(int(rate * ctx.seconds * 0.8), mix["check_calls"])
    picks = set(rng.choice(expect, size=mix["check_calls"], replace=False).tolist())
    kept = []

    prof = Profile(dev) if ctx.trace else None
    nv, nx, every = len(operands), len(xs), mix["sync_every"]
    host = host_calls = 0.0
    calls = 0
    if prof:  # started before the window: its start-up is not the window's
        prof.start()
    ctx.window_opens()
    t_open = time.perf_counter()
    while True:
        for _ in range(every):
            a = time.perf_counter()
            with span("call", prof is not None and prof.active):
                y = kern(operands[calls % nv], xs[calls % nx])
            if prof is None or not prof.active:
                host += time.perf_counter() - a
                host_calls += 1
            if calls in picks:
                kept.append((calls, y))
            calls += 1
        float(y.reshape(-1)[0])
        now = time.perf_counter()
        if prof and prof.active and now - t_open >= min(mix["trace_s"], ctx.seconds):
            prof.stop()
        if now - t_open >= ctx.seconds:
            break
    t_close = time.perf_counter()
    kept.append((calls - 1, y))
    if prof and prof.active:
        prof.stop()

    rec = {
        "calls": calls, "window_s": t_close - t_open,
        "host_us_per_call": host / host_calls * 1e6 if host_calls else None,
        "stored": m.stored, "rows": c["rows"], "cols": c["cols"],
        "n_cols": mix["n_cols"], "dtype": c["dtype"],
        "trace": prof.trace if prof else None,
        "memory_peak_bytes": ctx.memory_peak(),
        "attempted": calls,
    }
    ctx.log(f"staged: {calls} calls in {rec['window_s']:.6f} s, stage0 "
            f"{kern.stage0_time:.4f} s, checked {len(kept)} calls")
    del operands, kern

    # the reference, y = A x block by block, once per right-hand side used
    t = time.perf_counter()
    refs = {}
    errs = []
    for i, y in kept:
        key = (i % nv, i % nx)
        if key not in refs:
            refs[key] = ref.multiply(m, vals[key[0]], xs[key[1]])
        errs.append(ref.rel_err(y, refs[key]))
    rec["checks"] = {"max_rel_err": {"value": max(errs), "compared": len(errs), "items": errs}}
    ctx.log(f"reference: {time.perf_counter() - t:.3f} s for {len(refs)} operands")
    if ctx.control:  # the reference in the next precision down, in the program's place
        low = {k: ref.rel_err(ref.multiply(m, vals[k[0]], xs[k[1]], ref.CONTROL), r)
               for k, r in refs.items()}
        items = [low[(i % nv, i % nx)] for i, _ in kept]
        rec["control_checks"] = {"max_rel_err": {"value": max(items), "compared": len(items),
                                                 "items": items}}
    return rec
