#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N] [--reps N] [--verbose-build]

Phases, each printing its lines:

1. build    builds the CUDA kernels K1 (bsr_spmv), K2 (bsr_spmm) and K3
            (bsr_sdd) from src/repro_torch/kernels/csrc and prints the build
            time;
2. kernels  holds K1 and K2 against their plain PyTorch versions on random
            sorted tile tables (empty row tiles, n not a multiple of bn,
            odd tiles, float32 and bfloat16);
3. main     drives the port's first path, stage_spmv and stage_spmm
            (n = 128) through the 'cuda' backend, on the paper's
            10 000 x 10 000 matrices <50,50,500,u> and <100,100,500,nu>
            with 20% in-block zeros, in float32 and bfloat16. The launch
            counts are zeroed just before and read just after; each kernel
            must have launched. The outputs are held against the 'grouped'
            backend and a dense product, both in float32 with TF32 off, on
            the inputs the kernels saw;
4. times    medians of CUDA-event timings of each kernel, its plain version
            and torch.sparse_bsr_tensor(...) @ x on the main path's tables,
            each kernel's bound, and each staged fn(val, x), prepacked and
            not;
5. sdd      holds K3 against its plain version on odd shapes (bm = 8 and
            others, bn not a multiple of 128, K not a multiple of 32,
            padding slots, b as a strided expert stack), float32 and
            bfloat16;
6. moe      drives the port's second path: DeepSeek-V2-236B's MoE layer at
            its published widths (d_model 5120, 160 routed experts of
            d_ff 1536, top-6, 2 shared experts, swiglu), dropless, params
            in bfloat16 from --seed, through moe_apply at prefill (B=4,
            S=512) and decode (B=64, S=1). The launch counts are zeroed just
            before and read just after; K3 and K2 must have launched. The
            output is held against the capacity path (plain einsums) with
            capacity_factor = E / top_k, which drops nothing, and K3 on the
            path's own prefill tables against its plain version on 64
            sampled slots;
7. moe times  the MoE layer's time (prefill, decode); K3 at the prefill
            tables beside its bound, its plain version on the 64-slot sample
            and torch.sparse.sampled_addmm over the topology's element-level
            CSR (float32); K2 at the dsd shapes (tm=8, tk=1536, n=5120).

Tolerance: max|out - ref| / max|ref| <= 1e-5 in float32, 2e-2 in bfloat16.
Any failure raises. The last two lines are the `kernels` JSON object and
{"ok": true, "device": {...}}. Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"torch.float32": 67e12, "torch.bfloat16": 989e12}
TOL = {"torch.float32": 1e-5, "torch.bfloat16": 2e-2}

KERNELS = {
    "bsr_spmv": ("src/repro_torch/kernels/csrc/bsr_spmv.cu", "src/repro/kernels/bsr_spmv.py:39"),
    "bsr_spmm": ("src/repro_torch/kernels/csrc/bsr_spmm.cu", "src/repro/kernels/bsr_spmm.py:49"),
    "bsr_sdd": ("src/repro_torch/kernels/csrc/bsr_sdd.cu", "src/repro/kernels/bsr_ops.py:94"),
}


def rel_err(out, ref) -> tuple[float, float]:
    """(max abs error, that error over max|ref|), both in float32."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30)


def check(label: str, out, ref, dtype) -> float:
    err, rel = rel_err(out, ref)
    tol = TOL[str(dtype)]
    ok = rel <= tol
    print(f"  {label}: max_abs_err={err:.3e} rel={rel:.3e} tol={tol:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: relative error {rel:.3e} above {tol:g}")
    return err


def median_ms(fn, reps: int) -> float:
    """Median of per-call CUDA-event times, after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def random_tables(rng, n_row_tiles, n_col_tiles, nb, tm, tk, empty_rows):
    """Sorted tile tables; the first ``empty_rows`` row tiles of a shuffled
    order get no tile. Returns numpy (tiles, row_ids, col_ids)."""
    import numpy as np

    live = rng.permutation(n_row_tiles)[empty_rows:]
    rows = np.sort(np.concatenate([live, rng.choice(live, nb - len(live))])).astype(np.int32)
    cols = rng.integers(0, n_col_tiles, nb).astype(np.int32)
    tiles = rng.standard_normal((nb, tm, tk)).astype(np.float32)
    return tiles, rows, cols


def phase_kernels(rng, torch, kops, kref):
    print("phase 2: kernels vs plain versions on the card")
    cases = [  # (tm, tk, n, bn, dtype)
        (32, 32, 128, 128, torch.float32),
        (32, 32, 100, 128, torch.bfloat16),
        (8, 128, 70, 64, torch.float32),
        (5, 7, 33, 32, torch.float32),
        (16, 12, 6, 128, torch.bfloat16),
        (40, 3, 129, 128, torch.float32),
        (1, 1, 1, 128, torch.float32),
    ]
    dev = torch.device("cuda")
    for tm, tk, n, bn, dtype in cases:
        n_rt, n_ct = 23, 9
        tiles, rows, cols = random_tables(rng, n_rt, n_ct, 60, tm, tk, empty_rows=4)
        t = torch.as_tensor(tiles, device=dev).to(dtype)
        r = torch.as_tensor(rows, device=dev)
        c = torch.as_tensor(cols, device=dev)
        x = torch.as_tensor(rng.standard_normal(n_ct * tk), device=dev).to(dtype)
        xm = torch.as_tensor(rng.standard_normal((n_ct * tk, n)), device=dev).to(dtype)
        m_pad = n_rt * tm
        y = kops.bsr_spmv(t, r, c, x, m_pad=m_pad, device=dev)
        ym = kops.bsr_spmm(t, r, c, xm, m_pad=m_pad, bn=bn, device=dev)
        torch.cuda.synchronize()
        tag = f"tm={tm} tk={tk} n={n} bn={bn} {str(dtype)[6:]}"
        check(f"bsr_spmv {tag}", y, kref.bsr_spmv_ref(t, r, c, x, m_pad), dtype)
        check(f"bsr_spmm {tag}", ym, kref.bsr_spmm_ref(t, r, c, xm, m_pad), dtype)


def bound_ms(nbytes: int, ops: int, dtype) -> tuple[float, str]:
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the dtype's peak, whichever is larger."""
    return max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
               (ops / PEAK_OPS_PER_S[str(dtype)] * 1e3, "operations"))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_sdd(rng, torch, kops, kref):
    import numpy as np

    print("phase 5: K3 (bsr_sdd) vs its plain version on the card")
    cases = [  # (bm, bn, K, dtype)
        (8, 200, 45, torch.float32),
        (8, 200, 45, torch.bfloat16),
        (8, 1536, 5120, torch.bfloat16),
        (8, 96, 1000, torch.float32),
        (3, 7, 1, torch.float32),
        (20, 130, 33, torch.bfloat16),
        (40, 64, 96, torch.float32),
        (1, 1, 1, torch.bfloat16),
    ]
    dev = torch.device("cuda")
    for bm, bn, K, dtype in cases:
        n_rb, n_cb, nnz, pad = 9, 7, 20, 3
        # sorted slots, then padding slots clamped to (n_rb - 1, 0) as sdd passes them
        rows = np.concatenate([np.sort(rng.integers(0, n_rb, nnz)), np.full(pad, n_rb - 1)])
        cols = np.concatenate([rng.integers(0, n_cb, nnz), np.zeros(pad)])
        r = torch.as_tensor(rows.astype(np.int32), device=dev)
        c = torch.as_tensor(cols.astype(np.int32), device=dev)
        a = torch.as_tensor(rng.standard_normal((n_rb * bm, K)), device=dev).to(dtype)
        w = torch.as_tensor(rng.standard_normal((n_cb, K, bn)), device=dev).to(dtype)
        stacked = w.permute(1, 0, 2).reshape(K, n_cb * bn)
        want = kref.bsr_sdd_ref(a, stacked, r, c, bm, bn)
        tag = f"bm={bm} bn={bn} K={K} {str(dtype)[6:]}"
        for layout, b in (("stacked", stacked), ("expert stack view", w.permute(1, 0, 2))):
            out = kops.bsr_sdd(a, b, r, c, bm=bm, bn=bn, device=dev)
            torch.cuda.synchronize()
            check(f"bsr_sdd {tag} ({layout}, {pad} padding slots)", out, want, dtype)


def moe_configs():
    from repro_torch.configs.deepseek_v2_236b import full

    cfg = full()
    mc = cfg.moe
    dropless = replace(cfg, moe=replace(mc, dropless=True))
    # capacity_factor = E / top_k gives C >= tokens per group: nothing drops
    capacity = replace(cfg, moe=replace(mc, capacity_factor=mc.num_experts / mc.top_k))
    return dropless, capacity


def sdd_tables(tmoe, p, x, cfg):
    """K3's operands on the dropless path, as moe_apply builds them: the
    (G*E*C, d) buffer, the topology, and the coordinates sdd passes (padding
    slots clamped)."""
    r = tmoe._route(p, x, cfg)
    buf = tmoe._dispatch(x, r, cfg)
    topo = tmoe._dropless_topology(r.counts, r.C, r.Tg, cfg, cfg.moe.d_ff)
    rows = topo.row_indices.clamp(max=topo.n_block_rows - 1)
    cols = topo.column_indices.clamp(max=topo.n_block_cols - 1)
    return buf.reshape(-1, x.shape[-1]), topo, rows, cols


def phase_moe(args, torch, kops, kref):
    from repro_torch.models import moe as tmoe

    print("phase 6: DeepSeek-V2-236B MoE layer at full width, dropless (bfloat16)")
    cfg, cfg_cap = moe_configs()
    mc = cfg.moe
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    p = tmoe.moe_init(gen, cfg, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    print(f"  params: {nbytes(*p.values()) / 1e9:.3f} GB in bfloat16, drawn in "
          f"{time.perf_counter() - t0:.2f} s (d_model={cfg.d_model} experts={mc.num_experts} "
          f"top_k={mc.top_k} d_ff={mc.d_ff} shared={mc.num_shared}x{mc.shared_d_ff})")
    xs = {
        name: torch.randn((B, S, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
        for name, (B, S) in (("prefill", (4, 512)), ("decode", (64, 1)))
    }
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()
    outs = {name: tmoe.moe_apply(p, x, cfg) for name, x in xs.items()}
    torch.cuda.synchronize()
    launches = dict(kops.launches)
    print(f"  launches on the MoE path: {launches}")
    for name in ("bsr_sdd", "bsr_spmm"):
        if launches[name] == 0:
            raise AssertionError(f"MoE path never launched {name}")
    print(f"  peak device memory (dropless): {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")

    for name, x in xs.items():
        y, aux = outs[name]
        if tuple(y.shape) != tuple(x.shape) or not torch.isfinite(y.float()).all():
            raise AssertionError(f"{name}: output {tuple(y.shape)} is not finite of the "
                                 f"input's shape {tuple(x.shape)}")
        y_cap, aux_cap = tmoe.moe_apply(p, x, cfg_cap)
        check(f"moe {name} B,S={tuple(x.shape[:2])} dropless vs capacity path", y, y_cap,
              torch.bfloat16)
        check(f"moe {name} aux loss dropless vs capacity path (float32)", aux, aux_cap,
              torch.float32)
        print(f"  moe {name}: aux={float(aux):.6f} |y|max={float(y.abs().max()):.4f}")
        del y_cap
    print(f"  peak device memory (with the capacity path): "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")

    a, topo, rows, cols = sdd_tables(tmoe, p, xs["prefill"], cfg)
    n_valid = int(topo.n_blocks)
    pick = torch.cat([torch.randperm(n_valid, generator=gen, device=dev)[:60],
                      torch.arange(n_valid, topo.nnz_max, device=dev)[:4]])
    w1 = p["w1"].permute(1, 0, 2)
    bm, bn = topo.block
    out = kops.bsr_sdd(a, w1, rows[pick], cols[pick], bm=bm, bn=bn, device=dev)
    want = kref.bsr_sdd_ref(a, w1, rows[pick], cols[pick], bm, bn)
    check(f"bsr_sdd on the prefill path's tables ({len(pick)} sampled slots of "
          f"{topo.nnz_max}, {n_valid} valid)", out, want, torch.bfloat16)
    return tmoe, p, xs, cfg, cfg_cap, launches


def phase_moe_times(args, torch, kops, kref, tmoe, p, xs, cfg, cfg_cap):
    from repro_torch.kernels import _build, bsr_ops

    print(f"phase 7: MoE times (median of {args.reps} calls, CUDA events)")
    dev = torch.device("cuda")
    ext = _build.load_kernels()
    for name, x in xs.items():
        ms = median_ms(lambda: tmoe.moe_apply(p, x, cfg), args.reps)
        cap_ms = median_ms(lambda: tmoe.moe_apply(p, x, cfg_cap), args.reps)
        print(f"  moe_apply {name} B,S={tuple(x.shape[:2])}: dropless ms={ms:.4f} "
              f"capacity-path ms={cap_ms:.4f}")
        device_breakdown(torch, f"moe_apply {name} dropless", lambda: tmoe.moe_apply(p, x, cfg))
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff
    stack_ms = median_ms(lambda: p["w1"].permute(1, 0, 2).reshape(d, E * f), args.reps)
    print(f"  not on the path: stacking w1 into (d, E*f) as the reference does per call "
          f"ms={stack_ms:.4f} (x2 with w3); K3 reads the expert stack in place")

    a, topo, rows, cols = sdd_tables(tmoe, p, xs["prefill"], cfg)
    bm, bn = topo.block
    K = a.shape[1]
    nnz, n_valid = topo.nnz_max, int(topo.n_blocks)
    w1 = p["w1"].permute(1, 0, 2)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    pick = torch.randperm(n_valid, generator=gen, device=dev)[:64]
    records = {}
    for dtype in (torch.bfloat16, torch.float32):
        a_t, w_t = a.to(dtype), w1.to(dtype)  # float32: copies of the path's inputs
        out = torch.empty((nnz, bm, bn), dtype=dtype, device=dev)
        launch = lambda: ext.bsr_sdd(a_t, w_t, rows, cols, out)  # noqa: E731
        launch()
        sample = (rows[pick], cols[pick])
        plain = lambda: kref.bsr_sdd_ref(a_t, w_t, *sample, bm, bn)  # noqa: E731
        err = check(f"bsr_sdd {str(dtype)[6:]} prefill tables (64 sampled slots) kernel vs "
                    f"plain", out[pick], plain(), dtype)
        ms = median_ms(launch, args.reps)
        out_s = torch.empty((64, bm, bn), dtype=dtype, device=dev)
        sample_ms = median_ms(lambda: ext.bsr_sdd(a_t, w_t, *sample, out_s), args.reps)
        plain_ms = median_ms(plain, args.reps)
        # each slot's a rows and each expert's weight block read once
        n_a = int(torch.unique(rows).numel())
        n_b = int(torch.unique(cols).numel())
        es = a_t.element_size()
        need = (n_a * bm * K + n_b * K * bn + nnz * bm * bn) * es + nbytes(rows, cols)
        ops = 2 * nnz * bm * bn * K
        b_ms, b_by = bound_ms(need, ops, dtype)
        lib_ms, lib_txt = None, "n/a (bfloat16: the library call takes float32)"
        if dtype == torch.float32:
            lib_ms, lib_txt = sdd_library(torch, a_t, w_t, topo, out, n_valid, args.reps)
        print(f"  bsr_sdd prefill {str(dtype)[6:]}: slots={nnz} ({n_valid} valid) "
              f"bm={bm} bn={bn} K={K} ms={ms:.4f} bound_ms={b_ms:.4f} ({b_by}: {need} B, "
              f"{ops} ops) roofline_share={b_ms / ms:.3f}; on the 64-slot sample: "
              f"ms={sample_ms:.4f} plain_ms={plain_ms:.4f}; library_ms={lib_txt}")
        records[str(dtype)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=b_by, library_ms=lib_ms)
        del a_t, w_t, out, out_s

    # K2 at the dsd shapes: the activations h against the stacked w2
    h = bsr_ops.sdd(a, w1, topo)
    g = bsr_ops.sdd(a, p["w3"].permute(1, 0, 2), topo)
    tiles = h.with_data(torch.nn.functional.silu(h.data) * g.data).data.contiguous()
    del h, g
    x2 = p["w2"].reshape(E * f, d)
    Rb = topo.n_block_rows
    m_pad = (Rb + 1) * bm
    rptr = kops.row_ptr_from_ids(topo.row_indices, Rb + 1)
    y = torch.empty((m_pad, d), dtype=x2.dtype, device=dev)
    launch = lambda: ext.bsr_spmm(tiles, rptr, cols, x2, y, 128)  # noqa: E731
    ms = median_ms(launch, args.reps)
    ys = torch.empty((m_pad, d), dtype=x2.dtype, device=dev)
    sel = torch.sort(pick).values
    s_tiles, s_rows, s_cols = tiles[sel].contiguous(), topo.row_indices[sel], cols[sel]
    s_ptr = kops.row_ptr_from_ids(s_rows, Rb + 1)
    ext.bsr_spmm(s_tiles, s_ptr, s_cols, x2, ys, 128)
    plain = lambda: kref.bsr_spmm_ref(s_tiles, s_rows, s_cols, x2, m_pad)  # noqa: E731
    err = check("bsr_spmm dsd shapes (64 sampled slots) kernel vs plain", ys, plain(),
                torch.bfloat16)
    sample_ms = median_ms(lambda: ext.bsr_spmm(s_tiles, s_ptr, s_cols, x2, ys, 128), args.reps)
    plain_ms = median_ms(plain, args.reps)
    n_b = int(torch.unique(cols).numel())
    need = nbytes(tiles, rptr, cols, y) + n_b * f * d * x2.element_size()
    ops = 2 * tiles.numel() * d
    b_ms, b_by = bound_ms(need, ops, x2.dtype)
    lib_txt = dsd_library(torch, tiles, topo, cols, x2, args.reps)
    print(f"  bsr_spmm dsd bfloat16: tiles={tiles.shape[0]} tm={bm} tk={bn} n={d} "
          f"ms={ms:.4f} bound_ms={b_ms:.4f} ({b_by}: {need} B, {ops} ops) "
          f"roofline_share={b_ms / ms:.3f}; on the 64-slot sample: ms={sample_ms:.4f} "
          f"plain_ms={plain_ms:.4f} (max_abs_err={err:.3e}); library_ms={lib_txt}")
    return records


def device_breakdown(torch, label, fn, top=6):
    """One call under torch.profiler: the device time by kernel (exclusive
    times, largest first) and the device's busy share of the call's wall
    time (which the profiler's own overhead inflates), or "not measured"
    if the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():  # the profiler's notice about event cycles
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, e.key, e.count))
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print(f"  profile {label}: device time not measured (the profiler saw none)")
        return
    rows.sort(reverse=True)
    parts = "; ".join(f"{k[:60]} x{n} {t:.3f} ms" for t, k, n in rows[:top])
    print(f"  profile {label}: device busy {busy:.3f} of {wall_ms:.3f} ms wall "
          f"(share {busy / wall_ms:.3f}); by kernel: {parts}")


def sdd_library(torch, a, w, topo, out, n_valid, reps):
    """torch.sparse.sampled_addmm over the topology's element-level CSR, in
    float32, held against K3's blocks. (ms or None, text)."""
    try:
        bm, bn = topo.block
        dev = a.device
        r = topo.row_indices[:n_valid].long()
        c = topo.column_indices[:n_valid].long()
        if int((topo.offsets[1:] - topo.offsets[:-1]).max()) > 1:
            raise ValueError("a block row with two blocks: CSR order differs from slot order")
        m, j = torch.arange(bm, device=dev), torch.arange(bn, device=dev)
        er = (r[:, None, None] * bm + m[None, :, None]).expand(-1, bm, bn)
        ec = (c[:, None, None] * bn + j[None, None, :]).expand(-1, bm, bn)
        idx = torch.stack([er.reshape(-1), ec.reshape(-1)])
        stacked = w.reshape(w.shape[0], -1)  # (K, E*bn), a float32 copy
        pattern = torch.sparse_coo_tensor(
            idx, torch.ones(idx.shape[1], device=dev), (a.shape[0], stacked.shape[1]),
        ).coalesce().to_sparse_csr()
        del idx, er, ec
        call = lambda: torch.sparse.sampled_addmm(pattern, a, stacked, beta=0.0)  # noqa: E731
        res = call()
        check("sampled_addmm vs bsr_sdd (float32, valid slots)",
              res.values().reshape(n_valid, bm, bn), out[:n_valid], torch.float32)
        ms = median_ms(call, reps)
        return ms, f"{ms:.4f}"
    except (RuntimeError, NotImplementedError, ValueError) as e:
        return None, f"n/a ({type(e).__name__}: {str(e).splitlines()[0][:200]})"


def dsd_library(torch, tiles, topo, cols, x, reps):
    """torch.sparse_bsr_tensor(...) @ x in float32 at the dsd shapes, or
    n/a with the error this install gives."""
    try:
        n_valid = int(topo.n_blocks)
        bsr = torch.sparse_bsr_tensor(topo.offsets, cols[:n_valid], tiles[:n_valid].float(),
                                      size=topo.shape)
        x32 = x.float()
        ms = median_ms(lambda: bsr @ x32, reps)
        return f"{ms:.4f}"
    except (RuntimeError, NotImplementedError, ValueError) as e:
        return f"n/a ({type(e).__name__}: {str(e).splitlines()[0][:200]})"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=25, help="timed calls per median (>= 20)")
    ap.add_argument("--verbose-build", action="store_true", help="show the compiler's output")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core import StagingOptions, stage_spmm, stage_spmv, synthesize_paper
    from repro_torch.kernels import _build, ops as kops, ref as kref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the library yardstick's beta-state and kernel-tuning notices
    warnings.filterwarnings("ignore", message=r"(Sparse|bsr_dense_addmm)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)  # name, power limit: as nvidia-smi prints them
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    # -- phase 1 ---------------------------------------------------------
    _build.load_kernels(verbose=args.verbose_build)
    print(f"phase 1: kernels built in {_build.build_seconds():.1f} s")

    # -- phase 2 ---------------------------------------------------------
    rng = np.random.default_rng(args.seed)
    phase_kernels(rng, torch, kops, kref)

    # -- phase 3 ---------------------------------------------------------
    print("phase 3: main path at paper size (10000 x 10000, n = 128)")
    dev = torch.device("cuda")
    n_cols = 128
    mats = {
        "u": synthesize_paper(50, 50, 500, zeros_pct=20, seed=args.seed),
        "nu": synthesize_paper(100, 100, 500, zeros_pct=20, uniform=False, seed=args.seed),
    }
    dtypes = (torch.float32, torch.bfloat16)
    runs = []  # (matrix name, dtype, spmv kernel, spmm kernel, val, x, X)
    for name, v in mats.items():
        val = torch.as_tensor(v.val, device=dev)
        x = torch.as_tensor(rng.standard_normal(v.shape[1]).astype(np.float32), device=dev)
        X = torch.as_tensor(
            rng.standard_normal((v.shape[1], n_cols)).astype(np.float32), device=dev
        )
        for dtype in dtypes:
            opts = StagingOptions(backend="cuda", dtype=dtype)
            ks, km = stage_spmv(v, opts), stage_spmm(v, n_cols, opts)
            t = ks.tiled
            print(
                f"  {name} {str(dtype)[6:]}: stored={v.stored_nnz} tiles={t.n_tiles} "
                f"tile={t.tm}x{t.tk} padded_fraction={t.padded_fraction:.4f} "
                f"stage0_spmv={ks.stage0_time:.3f}s stage0_spmm={km.stage0_time:.3f}s"
            )
            runs.append((name, dtype, ks, km, val, x, X))

    kops.reset_launches()
    outs = [(ks(val, x), km(val, X)) for _, _, ks, km, val, x, X in runs]
    torch.cuda.synchronize()
    launches = dict(kops.launches)
    print(f"  launches on the main path: {launches}")
    for name in ("bsr_spmv", "bsr_spmm"):
        if launches[name] == 0:
            raise AssertionError(f"main path never launched {name}")

    for (name, dtype, ks, km, val, x, X), (y, ym) in zip(runs, outs):
        v = mats[name]
        # the inputs the kernels saw, in float32
        val_in, x_in, X_in = (a.to(dtype).float() for a in (val, x, X))
        ref_s = stage_spmv(v, StagingOptions(backend="grouped"), device=dev)(val_in, x_in)
        ref_m = stage_spmm(v, n_cols, StagingOptions(backend="grouped"), device=dev)(val_in, X_in)
        dense = torch.as_tensor(v.to_dense(), device=dev).to(dtype).float()
        tag = f"{name} {str(dtype)[6:]}"
        check(f"stage_spmv {tag} vs grouped", y, ref_s, dtype)
        check(f"stage_spmv {tag} vs dense", y, dense @ x_in, dtype)
        check(f"stage_spmm {tag} vs grouped", ym, ref_m, dtype)
        check(f"stage_spmm {tag} vs dense", ym, dense @ X_in, dtype)
        if not (torch.isfinite(y.float()).all() and torch.isfinite(ym.float()).all()):
            raise AssertionError(f"{tag}: non-finite output")
        del dense

    # -- phase 4 ---------------------------------------------------------
    print(f"phase 4: times (median of {args.reps} calls, CUDA events)")
    ext = _build.load_kernels()
    records = {}
    for name, dtype, ks, km, val, x, X in runs:
        t = ks.tiled
        tiles = ks.pack(val)
        dt = tiles.dtype
        xp = torch.cat([x.new_zeros(1), x]).to(dt)[torch.as_tensor(t.x_src, device=dev)]
        Xp = torch.cat([X.new_zeros(1, n_cols), X]).to(dt)[torch.as_tensor(t.x_src, device=dev)]
        rows = torch.as_tensor(t.row_ids, device=dev)
        cols = torch.as_tensor(t.col_ids, device=dev)
        rptr = torch.as_tensor(t.row_ptr, device=dev)
        y = torch.empty(t.m_pad, dtype=dt, device=dev)
        ym = torch.empty(t.m_pad, n_cols, dtype=dt, device=dev)
        tag = f"{name} {str(dtype)[6:]}"
        # the library call takes float32 only; bfloat16 rows get null
        bsr = (torch.sparse_bsr_tensor(rptr, cols, tiles, size=(t.m_pad, t.k_pad),
                                       check_invariants=True)
               if dtype == torch.float32 else None)
        for kname, launch, plain, lib, out, xin, flops_per in (
            ("bsr_spmv", lambda: ext.bsr_spmv(tiles, rptr, cols, xp, y),
             lambda: kref.bsr_spmv_ref(tiles, rows, cols, xp, t.m_pad),
             lambda: bsr @ xp.unsqueeze(1), y, xp, 2),
            ("bsr_spmm", lambda: ext.bsr_spmm(tiles, rptr, cols, Xp, ym, 128),
             lambda: kref.bsr_spmm_ref(tiles, rows, cols, Xp, t.m_pad),
             lambda: bsr @ Xp, ym, Xp, 2 * n_cols),
        ):
            launch()
            torch.cuda.synchronize()
            err = check(f"{kname} {tag} kernel vs plain (main-path tables)", out,
                        plain(), dtype)
            ms = median_ms(launch, args.reps)
            plain_ms = median_ms(plain, args.reps)
            lib_ms = None if bsr is None else median_ms(lib, args.reps)
            nbytes = sum(a.numel() * a.element_size() for a in (tiles, rptr, cols, xin, out))
            ops = flops_per * tiles.numel()
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_OPS_PER_S[str(dt)] * 1e3
            bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
            lib_txt = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
            print(
                f"  {kname} {tag}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={lib_txt} bound_ms={bound_ms:.4f} ({bound_by}: "
                f"{nbytes} B, {ops} ops) roofline_share={bound_ms / ms:.3f}"
            )
            records[(kname, name, str(dtype))] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms,
            )
        for kind, k, dense_x in (("spmv", ks, x), ("spmm", km, X)):
            # the same staged call on values packed once
            kp = (stage_spmv(mats[name], replace(k.opts, prepack=True)) if kind == "spmv"
                  else stage_spmm(mats[name], n_cols, replace(k.opts, prepack=True)))
            packed = kp.pack(val)
            call_ms = median_ms(lambda: k(val, dense_x), args.reps)
            packed_ms = median_ms(lambda: kp(packed, dense_x), args.reps)
            print(f"  stage_{kind} {tag}: fn(val, x) ms={call_ms:.4f} prepacked ms={packed_ms:.4f}")
            del kp, packed

    # -- phases 5-7 --------------------------------------------------------
    del runs, outs
    torch.cuda.empty_cache()
    phase_sdd(rng, torch, kops, kref)
    tmoe, p, xs, cfg, cfg_cap, moe_launches = phase_moe(args, torch, kops, kref)
    sdd_records = phase_moe_times(args, torch, kops, kref, tmoe, p, xs, cfg, cfg_cap)

    # K1, K2: u float32 on the first path; K3: float32 at the MoE prefill tables
    final = {k: (records[(k, "u", "torch.float32")], launches[k])
             for k in ("bsr_spmv", "bsr_spmm")}
    final["bsr_sdd"] = (sdd_records["torch.float32"], moe_launches["bsr_sdd"])
    summary = []
    for kname, (source, replaces) in KERNELS.items():
        rec, n = final[kname]
        summary.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces, launches=n, **rec,
        ))
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
