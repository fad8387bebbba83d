#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N] [--reps N] [--verbose-build]

Phases, each printing its lines:

1. build    builds the CUDA kernels K1 (bsr_spmv), K2 (bsr_spmm) and K3
            (bsr_sdd) from src/repro_torch/kernels/csrc and prints the build
            time;
2. kernels  holds K1 and K2 against their plain PyTorch versions on random
            sorted tile tables (empty row tiles, n not a multiple of the
            column block, odd tiles, float32 and bfloat16), on tables
            made of runs of 1-9 row tiles sharing a column tile, as the
            MoE's dsd makes them (runs across a 64-row panel, two runs into
            one row tile, padding tiles past the last row tile, tm = 5, 8,
            16, 32, and in bfloat16 40 and 100, where a CTA takes 64 rows
            of one tile), and on the skewed tables of testing.SKEWED that
            stress K1's and K2's even split of the tile table over the
            card's workers (a row tile with 90% of the tiles, fewer tiles
            than workers, one tile, long runs of empty row tiles), where
            a second launch in float32 must give the same bits;
3. main     drives the port's first path, stage_spmv and stage_spmm
            (n = 128) through the 'cuda' backend, on the paper's
            10 000 x 10 000 matrices <50,50,500,u> and <100,100,500,nu>
            with 20% in-block zeros, in float32 and bfloat16. The launch
            counts are zeroed just before and read just after; each kernel
            must have launched. The outputs are held against the 'grouped'
            backend and a dense product, both in float32 with TF32 off, on
            the inputs the kernels saw;
4. times    medians of CUDA-event timings of each kernel, its plain version
            and torch.sparse_bsr_tensor(...) @ x (in the row's dtype, its
            error against the plain version printed beside it; "n/a" with
            the error where this install refuses it) on the main path's
            tables (with the schedules the staged path built), each timed
            call after a 134 MB write and read that flush the L2 (outside
            the events), each kernel's bound, and each staged fn(val, x),
            prepacked and not; in float32 the last timed launch must give
            the first one's bits; at u, each kernel's device time by
            launch under torch.profiler, and beforehand the launch floor
            (an empty kernel timed the same way);
5. sdd      holds K3 against its plain version on odd shapes (bm = 8 and
            others, bn not a multiple of 128, K not a multiple of 32,
            padding slots with out-of-range columns, b as a strided expert
            stack), on random slots and on runs of 1-9 slots of one column
            block (runs across a CTA's group of slots), float32 and
            bfloat16 (bm = 40 and 100 too). In float32 (3xTF32 on the
            tensor cores) also at bm = 1, 5, 8, 16, 24, 40, 100 (bn 200,
            K 44) and at the MoE's bm 8, bn 1536, K 5120, each float32
            table through both bodies: cp.async copies, and scalar copies
            on the same values in a copy of a that starts 4 bytes past a
            16-byte boundary, as ops.sdd_body picks them (the body
            printed); a second launch must give the same bits;
6. moe      drives the port's second path: DeepSeek-V2-236B's MoE layer at
            its published widths (d_model 5120, 160 routed experts of
            d_ff 1536, top-6, 2 shared experts, swiglu), dropless, through
            moe_apply at prefill (B=4, S=512) and decode (B=64, S=1), in
            two passes: params in bfloat16 (7.6 GB), then, the bfloat16
            layer freed, in float32 (15.3 GB, the JAX config's
            param_dtype), each from --seed. The launch counts are zeroed
            just before each pass and read just after; K3 and K2 must have
            launched. The output is held against the capacity path (plain
            einsums, TF32 off) with capacity_factor = E / top_k, which drops
            nothing, in the pass's dtype, and K3 on the path's own prefill
            tables against its plain version on 64 sampled slots;
7. moe times  after each pass of phase 6, in its dtype: the MoE layer's time
            (prefill, decode) and its device time by kernel; at the prefill
            and decode tables as the path builds them, K3 (its body
            printed; a second launch must give the first one's bits; at
            prefill also on the same slots ordered by expert, one run per
            expert) and K2 at the dsd tables (tm=8, tk=1536, n=5120, m_pad
            = M), each beside its bound, its plain version (K3 on 64
            sampled slots, K2 on the tiles of 16 whole 64-row panels, each
            against the timed launch's own output) and the library call in
            the kernel's dtype: torch.sparse.sampled_addmm (K3) and
            torch.sparse_csr_tensor(...) @ x (K2, cuSPARSE; float32 beside
            bfloat16), each over the element-level CSR.

Bounds: bytes over 3.35 TB/s or operations over the dtype's peak, the
larger; float32's peak is the 3xTF32 rate (494.7 / 3 TFLOP/s), and
fma_bound_ms beside it counts float32 on the FMA pipes (67 TFLOP/s).
Tolerance: max|out - ref| / max|ref| <= 1e-5 in float32, 2e-2 in bfloat16.
Any failure raises. The last two lines are the `kernels` JSON object (K1
and K2 at u in float32 as the rows' own keys, and their other rows as
u_bf16_*, nu_f32_* and nu_bf16_* keys; K3 at the MoE prefill tables in
float32, launched by the float32 pass; moe_{prefill,decode}_{bf16,f32}_*
keys for K2 and K3) and {"ok": true, "device": {...}}.
Without a CUDA device, or without the package beside this script, it exits
non-zero and prints no result.
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
# float32: 3xTF32, three TF32 products (494.7 TFLOP/s) for each float32-accurate one
PEAK_OPS_PER_S = {"torch.float32": 494.7e12 / 3, "torch.bfloat16": 989e12}
FMA_OPS_PER_S = 67e12  # float32 on the FMA pipes: the bound before 3xTF32
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


def library_time(label, make, want, dtype, reps, select=lambda y: y, before=None):
    """A library call that computes a kernel's function, timed as its
    yardstick: ``make()`` builds the library's operands and returns the
    call. Its result (through ``select``) is compared with ``want``, and the
    error printed beside the time with a note where it exceeds the dtype's
    tolerance (the library's own precision, not a failure of the port).
    Returns (ms or None, text): None, with the error, where this install
    refuses the call."""
    import torch

    try:
        call = make()
        got = select(call())
        torch.cuda.synchronize()
    except Exception as e:  # any refusal is the finding: record it
        txt = f"n/a ({type(e).__name__}: {(str(e).splitlines() or [''])[0][:200]})"
        print(f"  {label}: {txt}")
        return None, txt
    err, rel = rel_err(got, want)
    del got
    ms = median_ms(call, reps, before)
    tol = TOL[str(dtype)]
    note = "" if rel <= tol else f", less precise than the kernels' tolerance {tol:g}"
    print(f"  {label}: ms={ms:.4f} vs plain: max_abs_err={err:.3e} rel={rel:.3e}{note}")
    return ms, f"{ms:.4f}"


def median_ms(fn, reps: int, before=None) -> float:
    """Median of per-call CUDA-event times, after two warm-up calls;
    ``before()``, if given, runs ahead of each call outside the events."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if before is not None:
            before()
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
    import numpy as np

    from repro_torch.kernels import testing

    print("phase 2: kernels vs plain versions on the card")
    cases = [  # (tables, tm, tk, n, dtype)
        ("random", 32, 32, 128, torch.float32),
        ("random", 32, 32, 100, torch.bfloat16),
        ("random", 8, 128, 70, torch.float32),
        ("random", 5, 7, 33, torch.float32),
        ("random", 16, 12, 6, torch.bfloat16),
        ("random", 40, 3, 129, torch.float32),
        ("random", 40, 32, 129, torch.bfloat16),  # one row tile to a bfloat16 CTA
        ("random", 100, 16, 72, torch.bfloat16),  # two CTAs to a row tile, one ragged
        ("random", 1, 1, 1, torch.float32),
        ("runs", 8, 1536, 200, torch.bfloat16),
        ("runs", 8, 40, 136, torch.float32),
        ("runs", 16, 24, 100, torch.bfloat16),
        ("runs", 16, 24, 100, torch.float32),
        ("runs", 32, 32, 128, torch.bfloat16),
        ("runs", 5, 16, 72, torch.bfloat16),
        ("runs", 5, 7, 33, torch.float32),
        ("runs", 40, 24, 100, torch.bfloat16),
        ("runs", 100, 16, 136, torch.bfloat16),
    ]
    # the skewed tables of K1 and K2's split over the card's workers: a row
    # tile with 90% of the tiles, fewer tiles than workers, one tile, long
    # runs of empty row tiles; float32 twice, for bit-identical results
    cases += [(kind, 32, 32, 100, dtype) for kind in testing.SKEWED
              for dtype in (torch.float32, torch.bfloat16)]
    dev = torch.device("cuda")
    for kind, tm, tk, n, dtype in cases:
        n_ct = 9
        if kind == "random":
            n_rt = 23
            tiles, rows, cols = random_tables(rng, n_rt, n_ct, 60, tm, tk, empty_rows=4)
        else:
            if kind == "runs":
                rows, cols, n_rt = testing.run_tables(rng, n_ct, pad=5)
            else:
                rows, cols, n_rt = testing.skewed_tables(rng, kind, n_ct)
            tiles = rng.standard_normal((len(rows), tm, tk)).astype(np.float32)
            tiles[rows == n_rt] = 0  # padding holds zeros, as BlockMatrix's does
        t = torch.as_tensor(tiles, device=dev).to(dtype)
        r = torch.as_tensor(rows, device=dev)
        c = torch.as_tensor(cols, device=dev)
        x = torch.as_tensor(rng.standard_normal(n_ct * tk), device=dev).to(dtype)
        xm = torch.as_tensor(rng.standard_normal((n_ct * tk, n)), device=dev).to(dtype)
        m_pad = n_rt * tm
        y = kops.bsr_spmv(t, r, c, x, m_pad=m_pad, device=dev)
        ym = kops.bsr_spmm(t, r, c, xm, m_pad=m_pad, device=dev)
        torch.cuda.synchronize()
        tag = f"{kind} tables tm={tm} tk={tk} n={n} {str(dtype)[6:]}"
        check(f"bsr_spmv {tag}", y, kref.bsr_spmv_ref(t, r, c, x, m_pad), dtype)
        check(f"bsr_spmm {tag}", ym, kref.bsr_spmm_ref(t, r, c, xm, m_pad), dtype)
        if kind in testing.SKEWED and dtype == torch.float32:
            same_bits(f"bsr_spmv {tag}", y, kops.bsr_spmv(t, r, c, x, m_pad=m_pad, device=dev))
            same_bits(f"bsr_spmm {tag}", ym,
                      kops.bsr_spmm(t, r, c, xm, m_pad=m_pad, device=dev))


def same_bits(label: str, first, again) -> None:
    """Two launches on the same inputs must give the same bits."""
    import torch

    torch.cuda.synchronize()
    ok = torch.equal(first, again)
    print(f"  {label}: second launch bit-identical {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: two launches on the same inputs differ")


def bound_fields(nbytes: int, ops: int, dtype) -> dict:
    """The least time the card could take: ``bound_ms``, bytes over HBM
    bandwidth or operations over the dtype's peak, whichever is larger, and
    ``bound_by``; in float32 also ``fma_bound_ms``, the same with float32 on
    the FMA pipes (the yardstick before 3xTF32)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ms, b_by = max((t_bytes, "bytes"),
                     (ops / PEAK_OPS_PER_S[str(dtype)] * 1e3, "operations"))
    fields = dict(bound_ms=b_ms, bound_by=b_by)
    if str(dtype) == "torch.float32":
        fields["fma_bound_ms"] = max(t_bytes, ops / FMA_OPS_PER_S * 1e3)
    return fields


def bound_text(f: dict, nbytes: int, ops: int) -> str:
    fma = f" fma_bound_ms={f['fma_bound_ms']:.4f}" if "fma_bound_ms" in f else ""
    return f"bound_ms={f['bound_ms']:.4f} ({f['bound_by']}: {nbytes} B, {ops} ops){fma}"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def body_label(dtype, body: str) -> str:
    """K3's body as printed: its products and its copies."""
    products = "3xTF32" if str(dtype) == "torch.float32" else "bfloat16"
    return f"{products} mma.sync, {body} copies"


def phase_sdd(rng, torch, kops, kref):
    import numpy as np

    from repro_torch.kernels import testing

    print("phase 5: K3 (bsr_sdd) vs its plain version on the card")
    cases = [  # (slots, bm, bn, K, dtype)
        ("random", 8, 200, 45, torch.float32),
        ("random", 8, 200, 45, torch.bfloat16),
        ("random", 8, 1536, 5120, torch.bfloat16),
        ("random", 8, 96, 1000, torch.float32),
        ("random", 3, 7, 1, torch.float32),
        ("random", 20, 130, 33, torch.bfloat16),
        ("random", 40, 64, 96, torch.float32),
        ("random", 40, 64, 96, torch.bfloat16),  # one slot to a bfloat16 CTA
        ("random", 100, 136, 40, torch.bfloat16),  # two CTAs to a slot, one ragged
        ("random", 1, 1, 1, torch.bfloat16),
        ("runs", 8, 1536, 512, torch.bfloat16),
        ("runs", 8, 200, 45, torch.float32),
        ("runs", 16, 136, 96, torch.bfloat16),
        ("runs", 32, 130, 64, torch.bfloat16),
        ("runs", 32, 130, 64, torch.float32),
        ("runs", 5, 72, 40, torch.bfloat16),
        ("runs", 40, 136, 96, torch.bfloat16),
        ("runs", 100, 72, 40, torch.bfloat16),
    ]
    # float32 on both bodies: groups of 64 to 2 slots, one slot of 40 rows and
    # two CTAs to a slot of 100, bn past 128 and ragged, K not 32-deep; the
    # MoE's blocks at its depth
    cases += [("runs", bm, 200, 44, torch.float32) for bm in (1, 5, 8, 16, 24, 40, 100)]
    cases += [("runs", 8, 1536, 5120, torch.float32)]
    dev = torch.device("cuda")
    for kind, bm, bn, K, dtype in cases:
        n_cb, pad = 7, 3
        if kind == "random":
            n_rb, nnz = 9, 20
            # sorted slots, then padding slots (row n_rb, col 0) as BlockMatrix pads
            rows = np.concatenate([np.sort(rng.integers(0, n_rb, nnz)), np.full(pad, n_rb)])
            cols = np.concatenate([rng.integers(0, n_cb, nnz), np.zeros(pad)])
        else:
            rows, cols, n_rb = testing.run_slots(rng, n_cb, pad)
        r = torch.as_tensor(rows.astype(np.int32), device=dev)
        c = torch.as_tensor(cols.astype(np.int32), device=dev)
        a = torch.as_tensor(rng.standard_normal((n_rb * bm, K)), device=dev).to(dtype)
        operands = [a]
        if dtype == torch.float32:  # the same values 4 bytes past a 16-byte boundary
            operands.append(torch.cat([a.new_zeros(1), a.reshape(-1)])[1:].view(a.shape))
        w = torch.as_tensor(rng.standard_normal((n_cb, K, bn)), device=dev).to(dtype)
        stacked = w.permute(1, 0, 2).reshape(K, n_cb * bn)
        want = kref.bsr_sdd_ref(a, stacked, r, c, bm, bn)
        tag = f"{kind} slots bm={bm} bn={bn} K={K} {str(dtype)[6:]}"
        for layout, b in (("stacked", stacked), ("expert stack view", w.permute(1, 0, 2))):
            for a_in in operands:
                body = kops.sdd_body(a_in, b.view(K, n_cb, bn) if b.dim() == 2 else b)
                out = kops.bsr_sdd(a_in, b, r, c, bm=bm, bn=bn, device=dev)
                torch.cuda.synchronize()
                label = f"bsr_sdd {tag} ({layout}, {pad} padding slots, {body_label(dtype, body)})"
                check(label, out, want, dtype)
                if dtype == torch.float32:
                    if a_in is not a and body != "scalar":
                        raise RuntimeError(f"{label}: a shifted a must take the scalar body")
                    same_bits(label, out, kops.bsr_sdd(a_in, b, r, c, bm=bm, bn=bn, device=dev))


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
    slots at row n_block_rows, which K3 writes as zero blocks)."""
    r = tmoe._route(p, x, cfg)
    buf = tmoe._dispatch(x, r, cfg)
    topo = tmoe._dropless_topology(r.counts, r.C, r.Tg, cfg, cfg.moe.d_ff)
    return buf.reshape(-1, x.shape[-1]), topo, topo.row_indices, topo.column_indices


def phase_moe(args, torch, kops, kref, dtype):
    """Phase 6 in ``dtype``: the dropless layer at full width through
    moe_apply, checked; returns what phase 7 times and the launch counts."""
    from repro_torch.models import moe as tmoe

    dname = str(dtype)[6:]
    print(f"phase 6: DeepSeek-V2-236B MoE layer at full width, dropless ({dname})")
    cfg, cfg_cap = moe_configs()
    mc = cfg.moe
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    p = tmoe.moe_init(gen, cfg, dtype=dtype, device=dev)
    torch.cuda.synchronize()
    print(f"  params: {nbytes(*p.values()) / 1e9:.3f} GB in {dname}, drawn in "
          f"{time.perf_counter() - t0:.2f} s (d_model={cfg.d_model} experts={mc.num_experts} "
          f"top_k={mc.top_k} d_ff={mc.d_ff} shared={mc.num_shared}x{mc.shared_d_ff})")
    xs = {
        name: torch.randn((B, S, cfg.d_model), generator=gen, device=dev).to(dtype)
        for name, (B, S) in (("prefill", (4, 512)), ("decode", (64, 1)))
    }
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()
    outs = {name: tmoe.moe_apply(p, x, cfg) for name, x in xs.items()}
    torch.cuda.synchronize()
    launches = dict(kops.launches)
    print(f"  launches on the MoE path ({dname}): {launches}")
    for name in ("bsr_sdd", "bsr_spmm"):
        if launches[name] == 0:
            raise AssertionError(f"MoE path ({dname}) never launched {name}")
    print(f"  peak device memory (dropless, {dname}): "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")

    for name, x in xs.items():
        y, aux = outs[name]
        if tuple(y.shape) != tuple(x.shape) or not torch.isfinite(y.float()).all():
            raise AssertionError(f"{name}: output {tuple(y.shape)} is not finite of the "
                                 f"input's shape {tuple(x.shape)}")
        y_cap, aux_cap = tmoe.moe_apply(p, x, cfg_cap)
        check(f"moe {name} B,S={tuple(x.shape[:2])} {dname} dropless vs capacity path", y,
              y_cap, dtype)
        check(f"moe {name} aux loss dropless vs capacity path (float32)", aux, aux_cap,
              torch.float32)
        print(f"  moe {name}: aux={float(aux):.6f} |y|max={float(y.abs().max()):.4f}")
        del y_cap
    print(f"  peak device memory (with the capacity path, {dname}): "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    del outs

    a, topo, rows, cols = sdd_tables(tmoe, p, xs["prefill"], cfg)
    n_valid = int(topo.n_blocks)
    pick = sample_slots(torch, topo, args.seed)
    w1 = p["w1"].permute(1, 0, 2)
    bm, bn = topo.block
    out = kops.bsr_sdd(a, w1, rows[pick], cols[pick], bm=bm, bn=bn, device=dev)
    want = kref.bsr_sdd_ref(a, w1, rows[pick], cols[pick], bm, bn)
    check(f"bsr_sdd on the prefill path's tables ({len(pick)} sampled slots of "
          f"{topo.nnz_max}, {n_valid} valid, {body_label(dtype, kops.sdd_body(a, w1))})", out,
          want, dtype)
    return tmoe, p, xs, cfg, cfg_cap, launches


def phase_moe_times(args, torch, kops, kref, tmoe, p, xs, cfg, cfg_cap, dtype):
    dname = str(dtype)[6:]
    print(f"phase 7: MoE times in {dname} (median of {args.reps} calls, CUDA events)")
    for name, x in xs.items():
        ms = median_ms(lambda: tmoe.moe_apply(p, x, cfg), args.reps)
        cap_ms = median_ms(lambda: tmoe.moe_apply(p, x, cfg_cap), args.reps)
        print(f"  moe_apply {name} B,S={tuple(x.shape[:2])} {dname}: dropless ms={ms:.4f} "
              f"capacity-path ms={cap_ms:.4f}")
        device_breakdown(torch, f"moe_apply {name} {dname} dropless",
                         lambda: tmoe.moe_apply(p, x, cfg))
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff
    stack_ms = median_ms(lambda: p["w1"].permute(1, 0, 2).reshape(d, E * f), args.reps)
    print(f"  not on the path: stacking w1 into (d, E*f) as the reference does per call "
          f"ms={stack_ms:.4f} (x2 with w3); K3 reads the expert stack in place")
    records = {}
    for name, x in xs.items():
        a, topo, rows, cols = sdd_tables(tmoe, p, x, cfg)
        records[("bsr_sdd", name, str(dtype))] = time_sdd(args, torch, kops, kref, p, a, topo,
                                                          name)
        records[("bsr_spmm", name, str(dtype))] = time_dsd(args, torch, kops, kref, p, a, topo,
                                                           name)
        del a, topo, rows, cols
        torch.cuda.empty_cache()
    return records


def sample_slots(torch, topo, seed, n=60, n_pad=4):
    """Sorted slot indices: ``n`` random valid slots and up to ``n_pad``
    padding slots, for the plain versions (which cannot hold a float32
    gather of every slot at these widths)."""
    dev = topo.row_indices.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_valid = int(topo.n_blocks)
    pick = torch.cat([torch.randperm(n_valid, generator=gen, device=dev)[:n],
                      torch.arange(n_valid, topo.nnz_max, device=dev)[:n_pad]])
    return torch.sort(pick).values


def time_sdd(args, torch, kops, kref, p, a, topo, name):
    """K3 at the path's tables (all slots, padding included) beside its
    bound, its plain version on sampled slots and the library call, in the
    layer's dtype; at prefill also on the same slots ordered by expert."""
    from repro_torch.kernels import _build

    ext = _build.load_kernels()
    dev, dtype = a.device, a.dtype
    bm, bn = topo.block
    K = a.shape[1]
    rows, cols = topo.row_indices, topo.column_indices
    nnz, n_valid = topo.nnz_max, int(topo.n_blocks)
    w = p["w1"].permute(1, 0, 2)
    body = kops.sdd_body(a, w)
    out = torch.empty((nnz, bm, bn), dtype=dtype, device=dev)
    launch = lambda: ext.bsr_sdd(a, w, rows, cols, out, body == "cp.async")  # noqa: E731
    launch()
    pick = sample_slots(torch, topo, args.seed + 1)
    sample = (rows[pick], cols[pick])
    plain = lambda: kref.bsr_sdd_ref(a, w, *sample, bm, bn)  # noqa: E731
    tag = f"bsr_sdd {name} {str(dtype)[6:]}"
    err = check(f"{tag} tables ({len(pick)} sampled slots) kernel vs plain", out[pick],
                plain(), dtype)
    first = out.clone()
    ms = median_ms(launch, args.reps)
    same_bits(f"{tag} tables, last timed launch", first, out)
    del first
    out_s = torch.empty((len(pick), bm, bn), dtype=dtype, device=dev)
    sample_ms = median_ms(lambda: ext.bsr_sdd(a, w, *sample, out_s, body == "cp.async"),
                          args.reps)
    plain_ms = median_ms(plain, args.reps)
    # the valid slots' a rows and each used expert's weight block read once,
    # every slot's block written once; padding slots do no work
    valid = rows < topo.n_block_rows
    n_a = int(torch.unique(rows[valid]).numel())
    n_b = int(torch.unique(cols[valid]).numel())
    need = (n_a * bm * K + n_b * K * bn + nnz * bm * bn) * a.element_size() + nbytes(rows, cols)
    ops = 2 * n_valid * bm * bn * K
    bound = bound_fields(need, ops, dtype)
    lib_ms, lib_txt = sdd_library(torch, a, w, topo, out, n_valid, args.reps)
    print(f"  {tag}: slots={nnz} ({n_valid} valid) bm={bm} bn={bn} K={K} "
          f"body={body_label(dtype, body)} ms={ms:.4f} {bound_text(bound, need, ops)} "
          f"roofline_share={bound['bound_ms'] / ms:.3f}; on {len(pick)} sampled slots: "
          f"ms={sample_ms:.4f} plain_ms={plain_ms:.4f}; library_ms={lib_txt}")
    if name == "prefill":
        # the same work with one run per expert: each weight chunk read about
        # once instead of once per token group (a dispatch sorted by expert)
        order = torch.sort(torch.where(valid, cols, cols.max() + 1), stable=True).indices
        r2, c2 = rows[order].contiguous(), cols[order].contiguous()
        by_ms = median_ms(lambda: ext.bsr_sdd(a, w, r2, c2, out, body == "cp.async"),
                          args.reps)
        print(f"  {tag} tables with the slots ordered by expert (one run per expert): "
              f"ms={by_ms:.4f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                body=body_label(dtype, body), **bound)


def time_dsd(args, torch, kops, kref, p, a, topo, name):
    """K2 at the dsd tables as bsr_ops.dsd builds them (m_pad = M, row
    offsets over the real row tiles only): the activations h against the
    stacked w2, in the layer's dtype, beside its bound, its plain version on
    a few whole 64-row panels (the runs a bfloat16 CTA walks) and the library
    call. The timed launch's own output is held against the plain version on
    those panels."""
    from repro_torch.kernels import _build, bsr_ops

    ext = _build.load_kernels()
    dev, dtype = a.device, a.dtype
    bm, f = topo.block
    E, d = p["w2"].shape[0], p["w2"].shape[2]
    w1, w3 = p["w1"].permute(1, 0, 2), p["w3"].permute(1, 0, 2)
    h, g = bsr_ops.sdd(a, w1, topo), bsr_ops.sdd(a, w3, topo)
    tiles = h.with_data(torch.nn.functional.silu(h.data) * g.data).data.contiguous()
    del h, g
    x2 = p["w2"].reshape(E * f, d)
    M, Rb = topo.shape[0], topo.n_block_rows
    rows, cols = topo.row_indices, topo.column_indices

    def tables(r):
        """Row offsets over r, and the float32 body's split of the table and
        its scratch (the bfloat16 body walks the row offsets alone)."""
        rp = kops.row_ptr_from_ids(r, Rb)
        if dtype != torch.float32:
            none = torch.empty(0, device=dev)
            return rp, none, none
        sched = kops.bsr_schedule("spmm", rp, bm, f, d, dtype)
        return rp, sched, torch.empty(2 * sched.shape[0] * bm * d, dtype=torch.float32,
                                      device=dev)

    rptr, sched, partial = tables(rows)
    y = torch.empty((M, d), dtype=x2.dtype, device=dev)
    launch = lambda: ext.bsr_spmm(tiles, rptr, cols, x2, y, sched, partial)  # noqa: E731
    ms = median_ms(launch, args.reps)
    # a few whole panels of 64 / bm row tiles that hold tiles, and their tiles
    n_valid = int(topo.n_blocks)
    panel = 64 // bm
    live = torch.unique(rows[:n_valid] // panel)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    pick = torch.randperm(live.numel(), generator=gen, device=dev)[:16]
    panels = torch.sort(live[pick]).values
    sel = torch.isin(rows[:n_valid] // panel, panels).nonzero().squeeze(1)
    s_tiles, s_rows, s_cols = tiles[sel].contiguous(), rows[sel], cols[sel]
    out_rows = (panels[:, None] * (panel * bm) + torch.arange(panel * bm, device=dev)).reshape(-1)
    out_rows = out_rows[out_rows < M]
    plain = lambda: kref.bsr_spmm_ref(s_tiles, s_rows, s_cols, x2, M)  # noqa: E731
    tag = f"bsr_spmm dsd {name} {str(dtype)[6:]}"
    err = check(f"{tag} tables, timed launch's output on {panels.numel()} whole panels "
                f"({len(sel)} tiles) vs plain", y[out_rows], plain()[out_rows], dtype)
    s_tables = tables(s_rows)
    ys = torch.empty_like(y)
    sample_ms = median_ms(lambda: ext.bsr_spmm(s_tiles, s_tables[0], s_cols, x2, ys,
                                               *s_tables[1:]), args.reps)
    plain_ms = median_ms(plain, args.reps)
    del ys
    # the valid tiles and each used expert's w2 block read once, y written
    # once; padding tiles are not visited
    n_b = int(torch.unique(cols[:n_valid]).numel())
    es = x2.element_size()
    need = (n_valid * bm * f + n_b * f * d + M * d) * es + nbytes(rptr, cols[:n_valid])
    ops = 2 * n_valid * bm * f * d
    bound = bound_fields(need, ops, dtype)
    del y
    torch.cuda.empty_cache()
    lib_ms, lib_txt = dsd_library(torch, kref, tiles[:n_valid], topo, x2, dtype, args.reps)
    if dtype != torch.float32:
        _, lib32_txt = dsd_library(torch, kref, tiles[:n_valid], topo, x2, torch.float32,
                                   args.reps)
        lib_txt += f" (float32: {lib32_txt})"
    print(f"  {tag}: tiles={tiles.shape[0]} ({n_valid} valid) tm={bm} tk={f} n={d} "
          f"ms={ms:.4f} {bound_text(bound, need, ops)} "
          f"roofline_share={bound['bound_ms'] / ms:.3f}; on {len(sel)} tiles of "
          f"{panels.numel()} panels: ms={sample_ms:.4f} plain_ms={plain_ms:.4f}; "
          f"library_ms={lib_txt}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **bound)


def own_times(spans):
    """Device time by kernel from (start, end, name) spans: each stretch of
    time goes to the earliest-started kernel running then, so a kernel's own
    time is what it runs after every kernel launched before it has ended (a
    programmatic dependent's wait on its primary is not its own), and the
    own times add up to the union of the spans. Returns ({name: [own, span,
    count]}, union)."""
    cuts = sorted({t for s, e, _ in spans for t in (s, e)})
    by_start = sorted(spans)
    table = {}
    for s, e, name in spans:
        row = table.setdefault(name, [0.0, 0.0, 0])
        row[1] += e - s
        row[2] += 1
    busy = 0.0
    active = []  # indices into by_start, in start order
    nxt = 0
    for t0, t1 in zip(cuts, cuts[1:]):
        while nxt < len(by_start) and by_start[nxt][0] <= t0:
            active.append(nxt)
            nxt += 1
        active = [k for k in active if by_start[k][1] > t0]
        if active:
            busy += t1 - t0
            table[by_start[active[0]][2]][0] += t1 - t0
    return table, busy


def device_breakdown(torch, label, fn, top=6):
    """One call under torch.profiler: the device time by kernel (own time,
    largest first, then any other kernel that overlapped another, with the
    kernel's whole span beside it where they differ; see ``own_times``) and the device's busy share of the call's
    wall time (the union of the kernels' spans; the profiler's overhead
    inflates the wall), or "not measured" if the profiler sees no device
    time."""
    from torch.autograd import DeviceType
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
    spans = [(e.time_range.start / 1e3, e.time_range.end / 1e3, e.name) for e in prof.events()
             if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start]
    table, busy = own_times(spans)
    if busy == 0:
        print(f"  profile {label}: device time not measured (the profiler saw none)")
        return
    rows = sorted(((own, span, n, k) for k, (own, span, n) in table.items()), reverse=True)
    def overlapped(row):
        return row[1] > row[0] * 1.01 + 1e-3

    parts = []
    for row in rows[:top] + [row for row in rows[top:] if overlapped(row)]:
        own, span, n, k = row
        parts.append(f"{k[:60]} x{n} {own:.3f} ms" + (f" (span {span:.3f})" if overlapped(row) else ""))
    parts = "; ".join(parts)
    print(f"  profile {label}: device busy {busy:.3f} of {wall_ms:.3f} ms wall "
          f"(share {busy / wall_ms:.3f}); by kernel: {parts}")


def sdd_library(torch, a, w, topo, out, n_valid, reps):
    """torch.sparse.sampled_addmm over the topology's element-level CSR, in
    a's dtype, held against K3's valid blocks; (ms or None, text)."""
    bm, bn = topo.block

    def make():
        dev = a.device
        r = topo.row_indices[:n_valid].long()
        c = topo.column_indices[:n_valid].long()
        if int((topo.offsets[1:] - topo.offsets[:-1]).max()) > 1:
            raise ValueError("a block row with two blocks: CSR order differs from slot order")
        m, j = torch.arange(bm, device=dev), torch.arange(bn, device=dev)
        er = (r[:, None, None] * bm + m[None, :, None]).expand(-1, bm, bn)
        ec = (c[:, None, None] * bn + j[None, None, :]).expand(-1, bm, bn)
        idx = torch.stack([er.reshape(-1), ec.reshape(-1)])
        stacked = w.reshape(w.shape[0], -1)  # (K, E*bn), a copy
        pattern = torch.sparse_coo_tensor(
            idx, torch.ones(idx.shape[1], dtype=a.dtype, device=dev),
            (a.shape[0], stacked.shape[1]),
        ).coalesce().to_sparse_csr()
        return lambda: torch.sparse.sampled_addmm(pattern, a, stacked, beta=0.0)

    return library_time(f"bsr_sdd library call sampled_addmm ({str(a.dtype)[6:]}, valid slots)",
                        make, out[:n_valid], a.dtype, reps,
                        select=lambda res: res.values().reshape(n_valid, bm, bn))


def dsd_library(torch, kref, tiles, topo, x, dtype, reps):
    """torch.sparse_csr_tensor(...) @ x (cuSPARSE) in ``dtype`` over the
    element-level CSR of the valid tiles, held against K2's plain version
    on the first tiles' rows; (ms or None, text)."""
    n_valid, (bm, bk) = tiles.shape[0], topo.block
    dev = tiles.device
    r = topo.row_indices[:n_valid].long()
    c = topo.column_indices[:n_valid].long()
    head = slice(0, min(n_valid, 16))
    m = torch.arange(bm, device=dev)
    rows = (r[head, None] * bm + m[None, :]).reshape(-1)
    want = kref.bsr_spmm_ref(tiles[head].float(), r[head], c[head], x.float(),
                             topo.shape[0])[rows]
    xd = x.to(dtype)

    def make():
        j = torch.arange(bk, device=dev)
        er = (r[:, None, None] * bm + m[None, :, None]).expand(-1, bm, bk)
        ec = (c[:, None, None] * bk + j[None, None, :]).expand(-1, bm, bk)
        idx = torch.stack([er.reshape(-1), ec.reshape(-1)])
        csr = torch.sparse_coo_tensor(idx, tiles.to(dtype).reshape(-1), topo.shape
                                      ).coalesce().to_sparse_csr()
        return lambda: csr @ xd

    return library_time(f"bsr_spmm dsd library call sparse_csr_tensor(...) @ x "
                        f"({str(dtype)[6:]})", make, want, dtype, reps,
                        select=lambda res: res[rows])


def l2_flush(torch):
    """A call that writes 134 MB, well past the 50 MB L2, then reads it back,
    so that the next launch finds its inputs in device memory as a cold
    caller would: the tiles of nu (26 MB in float32) and of u in bfloat16
    (50 MB) would otherwise stay in L2 between back-to-back launches. The
    read leaves the L2 full of clean lines: after the write alone it would
    hold 50 MB of dirty ones, whose write-back the timed launch would pay."""
    scratch = torch.empty(2**25, dtype=torch.float32, device="cuda")

    def flush():
        scratch.zero_()
        scratch.sum()

    return flush


def bsr_call(torch, row_ptr, cols, tiles, size, rhs):
    """torch.sparse_bsr_tensor(...) @ rhs, the tensor built once: the call."""
    bsr = torch.sparse_bsr_tensor(row_ptr, cols, tiles, size=size, check_invariants=True)
    return lambda: bsr @ rhs


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
    print(f"phase 4: times (median of {args.reps} calls, CUDA events; K1/K2, their plain "
          f"versions and library calls each after an L2 flush)")
    ext = _build.load_kernels()
    flush = l2_flush(torch)
    tiny = torch.empty(32, device=dev)
    print(f"  launch floor: one kernel that does nothing, timed the same way "
          f"ms={median_ms(tiny.zero_, args.reps, flush):.4f}")
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
        # the schedules the staged path built, and their scratch
        sv, sm = ks.schedules[dt], km.schedules[dt]
        pv = torch.empty(2 * sv.shape[0] * t.tm, dtype=torch.float32, device=dev)
        if sm is not None:
            pm = torch.empty(2 * sm.shape[0] * t.tm * n_cols, dtype=torch.float32, device=dev)
        else:  # the bfloat16 body walks row_ptr alone
            sm = pm = torch.empty(0, device=dev)
        tag = f"{name} {str(dtype)[6:]}"
        for kname, launch, plain, rhs, out, xin, flops_per in (
            ("bsr_spmv", lambda: ext.bsr_spmv(tiles, rptr, cols, xp, y, sv, pv),
             lambda: kref.bsr_spmv_ref(tiles, rows, cols, xp, t.m_pad), xp.unsqueeze(1),
             y, xp, 2),
            ("bsr_spmm", lambda: ext.bsr_spmm(tiles, rptr, cols, Xp, ym, sm, pm),
             lambda: kref.bsr_spmm_ref(tiles, rows, cols, Xp, t.m_pad), Xp,
             ym, Xp, 2 * n_cols),
        ):
            launch()
            torch.cuda.synchronize()
            want = plain()
            err = check(f"{kname} {tag} kernel vs plain (main-path tables)", out, want, dtype)
            first = out.clone()
            ms = median_ms(launch, args.reps, flush)
            if dt == torch.float32:  # the last timed launch against the first
                same_bits(f"{kname} {tag} main-path tables", first, out)
            del first
            if name == "u":  # the kernel's own launches, the cut row tiles' join beside it
                device_breakdown(torch, f"{kname} {tag} (L2 not flushed)", launch)
            plain_ms = median_ms(plain, args.reps, flush)
            # in the row's own dtype: (32, 32) blocks, as the kernels take them
            lib_ms, lib_txt = library_time(
                f"{kname} {tag} library call sparse_bsr_tensor(...) @ x",
                lambda: bsr_call(torch, rptr, cols, tiles, (t.m_pad, t.k_pad), rhs),
                want, dtype, args.reps, select=lambda r: r.reshape(want.shape), before=flush)
            del want
            need = sum(a.numel() * a.element_size() for a in (tiles, rptr, cols, xin, out))
            ops = flops_per * tiles.numel()
            bound = bound_fields(need, ops, dt)
            print(
                f"  {kname} {tag}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={lib_txt} {bound_text(bound, need, ops)} "
                f"roofline_share={bound['bound_ms'] / ms:.3f}"
            )
            records[(kname, name, str(dtype))] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **bound,
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
    del runs, outs, flush
    torch.cuda.empty_cache()
    phase_sdd(rng, torch, kops, kref)
    moe_records, moe_launches = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        # one dtype's params at a time: float32's 15.3 GB and its buffers need
        # the bfloat16 layer's memory freed
        state = phase_moe(args, torch, kops, kref, dtype)
        moe_launches[str(dtype)] = state[-1]
        moe_records.update(phase_moe_times(args, torch, kops, kref, *state[:-1], dtype))
        del state
        torch.cuda.empty_cache()

    # K1, K2: u float32 on the first path; K3: float32 at the MoE prefill
    # tables, launched by the float32 layer; beside them the other rows
    final = {k: (records[(k, "u", "torch.float32")], launches[k])
             for k in ("bsr_spmv", "bsr_spmm")}
    final["bsr_sdd"] = (moe_records[("bsr_sdd", "prefill", "torch.float32")],
                        moe_launches["torch.float32"]["bsr_sdd"])
    summary = []
    for kname, (source, replaces) in KERNELS.items():
        rec, n = final[kname]
        extra = {}  # the other rows: u bfloat16 and nu, the MoE tables
        for key, r in (("u_bf16", records.get((kname, "u", "torch.bfloat16"))),
                       ("nu_f32", records.get((kname, "nu", "torch.float32"))),
                       ("nu_bf16", records.get((kname, "nu", "torch.bfloat16"))),
                       *((f"moe_{shape}_{short}", moe_records.get((kname, shape, dt)))
                         for dt, short in (("torch.bfloat16", "bf16"), ("torch.float32", "f32"))
                         for shape in ("prefill", "decode"))):
            if r is not None:
                for k in ("ms", "bound_ms", "library_ms", "fma_bound_ms"):
                    if k in r:
                        extra[f"{key}_{k}"] = r[k]
        summary.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces, launches=n, **rec,
            **extra,
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
