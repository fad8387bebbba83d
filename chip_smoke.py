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
            bfloat16), each over the element-level CSR;
8. tuning  drives the rest of the staged path on u and nu in float32, in a
            plan cache of its own (a temporary directory): cold tunes
            (stage_spmv/stage_spmm with backend='autotune', the default
            candidates, every cuda[tm x tk] tile of autotune.CUDA_TILES
            among them; the launch counts zeroed just before and read just
            after, K1 and K2 must have launched), each candidate's time and
            the winner printed, the winner held against a float64 numpy
            product and timed beside phase 4's (32, 32) call; a warm restart
            (in-memory caches cleared, a new PlanCache on the same files)
            that must make 0 benchmarks and stage the same options; the
            extended space at nu (reblocking proposals, include_reblock);
            dia_hybrid on a banded 10 000 x 10 000 matrix under splits of 4
            (benchmarks/bench_reblock.py's band, bandwidth 24); the gather
            backend and stage_block_op (a row-sum op) at nu, each checked
            and timed; then K1 and K2 at every tile of the sweep other than
            (32, 32), at u and nu, as in phase 4;
9. serve   drives the port's serving path: llama3-8b-sable (llama3-8b at its
            published widths, each FFN matrix 896 tiles of 128 x 128) through
            ServeEngine.generate, params and compute in bfloat16 from --seed,
            8 prompts of 512 tokens and 64 greedy new tokens, in plan caches
            of its own. First K2 at the FFN shapes (`in` and `out`, prefill
            T = 4096 and decode T = 8, both dtypes) against its plain
            version, timed beside its bound, the plain version,
            torch.sparse_bsr_tensor(...) @ X and the per-call tile gather and
            transpose; a 2-layer model at the same widths in float32, whose
            prefill logits through cuda must match those through grouped
            within 1e-4 of max|logits|. Then the 32-layer model: a cold
            warmup (each pattern's candidate times and winner printed) and a
            warm restart that must stage 0 plans; serve (a) with the
            warmup's pick and (b) with both patterns pinned to cuda by plans
            in the cache, where K2 must launch 96 times a forward (3 FFN
            matmuls x 32 layers; the counts zeroed just before each serve
            and read just after); for each, prefill ms, decode ms a step,
            tokens/s, peak memory and a torch.profiler breakdown of the
            prefill and one decode step by layer (attention, FFN, K2, the
            tile gather and transpose, the head); and how many of the greedy
            tokens (a) and (b) share (reported, not gated).

Bounds: bytes over 3.35 TB/s or operations over the dtype's peak, the
larger; float32's peak is the 3xTF32 rate (494.7 / 3 TFLOP/s), and
fma_bound_ms beside it counts float32 on the FMA pipes (67 TFLOP/s).
Tolerance: max|out - ref| / max|ref| <= 1e-5 in float32, 2e-2 in bfloat16.
Any failure raises. The last two lines are the `kernels` JSON object (K1
and K2 at u in float32 as the rows' own keys, and their other rows as
u_bf16_*, nu_f32_* and nu_bf16_* keys; K3 at the MoE prefill tables in
float32, launched by the float32 pass; moe_{prefill,decode}_{bf16,f32}_*
keys for K2 and K3; tile_{u,nu}_{tm}x{tk}_f32_* keys for K1 and K2 at the
tuner's other tiles, with the launches of phase 8's cold tunes, and
tune_winners; ffn_{prefill,decode}_{bf16,f32}_* and ffn_out_* keys for K2 at
the FFN shapes, with the pinned-cuda serve's launches) and {"ok": true,
"device": {...}}.
Without a CUDA device, or without the package beside this script, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
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
    """The library's product of the tile table with rhs, the tensor built
    once: the call. torch.sparse_bsr_tensor(...) @ rhs for square tiles;
    its product takes no other (an internal assert on this install), so
    tm != tk gets torch.sparse_csr_tensor(...) @ rhs over the tiles'
    elements (padding zeros included), the same function."""
    nb, tm, tk = tiles.shape
    if tm == tk:
        bsr = torch.sparse_bsr_tensor(row_ptr, cols, tiles, size=size, check_invariants=True)
        return lambda: bsr @ rhs
    dev = tiles.device
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(counts.numel(), device=dev), counts)
    er = (rows[:, None, None] * tm + torch.arange(tm, device=dev)[None, :, None]).expand(-1, tm, tk)
    ec = (cols.long()[:, None, None] * tk + torch.arange(tk, device=dev)[None, None, :]).expand(
        -1, tm, tk)
    idx = torch.stack([er.reshape(-1), ec.reshape(-1)])
    csr = torch.sparse_coo_tensor(idx, tiles.reshape(-1), size).coalesce().to_sparse_csr()
    return lambda: csr @ rhs


def band_vbr(n, bw, step, seed):
    """The banded matrix of benchmarks/bench_reblock.py's ``_band`` (row i
    holds float32 standard normals in columns i-bw..i+bw, drawn row by row),
    stored under splits every ``step`` rows and columns that ignore the band,
    as that benchmark stores it; built from its entries, not from a dense
    array (400 MB at n = 10 000). Returns (vbr, rows, cols, values)."""
    import numpy as np

    from repro_torch.core.reblock import build_vbr_from_coo

    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(n):
        lo, hi = max(0, i - bw), min(n, i + bw + 1)
        rows.append(np.full(hi - lo, i))
        cols.append(np.arange(lo, hi))
        vals.append(rng.standard_normal(hi - lo).astype(np.float32))
    rows, cols, vals = (np.concatenate(a) for a in (rows, cols, vals))
    splits = sorted({0, n, *range(0, n, step)})
    v, _ = build_vbr_from_coo(rows, cols, np.arange(len(rows)), splits, splits, (n, n),
                              val=vals)
    return v, rows, cols, vals


def check64(label, out, want):
    """A float32 result against a float64 numpy one, at float32's tolerance."""
    import numpy as np
    import torch

    return check(label, out.float(), torch.as_tensor(np.asarray(want, np.float64)).to(
        out.device).float(), torch.float32)


def phase_tuning(args, torch, kops, kref, mats, call_times, dev):
    """Phase 8: the tuning path at the paper's size, float32, on ``dev``, in
    a plan cache of its own. Returns ({(kernel, matrix, tile): record} for K1
    and K2 at each tile of the sweep other than (32, 32), {kind: {matrix:
    the cold tune's winner}})."""
    import tempfile

    import numpy as np

    from repro_torch.core import autotune as tautotune
    from repro_torch.core import cache as tcache
    from repro_torch.core import reblock as treblock
    from repro_torch.core import staging as tstaging
    from repro_torch.core.dsl import loopgen
    from repro_torch.core.inspect import detect_structure
    from repro_torch.core.vbr import structure_hash
    from repro_torch.kernels import _build

    print("phase 8: tuning path (autotune, plan cache, reblocking, dia_hybrid, gather) at "
          "10000 x 10000, float32")
    n_cols = 128
    rng = np.random.default_rng(args.seed + 8)
    inputs = {name: (torch.as_tensor(v.val, device=dev),
                     rng.standard_normal(v.shape[1]).astype(np.float32),
                     rng.standard_normal((v.shape[1], n_cols)).astype(np.float32))
              for name, v in mats.items()}
    dense = {name: v.to_dense().astype(np.float64) for name, v in mats.items()}
    tmp = tempfile.TemporaryDirectory(prefix="repro-plans-")
    tcache.set_default_cache(tcache.PlanCache(tmp.name))  # no earlier plan is read
    cases = [(name, kind) for name in mats for kind in ("spmv", "spmm")]
    opts = tstaging.StagingOptions(backend="autotune")

    def stage(name, kind):
        v = mats[name]
        return (tstaging.stage_spmv(v, opts, device=dev) if kind == "spmv"
                else tstaging.stage_spmm(v, n_cols, opts, device=dev))

    def plan_of(name, kind, **kw):
        v, n = mats[name], None if kind == "spmv" else n_cols
        return tcache.default_cache().load_plan(tcache.plan_key(
            kind, structure_hash(v), tcache.device_key(dev), n, **kw))

    def check_winner(label, kern, name, kind):
        val, x, X = inputs[name]
        rhs = x if kind == "spmv" else X
        xin = torch.as_tensor(rhs, device=dev)
        y = kern(val, xin)
        torch.cuda.synchronize()
        check64(f"{label} winner vs float64", y, dense[name] @ rhs.astype(np.float64))
        return median_ms(lambda: kern(val, xin), args.reps)

    # -- cold tunes, the default candidate space -----------------------------
    tautotune.reset_autotune_stats()
    kops.reset_launches()
    cold, winners = {}, {"spmv": {}, "spmm": {}}
    for name, kind in cases:
        t0 = time.perf_counter()
        kern = stage(name, kind)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        plan = plan_of(name, kind)
        label = min(plan.timings, key=plan.timings.get)
        cold[(name, kind)] = (kern, plan, label)
        parts = ", ".join(f"{lbl} {t * 1e3:.4f}" for lbl, t in
                          sorted(plan.timings.items(), key=lambda kv: kv[1]))
        print(f"  cold tune {name} {kind}: {secs:.2f} s; candidates ms (median of "
              f"{tautotune.DEFAULT_ITERS}, host clock): {parts}; winner {label} "
              f"({plan.options.backend}, tile {tuple(plan.options.tile)})")
        missing = [f"cuda[{tm}x{tk}]" for tm, tk in tautotune.CUDA_TILES
                   if f"cuda[{tm}x{tk}]" not in plan.timings]
        if missing:
            raise AssertionError(f"cold tune {name} {kind}: no timing for {missing}")
        winners[kind][name] = label
    launches = dict(kops.launches)
    stats = tautotune.autotune_stats()
    print(f"  cold tunes: benchmarks={stats['benchmarks']} plans_tuned={stats['plans_tuned']}; "
          f"kernel launches during the tunes: {launches}")
    for k in ("bsr_spmv", "bsr_spmm"):
        if launches[k] == 0:
            raise AssertionError(f"the tunes never launched {k}")
    for (name, kind), (kern, plan, label) in cold.items():
        ms = check_winner(f"tuned {name} {kind} ({label})", kern, name, kind)
        print(f"  tuned {name} {kind} winner {label}: fn(val, x) ms={ms:.4f} (CUDA events, "
              f"median of {args.reps}); phase 4's cuda (32, 32) ms="
              f"{call_times[(name, kind, 'torch.float32')]:.4f}")

    # -- warm restart: in-memory caches gone, a new PlanCache on the files ---
    tstaging.clear_cache()  # the reblock and DIA memos too
    tautotune.reset_autotune_stats()
    tcache.set_default_cache(tcache.PlanCache(tmp.name))
    t0 = time.perf_counter()
    warm = {case: stage(*case) for case in cases}
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    stats = tautotune.autotune_stats()
    print(f"  warm restart: staged {len(cases)} cases in {secs:.2f} s, "
          f"benchmarks={stats['benchmarks']} cache_hits={stats['cache_hits']}")
    if stats["benchmarks"] != 0:
        raise AssertionError(f"warm restart made {stats['benchmarks']} benchmarks")
    for case, kern in warm.items():
        if kern.opts != cold[case][0].opts:
            raise AssertionError(f"warm restart of {case} staged {kern.opts}, "
                                 f"not {cold[case][0].opts}")

    # -- the extended space at nu ----------------------------------------------
    nu = mats["nu"]
    t0 = time.perf_counter()
    specs = treblock.propose_reblockings(nu, device=dev)
    print(f"  reblock proposals for nu ({time.perf_counter() - t0:.2f} s): " + "; ".join(
        f"{sp.strategy} fill_ratio={sp.fill_ratio:.4f} cost={sp.cost:.0f} "
        f"(as given {sp.base_cost:.0f})" for sp in specs))
    for kind in ("spmv", "spmm"):
        t0 = time.perf_counter()
        kern = tautotune.autotune_stage(nu, kind, None if kind == "spmv" else n_cols,
                                        include_reblock=True, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        plan = plan_of("nu", kind, reblock=True)
        label = min(plan.timings, key=plan.timings.get)
        parts = ", ".join(f"{lbl} {t * 1e3:.4f}" for lbl, t in
                          sorted(plan.timings.items(), key=lambda kv: kv[1]))
        print(f"  extended tune nu {kind}: {secs:.2f} s; candidates ms: {parts}; winner "
              f"{label}; a reblocked candidate won: {plan.reblock is not None}")
        ms = check_winner(f"extended tune nu {kind} ({label})", kern, "nu", kind)
        print(f"  extended tune nu {kind} winner {label}: fn(val, x) ms={ms:.4f}")

    # -- dia_hybrid on a banded matrix -----------------------------------------
    t0 = time.perf_counter()
    band, rows, cols, vals = band_vbr(10_000, 24, 4, args.seed)
    info = detect_structure(band)
    print(f"  band 10000 x 10000, bandwidth 24, splits of 4: blocks={band.num_blocks} "
          f"stored={band.stored_nnz} class={info.structure_class} "
          f"diag_occupancy={info.diag_occupancy:.3f} dense diagonals="
          f"{len(info.dense_offsets)} wants_dia={info.wants_dia} "
          f"({time.perf_counter() - t0:.2f} s)")
    if not info.wants_dia:
        raise AssertionError("the banded matrix does not want dia_hybrid")
    t0 = time.perf_counter()
    kd = tstaging.stage_spmv(band, tstaging.StagingOptions(backend="dia_hybrid"), device=dev)
    secs = time.perf_counter() - t0
    xb = rng.standard_normal(band.shape[1]).astype(np.float32)
    want = np.bincount(rows, weights=vals.astype(np.float64) * xb[cols], minlength=band.shape[0])
    bval, bx = torch.as_tensor(band.val, device=dev), torch.as_tensor(xb, device=dev)
    check64(f"dia_hybrid band ({kd.num_diagonals} diagonals, remainder {kd.remainder_nnz} "
            f"stored slots on {kd._rem.backend if kd._rem else None})", kd(bval, bx), want)
    print(f"  dia_hybrid band: staged in {secs:.2f} s, fn(val, x) "
          f"ms={median_ms(lambda: kd(bval, bx), args.reps):.4f}")

    # -- gather and stage_block_op at nu ---------------------------------------
    val, x, X = inputs["nu"]
    for kind, rhs in (("spmv", x), ("spmm", X)):
        t0 = time.perf_counter()
        gopts = tstaging.StagingOptions(backend="gather")
        kg = (tstaging.stage_spmv(nu, gopts, device=dev) if kind == "spmv"
              else tstaging.stage_spmm(nu, n_cols, gopts, device=dev))
        secs = time.perf_counter() - t0
        xin = torch.as_tensor(rhs, device=dev)
        check64(f"gather nu {kind}", kg(val, xin), dense["nu"] @ rhs.astype(np.float64))
        print(f"  gather nu {kind}: staged in {secs:.2f} s, fn(val, x) "
              f"ms={median_ms(lambda: kg(val, xin), args.reps):.4f}")

    def scale_rowsum(r1, r2, blk, x, out):
        def body(i, j):
            out[i] += blk[(j - r2.start) * len(r1) + (i - r1.start)] * x[j]

        loopgen(r1, lambda i: loopgen(r2, lambda j: body(i, j)))

    t0 = time.perf_counter()
    fn = tstaging.stage_block_op(nu, scale_rowsum, extra_arrays=("x",), device=dev)
    secs = time.perf_counter() - t0
    want = np.zeros(nu.shape[0])
    for t in nu.blocks():  # a numpy loop over the blocks
        blk = nu.val[t.val_offset:t.val_offset + t.size].reshape(t.width, t.height).T
        want[t.row_start:t.row_end] += blk.astype(np.float64) @ x[t.col_start:t.col_end]
    xin, out0 = torch.as_tensor(x, device=dev), torch.zeros(nu.shape[0], device=dev)
    check64("stage_block_op scale_rowsum nu vs a numpy loop", fn(val, xin, out0), want)
    print(f"  stage_block_op scale_rowsum nu: staged in {secs:.2f} s, call "
          f"ms={median_ms(lambda: fn(val, xin, out0), args.reps):.4f}")
    del dense, warm, cold
    tcache.set_default_cache(None)
    tmp.cleanup()

    # -- K1 and K2 at the sweep's other tiles, as in phase 4 ------------------
    # (the tunes' picks among near-equal candidates vary from run to run, so
    # every tile the tuner may pick is timed)
    records = {}
    ext, flush = _build.load_kernels(), l2_flush(torch)
    for name, v in mats.items():
        val, x, X = inputs[name]
        for tile in tautotune.CUDA_TILES:
            if tile == (32, 32):
                continue
            o = tstaging.StagingOptions(backend="cuda", tile=tile)
            ks, km = tstaging.stage_spmv(v, o, device=dev), tstaging.stage_spmm(v, n_cols, o,
                                                                                 device=dev)
            tag = f"{name} float32 tile {tile[0]}x{tile[1]}"
            for kname, rec in time_kernels(args, torch, kref, ext, flush, ks, km, val,
                                           torch.as_tensor(x, device=dev),
                                           torch.as_tensor(X, device=dev), tag).items():
                records[(kname, name, tile)] = dict(rec, launches=launches[kname])
            tstaging.clear_cache()
    del flush
    torch.cuda.empty_cache()
    return records, winners


def time_kernels(args, torch, kref, ext, flush, ks, km, val, x, X, tag, profile=False):
    """K1 and K2 at the tables of the staged 'cuda' kernels ``ks`` (SpMV) and
    ``km`` (SpMM) on ``val``, with the schedules they built: each held
    against its plain version and timed beside it, its bound and the library
    call, after an L2 flush; in float32 the last timed launch must give the
    first one's bits. ``profile``: each kernel's own launches under
    torch.profiler too. Returns {kernel name: record}."""
    dev = val.device
    t = ks.tiled
    n_cols = X.shape[1]
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
    records = {}
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
        err = check(f"{kname} {tag} kernel vs plain (main-path tables)", out, want, dt)
        first = out.clone()
        ms = median_ms(launch, args.reps, flush)
        if dt == torch.float32:  # the last timed launch against the first
            same_bits(f"{kname} {tag} main-path tables", first, out)
        del first
        if profile:  # the kernel's own launches, the cut row tiles' join beside it
            device_breakdown(torch, f"{kname} {tag} (L2 not flushed)", launch)
        plain_ms = median_ms(plain, args.reps, flush)
        # in the row's own dtype: (tm, tk) blocks, as the kernels take them
        lib_name = "sparse_bsr_tensor" if t.tm == t.tk else "sparse_csr_tensor"
        lib_ms, lib_txt = library_time(
            f"{kname} {tag} library call {lib_name}(...) @ x",
            lambda: bsr_call(torch, rptr, cols, tiles, (t.m_pad, t.k_pad), rhs),
            want, dt, args.reps, select=lambda r: r.reshape(want.shape), before=flush)
        del want
        need = sum(a.numel() * a.element_size() for a in (tiles, rptr, cols, xin, out))
        ops = flops_per * tiles.numel()
        bound = bound_fields(need, ops, dt)
        print(
            f"  {kname} {tag}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_txt} {bound_text(bound, need, ops)} "
            f"roofline_share={bound['bound_ms'] / ms:.3f}"
        )
        records[kname] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              **bound)
    return records


# ---------------------------------------------------------------------- #
# phase 9: serving llama3-8b-sable
# ---------------------------------------------------------------------- #
SERVE_B, SERVE_P, SERVE_G = 8, 512, 64  # prompts, prompt tokens, new tokens
SERVE_TOL = 1e-4  # 2-layer float32 logits, cuda vs grouped, over max|logits|


def serve_modules():
    from repro_torch.configs import get_config
    from repro_torch.core import autotune as tautotune
    from repro_torch.core import cache as tcache
    from repro_torch.models import config as tconfig
    from repro_torch.models import layers as tlayers
    from repro_torch.models import transformer as ttr
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sparse import linear as tlin

    return dict(get_config=get_config, tautotune=tautotune, tcache=tcache, tconfig=tconfig,
                tlayers=tlayers, ttr=ttr, ServeEngine=ServeEngine, tlin=tlin)


def pin_strategy(m, patterns, backend: str, dev) -> None:
    """Store a plan naming ``backend`` for each pattern in the default plan
    cache and empty the in-process registry, so that the next engine loads
    them: the reference's own mechanism for a chosen strategy."""
    from repro_torch.core.staging import StagingOptions

    tcache, tlin = m["tcache"], m["tlin"]
    for p in patterns:
        h = tlin.pattern_hash(p)
        tcache.default_cache().store_plan(
            tcache.plan_key("linear", h, tcache.device_key(dev)),
            tcache.TuningPlan(kind="linear", structure_hash=h, device=tcache.device_key(dev),
                              options=StagingOptions(backend=backend, tile=(p.tm, p.tk)),
                              meta={"pinned": True}, source="heuristic"))
    tlin._STRATEGY_REGISTRY.clear()


def time_ffn_k2(args, torch, kops, kref, m, dev):
    """K2 at the FFN shapes (896 tiles of 128 x 128; `in`: X (4096, T) ->
    (14336, T), `out`: X (14336, T) -> (4096, T)) at prefill T = 4096 and
    decode T = 8, in both dtypes, on the tables and the transposed tiles the
    cuda strategy builds: each held against its plain version, timed beside
    it, its bound and torch.sparse_bsr_tensor(...) @ X, after an L2 flush;
    and the per-call tile gather and transpose alone."""
    from repro_torch.kernels import _build

    tlin = m["tlin"]
    ext, flush = _build.load_kernels(), l2_flush(torch)
    cfg = m["get_config"]("llama3-8b-sable")
    pats = m["tlayers"].sable_patterns(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 9)
    records = {}
    print("phase 9a: K2 at llama3-8b-sable's FFN shapes (896 tiles of 128 x 128)")
    for pname, pat in pats.items():
        t = tlin._tables(pat, dev)
        for shape, T in (("prefill", SERVE_B * SERVE_P), ("decode", SERVE_B)):
            for dtype in (torch.bfloat16, torch.float32):
                dname = str(dtype)[6:]
                tiles = (torch.randn((pat.n_tiles, pat.tm, pat.tk), generator=gen, device=dev)
                         / pat.d_in ** 0.5).to(dtype)
                X = torch.randn((pat.d_in, T), generator=gen, device=dev).to(dtype)
                tiles_t = tlin._transposed_tiles(tiles, t.order)
                sched = t.schedule(T, dtype)
                y = kops.bsr_spmm(tiles_t, t.row_ids, t.col_ids, X, m_pad=pat.d_out,
                                  row_ptr=t.row_ptr, schedule=sched, device=dev)
                torch.cuda.synchronize()
                plain = lambda: kref.bsr_spmm_ref(tiles_t, t.row_ids, t.col_ids, X,  # noqa: E731
                                                  pat.d_out)
                want = plain()
                tag = f"bsr_spmm ffn {pname} {shape} T={T} {dname}"
                err = check(f"{tag} kernel vs plain", y, want, dtype)
                if dtype == torch.float32:
                    partial = torch.empty(2 * sched.shape[0] * pat.tk * T, dtype=torch.float32,
                                          device=dev)
                else:
                    sched = partial = torch.empty(0, device=dev)
                launch = lambda: ext.bsr_spmm(tiles_t, t.row_ptr, t.col_ids, X, y,  # noqa: E731
                                              sched, partial)
                ms = median_ms(launch, args.reps, flush)
                plain_ms = median_ms(plain, args.reps, flush)
                lib_ms, lib_txt = library_time(
                    f"{tag} library call sparse_bsr_tensor(...) @ X",
                    lambda: bsr_call(torch, t.row_ptr, t.col_ids, tiles_t,
                                     (pat.d_out, pat.d_in), X),
                    want, dtype, args.reps, before=flush)
                tr_ms = median_ms(lambda: tlin._transposed_tiles(tiles, t.order), args.reps,
                                  flush)
                need = nbytes(tiles_t, t.row_ptr, t.col_ids, X, y)
                ops = 2 * tiles_t.numel() * T
                bound = bound_fields(need, ops, dtype)
                print(f"  {tag}: ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_txt} "
                      f"{bound_text(bound, need, ops)} roofline_share={bound['bound_ms'] / ms:.3f}"
                      f"; tile gather+transpose alone ms={tr_ms:.4f} "
                      f"({2 * nbytes(tiles)} B moved)")
                records[(pname, shape, dname)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                                      library_ms=lib_ms, transpose_ms=tr_ms,
                                                      **bound)
                del tiles, X, tiles_t, y, want
        torch.cuda.empty_cache()
    return records


def check_two_layers(args, torch, kops, m, dev):
    """A 2-layer llama3-8b-sable at full width in float32: the prefill
    logits through cuda (K2) against those through grouped, both pinned by
    plans, at SERVE_TOL of max|logits|; K2 launches 3 times a layer."""
    tconfig = m["tconfig"]
    ttr = m["ttr"]
    cfg = replace(m["get_config"]("llama3-8b-sable"), compute_dtype="float32",
                  param_dtype="float32",
                  groups=tconfig.uniform_groups(2, tconfig.LayerSpec(mixer="gqa", ffn="dense")))
    pats = list(m["tlayers"].sable_patterns(cfg).values())
    gen = torch.Generator(device=dev).manual_seed(args.seed + 10)
    params = ttr.init_params(cfg, gen, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_P), generator=gen, device=dev)
    logits = {}
    for strategy in ("grouped", "cuda"):
        pin_strategy(m, pats, strategy, dev)
        before = kops.launches["bsr_spmm"]
        with torch.inference_mode():
            logits[strategy], _ = ttr.prefill(params, cfg, prompts,
                                              ttr.init_cache(cfg, SERVE_B, SERVE_P, device=dev))
        torch.cuda.synchronize()
        n = kops.launches["bsr_spmm"] - before
        if n != (6 if strategy == "cuda" else 0):
            raise AssertionError(f"2-layer prefill through {strategy}: {n} K2 launches")
    err, rel = rel_err(logits["cuda"], logits["grouped"])
    ok = rel <= SERVE_TOL and bool(torch.isfinite(logits["cuda"]).all())
    print(f"  2 layers at full width, float32, prefill B={SERVE_B} P={SERVE_P}: logits through "
          f"cuda vs grouped max_abs_err={err:.3e} rel={rel:.3e} tol={SERVE_TOL:g} "
          f"{'ok' if ok else 'FAIL'} (K2 launched 6 times through cuda, 0 through grouped)")
    if not ok:
        raise AssertionError(f"2-layer float32 logits: relative error {rel:.3e}")
    del params, logits
    torch.cuda.empty_cache()


class annotated:
    """Within the block, the serving path's layers run inside
    torch.profiler.record_function ranges (module attributes wrapped and
    restored), so that a profile attributes device time to them."""

    def __init__(self, torch, m):
        ttr, tlin = m["ttr"], m["tlin"]
        self.targets = [(ttr, "gqa_apply", "attention (gqa_apply)"),
                        (ttr, "ffn_apply", "FFN (ffn_apply)"),
                        (ttr, "_unembed", "head (final norm, lm_head)"),
                        (ttr, "_embed", "embedding"),
                        (tlin, "_transposed_tiles", "FFN: tile gather+transpose")]
        self.torch = torch

    def __enter__(self):
        self.saved = []
        for mod, attr, label in self.targets:
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, fn))

            def wrapped(*a, _fn=fn, _label=label, **k):
                with self.torch.profiler.record_function(_label):
                    return _fn(*a, **k)

            setattr(mod, attr, wrapped)
        return [label for _, _, label in self.targets]

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)


def serve_breakdown(torch, m, label, fn):
    """One call of ``fn`` under torch.profiler inside ``annotated``: device
    time (each range's kernels, summed) by layer, K2's and the elementwise
    kernels' own time, and the device's busy share of the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with annotated(torch, m) as labels:
        fn()
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    # a range's device time: the kernels of the operations inside it, each
    # operation's once. The profiler links a kernel to every event that
    # carries its operation's id, and an overhead event (a full launch
    # queue) carries it too, so device_time_total would count it twice.
    ranges = dict.fromkeys(labels, 0.0)
    seen = {label: set() for label in labels}
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        ms = sum(k.duration for k in e.kernels) / 1e3
        p = e
        while p is not None:
            if p.name in ranges and e.id not in seen[p.name]:
                seen[p.name].add(e.id)
                ranges[p.name] += ms
            p = p.cpu_parent
    spans = [(e.time_range.start / 1e3, e.time_range.end / 1e3, e.name) for e in events
             if e.device_type == DeviceType.CUDA and e.name not in ranges
             and e.time_range.end > e.time_range.start]
    table, busy = own_times(spans)
    if busy == 0:
        print(f"  profile {label}: device time not measured (the profiler saw none)")
        return None
    # K2 is launched from its binding, which the profiler links to no range:
    # its kernels' own time goes to the FFN by name
    k2 = sum(row[0] for k, row in table.items() if "bsr_spmm" in k or "combine_kernel" in k)
    ranges[labels[1]] += k2
    elem = sum(row[0] for k, row in table.items() if "elementwise" in k.lower())
    top = sorted(((row[0], row[2], k) for k, row in table.items()), reverse=True)[:5]
    other = busy - sum(ranges[k] for k in labels[:4])
    parts = "; ".join(f"{k} {v:.3f}" for k, v in ranges.items())
    print(f"  profile {label}: device busy {busy:.3f} of {wall_ms:.3f} ms wall (share "
          f"{busy / wall_ms:.3f}); by layer, ms: {parts}; FFN: K2 kernels {k2:.3f}; outside "
          f"those (norms, residual adds) {other:.3f}; elementwise kernels' own time "
          f"{elem:.3f}; top kernels: "
          + "; ".join(f"{k[:50]} x{n} {own:.3f}" for own, n, k in top))
    return dict(busy_ms=busy, wall_ms=wall_ms, k2_ms=k2, elementwise_ms=elem, **ranges)


def dispatch_host_time(tlin, p, dev, per_step: int, calls: int = 1000, rounds: int = 7):
    """Host clock, median of ``rounds`` rounds of ``calls``: the lookups each
    FFN matmul makes before its launch (the pattern's plan and its tables),
    and one hash of a pattern's fields, which each of those lookups paid
    before the pattern cached its hash."""
    fields = (p.d_in, p.d_out, p.tm, p.tk, p.rows, p.cols)

    def lookups():
        tlin.choose_matmul_strategy(p, device=dev)
        tlin._tables(p, dev)

    def per_call_us(fn):
        times = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) / calls * 1e6)
        return statistics.median(times)

    look, hashed = per_call_us(lookups), per_call_us(lambda: hash(fields))
    print(f"  FFN dispatch on the host (host clock, median of {rounds} x {calls}): plan and "
          f"tables lookup {look:.3f} us a matmul, {look * per_step / 1e3:.4f} ms a decode step "
          f"({per_step} matmuls); a hash of the pattern's fields ({p.n_tiles} tiles) "
          f"{hashed:.3f} us, {2 * hashed * per_step / 1e3:.4f} ms a step at two a matmul")


def step_bounds(cfg, params, batch, prompt, max_len):
    """Bytes and operations a decode step and the prefill need at least:
    every weight read once (the embedding's rows aside), the KV cache read
    over max_len positions (as the path attends over the whole cache), and
    the FFN tiles' per-call gather and transpose (read and write) beside."""
    kv = cfg.n_kv_heads * cfg.head_dim
    layers = cfg.n_layers
    es = 2  # bfloat16
    gp = params["groups"][0]["sub0"]
    attn = sum(v.numel() for v in gp["mixer"].values())
    ffn = sum(v.numel() for v in gp["ffn"].values())
    head = params["lm_head"].numel()
    weights = (attn + ffn + head) * es
    kv_bytes = 2 * layers * batch * max_len * kv * es
    transpose = 2 * ffn * es
    T = batch * prompt
    # projections and FFN over T tokens, scores and values over the whole
    # cache, the head at the last position
    prefill_ops = (2 * T * (attn + ffn) + layers * 4 * batch * cfg.n_heads * prompt
                   * max_len * cfg.head_dim + 2 * batch * cfg.d_model * cfg.vocab_size)
    return dict(weights=weights, kv=kv_bytes, transpose=transpose, prefill_ops=prefill_ops)


class temp_plans:
    """Within the block, the default plan cache is a new one in a temporary
    directory, and the in-process strategy registry starts empty: no plan
    from earlier runs or phases is read."""

    def __init__(self, m):
        self.m = m

    def __enter__(self):
        import tempfile

        self.tmp = tempfile.TemporaryDirectory(prefix="repro-serve-plans-")
        self.m["tcache"].set_default_cache(self.m["tcache"].PlanCache(self.tmp.name))
        self.m["tlin"]._STRATEGY_REGISTRY.clear()

    def __exit__(self, *exc):
        self.m["tcache"].set_default_cache(None)
        self.m["tlin"]._STRATEGY_REGISTRY.clear()
        self.tmp.cleanup()


def phase_serve(args, torch, kops, kref, dev):
    """Phase 9: llama3-8b-sable served at full width. Returns (K2's FFN
    records, the pinned-cuda serve's K2 launches)."""
    m = serve_modules()
    records = time_ffn_k2(args, torch, kops, kref, m, dev)
    print("phase 9b: checks at full width")
    with temp_plans(m):
        check_two_layers(args, torch, kops, m, dev)
    with temp_plans(m):
        launches = serve_llama(args, torch, kops, m, dev)
    return records, launches


def serve_llama(args, torch, kops, m, dev):
    from repro_torch.serve.engine import _leaves

    tcache, tlin, ttr, tautotune = m["tcache"], m["tlin"], m["ttr"], m["tautotune"]
    ServeEngine = m["ServeEngine"]
    cfg = replace(m["get_config"]("llama3-8b-sable"), param_dtype="bfloat16")
    pats = m["tlayers"].sable_patterns(cfg)
    B, P, G = SERVE_B, SERVE_P, SERVE_G
    max_len = P + G
    print(f"phase 9c: serve llama3-8b-sable at full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}; FFN matrices of {pats['in'].n_tiles} tiles of "
          f"{pats['in'].tm} x {pats['in'].tk}), params and compute in bfloat16; "
          f"B={B} prompts of {P} tokens, {G} greedy new tokens, max_len {max_len}")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    params = ttr.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    gp = params["groups"][0]["sub0"]
    counts = {
        "attention": sum(v.numel() for v in gp["mixer"].values()),
        "FFN tiles": sum(v.numel() for v in gp["ffn"].values()),
        "embed and head": params["embed"].numel() + params["lm_head"].numel(),
    }
    total = sum(v.numel() for _, v in _leaves(params))
    print(f"  params: {total / 1e9:.4f} G ({', '.join(f'{k} {v / 1e9:.4f} G' for k, v in counts.items())}), "
          f"{total * 2 / 1e9:.3f} GB in bfloat16, drawn in {time.perf_counter() - t0:.2f} s")
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device=dev)
    b = step_bounds(cfg, params, B, P, max_len)
    bw = HBM_BYTES_PER_S / 1e3
    print(f"  decode-step bound: weights {b['weights'] / 1e9:.4f} GB + KV cache "
          f"{b['kv'] / 1e9:.4f} GB -> {(b['weights'] + b['kv']) / bw:.4f} ms (bytes); the "
          f"cuda strategy's per-call tile gather+transpose adds {b['transpose'] / 1e9:.4f} GB "
          f"-> {(b['weights'] + b['kv'] + b['transpose']) / bw:.4f} ms; prefill bound "
          f"{max(b['prefill_ops'] / 989e9, (b['weights'] + b['kv']) / bw):.4f} ms "
          f"({b['prefill_ops'] / 1e12:.2f} TFLOP)")

    # -- warmup: cold, then a warm restart --------------------------------------
    tautotune.reset_autotune_stats()
    t0 = time.perf_counter()
    engine = ServeEngine(cfg, params, max_len=max_len, device=dev)
    secs = time.perf_counter() - t0
    for name, p in pats.items():
        h = tlin.pattern_hash(p)
        plan = tcache.default_cache().load_plan(
            tcache.plan_key("linear", h, tcache.device_key(dev)))
        parts = ", ".join(f"{k} {v * 1e3:.4f}" for k, v in sorted(plan.timings.items()))
        print(f"  warmup, pattern {name} ({h}): candidates ms (host clock, median of 3, float32, "
              f"batch 8): {parts}; winner {plan.options.backend}")
    print(f"  warmup ({secs:.2f} s): warmup_stats={engine.warmup_stats} "
          f"benchmarks={tautotune.autotune_stats()['benchmarks']}")
    if engine.warmup_stats["warm_start"] or engine.warmup_stats["plans_staged"] != len(pats):
        raise AssertionError(f"the first warmup was not cold: {engine.warmup_stats}")
    tlin._STRATEGY_REGISTRY.clear()
    tautotune.reset_autotune_stats()
    warm = ServeEngine(cfg, params, max_len=max_len, device=dev)
    bench = tautotune.autotune_stats()["benchmarks"]
    print(f"  warm restart: warmup_stats={warm.warmup_stats} benchmarks={bench}")
    if not warm.warmup_stats["warm_start"] or warm.warmup_stats["plans_staged"] or bench:
        raise AssertionError(f"warm restart staged plans: {warm.warmup_stats}, {bench} benchmarks")
    if warm.sparse_plans != engine.sparse_plans:
        raise AssertionError(f"warm restart loaded {warm.sparse_plans}, not {engine.sparse_plans}")
    del warm

    # -- (a) the warmup's pick, (b) both patterns pinned to cuda -----------------
    outs, launches = {}, {}
    for tag in ("a", "b"):
        if tag == "b":
            pin_strategy(m, pats.values(), "cuda", dev)
            engine = ServeEngine(cfg, params, max_len=max_len, device=dev)
        picks = {n: tlin.choose_matmul_strategy(p, device=dev) for n, p in pats.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kops.reset_launches()
        out, stats = engine.generate(prompts, G)
        launches[tag] = dict(kops.launches)
        peak = torch.cuda.max_memory_allocated() / 1e9
        outs[tag] = out
        new = out[:, P:]
        if tuple(out.shape) != (B, P + G) or not bool(((new >= 0) & (new < cfg.vocab_size)).all()):
            raise AssertionError(f"serve ({tag}): tokens {tuple(out.shape)} out of range")
        n_k2 = launches[tag]["bsr_spmm"]
        # the in pattern carries two of a layer's three FFN matmuls (w1, w3)
        want_k2 = ((2 if picks["in"] == "cuda" else 0) + (picks["out"] == "cuda")) * (
            cfg.n_layers * G)
        print(f"  serve ({tag}) strategies {picks}: prefill ms={stats['prefill_s'] * 1e3:.3f} "
              f"decode ms/step={stats['decode_s'] * 1e3 / (G - 1):.3f} "
              f"tokens/s={stats['tokens_per_s']:.1f} (B x new tokens / decode s) "
              f"peak GB={peak:.3f}; K2 launches {n_k2} over {G} forwards "
              f"({n_k2 / G:g} a forward, expected {want_k2 // G})")
        if n_k2 != want_k2 or (tag == "b" and n_k2 == 0):
            raise AssertionError(f"serve ({tag}): {n_k2} K2 launches, expected {want_k2}")
        with torch.inference_mode():
            cache = ttr.init_cache(cfg, B, max_len, device=dev)
            serve_breakdown(torch, m, f"serve ({tag}) prefill B={B} P={P}",
                            lambda: engine._prefill(prompts, cache))
            tok = out[:, P:P + 1]
            serve_breakdown(torch, m, f"serve ({tag}) one decode step at position {P}",
                            lambda: engine._decode(tok, cache, P, 0.0, None))
            del cache
    dispatch_host_time(tlin, pats["in"], dev, 3 * cfg.n_layers)
    same = int((outs["a"][:, P:] == outs["b"][:, P:]).sum())
    first = int((outs["a"][:, P] == outs["b"][:, P]).sum())
    print(f"  serves (a) and (b): {same} of {B * G} greedy tokens agree; prefill top-1 agrees "
          f"on {first} of {B} prompts (reported, not gated: bfloat16 paths differ)")
    del params, engine, outs
    torch.cuda.empty_cache()
    return launches["b"]["bsr_spmm"]


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
    records, call_times = {}, {}
    for name, dtype, ks, km, val, x, X in runs:
        tag = f"{name} {str(dtype)[6:]}"
        for kname, rec in time_kernels(args, torch, kref, ext, flush, ks, km, val, x, X,
                                       tag, profile=name == "u").items():
            records[(kname, name, str(dtype))] = rec
        for kind, k, dense_x in (("spmv", ks, x), ("spmm", km, X)):
            # the same staged call on values packed once
            kp = (stage_spmv(mats[name], replace(k.opts, prepack=True)) if kind == "spmv"
                  else stage_spmm(mats[name], n_cols, replace(k.opts, prepack=True)))
            packed = kp.pack(val)
            call_ms = median_ms(lambda: k(val, dense_x), args.reps)
            packed_ms = median_ms(lambda: kp(packed, dense_x), args.reps)
            print(f"  stage_{kind} {tag}: fn(val, x) ms={call_ms:.4f} prepacked ms={packed_ms:.4f}")
            call_times[(name, kind, str(dtype))] = call_ms
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

    # -- phase 8 -----------------------------------------------------------
    tile_records, winners = phase_tuning(args, torch, kops, kref, mats, call_times, dev)

    # -- phase 9 -----------------------------------------------------------
    ffn_records, serve_k2 = phase_serve(args, torch, kops, kref, dev)
    short = {"bfloat16": "bf16", "float32": "f32"}
    ffn_rows = [  # K2 at the FFN shapes: ffn_* the `in` pattern, ffn_out_* the `out` one
        (f"ffn{'' if p == 'in' else '_out'}_{shape}_{short[d]}", dict(r, launches=serve_k2))
        for (p, shape, d), r in ffn_records.items()
    ]

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
                         for shape in ("prefill", "decode")),
                       # the sweep's other tiles, float32
                       *((f"tile_{mat}_{tm}x{tk}_f32", r) for (k, mat, (tm, tk)), r
                         in tile_records.items() if k == kname),
                       # the served model's FFN shapes; launches: the pinned-cuda serve
                       *(ffn_rows if kname == "bsr_spmm" else ())):
            if r is not None:
                for k in ("ms", "bound_ms", "library_ms", "fma_bound_ms", "plain_ms",
                          "launches", "transpose_ms"):
                    if k in r:
                        extra[f"{key}_{k}"] = r[k]
        if kname in ("bsr_spmv", "bsr_spmm"):  # phase 8's cold tunes' winners
            extra["tune_winners"] = winners["spmv" if kname == "bsr_spmv" else "spmm"]
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
