#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N] [--reps N] [--verbose-build]

Phases, each printing its lines:

1. build    builds the CUDA kernels K1 (bsr_spmv) and K2 (bsr_spmm) from
            src/repro_torch/kernels/csrc and prints the build time;
2. kernels  holds each kernel against its plain PyTorch version on random
            sorted tile tables (empty row tiles, n not a multiple of bn,
            odd tiles, float32 and bfloat16);
3. main     drives the port's main path, stage_spmv and stage_spmm
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
            not.

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
    for name, n in launches.items():
        if n == 0:
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

    summary = []
    for kname, (source, replaces) in KERNELS.items():
        rec = records[(kname, "u", "torch.float32")]
        summary.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=launches[kname], **rec,
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
