#!/usr/bin/env python3
"""K3's float32 body (3xTF32 in ``runs.cuh``) against variants of itself, on
one CUDA card, in turns within one process.

    python3 tools/sdd_f32_variants.py [--reps N] [--seed N]

Each variant is the port's kernel sources with one text patch, built as its
own extension into ``build/sdd_variants/<name>/`` (gitignored):

- ``shipped``: the sources as they are;
- ``cvt_rna``: both TF32 parts by ``cvt.rna.tf32.f32`` (hi, and lo = the
  rounded rest) in place of the integer rounding of hi and the raw rest;
- ``cvt_lo``: the integer rounding of hi, lo by ``cvt.rna.tf32.f32``;
- ``chains4``: each step's 12 products of a group in four tensor-core
  accumulators (one per k half and m tile) in place of two.

Tables like the dropless MoE's at DeepSeek-V2-236B's widths (160 experts,
bm 8, bn 1536, K 5120): prefill, 4 token groups of 512 tokens, and decode,
1 group of 64, each token routed to 6 experts drawn uniformly from --seed,
each (group, expert) bucket's tokens in consecutive blocks of 8 and
padding slots at the end, as the dropless topology lays them out. Per
variant and table: K3's median time over --reps CUDA-event timed launches,
at prefill also with the slots ordered by expert (one run per expert), its
error against the plain version on 64 sampled slots, and whether a second
launch gives the same bits. Exits non-zero without a card.

A one-off measurement (PERF.md, "Variants of the float32 body"): it
patches exact lines of ``runs.cuh`` and leans on ``chip_smoke.py``'s
helpers and ``_build``'s private names, so it stops with an error once
any of those change; delete it then rather than mend it.
"""
from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SPLIT = """  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));"""
CVT_HI = """  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));
  hi &= 0xffffe000u;"""
CVT_LO = """  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));"""
INT_HI = SPLIT.splitlines()[0]
STEP = """      float d[2][4] = {};  // this step's products: the tensor cores' own accumulator
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_tf32(d[mt], wl[kh][mt], ah[2 * kh], ah[2 * kh + 1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_tf32(d[mt], wh[kh][mt], al[2 * kh], al[2 * kh + 1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_tf32(d[mt], wh[kh][mt], ah[2 * kh], ah[2 * kh + 1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][g][i] += d[mt][i];"""
STEP4 = """      float d[2][2][4] = {};  // [k half][m tile]
#pragma unroll
      for (int kh = 0; kh < 2; ++kh)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_tf32(d[kh][mt], wl[kh][mt], ah[2 * kh], ah[2 * kh + 1]);
          mma_tf32(d[kh][mt], wh[kh][mt], al[2 * kh], al[2 * kh + 1]);
          mma_tf32(d[kh][mt], wh[kh][mt], ah[2 * kh], ah[2 * kh + 1]);
        }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][g][i] += d[0][mt][i] + d[1][mt][i];"""
VARIANTS = {
    "shipped": [],
    "cvt_rna": [(SPLIT, CVT_HI + "\n" + CVT_LO)],
    "cvt_lo": [(SPLIT, INT_HI + "\n" + CVT_LO)],
    "chains4": [(STEP, STEP4)],
}


def build(name, patches):
    from torch.utils.cpp_extension import load

    from repro_torch.kernels import _build

    out = ROOT / "build" / "sdd_variants" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build._CSRC, out / "csrc")
    runs = out / "csrc" / "runs.cuh"
    text = runs.read_text()
    for old, new in patches:
        if old not in text:
            raise RuntimeError(f"{name}: runs.cuh no longer holds the text this variant patches")
        text = text.replace(old, new)
    runs.write_text(text)
    (out / "obj").mkdir()
    return load(name=f"sdd_variant_{name}", sources=[str(out / "csrc" / s) for s in _build._SOURCES],
                build_directory=str(out / "obj"), extra_cflags=["-O2"],
                extra_cuda_cflags=_build._CUDA_FLAGS)


def moe_like_tables(torch, rng, groups, tokens, E=160, top_k=6, bm=8):
    """(rows, cols, n_row_blocks, n_valid) as the dropless topology lays
    out G x E buckets of capacity `tokens`, padding slots last."""
    import numpy as np

    cb = tokens // bm
    counts = np.zeros((groups, E), dtype=np.int64)
    for g in range(groups):
        for _ in range(tokens):
            counts[g, rng.choice(E, top_k, replace=False)] += 1
    rows, cols = [], []
    for g in range(groups):
        for e in range(E):
            n = -(-counts[g, e] // bm)
            rows += [(g * E + e) * cb + j for j in range(n)]
            cols += [e] * n
    n_rb, n_valid = groups * E * cb, len(rows)
    nnz = min(groups * tokens * top_k // bm + groups * E, n_rb)
    rows += [n_rb] * (nnz - n_valid)
    cols += [0] * (nnz - n_valid)
    dev = torch.device("cuda")
    as_t = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    return as_t(rows), as_t(cols), n_rb, n_valid


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("sdd_f32_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from chip_smoke import median_ms, rel_err
    from repro_torch.kernels import ref

    exts = {name: build(name, patches) for name, patches in VARIANTS.items()}
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    bm, bn, K, E = 8, 1536, 5120, 160
    w = torch.randn((E, K, bn), generator=gen, device="cuda").permute(1, 0, 2)
    for table, groups, tokens in (("prefill", 4, 512), ("decode", 1, 64)):
        rows, cols, n_rb, n_valid = moe_like_tables(torch, rng, groups, tokens)
        a = torch.randn((n_rb * bm, K), generator=gen, device="cuda")
        by_expert = torch.sort(torch.where(rows < n_rb, cols, E), stable=True).indices
        r2, c2 = rows[by_expert].contiguous(), cols[by_expert].contiguous()
        pick = torch.sort(torch.cat([torch.randperm(n_valid, generator=gen, device="cuda")[:60],
                                     torch.arange(n_valid, len(rows), device="cuda")[:4]])).values
        want = ref.bsr_sdd_ref(a, w, rows[pick], cols[pick], bm, bn)
        out = torch.empty((len(rows), bm, bn), device="cuda")
        print(f"{table}: {len(rows)} slots, {n_valid} valid")
        for name in [*VARIANTS, "shipped"]:  # the shipped body first and last
            launch = lambda r=rows, c=cols: exts[name].bsr_sdd(a, w, r, c, out, True)  # noqa: E731
            launch()
            torch.cuda.synchronize()
            _, rel = rel_err(out[pick], want)
            first = out.clone()
            ms = median_ms(launch, args.reps)
            line = f"  {name}: ms={ms:.4f} rel_err={rel:.3e} same_bits={torch.equal(first, out)}"
            if table == "prefill":
                line += f" by_expert_ms={median_ms(lambda: launch(r2, c2), args.reps):.4f}"
            print(line, flush=True)
        del a, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
