"""What running attention whole costs a rank where the query heads do not
divide "model": the dry-run's per-rank FLOPs of llama3.2-3b (24 heads) and
llama4-scout (40 heads) on the (16, 16) production mesh, against the same
cells with the heads regrouped so that 16 divides them (32 heads of 96 and
64 heads of 80: the same d_model, query width and score work; the key/value
projections narrower by the same factor), traced the same way.

    PYTHONPATH=src python tools/dryrun_whole_heads.py [--device cpu|cuda]

Prints one line a cell: the FLOPs whole, the FLOPs with a head split, and
their ratio.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.distributed.sharding import ParallelConfig
from repro_torch.launch import dryrun

REGROUP = {"llama3.2-3b": 32, "llama4-scout-17b-a16e": 64}
SHAPES = ("prefill_32k", "decode_32k")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    args = ap.parse_args(argv)
    with dryrun.fake_group(256):
        for arch, heads in REGROUP.items():
            cfg = get_config(arch)
            split = dataclasses.replace(cfg, n_heads=heads, head_dim=cfg.d_model // heads)
            for shape in SHAPES:
                got = [dryrun.run_cell(arch, shape, False, ParallelConfig(), c, verbose=False,
                                       device=args.device) for c in (cfg, split)]
                for r in got:
                    if r["status"] != "ok":
                        raise SystemExit(f"{arch} {shape}: {r.get('error')}")
                whole, part = (r["hlo_flops_per_device"] for r in got)
                print(f"{arch} x {shape} x 16x16: {cfg.n_heads} heads whole {whole:.6g} FLOPs a "
                      f"rank; {heads} heads split {part:.6g}; ratio {whole / part:.4f}")


if __name__ == "__main__":
    main()
