"""Readings that set a cell's limits: the program's compared numbers over
many seeds, and the control's (the reference in the next precision down
put in the program's place) over some of them, in one process.

  python3 perfbench/calibrate.py --workload <name> --seeds 11,12,... \
      --control-seeds 11,12,13 --seconds 6

Each seed prints a JSON line with its readings and whether the control, in
the program's place, came out correct by the run's own comparison (it must
not); the last line holds the largest reading of the program and the
smallest of the control, per number. The benchmark's own runs never run
the control.
"""
from __future__ import annotations

import argparse
import json
import sys

from run import ROOT, _caches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args()
    _caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import harness
    from repro_torch.core import staging

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell(harness.load_json(ROOT / "BENCHMARK.json"), ROOT, args.workload)
    ctl_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    low, high = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        control = seed in ctl_seeds
        out, rec = harness.run_cell(cell, seed, args.seconds, False, "cuda", control=control)
        program_ok = harness.judge(rec["checks"], cell.limits)[0]
        line = {"seed": seed, "correct": program_ok,
                "program": {k: v["value"] for k, v in rec["checks"].items()},
                "control": ({k: v["value"] for k, v in rec["control_checks"].items()}
                            if control else None),
                "control_correct": out["correct"] if control else None,
                "metrics": out["metrics"]}
        print(json.dumps(line), flush=True)
        for k, v in line["program"].items():
            low[k] = max(low.get(k, 0.0), v)
        for k, v in (line["control"] or {}).items():
            high[k] = min(high.get(k, float("inf")), v)
        staging.clear_cache()
        torch.cuda.empty_cache()
    print(json.dumps({"lower": low, "upper": high}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
