"""The benchmark of the PyTorch/CUDA port: one run of one cell.

  python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with a CUDA card. Loads,
warms up, measures for ``--seconds``, compares what the timed path
produced with the plain reference, and prints the result as the last line
of standard output (one JSON object); the numbers compared, each beside its
limit, are also the last lines of standard error. Without a card, or with
fewer than the cell asks for, it exits 2 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _caches() -> None:
    """Every build and kernel cache of the program at fixed paths inside
    the checkout (``build/`` is not committed)."""
    build = ROOT / "build"
    os.environ["REPRO_CACHE_DIR"] = str(build / "perfbench-plans")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.Cell(bench, ROOT, args.workload)
    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # one process, one host thread: the host paces the serve loop
    print(f"card: {_power_limit()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr, flush=True)
    out, _ = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                              t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["check"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} over {c['compared']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
