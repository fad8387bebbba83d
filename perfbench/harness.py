"""One run of one cell: find its files by name, drive the program, read the
metrics, compare with the reference and build the result line.

``BENCHMARK.json`` names each cell's configuration and traffic mix. The
configuration is ``configs/<name>.json`` (its ``model_type`` picks
``models/<type>.py`` and ``reference/<type>.py``: ``family``), the mix is
``mixes/<traffic>.json`` (its ``driver`` picks ``drivers/<driver>.py``),
each metric is ``metrics/<name>.py`` (a ``read(m)`` that returns a number
or None), and the limits of the comparison are ``limits/<cell>.json``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name is JAX's, flax's
    or the JAX package's, compared whole (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".")[0] for name in (list(sys.modules) if names is None else names)}
    return sorted(tops.intersection(FORBIDDEN))


class Cell:
    """A workload of ``bench`` with its configuration, mix and limits."""

    def __init__(self, bench: dict, root: Path, name: str, mixes: Path = HERE / "mixes",
                 limits: Path = HERE / "limits"):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.cfg = load_json(root / conf["file"])
        self.mix = load_json(Path(mixes) / f"{self.entry['traffic']}.json")
        self.limits = load_json(Path(limits) / f"{name}.json")
        self.bench = bench

    def metrics(self, trace: bool) -> list:
        """The cell's metrics: its end-to-end ones, or with ``trace`` its
        per-layer ones."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if self.name in m.get("workloads", [self.name])]


class Ctx:
    """What a driver gets: the cell's files, the run's arguments, and
    hooks that record set-up and read the device."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device,
                 control: bool, t_start: float, log):
        self.cfg, self.mix, self.seed, self.seconds = cell.cfg, cell.mix, seed, seconds
        self.trace, self.device, self.control, self.log = trace, device, control, log
        self.t_start = t_start
        self.parts: dict = {}
        self.setup_s = None

    def part(self, name: str, seconds: float) -> None:
        self.parts[name] = self.parts.get(name, 0.0) + seconds

    def window_opens(self) -> None:
        self.setup_s = time.perf_counter() - self.t_start

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        import torch

        if self.device.type != "cuda":
            return 0
        self.sync()
        return int(torch.cuda.max_memory_allocated(self.device))


class MetricInput:
    """What a metric reader sees: the driver's record, the trace (None in
    an untraced run), the configuration and the set-up time."""

    def __init__(self, rec: dict, cfg: dict, setup_s: float):
        self.rec, self.cfg, self.setup_s = rec, cfg, setup_s
        self.trace = rec.get("trace")


def family(cfg: dict) -> tuple:
    """(``models.<type>``, ``reference.<type>``) for the configuration's
    ``model_type``: the program's side and the plain reference."""
    t = cfg["model_type"]
    return (importlib.import_module(f"perfbench.models.{t}"),
            importlib.import_module(f"perfbench.reference.{t}"))


def judge(checks: dict, limits: dict) -> tuple:
    """(correct, failed, the numbers beside their limits) of a run's
    ``checks``: each number at or under its limit, over at least one
    answer compared."""
    check, failed, correct = {}, 0, True
    for name, c in checks.items():
        limit = limits[name]
        ok = c["compared"] > 0 and c["value"] <= limit
        check[name] = {"value": c["value"], "limit": limit, "compared": c["compared"]}
        failed += (sum(v > limit for v in c["items"]) if "items" in c
                   else 0 if ok else c["compared"])
        correct = correct and ok
    return correct, failed, check


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metric(name: str, inp: MetricInput):
    """``metrics/<name>.py``'s reading, or None where it finds nothing."""
    mod = _module(HERE / "metrics" / f"{name}.py", "perfbench_metric_" + name.replace(".", "_"))
    value = mod.read(inp)
    return None if value is None else float(value)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, *,
             control: bool = False, t_start: float = None, log=None) -> tuple:
    """Drive one run; returns (the result line's object, the driver's record).

    With ``control`` the driver also puts the reference in the next
    precision down in the program's place, and the line judges that
    (``rec["control_checks"]``) by the same limits: it has to come out not
    correct. The program's own checks stay in ``rec["checks"]``."""
    import torch

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    t_start = time.perf_counter() if t_start is None else t_start
    ctx = Ctx(cell, seed, seconds, trace, torch.device(device), control, t_start, log)
    ctx.part("import", time.perf_counter() - t_start)
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
        t = time.perf_counter()
        from repro_torch.kernels import _build

        _build.load_kernels()
        ctx.part("kernels", time.perf_counter() - t)
    driver = importlib.import_module(f"perfbench.drivers.{cell.mix['driver']}")
    rec = driver.run(ctx)
    log("setup: " + json.dumps({"setup_s": ctx.setup_s, **ctx.parts}))

    inp = MetricInput(rec, cell.cfg, ctx.setup_s)
    metrics = {}
    for m in cell.metrics(trace):
        value = read_metric(m["name"], inp)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, failed, check = judge(rec["control_checks" if control else "checks"], cell.limits)
    device = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
              "kind": torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
              else "cpu",
              "count": int(cell.entry["chips"]),
              "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    out = {"correct": correct, "attempted": int(rec["attempted"]), "failed": int(failed),
           "metrics": metrics, "device": device}
    tr = rec.get("trace")
    if trace and tr is not None:
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
    out["check"] = check  # last: the numbers compared beside their limits
    return out, rec
