"""Fixtures of the benchmark's own tests: the tiny cells of ``data/`` (a
staged SpMM and SpMV on a 400 x 300 VBR, a DeepSeek-shaped model of width
64 served to three clients), each with the real ``BENCHMARK.json``'s
metrics. Tests marked ``requires_cuda`` skip without a card, decided here
at run time."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

TINY = {"u-spmm-packed": "u-tiny", "u-spmv-newvals": "v-tiny", "dsv2-longprompt": "ds-tiny"}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "requires_cuda: launches a CUDA kernel; skips without a CUDA device"
    )


@pytest.fixture(autouse=True)
def _card(request):
    if request.node.get_closest_marker("requires_cuda"):
        import torch

        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_bench() -> dict:
    """BENCHMARK.json with the tiny cells in place of the real ones."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    tiny = json.loads((DATA / "bench-tiny.json").read_text())
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            if "workloads" in m:
                m["workloads"] = [TINY[w] for w in m["workloads"] if w in TINY]
    bench["configs"], bench["workloads"] = tiny["configs"], tiny["workloads"]
    return bench


def tiny_cell(name: str):
    from perfbench import harness

    return harness.Cell(tiny_bench(), ROOT, name, mixes=DATA, limits=DATA)
