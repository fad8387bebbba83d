"""Compile-once / run-many: the paper's GMRES-style use case (PyTorch port).

One sparsity pattern, many value sets (e.g. iterative solver steps or NN
weights updated across training): inspection cost is paid once, every later
matrix with the same pattern reuses the staged kernel.

  PYTHONPATH=src python examples_torch/pattern_reuse.py [--device cpu]

Runs on the CUDA card; ``--device cpu`` runs the plain PyTorch versions of
the kernels. The 21 matrices are staged with the ``cuda`` backend (K1),
where the reference script stages with ``grouped``. The tuned plan lands
under ``$REPRO_CACHE_DIR`` (else ``~/.cache/repro-sable``). The last line
printed is a JSON object of the numbers ``main`` returns.
"""
from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.core import StagingOptions, stage_spmv, synthesize
    from repro_torch.core.autotune import autotune_stats
    from repro_torch.core.staging import cache_info, clear_cache
    from repro_torch.core.vbr import VBR
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops as kops

    dev = resolve_device(args.device)
    opts = StagingOptions(backend="cuda")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    clear_cache()
    kops.reset_launches()
    base = synthesize(4000, 4000, 40, 40, 300, block_sparsity=0.2, seed=0)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(4000).astype(np.float32),
                        device=dev)

    t0 = time.perf_counter()
    kern = stage_spmv(base, opts, device=dev)
    kern(torch.as_tensor(base.val, device=dev), x)
    sync()
    first = time.perf_counter() - t0
    print(f"first matrix: staged+built+ran in {first * 1e3:.1f} ms")

    # 20 more matrices with the same pattern (solver iterations)
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    for _ in range(20):
        m = VBR(**{**base.__dict__})
        m.val = rng.standard_normal(base.stored_nnz).astype(np.float32)
        k = stage_spmv(m, opts, device=dev)  # cache hit
        k(torch.as_tensor(m.val, device=dev), x)
    sync()
    rest = (time.perf_counter() - t0) / 20
    cache = cache_info()
    print(f"20 same-pattern matrices: {rest * 1e3:.1f} ms each "
          f"({first / rest:.0f}x faster than first)")
    print("cache:", cache)

    # ------------------------------------------------------------------- #
    # tune-once / run-forever: backend='autotune' measures the candidates
    # once and persists the winning plan on disk keyed by the structure
    # hash, so a SECOND PROCESS staging this pattern runs no benchmark.
    # ------------------------------------------------------------------- #
    t0 = time.perf_counter()
    kern_auto = stage_spmv(base, StagingOptions(backend="autotune"), device=dev)
    kern_auto(torch.as_tensor(base.val, device=dev), x)
    sync()
    auto_ms = (time.perf_counter() - t0) * 1e3
    stats = autotune_stats()
    print(f"autotuned staging: {auto_ms:.1f} ms, backend={kern_auto.backend}, stats={stats}")

    result = {
        "device": str(dev), "first_ms": first * 1e3, "rest_ms": rest * 1e3, "cache": cache,
        "autotune_ms": auto_ms,
        "autotune_backend": kern_auto.backend, "autotune_stats": stats,
        "launches": dict(kops.launches),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
