"""Quickstart: stage a blocked SpMV/SpMM the SABLE way (PyTorch port).

  PYTHONPATH=src python examples_torch/quickstart.py [--backend cuda] [--device cpu]

Runs on the CUDA card; ``--device cpu`` runs the plain PyTorch versions of
the kernels. ``--backend`` (default ``cuda``: K1 for the SpMV, K2 for the
SpMM) is any staging backend of ``repro_torch.core.StagingOptions``. The
last line printed is a JSON object of the numbers ``main`` returns.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backend", default="cuda",
                    help="staging backend (cuda: K1 and K2; grouped, bucketed, ...)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.core import StagingOptions, stage_spmm, stage_spmv, synthesize
    from repro_torch.core.vbr import structure_hash
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops as kops

    dev = resolve_device(args.device)
    opts = StagingOptions(backend=args.backend)

    # 1. a sparse matrix with block structure, stored in VBR
    #    (2000x2000, 20x20 grid, 60 mostly-dense blocks, 20% zeros inside)
    vbr = synthesize(2000, 2000, 20, 20, 60, block_sparsity=0.2, seed=0)
    print(f"matrix: {vbr.shape}, {vbr.num_blocks} blocks, "
          f"{vbr.stored_nnz:,} stored values, pattern {structure_hash(vbr)}")

    # 2. Stage 0/1: inspect the indirection arrays, specialize the kernel
    kops.reset_launches()
    kern = stage_spmv(vbr, opts, device=dev)
    tiled = getattr(kern, "tiled", None)
    shape = (f"{tiled.n_tiles} tiles of {tiled.tm}x{tiled.tk}" if tiled is not None
             else f"{len(getattr(kern, 'classes', None) or ())} shape classes")
    print(f"staged: backend={kern.backend} on {dev}, {shape}, "
          f"stage0 {kern.stage0_time * 1e3:.1f} ms")

    # 3. Stage 2: run -- only the VALUES and x are runtime inputs
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(2000).astype(np.float32),
                        device=dev)
    y = kern(torch.as_tensor(vbr.val, device=dev), x)
    dense = vbr.to_dense()
    oracle = dense @ x.cpu().numpy()
    spmv_err = float(np.abs(y.cpu().numpy() - oracle).max())
    print("spmv max err vs densify-oracle:", spmv_err)

    # 4. same pattern, different values -> the staged kernel is reused
    vbr.val = vbr.val * 3.0
    y3 = kern(torch.as_tensor(vbr.val, device=dev), x)
    tripled = bool(torch.allclose(y3, 3 * y, rtol=1e-3, atol=1e-3))
    print("3x values -> 3x result:", tripled)

    # 5. SpMM over the same structure (paper Section IV-C)
    X = torch.as_tensor(np.random.default_rng(1).standard_normal((2000, 64)).astype(np.float32),
                        device=dev)
    kern_mm = stage_spmm(vbr, 64, opts, device=dev)
    Y = kern_mm(torch.as_tensor(vbr.val, device=dev), X)
    oracle_mm = (3 * dense) @ X.cpu().numpy()
    spmm_err = float(np.abs(Y.cpu().numpy() - oracle_mm).max())
    print("spmm out:", tuple(Y.shape), "max err vs densify-oracle:", spmm_err)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    result = {
        "device": str(dev), "backend": kern.backend, "shape": list(vbr.shape),
        "blocks": vbr.num_blocks, "stored": vbr.stored_nnz, "pattern": structure_hash(vbr),
        "stage0_ms": kern.stage0_time * 1e3, "spmv_err": spmv_err,
        "spmv_rel": spmv_err / float(np.abs(oracle).max()), "tripled": tripled,
        "spmm_shape": list(Y.shape), "spmm_err": spmm_err,
        "spmm_rel": spmm_err / float(np.abs(oracle_mm).max()), "launches": dict(kops.launches),
    }
    print(json.dumps(result))
    result["outputs"] = {"y": y, "y3": y3, "Y": Y}  # for callers; not printed
    return result


if __name__ == "__main__":
    main()
