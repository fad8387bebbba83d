"""Serving launcher, single-batch path (port of ``repro.launch.serve``): one
prefill, then lockstep decode through ``ServeEngine.generate``::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b-sable \\
      --batch 8 --prompt-len 512 --gen 64

runs on the CUDA card (and fails without one); ``--device cpu`` runs the
plain PyTorch versions of the kernels, e.g. with ``--reduced``. Params are
random, drawn on the device from seed 0 and stored in the config's
``compute_dtype``, as a server stores them, so that no step re-casts the
weights (the reference CLI keeps float32 params and casts at every
matmul). ``--continuous`` (request-level continuous batching over the
paged KV cache) raises until the scheduler slice.
"""
from __future__ import annotations

import argparse
import dataclasses
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    ap.add_argument("--continuous", action="store_true",
                    help="request-level continuous batching (not ported yet)")
    args = ap.parse_args(argv)
    if args.continuous:
        raise NotImplementedError(
            "--continuous is not ported yet; it comes with the scheduler slice "
            "(serve/scheduler.py, serve/paged_cache.py)"
        )

    import torch

    from ..configs import get_config
    from ..device import resolve_device
    from ..models.transformer import init_params
    from ..serve.engine import ServeEngine

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    cfg = dataclasses.replace(cfg, param_dtype=cfg.compute_dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    engine = ServeEngine(cfg, params, max_len=args.prompt_len + args.gen, device=dev)
    if engine.warmup_stats["plans_staged"]:
        print(f"staged {engine.warmup_stats['plans_staged']} sparse plans "
              f"(cold cache): {engine.sparse_plans}; restart to serve warm")

    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    t0 = time.perf_counter()
    out, stats = engine.generate(prompts, max_new_tokens=args.gen,
                                 temperature=args.temperature)
    dt = time.perf_counter() - t0
    print(f"generated {tuple(out.shape)} on {dev} in {dt:.2f}s "
          f"(prefill {stats['prefill_s']:.2f}s, {stats['tokens_per_s']:.1f} tok/s decode)")
    print("first sequence:", out[0, : args.prompt_len + 8].tolist())
    return out, stats


if __name__ == "__main__":
    main()
