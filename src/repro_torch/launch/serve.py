"""Serving launcher (port of ``repro.launch.serve``): single-batch
``generate`` or continuous batching.

Single-batch (one prefill, then lockstep decode)::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b-sable \\
      --batch 8 --prompt-len 512 --gen 64

Continuous batching (request-level scheduler over the paged KV cache,
mixed prompt and generation lengths, admission and eviction mid-decode)::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b-sable \\
      --continuous --requests 12 --max-batch 4 --gen 32

The Mamba-2 models serve the same way: ``--arch mamba2-1.3b`` (every cache
leaf per-sequence state) and ``--arch jamba-1.5-large-398b --reduced``
(Mamba, attention and MoE layers: paged KV and state in one cache); their
caches refuse ``--prefix-sharing`` and ``--chunked-prefill``. An
encoder-decoder model (seamless-m4t-large-v2) needs ``src_embeds``, which
the CLI does not make: it raises ``ValueError`` (serve it through
``ServeEngine.generate(..., src_embeds=)``).

Both run on the CUDA card (and fail without one); ``--device cpu`` runs the
plain PyTorch versions of the kernels, e.g. with ``--reduced``. Params are
random, drawn on the device from seed 0 and stored in the config's
``compute_dtype``, as a server stores them, so that no step re-casts the
weights (the reference CLI keeps float32 params and casts at every
matmul). The continuous workload is the reference's: lengths from
``numpy.random.default_rng(1)``, request i sampling from a generator seeded
i.
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
                    help="request-level continuous batching (paged KV cache)")
    ap.add_argument("--requests", type=int, default=8,
                    help="[--continuous] number of mixed-length requests")
    ap.add_argument("--max-batch", type=int, default=4, help="[--continuous] decode lanes")
    ap.add_argument("--page-size", type=int, default=16,
                    help="[--continuous] KV page size (token positions)")
    ap.add_argument("--policy", default="fcfs", choices=("fcfs", "warm_first"),
                    help="[--continuous] admission policy")
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="[--continuous] share page-aligned prompt-prefix pages across "
                         "requests (copy-on-write)")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="[--continuous] prefill long prompts in chunks interleaved with "
                         "decode steps")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="[--chunked-prefill] tokens per prefill chunk (default 2*page_size)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="[--continuous] prepend this many identical tokens to every prompt "
                         "(demo workload for --prefix-sharing)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..configs import get_config
    from ..device import resolve_device
    from ..models.transformer import init_params
    from ..serve.engine import ServeEngine

    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.is_encdec:  # the reference's CLI asserts in generate for want of them
        raise ValueError(
            f"{cfg.name} is an encoder-decoder model: serving it needs src_embeds (frame "
            "embeddings), which this CLI does not make; call ServeEngine.generate(..., "
            "src_embeds=) or ServeEngine.serve with a src_embeds entry per request"
        )
    dev = resolve_device(args.device)
    cfg = dataclasses.replace(cfg, param_dtype=cfg.compute_dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    engine = ServeEngine(cfg, params, max_len=args.shared_prefix + args.prompt_len + args.gen,
                         device=dev)
    if engine.warmup_stats["plans_staged"]:
        print(f"staged {engine.warmup_stats['plans_staged']} sparse plans "
              f"(cold cache): {engine.sparse_plans}; restart to serve warm")

    if args.continuous:
        rng = np.random.default_rng(1)
        shared = rng.integers(0, cfg.vocab_size, size=(args.shared_prefix,)).astype(np.int32)
        reqs = []
        for i in range(args.requests):
            P = int(rng.integers(max(args.prompt_len // 4, 1), args.prompt_len + 1))
            G = int(rng.integers(max(args.gen // 4, 1), args.gen + 1))
            suffix = rng.integers(0, cfg.vocab_size, size=(P,)).astype(np.int32)
            reqs.append({
                "prompt": np.concatenate([shared, suffix]),
                "max_new_tokens": G,
                "temperature": args.temperature,
                "seed": i,
                "rid": f"req{i}",
            })
        t0 = time.perf_counter()
        results, sched = engine.serve(
            reqs, page_size=args.page_size, max_batch=args.max_batch, policy=args.policy,
            prefix_sharing=args.prefix_sharing, chunked_prefill=args.chunked_prefill,
            prefill_chunk=args.prefill_chunk,
        )
        dt = time.perf_counter() - t0
        s = sched.stats
        print(f"served {s['finished']} requests on {dev} in {dt:.2f}s: {s['steps']} steps, "
              f"{s['decode_tokens']} decode tokens ({s['decode_tokens'] / max(dt, 1e-9):.1f} "
              f"tok/s), {s['evictions']} evictions, {s['resumes']} resumes")
        if args.prefix_sharing or args.chunked_prefill:
            print(f"prefix sharing: {s['prefix_hits']} hits, {s['pages_shared']} pages shared, "
                  f"{s['cow_copies']} COW copies; prefill {s['prefill_tokens']} tokens in "
                  f"{s['prefill_chunks']} chunks")
        first = results["req0"]
        print("first request:", first["tokens"][: first["prompt_len"] + 8].tolist())
        return results, sched

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
