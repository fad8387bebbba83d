"""Batched serving with a KV cache (prefill once, decode many), PyTorch port.

  PYTHONPATH=src python examples_torch/serve_blockwise.py --arch llama3.2-3b [--device cpu]

Serves the reduced config of any ``--arch`` of ``repro_torch.configs``
(``llama3-8b-sable`` too: its FFN runs K2 where the plan cache picks the
``cuda`` strategy) on the CUDA card; ``--device cpu`` runs the plain PyTorch
versions of the kernels. Params and prompts are random, drawn on the device
from ``torch.Generator`` seeds 0 and 1 (an enc-dec config's 16 source frames
from seed 2). The last line printed is a JSON object of the numbers
``main`` returns.
"""
from __future__ import annotations

import argparse
import json


def generate(cfg, params, prompts, gen: int, temperature: float = 0.0, src_embeds=None,
             device=None):
    """``ServeEngine.generate`` over ``prompts`` (B, P) for ``gen`` new
    tokens; returns (tokens (B, P + gen), stats, engine)."""
    from repro_torch.serve.engine import ServeEngine

    engine = ServeEngine(cfg, params, max_len=prompts.shape[1] + gen, device=device)
    kwargs = {} if src_embeds is None else {"src_embeds": src_embeds}
    out, stats = engine.generate(prompts, max_new_tokens=gen, temperature=temperature,
                                 **kwargs)
    return out, stats, engine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops as kops
    from repro_torch.models import init_params

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=True)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    src = None
    if cfg.is_encdec:
        src = torch.randn((args.batch, 16, cfg.frontend_dim),
                          generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    kops.reset_launches()
    out, stats, engine = generate(cfg, params, prompts, args.gen, args.temperature, src, dev)
    sample = out[0, args.prompt_len: args.prompt_len + 12].tolist()
    print(f"{args.arch}: generated {out.shape[0]}x{args.gen} tokens on {dev}; "
          f"prefill {stats['prefill_s'] * 1e3:.0f} ms, "
          f"decode {stats['tokens_per_s']:.1f} tok/s")
    print("sample:", sample)

    result = {
        "arch": args.arch, "device": str(dev), "shape": list(out.shape),
        "prefill_ms": stats["prefill_s"] * 1e3, "decode_s": stats["decode_s"],
        "tokens_per_s": stats["tokens_per_s"], "sample": sample,
        "sparse_plans": engine.sparse_plans, "launches": dict(kops.launches),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
