"""End-to-end training driver (PyTorch port): a small LM for a few hundred steps.

  PYTHONPATH=src python examples_torch/train_e2e.py --steps 300 --d-model 512 \\
      --layers 8 --sable --ckpt /tmp/e2e_ckpt

Demonstrates: data pipeline -> train step -> async checkpoints (every 100
steps) -> preemption-safe resume. Runs on the CUDA card (``--sable``: the
block-sparse FFN, K2 where the plan cache picks the ``cuda`` strategy);
``--device cpu`` runs the plain PyTorch versions of the kernels.

``--steps`` is the step the run ends at: rerunning the same command with
``--ckpt`` restores the last checkpoint and trains on to that step, so a
resumed run repeats the steps an uninterrupted one takes, under the same
learning-rate schedule (the reference script trains ``--steps`` more after
a resume). ``--stop-at N`` stops at step N as a preempted job would, with
no final checkpoint. ``--deterministic`` runs under torch's deterministic
algorithms: the card's index_add_ and embedding gradients otherwise sum
with atomics, in an order that differs from run to run. The last line
printed is a JSON object of the numbers ``main`` returns.
"""
from __future__ import annotations

import argparse
import json


class Preempted(Exception):
    """Raised by the step at ``--stop-at``."""


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-ff", type=int, default=1024)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--sable", action="store_true", help="SABLE block-sparse FFN weights")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--stop-at", type=int, default=None,
                    help="stop at this step, as a preempted job would: no final checkpoint")
    ap.add_argument("--deterministic", action="store_true",
                    help="torch's deterministic algorithms (a resume repeats a run bit for bit)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    return ap.parse_args(argv)


def make_config(args):
    """The reference script's model: ``d_model // 64`` heads of 64,
    ``d_model // 128`` KV heads, float32 compute."""
    from repro_torch.models.config import LayerSpec, ModelConfig, SableConfig, uniform_groups

    return ModelConfig(
        name="e2e",
        family="dense",
        d_model=args.d_model,
        n_heads=max(args.d_model // 64, 1),
        n_kv_heads=max(args.d_model // 128, 1),
        head_dim=64,
        d_ff=args.d_ff,
        vocab_size=args.vocab,
        groups=uniform_groups(args.layers, LayerSpec()),
        compute_dtype="float32",
        sable=SableConfig(block_m=64, block_n=64, density=0.4) if args.sable else None,
    )


def init(cfg, device):
    """Random params on ``device``, drawn from seed 0."""
    import torch

    from repro_torch.models import init_params

    return init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)


def main(argv=None) -> dict:
    args = parse(argv)

    import torch

    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops as kops
    from repro_torch.models.config import param_count
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.optim.schedule import cosine_schedule
    from repro_torch.train.loop import TrainLoop
    from repro_torch.train.step import make_train_step

    dev = resolve_device(args.device)
    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    cfg = make_config(args)
    print(f"model: {param_count(cfg) / 1e6:.1f}M params "
          f"({'SABLE-sparse FFN' if args.sable else 'dense'}) on {dev}")

    params = init(cfg, dev)
    oc = AdamWConfig(lr=args.lr)
    opt = adamw_init(params, oc)
    step = make_train_step(cfg, oc, schedule=lambda s: cosine_schedule(s, args.lr, 20,
                                                                       args.steps))

    def step_fn(p, o, b, i):
        if i == args.stop_at:
            raise Preempted(i)
        return step(p, o, b, i)

    ds = SyntheticDataset(cfg.vocab_size, args.seq, args.batch, seed=0)
    loop = TrainLoop(step_fn, ds, ckpt_dir=args.ckpt, ckpt_every=100)
    resumed_from = None
    if args.ckpt:
        params, opt, resumed = loop.maybe_restore(params, opt)
        if resumed:
            resumed_from = loop.step
            print(f"resumed from step {loop.step}")
    kops.reset_launches()
    stopped = False
    try:
        params, opt, metrics = loop.run(params, opt, max(args.steps - loop.step, 0),
                                        log_every=20)
    except Preempted:
        stopped = True
        if loop.manager:
            loop.manager.wait()  # the last checkpoint started is the one a restart finds
        print(f"stopped at step {loop.step} (--stop-at): no final checkpoint")
    loss = loop.losses[-1] if loop.losses else None
    if not stopped:
        print(f"done at step {loop.step}: loss {loss:.4f}" if loss is not None
              else f"done at step {loop.step}: nothing left to train")

    result = {
        "device": str(dev), "params": param_count(cfg), "sable": args.sable,
        "resumed_from": resumed_from, "stopped": stopped, "step": loop.step, "loss": loss,
        "losses": loop.losses, "step_ms_median": loop.monitor.median * 1e3,
        "launches": dict(kops.launches),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
