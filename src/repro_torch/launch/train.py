"""Training launcher (port of ``repro.launch.train``)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --sable \\
      --reduced --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

It runs on the CUDA card (and fails without one); ``--device cpu`` runs the
plain PyTorch versions of the kernels, e.g. with ``--reduced``. Params are
random, drawn on the device from seed 0 in the config's ``param_dtype``;
the data is the reference's ``SyntheticDataset``; AdamW under a cosine
schedule (warmup 20 steps), with the reference's ``ParallelConfig``
defaults (gradients cast to bfloat16). ``--resume`` restores the latest
checkpoint in ``--ckpt-dir`` (params, optimizer state and the data step)
and runs ``--steps`` more. ``--devices`` (the reference's host-device
count for a mesh) raises until the sharding slice.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--sable", action="store_true",
                    help="enable SABLE block-sparse FFN (llama3-8b)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--devices", type=int, default=0,
                    help="devices of a data/model mesh (the sharding slice)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    import torch

    from ..configs import get_config
    from ..configs.shapes import Shape
    from ..data.pipeline import make_dataset
    from ..device import resolve_device
    from ..distributed.sharding import ParallelConfig, no_sharding
    from ..models.transformer import init_params
    from ..optim.adamw import AdamWConfig, adamw_init
    from ..optim.schedule import cosine_schedule
    from ..train.loop import TrainLoop
    from ..train.step import make_train_step

    if args.devices:
        no_sharding("--devices (a device mesh)")
    dev = resolve_device(args.device)
    if args.sable:
        from ..configs import llama3_8b

        cfg = llama3_8b.reduced_sable() if args.reduced else llama3_8b.full_sable()
    else:
        cfg = get_config(args.arch, reduced=args.reduced)
    shape = Shape("cli", args.seq, args.batch, "train")
    pc = ParallelConfig()
    opt_cfg = AdamWConfig(lr=args.lr)

    def sched(s):
        return cosine_schedule(s, args.lr, warmup=20, total=args.steps)

    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    opt_state = adamw_init(params, opt_cfg)
    ds = make_dataset(cfg, shape)
    step = make_train_step(cfg, opt_cfg, pc, schedule=sched)
    loop = TrainLoop(step, ds, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    if args.resume:
        params, opt_state, resumed = loop.maybe_restore(params, opt_state)
        print(f"resumed={resumed} at step {loop.step}")
    params, opt_state, metrics = loop.run(params, opt_state, args.steps,
                                          log_every=args.log_every)
    print(f"final loss {float(metrics['loss']):.4f} @ step {loop.step}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
