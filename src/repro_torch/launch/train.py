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
and runs ``--steps`` more.

``--devices N`` trains on a ``("data", "model")`` mesh of N ranks
(``make_local_mesh``), params and AdamW state sharded by the reference's
rules (``param_specs``/``make_shardings``) and the sharded train step:

* under torchrun's environment (``RANK``, ``WORLD_SIZE``, ...) each process
  joins that group: NCCL on the card, gloo with ``--device cpu``;
* otherwise with ``--device cpu`` it starts N gloo ranks on a ``file://``
  store in a temporary directory (one rank: this process);
* otherwise on the card N must equal the visible cards (one NCCL rank a
  card); anything else raises.

Rank 0 alone prints and writes checkpoints.
"""
from __future__ import annotations

import argparse
import os


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
                    help="ranks of a (data, model) mesh (0: no mesh)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    if not args.devices:
        return _train(args)
    return _launch(args)


def _launch(args) -> int:
    import tempfile

    import torch

    cpu = args.device == "cpu"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # torchrun's group
        if int(os.environ["WORLD_SIZE"]) != args.devices:
            raise ValueError(f"--devices {args.devices} in a group of "
                             f"{os.environ['WORLD_SIZE']} processes")
        return _rank(int(os.environ["RANK"]), args, "env://")
    if not cpu and torch.cuda.device_count() != args.devices:
        raise RuntimeError(f"--devices {args.devices} on the card needs as many visible cards; "
                           f"{torch.cuda.device_count()} are visible")
    with tempfile.TemporaryDirectory(prefix="repro-train-") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        if args.devices == 1:
            return _rank(0, args, init)
        import torch.multiprocessing as mp

        mp.spawn(_spawned, args=(args, init), nprocs=args.devices, join=True)
    return 0


def _spawned(rank: int, args, init: str) -> None:
    _rank(rank, args, init)


def _rank(rank: int, args, init: str) -> int:
    import torch
    import torch.distributed as dist

    backend = "gloo" if args.device == "cpu" else "nccl"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    else:  # the host's cores shared out among the ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.devices))
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=args.devices)
    try:
        return _train(args, sharded=True)
    finally:
        dist.destroy_process_group()


def _train(args, sharded: bool = False) -> int:
    import torch

    from ..configs import get_config
    from ..configs.shapes import Shape
    from ..data.pipeline import make_dataset
    from ..device import resolve_device
    from ..distributed.sharding import ParallelConfig, distribute, make_shardings, param_specs
    from ..models.transformer import init_params
    from ..optim.adamw import AdamWConfig, adamw_init
    from ..optim.schedule import cosine_schedule
    from ..train.loop import TrainLoop
    from ..train.step import make_train_step
    from .mesh import make_local_mesh

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
    mesh, say = None, print
    if sharded:
        import torch.distributed as dist

        mesh = make_local_mesh(("data", "model"))
        params = distribute(params, make_shardings(mesh, pc, param_specs(cfg, params), params))
        if dist.get_rank() != 0:
            def say(*a, **k):
                return None
    opt_state = adamw_init(params, opt_cfg)
    ds = make_dataset(cfg, shape)
    step = make_train_step(cfg, opt_cfg, pc, schedule=sched, mesh=mesh)
    loop = TrainLoop(step, ds, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    if args.resume:
        params, opt_state, resumed = loop.maybe_restore(params, opt_state)
        say(f"resumed={resumed} at step {loop.step}")
    params, opt_state, metrics = loop.run(params, opt_state, args.steps,
                                          log_every=args.log_every, log_fn=say)
    say(f"final loss {float(metrics['loss']):.4f} @ step {loop.step}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
