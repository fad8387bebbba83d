"""Production dry-run: trace every (arch x shape x mesh) cell on one rank of
a fake 256- or 512-rank process group (port of ``repro.launch.dryrun``).

Run:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both \\
      --out experiments/dryrun_torch
  (add ``--device cpu`` where torch has no CUDA build)

The reference lowers and compiles each cell for 512 placeholder devices and
reads its costs from the per-device HLO. The port has no compiler in
between: ``main`` starts a fake process group (``torch.testing._internal.
distributed.fake_pg``, a private module of torch: its collectives return at
once) of the production mesh's size in its own process, builds the mesh
(``make_production_mesh``) and runs rank 0's program of the cell once on
fake tensors on the trace device (``--device``, default ``cuda``: the
card's program; nothing is allocated and no card is used). The program is
the one a real rank runs: the params and caches are DTensors laid out by
the sharding rules, the collectives are issued (and counted by
``distributed.ctx``), and ``launch/trace_stats.py`` counts FLOPs, memory
traffic, live bytes and collective bytes per rank. ``analyze`` turns them
into the reference's report: roofline terms against ``launch/mesh.HW`` (an
H100's data-sheet peaks and a modelled network, not measurements).

The reference's ``cost_analysis_*`` keys (XLA's own estimate) and
``generated_code_size_in_bytes`` have no counterpart and are left out; its
bfloat16 adjustment of collective bytes (a host backend upcasting) does
not apply.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from ..configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from ..configs.shapes import Shape, src_len
from ..distributed.ctx import activation_sharding
from ..distributed.sharding import (
    ParallelConfig,
    cache_specs,
    distribute,
    make_shardings,
    param_specs,
)
from ..models.config import ModelConfig, param_count
from ..optim.adamw import AdamWConfig, adamw_init
from ..tree import tree_leaves, tree_map
from . import trace_stats
from .mesh import HW, make_production_mesh
from .specs import abstract_cache, abstract_params, input_specs

__all__ = ["analyze", "build_cell", "fake_group", "main", "run_cell"]

OPT = AdamWConfig(state_dtype="bfloat16")


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks in this process, as rank 0.
    Refuses to run beside a real process group."""
    import torch.distributed as dist
    import torch.testing._internal.distributed.fake_pg  # noqa: F401  (registers "fake")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry-run starts its own fake process group; "
                           "a process group already exists in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _traced():
    """A fake-tensor mode for one cell (real tensors it meets, the mesh's
    rank table among them, taken as constants), with the process caches
    that hold device tensors emptied on the way in and out: a fake tensor
    must not outlive its mode, nor reach a real run."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..models import layers

    layers._rope_freqs.cache_clear()
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            yield
    finally:
        layers._rope_freqs.cache_clear()


def _fake(tree, device):
    """Zeros on ``device`` shaped like ``tree``'s (meta) leaves: fake under a
    ``FakeTensorMode``, real (valid token ids among them) outside one."""
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device), tree)


def _locals(tree) -> list:
    from torch.distributed.tensor import DTensor

    return [t.to_local() if isinstance(t, DTensor) else t for t in tree_leaves(tree)]


def build_cell(cfg: ModelConfig, shape: Shape, mesh, pc: ParallelConfig, device):
    """(fn, args): ``fn()`` runs this rank's program of the cell (a train
    step, a prefill with its encoder, or a decode step), ``args`` are the
    local tensors it reads. Call it under a ``FakeTensorMode``: the params,
    optimizer state and cache are DTensors of fake tensors on ``device``,
    laid out as the reference lays out the cell."""
    from ..models.transformer import decode_step, encode, prefill
    from ..train.step import make_train_step

    model_size = int(mesh.size(tuple(mesh.mesh_dim_names).index(pc.tensor_axis)))
    if shape.kind != "train" and pc.fsdp:
        # serving: replicate over dp where the TP-split params take < 8 GB a
        # rank (FSDP would gather weight shards every decode step)
        if 4 * param_count(cfg) / model_size < 8e9:
            pc = dataclasses.replace(pc, fsdp=False)
    meta = abstract_params(cfg)
    params = distribute(_fake(meta, device), make_shardings(mesh, pc, param_specs(cfg, meta),
                                                            meta))
    ins = _fake(input_specs(cfg, shape), device)

    if shape.kind == "train":
        opt = adamw_init(params, OPT)
        batch = {k: v for k, v in ins.items()}
        step = make_train_step(cfg, OPT, pc, mesh=mesh)
        return ((lambda: step(params, opt, batch, 0)),
                _locals(params) + _locals(opt) + list(batch.values()))

    B, S = shape.global_batch, shape.seq_len
    enc_len = src_len(cfg, shape) if cfg.is_encdec else 0
    meta_cache = abstract_cache(cfg, B, S, enc_len)
    cache = distribute(_fake(meta_cache, device),
                       make_shardings(mesh, pc, cache_specs(cfg, meta_cache, pc, model_size),
                                      meta_cache))
    args = _locals(params) + _locals(cache) + list(ins.values())

    if shape.kind == "prefill":
        def fn():
            with activation_sharding(mesh, pc):
                enc_out = encode(params, cfg, ins["src_embeds"]) if cfg.is_encdec else None
                return prefill(params, cfg, ins["tokens"], cache, enc_out=enc_out)
        return fn, args

    def fn():  # decode: one token at the cache's last position
        with activation_sharding(mesh, pc):
            return decode_step(params, cfg, ins["token"], cache, S - 1)
    return fn, args


def analyze(stats: dict, cfg: ModelConfig, shape: Shape, mesh) -> dict:
    """The reference's report from ``trace_stats.trace``'s counts."""
    n_dev = mesh.size()
    flops, bytes_acc = stats["flops"], stats["hbm_bytes_est"]
    coll = stats["collectives"]
    t_compute = flops / HW["peak_bf16_flops"]
    t_memory = bytes_acc / HW["hbm_bw"]
    t_coll = (coll.get("total_intra_node_wire_bytes", 0.0) / HW["nvlink_bw"]
              + coll.get("total_inter_node_wire_bytes", 0.0) / HW["ib_bw"])
    dominant = max(("compute", t_compute), ("memory", t_memory), ("collective", t_coll),
                   key=lambda kv: kv[1])[0]
    n_total = param_count(cfg)
    n_active = param_count(cfg, active=True)
    tokens = shape.global_batch * (shape.seq_len if shape.kind in ("train", "prefill") else 1)
    model_flops = (6.0 if shape.kind == "train" else 2.0) * n_active * tokens
    return {
        "devices": n_dev,
        "hlo_flops_per_device": flops,
        "flops_by_op": stats["flops_by_op"],
        "hlo_bytes_per_device": bytes_acc,
        "collectives": coll,
        "memory": stats["memory"],
        "roofline": {"t_compute_s": t_compute, "t_memory_s": t_memory,
                     "t_collective_s": t_coll, "dominant": dominant},
        "model_flops_total": model_flops,
        "model_flops_per_device": model_flops / n_dev,
        "useful_flops_ratio": (model_flops / n_dev) / flops if flops else 0.0,
        "params_total": n_total,
        "params_active": n_active,
        "op_census": stats["op_census"],
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             pc: ParallelConfig = ParallelConfig(), cfg: ModelConfig = None,
             verbose: bool = True, device: str = "cuda", mesh=None, shape: Shape = None) -> dict:
    """One cell's report. The process group (a fake one, or real ranks)
    must exist; ``mesh`` defaults to the production mesh over it."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    if mesh is not None:
        mesh_name = "x".join(str(int(mesh.size(i))) for i in range(mesh.ndim))
    report = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "device": device,
              "parallel": dataclasses.asdict(pc)}
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        report.update(status="skipped", reason=reason)
        return report
    try:
        t0 = time.perf_counter()
        mesh = mesh or make_production_mesh(multi_pod=multi_pod, device_type=device)
        grad = contextlib.nullcontext() if shape.kind == "train" else torch.no_grad()
        with _traced(), grad:
            fn, args = build_cell(cfg, shape, mesh, pc, torch.device(device))
            stats = trace_stats.trace(fn, args, mesh, HW["node_size"])
        stats.pop("result")
        report.update(status="ok", trace_time_s=round(time.perf_counter() - t0, 2),
                      **analyze(stats, cfg, shape, mesh))
        if verbose:
            mem, r = report["memory"], report["roofline"]
            print(f"[ok] {arch} x {shape_name} x {mesh_name}: "
                  f"args {mem['argument_size_in_bytes'] / 1e9:.2f} GB/rank, "
                  f"peak {mem['peak_size_in_bytes'] / 1e9:.2f} GB/rank, "
                  f"{report['hlo_flops_per_device']:.4g} FLOPs, "
                  f"compute {r['t_compute_s'] * 1e3:.2f} ms, "
                  f"memory {r['t_memory_s'] * 1e3:.2f} ms, "
                  f"collective {r['t_collective_s'] * 1e3:.2f} ms "
                  f"-> {r['dominant']}-bound (trace {report['trace_time_s']}s)", flush=True)
    except Exception as e:  # a failure here is a bug in the port
        report.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[ERR] {arch} x {shape_name} x {mesh_name}: {e}", flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the trace device: cuda traces the card's program (needs a CUDA "
                         "build of torch; no card is used)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.backends.cuda.is_built():
        raise SystemExit("--device cuda traces the card's program and needs a CUDA build "
                         "of torch; this one has none (pass --device cpu)")

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    pods = {"single": [False], "multi": [True], "both": [False, True]}[args.multi_pod]
    pc = ParallelConfig(fsdp=not args.no_fsdp)

    os.makedirs(args.out, exist_ok=True)
    n_ok = n_skip = n_err = 0
    for mp in pods:
        with fake_group(512 if mp else 256):
            for arch in archs:
                for shape_name in shapes:
                    rep = run_cell(arch, shape_name, mp, pc, device=args.device)
                    tag = f"{arch}_{shape_name}_{rep['mesh']}".replace(".", "_")
                    with open(os.path.join(args.out, tag + ".json"), "w") as f:
                        json.dump(rep, f, indent=1)
                    n_ok += rep["status"] == "ok"
                    n_skip += rep["status"] == "skipped"
                    n_err += rep["status"] == "error"
    print(f"dry-run: {n_ok} ok, {n_skip} skipped (documented), {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
