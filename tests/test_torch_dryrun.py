"""PyTorch port, the dry-run (``repro_torch.launch.{specs,mesh,trace_stats,
dryrun}``) against the JAX package's.

- ``specs``: ``abstract_params``, ``abstract_opt``, ``abstract_cache`` and
  ``input_specs`` leaf for leaf (path, shape, dtype) against the
  reference's ``jax.eval_shape`` results, for every full config and every
  shape.
- ``make_production_mesh`` on fake process groups of 256 and 512 ranks,
  and its refusal on 8; ``fake_group``'s refusal beside another group.
- ``trace_stats`` on hand cases: the wire factors, the link split of groups
  of 8 and of 16 consecutive ranks, a matmul chain's FLOPs with its
  backward, its traffic and its peak of live bytes.
- The reference's nine small cells (reduced llama3-8b, mamba2-1.3b and
  seamless x train, prefill, decode at 8 x 32) on a fake ``(2, 2, 2)``
  group: each ``ok``, its per-rank FLOPs against the reference's
  ``analyze_hlo`` on 8 forced host devices (``jax.sharding.Mesh`` built
  directly), computed live in a subprocess: within 2%, or, for mamba2, the
  stated difference by design (ROADMAP §3).
- One full-width cell per family on both production meshes.
- The collective bytes the fake trace counts on rank 0 of a reduced
  ``(2, 2, 2)`` train and decode cell, against rank 0 of eight real gloo
  ranks running the same cell.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs this file beside the JAX suites

from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.distributed.sharding import ParallelConfig  # noqa: E402
from repro_torch.launch import dryrun, trace_stats  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

SRC = str(Path(__file__).resolve().parent.parent / "src")
SMALL = ("llama3-8b", "mamba2-1.3b", "seamless-m4t-large-v2")
KINDS = ("train_4k", "prefill_32k", "decode_32k")
SMALL_SHAPE = dict(seq_len=32, global_batch=8)
FLOP_TOL = 0.02
# one full-width cell per family, on both production meshes
FULL = (("llama3-8b", "train_4k"), ("deepseek-v2-236b", "decode_32k"),
        ("mamba2-1.3b", "long_500k"), ("seamless-m4t-large-v2", "prefill_32k"))


def _small(name):
    return dataclasses.replace(SHAPES[name], **SMALL_SHAPE)


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", shape, mesh_dim_names=names)


REFERENCE = """
    import dataclasses, json, re, sys
    import numpy as np
    import jax
    from jax.sharding import Mesh
    from repro.configs import SHAPES, get_config
    from repro.distributed.ctx import activation_sharding
    from repro.distributed.sharding import ParallelConfig
    from repro.launch import hlo_stats as hs
    from repro.launch.dryrun import build_cell

    SMALL, KINDS, SMALL_SHAPE = %(fill)r
    pc = ParallelConfig()
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2), ("pod", "data", "model"))
    out = {}
    for arch in SMALL:
        for kind in KINDS:
            shape = dataclasses.replace(SHAPES[kind], **SMALL_SHAPE)
            with activation_sharding(mesh, pc):
                jitted, args = build_cell(get_config(arch, reduced=True), shape, mesh, pc)
                text = jitted.lower(*args).compile().as_text()
            comps, entry = hs._parse_computations(text)
            sig = {op.name: op.out_sig for ops in comps.values() for op in ops}
            mult, todo = {entry: 1.0}, [entry]
            while todo:  # trip counts down the call graph
                name = todo.pop()
                for op in comps.get(name, []):
                    for callee, _ in op.calls:
                        if callee not in mult:
                            todo.append(callee)
                        mult[callee] = mult.get(name, 1.0) * op.trip
            dots = conv_fwd = 0.0
            for name, ops in comps.items():
                for op in ops:
                    if op.opcode == "dot":
                        dots += hs._dot_flops(op, sig) * mult.get(name, 1.0)
                    elif (op.opcode == "convolution" and "conv_general_dilated" in op.line
                          and "transpose(" not in op.line):  # the forward's
                        conv_fwd += hs._conv_flops(op, sig) * mult.get(name, 1.0)
            out[f"{arch}|{kind}"] = {"flops": hs.analyze_hlo(text)["flops"], "dots": dots,
                                     "conv_fwd": conv_fwd}
    print(json.dumps(out))
"""

RANK = """
    import dataclasses, datetime, json, sys
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        from torch.distributed.device_mesh import DeviceMesh
        from repro_torch.configs import SHAPES, get_config
        from repro_torch.distributed import ctx
        from repro_torch.distributed.sharding import ParallelConfig
        from repro_torch.launch.dryrun import build_cell

        SMALL_SHAPE = %(small)r
        mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                          mesh_dim_names=("pod", "data", "model"))
        moved = {}
        for kind in ("train_4k", "decode_32k"):
            shape = dataclasses.replace(SHAPES[kind], **SMALL_SHAPE)
            grad = torch.enable_grad() if kind == "train_4k" else torch.no_grad()
            with grad:
                fn, _ = build_cell(get_config("llama3-8b", reduced=True), shape, mesh,
                                   ParallelConfig(), torch.device("cpu"))
                ctx.reset_moved_bytes()
                fn()
            moved[kind] = {"|".join((k, *a)): v
                           for (k, a), v in ctx.moved_bytes(by_axes=True).items()}
        if rank == 0:
            with open(out, "w") as fh:
                json.dump(moved, fh)
    finally:
        dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def subprocesses(tmp_path_factory):
    """Started first, read where a test needs them: the reference's nine
    cells, and eight gloo ranks running two of them for real."""
    root = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = {"reference": subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE % {"fill": (SMALL, KINDS, SMALL_SHAPE)})],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    script = textwrap.dedent(RANK % {"small": SMALL_SHAPE})
    for r in range(8):
        procs[f"rank{r}"] = subprocess.Popen(
            [sys.executable, "-c", script, str(r), "8", str(root / "store"),
             str(root / "moved.json")], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    done = {}

    def result(name, timeout=420):
        if name not in done:
            end = time.monotonic() + timeout
            names = [name] if name == "reference" else [f"rank{r}" for r in range(8)]
            for n in names:
                try:
                    out, err = procs[n].communicate(timeout=max(end - time.monotonic(), 1))
                except subprocess.TimeoutExpired:
                    for p in procs.values():
                        p.kill()
                    pytest.fail(f"{n} did not finish within {timeout} s")
                assert procs[n].returncode == 0, f"{n}:\n{out[-2000:]}\n{err[-6000:]}"
                if n == "reference":
                    done[name] = json.loads(out.strip().splitlines()[-1])
            if name != "reference":
                done[name] = json.loads((root / "moved.json").read_text())
        return done[name]

    yield result
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget
    from repro.launch import specs as jspecs
    from repro.optim.adamw import AdamWConfig as JOpt

    with jax.default_device(jax.devices("cpu")[0]):
        yield dict(jax=jax, shapes=JSHAPES, get=jget, specs=jspecs, opt=JOpt)


def _ref_leaves(jax, tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp),
             tuple(v.shape), str(np.dtype(v.dtype))) for kp, v in flat]


def _leaves(tree):
    return [(p, tuple(t.shape), str(t.dtype).replace("torch.", "")) for p, t in tree_paths(tree)]


# ---------------------------------------------------------------------- #
# specs
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference_leaf_for_leaf(subprocesses, jx, arch):
    """Params, AdamW state (bfloat16 moments, as the dry-run's), the cache
    of every shape and every shape's inputs: meta tensors whose paths,
    shapes and dtypes are the reference's ``eval_shape`` results."""
    from repro_torch.configs.shapes import src_len

    jax, jspecs = jx["jax"], jx["specs"]
    cfg, jcfg = get_config(arch), jx["get"](arch)
    params = tspecs.abstract_params(cfg)
    assert all(t.device.type == "meta" for _, t in tree_paths(params))
    assert _leaves(params) == _ref_leaves(jax, jspecs.abstract_params(jcfg))
    opt = tspecs.abstract_opt(cfg, AdamWConfig(state_dtype="bfloat16"))
    assert _leaves(opt) == _ref_leaves(
        jax, jspecs.abstract_opt(jcfg, jx["opt"](state_dtype="bfloat16")))
    for name, shape in SHAPES.items():
        enc = src_len(cfg, shape) if cfg.is_encdec else 0
        cache = tspecs.abstract_cache(cfg, 2, 64, enc)
        assert _leaves(cache) == _ref_leaves(jax, jspecs.abstract_cache(jcfg, 2, 64, enc))
        ins = tspecs.input_specs(cfg, shape)
        want = jspecs.input_specs(jcfg, jx["shapes"][name])
        assert list(ins) == list(want)
        assert _leaves(ins) == _ref_leaves(jax, want), name


# ---------------------------------------------------------------------- #
# the production mesh on a fake group
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_on_a_fake_group(multi_pod):
    from repro_torch.launch.mesh import HW, make_production_mesh

    world = 512 if multi_pod else 256
    with dryrun.fake_group(world):
        mesh = make_production_mesh(multi_pod=multi_pod)
        shape = tuple(int(mesh.size(i)) for i in range(mesh.ndim))
        assert shape == ((2, 16, 16) if multi_pod else (16, 16))
        assert mesh.mesh_dim_names == (("pod", "data", "model") if multi_pod
                                       else ("data", "model"))
        with pytest.raises(ValueError, match="512|256"):
            make_production_mesh(multi_pod=not multi_pod)
        with pytest.raises(RuntimeError, match="already exists"):
            with dryrun.fake_group(8):
                pass
    assert HW["node_size"] == 8 and HW["peak_bf16_flops"] == 989e12


def test_production_mesh_refuses_eight_ranks():
    from repro_torch.launch.mesh import make_production_mesh

    with dryrun.fake_group(8):
        with pytest.raises(ValueError, match="256 ranks"):
            make_production_mesh()


# ---------------------------------------------------------------------- #
# trace_stats on hand cases
# ---------------------------------------------------------------------- #
def test_wire_factors():
    wf = trace_stats.wire_factor
    assert wf("all_reduce", 4) == 1.5 and wf("all_gather", 4) == 0.75
    assert wf("reduce_scatter", 16) == 15 / 16 and wf("exchange", 2) == 1.0
    assert wf("all_reduce", 1) == 0.0 and wf("all_gather", 1) == 0.0


@pytest.mark.parametrize("shape,inter", [((4, 8), {"model": False, "data": True}),
                                         ((2, 16), {"model": True, "data": True})])
def test_link_split_of_consecutive_groups(shape, inter):
    """Row-major meshes over 32 fake ranks: rank 0's model group is 8
    consecutive ranks (one node) on (4, 8) and 16 (two nodes) on (2, 16);
    its data group strides over nodes on both."""
    with dryrun.fake_group(32):
        mesh = _mesh(shape, ("data", "model"))
        assert trace_stats.group_ranks(mesh, ("model",)) == list(range(shape[1]))
        moved = {("all_gather", ("model",)): 100.0, ("all_reduce", ("data",)): 10.0}
        out = trace_stats.link_split(moved, mesh, 8)
    assert out["total_wire_bytes"] == 110.0
    want = 100.0 * inter["model"] + 10.0 * inter["data"]
    assert out["total_inter_node_wire_bytes"] == want
    assert out["total_intra_node_wire_bytes"] == 110.0 - want
    assert out["all_gather"]["max_group"] == shape[1]


def test_matmul_chain_flops_traffic_and_peak():
    """(64, 128) @ (128, 256) @ (256, 32), summed, its gradients: FLOPs of
    the forward and the backward; traffic every op's output plus the
    arguments; the peak all of it but the product ``a @ w1``, which
    autograd saved for ``w2``'s gradient and frees once that is taken,
    before ``w1``'s and ``a``'s gradients are made. Without gradients a
    longer chain frees each product after the next."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    f4 = 4
    with FakeTensorMode():
        a, w1, w2 = (torch.zeros(s, requires_grad=True) for s in ((64, 128), (128, 256),
                                                                  (256, 32)))
        w3 = torch.zeros(32, 512)

        def step():
            y = (a @ w1) @ w2
            return torch.autograd.grad(y.sum(), (a, w1, w2))

        s = trace_stats.trace(step, [a, w1, w2])
        fwd = 2 * 64 * 128 * 256 + 2 * 64 * 256 * 32
        assert s["flops"] == 3 * fwd
        args = f4 * (64 * 128 + 128 * 256 + 256 * 32)
        outs = f4 * (64 * 256 + 64 * 32 + 1 + 1 + 256 * 32 + 64 * 256 + 128 * 256 + 64 * 128)
        assert s["memory"]["argument_size_in_bytes"] == args
        assert s["hbm_bytes_est"] == args + outs
        assert s["memory"]["peak_size_in_bytes"] == args + outs - f4 * 64 * 256

        with torch.no_grad():
            s = trace_stats.trace(lambda: ((a @ w1) @ w2) @ w3, [a, w1, w2, w3])
        args = f4 * (64 * 128 + 128 * 256 + 256 * 32 + 32 * 512)
        h1, h2, h3 = f4 * 64 * 256, f4 * 64 * 32, f4 * 64 * 512
        assert s["flops"] == fwd + 2 * 64 * 32 * 512
        assert s["hbm_bytes_est"] == args + h1 + h2 + h3
        assert s["memory"]["peak_size_in_bytes"] == args + max(h1 + h2, h2 + h3)
        assert s["op_census"][0] == {"op": "mm.default", "count": 3, "bytes": h1 + h2 + h3}


def test_grouped_conv_backward_counts_twice_the_forward():
    """A depthwise conv1d's backward: grad input and grad weight, each the
    forward's multiply-adds (torch's own formula charges the weight
    gradient as a dense conv's)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    B, C, S, K = 2, 96, 32, 4
    with FakeTensorMode():
        x = torch.zeros(B, C, S + K - 1, requires_grad=True)
        w = torch.zeros(C, 1, K, requires_grad=True)
        s = trace_stats.trace(lambda: torch.autograd.grad(
            torch.nn.functional.conv1d(x, w, groups=C).sum(), (x, w)), [x, w])
    assert s["flops"] == 3 * 2 * B * C * S * K


# ---------------------------------------------------------------------- #
# cells
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def small_cells():
    """The nine reduced cells traced on a fake (2, 2, 2) group."""
    out = {}
    with dryrun.fake_group(8):
        mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
        for arch in SMALL:
            for kind in KINDS:
                out[f"{arch}|{kind}"] = dryrun.run_cell(
                    arch, kind, False, ParallelConfig(), get_config(arch, reduced=True),
                    verbose=False, device="cpu", mesh=mesh, shape=_small(kind))
    return out


def _whole_bc_flops(kind: str) -> float:
    """The dot FLOPs a rank of the fake (2, 2, 2) group adds over the
    reference's on reduced mamba2 by design: ``in_b``/``in_c`` whole on
    each model rank (the reference splits their columns over "model"), in
    the forward (and its two backward products in the train step), plus
    at decode the conv step's dot over the B/C channels the reference
    splits."""
    cfg = get_config("mamba2-1.3b", reduced=True)
    s = cfg.ssm
    gn, d, M = s.n_groups * s.d_state, cfg.d_model, 2
    layers = sum(g.repeat * len(g.layers) for g in cfg.groups)
    tokens = 8 // 4 * (1 if kind == "decode_32k" else 32)  # this data shard's
    proj = 2 * 2 * tokens * d * gn * (1 - 1 / M)  # in_b and in_c
    passes = 3 if kind == "train_4k" else 1
    conv = 0.0
    if kind == "decode_32k":
        ch, di = s.d_inner(cfg.d_model) + 2 * gn, s.d_inner(cfg.d_model)
        conv = 2 * tokens * s.d_conv * ((di // M + 2 * gn) - ch // M)
    return layers * (passes * proj + conv)


@pytest.mark.parametrize("cell", [f"{a}|{k}" for a in SMALL for k in KINDS])
def test_small_cells_flops_match_reference(subprocesses, small_cells, cell):
    """Each cell ``ok``; its per-rank FLOPs within 2% of the reference's
    ``analyze_hlo`` on the same mesh. mamba2's differ by design (ROADMAP
    §3): its dot FLOPs equal the reference's plus the whole B/C projections
    (``_whole_bc_flops``) within 2%, and its forward conv is the
    reference's over 96 of its 160 channels (the rank's x channels and every
    B/C channel) against 80; its conv backward is counted right (twice the
    forward), where the reference's ``_conv_flops`` charges a depthwise
    conv's backward as dense."""
    rep = small_cells[cell]
    assert rep["status"] == "ok", rep.get("traceback")
    ref = subprocesses("reference")[cell]
    got = rep["hlo_flops_per_device"]
    arch, kind = cell.split("|")
    if arch != "mamba2-1.3b":
        assert got == pytest.approx(ref["flops"], rel=FLOP_TOL)
        return
    by_op = rep["flops_by_op"]
    dots = sum(v for k, v in by_op.items() if "mm" in k)
    assert dots == pytest.approx(ref["dots"] + _whole_bc_flops(kind), rel=FLOP_TOL)
    if kind != "decode_32k":  # decode's conv step is a dot
        assert by_op["aten.convolution"] == pytest.approx(ref["conv_fwd"] * 96 / 80, rel=FLOP_TOL)
        assert by_op.get("aten.convolution_backward", 0.0) == (
            2 * by_op["aten.convolution"] if kind == "train_4k" else 0.0)


def test_small_cells_report_the_reference_keys(small_cells):
    """The report keys of the reference's ``analyze``, those with a meaning
    here (no ``cost_analysis_*``), and a roofline from the card's table."""
    rep = small_cells["llama3-8b|train_4k"]
    for key in ("hlo_flops_per_device", "hlo_bytes_per_device", "collectives", "memory",
                "roofline", "model_flops_total", "model_flops_per_device",
                "useful_flops_ratio", "params_total", "params_active", "devices"):
        assert key in rep, key
    assert not [k for k in rep if k.startswith("cost_analysis")]
    r = rep["roofline"]
    assert r["dominant"] == max(("compute", "memory", "collective"),
                                key=lambda k: r[f"t_{k}_s"])
    assert rep["memory"]["peak_size_in_bytes"] > rep["memory"]["argument_size_in_bytes"] > 0
    assert rep["collectives"]["total_wire_bytes"] > 0 and rep["devices"] == 8


@pytest.mark.parametrize("kind", ["train_4k", "decode_32k"])
def test_fake_trace_issues_the_real_collectives(subprocesses, small_cells, kind):
    """Rank 0's collective bytes, by collective and mesh dims, in the fake
    trace of a reduced llama3-8b cell equal rank 0's on eight gloo ranks
    running the same cell."""
    real = subprocesses("ranks")[kind]
    fake = {f"{k}|{axes}": v for k, s in small_cells[f"llama3-8b|{kind}"]["collectives"].items()
            if isinstance(s, dict) for axes, v in s["by_axes"].items()}
    assert real and fake == pytest.approx(real, rel=1e-12)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_full_width_cells_on_production_meshes(multi_pod):
    """One cell per family at full width on the production mesh (a fake
    group of 256 or 512 ranks), each ``ok``, with its per-rank argument
    bytes, FLOPs and a dominant roofline term."""
    with dryrun.fake_group(512 if multi_pod else 256):
        for arch, shape in FULL:
            rep = dryrun.run_cell(arch, shape, multi_pod, verbose=False, device="cpu")
            assert rep["status"] == "ok", (arch, shape, rep.get("traceback"))
            assert rep["devices"] == (512 if multi_pod else 256)
            assert rep["hlo_flops_per_device"] > 0 and rep["memory"]["argument_size_in_bytes"] > 0
            assert rep["roofline"]["dominant"] in ("compute", "memory", "collective")


def test_cli_refuses_cuda_without_a_cuda_build(tmp_path):
    """``--device cuda`` (the default) traces the card's program; without a
    CUDA build it stops instead of tracing the CPU program."""
    if torch.backends.cuda.is_built():
        pytest.skip("this torch has a CUDA build")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "llama3-8b",
                        "--shape", "decode_32k", "--out", str(tmp_path)],
                       env=dict(os.environ, PYTHONPATH=SRC), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and "CUDA build" in r.stderr
