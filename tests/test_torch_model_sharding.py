"""PyTorch port, model sharding (``repro_torch.distributed.{sharding,ctx}``,
the sharded train step, elastic checkpoints and ``launch/train.py
--devices``) against the JAX package.

- The rules: ``param_specs``, ``opt_state_specs``, ``batch_specs``,
  ``cache_specs`` and ``slice_shardings`` leaf for leaf against the
  reference's on every reduced arch (and llama3-8b-sable), and
  ``make_shardings``' sanitizing on ``(2, 2, 2)``, ``(2, 4)`` and ``(1, 8)``
  (the reference on an ``AbstractMesh``, the port on a stand-in mesh).
- On eight gloo ranks (``python -c`` processes sharing a ``file://`` store
  under the module's temporary directory, started as
  ``test_torch_sharded.py`` starts them), side by side with one reference
  subprocess on 8 forced host devices whose meshes are built directly as
  ``jax.sharding.Mesh`` (``jax.make_mesh``'s Explicit axes refuse the
  reference's constraints): each rank's DTensor blocks against
  ``devices_indices_map``; reduced llama3-8b's train step on ``(2, 2, 2)``
  and ``(2, 4)`` against the reference's single-device step and its step
  on the same mesh (``rtol=1e-3, atol=1e-4``, the reference's own test)
  and against the port's unsharded step; ``fsdp_over_pod``,
  ``compress_grads`` and remat "dots"; SABLE on ``(2, 2)`` with each rank's
  sub-pattern plan; DeepSeek-V2's expert-parallel forward (both MoE paths)
  against the reference at 2e-3 and one train step with its aux loss;
  mamba2 (its mixer split by SSD heads) and seamless (cross-attention split
  by heads) on ``(2, 2)``; a checkpoint saved on ``(4, 2)`` and
  restored on ``(2, 4)`` and in one process; ``save_async`` of DTensors
  updated in place while it writes; the bytes ``ctx.moved_bytes()`` counts
  in a step against ``tools/shard_volume.py``.
- Against the port's unsharded step the losses and grad norms agree to
  1e-5 and the first step's gradients (AdamW's first moment) to 1e-5 of
  each leaf's scale; the updated params to the reference's tolerance:
  AdamW's eps turns a gradient's rounding at ~1e-10 into ~1e-5 of update.
- The CLI: ``--device cpu --devices 4``, then ``--resume``, against the
  unsharded CLI's losses.
"""
import dataclasses
import datetime
import json
import os
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs this file beside the JAX suites

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs import llama3_8b as tl  # noqa: E402
from repro_torch.convert import params_from_arrays  # noqa: E402
from repro_torch.distributed import ctx as tctx  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.tree import tree_leaves, tree_paths  # noqa: E402

SRC = str(Path(__file__).resolve().parent.parent / "src")
TOOLS = Path(__file__).resolve().parent.parent / "tools"
CPU = "cpu"
RANKS = 8
SABLE = "llama3-8b-sable"
MESHES = {"222": ((2, 2, 2), ("pod", "data", "model")), "24": ((2, 4), ("data", "model")),
          "18": ((1, 8), ("data", "model"))}
REF_TOL = dict(rtol=1e-3, atol=1e-4)  # tests/test_distributed.py's step
EP_TOL = dict(rtol=2e-3, atol=2e-3)  # tests/test_distributed.py's MoE
SELF = 1e-5  # the port's sharded step against its unsharded one
BF16 = dict(rtol=2e-2, atol=2e-3)  # compress_grads: bfloat16 gradient collectives
CLI_TOL = 1e-3  # the CLI's losses in bfloat16 compute (5e-5 apart when measured)
LR = 1e-3
# (data x model mesh, arch, MoE dropless) of the counted collective bytes
VOLUME = (((4, 2), SABLE, None), ((4, 2), "deepseek-v2-236b", False),
          ((4, 2), "deepseek-v2-236b", True), ((2, 4), "deepseek-v2-236b", False),
          ((2, 4), "deepseek-v2-236b", True))
REF_PARTS = ("llama", "moe", "blocks")  # the reference's work, in parallel subprocesses
# (tag, mesh, ParallelConfig fields, remat) of the llama3-8b train steps
SCENARIOS = (("m222", "222", {}, "none"), ("m24", "24", {}, "none"),
             ("pod", "222", {"fsdp_over_pod": True}, "none"),
             ("compress", "222", {"compress_grads": True}, "none"),
             ("dots", "222", {}, "dots"))


def _cfg(arch):
    return tl.reduced_sable() if arch == SABLE else get_config(arch, reduced=True)


def _llama():
    return dataclasses.replace(get_config("llama3-8b", reduced=True), compute_dtype="float32")


def _deepseek(dropless=False):
    cfg = dataclasses.replace(get_config("deepseek-v2-236b", reduced=True),
                              compute_dtype="float32")
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0,
                                                            dropless=dropless))


def _norm(spec) -> tuple:
    """A spec as a tuple, a one-axis tuple entry as its axis (JAX's form)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else
                 (tuple(e) if isinstance(e, (tuple, list)) else e) for e in spec)


class NamesMesh:
    """Only what the rules read of a DeviceMesh: names and sizes."""

    def __init__(self, shape, names):
        self.mesh_dim_names, self._shape = tuple(names), tuple(shape)

    def size(self, dim=None):
        return int(np.prod(self._shape)) if dim is None else self._shape[dim]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jget
    from repro.configs import llama3_8b as jl
    from repro.distributed import sharding as jsh
    from repro.launch.specs import abstract_params
    from repro.models import transformer as jtr

    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        yield SimpleNamespace(jax=jax, jsh=jsh, jtr=jtr, abstract_params=abstract_params,
                              cfg=lambda a: jl.reduced_sable() if a == SABLE
                              else jget(a, reduced=True))


def _ref_paths(jax, tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp), v)
            for kp, v in flat]


def _specs_by_path(tree, like):
    from repro_torch.tree import flatten

    specs, _ = flatten(tree, is_leaf=lambda x: isinstance(x, (tsh.P, tsh.NamedSharding)))
    return list(zip([p for p, _ in tree_paths(like)], specs))


# ---------------------------------------------------------------------- #
# the rules, in this process
# ---------------------------------------------------------------------- #
def test_fetch_and_constrain_noop_outside_context():
    """Model code must run unchanged without an activation_sharding ctx."""
    x = torch.ones((4, 8))
    assert tctx.constrain(x, tctx.DP, None) is x
    assert tctx.fetch(x, None, tctx.MODEL) is x
    assert tctx.model_input(x) is x and tctx.dp_sum(x) is x and tctx.model_part(8) is None
    assert tctx.anchor_params(x) is x and tctx.dp_size() == 1


@pytest.mark.parametrize("arch", ARCH_IDS + [SABLE])
def test_specs_match_reference_leaf_for_leaf(jx, arch):
    """param_specs, opt_state_specs, batch_specs and cache_specs equal the
    reference's, leaf for leaf and as tuples."""
    jax, jsh = jx.jax, jx.jsh
    cfg, jcfg = _cfg(arch), jx.cfg(arch)
    jparams = jx.abstract_params(jcfg)
    params = ttr.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    got = _specs_by_path(tsh.param_specs(cfg, params), params)
    want = _ref_paths(jax, jsh.param_specs(jcfg, jparams))
    assert [p for p, _ in got] == [p for p, _ in want]
    assert [tuple(s) for _, s in got] == [tuple(s) for _, s in want]
    ostate = adamw_init(params, AdamWConfig())
    got_o = _specs_by_path(tsh.opt_state_specs(cfg, params, ostate), ostate)
    want_o = _ref_paths(jax, jsh.opt_state_specs(jcfg, jparams, None))
    assert [(p, tuple(s)) for p, s in got_o] == [(p, tuple(s)) for p, s in want_o]
    batch = {"tokens": np.zeros((8, 16), np.int32), "labels": np.zeros((8, 16), np.int32)}
    if cfg.is_encdec:
        batch["src_embeds"] = np.zeros((8, 12, cfg.frontend_dim), np.float32)
    got_b = _specs_by_path(tsh.batch_specs(cfg, batch), batch)
    want_b = _ref_paths(jax, jsh.batch_specs(jcfg, batch))
    assert [(p, tuple(s)) for p, s in got_b] == [(p, tuple(s)) for p, s in want_b]
    enc = 12 if cfg.is_encdec else 0
    cache = ttr.init_cache(cfg, 2, 16, enc_len=enc, device=CPU)
    jcache = jax.eval_shape(lambda: jx.jtr.init_cache(jcfg, 2, 16, enc_len=enc))
    for pc, msize in ((tsh.ParallelConfig(), 16), (tsh.ParallelConfig(seq_shard_cache=False), 2)):
        jpc = jsh.ParallelConfig(seq_shard_cache=pc.seq_shard_cache)
        got_c = _specs_by_path(tsh.cache_specs(cfg, cache, pc, msize), cache)
        want_c = _ref_paths(jax, jsh.cache_specs(jcfg, jcache, jpc, msize))
        assert [(p, tuple(s)) for p, s in got_c] == [(p, tuple(s)) for p, s in want_c]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("fsdp_over_pod", [False, True])
def test_make_shardings_sanitizes_as_the_reference(jx, mesh, fsdp_over_pod):
    """Resolved and sanitized specs on every reduced arch, and
    slice_shardings of each first group's layer, equal the reference's on
    the same mesh shape."""
    jax, jsh = jx.jax, jx.jsh
    shape, names = MESHES[mesh]
    jmesh = jax.sharding.AbstractMesh(shape, names)
    tmesh = NamesMesh(shape, names)
    pc = tsh.ParallelConfig(fsdp_over_pod=fsdp_over_pod)
    jpc = jsh.ParallelConfig(fsdp_over_pod=fsdp_over_pod)
    for arch in ARCH_IDS + [SABLE]:
        cfg, jcfg = _cfg(arch), jx.cfg(arch)
        jparams = jx.abstract_params(jcfg)
        params = ttr.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
        got = _specs_by_path(tsh.make_shardings(tmesh, pc, tsh.param_specs(cfg, params),
                                                params), params)
        want = jax.tree.leaves(jsh.make_shardings(jmesh, jpc, jsh.param_specs(jcfg, jparams),
                                                  jparams))
        assert [_norm(s.spec) for _, s in got] == [_norm(s.spec) for s in want], arch
        jlayer = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape[1:], a.dtype),
                              jparams["groups"][0])
        sliced = _first_layer(params["groups"][0])
        got_s = _specs_by_path(tsh.slice_shardings(tmesh, pc, sliced), sliced)
        want_s = jax.tree.leaves(jsh.slice_shardings(jmesh, jpc, jlayer))
        assert [_norm(s.spec) for _, s in got_s] == [_norm(s.spec) for s in want_s], arch


def _first_layer(tree):
    if isinstance(tree, dict):
        return {k: _first_layer(v) for k, v in tree.items()}
    return tree[0]


def test_placements_follow_the_mesh_order():
    """A dim split over several axes is Shard(d) on each, in mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = NamesMesh((2, 2, 2), ("pod", "data", "model"))
    sh = tsh.NamedSharding(mesh, tsh.P(None, ("data", "model")))
    assert sh.placements == (Replicate(), Shard(1), Shard(1))
    assert tsh.NamedSharding(mesh, tsh.P("model", "pod")).placements == (
        Shard(1), Replicate(), Shard(0))
    with pytest.raises(ValueError, match="order"):
        tsh.NamedSharding(mesh, tsh.P(("model", "data"))).placements


# ---------------------------------------------------------------------- #
# one rank in this process
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    import torch.distributed as dist

    store = tmp_path_factory.mktemp("gloo1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    yield dist
    dist.destroy_process_group()


def test_remat_recompute_on_another_thread_sees_the_context(one_rank):
    """The backward of a remat block may run on another thread (autograd's
    device thread on the card): its recompute re-enters the forward's
    context, so split leaves are still fetched."""
    from repro_torch.launch.mesh import make_local_mesh

    cfg = dataclasses.replace(_llama(), remat="dots")
    mesh = make_local_mesh(("pod", "data", "model"), (1, 1, 1))
    pc = tsh.ParallelConfig()
    params = ttr.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    dparams = tsh.distribute(params, tsh.make_shardings(mesh, pc, tsh.param_specs(cfg, params),
                                                        params))
    view, locals_ = tctx.local_view(dparams, requires_grad=True)
    assert any(isinstance(v, tctx.ShardedLeaf) for v in tree_leaves(view))
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
    with tctx.activation_sharding(mesh, pc):
        logits, _ = ttr.forward_train(view, cfg, {"tokens": tokens})
    out = []
    t = threading.Thread(target=lambda: out.append(torch.autograd.grad(logits.sum(), locals_)))
    t.start()
    t.join(60)
    assert out and len(out[0]) == len(locals_)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    want = torch.autograd.grad(ttr.forward_train(params, cfg, {"tokens": tokens})[0].sum(),
                               leaves)
    for g, w in zip(out[0], want):
        torch.testing.assert_close(g, w, rtol=SELF, atol=SELF)


def test_sparse_matmul_out_model_on_a_staging_mesh(one_rank):
    """``sparse_matmul_auto(mesh=, out_model=True)``: the whole product as a
    DTensor split on its last dim over the staging mesh's model axis."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import make_staging_mesh
    from repro_torch.sparse import linear as tlin

    pat = tlin.random_pattern(64, 96, 8, 8, density=0.4)
    rng = np.random.default_rng(0)
    tiles = torch.as_tensor(rng.standard_normal((pat.n_tiles, 8, 8)).astype(np.float32))
    x = torch.as_tensor(rng.standard_normal((4, 64)).astype(np.float32))
    y = tlin.sparse_matmul_auto(x, tiles, pat, mesh=make_staging_mesh((1, 1)), out_model=True)
    assert isinstance(y, DTensor) and y.placements[1].is_shard(1)
    torch.testing.assert_close(y.full_tensor(), tlin.sparse_matmul(x, tiles, pat),
                               rtol=SELF, atol=SELF)
    assert tlin.sparse_matmul_auto(x, tiles, pat, out_model=True).shape == (4, 96)


# ---------------------------------------------------------------------- #
# eight gloo ranks beside the reference on 8 forced host devices
# ---------------------------------------------------------------------- #
REFERENCE = """
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import get_config, llama3_8b
    from repro.distributed.ctx import activation_sharding
    from repro.distributed.sharding import (ParallelConfig, batch_specs, make_shardings,
                                            param_specs)
    from repro.launch.specs import abstract_params
    from repro.models import forward_train, init_params
    from repro.optim.adamw import AdamWConfig, adamw_init
    from repro.train.step import make_train_step

    out_dir, part = sys.argv[1], sys.argv[2]
    MESHES = %(meshes)r

    def mesh(tag):
        shape, names = MESHES[tag]
        return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)

    def paths(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return [("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp), v)
                for kp, v in flat]

    out, info = {}, {"boxes": {}, "losses": {}}
    # part "blocks": each device's block of every leaf, on every mesh;
    # "llama": the train steps; "moe": DeepSeek-V2's forward
    for tag in MESHES if part == "blocks" else ():
        m = mesh(tag)
        for arch in ("llama3-8b", "deepseek-v2-236b", "llama3-8b-sable"):
            cfg = (llama3_8b.reduced_sable() if arch.endswith("sable")
                   else get_config(arch, reduced=True))
            ap = abstract_params(cfg)
            sh = make_shardings(m, ParallelConfig(), param_specs(cfg, ap), ap)
            for (path, s), (_, leaf) in zip(paths(sh), paths(ap)):
                dmap = s.devices_indices_map(leaf.shape)
                info["boxes"][f"{tag}|{arch}|{path}"] = [
                    [[sl.start or 0, leaf.shape[i] if sl.stop is None else sl.stop]
                     for i, sl in enumerate(dmap[d])] for d in m.devices.reshape(-1)]

    with jax.default_matmul_precision("highest"):
        cfg = dataclasses.replace(get_config("llama3-8b", reduced=True), compute_dtype="float32")
        oc = AdamWConfig(lr=%(lr)r)
        params = init_params(cfg, jax.random.PRNGKey(0))
        k1, k2 = jax.random.split(jax.random.PRNGKey(1))
        batch = {"tokens": jax.random.randint(k1, (8, 16), 0, cfg.vocab_size),
                 "labels": jax.random.randint(k2, (8, 16), 0, cfg.vocab_size)}
        steps = (("single", False, None), ("single_c", True, None), ("m222", False, "222"),
                 ("m24", False, "24"))
        for tag, compress, mtag in steps if part == "llama" else ():
            pc = ParallelConfig(compress_grads=compress)
            step = make_train_step(cfg, oc, pc)
            p, o = params, adamw_init(params, oc)
            if mtag is None:
                f, b = jax.jit(step), batch
                run = lambda f, p, o, b, i: f(p, o, b, jnp.int32(i))
            else:
                m = mesh(mtag)
                ps = make_shardings(m, pc, param_specs(cfg, params), params)
                os_ = {"mu": ps, "nu": ps, "count": NamedSharding(m, P())}
                bs = make_shardings(m, pc, batch_specs(cfg, batch), batch)
                p, o, b = jax.device_put(p, ps), jax.device_put(o, os_), jax.device_put(batch, bs)
                f = jax.jit(step, in_shardings=(ps, os_, bs, NamedSharding(m, P())),
                            out_shardings=(ps, os_, None))

                def run(f, p, o, b, i, m=m, pc=pc):
                    with activation_sharding(m, pc):
                        return f(p, o, b, jnp.int32(i))
            losses = []
            for i in range(2):
                p, o, met = run(f, p, o, b, i)
                losses.append(float(met["loss"]))
                for path, leaf in paths(p):
                    out[f"{tag}|p{i}|{path}"] = np.asarray(jax.device_get(leaf), np.float32)
            info["losses"][tag] = losses

        # DeepSeek-V2's forward, expert parallel on (2, 4), both MoE paths
        ds = get_config("deepseek-v2-236b", reduced=True)
        ds = dataclasses.replace(ds, compute_dtype="float32",
                                 moe=dataclasses.replace(ds.moe, capacity_factor=8.0))
        dparams = init_params(ds, jax.random.PRNGKey(0))
        dbatch = {"tokens": jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0,
                                               ds.vocab_size)}
        for dropless in (True, False) if part == "moe" else ():
            c = dataclasses.replace(ds, moe=dataclasses.replace(ds.moe, dropless=dropless))
            out[f"ds{int(dropless)}|single"] = np.asarray(
                jax.jit(lambda p, b: forward_train(p, c, b))(dparams, dbatch)[0])
            pc, m = ParallelConfig(), mesh("24")
            ps = make_shardings(m, pc, param_specs(c, dparams))
            bs = make_shardings(m, pc, batch_specs(c, dbatch))
            with activation_sharding(m, pc):
                f = jax.jit(lambda p, b: forward_train(p, c, b), in_shardings=(ps, bs))
                got, _ = f(jax.device_put(dparams, ps), jax.device_put(dbatch, bs))
            out[f"ds{int(dropless)}|m24"] = np.asarray(jax.device_get(got), np.float32)
    np.savez(f"{out_dir}/ref-{part}.npz", **out)
    with open(f"{out_dir}/ref-{part}.json", "w") as fh:
        json.dump(info, fh)
"""

RANK = """
    import copy, dataclasses, datetime, json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, world, store, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import DTensor, Shard
        from repro_torch.checkpoint.manager import (CheckpointManager, restore_checkpoint,
                                                    save_checkpoint)
        from repro_torch.configs import get_config, llama3_8b
        from repro_torch.core import cache as tcache
        from repro_torch.distributed import ctx
        from repro_torch.distributed.sharding import (NamedSharding, P, ParallelConfig,
                                                      distribute, make_shardings, param_specs)
        from repro_torch.models import layers, transformer as ttr
        from repro_torch.optim.adamw import AdamWConfig, adamw_init
        from repro_torch.sparse import linear as tlin
        from repro_torch.train.step import make_train_step
        from repro_torch.tree import tree_leaves, tree_map, tree_paths, tree_unflatten

        MESHES, SCENARIOS, LR, VOLUME = %(meshes)r, %(scenarios)r, %(lr)r, %(volume)r
        out, info = {}, {"boxes": {}, "losses": {}, "norms": {}}

        def mesh(tag, ranks=None):
            shape, names = MESHES[tag] if isinstance(tag, str) else tag
            ranks = list(range(int(np.prod(shape)))) if ranks is None else ranks
            return DeviceMesh("cpu", torch.tensor(ranks).reshape(shape), mesh_dim_names=names)

        def cfg_of(arch, **kw):
            cfg = (llama3_8b.reduced_sable() if arch.endswith("sable")
                   else get_config(arch, reduced=True))
            return dataclasses.replace(cfg, compute_dtype="float32", **kw)

        def load(name, cfg):
            d = np.load(os.path.join(root, name + ".npz"))
            like = ttr.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
            return tree_unflatten(like, [torch.as_tensor(d[p]) for p, _ in tree_paths(like)]), d

        def full(tree):  # every rank gathers (a copy: the step updates in place)
            return {p: t.full_tensor().detach().numpy().copy() for p, t in tree_paths(tree)}

        def train(tag, cfg, params, batch, m, pc, steps=2, keep=True):
            params = tsh_distribute(params, m, pc, cfg)
            opt = adamw_init(params, AdamWConfig(lr=LR))
            step = make_train_step(cfg, AdamWConfig(lr=LR), pc, mesh=m)
            losses, norms = [], []
            for i in range(steps):
                params, opt, met = step(params, opt, batch, i)
                losses.append(float(met["loss"]))
                norms.append(float(met["grad_norm"]))
                if keep:
                    for path, a in full(params).items():
                        out[f"{tag}|p{i}|{path}"] = a
                    if i == 0:
                        for path, a in full(opt["mu"]).items():
                            out[f"{tag}|mu|{path}"] = a
            info["losses"][tag], info["norms"][tag] = losses, norms
            return params

        def tsh_distribute(params, m, pc, cfg):
            params = copy.deepcopy(params)
            return distribute(params, make_shardings(m, pc, param_specs(cfg, params), params))

        # 1. each rank's DTensor blocks (arange-valued leaves: a block's first
        #    value and shape give its box)
        for tag in MESHES:
            m = mesh(tag)
            for arch in ("llama3-8b", "deepseek-v2-236b", "llama3-8b-sable"):
                cfg = cfg_of(arch)
                like = ttr.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
                ar = tree_map(lambda t: torch.arange(t.numel(), dtype=torch.float64)
                              .reshape(t.shape), like)
                dts = distribute(ar, make_shardings(m, ParallelConfig(),
                                                    param_specs(cfg, ar), ar))
                for (path, t), whole in zip(tree_paths(dts), tree_leaves(ar)):
                    loc = t.to_local()
                    start = np.unravel_index(int(loc.reshape(-1)[0]), tuple(t.shape))
                    box = [[int(s), int(s) + n] for s, n in zip(start, loc.shape)]
                    same = torch.equal(whole[tuple(slice(a, b) for a, b in box)], loc)
                    info["boxes"][f"{tag}|{arch}|{path}"] = box if same else None

        # 2. reduced llama3-8b's train step, float32
        cfg = cfg_of("llama3-8b")
        p0, d = load("llama", cfg)
        batch = {"tokens": d["tokens"], "labels": d["labels"]}
        for tag, mtag, pcf, remat in SCENARIOS:
            pc = ParallelConfig(**{"compress_grads": False, **pcf})
            train(tag, dataclasses.replace(cfg, remat=remat), p0, batch, mesh(mtag), pc)

        # 3. DeepSeek-V2 on (2, 4): expert-parallel forward, then a train step
        m24 = mesh("24")
        pc = ParallelConfig(compress_grads=False)
        ds0, d = load("deepseek", cfg_of("deepseek-v2-236b"))
        for dropless in (True, False):
            c = cfg_of("deepseek-v2-236b")
            c = dataclasses.replace(c, moe=dataclasses.replace(c.moe, capacity_factor=8.0,
                                                               dropless=dropless))
            view, _ = ctx.local_view(tsh_distribute(ds0, m24, pc, c))
            tok = torch.as_tensor(d["tokens"])
            with ctx.activation_sharding(m24, pc):
                k = 4 // 2
                i = m24.get_local_rank("data")
                logits, aux = ttr.forward_train(view, c, {"tokens": tok[i * k:(i + 1) * k]})
            whole = DTensor.from_local(logits, m24, [Shard(0), Shard(2)]).full_tensor()
            out[f"ds{int(dropless)}|logits"] = whole.detach().numpy()
            info["losses"][f"ds{int(dropless)}|aux"] = float(aux)
        c = dataclasses.replace(cfg_of("deepseek-v2-236b"),
                                moe=dataclasses.replace(cfg_of("deepseek-v2-236b").moe,
                                                        capacity_factor=8.0))
        train("ds_step", c, ds0, {"tokens": d["tokens"], "labels": d["labels"]}, m24, pc,
              steps=1)

        # 4. SABLE on ranks 0-3, mamba2 then seamless on ranks 4-7, each (2, 2)
        meshes = [mesh(((2, 2), ("data", "model")), list(range(4 * j, 4 * j + 4)))
                  for j in (0, 1)]
        pc = ParallelConfig(compress_grads=False)
        jobs = [["llama3-8b-sable"], ["mamba2-1.3b", "seamless-m4t-large-v2"]][rank // 4]
        for arch in jobs:
            c = cfg_of(arch)
            p = ttr.init_params(c, torch.Generator().manual_seed(0), device="cpu")
            g = torch.Generator().manual_seed(1)
            b = {"tokens": torch.randint(0, c.vocab_size, (4, 16), generator=g),
                 "labels": torch.randint(0, c.vocab_size, (4, 16), generator=g)}
            if c.is_encdec:
                b["src_embeds"] = torch.randn(4, 12, c.frontend_dim, generator=g)
            train(arch, c, p, b, meshes[rank // 4], pc, steps=1)
            if not arch.endswith("sable"):  # the mixer's / cross-attention's split
                from repro_torch.models import attention, ssm
                with ctx.activation_sharding(meshes[1], pc):
                    info.setdefault("split", {})[arch] = (
                        ssm._weights({k: torch.zeros(v.shape[1:]) for k, v in
                                      p["groups"][0]["sub0"]["mixer"].items()}, c)[1]
                        if arch.startswith("mamba") else attention._cross_kv_split(c, None))
            if arch.endswith("sable"):
                pats = layers.sable_patterns(c)
                mi = meshes[0].get_local_rank("model")
                keys = [tcache.plan_key("linear", tlin.pattern_hash(tlin.sub_pattern(q, mi, 2)),
                                        "torchcpu") for q in pats.values()]
                info["sub_plans"] = [tcache.default_cache().load_plan(k_) is not None
                                     for k_ in keys]
                info["sub_hashes"] = [tlin.pattern_hash(tlin.sub_pattern(q, mi, 2))
                                      for q in pats.values()]

        # 5. a checkpoint saved on (4, 2) and restored on (2, 4)
        w = torch.arange(64.0).reshape(8, 8)
        ma, mb = mesh(((4, 2), ("data", "model"))), mesh("24")
        ta = distribute({"w": w}, {"w": NamedSharding(ma, P("data", "model"))})
        save_checkpoint(os.path.join(root, "ckpt"), 3, ta)
        sh_b = {"w": NamedSharding(mb, P("model", "data"))}
        tb, step, _ = restore_checkpoint(os.path.join(root, "ckpt"), {"w": w}, shardings=sh_b)
        r, c_ = mb.get_local_rank("model"), mb.get_local_rank("data")
        info["ckpt"] = [step, [repr(x) for x in tb["w"].placements],
                        torch.equal(tb["w"].to_local(), w[2 * r:2 * r + 2, 4 * c_:4 * c_ + 4]),
                        torch.equal(tb["w"].full_tensor(), w)]

        # 6. save_async of DTensors (one replicated, one split), then an
        #    in-place update before the writer thread is done: the checkpoint
        #    holds the state at the save
        mgr = CheckpointManager(os.path.join(root, "async"))
        tree = distribute({"r": w.clone(), "s": w.clone()},
                          {"r": NamedSharding(mb, P()), "s": NamedSharding(mb, P("model", "data"))})
        mgr.save_async(1, tree)
        for t in tree.values():
            t.to_local().add_(1.0)
        mgr.wait()
        dist.barrier()
        back, step, _ = mgr.restore({"r": w, "s": w})
        info["async"] = [step, torch.equal(back["r"], w), torch.equal(back["s"], w),
                         torch.equal(tree["r"].full_tensor(), w + 1)]

        # 7. the bytes each rank sends in one step, at the configs' own dtypes
        #    (bfloat16 compute, compress_grads) on (1, 4, 2) and (1, 2, 4)
        info["moved"] = {}
        for shape, arch, dropless in VOLUME:
            c = (llama3_8b.reduced_sable() if arch.endswith("sable")
                 else get_config(arch, reduced=True))
            if dropless is not None:
                c = dataclasses.replace(c, moe=dataclasses.replace(c.moe, dropless=dropless))
            m = mesh(((1,) + tuple(shape), ("pod", "data", "model")))
            p = ttr.init_params(c, torch.Generator().manual_seed(0), device="cpu")
            p = tsh_distribute(p, m, ParallelConfig(), c)
            g = torch.Generator().manual_seed(1)
            b = {k_: torch.randint(0, c.vocab_size, (8, 16), generator=g)
                 for k_ in ("tokens", "labels")}
            step = make_train_step(c, AdamWConfig(lr=LR), ParallelConfig(), mesh=m)
            ctx.reset_moved_bytes()
            step(p, adamw_init(p, AdamWConfig(lr=LR)), b, 0)
            info["moved"][repr((shape, arch, dropless))] = ctx.moved_bytes()

        np.savez(os.path.join(root, f"rank{rank}.npz"), **(out if rank in (0, 4) else {}))
        with open(os.path.join(root, f"rank{rank}.json"), "w") as fh:
            json.dump(info, fh)
    finally:
        dist.destroy_process_group()
"""


def _wait_all(procs, timeout):
    """Wait for every process; kill them all past ``timeout`` seconds."""
    end = time.monotonic() + timeout
    outs = []
    try:
        for name, p in procs:
            out, err = p.communicate(timeout=max(end - time.monotonic(), 1))
            outs.append((name, p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for _, p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"ranks or the reference did not finish within {timeout} s")
    bad = [f"{n} rc={rc}\n{out[-3000:]}\n{err[-6000:]}" for n, rc, out, err in outs if rc != 0]
    assert not bad, "\n".join(bad)


def _save_tree(path, tree):
    np.savez(path, **{p: t.numpy() for p, t in tree_paths(tree)})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the eight gloo ranks, side by side;
    the reference's params (converted) go to the ranks as npz files."""
    jax = pytest.importorskip("jax")
    from repro.models import init_params as jinit

    root = tmp_path_factory.mktemp("ranks")
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    cfg = _llama()
    llama = params_from_arrays(jinit(cfg, jax.random.PRNGKey(0)), device=CPU)
    tokens = np.array(jax.random.randint(k1, (8, 16), 0, cfg.vocab_size))
    labels = np.array(jax.random.randint(k2, (8, 16), 0, cfg.vocab_size))
    np.savez(root / "llama.npz", tokens=tokens, labels=labels,
             **{p: t.numpy() for p, t in tree_paths(llama)})
    ds = _deepseek()
    dsp = params_from_arrays(jinit(ds, jax.random.PRNGKey(0)), device=CPU)
    dtok = np.array(jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0, ds.vocab_size))
    dlab = np.array(jax.random.randint(jax.random.PRNGKey(2), (4, 16), 0, ds.vocab_size))
    np.savez(root / "deepseek.npz", tokens=dtok, labels=dlab,
             **{p: t.numpy() for p, t in tree_paths(dsp)})

    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               REPRO_CACHE_DIR=str(root / "cache"), OMP_NUM_THREADS="1")
    fill = dict(meshes=MESHES, scenarios=SCENARIOS, lr=LR, volume=VOLUME)
    procs = [(f"reference {part}", subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE % fill), str(root), part],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for part in REF_PARTS]
    script = textwrap.dedent(RANK % fill)
    for r in range(RANKS):
        procs.append((f"rank{r}", subprocess.Popen(
            [sys.executable, "-c", script, str(r), str(RANKS), str(root / "store"), str(root)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    _wait_all(procs, 420)
    info = [json.loads((root / f"rank{r}.json").read_text()) for r in range(RANKS)]
    ref = {k: v for part in REF_PARTS for k, v in np.load(root / f"ref-{part}.npz").items()}
    ref_info = {part: json.loads((root / f"ref-{part}.json").read_text()) for part in REF_PARTS}
    return dict(root=root, ref=ref, info=info,
                ref_info={"boxes": ref_info["blocks"]["boxes"],
                          "losses": ref_info["llama"]["losses"]},
                out={r: dict(np.load(root / f"rank{r}.npz")) for r in (0, 4)},
                llama=llama, batch={"tokens": tokens, "labels": labels},
                deepseek=dsp, ds_batch={"tokens": dtok, "labels": dlab})


def _unsharded(cfg, params, batch, steps, pc, lr=LR):
    """The port's unsharded steps: [(loss, grad_norm, params, mu)], each
    params and mu as {path: numpy}."""
    import copy

    params = copy.deepcopy(params)
    opt = adamw_init(params, AdamWConfig(lr=lr))
    step = tstep.make_train_step(cfg, AdamWConfig(lr=lr), pc)
    out = []
    for i in range(steps):
        params, opt, met = step(params, opt, batch, i)
        out.append((float(met["loss"]), float(met["grad_norm"]),
                    {p: t.detach().numpy().copy() for p, t in tree_paths(params)},
                    {p: t.detach().numpy().copy() for p, t in tree_paths(opt["mu"])}))
    return out


@pytest.fixture(scope="module")
def unsharded(runs):
    """The port's unsharded llama steps, without and with compress_grads."""
    cfg = _llama()
    return {c: _unsharded(cfg, runs["llama"], runs["batch"], 2,
                          tsh.ParallelConfig(compress_grads=c)) for c in (False, True)}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_local_blocks_match_devices_indices_map(runs, mesh):
    """Each rank's block of every leaf (llama3-8b, DeepSeek-V2, SABLE) is the
    one the reference's NamedSharding gives the device at the same mesh
    coordinates."""
    want = {k: v for k, v in runs["ref_info"]["boxes"].items() if k.startswith(mesh + "|")}
    assert want
    for r, info in enumerate(runs["info"]):
        for key, boxes in want.items():
            assert info["boxes"][key] == boxes[r], (r, key)


def _leaves(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


def _check_against_unsharded(out, info, tag, want, steps, tol=SELF, params_tol=REF_TOL):
    """Losses and grad norms to ``tol``, the first step's mu to ``tol`` of
    each leaf's scale, the params to ``params_tol``."""
    np.testing.assert_allclose(info["losses"][tag], [w[0] for w in want[:steps]], rtol=tol)
    np.testing.assert_allclose(info["norms"][tag], [w[1] for w in want[:steps]], rtol=tol)
    for path, mu in _leaves(out, f"{tag}|mu|").items():
        w = want[0][3][path]
        np.testing.assert_allclose(mu, w, rtol=0, atol=tol * max(np.abs(w).max(), 1e-12),
                                   err_msg=f"{tag} mu {path}")
    for i in range(steps):
        got = _leaves(out, f"{tag}|p{i}|")
        assert sorted(got) == sorted(want[i][2])
        for path, a in got.items():
            np.testing.assert_allclose(a, want[i][2][path], **params_tol,
                                       err_msg=f"{tag} step {i} {path}")


@pytest.mark.parametrize("tag", ["m222", "m24"])
def test_train_step_matches_reference_single_device_and_mesh(runs, unsharded, tag):
    """Reduced llama3-8b, float32, 8 x 16, two steps on (2, 2, 2) ("pod",
    "data", "model") and on (2, 4) ("data", "model"; 6 heads do not divide
    4: attention runs whole on each model rank): the loss and every updated
    leaf against the reference's single-device step and its step on the
    same mesh, and against the port's unsharded step."""
    out, info, ref = runs["out"][0], runs["info"][0], runs["ref"]
    for other in ("single", tag):
        np.testing.assert_allclose(info["losses"][tag], runs["ref_info"]["losses"][other],
                                   **REF_TOL)
        for i in range(2):
            got = _leaves(out, f"{tag}|p{i}|")
            want = _leaves(ref, f"{other}|p{i}|")
            assert sorted(got) == sorted(want)
            for path in got:
                np.testing.assert_allclose(got[path], want[path], **REF_TOL,
                                           err_msg=f"{tag} vs {other} step {i} {path}")
    _check_against_unsharded(out, info, tag, unsharded[False], 2)


@pytest.mark.parametrize("tag", ["pod", "compress", "dots"])
def test_train_step_variants_match(runs, unsharded, tag):
    """fsdp_over_pod (ZeRO over ("pod", "data")), compress_grads (bfloat16
    gradient collectives: a bfloat16 tolerance) and remat "dots" on (2, 2,
    2), against the port's unsharded step and the reference's single-device
    one."""
    out, info = runs["out"][0], runs["info"][0]
    compress = tag == "compress"
    tol = BF16["rtol"] if compress else SELF
    _check_against_unsharded(out, info, tag, unsharded[compress], 2, tol=tol,
                             params_tol=BF16 if compress else REF_TOL)
    ref = "single_c" if compress else "single"
    np.testing.assert_allclose(info["losses"][tag], runs["ref_info"]["losses"][ref],
                               **(BF16 if compress else REF_TOL))
    for path, a in _leaves(out, f"{tag}|p1|").items():
        np.testing.assert_allclose(a, runs["ref"][f"{ref}|p1|{path}"],
                                   **(BF16 if compress else REF_TOL), err_msg=path)


@pytest.mark.parametrize("dropless", [True, False])
def test_moe_expert_parallel_forward_matches_reference(runs, dropless):
    """Reduced DeepSeek-V2, capacity_factor 8, float32, on (2, 4): the
    logits against the reference's single-device forward and its forward on
    the same mesh (2e-3, as the reference's own test)."""
    got = runs["out"][0][f"ds{int(dropless)}|logits"]
    for other in ("single", "m24"):
        np.testing.assert_allclose(got, runs["ref"][f"ds{int(dropless)}|{other}"], **EP_TOL)


def test_moe_train_step_with_aux_loss_matches_unsharded(runs):
    """One expert-parallel train step (capacity path, the load-balance loss
    over the whole batch) against the port's unsharded step."""
    want = _unsharded(_deepseek(), runs["deepseek"], runs["ds_batch"], 1,
                      tsh.ParallelConfig(compress_grads=False))
    _check_against_unsharded(runs["out"][0], runs["info"][0], "ds_step", want, 1)


@pytest.mark.parametrize("arch", [SABLE, "mamba2-1.3b", "seamless-m4t-large-v2"])
def test_two_by_two_step_matches_unsharded(runs, arch):
    """One step on (2, 2): SABLE (each rank's K2 on its own sub-pattern,
    whose plan key is in the plan cache), the Mamba-2 mixer split by SSD
    heads (4 of 8 a rank) and seamless's cross-attention split by heads (2
    of 4 a rank, its K/V heads with them)."""
    rank = 0 if arch == SABLE else 4
    cfg = dataclasses.replace(_cfg(arch), compute_dtype="float32")
    params = ttr.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 16), generator=g),
             "labels": torch.randint(0, cfg.vocab_size, (4, 16), generator=g)}
    if cfg.is_encdec:
        batch["src_embeds"] = torch.randn(4, 12, cfg.frontend_dim, generator=g)
    want = _unsharded(cfg, params, batch, 1, tsh.ParallelConfig(compress_grads=False))
    _check_against_unsharded(runs["out"][rank], runs["info"][rank], arch, want, 1)
    if arch == "mamba2-1.3b":
        assert [runs["info"][r]["split"][arch] for r in range(4, 8)] == [[0, 4], [4, 8]] * 2
    elif arch != SABLE:
        assert all(runs["info"][r]["split"][arch] for r in range(4, 8))
    if arch == SABLE:
        hashes = [runs["info"][r]["sub_hashes"] for r in range(4)]
        assert all(all(i["sub_plans"]) for i in runs["info"][:4])
        assert hashes[0] == hashes[2] and hashes[1] == hashes[3] and hashes[0] != hashes[1]


def test_async_checkpoint_of_dtensors_holds_the_state_at_the_save(runs):
    """save_async on eight ranks, then an in-place update of the DTensors'
    storage: the restored leaves are the values at the save, replicated
    and split alike."""
    for info in runs["info"]:
        assert info["async"] == [1, True, True, True]


@pytest.mark.parametrize("case", VOLUME, ids=lambda c: f"{c[1]}-{c[0][0]}x{c[0][1]}-{c[2]}")
def test_collective_bytes_match_the_worked_out_volume(runs, case):
    """The bytes ``ctx.moved_bytes()`` counts in one step, on the rank that
    sends most (the one-chunk exchange skips ranks that already hold
    their chunk), equal ``tools/shard_volume.py``'s ``step_bytes``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("shard_volume", TOOLS / "shard_volume.py")
    shard_volume = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(shard_volume)
    shape, arch, dropless = case
    cfg = _cfg(arch)
    if dropless is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dropless=dropless))
    counted = [sum(i["moved"][repr(case)].values()) for i in runs["info"]]
    assert max(counted) == pytest.approx(shard_volume.step_bytes(cfg, *shape, 8, 16),
                                         rel=1e-12)


def test_elastic_checkpoint_across_mesh_shapes(runs):
    """Saved on (4, 2) as P("data", "model"), restored on (2, 4) as
    P("model", "data") (each rank its block) and in one process."""
    from repro_torch.checkpoint.manager import restore_checkpoint

    for info in runs["info"]:
        step, placements, block, whole = info["ckpt"]
        assert step == 3 and block and whole
        assert placements == ["Shard(dim=1)", "Shard(dim=0)"]
    t, step, _ = restore_checkpoint(str(runs["root"] / "ckpt"), {"w": torch.zeros(8, 8)})
    assert step == 3 and torch.equal(t["w"], torch.arange(64.0).reshape(8, 8))


# ---------------------------------------------------------------------- #
# the CLI
# ---------------------------------------------------------------------- #
def _cli_losses(stdout: str) -> list:
    return [float(line.split()[3]) for line in stdout.splitlines() if line.startswith("step ")]


def test_train_cli_devices_matches_unsharded(tmp_path):
    """--device cpu --devices 4 (four gloo ranks on a (1, 4) mesh), 3 steps
    then --resume for 2: the losses the unsharded CLI prints over 5 steps
    within ``CLI_TOL`` (the config's compute dtype, bfloat16); rank 0 alone
    prints."""
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_CACHE_DIR=str(tmp_path / "cache"),
               OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama3-8b", "--sable",
            "--reduced", "--batch", "4", "--seq", "16", "--device", CPU, "--log-every", "1"]

    def run(*extra):
        r = subprocess.run(base + list(extra), capture_output=True, text=True, env=env,
                           timeout=240)
        assert r.returncode == 0, r.stderr[-4000:]
        return r.stdout

    first = run("--devices", "4", "--steps", "3", "--ckpt-dir", str(tmp_path / "a"))
    second = run("--devices", "4", "--steps", "2", "--resume", "--ckpt-dir",
                 str(tmp_path / "a"))
    plain = run("--steps", "5", "--ckpt-dir", str(tmp_path / "b"))
    assert "resumed=True at step 3" in second and "@ step 5" in second
    assert first.count("final loss") == 1  # rank 0 alone
    sharded = _cli_losses(first) + _cli_losses(second)
    assert len(sharded) == 5
    np.testing.assert_allclose(sharded, _cli_losses(plain), rtol=CLI_TOL)
