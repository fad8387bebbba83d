"""PyTorch port, sharded serving (``prefill``/``decode_step``/``encode``
under ``activation_sharding`` with a cache of DTensors laid out by
``cache_specs``) against the JAX package.

Eight gloo ranks (``python -c`` processes sharing a ``file://`` store, as
``test_torch_model_sharding.py`` starts them) run reduced llama3-8b,
DeepSeek-V2 (capacity and dropless), mamba2-1.3b, jamba and seamless in
float32 on ``(2, 2, 2)``, ``(2, 4)`` and ``(1, 8)``: a prefill of 32
tokens into a cache of 64 positions (an enc-dec model's 16 source frames
encoded first), then 4 decode steps. Beside them one reference subprocess
a config (8 forced host devices, ``jax.sharding.Mesh`` built directly: the
reference's constraints refuse ``jax.make_mesh``'s Explicit axes) runs
the same params, jitted as its dry-run's ``build_cell`` jits them, on one
device and on each mesh. The gathered logits and every cache leaf's
``full_tensor()`` must match both at atol = rtol = 1e-5 (the reference's
own gap between its sharded and single-device runs is under 1e-6).

The ranks also record what shows the split paths run split: the local K/V
block of reduced llama3-8b on ``(2, 4)`` (6 query heads, 2 key/value
heads: a context-parallel cache of 64 / 4 positions), DeepSeek-V2's latent
block, the width of a Mamba rank's ``in_x`` block and the shapes gathered
over "model" in a mamba2 decode step, and a batch of one row (it does not
split over the data shards and runs whole on every rank); and a decode step
at per-lane positions on a context-parallel cache against the port's
unsharded step.
"""
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

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

SRC = str(Path(__file__).resolve().parent.parent / "src")
RANKS = 8
MESHES = {"222": ((2, 2, 2), ("pod", "data", "model")), "24": ((2, 4), ("data", "model")),
          "18": ((1, 8), ("data", "model"))}
# (name, arch, MoE dropless)
CONFIGS = (("llama", "llama3-8b", False), ("ds_capacity", "deepseek-v2-236b", False),
           ("ds_dropless", "deepseek-v2-236b", True), ("mamba", "mamba2-1.3b", False),
           ("jamba", "jamba-1.5-large-398b", False), ("seamless", "seamless-m4t-large-v2", False))
B, PROMPT, SMAX, STEPS, ENC = 4, 32, 64, 4, 16
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(arch, dropless):
    import dataclasses

    cfg = dataclasses.replace(get_config(arch, reduced=True), compute_dtype="float32")
    if cfg.moe is not None:  # no token dropped: the grouping of the capacity path is moot
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0,
                                                               dropless=dropless))
    return cfg


REFERENCE = """
    import contextlib, dataclasses, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.distributed.ctx import activation_sharding
    from repro.distributed.sharding import (ParallelConfig, batch_specs, cache_specs,
                                            make_shardings, param_specs)
    from repro.models import transformer as jtr

    root, name, arch, dropless = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4] == "1"
    MESHES, B, PROMPT, SMAX, STEPS, ENC = %(fill)r

    def paths(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return [("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp), v)
                for kp, v in flat]

    cfg = dataclasses.replace(get_config(arch, reduced=True), compute_dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0,
                                                               dropless=dropless))
    d = np.load(f"{root}/{name}.npz")
    like = jax.eval_shape(lambda: jtr.init_params(cfg, jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(like),
                                          [jnp.asarray(d["p/" + p]) for p, _ in paths(like)])
    tokens, steps = jnp.asarray(d["tokens"]), jnp.asarray(d["steps"])
    src = jnp.asarray(d["src"]) if cfg.is_encdec else jnp.zeros(())
    enc = ENC if cfg.is_encdec else 0
    out = {}

    def pre(p, t, c, s):
        eo = jtr.encode(p, cfg, s) if cfg.is_encdec else None
        return jtr.prefill(p, cfg, t, c, enc_out=eo)

    def dec(p, t, c, pos):
        return jtr.decode_step(p, cfg, t, c, pos)

    def run(tag, mesh):
        cache = jtr.init_cache(cfg, B, SMAX, enc_len=enc)
        ctx = contextlib.nullcontext()
        fp, fd, p, c = jax.jit(pre), jax.jit(dec), params, cache
        if mesh is not None:  # as the dry-run's build_cell places a serving cell
            pc = ParallelConfig()
            ps = make_shardings(mesh, pc, param_specs(cfg, params), params)
            cs = make_shardings(mesh, pc, cache_specs(cfg, cache, pc, mesh.shape["model"]),
                                cache)
            ins = {"tokens": tokens, "src": src} if cfg.is_encdec else {"tokens": tokens}
            bs = make_shardings(mesh, pc, batch_specs(cfg, ins), ins)
            ts = make_shardings(mesh, pc, batch_specs(cfg, {"t": steps[0]}), {"t": steps[0]})
            rep = NamedSharding(mesh, P())
            fp = jax.jit(pre, in_shardings=(ps, bs["tokens"], cs, bs.get("src", rep)),
                         out_shardings=(None, cs))
            fd = jax.jit(dec, in_shardings=(ps, ts["t"], cs, rep), out_shardings=(None, cs))
            p, c = jax.device_put(params, ps), jax.device_put(cache, cs)
            ctx = activation_sharding(mesh, pc)
        with ctx:
            lg, c = fp(p, tokens, c, src)
            out[f"{tag}|logits|0"] = np.asarray(jax.device_get(lg))
            for i in range(STEPS):
                lg, c = fd(p, steps[i], c, jnp.int32(PROMPT + i))
                out[f"{tag}|logits|{i + 1}"] = np.asarray(jax.device_get(lg))
        for path, leaf in paths(c):
            out[f"{tag}|cache|{path}"] = np.asarray(jax.device_get(leaf))

    with jax.default_matmul_precision("highest"):
        run("single", None)
        for tag, (shape, names) in MESHES.items():
            run(tag, Mesh(np.array(jax.devices()[:8]).reshape(shape), names))
    np.savez(f"{root}/ref-{name}.npz", **out)
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
        from repro_torch.configs import get_config
        from repro_torch.distributed import ctx
        from repro_torch.distributed.sharding import (ParallelConfig, cache_specs, distribute,
                                                      make_shardings, param_specs)
        from repro_torch.models import ssm, transformer as ttr
        from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten

        MESHES, B, PROMPT, SMAX, STEPS, ENC = %(fill)r
        CONFIGS = %(configs)r
        out, info = {}, {"blocks": {}, "gathers": [], "in_x": {}, "one_row": {},
                         "per_lane": {}}
        gathers = None
        real_gather = ctx._all_gather

        def logged_gather(x, dim, ax):
            y = real_gather(x, dim, ax)
            if gathers is not None and ax.name == "model":
                gathers.append(list(y.shape))
            return y

        ctx._all_gather = logged_gather

        def cfg_of(arch, dropless):
            cfg = dataclasses.replace(get_config(arch, reduced=True), compute_dtype="float32")
            if cfg.moe is not None:
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, capacity_factor=8.0, dropless=dropless))
            return cfg

        def mesh(tag):
            shape, names = MESHES[tag]
            return DeviceMesh("cpu", torch.arange(8).reshape(shape), mesh_dim_names=names)

        def serve(cfg, params, d, m, b=B):
            pc = ParallelConfig()
            enc = ENC if cfg.is_encdec else 0
            dp = distribute(copy.deepcopy(params),
                            make_shardings(m, pc, param_specs(cfg, params), params))
            c = ttr.init_cache(cfg, b, SMAX, enc_len=enc, device="cpu")
            dc = distribute(c, make_shardings(m, pc, cache_specs(cfg, c, pc, m.size(-1)), c))
            tokens = torch.as_tensor(d["tokens"][:b]).long()
            logits = []
            with ctx.activation_sharding(m, pc):
                eo = (ttr.encode(dp, cfg, torch.as_tensor(d["src"][:b])) if cfg.is_encdec
                      else None)
                lg, back = ttr.prefill(dp, cfg, tokens, dc, enc_out=eo)
                assert back is dc
                logits.append(ttr.whole_logits(lg, cfg, b))
                for i in range(STEPS):
                    lg, _ = ttr.decode_step(dp, cfg, torch.as_tensor(d["steps"][i][:b]).long(),
                                            dc, PROMPT + i)
                    logits.append(ttr.whole_logits(lg, cfg, b))
            return dp, dc, logits

        for name, arch, dropless in CONFIGS:
            cfg = cfg_of(arch, dropless)
            d = np.load(os.path.join(root, name + ".npz"))
            like = ttr.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
            params = tree_unflatten(like, [torch.as_tensor(d["p/" + p]) for p, _ in
                                           tree_paths(like)])
            for tag in MESHES:
                m = mesh(tag)
                dp, dc, logits = serve(cfg, params, d, m)
                for i, lg in enumerate(logits):
                    out[f"{name}|{tag}|logits|{i}"] = lg.numpy()
                for path, t in tree_paths(dc):
                    out[f"{name}|{tag}|cache|{path}"] = t.full_tensor().numpy()
                    info["blocks"][f"{name}|{tag}|{path}"] = list(t.to_local().shape)
                if name == "mamba":
                    view, _ = ctx.local_view(dp)
                    layer = {k: v.unbind(0)[0] if isinstance(v, ctx.ShardedLeaf) else v[0]
                             for k, v in view["groups"][0]["sub0"]["mixer"].items()}
                    with ctx.activation_sharding(m, ParallelConfig()):
                        w, heads = ssm._weights(layer, cfg)
                        info["in_x"][tag] = [list(w["in_x"].shape), heads]
                        gathers = []
                        ctx.reset_moved_bytes()
                        ttr.decode_step(dp, cfg, torch.zeros((B, 1), dtype=torch.long), dc,
                                        PROMPT + STEPS)
                        info["gathers"].append([tag, gathers, {
                            "|".join((k, *a)): v
                            for (k, a), v in ctx.moved_bytes(by_axes=True).items()}])
                        gathers = None
                if name in ("llama", "ds_capacity") and tag in ("24", "18"):
                    # a per-lane (B,) position on the context-parallel cache,
                    # each lane at its own slot, against the same step unsharded
                    pos = torch.arange(B) + PROMPT + STEPS
                    tok = torch.as_tensor(d["steps"][0]).long()
                    plain = tree_unflatten(dc, [t.full_tensor().clone()
                                                for t in tree_leaves(dc)])
                    want = ttr.decode_step(params, cfg, tok, plain, pos)[0]
                    with ctx.activation_sharding(m, ParallelConfig()):
                        lg, _ = ttr.decode_step(dp, cfg, tok, dc, pos)
                        got = ttr.whole_logits(lg, cfg, B)
                    info["per_lane"][f"{name}|{tag}"] = [
                        float((got - want).abs().max()),
                        max(float((t.full_tensor() - w_).abs().max())
                            for (_, t), w_ in zip(tree_paths(dc), tree_leaves(plain)))]
                if name == "llama" and tag == "222":  # one row: whole on every data shard
                    _, dc1, lg1 = serve(cfg, params, d, m, b=1)
                    c1 = ttr.init_cache(cfg, 1, SMAX, device="cpu")
                    want = [ttr.prefill(params, cfg, torch.as_tensor(d["tokens"][:1]).long(),
                                        c1)[0]]
                    for i in range(STEPS):
                        want.append(ttr.decode_step(
                            params, cfg, torch.as_tensor(d["steps"][i][:1]).long(), c1,
                            PROMPT + i)[0])
                    info["one_row"] = {
                        "logits": max(float((a - b_).abs().max()) for a, b_ in zip(lg1, want)),
                        "cache": max(float((t.full_tensor() - w_).abs().max()) for (_, t), (_, w_)
                                     in zip(tree_paths(dc1), tree_paths(c1))),
                        "blocks": [list(t.to_local().shape) for _, t in tree_paths(dc1)]}
        if rank == 0:
            np.savez(os.path.join(root, "rank0.npz"), **out)
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs (the port's params from a seed, numpy tokens), then the
    reference's subprocesses and the eight gloo ranks side by side."""
    pytest.importorskip("jax")
    root = tmp_path_factory.mktemp("serve")
    made = set()
    for name, arch, dropless in CONFIGS:
        cfg = _cfg(arch, dropless)
        params = ttr.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        rng = np.random.default_rng(1)
        arrays = {"p/" + p: t.numpy() for p, t in tree_paths(params)}
        arrays["tokens"] = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
        arrays["steps"] = rng.integers(0, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
        if cfg.is_encdec:
            arrays["src"] = rng.standard_normal((B, ENC, cfg.frontend_dim)).astype(np.float32)
        np.savez(root / f"{name}.npz", **arrays)
        made.add(name)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               REPRO_CACHE_DIR=str(root / "cache"), OMP_NUM_THREADS="1")
    fill = dict(fill=(MESHES, B, PROMPT, SMAX, STEPS, ENC), configs=CONFIGS)
    ref = textwrap.dedent(REFERENCE % fill)
    procs = [(f"reference {name}", subprocess.Popen(
        [sys.executable, "-c", ref, str(root), name, arch, str(int(dropless))], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for name, arch, dropless in CONFIGS]
    script = textwrap.dedent(RANK % fill)
    for r in range(RANKS):
        procs.append((f"rank{r}", subprocess.Popen(
            [sys.executable, "-c", script, str(r), str(RANKS), str(root / "store"), str(root)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    _wait_all(procs, 420)
    ref = {}
    for name, _, _ in CONFIGS:
        ref.update({f"{name}|{k}": v for k, v in np.load(root / f"ref-{name}.npz").items()})
    return dict(ref=ref, out=dict(np.load(root / "rank0.npz")),
                info=[json.loads((root / f"rank{r}.json").read_text()) for r in range(RANKS)])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", [c[0] for c in CONFIGS])
def test_sharded_prefill_and_decode_match_reference(runs, name, mesh):
    """The gathered logits of the prefill and of each decode step, and every
    cache leaf's ``full_tensor()``, against the reference's run on the same
    mesh and on one device."""
    out, ref = runs["out"], runs["ref"]
    got = {k[len(f"{name}|{mesh}|"):]: v for k, v in out.items()
           if k.startswith(f"{name}|{mesh}|")}
    assert len([k for k in got if k.startswith("logits|")]) == STEPS + 1
    assert any(k.startswith("cache|") for k in got)
    for other in ("single", mesh):
        for key, a in got.items():
            want = ref[f"{name}|{other}|{key}"]
            assert a.shape == want.shape, (key, a.shape, want.shape)
            np.testing.assert_allclose(a, want, **TOL, err_msg=f"{name} {mesh} vs {other}: {key}")


def test_context_parallel_caches_split_the_sequence(runs):
    """On (2, 4) llama3's key/value heads (2) do not divide "model": its
    local K/V block holds 64 / 4 positions; DeepSeek-V2's latent is split
    the same way; on (2, 2, 2) llama3's K/V block holds its key/value head
    (heads divide) and every position."""
    blocks = runs["info"][0]["blocks"]
    for path in ("0/sub0/attn/k", "0/sub0/attn/v"):
        rep = blocks[f"llama|24|{path}"][0]
        assert blocks[f"llama|24|{path}"] == [rep, B // 2, SMAX // 4, 2, 16]
        assert blocks[f"llama|222|{path}"] == [rep, B // 4, SMAX, 1, 16]
    for name in ("ds_capacity", "ds_dropless"):
        ckv = [v for k, v in blocks.items() if k.startswith(f"{name}|24|") and k.endswith("/ckv")]
        assert ckv and all(b[1:3] == [B // 2, SMAX // 4] for b in ckv)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mamba_mixer_runs_split(runs, mesh):
    """A rank's ``in_x`` block is d_inner / M wide and its heads its own;
    the decode step gathers no ``in_x``, ``in_z`` or ``out_proj`` over
    "model" (only the conv window, the new x channels, ``in_b``/``in_c``
    and the conv weight, all small)."""
    cfg = _cfg("mamba2-1.3b", False)
    di, nh = cfg.ssm.d_inner(cfg.d_model), cfg.ssm.n_heads(cfg.d_model)
    M = MESHES[mesh][0][-1]
    for r, info in enumerate(runs["info"]):
        shape, heads = info["in_x"][mesh]
        assert shape == [cfg.d_model, di // M]
        mr = r % M
        assert heads == [mr * nh // M, (mr + 1) * nh // M]
        tag, gathered, moved = next(g for g in info["gathers"] if g[0] == mesh)
        whole = ([cfg.d_model, di], [di, cfg.d_model])
        assert gathered and not [g for g in gathered if g[-2:] in whole], gathered
        assert all(np.prod(g) < cfg.d_model * di for g in gathered)
        assert moved.get("all_reduce|model", 0) > 0  # out_proj's partial sums


def test_batch_that_does_not_split_runs_whole_on_every_data_shard(runs):
    """One row on (2, 2, 2): every rank holds the whole row's cache block
    and the result equals the port's unsharded prefill and decode."""
    for info in runs["info"]:
        one = info["one_row"]
        assert one["logits"] < 1e-5 and one["cache"] < 1e-5
        assert all(b[1] == 1 for b in one["blocks"])


def test_per_lane_positions_on_a_context_parallel_cache(runs):
    """A decode step whose (B,) positions differ by lane, on (2, 4) and
    (1, 8) where llama3's K/V and DeepSeek-V2's latent split the sequence:
    each lane written on the rank that owns its slot; logits and cache
    equal the port's unsharded step with the same positions."""
    for info in runs["info"]:
        assert sorted(info["per_lane"]) == ["ds_capacity|18", "ds_capacity|24", "llama|18",
                                            "llama|24"]
        for key, (logits, cache) in info["per_lane"].items():
            assert logits < 1e-5 and cache < 1e-5, (key, logits, cache)
