"""PyTorch port, training: ``forward_train`` (every remat policy), the train
and eval steps, AdamW and its schedule, the data pipeline, checkpoints,
``TrainLoop`` and the training CLI, against the JAX package on the same
params, batches and steps.

Params come from the reference's ``init_params`` and are carried across
with ``convert.params_from_arrays`` (its AdamW state with
``convert.opt_state_from_arrays``); models run at compute and param dtype
float32. Logits, the MoE aux loss, gradients and a train step's params,
moments, loss, grad norm and learning rate agree to 1e-4; data batches,
the schedule's values and checkpoint bytes exactly. Each reference
function is jitted once per config (module-scoped fixture).
"""
import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs this file beside the JAX suites

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import manager as tckpt  # noqa: E402
from repro_torch.configs import llama3_8b as tl  # noqa: E402
from repro_torch.configs.shapes import Shape  # noqa: E402
from repro_torch.convert import opt_state_from_arrays, params_from_arrays  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.distributed.sharding import ParallelConfig  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim.schedule import cosine_schedule  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from test_torch_linear import _sealed_reference_plans  # noqa: E402,F401 (autouse)

CPU = "cpu"
TOL = dict(rtol=1e-4, atol=1e-4)
SABLE = "llama3-8b-sable"
# the reduced configs forward_train is held on: (arch, dropless or None)
MODELS = {
    SABLE: None,
    "deepseek-v2-236b": True,
    "deepseek-v2-236b-capacity": False,
    "mamba2-1.3b": None,
    "jamba-1.5-large-398b": None,
}


def _f32(cfg, dropless=None):
    cfg = dataclasses.replace(cfg, compute_dtype="float32", param_dtype="float32")
    if dropless is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dropless=dropless))
    return cfg


@pytest.fixture(scope="module")
def jx():
    """The reference's modules on JAX's CPU device in full float32, and a
    jit of each function once per key."""
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.checkpoint import manager
    from repro.configs import llama3_8b
    from repro.data import pipeline
    from repro.distributed.sharding import ParallelConfig as JPC
    from repro.models import transformer
    from repro.optim import adamw, schedule
    from repro.train import loop, step

    compiled = {}

    def jit(key, fn):
        if key not in compiled:
            compiled[key] = jax.jit(fn)
        return compiled[key]

    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        yield SimpleNamespace(jax=jax, jnp=jax.numpy, configs=configs, llama3_8b=llama3_8b,
                              tr=transformer, step=step, loop=loop, adamw=adamw,
                              schedule=schedule, data=pipeline, ckpt=manager, PC=JPC, jit=jit)


def _configs(jx, name):
    arch = name.removesuffix("-capacity")
    if arch == SABLE:
        jcfg, tcfg = jx.llama3_8b.reduced_sable(), tl.reduced_sable()
    else:
        jcfg = jx.configs.get_config(arch, reduced=True)
        tcfg = tconfigs.get_config(arch, reduced=True)
    jcfg, tcfg = _f32(jcfg, MODELS[name]), _f32(tcfg, MODELS[name])
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _flat(tree, prefix=""):
    """(path, leaf) pairs, dict keys sorted, of either package's tree."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flat(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flat(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _close(got_tree, want_tree, **tol):
    got, want = _flat(got_tree), _flat(want_tree)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        g = g.detach().float().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(w, dtype=np.float32), err_msg=k,
                                   **(tol or TOL))


def _batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.fixture(scope="module")
def ref_train(jx):
    """Per model: the reference's params (numpy), and its logits, aux and
    gradient of CE + aux on one batch (remat none: the values are the same
    under any policy)."""
    out = {}

    def get(name):
        if name not in out:
            jcfg, tcfg = _configs(jx, name)
            p = jx.jax.tree.map(np.asarray, jx.tr.init_params(jcfg, jx.jax.random.PRNGKey(0)))
            batch = _batch(tcfg)

            def loss(p, b):
                logits, aux = jx.tr.forward_train(p, jcfg, b)
                return jx.step.cross_entropy(logits, b["labels"]) + aux, (logits, aux)

            (val, (logits, aux)), grads = jx.jax.jit(
                jx.jax.value_and_grad(loss, has_aux=True))(p, batch)
            out[name] = SimpleNamespace(p=p, batch=batch, loss=float(val),
                                        logits=np.asarray(logits), aux=float(aux),
                                        grads=grads, tcfg=tcfg)
        return out[name]

    return get


# ---------------------------------------------------------------------- #
# forward_train
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_train_and_grads_match_jax(ref_train, name, remat):
    r = ref_train(name)
    cfg = dataclasses.replace(r.tcfg, remat=remat)
    tp = params_from_arrays(r.p, device=CPU)
    leaves = [v for _, v in _flat(tp)]
    for v in leaves:
        v.requires_grad_()
    batch = tstep.batch_to_device(r.batch, torch.device(CPU))
    logits, aux = ttr.forward_train(tp, cfg, batch)
    np.testing.assert_allclose(logits.detach().numpy(), r.logits, **TOL)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    np.testing.assert_allclose(float(aux.detach()), r.aux, **TOL)
    loss = tstep.cross_entropy(logits, batch["labels"]) + aux
    np.testing.assert_allclose(float(loss.detach()), r.loss, **TOL)
    loss.backward()
    _close(jax_like(tp, "grad"), r.grads)


def jax_like(tree, attr):
    """The tree of each leaf's ``attr`` (e.g. its grad)."""
    if isinstance(tree, dict):
        return {k: jax_like(v, attr) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_like(v, attr) for v in tree]
    return getattr(tree, attr)


def test_eval_step_matches_jax(jx, ref_train):
    r = ref_train(SABLE)
    want = float(jx.step.make_eval_step(_configs(jx, SABLE)[0])(r.p, r.batch))
    got = tstep.make_eval_step(r.tcfg)(params_from_arrays(r.p, device=CPU), r.batch)
    np.testing.assert_allclose(float(got), want, **TOL)


def test_one_repeat_group_params_train_as_leaves():
    """init_params keeps a one-repeat group's draws (DeepSeek-V2's dense
    layer 0) held once: they take requires_grad_() and in-place updates."""
    cfg = _f32(tconfigs.get_config("deepseek-v2-236b", reduced=True))
    p = ttr.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    leaf = p["groups"][0]["sub0"]["ln_ffn"]
    assert cfg.groups[0].repeat == 1 and leaf.shape[0] == 1 and leaf._base is None
    opt_cfg = tadamw.AdamWConfig()
    step = tstep.make_train_step(cfg, opt_cfg)
    before = leaf.clone()
    step(p, tadamw.adamw_init(p, opt_cfg), _batch(cfg, S=8), 0)
    assert leaf.requires_grad and not torch.equal(leaf.detach(), before)


# ---------------------------------------------------------------------- #
# one train step, and the loop
# ---------------------------------------------------------------------- #
def _ref_step(jx, compress):
    jcfg, _ = _configs(jx, SABLE)
    opt = jx.adamw.AdamWConfig(lr=1e-2)

    def sched(s):
        return jx.schedule.cosine_schedule(s, 1e-2, warmup=2, total=10)

    fn = jx.step.make_train_step(jcfg, opt, jx.PC(compress_grads=compress), schedule=sched)
    return jx.jit(("step", compress), fn)


def _port_step(compress):
    opt = tadamw.AdamWConfig(lr=1e-2)
    return tstep.make_train_step(tl_f32(), opt, ParallelConfig(compress_grads=compress),
                                 schedule=lambda s: cosine_schedule(s, 1e-2, warmup=2, total=10))


def tl_f32():
    return _f32(tl.reduced_sable())


@pytest.mark.parametrize("compress", [True, False])
def test_train_step_matches_jax(jx, ref_train, compress):
    """Two steps from the same params: params, mu, nu, count, loss, grad norm
    and lr after each; the port's second step starts from the reference's
    first-step params and AdamW state, carried across."""
    r = ref_train(SABLE)
    jstep = _ref_step(jx, compress)
    jopt = jx.adamw.adamw_init(r.p, jx.adamw.AdamWConfig(lr=1e-2))
    step = _port_step(compress)
    tp = params_from_arrays(r.p, device=CPU)
    topt = tadamw.adamw_init(tp, tadamw.AdamWConfig(lr=1e-2))
    jp = r.p
    for i in range(2):
        batch = _batch(r.tcfg, seed=i)
        jp, jopt, jm = jstep(jp, jopt, batch, i)
        tp, topt, tm = step(tp, topt, batch, i)
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k, **TOL)
        _close(tp, jp)
        _close({"mu": topt["mu"], "nu": topt["nu"]}, {"mu": jopt["mu"], "nu": jopt["nu"]})
        assert topt["count"].dtype == torch.int32 and int(topt["count"]) == int(jopt["count"])
        if i == 0:  # carry the reference's state across for the second step
            tp = params_from_arrays(jx.jax.tree.map(np.asarray, jp), device=CPU)
            topt = opt_state_from_arrays(jx.jax.tree.map(np.asarray, jopt), device=CPU)
    assert float(tm["lr"]) == float(jm["lr"])


def test_train_loop_losses_match_jax(jx, ref_train):
    """Three steps of TrainLoop on SyntheticDataset in both packages."""
    r = ref_train(SABLE)
    jstep = _ref_step(jx, True)
    losses = []

    def rec(p, o, b, i):
        out = jstep(p, o, b, i)
        losses.append(float(out[2]["loss"]))
        return out

    cfg = r.tcfg
    jloop = jx.loop.TrainLoop(rec, jx.data.SyntheticDataset(cfg.vocab_size, 16, 2, seed=1))
    jloop.run(r.p, jx.adamw.adamw_init(r.p, jx.adamw.AdamWConfig(lr=1e-2)), 3, log_every=0)
    tp = params_from_arrays(r.p, device=CPU)
    tloop_ = tloop.TrainLoop(_port_step(True), tdata.SyntheticDataset(cfg.vocab_size, 16, 2,
                                                                      seed=1))
    tloop_.run(tp, tadamw.adamw_init(tp, tadamw.AdamWConfig(lr=1e-2)), 3, log_every=0)
    np.testing.assert_allclose(tloop_.losses, losses, **TOL)
    assert tloop_.step == jloop.step == 3 and len(tloop_.monitor.times) == 3


def test_train_loop_resume_is_bit_exact(tmp_path):
    """Four steps straight, against two steps, a new loop that restores the
    checkpoint (params, AdamW state, the data step), and two more: the same
    losses, params and state, bit for bit."""
    cfg = tl_f32()

    def fresh():
        p = ttr.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
        return p, tadamw.adamw_init(p, tadamw.AdamWConfig(lr=1e-2))

    def loop(ckpt=None):
        return tloop.TrainLoop(_port_step(True), tdata.SyntheticDataset(cfg.vocab_size, 16, 2),
                               ckpt_dir=ckpt, ckpt_every=1)

    straight = loop()
    p4, o4, _ = straight.run(*fresh(), 4, log_every=0)
    first = loop(str(tmp_path))
    first.run(*fresh(), 2, log_every=0)
    second = loop(str(tmp_path))
    p, o, resumed = second.maybe_restore(*fresh())
    assert resumed and second.step == 2 and second.dataset.step == 2
    p, o, _ = second.run(p, o, 2, log_every=0)
    assert first.losses + second.losses == straight.losses
    for (k, a), (_, b) in zip(_flat({"p": p, "o": o}), _flat({"p": p4, "o": o4})):
        assert torch.equal(a.detach(), b.detach()), k
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003", "step_00000004"]


# ---------------------------------------------------------------------- #
# optimizer and schedule
# ---------------------------------------------------------------------- #
def _opt_tree(rng, bf16_leaf):
    p = {"w": rng.standard_normal((4, 3)).astype(np.float32),
         "stack": [rng.standard_normal((2, 5)).astype(np.float32)],
         "b": rng.standard_normal((3,)).astype(np.float32)}
    return p, ({"w"} if bf16_leaf else set())


@pytest.mark.parametrize("case", ["quadratic", "clipping", "bf16_states"])
def test_adamw_matches_jax(jx, case):
    """Steps on a quadratic (gradient 2 (p - target)), the same with
    gradients scaled past clip_norm, and with bfloat16 moments and a
    bfloat16 param: params, moments, count and grad norm after each step.
    Weight decay reaches the 2-D leaves only."""
    rng = np.random.default_rng(0)
    p, bf16 = _opt_tree(rng, case == "bf16_states")
    target = {k: v * 0 + 0.5 for k, v in _flat(p)}
    scale = 100.0 if case == "clipping" else 1.0
    kw = dict(lr=0.05, state_dtype="bfloat16" if case == "bf16_states" else None)
    jcfg, tcfg = jx.adamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    jnp = jx.jnp

    def jcast(tree):
        return {k: (jnp.asarray(v, jnp.bfloat16) if k in bf16 else jnp.asarray(v))
                if not isinstance(v, list) else [jnp.asarray(x) for x in v]
                for k, v in tree.items()}

    jp = jcast(p)
    jopt = jx.adamw.adamw_init(jp, jcfg)
    tp = {k: (params_from_arrays(v, device=CPU, dtype=torch.bfloat16) if k in bf16 else
              params_from_arrays(v, device=CPU)) for k, v in p.items()}
    topt = tadamw.adamw_init(tp, tcfg)
    jupd = jx.jit(("adamw", case), lambda p, g, s: jx.adamw.adamw_update(p, g, s, jcfg))
    losses = []
    for _ in range(6):
        jg = jx.jax.tree.map(lambda v, t: scale * 2 * (v.astype(jnp.float32) - t).astype(v.dtype),
                             jp, jx.jax.tree.map(lambda v: v * 0 + 0.5, jp))
        tg = tree_map(lambda v: scale * 2 * (v.float() - 0.5).to(v.dtype), tp)
        losses.append(sum(float(((v.float() - 0.5) ** 2).sum()) for v in tree_leaves(tp)))
        jp, jopt, jm = jupd(jp, jg, jopt)
        tp, topt, tm = tadamw.adamw_update(tp, tg, topt, tcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        tol = dict(rtol=1e-2, atol=1e-2) if bf16 else dict(rtol=1e-6, atol=1e-6)
        _close(tp, jp, **tol)
        _close({"mu": topt["mu"], "nu": topt["nu"]}, {"mu": jopt["mu"], "nu": jopt["nu"]},
               **tol)
    assert int(topt["count"]) == 6 and topt["count"].dtype == torch.int32
    assert losses[-1] < losses[0]
    assert target  # the quadratic's minimum: every leaf at 0.5
    if case == "bf16_states":
        assert topt["mu"]["b"].dtype == torch.bfloat16 and tp["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("point", ["start", "warmup", "midway", "end", "past_end"])
def test_cosine_schedule_matches_jax_exactly(jx, point):
    warmup, total = 20, 100
    step = {"start": 0, "warmup": 7, "midway": (warmup + total) // 2, "end": total,
            "past_end": total + 9}[point]
    want = np.asarray(jx.schedule.cosine_schedule(step, 3e-3, warmup, total))
    got = cosine_schedule(step, 3e-3, warmup, total)
    assert got.dtype == np.float32 and got == want


# ---------------------------------------------------------------------- #
# data
# ---------------------------------------------------------------------- #
def _same_batches(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


def test_synthetic_dataset_matches_jax_with_resume_and_hosts(jx):
    for host in (0, 1):
        kw = dict(vocab_size=512, seq_len=16, batch=4, seed=3, host_id=host, num_hosts=2)
        j, t = jx.data.SyntheticDataset(**kw), tdata.SyntheticDataset(**kw)
        for jb, tb in zip([next(iter(j)) for _ in range(3)], [next(iter(t)) for _ in range(3)]):
            _same_batches(tb, jb)
        j.load_state_dict({"step": 7})
        t.load_state_dict({"step": 7})
        _same_batches(next(iter(t)), next(iter(j)))
        assert t.state_dict() == j.state_dict() == {"step": 8}


def test_file_dataset_prefetcher_and_make_dataset_match_jax(jx, tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 60000, 5000).astype(np.uint16).tofile(path)
    kw = dict(seq_len=32, batch=3, host_id=1, num_hosts=2, seed=4)
    j, t = jx.data.FileDataset(str(path), **kw), tdata.FileDataset(str(path), **kw)
    t.load_state_dict({"step": 2})
    j.load_state_dict({"step": 2})
    pf = tdata.Prefetcher(iter(t), depth=2)
    for _ in range(3):
        _same_batches(next(pf), next(iter(j)))
    pf.close()
    cfg = tconfigs.get_config("llama3-8b", reduced=True)
    shape = Shape("t", 16, 4, "train")
    from repro.configs.shapes import Shape as JShape

    jd = jx.data.make_dataset(jx.configs.get_config("llama3-8b", reduced=True),
                              JShape("t", 16, 4, "train"), num_hosts=2)
    td = tdata.make_dataset(cfg, shape, num_hosts=2)
    assert type(td).__name__ == "SyntheticDataset" and td.batch == 2
    _same_batches(next(iter(td)), next(iter(jd)))


# ---------------------------------------------------------------------- #
# checkpoints
# ---------------------------------------------------------------------- #
def _ckpt_tree(rng):
    """A tree with float32, bfloat16 and int32 leaves, dicts and a list."""
    w = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    return {"params": {"w": w, "groups": [{"ln": b}], "emb": w[:2] * 3},
            "opt": {"count": np.int32(7)}}, {"emb"}


def _port_tree(tree, bf16):
    def conv(k, v):
        t = torch.as_tensor(np.asarray(v))
        return t.to(torch.bfloat16) if k in bf16 else t

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) if isinstance(v, (dict, list)) else conv(k, v)
                    for k, v in t.items()}
        return [walk(v) for v in t]

    return walk(tree)


def test_checkpoints_cross_both_ways_with_a_bf16_leaf(jx, tmp_path):
    """A checkpoint the port writes is restored by the reference's
    restore_checkpoint, and the reverse; the manifests agree leaf for leaf
    (names, files, shapes, dtypes, raw) and the files byte for byte."""
    rng = np.random.default_rng(0)
    tree, bf16 = _ckpt_tree(rng)
    tt = _port_tree(tree, bf16)
    jt = jx.jax.tree.map(jx.jnp.asarray, tree)
    jt["params"]["emb"] = jt["params"]["emb"].astype(jx.jnp.bfloat16)
    tckpt.save_checkpoint(str(tmp_path / "t"), 3, tt, extra={"data": {"step": 3}})
    jx.ckpt.save_checkpoint(str(tmp_path / "j"), 3, jt, extra={"data": {"step": 3}})
    mt, mj = (json.load(open(tmp_path / d / "step_00000003" / "manifest.json")) for d in "tj")
    assert mt == mj
    for leaf in mt["leaves"]:
        a, b = (open(tmp_path / d / "step_00000003" / leaf["file"], "rb").read() for d in "tj")
        assert a == b, leaf["name"]
    # port -> reference
    got, step, extra = jx.ckpt.restore_checkpoint(str(tmp_path / "t"), jt)
    assert step == 3 and extra == {"data": {"step": 3}}
    assert str(got["params"]["emb"].dtype) == "bfloat16"
    _close(tt, got, rtol=0, atol=0)
    # reference -> port
    back, step, _ = tckpt.restore_checkpoint(str(tmp_path / "j"), tt)
    assert step == 3 and back["params"]["emb"].dtype == torch.bfloat16
    assert back["opt"]["count"].dtype == torch.int32 and int(back["opt"]["count"]) == 7
    for (k, a), (_, b) in zip(_flat(back), _flat(tt)):
        assert torch.equal(a, b), k


def test_checkpoint_atomicity_async_save_and_gc(tmp_path):
    """A stale tmp directory (a save that died) is no checkpoint and is
    replaced; save_async snapshots the tensors when called (later in-place
    updates are not in it) and keep_last_k drops the oldest."""
    d = str(tmp_path)
    os.makedirs(os.path.join(d, f"tmp.5.{os.getpid()}"))
    open(os.path.join(d, f"tmp.5.{os.getpid()}", "junk"), "w").close()
    assert tckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(d, {"w": torch.zeros(2)})
    m = tckpt.CheckpointManager(d, keep_last_k=2)
    w = torch.zeros(4)
    snaps = {}
    for s in range(1, 6):
        w += 1
        m.save_async(s, {"w": w})
        snaps[s] = w.clone()
        w.mul_(10)  # in place, after the call: not in step s
    m.wait()
    assert sorted(os.listdir(d)) == ["step_00000004", "step_00000005"]
    for s in (4, 5):
        got, step, _ = m.restore({"w": torch.zeros(4)}, step=s)
        assert step == s and torch.equal(got["w"], snaps[s])
    assert m.latest_step() == 5 and len(m.save_times) == 5


def test_left_out_parts_raise(tmp_path):
    """The sharding entry points refuse what they cannot shard on: mesh=
    takes a named DeviceMesh, shardings= NamedSharding leaves, and --devices
    on the card as many cards as are visible (none here)."""
    from repro_torch.launch import train as tlaunch

    with pytest.raises(TypeError, match="DeviceMesh"):
        tstep.make_train_step(tl_f32(), tadamw.AdamWConfig(), mesh=object())
    tckpt.save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(2)})
    with pytest.raises(TypeError, match="NamedSharding"):
        tckpt.restore_checkpoint(str(tmp_path), {"w": torch.zeros(2)}, shardings=object())
    with pytest.raises(RuntimeError, match="visible cards"):
        tlaunch.main(["--arch", "llama3-8b", "--reduced", "--devices", "2"])


# ---------------------------------------------------------------------- #
# the CLI
# ---------------------------------------------------------------------- #
def test_train_cli_runs_and_resumes(tmp_path, capsys):
    from repro_torch.launch import train as tlaunch

    common = ["--arch", "llama3-8b", "--sable", "--reduced", "--batch", "2", "--seq", "16",
              "--device", CPU, "--ckpt-dir", str(tmp_path), "--log-every", "1"]
    assert tlaunch.main(common + ["--steps", "2"]) == 0
    assert tlaunch.main(common + ["--steps", "2", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "final loss" in out and "resumed=True at step 2" in out and "@ step 4" in out
    assert tckpt.latest_step(str(tmp_path)) == 4
