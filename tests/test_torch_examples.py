"""PyTorch port, the examples (``examples_torch/``) against the JAX package's
API on the same numpy-seeded inputs, on the CPU at small sizes.

quickstart: the port's ``synthesize`` gives the reference's VBR field for
field, and the script's y, 3y and Y match ``repro.core.stage_spmv`` /
``stage_spmm`` (``grouped``) within 1e-5 of max|ref|. pattern_reuse: the
staging cache counts the reference shows after the same stagings, and a
second process on the same plan directory runs no benchmark. serve_blockwise:
greedy tokens equal the reference's ``ServeEngine.generate`` on the same
params (to JAX by ``.numpy()``, back by ``convert.params_from_arrays``),
prompts and source frames, in float32 compute. train_e2e: three steps'
losses equal the reference's ``make_train_step`` within 1e-5, and a run
stopped at step 150 (checkpoints every 100) and rerun ends where an
uninterrupted run does, bit for bit. Every script needs the card unless
``--device cpu`` names the CPU.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs this file beside the JAX suites

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_arrays  # noqa: E402
from repro_torch.core import cache as tcache  # noqa: E402
from repro_torch.core import vbr as tvbr  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.sparse import linear as tlin  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402
from test_torch_linear import _sealed_reference_plans  # noqa: E402,F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples_torch"
NAMES = ("quickstart", "pattern_reuse", "serve_blockwise", "train_e2e")
CPU = ["--device", "cpu"]
REL = 1e-5
# train_e2e at a small size: the flags of every train case
SMALL = ["--d-model", "64", "--layers", "2", "--seq", "16", "--batch", "2"]


def example(name):
    """The script ``examples_torch/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def rel(got, want) -> float:
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def jx():
    """The reference's modules on JAX's CPU device in full float32."""
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.configs import llama3_8b
    from repro.core import StagingOptions, stage_spmm, stage_spmv, synthesize
    from repro.core import cache, staging, vbr
    from repro.data import pipeline
    from repro.models import config, transformer
    from repro.optim import adamw, schedule
    from repro.serve import engine
    from repro.train import step

    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        yield SimpleNamespace(
            jax=jax, jnp=jax.numpy, configs=configs, llama3_8b=llama3_8b,
            StagingOptions=StagingOptions, stage_spmv=stage_spmv, stage_spmm=stage_spmm,
            synthesize=synthesize, cache=cache, staging=staging, vbr=vbr, data=pipeline,
            config=config, tr=transformer, adamw=adamw, schedule=schedule, engine=engine,
            step=step)


@pytest.fixture
def plan_dir(tmp_path, monkeypatch):
    """Both packages' plan caches in a fresh directory, empty registries."""
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    tcache.set_default_cache(None)
    tlin._STRATEGY_REGISTRY.clear()
    yield tmp_path
    tcache.set_default_cache(None)
    tlin._STRATEGY_REGISTRY.clear()


def _numpy(tree):
    return tree_map(lambda t: t.detach().numpy(), tree)


# ---------------------------------------------------------------------- #
# every script
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", NAMES)
def test_script_needs_the_card_unless_asked_for_the_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        example(name).main([])


# ---------------------------------------------------------------------- #
# quickstart
# ---------------------------------------------------------------------- #
QUICK = (2000, 2000, 20, 20, 60)  # the script's matrix: 20% zeros inside, seed 0


def test_quickstart_matrix_is_the_references(jx):
    ref = jx.synthesize(*QUICK, block_sparsity=0.2, seed=0)
    port = tvbr.synthesize(*QUICK, block_sparsity=0.2, seed=0)
    assert [f.name for f in dataclasses.fields(port)] == [f.name for f in dataclasses.fields(ref)]
    assert port.shape == ref.shape
    for f in ("rpntr", "cpntr", "bindx", "bpntrb", "bpntre", "indx", "val"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f), err_msg=f)
        assert getattr(port, f).dtype == getattr(ref, f).dtype, f
    assert tvbr.structure_hash(port) == jx.vbr.structure_hash(ref)


def test_quickstart_matches_reference(jx, capsys):
    out = example("quickstart").main(CPU)
    printed = last_json(capsys.readouterr().out)
    assert printed == {k: v for k, v in out.items() if k != "outputs"}
    assert printed["backend"] == "cuda" and printed["tripled"]
    assert printed["spmm_shape"] == [2000, 64]

    vbr = jx.synthesize(*QUICK, block_sparsity=0.2, seed=0)
    opts = jx.StagingOptions(backend="grouped")
    x = jx.jnp.asarray(np.random.default_rng(0).standard_normal(2000), jx.jnp.float32)
    X = jx.jnp.asarray(np.random.default_rng(1).standard_normal((2000, 64)), jx.jnp.float32)
    kern = jx.stage_spmv(vbr, opts)
    y = kern(jx.jnp.asarray(vbr.val), x)
    y3 = kern(jx.jnp.asarray(vbr.val * 3.0), x)
    Y = jx.stage_spmm(vbr, 64, opts)(jx.jnp.asarray(vbr.val * 3.0), X)
    got = out["outputs"]
    for key, want in (("y", y), ("y3", y3), ("Y", Y)):
        assert tuple(got[key].shape) == tuple(want.shape)
        assert rel(got[key], want) <= REL, key


# ---------------------------------------------------------------------- #
# pattern_reuse
# ---------------------------------------------------------------------- #
def test_pattern_reuse_cache_counts_and_warm_second_process(jx, plan_dir, capsys):
    out = example("pattern_reuse").main(CPU)
    assert last_json(capsys.readouterr().out)["cache"] == out["cache"]

    # the same stagings through the reference: one miss, then hits
    jx.staging.clear_cache()
    base = jx.synthesize(4000, 4000, 40, 40, 300, block_sparsity=0.2, seed=0)
    opts = jx.StagingOptions(backend="grouped")
    jx.stage_spmv(base, opts)
    rng = np.random.default_rng(1)
    for _ in range(20):
        m = jx.vbr.VBR(**{**base.__dict__})
        m.val = rng.standard_normal(base.stored_nnz).astype(np.float32)
        jx.stage_spmv(m, opts)
    want = jx.staging.cache_info()
    jx.staging.clear_cache()
    assert out["cache"] == want == {"hits": 20, "misses": 1, "size": 1}

    # cold here: the autotune measured; a second process on the same plans runs nothing
    assert out["autotune_stats"]["benchmarks"] > 0 and out["autotune_stats"]["plans_tuned"] == 1
    assert list(plan_dir.glob("plans/spmv-*-torchcpu.json"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_CACHE_DIR=str(plan_dir),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(EXAMPLES / "pattern_reuse.py"), *CPU], env=env,
                          capture_output=True, text=True, timeout=300, check=True)
    warm = last_json(proc.stdout)
    assert warm["autotune_stats"]["benchmarks"] == 0
    assert warm["autotune_stats"]["cache_hits"] == 1
    assert warm["autotune_backend"] == out["autotune_backend"]
    assert warm["cache"] == want


# ---------------------------------------------------------------------- #
# serve_blockwise
# ---------------------------------------------------------------------- #
def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32", param_dtype="float32")


@pytest.mark.parametrize("arch", ["llama3.2-3b", "seamless-m4t-large-v2", "llama3-8b-sable"])
def test_serve_blockwise_tokens_match_reference(jx, plan_dir, arch):
    """The script's generation on the script's draws (params seed 0, prompts
    seed 1, an enc-dec config's 16 frames seed 2), at B=2, P=8, 6 new tokens."""
    from repro.core import cache as jcache

    jcache.set_default_cache(None)
    jcfg = jx.llama3_8b.reduced_sable() if arch == "llama3-8b-sable" else \
        jx.configs.get_config(arch, reduced=True)
    jcfg, tcfg = _f32(jcfg), _f32(tconfigs.get_config(arch, reduced=True))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    B, P, G = 2, 8, 6
    arrays = _numpy(ttr.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu"))
    prompts = torch.randint(0, tcfg.vocab_size, (B, P), generator=torch.Generator().manual_seed(1))
    src = None
    if tcfg.is_encdec:
        src = torch.randn((B, 16, tcfg.frontend_dim), generator=torch.Generator().manual_seed(2))
    got, stats, engine = example("serve_blockwise").generate(
        tcfg, params_from_arrays(arrays, device="cpu"), prompts, G, src_embeds=src, device="cpu")
    kwargs = {} if src is None else {"src_embeds": jx.jnp.asarray(src.numpy())}
    want, _ = jx.engine.ServeEngine(jcfg, jx.jax.tree.map(jx.jnp.asarray, arrays),
                                    max_len=P + G).generate(
        jx.jnp.asarray(prompts.numpy().astype(np.int32)), G, **kwargs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats["tokens_per_s"] > 0
    assert bool(engine.patterns) == (arch == "llama3-8b-sable")


def test_serve_blockwise_cli_prints_its_numbers(plan_dir, capsys):
    out = example("serve_blockwise").main(["--arch", "llama3-8b-sable", "--batch", "2",
                                           "--prompt-len", "5", "--gen", "4", *CPU])
    printed = last_json(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(out))
    assert out["shape"] == [2, 9] and len(out["sample"]) == 4
    assert set(out["sparse_plans"].values()) == {"grouped"}  # the CPU's one candidate


# ---------------------------------------------------------------------- #
# train_e2e
# ---------------------------------------------------------------------- #
def _ref_losses(jx, tr, args, steps):
    """The reference's make_train_step on the script's config, params and
    data, jitted, for ``steps`` steps."""
    c = jx.config
    jcfg = c.ModelConfig(
        name="e2e", family="dense", d_model=args.d_model, n_heads=max(args.d_model // 64, 1),
        n_kv_heads=max(args.d_model // 128, 1), head_dim=64, d_ff=args.d_ff,
        vocab_size=args.vocab, groups=c.uniform_groups(args.layers, c.LayerSpec()),
        compute_dtype="float32",
        sable=c.SableConfig(block_m=64, block_n=64, density=0.4) if args.sable else None)
    tcfg = tr.make_config(args)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    p = jx.jax.tree.map(jx.jnp.asarray, _numpy(tr.init(tcfg, torch.device("cpu"))))
    oc = jx.adamw.AdamWConfig(lr=args.lr)
    opt = jx.adamw.adamw_init(p, oc)
    step = jx.jax.jit(jx.step.make_train_step(
        jcfg, oc, schedule=lambda s: jx.schedule.cosine_schedule(s, args.lr, 20, args.steps)))
    losses = []
    for i, batch in zip(range(steps), jx.data.SyntheticDataset(jcfg.vocab_size, args.seq,
                                                               args.batch, seed=0)):
        p, opt, metrics = step(p, opt, batch, jx.jnp.int32(i))
        losses.append(float(metrics["loss"]))
    return losses


@pytest.mark.parametrize("sable", [False, True], ids=["dense", "sable"])
def test_train_e2e_losses_match_reference(jx, plan_dir, capsys, sable):
    from repro.core import cache as jcache

    jcache.set_default_cache(None)
    tr = example("train_e2e")
    argv = [*SMALL, "--steps", "3", *CPU] + (["--sable"] if sable else [])
    out = tr.main(argv)
    assert last_json(capsys.readouterr().out) == json.loads(json.dumps(out))
    assert out["step"] == 3 and len(out["losses"]) == 3 and out["sable"] == sable
    want = _ref_losses(jx, tr, tr.parse(argv), 3)
    np.testing.assert_allclose(out["losses"], want, rtol=REL, atol=0)


def test_train_e2e_resume_repeats_an_uninterrupted_run(tmp_path, plan_dir):
    """Stopped at step 150 (a checkpoint at 100, none at the stop), the same
    command resumes at 100 and ends at 250 with an uninterrupted run's
    losses, bit for bit on the CPU."""
    tr = example("train_e2e")
    argv = [*SMALL, "--d-ff", "256", "--vocab", "512", "--steps", "250", "--sable", *CPU]
    whole = tr.main([*argv, "--ckpt", str(tmp_path / "whole")])
    stopped = tr.main([*argv, "--ckpt", str(tmp_path / "cut"), "--stop-at", "150"])
    assert stopped["stopped"] and stopped["step"] == 150
    assert sorted(p.name for p in (tmp_path / "cut").iterdir()) == ["step_00000100"]
    resumed = tr.main([*argv, "--ckpt", str(tmp_path / "cut")])
    assert resumed["resumed_from"] == 100 and resumed["step"] == 250 and not resumed["stopped"]
    assert resumed["losses"] == whole["losses"][100:]
    assert stopped["losses"] == whole["losses"][:150]
    again = tr.main([*argv, "--ckpt", str(tmp_path / "cut")])  # finished: nothing to train
    assert again["resumed_from"] == 250 and again["losses"] == [] and again["loss"] is None
