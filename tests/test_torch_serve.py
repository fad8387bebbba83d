"""PyTorch port, single-batch serving: ``repro_torch.serve.ServeEngine`` and
the ``repro_torch.launch.serve`` CLI against the JAX package's.

``generate``'s greedy tokens must equal the reference's on the same params
(carried across with ``convert.params_from_arrays``) and prompts, in float32
compute. The plan warmup is restart-aware, as the reference's
(tests/test_serve.py): a second engine on the same plan cache stages
nothing.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs this file beside the JAX suites

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_arrays  # noqa: E402
from repro_torch.core import autotune as tautotune  # noqa: E402
from repro_torch.core import cache as tcache  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.sparse import linear as tlin  # noqa: E402
from test_torch_linear import _sealed_reference_plans  # noqa: E402,F401 (autouse)

CPU = "cpu"


@pytest.fixture(autouse=True)
def _card(request):
    """Tests marked requires_cuda skip without a card: decided here, when the
    test runs, so that every worker collects the same tests."""
    if request.node.get_closest_marker("requires_cuda") and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the kernels")


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.configs import llama3_8b
    from repro.models import transformer
    from repro.serve import engine

    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        yield SimpleNamespace(jax=jax, configs=configs, llama3_8b=llama3_8b, tr=transformer,
                              engine=engine)


@pytest.fixture
def plan_dir(tmp_path, monkeypatch):
    """Both packages' plan caches in a fresh directory, empty registries."""
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    tcache.set_default_cache(None)
    tlin._STRATEGY_REGISTRY.clear()
    yield tmp_path
    tcache.set_default_cache(None)
    tlin._STRATEGY_REGISTRY.clear()


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32", param_dtype="float32")


@pytest.mark.parametrize("arch", ["llama3-8b-sable", "llama3.2-3b"])
def test_generate_greedy_tokens_match_jax(jx, plan_dir, arch):
    """Greedy decoding: the reference's tokens, exactly."""
    from repro.core import cache as jcache

    jcache.set_default_cache(None)
    if arch == "llama3-8b-sable":
        jcfg = jx.llama3_8b.reduced_sable()
    else:
        jcfg = jx.configs.get_config(arch, reduced=True)
    jcfg = _f32(jcfg)
    tcfg = _f32(tconfigs.get_config(arch, reduced=True))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    p = jx.tr.init_params(jcfg, jx.jax.random.PRNGKey(0))
    prompts = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    want, _ = jx.engine.ServeEngine(jcfg, p, max_len=16).generate(
        jx.jax.numpy.asarray(prompts), 8)
    eng = tengine.ServeEngine(tcfg, params_from_arrays(jx.jax.tree.map(np.asarray, p),
                                                       device=CPU), max_len=16, device=CPU)
    got, stats = eng.generate(prompts, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(stats) == {"prefill_s", "decode_s", "tokens_per_s"}
    assert eng.sparse_plans == ({tlin.pattern_hash(q): "grouped" for q in eng.patterns}
                                if "sable" in arch else {})


def test_warm_restart_stages_no_plans(plan_dir):
    """A second engine on the same plan cache loads every plan and stages
    none (tests/test_serve.py's contract), in a process whose registry was
    emptied as a restart's is; dense params skip the warmup."""
    cfg = _f32(tconfigs.get_config("llama3-8b-sable", reduced=True))
    params = ttr.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    eng1 = tengine.ServeEngine(cfg, params, max_len=16, device=CPU)
    assert eng1.warmup_stats == {"warm_start": False, "plans_staged": 2, "plans_predicted": 0}
    keys = [tcache.plan_key("linear", tlin.pattern_hash(p), "torchcpu") for p in eng1.patterns]
    assert all(tcache.default_cache().has_plan(k) for k in keys)
    tlin._STRATEGY_REGISTRY.clear()
    tautotune.reset_autotune_stats()
    eng2 = tengine.ServeEngine(cfg, params, max_len=16, device=CPU)
    assert eng2.warmup_stats["warm_start"] is True
    assert eng2.warmup_stats["plans_staged"] == 0
    assert tautotune.autotune_stats()["benchmarks"] == 0
    assert eng2.sparse_plans == eng1.sparse_plans
    dense = ttr.init_params(dataclasses.replace(cfg, sable=None),
                            torch.Generator().manual_seed(0), device=CPU)
    eng3 = tengine.ServeEngine(cfg, dense, max_len=16, device=CPU)
    assert eng3.patterns == () and eng3.warmup_stats == {"warm_start": True, "plans_staged": 0}
    out, _ = eng3.generate(torch.zeros((1, 3), dtype=torch.long), 2, temperature=0.7)
    assert out.shape == (1, 5) and int(out.max()) < cfg.vocab_size


def test_cli_generates_on_cpu(plan_dir, capsys, monkeypatch):
    """The CLI serves on the CPU when asked, with its params stored in the
    config's compute dtype."""
    engines = []

    class Engine(tengine.ServeEngine):
        def __init__(self, cfg, params, **kw):
            engines.append((cfg, params))
            super().__init__(cfg, params, **kw)

    monkeypatch.setattr(tengine, "ServeEngine", Engine)
    out, stats = tlaunch.main(["--arch", "llama3-8b-sable", "--reduced", "--device", "cpu",
                               "--batch", "2", "--prompt-len", "5", "--gen", "4"])
    assert tuple(out.shape) == (2, 9) and out.device.type == "cpu"
    (cfg, params), = engines
    assert cfg.param_dtype == cfg.compute_dtype == "bfloat16"
    assert params["embed"].dtype == torch.bfloat16
    text = capsys.readouterr().out
    assert "generated (2, 9) on cpu" in text and "staged 2 sparse plans" in text


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "llama4-scout-17b-a16e"])
def test_cli_generates_moe_models_on_cpu(plan_dir, capsys, arch):
    """The MoE configs (MLA for DeepSeek-V2) serve through the CLI on the
    CPU: no SABLE pattern, so the warmup stages nothing, and the params are
    stored in the compute dtype."""
    out, stats = tlaunch.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                               "--prompt-len", "5", "--gen", "3"])
    assert tuple(out.shape) == (2, 8) and out.device.type == "cpu"
    assert int(out.min()) >= 0 and int(out.max()) < tconfigs.get_config(arch, True).vocab_size
    text = capsys.readouterr().out
    assert "generated (2, 8) on cpu" in text and "staged" not in text


def test_cli_and_engine_refuse_what_is_left_out(plan_dir, monkeypatch):
    """Without --device the CLI wants the card and raises without one, with
    --continuous too; sharding (the engine's and the scheduler's mesh=)
    raises until its slice. A decoder-only engine ignores src_embeds=, as
    the reference's does (enc-dec serving: tests/test_torch_encdec.py)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tlaunch.main(["--arch", "llama3-8b-sable", "--reduced"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        tlaunch.main(["--arch", "llama3-8b", "--reduced", "--continuous"])
    cfg = _f32(tconfigs.get_config("llama3.2-3b", reduced=True))
    params = ttr.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    eng = tengine.ServeEngine(cfg, params, max_len=8, device=CPU)
    assert eng.serve([])[0] == {}
    with pytest.raises(TypeError, match="DeviceMesh"):
        eng.make_scheduler(mesh=object())
    prompt = torch.zeros((1, 2), dtype=torch.long)
    with_src, _ = eng.generate(prompt, 2, src_embeds=np.zeros((1, 2, 4)))
    assert torch.equal(with_src, eng.generate(prompt, 2)[0])
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(torch.zeros((1, 6), dtype=torch.long), 4)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tengine.ServeEngine(cfg, params, max_len=8, mesh=object(), device=CPU)
    with pytest.raises(ValueError, match="tune_mode"):
        tengine.ServeEngine(cfg, params, max_len=8, tune_mode="guess", device=CPU)
