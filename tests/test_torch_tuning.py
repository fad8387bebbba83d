"""PyTorch port, the tuning layer: the plan cache, the autotuner and the cost
model against the JAX package on the same numpy inputs. Plans, keys, cost
model features and predictions, worker splits and format decisions are held
exactly; the tuned winner's products at rtol = atol = 2e-4 in float32.

The two packages share the cache layout and never each other's plans: the
port writes the device segment ``cuda`` or ``torchcpu``, the JAX package
``jax.default_backend()``."""
import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs this file beside the JAX suites

from repro_torch.convert import vbr_from_arrays  # noqa: E402
from repro_torch.core import autotune as tautotune  # noqa: E402
from repro_torch.core import cache as tcache  # noqa: E402
from repro_torch.core import cost_model as tcm  # noqa: E402
from repro_torch.core import reblock as treblock  # noqa: E402
from repro_torch.core import staging as tstaging  # noqa: E402
from repro_torch.core import vbr as tvbr  # noqa: E402
from repro_torch.core.staging import StagingOptions, stage_spmm, stage_spmv  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "fixtures"
TOL = 2e-4
CPU = "cpu"
requires_cuda = pytest.mark.requires_cuda


@pytest.fixture(autouse=True)
def _card(request):
    """Tests marked requires_cuda skip without a card: decided here, when the
    test runs, so that every worker collects the same tests."""
    if request.node.get_closest_marker("requires_cuda") and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the kernels")


@pytest.fixture(autouse=True)
def _fresh():
    tstaging.clear_cache()
    tautotune.reset_autotune_stats()
    tcm.reset_cost_model_stats()
    tautotune.reset_structure_trackers()
    yield
    tstaging.clear_cache()
    tcache.set_default_cache(None)


@pytest.fixture(scope="module")
def jx():
    """The reference, on JAX's CPU device in full float32."""
    jax = pytest.importorskip("jax")
    from repro.core import autotune, cache, cost_model, staging, vbr

    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        yield SimpleNamespace(jnp=jax.numpy, autotune=autotune, cache=cache,
                              cost_model=cost_model, staging=staging, vbr=vbr)


def _ref(jx, v):
    return jx.vbr.VBR(**dataclasses.asdict(v))


def _mk(seed=0, rows=48, cols=40, rs=5, cs=4, nb=10, sp=0.3, uniform=False):
    return tvbr.synthesize(rows, cols, rs, cs, nb, sp, uniform, seed=seed)


def _fixture(name):
    with np.load(FIXTURES / f"{name}.npz") as d:
        f = {k: d[k] for k in d.files}
    v = vbr_from_arrays(*(f[k] for k in ("shape", "rpntr", "cpntr", "bindx", "bpntrb",
                                         "bpntre", "indx", "val")))
    return v, f


def _banded(n=48, bw=3, step=2, seed=0):
    rng = np.random.default_rng(seed)
    dense = np.zeros((n, n), np.float32)
    for i in range(n):
        lo, hi = max(0, i - bw), min(n, i + bw + 1)
        dense[i, lo:hi] = rng.standard_normal(hi - lo)
    splits = list(range(0, n + 1, step))
    return tvbr.from_dense(dense, splits, splits)


# ---------------------------------------------------------------------- #
# the plan cache
# ---------------------------------------------------------------------- #
def test_device_keys_are_not_jax_backend_names():
    assert tcache.device_key(torch.device("cuda")) == "cuda"
    assert tcache.device_key(CPU) == "torchcpu"
    assert {"cuda", "torchcpu"}.isdisjoint({"cpu", "gpu", "tpu"})


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(n_cols=128),
    dict(n_cols=8, shard_id=3, num_shards=8),
    dict(num_shards=4),
    dict(n_cols=16, shard_id=0, num_shards=2, model_cols=4),
    dict(reblock=True),
    dict(n_cols=6, reblock=True),
])
@pytest.mark.parametrize("kind", ["spmv", "spmm"])
def test_plan_key_matches_reference(jx, kind, kwargs):
    for device in ("torchcpu", "cuda"):
        key = tcache.plan_key(kind, "0123456789abcdef", device, **kwargs)
        assert key == jx.cache.plan_key(kind, "0123456789abcdef", device, **kwargs)


def _json_keys(d, prefix=""):
    keys = set()
    for k, v in d.items():
        keys.add(prefix + k)
        if isinstance(v, dict) and k in ("options", "reblock"):
            keys |= _json_keys(v, prefix + k + ".")
    return keys


def test_plan_roundtrip_and_schema_match_reference(jx, tmp_path):
    v = _banded()
    spec = treblock.propose_reblockings(v, device=CPU)[0]
    plan = tcache.TuningPlan(
        kind="spmm", structure_hash=tvbr.structure_hash(v),
        options=StagingOptions(backend="cuda", tile=(16, 64), dtype=torch.bfloat16),
        n_cols=6, device="cuda", timings={"cuda[16x64]": 1e-4, "grouped": 2e-4},
        num_workers=2, meta={"shape": [48, 48]}, source="measured", reblock=spec.to_dict(),
    )
    cache = tcache.PlanCache(str(tmp_path / "port"))
    key = tcache.plan_key("spmm", plan.structure_hash, "cuda", 6, reblock=True)
    path = cache.store_plan(key, plan)
    back = cache.load_plan(key)
    assert back == plan and back.options.dtype is torch.bfloat16
    doc = json.loads(Path(path).read_text())
    assert doc["options"]["dtype"] == "bfloat16" and doc["options"]["interpret"] is None
    # the reference writes the same keys, field for field
    jplan = jx.cache.TuningPlan(
        kind="spmm", structure_hash=plan.structure_hash,
        options=jx.staging.StagingOptions(backend="pallas", dtype=np.float32),
        n_cols=6, device="cpu", timings={"grouped": 1.0}, reblock=spec.to_dict(),
    )
    jpath = jx.cache.PlanCache(str(tmp_path / "jax")).store_plan("k", jplan)
    assert _json_keys(doc) == _json_keys(json.loads(Path(jpath).read_text()))
    assert tcache.TuningPlan.from_dict(doc).to_dict() == doc


def test_structure_cache_roundtrip_is_shared_with_reference(jx, tmp_path):
    v = _mk(seed=3)
    path = tcache.PlanCache(str(tmp_path)).store_structure(v)
    h = tvbr.structure_hash(v)
    back = tcache.PlanCache(str(tmp_path)).load_structure(h, val=v.val)
    jback = jx.cache.PlanCache(str(tmp_path)).load_structure(h, val=v.val)
    assert Path(path).name == f"{h}.npz"
    assert tvbr.structure_hash(back) == jx.vbr.structure_hash(jback) == h


def test_plans_never_cross_packages(jx, tmp_path):
    """A plan the reference wrote is not loaded by the port, and the reverse,
    in one cache directory; each package reads its own plan back warm."""
    v = _mk(seed=4)
    cache_dir = str(tmp_path)
    jplan = jx.autotune.autotune(_ref(jx, v), "spmv", cache=jx.cache.PlanCache(cache_dir),
                                 warmup=0, iters=1)
    assert jplan.device == "cpu"
    jx.autotune.reset_autotune_stats()
    plan = tautotune.autotune(v, "spmv", device=CPU, cache=tcache.PlanCache(cache_dir),
                              warmup=0, iters=1)
    st = tautotune.autotune_stats()
    assert (st["cache_hits"], st["cache_misses"]) == (0, 1) and st["benchmarks"] > 0
    assert plan.device == "torchcpu" and plan.source == "measured"
    # the candidate labels on the CPU are the reference's
    assert sorted(plan.timings) == sorted(jplan.timings)
    names = sorted(p.name for p in (tmp_path / "plans").iterdir())
    h = tvbr.structure_hash(v)
    assert names == [f"spmv-{h}-cpu.json", f"spmv-{h}-torchcpu.json"]
    # each reads its own back, warm
    jx.autotune.autotune(_ref(jx, v), "spmv", cache=jx.cache.PlanCache(cache_dir))
    assert jx.autotune.autotune_stats()["cache_hits"] == 1
    assert jx.autotune.autotune_stats()["benchmarks"] == 0
    tautotune.autotune(v, "spmv", device=CPU, cache=tcache.PlanCache(cache_dir))
    assert tautotune.autotune_stats()["cache_hits"] == 1
    # and neither cost model's corpus holds the other's plan
    assert [p.device for p in tcache.PlanCache(cache_dir).iter_plans(device="torchcpu")] == [
        "torchcpu"]
    assert [p.device for p in jx.cache.PlanCache(cache_dir).iter_plans(device="cpu")] == ["cpu"]


# ---------------------------------------------------------------------- #
# the autotuner
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("case", ["small", "many_blocks", "dense_blocks"])
def test_candidate_labels_on_the_cpu_match_reference(jx, case):
    v = {"small": _mk(seed=1), "many_blocks": _mk(seed=2, rows=256, cols=256, rs=20, cs=20,
                                                  nb=200),
         "dense_blocks": _mk(seed=5, sp=0.0)}[case]
    for gather in (False, True):
        got = [lbl for lbl, _ in tautotune.candidate_options(v, device=CPU,
                                                             include_gather=gather)]
        want = [lbl for lbl, _ in jx.autotune.candidate_options(_ref(jx, v), device="cpu",
                                                                include_gather=gather)]
        assert got == want


def test_candidates_on_the_card_sweep_every_cuda_tile():
    v = _mk(seed=1)
    cands = dict(tautotune.candidate_options(v, device="cuda"))
    for tm, tk in tautotune.CUDA_TILES:
        assert cands[f"cuda[{tm}x{tk}]"] == StagingOptions(backend="cuda", tile=(tm, tk))
    assert (32, 32) in tautotune.CUDA_TILES and tuple(StagingOptions().tile) == (32, 32)
    assert not any(lbl.startswith("pallas") for lbl in cands)


def test_autotune_cold_then_warm_and_winner_matches_reference(jx, tmp_path):
    v, f = _fixture("random_block")
    n = f["X"].shape[1]
    tcache.set_default_cache(tcache.PlanCache(str(tmp_path)))
    ks = stage_spmv(v, StagingOptions(backend="autotune"), device=CPU)
    km = stage_spmm(v, n, StagingOptions(backend="autotune"), device=CPU)
    n_cands = len(tautotune.candidate_options(v, device=CPU))
    st = tautotune.autotune_stats()
    assert st["benchmarks"] == 2 * n_cands and st["plans_tuned"] == 2
    jo = jx.staging.StagingOptions(backend="grouped")
    jv = _ref(jx, v)
    want = jx.staging.StagedKernel("spmv", jv, jo)(jx.jnp.asarray(f["val"]), jx.jnp.asarray(f["x"]))
    want_m = jx.staging.StagedKernel("spmm", jv, jo, n_cols=n)(jx.jnp.asarray(f["val"]),
                                                               jx.jnp.asarray(f["X"]))
    np.testing.assert_allclose(ks(f["val"], f["x"]).numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(km(f["val"], f["X"]).numpy(), np.asarray(want_m), rtol=TOL,
                               atol=TOL)
    # a restart: in-memory caches gone, a new PlanCache over the same files
    tstaging.clear_cache()
    tautotune.reset_autotune_stats()
    tcache.set_default_cache(tcache.PlanCache(str(tmp_path)))
    ks2 = stage_spmv(v, StagingOptions(backend="autotune"), device=CPU)
    km2 = stage_spmm(v, n, StagingOptions(backend="autotune"), device=CPU)
    st = tautotune.autotune_stats()
    assert st["benchmarks"] == 0 and st["cache_hits"] == 2 and st["plans_tuned"] == 0
    assert (ks2.opts, km2.opts) == (ks.opts, km.opts)
    np.testing.assert_allclose(km2(f["val"], f["X"]).numpy(), np.asarray(want_m), rtol=TOL,
                               atol=TOL)


def test_extended_space_warm_restart_reruns_no_dp(jx, tmp_path):
    v = _banded()
    cache = tcache.PlanCache(str(tmp_path))
    plan = tautotune.autotune(v, "spmv", device=CPU, cache=cache, include_reblock=True,
                              warmup=0, iters=1)
    jplan = jx.autotune.autotune(_ref(jx, v), "spmv", cache=jx.cache.PlanCache(str(tmp_path)),
                                 include_reblock=True, warmup=0, iters=1)
    assert sorted(plan.timings) == sorted(jplan.timings)
    assert "dia_hybrid" in plan.timings and any(k.startswith("reblock[") for k in plan.timings)
    assert plan.meta["dia_offsets"] == jplan.meta["dia_offsets"]
    assert (tmp_path / "plans" / f"spmv-{tvbr.structure_hash(v)}-torchcpu-rb.json").exists()
    tstaging.clear_cache()
    tautotune.reset_autotune_stats()
    treblock.reset_reblock_stats()
    k = tautotune.autotune_stage(v, "spmv", cache=tcache.PlanCache(str(tmp_path)),
                                 include_reblock=True, device=CPU)
    assert tautotune.autotune_stats()["benchmarks"] == 0
    assert treblock.reblock_stats()["dp_runs"] == 0
    assert k.backend == plan.options.backend
    assert isinstance(k, treblock.ReblockedKernel) == (plan.reblock is not None)
    x = np.random.default_rng(0).standard_normal(v.shape[1]).astype(np.float32)
    np.testing.assert_allclose(k(v.val, x).numpy(), v.to_dense() @ x, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("strategy", ["dp", "dia_hybrid"])
def test_a_tuned_plan_that_pins_a_reblocking_or_diagonals_stages_it(tmp_path, monkeypatch,
                                                                    strategy):
    """Whatever wins is staged from the plan; the timings are forced here."""
    v = _banded()
    want = "reblock[dp]+grouped" if strategy == "dp" else "dia_hybrid"
    monkeypatch.setattr(tautotune, "measure",
                        lambda kern, *a, **k: 1e-6 if _label_of(kern) == want else 1.0)
    plan = tautotune.autotune(v, "spmv", device=CPU, cache=tcache.PlanCache(str(tmp_path)),
                              include_reblock=True)
    assert min(plan.timings, key=plan.timings.get) == want
    k = tautotune.autotune_stage(v, "spmv", cache=tcache.PlanCache(str(tmp_path)),
                                 include_reblock=True, device=CPU)
    if strategy == "dp":
        assert isinstance(k, treblock.ReblockedKernel) and plan.reblock["strategy"] == "dp"
    else:
        assert k.backend == "dia_hybrid" and list(k.offsets) == plan.meta["dia_offsets"]
    x = np.random.default_rng(0).standard_normal(v.shape[1]).astype(np.float32)
    np.testing.assert_allclose(k(v.val, x).numpy(), v.to_dense() @ x, rtol=TOL, atol=TOL)


def _label_of(kern):
    if isinstance(kern, treblock.ReblockedKernel):
        return f"reblock[{kern.spec.strategy}]+{kern.backend}"
    return kern.backend


def test_a_candidate_refusing_the_structure_drops_out(tmp_path, monkeypatch):
    v = _mk(seed=2)
    real = tstaging._cached

    def cached(kind, vbr, opts, *a, **k):
        if opts.backend == "bucketed":
            raise ValueError("refuses this structure")
        return real(kind, vbr, opts, *a, **k)

    monkeypatch.setattr(tstaging, "_cached", cached)
    plan = tautotune.autotune(v, "spmv", device=CPU, cache=tcache.PlanCache(str(tmp_path)),
                              warmup=0, iters=1)
    assert "bucketed" not in plan.timings and "grouped" in plan.timings


def test_a_kernel_that_fails_to_launch_fails_the_tune(tmp_path, monkeypatch):
    v = _mk(seed=2)
    real = tstaging._cached

    def cached(kind, vbr, opts, *a, **k):
        kern = real(kind, vbr, opts, *a, **k)
        if opts.backend != "bucketed":
            return kern

        def launch(val, x):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

        return launch

    monkeypatch.setattr(tstaging, "_cached", cached)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tautotune.autotune(v, "spmv", device=CPU, cache=tcache.PlanCache(str(tmp_path)),
                           warmup=0, iters=1)
    assert not (tmp_path / "plans").exists()


def test_autotune_stage_carries_dtype_and_refuses_prepack(tmp_path):
    v = _mk(seed=5)
    cache = tcache.PlanCache(str(tmp_path))
    k = tautotune.autotune_stage(v, "spmv", cache=cache, device=CPU, warmup=0, iters=1,
                                 base_opts=StagingOptions(dtype=torch.bfloat16))
    assert k.opts.dtype is torch.bfloat16
    assert k(v.val, np.ones(v.shape[1], np.float32)).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="prepack"):
        stage_spmv(v, StagingOptions(backend="autotune", prepack=True), device=CPU)
    with pytest.raises(ValueError, match="unknown kind"):
        tautotune.autotune(v, "spmx", device=CPU, cache=cache)


@pytest.mark.parametrize("seed", [0, 3])
def test_tune_num_workers_and_structure_meta_match_reference(jx, seed):
    v = _mk(seed=seed, rows=200, cols=200, rs=20, cs=10, nb=80)
    assert tautotune.tune_num_workers(v) == jx.autotune.tune_num_workers(_ref(jx, v))
    assert tautotune._structure_meta(v) == jx.autotune._structure_meta(_ref(jx, v))


def test_choose_format_matches_reference(jx):
    rng = np.random.default_rng(0)
    stream = [f"{h:016x}" for h in rng.integers(0, 3, 40)] + ["a" * 16] * 20
    jx.autotune.reset_structure_trackers()
    got = [tautotune.choose_format("moe", h) for h in stream]
    want = [jx.autotune.choose_format("moe", h) for h in stream]
    assert got == want and {"staged", "fixed_block"} <= set(got)
    jx.autotune.reset_structure_trackers()


# ---------------------------------------------------------------------- #
# the cost model
# ---------------------------------------------------------------------- #
_WEIGHTS = {  # planted log-linear timings: (bias, on log_nnz, on log_blocks)
    "grouped": (-12.0, 0.9, 0.0),
    "bucketed": (-10.0, 0.8, 0.35),
    "grouped+hybrid0.5": (-8.0, 0.85, 0.1),
}


def _family(count, seed0=0):
    rng = np.random.default_rng(1)
    return [tvbr.synthesize(400, 400, 10, 10, int(rng.integers(10, 60)), 0.3, False,
                            seed=seed0 + s) for s in range(count)]


def _seed_corpus(pkg, cache, vbrs, device, opts):
    """Measured plans with planted timings, written by one package (``pkg``:
    its cache, cost_model and autotune modules)."""
    for v in vbrs:
        meta = pkg.autotune._structure_meta(v)
        feats = pkg.cost_model.meta_features("spmv", meta)
        h = tvbr.structure_hash(v)
        timings = {lbl: float(np.exp(b + c1 * feats[2] + c2 * feats[3]))
                   for lbl, (b, c1, c2) in _WEIGHTS.items()}
        cache.store_plan(pkg.cache.plan_key("spmv", h, device), pkg.cache.TuningPlan(
            kind="spmv", structure_hash=h, options=opts, device=device, timings=timings,
            meta=meta, source="measured"))


PORT = SimpleNamespace(cache=tcache, cost_model=tcm, autotune=tautotune)


def test_cost_model_fit_and_predictions_match_reference(jx, tmp_path):
    vbrs = _family(10)
    cache = tcache.PlanCache(str(tmp_path / "port"))
    jcache = jx.cache.PlanCache(str(tmp_path / "jax"))
    _seed_corpus(PORT, cache, vbrs, "torchcpu", StagingOptions(backend="grouped"))
    _seed_corpus(jx, jcache, [_ref(jx, v) for v in vbrs], "cpu",
                 jx.staging.StagingOptions(backend="grouped"))
    model = tcm.load_or_fit(cache, "torchcpu", "spmv")
    jmodel = jx.cost_model.load_or_fit(jcache, "cpu", "spmv")
    for k in ("mu", "sigma", "train_x", "n_train", "label_counts", "feature_names"):
        assert model.to_dict()[k] == jmodel.to_dict()[k], k
    for lbl, w in model.weights.items():
        np.testing.assert_array_equal(w, jmodel.weights[lbl])
    assert (tmp_path / "port" / "models" / "cost-spmv-torchcpu-v2.json").exists()
    new = _family(1, seed0=50)[0]
    feats = tcm.vbr_features(new)
    np.testing.assert_array_equal(feats, jx.cost_model.vbr_features(_ref(jx, new)))
    labels = list(_WEIGHTS)
    assert model.predict(feats, labels) == jmodel.predict(feats, labels)
    assert model.confident(feats, labels) == jmodel.confident(feats, labels)


def test_predict_mode_stages_with_zero_benchmarks(tmp_path):
    cache = tcache.PlanCache(str(tmp_path))
    _seed_corpus(PORT, cache, _family(tcm.MIN_CORPUS), "torchcpu",
                 StagingOptions(backend="grouped"))
    new = _family(1, seed0=50)[0]
    plan = tautotune.autotune(new, "spmv", device=CPU, cache=cache, mode="predict",
                              max_unrolled_blocks=0)
    st = tautotune.autotune_stats()
    assert st["plans_predicted"] == 1 and st["benchmarks"] == 0
    assert plan.source == "predicted" and plan.device == "torchcpu"
    assert plan.options.backend == min(plan.timings, key=plan.timings.get) == "grouped"
    assert (tmp_path / "models" / "cost-spmv-torchcpu-v2.json").exists()
    # the predicted plan stages without a measurement
    k = tautotune.autotune_stage(new, "spmv", cache=cache, mode="predict",
                                 max_unrolled_blocks=0, device=CPU)
    x = np.random.default_rng(0).standard_normal(new.shape[1]).astype(np.float32)
    np.testing.assert_allclose(k(new.val, x).numpy(), new.to_dense() @ x, rtol=TOL, atol=TOL)
    assert tautotune.autotune_stats()["benchmarks"] == 0
    # a structure far outside the corpus is measured instead
    big = tvbr.synthesize(2000, 2000, 40, 40, 900, 0.05, True, seed=7)
    plan = tautotune.autotune(big, "spmv", device=CPU, cache=cache, mode="predict",
                              warmup=0, iters=1)
    assert plan.source == "measured" and tautotune.autotune_stats()["predict_fallbacks"] == 1


# ---------------------------------------------------------------------- #
# on the card
# ---------------------------------------------------------------------- #
@requires_cuda
def test_cuda_candidates_list_every_tile_on_the_card():
    labels = [lbl for lbl, _ in tautotune.candidate_options(_mk(seed=1))]
    assert [lbl for lbl in labels if lbl.startswith("cuda[")] == [
        f"cuda[{tm}x{tk}]" for tm, tk in tautotune.CUDA_TILES]


@requires_cuda
def test_cuda_tune_launches_k1_and_k2_and_keys_the_plan_cuda(tmp_path):
    from repro_torch.kernels import ops as tops

    v, f = _fixture("random_block")
    cache = tcache.PlanCache(str(tmp_path))
    tops.reset_launches()
    plan = tautotune.autotune(v, "spmv", cache=cache, warmup=0, iters=1)
    plan_m = tautotune.autotune(v, "spmm", 6, cache=cache, warmup=0, iters=1)
    assert plan.device == plan_m.device == "cuda"
    assert tops.launches["bsr_spmv"] >= len(tautotune.CUDA_TILES)
    assert tops.launches["bsr_spmm"] >= len(tautotune.CUDA_TILES)
    for p in (plan, plan_m):
        assert {f"cuda[{tm}x{tk}]" for tm, tk in tautotune.CUDA_TILES} <= set(p.timings)
    km = tautotune.autotune_stage(v, "spmm", 6, cache=cache)
    np.testing.assert_allclose(km(f["val"], f["X"]).cpu().numpy(), f["y_spmm"], rtol=TOL,
                               atol=TOL)
