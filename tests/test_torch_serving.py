"""The port's planning, weight pool, serving engine and CLI against the JAX
package's, on the CPU at a small size with a fixed HWSpec: plans are equal
as JSON (but for the solver's wall time), the pool's ledger follows the
same op sequence identically, and the engine makes the same plans, hits,
misses and peaks, with results that agree within atol = rtol = 1e-4."""
import json
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.gptneo import GPTNEO_S as JAX_GPTNEO_S
from repro.core.capacity import HWSpec as JaxHWSpec
from repro.core.graph import build_lm_graph as jax_build
from repro.core.plan import plan_multi_model as jax_plan_multi_model
from repro.core.streaming import HostModel as JaxHostModel
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.weight_cache import WeightCache as JaxWeightCache
from repro_torch.configs import get_arch
from repro_torch.configs.gptneo import GPTNEO_S
from repro_torch.core.allocator import ReservationSpec
from repro_torch.core.capacity import HWSpec
from repro_torch.core.graph import build_lm_graph
from repro_torch.core.plan import plan_multi_model
from repro_torch.core.streaming import HostModel, PreloadExecutor
from repro_torch.launch import serve
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.weight_cache import WeightCache

SHAPE = dict(num_layers=4, d_model=256, n_heads=4, n_kv_heads=4, d_ff=1024,
             vocab=1024, name="gptneo-tiny")
CFG = replace(GPTNEO_S, **SHAPE)
JAX_CFG = replace(JAX_GPTNEO_S, **SHAPE)
SEQ = 64
HW = dict(peak_flops=5e10, hbm_bw=2e10, stream_bw=1e10)
TOL = dict(atol=1e-4, rtol=1e-4)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _plan(mm) -> dict:
    """A MultiModelPlan's JSON without the solver's wall time."""
    d = json.loads(mm.to_json())
    for p in d["plans"].values():
        p.get("meta", {}).pop("solve_s", None)
    return d


# --- planning ---------------------------------------------------------------

@pytest.mark.parametrize("case", ["uniform", "mix", "reserves", "full_size"])
def test_plan_multi_model_json_equal(case):
    if case == "full_size":
        names = ("gptneo-1.3b", "gptneo-s")
        cfgs = {f"{n}#{i}": (get_arch(n).model, jax_get_arch(n).model)
                for i, n in enumerate(names)}
        seq, budget = 1024, 2048 << 20
        hw = dict(peak_flops=5e12, hbm_bw=3.35e12, stream_bw=25e9)
    else:
        cfgs = {"a": (CFG, JAX_CFG),
                "b": (replace(CFG, num_layers=2),
                      replace(JAX_CFG, num_layers=2))}
        seq, budget, hw = SEQ, 8 << 20, HW
    g_t = {n: build_lm_graph(c[0], seq=seq, batch=1, dtype_bytes=4)
           for n, c in cfgs.items()}
    g_j = {n: jax_build(c[1], seq=seq, batch=1, dtype_bytes=4)
           for n, c in cfgs.items()}
    kw_t, kw_j = {}, {}
    if case == "mix":
        kw_t = kw_j = {"mix": {"a": 8.0, "b": 1.0}}
    if case == "reserves":
        from repro.core.allocator import ReservationSpec as JaxReservation
        spec = dict(arena_bytes=256 << 10, kv_seq_bytes=128 << 10,
                    kv_target_seqs=2, kv_benefit_s=1e-3)
        kw_t = {"reserves": {n: ReservationSpec(**spec) for n in cfgs}}
        kw_j = {"reserves": {n: JaxReservation(**spec) for n in cfgs}}
    mm_t = plan_multi_model(g_t, 1 << 20 if case == "full_size" else 256 << 10,
                            budget, hw=HWSpec(**hw), **kw_t)
    mm_j = jax_plan_multi_model(g_j, 1 << 20 if case == "full_size"
                                else 256 << 10, budget, hw=JaxHWSpec(**hw),
                                **kw_j)
    assert _plan(mm_t) == _plan(mm_j)
    if case == "full_size":
        assert mm_t.fits_budget()


# --- the weight pool --------------------------------------------------------

@pytest.mark.parametrize("policy", ["lru", "cost"])
@pytest.mark.parametrize("seed", [0, 1])
def test_weight_cache_random_ops_give_equal_ledgers(policy, seed):
    kb = 1 << 10
    rng = np.random.default_rng(seed)
    pools = (WeightCache(24 * kb, policy=policy),
             JaxWeightCache(24 * kb, policy=policy))
    held = []
    for _ in range(400):
        op = int(rng.integers(0, 100))
        key = (f"m{int(rng.integers(0, 3))}", f"w{int(rng.integers(0, 10))}",
               "w")
        if op < 35:
            n_kb = int(rng.integers(1, 6))
            pin = bool(rng.integers(0, 10) < 3)
            restream = int(n_kb * kb // int(rng.integers(1, 4)))
            value = torch.zeros(n_kb * kb, dtype=torch.uint8)
            out = [p.put(key, value, n_kb * kb, pin=pin,
                         restream_bytes=restream) for p in pools]
            if out[0] and pin:
                held.append(key)
        elif op < 55:
            out = [p.acquire(key) is not None for p in pools]
            if out[0]:
                held.append(key)
        elif op < 75:
            out = [None, None]
            if held:
                k = held.pop(int(rng.integers(0, len(held))))
                for p in pools:
                    p.release(k)
        elif op < 85:
            out = [p.remove(key) for p in pools]
            held = [k for k in held if k != key]
        elif op < 95:
            out = [(p.contains(key), p.free_bytes(), p.pins(key))
                   for p in pools]
        else:
            model = f"m{int(rng.integers(0, 3))}"
            out = [p.evict_model(model) for p in pools]
        assert out[0] == out[1]
        assert pools[0].used_bytes() == pools[1].used_bytes()
    assert pools[0].stats_snapshot() == pools[1].stats_snapshot()
    assert list(pools[0].keys()) == list(pools[1].keys())
    assert pools[0].ledger_balanced() and pools[1].ledger_balanced()


# --- the serving engine ------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jax_models = {n: JaxHostModel.build(JAX_CFG, seq=SEQ, seed=i)
                  for i, n in enumerate("ab")}
    port_models = {n: HostModel.from_host_weights(CFG, m.host_weights,
                                                  seq=SEQ, device="cpu")
                   for n, m in jax_models.items()}
    return jax_models, port_models


def _run(engine_cls, request_cls, models, **kw):
    eng = engine_cls(**kw)
    for n, m in models.items():
        eng.register(n, m)
    rng = np.random.default_rng(0)
    for r in range(6):
        eng.submit(request_cls(model="ab"[r % 2], req_id=r,
                               tokens=rng.integers(0, CFG.vocab, (1, SEQ),
                                                   dtype=np.int32)))
    return eng, eng.run_all()


@pytest.mark.parametrize("budget_mb", [6, 30])
def test_engine_run_all_matches_reference(models, budget_mb):
    jax_models, port_models = models
    kw = dict(budget_bytes=budget_mb << 20, prefetch=False)
    ej, rj = _run(JaxEngine, JaxRequest, jax_models, hw=JaxHWSpec(**HW), **kw)
    et, rt = _run(ServingEngine, Request, port_models, hw=HWSpec(**HW),
                  device="cpu", **kw)
    assert _plan(et.multi_plan) == _plan(ej.multi_plan)
    assert [(r.model, r.req_id, r.cache_hits, r.cache_misses, r.peak_bytes)
            for r in rt] == \
        [(r.model, r.req_id, r.cache_hits, r.cache_misses, r.peak_bytes)
         for r in rj]
    assert et.peak_memory() == ej.peak_memory() <= budget_mb << 20
    assert et.cache.stats_snapshot() == ej.cache.stats_snapshot()
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(_np(a.result), _np(b.result), **TOL)
    assert et.cache.ledger_balanced()


def test_engine_with_prefetch_agrees_and_balances(models):
    jax_models, port_models = models
    kw = dict(budget_bytes=10 << 20, prefetch=True)
    _, rj = _run(JaxEngine, JaxRequest, jax_models, hw=JaxHWSpec(**HW), **kw)
    et, rt = _run(ServingEngine, Request, port_models, hw=HWSpec(**HW),
                  device="cpu", **kw)
    assert [r.req_id for r in rt] == [r.req_id for r in rj]
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(_np(a.result), _np(b.result), **TOL)
    assert et.cache.ledger_balanced()
    assert et.peak_memory() <= 10 << 20


def test_engine_refuses_a_model_on_another_device(models):
    _, port_models = models
    eng = ServingEngine(hw=HWSpec(**HW), device="cpu")
    other = replace(port_models["a"], device=torch.device("meta"))
    with pytest.raises(ValueError, match="runs on"):
        eng.register("x", other)


# --- the CLI -----------------------------------------------------------------

TINY = ["--device", "cpu", "--layers", "1", "--seq", "32", "--disk-gbps", "0"]


def test_serve_cli_batch_mode_on_cpu():
    responses, engine = serve.main(TINY + [
        "--models", "gptneo-s,gptneo-s", "--requests", "3",
        "--budget-mb", "128"])
    assert [r.req_id for r in responses] == [0, 1, 2]
    toks = {r.req_id: r.tokens for r in serve.make_requests(
        engine.models, 3, 32)}
    for r in responses:
        assert tuple(r.result.shape) == (1, 32, 768)
        want = PreloadExecutor(engine.models[r.model]).run(toks[r.req_id])
        np.testing.assert_allclose(_np(r.result), _np(want.result),
                                   atol=1e-5)
    assert engine.peak_memory() <= 128 << 20
    assert engine.cache.ledger_balanced()


def test_serve_cli_online_debatches_against_solo_runs():
    responses, engine = serve.main(TINY + [
        "--models", "gptneo-s", "--online", "--rate", "100", "--duration",
        "0.1", "--max-batch", "2", "--budget-mb", "128"])
    ok = [r for r in responses if r.status == "ok"]
    assert any(r.batch_size == 2 for r in ok)
    trace = {r.req_id: r.tokens for r in serve.online_trace(
        engine.models, 100.0, 0.1, 32)}
    for r in ok:
        solo = PreloadExecutor(engine.models[r.model]).run(trace[r.req_id])
        np.testing.assert_allclose(_np(r.result), _np(solo.result),
                                   atol=1e-4)


def test_serve_cli_refuses_fleet_mode():
    """Fleet mode replays a trace: without --online it is refused, as the
    reference CLI refuses it."""
    with pytest.raises(SystemExit):
        serve.main(TINY + ["--models", "gptneo-s", "--replicas", "2"])
