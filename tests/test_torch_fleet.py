"""The port's fleet tier (``ft/resilience.py``, ``serving/replica.py``,
``serving/router.py`` and the serve CLI's fleet mode) against the JAX
package's, on the CPU.

Under a fixed virtual charge per batch (``ReplicaClock(exec_time=...)``),
a fixed ``HWSpec`` and ``prefetch=False`` both fleets are deterministic,
so the port must make the reference's decisions exactly: the same routes,
seeded retry jitter, md5 ring, breaker transitions, health and fault logs,
responses and ``FleetReport``, with served outputs within atol 1e-5 of the
reference's (the same batches, f32). The scenarios are those of
``tests/test_router.py``."""
import math
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro.ft import resilience as jax_resilience
from repro.launch import serve as jax_serve
from repro.core.capacity import HWSpec as JaxHWSpec
from repro.serving import replica as jax_replica
from repro.serving import router as jax_router
from repro.serving.config import ServeConfig as JaxServeConfig
from repro.serving.stream import poisson_trace
from repro.serving.types import Request as JaxRequest
from repro.serving.types import SLOConfig as JaxSLOConfig
from repro_torch.configs.gptneo import GPTNEO_S
from repro_torch.core.capacity import HWSpec
from repro_torch.core.streaming import HostModel
from repro_torch.ft import resilience
from repro_torch.launch import serve
from repro_torch.serving import replica, router
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.types import Request, SLOConfig
from serving_scenarios import (CHUNK, SEQ, TINY_CFG, build_models,
                               combined_bytes)

EXEC = 0.05
NAMES = ("a", "b", "c")
HW = dict(peak_flops=5e10, hbm_bw=2e10, stream_bw=1e10)
SIDES = {
    "jax": dict(replica=jax_replica, router=jax_router,
                resilience=jax_resilience, hw=JaxHWSpec,
                config=JaxServeConfig, slo=JaxSLOConfig, request=JaxRequest,
                engine_kw={}),
    "torch": dict(replica=replica, router=router, resilience=resilience,
                  hw=HWSpec, config=ServeConfig, slo=SLOConfig,
                  request=Request, engine_kw={"device": "cpu"}),
}
RESPONSE_FIELDS = ("req_id", "model", "status", "arrival_s", "latency_s",
                   "queue_s", "batch_size", "deadline_s", "priority",
                   "peak_bytes", "cache_hits", "cache_misses",
                   "kv_bytes", "predicted_s", "charged_s")


@pytest.fixture(scope="module")
def models():
    jax_models = build_models(NAMES)
    tiny = replace(GPTNEO_S, num_layers=TINY_CFG.num_layers,
                   d_model=TINY_CFG.d_model, n_heads=TINY_CFG.n_heads,
                   n_kv_heads=TINY_CFG.n_kv_heads, d_ff=TINY_CFG.d_ff,
                   vocab=TINY_CFG.vocab)
    port_models = {n: HostModel.from_host_weights(
        replace(tiny, name=n), m.host_weights, seq=SEQ, device="cpu")
        for n, m in jax_models.items()}
    return {"jax": jax_models, "torch": port_models}


def _fleet(side, models, *, n=3, budget_frac=0.5, result_mode="object",
           scheduler="fifo"):
    s = SIDES[side]
    per = int(budget_frac * combined_bytes(models["jax"]))
    fleet = []
    for rid in range(n):
        rep = s["replica"].Replica(
            rid, clock=s["replica"].ReplicaClock(exec_time=EXEC),
            policy="stream", chunk_bytes=CHUNK, budget_bytes=per,
            prefetch=False, hw=s["hw"](**HW), **s["engine_kw"])
        for name, m in models[side].items():
            rep.register(name, m)
        rep.start(config=s["config"](scheduler=scheduler,
                                     result_mode=result_mode))
        fleet.append(rep)
    return fleet


def _random_events(seed):
    """The seeded random fault plans of tests/test_router.py's
    exactly-one-terminal-response property."""
    rng = np.random.default_rng(seed)
    rate = float(rng.uniform(3.0, 8.0))
    events = []
    for rid in range(3):
        if rng.random() < 0.6:
            t = float(rng.uniform(0.1, 1.2))
            kind = rng.choice(["kill", "wedge", "slow"])
            if kind == "kill":
                events.append(("kill", t, rid))
            elif kind == "wedge":
                events.append(("wedge", t, rid))
                if rng.random() < 0.7:
                    events.append(("recover",
                                   t + float(rng.uniform(0.2, 0.8)), rid))
            else:
                events.append(("slow", t, rid,
                               float(rng.uniform(3, 10))))
    return rate, events


SCENARIOS = {
    "affinity": dict(rate=4.0, duration=1.5, slo=0.5),
    "round_robin": dict(rate=4.0, duration=1.0,
                        router=dict(routing="round_robin")),
    "affinity_small_pools": dict(rate=6.0, duration=2.0, budget_frac=0.45),
    "round_robin_small_pools": dict(rate=6.0, duration=2.0,
                                    budget_frac=0.45,
                                    router=dict(routing="round_robin")),
    "kill": dict(rate=6.0, duration=2.5, slo=1.0,
                 router=dict(timeout_s=0.2, cooldown_s=0.3,
                             failure_threshold=3),
                 events=[("kill", 0.8, 1)]),
    "kill_columnar": dict(rate=6.0, duration=2.0, slo=1.0,
                          result_mode="columnar",
                          router=dict(timeout_s=0.2, seed=5),
                          events=[("kill", 0.7, 0)]),
    "wedge_recover": dict(rate=6.0, duration=3.0, slo=1.0,
                          router=dict(timeout_s=0.2, cooldown_s=0.25,
                                      failure_threshold=2),
                          events=[("wedge", 0.6, "home_a"),
                                  ("recover", 1.4, "home_a")]),
    "slow": dict(rate=5.0, duration=3.0, slo=2.0,
                 router=dict(routing="round_robin", timeout_s=5.0,
                             health_interval_s=0.5, cooldown_s=10.0),
                 events=[("slow", 0.3, 2, 8.0)]),
    "slo_scheduler": dict(rate=8.0, duration=1.5, slo=0.3,
                          scheduler="slo", events=[("kill", 0.5, 2)],
                          router=dict(timeout_s=0.3)),
}
for _seed in range(5):
    _rate, _events = _random_events(_seed)
    SCENARIOS[f"random_faults_{_seed}"] = dict(
        rate=_rate, duration=1.5, slo=0.8, trace_seed=100 + _seed,
        events=_events, router=dict(timeout_s=0.2, cooldown_s=0.25,
                                    seed=_seed))


def _run(side, models, sc):
    s = SIDES[side]
    trace = poisson_trace({n: sc["rate"] for n in NAMES}, sc["duration"],
                          vocab=TINY_CFG.vocab, seq=SEQ,
                          seed=sc.get("trace_seed", 3))
    trace = [s["request"](r.model, r.tokens, arrival_s=r.arrival_s)
             for r in trace]
    fleet = _fleet(side, models, budget_frac=sc.get("budget_frac", 0.5),
                   result_mode=sc.get("result_mode", "object"),
                   scheduler=sc.get("scheduler", "fifo"))
    rt = s["router"].Router(fleet, **sc.get("router", {}))
    plan = s["replica"].FaultPlan()
    home_a = s["router"].HashRing([0, 1, 2]).lookup("a")
    for kind, t, rid, *factor in sc.get("events", ()):
        getattr(plan, kind)(t, home_a if rid == "home_a" else rid, *factor)
    slo = s["slo"](default_slo_s=sc["slo"]) if "slo" in sc else None
    responses = rt.serve(trace, slo=slo, fault_plan=plan)
    rows = [tuple(getattr(r, f) for f in RESPONSE_FIELDS)
            for r in responses]
    # a columnar table keeps no outputs
    results = {r.req_id: r.result for r in responses
               if r.status == "ok" and sc.get("result_mode") != "columnar"}
    decisions = dict(
        rows=rows, routes=list(rt.route_log), health=list(rt.health_log),
        faults=list(rt.fault_log),
        breakers={rid: (br.state, br.failures, br.transitions)
                  for rid, br in rt.breakers.items()},
        counters=(rt.retries, rt.failed, rt.dup_suppressed),
        report=rt.report(responses).as_dict(),
        feeds=[list(rep.batch_feed) for rep in fleet],
        clocks=[rep.clock.now() for rep in fleet],
        pools=[rep.engine.cache.stats_snapshot() for rep in fleet],
        health_reports=[rep.health().as_dict() for rep in fleet])
    for rep in fleet:
        assert rep.engine.peak_memory() <= rep.engine.cache.budget_bytes
        assert rep.engine.cache.ledger_balanced()
    return trace, decisions, results


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fleet_makes_the_reference_decisions(models, name):
    trace, want, want_out = _run("jax", models, SCENARIOS[name])
    _, got, got_out = _run("torch", models, SCENARIOS[name])
    for key in want:
        assert got[key] == want[key], key
    # every request has exactly one terminal response, in arrival order
    assert sorted(r[0] for r in got["rows"]) == list(range(len(trace)))
    assert all(r[2] in ("ok", "rejected", "failed") for r in got["rows"])
    assert all(math.isfinite(r[4]) and r[4] >= 0.0 for r in got["rows"])
    assert got_out.keys() == want_out.keys()
    for req_id, out in got_out.items():
        np.testing.assert_allclose(_np(out), _np(want_out[req_id]),
                                   atol=1e-5, rtol=0)


def test_fault_scenarios_exercise_retries_breakers_and_stragglers(models):
    """The scenarios compared above reach the paths they name."""
    _, kill, _ = _run("torch", models, SCENARIOS["kill"])
    assert kill["counters"][0] >= 3 and kill["counters"][1] == 0
    assert any("consecutive" in why for *_x, why in kill["breakers"][1][2])
    _, wedge, _ = _run("torch", models, SCENARIOS["wedge_recover"])
    assert any(b == "closed" and a == "half_open"
               for tr in (br[2] for br in wedge["breakers"].values())
               for _, a, b, _ in tr)
    _, slow, _ = _run("torch", models, SCENARIOS["slow"])
    assert any(ev == "straggler_trip" and rid == 2
               for _, ev, rid in slow["health"])


def test_spillover_picks_equal(models):
    picks = {}
    for side, s in SIDES.items():
        fleet = _fleet(side, models)
        rt = s["router"].Router(fleet, routing="affinity", spill_depth=2)
        rt._ring = s["router"].HashRing([r.rid for r in fleet])
        home = rt._ring.lookup("a")
        sibs = [r.rid for r in fleet if r.rid != home]
        out = [rt._pick("a", 0.0, exclude=set())]
        rng = np.random.default_rng(0)
        for _ in range(3):
            fleet[home].inbox.push(s["request"](
                "a", rng.integers(0, TINY_CFG.vocab, (1, SEQ),
                                  dtype=np.int32), arrival_s=0.0))
        fleet[sibs[0]].engine.cache.put(("a", "wte", "w"),
                                        np.zeros(8, np.uint8), 4096)
        out.append(rt._pick("a", 0.0, exclude=set()))
        fleet[sibs[0]].engine.cache.remove(("a", "wte", "w"))
        fleet[sibs[1]].engine.cache.put(("filler", "w0", "w"),
                                        np.zeros(8, np.uint8), 1 << 20)
        out.append(rt._pick("a", 0.0, exclude={home}))
        out.append(rt._pick("a", 0.0, exclude=set()))
        rt.breakers[home].trip(0.0)
        out.append(rt._pick("a", 0.0, exclude=set()))
        picks[side] = [(rep.rid, why) for rep, why in out]
    assert picks["torch"] == picks["jax"]
    assert [why for _, why in picks["torch"]] == [
        "home", "hot", "cold", "home_backlogged", "cold"]


# --- units --------------------------------------------------------------------

def test_hash_ring_lookups_equal():
    names = [f"model-{i}" for i in range(32)] + ["a", "b", "c", "gptneo-s#0"]
    for rids, vnodes in (([0, 1, 2], 64), ([0, 2], 64), ([0, 1, 2, 3, 4], 8)):
        got = router.HashRing(rids, vnodes=vnodes)
        want = jax_router.HashRing(rids, vnodes=vnodes)
        assert [got.lookup(n) for n in names] == \
            [want.lookup(n) for n in names]


def test_circuit_breaker_and_retry_policy_equal():
    out = {}
    for side, s in SIDES.items():
        br = s["router"].CircuitBreaker(0, failure_threshold=3, cooldown_s=1.0)
        seen = []
        for op, t in [("failure", 0.1), ("success", 0.15), ("failure", 0.2),
                      ("failure", 0.3), ("failure", 0.4), ("route", 1.5),
                      ("success", 1.7), ("trip", 2.0), ("route", 3.1),
                      ("failure", 3.2), ("route", 4.3), ("route", 4.4),
                      ("success", 4.5)]:
            getattr(br, {"failure": "on_failure", "success": "on_success",
                         "route": "on_route", "trip": "trip"}[op])(t)
            seen.append((br.state, br.failures, br.probe_inflight,
                         br.available(t), br.available(t + 1.0)))
        rp = s["router"].RetryPolicy(base_s=0.05, factor=2.0, cap_s=0.4,
                                     jitter_frac=0.25)
        rng = np.random.default_rng(7)
        out[side] = (seen, br.transitions,
                     [rp.delay(k, rng) for k in range(1, 9)])
    assert out["torch"] == out["jax"]
    with pytest.raises(ValueError, match="unknown routing"):
        router.Router([], routing="random")


def test_replica_clock_and_fault_plan_equal():
    out = {}
    for side, s in SIDES.items():
        clk = s["replica"].ReplicaClock(exec_time=0.1, batch_growth=0.5)
        ticks = [clk.tick(0.0, "m"), clk.tick(0.0, "m", batch_size=3)]
        clk.slow_factor = 4.0
        ticks += [clk.tick(0.0, "m"), clk.tick(0.0, "m", frac=0.5)]
        clk.advance(0.2)
        measured = s["replica"].ReplicaClock()
        measured.slow_factor = 3.0
        ticks += [clk.now(), measured.tick(0.01, "m"), measured.now()]
        plan = s["replica"].FaultPlan().kill(0.5, rid=1) \
            .slow(0.2, rid=0, factor=8.0).wedge(0.2, rid=2) \
            .recover(0.9, rid=2)
        errors = []
        for args in [(0.1, 0, "explode"), (0.1, 0, "slow", 1.0)]:
            with pytest.raises(ValueError) as err:
                s["replica"].FaultEvent(*args)
            errors.append(str(err.value))
        out[side] = (ticks, [(e.t_s, e.rid, e.kind, e.factor)
                             for e in plan.sorted_events()], errors)
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("seed", [0, 1])
def test_straggler_detector_equal(seed):
    rng = np.random.default_rng(seed)
    steps = [[(h, float(rng.lognormal(0.0, 0.1) * (6.0 if h == 3 and k > 4
                                                    else 1.0)))
              for h in range(5) if not (h == 1 and 6 <= k < 9)]
             for k in range(14)]
    out = {}
    for side, s in SIDES.items():
        det = s["resilience"].StragglerDetector(window=8, z_thresh=3.0,
                                                patience=2)
        flagged = []
        for step in steps:
            for h, t in step:
                det.record(h, t)
            flagged.append(det.check())
        out[side] = (flagged, det.strikes)
    assert out["torch"] == out["jax"]
    assert any(3 in f for f in out["torch"][0])


def test_preemption_and_elastic_controller_equal():
    out = {}
    for side, s in SIDES.items():
        res = s["resilience"]
        pre = res.PreemptionHandler()
        before = pre.should_stop()
        pre.preempt()
        ctl = res.ElasticController(lambda n: f"mesh{n}",
                                    lambda env: (env + ":state", 7),
                                    min_hosts=2)
        ret = ctl.on_membership_change(10, 4, 3)
        with pytest.raises(RuntimeError) as err:
            ctl.on_membership_change(11, 3, 1)
        out[side] = (before, pre.should_stop(), ret,
                     [(e.step, e.old_hosts, e.new_hosts, e.restore_step)
                      for e in ctl.events], str(err.value))
    assert out["torch"] == out["jax"]


def test_timed_step_returns_the_result_and_its_time():
    value = {"a": [torch.ones(3), (torch.zeros(2), 5)], "b": np.ones(2)}
    out, dt = resilience.timed_step(lambda x: x, value)
    assert out is value and dt >= 0.0
    with pytest.raises(ZeroDivisionError):
        resilience.timed_step(lambda: 1 / 0)


# --- the CLI -------------------------------------------------------------------

FLEET_ARGV = ["--models", "gptneo-s,gptneo-s", "--online", "--layers", "1",
              "--seq", "32", "--disk-gbps", "0", "--budget-mb", "128",
              "--rate", "8", "--duration", "1", "--max-batch", "2"]


@pytest.mark.parametrize("routing", ["affinity", "round_robin"])
def test_serve_cli_fleet_mode_against_the_reference(routing, capsys):
    """Three replicas on the CPU. The CLI charges measured time, so the two
    fleets may batch differently: they serve the same trace to completion,
    and every output agrees with the reference's for the same request
    within the de-batching tolerance of the port's online CLI test."""
    argv = FLEET_ARGV + ["--replicas", "3", "--routing", routing,
                         "--timeout-ms", "10000"]
    want, want_router = jax_serve.main(argv)
    got, got_router = serve.main(["--device", "cpu"] + argv)
    text = capsys.readouterr().out
    assert f"FLEET 3 replicas routing={routing}" in text
    assert [(r.req_id, r.model, r.arrival_s) for r in got] == \
        [(r.req_id, r.model, r.arrival_s) for r in want]
    assert all(r.status == "ok" for r in got) and len(got) > 4
    assert got_router.retries == want_router.retries == 0
    assert {rep.device for rep in got_router.replicas} == \
        {torch.device("cpu")}
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a.result), _np(b.result), atol=1e-4,
                                   rtol=0)
    for rep in got_router.replicas:
        assert rep.engine.peak_memory() <= 128 << 20


def test_serve_cli_fleet_mode_needs_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(FLEET_ARGV + ["--replicas", "3"])
