"""The port's trace library (``serving/traces.py``) against the JAX
package's: every generator gives the same requests bit for bit (arrival,
model, tokens, deadline, priority, ``req_id``) under the same seed, and
``jain_fairness`` and ``tenant_on_time_rates`` give the same numbers over
the same responses, as objects and as a columnar table."""
import numpy as np
import pytest

from repro.serving import traces as jax_traces
from repro.serving.response_table import ResponseTable as JaxResponseTable
from repro.serving.types import Response as JaxResponse
from repro_torch.serving import traces
from repro_torch.serving.response_table import ResponseTable
from repro_torch.serving.types import Response

VOCAB, SEQ = 64, 8
SIDES = {"jax": (jax_traces, JaxResponse, JaxResponseTable),
         "torch": (traces, Response, ResponseTable)}


def _requests(trace):
    return [(r.model, r.arrival_s, r.tokens.dtype.str, r.tokens.shape,
             r.tokens.tobytes(), r.deadline_s, r.priority, r.req_id,
             r.decode_tokens) for r in trace]


def _tenants(mod):
    return {"fast": mod.TenantSpec(models=("a",), rate=40.0, slo_s=0.05,
                                   priority=2.0),
            "slow": mod.TenantSpec(models=("a", "b"), rate=40.0, slo_s=0.5),
            "idle": mod.TenantSpec(models=("b",), rate=0.0, slo_s=0.1)}


GENERATORS = {
    "diurnal": lambda m, seed: m.diurnal_trace(
        {"a": 50.0, "b": 5.0, "z": 0.0}, 12.0, period_s=5.0, depth=0.6,
        phase=0.3, vocab=VOCAB, seq=SEQ, seed=seed),
    "flash_crowd": lambda m, seed: m.flash_crowd_trace(
        {"a": 20.0, "b": 20.0}, 10.0, crowd_model="a", start_s=3.0,
        span_s=2.0, factor=20.0, vocab=VOCAB, seq=SEQ, seed=seed),
    "multi_tenant": lambda m, seed: m.multi_tenant_trace(
        _tenants(m), 5.0, vocab=VOCAB, seq=SEQ, seed=seed),
    "session": lambda m, seed: m.session_trace(
        ("a", "b", "c"), 5.0, 8.0, chain_len=3, think_s=0.1, vocab=VOCAB,
        seq=SEQ, seed=seed),
    "stamped": lambda m, seed: m.stamp_req_ids(m.session_trace(
        ("a", "b"), 3.0, 4.0, vocab=VOCAB, seq=SEQ, seed=seed), start=7),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
@pytest.mark.parametrize("seed", [0, 5])
def test_traces_equal(name, seed):
    out = {}
    for side, (mod, *_rest) in SIDES.items():
        got = GENERATORS[name](mod, seed)
        if name == "multi_tenant":
            trace, tenant_of = got
            out[side] = (_requests(trace), tenant_of)
        else:
            out[side] = _requests(got)
    assert out["torch"] == out["jax"]
    assert len(out["torch"]) > 0


@pytest.mark.parametrize("name,kw", [
    ("diurnal_trace", dict(rates={"m": 1.0}, duration_s=1.0, period_s=1.0,
                           depth=1.5)),
    ("flash_crowd_trace", dict(base_rates={"a": 1.0}, duration_s=1.0,
                               crowd_model="zzz", start_s=0.0, span_s=1.0)),
    ("flash_crowd_trace", dict(base_rates={"a": 1.0}, duration_s=1.0,
                               crowd_model="a", start_s=0.0, span_s=1.0,
                               factor=0.5)),
    ("session_trace", dict(models=(), session_rate=1.0, duration_s=1.0)),
    ("session_trace", dict(models=("a",), session_rate=1.0, duration_s=1.0,
                           chain_len=0))])
def test_invalid_trace_arguments_raise_the_same_error(name, kw):
    msgs = []
    for mod, *_rest in SIDES.values():
        with pytest.raises(ValueError) as err:
            getattr(mod, name)(vocab=VOCAB, seq=SEQ, **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("columnar", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_tenant_on_time_rates_and_fairness_equal(columnar, seed):
    rng = np.random.default_rng(seed)
    trace, tenant_of = traces.multi_tenant_trace(
        _tenants(traces), 5.0, vocab=VOCAB, seq=SEQ, seed=seed)
    rows = [dict(model=r.model, latency_s=float(rng.uniform(0.0, 0.6)),
                 status=str(rng.choice(["ok", "ok", "ok", "rejected",
                                        "failed"])),
                 arrival_s=r.arrival_s, deadline_s=r.deadline_s,
                 priority=r.priority, req_id=r.req_id) for r in trace]
    # one response for a request the map does not know, one tenant lost
    rows.append(dict(rows[0], req_id=10 ** 6))
    tenant_of = {k: v for k, v in tenant_of.items() if k != 3}
    out = {}
    for side, (mod, resp_cls, table_cls) in SIDES.items():
        resps = [resp_cls(r["model"], r["latency_s"], 0.0, 0.0, 0,
                          **{k: v for k, v in r.items()
                             if k not in ("model", "latency_s")})
                 for r in rows]
        if columnar:
            table = table_cls()
            for r in resps:
                table.append_response(r)
            resps = table
        rates = mod.tenant_on_time_rates(resps, tenant_of)
        out[side] = (rates, mod.jain_fairness(list(rates.values())),
                     mod.tenant_on_time_rates(resps, {}))
    assert out["torch"] == out["jax"]
    assert set(out["torch"][0]) == {"fast", "slow"}


@pytest.mark.parametrize("values", [[], [0.0, 0.0], [1.0, 1.0, 1.0],
                                    [1.0, 0.0, 0.0], [1.0, 0.5, 0.25],
                                    list(np.random.default_rng(0)
                                         .uniform(0.1, 1.0, 16))])
def test_jain_fairness_equal(values):
    assert traces.jain_fairness(values) == jax_traces.jain_fairness(values)
