"""The serving pool over its budget: the port's engine and the JAX
package's, on the CPU, through one trace with one recorded ``HWSpec``.

The engine's residency counts the pool's bytes plus what the pool refused
(a put is refused when pinned entries fill it; the weight stays on the
device as a transient) plus the loader's chunks in flight. While model
``a`` runs, the prefetch thread pins model ``b``'s earliest chunks up to
``prefetch_budget(a, reserve=0.1)``, which trusts ``a``'s planned peak.
Here ``a``'s planned peak is understated tenfold after planning, so the
pins reach that limit while ``a``'s executed residency runs over what the
plan said: both engines refuse puts of ``a`` and of ``a`` only, and both
pass the budget by no more than the bytes they refused. With the plan's
own peaks neither engine refuses a put or passes the budget. The
prefetch thread is joined before ``a`` runs, so the pins are in place
when its loads come. Each run's loader thread is held to its compute
loop as well (``_loaders_held``): when compute lets op ``l``'s loads
through, it waits until the loader has put them and parks at a later
gate, so every chunk is put before the compute loop releases the weights
that op ``l`` uses for the last time. Left to the scheduler, a loader
that lags its compute loop (as on a loaded host) puts its chunks only
once compute waits for them: they are assembled before the op's
residency is read, and at ``frac=0.3`` the peak stayed under the budget
(1101824 against 1104076 bytes in both engines) though puts were
refused. The engines are held to the same bounds, not to each other's
bytes.

With an ``HWSpec`` that phase 5 of ``chip_smoke.py`` recorded on the
card, the plan of these reduced models does not fit the budget itself
(``tests/test_torch_plan_fit.py`` shows the same of phase 5's full-size
pair past a calibration threshold): neither engine reads
``fits_budget()`` before it runs the plan, and both pass the budget by no
more than the same bound, the bytes they refused and the plan's own peak.
"""
import threading
from collections import Counter
from contextlib import contextmanager
from dataclasses import replace

import numpy as np
import pytest

from repro.configs.gptneo import GPTNEO_S as JAX_GPTNEO_S
from repro.core.capacity import HWSpec as JaxHWSpec
from repro.core import streaming as jax_streaming
from repro.core.streaming import HostModel as JaxHostModel
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs.gptneo import GPTNEO_S
from repro_torch.core.capacity import HWSpec
from repro_torch.core import streaming as torch_streaming
from repro_torch.core.streaming import HostModel
from repro_torch.serving.engine import Request, ServingEngine

SHAPE = dict(num_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=512,
             vocab=512)
SEQ = 32
HW = dict(peak_flops=5e10, hbm_bw=2e10, stream_bw=1e10)
# phase 5's "[serve] planned with" line on the H100
CARD_HW = dict(peak_flops=35620415632564.55, hbm_bw=2258645061038.675,
               stream_bw=45675652730.75533)
CHUNK = 16 << 10


class _Gate(threading.Event):
    """A loader gate that tells its loader's compute loop when the loader
    waits at it."""

    def __init__(self, loader, op_index):
        super().__init__()
        self.loader, self.op_index = loader, op_index

    def wait(self, timeout=None):
        with self.loader.parked:
            self.loader.parked_at = self.op_index
            self.loader.parked.notify_all()
        return super().wait(timeout)


@contextmanager
def _loaders_held():
    """Both packages' ``_Loader``s, with each gate's loads put before the
    compute loop runs the op that let them through."""
    saved = []
    for mod in (jax_streaming, torch_streaming):
        cls = mod._Loader
        saved.append((cls, cls.start, cls.run, cls.allow_through))

        def start(self, _start=cls.start):
            self.parked = threading.Condition()
            self.parked_at = -1
            self.gate = {l: _Gate(self, l) for l in self.gate}
            _start(self)

        def run(self, _run=cls.run):
            try:
                _run(self)
            finally:
                with self.parked:
                    self.parked_at = float("inf")
                    self.parked.notify_all()

        def allow_through(self, op_index, _allow=cls.allow_through):
            _allow(self, op_index)
            if op_index in self.gate:
                with self.parked:
                    assert self.parked.wait_for(
                        lambda: self.parked_at > op_index, timeout=60)

        cls.start, cls.run, cls.allow_through = start, run, allow_through
    try:
        yield
    finally:
        for cls, start, run, allow in saved:
            cls.start, cls.run, cls.allow_through = start, run, allow


@pytest.fixture(scope="module")
def models():
    jax_models = {n: JaxHostModel.build(replace(JAX_GPTNEO_S, name=n,
                                                **SHAPE), seq=SEQ, seed=i)
                  for i, n in enumerate("ab")}
    port = {n: HostModel.from_host_weights(replace(GPTNEO_S, name=n, **SHAPE),
                                           m.host_weights, seq=SEQ,
                                           device="cpu")
            for n, m in jax_models.items()}
    total = sum(a.nbytes for m in jax_models.values()
                for a in m.host_weights.values())
    return {"jax": jax_models, "torch": port}, total


def _serve(side, models, budget, understate, hw=HW):
    """Serve a then b with prefetch; returns (peak, refused bytes by
    model, refused puts, a's planned peak, the plan's global peak)."""
    cls, req, hw, kw = {
        "jax": (JaxEngine, JaxRequest, JaxHWSpec(**hw), {}),
        "torch": (ServingEngine, Request, HWSpec(**hw), {"device": "cpu"}),
    }[side]
    eng = cls(budget_bytes=budget, prefetch=True, hw=hw, chunk_bytes=CHUNK,
              **kw)
    for name, m in models.items():
        eng.register(name, m)
    eng._ensure_planned()
    planned = eng.multi_plan.peaks["a"]
    plan_peak = eng.multi_plan.global_peak()
    if understate:
        eng.multi_plan.peaks["a"] = int(planned * understate)
    start = eng._start_prefetch

    def start_and_join(target, current, lookahead_ops=None):
        th, stop = start(target, current, lookahead_ops)
        th.join(timeout=60)
        assert not th.is_alive()
        return th, stop

    eng._start_prefetch = start_and_join
    refused, puts = Counter(), [0]
    put = eng.cache.put

    def counted_put(key, value, nbytes, **put_kw):
        ok = put(key, value, nbytes, **put_kw)
        if not ok:
            refused[key[0]] += int(nbytes)
            puts[0] += 1
        return ok

    eng.cache.put = counted_put
    rng = np.random.default_rng(0)
    for r, name in enumerate("ab"):
        eng.submit(req(model=name, req_id=r, tokens=rng.integers(
            0, SHAPE["vocab"], (1, SEQ), dtype=np.int32)))
    with _loaders_held():
        eng.run_all()
    assert eng.cache.ledger_balanced()
    return eng.peak_memory(), dict(refused), puts[0], planned, plan_peak


@pytest.mark.parametrize("frac", [0.2, 0.3])
def test_both_engines_over_run_alike_when_the_planned_peak_is_short(models,
                                                                    frac):
    sides, total = models
    budget = int(frac * total)
    jax_run = _serve("jax", sides["jax"], budget, 0.1)
    port_run = _serve("torch", sides["torch"], budget, 0.1)
    assert port_run[3] == jax_run[3] <= budget  # the true plan fits
    for peak, refused, puts, _, _ in (jax_run, port_run):
        assert set(refused) == {"a"} and puts > 0
        # over the budget, by no more than the refused bytes
        assert budget < peak <= budget + refused["a"]


@pytest.mark.parametrize("frac", [0.2, 0.3, 0.45])
def test_with_the_plans_own_peaks_neither_engine_passes_the_budget(models,
                                                                   frac):
    sides, total = models
    budget = int(frac * total)
    for side in ("jax", "torch"):
        peak, refused, puts, _, _ = _serve(side, sides[side], budget, None)
        assert peak <= budget and puts == 0 and not refused, side


@pytest.mark.parametrize("frac", [0.2, 0.3])
def test_both_engines_pass_the_budget_alike_under_a_plan_that_does_not_fit(
        models, frac):
    """At the card's calibration these reduced models' plan preloads past
    the budget; both engines run it as it is."""
    sides, total = models
    budget = int(frac * total)
    runs = [_serve(side, sides[side], budget, None, CARD_HW)
            for side in ("jax", "torch")]
    assert runs[0][3:] == runs[1][3:]  # the same plan
    for peak, refused, puts, _, plan_peak in runs:
        assert plan_peak > budget and puts > 0
        assert budget < peak <= min(plan_peak,
                                    budget + sum(refused.values()))
