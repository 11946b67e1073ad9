"""Whether the serving plan of ``chip_smoke.py`` phase 5 fits its budget,
by the port's planner and the JAX package's, on the CPU.

Phase 5 serves GPT-Neo-1.3B and GPT-Neo-S (seq 1024, f32 weights, 1 MiB
chunks, a 2048 MiB pool, no mix and no reserves, as ``launch/serve.py``
builds them) with an ``HWSpec`` calibrated on the card at engine start.
The two planners give the same per-model peaks bit for bit at every
``HWSpec``. Where the card's matmul rate is high against its host copy
rate (near 880 FLOP for each byte streamed), the loads can no longer hide
behind compute, LC-OPG preloads past the budget and neither plan fits:
the 1.3B model's planned peak jumps from about 2138 MB to 2173.7 MB, and
past that to 3440.4 MB. One calibration the card has printed lies past
the threshold (1011.4 FLOP a streamed byte, a host copy rate of 39.0
GB/s): there both planners give the 1.3B model 3386.9 MB, and phase 5's
pool ran over its budget. Neither engine reads ``fits_budget()`` before
it runs a plan (``tests/test_torch_pool_overrun.py`` runs both engines on
such a plan).
"""
import pytest

from repro.configs import get_arch as jax_get_arch
from repro.core.capacity import HWSpec as JaxHWSpec
from repro.core.graph import build_lm_graph as jax_build
from repro.core.plan import plan_multi_model as jax_plan_multi_model
from repro_torch.configs import get_arch
from repro_torch.core.capacity import HWSpec
from repro_torch.core.graph import build_lm_graph
from repro_torch.core.plan import plan_multi_model

MODELS = ("gptneo-1.3b", "gptneo-s")
SEQ, CHUNK, BUDGET = 1024, 1 << 20, 2048 << 20
# (peak_flops, hbm_bw, stream_bw): five that phase 5 printed on the H100
# (its "[serve] planned with" lines; the first, at 867.1 FLOP a streamed
# byte, the nearest under the threshold the card has printed; the fifth,
# at 1011.4, the one past it, printed when the pool ran over its budget),
# then round-number calibrations on either side of the threshold; with
# the 1.3B model's planned peak in MB and whether the plan fits the
# budget
CASES = [((35007231310523.957, 2095056827709.6345, 40374102065.861244),
          2142.2, True),
         ((35620415632564.55, 2258645061038.675, 45675652730.75533),
          2139.1, True),
         ((36802228043242.24, 2192526904320.9053, 45846402966.526955),
          2138.0, True),
         ((35681970495867.3, 2183396194313.5974, 52908949552.26515),
          1194.2, True),
         ((39475801829584.78, 2457120152138.118, 39032758080.86753),
          3386.9, False),
         ((3.6e13, 2.2e12, 4.2e10), None, True),
         ((3.7e13, 2.2e12, 4.2e10), 2173.7, False),
         ((4.0e13, 2.2e12, 3.8e10), 3440.4, False),
         ((4.0e13, 2.2e12, 3.0e10), 4153.4, False)]


@pytest.fixture(scope="module")
def graphs():
    """Phase 5's two graphs in both packages, named as the CLI names
    them."""
    names = [f"{n}#{i}" for i, n in enumerate(MODELS)]
    return ({k: build_lm_graph(get_arch(n).model, seq=SEQ, dtype_bytes=4)
             for k, n in zip(names, MODELS)},
            {k: jax_build(jax_get_arch(n).model, seq=SEQ, dtype_bytes=4)
             for k, n in zip(names, MODELS)})


@pytest.mark.parametrize("spec,big_mb,fits", CASES,
                         ids=[f"{s[0]:.4g}/{s[2]:.4g}" for s, _, _ in CASES])
def test_both_planners_give_phase_5_the_same_plan(graphs, spec, big_mb, fits):
    port_graphs, jax_graphs = graphs
    port = plan_multi_model(port_graphs, CHUNK, BUDGET, hw=HWSpec(*spec))
    ref = jax_plan_multi_model(jax_graphs, CHUNK, BUDGET, hw=JaxHWSpec(*spec))
    assert dict(port.peaks) == dict(ref.peaks)
    assert port.fits_budget() == ref.fits_budget() == fits
    if big_mb is not None:
        assert round(port.peaks["gptneo-1.3b#0"] / 1e6, 1) == big_mb
    # the FLOP for each streamed byte on either side of the threshold
    assert (spec[0] / spec[2] < 870) == fits
