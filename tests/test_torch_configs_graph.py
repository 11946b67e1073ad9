"""The port's copies of the configs and the planning graph match the JAX
package's: same registry, same configs, and for every architecture the
same ops (names, kinds, FLOPs, bytes, weights) and the same weights."""
import dataclasses

import pytest

from repro.configs import ARCHS as JAX_ARCHS
from repro.core.graph import build_lm_graph as jax_build
from repro_torch.configs import ARCHS
from repro_torch.core.graph import build_lm_graph


def test_registry_is_the_same():
    assert sorted(ARCHS) == sorted(JAX_ARCHS)


@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_config_fields_equal(name):
    assert dataclasses.asdict(ARCHS[name].model) == \
        dataclasses.asdict(JAX_ARCHS[name].model)


@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_graph_ops_and_weights_equal(name):
    cfg_t, cfg_j = ARCHS[name].model, JAX_ARCHS[name].model
    seq = 64
    g_t = build_lm_graph(cfg_t, seq=seq, batch=2, dtype_bytes=4)
    g_j = jax_build(cfg_j, seq=seq, batch=2, dtype_bytes=4)
    assert g_t.name == g_j.name
    assert [(o.index, o.name, o.kind, o.flops, o.act_bytes, o.weights,
             o.layer, o.op_class) for o in g_t.ops] == \
        [(o.index, o.name, o.kind, o.flops, o.act_bytes, o.weights,
          o.layer, o.op_class) for o in g_j.ops]
    assert {n: (w.bytes, w.consumer) for n, w in g_t.weights.items()} == \
        {n: (w.bytes, w.consumer) for n, w in g_j.weights.items()}
    assert g_t.weight_consumers() == g_j.weight_consumers()
