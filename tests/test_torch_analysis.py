"""The port's analysis, sharding-rule and dry-run modules against the JAX
package's, on the CPU.

* ``analysis.hlo_parse``, ``analysis.report`` and the term arithmetic of
  ``analysis.roofline`` (given the JAX package's TPU peaks as arguments)
  equal to the JAX package's on the fixtures of ``tests/test_analysis.py``
  and on the optimized HLO text of a small JAX-compiled scan program;
  ``model_flops`` equal for every arch and shape.
* ``make_rules`` equal for every flag combination; ``MeshEnv.pspec`` and
  ``axis_size`` over a described mesh equal to the JAX ``MeshEnv``'s on
  ``jax.sharding.AbstractMesh`` meshes of 16 x 16 and 2 x 16 x 16, for the
  parameter specs of every arch.
* ``launch.dryrun`` on a reduced arch on the ``meta`` device: its FLOPs
  are those of the same step run on CPU tensors, its bytes those of the
  specs, its terms the roofline's arithmetic.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.analysis import hlo_parse as jax_hlo
from repro.analysis import report as jax_report
from repro.analysis import roofline as jax_roof
from repro.configs import ASSIGNED as JAX_ASSIGNED
from repro.configs import get_arch as jax_get_arch
from repro.distributed import sharding as jax_shd
from repro.models import model as jax_model
from repro_torch.analysis import hlo_parse, report, roofline
from repro_torch.configs import ASSIGNED, get_arch
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun, mesh
from repro_torch.models import model as tmodel
from test_analysis import HLO
from torch_threads import one_torch_thread  # noqa: F401

TPU = dict(peak_flops=jax_roof.PEAK_FLOPS, hbm_bw=jax_roof.HBM_BW,
           link_bw=jax_roof.ICI_BW)
START_DONE = """\
HloModule m, is_scheduled=true

ENTRY %main (p: f32[64,64]) -> f32[64,64] {
  %p = f32[64,64]{1,0} parameter(0)
  %s = f32[64,64]{1,0} all-reduce-start(%p), to_apply=%add
  ROOT %d = f32[64,64]{1,0} all-reduce-done(%s)
}
"""


@pytest.fixture(scope="module")
def scan_hlo():
    """The optimized HLO text of a small jitted scan (a while loop with a
    known trip count around a dot) and its XLA cost analysis."""
    def step(c, w):
        return jnp.tanh(c @ w), None

    def f(c, ws):
        return jax.lax.scan(step, c, ws)[0]
    compiled = jax.jit(f).lower(jnp.ones((32, 64), jnp.float32),
                                jnp.ones((6, 64, 64), jnp.float32)).compile()
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    return compiled.as_text(), dict(cost)


@pytest.mark.parametrize("text", ["fixture", "start_done", "scan"])
def test_parse_hlo_equals_jax(text, scan_hlo):
    hlo = {"fixture": HLO, "start_done": START_DONE,
           "scan": scan_hlo[0]}[text]
    got = hlo_parse.parse_hlo(hlo)
    assert got == jax_hlo.parse_hlo(hlo)
    if text == "scan":
        assert got["dot_flops"] > 0


@pytest.mark.parametrize("text", ["fixture", "scan"])
def test_roofline_terms_equal_jax_at_its_peaks(text, scan_hlo):
    hlo, cost = (HLO, {"flops": 1.0, "bytes accessed": 1.0}) \
        if text == "fixture" else scan_hlo
    mf = 4 * 9 * 2 * 128 * 128 * 256
    for chips in (1, 4):
        got = roofline.roofline_from_hlo_text(hlo, chips, cost, mf, **TPU)
        assert got == jax_roof.roofline_from_hlo_text(hlo, chips, cost, mf)


def test_roofline_defaults_are_one_h100_without_a_link():
    stats = {"dot_flops": 2e12, "hbm_bytes": 1e9, "collective_bytes": 0,
             "collective_counts": {}}
    r = roofline.roofline_terms(stats, 1, {}, 1e12)
    assert r["compute_s"] == 2e12 / 989e12
    assert r["memory_s"] == 1e9 / 3.35e12
    assert r["collective_s"] == 0.0 and r["bottleneck"] == "compute_s"
    with pytest.raises(ValueError, match="link rate"):
        roofline.roofline_terms(dict(stats, collective_bytes=8), 1, {}, 1e12)


def test_model_flops_equal_jax_for_every_arch_and_shape():
    assert ASSIGNED == JAX_ASSIGNED
    for name in ASSIGNED:
        arch, jarch = get_arch(name), jax_get_arch(name)
        for shape, jshape in zip(arch.shapes, jarch.shapes):
            assert roofline.model_flops(arch, shape) == \
                jax_roof.model_flops(jarch, jshape), (name, shape.name)


def test_report_tables_equal_jax(scan_hlo):
    """The report's tables of the same records, ok and failed, tagged and
    not, on both meshes."""
    recs = []
    for i, (tag, mesh_name) in enumerate(itertools.product(
            ("", "final"), ("16x16", "2x16x16"))):
        roof = jax_roof.roofline_from_hlo_text(
            scan_hlo[0], 1 + i, scan_hlo[1], 1e9 * (i + 1))
        recs.append({"arch": f"a{i % 2}", "shape": "train_4k",
                     "mesh": mesh_name, "tag": tag, "compile_s": 1.5 + i,
                     "memory": {"argument_bytes": 2e9 * i,
                                "temp_bytes": None},
                     "roofline": roof, "ok": True})
    recs.append({"arch": "b", "shape": "x", "mesh": "16x16", "tag": "",
                 "ok": False, "error": "boom"})
    for tag in ("", "final"):
        assert report.dryrun_table(recs, tag) == \
            jax_report.dryrun_table(recs, tag)
        assert report.roofline_table(recs, tag) == \
            jax_report.roofline_table(recs, tag)
    assert report.perf_compare(recs, "a0", "train_4k", ["", "final"]) == \
        jax_report.perf_compare(recs, "a0", "train_4k", ["", "final"])
    for x in (None, 0.5, 3e-3, 2e-6, 12.0):
        assert report.fmt_s(x) == jax_report.fmt_s(x)
        assert report.fmt_bytes(x) == jax_report.fmt_bytes(x)


RULE_FLAGS = list(itertools.product((False, True), (False, True),
                                    (False, True), (False, True),
                                    ("tp", "dp")))


@pytest.mark.parametrize("multi_pod,fsdp,seq_shard,expert_parallel,layout",
                         RULE_FLAGS)
def test_make_rules_equal_jax(multi_pod, fsdp, seq_shard, expert_parallel,
                              layout):
    kw = dict(multi_pod=multi_pod, fsdp=fsdp, seq_shard=seq_shard,
              expert_parallel=expert_parallel, layout=layout)
    assert shd.make_rules(**kw) == jax_shd.make_rules(**kw)


def _spec_leaves(specs):
    return [s for s in jax.tree.leaves(specs, is_leaf=jax_shd.is_spec)]


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                          "2x16x16"])
@pytest.mark.parametrize("fsdp,layout", [(False, "tp"), (True, "tp"),
                                         (True, "dp")])
def test_pspec_equals_jax_on_the_production_meshes(multi_pod, fsdp, layout):
    """Every parameter spec of every arch, and every logical axis alone,
    with and without its shape, resolves as the JAX ``MeshEnv`` resolves it
    on an ``AbstractMesh`` of the production shape."""
    sizes = mesh.make_production_mesh(multi_pod=multi_pod)
    jenv = jax_shd.MeshEnv(
        mesh=jax.sharding.AbstractMesh(tuple(sizes.values()), tuple(sizes)),
        rules=jax_shd.make_rules(multi_pod=multi_pod, fsdp=fsdp,
                                 layout=layout))
    env = mesh.make_env(multi_pod=multi_pod, fsdp=fsdp, layout=layout)
    assert env.device == torch.device("meta") and env.mesh_shape == sizes
    for name in env.rules:
        assert env.axis_size(name) == jenv.axis_size(name), name
        assert env.pspec((name,)) == tuple(jenv.pspec((name,))), name
    n = 0
    for arch_name in ASSIGNED:
        for s in _spec_leaves(jax_model.param_specs(
                jax_get_arch(arch_name).model)):
            for shape in (None, s.shape):
                assert env.pspec(s.logical, shape) == tuple(
                    jenv.pspec(s.logical, shape)), (arch_name, s)
                n += 1
    assert n > 200


def test_described_envs_and_the_host_mesh():
    env = mesh.make_env(mesh={"data": 2, "model": 4}, seq_shard=False)
    assert env.rules == shd.make_rules(seq_shard=False)
    assert env.pspec(("batch", "seq", "heads"), (8, 128, 6)) == ("data",)
    assert env.pspec(("batch", None, "heads"), (8, 128, 8)) == (
        "data", None, "model")
    host = mesh.make_host_mesh(device="cpu")
    assert host.mesh_shape == {"data": 1, "model": 1}
    assert host.rules == shd.make_rules()
    with pytest.raises(NotImplementedError, match="host mesh needs 4"):
        mesh.make_host_mesh(1, 4, device="cpu")


SHAPES = (ShapeConfig("train", 32, 4, "train"),
          ShapeConfig("prefill", 32, 2, "prefill"),
          ShapeConfig("decode", 32, 2, "decode"))


def _reduced(name):
    return ArchConfig(model=get_arch(name).model.reduced(), shapes=SHAPES)


@pytest.mark.parametrize("name", ["yi-6b", "mamba2-130m"])
@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_dryrun_on_meta_counts_the_flops_of_a_cpu_run(name, kind):
    arch = _reduced(name)
    rec = dryrun.run_cell(arch, kind, verbose=False)
    assert rec["ok"] and rec["mesh"] == "1"
    assert rec["compile_s"] is None and rec["memory"]["temp_bytes"] is None
    assert rec["memory"]["generated_code_bytes"] is None
    assert rec["cost"]["bytes_accessed"] is None
    jarch = jax_get_arch(name).model.reduced()
    specs = jax_model.param_specs(jarch)
    assert rec["param_bytes_global"] == jax_shd.param_bytes(specs)
    # the same step on real CPU tensors counts the same FLOPs
    shape = {s.name: s for s in SHAPES}[kind]
    bundle = tmodel.make_step_bundle(
        arch, shape, mesh.make_host_mesh(device="cpu"))
    args = tmodel.init_inputs(bundle, torch.Generator().manual_seed(0),
                              "cpu")
    arg_bytes = dryrun.tensor_bytes(args)
    counter = FlopCounterMode(display=False)
    with counter:
        out = bundle.fn(*args)
    assert rec["cost"]["flops"] == counter.get_total_flops() > 0
    assert rec["memory"]["argument_bytes"] == arg_bytes
    assert rec["memory"]["output_bytes"] == dryrun.tensor_bytes(out)
    assert rec["memory"]["fits"]
    mf = roofline.model_flops(arch, shape)
    assert rec["model_flops"] == mf
    roof = rec["roofline"]
    assert roof["compute_s"] == rec["cost"]["flops"] / 989e12
    assert roof["memory_s"] == (arg_bytes + dryrun.tensor_bytes(out)) / 3.35e12
    assert roof["collective_s"] == 0.0 and roof["chips"] == 1
    assert roof["useful_flops_ratio"] == mf / rec["cost"]["flops"]


def test_dryrun_cli_writes_its_records(tmp_path):
    """The CLI on one full-size cell (nothing is allocated on ``meta``):
    Yi-6B's 2 x 4096 parameters' bytes, a record that the report reads."""
    out = tmp_path / "dry.json"
    recs = dryrun.main(["--arch", "yi-6b", "--shape", "prefill_32k",
                        "--out", str(out)])
    (rec,) = recs
    assert rec["ok"], rec
    assert rec["param_bytes_global"] == jax_shd.param_bytes(
        jax_model.param_specs(jax_get_arch("yi-6b").model))
    assert rec["memory"]["argument_bytes"] > rec["param_bytes_global"]
    assert "| yi-6b | prefill_32k | 1 |" in report.dryrun_table(recs, "")
    again = dryrun.main(["--arch", "yi-6b", "--shape", "prefill_32k",
                         "--out", str(out)])
    assert len(again) == 1                 # a cached cell is not rerun
    np.testing.assert_equal(again[0]["cost"], rec["cost"])
