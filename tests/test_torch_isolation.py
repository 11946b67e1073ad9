"""The port stands alone: importing every ``repro_torch`` module (and what
``chip_smoke.py`` imports) loads neither JAX nor the JAX package, and its
entry points need an explicit ``cpu`` to run without a card."""
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

MODULES = sorted(
    ".".join(p.relative_to(SRC).with_suffix("").parts).replace(
        ".__init__", "")
    for p in (SRC / "repro_torch").rglob("*.py"))


def test_port_imports_neither_jax_nor_reference_package():
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(SRC)!r})\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "importlib.import_module('chip_smoke')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert len(MODULES) > 30


def test_every_module_of_the_port_is_covered():
    """The modules the JAX package has are all in the port and among those
    the import test loads, context parallelism, analysis and the dry run
    included."""
    ref = sorted(
        ".".join(p.relative_to(SRC / "repro").with_suffix("").parts)
        .replace(".__init__", "") for p in (SRC / "repro").rglob("*.py"))
    port = {m.removeprefix("repro_torch.") for m in MODULES}
    assert [m for m in ref if m not in port] == []
    for m in ("models.context_parallel", "launch.dryrun",
              "analysis.hlo_parse", "analysis.roofline", "analysis.report"):
        assert f"repro_torch.{m}" in MODULES


def test_port_sources_never_name_jax_or_reference_imports():
    files = list((SRC / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), (f, line)
            assert not s.startswith(("import repro.", "from repro.",
                                     "from repro import")), (f, line)
            assert s != "import repro", (f, line)


def test_default_device_raises_without_cuda_and_cpu_runs():
    from repro_torch.device import resolve_device
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_refuse_the_missing_card():
    from repro_torch.configs.gptneo import GPTNEO_S
    from repro_torch.core.streaming import HostModel
    from repro_torch.launch import serve
    from repro_torch.serving.engine import ServingEngine
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from dataclasses import replace
    tiny = replace(GPTNEO_S, num_layers=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        HostModel.build(tiny, seq=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--models", "gptneo-s", "--layers", "1", "--seq", "8",
                    "--requests", "1"])


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    from repro_torch.kernels import ops, ref
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((7, 3)).astype(np.float32))
    torch.testing.assert_close(ops.matmul(a, b), ref.matmul_ref(a, b),
                               atol=0, rtol=0)
    q = torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(np.float32))
    torch.testing.assert_close(ops.attention(q, q, q),
                               ref.flash_attention_ref(q, q, q),
                               atol=0, rtol=0)
    x = torch.from_numpy(rng.standard_normal((1, 8, 2, 4)).astype(np.float32))
    dt = torch.from_numpy(rng.random((1, 8, 2)).astype(np.float32))
    bc = torch.from_numpy(rng.standard_normal((1, 8, 3)).astype(np.float32))
    a, d = -torch.ones(2), torch.ones(2)
    torch.testing.assert_close(ops.ssd(x, dt, a, bc, bc, d, chunk=4),
                               ref.ssd_ref(x, dt, a, bc, bc, d),
                               atol=0, rtol=0)
    assert torch.equal(ops.pack(a[None]), ref.layout_pack_ref(a[None]))
    names = ("streamed_matmul", "flash_attention", "flash_attention_bwd",
             "ssd_scan", "ssd_scan_bwd", "layout_pack")
    assert ops.launch_counts() == {n: 0 for n in names}
    assert ops.launch_counts_by_shape() == {n: {} for n in names}


def test_kernel_wrappers_raise_on_cpu_tensors():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.streamed_matmul import streamed_matmul
    a = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        streamed_matmul(a, a)
    q = torch.zeros((1, 4, 1, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
    lse = torch.zeros((1, 1, 4))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(q, q, q, q, lse, q)
    from repro_torch.kernels.layout_pack import layout_pack
    from repro_torch.kernels.ssd_scan import ssd_scan
    h = torch.zeros(1)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(q, q[..., 0], h, q[:, :, 0], q[:, :, 0], h)
    from repro_torch.kernels.ssd_scan_bwd import ssd_scan_bwd
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_bwd(q, q, q[..., 0], h, q[:, :, 0], q[:, :, 0], h, q, None)
    with pytest.raises(ValueError, match="CUDA"):
        layout_pack(a)


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
