"""Where the time of ssd_scan's output pass goes, by ablation, on the card.

    python3 tools/ssd_scan_ablation.py

Builds ``src/repro_torch/kernels/csrc/ssd_scan.cu`` as it is and in copies
with one piece of ``chunk_out_kernel`` taken out (the textual cuts below),
then times every CUDA kernel of one ``ssd_scan`` call at the Mamba-2-130M
prefill shape (4 x 4096 tokens, 24 heads of 64, d_state 128, chunk 256)
with each build, in turns, by profiler kernel name (20 calls, two rounds).
A cut build computes wrong values: it is for timing only, and only the
unchanged build is held against ``models.ssm.ssd_chunked``. Needs one
NVIDIA card and ``nvcc``; builds into ``build/ssd_ablation/``.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models.ssm import ssd_chunked  # noqa: E402

SHAPE = (4, 4096, 24, 64, 128)
CHUNK = 256
CALLS = 20
OUT = ROOT / "build" / "ssd_ablation"

# the pieces of chunk_out_kernel a build goes without
LOADS = ("    load(t + 2);\n", "")
SCALE = ("    if (factored && t >= n1 && jt < i0) {", "    if (false) {")
FORM = ("const bool form = tn >= n1 && tn < nsteps && (jn >= i0 || !factored);",
        "const bool form = false;")
PROLOGUE = [
    ("lh[e] = h < H && i < Q ? args.lw[((long long)bi * H + h) * S + t0 + i]"
     "\n                           : 0.f;", "lh[e] = -0.01f * i;"),
    ("\n        in ? args.dt[bi * args.sdb + (t0 + i) * args.sds + h * "
     "args.sdh]\n           : 0.f;", " 0.5f;"),
    ("          const float4 f = *reinterpret_cast<const float4*>(src);",
     "          const float4 f = make_float4(n, r, 1.f, 2.f);")]
CUTS = {"as it is": [],
        "no copies after the first two steps": [LOADS],
        "no scaling of X left of the diagonal": [SCALE],
        "no scaling of X, no M": [SCALE, FORM],
        "FMAs, barriers and stores only": [LOADS, SCALE, FORM, *PROLOGUE]}


def cut(src: str, pieces) -> str:
    for old, new in pieces:
        if src.count(old) != 1:
            raise ValueError(f"the cut no longer matches ssd_scan.cu: {old!r}")
        src = src.replace(old, new)
    return src


def build(sources: dict, out: Path = OUT) -> dict:
    """{name: shared library path} of {name: CUDA source text}, one nvcc
    per build, in parallel, into ``out``."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu, lib = out / f"v{i}.cu", out / f"v{i}.so"
        cu.write_text(text)
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        print(f"[build] {name}: registers per entry {regs}", flush=True)
        libs[name] = lib
    return libs


def load(path: Path):
    lib = ctypes.CDLL(str(path))
    lib.fm_ssd_scan.argtypes = ssd._ARGTYPES
    lib.fm_ssd_scan.restype = ctypes.c_int
    lib.fm_ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.fm_ssd_scan_smem_bytes.restype = ctypes.c_longlong
    return lib


def inputs(dev):
    """The Mamba-2-130M prefill shape's operands as the model hands them
    over (seed 0), and ``models.ssm.ssd_chunked``'s y on them."""
    gen = torch.Generator().manual_seed(0)
    b, s, h, p, n = SHAPE
    xbc = torch.randn(b, s, h * p + 2 * n, generator=gen).to(dev)
    ins = (xbc[..., :h * p].reshape(b, s, h, p),
           torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen))
           .to(dev), -torch.exp(0.5 * torch.randn(h, generator=gen)).to(dev),
           xbc[..., h * p:h * p + n], xbc[..., h * p + n:],
           torch.randn(h, generator=gen).to(dev))
    return ins, ssd_chunked(*ins, CHUNK)[0]


def time_build(path: Path, ins, want=None) -> dict:
    """Device ms per call of each CUDA kernel of ``ssd_scan`` built into
    ``path``, by profiler name (3 untimed calls, then ``CALLS``); with
    ``want``, first holds y against it within 1e-4 of its scale."""
    lib = load(path)
    ssd._lib = lambda lib=lib: lib
    got = ssd.ssd_scan(*ins, chunk=CHUNK)
    torch.cuda.synchronize()
    if want is not None:
        err = (got - want).abs().max().item()
        tol = 1e-4 * want.abs().max().item()
        if not err <= tol:
            raise AssertionError(f"ssd_scan vs ssd_chunked: {err}")
    for _ in range(3):
        ssd.ssd_scan(*ins, chunk=CHUNK)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            ssd.ssd_scan(*ins, chunk=CHUNK)
        torch.cuda.synchronize()
    return {re.sub(r"\(anonymous namespace\)::|void |\(.*|<.*", "",
                   ev.key): round(ev.self_device_time_total / CALLS / 1e3, 4)
            for ev in prof.key_averages()
            if getattr(ev, "self_device_time_total", 0) > 0}


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_scan_ablation: needs an NVIDIA card", file=sys.stderr)
        return 2
    print(f"[device] {smi()}", flush=True)
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    libs = build({name: cut(src, pieces) for name, pieces in CUTS.items()})
    ins, want = inputs(torch.device("cuda:0"))
    for rnd in range(2):
        for name, path in libs.items():
            per = time_build(path, ins, want if name == "as it is" else None)
            print(f"[round {rnd}] {name}: device ms per call {per}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
