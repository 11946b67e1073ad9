"""Two versions of the MoE combine (``_combine_group`` of two copies of
``src/repro_torch/models/moe.py``) on one card, in turns.

    python3 tools/moe_combine_compare.py OLD_moe.py NEW_moe.py

Inputs are Qwen3-30B-A3B's (128 experts top-8, d_model 2048, capacity
factor 1.25), made on the card from seed 0: a random router over random
bf16 tokens gives the routes, NEW's ``_dispatch_group`` the slot map and
gates, random bf16 rows the expert outputs. Two shapes: a prefill of
2 x 4096 tokens (320 slots an expert a row) and a decode step at batch 8
(8 slots). Both versions must give bit-equal outputs. Each is then timed
in turns, OLD NEW NEW OLD twice: device time (CUDA events around 20
back-to-back calls, median of 5 rounds), one call with its host dispatch
(``chip_smoke.call_ms``) and the peak of the memory the call allocates
beyond its inputs. Prints each reading and one JSON line of medians.
Needs one NVIDIA card. An older version comes from git as a file first,
e.g. ``git show REV:src/repro_torch/models/moe.py > build/moe_old.py``.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs(mod, cfg, b: int, s: int, gen, dev):
    """(args of ``_combine_group``) for b x s tokens of ``cfg``."""
    m, d = cfg.moe, cfg.d_model
    c = mod.capacity(s, m.n_experts, m.top_k, m.capacity_factor)
    x = torch.randn((b, s, d), generator=gen, device=dev).to(torch.bfloat16)
    router = torch.randn((d, m.n_experts), generator=gen, device=dev) * 0.02
    w, ids, _ = mod._router(cfg, {"router": router}, x.reshape(b * s, d))
    _, idx, gate, _ = mod._dispatch_group(
        m, s, c, d, x, w.view(b, s, m.top_k), ids.view(b, s, m.top_k))
    ye = torch.randn((m.n_experts, b * c, d), generator=gen,
                     device=dev).to(torch.bfloat16)
    return (m, s, c, d, ye, idx, gate)


def peak_bytes(fn) -> int:
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def main(old_path: str, new_path: str) -> int:
    if not torch.cuda.is_available():
        print("moe_combine_compare: needs one CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_arch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    mods = {"old": load(old_path, "moe_old"),
            "new": load(new_path, "moe_new")}
    cfg = get_arch(cs.MOE).model
    dev = torch.device("cuda:0")
    out = {}
    for label, (b, s) in (("prefill 2 x 4096", (2, 4096)),
                          ("decode 8 x 1", (8, 1))):
        gen = torch.Generator(device=dev).manual_seed(0)
        args = inputs(mods["new"], cfg, b, s, gen, dev)
        ys = {k: mod._combine_group(*args) for k, mod in mods.items()}
        cs.check(torch.equal(cs.bits(ys["old"]), cs.bits(ys["new"])),
                 f"{label}: the two combines differ")
        del ys
        reads = {k: {"device_ms": [], "call_ms": [], "peak_mb": []}
                 for k in mods}
        for k in ("old", "new", "new", "old") * 2:
            fn = (lambda mod: lambda: mod._combine_group(*args))(mods[k])
            reads[k]["device_ms"].append(cs.device_ms(fn))
            reads[k]["call_ms"].append(cs.call_ms(fn))
            reads[k]["peak_mb"].append(peak_bytes(fn) / 1e6)
        med = {k: {q: float(np.median(v)) for q, v in r.items()}
               for k, r in reads.items()}
        cs.log(f"[combine] {smi}: {label} (capacity {args[2]}): bit-equal; "
               + "; ".join(f"{k}: device " + ", ".join(
                   f"{t:.4f}" for t in r["device_ms"]) + " ms, one call "
                   + ", ".join(f"{t:.4f}" for t in r["call_ms"])
                   + f" ms, peak {r['peak_mb'][0]:.1f} MB"
                   for k, r in reads.items())
               + "; new/old " + ", ".join(
                   f"{q} {med['new'][q] / med['old'][q]:.3f}x"
                   for q in ("device_ms", "call_ms")))
        out[label] = med
    print(json.dumps({"card": smi, "medians": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
