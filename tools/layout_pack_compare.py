"""Cold-L2 device time of two versions of ``layout_pack.cu``, in turns, on
the card.

    python3 tools/layout_pack_compare.py OLD.cu NEW.cu

Builds both sources into ``build/pack_compare/``. Each keeps the C entry
point ``fm_layout_pack``, either with the parent's arguments (w, out, R,
C, tr, tc, itemsize, stream) or with ``pack_plan``'s path and grid after
the itemsize (read from the source). Holds each build bit-exact against
``kernels.ref.layout_pack_ref`` at every shape of ``chip_smoke.py``'s pack
pass (the six weights of a GPT-Neo-1.3B layer, f32 and bf16) and at its
boundary sweep, then times each pass shape's cold device time
(``chip_smoke.kernel_device_ms``: the profiler's time of the pack
kernel, each call after a 256 MiB flush, median of 20) in the order old,
new, new, old, twice, and prints each shape's and the whole pass's new /
old with the card's name and power limit. Needs one NVIDIA card and
``nvcc``; the parent's source comes from ``git show`` into a gitignored
path first, since the chip's copy has no ``.git``.
"""
from __future__ import annotations

import ctypes
import re
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from ssd_scan_ablation import ROOT, build, smi

sys.path.insert(0, str(ROOT))
from chip_smoke import bits, kernel_device_ms, pack_input  # noqa: E402

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.layout_pack import (  # noqa: E402
    native_tile, pack_plan)

OUT = ROOT / "build" / "pack_compare"
# the pack pass: (R, C) -> launches, in f32 and bf16 (GPT-Neo-1.3B layer 0:
# wq, wk, wv, wo; ffn_in; ffn_out)
PASS = Counter({(2048, 2048): 4, (2048, 8192): 1, (8192, 2048): 1})
DTYPES = (torch.float32, torch.bfloat16)
# chip_smoke.py phase 3's boundary sweep: (R, C), dtype, tile, skew bytes
BOUNDARY = [((70, 256), torch.float32, None, 0),
            ((33, 129), torch.float32, None, 0),
            ((33, 129), torch.bfloat16, None, 0),
            ((64, 96), torch.float32, (8, 64), 0),
            ((48, 96), torch.float32, (5, 12), 0),
            ((40, 256), torch.uint8, None, 0),
            ((40, 256), torch.int64, None, 0),
            ((64, 256), torch.float32, None, 4)]


def entry(lib: Path, source: str):
    """A call ``(w, out, tile)`` of the build's ``fm_layout_pack`` with the
    arguments its source takes."""
    params = re.search(r'extern "C" int fm_layout_pack\(([^)]*)\)',
                       source).group(1)
    planned = "blocks" in params
    fn = ctypes.CDLL(str(lib)).fm_layout_pack
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * (
        8 if planned else 5) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(w, out, tile):
        (r, c), (tr, tc), size = w.shape, tile, w.dtype.itemsize
        extra = ()
        if planned:
            plan = pack_plan(r, c, tr, tc, size, w.data_ptr(),
                             out.data_ptr())
            extra = (int(plan.path == "vector"), plan.blocks, plan.threads)
        err = fn(w.data_ptr(), out.data_ptr(), r, c, tr, tc, size, *extra,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"layout_pack: CUDA error {err}")
    return call


def packed(call, w, tile):
    r, c = w.shape
    out = torch.empty((-(-r // tile[0]), -(-c // tile[1]), *tile),
                      dtype=w.dtype, device=w.device)
    call(w, out, tile)
    return out


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("layout_pack_compare: needs an NVIDIA card", file=sys.stderr)
        return 2
    card = smi()
    print(f"[device] {card}", flush=True)
    sources = {name: Path(path).read_text()
               for name, path in zip(("old", "new"), argv)}
    calls = {name: entry(lib, sources[name])
             for name, lib in build(sources, OUT).items()}
    dev = torch.device("cuda:0")
    gen = torch.Generator(device="cpu").manual_seed(0)
    cases = [(shape, dt, None, 0) for shape in PASS for dt in DTYPES]
    for (r, c), dt, tile, skew in cases + BOUNDARY:
        w = pack_input(r, c, dt, skew, gen, dev)
        tile = tile or native_tile(dt)
        want = ref.layout_pack_ref(w, tile)
        for name, call in calls.items():
            got = packed(call, w, tile)
            torch.cuda.synchronize()
            if not torch.equal(bits(got), bits(want)):
                raise AssertionError(f"{name} at {(r, c)} {dt} tile {tile} "
                                     f"skew {skew}: not bit-exact")
    print(f"[check] both builds bit-exact at {len(cases)} pass shapes and "
          f"{len(BOUNDARY)} boundary cases", flush=True)
    total = {"old": 0.0, "new": 0.0}
    for (r, c), dt, _, _ in cases:
        w = pack_input(r, c, dt, 0, gen, dev)
        tile = native_tile(dt)
        nbytes = dt.itemsize * 2 * r * c
        times = {"old": [], "new": []}
        for rnd in range(2):
            for name in ("old", "new", "new", "old"):
                ms = kernel_device_ms(
                    lambda: packed(calls[name], w, tile), cold=True)
                times[name].append(ms)
                print(f"[({r}, {c}) {dt}] round {rnd} {name}: {ms:.4f} ms "
                      f"cold, {nbytes / ms / 1e6:.0f} GB/s", flush=True)
        old, new = (float(np.median(times[n])) for n in ("old", "new"))
        for n, t in (("old", old), ("new", new)):
            total[n] += PASS[(r, c)] * t
        print(f"[({r}, {c}) {dt}] median old {old:.4f} ms, new {new:.4f} "
              f"ms, new / old {new / old:.4f}", flush=True)
        del w
    print(f"[pass] {sum(PASS.values()) * len(DTYPES)} launches, cold device "
          f"time: old {total['old']:.4f} ms, new {total['new']:.4f} ms, "
          f"new / old {total['new'] / total['old']:.4f} ({card})",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
