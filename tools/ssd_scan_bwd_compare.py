"""Two versions of ``ssd_scan_bwd.cu`` in turns, on the card.

    python3 tools/ssd_scan_bwd_compare.py OLD.cu NEW.cu

Builds both sources and, at the Mamba-2 training key (2, 4096, 24, 64,
128, 256) and Jamba's (2, 4096, 128, 64, 16, 256), each with and without
``swing`` (dt a of both signs in a chunk), on the inputs of
``chip_smoke.ssd_bwd_inputs`` and the forward kernel's workspace:

* holds each version's six gradients against ``ssd_scan_bwd.plain``
  (autograd of the plain passes in f32) with the smoke's bound, each
  within ``BWD_F32_MAX`` of its largest element, and each version against
  itself over two runs, bit for bit;
* times each version's device time (CUDA events around 5 back-to-back
  calls, median of 3 rounds) in the order old, new, new, old, twice, and
  prints the medians, their ratio and the share of each bound: the
  3xTF32 bound (three times the work at the TF32 tensor-core rate, half
  the bf16 one) and the FMA bound (the work at the f32 rate outside the
  tensor cores); then one call of each by kernel name (the profiler).

A source is called through the C interface it declares: the seven-kernel
one (no head groups) or the one with ``int hg`` and the group parts.
Needs one NVIDIA card and ``nvcc``; builds into
``build/ssd_bwd_compare/``. The chip copy has no ``.git``: put the
parent's source under ``build/`` first, e.g. ``git show
HEAD:src/repro_torch/kernels/csrc/ssd_scan_bwd.cu >
build/ssd_bwd_parent.cu``.
"""
from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import numpy as np
import torch

from ssd_scan_ablation import ROOT, build, smi

sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

from repro_torch.kernels import ssd_scan_bwd as sbw  # noqa: E402
from repro_torch.kernels.ssd_scan import TILE, ssd_scan_saving  # noqa: E402

OUT = ROOT / "build" / "ssd_bwd_compare"
CALLS, ROUNDS = 5, 3
KEYS = ((2, 4096, 24, 64, 128, 256), (2, 4096, 128, 64, 16, 256))
NAMES = ("dx", "ddt", "da", "db", "dc", "dd")


def entry(lib: Path, grouped: bool):
    """The library's entry point, typed by its interface."""
    fn = ctypes.CDLL(str(lib)).fm_ssd_scan_bwd
    fn.argtypes = sbw._ARGTYPES if grouped else \
        [ctypes.c_void_p] * 23 + [ctypes.c_int] * 7 + \
        [ctypes.c_longlong] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def caller(fn, grouped: bool, dy, ins, y, saved):
    """A function of no arguments that launches ``fn`` once on these
    inputs and returns the six gradients (x, b and c as the model hands
    them over: 16-byte aligned rows)."""
    x, dt, a, b, c, d = ins
    bsz, s, h, p = x.shape
    n, q = b.shape[-1], saved[0].shape[-1]
    nc, q64 = s // q, -(-q // TILE) * TILE
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    if grouped:
        ws = sbw.workspace(bsz, s, h, p, n, q, dev)
        ints = (bsz, s, h, p, n, q, q64, sbw.head_group(h))
    else:
        ws = (torch.empty((bsz, h, nc, n, p), **f32),
              torch.empty((bsz, nc, q64, q64), **f32),
              torch.empty((bsz, h, s), **f32), torch.empty((bsz, h, s), **f32),
              torch.empty((bsz, h, nc, 2), **f32))
        ints = (bsz, s, h, p, n, q, q64)
    saved = tuple(t.contiguous() for t in saved)

    def run():
        grads = (torch.empty((bsz, s, h, p), **f32),
                 torch.empty((bsz, s, h), **f32), torch.empty((h,), **f32),
                 torch.empty((bsz, s, n), **f32),
                 torch.empty((bsz, s, n), **f32), torch.empty((h,), **f32))
        err = fn(*(t.data_ptr() for t in (x, dt, a, b, c, d, dy, y, *saved,
                                          *grads, *ws)),
                 *ints, *x.stride()[:3], *dt.stride(), *b.stride()[:2],
                 *c.stride()[:2], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"ssd_scan_bwd: CUDA error {err}")
        return grads
    return run


def device_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(ROUNDS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / CALLS)
    return float(np.median(times))


def compare(sources: dict) -> dict:
    """Build {name: CUDA source text}, check and time every version in
    turns (the order of ``sources``, then back) at ``KEYS``, with and
    without swing. Returns {(key, swing): {name: median device ms}}."""
    line = smi()
    print(f"[device] {line}", flush=True)
    peaks = cs.card_peaks(line)
    libs = build(sources, OUT)
    grouped = {name: "int hg" in text for name, text in sources.items()}
    fns = {name: entry(lib, grouped[name]) for name, lib in libs.items()}
    order = list(sources) + list(reversed(sources))
    result = {}
    for key in KEYS:
        for swing in (False, True):
            dy, *ins = cs.ssd_bwd_inputs(key, swing)
            y, saved = ssd_scan_saving(*ins, chunk=key[5])
            ins = [sbw._rows16(t) if i in (0, 3, 4) else t
                   for i, t in enumerate(ins)]
            want = sbw.plain(dy, *ins, chunk=key[5])
            label = f"{key}" + (" swing" if swing else "")
            runs = {}
            for name, fn in fns.items():
                runs[name] = caller(fn, grouped[name], dy, ins, y, saved)
                got, again = runs[name](), runs[name]()
                torch.cuda.synchronize()
                if not all(torch.equal(u, v) for u, v in zip(got, again)):
                    raise AssertionError(f"{name} at {label}: two runs "
                                         f"differ")
                errs = []
                for gname, g, w in zip(NAMES, got, want):
                    scale = w.abs().max().item()
                    err = (g - w).abs().max().item()
                    if not (bool(torch.isfinite(g).all())
                            and err <= cs.BWD_F32_MAX * scale):
                        raise AssertionError(
                            f"{name} at {label} {gname}: max abs {err:.3e} "
                            f"(max |ref| {scale:.3e})")
                    errs.append(f"{gname} {err / scale:.3e}")
                print(f"[{label}] {name}: max abs / max |ref| "
                      + ", ".join(errs) + "; two runs bit-equal", flush=True)
                del got, again
            del want
            times = {name: [] for name in fns}
            for rnd in range(2):
                for name in order:
                    ms = device_ms(runs[name])
                    times[name].append(ms)
                    print(f"[{label}] round {rnd} {name}: {ms:.4f} ms",
                          flush=True)
            flops, nbytes = cs.ssd_bwd_work(key)
            fma_ms, fma_by = cs.bound_ms(flops, nbytes, peaks)
            tc_ms, tc_by = cs.ssd_bwd_tc_bound_ms(flops, nbytes, peaks)
            med = {name: float(np.median(t)) for name, t in times.items()}
            first = med[order[0]]
            print(f"[{label}] medians: " + ", ".join(
                f"{name} {ms:.4f} ms ({ms / first:.4f}x {order[0]}; "
                f"{tc_ms / ms:.2%} of the {tc_ms:.4f} ms 3xTF32 bound "
                f"({tc_by}), {fma_ms / ms:.2%} of the {fma_ms:.4f} ms FMA "
                f"bound ({fma_by}))" for name, ms in med.items()), flush=True)
            for name in fns:
                expect = 9 if grouped[name] else 7
                by = cs.traced_kernels_ms(runs[name], cs.SSD_BWD_NAMES, expect)
                print(f"[{label}] {name} by kernel: " + (", ".join(
                    f"{k} {v:.3f} ms" for k, v in by.most_common())
                    or "not measured (the trace lost them)"), flush=True)
            result[(key, swing)] = med
            del dy, ins, y, saved, runs
            torch.cuda.empty_cache()
    return result


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ssd_scan_bwd_compare: needs an NVIDIA card", file=sys.stderr)
        return 2
    sources = {name: Path(path).read_text()
               for name, path in zip(("old", "new"), argv)}
    compare(sources)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
