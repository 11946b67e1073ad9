"""Two versions of ``flash_attention_bwd.cu`` in turns, on the card.

    python3 tools/flash_attention_bwd_compare.py OLD.cu NEW.cu

Builds both sources (each with the C interface of
``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``, with or without
its query offset ``q_base``, which a source without it cannot take) and,
at every key of ``chip_smoke.BWD_KEYS`` (the training paths' keys, a
window and an f32 case, the four cp shard keys of phase 7f(d) and two
keys at an offset), on inputs made from a seed with the forward's ``o``
and ``lse``:

* holds each version's dq, dk and dv against ``flash_attention_bwd.plain``
  (autograd of the plain version in f32) with the smoke's bounds: bf16
  within ``BWD_BF16_REL_L2`` relative L2 and ``BWD_BF16_MAX`` max|ref|,
  f32 within ``BWD_F32_MAX`` max|ref|; and each version against itself
  over two runs, bit for bit;
* prints whether the two versions' outputs are bit-equal, and for the f32
  key the SHA-256 of each version's dq, dk and dv bytes;
* times each version's device time (CUDA events around 5 back-to-back
  calls, median of 3 rounds) in the order old, new, new, old, twice, and
  prints the medians, their ratio, the share of the key's tensor-core or
  FMA bound and the factor against the backward of SDPA (timed in the
  same call, ``chip_smoke.sdpa_backward``).

At a nonzero offset a version without ``q_base`` is skipped: only the
other is checked and timed (new, new, twice).

``--digests`` prints, at ``tests/test_torch_cuda.py::FA_BWD_CASES`` in
f32, the SHA-256 of each version's outputs on the inputs of that file's
``test_flash_attention_bwd_kernel`` (``FA_BWD_F32_SHA256`` records the
parent's).

Needs one NVIDIA card and ``nvcc``; builds into ``build/fa_bwd_compare/``.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import sys
from pathlib import Path

import numpy as np
import torch

from ssd_scan_ablation import ROOT, build, smi

sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
import chip_smoke as cs  # noqa: E402
from test_torch_cuda import FA_BWD_CASES, _bwd_inputs  # noqa: E402

from repro_torch.kernels import flash_attention_bwd as fab  # noqa: E402
from repro_torch.kernels.flash_attention import forward_with_lse  # noqa: E402

OUT = ROOT / "build" / "fa_bwd_compare"
CALLS, ROUNDS = 5, 3


def entry(lib: Path, source: str):
    """(the entry point, whether it takes the query offset after the
    window)."""
    takes_off = "int q_base" in source
    types = list(fab._ARGTYPES)   # 10 pointers, 9 ints (q_base the last)
    if not takes_off:
        del types[18]
    fn = ctypes.CDLL(str(lib)).fm_flash_attention_bwd
    fn.argtypes = types
    fn.restype = ctypes.c_int
    return fn, takes_off


def launch(fn, q, k, v, o, lse, do, causal, window, q_off=0):
    """dq, dk, dv of one call of the entry point ``fn``."""
    fn, takes_off = fn
    if q_off and not takes_off:
        raise ValueError("this version takes no query offset")
    b, sq, hq, hd = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dsum = torch.empty_like(lse)
    off = (q_off,) if takes_off else ()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), b, sq, k.shape[1], hq, k.shape[2],
             hd, int(causal), int(window), *off, 1.0 / math.sqrt(hd),
             fab._DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd: CUDA error {err}")
    return dq, dk, dv


def digest(outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def check(got, want, dtype, what) -> float:
    """The largest relative L2 error of dq, dk, dv; raises past a bound."""
    worst = 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g = g.float()
        scale = w.abs().max().item()
        err = (g - w).abs().max().item()
        rel = ((g - w).norm() / w.norm()).item()
        ok = err <= cs.BWD_F32_MAX * scale if dtype == torch.float32 else \
            err <= cs.BWD_BF16_MAX * scale and rel <= cs.BWD_BF16_REL_L2
        if not (ok and math.isfinite(err)):
            raise AssertionError(f"{what} {name}: max abs {err:.3e} (max "
                                 f"|ref| {scale:.3e}), relative L2 "
                                 f"{rel:.3e}")
        worst = max(worst, rel)
    return worst


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


def digests(fns, dev) -> None:
    """The f32 outputs' SHA-256 at FA_BWD_CASES on the inputs of
    ``test_flash_attention_bwd_kernel``."""
    for case in FA_BWD_CASES:
        b, sq, sk, hq, hkv, hd, causal, window = case
        rng = np.random.default_rng(7 * sq + sk + hd)
        q, k, v, do = _bwd_inputs(rng, b, sq, sk, hq, hkv, hd, torch.float32,
                                  dev)
        o, lse = forward_with_lse(q, k, v, causal=causal, window=window)
        for name, fn in fns.items():
            print(f"[f32-digest] {case} {name}: "
                  f"{digest(launch(fn, q, k, v, o, lse, do, causal, window))}",
                  flush=True)


def main(argv) -> int:
    want_digests = "--digests" in argv
    argv = [a for a in argv if a != "--digests"]
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("flash_attention_bwd_compare: needs an NVIDIA card",
              file=sys.stderr)
        return 2
    line = smi()
    print(f"[device] {line}", flush=True)
    peaks = cs.card_peaks(line)
    sources = {name: Path(path).read_text()
               for name, path in zip(("old", "new"), argv)}
    fns = {name: entry(lib, sources[name])
           for name, lib in build(sources, OUT).items()}
    dev = torch.device("cuda:0")
    if want_digests:
        digests(fns, dev)
    for key in cs.BWD_KEYS:
        b, sq, sk, hq, hkv, hd, causal, window, q_off, dt = key
        gen = torch.Generator(device="cpu").manual_seed(sq + sk + hq + hd
                                                        + q_off)
        q, k, v, do = (torch.randn(s, generator=gen).to(dev, dt)
                       for s in ((b, sq, hq, hd), (b, sk, hkv, hd),
                                 (b, sk, hkv, hd), (b, sq, hq, hd)))
        o, lse = forward_with_lse(q, k, v, causal=causal, window=window,
                                  q_offset=q_off)
        want = fab.plain(q, k, v, do, causal=causal, window=window,
                         q_offset=q_off)
        label = f"{(b, sq, sk, hq, hkv, hd)} causal={causal} " \
            f"window={window} q_offset={q_off} {dt}"
        here = {n: fn for n, fn in fns.items() if fn[1] or not q_off}
        outs = {}
        for name, fn in here.items():
            got = launch(fn, q, k, v, o, lse, do, causal, window, q_off)
            again = launch(fn, q, k, v, o, lse, do, causal, window, q_off)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"{name} at {label}: two runs differ")
            rel = check(got, want, dt, f"{name} at {label}")
            outs[name] = got
            print(f"[{label}] {name}: worst relative L2 {rel:.3e}; two runs "
                  f"bit-equal", flush=True)
        if len(outs) == 2:
            same = all(torch.equal(x, y) for x, y in zip(outs["old"],
                                                         outs["new"]))
            print(f"[{label}] old and new outputs bit-equal: {same}",
                  flush=True)
        else:
            print(f"[{label}] only {list(outs)} takes the offset", flush=True)
        if dt == torch.float32:
            for name in outs:
                print(f"[{label}] {name} sha256 {digest(outs[name])}",
                      flush=True)
        del outs, want
        times = {name: [] for name in here}
        for rnd in range(2):
            for name in ("old", "new", "new", "old"):
                if name not in here:
                    continue
                ms = device_ms(lambda: launch(here[name], q, k, v, o, lse, do,
                                              causal, window, q_off))
                times[name].append(ms)
                print(f"[{label}] round {rnd} {name}: {ms:.4f} ms",
                      flush=True)
        lib_ms = device_ms(cs.sdpa_backward(q, k, v, do, causal, window,
                                            q_off))
        med = {n: float(np.median(t)) for n, t in times.items()}
        bms, bby = cs.bound_ms(*cs.bwd_work(key), peaks, dt)
        print(f"[{label}] " + ", ".join(
            f"median {n} {ms:.4f} ms ({bms / ms:.2%} of the bound, "
            f"{ms / lib_ms:.2f}x SDPA's backward)" for n, ms in med.items())
            + (f", new / old {med['new'] / med['old']:.4f}"
               if len(med) == 2 else "")
            + f"; bound {bms:.4f} ms ({bby}); SDPA backward {lib_ms:.4f} ms",
            flush=True)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
