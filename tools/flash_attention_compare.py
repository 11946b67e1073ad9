"""Device time of two versions of ``flash_attention.cu``, in turns, on the card.

    python3 tools/flash_attention_compare.py OLD.cu NEW.cu

Builds both sources (each with the C interface of
``src/repro_torch/kernels/csrc/flash_attention.cu``, with or without its
``lse`` pointer, which is passed null: the forward alone, and with or
without its ``q_off``, which is passed 0), holds each against
``kernels.ref.flash_attention_ref`` at the shapes below (f32 within 2e-5;
bf16 within 2e-2, one bf16 ulp above a 1e-3 floor and 1e-2 relative L2)
and times each shape's device time (CUDA events around 20 back-to-back
calls, median of 5 rounds) in the order old, new, new, old, twice, and
prints whether the two give the same output bits:

* the Yi-6B prefill, (2, 4096, 4096, 32, 4, 128), causal, bf16;
* Whisper-small's three keys in bf16: the encoder (8, 1500, 1500, 12, 12,
  64) bidirectional, cross-attention (8, 448, 1500, ...) and the decoder's
  causal self-attention (8, 448, 448, ...);
* the serving path, GPT-Neo-1.3B (1, 1024, 1024, 16, 16, 128) and
  GPT-Neo-S (1, 1024, 1024, 12, 12, 64), causal, f32.

Needs one NVIDIA card and ``nvcc``; builds into ``build/fa_compare/``.
"""
from __future__ import annotations

import ctypes
import math
import sys
from pathlib import Path

import numpy as np
import torch

from ssd_scan_ablation import ROOT, build, smi

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import _ARGTYPES, _DTYPES

OUT = ROOT / "build" / "fa_compare"
# (B, Sq, Sk, Hq, Hkv, hd, causal, dtype)
SHAPES = {"yi-6b prefill": (2, 4096, 4096, 32, 4, 128, True, torch.bfloat16),
          "whisper encoder": (8, 1500, 1500, 12, 12, 64, False,
                              torch.bfloat16),
          "whisper cross": (8, 448, 1500, 12, 12, 64, False, torch.bfloat16),
          "whisper self": (8, 448, 448, 12, 12, 64, True, torch.bfloat16),
          "gptneo-1.3b": (1, 1024, 1024, 16, 16, 128, True, torch.float32),
          "gptneo-s": (1, 1024, 1024, 12, 12, 64, True, torch.float32)}
CALLS, ROUNDS = 20, 5


def entry(lib: Path, source: str):
    """(entry point, whether it takes the lse pointer after o, whether it
    takes the query offset after the window)."""
    takes_lse = "void* lse" in source
    takes_off = "int q_off" in source
    types = list(_ARGTYPES)       # 5 pointers, 9 ints (q_off the last)
    if not takes_off:
        del types[13]
    if not takes_lse:
        del types[4]
    fn = ctypes.CDLL(str(lib)).fm_flash_attention
    fn.argtypes = types
    fn.restype = ctypes.c_int
    return fn, takes_lse, takes_off


def launch(fn, q, k, v, o, causal):
    fn, takes_lse, takes_off = fn
    b, sq, hq, hd = q.shape
    lse = (0,) if takes_lse else ()
    off = (0,) if takes_off else ()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *lse, b,
             sq, k.shape[1], hq, k.shape[2], hd, int(causal), 0, *off,
             1.0 / math.sqrt(hd), _DTYPES[q.dtype],
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention: CUDA error {err}")


def check_numbers(got, want):
    """(max abs error, the largest error over its one-bf16-ulp limit
    1e-3 + 2^-7 |want|, relative L2 error)."""
    g, w = got.float(), want.float()
    return ((g - w).abs().max().item(),
            ((g - w).abs() / (1e-3 + 2 ** -7 * w.abs())).max().item(),
            ((g - w).norm() / w.norm()).item())


def check(got, want, dtype, what):
    err, ulp, rel = check_numbers(got, want)
    ok = err <= 2e-5 if dtype == torch.float32 else \
        err <= 2e-2 and ulp <= 1.0 and rel <= 1e-2
    if not (ok and math.isfinite(err)):
        raise AssertionError(f"{what}: max abs err {err:.3e} beyond limit")
    return err


def device_ms(fn) -> float:
    for _ in range(3):
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


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("flash_attention_compare: needs an NVIDIA card", file=sys.stderr)
        return 2
    print(f"[device] {smi()}", flush=True)
    sources = {name: Path(path).read_text()
               for name, path in zip(("old", "new"), argv)}
    fns = {name: entry(lib, sources[name])
           for name, lib in build(sources, OUT).items()}
    dev = torch.device("cuda:0")
    gen = torch.Generator(device="cpu").manual_seed(0)
    for label, (b, sq, sk, hq, hkv, hd, causal, dt) in SHAPES.items():
        q, k, v = ((torch.randn(b, s, h, hd, generator=gen)).to(dev, dt)
                   for s, h in ((sq, hq), (sk, hkv), (sk, hkv)))
        o = torch.empty_like(q)
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        flops = 4.0 * hd * hq * b * (sq * (sq + 1) / 2 if causal else sq * sk)
        outs = {}
        for name, fn in fns.items():
            launch(fn, q, k, v, o, causal)
            torch.cuda.synchronize()
            err = check(o, want, dt, f"{name} at {label}")
            outs[name] = o.clone()
            print(f"[{label}] {name}: max abs err {err:.3e}", flush=True)
        print(f"[{label}] old and new outputs bit-equal: "
              f"{torch.equal(outs['old'], outs['new'])}", flush=True)
        times = {"old": [], "new": []}
        for rnd in range(2):
            for name in ("old", "new", "new", "old"):
                ms = device_ms(lambda: launch(fns[name], q, k, v, o, causal))
                times[name].append(ms)
                print(f"[{label}] round {rnd} {name}: {ms:.4f} ms, "
                      f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
        old, new = (float(np.median(times[n])) for n in ("old", "new"))
        print(f"[{label}] {(b, sq, sk, hq, hkv, hd)} causal={causal} {dt}: "
              f"median old {old:.4f} ms, new {new:.4f} ms, new / old "
              f"{new / old:.4f}", flush=True)
        del q, k, v, o, want
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
