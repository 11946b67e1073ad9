"""Where the time of the bf16 ``flash_attention`` kernel goes, by ablation,
on the card.

    python3 tools/flash_attention_ablation.py

Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` as it is and in
copies with one piece of the bf16 tensor-core kernel taken out (the
textual cuts below), then times each build's device time at the Yi-6B
prefill shape (2 x 4096, 32 query and 4 KV heads of 128, causal; CUDA
events around 20 back-to-back calls, median of 5 rounds) in turns, two
rounds. Each build is also held against ``flash_attention_ref`` (max abs
error, the largest error over its one-bf16-ulp limit 1e-3 + 2^-7 |ref|,
relative L2): a cut build computes wrong values and is for timing only,
except the single-bf16-P build, which shows what the split of P into
hi + lo buys in precision. Needs one NVIDIA card and ``nvcc``; builds into
``build/fa_ablation/``.
"""
from __future__ import annotations

import sys

import torch

from flash_attention_compare import check_numbers, device_ms, entry, launch
from ssd_scan_ablation import ROOT, build, cut, smi

from repro_torch.kernels import ref

SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
OUT = ROOT / "build" / "fa_ablation"
SHAPE = (2, 4096, 4096, 32, 4, 128)

# the pieces of the bf16 kernel (hd 128) a build goes without
LO = ("      wgmma_rs_n128(acc, pl[kk], dv);\n", "")
HI = ("      wgmma_rs_n128(acc, ph[kk], dv);\n", "")
SPLIT = ("        pl[kk][r] = pack(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));",
         "        pl[kk][r] = 0u;")
S = ("    wgmma_ss_n64(s, desc(qs + (kk >> 2) * BQ * 128 + col, 16, 1024),\n"
     "                 desc(ks + (kk >> 2) * BKV * 128 + col, 16, 1024), "
     "kk > 0);\n", "")
EXP = [(f"        pf[4 * j{e}] = ex2(fmaf(s[4 * j{e}], scale2, -n{r}));",
        f"        pf[4 * j{e}] = fmaf(s[4 * j{e}], scale2, -n{r});")
       for e, r in (("", 0), (" + 1", 0), (" + 2", 1), (" + 3", 1))]
COPIES = ("      kc.load(Ks + sn * KB, (kt + 2) * BKV, sk);\n"
          "      vc.load(Vs + sn * KB, (kt + 2) * BKV, sk);\n", "")
CUTS = {"as it is": [],
        "single-bf16 P (no P_lo V product)": [LO],
        "no P V products": [LO, HI],
        "no split of P (P_lo = 0, its product kept)": [SPLIT],
        "no S products": [S],
        "no exponentials (full tiles)": EXP,
        "no copies after the first two tiles": [COPIES]}


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_attention_ablation: needs an NVIDIA card",
              file=sys.stderr)
        return 2
    print(f"[device] {smi()}", flush=True)
    src = SOURCE.read_text()
    fns = {name: entry(lib) for name, lib in build(
        {name: cut(src, pieces) for name, pieces in CUTS.items()},
        OUT).items()}
    b, sq, sk, hq, hkv, hd = SHAPE
    gen = torch.Generator(device="cpu").manual_seed(0)
    dev = torch.device("cuda:0")
    q, k, v = (torch.randn(b, s, h, hd, generator=gen).to(dev, torch.bfloat16)
               for s, h in ((sq, hq), (sk, hkv), (sk, hkv)))
    o = torch.empty_like(q)
    want = ref.flash_attention_ref(q, k, v)
    flops = 4.0 * hd * hq * b * sq * (sq + 1) / 2
    for name, fn in fns.items():
        launch(fn, q, k, v, o, True)
        torch.cuda.synchronize()
        err, ulp, rel = check_numbers(o, want)
        print(f"[{name}] max abs err {err:.3e}, {ulp:.3f}x its one-ulp "
              f"limit, relative L2 {rel:.3e}", flush=True)
    for rnd in range(2):
        for name in list(fns) + list(fns)[::-1]:
            ms = device_ms(lambda: launch(fns[name], q, k, v, o, True))
            print(f"[round {rnd}] {name}: {ms:.4f} ms, "
                  f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
