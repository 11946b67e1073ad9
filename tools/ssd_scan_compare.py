"""Device time of two versions of ``ssd_scan.cu``, in turns, on the card.

    python3 tools/ssd_scan_compare.py OLD.cu NEW.cu

Builds both sources (each must keep the C interface of
``src/repro_torch/kernels/csrc/ssd_scan.cu``), holds each against
``models.ssm.ssd_chunked`` at the Mamba-2-130M prefill shape (4 x 4096
tokens, 24 heads of 64, d_state 128, chunk 256, softplus dt: L monotone in
every chunk) and times every CUDA kernel of one call by profiler name
(20 calls) in the order old, new, new, old, twice. Needs one NVIDIA card
and ``nvcc``; builds into ``build/ssd_compare/``.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

from ssd_scan_ablation import ROOT, build, inputs, smi, time_build

OUT = ROOT / "build" / "ssd_compare"


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ssd_scan_compare: needs an NVIDIA card", file=sys.stderr)
        return 2
    print(f"[device] {smi()}", flush=True)
    libs = build({name: Path(path).read_text()
                  for name, path in zip(("old", "new"), argv)}, OUT)
    ins, want = inputs(torch.device("cuda:0"))
    for rnd in range(2):
        for name in ("old", "new", "new", "old"):
            per = time_build(libs[name], ins, want)
            print(f"[round {rnd}] {name}: device ms per call {per}, total "
                  f"{sum(per.values()):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
