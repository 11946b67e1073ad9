"""The consistency checks of ``chip_smoke.py``'s model phases with MoE
layers, the MoE phase (7c, Qwen3-30B-A3B) and the hybrid phase (7d,
Jamba-v0.1-52B at 16 layers), and of its enc-dec phase (7e,
Whisper-small), at several weight seeds, on one card.

    python3 tools/moe_consistency_seeds.py [--phase moe|hybrid|encdec]
        [SEED ...]          (default: moe, and the phase's seed and 3 more)

For each seed it draws the phase's model (full width, bf16) on the card
as the phase does (``chip_smoke.draw_by_layer``, the seed's generator
then drawing the prompt) and runs the phase's check (``moe_consistency``
at 2 x 256 and capacity factor E / k; ``consistency`` for enc-dec):
prefill through the kernels against prefill through their plain
versions, and decode step by step from the zero cache against the
prefill. A reading beyond the phase's bounds (max abs, relative L2) is
printed, not raised, so every seed is read; the last line is one JSON
object with each seed's readings and the largest of each. Needs one
NVIDIA card and ``nvcc`` (the kernels build into
``build/torch_kernels/``).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402

# each phase: (its arch, its check, its own seed, its bounds (max abs,
# relative L2))
PHASES = {
    "moe": (lambda: get_arch(cs.MOE),
            lambda *a: cs.moe_consistency("Qwen3", *a), 5,
            (cs.MOE_LOGIT_ATOL, cs.MOE_LOGIT_REL_L2)),
    "hybrid": (cs.hybrid_arch, cs.hybrid_consistency, 6,
               (cs.HYBRID_LOGIT_ATOL, cs.HYBRID_LOGIT_REL_L2)),
    "encdec": (lambda: get_arch(cs.ENCDEC), cs.encdec_consistency, 7,
               (cs.ENCDEC_LOGIT_ATOL, cs.ENCDEC_LOGIT_REL_L2)),
}
READINGS = ("plain_err", "plain_rel", "consist_err", "consist_rel")


def main(phase: str, seeds: list) -> int:
    if not torch.cuda.is_available():
        print("moe_consistency_seeds: needs one CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model

    arch_of, run_check, own_seed, bounds = PHASES[phase]
    seeds = seeds or [own_seed + i for i in range(4)]
    beyond = []

    def note(cond: bool, what: str):
        if not cond:
            beyond.append(what)
            cs.log(f"[seeds] beyond the bound: {what}")
    cs.check = note
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    _build.build_all()
    dev = torch.device("cuda:0")
    env = make_host_mesh(device=dev)
    arch = arch_of()
    specs = model.make_step_bundle(arch, ShapeConfig(
        "prefill", cs.CONSIST_SEQ, cs.CONSIST_BATCH, "prefill"),
        env).arg_specs[0]
    out = {}
    for seed in seeds:
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = cs.draw_by_layer(specs, gen, dev)
        cs.log(f"[seeds] {smi}: {phase} seed {seed}")
        r = run_check(arch, params, gen, dev, env)
        out[seed] = {k: r[k] for k in READINGS}
        cs.log(f"[seeds] {phase} seed {seed}: {out[seed]} "
               f"({time.perf_counter() - t0:.1f} s)")
        del params, r
        torch.cuda.empty_cache()
    worst = {k: max(r[k] for r in out.values()) for k in READINGS}
    cs.log(f"[seeds] {smi}: {phase}: largest over seeds {seeds}: {worst}; "
           f"bounds {bounds[0]} max abs, {bounds[1]} relative L2; beyond: "
           f"{len(beyond)}")
    print(json.dumps({"card": smi, "phase": phase, "seeds": out,
                      "largest": worst, "beyond": beyond}))
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    chosen = "moe"
    if args[:1] == ["--phase"]:
        chosen, args = args[1], args[2:]
    sys.exit(main(chosen, [int(a) for a in args]))
