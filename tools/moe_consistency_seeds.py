"""The Qwen3-30B-A3B consistency checks of ``chip_smoke.py``'s MoE phase
(7c) at several weight seeds, on one card.

    python3 tools/moe_consistency_seeds.py [SEED ...]     (default 5 6 7 8)

For each seed it draws Qwen3-30B-A3B (full width, all 48 layers, bf16) on
the card as the phase does (``chip_smoke.draw_by_layer``, the seed's
generator then drawing the prompt) and runs the phase's
``moe_consistency``: at 2 x 256 and capacity factor E / k, prefill
through ``flash_attention`` against prefill through its plain version,
and decode step by step from the zero cache against the prefill. A
reading beyond the phase's bounds (``MOE_LOGIT_ATOL`` max abs,
``MOE_LOGIT_REL_L2`` relative L2) is printed, not raised, so every seed
is read; the last line is one JSON object with each seed's readings and
the largest of each. Seed 5 is the phase's own. Needs one NVIDIA card and
``nvcc`` (the kernels build into ``build/torch_kernels/``).
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


def main(seeds: list) -> int:
    if not torch.cuda.is_available():
        print("moe_consistency_seeds: needs one CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model

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
    arch = get_arch(cs.MOE)
    specs = model.make_step_bundle(arch, ShapeConfig(
        "prefill", cs.CONSIST_SEQ, cs.CONSIST_BATCH, "prefill"),
        env).arg_specs[0]
    out = {}
    for seed in seeds:
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = cs.draw_by_layer(specs, gen, dev)
        cs.log(f"[seeds] {smi}: seed {seed}")
        out[seed] = cs.moe_consistency("Qwen3", arch, params, gen, dev, env)
        cs.log(f"[seeds] seed {seed}: {out[seed]} "
               f"({time.perf_counter() - t0:.1f} s)")
        del params
        torch.cuda.empty_cache()
    worst = {k: max(r[k] for r in out.values())
             for k in ("plain_err", "plain_rel", "consist_err",
                       "consist_rel")}
    cs.log(f"[seeds] {smi}: largest over seeds {seeds}: {worst}; bounds "
           f"{cs.MOE_LOGIT_ATOL} max abs, {cs.MOE_LOGIT_REL_L2} relative L2; "
           f"beyond: {len(beyond)}")
    print(json.dumps({"card": smi, "seeds": out, "largest": worst,
                      "beyond": beyond}))
    return 0


if __name__ == "__main__":
    sys.exit(main([int(a) for a in sys.argv[1:]] or [5, 6, 7, 8]))
