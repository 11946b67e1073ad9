"""The gradient checks of ``chip_smoke.py``'s phase 7f(d) (the gradient
through context-parallel prefill) at several seeds, on one card.

    python3 tools/cp_grad_seeds.py [SEED ...]     (default: 8 9 10 11)

For each seed, at the check shape (``chip_smoke.CHECK_LAYERS`` layers of
Yi-6B at full width, ``CHECK_BATCH`` x ``CHECK_SEQ`` over ``CP_SHARDS``
shards; ``chip_smoke.cp_grad_check``) the worst leaf of the cp gradient
through the kernels against the ordinary prefill's through the kernels
and against the cp gradient through the plain versions; and at the
phase's own shape (the cut ``cp_grad_layers`` chooses beside the 32
layers phase 7b holds, ``DENSE_BATCH`` x ``DENSE_SEQ``, weights, tokens
and projection drawn from the seed) the worst leaf against the ordinary
prefill's. A reading beyond the smoke's bounds is printed, not raised;
the last line is one JSON object with every reading and the largest of
each. Needs one NVIDIA card and ``nvcc`` (the kernels build into
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


def main(seeds: list) -> int:
    if not torch.cuda.is_available():
        print("cp_grad_seeds: needs one CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model

    seeds = seeds or list(cs.CHECK_SEEDS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    _build.build_all()
    dev = torch.device("cuda:0")
    env = make_host_mesh(device=dev)
    arch = get_arch(cs.DENSE)
    held = shd.param_bytes(model.param_specs(arch.model))
    card = torch.cuda.get_device_properties(dev).total_memory
    layers, need, budget = cs.cp_grad_layers(arch, cs.DENSE_BATCH,
                                             cs.DENSE_SEQ, cs.CP_SHARDS,
                                             held, card)
    cs.log(f"[cp-grad-seeds] {smi}: the phase's cut {layers} layers "
           f"({need / 1e9:.2f} GB of a {budget / 1e9:.2f} GB budget beside "
           f"{held / 1e9:.2f} GB of weights)")
    out, beyond = {}, []
    for seed in seeds:
        t0 = time.perf_counter()
        r = cs.cp_grad_check(dev, env, arch, seed)
        torch.cuda.empty_cache()
        full = cs.cp_grad_check(dev, env, arch, seed, layers, cs.DENSE_BATCH,
                                cs.DENSE_SEQ, plain=False)
        torch.cuda.empty_cache()
        r.update(full=full["ordinary"], full_leaf=full["ordinary_leaf"])
        out[seed] = r
        for what, bound in (("ordinary", cs.CP_GRAD_REL_L2),
                            ("plain", cs.TRAIN_GRAD_REL_L2),
                            ("full", cs.CP_GRAD_REL_L2)):
            if r[what] > bound:
                beyond.append((seed, what, r[what]))
        cs.log(f"[cp-grad-seeds] seed {seed}: {r} "
               f"({time.perf_counter() - t0:.1f} s)")
    largest = {k: max(r[k] for r in out.values())
               for k in ("ordinary", "plain", "full")}
    cs.log(f"[cp-grad-seeds] {smi}: largest over seeds {seeds}: {largest}; "
           f"bounds {cs.CP_GRAD_REL_L2} (ordinary, full) and "
           f"{cs.TRAIN_GRAD_REL_L2} (plain); beyond: {beyond}")
    print(json.dumps({"card": smi, "layers": layers, "seeds": out,
                      "largest": largest, "beyond": beyond}))
    return 0


if __name__ == "__main__":
    sys.exit(main([int(a) for a in sys.argv[1:]]))
