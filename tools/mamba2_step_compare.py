"""Two trees' Mamba-2-130M train steps in turns, on the card, with where
the host's time goes.

    python3 tools/mamba2_step_compare.py OLD_ROOT NEW_ROOT [--steps N]

Each ROOT is a checkout of the repo (its ``src/`` and ``chip_smoke.py``).
Runs ``chip_smoke.py`` phase 9e's train step (Mamba-2-130M at full width
and all 24 layers, seed 12, 8 x 4096 in 4 microbatches, remat full, the
SSD kernels forward and backward) in one process per turn, in the order
old, new, new, old, each process building its tree's kernels into that
tree's ``build/``. A turn takes one untimed step, then N timed ones
(default 4), each read three ways:

* ``wall``: host clock from the step's call to ``synchronize`` after it;
* ``issue``: host clock from the call to its return (the step makes no
  host sync, so this is the time the host takes to dispatch the step,
  which the device can only trail);
* ``bwd_host``: the host's time inside the ``ssd_scan`` backward's
  wrapper (``kernels.ssd_scan_bwd.ssd_scan_bwd``), summed over the
  step's calls, and the count of those calls.

Then one step under the profiler (CPU and CUDA activities): device time
by ``chip_smoke.train_split``, the busy total and the idle share of the
unprofiled fastest wall, and the ten host ops with the most self CPU time.
Prints each turn's numbers and, per tree, the medians. Needs one NVIDIA
card and ``nvcc``. The chip copy has no ``.git``: unpack the parent into
an ignored directory first, e.g. ``mkdir -p build/parent && git archive
HEAD | tar -x -C build/parent``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

STEPS = 4
TAG = "mamba2_step_compare: "


def worker(root: Path, steps: int) -> dict:
    """One turn in this process, on ``root``'s tree."""
    sys.path[:0] = [str(root / "src"), str(root)]
    from unittest import mock

    import torch

    import chip_smoke as cs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ssd_scan_bwd as sbw
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model
    from repro_torch.training.optimizer import OptConfig, init_opt_state

    dev = torch.device("cuda:0")
    env = make_host_mesh(device=dev)
    arch = cs.train_arch(cs.MAMBA, microbatch=cs.TRAIN_MICRO, remat="full")
    cfg = arch.model
    opt_cfg = OptConfig(warmup=2, total_steps=10)
    bundle = model.make_step_bundle(
        arch, ShapeConfig("train", cs.TRAIN_SEQ, cs.TRAIN_BATCH, "train"),
        env, opt_cfg=opt_cfg)
    gen = torch.Generator(device=dev).manual_seed(cs.MAMBA_TRAIN_SEED)
    params = shd.init_params(bundle.arg_specs[0], gen, dev)
    opt = init_opt_state(params, opt_cfg)
    batches = cs.lm_batches(cfg, cs.TRAIN_BATCH, cs.TRAIN_SEQ,
                            cs.MAMBA_TRAIN_SEED, dev, steps + 2)

    bwd = sbw.ssd_scan_bwd
    inside = []

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = bwd(*a, **kw)
        inside.append(time.perf_counter() - t0)
        return out

    rows = []
    with mock.patch.object(sbw, "ssd_scan_bwd", timed):
        for step in range(steps + 1):
            torch.cuda.synchronize()
            inside.clear()
            t0 = time.perf_counter()
            params, opt, _ = bundle.fn(params, opt, batches[step])
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if step:  # the first step builds and warms up
                rows.append({"wall": t2 - t0, "issue": t1 - t0,
                             "bwd_host": sum(inside),
                             "bwd_calls": len(inside)})
    prof_wall, prof = cs.profiled_step(
        lambda: bundle.fn(params, opt, batches[steps + 1]))
    split, _, busy, _ = cs.train_split(prof, prof_wall)
    cpu = sorted(((ev.key, ev.self_cpu_time_total / 1e3, ev.count)
                  for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CPU),
                 key=lambda r: -r[1])[:10]
    fastest = min(r["wall"] for r in rows)
    return {"steps": rows, "busy_ms": busy,
            "idle_of_fastest": 1 - busy / 1e3 / fastest,
            "split_ms": split, "profiled_wall": prof_wall,
            "cpu_self_ms": cpu}


def median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2


def main(argv) -> int:
    if "--worker" in argv:
        i = argv.index("--worker")
        steps = int(argv[argv.index("--steps") + 1]) if "--steps" in argv \
            else STEPS
        print(TAG + json.dumps(worker(Path(argv[i + 1]).resolve(), steps)),
              flush=True)
        return 0
    steps = STEPS
    if "--steps" in argv:
        i = argv.index("--steps")
        steps = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("mamba2_step_compare: needs an NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"[device] {smi.stdout.strip()}", flush=True)
    roots = {"old": Path(argv[0]).resolve(), "new": Path(argv[1]).resolve()}
    turns = {name: [] for name in roots}
    for name in ("old", "new", "new", "old"):
        root = roots[name]
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             str(root), "--steps", str(steps)],
            capture_output=True, text=True, cwd=root, timeout=1200,
            env={**os.environ, "PYTHONPATH": str(root / "src")})
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith(TAG)]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"the {name} turn failed "
                               f"(exit {proc.returncode})")
        r = json.loads(lines[-1][len(TAG):])
        turns[name].append(r)
        steps_ = r["steps"]
        print(f"[{name} turn {len(turns[name])}] wall "
              + ", ".join(f"{s['wall']:.3f}" for s in steps_) + " s; issue "
              + ", ".join(f"{s['issue']:.3f}" for s in steps_) + " s; host "
              "in the SSD backward's wrapper "
              + ", ".join(f"{s['bwd_host'] * 1e3:.1f}" for s in steps_)
              + f" ms over {steps_[0]['bwd_calls']} calls; profiled step: "
              f"busy {r['busy_ms']:.1f} ms (" + ", ".join(
                  f"{k} {v:.1f}" for k, v in r["split_ms"].items())
              + f"), idle {r['idle_of_fastest']:.1%} of the fastest wall; "
              "host ops by self CPU ms: " + ", ".join(
                  f"{k} {ms:.1f} ({n})" for k, ms, n in r["cpu_self_ms"]),
              flush=True)
    for name, rs in turns.items():
        steps_ = [s for r in rs for s in r["steps"]]
        print(f"[{name}] medians over {len(steps_)} steps: wall "
              f"{median([s['wall'] for s in steps_]):.4f} s, issue "
              f"{median([s['issue'] for s in steps_]):.4f} s, host in the "
              f"SSD backward's wrapper "
              f"{median([s['bwd_host'] for s in steps_]) * 1e3:.2f} ms; "
              f"busy {median([r['busy_ms'] for r in rs]):.1f} ms, idle "
              f"{median([r['idle_of_fastest'] for r in rs]):.1%}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
