"""Dry run: what one step of an (arch, shape) needs on one H100, from a
trace on the ``meta`` device, which allocates and computes nothing.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
        --shape prefill_32k [--out dryrun_results.json]

The JAX package's dry run (``repro.launch.dryrun``) lowers and compiles
each step for a production mesh and reads XLA's memory and cost analyses.
The port keeps the keys of its record that mean something on one card:

* ``param_bytes_global``: the parameters' bytes;
* ``memory.argument_bytes``: the bytes of the step's arguments
  (parameters, batch, decode cache or optimizer state), which on one card
  are the per-device program's, beside ``memory.card_bytes`` and whether
  they fit; ``memory.output_bytes``: the bytes of what the step returns;
* ``model_flops``: 6 N D, 2 N D or 2 N a token (``analysis.roofline``);
* ``cost.flops``: the step's FLOPs, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` while the bundle's function
  runs on ``meta`` tensors (``kernels.ops`` sends them to the plain
  versions, so attention and the SSD scan count as their plain
  statements: the FLOPs of the function, with the masked pairs of a
  causal score matrix included);
* ``roofline``: ``analysis.roofline.roofline_terms`` against one H100's
  bf16 tensor-core and HBM peaks, the bytes taken as the arguments read
  once and the outputs written once, no collective term.

Keys that need XLA (``compile_s``, ``memory.temp_bytes``,
``memory.generated_code_bytes``, ``cost.bytes_accessed``) are ``null``;
``trace_s`` takes the place of ``lower_s``. A cell that fails to trace
(a data-dependent operation has no ``meta`` kernel) is recorded with
``ok: false`` and its error, as in the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.roofline import model_flops, roofline_terms
from repro_torch.configs import ASSIGNED, get_arch
from repro_torch.distributed.sharding import (param_bytes, spec_map,
                                              tree_leaves)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import make_step_bundle

RESULTS = "dryrun_results.json"
CARD_BYTES = 80e9          # an H100 80GB HBM3's device memory


def meta_inputs(bundle) -> tuple:
    """Empty ``meta`` tensors of the bundle's argument specs."""
    return tuple(spec_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                                device="meta"), tree)
                 for tree in bundle.arg_specs)


def tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def run_cell(arch, shape_name: str, *, attn_mode: str = "full",
             verbose: bool = True, extra_tag: str = "") -> dict:
    """The record of one (arch, shape): ``arch`` a name or an
    ``ArchConfig`` (a reduced one, say)."""
    arch_name = arch if isinstance(arch, str) else arch.model.name
    arch = get_arch(arch) if isinstance(arch, str) else arch
    shape = {s.name: s for s in arch.shapes}[shape_name]
    env = make_host_mesh(device="meta")
    bundle = make_step_bundle(arch, shape, env, attn_mode=attn_mode)
    args = meta_inputs(bundle)
    counter = FlopCounterMode(display=False)
    t0 = time.time()
    with counter:
        out = bundle.fn(*args)
    trace_s = time.time() - t0
    flops = float(counter.get_total_flops())
    arg_bytes, out_bytes = tensor_bytes(args), tensor_bytes(out)
    mf = model_flops(arch, shape)
    stats = {"dot_flops": flops, "hbm_bytes": float(arg_bytes + out_bytes),
             "collective_bytes": 0, "collective_counts": {}}
    roof = roofline_terms(stats, 1, {}, mf)
    rec = {
        "arch": arch_name,
        "shape": shape_name,
        "mesh": "1",
        "tag": extra_tag,
        "trace_s": round(trace_s, 2),
        "compile_s": None,
        "param_bytes_global": param_bytes(bundle.arg_specs[0]),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": None,
            "generated_code_bytes": None,
            "card_bytes": CARD_BYTES,
            "fits": arg_bytes <= CARD_BYTES,
        },
        "cost": {"flops": flops, "bytes_accessed": None},
        "model_flops": mf,
        "roofline": roof,
        "ok": True,
    }
    if verbose:
        print(f"== {arch_name} x {shape_name} on one card (trace "
              f"{rec['trace_s']}s): arguments {arg_bytes / 1e9:.2f} GB of "
              f"{CARD_BYTES / 1e9:.0f} GB, {flops / 1e12:.2f} TFLOP, model "
              f"{mf / 1e12:.2f} TFLOP, bound {roof['step_time_bound_s']:.4g} s "
              f"({roof['bottleneck']})")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--attn-mode", default="full")
    ap.add_argument("--out", default=RESULTS)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    archs = ASSIGNED if args.arch == "all" else [args.arch]
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"], r.get("tag", ""))
            for r in results if r.get("ok")}

    for name in archs:
        arch = get_arch(name)
        supported = [s.name for s in arch.supported_shapes()]
        shape_names = supported if args.shape == "all" else \
            [s for s in [args.shape] if s in supported]
        for skipped in arch.skipped_shapes():
            print(f"-- skip {name} x {skipped.name}: full-attention arch, "
                  "sub-quadratic shape")
        for sn in shape_names:
            key = (name, sn, "1", args.tag)
            if key in done:
                print(f"-- cached {key}")
                continue
            try:
                rec = run_cell(name, sn, attn_mode=args.attn_mode,
                               extra_tag=args.tag)
            except Exception as e:  # noqa: BLE001 — record and continue
                traceback.print_exc()
                rec = {"arch": name, "shape": sn, "mesh": "1",
                       "tag": args.tag, "ok": False, "error": repr(e)}
            results.append(rec)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)

    n_ok = sum(1 for r in results if r.get("ok"))
    print(f"\n{n_ok}/{len(results)} cells OK -> {args.out}")
    return results


__all__ = ["run_cell", "meta_inputs", "main", "CARD_BYTES"]


if __name__ == "__main__":
    main()
