"""Markdown tables of dry-run records (``launch/dryrun.py``'s JSON): the
dry-run table, the roofline table and a comparison of tagged variants.
The JAX package's ``repro.analysis.report``, unchanged in behaviour.

    PYTHONPATH=src python -m repro_torch.analysis.report [--json dryrun_results.json]
"""
from __future__ import annotations

import argparse
import json


def fmt_bytes(b):
    if b is None:
        return "-"
    return f"{b/1e9:.2f}GB"


def fmt_s(x):
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.3g}s"
    if x >= 1e-3:
        return f"{x*1e3:.3g}ms"
    return f"{x*1e6:.3g}us"


def dryrun_table(recs, tag):
    rows = ["| arch | shape | mesh | compile s | args/chip | temps/chip | "
            "HLO GFLOPs/chip | collective counts |",
            "|---|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda x: (x["arch"], x["shape"], x["mesh"])):
        if r.get("tag", "") != tag or not r.get("ok"):
            continue
        ro = r["roofline"]
        cc = ro.get("collective_counts", {})
        ccs = " ".join(f"{k.split('-')[-1][:6]}:{v}" for k, v in
                       sorted(cc.items()))
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['compile_s']} | "
            f"{fmt_bytes(r['memory'].get('argument_bytes'))} | "
            f"{fmt_bytes(r['memory'].get('temp_bytes'))} | "
            f"{ro['hlo_flops_per_chip']/1e9:,.0f} | {ccs} |")
    return "\n".join(rows)


def roofline_table(recs, tag, mesh="16x16"):
    rows = ["| arch | shape | compute | memory | collective | bottleneck | "
            "6ND/HLO | MFU bound |",
            "|---|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda x: (x["arch"], x["shape"])):
        if r.get("tag", "") != tag or not r.get("ok") or r["mesh"] != mesh:
            continue
        ro = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(ro['compute_s'])} | "
            f"{fmt_s(ro['memory_s'])} | {fmt_s(ro['collective_s'])} | "
            f"{ro['bottleneck'].replace('_s','')} | "
            f"{ro['useful_flops_ratio']:.2f} | {ro['mfu_bound']:.4f} |")
    return "\n".join(rows)


def perf_compare(recs, arch, shape, tags):
    rows = [f"| variant | compute | memory | collective | MFU bound |",
            "|---|---|---|---|---|"]
    for tag in tags:
        for r in recs:
            if (r.get("arch") == arch and r.get("shape") == shape
                    and r.get("mesh") == "16x16" and r.get("tag", "") == tag
                    and r.get("ok")):
                ro = r["roofline"]
                rows.append(
                    f"| {tag or 'baseline'} | {fmt_s(ro['compute_s'])} | "
                    f"{fmt_s(ro['memory_s'])} | {fmt_s(ro['collective_s'])} | "
                    f"{ro['mfu_bound']:.4f} |")
                break
    return "\n".join(rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default="dryrun_results.json")
    ap.add_argument("--section", default="all",
                    choices=["all", "dryrun", "roofline", "final"])
    args = ap.parse_args()
    with open(args.json) as f:
        recs = json.load(f)

    if args.section in ("all", "dryrun"):
        print("### Dry-run (baseline, 16x16 + 2x16x16)\n")
        print(dryrun_table(recs, ""))
    if args.section in ("all", "roofline"):
        print("\n### Roofline (baseline, single pod 16x16)\n")
        print(roofline_table(recs, ""))
    if args.section in ("all", "final"):
        print("\n### Roofline (optimized 'final', single pod 16x16)\n")
        print(roofline_table(recs, "final"))
        print("\n### Dry-run (optimized 'final')\n")
        print(dryrun_table(recs, "final"))


if __name__ == "__main__":
    main()
