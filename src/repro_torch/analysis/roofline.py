"""Roofline terms of a step: the least time its work could take on a chip.

compute term    = FLOPs / (chips x peak FLOP/s)
memory term     = bytes / (chips x memory bytes/s)
collective term = collective bytes / (chips x link bytes/s)

All tallies are per device, so dividing by one device's peaks gives the
same ratio as global / (chips x peak). The arithmetic is the JAX package's
``repro.analysis.roofline.roofline_from_hlo_text``, with the peaks an
argument; ``roofline_terms`` takes the tallies from any source
(``parse_hlo`` of an XLA text, or the port's dry run, which counts a
step's FLOPs with ``torch.utils.flop_counter`` and its bytes as each
argument read once and each output written once).

The default peaks are one H100 80GB HBM3's published dense rates: bf16 on
the tensor cores and the HBM rate, those ``chip_smoke.card_peaks`` bounds
kernels with. One card has no link, so the collective term is 0 unless a
link rate is given (and a program with collective bytes needs one).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.analysis.hlo_parse import parse_hlo

PEAK_FLOPS = 989e12       # bf16 on the tensor cores, dense
HBM_BW = 3.35e12          # bytes/s


def model_flops(arch, shape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); prefill 2*N*D; decode per token."""
    cfg = arch.model
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n_active * toks
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * n_active * toks
    return 2.0 * n_active * shape.global_batch   # decode: one token/sequence


def roofline_terms(stats: dict, chips: int, cost: dict, mf_total: float, *,
                   peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
                   link_bw: Optional[float] = None) -> dict:
    """The terms from per-device tallies ``stats`` (``dot_flops``,
    ``hbm_bytes``, ``collective_bytes``, ``collective_counts``, as
    ``parse_hlo`` gives them) and a compiler's ``cost`` (``flops``,
    ``bytes accessed``; empty without one): the larger of the two counts
    of each is taken."""
    xla_flops = float(cost.get("flops", 0.0) or 0.0)
    xla_bytes = float(cost.get("bytes accessed", 0.0) or 0.0)
    hlo_flops = max(stats["dot_flops"], xla_flops)
    hbm_bytes = max(stats["hbm_bytes"], xla_bytes)
    coll_bytes = stats["collective_bytes"]
    if link_bw is None and coll_bytes:
        raise ValueError(f"{coll_bytes} collective bytes need a link rate")

    terms = {
        "compute_s": hlo_flops / peak_flops,
        "memory_s": hbm_bytes / hbm_bw,
        "collective_s": coll_bytes / link_bw if link_bw else 0.0,
    }
    bottleneck = max(terms, key=terms.get)
    mf_per_chip = mf_total / chips
    bound = max(terms.values())
    return {
        "chips": chips,
        "hlo_flops_per_chip": hlo_flops,
        "xla_cost_flops": xla_flops,
        "parsed_dot_flops": stats["dot_flops"],
        "hbm_bytes_per_chip": hbm_bytes,
        "xla_bytes_accessed": xla_bytes,
        "collective_bytes_per_chip": coll_bytes,
        "collective_counts": stats["collective_counts"],
        **terms,
        "bottleneck": bottleneck,
        "model_flops_total": mf_total,
        "useful_flops_ratio": (mf_per_chip / hlo_flops) if hlo_flops else None,
        "step_time_bound_s": bound,
        "mfu_bound": (mf_per_chip / peak_flops) / bound if bound > 0 else None,
    }


def roofline_from_hlo_text(hlo_text: str, chips: int, cost: dict,
                           mf_total: float, **peaks) -> dict:
    """``roofline_terms`` of an optimized XLA program's text."""
    return roofline_terms(parse_hlo(hlo_text), chips, cost, mf_total,
                          **peaks)


__all__ = ["PEAK_FLOPS", "HBM_BW", "model_flops", "roofline_terms",
           "roofline_from_hlo_text"]
