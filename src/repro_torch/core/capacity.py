"""Per-op load capacity C_l (paper §4.2, Table 5).

Class thresholds (max tolerated latency inflation from concurrent loading):
  hierarchical 0%   — never overlap (softmax/layernorm/attention/router)
  reusable     20%  — matmul/conv: high tolerance, slow relative growth
  elemental    300% — elementwise: tiny baseline latency, large tolerance

Two modes:
  * analytic — C_bytes = threshold x t_op x stream_bw, with t_op the
    max(compute, memory) roofline time of the op on the target chip. Used
    for planning at dry-run scale.
  * model-calibrated — invert the GBT latency model by binary search
    (profile-driven; used in the benchmarks, mirrors the paper's XGBoost).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.core.graph import ELEMENTAL, HIERARCHICAL, REUSABLE, ModelGraph, Op
from repro_torch.core.latency_model import GBTRegressor, features

THRESHOLDS = {HIERARCHICAL: 0.0, REUSABLE: 0.20, ELEMENTAL: 3.00}


@dataclass(frozen=True)
class HWSpec:
    peak_flops: float = 197e12       # bf16/chip (TPU v5e-class)
    hbm_bw: float = 819e9
    stream_bw: float = 25e9          # host->HBM streaming path (PCIe-class)
    disk_bw: float = 0.0             # storage->host stage (0 = not modeled)

    def op_time(self, op: Op) -> float:
        return max(op.flops / self.peak_flops, op.act_bytes / self.hbm_bw,
                   1e-9)

    @staticmethod
    def cpu_calibrated() -> "HWSpec":
        """Measure this machine (benchmark executors run on CPU)."""
        import time

        import numpy as np
        a = np.random.rand(768, 768).astype(np.float32)
        t0 = time.perf_counter()
        for _ in range(8):
            a = a @ a * 1e-3
        tf = (time.perf_counter() - t0) / 8
        flops = 2 * 768 ** 3 / max(tf, 1e-9)
        src = np.ones(32 << 20, np.uint8)
        dst = np.empty_like(src)
        np.copyto(dst, src)  # warm pages
        t0 = time.perf_counter()
        for _ in range(4):
            np.copyto(dst, src)
        bw = 4 * src.nbytes / max(time.perf_counter() - t0, 1e-9)
        return HWSpec(peak_flops=flops, hbm_bw=bw, stream_bw=bw / 2,
                      disk_bw=0.5e9)

    @staticmethod
    def cuda_calibrated(device=None) -> "HWSpec":
        """Measure the card the executors run on, timed with CUDA events
        (median of ``CALIBRATION_ITERS`` after warm-up):

        * ``peak_flops``: the port's own ``streamed_matmul`` at a serving
          shape, (1024, 2048) @ (2048, 2048) in f32 — the rate the
          projections really run at, not a library GEMM's;
        * ``hbm_bw``: a device-to-device copy (bytes read + written);
        * ``stream_bw``: a copy from pinned host memory to the device.

        It launches the kernel ``CALIBRATION_LAUNCHES`` times."""
        import torch

        from repro_torch.device import resolve_device
        from repro_torch.kernels.streamed_matmul import streamed_matmul

        dev = resolve_device(device)
        if dev.type != "cuda":
            raise ValueError(f"cuda_calibrated measures a CUDA device, "
                             f"got {dev}")
        gen = torch.Generator(device=dev).manual_seed(0)
        m, k, n = CALIBRATION_SHAPE
        a = torch.randn((m, k), generator=gen, device=dev)
        b = torch.randn((k, n), generator=gen, device=dev) / k ** 0.5
        t_mm = _median_ms(lambda: streamed_matmul(a, b)) / 1e3
        src = torch.empty(16 << 20, dtype=torch.float32, device=dev)
        dst = torch.empty_like(src)
        t_d2d = _median_ms(lambda: dst.copy_(src)) / 1e3
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        t_h2d = _median_ms(lambda: dst.copy_(host, non_blocking=True)) / 1e3
        return HWSpec(peak_flops=2 * m * k * n / t_mm,
                      hbm_bw=2 * src.nbytes / t_d2d,
                      stream_bw=host.nbytes / t_h2d, disk_bw=0.0)


CALIBRATION_SHAPE = (1024, 2048, 2048)
CALIBRATION_WARMUP = 2
CALIBRATION_ITERS = 5
# streamed_matmul launches one cuda_calibrated() makes
CALIBRATION_LAUNCHES = CALIBRATION_WARMUP + CALIBRATION_ITERS


def _median_ms(fn) -> float:
    """Median milliseconds of ``fn`` on the current CUDA stream, by CUDA
    events, after ``CALIBRATION_WARMUP`` untimed calls."""
    import torch

    for _ in range(CALIBRATION_WARMUP):
        fn()
    times = []
    for _ in range(CALIBRATION_ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def analytic_capacity_bytes(op: Op, hw: HWSpec,
                            thresholds=None) -> int:
    """TPU-adapted C_l (DESIGN.md §2): on a chip with an independent DMA
    engine, interference is HBM-bandwidth contention, not a shared texture
    bus. A compute-bound op leaves (t_c - t_m) x hbm_bw of free HBM slack;
    the class threshold tolerates th x t_op of extra memory time on top.
    The link itself bounds what can physically move during the op."""
    th = (thresholds or THRESHOLDS)[op.op_class]
    if th <= 0.0:
        return 0
    t_c = op.flops / hw.peak_flops
    t_m = op.act_bytes / hw.hbm_bw
    t_op = max(t_c, t_m, 1e-9)
    slack = max(0.0, t_c - t_m) * hw.hbm_bw
    tolerated = th * t_op * hw.hbm_bw
    link_cap = (1.0 + th) * t_op * hw.stream_bw
    return int(min(slack + tolerated, link_cap))


def capacities(graph: ModelGraph, chunk_bytes: int, hw: Optional[HWSpec] = None,
               model: Optional[GBTRegressor] = None,
               thresholds=None) -> List[int]:
    """C_l per op, in chunks."""
    hw = hw or HWSpec()
    out = []
    for op in graph.ops:
        if model is not None:
            b = model_capacity_bytes(op, model, hw, thresholds)
        else:
            b = analytic_capacity_bytes(op, hw, thresholds)
        out.append(b // max(chunk_bytes, 1))
    return out


def model_capacity_bytes(op: Op, model: GBTRegressor, hw: HWSpec,
                         thresholds=None) -> int:
    """Largest extra bytes with predicted slowdown <= class threshold."""
    th = (thresholds or THRESHOLDS)[op.op_class]
    if th <= 0.0:
        return 0
    base = float(model.predict(features(op.op_class, op.flops,
                                        op.act_bytes, 0.0))[0])
    limit = base * (1.0 + th)
    lo, hi = 0.0, max(op.act_bytes * 64.0, 1 << 24)
    for _ in range(40):
        mid = (lo + hi) / 2
        t = float(model.predict(features(op.op_class, op.flops,
                                         op.act_bytes, mid))[0])
        if t <= limit:
            lo = mid
        else:
            hi = mid
    return int(lo)


def classify_report(graph: ModelGraph) -> dict:
    counts = {}
    for op in graph.ops:
        counts[op.op_class] = counts.get(op.op_class, 0) + 1
    return counts
