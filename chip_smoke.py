"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each against its plain PyTorch version on the card, runs the streaming
executors, then drives each path through the port's own entry points:

* serving: ``repro_torch.launch.serve`` serving GPT-Neo-1.3B and GPT-Neo-S
  (full width, full depth, seq 1024, random weights from a seed) under a
  2048 MiB weight pool, and a short online replay (``streamed_matmul``,
  ``flash_attention``);
* the fleet: the same two models behind the Router on two replicas, each
  with its own 2048 MiB pool on the one card, once through
  ``repro_torch.launch.serve --replicas 2`` and once over a flash-crowd
  trace (``serving.traces``) with replica 1 killed partway: one terminal
  response per request, outputs against a plain forward, each pool within
  its budget, the killed replica's breaker open and its requests retried
  or failed;
* the model path: Mamba-2-130M (full width, all 24 layers, random weights
  from a seed) through ``models.model.make_step_bundle``, three prefill
  requests at batch 4 x 4096 tokens (``ssd_scan`` in every layer), one
  more under the profiler (device time of ``ssd_scan``, of the matmuls and
  of the rest by kernel name, and the compute stream's idle share), greedy
  decode, and decode against prefill;
* the dense model path: Yi-6B (full width, all 32 layers, bf16, random
  weights drawn on the card from a seed) through the same entry points:
  prefill through the kernel against prefill through its plain version
  and decode from the zero cache against prefill (2 x 256), three prefill
  requests of 2 x 4096 tokens (a bf16 ``flash_attention`` in every layer),
  one more under the profiler, the kernel at that shape against its plain
  version, its tensor-core bound and bf16 SDPA, and decode at batch 8
  over a 4096-slot KV cache;
* the MoE model path: Qwen3-30B-A3B (full width, all 48 layers, 128
  experts top-8, bf16, random weights drawn on the card layer by layer
  from a seed) through the same entry points: prefill through the kernel
  against prefill through its plain version with the share of routes
  that agree, and decode from the zero cache against prefill (2 x 256 at
  capacity factor E / k), three prefill requests of 2 x 4096 tokens (a
  bf16 ``flash_attention`` in every layer) with the share of dropped
  assignments, one more under the profiler (``flash_attention``, the
  expert products, the other matmuls, the rest by kernel name, the idle
  share), decode at batch 8 over a 4096-slot KV cache, and layer 0's MoE
  block alone: gather against the plain dense mode and two gather runs
  bit for bit equal;
* ``kernels.ops.pack`` over the weights of one GPT-Neo-1.3B layer, f32 and
  bf16 (``layout_pack``).

The launch counts are set to 0 just before each path and read just after;
on the serving and fleet paths they must equal the graphs' counts over
the batches each engine executed, plus each engine's calibration.
Any failed check raises and the script exits non-zero without its last
line. It imports nothing of JAX or of the JAX package, needs one card, and
exits non-zero without one.

A kernel's ``ms`` (and its plain version's and the library call's) is one
call between two CUDA events on an idle stream, the wrapper's host
dispatch included, the median of 20 calls. ``device_ms`` (and the library
call's ``library_device_ms``) is device time per call: CUDA events around
20 back-to-back calls, so the host's dispatch of a call overlaps the
device's work on the one before, the median of 5 rounds. ``bound_ms``
takes a launch's operations at the peak of their type: f32 on the FMA
units, bf16 on the tensor cores, where the bf16 ``flash_attention``
kernel computes (``wgmma``).

``ssd_scan`` runs as three passes in four CUDA launches, counted as one
call; phase 3d holds each pass against its plain statement
(``kernels.ssd_scan.chunk_states``, ``state_passing``, ``chunk_outputs``)
and prints its device time by profiler kernel name against its own bound.

Phase 8 also times ``layout_pack``'s library counterpart, the same copy
as one PyTorch call (``view``, ``permute``, ``contiguous``), and times
by the profiler (``kernel_device_ms``: the device time of the call's own
kernel, median of 20, host dispatch never counted), warm (back to back)
and with a cold L2 (each call after a 256 MiB flush), the kernel, that
call and a plain device copy of the same bytes (the card's ceiling for a
copy). For a call as short as a pack's the host's dispatch is longer
than the kernel, so ``device_ms`` then reads the dispatch. It prints the
path ``pack_plan`` chose for each shape and the pass's cold time against
its byte bound. Phase 3 holds the kernel bit-exact at each boundary of
its two paths.

Phase 5c serves the same requests once more with the planner's f32 rate
pinned to what the previous version of the matmul kernel calibrated to,
and both serving runs log the weight pool's evictions in order, so a
change of the plan can be told from a change of the kernels.

The last lines are the kernels' launch counts, the card's name and power
limit as ``nvidia-smi`` reports them, one JSON object with each kernel's
numbers, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import threading
import time
from collections import Counter
from unittest import mock
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# published dense peaks of each H100 part (NVIDIA's data sheets), first
# match on the card's name wins: f32 FLOP/s outside the tensor cores,
# device-memory bytes/s, bf16 FLOP/s on the tensor cores (dense, without
# sparsity), and the power limit in W the rates assume
H100_PEAKS = (("H100 NVL", 60e12, 3.9e12, 835e12, 400.0),
              ("H100 PCIe", 51e12, 2.0e12, 756e12, 350.0),
              ("H100 80GB HBM3", 67e12, 3.35e12, 989e12, 700.0))
SERVE_MODELS = ("gptneo-1.3b", "gptneo-s")
SEQ = 1024
REQUESTS = 4
BUDGET_MB = 2048
TIMED = 20          # timed calls (per round), after 3 untimed ones
ROUNDS = 5          # rounds of back-to-back calls per device-time median
FLUSH_BYTES = 256 << 20   # scratch written before each cold-L2 call
TRACES = 3          # profiler traces a kernel timing may take (see there)
# profiler names of the flush's device work: fill_, and amax, which
# clears its reduction's semaphores with a memset before its kernel
FLUSH_KERNELS = re.compile(r"FillFunctor|reduce_kernel|Memset")
# the f32 rate HWSpec.cuda_calibrated measured with the previous,
# register-staged version of the matmul kernel: 0.3459 ms a call at
# CALIBRATION_SHAPE (1024 x 2048 x 2048) on an H100 80GB HBM3 at 700 W
PREVIOUS_PEAK_FLOPS = 2 * 1024 * 2048 * 2048 / 0.3459e-3
# the fleet phase: two replicas on the one card, each with its own
# BUDGET_MB pool. Run 1 (the CLI): a Poisson trace of 7 requests (seed 0
# at seq 1024: 4 for GPT-Neo-1.3B, 3 for GPT-Neo-S). Run 2: 10 requests of
# a flash crowd on GPT-Neo-S (seed 0: 4 for GPT-Neo-1.3B, 6 for GPT-Neo-S),
# replica 1, the hash ring's home of both models, killed in the crowd. The
# timeout is well above a cold 1.3B request (up to 1.68 s on the card), so
# no retry comes from a slow load.
FLEET_RATE, FLEET_DURATION, FLEET_TIMEOUT_S = 1.4, 4.0, 10.0
CROWD_BASE_RATE, CROWD_DURATION = 0.8, 6.0
CROWD_START, CROWD_SPAN, CROWD_FACTOR = 1.5, 2.0, 8.0
FLEET_VICTIM, FLEET_KILL_S = 1, 3.0
MAMBA = "mamba2-130m"
MAMBA_BATCH, MAMBA_SEQ, MAMBA_REQUESTS = 4, 4096, 3
DECODE_STEPS = 32
CONSIST_BATCH, CONSIST_SEQ = 2, 256
DENSE = "yi-6b"
DENSE_BATCH, DENSE_SEQ, DENSE_REQUESTS = 2, 4096, 3
DENSE_DECODE_BATCH, DENSE_DECODE_STEPS = 8, 16
# Yi-6B logits (up to about 5 with these random weights) of two runs that
# differ in attention's f32 summation order (the kernel's online softmax
# over 64-key tiles, P carried as two bf16 terms, vs the plain version's
# one softmax), or of decode step by step (softmax weights rounded to bf16
# before PV) vs prefill: the bf16 residual stream of 32 layers carries
# one-ulp differences on. A CPU emulation of both at full depth (widths
# 1024 and 2048, seeds 0-1, the earlier FMA kernel's order over 32-key
# tiles written out in PyTorch) read 0.074-0.078 max abs and
# 1.6-1.7% relative L2 for the order, 0.090-0.104 and 1.9-2.1% for decode;
# the checks allow about twice that
DENSE_LOGIT_ATOL = 0.2
DENSE_LOGIT_REL_L2 = 0.05
MOE = "qwen3-moe-30b-a3b"
MOE_BATCH, MOE_SEQ, MOE_REQUESTS = 2, 4096, 3
MOE_DECODE_BATCH, MOE_DECODE_STEPS = 8, 16
MOE_BLOCK_SEQ = 256
MOE_STAGES = ("_router", "_dispatch_group", "_expert_ffn", "_combine_group")
# Qwen3-30B-A3B logits (up to about 5.5 with these random weights) of two
# runs that differ in attention's f32 summation order (kernel vs plain
# version) or of decode step by step vs prefill (2 x 256, 48 layers,
# capacity E / k so that prefill drops nothing). Beside one-ulp residuals,
# near-tied routes flip between the two runs (about a quarter of the
# slots by layer 47) and each flip moves its token by a whole expert's
# share. On an H100 80GB HBM3 at 700 W (seed 5) the two checks read 0.285
# and 0.242 max abs, 5.4% and 5.1% relative L2; over seeds 5-8
# (tools/moe_consistency_seeds.py) at most 0.354 and 5.7%. The checks
# allow 1.7x and 2.1x that
MOE_LOGIT_ATOL = 0.6
MOE_LOGIT_REL_L2 = 0.12
# the MoE block of layer 0 at 1 x 256 (capacity E / k, outputs up to
# about 1.2): gather against the plain dense mode, the same products on
# the same rows summed in another order, read 3.9e-3 max abs (one bf16
# ulp) and 2.7e-5 relative L2 on that card; one route in a thousand
# wrong would move the relative L2 past 1e-3
MOE_BLOCK_ATOL = 1e-2
MOE_BLOCK_REL_L2 = 1e-3
# a bf16 flash_attention output against its plain version: both round an
# f32 result to bf16, so an element may be one bf16 ulp apart (rtol 2^-7)
# above a floor for outputs near zero; the rounding alone gives a relative
# L2 error near 2^-9, and a 1% limit catches a missing key tile
BF16_ATTN_ATOL, BF16_ATTN_RTOL, BF16_ATTN_REL_L2 = 1e-3, 2 ** -7, 1e-2
# the CUDA kernels of one ssd_scan call, by profiler name: its pass and
# the ptxas entry of the build that runs with 16-byte aligned rows
SSD_PASSES = {"chunk_state_kernel": ("1 chunk states", "ILi4E"),
              "state_pass_kernel": ("2 state passing", "E"),
              "cb_kernel": ("3a C B^T", "ILi4E"),
              "chunk_out_kernel": ("3b chunk outputs", "ILi4E")}
# profiler names of the library's matmul kernels (cuBLAS, CUTLASS)
MATMUL_NAMES = re.compile(r"gemm|nvjet|cutlass|xmma|cublas", re.I)
# Mamba-2 logits of two runs that differ only in the order of the SSD's
# f32 sums (kernel vs ssd_chunked in prefill, or the recurrence step by
# step in decode vs the chunked scan): with these random weights the bf16
# residual stream of 24 layers amplifies such differences to a max abs
# error of 0.02-0.03 and a relative L2 error of about 4% on logits up to
# about 0.6 (what these two checks read on an H100). The checks allow
# twice that. A near-tie can then change the argmax, so decode's pick must
# be within LOGIT_ATOL of the prefill's best logit; whether the argmax is
# the same is printed.
LOGIT_ATOL = 6e-2
LOGIT_REL_L2 = 0.1
SOURCES = {n: f"src/repro_torch/kernels/csrc/{n}.cu" for n in
           ("streamed_matmul", "flash_attention", "ssd_scan", "layout_pack")}
REPLACES = {"streamed_matmul": "src/repro/kernels/streamed_matmul.py:66",
            "flash_attention": "src/repro/kernels/flash_attention.py:111",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:97",
            "layout_pack": "src/repro/kernels/layout_pack.py:37"}


def log(*parts):
    print(*parts, flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def device_ms(fn, n: int = TIMED, rounds: int = ROUNDS) -> float:
    """Device time of one call of ``fn`` in ms, after 3 untimed calls: the
    median over ``rounds`` of CUDA events around ``n`` back-to-back calls,
    divided by ``n``. The host's dispatch of a call overlaps the device's
    work on the one before, so this is the kernels' time, not the
    wrapper's."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def call_ms(fn, n: int = TIMED) -> float:
    """Median time of ``n`` single calls of ``fn`` in ms, each between two
    CUDA events on an idle stream, after 3 untimed calls: the wrapper's
    host dispatch included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_device_ms(fn, *, cold: bool, n: int = TIMED) -> float:
    """Device time in ms of the one kernel ``fn`` launches, by the
    profiler: the median over ``n`` calls, host dispatch never counted.
    The trace runs the calls twice and keeps the second round (the first
    is the profiler's warm-up), each round between 10 ms of idle time, so
    no activity of the kept round falls outside the traced window. Warm:
    the calls back to back, so the operands of one call are in the L2 for
    the next as far as they fit. Cold: each call preceded by a flush that
    writes a 256 MiB scratch buffer (5x the 50 MB L2), then reads half of
    it, so the lines it leaves are clean and no write-back of the flush
    falls into the timed kernel; the flush's kernels are told apart by
    name (``FLUSH_KERNELS``). In a long process a trace has been seen to
    lose some or all of its activities, so the median is over the
    launches it kept, at least half of them, and a trace that kept fewer
    is taken again, up to ``TRACES`` traces in all."""
    from torch.profiler import ProfilerActivity, profile, schedule
    scratch = torch.empty(FLUSH_BYTES // 4 if cold else 0, device="cuda")
    fn()
    torch.cuda.synchronize()
    for _ in range(TRACES):
        events = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: events.extend(
                         (ev.name, ev.time_range.elapsed_us())
                         for ev in p.events()
                         if ev.device_type == torch.autograd.DeviceType.CUDA)
                     ) as prof:
            for _ in range(2):
                time.sleep(0.01)
                for _ in range(n):
                    if cold:
                        scratch.fill_(1.0)
                        scratch[: scratch.numel() // 2].amax()
                    fn()
                torch.cuda.synchronize()
                time.sleep(0.01)
                prof.step()
        kernels = Counter(name for name, _ in events
                          if not FLUSH_KERNELS.search(name))
        if sum(kernels.values()) >= n // 2:
            break
        log(f"[timing] a trace kept {dict(kernels)} of {n} calls; traced "
            f"again")
    del scratch
    check(len(kernels) == 1,
          f"kernel timing: the calls launched {dict(kernels)}")
    (name, count), = kernels.items()
    check(n // 2 <= count <= n,
          f"kernel timing: {count} launches of {name} in {n} calls")
    return float(np.median([us for kname, us in events
                            if kname == name])) / 1e3


def ptxas_usage(log: str) -> dict:
    """{kernel entry (mangled name): (registers, spill store bytes, spill
    load bytes)} from ``nvcc -Xptxas -v`` output."""
    out, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), *spills)
            name = None
    return out


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def card_peaks(smi: str):
    """(f32 FLOP/s, device-memory bytes/s, bf16 tensor-core FLOP/s) of the
    card ``nvidia-smi`` names (its "name, power.limit" line): its part's
    published peaks, the FLOP rates scaled by power.limit over the part's
    rated limit when the card is set below it (the SM clock falls with the
    limit, the memory clock does not). Raises on a part without published
    peaks here."""
    name, limit = (f.strip() for f in smi.rsplit(",", 1))
    watts = float(limit.split()[0])
    for part, flops, mem_bw, bf16_flops, rated_w in H100_PEAKS:
        if part in name:
            scale = min(1.0, watts / rated_w)
            return flops * scale, mem_bw, bf16_flops * scale
    raise ValueError(f"no published peaks for the card {name!r}")


def bound_ms(flops: float, nbytes: float, peaks, dtype=torch.float32):
    """The least time the card could take: (ms, what bounds it). The
    operations run at the peak of their type: f32 on the FMA units, bf16
    on the tensor cores."""
    rate = peaks[2] if dtype == torch.bfloat16 else peaks[0]
    t_ops, t_bytes = flops / rate, nbytes / peaks[1]
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")


def shape_work(kernel: str, key):
    """(FLOPs, bytes) one launch at the wrapper's shape ``key`` needs: each
    input read once, the output written once. Matmul in f32; attention in
    its key's dtype (4 or 2 B an element); causal attention counts the
    s(s+1)/2 visible (q, k) pairs per head, 2 hd FLOPs each for QK^T and for
    PV. The SSD scan (f32) counts, per chunk of Q, the Q(Q+1)/2 causal
    pairs once for C B^T (shared by the heads, 2N each) and per head for
    the product with X (2P each), plus C . state and the state update
    (2QNP each per head). Packing moves bytes only: R x C
    read, the padded output written."""
    if kernel == "streamed_matmul":
        m, k, n = key
        return 2.0 * m * k * n, 4.0 * (m * k + k * n + m * n)
    if kernel == "ssd_scan":
        b, s, h, p, n, q = key
        pairs = q * (q + 1) / 2
        flops = b * (s // q) * (h * (2 * pairs * p + 4 * q * n * p)
                                + 2 * pairs * n)
        return flops, 4.0 * (2 * b * s * h * p + 2 * b * s * n + b * s * h
                             + 2 * h)
    if kernel == "layout_pack":
        r, c, tr, tc, dtype = key
        padded = -(-r // tr) * tr * (-(-c // tc) * tc)
        return 0.0, float(dtype.itemsize) * (r * c + padded)
    b, sq, sk, hq, hkv, hd, causal, window, dtype = key
    check(sq == sk and window == 0, f"attention work at {key}")
    pairs = sq * (sq + 1) / 2 if causal else sq * sk
    return 4.0 * hd * pairs * hq * b, float(dtype.itemsize) * b * hd * (
        2 * sq * hq + 2 * sk * hkv)


def ssd_pass_work(key) -> dict:
    """{pass: (FLOPs, bytes)} of each pass of one ``ssd_scan`` call at
    ``key`` (B, S, H, P, N, Q), f32: each pass's inputs read once and its
    outputs written once, the workspace included. Pass 1 forms each
    chunk's state (2QNP a chunk and head), pass 2 hands the states on (2NP),
    pass 3a C B^T over the causal pairs once per batch row (2N a pair; it
    writes whole 64 x 64 causal tiles), pass 3b the causal (..) X (2P a
    pair) and C . S_in (2QNP)."""
    b, s, h, p, n, q = key
    nc, pairs = s // q, q * (q + 1) / 2
    tiles = -(-q // 64)
    g_tiles = b * nc * tiles * (tiles + 1) / 2 * 64 * 64
    states = b * h * nc * n * p
    return {
        "1 chunk states": (2.0 * b * h * s * n * p, 4.0 * (
            b * s * h * p + b * s * n + b * s * h + states + b * h * s
            + b * h * nc)),
        "2 state passing": (2.0 * states, 4.0 * (2 * states + b * h * nc)),
        "3a C B^T": (2.0 * n * pairs * b * nc, 4.0 * (2 * b * s * n
                                                      + g_tiles)),
        "3b chunk outputs": (b * h * nc * (2 * pairs * p + 2 * q * n * p),
                             4.0 * (2 * b * s * h * p + b * s * n + states
                                    + g_tiles + 2 * b * h * s))}


def device_by_name(prof) -> Counter:
    """Device time in ms by kernel name of a profiler run."""
    out = Counter()
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if dev_us > 0:
            out[ev.key] += dev_us / 1e3
    return out


def short_kernel_name(name: str) -> str:
    """A profiler kernel name cut to what tells PyTorch's generic kernels
    apart: the functors and ops named in its template arguments (e.g.
    ``vectorized_elementwise_kernel[CUDAFunctor_add]``), else its head."""
    name = name.replace("(anonymous namespace)::", "")
    if "<" not in name:
        return name[:70]
    head = re.split(r"[<(]", name.replace("void ", "", 1), 1)[0]
    ops = list(dict.fromkeys(re.findall(
        r"\b(\w*(?:Functor|_functor)\w*|\w+Op|\w+_kernel_cuda)\b", name)))
    return f"{head}[{', '.join(ops[:3])}]" if ops else head[:70]


def ssd_pass_of(name: str):
    """The ``ssd_scan`` pass a profiler kernel name belongs to, or None."""
    return next((label for k, (label, _) in SSD_PASSES.items() if k in name),
                None)


def weight_shapes(cfg) -> dict:
    """(K, N) of each projection weight of a GPT-Neo-style ``cfg``."""
    d, hd, ff = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    return {"wq": (d, nq * hd), "wk": (d, nkv * hd), "wv": (d, nkv * hd),
            "wo": (nq * hd, d), "ffn_in": (d, ff), "ffn_gate": (d, ff),
            "ffn_out": (ff, d), "lm_head": (d, cfg.vocab)}


def path_shapes(cfg, seq: int, batch: int = 1) -> Counter:
    """The kernel launches one request of ``cfg`` makes, from the planning
    graph the executors run, keyed as the wrappers count them:
    ("streamed_matmul", (M, K, N)) per projection and ("flash_attention",
    (B, S, S, Hq, Hkv, hd, True, 0, f32)) per attention."""
    from repro_torch.core.graph import build_lm_graph
    wshape = weight_shapes(cfg)
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    out = Counter()
    for op in build_lm_graph(cfg, seq=seq, batch=batch, dtype_bytes=4).ops:
        if op.kind == "matmul":
            out[("streamed_matmul",
                 (batch * seq, *wshape[op.name.split(".")[-1]]))] += 1
        elif op.kind == "attention":
            out[("flash_attention",
                 (batch, seq, seq, nq, nkv, hd, True, 0, torch.float32))] += 1
    return out


def layer_weights(cfg) -> list:
    """(name, (K, N)) of every projection weight of ``cfg``'s layer 0, in
    the planning graph's order."""
    from repro_torch.core.graph import build_lm_graph
    wshape = weight_shapes(cfg)
    return [(op.name, wshape[op.name.split(".")[-1]]) for op in
            build_lm_graph(cfg, seq=1, batch=1, dtype_bytes=4).ops
            if op.kind == "matmul" and op.layer == 0]


def bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s elements as integers of the same width, for bit-exact
    comparison."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.dtype.itemsize])


def pack_input(r: int, c: int, dtype: torch.dtype, skew: int, gen,
               dev) -> torch.Tensor:
    """A contiguous [r, c] of ``dtype`` on ``dev`` from ``gen`` (normal
    values for floats, all bit patterns for integers) whose data starts
    ``skew`` bytes past a 16-byte boundary."""
    n = r * c + skew // dtype.itemsize
    if dtype.is_floating_point:
        flat = torch.randn(n, generator=gen).to(dtype)
    else:
        info = torch.iinfo(dtype)
        flat = torch.randint(info.min, info.max, (n,), generator=gen,
                             dtype=dtype)
    return flat.to(dev)[skew // dtype.itemsize:].view(r, c)


@contextlib.contextmanager
def eviction_log():
    """Records the weight pool's evictions in order while it is open, as
    (request, thread, model of the evicted entry): ``request`` counts the
    serving engine's finished requests, so an eviction made while request
    i runs, or by the prefetch of the request after it, carries i; the
    thread is "run" for the engine's own and "prefetch" for the others."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.weight_cache import WeightCache
    events, done = [], [0]
    select, release = WeightCache._select_victims, \
        ServingEngine._release_protection

    def logged_select(cache, need):
        victims = select(cache, need)
        by = "run" if threading.current_thread() is threading.main_thread() \
            else "prefetch"
        events.extend((done[0], by, WeightCache._model_of(k))
                      for k in victims or ())
        return victims

    def counted_release(engine, name):
        release(engine, name)
        done[0] += 1

    with mock.patch.object(WeightCache, "_select_victims", logged_select), \
            mock.patch.object(ServingEngine, "_release_protection",
                              counted_release):
        yield events


def eviction_order(events) -> str:
    """The evictions of ``eviction_log`` in order, one run of entries of
    one model evicted by one thread during one request per item."""
    runs = []
    for req, by, model in events:
        if runs and runs[-1][:3] == [req, by, model]:
            runs[-1][3] += 1
        else:
            runs.append([req, by, model, 1])
    return ", ".join(f"req {r} {by} evicted {m} x {c}"
                     for r, by, m, c in runs) or "none"


def by_kernel(shapes: Counter) -> Counter:
    """Launch totals per kernel of a (kernel, shape key) counter."""
    out = Counter()
    for (kn, _), c in shapes.items():
        out[kn] += c
    return out


def close(got, want, atol, rtol, what) -> float:
    """Max abs error of ``got`` against ``want``, checked against ``atol``
    and ``rtol``."""
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)
    check(ok and math.isfinite(err), f"{what}: max abs err {err:.3e} "
          f"beyond atol={atol} rtol={rtol}")
    return err


def logits_close(got, want, what, atol=LOGIT_ATOL, rel_l2=LOGIT_REL_L2):
    """Max abs and relative L2 error of two runs' logits, checked against
    ``atol`` and ``rel_l2``."""
    err = close(got, want, atol, 0.0, what)
    rel = ((got - want).norm() / want.norm()).item()
    check(rel <= rel_l2, f"{what}: relative L2 error {rel:.3e} beyond "
          f"{rel_l2}")
    return err, rel


def flash_key(cfg, batch: int, seq: int) -> tuple:
    """The bf16 ``flash_attention`` launch key of one prefill layer."""
    return ("flash_attention", (batch, seq, seq, cfg.n_heads, cfg.n_kv_heads,
                                cfg.resolved_head_dim, True, 0,
                                torch.bfloat16))


def counted() -> Counter:
    """The port's kernel launches since the last reset, by (kernel, key)."""
    from repro_torch.kernels import ops
    return Counter({(kn, key): c for kn, by_shape in
                    ops.launch_counts_by_shape().items()
                    for key, c in by_shape.items()})


def draw_by_layer(specs, gen: torch.Generator, dev) -> dict:
    """Parameters of ``specs`` drawn on ``dev`` from ``gen``, the stacked
    ``blocks`` one layer at a time: ``init_params`` draws each leaf in f32
    before the cast, and a stacked expert leaf of Qwen3-30B-A3B would need
    a 38.6 GB f32 temporary. Each stacked bf16 leaf is allocated first and
    layer i is filled from ``init_params`` on the per-layer specs."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer
    params = shd.init_params({k: v for k, v in specs.items()
                              if k != "blocks"}, gen, dev)
    blocks = shd.spec_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                                device=dev), specs["blocks"])
    layer_specs = transformer.strip_layer_axis(specs["blocks"])
    n_layers = shd.tree_leaves(blocks)[0].shape[0]
    for i in range(n_layers):
        shd.tree_map(lambda dst, src: dst[i].copy_(src), blocks,
                     shd.init_params(layer_specs, gen, dev))
    params["blocks"] = blocks
    return params


@contextlib.contextmanager
def moe_recording():
    """While open, each MoE block's expert ids [T, k] and ``dropped_frac``
    (device tensors, in call order: layer by layer, step by step) land in
    the two lists it yields."""
    from repro_torch.models import moe as moe_mod
    routes, dropped = [], []
    router, apply = moe_mod._router, moe_mod.apply_moe

    def recorded_router(*a):
        out = router(*a)
        routes.append(out[1])
        return out

    def recorded_apply(*a, **kw):
        y, aux = apply(*a, **kw)
        dropped.append(aux["dropped_frac"])
        return y, aux
    with mock.patch.object(moe_mod, "_router", recorded_router), \
            mock.patch.object(moe_mod, "apply_moe", recorded_apply):
        yield routes, dropped


def route_agreement(a: torch.Tensor, b: torch.Tensor, n_experts: int):
    """Two runs' expert ids [..., k]: the share of slots with the same id,
    and the share of each token's k experts that both runs chose."""
    slots = (a == b).float().mean()
    chosen = [torch.zeros((*t.shape[:-1], n_experts), dtype=torch.bool,
                          device=t.device).scatter_(-1, t, True)
              for t in (a, b)]
    sets = (chosen[0] & chosen[1]).sum(-1).float().mean() / a.shape[-1]
    return slots.item(), sets.item()


@contextlib.contextmanager
def moe_ranges():
    """While open, each call of the MoE layer's four stages (``_router``,
    ``_dispatch_group``, ``_expert_ffn``, ``_combine_group``) runs in a
    profiler range of its name, so a profile can read each stage's device
    time."""
    from repro_torch.models import moe as moe_mod

    def ranged(name, fn):
        def run(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return run
    with contextlib.ExitStack() as stack:
        for name in MOE_STAGES:
            stack.enter_context(mock.patch.object(
                moe_mod, name, ranged(name, getattr(moe_mod, name))))
        yield


def profile_split(prof, wall_s: float) -> tuple:
    """A profiler run over the CPU and the card, as ms of kernel time:
    ``flash_attention`` (by kernel name), the kernels of ``aten::bmm`` (the
    MoE layer's expert products; attention's products in decode), those of
    ``aten::mm`` (the projections, the router, the head) and the rest; the
    kernel time of each MoE stage of ``moe_ranges`` (its products
    included; 0 without MoE blocks); the rest's kernels by name; the kernel
    total; and the compute stream's idle share of ``wall_s``. A stage's
    range also shows as a span on the device (the profiler's annotation,
    no kernel): it is left out of the kernels."""
    kernels, ops_ = Counter(), Counter()
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if ev.key not in MOE_STAGES:
                kernels[ev.key] += ev.self_device_time_total / 1e3
        elif ev.key in ("aten::bmm", "aten::mm") + MOE_STAGES:
            ops_[ev.key] += ev.device_time_total / 1e3
    busy = sum(kernels.values())
    flash = sum(ms_ for k, ms_ in kernels.items()
                if "flash_tc_kernel" in k or "flash_kernel" in k)
    split = {"flash_attention": flash, "bmm": ops_["aten::bmm"],
             "mm": ops_["aten::mm"],
             "rest": busy - flash - ops_["aten::bmm"] - ops_["aten::mm"]}
    rest = Counter({k: ms_ for k, ms_ in kernels.items()
                    if "flash" not in k and not MATMUL_NAMES.search(k)})
    return (split, {n: ops_[n] for n in MOE_STAGES}, rest, busy,
            1 - busy / 1e3 / wall_s)


def profiled_call(fn, ranges=contextlib.nullcontext) -> tuple:
    """One call of ``fn`` under the profiler (the CPU and the card) with
    ``ranges`` open: its wall in s, then ``profile_split``'s readings."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with ranges(), profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return (wall, *profile_split(prof, wall))


def consistency(name: str, arch, params, gen, dev, env, atol: float,
                rel_l2: float, record=contextlib.nullcontext) -> dict:
    """At CONSIST_BATCH x CONSIST_SEQ over all of ``arch``'s layers:
    prefill through ``flash_attention`` (one launch a layer) against the
    same prefill through its plain version, then decode step by step from
    the zero cache (no launch) against the prefill, both logits within
    ``atol`` max abs and ``rel_l2`` relative L2. ``record`` wraps each of
    the three runs; what it yields comes back under ``kernel``, ``plain``
    and ``decode``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model
    cfg = arch.model
    cpre = model.make_step_bundle(arch, ShapeConfig(
        "prefill", CONSIST_SEQ, CONSIST_BATCH, "prefill"), env)
    cdec = model.make_step_bundle(arch, ShapeConfig(
        "decode", CONSIST_SEQ, CONSIST_BATCH, "decode"), env)
    prompt = torch.randint(0, cfg.vocab, (CONSIST_BATCH, CONSIST_SEQ),
                           generator=gen, device=dev, dtype=torch.int32)
    ops.reset_launch_counts()
    with record() as kernel_rec:
        want = cpre.fn(params, {"tokens": prompt})
        torch.cuda.synchronize()
    check(counted() == Counter({flash_key(cfg, CONSIST_BATCH, CONSIST_SEQ):
                                cfg.num_layers}),
          f"consistency prefill launches {dict(counted())}")
    with record() as plain_rec, \
            mock.patch.object(ops, "attention", ref.flash_attention_ref):
        plain_out = cpre.fn(params, {"tokens": prompt})
        torch.cuda.synchronize()
    plain_err, plain_rel = logits_close(
        want, plain_out, f"{name} prefill through flash_attention vs "
        f"through its plain version", atol, rel_l2)
    same_argmax = int((want.argmax(-1) == plain_out.argmax(-1)).sum())
    del plain_out
    cache = shd.init_params(cdec.arg_specs[1], gen, dev)          # zeros
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with record() as decode_rec:
        for t in range(CONSIST_SEQ):
            got, cache = cdec.fn(params, cache, prompt[:, t:t + 1],
                                 torch.full((CONSIST_BATCH,), t,
                                            dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    check(sum(ops.launch_counts().values()) == 0,
          f"decode launched kernels: {ops.launch_counts()}")
    consist_err, consist_rel = logits_close(
        got, want, f"{name} decode from the zero cache vs prefill", atol,
        rel_l2)
    return {"want": want, "got": got, "plain_err": plain_err,
            "plain_rel": plain_rel, "same_argmax": same_argmax,
            "consist_err": consist_err, "consist_rel": consist_rel,
            "decode_s": decode_s, "kernel": kernel_rec, "plain": plain_rec,
            "decode": decode_rec}


def prefill_requests(name: str, cfg, pre, params, gen, dev, n: int,
                     batch: int, seq: int,
                     record=contextlib.nullcontext) -> dict:
    """``n`` prefill requests of ``batch`` x ``seq`` tokens through the
    bundle ``pre``: each request's wall and what ``record`` yielded around
    it, finite logits, and the launches by (kernel, key), exactly one bf16
    ``flash_attention`` a layer. Returns those and the last request's
    tokens."""
    from repro_torch.kernels import ops
    requests = [torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                              device=dev, dtype=torch.int32)
                for _ in range(n)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    walls, recs = [], []
    for toks in requests:
        with record() as rec:
            t0 = time.perf_counter()
            out = pre.fn(params, {"tokens": toks})
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        recs.append(rec)
        check(tuple(out.shape) == (batch, 1, cfg.vocab)
              and bool(torch.isfinite(out).all()),
              f"{name} prefill logits {tuple(out.shape)} not finite")
    shapes = counted()
    key = flash_key(cfg, batch, seq)
    check(shapes == Counter({key: cfg.num_layers * n}),
          f"prefill launches {dict(shapes)}, expected {cfg.num_layers} a "
          f"request at {key}")
    return {"walls": walls, "records": recs, "shapes": shapes,
            "last": requests[-1]}


def decode_run(name: str, arch, params, gen, dev, env, batch: int,
               seq: int, steps: int, ranges=contextlib.nullcontext) -> dict:
    """Decode at ``batch`` over a cache of ``seq`` slots, the last
    ``steps`` positions, each step's pick fed back: each step's wall, no
    kernel launch and finite logits; then one more step under
    ``profiled_call``. Returns the walls, the cache and that profile."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.models import model
    cfg = arch.model
    dec = model.make_step_bundle(arch, ShapeConfig("decode", seq, batch,
                                                   "decode"), env)
    cache = shd.init_params(dec.arg_specs[1], gen, dev)           # zeros
    tok = torch.randint(0, cfg.vocab, (batch, 1), generator=gen, device=dev,
                        dtype=torch.int32)
    ops.reset_launch_counts()
    walls = []
    for t in range(seq - steps, seq):
        t0 = time.perf_counter()
        out, cache = dec.fn(params, cache, tok, torch.full(
            (batch,), t, dtype=torch.int32, device=dev))
        tok = out.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    check(sum(ops.launch_counts().values()) == 0,
          f"decode launched kernels: {ops.launch_counts()}")
    check(tuple(out.shape) == (batch, 1, cfg.vocab)
          and bool(torch.isfinite(out).all()),
          f"{name} decode logits not finite")
    pos = torch.full((batch,), seq - 1, dtype=torch.int32, device=dev)
    prof = profiled_call(lambda: dec.fn(params, cache, tok, pos), ranges)
    return {"walls": walls, "cache": cache, "profile": prof}


def ms_list(split: dict) -> str:
    """A ``profile_split`` split as text."""
    return ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())


def stage_list(stages: dict) -> str:
    return ", ".join(f"{k.strip('_')} {v:.3f} ms" for k, v in stages.items())


def moe_arch_at_full_capacity(arch):
    """``arch`` with capacity factor E / k: the capacity is then at least
    the row length, so a prefill drops nothing and decode can be held to
    it."""
    m = arch.model.moe
    return replace(arch, model=replace(arch.model, moe=replace(
        m, capacity_factor=m.n_experts / m.top_k)))


def moe_consistency(name: str, arch, params, gen, dev, env) -> dict:
    """``consistency`` of an MoE model at capacity E / k with each layer's
    routes recorded: no assignment dropped in any run, the share of routes
    that agree between the kernel's and the plain prefill and between
    decode and prefill (by slot and by chosen expert), logged."""
    carch = moe_arch_at_full_capacity(arch)
    cfg, m = carch.model, carch.model.moe
    n_layers = cfg.num_layers
    r = consistency(name, carch, params, gen, dev, env, MOE_LOGIT_ATOL,
                    MOE_LOGIT_REL_L2, moe_recording)
    (kernel_routes, k_drop), (plain_routes, _), (decode_routes, d_drop) = \
        r["kernel"], r["plain"], r["decode"]
    check(len(k_drop) == n_layers and float(torch.stack(k_drop).max())
          == 0.0, "the prefill at capacity E / k dropped assignments")
    check(float(torch.stack(d_drop).max()) == 0.0, "decode dropped")
    agree = [route_agreement(a, b, m.n_experts)
             for a, b in zip(kernel_routes, plain_routes)]
    slots, sets = route_agreement(torch.stack(kernel_routes),
                                  torch.stack(plain_routes), m.n_experts)
    # decode's routes of token t in layer l against the prefill's
    dec_slots, dec_sets = route_agreement(
        torch.stack(decode_routes).view(CONSIST_SEQ, n_layers,
                                        CONSIST_BATCH, m.top_k),
        torch.stack(kernel_routes).view(n_layers, CONSIST_BATCH, CONSIST_SEQ,
                                        m.top_k).permute(2, 0, 1, 3),
        m.n_experts)
    want, got = r["want"], r["got"]
    log(f"[moe] prefill {CONSIST_BATCH} x {CONSIST_SEQ} at capacity factor "
        f"{m.capacity_factor} (dropped 0 in every layer) through "
        f"flash_attention vs through flash_attention_ref: routes (token, "
        f"layer, slot) agree {slots:.4%} (the least layer "
        f"{min(a[0] for a in agree):.4%}, layer 0 {agree[0][0]:.4%}), "
        f"each token's chosen experts {sets:.4%} (the least layer "
        f"{min(a[1] for a in agree):.4%}); logits "
        f"max abs err {r['plain_err']:.3e} (atol {MOE_LOGIT_ATOL}), relative "
        f"L2 {r['plain_rel']:.3e} (<= {MOE_LOGIT_REL_L2}), |logits| up to "
        f"{want.abs().max().item():.3f}, same argmax in "
        f"{r['same_argmax']}/{CONSIST_BATCH} rows")
    log(f"[moe] decode {CONSIST_SEQ} steps at batch {CONSIST_BATCH} from "
        f"the zero cache ({r['decode_s']:.3f} s, no kernel launch, dropped "
        f"0) vs prefill: routes agree {dec_slots:.4%} by slot, "
        f"{dec_sets:.4%} by chosen expert; logits max abs err "
        f"{r['consist_err']:.3e} (atol {MOE_LOGIT_ATOL}), relative L2 "
        f"{r['consist_rel']:.3e}; decode picks "
        f"{got.argmax(-1).flatten().tolist()}, prefill "
        f"{want.argmax(-1).flatten().tolist()}. At the config's own "
        f"capacity factor {arch.model.moe.capacity_factor} a prefill drops "
        f"assignments that decode (one token a row, 8 slots an expert) "
        f"keeps, by the reference's own semantics, so this check runs at "
        f"E / k")
    return {k: r[k] for k in ("plain_err", "plain_rel", "consist_err",
                              "consist_rel")} | {"slots": slots,
                                                 "dec_slots": dec_slots}


def moe_phase(dev, env, smi: str) -> dict:
    """Phase 7c: Qwen3-30B-A3B (full width, all 48 layers, bf16, random
    weights drawn on the card from a seed) through ``make_step_bundle``.
    Returns the launches of its prefill requests by (kernel, key) and its
    checks' errors."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import model
    from repro_torch.models import moe as moe_mod

    t_phase = time.perf_counter()
    arch = get_arch(MOE)
    cfg, m = arch.model, arch.model.moe
    n_layers = cfg.num_layers
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    pre = model.make_step_bundle(arch, ShapeConfig(
        "prefill", MOE_SEQ, MOE_BATCH, "prefill"), env)
    gen = torch.Generator(device=dev).manual_seed(5)
    t0 = time.perf_counter()
    params = draw_by_layer(pre.arg_specs[0], gen, dev)
    torch.cuda.synchronize()
    log(f"[moe] {smi}: {MOE}: {n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} query and {cfg.n_kv_heads} KV heads of "
        f"{cfg.resolved_head_dim}, {m.n_experts} experts of width {m.d_ff}, "
        f"top-{m.top_k}, capacity factor {m.capacity_factor}, vocab "
        f"{cfg.vocab}, bf16; {shd.param_count(pre.arg_specs[0]) / 1e9:.3f}B "
        f"parameters ({shd.param_bytes(pre.arg_specs[0]) / 1e9:.2f} GB) "
        f"drawn on {dev} layer by layer in {time.perf_counter() - t0:.2f}s "
        f"({before / 1e9:.2f} GB allocated before them); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # (b) full width, all layers, 2 x 256, at capacity factor E / k
    errs = moe_consistency("Qwen3", arch, params, gen, dev, env)

    # (c) prefill requests of MOE_BATCH x MOE_SEQ tokens at the config's
    # capacity factor, then one more under the profiler with each MoE
    # stage (router, dispatch, expert FFN, combine) in a range of its own
    req = prefill_requests("Qwen3", cfg, pre, params, gen, dev, MOE_REQUESTS,
                           MOE_BATCH, MOE_SEQ, moe_recording)
    walls, shapes = req["walls"], req["shapes"]
    drops = [torch.stack(dropped) for _, dropped in req["records"]]
    tokens_req = MOE_BATCH * MOE_SEQ
    log(f"[moe] {smi}: prefill {MOE_REQUESTS} requests of {MOE_BATCH} x "
        f"{MOE_SEQ} tokens: wall {', '.join(f'{w:.4f}' for w in walls)} s, "
        f"{', '.join(f'{tokens_req / w:.0f}' for w in walls)} tokens/s; "
        f"dropped_frac (mean over the layers) "
        f"{', '.join(f'{d.mean().item():.4f}' for d in drops)}, by layer in "
        f"request 0 {[round(d, 3) for d in drops[0].tolist()]}; launches "
        f"{dict(shapes)} ({n_layers} a request); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    prof_wall, split, stages, rest, busy, idle = profiled_call(
        lambda: pre.fn(params, {"tokens": req["last"]}), moe_ranges)
    check(split["flash_attention"] > 0 and split["bmm"] > 0,
          f"the profiler saw no flash_attention or expert products in a "
          f"prefill: {split}")
    warm = min(walls[1:])
    log(f"[moe] {smi}: profiled prefill of {MOE_BATCH} x {MOE_SEQ}: wall "
        f"{prof_wall:.4f} s (warm unprofiled {warm:.4f} s); device time "
        + ", ".join(f"{k} {v:.3f} ms ({v / busy:.1%})"
                    for k, v in split.items())
        + f" (bmm: the expert products; mm: the projections, router and "
        f"head); compute stream busy {busy:.3f} ms, idle {idle:.1%} of the "
        f"profiled wall ({1 - busy / 1e3 / warm:.1%} of the warm wall); by "
        f"MoE stage (its products included) {stage_list(stages)}")
    log(f"[moe] the rest by kernel: " + "; ".join(
        f"{short_kernel_name(k)} {v:.3f} ms" for k, v in rest.most_common(10)))
    del req

    # (d) decode at batch MOE_DECODE_BATCH over a cache of MOE_SEQ slots
    d = decode_run("Qwen3", arch, params, gen, dev, env, MOE_DECODE_BATCH,
                   MOE_SEQ, MOE_DECODE_STEPS, moe_ranges)
    steps, cache = d["walls"], d["cache"]
    step_wall, dsplit, dstages, drest, _, didle = d["profile"]
    log(f"[moe] {smi}: decode {MOE_DECODE_STEPS} steps at batch "
        f"{MOE_DECODE_BATCH}, cache {tuple(cache['k'].shape)} "
        f"({cache['k'].numel() * 4 / 1e9:.2f} GB of k and v), capacity "
        f"{moe_mod.capacity(1, m.n_experts, m.top_k, m.capacity_factor)} "
        f"slots an expert a row: median step {np.median(steps) * 1e3:.3f} "
        f"ms, first {steps[0] * 1e3:.3f} ms, no kernel launch; one step "
        f"profiled: wall {step_wall * 1e3:.3f} ms, device time "
        f"{ms_list(dsplit)}, idle {didle:.1%}; by MoE stage "
        f"{stage_list(dstages)}; the rest's largest kernels: " + "; ".join(
            f"{short_kernel_name(k)} {v:.3f} ms"
            for k, v in drest.most_common(5))
        + f"; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del d, cache

    # (e) the MoE block alone on layer 0's weights at 1 x MOE_BLOCK_SEQ,
    # capacity factor E / k: gather against the plain dense mode, and two
    # gather runs bit for bit equal (the combine adds without atomics)
    ccfg = moe_arch_at_full_capacity(arch).model
    p0 = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    x = torch.randn((1, MOE_BLOCK_SEQ, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    yg, aux = moe_mod.apply_moe(ccfg, p0, x, env, mode="gather")
    yg2, _ = moe_mod.apply_moe(ccfg, p0, x, env, mode="gather")
    yd, _ = moe_mod.apply_moe(ccfg, p0, x, env, mode="dense")
    torch.cuda.synchronize()
    check(float(aux["dropped_frac"]) == 0.0, "the block dropped")
    check(torch.equal(bits(yg), bits(yg2)),
          "two gather runs of the MoE block differ")
    block_err = close(yg, yd, MOE_BLOCK_ATOL, 0.0,
                      "MoE block gather vs dense")
    block_rel = ((yg.float() - yd.float()).norm() / yd.float().norm()).item()
    check(block_rel <= MOE_BLOCK_REL_L2, f"MoE block gather vs dense: "
          f"relative L2 {block_rel:.3e} beyond {MOE_BLOCK_REL_L2}")
    gather_ms = device_ms(lambda: moe_mod.apply_moe(ccfg, p0, x, env),
                          n=5, rounds=3)
    dense_ms = device_ms(lambda: moe_mod.apply_moe(ccfg, p0, x, env,
                                                   mode="dense"),
                         n=5, rounds=3)
    log(f"[moe] {smi}: the MoE block of layer 0 at 1 x {MOE_BLOCK_SEQ}, "
        f"capacity factor {ccfg.moe.capacity_factor}: gather vs dense max "
        f"abs err {block_err:.3e} (atol {MOE_BLOCK_ATOL}), relative L2 "
        f"{block_rel:.3e} (<= {MOE_BLOCK_REL_L2}), |y| up to "
        f"{yd.abs().max().item():.3f}; two gather runs bit for bit equal; "
        f"device time gather {gather_ms:.3f} ms, dense {dense_ms:.3f} ms; "
        f"the phase took {time.perf_counter() - t_phase:.1f} s")
    del params, p0, x, yg, yg2, yd
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"shapes": shapes, "plain_err": errs["plain_err"],
            "consist_err": errs["consist_err"], "block_err": block_err}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_arch
    from repro_torch.core.capacity import (CALIBRATION_LAUNCHES,
                                           CALIBRATION_SHAPE, HWSpec)
    from repro_torch.core.plan import plan_always_next
    from repro_torch.core.streaming import (HostModel, PreloadExecutor,
                                            StreamingExecutor,
                                            _build_programs, chunk_rows)
    from repro_torch.device import HostToDevice
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.layout_pack import layout_pack, pack_plan
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.kernels.ssd_scan import chunk_len, ssd_scan
    from repro_torch.kernels.streamed_matmul import streamed_matmul, tile_for
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving.stream import stamp_req_ids
    from repro_torch.models import model
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.ssm import ssd_chunked
    from torch.profiler import ProfilerActivity, profile

    t_start = time.perf_counter()
    dev = torch.device("cuda:0")

    # ---- 1. device --------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    peaks = card_peaks(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {name} count={count} ({smi}) torch {torch.__version__} "
        f"cuda {torch.version.cuda}; bound from {peaks[0]:.4g} FLOP/s f32, "
        f"{peaks[2]:.4g} FLOP/s bf16 on the tensor cores and {peaks[1]:.4g} "
        f"B/s")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {len(_build.SOURCES)} kernels built in "
        f"{time.perf_counter() - t0:.2f}s "
        f"(one nvcc per source, in parallel) into {_build.BUILD_DIR}")
    for kname, info in _build.BUILD_LOG.items():
        for line in info["log"].splitlines():
            if "Compiling entry function" in line or (
                    "Used" in line and "registers" in line) or (
                    "spill" in line and not line.strip().startswith(
                        "0 bytes stack frame, 0 bytes spill stores, 0 bytes")):
                log(f"[build] {kname} ({info['seconds']:.2f}s): "
                    f"{line.strip()}")

    # ---- 3. kernels against their plain versions --------------------------
    gen = torch.Generator(device="cpu").manual_seed(0)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    def close_bf16_attention(got, want, what) -> tuple:
        """A bf16 attention output against its plain version. Both compute
        in f32 and round to bf16, so an element may land one bf16 ulp
        apart: |got - want| <= BF16_ATTN_ATOL + 2^-7 |want| (the form of
        tests/test_torch_attention.py's ULP_TOL), and the earlier 2e-2
        max-abs limit beside it. The whole output is held to
        BF16_ATTN_REL_L2 relative L2, which a dropped key tile in the late
        rows (outputs near 0.02 at S = 4096) would break. Returns (max abs
        error, relative L2 error, the largest error over its one-ulp
        limit)."""
        g, w = got.float(), want.float()
        diff = (g - w).abs()
        err = close(got, want, 2e-2, 0.0, what)
        ulp = (diff / (BF16_ATTN_ATOL + BF16_ATTN_RTOL * w.abs())).max()
        rel = ((g - w).norm() / w.norm()).item()
        check(ulp.item() <= 1.0, f"{what}: an element {ulp.item():.3f}x its "
              f"limit atol {BF16_ATTN_ATOL} + rtol 2^-7 |plain| (max abs "
              f"err {err:.3e})")
        check(rel <= BF16_ATTN_REL_L2, f"{what}: relative L2 error "
              f"{rel:.3e} beyond {BF16_ATTN_REL_L2}")
        return err, rel, ulp.item()

    # (a) the JAX kernel tests' sweeps (tests/test_kernels.py:13-55), plus
    # ragged shapes (K split into ranges that are not whole K tiles, rows
    # not 16-byte aligned, ragged key tiles at every head dim); B is scaled
    # like HostModel's weights (1/sqrt(K))
    sweep_mm = [(8, 128, 128), (64, 256, 128), (128, 128, 384),
                (256, 512, 256), (40, 128, 256), (37, 100, 61),
                (33, 130, 770), (64, 3100, 768), (33, 3074, 770)]
    for (m, k, n) in sweep_mm:
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            a, b = rnd(m, k, dtype=dt), rnd(k, n, scale=k ** -0.5, dtype=dt)
            got = streamed_matmul(a, b)
            torch.cuda.synchronize()
            close(got, ref.matmul_ref(a, b), tol, tol,
                  f"streamed_matmul {(m, k, n)} {dt}")
    sweep_fa = [(2, 128, 128, 4, 2, 64), (1, 256, 256, 4, 4, 32),
                (2, 64, 64, 2, 1, 16), (1, 128, 128, 8, 8, 128),
                (1, 128, 128, 4, 2, 64), (1, 100, 100, 4, 2, 64),
                (1, 100, 100, 4, 2, 128), (1, 256, 256, 8, 1, 128)]
    fa_bf16_worst = (0.0, 0.0, 0.0)     # (max abs, rel L2, share of limit)
    for (b_, sq, sk, hq, hkv, hd) in sweep_fa:
        for causal, window in ((True, 0), (True, 64), (False, 0)):
            for dt in (torch.float32, torch.bfloat16):
                q = rnd(b_, sq, hq, hd, dtype=dt)
                k = rnd(b_, sk, hkv, hd, dtype=dt)
                v = rnd(b_, sk, hkv, hd, dtype=dt)
                got = flash_attention(q, k, v, causal=causal, window=window)
                torch.cuda.synchronize()
                want = ref.flash_attention_ref(q, k, v, causal=causal,
                                               window=window)
                what = (f"flash_attention {(b_, sq, sk, hq, hkv, hd)} "
                        f"causal={causal} window={window} {dt}")
                if dt == torch.float32:
                    close(got, want, 2e-5, 0.0, what)
                else:
                    fa_bf16_worst = max(fa_bf16_worst, close_bf16_attention(
                        got, want, what), key=lambda r: r[2])
    # a row of C alone equals the same row inside 300 (one K order, the
    # plan from N and K only), with and without a split of K
    for (k, n) in ((768, 3072), (3072, 768), (2048, 2048)):
        a, b = rnd(300, k), rnd(k, n, scale=k ** -0.5)
        full, part = streamed_matmul(a, b), streamed_matmul(a[17:18].clone(), b)
        torch.cuda.synchronize()
        check(torch.equal(full[17:18], part), f"streamed_matmul row 17 of "
              f"300 differs from the row alone at K={k} N={n}")
    log(f"[kernels] sweep ok: {len(sweep_mm) * 2} matmul and "
        f"{len(sweep_fa) * 6} attention cases, f32 and bf16 (bf16 at "
        f"worst {fa_bf16_worst[2]:.3f}x its one-ulp limit, max abs err "
        f"{fa_bf16_worst[0]:.3e}, relative L2 {fa_bf16_worst[1]:.3e} <= "
        f"{BF16_ATTN_REL_L2}); matmul rows "
        f"bit-equal alone and in a batch of 300 at (K, N) = (768, 3072), "
        f"(3072, 768), (2048, 2048)")

    # (b) every shape the serving path launches, f32, timed: one call with
    # its host dispatch, and device time by back-to-back calls; the share
    # of the bound and the ratio to the library call in each, the library's
    # kernels, and the registers and spills of the kernel that ran
    usage = {kn: ptxas_usage(info["log"]) for kn, info in
             _build.BUILD_LOG.items()}

    def entry_usage(kn, pattern):
        """(registers, spill store bytes, spill load bytes) of the kernel
        entry matching ``pattern``; Nones when ``kn`` was built before this
        run (no compiler log)."""
        if kn not in usage:
            return None, None, None
        found = [u for f, u in usage[kn].items() if pattern in f]
        check(len(found) == 1, f"{kn}: {len(found)} ptxas entries match "
              f"{pattern!r}")
        return found[0]

    per_request = {m: path_shapes(get_arch(m).model, SEQ)
                   for m in SERVE_MODELS}
    log(f"[kernels] launches per request from the graphs: "
        f"{ {m: dict(by_kernel(c)) for m, c in per_request.items()} }")
    measured = {}                       # (kernel, shape key) -> numbers
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def measure(shape):
        """Check one serving-path shape against the plain version and
        time it, the plain version and the library call into
        ``measured``."""
        kn, key = shape
        if kn == "streamed_matmul":
            m, k, n = key
            a, b = rnd(m, k), rnd(k, n, scale=k ** -0.5)
            kern = lambda: streamed_matmul(a, b)
            plain = lambda: ref.matmul_ref(a, b)
            library = lambda: torch.matmul(a, b)
            atol = rtol = 1e-4
            # the f32 kernel on 16-byte aligned rows
            regs = entry_usage(kn, "matmul_kernelIfLi0E")
            plan = f"splits {tile_for(n, k)}, "
        else:
            b_, sq, sk, hq, hkv, hd, causal, window, dt = key
            check(window == 0,
                  f"the SDPA yardstick takes no window, got {key}")
            q, k, v = rnd(b_, sq, hq, hd, dtype=dt), \
                rnd(b_, sk, hkv, hd, dtype=dt), rnd(b_, sk, hkv, hd, dtype=dt)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            kern = lambda: flash_attention(q, k, v, causal=causal,
                                           window=window)
            plain = lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                                    window=window)
            atol, rtol = 2e-5, 0.0          # f32; bf16 in ULP form below
            gqa = {"enable_gqa": True} if hq != hkv else {}
            library = lambda: sdpa(qt, kt, vt, is_causal=causal, **gqa)
            # f32 runs the FMA kernel, bf16 the tensor-core kernel, whose
            # bound is the tensor cores' (bound_ms below)
            regs = entry_usage(kn, f"flash_kernelIfLi{hd}E"
                               if dt == torch.float32 else
                               f"flash_tc_kernelILi{hd}E")
            plan = ""
        got = kern()
        torch.cuda.synchronize()
        if kn == "flash_attention" and dt == torch.bfloat16:
            err, rel, ulp = close_bf16_attention(got, plain(),
                                                 f"slice shape {shape}")
            plan += (f"bf16 check: max abs err {err:.3e} (each element "
                     f"within atol {BF16_ATTN_ATOL} + rtol 2^-7 |plain|, at "
                     f"worst {ulp:.3f}x it), relative L2 {rel:.3e} (<= "
                     f"{BF16_ATTN_REL_L2}); ")
        else:
            err = close(got, plain(), atol, rtol, f"slice shape {shape}")
        flops, nbytes = shape_work(kn, key)
        bms, bby = bound_ms(flops, nbytes, peaks, key[-1]
                            if kn == "flash_attention" else torch.float32)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            library()
            torch.cuda.synchronize()
        # the kernels the library ran; where the profiler saw none (bf16
        # SDPA on the card), the ATen operators it dispatched to
        events = prof.key_averages()
        lib_kernels = sorted({
            ev.key for ev in events
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0}) or sorted(
                {ev.key for ev in events if ev.key.startswith("aten::")})
        measured[shape] = {"ms": call_ms(kern), "plain_ms": call_ms(plain),
                           "library_ms": call_ms(library),
                           "device_ms": device_ms(kern),
                           "library_device_ms": device_ms(library),
                           "library_kernels": lib_kernels,
                           "bound_ms": bms, "bound_by": bby,
                           "max_abs_err": err, "registers": regs[0],
                           "spill_bytes": None if regs[0] is None
                           else regs[1] + regs[2]}
        r = measured[shape]
        log(f"[kernels] {shape}: one call: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"{bms / r['ms']:.1%} of the bound, "
            f"{r['ms'] / r['library_ms']:.3f}x the library; device time: "
            f"kernel {r['device_ms']:.4f} ms, library "
            f"{r['library_device_ms']:.4f} ms, "
            f"{flops / r['device_ms'] / 1e9:.1f} TFLOP/s, "
            f"{bms / r['device_ms']:.1%} of the bound, "
            f"{r['device_ms'] / r['library_device_ms']:.3f}x the library; "
            f"bound {bms:.4f} ms ({bby}), max abs err {err:.2e}; {plan}"
            f"{regs[0]} registers, {regs[1]} B spill stores, {regs[2]} B "
            f"spill loads; the library ran {lib_kernels}")

    for shape in sorted({s for c in per_request.values() for s in c}
                        | {("streamed_matmul", CALIBRATION_SHAPE)}):
        measure(shape)

    # (c) ssd_scan against the sequential recurrence on the JAX kernel
    # tests' sweep (tests/test_kernels.py:56-91) plus a length whose chunk
    # halves, 25 heads (no multiple of the output pass's 4) and 64 chunks
    # (more than the state pass loads at once), at that file's tolerance;
    # layout_pack bit for bit on its sweep (tests/test_kernels.py:94-106)
    # in f32 and bf16
    def ssd_inputs(b_, s, h, p, n):
        """SSD operands as the model hands them over: x, b and c slices of
        one conv output, dt softplus'ed, a negative, d from a normal."""
        xbc = rnd(b_, s, h * p + 2 * n)
        return (xbc[..., :h * p].reshape(b_, s, h, p),
                torch.nn.functional.softplus(rnd(b_, s, h)),
                -torch.exp(rnd(h, scale=0.5)), xbc[..., h * p:h * p + n],
                xbc[..., h * p + n:], rnd(h))

    sweep_ssd = [(2, 128, 3, 16, 8, 32), (1, 64, 2, 32, 16, 64),
                 (1, 256, 4, 8, 4, 16), (2, 96, 2, 16, 8, 32),
                 (1, 96, 2, 16, 8, 64), (1, 512, 25, 64, 128, 256),
                 (1, 4096, 3, 16, 8, 64)]
    for (b_, s, h, p, n, ch) in sweep_ssd:
        ins = ssd_inputs(b_, s, h, p, n)
        got = ssd_scan(*ins, chunk=ch)
        torch.cuda.synchronize()
        close(got, ref.ssd_ref(*ins), 2e-3, 1e-3,
              f"ssd_scan {(b_, s, h, p, n, ch)}")
    sweep_pack = [(64, 256), (70, 300), (128, 384), (8, 128)]
    for (r, c) in sweep_pack:
        for dt in (torch.float32, torch.bfloat16):
            w = rnd(r, c, dtype=dt)
            got = layout_pack(w)
            torch.cuda.synchronize()
            check(torch.equal(bits(got), bits(ref.layout_pack_ref(
                w, ops.native_tile(dt)))), f"layout_pack {(r, c)} {dt}")
    # the boundaries of pack_plan's two paths: ((R, C), dtype, tile or the
    # native one, bytes the input starts past a 16-byte boundary, the path)
    boundary = [((70, 256), torch.float32, None, 0, "vector"),
                ((33, 129), torch.float32, None, 0, "general"),
                ((33, 129), torch.bfloat16, None, 0, "general"),
                ((64, 96), torch.float32, (8, 64), 0, "general"),
                ((48, 96), torch.float32, (5, 12), 0, "vector"),
                ((40, 256), torch.uint8, None, 0, "vector"),
                ((40, 256), torch.int64, None, 0, "vector"),
                ((64, 256), torch.float32, None, 4, "general")]
    for (r, c), dt, tile, skew, path in boundary:
        w = pack_input(r, c, dt, skew, gen, dev)
        tile = tile or ops.native_tile(dt)
        got = layout_pack(w, tile)
        torch.cuda.synchronize()
        plan = pack_plan(r, c, *tile, dt.itemsize, w.data_ptr(),
                         got.data_ptr())
        check(plan.path == path and w.data_ptr() % 16 == skew,
              f"layout_pack {(r, c)} {dt} tile {tile} skew {skew}: "
              f"{plan.path} path, {path} expected")
        check(torch.equal(bits(got), bits(ref.layout_pack_ref(w, tile))),
              f"layout_pack {(r, c)} {dt} tile {tile} skew {skew}")
        log(f"[kernels] layout_pack {(r, c)} {dt} tile {tile}, input "
            f"{skew} B past 16: {plan.path} path ({plan.walk} walk, "
            f"{plan.blocks} blocks), bit-exact")
    log(f"[kernels] sweep ok: {len(sweep_ssd)} ssd_scan cases (atol 2e-3, "
        f"rtol 1e-3 against ssd_ref) and {len(sweep_pack) * 2} layout_pack "
        f"cases (bit-exact), f32 and bf16, and {len(boundary)} at the "
        f"paths' boundaries")

    # (d) ssd_scan at the Mamba-2-130M prefill shape, timed, against the
    # sequential recurrence (its plain version) and against ssd_chunked
    # (what the model path runs on the CPU): f32 summation order only, so
    # within 1e-4 (chunked) and 1e-3 (4096 sequential steps) of y's scale
    mcfg = get_arch(MAMBA).model
    sc = mcfg.ssm
    heads = sc.expand * mcfg.d_model // sc.head_dim
    ssd_key = (MAMBA_BATCH, MAMBA_SEQ, heads, sc.head_dim, sc.d_state,
               chunk_len(MAMBA_SEQ, sc.chunk))
    ins = ssd_inputs(*ssd_key[:5])
    got = ssd_scan(*ins, chunk=sc.chunk)
    torch.cuda.synchronize()
    chunked = ssd_chunked(*ins, sc.chunk)[0]
    seq_ref = ref.ssd_ref(*ins)
    scale = chunked.abs().max().item()
    err_chunked = close(got, chunked, 1e-4 * scale, 0.0,
                        f"ssd_scan {ssd_key} vs ssd_chunked")
    err = close(got, seq_ref, 1e-3 * scale, 0.0,
                f"ssd_scan {ssd_key} vs ssd_ref")
    del chunked, seq_ref
    flops, nbytes = shape_work("ssd_scan", ssd_key)
    bms, bby = bound_ms(flops, nbytes, peaks)
    measured[("ssd_scan", ssd_key)] = {
        "ms": call_ms(lambda: ssd_scan(*ins, chunk=sc.chunk)),
        "device_ms": device_ms(lambda: ssd_scan(*ins, chunk=sc.chunk)),
        "plain_ms": call_ms(lambda: ref.ssd_ref(*ins), n=5),
        "chunked_ms": call_ms(lambda: ssd_chunked(*ins, sc.chunk)),
        "library_ms": None, "bound_ms": bms, "bound_by": bby,
        "max_abs_err": err, "max_abs_err_chunked": err_chunked}
    r = measured[("ssd_scan", ssd_key)]
    log(f"[kernels] ('ssd_scan', {ssd_key}): one call: kernel "
        f"{r['ms']:.4f} ms (device time {r['device_ms']:.4f} ms), plain "
        f"(ssd_ref, median of 5) {r['plain_ms']:.4f} ms, ssd_chunked "
        f"{r['chunked_ms']:.4f} ms, bound {bms:.4f} ms ({bby}, "
        f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), "
        f"{flops / r['device_ms'] / 1e9:.1f} TFLOP/s; max abs err {err:.2e} vs "
        f"ssd_ref, {err_chunked:.2e} vs ssd_chunked (|y| up to {scale:.1f})")

    # the passes: what each left in the workspace against its plain
    # statement on the same inputs (f32 order of the sums only: within
    # 1e-4 of each quantity's scale; C B^T where j <= i, the part the
    # output pass reads), then each pass's device time by kernel name
    # against its own bound, and its registers and spills
    y_k, l_k, s_k, g_k = ssd_mod.ssd_scan_with_passes(*ins, chunk=sc.chunk)
    x_, dt_, a_, b_, c_, d_ = ins
    l_p, decay_p, ds_p = ssd_mod.chunk_states(x_, dt_, a_, b_, sc.chunk)
    s_p, _ = ssd_mod.state_passing(decay_p, ds_p)
    y_p = ssd_mod.chunk_outputs(x_, dt_, b_, c_, d_, l_p, s_p)
    cr = c_.reshape(MAMBA_BATCH, -1, ssd_key[5], ssd_key[4])
    br = b_.reshape(MAMBA_BATCH, -1, ssd_key[5], ssd_key[4])
    g_p = torch.einsum("bcin,bcjn->bcij", cr, br).tril()
    torch.cuda.synchronize()
    pass_err = {}
    for what, got_, want_ in (("L", l_k, l_p), ("S_in", s_k, s_p),
                              ("C B^T", g_k.tril(), g_p), ("y", y_k, y_p)):
        pass_err[what] = close(got_, want_, 1e-4 * want_.abs().max().item(),
                               0.0, f"ssd_scan pass output {what} vs its "
                               f"plain statement")
    del y_k, l_k, s_k, g_k, l_p, decay_p, ds_p, s_p, y_p, cr, br, g_p
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(TIMED):
            ssd_scan(*ins, chunk=sc.chunk)
        torch.cuda.synchronize()
    by_pass = Counter()
    for kname, ms_ in device_by_name(prof).items():
        label = ssd_pass_of(kname)
        check(label is not None, f"ssd_scan ran an unknown kernel {kname}")
        by_pass[label] += ms_ / TIMED
    check(set(by_pass) == {label for label, _ in SSD_PASSES.values()},
          f"ssd_scan ran the passes {sorted(by_pass)}")
    passes = {}
    for kname, (label, entry) in SSD_PASSES.items():
        p_flops, p_bytes = ssd_pass_work(ssd_key)[label]
        p_bms, p_bby = bound_ms(p_flops, p_bytes, peaks)
        regs = entry_usage("ssd_scan", kname + entry)
        passes[label] = {"kernel": kname, "device_ms": by_pass[label],
                         "bound_ms": p_bms, "bound_by": p_bby,
                         "registers": regs[0], "spill_bytes": None
                         if regs[0] is None else regs[1] + regs[2]}
        log(f"[kernels] ssd_scan pass {label} ({kname}): device time "
            f"{by_pass[label]:.4f} ms, bound {p_bms:.4f} ms ({p_bby}, "
            f"{p_flops / 1e9:.2f} GFLOP, {p_bytes / 1e6:.1f} MB), "
            f"{p_bms / by_pass[label]:.1%} of the bound; {regs[0]} "
            f"registers, {regs[1]} B spill stores, {regs[2]} B spill loads")
    r["passes"], r["pass_max_abs_err"] = passes, pass_err
    log(f"[kernels] ssd_scan passes: {sum(by_pass.values()):.4f} ms of "
        f"device time in all (profiler), {bms / r['device_ms']:.1%} of the "
        f"bound in device time (events); each pass's output held against "
        f"its plain statement within 1e-4 of its scale: max abs err "
        f"{ {k: f'{v:.2e}' for k, v in pass_err.items()} }")
    del ins, got, w

    # ---- 4. executors: GPT-Neo-S streamed vs preloaded --------------------
    cfg_s = get_arch("gptneo-s").model
    model_s = HostModel.build(cfg_s, seq=SEQ, seed=1, device=dev)
    toks = np.random.default_rng(7).integers(0, cfg_s.vocab, (1, SEQ),
                                             dtype=np.int32)
    PreloadExecutor(model_s).run(toks)                      # warm
    torch.cuda.reset_peak_memory_stats()
    st = StreamingExecutor(model_s, plan_always_next(model_s.graph, 1 << 20)
                           ).run(toks)
    st_mem = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pe = PreloadExecutor(model_s).run(toks)
    pe_mem = torch.cuda.max_memory_allocated()
    err = close(st.result, pe.result, 1e-5, 0.0, "streaming vs preload")
    check(tuple(st.result.shape) == (1, SEQ, cfg_s.d_model),
          f"result shape {tuple(st.result.shape)}")
    for tag, s_, mem in (("stream(always-next)", st, st_mem),
                         ("preload", pe, pe_mem)):
        log(f"[executor] gptneo-s {tag}: init_s {s_.init_s:.4f} exec_s "
            f"{s_.exec_s:.4f} peak_bytes {s_.peak_bytes} stall_events "
            f"{s_.stall_events} max_memory_allocated {mem}")
    log(f"[executor] streaming == preload within atol 1e-5 "
        f"(max abs err {err:.2e})")
    del model_s, st, pe

    # ---- 5. serving: the main path ----------------------------------------
    argv = ["--device", "cuda", "--models", ",".join(SERVE_MODELS),
            "--policy", "stream", "--budget-mb", str(BUDGET_MB),
            "--requests", str(REQUESTS), "--seq", str(SEQ),
            "--disk-gbps", "0"]
    log(f"[serve] python -m repro_torch.launch.serve {' '.join(argv)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    copied0 = HostToDevice.copied_bytes
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    with eviction_log() as evicted:
        responses, engine = serve.main(argv)
    torch.cuda.synchronize()
    serve_shapes = Counter({(kn, key): c for kn, by_shape in
                            ops.launch_counts_by_shape().items()
                            for key, c in by_shape.items()})
    launches = by_kernel(serve_shapes)
    serve_s = time.perf_counter() - t0
    serve_mem = torch.cuda.max_memory_allocated()
    streamed = HostToDevice.copied_bytes - copied0
    served = Counter(r.model.split("#")[0] for r in responses)
    expected = Counter({("streamed_matmul", CALIBRATION_SHAPE):
                        CALIBRATION_LAUNCHES})
    for m in SERVE_MODELS:
        for shape, c in per_request[m].items():
            expected[shape] += c * served[m]
    log(f"[serve] launches {dict(launches)}, by shape "
        f"{ {f'{kn}{key}': c for (kn, key), c in sorted(serve_shapes.items())} }")
    log(f"[serve] expected {dict(by_kernel(expected))}: per request from the "
        f"graphs, plus {CALIBRATION_LAUNCHES} matmuls at {CALIBRATION_SHAPE} "
        f"of the card's calibration")
    check(len(responses) == REQUESTS, f"{len(responses)} responses")
    check(serve_shapes == expected,
          f"launch counts by shape differ from the graphs: counted "
          f"{sorted(serve_shapes.items())}, expected {sorted(expected.items())}")
    budget = BUDGET_MB << 20
    check(engine.peak_memory() <= budget,
          f"pool peak {engine.peak_memory()} > budget {budget}")
    check(engine.cache.ledger_balanced(), "weight-pool ledger unbalanced")

    def log_plan(tag, engine, streamed, evicted):
        log(f"[{tag}] planned with {engine.hw}: fits_budget "
            f"{engine.multi_plan.fits_budget()} peaks "
            f"{ {n: round(p / 1e6, 1) for n, p in engine.multi_plan.peaks.items()} } MB; "
            f"stall events per request "
            f"{[s.stall_events for s in engine.stats_log]}")
        log(f"[{tag}] pool peak {engine.peak_memory() / 1e6:.1f} MB of "
            f"{budget / 1e6:.1f} MB, hit rate {engine.cache_hit_rate():.3f}, "
            f"host-to-device {streamed / 1e6:.1f} MB")
        log(f"[{tag}] evictions in order: {eviction_order(evicted)}")

    log_plan("serve", engine, streamed, evicted)
    log(f"[serve] max_memory_allocated {serve_mem / 1e6:.1f} MB, wall "
        f"{serve_s:.2f}s")
    # each response against the plain-version forward of the same model
    # and tokens (the same op program with kernels.ref in the kernels' place)
    tokens = {r.req_id: r.tokens for r in serve.make_requests(
        engine.models, REQUESTS, SEQ)}
    serve_err = 0.0
    for r in responses:
        m = engine.models[r.model]
        plain_model = replace(m, programs=_build_programs(
            m.cfg, matmul=ref.matmul_ref, attention=ref.flash_attention_ref))
        want = PreloadExecutor(plain_model).run(tokens[r.req_id]).result
        check(tuple(r.result.shape) == (1, SEQ, m.cfg.d_model)
              and bool(torch.isfinite(r.result).all()),
              f"{r.model} result {tuple(r.result.shape)} not finite")
        e = close(r.result, want, 1e-3, 0.0, f"{r.model} vs plain forward")
        serve_err = max(serve_err, e)
        log(f"[serve] {r.model} req {r.req_id}: latency {r.latency_s:.4f}s "
            f"init {r.init_s:.4f}s exec {r.exec_s:.4f}s peak "
            f"{r.peak_bytes / 1e6:.1f} MB hits {r.cache_hits} misses "
            f"{r.cache_misses}, max abs err vs plain {e:.2e}")
        del want, plain_model

    # ---- 5b. where one more 1.3B request's time goes ----------------------
    big = next(n for n in engine.models if n.startswith(SERVE_MODELS[0]))
    w = engine.models[big].host_weights["L0.ffn_in.w"]
    rates = {}
    for label, arr in (("page-locked", w), ("staged", np.array(w))):
        h2d = HostToDevice(dev)
        chunks = chunk_rows(arr, engine.chunk_bytes)
        for _ in range(2):                      # the second pass is timed
            t0 = time.perf_counter()
            with h2d.copies():
                outs = [h2d.put(c) for c in chunks]
            h2d.mark().synchronize()
            rates[label] = arr.nbytes / (time.perf_counter() - t0) / 1e9
            del outs
    log(f"[stream] {len(chunks)} chunks of {engine.chunk_bytes >> 20} MiB "
        f"({w.nbytes / 1e6:.1f} MB) through HostToDevice: page-locked "
        f"{rates['page-locked']:.1f} GB/s, staged {rates['staged']:.1f} GB/s")
    engine.submit(serve.make_requests(engine.models, 1, SEQ)[0])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        (resp,) = engine.run_all()
    kern_us = copy_us = 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if "memcpy" in ev.key.lower():
            copy_us += dev_us
        else:
            kern_us += dev_us
    if kern_us > 0:
        log(f"[stream] profiled {resp.model} request: wall {resp.latency_s:.4f}s, "
            f"kernels {kern_us / 1e6:.4f}s (compute stream busy "
            f"{kern_us / 1e6 / resp.latency_s:.1%}, idle "
            f"{1 - kern_us / 1e6 / resp.latency_s:.1%}), host-to-device copies "
            f"{copy_us / 1e6:.4f}s")
    else:
        log("[stream] the profiler saw no device time: idle share not measured")
    del responses, engine, resp, prof, w, arr, chunks

    # ---- 5c. the same requests planned with the previous kernel's rate ----
    # everything else calibrated on this card in this run, so a difference
    # from phase 5 comes from the plan the faster kernel's rate makes
    calibrated = HWSpec.cuda_calibrated

    def previous_rate(device=None):
        return replace(calibrated(device), peak_flops=PREVIOUS_PEAK_FLOPS)

    log(f"[serve-previous-rate] the same run with HWSpec.peak_flops pinned "
        f"to {PREVIOUS_PEAK_FLOPS:.6g} FLOP/s")
    copied0 = HostToDevice.copied_bytes
    with mock.patch.object(HWSpec, "cuda_calibrated",
                           staticmethod(previous_rate)), \
            eviction_log() as evicted:
        responses, engine = serve.main(argv)
    torch.cuda.synchronize()
    check(engine.hw.peak_flops == PREVIOUS_PEAK_FLOPS,
          f"the engine planned with {engine.hw}")
    check(len(responses) == REQUESTS, f"{len(responses)} responses")
    check(engine.peak_memory() <= budget,
          f"pool peak {engine.peak_memory()} > budget {budget}")
    check(engine.cache.ledger_balanced(), "weight-pool ledger unbalanced")
    log_plan("serve-previous-rate", engine,
             HostToDevice.copied_bytes - copied0, evicted)
    for r in responses:
        check(tuple(r.result.shape) == (1, SEQ, engine.models[r.model].cfg
                                        .d_model)
              and bool(torch.isfinite(r.result).all()),
              f"{r.model} result {tuple(r.result.shape)} not finite")
        log(f"[serve-previous-rate] {r.model} req {r.req_id}: latency "
            f"{r.latency_s:.4f}s init {r.init_s:.4f}s exec {r.exec_s:.4f}s "
            f"hits {r.cache_hits} misses {r.cache_misses}")
    del responses, engine

    # ---- 6. online: a padded batch de-batched on the card -----------------
    on_argv = ["--device", "cuda", "--models", "gptneo-s", "--online",
               "--rate", "100", "--duration", "0.1", "--max-batch", "2",
               "--seq", str(SEQ), "--budget-mb", str(BUDGET_MB),
               "--disk-gbps", "0"]
    log(f"[online] python -m repro_torch.launch.serve {' '.join(on_argv)}")
    ops.reset_launch_counts()
    on_resp, on_engine = serve.main(on_argv)
    torch.cuda.synchronize()
    on_launches = ops.launch_counts()
    trace = {r.req_id: r.tokens for r in serve.online_trace(
        on_engine.models, 100.0, 0.1, SEQ)}
    ok = [r for r in on_resp if r.status == "ok"]
    check(ok and any(r.batch_size == 2 for r in ok),
          "the online replay formed no padded batch of 2")
    on_err = 0.0
    for r in ok:
        solo = PreloadExecutor(on_engine.models[r.model]).run(
            trace[r.req_id]).result
        on_err = max(on_err, close(r.result, solo, 1e-4, 0.0,
                                   f"online req {r.req_id} vs solo"))
    log(f"[online] {len(ok)}/{len(on_resp)} served, batch sizes "
        f"{sorted(Counter(r.batch_size for r in ok).items())}, de-batched "
        f"results within atol 1e-4 of solo runs (max abs err {on_err:.2e}), "
        f"launches {on_launches}")
    del on_resp, on_engine

    # ---- 6b. the fleet: two replicas behind the Router on one card -------
    plain_models = {}

    def check_fleet(tag, router, responses, trace, wall, wall_what, shapes,
                    warmed):
        """One terminal response per request; every served output within
        1e-3 of a plain-version forward on the card; every replica's pool
        within its budget; the kernels' launches by shape equal to the
        graphs' (each engine's calibration, ``warmed`` forwards, and every
        batch each replica executed). Logs the run; returns the max abs
        error against the plain forwards."""
        models = router.replicas[0].engine.models
        check(sorted(r.req_id for r in responses)
              == sorted(t.req_id for t in trace),
              f"{tag}: {len(responses)} terminal responses for "
              f"{len(trace)} requests")
        check(all(r.status in ("ok", "rejected", "failed")
                  for r in responses), f"{tag}: unknown statuses")
        served = [r for r in responses if r.status == "ok"]
        check(served, f"{tag}: nothing served")
        tokens = {t.req_id: t.tokens for t in trace}
        err = 0.0
        for r in served:
            m = models[r.model]
            if r.model not in plain_models:
                plain_models[r.model] = replace(m, programs=_build_programs(
                    m.cfg, matmul=ref.matmul_ref,
                    attention=ref.flash_attention_ref))
            want = PreloadExecutor(plain_models[r.model]).run(
                tokens[r.req_id]).result
            check(tuple(r.result.shape) == (1, SEQ, m.cfg.d_model)
                  and bool(torch.isfinite(r.result).all()),
                  f"{tag}: {r.model} result {tuple(r.result.shape)} not "
                  f"finite")
            err = max(err, close(r.result, want, 1e-3, 0.0,
                                 f"{tag} req {r.req_id} vs plain forward"))
        expected = Counter({("streamed_matmul", CALIBRATION_SHAPE):
                            CALIBRATION_LAUNCHES * len(router.replicas)})
        for m, c in warmed.items():
            for shape, n in per_request[m].items():
                expected[shape] += n * c
        batches = Counter()
        for rep in router.replicas:
            check(rep.engine.peak_memory() <= BUDGET_MB << 20,
                  f"{tag}: replica {rep.rid} pool peak "
                  f"{rep.engine.peak_memory()} > {BUDGET_MB} MiB")
            check(rep.engine.cache.ledger_balanced(),
                  f"{tag}: replica {rep.rid} pool ledger unbalanced")
            for _, name, size in rep.engine.batch_log:
                batches[(name, size)] += 1
        for (name, size), c in batches.items():
            for shape, n in path_shapes(models[name].cfg, SEQ,
                                        batch=size).items():
                expected[shape] += n * c
        check(shapes == expected,
              f"{tag}: launch counts by shape differ from the graphs: "
              f"counted {sorted(shapes.items())}, expected "
              f"{sorted(expected.items())}")
        rep_ = router.report(responses)
        routes = Counter((e[2], e[3]) for e in router.route_log)
        log(f"[{tag}] FLEET {len(router.replicas)} replicas routing="
            f"{router.routing} served {rep_['served']}/{rep_['requests']} "
            f"failed={rep_['failed']} retries={rep_['retries']} "
            f"dup_suppressed={rep_['dup_suppressed']} restream_mb="
            f"{rep_['restream_bytes'] / 1e6:.1f}; {wall_what} {wall:.3f}s, "
            f"{wall / len(trace):.4f}s per request, charged "
            f"{sum(r.charged_s for r in served):.4f}s in all; launches "
            f"{dict(by_kernel(shapes))} = the graphs' over batches "
            f"{dict(sorted(batches.items()))}, {len(router.replicas)} "
            f"calibrations and warm-ups {dict(warmed)}")
        log(f"[{tag}] routes (model, replica): {dict(sorted(routes.items()))}"
            f"; reasons {dict(Counter(e[4] for e in router.route_log))}")
        for rep in router.replicas:
            br = router.breakers[rep.rid]
            log(f"[{tag}] replica {rep.rid} on {rep.device}: batches "
                f"{rep.batch_feed.total}, pool peak "
                f"{rep.engine.peak_memory() / 1e6:.1f} MB of "
                f"{(BUDGET_MB << 20) / 1e6:.1f} MB, hit rate "
                f"{rep.engine.cache_hit_rate():.3f}, restream "
                f"{rep.restream_bytes() / 1e6:.1f} MB, breaker {br.state} "
                f"after {[(round(t, 4), a, b, why) for t, a, b, why in br.transitions]}")
        for r in sorted(responses, key=lambda r: r.req_id):
            log(f"[{tag}] req {r.req_id} {r.model} {r.status}: arrival "
                f"{r.arrival_s:.3f}s latency {r.latency_s:.4f}s charged "
                f"{r.charged_s:.4f}s batch {r.batch_size}")
        log(f"[{tag}] every request has one terminal response, served "
            f"outputs within atol 1e-3 of a plain forward (max abs err "
            f"{err:.2e}), every pool within {BUDGET_MB} MiB; "
            f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e6:.1f} MB")
        return err

    # both models at full width, each replica with its own BUDGET_MB pool;
    # run 1 through the CLI, run 2 with Replicas and a Router built here
    # over a flash-crowd trace, replica 1 killed partway
    fleet_argv = ["--device", "cuda", "--models", ",".join(SERVE_MODELS),
                  "--online", "--replicas", "2", "--routing", "affinity",
                  "--budget-mb", str(BUDGET_MB), "--rate", str(FLEET_RATE),
                  "--duration", str(FLEET_DURATION), "--seq", str(SEQ),
                  "--timeout-ms", str(FLEET_TIMEOUT_S * 1e3),
                  "--disk-gbps", "0"]
    log(f"[fleet] python -m repro_torch.launch.serve {' '.join(fleet_argv)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    fleet_resp, fleet_router = serve.main(fleet_argv)
    torch.cuda.synchronize()
    fleet_wall = time.perf_counter() - t0
    fleet_shapes = Counter({(kn, key): c for kn, by_shape in
                            ops.launch_counts_by_shape().items()
                            for key, c in by_shape.items()})
    fleet_models = fleet_router.replicas[0].engine.models
    trace = serve.online_trace(fleet_models, FLEET_RATE, FLEET_DURATION, SEQ)
    # the CLI warms each model with one forward before the trace
    fleet_err = check_fleet(
        "fleet", fleet_router, fleet_resp, trace, fleet_wall,
        "wall of the CLI (both models built, two engines calibrated, each "
        "model warmed, the replay)", fleet_shapes,
        Counter(m.split("#")[0] for m in fleet_models))

    # run 2: the same models (built once, registered with every replica),
    # a crowd on GPT-Neo-S, replica 1 (the ring's home of both models)
    # killed partway
    from repro_torch.serving.replica import FaultPlan, Replica
    from repro_torch.serving.router import Router
    from repro_torch.serving.traces import flash_crowd_trace
    crowd = next(n for n in fleet_models if n.startswith("gptneo-s"))
    trace = stamp_req_ids(flash_crowd_trace(
        {n: CROWD_BASE_RATE for n in fleet_models}, CROWD_DURATION,
        crowd_model=crowd, start_s=CROWD_START, span_s=CROWD_SPAN,
        factor=CROWD_FACTOR, vocab=min(m.cfg.vocab for m in
                                       fleet_models.values()),
        seq=SEQ, seed=0))
    del fleet_resp, fleet_router
    # counted from here: each engine's calibration is on the path, as in
    # the CLI run
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    fleet = []
    for rid in range(2):
        rep = Replica(rid, device=dev, budget_bytes=BUDGET_MB << 20,
                      disk_bw=0.0)
        for nm, m in fleet_models.items():
            rep.register(nm, m)
        fleet.append(rep.start())
    router = Router(fleet, routing="affinity", timeout_s=FLEET_TIMEOUT_S)
    log(f"[fleet-fault] {len(trace)} requests of a flash crowd on {crowd} "
        f"(x{CROWD_FACTOR} from {CROWD_START}s for {CROWD_SPAN}s over "
        f"{CROWD_BASE_RATE} req/s per model for {CROWD_DURATION}s); replica "
        f"{FLEET_VICTIM} killed at {FLEET_KILL_S}s; timeout "
        f"{FLEET_TIMEOUT_S}s")
    t0 = time.perf_counter()
    crowd_resp = router.serve(trace, fault_plan=FaultPlan().kill(
        FLEET_KILL_S, rid=FLEET_VICTIM))
    torch.cuda.synchronize()
    crowd_wall = time.perf_counter() - t0
    crowd_shapes = Counter({(kn, key): c for kn, by_shape in
                            ops.launch_counts_by_shape().items()
                            for key, c in by_shape.items()})
    fleet_err = max(fleet_err, check_fleet(
        "fleet-fault", router, crowd_resp, trace, crowd_wall,
        "wall of Router.serve", crowd_shapes, Counter()))
    br = router.breakers[FLEET_VICTIM]
    check(any(to == "open" for _, _, to, _ in br.transitions),
          f"replica {FLEET_VICTIM}'s breaker never opened: {br.transitions}")
    status = {r.req_id: r.status for r in crowd_resp}
    attempts = Counter((e[1], e[5]) for e in router.route_log)
    lost = [e for e in router.route_log
            if e[3] == FLEET_VICTIM and e[0] >= FLEET_KILL_S
            and (e[1], e[5] + 1) not in attempts
            and status[e[1]] != "failed"]
    check(not lost, f"requests routed to the dead replica neither retried "
          f"nor failed: {lost}")
    log(f"[fleet-fault] every request routed to replica {FLEET_VICTIM} at or "
        f"after its death was routed again or failed; its breaker: "
        f"{[(round(t, 4), a, b, why) for t, a, b, why in br.transitions]}")
    fleet_shapes += crowd_shapes
    del crowd_resp, router, fleet, fleet_models, trace
    # the shapes batching made that the serving phase did not time
    for shape in sorted(set(fleet_shapes) - set(measured), key=str):
        measure(shape)

    # ---- 7. Mamba-2-130M through the model path ---------------------------
    arch = get_arch(MAMBA)
    env = make_host_mesh(device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pre = model.make_step_bundle(
        arch, ShapeConfig("prefill", MAMBA_SEQ, MAMBA_BATCH, "prefill"), env)
    mgen = torch.Generator(device=dev).manual_seed(2)
    params = shd.init_params(pre.arg_specs[0], mgen, dev)
    log(f"[mamba] {MAMBA}: {mcfg.num_layers} layers, d_model "
        f"{mcfg.d_model}, {heads} SSD heads of {sc.head_dim}, d_state "
        f"{sc.d_state}, chunk {sc.chunk}, vocab {mcfg.vocab}; "
        f"{shd.param_count(pre.arg_specs[0]) / 1e6:.1f}M parameters "
        f"({shd.param_bytes(pre.arg_specs[0]) / 1e6:.1f} MB) from "
        f"init_params on {dev}")
    requests = [torch.randint(0, mcfg.vocab, (MAMBA_BATCH, MAMBA_SEQ),
                              generator=mgen, device=dev, dtype=torch.int32)
                for _ in range(MAMBA_REQUESTS)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    logits, walls = [], []
    for toks in requests:
        t0 = time.perf_counter()
        out = pre.fn(params, {"tokens": toks})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        logits.append(out)
    mamba_shapes = Counter({(kn, key): c for kn, by_shape in
                            ops.launch_counts_by_shape().items()
                            for key, c in by_shape.items()})
    expected = Counter({("ssd_scan", ssd_key):
                        mcfg.num_layers * MAMBA_REQUESTS})
    check(mamba_shapes == expected,
          f"prefill launches {dict(mamba_shapes)}, expected {dict(expected)}")
    for out in logits:
        check(tuple(out.shape) == (MAMBA_BATCH, 1, mcfg.vocab)
              and bool(torch.isfinite(out).all()),
              f"prefill logits {tuple(out.shape)} not finite")
    log(f"[mamba] prefill {MAMBA_REQUESTS} requests of {MAMBA_BATCH} x "
        f"{MAMBA_SEQ} tokens: wall {', '.join(f'{w:.4f}' for w in walls)} s "
        f"({MAMBA_BATCH * MAMBA_SEQ / min(walls):.0f} tokens/s at best); "
        f"logits {tuple(logits[0].shape)} finite; launches "
        f"{ {f'{kn}{key}': c for (kn, key), c in mamba_shapes.items()} } "
        f"({mcfg.num_layers} per request)")

    # one more warm prefill under the profiler (its launches are not
    # counted above): device time of ssd_scan (all passes), of the matmuls
    # (the projections and lm_head, torch.matmul) and of the rest by kernel
    # name, and the share of the wall the compute stream was idle
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pre.fn(params, {"tokens": requests[-1]})
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    split = Counter()
    rest = Counter()
    for kname, ms_ in device_by_name(prof).items():
        if ssd_pass_of(kname):
            split["ssd_scan"] += ms_
        elif MATMUL_NAMES.search(kname):
            split["matmul"] += ms_
        else:
            split["rest"] += ms_
            rest[kname] += ms_
    busy = sum(split.values())
    check(split["ssd_scan"] > 0, "the profiler saw no ssd_scan in a prefill")
    warm = min(walls[1:])
    log(f"[mamba] profiled prefill of {MAMBA_BATCH} x {MAMBA_SEQ}: wall "
        f"{prof_wall:.4f} s (warm unprofiled {warm:.4f} s); device time "
        f"ssd_scan {split['ssd_scan']:.3f} ms "
        f"({split['ssd_scan'] / 1e3 / warm:.1%} of the warm wall), matmuls "
        f"{split['matmul']:.3f} ms, the rest {split['rest']:.3f} ms; compute "
        f"stream busy {busy:.3f} ms, idle {1 - busy / 1e3 / prof_wall:.1%} "
        f"of the profiled wall ({1 - busy / 1e3 / warm:.1%} of the warm "
        f"wall)")
    log(f"[mamba] the rest by kernel: " + "; ".join(
        f"{short_kernel_name(k)} {v:.3f} ms" for k, v in rest.most_common(10)))
    del prof

    def plain_ssd(x, dt, a, b_, c, d, *, chunk):
        return ssm_mod.ssd_chunked(x, dt, a, b_, c, d, chunk)[0]

    with mock.patch.object(ops, "ssd", plain_ssd):
        t0 = time.perf_counter()
        want = pre.fn(params, {"tokens": requests[0]})
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
    prefill_err, prefill_rel = logits_close(
        logits[0], want, "prefill through ssd_scan vs through ssd_chunked")
    log(f"[mamba] request 0 through ssd_chunked instead of the kernel: wall "
        f"{plain_wall:.4f} s, logits within atol {LOGIT_ATOL} (max abs "
        f"err {prefill_err:.2e}, relative L2 {prefill_rel:.2e}, |logits| up "
        f"to {want.abs().max().item():.3f}), same argmax in "
        f"{int((logits[0].argmax(-1) == want.argmax(-1)).sum())}/"
        f"{MAMBA_BATCH} rows")
    del logits, want, out

    dec = model.make_step_bundle(
        arch, ShapeConfig("decode", MAMBA_SEQ, MAMBA_BATCH, "decode"), env)
    cache = shd.init_params(dec.arg_specs[1], mgen, dev)        # zeros
    tok = requests[0][:, :1]
    ops.reset_launch_counts()
    steps = []
    for t in range(DECODE_STEPS):
        t0 = time.perf_counter()
        out, cache = dec.fn(params, cache, tok, torch.full(
            (MAMBA_BATCH,), t, dtype=torch.int32, device=dev))
        tok = out.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    check(sum(ops.launch_counts().values()) == 0,
          f"decode launched kernels: {ops.launch_counts()}")
    check(tuple(out.shape) == (MAMBA_BATCH, 1, mcfg.vocab)
          and bool(torch.isfinite(out).all()), "decode logits not finite")
    log(f"[mamba] greedy decode {DECODE_STEPS} steps at batch {MAMBA_BATCH} "
        f"from the zero cache: median step {np.median(steps) * 1e3:.3f} ms, "
        f"total {sum(steps):.4f} s, first step {steps[0] * 1e3:.3f} ms; "
        f"no kernel launch")

    # decode against prefill: the recurrence step by step from the zero
    # cache ends at the chunked scan's last logits
    cpre = model.make_step_bundle(arch, ShapeConfig(
        "prefill", CONSIST_SEQ, CONSIST_BATCH, "prefill"), env)
    cdec = model.make_step_bundle(arch, ShapeConfig(
        "decode", CONSIST_SEQ, CONSIST_BATCH, "decode"), env)
    prompt = torch.randint(0, mcfg.vocab, (CONSIST_BATCH, CONSIST_SEQ),
                           generator=mgen, device=dev, dtype=torch.int32)
    ops.reset_launch_counts()
    want = cpre.fn(params, {"tokens": prompt})
    torch.cuda.synchronize()
    check(ops.launch_counts()["ssd_scan"] == mcfg.num_layers,
          f"consistency prefill launches {ops.launch_counts()}")
    cache = shd.init_params(cdec.arg_specs[1], mgen, dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for t in range(CONSIST_SEQ):
        got, cache = cdec.fn(params, cache, prompt[:, t:t + 1], torch.full(
            (CONSIST_BATCH,), t, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    consist_s = time.perf_counter() - t0
    check(sum(ops.launch_counts().values()) == 0,
          f"decode launched kernels: {ops.launch_counts()}")
    consist_err, consist_rel = logits_close(
        got, want, "decode from the zero cache vs prefill")
    pick = got.argmax(-1, keepdim=True)
    gap = (want.amax(-1, keepdim=True) - want.gather(-1, pick)).max().item()
    check(gap <= LOGIT_ATOL, f"decode picks {pick.flatten().tolist()}, "
          f"{gap:.3e} below the prefill's best logit")
    top2 = want.topk(2, dim=-1).values[..., 0, :]
    log(f"[mamba] decode {CONSIST_SEQ} steps at batch {CONSIST_BATCH} from "
        f"the zero cache ({consist_s:.3f} s) vs prefill of the same prompt: "
        f"max abs err {consist_err:.2e} (atol {LOGIT_ATOL}), relative L2 "
        f"{consist_rel:.2e}, |logits| up to {want.abs().max().item():.3f}; "
        f"decode picks {pick.flatten().tolist()}, prefill "
        f"{want.argmax(-1).flatten().tolist()} (same: "
        f"{torch.equal(pick, want.argmax(-1, keepdim=True))}), prefill "
        f"top-2 gaps "
        f"{[round(g, 4) for g in (top2[:, 0] - top2[:, 1]).tolist()]}")
    mamba_mem = torch.cuda.max_memory_allocated()
    log(f"[mamba] max_memory_allocated {mamba_mem / 1e6:.1f} MB")
    del params, cache, requests, prompt, want, got, out, pre, dec

    # ---- 7b. Yi-6B through the model path (the dense family) -------------
    t_dense = time.perf_counter()
    darch = get_arch(DENSE)
    dcfg = darch.model
    nq, nkv, dhd = dcfg.n_heads, dcfg.n_kv_heads, dcfg.resolved_head_dim
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dpre = model.make_step_bundle(darch, ShapeConfig(
        "prefill", DENSE_SEQ, DENSE_BATCH, "prefill"), env)
    dgen = torch.Generator(device=dev).manual_seed(4)
    t0 = time.perf_counter()
    dparams = shd.init_params(dpre.arg_specs[0], dgen, dev)
    torch.cuda.synchronize()
    log(f"[dense] {smi}: {DENSE}: {dcfg.num_layers} layers, d_model "
        f"{dcfg.d_model}, {nq} query and {nkv} KV heads of {dhd}, d_ff "
        f"{dcfg.d_ff}, vocab {dcfg.vocab}, bf16; "
        f"{shd.param_count(dpre.arg_specs[0]) / 1e9:.3f}B parameters "
        f"({shd.param_bytes(dpre.arg_specs[0]) / 1e9:.2f} GB) drawn on "
        f"{dev} in {time.perf_counter() - t0:.2f}s")

    # (a) full width, all 32 layers, 2 x 256: prefill through the kernel
    # against the same prefill through its plain version, then decode step
    # by step from the zero cache against the prefill
    r = consistency("Yi-6B", darch, dparams, dgen, dev, env,
                    DENSE_LOGIT_ATOL, DENSE_LOGIT_REL_L2)
    want, got = r["want"], r["got"]
    dense_plain_err, dense_consist_err = r["plain_err"], r["consist_err"]
    pick = got.argmax(-1, keepdim=True)
    gap = (want.amax(-1, keepdim=True) - want.gather(-1, pick)).max().item()
    check(gap <= DENSE_LOGIT_ATOL, f"decode picks {pick.flatten().tolist()}"
          f", {gap:.3e} below the prefill's best logit")
    log(f"[dense] prefill {CONSIST_BATCH} x {CONSIST_SEQ} through "
        f"flash_attention vs through flash_attention_ref: max abs err "
        f"{dense_plain_err:.3e} (atol {DENSE_LOGIT_ATOL}), relative L2 "
        f"{r['plain_rel']:.3e} (<= {DENSE_LOGIT_REL_L2}), |logits| up to "
        f"{want.abs().max().item():.3f}, same argmax in "
        f"{r['same_argmax']}/{CONSIST_BATCH} rows")
    log(f"[dense] decode {CONSIST_SEQ} steps at batch {CONSIST_BATCH} from "
        f"the zero cache ({r['decode_s']:.3f} s, no kernel launch) vs "
        f"prefill: max abs err {dense_consist_err:.3e} (atol "
        f"{DENSE_LOGIT_ATOL}), relative L2 {r['consist_rel']:.3e}; decode "
        f"picks {pick.flatten().tolist()}, prefill "
        f"{want.argmax(-1).flatten().tolist()}")
    del r, want, got, pick

    # (b) prefill requests of DENSE_BATCH x DENSE_SEQ tokens: one bf16
    # flash_attention per layer, at the key counted here; then (c) one more
    # warm prefill under the profiler (its launches are not counted above)
    req = prefill_requests("Yi-6B", dcfg, dpre, dparams, dgen, dev,
                           DENSE_REQUESTS, DENSE_BATCH, DENSE_SEQ)
    walls, dense_shapes = req["walls"], req["shapes"]
    dense_key = flash_key(dcfg, DENSE_BATCH, DENSE_SEQ)
    tokens_req = DENSE_BATCH * DENSE_SEQ
    log(f"[dense] {smi}: prefill {DENSE_REQUESTS} requests of {DENSE_BATCH} "
        f"x {DENSE_SEQ} tokens: wall "
        f"{', '.join(f'{w:.4f}' for w in walls)} s, "
        f"{', '.join(f'{tokens_req / w:.0f}' for w in walls)} tokens/s; "
        f"launches {dict(dense_shapes)} ({dcfg.num_layers} a request)")
    prof_wall, split, _, rest, busy, _ = profiled_call(
        lambda: dpre.fn(dparams, {"tokens": req["last"]}))
    check(split["flash_attention"] > 0,
          "the profiler saw no flash_attention in a prefill")
    warm = min(walls[1:])
    log(f"[dense] {smi}: profiled prefill of {DENSE_BATCH} x {DENSE_SEQ}: "
        f"wall {prof_wall:.4f} s (warm unprofiled {warm:.4f} s); device time "
        f"{ms_list(split)} (flash_attention "
        f"{split['flash_attention'] / 1e3 / warm:.1%} of the warm wall; mm: "
        f"the projections and the head); compute stream busy {busy:.3f} ms, "
        f"idle {1 - busy / 1e3 / prof_wall:.1%} of the profiled wall "
        f"({1 - busy / 1e3 / warm:.1%} of the warm wall)")
    log(f"[dense] the rest by kernel: " + "; ".join(
        f"{short_kernel_name(k)} {v:.3f} ms" for k, v in rest.most_common(8)))
    del req

    # (d) the kernel at the prefill's shape against its plain version, its
    # bound (bf16 tensor cores, where it computes), and the one PyTorch call
    # that computes the same function (bf16 SDPA with enable_gqa), timed as
    # a yardstick only
    measure(dense_key)
    r = measured[dense_key]
    dense_flops = shape_work(*dense_key)[0]
    log(f"[dense] {smi}: flash_attention {dense_key[1]}: device time "
        f"{r['device_ms']:.4f} ms a call, "
        f"{dense_flops / r['device_ms'] / 1e9:.1f} TFLOP/s, "
        f"{r['bound_ms'] / r['device_ms']:.1%} of its {r['bound_ms']:.4f} ms "
        f"bound (bf16 tensor cores, {r['bound_by']}), bf16 SDPA "
        f"{r['library_device_ms']:.4f} ms "
        f"({r['device_ms'] / r['library_device_ms']:.2f}x); "
        f"{dcfg.num_layers} calls a request: "
        f"{dcfg.num_layers * r['device_ms'] / 1e3:.4f} s")

    # (e) decode at batch DENSE_DECODE_BATCH over a cache of DENSE_SEQ
    # slots (the last DENSE_DECODE_STEPS positions): ms a step, then one
    # step under the profiler, and the cost of widening one layer's cache
    # to f32 for the f32 products (decode_attention)
    d = decode_run("Yi-6B", darch, dparams, dgen, dev, env,
                   DENSE_DECODE_BATCH, DENSE_SEQ, DENSE_DECODE_STEPS)
    steps, cache = d["walls"], d["cache"]
    step_wall, dsplit, _, _, _, didle = d["profile"]
    widen_ms = device_ms(lambda: (cache["k"][0].float(),
                                  cache["v"][0].float()), n=5, rounds=3)
    dense_mem = torch.cuda.max_memory_allocated()
    log(f"[dense] {smi}: decode {DENSE_DECODE_STEPS} steps at batch "
        f"{DENSE_DECODE_BATCH}, cache {tuple(cache['k'].shape)} "
        f"({cache['k'].numel() * 4 / 1e9:.2f} GB of k and v): median step "
        f"{np.median(steps) * 1e3:.3f} ms, first {steps[0] * 1e3:.3f} ms, "
        f"no kernel launch; one step profiled: wall {step_wall * 1e3:.3f} "
        f"ms, device time {ms_list(dsplit)} (bmm: attention's products "
        f"over the cache), idle {didle:.1%}; widening one "
        f"layer's k and v to f32 {widen_ms:.3f} ms of device time "
        f"({widen_ms * dcfg.num_layers:.3f} ms over {dcfg.num_layers} "
        f"layers); max_memory_allocated {dense_mem / 1e6:.1f} MB; the "
        f"phase took {time.perf_counter() - t_dense:.1f} s")
    del dparams, d, cache, dpre

    # ---- 7c. Qwen3-30B-A3B through the model path (the MoE family) -------
    moe_out = moe_phase(dev, env, smi)
    moe_shapes = moe_out["shapes"]
    for shape in moe_shapes:
        if shape not in measured:
            measure(shape)

    # ---- 8. ops.pack over one GPT-Neo-1.3B layer's weights ----------------
    big_cfg = get_arch(SERVE_MODELS[0]).model
    layer_w = layer_weights(big_cfg)
    wgen = torch.Generator(device=dev).manual_seed(3)
    packed = {}
    ops.reset_launch_counts()
    for dt in (torch.float32, torch.bfloat16):
        for wname, (k, n) in layer_w:
            w = torch.randn((k, n), generator=wgen, device=dev).to(dt)
            packed[(wname, dt)] = (w, ops.pack(w))
    torch.cuda.synchronize()
    pack_shapes = Counter({("layout_pack", key): c for key, c in
                           ops.launch_counts_by_shape()["layout_pack"]
                           .items()})
    check(sum(ops.launch_counts().values()) == len(packed) == sum(
        pack_shapes.values()), f"pack launches {ops.launch_counts()}")
    for (wname, dt), (w, t) in packed.items():
        check(torch.equal(bits(t), bits(ref.layout_pack_ref(
            w, ops.native_tile(dt)))), f"pack {wname} {dt} not bit-exact")
        check(torch.equal(bits(ops.unpack(t, tuple(w.shape))), bits(w)),
              f"unpack {wname} {dt}")
    del packed, w, t
    for shape in sorted(pack_shapes, key=str):
        r, c, tr, tc, dt = shape[1]
        w = torch.randn((r, c), generator=wgen, device=dev).to(dt)
        got = layout_pack(w)
        want = ref.layout_pack_ref(w, (tr, tc))
        torch.cuda.synchronize()
        check(torch.equal(bits(got), bits(want)), f"pack {shape}")
        flops, nbytes = shape_work("layout_pack", shape[1])
        bms, bby = bound_ms(flops, nbytes, peaks)
        plan = pack_plan(r, c, tr, tc, dt.itemsize, w.data_ptr(),
                         got.data_ptr())
        # on shapes the tile divides, the same copy is one PyTorch call,
        # and a plain device copy of the same bytes is the card's ceiling
        library = copy = None
        if r % tr == 0 and c % tc == 0:
            def library():
                return w.view(r // tr, tr, c // tc, tc).permute(
                    0, 2, 1, 3).contiguous()

            def copy():
                return torch.empty_like(w).copy_(w)
            check(torch.equal(bits(library()), bits(got)),
                  f"pack {shape}: the permute differs from the kernel")
        measured[shape] = {
            "ms": call_ms(lambda: layout_pack(w)),
            "device_ms": device_ms(lambda: layout_pack(w)),
            "warm_device_ms": kernel_device_ms(lambda: layout_pack(w),
                                               cold=False),
            "cold_device_ms": kernel_device_ms(lambda: layout_pack(w),
                                               cold=True),
            "plain_ms": call_ms(lambda: ref.layout_pack_ref(w, (tr, tc))),
            "library_ms": library and call_ms(library),
            "library_device_ms": library and device_ms(library),
            "library_warm_device_ms": library and kernel_device_ms(
                library, cold=False),
            "library_cold_device_ms": library and kernel_device_ms(
                library, cold=True),
            "copy_warm_device_ms": copy and kernel_device_ms(copy,
                                                             cold=False),
            "copy_cold_device_ms": copy and kernel_device_ms(copy,
                                                             cold=True),
            "path": plan.path, "bound_ms": bms, "bound_by": bby,
            "max_abs_err": (got.float() - want.float()).abs().max().item()}
        m_ = measured[shape]
        lib_note = "no library call (the tile does not divide the shape)"
        if library:
            lib_note = (
                f"library (view, permute, contiguous) one call "
                f"{m_['library_ms']:.4f} ms, events "
                f"{m_['library_device_ms']:.4f} ms, kernel warm "
                f"{m_['library_warm_device_ms']:.4f} ms, cold "
                f"{m_['library_cold_device_ms']:.4f} ms: kernel "
                f"{m_['warm_device_ms'] / m_['library_warm_device_ms']:.3f}x "
                f"the library warm, "
                f"{m_['cold_device_ms'] / m_['library_cold_device_ms']:.3f}x "
                f"cold; plain copy of the same bytes warm "
                f"{m_['copy_warm_device_ms']:.4f} ms, cold "
                f"{m_['copy_cold_device_ms']:.4f} ms "
                f"({nbytes / m_['copy_cold_device_ms'] / 1e6:.0f} GB/s), "
                f"kernel "
                f"{m_['cold_device_ms'] / m_['copy_cold_device_ms']:.3f}x "
                f"the copy cold")
        log(f"[pack] {shape}: {plan.path} path ({plan.walk} walk, "
            f"{plan.blocks} blocks of {plan.threads}); one call: kernel "
            f"{m_['ms']:.4f} ms, plain {m_['plain_ms']:.4f} ms; events "
            f"around back-to-back calls {m_['device_ms']:.4f} ms; kernel "
            f"warm {m_['warm_device_ms']:.4f} ms "
            f"({nbytes / m_['warm_device_ms'] / 1e6:.0f} GB/s, "
            f"{bms / m_['warm_device_ms']:.1%} of the bound), cold "
            f"{m_['cold_device_ms']:.4f} ms "
            f"({nbytes / m_['cold_device_ms'] / 1e6:.0f} GB/s, "
            f"{bms / m_['cold_device_ms']:.1%}); bound {bms:.4f} ms ({bby}, "
            f"{nbytes / 1e6:.1f} MB); bit-exact; {lib_note}")
        del w, got, want, library, copy
    # the pass: each shape's times and bound times its launches
    pass_ms = {f: sum(measured[s][f] * n for s, n in pack_shapes.items())
               for f in ("bound_ms", "warm_device_ms", "cold_device_ms",
                         "library_warm_device_ms", "library_cold_device_ms",
                         "copy_cold_device_ms")}
    log(f"[pack] ops.pack over {len(layer_w)} weights of a {SERVE_MODELS[0]} "
        f"layer in f32 and bf16: {sum(pack_shapes.values())} launches, each "
        f"bit-exact against layout_pack_ref and unpacked back exactly; the "
        f"pass: kernel cold {pass_ms['cold_device_ms']:.4f} ms "
        f"({pass_ms['bound_ms'] / pass_ms['cold_device_ms']:.1%} of its "
        f"{pass_ms['bound_ms']:.4f} ms bound), warm "
        f"{pass_ms['warm_device_ms']:.4f} ms; the library cold "
        f"{pass_ms['library_cold_device_ms']:.4f} ms, warm "
        f"{pass_ms['library_warm_device_ms']:.4f} ms; a plain copy of the "
        f"same bytes cold {pass_ms['copy_cold_device_ms']:.4f} ms")

    # ---- 9. summary -------------------------------------------------------
    # each kernel's launches by shape on its path: serving (phase 5), the
    # fleet (phase 6b), the Mamba-2 prefill requests (phase 7), the Yi-6B
    # prefill requests (phase 7b), the Qwen3-30B-A3B prefill requests
    # (phase 7c), the pack pass (phase 8)
    path_counts = serve_shapes + fleet_shapes + mamba_shapes + \
        dense_shapes + moe_shapes + pack_shapes
    kernels = []
    for kn in SOURCES:
        # each shape's numbers weighted by its launches counted on the path
        weights = Counter({s: c for s, c in path_counts.items()
                           if s[0] == kn})
        total = sum(weights.values())
        check(total > 0, f"{kn} was not launched on its path")
        mean = {f: sum(measured[s][f] * c for s, c in weights.items()) / total
                for f in ("ms", "plain_ms", "bound_ms", "device_ms")}

        def mean_of(f):
            lib = [measured[s].get(f) for s in weights]
            return None if None in lib else sum(
                measured[s][f] * c for s, c in weights.items()) / total
        by = Counter()
        for s, c in weights.items():
            by[measured[s]["bound_by"]] += c
        kernels.append({
            "name": kn, "route": "cuda", "source": SOURCES[kn],
            "replaces": REPLACES[kn], "launches": total,
            "max_abs_err": max(measured[s]["max_abs_err"] for s in weights),
            "ms": mean["ms"], "plain_ms": mean["plain_ms"],
            "bound_ms": mean["bound_ms"], "bound_by": by.most_common(1)[0][0],
            "library_ms": mean_of("library_ms"),
            "device_ms": mean["device_ms"],
            "library_device_ms": mean_of("library_device_ms"),
            "per_shape": [{"shape": [str(v) if isinstance(v, torch.dtype)
                                     else v for v in s[1]],
                           "launches": c, **measured[s]}
                          for s, c in sorted(weights.items(), key=str)]})
        if kn == "layout_pack":
            kernels[-1].update({f: mean_of(f) for f in (
                "warm_device_ms", "cold_device_ms", "library_warm_device_ms",
                "library_cold_device_ms", "copy_warm_device_ms",
                "copy_cold_device_ms")})
    log("kernels: " + " ".join(
        f"{k['name']}=ok ({k['launches']} launches, one call {k['ms']:.4f} ms"
        + (f" = {k['ms'] / k['library_ms']:.3f}x the library"
           if k["library_ms"] else "")
        + f", device time {k['device_ms']:.4f} ms"
        + (f" = {k['device_ms'] / k['library_device_ms']:.3f}x the library"
           if k["library_device_ms"] else "") + ")" for k in kernels)
        + f"; serving max abs err vs plain {serve_err:.2e}; fleet "
        f"{fleet_err:.2e}; Mamba-2 prefill "
        f"vs plain {prefill_err:.2e}, decode vs prefill {consist_err:.2e}; "
        f"Yi-6B prefill vs plain {dense_plain_err:.2e}, decode vs prefill "
        f"{dense_consist_err:.2e}; Qwen3-30B-A3B prefill vs plain "
        f"{moe_out['plain_err']:.2e}, decode vs prefill "
        f"{moe_out['consist_err']:.2e}, MoE block gather vs dense "
        f"{moe_out['block_err']:.2e}; "
        f"total {time.perf_counter() - t_start:.1f}s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
