"""Multi-model serving entry point (the paper's headline scenario), on the card.

Every model runs on ``--device`` (``cuda``, the default, or ``cpu``): on
the card each projection is the CUDA ``streamed_matmul`` kernel and each
attention the CUDA ``flash_attention`` kernel; on the CPU their plain
PyTorch versions run.

Batch (Fig 6) mode — drain a pre-filled FIFO mix, here two of the paper's
models at full size under a pool smaller than their weights:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --models gptneo-1.3b,gptneo-s --policy stream \
        --budget-mb 2048 --requests 4 --seq 1024 --disk-gbps 0

Online mode — replay a Poisson arrival trace through the continuous
arrival-aware loop (batcher coalescing + queue-depth/arrival-time-driven
prefetch), with per-request arrival→completion latencies:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --models gptneo-s,gptneo-s --online --rate 4 --duration 2 \
        --budget-mb 256 --eviction cost

``--eviction`` picks the shared pool's policy: ``lru`` or ``cost``
(cheapest-to-restream first, à la Demand Layering).

SLO mode — same loop under deadline scheduling: every request gets a
deadline of ``arrival + --slo-ms``, runnable work is ordered earliest-
feasible-deadline first (exec estimate + cold-chunk restream cost), long
batches yield to tighter deadlines at op boundaries, and infeasible
requests are rejected up front instead of inflating tail latency:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --models gptneo-s,gptneo-s --online --scheduler slo --slo-ms 250 \
        --rate 8 --duration 2 --budget-mb 256

Priorities + deadline-aware batching: ``--priority-mix`` stamps
seeded per-request priority weights (weight:probability pairs; 0 =
best-effort) that bend the EDF key — heavier requests run, admit, and
survive shedding first — and ``--batch-cap`` controls the feasibility
cap that stops a batch from growing past the point where its exec
estimate would blow the tightest admitted deadline:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --models gptneo-s,gptneo-s --online --scheduler slo --slo-ms 250 \
        --rate 8 --duration 2 --budget-mb 256 \
        --priority-mix 0:0.2,1:0.6,2:0.2 --batch-cap on

Mix-weighted mode — partition the shared pool budget by request mix via
the joint allocator (``--mix``, aligned with ``--models``); with
``--replan`` the online loop tracks the observed mix (EWMA arrival
rates) and re-plans the split in the background when it drifts:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --models gptneo-s,gptneo-s --online --budget-mb 256 \
        --mix 8,1 --replan

Fleet mode — replay the trace through a multi-replica tier behind the
cache-affinity Router instead of one engine. Each replica gets its OWN
pool budget (the fleet is a partitioned weight cache) on ``--device``;
``--routing affinity`` keeps each model pinned to its consistent-hash
home replica, ``--routing round_robin`` is the cache-oblivious control:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --models gptneo-s,gptneo-s --online --replicas 3 \
        --routing affinity --budget-mb 128 --rate 8 --duration 2
"""
from __future__ import annotations

import argparse
from dataclasses import replace

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.core.streaming import HostModel, PreloadExecutor
from repro_torch.serving.batcher import BatcherConfig
from repro_torch.serving.clock import SimClock
from repro_torch.serving.config import add_serve_config_flags, \
    serve_config_from_args
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.stream import (RequestStream, assign_priorities,
                                        poisson_trace, stamp_req_ids)
from repro_torch.serving.types import SLOConfig


def make_requests(models, n: int, seq: int, seed: int = 0):
    """The batch-mode requests: round-robin over ``models`` (name ->
    HostModel, in registration order), seeded random tokens, ``req_id``
    = submission index. The same arguments give the same requests, so a
    caller can recompute the tokens behind each response."""
    rng = np.random.default_rng(seed)
    keys = list(models)
    out = []
    for r in range(n):
        name = keys[r % len(keys)]
        out.append(Request(model=name, req_id=r, tokens=rng.integers(
            0, models[name].cfg.vocab, (1, seq), dtype=np.int32)))
    return out


def online_trace(models, rate: float, duration: float, seq: int,
                 mix=None):
    """The online-mode Poisson trace (seed 0, ``req_id`` = trace index):
    ``rate`` req/s per model, or split by ``mix`` (mean rate preserved;
    zero-weight models get no arrivals)."""
    vocab = min(m.cfg.vocab for m in models.values())
    if mix is not None:
        mean_w = sum(mix.values()) / len(mix)
        rates = {n: rate * mix[n] / mean_w for n in models if mix[n] > 0}
    else:
        rates = {n: rate for n in models}
    return stamp_req_ids(poisson_trace(rates, duration, vocab=vocab,
                                       seq=seq, seed=0))


def main(argv=None):
    ap = argparse.ArgumentParser()
    # serve-loop knobs (--scheduler/--step-mode/--admission/--preempt/
    # --batch-cap/--replan*/--result-mode) derive from ServeConfig: one
    # source of truth for names, defaults, choices, and help text
    add_serve_config_flags(ap)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the models run: the card with the CUDA "
                    "kernels, or the CPU with their plain versions")
    ap.add_argument("--models", default="gptneo-s")
    ap.add_argument("--policy", choices=["stream", "preload"], default="stream")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--m-peak-mb", type=int, default=96)
    ap.add_argument("--disk-gbps", type=float, default=0.5)
    ap.add_argument("--budget-mb", type=int, default=0,
                    help="shared device pool budget (0 = no shared cache)")
    ap.add_argument("--eviction", choices=["lru", "cost"], default="lru",
                    help="pool eviction policy (cost = cheapest-to-restream)")
    ap.add_argument("--layers", type=int, default=0,
                    help="override layer count (reduced models)")
    ap.add_argument("--online", action="store_true",
                    help="serve a Poisson arrival trace via the online loop")
    ap.add_argument("--rate", type=float, default=4.0,
                    help="online: per-model arrival rate (req/s, virtual)")
    ap.add_argument("--duration", type=float, default=2.0,
                    help="online: trace duration (virtual seconds)")
    ap.add_argument("--slo-ms", type=float, default=250.0,
                    help="online: per-request latency SLO (deadline = "
                    "arrival + slo; used by --scheduler slo)")
    ap.add_argument("--priority-mix", default="",
                    help="online: seeded random per-request priority "
                    "weights as weight:probability pairs, e.g. "
                    "'0:0.2,1:0.6,2:0.2' (0 = best-effort). Empty = all "
                    "priority 1.0 (plain EDF)")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-wait-ms", type=float, default=20.0)
    ap.add_argument("--mix", default="",
                    help="request-mix weights for the joint budget "
                    "allocator, comma-separated and aligned with --models "
                    "(e.g. --models a,b --mix 8,1). Empty = uniform "
                    "iterative shrink (no joint split)")
    ap.add_argument("--cost-model", choices=["ewma", "learned"],
                    default="ewma",
                    help="online: batch-latency cost model. ewma = "
                    "per-model EWMA with a fixed batch-growth factor; "
                    "learned = online RLS fit over (batch size, cold "
                    "bytes, decode tokens) that takes over from the EWMA "
                    "once calibrated and feeds admission, the batch cap, "
                    "allocation, and proactive re-planning")
    ap.add_argument("--min-samples", type=int, default=8,
                    help="learned cost model: observed batches per model "
                    "before the RLS fit replaces the EWMA estimate")
    ap.add_argument("--kv-page-kb", type=int, default=0,
                    help="unified budget: paged-KV page size (KB); > 0 "
                    "adds every active sequence's KV cache to the shared "
                    "pool (prompt prefill + per-decode-step growth, pages "
                    "pinned while the sequence runs). 0 = weights-only")
    ap.add_argument("--kv-restore", choices=["reload", "recompute"],
                    default="reload",
                    help="unified budget: cost of bringing an evicted KV "
                    "page back — reload its bytes from storage, or "
                    "recompute the attention prefix (priced at page_bytes "
                    "* --kv-recompute-factor restream-equivalents)")
    ap.add_argument("--kv-recompute-factor", type=float, default=1.5,
                    help="unified budget: recompute cost multiplier for "
                    "--kv-restore recompute")
    ap.add_argument("--kv-target-seqs", type=int, default=4,
                    help="unified budget: concurrent sequences per model "
                    "the joint allocator funds KV reservations for")
    ap.add_argument("--decode-tokens", type=int, default=0,
                    help="unified budget: planned decode length stamped "
                    "on every trace request (KV grows by this many tokens "
                    "over the request's execution)")
    ap.add_argument("--arena", action="store_true",
                    help="unified budget: reserve each model's profile-"
                    "driven activation-arena peak (core.arena) in the "
                    "shared pool for the duration of a batch")
    ap.add_argument("--replicas", type=int, default=1,
                    help="online: serve through a fleet of N replicas "
                    "behind the cache-affinity Router (each replica gets "
                    "its own --budget-mb pool)")
    ap.add_argument("--routing", choices=["affinity", "round_robin"],
                    default="affinity",
                    help="fleet request routing: affinity = consistent-"
                    "hash home replica with hot/cold spillover; "
                    "round_robin = cache-oblivious control")
    ap.add_argument("--timeout-ms", type=float, default=2000.0,
                    help="fleet: per-attempt response timeout before the "
                    "Router retries on a sibling (keep well above the "
                    "real per-batch latency, or healthy replicas get "
                    "treated as failed)")
    args = ap.parse_args(argv)
    if args.replicas > 1 and not args.online:
        ap.error("--replicas needs --online (the Router replays a trace)")

    names = args.models.split(",")
    mix = None
    if args.mix:
        weights = [float(w) for w in args.mix.split(",")]
        if len(weights) != len(names):
            ap.error("--mix needs one weight per --models entry "
                     f"({len(names)}), got {len(weights)}")
        mix = {f"{n}#{i}": w for i, (n, w) in enumerate(zip(names, weights))}
    kv_spec = None
    if args.kv_page_kb > 0:
        from repro_torch.serving.weight_cache import KVSpec
        kv_spec = KVSpec(page_bytes=args.kv_page_kb << 10,
                         restore=args.kv_restore,
                         recompute_factor=args.kv_recompute_factor)
    engine_kw = dict(policy=args.policy, m_peak=args.m_peak_mb << 20,
                     disk_bw=args.disk_gbps * 1e9,
                     budget_bytes=(args.budget_mb << 20) or None,
                     eviction=args.eviction, mix=mix,
                     kv=kv_spec, kv_target_seqs=args.kv_target_seqs,
                     arena=args.arena, device=args.device)
    rng = np.random.default_rng(0)
    models = {}
    for i, n in enumerate(names):
        cfg = get_arch(n).model
        if args.layers:
            cfg = replace(cfg, num_layers=args.layers)
        models[f"{n}#{i}"] = HostModel.build(cfg, seq=args.seq, seed=i,
                                             device=args.device)
    engine = None
    if args.replicas <= 1:
        engine = ServingEngine(**engine_kw)
        for nm, m in models.items():
            engine.register(nm, m)

    if args.online:
        # with --mix, offered traffic follows the declared mix so the
        # joint split faces the load it was planned for
        trace = online_trace(models, args.rate, args.duration, args.seq,
                             mix=mix)
        if args.decode_tokens > 0:
            for r in trace:
                r.decode_tokens = args.decode_tokens
        if args.priority_mix:
            pmix = {}
            for pair in args.priority_mix.split(","):
                w, _, prob = pair.partition(":")
                try:
                    weight, p = float(w), float(prob or 1.0)
                except ValueError:
                    ap.error(f"--priority-mix: malformed pair {pair!r} "
                             "(expected weight:probability, e.g. "
                             "0:0.2,1:0.6,2:0.2)")
                if weight in pmix:
                    ap.error(f"--priority-mix: duplicate weight {w}")
                pmix[weight] = p
            trace = assign_priorities(trace, pmix, seed=1)
        # warm the kernels first: the loop charges measured real
        # durations, and the first launch's build would otherwise poison
        # both the latency report and the SLO cost estimates
        for m in models.values():
            PreloadExecutor(m).run(rng.integers(0, m.cfg.vocab,
                                                (1, args.seq),
                                                dtype=np.int32))
        # virtual arrival timeline + measured real execution charges
        clock = SimClock()
        slo = SLOConfig(default_slo_s=args.slo_ms / 1e3) \
            if args.scheduler == "slo" else None
        cost_model = None
        if args.cost_model == "learned":
            from repro_torch.core.latency_model import OnlineLatencyModel
            cost_model = OnlineLatencyModel(min_samples=args.min_samples)
        cfg = serve_config_from_args(
            args, slo=slo, cost_model=cost_model,
            batcher=BatcherConfig(max_batch=args.max_batch,
                                  max_wait_s=args.max_wait_ms / 1e3))
        if args.replicas > 1:
            from repro_torch.serving.replica import Replica
            from repro_torch.serving.router import Router
            fleet = []
            for rid in range(args.replicas):
                rep = Replica(rid, **engine_kw)
                for nm, m in models.items():
                    rep.register(nm, m)
                # each replica gets its own learned cost model instance
                # (calibration state must not be shared across engines)
                rep.start(config=cfg if cost_model is None else
                          replace(cfg, cost_model=OnlineLatencyModel(
                              min_samples=args.min_samples)))
                fleet.append(rep)
            router = Router(fleet, routing=args.routing,
                            timeout_s=args.timeout_ms / 1e3)
            responses = router.serve(trace, slo=slo)
            for r in responses:
                print(f"{r.model:14s} arrival {r.arrival_s:7.3f}s "
                      f"queue {r.queue_s:6.3f}s "
                      f"latency {r.latency_s:6.3f}s {r.status}")
            frep = router.report(responses)
            print(f"FLEET {args.replicas} replicas "
                  f"routing={args.routing} "
                  f"served {frep['served']}/{frep['requests']} "
                  f"failed={frep['failed']} retries={frep['retries']} "
                  f"miss_rate={frep['miss_rate']:.2f} "
                  f"bad_rate={frep['bad_rate']:.2f} "
                  f"restream_mb={frep['restream_bytes'] / 1e6:.1f}")
            for rid, st in frep["per_replica"].items():
                print(f"  r{rid}: batches={st['batches']} "
                      f"restream_mb={st['restream_bytes'] / 1e6:.1f} "
                      f"breaker={st['breaker']}")
            return responses, router
        responses = engine.serve(RequestStream.from_trace(trace),
                                 clock=clock, config=cfg)
        for r in responses:
            if r.status == "rejected":
                print(f"{r.model:14s} arrival {r.arrival_s:7.3f}s "
                      f"REJECTED (deadline {r.deadline_s:.3f}s infeasible)")
                continue
            print(f"{r.model:14s} arrival {r.arrival_s:7.3f}s "
                  f"queue {r.queue_s:6.3f}s latency {r.latency_s:6.3f}s "
                  f"batch={r.batch_size}")
        served = [r for r in responses if r.status == "ok"]
        lats = [r.latency_s for r in served] or [float("nan")]
        line = (f"ONLINE {len(served)}/{len(responses)} requests served "
                f"({engine.batch_log.total} batches) "
                f"mean latency {np.mean(lats):.3f}s "
                f"p95 {np.percentile(lats, 95):.3f}s "
                f"pool hit rate {engine.cache_hit_rate():.2f} "
                f"scheduler={args.scheduler} eviction={args.eviction}")
        detail = []
        if slo is not None:
            rep = engine.slo_report(responses)
            line += (f" slo={args.slo_ms:.0f}ms "
                     f"miss_rate={rep['miss_rate']:.2f} "
                     f"rejection_rate={rep['rejection_rate']:.2f} "
                     f"preemptions={rep['preemptions']} "
                     f"deferred_joins={rep['deferred_joins']}")
            if args.priority_mix:
                line += (" priority_miss_rate="
                         f"{rep['priority_miss_rate']:.2f}")
                detail = [f"  priority={p:g}: {st['served']}/"
                          f"{st['requests']} served "
                          f"miss_rate={st['miss_rate']:.2f} "
                          f"rejection_rate={st['rejection_rate']:.2f} "
                          f"p50={st['p50_s']:.3f}s p99={st['p99_s']:.3f}s"
                          for p, st in rep["per_priority"].items()]
        if args.replan:
            swaps = sum(1 for e in engine.replan_log
                        if e["event"] == "swap")
            line += f" replans={swaps}"
        if engine.unified:
            # exact streaming counters — the ring-buffered kv_log only
            # retains a window at trace scale
            grown = engine.kv_grown_bytes
            rej = engine.kv_rejects
            line += (f" kv_grown_mb={grown / 1e6:.1f} "
                     f"kv_rejects={rej} reserved_mb="
                     f"{engine.multi_plan.meta.get('reserved_bytes', 0) / 1e6:.1f}"
                     if engine.multi_plan is not None else
                     f" kv_grown_mb={grown / 1e6:.1f} kv_rejects={rej}")
        print(line)
        for d in detail:
            print(d)
        if cost_model is not None:
            for nm, st in cost_model.calibration_report().items():
                coef = st["coef"]
                print(f"  calib {nm}: samples={st['samples']} "
                      f"calibrated={st['calibrated']} "
                      f"mae={st['mae_s'] * 1e3:.2f}ms "
                      f"rel_err={st['rel_err']:.3f} "
                      f"drift={st['drift']:.3f} "
                      f"base={coef['base_s'] * 1e3:.2f}ms "
                      f"growth={coef['growth']:.3f}")
        return responses, engine

    for req in make_requests(engine.models, args.requests, args.seq):
        engine.submit(req)
    responses = engine.run_all()
    for r in responses:
        print(f"{r.model:14s} latency {r.latency_s:.3f}s "
              f"(init {r.init_s:.3f} exec {r.exec_s:.3f}) "
              f"peak {r.peak_bytes/1e6:.1f}MB")
    print(f"GLOBAL peak {engine.peak_memory()/1e6:.1f}MB "
          f"avg {engine.avg_memory()/1e6:.1f}MB "
          f"pool hit rate {engine.cache_hit_rate():.2f} "
          f"policy={args.policy}")
    return responses, engine


if __name__ == "__main__":
    main()
