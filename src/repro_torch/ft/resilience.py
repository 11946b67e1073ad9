"""Fault tolerance for 1000+-node runs: straggler detection, preemption
handling, and elastic re-meshing. The fleet's ``Router`` uses the
straggler detector; the checkpoint module the other two are wired around
is ported with training.

On real fleets the signals come from the cluster scheduler; here the policy
layer is real and the signal layer is injectable (tests drive it), which is
the part a dry-run CAN validate:

  * StragglerDetector — robust z-score on per-step times; persistent
    outliers trigger a `demote` callback (on a fleet: re-slice without
    the slow host; in tests: assert detection latency).
  * PreemptionHandler — SIGTERM/flag -> checkpoint-now -> clean exit.
  * ElasticController — on membership change, rebuild the mesh from the
    survivor count, restore the latest checkpoint with the new shardings,
    and re-shard the data stream (both restore paths are exact because
    checkpoints are logical-path-addressed and the data stream is
    (shard, step)-seeded).
"""
from __future__ import annotations

import signal
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch


class StragglerDetector:
    """Flags hosts whose step times are persistent robust outliers.

    Only hosts that reported since the previous ``check()`` are compared
    (and can accrue strikes): a host that stops reporting — departed,
    preempted, or demoted — is pruned rather than frozen at its last
    sample, so it re-joins with a clean slate instead of re-flagging
    instantly off stale strike counts.
    """

    def __init__(self, window: int = 32, z_thresh: float = 4.0,
                 patience: int = 3):
        self.window = window
        self.z_thresh = z_thresh
        self.patience = patience
        self.times: dict = {}
        self.strikes: dict = {}
        self._fresh: set = set()      # hosts seen since the last check()

    def record(self, host: int, step_time_s: float):
        dq = self.times.setdefault(host, deque(maxlen=self.window))
        dq.append(step_time_s)
        self._fresh.add(host)

    def check(self) -> list:
        """Returns hosts currently flagged as stragglers (among hosts that
        reported in the current window); prunes state for hosts absent
        from it."""
        for h in list(self.times):
            if h not in self._fresh:
                self.times.pop(h, None)
                self.strikes.pop(h, None)
        self._fresh.clear()
        lasts = {h: dq[-1] for h, dq in self.times.items() if dq}
        if len(lasts) < 3:
            return []
        vals = np.array(list(lasts.values()))
        med = np.median(vals)
        mad = np.median(np.abs(vals - med)) + 1e-9
        flagged = []
        for h, v in lasts.items():
            z = 0.6745 * (v - med) / mad
            if z > self.z_thresh:
                self.strikes[h] = self.strikes.get(h, 0) + 1
            else:
                self.strikes[h] = 0
            if self.strikes.get(h, 0) >= self.patience:
                flagged.append(h)
        return flagged


class PreemptionHandler:
    """SIGTERM (or programmatic flag) -> save-now -> stop the train loop."""

    def __init__(self, install_signal: bool = False):
        self.requested = threading.Event()
        if install_signal:
            signal.signal(signal.SIGTERM, lambda *_: self.requested.set())

    def preempt(self):
        self.requested.set()

    def should_stop(self) -> bool:
        return self.requested.is_set()


@dataclass
class ElasticEvent:
    step: int
    old_hosts: int
    new_hosts: int
    restore_step: Optional[int]


class ElasticController:
    """Policy driver for membership changes.

    mesh_builder(n_hosts) -> MeshEnv; restore_fn(env) -> (state,
    restore_step); both supplied by the launcher. ``restore_step`` is the
    last committed step the checkpoint restore landed on — it is recorded
    in the ``ElasticEvent`` and returned so the launcher resumes (and
    re-seeds the data stream) at exactly that step, never double-applying
    one.
    """

    def __init__(self, mesh_builder: Callable, restore_fn: Callable,
                 min_hosts: int = 1):
        self.mesh_builder = mesh_builder
        self.restore_fn = restore_fn
        self.min_hosts = min_hosts
        self.events: list = []

    def on_membership_change(self, step: int, old_hosts: int,
                             new_hosts: int):
        if new_hosts < self.min_hosts:
            raise RuntimeError(
                f"cluster below min_hosts ({new_hosts}<{self.min_hosts})")
        env = self.mesh_builder(new_hosts)
        state, restore_step = self.restore_fn(env)
        self.events.append(ElasticEvent(step, old_hosts, new_hosts,
                                        restore_step))
        return env, state, restore_step


def _tensors(out):
    """The tensors in ``out``: a tensor, or dicts, lists and tuples of
    them at any depth."""
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensors(v)


def timed_step(fn, *args, **kw):
    """``(fn(*args, **kw), seconds)``, the time covering the device work
    the call queued: every CUDA device that holds a tensor of the result
    is synchronised before the clock is read."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    for dev in {t.device for t in _tensors(out) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0
