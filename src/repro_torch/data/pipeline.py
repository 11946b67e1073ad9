"""Data pipeline: deterministic synthetic LM shards with per-host sharding,
background prefetch, and resumable iteration state.

Production layout: each host reads only its slice of the global batch
(``host_index``/``host_count``); the loader hands out numpy arrays that the
trainer places onto the local devices. Synthetic shards are seeded by
(shard_id, step) so any host can reproduce any step — which is what makes
checkpoint-resume and elastic re-sharding exact.

The JAX package's ``repro.data.pipeline``, which imports only numpy, copied
unchanged: the same ``DataConfig`` gives the same batches bit for bit.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    host_index: int = 0
    host_count: int = 1
    seed: int = 0
    pad_frac: float = 0.02            # fraction of padded (-1) targets
    prefetch: int = 2


@dataclass
class DataState:
    step: int = 0


class SyntheticLMStream:
    """Deterministic synthetic token stream (zipf-ish unigram mix +
    shift-structured targets so the loss is learnable)."""

    def __init__(self, cfg: DataConfig, state: Optional[DataState] = None):
        assert cfg.global_batch % cfg.host_count == 0
        self.cfg = cfg
        self.state = state or DataState()
        self.local_batch = cfg.global_batch // cfg.host_count

    def _batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + cfg.host_index)
        # zipf-flavoured unigram distribution, stable across hosts
        ranks = np.arange(1, cfg.vocab + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = rng.choice(cfg.vocab, size=(self.local_batch, cfg.seq_len + 1),
                          p=probs).astype(np.int32)
        # inject copy structure: token t+1 often repeats token t
        rep = rng.random((self.local_batch, cfg.seq_len)) < 0.3
        toks[:, 1:][rep] = toks[:, :-1][rep]
        tokens = toks[:, :-1]
        targets = toks[:, 1:].copy()
        pad = rng.random(targets.shape) < cfg.pad_frac
        targets[pad] = -1
        return {"tokens": tokens, "targets": targets}

    def __iter__(self) -> Iterator[dict]:
        while True:
            b = self._batch_at(self.state.step)
            self.state.step += 1
            yield b

    def checkpoint(self) -> dict:
        return {"step": self.state.step}

    def restore(self, snap: dict):
        self.state.step = int(snap["step"])

    def reshard(self, host_index: int, host_count: int) -> "SyntheticLMStream":
        """Elastic re-shard: same global stream, new host topology."""
        cfg = DataConfig(**{**self.cfg.__dict__,
                            "host_index": host_index,
                            "host_count": host_count})
        return SyntheticLMStream(cfg, DataState(self.state.step))


class PrefetchIterator:
    """Background-thread prefetch (depth cfg.prefetch)."""

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.it = it
        self.err = None
        self._stop = threading.Event()
        self.t = threading.Thread(target=self._fill, daemon=True)
        self.t.start()

    def _fill(self):
        try:
            for b in self.it:
                if self._stop.is_set():
                    return
                self.q.put(b)
        except Exception as e:  # noqa: BLE001
            self.err = e
            self.q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        b = self.q.get()
        if b is None:
            raise self.err or StopIteration
        return b

    def close(self):
        self._stop.set()
        try:
            self.q.get_nowait()
        except queue.Empty:
            pass


def make_stream(cfg: DataConfig) -> PrefetchIterator:
    return PrefetchIterator(iter(SyntheticLMStream(cfg)), cfg.prefetch)
