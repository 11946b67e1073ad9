"""WeightCache — shared budgeted device-memory pool for multi-DNN serving.

The paper's multi-DNN story (§1, §4.4) is that several models share scarce
device memory: weights stream in on demand instead of every model being
preloaded. This module is the pool those weights live in. Executors and the
engine's cross-model prefetcher check weight *chunks* (and assembled
weights) in and out under a single byte budget:

  * entries are keyed by ``(model, weight, chunk)`` tuples — chunk is an
    int index for in-flight pieces or ``"w"`` for an assembled weight;
  * ``acquire`` pins an entry (it cannot be evicted while an executor or
    prefetcher holds it) and counts a hit; a miss is counted so callers
    get end-to-end hit-rate accounting per model;
  * ``put`` inserts under the budget, evicting *unpinned* entries to make
    room; if even full eviction cannot fit the entry, the put is rejected
    (the caller keeps a transient array) — the pool's ``used_bytes``
    therefore NEVER exceeds ``budget_bytes``. Eviction is two-phase:
    victims are SELECTED first and committed only when they free enough
    bytes, so a rejected put leaves residency, LRU order, and the byte
    ledger exactly as they were (a partial eviction on rejection would
    silently shrink other models' residency);
  * pinning is how plans become eviction policy: the engine pins exactly
    the chunks the next model's OverlapPlan schedules earliest, so
    eviction pressure from the currently-executing model cannot throw away
    bytes that are about to be consumed ("plan-aware pinned eviction").

Unified budget pool: the same budget now carries three TYPED
reservation kinds, because for the LLM configs the KV cache dominates
device memory at real batch sizes and activations were unaccounted for:

  * ``kind="weight"`` — today's entries, exactly as before;
  * ``kind="kv"``     — paged KV blocks (``KVSpec.page_bytes`` each),
    keyed ``(model, "__kv__", seq_id, page_idx)``. ``kv_grow`` charges
    prefill/decode growth to an ACTIVE sequence (pages stay pinned while
    the sequence is active, so capacity pressure can never evict live
    context); ``kv_release`` unpins (sequence finished or preempted —
    pages become evictable/offloadable warm state) or drops; ``kv_resume``
    re-pins resident pages and restores evicted ones. A page's restream
    cost is the explicit recompute-vs-reload choice (``KVSpec.restore``):
    reloading moves ``page_bytes``, recomputing costs
    ``page_bytes * recompute_factor`` restream-byte-equivalents — the
    cost policy's currency, so "cheapest to bring back" stays one axis;
  * ``kind="arena"``  — per-model activation arenas (one pinned entry
    keyed ``(model, "__arena__")``, peak sized by the profile-driven
    offset calculation in ``core/arena.py``), reserved for the duration
    of a batch via ``reserve_arena`` / ``release_arena``. An arena's
    restream cost is 0: scratch costs nothing to re-materialize, so the
    cost policy reclaims idle arenas first.

With no KV spec and no arena reservations every new path is dormant and
the pool behaves bit-for-bit as the weights-only pool did.

Eviction policy is pluggable (Demand Layering, PAPERS.md):

  * ``"lru"``  — least-recently-used unpinned entry first (default);
  * ``"cost"`` — cheapest-to-restream unpinned entry first, where an
    entry's restream cost is ``restream_bytes / disk_bw`` (``put`` takes
    an optional ``restream_bytes`` — e.g. int8-quantized chunks restream
    fewer bytes than they occupy on device; defaults to ``nbytes``).
    Ties (equal cost) break in LRU order. Evicting cheap-to-reload bytes
    first keeps expensive weights resident when policies compete for one
    pool.

The ledger balances at all times::

    used_bytes() == stats.inserted_bytes - stats.evicted_bytes
                                         - stats.removed_bytes

``evicted_*`` counts policy evictions (capacity pressure); ``removed_*``
counts explicit removals (``remove`` / ``evict_model`` / ``clear`` and the
old bytes replaced by a ``put`` refresh) — the two are separated so
evicted-vs-restreamed accounting stays exact when policies are compared.
``ledger_balanced()`` additionally requires ``release_underflows == 0``:
a release of a PRESENT but unpinned entry is a double-release (a
pin-accounting bug upstream) and is counted instead of silently masked.

Thread-safe: the engine's prefetch thread, executor loader threads, and
the compute thread all touch the pool concurrently.

NOTE: this module must stay free of `repro` imports — core/streaming.py
imports it while serving/engine.py imports core, so any repro dependency
added here risks an import cycle through core/__init__.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

EVICTION_POLICIES = ("lru", "cost")
KV_RESTORE_MODES = ("reload", "recompute")

# key sentinels for the typed reservation kinds; weight keys never use
# these as their second element (weight names come from the op graph)
KV_KIND = "__kv__"
ARENA_KIND = "__arena__"


@dataclass(frozen=True)
class KVSpec:
    """Paged-KV configuration for the unified pool.

    ``page_bytes`` is the fixed page size every sequence's KV cache is
    quantized to. ``restore`` is the explicit recompute-vs-reload knob:
    a page evicted while its sequence was offloaded costs either a
    reload of its bytes from storage (``"reload"``) or a recompute of
    the attention prefix (``"recompute"``, priced at
    ``page_bytes * recompute_factor`` restream-byte-equivalents — the
    cost eviction policy's currency, so weights and KV compete on one
    axis)."""
    page_bytes: int
    restore: str = "reload"
    recompute_factor: float = 1.5

    def __post_init__(self):
        if self.page_bytes <= 0:
            raise ValueError(f"page_bytes must be > 0, got {self.page_bytes}")
        if self.restore not in KV_RESTORE_MODES:
            raise ValueError(f"restore must be one of {KV_RESTORE_MODES}, "
                             f"got {self.restore!r}")
        if self.recompute_factor < 0:
            raise ValueError("recompute_factor must be >= 0, got "
                             f"{self.recompute_factor}")

    def restore_bytes(self) -> int:
        """Restream-byte-equivalents to bring one evicted page back."""
        if self.restore == "recompute":
            return int(self.page_bytes * self.recompute_factor)
        return int(self.page_bytes)


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    rejected_puts: int = 0
    refreshes: int = 0
    removals: int = 0
    inserted_bytes: int = 0
    evicted_bytes: int = 0
    removed_bytes: int = 0
    evicted_restream_bytes: int = 0    # bytes a re-load would actually move
    # double-releases detected: a release() of a PRESENT entry whose pin
    # count was already 0 — a pin-accounting bug upstream, surfaced here
    # instead of silently no-oping (ledger_balanced() fails while nonzero)
    release_underflows: int = 0
    # unified-pool counters: KV growth the budget could not admit, and
    # pages restored (reloaded-or-recomputed) on sequence resume
    kv_rejections: int = 0
    kv_restored_pages: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "rejected_puts": self.rejected_puts,
                "refreshes": self.refreshes,
                "removals": self.removals,
                "evicted_bytes": self.evicted_bytes,
                "removed_bytes": self.removed_bytes,
                "evicted_restream_bytes": self.evicted_restream_bytes,
                "release_underflows": self.release_underflows,
                "kv_rejections": self.kv_rejections,
                "kv_restored_pages": self.kv_restored_pages,
                "hit_rate": self.hit_rate}


@dataclass
class _Entry:
    value: Any
    nbytes: int
    pins: int = 0
    restream_bytes: int = 0            # bytes to stream it back (cost policy)
    kind: str = "weight"               # "weight" | "kv" | "arena"


class WeightCache:
    """Budgeted pool of device-resident weight chunks, paged KV blocks,
    and activation arenas (LRU or cost-aware).

    Keys are tuples whose first element is the owning model's name — all
    per-model accounting (hit rate, resident bytes) derives from that.
    """

    def __init__(self, budget_bytes: int, name: str = "pool",
                 policy: str = "lru", disk_bw: float = 1e9,
                 kv: Optional[KVSpec] = None):
        assert budget_bytes > 0, "cache budget must be positive"
        assert policy in EVICTION_POLICIES, policy
        self.budget_bytes = int(budget_bytes)
        self.name = name
        self.policy = policy
        self.disk_bw = float(disk_bw) if disk_bw > 0 else 1e9
        self.kv = kv
        self._entries: "OrderedDict[Tuple, _Entry]" = OrderedDict()
        self._used = 0
        self._lock = threading.RLock()
        self.stats = CacheStats()
        self._model_stats: Dict[str, CacheStats] = {}
        # per-model resident bytes, maintained incrementally: the serving
        # scheduler probes model_bytes() per queue at every preemption
        # checkpoint, which must not rescan the whole pool under the lock
        self._model_bytes: Dict[str, int] = {}
        # per-kind resident bytes (weight/kv/arena), same O(1) discipline
        self._kind_bytes: Dict[str, int] = {}
        # KV sequence bookkeeping: (model, seq_id) -> bytes appended so far
        # and total pages ever allocated. Survives page eviction — that is
        # the "offloaded" state kv_resume restores from.
        self._kv_tail: Dict[Tuple[str, Any], int] = {}
        self._kv_pages: Dict[Tuple[str, Any], int] = {}

    # -- internals ---------------------------------------------------------
    @staticmethod
    def _model_of(key: Tuple) -> str:
        return key[0] if isinstance(key, tuple) and key else str(key)

    def _mstats(self, key: Tuple) -> CacheStats:
        return self._model_stats.setdefault(self._model_of(key), CacheStats())

    def _bump_model_bytes(self, key: Tuple, delta: int):
        m = self._model_of(key)
        self._model_bytes[m] = self._model_bytes.get(m, 0) + delta

    def _bump_kind_bytes(self, kind: str, delta: int):
        self._kind_bytes[kind] = self._kind_bytes.get(kind, 0) + delta

    def _pick_victim(self, exclude=frozenset()) -> Optional[Tuple]:
        if self.policy == "cost":
            best, best_cost = None, None
            for k, e in self._entries.items():   # insertion order = LRU order
                if e.pins or k in exclude:
                    continue
                cost = e.restream_bytes / self.disk_bw
                if best is None or cost < best_cost:   # strict <: ties -> LRU
                    best, best_cost = k, cost
            return best
        for k, e in self._entries.items():           # OrderedDict = LRU order
            if e.pins == 0 and k not in exclude:
                return k
        return None

    def _select_victims(self, need: int) -> Optional[List[Tuple]]:
        """Phase 1 of two-phase eviction: the victim set (policy order)
        that would free `need` bytes, WITHOUT mutating anything — or None
        when even evicting every unpinned entry cannot."""
        if need > self.budget_bytes:
            return None
        free = self.budget_bytes - self._used
        victims: List[Tuple] = []
        chosen = set()
        while free < need:
            v = self._pick_victim(exclude=chosen)
            if v is None:
                return None
            chosen.add(v)
            victims.append(v)
            free += self._entries[v].nbytes
        return victims

    def _evict_until(self, need: int) -> bool:
        """Evict unpinned entries (policy order) until `need` bytes free.

        Two-phase: victims are selected first and committed only when the
        set actually frees enough — a request that is ultimately rejected
        must leave residency, LRU order, and the byte ledger untouched
        (one-at-a-time eviction used to leak partial evictions on the
        rejection path)."""
        victims = self._select_victims(need)
        if victims is None:
            return False
        for k in victims:
            e = self._entries.pop(k)
            self._used -= e.nbytes
            self._bump_model_bytes(k, -e.nbytes)
            self._bump_kind_bytes(e.kind, -e.nbytes)
            self.stats.evictions += 1
            self.stats.evicted_bytes += e.nbytes
            self.stats.evicted_restream_bytes += e.restream_bytes
            ms = self._mstats(k)
            ms.evictions += 1
            ms.evicted_bytes += e.nbytes
            ms.evicted_restream_bytes += e.restream_bytes
        return True

    def _insert(self, key: Tuple, value: Any, nbytes: int, pins: int,
                restream: int, kind: str):
        """Insert at MRU, assuming `_evict_until(nbytes)` already made
        room. Shared by put / kv_grow / kv_resume so the ledger and the
        kind/model byte breakdowns move through one place."""
        self._entries[key] = _Entry(value, nbytes, pins=pins,
                                    restream_bytes=restream, kind=kind)
        self._used += nbytes
        self._bump_model_bytes(key, nbytes)
        self._bump_kind_bytes(kind, nbytes)
        self.stats.inserted_bytes += nbytes
        self._mstats(key).inserted_bytes += nbytes

    # -- core API ----------------------------------------------------------
    def acquire(self, key: Tuple) -> Optional[Any]:
        """Pin + return the cached value, or None (miss) — both counted."""
        with self._lock:
            e = self._entries.get(key)
            ms = self._mstats(key)
            if e is None:
                self.stats.misses += 1
                ms.misses += 1
                return None
            e.pins += 1
            self._entries.move_to_end(key)
            self.stats.hits += 1
            ms.hits += 1
            return e.value

    def put(self, key: Tuple, value: Any, nbytes: int, pin: bool = False,
            restream_bytes: Optional[int] = None,
            kind: str = "weight") -> bool:
        """Insert or refresh under budget; returns False (rejected) if the
        entry cannot fit after evicting every unpinned entry. A rejected
        value stays the caller's transient responsibility — the pool never
        over-commits, and (two-phase eviction) a rejected put leaves every
        other entry exactly where it was. Re-putting an existing key
        REPLACES its value and size (pins carry over; a rejected refresh
        keeps the old entry)."""
        nbytes = int(nbytes)
        restream = int(restream_bytes) if restream_bytes is not None \
            else nbytes
        with self._lock:
            ms = self._mstats(key)
            old = self._entries.pop(key, None)
            if old is not None:
                self._used -= old.nbytes
                self._bump_model_bytes(key, -old.nbytes)
                self._bump_kind_bytes(old.kind, -old.nbytes)
            if not self._evict_until(nbytes):
                self.stats.rejected_puts += 1
                ms.rejected_puts += 1
                if old is not None:                 # restore at MRU position
                    self._entries[key] = old
                    self._used += old.nbytes
                    self._bump_model_bytes(key, old.nbytes)
                    self._bump_kind_bytes(old.kind, old.nbytes)
                return False
            pins = (old.pins if old is not None else 0) + (1 if pin else 0)
            self._insert(key, value, nbytes, pins, restream, kind)
            if old is not None:                     # ledger: old bytes leave
                self.stats.refreshes += 1
                self.stats.removed_bytes += old.nbytes
                ms.refreshes += 1
                ms.removed_bytes += old.nbytes
            return True

    def pin_existing(self, key: Tuple) -> Optional[int]:
        """Pin an already-resident entry WITHOUT hit/miss accounting;
        returns its nbytes, or None if absent. This is the engine's
        plan-aware protection primitive: entries the schedule says are
        needed soon get pinned so the current model's eviction pressure
        cannot drop them (sequential streaming otherwise thrashes a shared
        pool — every insert evicts exactly the bytes needed next)."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            e.pins += 1
            self._entries.move_to_end(key)
            return e.nbytes

    def release(self, key: Tuple):
        """Unpin. Absent keys are a legitimate no-op (the entry may have
        been consumed and removed by the executor that assembled it), but
        releasing a PRESENT entry whose pin count is already 0 is a
        double-release — a pin-accounting bug upstream — and is counted in
        ``release_underflows`` (``ledger_balanced()`` fails while nonzero)
        instead of being silently masked. The pin count itself is never
        corrupted: it stays at 0."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return
            if e.pins <= 0:
                self.stats.release_underflows += 1
                self._mstats(key).release_underflows += 1
                return
            e.pins -= 1

    def remove(self, key: Tuple) -> bool:
        """Drop an entry regardless of pins — used by the owning executor
        when chunk entries are consumed into an assembled weight. Counted
        as an explicit removal (not an eviction) in the ledger."""
        with self._lock:
            e = self._entries.pop(key, None)
            if e is None:
                return False
            self._used -= e.nbytes
            self._bump_model_bytes(key, -e.nbytes)
            self._bump_kind_bytes(e.kind, -e.nbytes)
            self.stats.removals += 1
            self.stats.removed_bytes += e.nbytes
            ms = self._mstats(key)
            ms.removals += 1
            ms.removed_bytes += e.nbytes
            return True

    # -- paged KV blocks (unified pool) ------------------------------------
    def _kv_key(self, model: str, seq_id, page_idx: int) -> Tuple:
        return (model, KV_KIND, seq_id, page_idx)

    def _require_kv(self) -> KVSpec:
        if self.kv is None:
            raise RuntimeError("KV paging needs a KVSpec: construct the "
                               "pool with WeightCache(..., kv=KVSpec(...))")
        return self.kv

    def kv_grow(self, model: str, seq_id, nbytes: int,
                value: Any = None) -> bool:
        """Charge `nbytes` of KV growth (prefill or decode steps) to an
        ACTIVE sequence. New pages are allocated pinned whenever the
        sequence's tail crosses a page boundary — pinned because evicting
        live context would corrupt the sequence; only ``kv_release`` makes
        a sequence's pages reclaimable. All-or-nothing: if the new pages
        cannot fit (two-phase eviction of unpinned entries included), the
        grow is rejected, nothing changes, and ``kv_rejections`` counts it
        — the caller sheds or defers the sequence."""
        spec = self._require_kv()
        nbytes = int(nbytes)
        if nbytes < 0:
            raise ValueError(f"kv_grow nbytes must be >= 0, got {nbytes}")
        with self._lock:
            sk = (model, seq_id)
            pb = spec.page_bytes
            tail = self._kv_tail.get(sk, 0)
            have = self._kv_pages.get(sk, 0)
            want = -(-(tail + nbytes) // pb)        # ceil division
            grow = max(0, want - have)
            if grow:
                if not self._evict_until(grow * pb):
                    self.stats.kv_rejections += 1
                    self._mstats((model,)).kv_rejections += 1
                    return False
                restream = spec.restore_bytes()
                for i in range(have, want):
                    self._insert(self._kv_key(model, seq_id, i), value, pb,
                                 pins=1, restream=restream, kind="kv")
            self._kv_tail[sk] = tail + nbytes
            self._kv_pages[sk] = max(have, want)
            return True

    def kv_release(self, model: str, seq_id, drop: bool = False) -> int:
        """A sequence finished (``drop=True``: pages leave the pool as
        explicit removals and the sequence's bookkeeping is cleared) or
        was preempted/offloaded (``drop=False``: pages are unpinned in
        place — warm, evictable state the policy reclaims under pressure
        at the spec's recompute-vs-reload restream cost, and
        ``kv_resume`` re-activates). Returns the number of resident pages
        affected; releasing an unknown sequence is a no-op."""
        with self._lock:
            sk = (model, seq_id)
            n = self._kv_pages.get(sk, 0)
            touched = 0
            for i in range(n):
                key = self._kv_key(model, seq_id, i)
                e = self._entries.get(key)
                if e is None:
                    continue                        # already evicted
                touched += 1
                if drop:
                    self.remove(key)
                else:
                    e.pins = 0
            if drop:
                self._kv_tail.pop(sk, None)
                self._kv_pages.pop(sk, None)
            return touched

    def kv_resume(self, model: str, seq_id) -> Optional[Tuple[int, int]]:
        """Re-activate a preempted sequence: re-pin its still-resident
        pages and restore (reload-or-recompute, per the spec) any pages
        evicted while it was offloaded. Two-phase and atomic: resident
        pages are pinned FIRST so victim selection for the missing pages
        can never pick the sequence's own pages, and if the missing pages
        cannot fit, the taken pins are rolled back and None is returned —
        the pool is left exactly as it was. On success returns
        ``(resident_pages, restored_pages)``."""
        spec = self._require_kv()
        with self._lock:
            sk = (model, seq_id)
            n = self._kv_pages.get(sk, 0)
            pb = spec.page_bytes
            resident, missing = [], []
            for i in range(n):
                key = self._kv_key(model, seq_id, i)
                (resident if key in self._entries else missing).append(i)
            newly_pinned = []
            for i in resident:
                e = self._entries[self._kv_key(model, seq_id, i)]
                if e.pins == 0:
                    e.pins = 1
                    newly_pinned.append(e)
            if missing:
                if not self._evict_until(len(missing) * pb):
                    for e in newly_pinned:          # atomic: roll pins back
                        e.pins = 0
                    self.stats.kv_rejections += 1
                    self._mstats((model,)).kv_rejections += 1
                    return None
                restream = spec.restore_bytes()
                for i in missing:
                    self._insert(self._kv_key(model, seq_id, i), None, pb,
                                 pins=1, restream=restream, kind="kv")
                self.stats.kv_restored_pages += len(missing)
            return (len(resident), len(missing))

    def kv_seq_bytes(self, model: str, seq_id) -> int:
        """Bytes charged to one sequence's KV tail so far (its logical
        length, independent of page residency)."""
        with self._lock:
            return self._kv_tail.get((model, seq_id), 0)

    def kv_resident_pages(self, model: str, seq_id) -> Tuple[int, int]:
        """(resident, total) page counts for one sequence — total pages
        survive eviction (the offloaded state kv_resume restores)."""
        with self._lock:
            n = self._kv_pages.get((model, seq_id), 0)
            res = sum(1 for i in range(n)
                      if self._kv_key(model, seq_id, i) in self._entries)
            return res, n

    # -- activation arenas (unified pool) ----------------------------------
    def _arena_key(self, model: str) -> Tuple:
        return (model, ARENA_KIND)

    def reserve_arena(self, model: str, nbytes: int) -> bool:
        """Reserve `model`'s activation arena (its profile-driven peak,
        ``core.arena.arena_size``) as one pinned entry for the duration of
        a batch. Idempotent at the same size (re-reserving just re-pins);
        growing goes through the same two-phase rejection discipline as
        ``put`` — a rejected grow keeps the old reservation. Returns
        whether the arena is reserved. ``nbytes <= 0`` reserves nothing
        and returns True (models with no profiled activations)."""
        nbytes = int(nbytes)
        if nbytes <= 0:
            return True
        with self._lock:
            key = self._arena_key(model)
            e = self._entries.get(key)
            if e is not None and e.nbytes == nbytes:
                e.pins = 1                          # re-reserve: one owner
                self._entries.move_to_end(key)
                return True
            # scratch restreams for free: the cost policy reclaims idle
            # arenas before any weight or KV byte
            ok = self.put(key, None, nbytes, pin=True, restream_bytes=0,
                          kind="arena")
            if ok:
                self._entries[key].pins = 1         # exactly one owner pin
            return ok

    def release_arena(self, model: str, drop: bool = False) -> bool:
        """End a batch's arena reservation. ``drop=False`` unpins in place
        — the arena stays warm for the model's next batch but is evictable
        scratch meanwhile; ``drop=True`` removes it from the pool (an
        explicit removal in the ledger). Absent arena: no-op, False."""
        with self._lock:
            key = self._arena_key(model)
            e = self._entries.get(key)
            if e is None:
                return False
            if drop:
                return self.remove(key)
            e.pins = 0
            return True

    def arena_bytes(self, model: str) -> int:
        with self._lock:
            e = self._entries.get(self._arena_key(model))
            return e.nbytes if e is not None else 0

    # -- queries -----------------------------------------------------------
    def contains(self, key: Tuple) -> bool:
        with self._lock:
            return key in self._entries

    def touch(self, key: Tuple):
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)

    def pins(self, key: Tuple) -> int:
        """Current pin count (0 for absent keys) — invariant probes."""
        with self._lock:
            e = self._entries.get(key)
            return e.pins if e is not None else 0

    def used_bytes(self) -> int:
        with self._lock:
            return self._used

    def free_bytes(self) -> int:
        with self._lock:
            return self.budget_bytes - self._used

    def pinned_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values() if e.pins)

    def kind_bytes(self) -> Dict[str, int]:
        """Resident bytes by reservation kind (weight/kv/arena) — the
        typed breakdown of the unified pool, O(1)."""
        with self._lock:
            return {k: v for k, v in self._kind_bytes.items() if v}

    def kv_bytes(self) -> int:
        with self._lock:
            return self._kind_bytes.get("kv", 0)

    def hit_rate(self) -> float:
        with self._lock:
            return self.stats.hit_rate

    def model_stats(self, model: str) -> CacheStats:
        with self._lock:
            return self._model_stats.setdefault(model, CacheStats())

    def model_bytes(self, model: str) -> int:
        """Resident bytes of one model's entries — O(1), maintained
        incrementally (the SLO scheduler calls this per queue at every
        preemption checkpoint)."""
        with self._lock:
            return self._model_bytes.get(model, 0)

    def keys(self):
        with self._lock:
            return list(self._entries)

    def stats_snapshot(self) -> dict:
        """Atomic copy of the ledger counters — diff two snapshots to
        prove what a critical section (e.g. the engine's online plan
        swap) did to the pool: equal snapshots mean the section evicted,
        removed, and inserted NOTHING."""
        with self._lock:
            return {"evictions": self.stats.evictions,
                    "evicted_bytes": self.stats.evicted_bytes,
                    "removals": self.stats.removals,
                    "removed_bytes": self.stats.removed_bytes,
                    "inserted_bytes": self.stats.inserted_bytes,
                    "release_underflows": self.stats.release_underflows,
                    "used_bytes": self._used}

    def ledger_balanced(self) -> bool:
        """inserted == resident + evicted + removed AND no release
        underflows — exact byte accounting (the Pisarchyk/Lee
        shared-buffer motivation: when policies compete for one pool,
        evicted-vs-restreamed byte counts must be precise) plus exact pin
        accounting (a detected double-release means some caller's
        pin/release pairing is broken, so "balanced" would be a lie)."""
        with self._lock:
            return (self.stats.release_underflows == 0
                    and self._used == (self.stats.inserted_bytes
                                       - self.stats.evicted_bytes
                                       - self.stats.removed_bytes))

    def evict_model(self, model: str) -> int:
        """Drop every unpinned entry of one model; returns bytes freed.
        Counted as explicit removals, not evictions."""
        with self._lock:
            freed = 0
            for k in [k for k, e in self._entries.items()
                      if self._model_of(k) == model and e.pins == 0]:
                freed += self._entries[k].nbytes
                self.remove(k)
            return freed

    def evict_model_to(self, model: str, target_bytes: int) -> int:
        """Shrink one model's residency to at most ``target_bytes``: drop
        its unpinned entries in LRU order until it fits (pinned bytes can
        leave it above target). Returns bytes freed. The proactive
        re-planner calls this right after a feasibility-triggered swap, so
        models whose cap shrank hand their over-cap bytes back BEFORE the
        favored model's next prefetch needs the room, instead of one
        eviction at a time mid-stream. Counted as explicit removals, like
        ``evict_model``."""
        target = max(0, int(target_bytes))
        with self._lock:
            over = self.model_bytes(model) - target
            if over <= 0:
                return 0
            freed = 0
            for k in [k for k, e in self._entries.items()
                      if self._model_of(k) == model and e.pins == 0]:
                if over <= 0:
                    break
                nb = self._entries[k].nbytes
                self.remove(k)
                freed += nb
                over -= nb
            return freed

    def clear(self):
        with self._lock:
            for k in list(self._entries):
                self.remove(k)
            self._kv_tail.clear()
            self._kv_pages.clear()
