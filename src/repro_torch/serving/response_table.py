"""Columnar response storage: a struct-of-arrays ``ResponseTable`` the
serve loop appends into instead of constructing one ``Response``
dataclass per request.

At 10^5 requests per-request ``Response`` allocation became the
dominant steady-state cost of a trace replay — exactly the
off-the-compute-path overhead Demand Layering and SmartMem warn caps
sustained throughput. The columnar mode stores every response field in
chunked numpy arrays (~130 B/row vs several hundred bytes per dataclass
+ boxed fields), interns model names through a small vocab, and encodes
status as an int8 code, which is what carries the replay to 10^6
requests under the trace-scale memory budget.

Design points:

  * **Chunked appender** — appends write into preallocated fixed-size
    column chunks (no per-append array growth); ``column(name)``
    concatenates lazily and caches until the next append.
  * **Lazy object views** — ``table[i]`` returns a lightweight
    ``ResponseView`` with the same attribute surface as ``Response``
    (including ``finish_s``/``deadline_met``), and ``to_responses()``
    materializes real ``Response`` objects for callers that need them.
    ``result`` tensors are NOT carried in columnar mode (always None) —
    callers that need outputs use the default object mode.
  * **Encoding** — ``req_id`` None ↔ -1 (caller req_ids must be >= 0),
    ``deadline_s`` None ↔ NaN (±inf deadlines are preserved as-is),
    ``status`` interned via ``STATUS_CODES``. All float columns are
    float64, so a ``Response`` round-trips bit-for-bit through
    ``to_responses()`` (minus ``result``).
  * **Reducer columns** — ``reducer_columns()`` hands the shared metric
    kernels in ``serving/types.py`` the raw arrays; the object path
    extracts identical arrays from ``Response`` lists, so object and
    columnar reducer outputs agree bit-for-bit by construction.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.serving.types import Response

STATUS_CODES: Dict[str, int] = {"ok": 0, "rejected": 1, "failed": 2}
STATUS_NAMES: tuple = ("ok", "rejected", "failed")

# column name -> dtype; one entry per Response field except `result`
# (tensors are dropped in columnar mode) and `model`/`status` (interned)
_COLUMNS = (
    ("req_id", np.int64),        # -1 encodes None
    ("model_id", np.int32),      # index into the table's vocab
    ("status", np.int8),         # STATUS_CODES
    ("batch_size", np.int32),
    ("arrival_s", np.float64),
    ("queue_s", np.float64),
    ("latency_s", np.float64),   # finish_s = arrival_s + latency_s, derived
    ("deadline_s", np.float64),  # NaN encodes None; ±inf preserved
    ("priority", np.float64),
    ("predicted_s", np.float64),
    ("charged_s", np.float64),
    ("kv_bytes", np.int64),
    ("init_s", np.float64),
    ("exec_s", np.float64),
    ("peak_bytes", np.int64),
    ("avg_bytes", np.float64),
    ("cache_hits", np.int64),
    ("cache_misses", np.int64),
    ("cache_hit_rate", np.float64),
)
_COLUMN_NAMES = tuple(n for n, _ in _COLUMNS)


class ResponseView:
    """Zero-copy row view over one table index with the ``Response``
    attribute surface (``result`` is always None in columnar mode)."""

    __slots__ = ("_t", "_i")

    def __init__(self, table: "ResponseTable", i: int):
        self._t = table
        self._i = i

    @property
    def model(self) -> str:
        return self._t.vocab[self._t.column("model_id")[self._i]]

    @property
    def status(self) -> str:
        return STATUS_NAMES[self._t.column("status")[self._i]]

    @property
    def req_id(self) -> Optional[int]:
        rid = int(self._t.column("req_id")[self._i])
        return None if rid < 0 else rid

    @property
    def deadline_s(self) -> Optional[float]:
        d = float(self._t.column("deadline_s")[self._i])
        return None if math.isnan(d) else d

    @property
    def result(self):
        return None

    @property
    def finish_s(self) -> float:
        return self.arrival_s + self.latency_s

    @property
    def deadline_met(self) -> Optional[bool]:
        d = self.deadline_s
        if d is None or not math.isfinite(d) or self.status != "ok":
            return None
        return self.finish_s <= d + 1e-9

    def to_response(self) -> Response:
        t, i = self._t, self._i
        return Response(
            self.model, self.latency_s, self.init_s, self.exec_s,
            self.peak_bytes, avg_bytes=self.avg_bytes,
            cache_hits=self.cache_hits, cache_misses=self.cache_misses,
            cache_hit_rate=self.cache_hit_rate, result=None,
            arrival_s=self.arrival_s, queue_s=self.queue_s,
            batch_size=self.batch_size, status=self.status,
            deadline_s=self.deadline_s, priority=self.priority,
            req_id=self.req_id, kv_bytes=int(t.column("kv_bytes")[i]),
            predicted_s=self.predicted_s, charged_s=self.charged_s)

    def __repr__(self) -> str:
        return (f"ResponseView({self.model!r}, status={self.status!r}, "
                f"arrival_s={self.arrival_s}, latency_s={self.latency_s}, "
                f"req_id={self.req_id})")


def _mk_scalar_property(name, py):
    def get(self):
        return py(self._t.column(name)[self._i])
    return property(get)


for _name, _dtype in _COLUMNS:
    if _name in ("model_id", "status", "req_id", "deadline_s"):
        continue
    _py = int if np.issubdtype(_dtype, np.integer) else float
    setattr(ResponseView, _name, _mk_scalar_property(_name, _py))
del _name, _dtype, _py


class ResponseTable:
    """Struct-of-arrays response store with a chunked appender.

    ``append(model, **fields)`` takes the same keyword fields as the
    ``Response`` constructor (minus ``result``); ``column(name)`` returns
    the concatenated column as one numpy array (cached until the next
    append); ``table[i]`` / iteration yield ``ResponseView`` rows;
    ``to_responses()`` materializes the object API.
    """

    def __init__(self, chunk_rows: int = 4096):
        self._chunk_rows = int(chunk_rows)
        self._full: Dict[str, List[np.ndarray]] = {n: [] for n in
                                                   _COLUMN_NAMES}
        self._cur: Dict[str, np.ndarray] = {}
        self._fill = 0
        self._n = 0
        self.vocab: List[str] = []
        self._vocab_ids: Dict[str, int] = {}
        self._cache: Dict[str, np.ndarray] = {}
        self._cache_n = -1

    # -- building ----------------------------------------------------------
    def model_id(self, model: str) -> int:
        """Intern ``model`` into the vocab and return its id."""
        mid = self._vocab_ids.get(model)
        if mid is None:
            mid = self._vocab_ids[model] = len(self.vocab)
            self.vocab.append(model)
        return mid

    def _new_chunk(self):
        if self._cur:
            for name in _COLUMN_NAMES:
                self._full[name].append(self._cur[name])
        self._cur = {name: np.empty(self._chunk_rows, dtype=dt)
                     for name, dt in _COLUMNS}
        self._fill = 0

    def append(self, model: str, *, latency_s: float, init_s: float = 0.0,
               exec_s: float = 0.0, peak_bytes: int = 0,
               avg_bytes: float = 0.0, cache_hits: int = 0,
               cache_misses: int = 0, cache_hit_rate: float = 0.0,
               arrival_s: float = 0.0, queue_s: float = 0.0,
               batch_size: int = 1, status: str = "ok",
               deadline_s: Optional[float] = None, priority: float = 1.0,
               req_id: Optional[int] = None, kv_bytes: int = 0,
               predicted_s: float = 0.0, charged_s: float = 0.0):
        """Append one row; keyword surface mirrors ``Response``."""
        if not self._cur or self._fill >= self._chunk_rows:
            self._new_chunk()
        cur, i = self._cur, self._fill
        cur["model_id"][i] = self.model_id(model)
        cur["status"][i] = STATUS_CODES[status]
        cur["req_id"][i] = -1 if req_id is None else req_id
        cur["deadline_s"][i] = (np.nan if deadline_s is None
                                else deadline_s)
        cur["latency_s"][i] = latency_s
        cur["init_s"][i] = init_s
        cur["exec_s"][i] = exec_s
        cur["peak_bytes"][i] = peak_bytes
        cur["avg_bytes"][i] = avg_bytes
        cur["cache_hits"][i] = cache_hits
        cur["cache_misses"][i] = cache_misses
        cur["cache_hit_rate"][i] = cache_hit_rate
        cur["arrival_s"][i] = arrival_s
        cur["queue_s"][i] = queue_s
        cur["batch_size"][i] = batch_size
        cur["priority"][i] = priority
        cur["kv_bytes"][i] = kv_bytes
        cur["predicted_s"][i] = predicted_s
        cur["charged_s"][i] = charged_s
        self._fill = i + 1
        self._n += 1

    def append_response(self, r: Response):
        self.append(r.model, latency_s=r.latency_s, init_s=r.init_s,
                    exec_s=r.exec_s, peak_bytes=r.peak_bytes,
                    avg_bytes=r.avg_bytes, cache_hits=r.cache_hits,
                    cache_misses=r.cache_misses,
                    cache_hit_rate=r.cache_hit_rate,
                    arrival_s=r.arrival_s, queue_s=r.queue_s,
                    batch_size=r.batch_size, status=r.status,
                    deadline_s=r.deadline_s, priority=r.priority,
                    req_id=r.req_id, kv_bytes=r.kv_bytes,
                    predicted_s=r.predicted_s, charged_s=r.charged_s)

    @classmethod
    def from_responses(cls, responses: Iterable[Response],
                       chunk_rows: int = 4096) -> "ResponseTable":
        t = cls(chunk_rows=chunk_rows)
        for r in responses:
            t.append_response(r)
        return t

    # -- access ------------------------------------------------------------
    def __len__(self) -> int:
        return self._n

    def __bool__(self) -> bool:
        return self._n > 0

    def column(self, name: str) -> np.ndarray:
        """The full column as one array (cached until the next append)."""
        if self._cache_n != self._n:
            self._cache.clear()
            self._cache_n = self._n
        col = self._cache.get(name)
        if col is None:
            parts = list(self._full[name])
            if self._cur:
                parts.append(self._cur[name][:self._fill])
            col = (np.concatenate(parts) if parts
                   else np.empty(0, dtype=dict(_COLUMNS)[name]))
            self._cache[name] = col
        return col

    def __getitem__(self, i: int) -> ResponseView:
        if not isinstance(i, (int, np.integer)):
            raise TypeError("ResponseTable indices must be integers "
                            f"(got {type(i).__name__}); use take() for "
                            "fancy indexing")
        n = self._n
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(f"row {i} out of range for {n}-row table")
        return ResponseView(self, int(i))

    def __iter__(self) -> Iterator[ResponseView]:
        return (ResponseView(self, i) for i in range(self._n))

    def to_responses(self) -> List[Response]:
        """Materialize the object API (``result`` is always None)."""
        return [ResponseView(self, i).to_response()
                for i in range(self._n)]

    def take(self, indices: Sequence[int]) -> "ResponseTable":
        """New table with rows reordered/selected by ``indices`` (shares
        nothing with self; vocab rebuilt in first-seen order)."""
        idx = np.asarray(list(indices), dtype=np.int64)
        out = ResponseTable(chunk_rows=max(self._chunk_rows, 1))
        if idx.size == 0:
            return out
        mids = self.column("model_id")[idx]
        # remap model ids through the new table's vocab (first-seen order)
        remap = np.empty(len(self.vocab) or 1, dtype=np.int32)
        for old_id in np.unique(mids):
            remap[old_id] = out.model_id(self.vocab[old_id])
        chunk = {name: self.column(name)[idx] for name in _COLUMN_NAMES}
        chunk["model_id"] = remap[mids].astype(np.int32)
        out._full = {name: [chunk[name]] for name in _COLUMN_NAMES}
        out._cur = {}
        out._fill = 0
        out._n = int(idx.size)
        return out

    def extend(self, other: "ResponseTable"):
        """Append every row of ``other`` (vocab remapped)."""
        n = len(other)
        if n == 0:
            return
        mids = other.column("model_id")
        remap = {int(o): self.model_id(other.vocab[int(o)])
                 for o in np.unique(mids)}
        for i in range(n):
            if not self._cur or self._fill >= self._chunk_rows:
                self._new_chunk()
            cur, j = self._cur, self._fill
            for name in _COLUMN_NAMES:
                if name == "model_id":
                    cur[name][j] = remap[int(mids[i])]
                else:
                    cur[name][j] = other.column(name)[i]
            self._fill = j + 1
            self._n += 1

    # -- reducer plumbing --------------------------------------------------
    def reducer_columns(self) -> dict:
        """Raw arrays for the shared metric kernels in serving/types.py.
        The object path builds the SAME dict from Response lists, so both
        modes run one kernel and agree bit-for-bit."""
        return {
            "status": self.column("status"),
            "arrival_s": self.column("arrival_s"),
            "latency_s": self.column("latency_s"),
            "deadline_s": self.column("deadline_s"),
            "priority": self.column("priority"),
            "predicted_s": self.column("predicted_s"),
            "charged_s": self.column("charged_s"),
            "req_id": self.column("req_id"),
            "model_id": self.column("model_id"),
            "vocab": list(self.vocab),
        }

    def __repr__(self) -> str:
        return (f"ResponseTable(rows={self._n}, "
                f"models={len(self.vocab)})")
