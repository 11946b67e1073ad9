"""Latency-under-load model (paper §4.2, Figs 2/4).

The paper trains an XGBoost regressor on profiled kernels to predict
execution latency under varying *additional* concurrent data loading, then
derives per-layer load capacities. XGBoost is not available offline, so
``GBTRegressor`` is a small histogram gradient-boosted-trees implementation
in numpy (squared loss, depth-limited greedy splits) — same role, same
feature set:

  [class onehot(3), log10 flops, log10 act_bytes, extra_ratio, log10 extra_bytes]

``profile_ops`` measures the real phenomenon on this machine: each op kernel
is timed while a background thread streams (memcpy) extra bytes — the CPU
analogue of texture-upload contention on the mobile GPU's shared memory bus.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

CLASSES = ("elemental", "reusable", "hierarchical")


# ---------------------------------------------------------------------------
# histogram GBT (xgboost stand-in)
# ---------------------------------------------------------------------------

@dataclass
class _Node:
    feature: int = -1
    thresh: float = 0.0
    left: int = -1
    right: int = -1
    value: float = 0.0


class GBTRegressor:
    def __init__(self, n_trees: int = 80, depth: int = 3, lr: float = 0.1,
                 n_bins: int = 32, min_leaf: int = 4):
        self.n_trees, self.depth, self.lr = n_trees, depth, lr
        self.n_bins, self.min_leaf = n_bins, min_leaf
        self.trees: List[List[_Node]] = []
        self.base = 0.0

    def _fit_tree(self, x, g):
        nodes = [_Node(value=float(np.mean(g)))]
        stack = [(0, np.arange(len(g)), 0)]
        while stack:
            idx, rows, d = stack.pop()
            if d >= self.depth or len(rows) < 2 * self.min_leaf:
                continue
            best = (0.0, None)
            gsum, cnt = g[rows].sum(), len(rows)
            for f in range(x.shape[1]):
                vals = x[rows, f]
                qs = np.quantile(vals, np.linspace(0.05, 0.95, self.n_bins))
                for t in np.unique(qs):
                    m = vals <= t
                    nl = int(m.sum())
                    if nl < self.min_leaf or cnt - nl < self.min_leaf:
                        continue
                    sl = g[rows[m]].sum()
                    sr = gsum - sl
                    gain = sl * sl / nl + sr * sr / (cnt - nl) - gsum * gsum / cnt
                    if gain > best[0]:
                        best = (gain, (f, t, m))
            if best[1] is None:
                continue
            f, t, m = best[1]
            li, ri = len(nodes), len(nodes) + 1
            nodes[idx].feature, nodes[idx].thresh = f, t
            nodes[idx].left, nodes[idx].right = li, ri
            nodes.append(_Node(value=float(np.mean(g[rows[m]]))))
            nodes.append(_Node(value=float(np.mean(g[rows[~m]]))))
            stack.append((li, rows[m], d + 1))
            stack.append((ri, rows[~m], d + 1))
        return nodes

    def _predict_tree(self, nodes, x):
        out = np.zeros(len(x))
        for i, row in enumerate(x):
            n = 0
            while nodes[n].left != -1:
                n = nodes[n].left if row[nodes[n].feature] <= nodes[n].thresh \
                    else nodes[n].right
            out[i] = nodes[n].value
        return out

    def fit(self, x: np.ndarray, y: np.ndarray) -> "GBTRegressor":
        x = np.asarray(x, float)
        y = np.asarray(y, float)
        self.base = float(np.mean(y))
        pred = np.full(len(y), self.base)
        self.trees = []
        for _ in range(self.n_trees):
            tree = self._fit_tree(x, y - pred)
            self.trees.append(tree)
            pred += self.lr * self._predict_tree(tree, x)
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        x = np.atleast_2d(np.asarray(x, float))
        out = np.full(len(x), self.base)
        for tree in self.trees:
            out += self.lr * self._predict_tree(tree, x)
        return out

    def r2(self, x, y) -> float:
        p = self.predict(x)
        y = np.asarray(y, float)
        ss = np.sum((y - y.mean()) ** 2)
        return 1.0 - np.sum((y - p) ** 2) / max(ss, 1e-12)


def features(op_class: str, flops: float, act_bytes: float,
             extra_bytes: float) -> np.ndarray:
    one = [1.0 if op_class == c else 0.0 for c in CLASSES]
    ratio = extra_bytes / max(act_bytes, 1.0)
    return np.array(one + [np.log10(max(flops, 1.0)),
                           np.log10(max(act_bytes, 1.0)),
                           ratio,
                           np.log10(max(extra_bytes, 1.0))])


# ---------------------------------------------------------------------------
# profiling harness — op latency under concurrent streaming
# ---------------------------------------------------------------------------

class _Streamer(threading.Thread):
    """Background memcpy of `total_bytes` in 1 MiB slabs."""

    def __init__(self, total_bytes: int):
        super().__init__(daemon=True)
        self.total = int(total_bytes)
        self.src = np.ones(1 << 20, np.uint8)
        self.dst = np.empty_like(self.src)
        self.done = threading.Event()

    def run(self):
        moved = 0
        while moved < self.total and not self.done.is_set():
            np.copyto(self.dst, self.src)
            moved += self.src.nbytes


def time_op(fn: Callable[[], None], extra_bytes: int = 0,
            reps: int = 3) -> float:
    """Median wall time of fn() while a streamer moves extra_bytes."""
    ts = []
    for _ in range(reps):
        streamer = _Streamer(extra_bytes) if extra_bytes else None
        if streamer:
            streamer.start()
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
        if streamer:
            streamer.done.set()
            streamer.join(timeout=5.0)
    return float(np.median(ts))


def profile_ops(op_suite: Dict[str, tuple], ratios=(0.0, 0.5, 1.0, 2.0, 4.0),
                reps: int = 3) -> dict:
    """op_suite: name -> (op_class, flops, act_bytes, fn). Returns rows of
    (features, latency_s) plus the per-op baseline latency."""
    xs, ys, meta = [], [], []
    for name, (op_class, flops, act_bytes, fn) in op_suite.items():
        fn()  # warmup / compile
        base = time_op(fn, 0, reps)
        for r in ratios:
            extra = int(r * act_bytes)
            t = time_op(fn, extra, reps) if extra else base
            xs.append(features(op_class, flops, act_bytes, extra))
            ys.append(t)
            meta.append({"op": name, "class": op_class, "ratio": r,
                         "latency_s": t, "slowdown": t / max(base, 1e-12)})
    return {"x": np.array(xs), "y": np.array(ys), "meta": meta}


def fit_latency_model(profile: dict, **gbt_kw) -> GBTRegressor:
    return GBTRegressor(**gbt_kw).fit(profile["x"], profile["y"])


# ---------------------------------------------------------------------------
# online per-batch cost estimator (SLO-aware serving)
# ---------------------------------------------------------------------------

class BatchLatencyEstimator:
    """Per-model batch-execution-time estimate for the serving scheduler.

    The SLO scheduler needs "how long will one batch of model m take?" to
    order work by earliest-feasible-deadline, decide admission, and project
    progress between preemption checkpoints. The estimate is an EWMA over
    the durations the serving clock actually charged (so under ``SimClock``
    with fixed per-model exec times the estimator converges to those exact
    values after one observation — scheduling tests stay bit-reproducible),
    seeded with ``priors`` / ``prior_s`` before the first observation.

    A padded batch executes as one fused pass; with the default
    ``growth=0.0`` the estimate is per-batch and independent of
    ``batch_size``. ``growth > 0`` models the fused
    pass getting slower as rows are added — ``estimate(m, b)`` scales the
    per-model base by ``1 + growth * (b - 1)`` and ``observe`` normalizes
    the charged duration by the same factor, so the base EWMA stays a
    size-1 quantity whatever mix of batch sizes was observed. This is the
    size-dependence the deadline-aware batch cap reasons about: "would
    admitting one more member blow the head's deadline?" is only a real
    question when estimate(b+1) > estimate(b).
    """

    def __init__(self, prior_s: float = 0.05, alpha: float = 0.5,
                 priors: Optional[Dict[str, float]] = None,
                 growth: float = 0.0):
        assert 0.0 < alpha <= 1.0, alpha
        assert growth >= 0.0, growth
        self.prior_s = float(prior_s)
        self.alpha = float(alpha)
        self.growth = float(growth)
        self._est: Dict[str, float] = {m: float(v)
                                       for m, v in (priors or {}).items()}
        self.observations: Dict[str, int] = {}

    def _factor(self, batch_size: int) -> float:
        b = int(batch_size)
        if b < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        return 1.0 + self.growth * (b - 1)

    def observe(self, model: str, dt_s: float, batch_size: int = 1):
        dt_s = float(dt_s) / self._factor(batch_size)
        if model in self._est and self.observations.get(model, 0) > 0:
            self._est[model] += self.alpha * (dt_s - self._est[model])
        else:
            self._est[model] = dt_s          # first real sample wins the prior
        self.observations[model] = self.observations.get(model, 0) + 1

    def estimate(self, model: str, batch_size: int = 1) -> float:
        return self._est.get(model, self.prior_s) * self._factor(batch_size)


# ---------------------------------------------------------------------------
# online RLS calibration — learned latency curves per model
# ---------------------------------------------------------------------------

#: feature vector layout for the per-model RLS fit (see OnlineLatencyModel):
#: [intercept, extra rows beyond 1, cold bytes to restream / COLD_SCALE,
#:  decode tokens / DECODE_SCALE]
N_FEATURES = 4
COLD_SCALE = float(1 << 30)     # bytes -> GiB keeps the normal matrix sane
DECODE_SCALE = 1024.0           # tokens -> ktokens, same reason


class OnlineLatencyModel(BatchLatencyEstimator):
    """Per-model regularized recursive-least-squares latency fit.

    The EWMA parent prices every batch with two hand-set knobs (the prior
    and ``growth``); this subclass *learns* the curve online from what the
    serving clock actually charged. Each executed batch contributes one
    sample ``features(batch_size, cold_bytes, decode_tokens) -> charged_s``
    and the fit is the exact ridge solution

        argmin_theta  sum_i (y_i - x_i . theta)^2 + lam * ||theta - theta0||^2

    computed recursively (standard RLS, no forgetting factor — so the fit
    is independent of sample order and matches the closed-form
    ``numpy.linalg.lstsq`` solution of the augmented system to fp
    precision). ``theta0`` warm-starts from the analytic prior at the
    first sample: base = the current per-model prior estimate, per-row
    slope = ``growth * base``, restream and decode slopes 0.

    Dormant-by-default contract: until ``min_samples`` observations land
    for a model, ``estimate()`` defers to the EWMA parent **bit-for-bit**
    (the RLS runs silently alongside). Pass ``min_samples=math.inf`` to
    keep the learned path permanently dormant — every schedule is then
    identical to ``BatchLatencyEstimator``. Once calibrated,
    ``estimate(m, b)`` prices a batch at the fitted curve evaluated at the
    model's running-mean cold/decode features (the scheduler call sites
    don't know them per-batch), and ``predict()`` exposes the full
    feature-resolved prediction for feasibility checks.

    Calibration quality is tracked prequentially: each sample is first
    predicted with the *current* state (EWMA or fit — whatever the
    scheduler would have used), then absorbed. ``calibration_report()``
    therefore measures real scheduling error, and its ``drift`` field (an
    EWMA of recent relative error) rises again if the machine moves away
    from the fit — the signal ``slo_report()`` surfaces.
    """

    def __init__(self, prior_s: float = 0.05, alpha: float = 0.5,
                 priors: Optional[Dict[str, float]] = None,
                 growth: float = 0.0, min_samples: float = 8,
                 ridge_lambda: float = 1e-3, drift_alpha: float = 0.25):
        super().__init__(prior_s, alpha, priors, growth)
        assert min_samples >= 1, min_samples
        assert ridge_lambda > 0.0, ridge_lambda
        assert 0.0 < drift_alpha <= 1.0, drift_alpha
        self.min_samples = min_samples
        self.ridge_lambda = float(ridge_lambda)
        self.drift_alpha = float(drift_alpha)
        self._theta: Dict[str, np.ndarray] = {}
        self._theta0: Dict[str, np.ndarray] = {}
        self._P: Dict[str, np.ndarray] = {}
        self._nsamp: Dict[str, int] = {}
        self._feat_sum: Dict[str, np.ndarray] = {}
        self._abs_err_sum: Dict[str, float] = {}
        self._rel_err_sum: Dict[str, float] = {}
        self._drift: Dict[str, float] = {}

    # -- features ----------------------------------------------------------

    @staticmethod
    def features_of(batch_size: int, cold_bytes: int = 0,
                    decode_tokens: int = 0) -> np.ndarray:
        b = int(batch_size)
        if b < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        return np.array([1.0, float(b - 1),
                         float(max(0, cold_bytes)) / COLD_SCALE,
                         float(max(0, decode_tokens)) / DECODE_SCALE])

    def _init_model(self, model: str):
        base = self._est.get(model, self.prior_s)
        self._theta0[model] = np.array([base, self.growth * base, 0.0, 0.0])
        self._theta[model] = self._theta0[model].copy()
        self._P[model] = np.eye(N_FEATURES) / self.ridge_lambda
        self._nsamp[model] = 0
        self._feat_sum[model] = np.zeros(N_FEATURES)
        self._abs_err_sum[model] = 0.0
        self._rel_err_sum[model] = 0.0

    # -- observation -------------------------------------------------------

    def observe_sample(self, model: str, charged_s: float,
                       batch_size: int = 1, cold_bytes: int = 0,
                       decode_tokens: int = 0):
        """Absorb one executed batch: RLS update + the parent EWMA (which
        stays the fallback until calibration). Prequential error is scored
        against whatever ``estimate`` would have priced this batch at."""
        x = self.features_of(batch_size, cold_bytes, decode_tokens)
        y = float(charged_s)
        if model not in self._theta:
            self._init_model(model)
        err = y - self.estimate(model, batch_size)
        self._abs_err_sum[model] += abs(err)
        rel = abs(err) / max(y, 1e-12)
        self._rel_err_sum[model] += rel
        self._drift[model] = (rel if model not in self._drift else
                              self._drift[model] + self.drift_alpha *
                              (rel - self._drift[model]))
        P = self._P[model]
        Px = P @ x
        k = Px / (1.0 + float(x @ Px))
        self._theta[model] = self._theta[model] + k * (y - float(
            x @ self._theta[model]))
        self._P[model] = P - np.outer(k, Px)
        self._nsamp[model] += 1
        self._feat_sum[model] = self._feat_sum[model] + x
        super().observe(model, charged_s, batch_size)

    # -- queries -----------------------------------------------------------

    def calibrated(self, model: str) -> bool:
        return self._nsamp.get(model, 0) >= self.min_samples

    def _mean_features(self, model: str) -> np.ndarray:
        n = max(1, self._nsamp.get(model, 0))
        return self._feat_sum[model] / n

    def predict(self, model: str, batch_size: int = 1, cold_bytes: int = 0,
                decode_tokens: int = 0) -> float:
        """Feature-resolved prediction; falls back to ``estimate`` (which
        ignores cold/decode) while uncalibrated."""
        if not self.calibrated(model):
            return self.estimate(model, batch_size)
        x = self.features_of(batch_size, cold_bytes, decode_tokens)
        return max(1e-9, float(x @ self._theta[model]))

    def estimate(self, model: str, batch_size: int = 1) -> float:
        if not self.calibrated(model):
            return super().estimate(model, batch_size)
        x = self.features_of(batch_size)
        mean = self._mean_features(model)
        x[2], x[3] = mean[2], mean[3]   # typical cold/decode load
        return max(1e-9, float(x @ self._theta[model]))

    def coefficients(self, model: str) -> Optional[Dict[str, float]]:
        """Fitted curve in engineering units, or None before any sample."""
        th = self._theta.get(model)
        if th is None:
            return None
        base = float(th[0])
        return {"base_s": base,
                "per_row_s": float(th[1]),
                "growth": float(th[1] / base) if abs(base) > 1e-12 else 0.0,
                "s_per_cold_byte": float(th[2]) / COLD_SCALE,
                "s_per_decode_token": float(th[3]) / DECODE_SCALE}

    def calibration_report(self) -> Dict[str, dict]:
        """Per-model fit quality for ``slo_report()``: sample count,
        whether the fitted curve is live, lifetime mean absolute /
        relative prequential error, and ``drift`` (EWMA of recent
        relative error — rises when the machine leaves the fit)."""
        out: Dict[str, dict] = {}
        for m, n in self._nsamp.items():
            coef = self.coefficients(m)
            out[m] = {
                "samples": int(n),
                "calibrated": self.calibrated(m),
                "mae_s": self._abs_err_sum[m] / max(1, n),
                "rel_err": self._rel_err_sum[m] / max(1, n),
                "drift": self._drift.get(m, 0.0),
                "coef": coef,
            }
        return out

    def calibration_scales(self, analytic_s: Dict[str, float],
                           clip: float = 16.0) -> Dict[str, float]:
        """Observed-over-analytic latency ratio per calibrated model — the
        fitted correction ``allocate_joint(calibration=...)`` applies to
        the analytic latency-per-byte curve. Models still dormant (or with
        a degenerate analytic estimate) are omitted, so the allocator
        prices them purely analytically."""
        out: Dict[str, float] = {}
        for m, lat in analytic_s.items():
            if not self.calibrated(m) or not lat or lat <= 0.0:
                continue
            scale = self.estimate(m, 1) / float(lat)
            out[m] = float(min(clip, max(1.0 / clip, scale)))
        return out
