"""``ServeConfig``: one frozen dataclass for every serve-loop knob.

``ServingEngine.serve`` had accreted 17 keyword arguments; launch CLIs
and the fleet tier hand-mirrored their names, defaults, and help text.
``ServeConfig`` is the single source of truth:

    eng.serve(stream, config=ServeConfig(scheduler="slo",
                                         slo=SLOConfig(...),
                                         result_mode="columnar"))

Legacy loose kwargs are still accepted and merged (an explicit kwarg
wins over the config field, with a ``DeprecationWarning``):

    eng.serve(stream, scheduler="slo", slo=SLOConfig(...))   # deprecated

``clock`` stays a direct argument to ``serve()``/``serve_session()`` —
it is a live resource bound to one call, not serialized policy.

Validation happens once in ``__post_init__`` (scheduler/step_mode/
result_mode enums, positive intervals, replan knob coherence), so a bad
knob fails at construction instead of deep inside the loop.

CLI derivation: fields carrying ``cli`` metadata feed
``add_serve_config_flags`` (argparse flags with the field's default,
choices, and help — one source of truth for launch/serve.py) and
``serve_config_from_args`` maps parsed args back to a config.
``LEGACY_SERVE_KWARGS`` is the frozen list of original loose kwarg
names; ``tools/lint_serve_config.py`` asserts it stays in sync with the
dataclass fields.
"""
from __future__ import annotations

import argparse
import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.latency_model import BatchLatencyEstimator
from repro_torch.serving.batcher import BatcherConfig
from repro_torch.serving.types import SLOConfig

SCHEDULERS = ("fifo", "arrival", "static", "slo")   # "arrival" = fifo alias
STEP_MODES = ("event", "poll")
RESULT_MODES = ("object", "columnar")

# the 16 loose serve()/serve_session() kwargs of the original surface
# (clock excluded: it never moved into the config). Frozen by the lint
# check: ServeConfig fields == LEGACY_SERVE_KWARGS + {"result_mode"}.
LEGACY_SERVE_KWARGS = (
    "batcher", "scheduler", "poll_interval_s", "step_mode",
    "speculative_lookahead_ops", "slo", "admission", "preempt",
    "batch_cap", "cost_model", "replan", "replan_drift",
    "replan_min_observed", "mix_halflife_s", "replan_background",
    "replan_feasibility",
)


def _cli(flag: str, kind: str, help: str, choices=None) -> dict:
    meta = {"cli": flag, "cli_kind": kind, "help": help}
    if choices is not None:
        meta["choices"] = choices
    return meta


@dataclass(frozen=True)
class ServeConfig:
    """Every serve-loop knob in one validated, immutable object. Field
    semantics are documented on ``ServingEngine.serve``; defaults here
    ARE the serve() defaults."""

    batcher: Optional[BatcherConfig] = None
    scheduler: str = field(default="arrival", metadata=_cli(
        "--scheduler", "choice",
        "online: run/prefetch picking (fifo = arrival-order; slo = "
        "earliest-feasible-deadline with preemption + admission control)",
        choices=SCHEDULERS))
    poll_interval_s: float = 0.001
    step_mode: str = field(default="event", metadata=_cli(
        "--step-mode", "choice",
        "idle-gap stepping: event = one step per gap (default); poll = "
        "legacy fixed-interval stepping for open streams",
        choices=STEP_MODES))
    speculative_lookahead_ops: int = 8
    slo: Optional[SLOConfig] = None
    admission: Optional[bool] = field(default=None, metadata=_cli(
        "--admission", "tristate",
        "admission control: reject requests whose deadline is infeasible "
        "at current depth (auto = on under --scheduler slo)"))
    preempt: Optional[bool] = field(default=None, metadata=_cli(
        "--preempt", "tristate",
        "let a running batch yield at an op boundary to a strictly "
        "earlier deadline (auto = on under --scheduler slo)"))
    batch_cap: Optional[bool] = field(default=None, metadata=_cli(
        "--batch-cap", "tristate",
        "deadline-aware batch feasibility cap — a group stops admitting "
        "members once the grown batch's exec estimate would blow the "
        "tightest admitted deadline (auto = on under --scheduler slo)"))
    cost_model: Optional[BatchLatencyEstimator] = None
    replan: bool = field(default=False, metadata=_cli(
        "--replan", "flag",
        "track the observed mix (EWMA arrival rates) and re-plan the "
        "joint split in the background when it drifts; the new plan "
        "swaps in at a batch boundary, reusing pool-resident bytes"))
    replan_drift: float = field(default=0.3, metadata=_cli(
        "--replan-drift", "float",
        "total-variation drift threshold that triggers an online "
        "re-plan (with --replan)"))
    replan_min_observed: int = field(default=8, metadata=_cli(
        "--replan-min-observed", "int",
        "arrivals observed before mix drift may trigger a re-plan"))
    mix_halflife_s: float = 0.5
    replan_background: bool = True
    replan_feasibility: bool = True
    result_mode: str = field(default="object", metadata=_cli(
        "--result-mode", "choice",
        "response storage: object = one Response dataclass per request; "
        "columnar = struct-of-arrays ResponseTable (no result tensors; "
        "the 10^6-request trace-replay mode)",
        choices=RESULT_MODES))

    def __post_init__(self):
        if self.scheduler not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {self.scheduler!r}; "
                             f"expected one of {SCHEDULERS}")
        if self.step_mode not in STEP_MODES:
            raise ValueError(f"unknown step_mode {self.step_mode!r}; "
                             f"expected one of {STEP_MODES}")
        if self.result_mode not in RESULT_MODES:
            raise ValueError(f"unknown result_mode {self.result_mode!r}; "
                             f"expected one of {RESULT_MODES}")
        if not self.poll_interval_s > 0:
            raise ValueError("poll_interval_s must be > 0, "
                             f"got {self.poll_interval_s}")
        if self.speculative_lookahead_ops < 0:
            raise ValueError("speculative_lookahead_ops must be >= 0, "
                             f"got {self.speculative_lookahead_ops}")
        # replan knob coherence — validated even when replan is off, so a
        # config built once and toggled later is still sound
        if not self.replan_drift > 0:
            raise ValueError("replan_drift must be > 0, "
                             f"got {self.replan_drift}")
        if self.replan_min_observed < 1:
            raise ValueError("replan_min_observed must be >= 1, "
                             f"got {self.replan_min_observed}")
        if not self.mix_halflife_s > 0:
            raise ValueError("mix_halflife_s must be > 0, "
                             f"got {self.mix_halflife_s}")


_FIELD_NAMES = tuple(f.name for f in dataclasses.fields(ServeConfig))


def resolve_serve_config(config: Optional[ServeConfig],
                         kwargs: dict, *,
                         stacklevel: int = 4) -> ServeConfig:
    """Merge the deprecated loose-kwarg surface into a ``ServeConfig``.

    ``config`` provides the base (``ServeConfig()`` defaults when None);
    any key in ``kwargs`` overrides the matching field (explicit kwarg
    wins). Unknown keys raise ``TypeError``; any loose kwarg use emits
    one ``DeprecationWarning``. Validation re-runs on the merged result.
    """
    unknown = sorted(set(kwargs) - set(_FIELD_NAMES))
    if unknown:
        raise TypeError("unknown serve() keyword argument(s) "
                        f"{unknown}; valid names: {sorted(_FIELD_NAMES)}")
    if kwargs:
        warnings.warn(
            "passing serve-loop keyword arguments "
            f"({sorted(kwargs)}) to serve()/serve_session() is "
            "deprecated; pass config=ServeConfig(...) instead",
            DeprecationWarning, stacklevel=stacklevel)
    base = config if config is not None else ServeConfig()
    return dataclasses.replace(base, **kwargs) if kwargs else base


# -- CLI derivation (launch/serve.py) ---------------------------------------

_TRISTATE = {"auto": None, "on": True, "off": False}


def cli_fields():
    """The ServeConfig fields that carry CLI metadata, in field order."""
    return [f for f in dataclasses.fields(ServeConfig)
            if "cli" in f.metadata]


def add_serve_config_flags(ap: argparse.ArgumentParser):
    """Register one argparse flag per CLI-exposed ServeConfig field —
    names, defaults, choices, and help all derive from the dataclass
    (``dest`` is the field name, so existing ``args.scheduler``-style
    reads keep working)."""
    for f in cli_fields():
        meta = f.metadata
        flag, kind = meta["cli"], meta["cli_kind"]
        if kind == "choice":
            ap.add_argument(flag, dest=f.name, choices=meta["choices"],
                            default=f.default, help=meta["help"])
        elif kind == "tristate":
            ap.add_argument(flag, dest=f.name,
                            choices=tuple(_TRISTATE), default="auto",
                            help=meta["help"])
        elif kind == "flag":
            ap.add_argument(flag, dest=f.name, action="store_true",
                            default=f.default, help=meta["help"])
        elif kind == "float":
            ap.add_argument(flag, dest=f.name, type=float,
                            default=f.default, help=meta["help"])
        elif kind == "int":
            ap.add_argument(flag, dest=f.name, type=int,
                            default=f.default, help=meta["help"])
        else:  # pragma: no cover - new kinds must be added explicitly
            raise ValueError(f"unknown cli_kind {kind!r} on {f.name}")
    return ap


def serve_config_from_args(args: argparse.Namespace,
                           **overrides) -> ServeConfig:
    """Build a ``ServeConfig`` from parsed CLI args (the flags
    ``add_serve_config_flags`` registered) plus programmatic overrides
    for the non-CLI fields (batcher=, slo=, cost_model=, ...)."""
    kw = {}
    for f in cli_fields():
        val = getattr(args, f.name)
        if f.metadata["cli_kind"] == "tristate":
            val = _TRISTATE[val]
        kw[f.name] = val
    kw.update(overrides)
    return ServeConfig(**kw)
