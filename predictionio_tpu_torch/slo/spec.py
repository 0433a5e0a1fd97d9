"""Declarative service-level objectives (the port's own copy of
``predictionio_tpu/slo/spec.py``).

An :class:`SLOSpec` states a promise in the operator's terms ("99.9% of
``/queries.json`` requests succeed", "99% of queries finish within 150
ms", "95% of fold-ins are servable within 5 s of ingest") and names the
telemetry it is checked against. The spec is pure data: the
:mod:`.engine` turns it into multi-window burn rates against a live
:class:`~predictionio_tpu_torch.obs.MetricsRegistry`, and the :mod:`.gate`
turns the ``capacity`` section of a spec file into a merge gate over a
capacity model (``CAPACITY.json``).

Every objective reduces to the same error-budget arithmetic: a *target*
fraction of good events, so the budget is ``1 - target`` and the burn
rate is ``(bad events / total events) / budget`` over a window. What
counts as "bad" is the only per-objective part:

- ``availability``: a 5xx-status request (counted off a labeled request
  counter such as ``pio_http_requests_total``);
- ``latency``: a request slower than ``threshold_ms`` (counted off a
  latency histogram's cumulative buckets, interpolated inside the bucket
  the threshold lands in);
- ``freshness``: an event-to-servable sample slower than
  ``threshold_ms`` (the same bucket arithmetic over
  ``pio_stream_freshness_seconds``).
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Tuple

OBJECTIVES = ("availability", "latency", "freshness")

#: default metric family per objective; a spec's ``scope`` labels can
#: re-route latency to the per-route or per-release-arm series
_DEFAULT_METRICS = {
    "availability": "pio_http_requests_total",
    "freshness": "pio_stream_freshness_seconds",
}


@dataclass
class SLOSpec:
    """One service objective: what is promised, over which telemetry,
    at which burn-alert windows.

    The window pair follows the multi-window burn-rate alerting
    pattern (Google SRE workbook): a breach requires the *fast* window
    burning at ``burn_fast``× budget AND the *slow* window at
    ``burn_slow``× — the fast window proves the problem is happening
    now, the slow window proves it is big enough to matter, and the
    pair together is robust to both blips and slow bleeds.
    """

    name: str
    objective: str
    #: fraction of events that must be good (0.999 → 0.1% error budget)
    target: float = 0.999
    #: latency/freshness: a sample above this is a budget-burning event
    threshold_ms: Optional[float] = None
    #: metric family to evaluate against; None resolves per objective
    metric: Optional[str] = None
    #: label filters — only children carrying ALL of these label values
    #: are aggregated (``{"route": "/queries.json"}`` scopes the spec
    #: to one route; ``{"arm": "candidate"}`` to one release arm)
    scope: Dict[str, str] = field(default_factory=dict)
    window_fast_sec: float = 300.0
    window_slow_sec: float = 3600.0
    #: burn-rate alert thresholds (× budget) per window
    burn_fast: float = 14.4
    burn_slow: float = 6.0
    #: the compliance period the error budget is accounted over
    budget_window_sec: float = 86_400.0
    description: str = ""

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("SLOSpec needs a name")
        if self.objective not in OBJECTIVES:
            raise ValueError(
                f"objective must be one of {OBJECTIVES}, got "
                f"{self.objective!r}")
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"target must be in (0, 1), got {self.target}")
        if self.objective in ("latency", "freshness"):
            if self.threshold_ms is None or self.threshold_ms <= 0:
                raise ValueError(
                    f"{self.objective} SLO {self.name!r} needs a "
                    f"positive threshold_ms")
        if self.window_fast_sec <= 0 or self.window_slow_sec <= 0:
            raise ValueError("windows must be positive")
        if self.window_fast_sec > self.window_slow_sec:
            raise ValueError(
                f"window_fast_sec ({self.window_fast_sec}) must not "
                f"exceed window_slow_sec ({self.window_slow_sec})")
        if self.budget_window_sec < self.window_slow_sec:
            raise ValueError(
                "budget_window_sec must cover the slow window")
        self.scope = {str(k): str(v) for k, v in self.scope.items()}

    @property
    def budget(self) -> float:
        """Error budget: the allowed bad-event fraction."""
        return 1.0 - self.target

    def resolved_metric(self) -> str:
        """The metric family this spec reads (explicit ``metric`` wins;
        otherwise by objective, with latency picking the per-arm or
        per-route series when the scope names one)."""
        if self.metric:
            return self.metric
        if self.objective == "latency":
            if "arm" in self.scope:
                return "pio_release_latency_seconds"
            if "route" in self.scope:
                return "pio_http_request_duration_seconds"
            return "pio_query_latency_seconds"
        return _DEFAULT_METRICS[self.objective]

    def to_json(self) -> Dict[str, Any]:
        d = asdict(self)
        return {k: v for k, v in d.items()
                if v not in (None, "", {}) or k in ("name", "objective")}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "SLOSpec":
        unknown = set(d) - set(cls.__dataclass_fields__)
        if unknown:
            raise ValueError(
                f"unknown SLOSpec field(s) {sorted(unknown)} in "
                f"{d.get('name', '?')!r}")
        return cls(**d)


def default_specs(streaming: bool = False) -> List[SLOSpec]:
    """The out-of-the-box objectives a deployed engine server watches
    when no spec file is given: request availability and end-to-end
    query latency on ``/queries.json``, plus event→servable freshness
    while the streaming trainer is attached. Deliberately loose — they
    exist so every deployment has burn-rate telemetry from minute one;
    a real deployment commits its own file (``slo/specs/``)."""
    specs = [
        SLOSpec(
            name="queries-availability",
            objective="availability",
            target=0.999,
            scope={"route": "/queries.json"},
            description="99.9% of /queries.json requests answer "
                        "without a 5xx"),
        SLOSpec(
            name="queries-p99-latency",
            objective="latency",
            target=0.99,
            threshold_ms=500.0,
            scope={"route": "/queries.json"},
            description="99% of /queries.json requests finish within "
                        "500 ms"),
    ]
    if streaming:
        specs.append(SLOSpec(
            name="stream-freshness",
            objective="freshness",
            target=0.95,
            threshold_ms=5_000.0,
            description="95% of fold-ins are servable within 5 s of "
                        "ingest"))
    return specs


def load_specs(path: str) -> Tuple[List[SLOSpec], Dict[str, Any]]:
    """Parse a committed spec file (``slo/specs/*.json``)::

        {"specs": [{"name": ..., "objective": ..., ...}, ...],
         "capacity": {"<config>": {"min_knee_qps": ...,
                                   "max_p99_at_80pct_knee_ms": ...,
                                   "max_freshness_under_load_ms": ...},
                      ...}}

    Returns ``(specs, capacity_gates)``. The ``capacity`` section is
    the committed side of the capacity gate
    (:func:`~predictionio_tpu_torch.slo.gate.gate_capacity`)."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    raw = doc.get("specs")
    if not isinstance(raw, list) or not raw:
        raise ValueError(f"{path}: no 'specs' list")
    specs = [SLOSpec.from_json(d) for d in raw]
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise ValueError(f"{path}: duplicate spec names")
    gates = doc.get("capacity") or {}
    if not isinstance(gates, dict):
        raise ValueError(f"{path}: 'capacity' must be an object")
    return specs, gates
