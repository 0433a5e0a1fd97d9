"""Deterministic traffic splitter for the serving hot path (the port's own
copy of ``predictionio_tpu/rollout/splitter.py``).

Routing is by **hash-of-entity cohort**, not per-request randomness: the
same user lands on the same arm for the whole rollout, and the cohort is
monotone under ramping (the entities routed to the candidate at fraction
f1 are a subset of those at f2 > f1), so a ramp step only adds cohort.
The bucket is the JAX package's (sha256), so both packages split one
population alike. The hot-path cost is one sha256 of a short string a
query.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Optional, Sequence

ARM_STABLE = "stable"
ARM_CANDIDATE = "candidate"

#: Query fields tried (in order) as the cohort entity key: user-keyed
#: recommendation, e-commerce and sequential queries, item-keyed
#: similar-product ones.
DEFAULT_COHORT_FIELDS: Sequence[str] = (
    "user", "userId", "entityId", "entity_id", "uid", "item", "items")


def cohort_bucket(key: str) -> float:
    """Map a cohort key to a uniform bucket in [0, 1), stable across
    processes and Python versions (sha256, not ``hash()``)."""
    digest = hashlib.sha256(key.encode("utf-8", "surrogatepass")).digest()
    return int.from_bytes(digest[:8], "big") / 2.0 ** 64


class TrafficSplitter:
    """Routes queries between the stable and candidate arms.

    ``fraction`` is the share of cohort space routed to the candidate
    (0.0 none, 1.0 all). ``shadow=True``: the fraction selects queries to
    *mirror*, and the stable arm still answers all of them.
    """

    def __init__(self, fraction: float = 0.0, shadow: bool = False,
                 cohort_fields: Sequence[str] = DEFAULT_COHORT_FIELDS):
        self.fraction = float(fraction)
        self.shadow = bool(shadow)
        self.cohort_fields = tuple(cohort_fields)

    def set_fraction(self, fraction: float) -> None:
        self.fraction = min(max(float(fraction), 0.0), 1.0)

    def cohort_key(self, query_json: Any) -> str:
        """The entity this query is bucketed by; an entity-less query
        falls back to the whole (canonicalized) query, so the split stays
        deterministic."""
        if isinstance(query_json, dict):
            for name in self.cohort_fields:
                v = query_json.get(name)
                if v is not None and not isinstance(v, (dict, list)):
                    return f"{name}={v}"
        try:
            return json.dumps(query_json, sort_keys=True, default=str)
        except (TypeError, ValueError):
            return str(query_json)

    def routes_candidate(self, query_json: Any) -> bool:
        """True when this query's cohort falls inside the candidate
        fraction (monotone in ``fraction``)."""
        f = self.fraction
        if f <= 0.0:
            return False
        if f >= 1.0:
            return True
        return cohort_bucket(self.cohort_key(query_json)) < f

    def route(self, query_json: Any) -> str:
        """``"candidate"`` or ``"stable"`` for a canary split (shadow
        callers pick mirrors with :meth:`routes_candidate`; the stable
        arm answers regardless)."""
        return (ARM_CANDIDATE if not self.shadow
                and self.routes_candidate(query_json) else ARM_STABLE)

    def describe(self) -> dict:
        """The split as ``{"fraction", "shadow"}``."""
        return {"fraction": self.fraction, "shadow": self.shadow}


def parse_fraction(value: Any, default: Optional[float] = None) -> float:
    """A traffic fraction from user input (CLI, HTTP): 0.05, "0.05" or
    "5%"; must lie in (0, 1]."""
    if value is None:
        if default is None:
            raise ValueError("fraction required")
        return default
    s = str(value).strip()
    if s.endswith("%"):
        f = float(s[:-1]) / 100.0
    else:
        f = float(s)
    if not 0.0 < f <= 1.0:
        raise ValueError(f"fraction must be in (0, 1], got {value!r}")
    return f
