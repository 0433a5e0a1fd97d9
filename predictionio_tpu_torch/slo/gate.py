"""The capacity gate: committed SLOs against a fresh ``CAPACITY.json``
(the port's own copy of ``predictionio_tpu/slo/gate.py``).

A load harness emits a machine-readable capacity model per serving
config: knee qps, p99 at 80% of the knee, freshness under load, device
idle fraction. The committed side lives in the ``capacity`` section of
a spec file (``slo/specs/ci.json``); this module diffs the two with
**ratchet semantics**: a regression fails naming the spec, the
measurement window and the measured value; the committed floors and
ceilings only ever tighten, and only through an explicit ``slo check
--update`` commit.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

#: gate key → (capacity-model key, direction). ``min``: measured must
#: be >= committed (throughput floors); ``max``: measured must be <=
#: committed (latency/staleness ceilings).
GATE_KEYS = {
    "min_knee_qps": ("knee_qps", "min"),
    "max_p99_at_80pct_knee_ms": ("p99_at_80pct_knee_ms", "max"),
    "max_freshness_under_load_ms": ("freshness_under_load_ms", "max"),
    "max_device_idle_fraction": ("device_idle_fraction", "max"),
}

#: how much better a fresh measurement must be before --update
#: tightens the committed value toward it (the slack absorbs run-to-run
#: noise so the ratchet follows real wins, not lucky runs)
RATCHET_SLACK = 0.8


def _window_of(entry: Dict[str, Any], capacity: Dict[str, Any]) -> str:
    """The measurement window a gate failure names: per-rate step
    duration + the sweep shape, so "regressed" is attributable to a
    concrete measurement, not a vibe."""
    step = entry.get("step_sec") or capacity.get("step_sec")
    rates = entry.get("frontier") or []
    lo = rates[0].get("offered_qps") if rates else None
    hi = rates[-1].get("offered_qps") if rates else None
    parts = []
    if step is not None:
        parts.append(f"{step}s/rate open-loop sweep")
    if lo is not None and hi is not None:
        parts.append(f"{lo}-{hi} qps offered")
    return ", ".join(parts) or "load_harness sweep"


def gate_capacity(capacity: Dict[str, Any],
                  gates: Dict[str, Any]) -> List[str]:
    """Every committed gate checked against the fresh capacity model;
    returns human-readable failure lines (empty = gate passes)."""
    failures: List[str] = []
    configs = capacity.get("configs") or {}
    for cfg_name, gate in sorted(gates.items()):
        entry = configs.get(cfg_name)
        if entry is None:
            failures.append(
                f"capacity gate {cfg_name!r}: no measurement in "
                f"CAPACITY.json (configs measured: "
                f"{sorted(configs) or 'none'})")
            continue
        window = _window_of(entry, capacity)
        for gkey, committed in sorted(gate.items()):
            spec = GATE_KEYS.get(gkey)
            if spec is None:
                failures.append(
                    f"capacity gate {cfg_name!r}: unknown gate key "
                    f"{gkey!r} (known: {sorted(GATE_KEYS)})")
                continue
            mkey, direction = spec
            measured = entry.get(mkey)
            if measured is None:
                failures.append(
                    f"capacity gate {cfg_name!r}: {mkey} was not "
                    f"measured (window: {window}) but {gkey}="
                    f"{committed} is committed")
                continue
            ok = (measured >= committed if direction == "min"
                  else measured <= committed)
            if not ok:
                cmp = "<" if direction == "min" else ">"
                failures.append(
                    f"capacity gate {cfg_name!r}: {mkey} {measured} "
                    f"{cmp} committed {gkey} {committed} "
                    f"(window: {window})")
    return failures


def ratchet_gates(capacity: Dict[str, Any], gates: Dict[str, Any],
                  slack: float = RATCHET_SLACK
                  ) -> Tuple[Dict[str, Any], List[str]]:
    """Tighten the committed gates toward a fresh (passing) run:
    floors rise to ``slack × measured`` when that beats the committed
    floor, ceilings drop to ``measured / slack`` when that beats the
    committed ceiling. Never loosens — a regressed run leaves the
    committed value alone (and should have failed the gate anyway).
    Returns ``(new_gates, change lines)``."""
    configs = capacity.get("configs") or {}
    out: Dict[str, Any] = {}
    changes: List[str] = []
    for cfg_name, gate in gates.items():
        entry = configs.get(cfg_name) or {}
        new_gate = dict(gate)
        for gkey, committed in gate.items():
            spec = GATE_KEYS.get(gkey)
            if spec is None:
                continue
            mkey, direction = spec
            measured = entry.get(mkey)
            if measured is None:
                continue
            if direction == "min":
                candidate = round(measured * slack, 3)
                if candidate > committed:
                    new_gate[gkey] = candidate
            else:
                candidate = round(measured / slack, 3)
                if candidate < committed:
                    new_gate[gkey] = candidate
            if new_gate[gkey] != committed:
                changes.append(
                    f"{cfg_name}.{gkey}: {committed} -> "
                    f"{new_gate[gkey]} (measured {mkey}={measured})")
        out[cfg_name] = new_gate
    return out, changes


def write_gates(path: str, gates: Dict[str, Any]) -> None:
    """Rewrite only the ``capacity`` section of a committed spec file,
    preserving the specs untouched. Temp+fsync+rename: a crash
    mid-ratchet must leave the committed gates readable, not torn."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    doc["capacity"] = gates
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
