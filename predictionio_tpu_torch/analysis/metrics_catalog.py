"""Metric-catalog drift gate: code ↔ docs/observability.md, both ways
(the port of ``predictionio_tpu/analysis/metrics_catalog.py``, against
the same, unchanged catalog).

- **code → docs**: every ``pio_*`` family registered through the
  :class:`~predictionio_tpu_torch.obs.registry.MetricsRegistry` API
  (``.counter("pio_…")`` / ``.gauge`` / ``.histogram`` with a literal
  name) must appear backticked in the catalog tables — an undocumented
  family is invisible to operators and to the SLO tooling that reads
  the catalog.
- **docs → code**: every backticked ``pio_*`` name in the catalog must
  occur somewhere in the scanned sources — a documented family nothing
  emits is a dashboard that silently flatlines. The families the port
  leaves out on purpose are excused by :data:`LEFT_OUT`, each with its
  ``ROADMAP.md`` decision, and only by it.

Dynamically-named registrations (f-strings, variables) are skipped on
the code side; the docs side only requires the name to *occur* in
source (string literal, format template, or export tuple), so custom
render paths like the lock-metrics exporter still count. The gate is
silent unless the scanned set registers at least one ``pio_*`` family
and the catalog file exists.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Sequence, Set, Tuple

from .core import CheckContext, Finding, ModuleInfo

#: resolved against the repo root holding this package; tests
#: monkeypatch it to a tmp catalog
CATALOG_PATH = os.path.join(
    os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
    "docs", "observability.md")

_REGISTRY_METHODS = {"counter", "gauge", "histogram"}
_NAME_RE = re.compile(r"\bpio_[a-z0-9_]+\b")
_DOC_NAME_RE = re.compile(r"`(pio_[a-z0-9_]+)")

#: ``pio_*`` literals that are event-store vocabulary, not metric
#: families (data/event.py reserved names)
_NON_METRIC = {"pio_pr", "pio_stream", "pio_traceparent", "pio_data",
               "pio_dashboard_session"}

#: documented families the port does not emit, each with its
#: ``ROADMAP.md`` decision (``tests/test_torch_telemetry.py`` holds the
#: port's ``/metrics`` to the JAX package's less these)
LEFT_OUT = {
    "pio_compiles_since_warm": "decided not to port: XLA sentinels",
    "pio_xla_compiles_total": "decided not to port: XLA sentinels",
    "pio_transfer_guard_violations_total":
        "decided not to port: XLA transfer guard",
    "pio_sharding_findings": "decided not to port: JAX program analysis",
}


def registered_families(mod: ModuleInfo
                        ) -> List[Tuple[str, int]]:
    """(family, line) for every literal-named registry registration in
    one module."""
    out: List[Tuple[str, int]] = []
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _REGISTRY_METHODS
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            continue
        name = node.args[0].value
        if name.startswith("pio_"):
            out.append((name, node.args[0].lineno))
    return out


def documented_families(text: str) -> Dict[str, int]:
    """Backticked ``pio_*`` names in the catalog → first line seen."""
    out: Dict[str, int] = {}
    for i, line in enumerate(text.splitlines(), 1):
        for m in _DOC_NAME_RE.finditer(line):
            name = m.group(1)
            if name.endswith("_"):
                continue  # `pio_lane_*`-style prefix prose, not a row
            out.setdefault(name, i)
    return out


def rule_metric_catalog_drift(mods: Sequence[ModuleInfo],
                              ctx: CheckContext) -> List[Finding]:
    registered: List[Tuple[str, str, int]] = []  # (name, path, line)
    mentioned: Set[str] = set()
    for mod in mods:
        if "pio_" not in mod.source:
            continue
        mentioned |= set(_NAME_RE.findall(mod.source))
        for name, line in registered_families(mod):
            registered.append((name, mod.path, line))
    if not registered or not os.path.exists(CATALOG_PATH):
        return []
    try:
        with open(CATALOG_PATH, encoding="utf-8") as f:
            documented = documented_families(f.read())
    except OSError:
        return []
    doc_display = os.path.join("docs", "observability.md")
    findings: List[Finding] = []
    seen: Set[str] = set()
    for name, path, line in registered:
        if name in documented or name in seen:
            continue
        seen.add(name)
        findings.append(Finding(
            "metric-catalog-drift", path, line, 0,
            f"metric family `{name}` is registered here but missing "
            f"from {doc_display} — undocumented series are invisible "
            f"to operators and to the SLO catalog; add a table row "
            f"(Series/Type/Labels/Meaning)"))
    for name, line in sorted(documented.items()):
        if name in mentioned or name in _NON_METRIC or name in LEFT_OUT:
            continue
        findings.append(Finding(
            "metric-catalog-drift", doc_display, line, 0,
            f"metric family `{name}` is documented in the catalog "
            f"but never occurs in the scanned sources — a dashboard "
            f"reading it flatlines silently; delete the row or "
            f"restore the emitter"))
    return findings


__all__ = ["CATALOG_PATH", "LEFT_OUT", "documented_families",
           "registered_families", "rule_metric_catalog_drift"]
