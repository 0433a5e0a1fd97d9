"""Finding baselines: gate CI on *no new findings* (the port of
``predictionio_tpu/analysis/baseline.py``; each package reads a baseline
the other wrote).

Turning a new rule on over a living codebase surfaces legacy findings
that can't all be fixed in the enabling PR. The baseline workflow
burns them down without blocking the gate:

- ``check --baseline findings.json --write-baseline`` records the
  current findings;
- ``check --baseline findings.json`` then fails ONLY on findings
  not in the baseline — pre-existing debt passes, regressions don't —
  and prints the entries the run no longer reproduces
  (:func:`shrinkable_entries`), so paid-down debt is visible;
- ``--write-baseline`` against an EXISTING baseline auto-tightens: it
  only ever removes or decrements entries (the ratchet — CI re-runs
  it every build, so the recorded debt is monotone non-increasing);
  recording genuinely new debt (enabling a new rule) needs the
  explicit ``--baseline-grow`` flag.

Findings are keyed by ``(path, rule, message)`` — deliberately NOT by
line, so unrelated edits that shift code don't resurrect baselined
findings. Each key carries a count: a second instance of an already-
baselined finding in the same file still fails.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

from .core import Finding

BASELINE_VERSION = 1

Key = Tuple[str, str, str]


def atomic_write_text(path: str, text: str) -> None:
    """Temp-file + fsync + rename: the durability funnel for every
    committed baseline/manifest this package writes. A crash at
    any instant leaves either the old file or the new one — never a
    torn half-write that the next CI run reads as garbage."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(text)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _key(f: Finding) -> Key:
    return (f.path.replace("\\", "/"), f.rule, f.message)


def _counts(findings: Sequence[Finding]) -> Dict[Key, int]:
    out: Dict[Key, int] = {}
    for f in findings:
        out[_key(f)] = out.get(_key(f), 0) + 1
    return out


def write_baseline(path: str, findings: Sequence[Finding],
                   cap: Optional[Dict[Key, int]] = None) -> int:
    """Persist the current findings as the accepted debt; returns how
    many entries were recorded. With ``cap`` (the previously recorded
    baseline) the write RATCHETS: every entry is clamped to
    ``min(current, recorded)`` and keys the old baseline never held
    are dropped — the file can only shrink, never absorb new debt."""
    counts = _counts(findings)
    if cap is not None:
        counts = {k: min(c, cap[k])
                  for k, c in counts.items() if k in cap}
    doc = {
        "version": BASELINE_VERSION,
        "entries": [
            {"path": p, "rule": r, "message": m, "count": c}
            for (p, r, m), c in sorted(counts.items())],
    }
    atomic_write_text(
        path, json.dumps(doc, indent=2, sort_keys=True) + "\n")
    return len(counts)


def load_baseline(path: str) -> Dict[Key, int]:
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict) \
            or doc.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"{path}: not a ptpu check baseline (expected version "
            f"{BASELINE_VERSION})")
    out: Dict[Key, int] = {}
    for e in doc.get("entries", []):
        out[(e["path"], e["rule"], e["message"])] = int(
            e.get("count", 1))
    return out


def new_findings(findings: Sequence[Finding],
                 baseline: Dict[Key, int]) -> List[Finding]:
    """Findings beyond the baseline's per-key budget, in input order
    (the first ``count`` instances of a baselined key pass; extras and
    unknown keys fail)."""
    budget = dict(baseline)
    out: List[Finding] = []
    for f in findings:
        k = _key(f)
        if budget.get(k, 0) > 0:
            budget[k] -= 1
        else:
            out.append(f)
    return out


def shrinkable_entries(findings: Sequence[Finding],
                       baseline: Dict[Key, int]
                       ) -> List[Tuple[Key, int, int]]:
    """Baseline entries the current run under-fills: ``(key,
    recorded, actual)`` with ``actual < recorded`` — the debt that has
    been paid down and can ratchet out of the file (sorted for stable
    output)."""
    counts = _counts(findings)
    out = [(k, rec, counts.get(k, 0))
           for k, rec in baseline.items()
           if counts.get(k, 0) < rec]
    return sorted(out)
