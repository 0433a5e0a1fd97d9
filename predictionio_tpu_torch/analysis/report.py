"""Finding output formats for ``check`` (the port of
``predictionio_tpu/analysis/report.py``: byte for byte its output for the
same findings and rules).

``text`` (the default, one ``path:line:col: rule: message`` per line)
stays the human surface; this module adds:

- ``json`` — a stable machine shape for scripting
  (``{"findings": [...], "count": N}``).
- ``sarif`` — SARIF 2.1.0, the format GitHub code scanning ingests, so
  a CI run of ``check --format sarif`` annotates the PR diff with
  each finding at its exact line (upload with
  ``github/codeql-action/upload-sarif``). Interprocedural findings
  carry their call chain as ``relatedLocations`` — the code-scanning
  UI walks from the hot call site down to the helper's direct
  violation.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence

from .core import Finding

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/"
                "sarif-spec/master/Schemata/sarif-schema-2.1.0.json")


def findings_to_json(findings: Sequence[Finding]) -> str:
    def one(f: Finding) -> dict:
        d = {"rule": f.rule, "path": f.path, "line": f.line,
             "col": f.col, "message": f.message}
        if f.related:
            d["related"] = [{"path": p, "line": ln, "note": note}
                            for p, ln, note in f.related]
        return d

    return json.dumps({
        "count": len(findings),
        "findings": [one(f) for f in findings],
    }, indent=2, sort_keys=True)


def findings_to_sarif(findings: Sequence[Finding],
                      rules: Dict[str, object]) -> str:
    """SARIF run: every registry rule is declared (so suppressed-to-
    zero still uploads a valid catalogue) and each finding becomes a
    ``result`` anchored at its file/line/col."""
    rule_ids = sorted(set(rules) | {f.rule for f in findings})
    driver_rules: List[dict] = []
    for rid in rule_ids:
        rule = rules.get(rid)
        desc = getattr(rule, "description", rid)
        driver_rules.append({
            "id": rid,
            "shortDescription": {"text": desc},
            "helpUri": "https://github.com/predictionio-tpu/"
                       "predictionio-tpu/blob/main/docs/"
                       "static-analysis.md",
        })
    index = {rid: i for i, rid in enumerate(rule_ids)}

    def physical(path: str, line: int, col: int) -> dict:
        return {
            "artifactLocation": {
                "uri": path.replace("\\", "/"),
                "uriBaseId": "%SRCROOT%",
            },
            "region": {
                "startLine": max(line, 1),
                # SARIF columns are 1-based; ast's are 0-based
                "startColumn": col + 1,
            },
        }

    results = []
    for f in findings:
        result = {
            "ruleId": f.rule,
            "ruleIndex": index[f.rule],
            "level": "error",
            "message": {"text": f.message},
            "locations": [{"physicalLocation":
                           physical(f.path, f.line, f.col)}],
        }
        if f.related:
            result["relatedLocations"] = [
                {"physicalLocation": physical(p, ln, 0),
                 "message": {"text": note}}
                for p, ln, note in f.related]
        results.append(result)
    doc = {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": "ptpu-check",
                "informationUri": "https://github.com/predictionio-tpu/"
                                  "predictionio-tpu",
                "rules": driver_rules,
            }},
            "results": results,
        }],
    }
    return json.dumps(doc, indent=2, sort_keys=True)
