"""``check`` — the port's static analysis (the port of
``predictionio_tpu/analysis``), and ``audit-lifecycle``,
``audit-numerics`` and ``audit-hlo``, its runtime complements
(:mod:`.lifecycle_audit`, :mod:`.numerics_audit`, :mod:`.hlo_audit`).

Public surface:

- :func:`run_check` / :func:`check_source` / :func:`check_project` —
  run the rule suite over paths, a source blob, or an in-memory
  multi-module project, returning :class:`Finding`\\ s. Module rules
  run per file; project rules (the cross-file lock-order graph, the
  interprocedural summary consumers, the shared-memory budget) run once
  over the whole parsed set, against the :class:`~.core.ProjectIndex`
  call graph.
- :data:`RULES` — the rule registry (name → :class:`Rule`): the
  concurrency, lifecycle, kernel-safety and numerics families,
  ``host-sync-in-hot-path`` with torch's sync calls, ``unbounded-retry``,
  ``metric-catalog-drift`` and ``smem-overbudget`` over ``csrc/``
  (:mod:`.rules` names what was not ported, and why).
- :func:`findings_to_json` / :func:`findings_to_sarif` — machine
  output (:mod:`.report`), byte for byte the JAX package's.
- :func:`write_baseline` / :func:`load_baseline` /
  :func:`new_findings` / :func:`shrinkable_entries` — gate CI on *no
  new findings* and ratchet the recorded debt monotonically down
  (:mod:`.baseline`).
- ``# ptpu: allow[rule] — why`` pragmas suppress a finding on that line
  or via the comment block directly above; ``# ptpu: guarded-by[lock]``
  is the lock-contract annotation ``unguarded-shared-state`` honors. A
  pragma at an effect's direct site also stops interprocedural
  propagation (blessing the one named helper blesses its callers).

Importing and running the checker loads neither torch nor numpy; only
the audits' entries do, inside their setup functions.
"""

from .baseline import (
    load_baseline,
    new_findings,
    shrinkable_entries,
    write_baseline,
)
from .core import (
    CheckContext,
    Finding,
    ProjectIndex,
    check_project,
    check_source,
    default_context,
    iter_py_files,
    run_check,
)
from .report import findings_to_json, findings_to_sarif
from .rules import RULES, Rule

__all__ = [
    "CheckContext",
    "Finding",
    "ProjectIndex",
    "RULES",
    "Rule",
    "check_project",
    "check_source",
    "default_context",
    "findings_to_json",
    "findings_to_sarif",
    "iter_py_files",
    "load_baseline",
    "new_findings",
    "run_check",
    "shrinkable_entries",
    "write_baseline",
]
