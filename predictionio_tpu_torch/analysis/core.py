"""Core machinery of ``check`` — the port's static-analysis pass (the
port of ``predictionio_tpu/analysis/core.py``).

Pure AST: this package imports neither torch nor numpy, so ``check``
runs in milliseconds on a storage-only host and in CI without a card.

Pieces:

- :class:`Finding` — one lint hit (rule, path, line, col, message),
  optionally carrying ``related`` call-chain locations (SARIF
  ``relatedLocations``).
- :class:`ModuleInfo` — a parsed file plus its import-alias table, so
  rules match *resolved* dotted names (``np.asarray`` and
  ``numpy.asarray`` are the same callee; ``from torch import cuda`` makes
  ``cuda.synchronize`` ``torch.cuda.synchronize``; relative imports
  resolve against the module's own package path).
- :class:`ProjectIndex` — the interprocedural layer: a project-wide
  symbol table and call graph over the parsed module set, with
  per-function effect summaries (performs-host-sync, blocks,
  delivers-callbacks, waits-on-the-network, acquires-locks,
  invokes-param) propagated through calls with cycle handling, so a
  violation hidden one helper call away is reported at the hot-path
  call site with the call chain in the message.
- pragma suppression — ``# ptpu: allow[rule]`` on the finding line or
  the comment block directly above silences that rule there
  (``allow[*]`` silences every rule). Justify the pragma in prose after
  the bracket. A pragma at an effect's *direct site* also stops the
  effect from propagating: blessing the one named D2H helper blesses
  its callers.
- :func:`run_check` — walk paths, parse once per file, run every rule,
  drop pragma'd findings, return the rest sorted. A file that fails to
  parse or decode becomes a per-file ``parse-error`` finding; a rule
  that crashes becomes a ``checker-error`` finding — one bad file or
  rule never kills the run.

Left out of the JAX package's core, as ``ROADMAP.md`` decided: the mesh
axis extraction behind the sharding rules, and the gather, spec and
low-precision sinks of ``materialized-gather``, ``implicit-reshard`` and
``low-precision-reduction`` (rules about JAX programs).

The rule catalogue lives in :mod:`.rules`; ``docs/static-analysis.md``
is the operator-facing reference.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: ``# ptpu: allow[rule-a,rule-b] — justification``; the marker may sit
#: anywhere inside a comment (pragmas usually end a justification
#: sentence), and the justification is free-form prose
PRAGMA_RE = re.compile(r"#.*?ptpu:\s*allow\[([^\]]*)\]")

#: ``# ptpu: guarded-by[lock] — justification``: the concurrency
#: contract annotation (see rule ``unguarded-shared-state``). On an
#: ``__init__`` attribute assignment it DECLARES the attribute
#: lock-guarded; on a ``def`` line it asserts every caller holds the
#: lock; on an access line it asserts that access is safe (caller
#: holds the lock, or a justified benign racy read).
GUARDED_RE = re.compile(r"#.*?ptpu:\s*guarded-by\[([^\]]*)\]")


@dataclass(frozen=True)
class Finding:
    """One checker hit, formatted ``path:line:col: rule: message``.

    ``related`` carries (path, line, note) hops of an interprocedural
    call chain — rendered as SARIF ``relatedLocations`` so a
    code-scanning UI can walk from the hot call site down to the
    offending helper."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    related: Tuple[Tuple[str, int, str], ...] = ()

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: " \
               f"{self.message}"


@dataclass
class CheckContext:
    """Cross-file facts rules need: the interprocedural
    :class:`ProjectIndex` over the scanned module set (built once per run
    by the orchestrator)."""

    project: Optional["ProjectIndex"] = None


def _module_parts(path: str) -> List[str]:
    """Dotted-name parts a file would import as: path components minus
    the ``.py`` suffix, with a package's ``__init__`` collapsing into
    the package name. Used for relative-import resolution and for the
    suffix-keyed function index (an absolute path's leading directories
    simply become extra — harmless — suffix prefixes)."""
    parts = [p for p in path.replace(os.sep, "/").split("/")
             if p not in ("", ".", "..")]
    if parts and parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return parts


class ModuleInfo:
    """A parsed module plus resolution helpers shared by every rule."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path.replace(os.sep, "/")
        self.source = source
        self.tree = tree
        self.lines = source.splitlines()
        self.module_parts = _module_parts(self.path)
        self.aliases = _collect_aliases(
            tree, self.module_parts,
            is_init=self.path.endswith("__init__.py"))
        self.pragmas = _collect_pragmas(self.lines)
        self.guards = _collect_guards(self.lines)

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted name of a Name/Attribute chain with import aliases
        expanded (``np.asarray`` → ``numpy.asarray``), else None."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        head = self.aliases.get(node.id, node.id)
        parts.append(head)
        return ".".join(reversed(parts))

    def _covering_lines(self, line: int) -> List[int]:
        """``line`` itself plus the contiguous comment block directly
        above it — the lines whose markers cover a statement at
        ``line`` (a multi-line justification can carry the marker on
        any of its lines)."""
        candidates = [line]
        ln = line - 1
        while 1 <= ln <= len(self.lines) \
                and self.lines[ln - 1].strip().startswith("#"):
            candidates.append(ln)
            ln -= 1
        return candidates

    def suppressed(self, finding: Finding) -> bool:
        """A pragma suppresses a finding on its own line, or anywhere in
        the contiguous comment block directly above the finding line."""
        for ln in self._covering_lines(finding.line):
            allowed = self.pragmas.get(ln)
            if allowed and ("*" in allowed or finding.rule in allowed):
                return True
        return False

    def guards_at(self, line: int) -> Set[str]:
        """Lock names asserted by ``# ptpu: guarded-by[...]`` markers
        covering ``line`` (same placement rules as pragmas)."""
        out: Set[str] = set()
        for ln in self._covering_lines(line):
            out |= self.guards.get(ln, set())
        return out


def _collect_aliases(tree: ast.Module,
                     module_parts: Optional[Sequence[str]] = None,
                     is_init: bool = False) -> Dict[str, str]:
    """Local name → dotted origin, from every import in the module
    (function-local imports included — the port imports triton and its
    kernel libraries inside the functions that launch them). Relative
    imports resolve against ``module_parts`` (the importing module's
    own dotted path), so ``from ..parallel.collectives import x`` in
    ``predictionio_tpu_torch/models/als.py`` binds
    ``predictionio_tpu_torch.parallel.collectives.x`` — the call-graph layer
    needs cross-module names to land on indexed functions."""
    aliases: Dict[str, str] = {}
    pkg = list(module_parts or [])
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = \
                    a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and not node.module:
                continue
            if node.level == 0:
                base = node.module
            else:
                # `from .` in a/b/c.py is package a.b (module_parts
                # minus the module itself); in a/b/__init__.py the
                # collapsed parts a.b already ARE the `.` base. Each
                # extra dot climbs one level.
                head = pkg if is_init else pkg[:-1]
                up = node.level - 1
                head = head[:len(head) - up] if up else head
                if not head:
                    continue
                base = ".".join(head + ([node.module]
                                        if node.module else []))
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{base}.{a.name}"
    return aliases


def _collect_pragmas(lines: Sequence[str]) -> Dict[int, Set[str]]:
    pragmas: Dict[int, Set[str]] = {}
    for i, line in enumerate(lines, start=1):
        m = PRAGMA_RE.search(line)
        if m:
            pragmas[i] = {r.strip() for r in m.group(1).split(",")
                          if r.strip()}
    return pragmas


def _collect_guards(lines: Sequence[str]) -> Dict[int, Set[str]]:
    guards: Dict[int, Set[str]] = {}
    for i, line in enumerate(lines, start=1):
        m = GUARDED_RE.search(line)
        if m:
            guards[i] = {r.strip() for r in m.group(1).split(",")
                         if r.strip()}
    return guards


def default_context() -> CheckContext:
    """A fresh context (the JAX package's also carries its mesh axes,
    which no rule of the port reads)."""
    return CheckContext()


# ---------------------------------------------------------------------------
# graph utilities (shared by the call graph and the lock-order graph)
# ---------------------------------------------------------------------------

def strongly_connected(nodes: Set[str],
                       edges: Dict[str, Set[str]]) -> List[Set[str]]:
    """Tarjan SCCs (iterative), deterministic. Emission order is
    reverse-topological over the condensation — every SCC is emitted
    before any of its callers — which is exactly the order effect
    propagation wants (callees first)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[Set[str]] = []
    counter = [0]

    for root in sorted(nodes):
        if root in index:
            continue
        work: List[Tuple[str, int]] = [(root, 0)]
        while work:
            node, pi = work[-1]
            if pi == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack.add(node)
            advanced = False
            succs = sorted(edges.get(node, ()))
            for i in range(pi, len(succs)):
                s = succs[i]
                if s not in index:
                    work[-1] = (node, i + 1)
                    work.append((s, 0))
                    advanced = True
                    break
                if s in on_stack:
                    low[node] = min(low[node], index[s])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc: Set[str] = set()
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.add(w)
                    if w == node:
                        break
                sccs.append(scc)
    return sccs


# ---------------------------------------------------------------------------
# interprocedural layer: symbol table, call graph, effect summaries
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Witness:
    """Where an effect is anchored. ``via=None``: the direct site (the
    offending expression itself, described by ``what``). ``via=qname``:
    this function inherits the effect from a call to ``qname`` at
    (path, line) — follow the callee's own witness to keep walking the
    chain down to the direct site."""

    rule: str
    path: str
    line: int
    col: int
    what: str
    via: Optional[str] = None


@dataclass
class CallSite:
    """One call edge out of a function's immediate body (nested defs
    are deferred execution and keep their own edges out of summaries).
    ``arg_names[i]`` / ``kwarg_names[k]`` hold the bare variable name
    passed at that slot (None for non-Name expressions) so param-flow
    sinks (invoked callables) can be matched through
    the call."""

    line: int
    col: int
    callee: Optional[str]           # resolved qname, or None
    bound: bool                     # invoked as self.m(...) / cls.m(...)
    arg_names: List[Optional[str]]
    kwarg_names: Dict[str, Optional[str]]
    lambda_args: Set[int] = field(default_factory=set)


#: effect summary slots propagated through the call graph; each maps
#: to the rule whose `# ptpu: allow[...]` pragma at the DIRECT site
#: stops propagation (blessing the helper blesses its callers)
EFFECTS = ("host_sync", "blocking", "callback", "net_wait")
EFFECT_RULE = {
    "host_sync": "host-sync-in-hot-path",
    "blocking": "blocking-under-lock",
    "callback": "callback-under-lock",
    "net_wait": "missing-timeout",
}


class FunctionInfo:
    """One indexed function (module-level def or class method) with its
    direct facts and, after :meth:`ProjectIndex._propagate`, the
    transitive summaries."""

    def __init__(self, qname: str, mod: ModuleInfo, node: ast.AST,
                 cls: Optional[str]):
        self.qname = qname
        self.mod = mod
        self.node = node
        self.cls = cls
        a = node.args
        self.params: List[str] = [p.arg for p in
                                  (*a.posonlyargs, *a.args)]
        self.calls: List[CallSite] = []
        #: effect name → Witness (direct first, transitive after
        #: propagation); acquired lock names use the canonical
        #: Class.attr / module.name identities of the lock-order graph
        self.effects: Dict[str, Optional[Witness]] = \
            {e: None for e in EFFECTS}
        self.acquires: Dict[str, Witness] = {}
        #: param position → Witness: the param is invoked as a
        #: callable (callback-under-lock)
        self.call_sinks: Dict[int, Witness] = {}

    def hot(self, dir_parts: Set[str]) -> bool:
        return bool(set(self.mod.path.split("/")[:-1]) & dir_parts)


def _immediate_body(fn: ast.AST) -> Iterable[ast.AST]:
    """Walk a function's own body, NOT descending into nested
    defs/lambdas — those are deferred execution with their own call
    timing, so their effects must not leak into the enclosing
    function's summary (mirrors the held-lock reset in the walkers)."""
    stack = list(fn.body) if isinstance(fn.body, list) else [fn.body]
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


_AMBIGUOUS = object()


class ProjectIndex:
    """Project-wide symbol table + call graph + effect summaries.

    Functions are keyed by their full dotted qname and registered under
    every dotted *suffix* (``als._lhs_fn``,
    ``models.als._lhs_fn``, …) so call sites resolve however the
    caller imported the module; a suffix naming two different functions
    is ambiguous and resolves to nothing (conservative silence beats a
    wrong chain). ``self.m()`` / ``cls.m()`` resolve within the
    enclosing class only.
    """

    def __init__(self, mods: Sequence[ModuleInfo]):
        self.functions: Dict[str, FunctionInfo] = {}
        self._suffixes: Dict[str, object] = {}
        for mod in mods:
            self._index_module(mod)
        for fn in self.functions.values():
            self._collect_direct(fn)
        self._propagate()

    # -- symbol table -------------------------------------------------

    def _register(self, key: str, fn: FunctionInfo) -> None:
        cur = self._suffixes.get(key)
        if cur is None:
            self._suffixes[key] = fn
        elif cur is not fn:
            self._suffixes[key] = _AMBIGUOUS

    def _index_module(self, mod: ModuleInfo) -> None:
        parts = mod.module_parts
        dotted = ".".join(parts)

        def add(local: str, node: ast.AST, cls: Optional[str]) -> None:
            qname = f"{dotted}.{local}" if dotted else local
            fn = FunctionInfo(qname, mod, node, cls)
            self.functions[qname] = fn
            for k in range(1, len(parts) + 1):
                self._register(
                    ".".join(parts[-k:] + [local]), fn)

        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                add(node.name, node, None)
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        add(f"{node.name}.{sub.name}", sub, node.name)

    def lookup(self, dotted: Optional[str]) -> Optional[FunctionInfo]:
        if not dotted:
            return None
        hit = self._suffixes.get(dotted)
        return hit if isinstance(hit, FunctionInfo) else None

    def resolve_call(self, mod: ModuleInfo, class_name: Optional[str],
                     func_expr: ast.AST) -> Tuple[Optional[str], bool]:
        """(callee qname, bound?) for a call's func expression:
        ``self.m``/``cls.m`` resolves within ``class_name``; names and
        attribute chains resolve through the import-alias table and
        the suffix index."""
        if isinstance(func_expr, ast.Attribute) \
                and isinstance(func_expr.value, ast.Name) \
                and func_expr.value.id in ("self", "cls"):
            if class_name is None:
                return None, True
            dotted = ".".join(mod.module_parts
                              + [class_name, func_expr.attr])
            fn = self.functions.get(dotted)
            return (fn.qname if fn else None), True
        resolved = mod.resolve(func_expr)
        if resolved is None:
            return None, False
        fn = self.lookup(resolved)
        if fn is None and isinstance(func_expr, ast.Name):
            # plain local call: the alias table has no entry, so try
            # the caller's own module
            dotted = ".".join(mod.module_parts + [func_expr.id])
            f2 = self.functions.get(dotted)
            return (f2.qname if f2 else None), False
        return (fn.qname if fn else None), False

    # -- direct facts -------------------------------------------------

    def _suppressed_at(self, mod: ModuleInfo, rule: str,
                       line: int) -> bool:
        return mod.suppressed(Finding(rule, mod.path, line, 0, ""))

    def _collect_direct(self, fn: FunctionInfo) -> None:
        # lazy imports: rules/concurrency import this module at top
        # level, so the detector tables are pulled in at call time
        from .concurrency import blocking_reason, lock_expr_name
        from .concurrency import CALLBACK_ATTRS
        from .lifecycle import net_wait_reason
        from .rules import host_sync_reason

        mod = fn.mod
        params = fn.params

        def witness(effect: str, node: ast.AST, what: str) -> None:
            rule = EFFECT_RULE[effect]
            if fn.effects[effect] is not None \
                    or self._suppressed_at(mod, rule, node.lineno):
                return
            fn.effects[effect] = Witness(rule, mod.path, node.lineno,
                                         node.col_offset, what)

        for node in _immediate_body(fn.node):
            if isinstance(node, ast.With):
                for item in node.items:
                    name = lock_expr_name(mod, item.context_expr,
                                          fn.cls)
                    if name is not None and name not in fn.acquires:
                        fn.acquires[name] = Witness(
                            "lock-order-inversion", mod.path,
                            item.context_expr.lineno,
                            item.context_expr.col_offset,
                            f"acquires {name}")
            if not isinstance(node, ast.Call):
                continue
            # host sync
            why = host_sync_reason(mod, node)
            if why is not None:
                witness("host_sync", node, why)
            # blocking
            why = blocking_reason(mod, node)
            if why is not None:
                witness("blocking", node, why)
            # timeout-less network wait (missing-timeout)
            why = net_wait_reason(mod, node)
            if why is not None:
                witness("net_wait", node, why)
            # delivery-style callback
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in CALLBACK_ATTRS:
                witness("callback", node,
                        f"`.{node.func.attr}(…)` delivers to "
                        f"subscribers/plugins")
            # param invoked as a callable
            if isinstance(node.func, ast.Name) \
                    and node.func.id in params:
                pos = params.index(node.func.id)
                if pos not in fn.call_sinks \
                        and not self._suppressed_at(
                            mod, "callback-under-lock", node.lineno):
                    fn.call_sinks[pos] = Witness(
                        "callback-under-lock", mod.path, node.lineno,
                        node.col_offset,
                        f"invokes its `{node.func.id}` argument")
            # call edge
            callee, bound = self.resolve_call(mod, fn.cls, node.func)
            arg_names = [a.id if isinstance(a, ast.Name) else None
                         for a in node.args]
            lambda_args = {i for i, a in enumerate(node.args)
                           if isinstance(a, (ast.Lambda,))}
            kwarg_names = {kw.arg: (kw.value.id
                                    if isinstance(kw.value, ast.Name)
                                    else None)
                           for kw in node.keywords if kw.arg}
            fn.calls.append(CallSite(node.lineno, node.col_offset,
                                     callee, bound, arg_names,
                                     kwarg_names, lambda_args))

    # -- propagation --------------------------------------------------

    def _arg_to_param(self, call: CallSite,
                      callee: FunctionInfo) -> List[Tuple[int, int]]:
        """(caller arg slot, callee param position) pairs, accounting
        for the implicit self of bound calls. The caller arg slot is
        the positional index into ``call.arg_names``; keyword args get
        synthetic slots past the positionals."""
        pairs: List[Tuple[int, int]] = []
        off = 1 if call.bound else 0
        for i in range(len(call.arg_names)):
            pairs.append((i, i + off))
        base = len(call.arg_names)
        for j, k in enumerate(call.kwarg_names):
            if k in callee.params:
                pairs.append((base + j, callee.params.index(k)))
        return pairs

    def _call_slot_name(self, call: CallSite,
                        slot: int) -> Optional[str]:
        if slot < len(call.arg_names):
            return call.arg_names[slot]
        keys = list(call.kwarg_names)
        j = slot - len(call.arg_names)
        return call.kwarg_names[keys[j]] if j < len(keys) else None

    def _propagate(self) -> None:
        edges: Dict[str, Set[str]] = {}
        for q, fn in self.functions.items():
            edges[q] = {c.callee for c in fn.calls
                        if c.callee and c.callee in self.functions}
        sccs = strongly_connected(set(self.functions), edges)
        for scc in sccs:  # emitted callees-first
            members = [self.functions[q] for q in sorted(scc)]
            # fixpoint within the SCC (mutual recursion: an effect
            # anywhere in the cycle reaches every member)
            for _ in range(len(members) + 1):
                changed = False
                for fn in members:
                    changed |= self._absorb(fn)
                if not changed:
                    break

    def _absorb(self, fn: FunctionInfo) -> bool:
        changed = False
        for call in fn.calls:
            callee = self.functions.get(call.callee or "")
            if callee is None or callee is fn:
                continue
            for eff in EFFECTS:
                if fn.effects[eff] is None \
                        and callee.effects[eff] is not None:
                    fn.effects[eff] = Witness(
                        EFFECT_RULE[eff], fn.mod.path, call.line,
                        call.col, "", via=callee.qname)
                    changed = True
            for name, w in callee.acquires.items():
                if name not in fn.acquires:
                    fn.acquires[name] = Witness(
                        "lock-order-inversion", fn.mod.path, call.line,
                        call.col, f"acquires {name}",
                        via=callee.qname)
                    changed = True
            for slot, pos in self._arg_to_param(call, callee):
                name = self._call_slot_name(call, slot)
                if name is None or name not in fn.params:
                    continue
                my_pos = fn.params.index(name)
                if pos in callee.call_sinks \
                        and my_pos not in fn.call_sinks:
                    fn.call_sinks[my_pos] = Witness(
                        "callback-under-lock", fn.mod.path, call.line,
                        call.col, "", via=f"{callee.qname}#{pos}")
                    changed = True
        return changed

    # -- chain reconstruction ----------------------------------------

    def chain(self, start: FunctionInfo, effect: str
              ) -> List[Tuple[str, Witness]]:
        """(function qname, witness) hops from ``start`` down to the
        direct site; the last hop's witness has ``via=None`` and a
        populated ``what``. Cycle-guarded."""
        hops: List[Tuple[str, Witness]] = []
        fn: Optional[FunctionInfo] = start
        seen: Set[str] = set()
        while fn is not None and fn.qname not in seen:
            seen.add(fn.qname)
            w = fn.effects.get(effect)
            if w is None:
                break
            hops.append((fn.qname, w))
            fn = self.functions.get(w.via) if w.via else None
        return hops

    def sink_chain(self, start: FunctionInfo, kind: str, pos: int
                   ) -> List[Tuple[str, Witness]]:
        """Like :meth:`chain` for a param-position sink (``kind`` is
        ``call``: the only sink the port's rules read)."""
        hops: List[Tuple[str, Witness]] = []
        fn: Optional[FunctionInfo] = start
        seen: Set[Tuple[str, int]] = set()
        while fn is not None and (fn.qname, pos) not in seen:
            seen.add((fn.qname, pos))
            sinks = {"call": fn.call_sinks}[kind]
            w = sinks.get(pos)
            if w is None:
                break
            hops.append((fn.qname, w))
            if not w.via:
                break
            qname, _, p = w.via.partition("#")
            fn = self.functions.get(qname)
            pos = int(p) if p else pos
        return hops


def short_name(qname: str) -> str:
    """`pkg.mod.Class.meth` → `Class.meth`; `pkg.mod.fn` → `fn` (for
    finding messages — the full path rides in ``related``)."""
    parts = qname.split(".")
    if len(parts) >= 2 and parts[-2][:1].isupper():
        return ".".join(parts[-2:])
    return parts[-1]


def chain_text(hops: List[Tuple[str, Witness]]) -> str:
    """Human call-chain starting at the callee of the flagged call
    site: ``outer (lib/middle.py:4) → inner (utils/x.py:2):
    np.asarray …`` — each hop's location is the site *inside* that
    function (its call to the next hop, or the direct effect)."""
    if not hops:
        return ""
    segs = [f"{short_name(q)} ({w.path}:{w.line})" for q, w in hops]
    last = hops[-1][1]
    return f"{' → '.join(segs)}: {last.what}"


def chain_related(hops: List[Tuple[str, Witness]]
                  ) -> Tuple[Tuple[str, int, str], ...]:
    out: List[Tuple[str, int, str]] = []
    for qname, w in hops:
        note = w.what if not w.via \
            else f"`{short_name(qname)}` calls " \
                 f"`{short_name(w.via.partition('#')[0])}` here"
        out.append((w.path, w.line, note))
    return tuple(out)


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

def iter_py_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                out.append(p)
            continue
        for root, dirs, names in os.walk(p):
            dirs[:] = sorted(d for d in dirs
                             if not d.startswith(".")
                             and d != "__pycache__")
            for n in sorted(names):
                if n.endswith(".py"):
                    out.append(os.path.join(root, n))
    return out


def _run_rules(mods: List[ModuleInfo],
               rule_names: Optional[Sequence[str]],
               ctx: CheckContext) -> List[Finding]:
    """Module-scoped rules per file, then project-scoped rules over the
    whole parsed set (the cross-file lock-order graph, the
    interprocedural summary consumers); pragma suppression is resolved
    against the module each finding points at. A rule that crashes on
    one module becomes a ``checker-error`` finding instead of killing
    the run — the checker must never be the flakiest thing in CI."""
    from .rules import RULES

    if ctx.project is None:
        ctx.project = ProjectIndex(mods)
    by_path = {m.path: m for m in mods}
    findings: List[Finding] = []

    def guarded(fn, target, anchor_path: str, name: str) -> None:
        try:
            findings.extend(fn(target, ctx))
        except Exception as e:  # noqa: BLE001 — robustness boundary
            findings.append(Finding(
                "checker-error", anchor_path, 1, 0,
                f"rule `{name}` crashed: {type(e).__name__}: {e} "
                f"(checker bug — findings for this rule are "
                f"incomplete here)"))

    for name, rule in RULES.items():
        if rule_names and name not in rule_names:
            continue
        if rule.project:
            guarded(rule.fn, mods,
                    mods[0].path if mods else "<project>", name)
        else:
            for mod in mods:
                guarded(rule.fn, mod, mod.path, name)
    surviving = [f for f in findings
                 if f.path not in by_path
                 or not by_path[f.path].suppressed(f)]
    return sorted(surviving,
                  key=lambda f: (f.path, f.line, f.col, f.rule))


def check_source(source: str, path: str = "<string>",
                 rule_names: Optional[Sequence[str]] = None,
                 ctx: Optional[CheckContext] = None) -> List[Finding]:
    """Run the (selected) rules over one source blob — the test and
    single-file entry point. Pragma suppression applies; project rules
    see a one-module project."""
    ctx = ctx or default_context()
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("parse-error", path, e.lineno or 1, 0,
                        f"cannot parse: {e.msg}")]
    return _run_rules([ModuleInfo(path, source, tree)], rule_names, ctx)


def check_project(files: Dict[str, str],
                  rule_names: Optional[Sequence[str]] = None,
                  ctx: Optional[CheckContext] = None) -> List[Finding]:
    """Run the (selected) rules over an in-memory multi-module project
    — the entry point the interprocedural tests use (cross-module
    summary propagation without touching disk). ``files`` maps
    relative paths to sources; unparsable entries become per-file
    ``parse-error`` findings like :func:`run_check`."""
    ctx = ctx or default_context()
    findings: List[Finding] = []
    mods: List[ModuleInfo] = []
    for path, source in sorted(files.items()):
        try:
            tree = ast.parse(source)
        except SyntaxError as e:
            findings.append(Finding("parse-error", path, e.lineno or 1,
                                    0, f"cannot parse: {e.msg}"))
            continue
        mods.append(ModuleInfo(path, source, tree))
    findings.extend(_run_rules(mods, rule_names, ctx))
    return sorted(findings,
                  key=lambda f: (f.path, f.line, f.col, f.rule))


def run_check(paths: Sequence[str],
              rule_names: Optional[Sequence[str]] = None) -> List[Finding]:
    """Walk ``paths``, check every ``.py`` file, return surviving
    findings sorted by location."""
    from .rules import RULES

    unknown = set(rule_names or ()) - set(RULES)
    if unknown:
        raise ValueError(f"unknown rule(s): {sorted(unknown)} "
                         f"(have: {sorted(RULES)})")
    files = iter_py_files(paths)
    ctx = CheckContext()
    findings: List[Finding] = []
    mods: List[ModuleInfo] = []
    for f in files:
        try:
            with open(f, "r", encoding="utf-8") as fh:
                src = fh.read()
        except (OSError, UnicodeDecodeError) as e:
            findings.append(Finding("parse-error", f, 1, 0, str(e)))
            continue
        try:
            tree = ast.parse(src)
        except SyntaxError as e:
            findings.append(Finding("parse-error", f, e.lineno or 1, 0,
                                    f"cannot parse: {e.msg}"))
            continue
        mods.append(ModuleInfo(f, src, tree))
    findings.extend(_run_rules(mods, rule_names, ctx))
    return findings
