"""The concurrency rule family behind ``check`` (the port of
``predictionio_tpu/analysis/concurrency.py``).

The serving path is heavily threaded (the staged pipeline and the
drainers, the cache tiers and the invalidation bus, the release swap,
the rollout gate, the hot-tier refresh, the stream trainer), and the
riskiest bug class in such a system is a cross-thread state race or an
acquisition-order deadlock. Four rules make lock discipline statically
checkable:

- ``unguarded-shared-state`` — per class, infer the lock-guarded
  attribute set (any ``self._x`` written under ``with self._lock`` in
  some method) and flag reads/writes of those attributes outside the
  lock. The ``# ptpu: guarded-by[lock]`` annotation is the escape
  hatch AND the contract language: on an ``__init__`` assignment it
  declares the attribute guarded; on a ``def`` line it asserts every
  caller holds the lock (the whole body is then treated as locked); on
  an access line it blesses that one access (caller holds the lock, or
  a justified benign racy read of an atomically-swapped reference).
- ``lock-order-inversion`` — project-scoped: build the static
  acquisition graph from nested ``with``-lock scopes across every
  scanned file and report cycles. Lock identity is ``Class.attr`` for
  ``self``/``cls`` locks (conservative: instances of one class merge)
  and ``module.name`` for globals.
- ``blocking-under-lock`` — a wait on the card (``torch.cuda.synchronize``,
  ``.synchronize()``, ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``), a launch of one of the port's kernels, HTTP/socket I/O,
  storage access, ``sleep``, zero-arg ``.join()``, ``.wait()``/
  ``.result()`` inside a held-lock region in ``server/``, ``cache/``, or
  ``rollout/``. A lock held across a blocking call serializes every
  other thread on that I/O — and held across a wait on the card it caps
  throughput at one round trip per lock.
- ``callback-under-lock`` — invoking a dynamic callable (subscriber,
  plugin hook, loop-variable function) or a publish/notify-style
  method while holding a lock: the callee can re-enter the publisher
  and deadlock, and the bus pattern (snapshot under lock, call
  outside) exists precisely to prevent it.

A lock is what a ``threading`` factory or ``concurrency.new_lock`` /
``new_rlock`` builds (:data:`LOCK_FACTORY_SUFFIXES`), or a lock-named
attribute.

The JAX package's blocking rows, beside the port's:

=====================================  ====================================
JAX package                            the port
=====================================  ====================================
``time.sleep``                         ``time.sleep`` (kept)
``jax.device_get``                     ``.cpu()``, ``.numpy()``,
                                       ``.tolist()``, ``.item()``: the
                                       copies to the host that wait for
                                       the card
``jax.block_until_ready``,             ``torch.cuda.synchronize``,
``.block_until_ready()``               ``.synchronize()`` on a stream or
                                       an event
``jax.*`` (device work dispatched,     the port's kernel launchers under
possibly compiled, with the lock       ``ops/`` (:data:`KERNEL_LAUNCHERS`:
held)                                  a launch, and ``nvcc`` on the
                                       first); torch's own operators
                                       are asynchronous and have no row
``urllib.``, ``requests.``,            kept
``socket.``, ``http.client``,
``.urlopen()``
``.wait()``, ``.result()``, ``.join()`` kept
storage chains (``*.storage.*``)       kept
=====================================  ====================================

All four honor ``# ptpu: allow[rule] — justification`` pragmas. The
runtime complement lives in :mod:`predictionio_tpu_torch.concurrency`
(DebugLock order graph, watchdog, ``pio_lock_*`` metrics).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .core import (
    CheckContext,
    Finding,
    ModuleInfo,
    chain_related,
    chain_text,
    short_name,
    strongly_connected,
)

#: what makes a name "a lock" for the with-scope rules
LOCK_NAME_RE = re.compile(r"lock|mutex", re.IGNORECASE)

#: constructors whose result is a mutex, regardless of attribute name
LOCK_FACTORY_SUFFIXES = {"Lock", "RLock", "Condition",
                         "new_lock", "new_rlock"}

#: directories whose lock regions must not block (the serving stack)
SERVING_DIR_PARTS = {"server", "cache", "rollout"}

#: attribute-method names that suggest delivering to subscribers or
#: plugins — calling one with a lock held invites re-entrant deadlock
CALLBACK_ATTRS = {"publish", "process_output", "on_event", "notify",
                  "emit", "fire_event"}

#: blocking calls by resolved dotted name
BLOCKING_EXACT = {
    "time.sleep": "time.sleep blocks every thread queued on this lock",
    "torch.cuda.synchronize": "torch.cuda.synchronize blocks until the "
                              "card has run every queued kernel",
}
BLOCKING_PREFIXES = (
    ("urllib.", "HTTP I/O under a lock serializes all waiters on the "
                "network"),
    ("requests.", "HTTP I/O under a lock serializes all waiters on "
                  "the network"),
    ("socket.", "socket I/O under a lock serializes all waiters on "
                "the network"),
    ("http.client", "HTTP I/O under a lock serializes all waiters on "
                    "the network"),
)
#: the port's kernel launchers, by dotted suffix: each launches a
#: hand-written kernel (and builds its library with nvcc on the first
#: call)
KERNEL_LAUNCHERS = (
    "ops.fused_topk.fused_topk",
    "ops.fused_gram.fused_gram",
    "ops.solve.solve_spd_batch",
    "ops.gram.gram_table",
)
#: blocking method calls by attribute name
BLOCKING_METHOD_ATTRS = {
    "synchronize": ".synchronize() blocks until the stream's or event's "
                   "work on the card completes",
    "item": ".item() waits for the card and copies a scalar to the host",
    "tolist": ".tolist() waits for the card and copies the tensor to "
              "host Python objects",
    "cpu": ".cpu() waits for the card and copies the tensor to the host",
    "numpy": ".numpy() copies the tensor to a host array (after the "
             "wait of the .cpu() before it)",
    "urlopen": "HTTP I/O under a lock serializes all waiters on the "
               "network",
    "wait": "waiting on an event/condition while holding a lock is a "
            "classic lost-wakeup deadlock",
    "result": "blocking on a Future while holding a lock deadlocks if "
              "the producer needs the same lock",
}
#: of those, the tensor methods: blocking only when called bare
_TENSOR_SYNC_ATTRS = ("synchronize", "item", "tolist", "cpu", "numpy")


def is_kernel_launcher(resolved: Optional[str]) -> bool:
    """Whether a resolved dotted name is one of the port's kernel
    launchers (however its module was imported)."""
    return bool(resolved) and any(
        resolved == s or resolved.endswith("." + s)
        for s in KERNEL_LAUNCHERS)


def _in_serving_stack(path: str) -> bool:
    return bool(set(path.split("/")[:-1]) & SERVING_DIR_PARTS)


def _mod_stem(path: str) -> str:
    return os.path.basename(path)[:-3] if path.endswith(".py") \
        else os.path.basename(path)


def _is_lock_factory(mod: ModuleInfo, value: ast.AST) -> bool:
    if not isinstance(value, ast.Call):
        return False
    name = mod.resolve(value.func)
    if not name:
        return False
    return name.split(".")[-1] in LOCK_FACTORY_SUFFIXES


def _self_attr(node: ast.AST) -> Optional[str]:
    """``X`` for ``self.X`` / ``cls.X``, else None."""
    if isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Name) \
            and node.value.id in ("self", "cls"):
        return node.attr
    return None


# ---------------------------------------------------------------------------
# rule: unguarded-shared-state
# ---------------------------------------------------------------------------

class _Access:
    __slots__ = ("attr", "line", "col", "store", "held", "method")

    def __init__(self, attr: str, line: int, col: int, store: bool,
                 held: FrozenSet[str], method: str):
        self.attr = attr
        self.line = line
        self.col = col
        self.store = store
        self.held = held
        self.method = method


def _class_lock_attrs(mod: ModuleInfo, cls: ast.ClassDef) -> Set[str]:
    """Attributes of ``cls`` that hold mutexes: assigned from a lock
    factory (anywhere in the class) or lock-named."""
    locks: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                attr = _self_attr(t)
                if attr is None and isinstance(t, ast.Name):
                    attr = t.id  # class-level `_lock = Lock()`
                if attr and (_is_lock_factory(mod, node.value)
                             or LOCK_NAME_RE.search(attr)):
                    locks.add(attr)
    return locks


def _walk_method_accesses(mod: ModuleInfo, method: ast.AST,
                          lock_attrs: Set[str]) -> List[_Access]:
    """Every ``self.X``/``cls.X`` access in ``method`` with the set of
    class locks syntactically held at that point. Entering a nested
    function resets the held set (deferred execution) except for locks
    the nested def's own ``guarded-by`` line asserts."""
    accesses: List[_Access] = []
    mname = getattr(method, "name", "<lambda>")

    def held_from_with(item: ast.withitem,
                       held: FrozenSet[str]) -> FrozenSet[str]:
        attr = _self_attr(item.context_expr)
        if attr and attr in lock_attrs:
            return held | {attr}
        return held

    def visit(node: ast.AST, held: FrozenSet[str]) -> None:
        if isinstance(node, ast.With):
            h = held
            for item in node.items:
                visit(item.context_expr, h)
                h = held_from_with(item, h)
                if item.optional_vars is not None:
                    visit(item.optional_vars, h)
            for stmt in node.body:
                visit(stmt, h)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node is not method:
            inner = frozenset(mod.guards_at(node.lineno) & lock_attrs)
            for child in ast.iter_child_nodes(node):
                visit(child, inner)
            return
        if isinstance(node, ast.Lambda):
            for child in ast.iter_child_nodes(node):
                visit(child, frozenset())
            return
        attr = _self_attr(node)
        if attr is not None:
            accesses.append(_Access(
                attr, node.lineno, node.col_offset,
                isinstance(node.ctx, (ast.Store, ast.Del)), held,
                mname))
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    start = frozenset(mod.guards_at(method.lineno) & lock_attrs) \
        if isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)) \
        else frozenset()
    for child in ast.iter_child_nodes(method):
        visit(child, start)
    return accesses


def rule_unguarded_shared_state(mod: ModuleInfo,
                                ctx: CheckContext) -> List[Finding]:
    findings: List[Finding] = []
    for cls in ast.walk(mod.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        lock_attrs = {a for a in _class_lock_attrs(mod, cls)}
        if not lock_attrs:
            continue
        methods = [n for n in cls.body
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))]
        per_method = {m.name: _walk_method_accesses(mod, m, lock_attrs)
                      for m in methods}
        # infer the guarded set: attr → locks it was written under
        guarded: Dict[str, Set[str]] = {}
        for m in methods:
            exempt = m.name in ("__init__", "__del__")
            for acc in per_method[m.name]:
                if acc.attr in lock_attrs:
                    continue
                if acc.store and acc.held and not exempt:
                    guarded.setdefault(acc.attr, set()).update(acc.held)
                if acc.store and exempt:
                    # declaration form: `self._x = 0  # ptpu:
                    # guarded-by[_lock]` in __init__
                    declared = mod.guards_at(acc.line) & lock_attrs
                    if declared:
                        guarded.setdefault(acc.attr,
                                           set()).update(declared)
        if not guarded:
            continue
        for m in methods:
            if m.name in ("__init__", "__del__"):
                continue
            for acc in per_method[m.name]:
                locks = guarded.get(acc.attr)
                if not locks or acc.held & locks:
                    continue
                asserted = mod.guards_at(acc.line)
                if asserted & locks or "*" in asserted:
                    continue
                verb = "written" if acc.store else "read"
                lock_list = "/".join(sorted(locks))
                findings.append(Finding(
                    "unguarded-shared-state", mod.path, acc.line,
                    acc.col,
                    f"`self.{acc.attr}` is {verb} in "
                    f"`{cls.name}.{m.name}` without holding "
                    f"`{lock_list}`, but other methods write it under "
                    f"that lock; take the lock, or annotate with "
                    f"'# ptpu: guarded-by[{sorted(locks)[0]}] — why' "
                    f"if the caller holds it"))
    return findings


# ---------------------------------------------------------------------------
# shared with-scope walker (lock-order / blocking / callback rules)
# ---------------------------------------------------------------------------

def lock_expr_name(mod: ModuleInfo, expr: ast.AST,
                   class_name: Optional[str]) -> Optional[str]:
    """Canonical cross-file name for a lock expression in a ``with``
    item, or None when the expression is not lock-like. Shared with
    the interprocedural acquires-locks summaries
    (:class:`~.core.ProjectIndex`), so call-through acquisition edges
    land on the same graph nodes as syntactic nesting."""
    attr = _self_attr(expr)
    if attr is not None:
        if LOCK_NAME_RE.search(attr):
            return f"{class_name or _mod_stem(mod.path)}.{attr}"
        return None
    if isinstance(expr, ast.Name) and LOCK_NAME_RE.search(expr.id):
        return f"{_mod_stem(mod.path)}.{expr.id}"
    if isinstance(expr, ast.Attribute) \
            and LOCK_NAME_RE.search(expr.attr):
        base = expr.value
        recv = base.id if isinstance(base, ast.Name) else "?"
        return f"{_mod_stem(mod.path)}:{recv}.{expr.attr}"
    return None


class _WithScopeWalker:
    """Walks one module, calling ``on_edge`` for every nested-lock
    acquisition edge and ``on_node`` for every AST node with the
    currently-held lock list. Held state resets at function
    boundaries (each call stack acquires from scratch; nested defs are
    deferred execution)."""

    def __init__(self, mod: ModuleInfo, on_edge=None, on_node=None):
        self.mod = mod
        self.on_edge = on_edge
        self.on_node = on_node

    def run(self) -> None:
        self._visit_block(self.mod.tree.body, [], None)

    def _visit_block(self, stmts, held: List[str],
                     class_name: Optional[str]) -> None:
        for stmt in stmts:
            self._visit(stmt, held, class_name)

    def _visit(self, node: ast.AST, held: List[str],
               class_name: Optional[str]) -> None:
        if isinstance(node, ast.ClassDef):
            self._visit_block(node.body, [], node.name)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            body = node.body if isinstance(node.body, list) \
                else [node.body]
            self._visit_block(body, [], class_name)
            return
        if isinstance(node, ast.With):
            h = list(held)
            for item in node.items:
                self._visit(item.context_expr, h, class_name)
                name = lock_expr_name(self.mod, item.context_expr,
                                      class_name)
                if name is not None:
                    if self.on_edge is not None:
                        for prior in h:
                            if prior != name:
                                self.on_edge(prior, name,
                                             item.context_expr)
                    h.append(name)
            self._visit_block(node.body, h, class_name)
            return
        if self.on_node is not None and held:
            self.on_node(node, held, class_name)
        for child in ast.iter_child_nodes(node):
            self._visit(child, held, class_name)


# ---------------------------------------------------------------------------
# rule: lock-order-inversion (project-scoped)
# ---------------------------------------------------------------------------

def rule_lock_order_inversion(mods: Sequence[ModuleInfo],
                              ctx: CheckContext) -> List[Finding]:
    """Cycles in the acquisition graph. Edges come from two sources:
    syntactic nesting (``with a:`` containing ``with b:``) and — via
    the interprocedural acquires-locks summaries — calls made while a
    lock is held into functions that (transitively) acquire another
    lock: ``with a: self._refill()`` where ``_refill`` takes ``b`` is
    an a→b edge even though no ``with b:`` is lexically in sight."""
    edges: Dict[str, Set[str]] = {}
    sites: Dict[Tuple[str, str], Tuple[str, int, int]] = {}
    proj = ctx.project

    def add_edge(src: str, dst: str, path: str, line: int,
                 col: int) -> None:
        if src == dst:
            return
        edges.setdefault(src, set()).add(dst)
        sites.setdefault((src, dst), (path, line, col))

    for mod in mods:
        def on_edge(src: str, dst: str, expr: ast.AST,
                    _mod: ModuleInfo = mod) -> None:
            add_edge(src, dst, _mod.path, expr.lineno, expr.col_offset)

        def on_node(node: ast.AST, held: List[str],
                    class_name: Optional[str],
                    _mod: ModuleInfo = mod) -> None:
            if proj is None or not isinstance(node, ast.Call):
                return
            qname, _ = proj.resolve_call(_mod, class_name, node.func)
            callee = proj.functions.get(qname or "")
            if callee is None:
                return
            for acq in callee.acquires:
                for prior in held:
                    add_edge(prior, acq, _mod.path, node.lineno,
                             node.col_offset)

        _WithScopeWalker(mod, on_edge=on_edge, on_node=on_node).run()

    nodes = set(edges) | {d for ds in edges.values() for d in ds}
    findings: List[Finding] = []
    for scc in strongly_connected(nodes, edges):
        if len(scc) < 2:
            continue
        internal = sorted(
            ((src, dst) for src in scc
             for dst in edges.get(src, ()) if dst in scc))
        edge_desc = "; ".join(
            f"{src} → {dst} at "
            f"{sites[(src, dst)][0]}:{sites[(src, dst)][1]}"
            for src, dst in internal)
        anchor = min(sites[e] for e in internal)
        findings.append(Finding(
            "lock-order-inversion", anchor[0], anchor[1], anchor[2],
            f"cyclic lock acquisition order between "
            f"{', '.join(sorted(scc))}: {edge_desc} — two threads "
            f"interleaving these paths deadlock; pick one global "
            f"order (or merge the critical sections)"))
    return findings


# ---------------------------------------------------------------------------
# rule: blocking-under-lock
# ---------------------------------------------------------------------------

def _storage_chain(resolved: Optional[str]) -> bool:
    if not resolved:
        return False
    # a Capitalized tail is a class constructor (data.storage.Model),
    # not an I/O call — building the record doesn't touch the backend
    if resolved.split(".")[-1][:1].isupper():
        return False
    return any(seg in ("storage", "_storage")
               for seg in resolved.split("."))


def blocking_reason(mod: ModuleInfo, node: ast.Call) -> Optional[str]:
    """Why this call blocks, or None — the shared predicate behind the
    direct rule and the interprocedural blocks summaries
    (:class:`~.core.ProjectIndex`)."""
    resolved = mod.resolve(node.func)
    if resolved in BLOCKING_EXACT:
        return BLOCKING_EXACT[resolved]
    if resolved:
        for prefix, reason in BLOCKING_PREFIXES:
            if resolved.startswith(prefix):
                return reason
        if is_kernel_launcher(resolved):
            return (f"`{resolved.rsplit('.', 1)[-1]}` launches a kernel on "
                    f"the card (and builds it with nvcc on the first call) "
                    f"with the lock held")
        if _storage_chain(resolved):
            return ("storage/event-store I/O under a lock serializes "
                    "every waiter on the backend")
    if isinstance(node.func, ast.Attribute):
        attr = node.func.attr
        bare = not node.args and not node.keywords
        if (attr in _TENSOR_SYNC_ATTRS and bare) or attr == "urlopen" \
                or (attr == "join" and bare) \
                or attr in ("wait", "result"):
            return BLOCKING_METHOD_ATTRS.get(
                attr, "blocking call while a lock is held")
    return None


def rule_blocking_under_lock(mod: ModuleInfo,
                             ctx: CheckContext) -> List[Finding]:
    if not _in_serving_stack(mod.path):
        return []
    findings: List[Finding] = []
    seen: Set[int] = set()
    proj = ctx.project

    def on_node(node: ast.AST, held: List[str],
                class_name: Optional[str]) -> None:
        if not isinstance(node, ast.Call) or id(node) in seen:
            return
        seen.add(id(node))
        why = blocking_reason(mod, node)
        if why is not None:
            findings.append(Finding(
                "blocking-under-lock", mod.path, node.lineno,
                node.col_offset,
                f"blocking call while holding {'/'.join(held)}: {why}; "
                f"snapshot state under the lock and do the slow work "
                f"outside it"))
            return
        # interprocedural: the blocking call hides inside a helper —
        # report the held-lock call site with the chain to the direct
        # blocking site
        if proj is None:
            return
        qname, _ = proj.resolve_call(mod, class_name, node.func)
        callee = proj.functions.get(qname or "")
        if callee is None or callee.effects["blocking"] is None:
            return
        hops = proj.chain(callee, "blocking")
        if not hops:
            return
        findings.append(Finding(
            "blocking-under-lock", mod.path, node.lineno,
            node.col_offset,
            f"calling `{short_name(callee.qname)}` while holding "
            f"{'/'.join(held)} transitively blocks: "
            f"{chain_text(hops)}; snapshot state under the lock and "
            f"do the slow work outside it (or pragma the helper's "
            f"blocking site if it is the blessed shape)",
            related=chain_related(hops)))

    _WithScopeWalker(mod, on_node=on_node).run()
    return findings


# ---------------------------------------------------------------------------
# rule: callback-under-lock
# ---------------------------------------------------------------------------

def _function_scopes(tree: ast.Module):
    """Top-level-ish functions (module funcs + class methods), each
    with its dynamically-bound local names: parameters, loop targets,
    and plain assignments — excluding nested ``def``/lambda bindings
    (those bodies are statically known, not foreign callbacks)."""
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        static_names: Set[str] = set()
        dynamic: Set[str] = set()
        a = node.args
        for p in (*a.posonlyargs, *a.args, *a.kwonlyargs):
            dynamic.add(p.arg)
        for sub in ast.walk(node):
            if sub is node:
                continue
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                static_names.add(sub.name)
            elif isinstance(sub, ast.Assign):
                for t in sub.targets:
                    if isinstance(t, ast.Name):
                        if isinstance(sub.value, ast.Lambda):
                            static_names.add(t.id)
                        else:
                            dynamic.add(t.id)
            elif isinstance(sub, (ast.For, ast.AsyncFor)):
                for n in ast.walk(sub.target):
                    if isinstance(n, ast.Name):
                        dynamic.add(n.id)
            elif isinstance(sub, ast.withitem) \
                    and sub.optional_vars is not None:
                for n in ast.walk(sub.optional_vars):
                    if isinstance(n, ast.Name):
                        dynamic.add(n.id)
        yield node, dynamic - static_names


def rule_callback_under_lock(mod: ModuleInfo,
                             ctx: CheckContext) -> List[Finding]:
    findings: List[Finding] = []
    seen: Set[int] = set()

    proj = ctx.project
    owners: Dict[int, str] = {}
    for cls in ast.walk(mod.tree):
        if isinstance(cls, ast.ClassDef):
            for sub in cls.body:
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    owners[id(sub)] = cls.name

    # walk per function scope so each scope's dynamically-bound names
    # are in force; _WithScopeWalker supplies the held-lock context
    for fn, dynamic in _function_scopes(mod.tree):

        def on_node(node: ast.AST, held: List[str],
                    class_name: Optional[str],
                    _dynamic: Set[str] = dynamic) -> None:
            if not isinstance(node, ast.Call) or id(node) in seen:
                return
            if isinstance(node.func, ast.Name) \
                    and node.func.id in _dynamic:
                seen.add(id(node))
                findings.append(Finding(
                    "callback-under-lock", mod.path, node.lineno,
                    node.col_offset,
                    f"`{node.func.id}(…)` invokes a dynamically-bound "
                    f"callable while holding {'/'.join(held)}; the "
                    f"callee can re-enter and deadlock — snapshot "
                    f"under the lock, call outside it (the "
                    f"invalidation-bus publish pattern)"))
                return
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in CALLBACK_ATTRS:
                seen.add(id(node))
                findings.append(Finding(
                    "callback-under-lock", mod.path, node.lineno,
                    node.col_offset,
                    f"`.{node.func.attr}(…)` delivers to subscribers/"
                    f"plugins while holding {'/'.join(held)}; a "
                    f"subscriber that takes the same lock (or "
                    f"publishes back) deadlocks — move the delivery "
                    f"outside the critical section"))
                return
            if proj is None:
                return
            # interprocedural: (a) the delivery hides inside a helper;
            # (b) a dynamically-bound callable is PASSED into a helper
            # that invokes its argument — either way the foreign code
            # runs with this lock held
            qname, bound = proj.resolve_call(mod, class_name,
                                             node.func)
            callee = proj.functions.get(qname or "")
            if callee is None:
                return
            if callee.effects["callback"] is not None:
                hops = proj.chain(callee, "callback")
                if hops:
                    seen.add(id(node))
                    findings.append(Finding(
                        "callback-under-lock", mod.path, node.lineno,
                        node.col_offset,
                        f"calling `{short_name(callee.qname)}` while "
                        f"holding {'/'.join(held)} transitively "
                        f"delivers to subscribers/plugins: "
                        f"{chain_text(hops)}; snapshot under the "
                        f"lock, deliver outside it",
                        related=chain_related(hops)))
                    return
            if not callee.call_sinks:
                return
            off = 1 if bound else 0
            for i, a in enumerate(node.args):
                pos = i + off
                passed_dynamic = (
                    (isinstance(a, ast.Name) and a.id in _dynamic)
                    or isinstance(a, ast.Lambda))
                if passed_dynamic and pos in callee.call_sinks:
                    seen.add(id(node))
                    hops = proj.sink_chain(callee, "call", pos)
                    findings.append(Finding(
                        "callback-under-lock", mod.path, node.lineno,
                        node.col_offset,
                        f"passing a dynamically-bound callable into "
                        f"`{short_name(callee.qname)}` while holding "
                        f"{'/'.join(held)} — the helper invokes it "
                        f"with the lock held: {chain_text(hops)}; "
                        f"snapshot under the lock, call outside it",
                        related=chain_related(hops)))
                    return

        walker = _WithScopeWalker(mod, on_node=on_node)
        # held state starts fresh inside fn (function boundaries reset
        # acquisition context); the owning class rides along so
        # self-method calls resolve in the project index
        walker._visit_block([fn], [], owners.get(id(fn)))
    return findings
