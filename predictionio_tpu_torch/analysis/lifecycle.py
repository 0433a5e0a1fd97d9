"""Resource-lifecycle rule family (the port of
``predictionio_tpu/analysis/lifecycle.py``).

The port runs continuously-running control loops — the fleet
aggregator's scrape loop, the router's replica lifecycle and
autoscaler, the stream trainer, the rollout gate — where a leaked
thread, an un-timed-out HTTP call, or a torn state-file write becomes a
wedged autoscaler or a replica that never drains. This family rides the
interprocedural engine (:class:`~.core.ProjectIndex`):

- ``leaked-thread`` — a ``threading.Thread`` whose target runs an
  unbounded (or stop-event) loop, started in ``server/`` / ``fleet/`` /
  ``router/`` / ``streaming/`` / ``rollout/`` code, with no reachable
  ``join`` for the handle. Joins are resolved through the class (any
  method joining the storing attribute, including via locals and
  ``for t in self._threads`` iteration) and through the call graph (a
  helper that joins its parameter blesses every caller passing the
  handle). One-shot targets (warm-ups, delayed shutdowns) terminate on
  their own and are exempt by construction. ``# ptpu:
  allow[leaked-thread]`` marks intentional process-lifetime daemons.
- ``missing-timeout`` — ``urllib.request.urlopen`` /
  ``http.client.HTTP(S)Connection`` / ``socket.create_connection``
  without an explicit timeout, reachable from ``fleet/`` / ``router/``
  / ``data/`` (storage) code. The hang that freezes a scrape or a
  control tick may sit N helpers away: a timeout-less net call exports
  a ``net_wait`` effect summary, and an in-scope caller of the helper
  is flagged at its own call site with the chain in the message.
- ``non-atomic-persist`` — durable state (baselines, release/registry/
  gate files, cursors) written with a plain ``open(path, "w")`` outside
  the temp-file+fsync+rename funnel (the port's is
  ``data/storage/localfs.py::atomic_write``): a crash mid-write tears
  the file and the next boot reads garbage. A function that calls
  ``os.replace``/``os.rename`` itself, writes a ``*.tmp`` staging path,
  or routes through a blessed ``atomic_write*`` helper is clean.
- ``unbounded-queue`` — ``queue.Queue()`` / ``collections.deque()``
  constructed without a bound on serving/streaming paths: backlog is
  the memory leak you only meet under overload.
- ``hot-spin-loop`` — ``while True`` daemon loops with *neither* a
  stop-event check *nor* a pacing/blocking call in the body: a busy
  spin that pins a core and never yields shutdown. Complements
  ``unbounded-retry`` (which needs a swallowed exception to fire).

All five obey ``# ptpu: allow[rule] — justification`` pragmas; a pragma
at a net call's *direct site* also stops the ``net_wait`` effect from
propagating (blessing the helper blesses its callers). Runtime
complement: ``audit-lifecycle`` (:mod:`.lifecycle_audit`) cycles each
subsystem start→serve→stop and ratchets /proc thread/fd/socket leak
counts against ``analysis/lifecycle_baseline.json``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import (
    CheckContext,
    Finding,
    ModuleInfo,
    chain_related,
    chain_text,
    short_name,
)

LIFECYCLE_RULES = (
    "leaked-thread",
    "missing-timeout",
    "non-atomic-persist",
    "unbounded-queue",
    "hot-spin-loop",
)

#: where long-lived worker threads live — servers, fleet control
#: plane, router daemons, streaming trainer, rollout controller
THREAD_SCOPE_PARTS = {"server", "fleet", "router", "streaming",
                      "rollout"}
#: where a hung HTTP call freezes a scrape/control tick or a
#: storage client
NET_SCOPE_PARTS = {"fleet", "router", "data", "storage"}
#: where durable state files are produced (baselines, gates,
#: registries, artifacts, cursors)
PERSIST_SCOPE_PARTS = {"analysis", "slo", "aot", "rollout",
                       "controller", "data", "storage", "streaming"}
#: serving/streaming paths where an unbounded backlog is an OOM
QUEUE_SCOPE_PARTS = {"server", "streaming"}
#: daemon-loop territory for the spin rule
SPIN_SCOPE_PARTS = {"server", "streaming", "fleet", "router",
                    "rollout", "slo"}


def _in_dirs(mod: ModuleInfo, parts: Set[str]) -> bool:
    return bool(set(mod.path.split("/")[:-1]) & parts)


def _same_scope(node: ast.AST):
    """Walk without descending into nested defs/lambdas — their
    lifecycles are judged where they are defined."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            continue
        yield child
        yield from _same_scope(child)


def _body_nodes(fn: ast.AST) -> List[ast.AST]:
    return [n for stmt in fn.body for n in [stmt, *_same_scope(stmt)]]


# ---------------------------------------------------------------------------
# missing-timeout — the net_wait effect (collected by core, like
# host_sync/blocking) plus the scope rule that reports it
# ---------------------------------------------------------------------------

_NET_CALLS = {
    # resolved dotted name → (positional slot of the timeout
    # argument, human label)
    "urllib.request.urlopen": (2, "urlopen"),
    "http.client.HTTPConnection": (2, "HTTPConnection"),
    "http.client.HTTPSConnection": (2, "HTTPSConnection"),
    "socket.create_connection": (1, "create_connection"),
}
_NET_ATTRS = {name.rsplit(".", 1)[-1]: spec
              for name, spec in _NET_CALLS.items()}


def net_wait_reason(mod: ModuleInfo, node: ast.Call) -> Optional[str]:
    """Reason string when ``node`` is a network call with no explicit
    timeout (the ``net_wait`` direct-effect detector, called from
    :meth:`~.core.ProjectIndex._collect_direct`)."""
    resolved = mod.resolve(node.func)
    spec = _NET_CALLS.get(resolved or "")
    if spec is None and isinstance(node.func, ast.Attribute):
        spec = _NET_ATTRS.get(node.func.attr)
    if spec is None:
        return None
    slot, label = spec
    if any(kw.arg == "timeout" for kw in node.keywords):
        return None
    if len(node.args) > slot:
        return None  # timeout passed positionally
    return (f"`{label}(…)` with no timeout — the peer hanging "
            f"hangs this call forever")


def rule_missing_timeout(mods: Sequence[ModuleInfo],
                         ctx: CheckContext) -> List[Finding]:
    """Project-scoped: direct timeout-less net calls inside fleet/
    router/data/storage functions, plus — through the call graph —
    in-scope calls into helpers (anywhere in the project) that
    transitively reach one, reported at the in-scope call site with
    the chain down to the direct site."""
    findings: List[Finding] = []
    for mod in mods:
        if not _in_dirs(mod, NET_SCOPE_PARTS):
            continue
        if "urlopen" not in mod.source \
                and "Connection" not in mod.source \
                and "create_connection" not in mod.source:
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            why = net_wait_reason(mod, node)
            if why is not None:
                findings.append(Finding(
                    "missing-timeout", mod.path, node.lineno,
                    node.col_offset,
                    f"{why}; a wedged peer freezes the scrape/"
                    f"control tick that issued it — pass an explicit "
                    f"timeout"))
    proj = ctx.project
    if proj is None:
        return findings
    for fninfo in proj.functions.values():
        if not fninfo.hot(NET_SCOPE_PARTS):
            continue
        for call in fninfo.calls:
            callee = proj.functions.get(call.callee or "")
            if callee is None or callee.hot(NET_SCOPE_PARTS):
                continue  # in-scope helpers got the direct finding
            if callee.effects["net_wait"] is None:
                continue
            hops = proj.chain(callee, "net_wait")
            if not hops:
                continue
            findings.append(Finding(
                "missing-timeout", fninfo.mod.path, call.line,
                call.col,
                f"calling `{short_name(callee.qname)}` from "
                f"`{short_name(fninfo.qname)}` transitively performs "
                f"a network call with no timeout: "
                f"{chain_text(hops)}; thread a timeout through, or "
                f"pragma the blessed helper at its direct site",
                related=chain_related(hops)))
    return findings


# ---------------------------------------------------------------------------
# leaked-thread
# ---------------------------------------------------------------------------

def _is_thread_ctor(mod: ModuleInfo, node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    resolved = mod.resolve(node.func)
    if resolved == "threading.Thread":
        return True
    return isinstance(node.func, ast.Name) \
        and mod.aliases.get(node.func.id) == "threading.Thread"


def _target_expr(node: ast.Call) -> Optional[ast.AST]:
    for kw in node.keywords:
        if kw.arg == "target":
            return kw.value
    return None


def _is_stoppy_test(test: ast.AST) -> bool:
    """``while not self._stop.is_set()`` / ``while not stop.wait(t)``
    — a stop-event loop: long-running until someone signals it."""
    for n in ast.walk(test):
        if isinstance(n, ast.Call) \
                and isinstance(n.func, ast.Attribute) \
                and n.func.attr in ("is_set", "wait"):
            return True
    return False


def _target_loops_forever(mod: ModuleInfo, target: ast.AST) -> bool:
    """True when the thread target's own body contains an unbounded
    loop (``while True`` / ``itertools.count``) or a stop-event loop —
    either way a thread that outlives its spawner unless joined.
    One-shot targets (no such loop) terminate on their own."""
    for node in _body_nodes(target):
        if isinstance(node, ast.While):
            t = node.test
            if isinstance(t, ast.Constant) and bool(t.value):
                return True
            if _is_stoppy_test(t):
                return True
        if isinstance(node, ast.For) and isinstance(node.iter, ast.Call) \
                and mod.resolve(node.iter.func) == "itertools.count":
            return True
    return False


def _resolve_target_def(mod: ModuleInfo, expr: ast.AST,
                        enclosing_fn: Optional[ast.AST],
                        enclosing_cls: Optional[ast.ClassDef]
                        ) -> Optional[ast.AST]:
    """The FunctionDef a ``target=`` expression names: ``self.method``,
    a module-level def, or a closure defined in the enclosing
    function. Unresolvable targets (bound methods of other objects,
    e.g. ``httpd.serve_forever``) return None — judged one-shot rather
    than guessed at."""
    if isinstance(expr, ast.Attribute) \
            and isinstance(expr.value, ast.Name) \
            and expr.value.id == "self" and enclosing_cls is not None:
        for item in enclosing_cls.body:
            if isinstance(item, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)) \
                    and item.name == expr.attr:
                return item
        return None
    if isinstance(expr, ast.Name):
        if enclosing_fn is not None:
            for node in ast.walk(enclosing_fn):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                        and node.name == expr.id:
                    return node
        for item in mod.tree.body:
            if isinstance(item, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)) \
                    and item.name == expr.id:
                return item
    if isinstance(expr, ast.Lambda):
        return None  # a lambda daemon would be its own finding
    return None


def _attr_roots(env: Dict[str, Set[str]], expr: ast.AST) -> Set[str]:
    """The ``self.<attr>`` tokens an expression can reach: direct
    attribute accesses plus whatever the names in it were bound from
    (the tiny intra-method dataflow that sees through
    ``threads = list(self._threads)``)."""
    roots: Set[str] = set()
    for n in ast.walk(expr):
        if isinstance(n, ast.Attribute) \
                and isinstance(n.value, ast.Name) \
                and n.value.id == "self":
            roots.add(n.attr)
        elif isinstance(n, ast.Name):
            roots |= env.get(n.id, set())
    return roots


def _join_roots_of_method(method: ast.AST) -> Set[str]:
    """Attributes of ``self`` that this method (transitively through
    locals and for-targets) calls ``.join()`` on."""
    env: Dict[str, Set[str]] = {}
    joined: Set[str] = set()
    for node in _body_nodes(method):
        if isinstance(node, ast.Assign):
            roots = _attr_roots(env, node.value)
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    env[tgt.id] = env.get(tgt.id, set()) | roots
        elif isinstance(node, ast.For):
            roots = _attr_roots(env, node.iter)
            # tuple targets get every root (conservative: `for q, ts in
            # ((self._q, self._threads),)` binds both names to both)
            targets = (node.target.elts
                       if isinstance(node.target, ast.Tuple)
                       else [node.target])
            for tgt in targets:
                if isinstance(tgt, ast.Name):
                    env[tgt.id] = env.get(tgt.id, set()) | roots
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "join":
            joined |= _attr_roots(env, node.func.value)
    return joined


def _class_join_roots(cls: ast.ClassDef) -> Set[str]:
    roots: Set[str] = set()
    for item in cls.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            roots |= _join_roots_of_method(item)
    return roots


def _param_joiners(proj) -> Set[Tuple[str, int]]:
    """(qname, param position) pairs whose function joins that
    parameter — the "stop helper" the call graph resolves: a spawner
    passing its thread handle to one of these has a join path."""
    out: Set[Tuple[str, int]] = set()
    for qname, fn in proj.functions.items():
        params = fn.params
        if not params:
            continue
        env: Dict[str, Set[str]] = {p: {p} for p in params}
        for node in _body_nodes(fn.node):
            if isinstance(node, ast.Assign):
                roots = _attr_roots(env, node.value) | {
                    n.id for n in ast.walk(node.value)
                    if isinstance(n, ast.Name) and n.id in env
                }
                roots = {r for r in roots if r in params}
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        env[tgt.id] = env.get(tgt.id, set()) | roots
            elif isinstance(node, ast.For):
                roots = {n.id for n in ast.walk(node.iter)
                         if isinstance(n, ast.Name) and n.id in env}
                hit = set()
                for r in roots:
                    hit |= env.get(r, set())
                if isinstance(node.target, ast.Name):
                    env[node.target.id] = \
                        env.get(node.target.id, set()) | hit | roots
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "join" \
                    and isinstance(node.func.value, ast.Name):
                for p in env.get(node.func.value.id, set()):
                    if p in params:
                        out.add((qname, params.index(p)))
    return out


def _enclosing_maps(mod: ModuleInfo):
    """(node id → enclosing FunctionDef, node id → enclosing ClassDef)
    for every node in the module."""
    fn_of: Dict[int, ast.AST] = {}
    cls_of: Dict[int, ast.ClassDef] = {}

    def visit(node, fn, cls):
        for child in ast.iter_child_nodes(node):
            nfn, ncls = fn, cls
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef, ast.Lambda)):
                nfn = node
            if isinstance(node, ast.ClassDef):
                ncls = node
            fn_of[id(child)] = nfn
            cls_of[id(child)] = ncls
            visit(child, nfn, ncls)

    visit(mod.tree, None, None)
    return fn_of, cls_of


def rule_leaked_thread(mods: Sequence[ModuleInfo],
                       ctx: CheckContext) -> List[Finding]:
    """Project-scoped: daemon-looping threads spawned in server/,
    fleet/, router/, streaming/, or rollout/ code whose handle nobody
    joins — in the spawning function, anywhere in the owning class
    (through locals and list-attr iteration), or through a call-graph
    helper that joins its parameter."""
    proj = ctx.project
    joiners: Set[Tuple[str, int]] = \
        _param_joiners(proj) if proj is not None else set()
    findings: List[Finding] = []
    for mod in mods:
        if not _in_dirs(mod, THREAD_SCOPE_PARTS):
            continue
        if "Thread" not in mod.source:
            continue
        fn_of, cls_of = _enclosing_maps(mod)
        for node in ast.walk(mod.tree):
            if not _is_thread_ctor(mod, node):
                continue
            enclosing_fn = fn_of.get(id(node))
            enclosing_cls = cls_of.get(id(node))
            target = _target_expr(node)
            tdef = _resolve_target_def(mod, target, enclosing_fn,
                                       enclosing_cls) \
                if target is not None else None
            if tdef is None or not _target_loops_forever(mod, tdef):
                continue  # one-shot (or unresolvable): ends on its own
            if _handle_joined(mod, node, enclosing_fn, enclosing_cls,
                              proj, joiners):
                continue
            tname = (target.attr if isinstance(target, ast.Attribute)
                     else getattr(target, "id", "<target>"))
            findings.append(Finding(
                "leaked-thread", mod.path, node.lineno,
                node.col_offset,
                f"thread running looping target `{tname}` is never "
                f"joined — no stop-event + join path reachable from "
                f"the owning class or through any helper: the daemon "
                f"outlives every start→stop cycle (the audit-"
                f"lifecycle leak). Store the handle, signal a stop "
                f"event, and join it in close()/stop(); pragma "
                f"`# ptpu: allow[leaked-thread]` only for intentional "
                f"process-lifetime daemons"))
    return findings


def _handle_joined(mod: ModuleInfo, ctor: ast.Call,
                   enclosing_fn: Optional[ast.AST],
                   enclosing_cls: Optional[ast.ClassDef],
                   proj, joiners: Set[Tuple[str, int]]) -> bool:
    """Is the Thread constructed at ``ctor`` joined anywhere its
    handle flows? Tracks: local var, ``self.<attr>`` stores (direct or
    via local), ``self.<attr>.append``, return (caller's
    responsibility), and handle-passed-to-joiner-helper calls."""
    if enclosing_fn is None:
        return False  # module-level daemon construction
    local: Optional[str] = None
    attrs: Set[str] = set()
    returned = False
    for node in _body_nodes(enclosing_fn):
        if isinstance(node, ast.Assign) and any(
                n is ctor for n in ast.walk(node.value)):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    local = tgt.id
                elif isinstance(tgt, ast.Attribute) \
                        and isinstance(tgt.value, ast.Name) \
                        and tgt.value.id == "self":
                    attrs.add(tgt.attr)
    if local is not None:
        for node in _body_nodes(enclosing_fn):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == local:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute) \
                            and isinstance(tgt.value, ast.Name) \
                            and tgt.value.id == "self":
                        attrs.add(tgt.attr)
            if isinstance(node, ast.Call):
                fnc = node.func
                if isinstance(fnc, ast.Attribute) \
                        and fnc.attr == "join" \
                        and isinstance(fnc.value, ast.Name) \
                        and fnc.value.id == local:
                    return True  # joined in the spawning function
                if isinstance(fnc, ast.Attribute) \
                        and fnc.attr == "append" \
                        and isinstance(fnc.value, ast.Attribute) \
                        and isinstance(fnc.value.value, ast.Name) \
                        and fnc.value.value.id == "self" \
                        and any(isinstance(a, ast.Name)
                                and a.id == local
                                for a in node.args):
                    attrs.add(fnc.value.attr)
                # handle passed to a call-graph joiner helper
                if proj is not None and joiners:
                    arg_pos = [i for i, a in enumerate(node.args)
                               if isinstance(a, ast.Name)
                               and a.id == local]
                    if arg_pos and _calls_joiner(
                            mod, node, arg_pos, proj, joiners,
                            enclosing_cls):
                        return True
            if isinstance(node, ast.Return) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == local:
                returned = True
    # stored-in-list append of the ctor expression itself:
    # self._threads.append(threading.Thread(...))
    for node in _body_nodes(enclosing_fn):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "append" \
                and any(n is ctor for a in node.args
                        for n in ast.walk(a)):
            base = node.func.value
            if isinstance(base, ast.Attribute) \
                    and isinstance(base.value, ast.Name) \
                    and base.value.id == "self":
                attrs.add(base.attr)
    if attrs and enclosing_cls is not None:
        if attrs & _class_join_roots(enclosing_cls):
            return True
    if returned:
        return True  # the caller owns the handle now
    return False


def _calls_joiner(mod: ModuleInfo, call: ast.Call,
                  arg_positions: List[int], proj, joiners,
                  enclosing_cls: Optional[ast.ClassDef]) -> bool:
    cls_name = enclosing_cls.name if enclosing_cls is not None \
        else None
    callee, bound = proj.resolve_call(mod, cls_name, call.func)
    if callee is None:
        return False
    off = 1 if bound else 0
    return any((callee, pos + off) in joiners
               for pos in arg_positions)


# ---------------------------------------------------------------------------
# non-atomic-persist
# ---------------------------------------------------------------------------

_ATOMIC_FUNNELS = ("atomic_write", "atomic_write_text",
                   "atomic_replace", "write_atomic")
#: truncate-rewrite modes only: append-only logs ("a") are a
#: legitimate durable pattern — a crashed appender tears at most the
#: trailing record, which replay detects and truncates (localfs.py's
#: event-log discipline); rewriting in place tears the whole file
_WRITE_MODES = set("wx")


def _open_write_mode(node: ast.Call) -> bool:
    if not (isinstance(node.func, ast.Name)
            and node.func.id == "open"):
        return False
    mode = None
    if len(node.args) > 1:
        mode = node.args[1]
    for kw in node.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if not isinstance(mode, ast.Constant) \
            or not isinstance(mode.value, str):
        return False
    return bool(set(mode.value) & _WRITE_MODES)


def _tmp_staged(node: ast.Call) -> bool:
    """The opened path is visibly a staging file (``…tmp…`` in a name
    or literal): the rename half may live one helper away."""
    path_arg = node.args[0] if node.args else None
    if path_arg is None:
        return False
    for n in ast.walk(path_arg):
        if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                and "tmp" in n.value.lower():
            return True
        if isinstance(n, ast.Name) and "tmp" in n.id.lower():
            return True
        if isinstance(n, ast.Attribute) and "tmp" in n.attr.lower():
            return True
    return False


def rule_non_atomic_persist(mod: ModuleInfo,
                            ctx: CheckContext) -> List[Finding]:
    """Plain ``open(path, "w")`` writes of durable state in analysis/,
    slo/, aot/, rollout/, controller/, data/, storage/, or streaming/
    — outside a function that completes the temp+rename funnel
    (``os.replace``/``os.rename`` in the same function, a ``*tmp*``
    staging path, or a blessed ``atomic_write*`` helper)."""
    if not _in_dirs(mod, PERSIST_SCOPE_PARTS):
        return []
    if "open(" not in mod.source:
        return []
    findings: List[Finding] = []
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        nodes = _body_nodes(fn)
        calls = [n for n in nodes if isinstance(n, ast.Call)]
        atomic = False
        for c in calls:
            resolved = mod.resolve(c.func) or ""
            if resolved in ("os.replace", "os.rename") \
                    or resolved.endswith(_ATOMIC_FUNNELS):
                atomic = True
                break
        if atomic:
            continue
        for c in calls:
            if not _open_write_mode(c) or _tmp_staged(c):
                continue
            findings.append(Finding(
                "non-atomic-persist", mod.path, c.lineno,
                c.col_offset,
                "durable state written in place — a crash mid-write "
                "tears the file and the next reader gets garbage; "
                "write to a temp file, fsync, and os.replace() over "
                "the destination (localfs.atomic_write / "
                "analysis.baseline.atomic_write_text are the blessed "
                "funnels), or pragma with a durability argument"))
    return findings


# ---------------------------------------------------------------------------
# unbounded-queue
# ---------------------------------------------------------------------------

_QUEUE_CTORS = {
    "queue.Queue": "maxsize",
    "queue.LifoQueue": "maxsize",
    "queue.PriorityQueue": "maxsize",
    "collections.deque": "maxlen",
}


def rule_unbounded_queue(mod: ModuleInfo,
                         ctx: CheckContext) -> List[Finding]:
    """Queue/deque construction with no bound (or an explicit 0) on
    serving/streaming paths: producers outrunning a consumer grow it
    without limit, and the overload you bought batching for becomes
    an OOM instead of backpressure."""
    if not _in_dirs(mod, QUEUE_SCOPE_PARTS):
        return []
    if "Queue" not in mod.source and "deque" not in mod.source:
        return []
    findings: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        resolved = mod.resolve(node.func) or ""
        bound_kw = _QUEUE_CTORS.get(resolved)
        if bound_kw is None:
            continue
        bound = node.args[0] if node.args else None
        if resolved == "collections.deque" and len(node.args) > 1:
            bound = node.args[1]
        elif resolved == "collections.deque":
            bound = None
        for kw in node.keywords:
            if kw.arg == bound_kw:
                bound = kw.value
        unbounded = bound is None or (
            isinstance(bound, ast.Constant)
            and (bound.value is None or bound.value == 0))
        if not unbounded:
            continue
        short = resolved.rsplit(".", 1)[-1]
        findings.append(Finding(
            "unbounded-queue", mod.path, node.lineno,
            node.col_offset,
            f"`{short}` constructed without a bound on a serving/"
            f"streaming path — backlog grows without limit under "
            f"overload; pass {bound_kw}= (shed or block at the "
            f"bound), or pragma with the invariant that bounds it"))
    return findings


# ---------------------------------------------------------------------------
# hot-spin-loop
# ---------------------------------------------------------------------------

#: attribute calls that pace (block/sleep) a loop iteration —
#: mirrors unbounded-retry's table; ``*_nowait`` does not count
_PACING_ATTRS = {"sleep", "wait", "get", "join", "acquire", "select",
                 "accept", "recv", "poll", "serve_forever"}
_PACING_NAMES = {"time.sleep", "select.select"}
_PACING_SUFFIXES = ("retry_call", "backoff_delays")


def _paces(mod: ModuleInfo, call: ast.Call) -> bool:
    name = mod.resolve(call.func) or ""
    if name in _PACING_NAMES or name.endswith(_PACING_SUFFIXES):
        return True
    if isinstance(call.func, ast.Attribute):
        attr = call.func.attr
        return attr in _PACING_ATTRS and not attr.endswith("_nowait")
    return False


def _checks_stop(nodes: List[ast.AST]) -> bool:
    return any(isinstance(n, ast.Call)
               and isinstance(n.func, ast.Attribute)
               and n.func.attr == "is_set"
               for n in nodes)


def rule_hot_spin_loop(mod: ModuleInfo,
                       ctx: CheckContext) -> List[Finding]:
    """``while True`` (or ``itertools.count``) daemon loops in
    server/, streaming/, fleet/, router/, rollout/, or slo/ code with
    neither a stop-event check nor a pacing/blocking call in the body:
    a spin that pins a core and a daemon that cannot be shut down.
    Complements ``unbounded-retry``, which only fires on swallowed
    exceptions."""
    if not _in_dirs(mod, SPIN_SCOPE_PARTS):
        return []
    if "while" not in mod.source and "count(" not in mod.source:
        return []
    findings: List[Finding] = []
    for loop in ast.walk(mod.tree):
        unbounded = False
        if isinstance(loop, ast.While):
            t = loop.test
            unbounded = isinstance(t, ast.Constant) and bool(t.value)
        elif isinstance(loop, ast.For):
            unbounded = isinstance(loop.iter, ast.Call) \
                and mod.resolve(loop.iter.func) == "itertools.count"
        if not unbounded:
            continue
        nodes = [n for stmt in loop.body
                 for n in [stmt, *_same_scope(stmt)]]
        if any(isinstance(n, ast.Yield) for n in nodes):
            continue  # generator pump: consumer-paced by pull
        if any(isinstance(n, ast.Try) for n in nodes):
            continue  # retry-shaped loop: unbounded-retry's territory
            # (it judges swallowed exceptions and back-off; one loop
            # must not draw two findings)
        if any(isinstance(n, ast.Call) and _paces(mod, n)
               for n in nodes):
            continue
        if _checks_stop(nodes):
            continue
        findings.append(Finding(
            "hot-spin-loop", mod.path, loop.lineno, loop.col_offset,
            "unbounded loop with neither a stop-event check nor any "
            "pacing/blocking call — it pins a core while idle and "
            "ignores shutdown; block on the work source (queue.get / "
            "event.wait) or check a stop event with a sleep, or "
            "pragma with the bound"))
    return findings
