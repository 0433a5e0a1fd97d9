"""The rule registry behind the port's ``check`` (the port of
``predictionio_tpu/analysis/rules.py``).

:data:`RULES` assembles ``host-sync-in-hot-path`` and
``unbounded-retry`` (here), the concurrency family (:mod:`.concurrency`:
``unguarded-shared-state``, ``lock-order-inversion``,
``blocking-under-lock``, ``callback-under-lock``), the lifecycle family
(:mod:`.lifecycle`: ``leaked-thread``, ``missing-timeout``,
``non-atomic-persist``, ``unbounded-queue``, ``hot-spin-loop``),
``metric-catalog-drift`` (:mod:`.metrics_catalog`),
``smem-overbudget`` (:mod:`.kernels`, the counterpart of the JAX
package's ``vmem-overbudget`` over ``csrc/``), the kernel-safety
rules (:mod:`.kernel_safety`: ``dma-unwaited``,
``low-precision-accumulator`` and ``missing-interpret-fallback``, the
JAX package's Pallas rules read against ``csrc/`` and the ``ops/``
wrappers) and the numerics family (:mod:`.numerics`:
``low-precision-reduction``, ``dequant-outside-funnel``,
``quantize-without-parity-gate``, ``unguarded-domain``,
``requant-torn-pair``, the JAX package's rules with torch's reductions,
casts and domain ops in place of ``jnp``'s).

- ``host-sync-in-hot-path`` — device→host landings inside functions of
  the hot packages (``server/``, ``ops/``), directly or through any
  helper call chain (reported at the hot call site with the chain in
  the message). Each waits for the card: on the query path one stray
  sync caps throughput at the round-trip rate. The JAX package's
  spellings, beside the port's:

  ==============================  ========================================
  JAX package                     the port
  ==============================  ========================================
  ``np.asarray``                  kept
  ``np.ascontiguousarray``        kept
  ``jax.device_get``              no torch spelling; its work is
                                  ``.cpu()``, ``.to("cpu")`` and
                                  ``.numpy()``
  ``.item()``                     kept (``Tensor.item``)
  ``.tolist()``                   kept (``Tensor.tolist``)
  ``.block_until_ready()``        no torch spelling; its work is
                                  ``torch.cuda.synchronize``,
                                  ``Event.synchronize`` and
                                  ``Stream.synchronize``
  ``float(jnp…)``, ``int(jnp…)``  ``float(torch…)``, ``int(torch…)``
  ==============================  ========================================

- ``unbounded-retry`` — swallow-and-continue loops in ``server/``,
  ``streaming/`` or ``storage/`` with no max-attempts bound and no
  pacing.

Not ported, as ``ROADMAP.md`` decided (rules about JAX programs):
``recompile-hazard`` and ``missing-donation``; the sharding family
(``sharding-mismatch``, ``implicit-reshard``,
``shard-map-spec-mismatch``, ``unsharded-capture``,
``missing-donation-sharded``), ``materialized-gather`` and
``config-drift``. The sharding family reads ``shard_map`` specs,
closures over sharded arrays and jit donation: the port's ``sharded`` /
``shard_map_compat`` have no caller, and torch has no donation, so its
rules would have no site to read. The moves they would guess at are
counted at run time instead: ``audit-hlo`` (:mod:`.hlo_audit`) records
every collective call and every op that joins blocks of two mesh
positions outside one.

Every rule obeys the ``# ptpu: allow[rule] — justification`` pragma
(see :mod:`.core`).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Set

from .core import (
    CheckContext,
    Finding,
    ModuleInfo,
    chain_related,
    chain_text,
    short_name,
)

RuleFn = Callable[[ModuleInfo, CheckContext], List[Finding]]


@dataclass(frozen=True)
class Rule:
    name: str
    description: str
    fn: RuleFn
    #: project-scoped rules run ONCE over the whole parsed module set
    #: (cross-file facts like the lock-order graph); their ``fn`` takes
    #: ``(mods: List[ModuleInfo], ctx)`` instead of one module
    project: bool = False


# ---------------------------------------------------------------------------
# rule 1: host-sync-in-hot-path
# ---------------------------------------------------------------------------

#: directories whose function bodies are considered hot (serving/query
#: and device-op code; module level runs once at import and is exempt)
HOT_DIR_PARTS = {"server", "ops"}

HOST_SYNC_CALLS = {
    "numpy.asarray": "np.asarray on a device value copies device→host "
                     "synchronously",
    "numpy.ascontiguousarray": "np.ascontiguousarray forces a host "
                               "copy (and a second one if the first "
                               "landing was non-contiguous)",
    "torch.cuda.synchronize": "torch.cuda.synchronize stalls the caller "
                              "until the card has run every queued "
                              "kernel",
}

HOST_SYNC_METHODS = {
    "item": ".item() synchronously pulls a scalar off the device",
    "tolist": ".tolist() copies the whole array to host Python objects",
    "cpu": ".cpu() copies the tensor device→host synchronously",
    "numpy": ".numpy() lands the tensor in a host array",
    "synchronize": ".synchronize() stalls the caller until the event's "
                   "or stream's work on the card completes",
}


def _in_hot_path(path: str) -> bool:
    parts = path.split("/")
    return bool(set(parts[:-1]) & HOT_DIR_PARTS)


def host_sync_reason(mod: ModuleInfo, node: ast.Call) -> Optional[str]:
    """Why this call is a device→host sync, or None — the shared
    predicate behind the direct rule and the interprocedural effect
    summaries (:class:`~.core.ProjectIndex`)."""
    name = mod.resolve(node.func)
    if name in HOST_SYNC_CALLS:
        return HOST_SYNC_CALLS[name]
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in HOST_SYNC_METHODS \
            and not node.args and not node.keywords:
        return HOST_SYNC_METHODS[node.func.attr]
    if isinstance(node.func, ast.Attribute) and node.func.attr == "to" \
            and _names_cpu(mod, node):
        return ('.to("cpu") copies the tensor device→host '
                'synchronously')
    if name in ("float", "int") and len(node.args) == 1 \
            and isinstance(node.args[0], ast.Call):
        inner = mod.resolve(node.args[0].func)
        if inner and inner.startswith("torch."):
            return (f"{name}() on a torch result forces a blocking "
                    f"device→host scalar read")
    return None


def _names_cpu(mod: ModuleInfo, node: ast.Call) -> bool:
    """``.to("cpu")``, ``.to(device="cpu")`` or
    ``.to(torch.device("cpu"))``."""
    args = list(node.args[:1]) + [kw.value for kw in node.keywords
                                  if kw.arg == "device"]
    for a in args:
        if isinstance(a, ast.Call) and a.args \
                and mod.resolve(a.func) == "torch.device":
            a = a.args[0]
        if isinstance(a, ast.Constant) and a.value == "cpu":
            return True
    return False


def rule_host_sync(mods: Sequence[ModuleInfo],
                   ctx: CheckContext) -> List[Finding]:
    """Project-scoped: direct syncs inside hot-package functions, plus
    — through the call graph — hot-path calls into helpers (anywhere
    in the project) that transitively sync, reported at the hot call
    site with the chain down to the direct site. Helpers living in hot
    packages are skipped here: their bodies already get the direct
    finding."""
    findings: List[Finding] = []
    for mod in mods:
        if not _in_hot_path(mod.path):
            continue
        seen: Set[int] = set()
        funcs = [n for n in ast.walk(mod.tree)
                 if isinstance(n, (ast.FunctionDef,
                                   ast.AsyncFunctionDef))]
        for fn in funcs:
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call) or id(node) in seen:
                    continue
                seen.add(id(node))
                why = host_sync_reason(mod, node)
                if why is not None:
                    findings.append(Finding(
                        "host-sync-in-hot-path", mod.path, node.lineno,
                        node.col_offset,
                        f"{why} (in hot function `{fn.name}`); keep "
                        f"the hot path device-resident or pragma with "
                        f"justification"))
    proj = ctx.project
    if proj is None:
        return findings
    for fninfo in proj.functions.values():
        if not fninfo.hot(HOT_DIR_PARTS):
            continue
        for call in fninfo.calls:
            callee = proj.functions.get(call.callee or "")
            if callee is None or callee.hot(HOT_DIR_PARTS):
                continue
            if callee.effects["host_sync"] is None:
                continue
            hops = proj.chain(callee, "host_sync")
            if not hops:
                continue
            findings.append(Finding(
                "host-sync-in-hot-path", fninfo.mod.path, call.line,
                call.col,
                f"calling `{short_name(callee.qname)}` from hot "
                f"function `{short_name(fninfo.qname)}` transitively "
                f"syncs device→host: {chain_text(hops)}; keep the hot "
                f"path device-resident, or pragma the blessed helper "
                f"at its direct site",
                related=chain_related(hops)))
    return findings


# ---------------------------------------------------------------------------
# rule: unbounded-retry
# ---------------------------------------------------------------------------

#: directories whose loops talk to failable dependencies: a
#: swallow-and-continue loop here is a wedged-daemon generator
RETRY_SCOPE_PARTS = {"server", "streaming", "storage"}

#: attribute calls that pace (block/sleep) or bound a loop iteration —
#: their presence anywhere in the loop body means the retry is not a
#: hot spin; ``*_nowait`` variants deliberately do NOT count
_PACING_ATTRS = {"sleep", "wait", "get", "join", "acquire", "select",
                 "accept", "recv", "poll"}
_PACING_NAMES = {"time.sleep", "select.select"}
#: the shared bounded-backoff helpers (utils/retrying.py)
_PACING_SUFFIXES = ("retry_call", "backoff_delays")


def _walk_same_scope(node):
    """Walk a loop body without descending into nested function
    definitions (their loops are judged where they are defined)."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            continue
        yield child
        yield from _walk_same_scope(child)


def _loop_unbounded(mod: ModuleInfo, node: ast.AST) -> bool:
    if isinstance(node, ast.While):
        t = node.test
        return isinstance(t, ast.Constant) and bool(t.value)
    if isinstance(node, ast.For):
        it = node.iter
        return isinstance(it, ast.Call) \
            and mod.resolve(it.func) == "itertools.count"
    return False


def _is_pacing_call(mod: ModuleInfo, call: ast.Call) -> bool:
    name = mod.resolve(call.func) or ""
    if name in _PACING_NAMES or name.endswith(_PACING_SUFFIXES):
        return True
    if isinstance(call.func, ast.Attribute):
        attr = call.func.attr
        return attr in _PACING_ATTRS and not attr.endswith("_nowait")
    return False


def rule_unbounded_retry(mod: ModuleInfo,
                         ctx: CheckContext) -> List[Finding]:
    """``while True`` (or ``itertools.count``) loops in server/,
    streaming/, or storage/ code that swallow exceptions and loop again
    with NO max-attempts bound and NO pacing call (sleep / blocking
    wait / the shared retry helpers): a failing dependency turns such a
    loop into a hot spin or a silently wedged daemon. Bound it with
    ``utils.retrying.retry_call`` (bounded exponential backoff) or add
    explicit pacing."""
    parts = set(mod.path.split("/")[:-1])
    if not parts & RETRY_SCOPE_PARTS:
        return []
    findings: List[Finding] = []
    for loop in ast.walk(mod.tree):
        if not isinstance(loop, (ast.While, ast.For)) \
                or not _loop_unbounded(mod, loop):
            continue
        body_nodes = [n for stmt in loop.body
                      for n in [stmt, *_walk_same_scope(stmt)]]
        swallows = None
        for n in body_nodes:
            if not isinstance(n, ast.Try):
                continue
            for handler in n.handlers:
                escapes = any(isinstance(h, (ast.Raise, ast.Return,
                                             ast.Break))
                              for stmt in handler.body
                              for h in [stmt, *_walk_same_scope(stmt)])
                if not escapes:
                    swallows = handler
                    break
            if swallows is not None:
                break
        if swallows is None:
            continue
        paced = any(isinstance(n, ast.Call) and _is_pacing_call(mod, n)
                    for n in body_nodes)
        if paced:
            continue
        findings.append(Finding(
            "unbounded-retry", mod.path, swallows.lineno,
            swallows.col_offset,
            "unbounded retry: this loop swallows the exception and "
            "re-runs with no max-attempts bound and no backoff/pacing "
            "— a failing dependency becomes a hot spin or a wedged "
            "daemon; bound it with utils.retrying.retry_call (bounded "
            "exponential backoff) or add explicit pacing"))
    return findings


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

from .concurrency import (  # noqa: E402 — registry assembly
    rule_blocking_under_lock,
    rule_callback_under_lock,
    rule_lock_order_inversion,
    rule_unguarded_shared_state,
)
from .kernel_safety import (  # noqa: E402 — registry assembly
    rule_dma_unwaited,
    rule_low_precision_accumulator,
    rule_missing_interpret_fallback,
)
from .kernels import rule_smem_overbudget  # noqa: E402
from .lifecycle import (  # noqa: E402 — registry assembly
    rule_hot_spin_loop,
    rule_leaked_thread,
    rule_missing_timeout,
    rule_non_atomic_persist,
    rule_unbounded_queue,
)
from .metrics_catalog import (  # noqa: E402 — registry assembly
    rule_metric_catalog_drift,
)
from .numerics import (  # noqa: E402 — registry assembly
    rule_dequant_outside_funnel,
    rule_low_precision_reduction,
    rule_quantize_without_parity_gate,
    rule_requant_torn_pair,
    rule_unguarded_domain,
)

RULES: Dict[str, Rule] = {r.name: r for r in (
    Rule("host-sync-in-hot-path",
         "device→host sync (np.asarray/.item()/.tolist()/.cpu()/"
         ".numpy()/.to('cpu')/synchronize) inside server/ or ops/ "
         "functions, directly or through any helper call chain",
         rule_host_sync, project=True),
    Rule("unbounded-retry",
         "swallow-and-continue retry loops in server/, streaming/, or "
         "storage/ code with no max-attempts bound and no "
         "backoff/pacing (route through utils/retrying.py)",
         rule_unbounded_retry),
    Rule("smem-overbudget",
         "a kernel whose dynamic shared memory (ops/smem.py, over every "
         "point its launcher accepts) passes the card's opt-in limit "
         "unrefused, or a csrc/ launch past 48 KB with no "
         "cudaFuncAttributeMaxDynamicSharedMemorySize opt-in",
         rule_smem_overbudget, project=True),
    Rule("dma-unwaited",
         "a cp.async or TMA (cp.async.bulk) copy in a csrc/ kernel with "
         "no cp.async.wait_group / wait_all or mbarrier wait after it "
         "before the kernel ends, followed through helper calls",
         rule_dma_unwaited, project=True),
    Rule("low-precision-accumulator",
         "a __half / __nv_bfloat16 variable or shared array accumulated "
         "into (+=, read-modify-write, __hadd/__hfma chains), or an "
         "mma.sync / wgmma / WMMA accumulator of f16 or bf16, in csrc/",
         rule_low_precision_accumulator, project=True),
    Rule("missing-interpret-fallback",
         "an ops/ launcher whose CUDA branch can return before its "
         "kernel launches (off the plain branch, or from an except "
         "handler), or a csrc/ export taking a stream that no ops/ "
         "wrapper names: a CUDA tensor reaching neither a kernel nor a "
         "refusal",
         rule_missing_interpret_fallback, project=True),
    Rule("unguarded-shared-state",
         "reads/writes of a class's lock-guarded attributes outside "
         "the lock (honors # ptpu: guarded-by[lock])",
         rule_unguarded_shared_state),
    Rule("lock-order-inversion",
         "cycles in the cross-file static lock-acquisition graph "
         "built from nested with-lock scopes",
         rule_lock_order_inversion, project=True),
    Rule("blocking-under-lock",
         "device dispatch, HTTP/storage I/O, sleep, join/wait/result "
         "inside a held-lock region in server/, cache/, or rollout/",
         rule_blocking_under_lock),
    Rule("callback-under-lock",
         "bus/plugin callbacks invoked while holding the publisher's "
         "lock (re-entrancy deadlock)",
         rule_callback_under_lock),
    Rule("metric-catalog-drift",
         "pio_* families registered in code but missing from the "
         "docs/observability.md catalog, or documented but never "
         "emitted (both directions)",
         rule_metric_catalog_drift, project=True),
    Rule("leaked-thread",
         "threading.Thread with a looping target started in server/, "
         "fleet/, router/, streaming/, or rollout/ code whose handle "
         "is never joined — in the spawning function, the owning "
         "class, or through a call-graph join helper",
         rule_leaked_thread, project=True),
    Rule("missing-timeout",
         "urlopen/HTTPConnection/create_connection with no explicit "
         "timeout reachable from fleet/, router/, data/, or storage/ "
         "code — directly or through any helper chain (a wedged peer "
         "freezes the scrape/control tick forever)",
         rule_missing_timeout, project=True),
    Rule("non-atomic-persist",
         "durable state (baselines, gates, registries, artifacts) "
         "written with a plain open(path, 'w') outside the temp-file+"
         "fsync+os.replace funnel — a crash mid-write tears the file",
         rule_non_atomic_persist),
    Rule("unbounded-queue",
         "queue.Queue()/collections.deque() constructed without a "
         "bound on serving/streaming paths — backlog becomes an OOM "
         "instead of backpressure under overload",
         rule_unbounded_queue),
    Rule("hot-spin-loop",
         "while-True daemon loops in server/, streaming/, fleet/, "
         "router/, rollout/, or slo/ code with neither a stop-event "
         "check nor a pacing/blocking call — pins a core and ignores "
         "shutdown (complements unbounded-retry)",
         rule_hot_spin_loop),
    Rule("low-precision-reduction",
         "sum/mean/prod/matmul/mm/bmm/einsum/dot/@ over bf16/f16 "
         "operands with no dtype=torch.float32 and no upcast first, in "
         "models/, ops/, streaming/ — directly or through a helper "
         "chain whose leaf reduction trusts its caller's dtype",
         rule_low_precision_reduction, project=True),
    Rule("dequant-outside-funnel",
         "f32 upcast (.float()/.to(torch.float32)/.type(...)) of "
         "int8/bf16 or QuantizedFactors.data values outside "
         "dequantize_table / table_host_f32 / _host_row_f32 — a full-"
         "precision table copy forfeits the quantized-serving HBM win",
         rule_dequant_outside_funnel),
    Rule("quantize-without-parity-gate",
         "QuantizedFactors(...) / _quantize_rows(...) outside "
         "quantize_serving_model's NDCG@10 parity probe (and the "
         "apply_row_updates / extend_factor_rows requantize seams)",
         rule_quantize_without_parity_gate),
    Rule("unguarded-domain",
         "log/sqrt/rsqrt/division on tensor or accumulated values with "
         "no eps/clamp/maximum/where guard, branch test, or "
         "bumped-counter proof",
         rule_unguarded_domain),
    Rule("requant-torn-pair",
         "QuantizedFactors.data written (attribute or "
         "dataclasses.replace) without the paired scale update — rows "
         "dequantize through stale per-row scales",
         rule_requant_torn_pair),
)}
