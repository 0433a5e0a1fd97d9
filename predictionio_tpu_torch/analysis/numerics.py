"""The numerics rule family of ``check`` (the port of
``predictionio_tpu/analysis/numerics.py``): a dtype lattice over the
quantized stack, read in torch's idiom.

The port serves int8 and bf16 row-quantized tables, shadows the fixed
table in bf16 for the fold-in's gathers, and keeps every accumulator in
f32. These rules hold those contracts at the tensor level and at the
quantization seams, on the interprocedural engine of :mod:`.core` (each
function's *low-precision sinks* propagate through the call graph like
every other effect):

- ``low-precision-reduction`` — ``torch.sum`` / ``mean`` / ``prod`` /
  ``matmul`` / ``mm`` / ``bmm`` / ``einsum`` / ``dot``, ``@`` and the
  ``.sum()`` / ``.mean()`` / ``.prod()`` / ``.dot()`` methods over bf16 or
  f16 operands with no ``dtype=torch.float32`` and no upcast first
  (``.float()``, ``.double()``, ``.to(torch.float32)``,
  ``.to(dtype=...)``), in ``models/``, ``ops/`` and ``streaming/``. The
  reduction may sit N helpers away: a function that reduces a
  *parameter* at operand precision exports a sink on that position, and
  a caller passing a known bf16 value is flagged at its own call site
  with the chain in the message.
- ``dequant-outside-funnel`` — an f32 (or f64) upcast (``.float()``,
  ``.double()``, ``.to(torch.float32)``, ``.type(torch.float32)``,
  numpy's ``.astype(np.float32)``) of an int8 or bf16 value or of a
  ``QuantizedFactors.data`` leaf anywhere but the funnels
  (``dequantize_table``, ``table_host_f32``, ``_host_row_f32``,
  ``_dequant*``), in ``models/``, ``ops/``, ``streaming/`` and
  ``server/``. Such a copy forfeits the bytes the quantized table saved.
- ``quantize-without-parity-gate`` — ``QuantizedFactors(...)`` or
  ``_quantize_rows(...)`` outside ``quantize_serving_model``'s NDCG@10
  probe and the two seams that requantize under its decision
  (``apply_row_updates``, ``extend_factor_rows``); a constructor whose
  ``quant`` reads an existing table's ``.quant`` is a copy, not a new
  quantization.
- ``unguarded-domain`` — ``torch.log`` / ``log2`` / ``log10`` / ``sqrt``
  / ``rsqrt`` (and the tensor methods, and numpy's and ``math``'s) and
  ``/`` with no guard. Accepted guards: ``torch.clamp``, ``clamp_min``,
  ``torch.maximum``, ``torch.where``, ``max(x, eps)``, ``+ eps``, a
  branch test on the same value, and a counter bumped before the divide;
  a guard holds through ``.to(dev)`` and ``.float()``, and a ``pathlib``
  join (``root / f"lib{name}.so"``) is no division.
- ``requant-torn-pair`` — a write of ``QuantizedFactors.data`` without
  its ``.scale``, by attribute or through ``dataclasses.replace``.

All five obey ``# ptpu: allow[rule] — justification``; a pragma at a
reduction's direct site also stops its sink from propagating (blessing
the helper blesses its callers). Their runtime complement is
``audit-numerics`` (:mod:`.numerics_audit`), a dtype census of the
port's entry points under a ``TorchDispatchMode``.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .core import (
    CheckContext,
    Finding,
    ModuleInfo,
    Witness,
    chain_related,
    chain_text,
)

NUMERICS_RULES = (
    "low-precision-reduction",
    "dequant-outside-funnel",
    "quantize-without-parity-gate",
    "unguarded-domain",
    "requant-torn-pair",
)

#: directories the precision rules patrol — where quantized tables and
#: reductions live; utility and storage code stays unbothered
_HOT_DIRS = {"models", "ops", "streaming"}
_DEQUANT_DIRS = {"models", "ops", "streaming", "server"}

_LOW = {"bfloat16", "float16"}
_WIDE = {"float32", "float64"}
_QUANT = {"int8", "bfloat16", "float16"}

_DTYPE_TOKENS = {
    "bfloat16", "float16", "float32", "float64", "int8", "int16",
    "int32", "int64", "uint8", "uint16", "uint32", "float8_e4m3fn",
    "float8_e5m2",
}
#: torch's other names for the same dtypes
_DTYPE_ALIASES = {"half": "float16", "float": "float32",
                  "double": "float64"}

#: tensor methods that ARE a cast: ``x.float()`` is ``x.to(float32)``
_CAST_METHODS = {"float": "float32", "double": "float64",
                 "half": "float16", "bfloat16": "bfloat16"}

#: creation callees whose ``dtype=`` kwarg types the result
_CREATION = {"zeros", "ones", "full", "empty", "array", "asarray",
             "arange", "zeros_like", "ones_like", "full_like",
             "empty_like", "tensor", "as_tensor", "rand", "randn"}

#: dtype-preserving wrappers `_param_source` sees through
_PRESERVE_METHODS = {"reshape", "view", "transpose", "permute", "t",
                     "contiguous", "flatten", "ravel", "squeeze",
                     "unsqueeze", "clone", "detach", "copy", "conj",
                     "expand", "narrow", "cpu", "cuda"}
_PRESERVE_CALLS = {"reshape", "transpose", "asarray", "as_tensor",
                   "ravel", "flatten", "squeeze", "unsqueeze",
                   "expand_dims", "broadcast_to", "pad", "atleast_2d",
                   "ascontiguousarray", "permute"}

#: reduction callees → positional operand slots that set the
#: accumulation dtype (einsum is special-cased: operands follow the
#: subscript string)
_REDUCE_CALLS: Dict[str, Tuple[int, ...]] = {
    "torch.sum": (0,), "torch.mean": (0,), "torch.prod": (0,),
    "torch.matmul": (0, 1), "torch.mm": (0, 1), "torch.bmm": (0, 1),
    "torch.dot": (0, 1), "torch.inner": (0, 1),
    "torch.tensordot": (0, 1),
    "numpy.sum": (0,), "numpy.mean": (0,), "numpy.dot": (0, 1),
    "numpy.matmul": (0, 1), "numpy.tensordot": (0, 1),
}
_REDUCE_METHODS = {"sum", "mean", "prod", "dot"}

#: unary ops with a restricted domain (operand must be > 0 / >= 0)
_DOMAIN_CALLS = {
    "torch.log", "torch.log2", "torch.log10", "torch.sqrt",
    "torch.rsqrt",
    "numpy.log", "numpy.log2", "numpy.log10", "numpy.sqrt",
    "math.log", "math.log2", "math.log10", "math.sqrt",
}
_DOMAIN_METHODS = {"log", "log2", "log10", "sqrt", "rsqrt"}

#: called on the operand of a domain op / a divisor, these make the
#: value safe: positive-clamped, shifted, or branch-selected
_GUARD_TEXT = ("maximum(", "max(", "clip(", "clamp(", "clamp_min(",
               "where(", "errstate", "abs(", "> 0", ">= 1", "!= 0")

_DEQUANT_FUNNELS = {"dequantize_table", "table_host_f32",
                    "_host_row_f32"}
_PARITY_FUNNELS = {"quantize_serving_model", "apply_row_updates",
                   "extend_factor_rows", "_quantize_rows"}

_EPS_NAME = re.compile(r"(^|_)(eps|epsilon)\w*$")

#: tensor methods that move or cast a value and keep its sign: a guard
#: on ``n`` still holds on ``n.to(dev)`` or ``n.float()``
_VALUE_PRESERVING = {"to", "float", "double", "cpu", "cuda", "detach",
                     "clone", "contiguous", "item"}


# ---------------------------------------------------------------------------
# local helpers (the JAX package keeps these in its sharding module, which
# the port does not have)
# ---------------------------------------------------------------------------

class _Assigns:
    """Name → value-expression chains over (module constants, one
    function's simple assignments)."""

    def __init__(self, mod: ModuleInfo, fn: Optional[ast.AST] = None):
        self.table: Dict[str, ast.AST] = {}
        for node in mod.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                self.table[node.targets[0].id] = node.value
        if fn is not None:
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) \
                        and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    self.table[node.targets[0].id] = node.value

    def follow(self, node: ast.AST, depth: int = 0) -> ast.AST:
        while isinstance(node, ast.Name) and depth < 8:
            tgt = self.table.get(node.id)
            if tgt is None or tgt is node:
                break
            node = tgt
            depth += 1
        return node


def _function_nodes(mod: ModuleInfo
                    ) -> List[Tuple[Optional[str], ast.AST]]:
    out: List[Tuple[Optional[str], ast.AST]] = []
    for node in mod.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append((None, node))
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    out.append((node.name, sub))
    return out


# ---------------------------------------------------------------------------
# cheap per-module text gates (memoized on ModuleInfo)
# ---------------------------------------------------------------------------

def _mentions_lowprec(mod: ModuleInfo) -> bool:
    cached = getattr(mod, "_lowprec_hint", None)
    if cached is None:
        src = mod.source
        cached = ("bfloat16" in src or "float16" in src
                  or ".half()" in src)
        mod._lowprec_hint = cached
    return cached


def _mentions_reduction(mod: ModuleInfo) -> bool:
    cached = getattr(mod, "_reduce_hint", None)
    if cached is None:
        src = mod.source
        cached = any(t in src for t in (
            "einsum(", ".sum(", ".mean(", ".prod(", ".dot(", "matmul",
            " @ ", "tensordot", ".mm(", ".bmm(", "torch.sum",
            "torch.mean"))
        mod._reduce_hint = cached
    return cached


def _in_dirs(mod: ModuleInfo, dirs: Set[str]) -> bool:
    return bool(set(mod.path.split("/")[:-1]) & dirs)


# ---------------------------------------------------------------------------
# dtype lattice: literal dtype inference over one function's locals
# ---------------------------------------------------------------------------

def _dtype_token(mod: ModuleInfo, assigns: _Assigns,
                 node: ast.AST) -> Optional[str]:
    """``torch.bfloat16`` / ``torch.half`` / ``np.float32`` /
    ``"bfloat16"`` → the canonical dtype string of a dtype expression,
    or None when it cannot be pinned."""
    node = assigns.follow(node)
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value if node.value in _DTYPE_TOKENS else None
    resolved = mod.resolve(node) or ""
    last = resolved.rsplit(".", 1)[-1]
    if last in _DTYPE_TOKENS:
        return last
    if resolved.startswith("torch.") and last in _DTYPE_ALIASES:
        return _DTYPE_ALIASES[last]
    return None


def _cast_target(mod: ModuleInfo, assigns: _Assigns,
                 call: ast.Call) -> Optional[str]:
    """The dtype a cast call produces: ``x.float()``, ``x.half()``,
    ``x.to(D)`` / ``x.to(dev, D)`` / ``x.to(dtype=D)``, ``x.type(D)``,
    ``x.astype(D)``; None when the call is no cast (or its target
    cannot be pinned)."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    if f.attr in _CAST_METHODS and not call.args and not call.keywords:
        return _CAST_METHODS[f.attr]
    if f.attr in ("astype", "type") and call.args:
        return _dtype_token(mod, assigns, call.args[0])
    if f.attr == "to":
        for kw in call.keywords:
            if kw.arg == "dtype":
                return _dtype_token(mod, assigns, kw.value)
        for a in call.args:
            dt = _dtype_token(mod, assigns, a)
            if dt is not None:
                return dt
    return None


def _expr_dtype(mod: ModuleInfo, assigns: _Assigns, node: ast.AST,
                dmap: Optional[Dict[str, Tuple[str, int]]] = None,
                depth: int = 0) -> Optional[str]:
    """Best-effort dtype of a value expression: casts, creation calls
    with ``dtype=D``, and names followed through the local assignment
    map."""
    if depth > 6:
        return None
    if isinstance(node, ast.Name) and dmap and node.id in dmap:
        return dmap[node.id][0]
    node = assigns.follow(node)
    if isinstance(node, ast.Name) and dmap and node.id in dmap:
        return dmap[node.id][0]
    if isinstance(node, ast.IfExp):
        # `t.to(torch.bfloat16) if cond else t`: the conditional
        # gather-shadow idiom — if EITHER branch is low precision the
        # value may be, and the reduction may be lossy
        for branch in (node.body, node.orelse):
            dt = _expr_dtype(mod, assigns, branch, dmap, depth + 1)
            if dt in _LOW:
                return dt
        return None
    if not isinstance(node, ast.Call):
        return None
    cast = _cast_target(mod, assigns, node)
    if cast is not None:
        return cast
    resolved = mod.resolve(node.func) or ""
    last = resolved.rsplit(".", 1)[-1]
    if last in _CREATION:
        for kw in node.keywords:
            if kw.arg == "dtype":
                return _dtype_token(mod, assigns, kw.value)
        if resolved.startswith("numpy.") \
                and last in ("zeros", "ones", "empty") \
                and len(node.args) >= 2:
            return _dtype_token(mod, assigns, node.args[1])
    return None


def local_dtype_map(mod: ModuleInfo, fn: ast.AST
                    ) -> Dict[str, Tuple[str, int]]:
    """Variable → (dtype, line) facts inside one function, from
    ``x = y.to(torch.bfloat16)`` and dtype'd creation calls — memoized
    per function (two rules and the sink collector read it)."""
    memo = getattr(mod, "_dtype_maps", None)
    if memo is None:
        memo = mod._dtype_maps = {}
    cached = memo.get(id(fn))
    if cached is not None:
        return cached
    assigns = _Assigns(mod, fn)
    out: Dict[str, Tuple[str, int]] = {}
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        dt = _expr_dtype(mod, assigns, node.value, out)
        if dt is not None:
            out[node.targets[0].id] = (dt, node.lineno)
    memo[id(fn)] = out
    return out


# ---------------------------------------------------------------------------
# reductions: direct sites + interprocedural dtype sinks
# ---------------------------------------------------------------------------

def _widened(mod: ModuleInfo, assigns: _Assigns,
             call: ast.Call) -> bool:
    """An explicit wide accumulator on the call: an f32 / f64
    ``dtype=`` (``torch.sum(x, dtype=torch.float32)``)."""
    for kw in call.keywords:
        if kw.arg in ("dtype", "acc_dtype"):
            if _dtype_token(mod, assigns, kw.value) in _WIDE:
                return True
    return False


def _reduction_operands(mod: ModuleInfo, assigns: _Assigns,
                        node: ast.AST
                        ) -> Iterable[Tuple[ast.AST, str]]:
    """(operand expression, human description) pairs for a reduction
    site that accumulates at operand precision (nothing yielded when
    the call already declares a wide accumulator)."""
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
        yield node.left, "`@` matmul"
        yield node.right, "`@` matmul"
        return
    if not isinstance(node, ast.Call):
        return
    if _widened(mod, assigns, node):
        return
    f = node.func
    resolved = mod.resolve(f) or ""
    if resolved in _REDUCE_CALLS:
        short = resolved.rsplit(".", 1)[-1]
        for pos in _REDUCE_CALLS[resolved]:
            if pos < len(node.args):
                yield node.args[pos], f"`{short}`"
        return
    if resolved.rsplit(".", 1)[-1] == "einsum" and len(node.args) > 1:
        for a in node.args[1:]:
            yield a, "`einsum`"
        return
    if isinstance(f, ast.Attribute) and f.attr in _REDUCE_METHODS \
            and not isinstance(f.value, ast.Constant) \
            and not resolved.startswith(("numpy.", "torch.", "math.")):
        yield f.value, f"`.{f.attr}()`"
        if f.attr == "dot" and node.args:
            yield node.args[0], "`.dot()`"


def _param_source(mod: ModuleInfo, assigns: _Assigns,
                  params: List[str], node: ast.AST,
                  depth: int = 0) -> Optional[int]:
    """Parameter position an expression derives from through
    dtype-PRESERVING wrappers (subscript, view/reshape/transpose,
    ``.T``, ``.to(device)``). A cast breaks the chain — an upcast at
    the call site is the fix, not a finding."""
    if depth > 6:
        return None
    node = assigns.follow(node)
    if isinstance(node, ast.Name):
        return params.index(node.id) if node.id in params else None
    if isinstance(node, ast.Subscript):
        return _param_source(mod, assigns, params, node.value,
                             depth + 1)
    if isinstance(node, ast.Attribute) and node.attr in ("T", "mT"):
        return _param_source(mod, assigns, params, node.value,
                             depth + 1)
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and (
                f.attr in _PRESERVE_METHODS
                or (f.attr == "to"
                    and _cast_target(mod, assigns, node) is None)):
            return _param_source(mod, assigns, params, f.value,
                                 depth + 1)
        resolved = mod.resolve(f) or ""
        if resolved.rsplit(".", 1)[-1] in _PRESERVE_CALLS \
                and node.args \
                and not any(kw.arg == "dtype" for kw in node.keywords):
            return _param_source(mod, assigns, params, node.args[0],
                                 depth + 1)
    return None


def collect_lowprec_sinks(fn_info) -> Dict[int, Witness]:
    """Parameter position → witness for params this function reduces
    at operand precision (no f32 ``dtype=`` / upcast): the direct sites
    of ``low-precision-reduction``. A pragma at the reduction kills the
    sink — blessing the helper blesses callers. Collected by
    :meth:`~.core.ProjectIndex._collect_direct` and propagated through
    the call graph like every other effect."""
    mod: ModuleInfo = fn_info.mod
    params: List[str] = fn_info.params
    if not params or not _mentions_reduction(mod):
        return {}
    assigns = _Assigns(mod, fn_info.node)
    out: Dict[int, Witness] = {}
    for node in ast.walk(fn_info.node):
        for operand, desc in _reduction_operands(mod, assigns, node):
            pos = _param_source(mod, assigns, params, operand)
            if pos is None or pos in out:
                continue
            if mod.suppressed(Finding("low-precision-reduction",
                                      mod.path, node.lineno, 0, "")):
                continue
            out[pos] = Witness(
                "low-precision-reduction", mod.path, node.lineno,
                node.col_offset,
                f"{desc} reduces `{params[pos]}` at operand precision "
                f"(no f32 dtype= / upcast)")
    return out


def rule_low_precision_reduction(mods: Sequence[ModuleInfo],
                                 ctx: CheckContext) -> List[Finding]:
    """A reduction over bf16/f16 operands accumulating at operand
    precision — directly, or through any helper chain whose leaf
    reduction trusts its caller's dtype. bf16's 8-bit mantissa makes
    long sums lossy; the port's contract is an f32 accumulator (the
    kernels' and the plain versions' alike)."""
    proj = ctx.project
    findings: List[Finding] = []
    for mod in mods:
        if not _in_dirs(mod, _HOT_DIRS) or not _mentions_lowprec(mod):
            continue
        for cls, fn in _function_nodes(mod):
            assigns = _Assigns(mod, fn)
            dmap = local_dtype_map(mod, fn)
            for node in ast.walk(fn):
                # direct: reducing a known-low-precision value
                hit = False
                for operand, desc in _reduction_operands(mod, assigns,
                                                         node):
                    dt = _expr_dtype(mod, assigns, operand, dmap)
                    if dt not in _LOW:
                        continue
                    findings.append(Finding(
                        "low-precision-reduction", mod.path,
                        node.lineno, node.col_offset,
                        f"{desc} over {dt} operands accumulates in "
                        f"{dt}: an 8-bit mantissa loses the low bits "
                        f"of every long sum — declare the accumulator "
                        f"wide (dtype=torch.float32) or upcast the "
                        f"operand first (.float())"))
                    hit = True
                    break
                if hit or not isinstance(node, ast.Call) \
                        or proj is None:
                    continue
                # interprocedural: a known-low value passed into a
                # helper that (transitively) reduces that position
                qname, bound = proj.resolve_call(mod, cls, node.func)
                callee = proj.functions.get(qname or "")
                if callee is None or not callee.lowprec_sinks:
                    continue
                off = 1 if bound else 0
                for i, a in enumerate(node.args):
                    dt = _expr_dtype(mod, assigns, a, dmap)
                    if dt not in _LOW:
                        continue
                    pos = i + off
                    if pos not in callee.lowprec_sinks:
                        continue
                    hops = proj.sink_chain(callee, "lowprec", pos)
                    findings.append(Finding(
                        "low-precision-reduction", mod.path,
                        node.lineno, node.col_offset,
                        f"this {dt} argument reaches a reduction that "
                        f"accumulates at operand precision: "
                        f"{chain_text(hops)} — widen the accumulator "
                        f"at the direct site (dtype=torch.float32) or "
                        f"upcast before the call",
                        related=chain_related(hops)))
                    break
    return findings


# ---------------------------------------------------------------------------
# rule: dequant-outside-funnel
# ---------------------------------------------------------------------------

def _module_level_name(mod: ModuleInfo, node: ast.AST) -> str:
    """For a site at module level (outside any def): the Assign target
    name whose statement contains it, so module-level ``_dequant_*``
    lambdas bless themselves."""
    for stmt in mod.tree.body:
        if isinstance(stmt, ast.Assign) \
                and stmt.lineno <= node.lineno <= (stmt.end_lineno
                                                   or stmt.lineno) \
                and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            return stmt.targets[0].id
    return ""


def _mentions_upcast(mod: ModuleInfo) -> bool:
    src = mod.source
    return any(t in src for t in (".float(", ".double(", ".to(",
                                  ".type(", "astype"))


def rule_dequant_outside_funnel(mod: ModuleInfo,
                                ctx: CheckContext) -> List[Finding]:
    """f32 materialization of quantized table data outside the
    funnels — one stray ``.float()`` keeps a full-precision copy of a
    table that was quantized precisely so it would not exist."""
    if not _in_dirs(mod, _DEQUANT_DIRS) or not _mentions_upcast(mod):
        return []
    findings: List[Finding] = []
    covered: Set[int] = set()

    def scan(owner: str, scope: ast.AST,
             dmap: Dict[str, Tuple[str, int]],
             assigns: _Assigns) -> None:
        blessed = owner in _DEQUANT_FUNNELS \
            or owner.startswith("_dequant")
        for node in ast.walk(scope):
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)) \
                    and scope is mod.tree:
                continue  # handled with its own owner
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            if id(node) in covered:
                continue
            covered.add(id(node))
            if _cast_target(mod, assigns, node) not in _WIDE:
                continue
            recv = node.func.value
            seg = ast.get_source_segment(mod.source, recv) or ""
            followed = assigns.follow(recv)
            fseg = ast.get_source_segment(mod.source, followed) or ""
            quantized = (".data" in seg or ".data" in fseg
                         or _expr_dtype(mod, assigns, recv,
                                        dmap) in _QUANT)
            if not quantized:
                continue
            site_owner = owner or _module_level_name(mod, node)
            if site_owner in _DEQUANT_FUNNELS \
                    or site_owner.startswith("_dequant") or blessed:
                continue
            findings.append(Finding(
                "dequant-outside-funnel", mod.path, node.lineno,
                node.col_offset,
                "f32 materialization of quantized table data outside "
                "the funnels: this builds a full-precision copy of a "
                "table quantized to avoid exactly that — route through "
                "dequantize_table / table_host_f32 / _host_row_f32, or "
                "upcast inside the kernel after the load"))

    for _, fn in _function_nodes(mod):
        scan(fn.name, fn, local_dtype_map(mod, fn), _Assigns(mod, fn))
    scan("", mod.tree, {}, _Assigns(mod))
    return findings


# ---------------------------------------------------------------------------
# rule: quantize-without-parity-gate
# ---------------------------------------------------------------------------

def _copies_quant(node: ast.Call) -> bool:
    """The ``quant`` slot (3rd positional / ``quant=``) reads some
    existing table's ``.quant`` attribute."""
    exprs: List[ast.AST] = []
    if len(node.args) >= 3:
        exprs.append(node.args[2])
    exprs += [kw.value for kw in node.keywords if kw.arg == "quant"]
    return any(isinstance(e, ast.Attribute) and e.attr == "quant"
               for e in exprs)


def rule_quantize_without_parity_gate(mod: ModuleInfo,
                                      ctx: CheckContext
                                      ) -> List[Finding]:
    """Raw construction of quantized serving tables —
    ``QuantizedFactors(...)`` or ``_quantize_rows(...)`` — outside the
    parity-gated path. ``quantize_serving_model`` probes NDCG@10
    against the f32 tables and falls back below the floor; a raw
    construction skips the probe and can ship a table that scores
    garbage."""
    if "QuantizedFactors" not in mod.source \
            and "_quantize_rows" not in mod.source:
        return []
    findings: List[Finding] = []
    for cls, fn in _function_nodes(mod):
        if fn.name in _PARITY_FUNNELS or cls == "QuantizedFactors":
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            resolved = mod.resolve(node.func) or ""
            last = resolved.rsplit(".", 1)[-1]
            if last not in ("QuantizedFactors", "_quantize_rows"):
                continue
            if last == "QuantizedFactors" and _copies_quant(node):
                # copy-constructor signature: quant= carries an
                # EXISTING table's `.quant` — a residency move
                # propagating an already-gated decision, not a fresh
                # quantization
                continue
            findings.append(Finding(
                "quantize-without-parity-gate", mod.path, node.lineno,
                node.col_offset,
                f"`{last}` constructs a quantized serving table "
                f"outside the parity gate — route through "
                f"quantize_serving_model (NDCG@10 probe + auto "
                f"fallback below SERVING_QUANT_NDCG_FLOOR) so a "
                f"quality regression falls back to f32 instead of "
                f"shipping"))
    return findings


# ---------------------------------------------------------------------------
# rule: unguarded-domain
# ---------------------------------------------------------------------------

_WORD = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def _src(mod: ModuleInfo, node: ast.AST) -> str:
    return ast.get_source_segment(mod.source, node) or ""


def _int_params(fn: ast.AST) -> Set[str]:
    """Params statically annotated ``int`` — shape/config scalars, not
    tensor values."""
    out: Set[str] = set()
    a = fn.args
    for p in (*a.posonlyargs, *a.args, *a.kwonlyargs):
        ann = p.annotation
        if isinstance(ann, ast.Name) and ann.id == "int":
            out.add(p.arg)
    return out


def _literal_defaults(fn: ast.AST) -> Set[str]:
    """Params whose default is a positive numeric literal (the
    ``lam: float = 1.0`` Laplace-smoothing idiom)."""
    out: Set[str] = set()
    a = fn.args
    pos = [*a.posonlyargs, *a.args]
    for p, d in zip(pos[len(pos) - len(a.defaults):], a.defaults):
        if isinstance(d, ast.Constant) \
                and isinstance(d.value, (int, float)) and d.value > 0:
            out.add(p.arg)
    for p, d in zip(a.kwonlyargs, a.kw_defaults):
        if isinstance(d, ast.Constant) \
                and isinstance(d.value, (int, float)) and d.value > 0:
            out.add(p.arg)
    return out


class _DomainScope:
    """Per-function context for the guard battery: conditional test
    texts (``if``/ternary/``while``/``assert``), ``+=``'d counters,
    int-annotated params, positive-literal defaults."""

    def __init__(self, mod: ModuleInfo, fn: ast.AST,
                 assigns: _Assigns):
        self.mod = mod
        self.assigns = assigns
        self.tests: List[str] = []
        self.bumped: Set[str] = set()
        self.int_params = _int_params(fn)
        self.pos_defaults = _literal_defaults(fn)
        for node in ast.walk(fn):
            if isinstance(node, (ast.If, ast.IfExp, ast.While,
                                 ast.Assert)):
                self.tests.append(_src(mod, node.test))
            elif isinstance(node, ast.AugAssign) \
                    and isinstance(node.op, ast.Add) \
                    and isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, (int, float)) \
                    and node.value.value > 0:
                self.bumped.add(_src(mod, node.target))

    def tested(self, text: str) -> bool:
        """Some conditional in the function mentions this expression
        (or one of its identifier tokens, word-bounded) — the
        ``if ideal else 0.0`` / early-return-guard family."""
        if not text:
            return False
        tokens = set(_WORD.findall(text)) - {
            "torch", "np", "math", "numpy"}
        for t in self.tests:
            if text in t:
                return True
            for tok in tokens:
                if re.search(rf"\b{re.escape(tok)}\b", t):
                    return True
        return False


def _static_positive(mod: ModuleInfo, scope: _DomainScope,
                     node: ast.AST, depth: int = 0) -> bool:
    """Positive before anything runs: numeric literals, arithmetic over
    them, int-annotated params through ``float()``/``int()``, names
    followed to any of those."""
    if depth > 6:
        return False
    node = scope.assigns.follow(node)
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float)) \
            and not isinstance(node.value, bool) and node.value > 0
    if isinstance(node, ast.Name):
        return node.id in scope.int_params \
            or node.id in scope.pos_defaults
    if isinstance(node, ast.BinOp) \
            and isinstance(node.op, (ast.Mult, ast.Add, ast.Pow)):
        return _static_positive(mod, scope, node.left, depth + 1) \
            and _static_positive(mod, scope, node.right, depth + 1)
    if isinstance(node, ast.Call):
        resolved = mod.resolve(node.func) or ""
        last = resolved.rsplit(".", 1)[-1]
        if last in ("float", "int") and node.args:
            return _static_positive(mod, scope, node.args[0],
                                    depth + 1)
        if last == "exp":
            return True  # e^x > 0 always
    return False


def _domain_guarded(mod: ModuleInfo, scope: _DomainScope,
                    node: ast.AST, depth: int = 0) -> bool:
    """The guard battery for one operand/divisor."""
    if depth > 4:
        return False
    if _static_positive(mod, scope, node):
        return True
    followed = scope.assigns.follow(node)
    for probe in (node, followed):
        seg = _src(mod, probe)
        if seg and any(g in seg for g in _GUARD_TEXT):
            return True
        if isinstance(probe, (ast.Constant, ast.JoinedStr)):
            return True  # non-numeric constant: not our domain
    if scope.tested(_src(mod, node)) \
            or scope.tested(_src(mod, followed)):
        return True
    seg = _src(mod, node)
    if seg in scope.bumped or _src(mod, followed) in scope.bumped:
        return True
    if isinstance(followed, ast.BinOp) \
            and isinstance(followed.op, ast.Add):
        # `x + eps` shift: either side a positive literal / eps name
        for side in (followed.left, followed.right):
            s = scope.assigns.follow(side)
            if _static_positive(mod, scope, s):
                return True
            if isinstance(side, ast.Name) \
                    and _EPS_NAME.search(side.id):
                return True
    if isinstance(followed, ast.Call) \
            and isinstance(followed.func, ast.Attribute) \
            and followed.func.attr in _VALUE_PRESERVING \
            and not (mod.resolve(followed.func) or "").startswith(
                ("torch.", "numpy.", "math.")):
        # `n.to(dev)`, `n.float()`: the receiver's guard carries over
        return _domain_guarded(mod, scope, followed.func.value,
                               depth + 1)
    if isinstance(followed, ast.Call):
        resolved = mod.resolve(followed.func) or ""
        last = resolved.rsplit(".", 1)[-1]
        if last in ("exp", "float", "int", "len", "abs") \
                and (last == "exp" or not followed.args
                     or _domain_guarded(mod, scope,
                                        followed.args[0], depth + 1)
                     or scope.tested(_src(mod, followed))):
            # len()/abs()/float() of something itself guarded or
            # tested; exp() is positive unconditionally
            if last == "exp":
                return True
            if last in ("float", "int") and followed.args \
                    and _static_positive(mod, scope,
                                         followed.args[0]):
                return True
            if scope.tested(_src(mod, node)) \
                    or scope.tested(_src(mod, followed)):
                return True
        if last in ("log", "log2", "log10", "sqrt") and followed.args:
            # log/sqrt of a shifted/guarded argument is bounded away
            # from the pole for the shifted-index idiom
            # (`1 / log2(i + 2)`)
            return _domain_guarded(mod, scope, followed.args[0],
                                   depth + 1)
    return False


def _domain_operand(mod: ModuleInfo, node: ast.Call
                    ) -> Optional[Tuple[ast.AST, str]]:
    """(operand, short name) of a domain op: ``torch.log(x)`` and its
    numpy / math spellings, or the ``x.log()`` / ``x.sqrt()`` /
    ``x.rsqrt()`` tensor methods."""
    resolved = mod.resolve(node.func) or ""
    if resolved in _DOMAIN_CALLS:
        if not node.args:
            return None
        return node.args[0], resolved.rsplit(".", 1)[-1]
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in _DOMAIN_METHODS \
            and not node.args and not node.keywords \
            and not resolved.startswith(("numpy.", "torch.", "math.")):
        return f.value, f".{f.attr}()"
    return None


def _path_joins(fn: ast.AST) -> Set[int]:
    """``pathlib`` joins: a ``/`` whose right side is a string, and every
    ``/`` on the left spine of such a chain (``root / digest / f"x"``)
    — not arithmetic."""
    out: Set[int] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div) \
                and (isinstance(node.right, ast.JoinedStr)
                     or (isinstance(node.right, ast.Constant)
                         and isinstance(node.right.value, str))):
            cur: ast.AST = node
            while isinstance(cur, ast.BinOp) \
                    and isinstance(cur.op, ast.Div):
                out.add(id(cur))
                cur = cur.left
    return out


def rule_unguarded_domain(mod: ModuleInfo,
                          ctx: CheckContext) -> List[Finding]:
    """``log``/``sqrt``/``rsqrt``/division applied to tensor or
    accumulated values without an epsilon/clamp guard. NaN/Inf born
    here propagates through every downstream op and surfaces as
    garbage scores long after the cause — guard at the source
    (``max(x, 1e-9)``, ``torch.clamp(x, min=eps)``, ``clamp_min``,
    ``torch.maximum``, ``+ eps``, or a ``where``)."""
    if not _in_dirs(mod, _HOT_DIRS):
        return []
    findings: List[Finding] = []
    for _, fn in _function_nodes(mod):
        assigns = _Assigns(mod, fn)
        scope = _DomainScope(mod, fn, assigns)
        joins = _path_joins(fn)
        for node in ast.walk(fn):
            if isinstance(node, ast.BinOp) \
                    and isinstance(node.op, ast.Div):
                if id(node) in joins \
                        or _domain_guarded(mod, scope, node.right):
                    continue
                findings.append(Finding(
                    "unguarded-domain", mod.path, node.lineno,
                    node.col_offset,
                    f"division by `{_src(mod, node.right)}` with no "
                    f"zero guard — a zero divisor mints NaN/Inf that "
                    f"propagates silently; guard the divisor "
                    f"(max(x, 1e-9), x.clamp_min(eps), or + eps)"))
            elif isinstance(node, ast.Call):
                hit = _domain_operand(mod, node)
                if hit is None:
                    continue
                operand, short = hit
                if _domain_guarded(mod, scope, operand):
                    continue
                findings.append(Finding(
                    "unguarded-domain", mod.path, node.lineno,
                    node.col_offset,
                    f"`{short}` of `{_src(mod, operand)}` with no "
                    f"domain guard — negative/zero input mints "
                    f"NaN/-Inf; clamp first (torch.clamp(x, min=eps), "
                    f"torch.maximum, or an explicit branch)"))
    return findings


# ---------------------------------------------------------------------------
# rule: requant-torn-pair
# ---------------------------------------------------------------------------

def _quantish_names(mod: ModuleInfo, fn: ast.AST) -> Set[str]:
    """Names this function can prove hold a ``QuantizedFactors``:
    annotated params, construction assignments, isinstance checks."""
    names: Set[str] = set()
    a = fn.args
    for p in (*a.posonlyargs, *a.args, *a.kwonlyargs):
        ann = p.annotation
        if ann is not None \
                and (mod.resolve(ann) or "").rsplit(".", 1)[-1] \
                == "QuantizedFactors":
            names.add(p.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Call) \
                and (mod.resolve(node.value.func) or "").rsplit(
                    ".", 1)[-1] == "QuantizedFactors":
            names.add(node.targets[0].id)
        if isinstance(node, ast.Call) \
                and (mod.resolve(node.func) or "").rsplit(
                    ".", 1)[-1] == "isinstance" \
                and len(node.args) == 2 \
                and isinstance(node.args[0], ast.Name) \
                and (mod.resolve(node.args[1]) or "").rsplit(
                    ".", 1)[-1] == "QuantizedFactors":
            names.add(node.args[0].id)
    return names


def rule_requant_torn_pair(mod: ModuleInfo,
                           ctx: CheckContext) -> List[Finding]:
    """A write to ``QuantizedFactors.data`` without the paired
    ``scale`` update — attribute assignment or
    ``dataclasses.replace(…, data=…)`` missing ``scale=``. int8 rows
    dequantize as ``data * scale``; a torn pair serves every affected
    row through a stale per-row scale (silently wrong scores, no
    crash). ``apply_row_updates`` is the seam: it re-quantizes rows and
    swaps data and scale together."""
    if "QuantizedFactors" not in mod.source:
        return []
    findings: List[Finding] = []
    for _, fn in _function_nodes(mod):
        quantish = _quantish_names(mod, fn)
        if not quantish:
            continue
        scale_written: Set[str] = set()
        data_writes: List[Tuple[str, ast.AST]] = []
        for node in ast.walk(fn):
            targets: List[ast.expr] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AugAssign):
                targets = [node.target]
            for t in targets:
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id in quantish:
                    if t.attr == "scale":
                        scale_written.add(t.value.id)
                    elif t.attr == "data":
                        data_writes.append((t.value.id, node))
            if isinstance(node, ast.Call) \
                    and (mod.resolve(node.func) or "").rsplit(
                        ".", 1)[-1] == "replace" \
                    and node.args \
                    and isinstance(node.args[0], ast.Name) \
                    and node.args[0].id in quantish:
                kws = {kw.arg for kw in node.keywords}
                if "data" in kws and "scale" not in kws:
                    findings.append(Finding(
                        "requant-torn-pair", mod.path, node.lineno,
                        node.col_offset,
                        f"replace(…, data=…) on "
                        f"`{node.args[0].id}` without the paired "
                        f"scale= — new int8 rows dequantize through "
                        f"STALE per-row scales; re-quantize and swap "
                        f"data+scale together "
                        f"(apply_row_updates is the seam)"))
        for name, node in data_writes:
            if name in scale_written:
                continue
            findings.append(Finding(
                "requant-torn-pair", mod.path, node.lineno,
                node.col_offset,
                f"`{name}.data` written without the paired "
                f"`{name}.scale` update — rows dequantize as "
                f"data * scale, so a torn pair serves silently wrong "
                f"scores; swap both leaves together "
                f"(apply_row_updates is the seam)"))
    return findings


__all__ = [
    "NUMERICS_RULES",
    "collect_lowprec_sinks",
    "local_dtype_map",
    "rule_dequant_outside_funnel",
    "rule_low_precision_reduction",
    "rule_quantize_without_parity_gate",
    "rule_requant_torn_pair",
    "rule_unguarded_domain",
]
