"""The kernel-safety rules over the port's hand-written kernels: the
counterparts of the JAX package's ``dma-unwaited``,
``low-precision-accumulator`` and ``missing-interpret-fallback``
(``predictionio_tpu/analysis/kernels.py``), which read Pallas programs,
for the CUDA sources under ``csrc/`` and the ``ops/`` wrappers that
launch them.

Scope: a package whose scanned modules include one under ``ops/`` and
that holds a ``csrc/`` directory beside it (the port's layout); the C
rules read its ``*.cu`` and ``*.cuh`` files. Pure text and AST, like
the rest of ``check``: nothing is compiled or run.

- ``dma-unwaited`` — a ``cp.async`` (Ampere's ``cp.async.ca`` /
  ``.cg``) or ``cp.async.bulk`` (TMA) issue in a ``__global__`` or
  ``__device__`` function with no ``cp.async.wait_group``,
  ``cp.async.wait_all``, ``cp.async.bulk.wait_group`` or mbarrier wait
  (``mbarrier.try_wait`` / ``test_wait``) after it before the kernel
  ends. Helpers are followed by name through the call graph: a helper
  that issues (``cp_async16``, ``cp_async_commit``) leaves its caller
  owing a wait, a helper that waits (``cp_async_wait<N>``) pays it, so
  the issue-in-one-helper, drain-in-another idiom matches as the JAX
  rule matches it. A function that still owes a wait at its end is
  reported where nothing calls it (a kernel), at the first issue after
  its last wait: the
  data lands in shared memory while the kernel reads it, or after it
  exits.
- ``low-precision-accumulator`` — a ``__half``, ``half2``,
  ``__nv_bfloat16`` or ``__nv_bfloat162`` variable or shared array that
  is the target of ``+=``, ``-=``, ``*=``, of a read-modify-write
  (``x = x + y``, ``x = __hfma(a, b, x)``) or of an ``__hadd`` /
  ``__hfma`` chain; and an ``mma.sync`` / ``wgmma`` whose accumulator
  type is ``f16`` or ``bf16``, or a WMMA accumulator fragment of
  ``half`` or ``__nv_bfloat16``. Every partial sum rounds to 8 or 11
  bits: the wire may be bf16, the sum stays f32.
- ``missing-interpret-fallback`` — the port's counterpart, a CUDA
  tensor that reaches neither a kernel nor a refusal. In ``ops/`` a
  launcher (a function that calls a loader of a ``csrc/`` library, one
  that calls ``load_library``) whose CUDA branch can return before its
  launch: a ``return`` ahead of the first loader call that is not on
  the CPU branch (the body of an ``if x == "cpu"``, the else of an
  ``if x != "cpu"``) and not the answer to an empty input (under ``if
  ... == 0``), or a ``return`` in an ``except`` handler (a ``try`` that
  falls back). And in ``csrc/`` a C export that takes a stream (it launches
  work on the card) which no ``ops/`` module of the package names.

C findings are suppressed by ``// ptpu: allow[rule] — why`` on the line
or in the comment block directly above it; Python findings by the usual
``#`` pragma.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .core import CheckContext, Finding, ModuleInfo
from .kernels import _c_suppressed, _read, _strip_comments

DMA_RULE = "dma-unwaited"
ACC_RULE = "low-precision-accumulator"
FALLBACK_RULE = "missing-interpret-fallback"

_QUALIFIER_RE = re.compile(r"\b(__global__|__device__)\b")
_IDENT_BEFORE_RE = re.compile(r"([A-Za-z_]\w*)\s*$")

#: asynchronous copies into shared memory (and TMA's bulk copies)
_COPY_RE = re.compile(
    r"cp\.async\.(?:ca|cg)\b|cp\.async\.bulk\.(?!commit_group|wait_group)"
    r"|\b__pipeline_memcpy_async\s*\(|\bcuda::memcpy_async\s*\(")
#: what waits for them
_WAIT_RE = re.compile(
    r"cp\.async\.(?:bulk\.)?wait_(?:group|all)\b"
    r"|mbarrier\.(?:try_wait|test_wait)\b|\b__pipeline_wait_prior\s*\("
    r"|\barrive_and_wait\s*\(|\.wait(?:_prior)?\s*[<(]")

_LOW_TYPES = r"(?:__half2?|half2?|__nv_bfloat162?|nv_bfloat162?)"
_LOW_DECL_RE = re.compile(
    r"(?:\b__shared__\s+)?(?:\bconst\s+)?\b(" + _LOW_TYPES + r")\b"
    r"\s*(?:\*\s*)?(?:__restrict__\s+)?([A-Za-z_]\w*)\s*(?=[\[=;,)])")
_HALF_MATH_RE = re.compile(r"\b__h(?:add|fma|sub|mul)2?(?:_rn)?\s*\(")
_MMA_RE = re.compile(
    r"\b(w?gmma\.mma_async(?:\.sp)?\.sync\.aligned|mma\.sync\.aligned)"
    r"\.(m\d+n\d+k\d+)((?:\.[\w:]+)*)")
_WMMA_ACC_RE = re.compile(
    r"fragment\s*<\s*(?:nvcuda::)?wmma::accumulator\s*,[^>;]*?"
    r"\b(half|__half|__nv_bfloat16)\s*>")
_LOW_MMA = {"f16", "bf16"}
_MMA_DTYPES = {"f16", "bf16", "f32", "f64", "s32"}

_EXTERN_RE = re.compile(
    r'extern\s+"C"\s+[\w\s\*]+?\b([A-Za-z_]\w*)\s*\(([^)]*)\)\s*\{')
_DEFINE_RE = re.compile(r"#\s*define\s+([A-Za-z_]\w*)\(([^)]*)\)")


# -- C sources ----------------------------------------------------------------

class _CFile:
    """One C source: its text with comments blanked (``raw``, inline PTX
    kept) and with strings blanked too (``code``, for structure), same
    offsets."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.lines = text.splitlines()
        self.raw = _strip_comments(text, strings=False)
        self.code = _strip_comments(text)

    def line_of(self, pos: int) -> int:
        return self.code.count("\n", 0, pos) + 1


class _CFunction:
    __slots__ = ("file", "name", "start", "end", "kernel")

    def __init__(self, file: _CFile, name: str, start: int, end: int,
                 kernel: bool):
        self.file = file
        self.name = name
        self.start = start      # the body's opening brace
        self.end = end          # one past its closing brace
        self.kernel = kernel


def _match_brace(code: str, at: int) -> int:
    """One past the brace that closes the one at ``at``."""
    depth = 0
    for i in range(at, len(code)):
        if code[i] == "{":
            depth += 1
        elif code[i] == "}":
            depth -= 1
            if depth == 0:
                return i + 1
    return len(code)


def _name_of(header: str) -> Optional[str]:
    """The function name of a definition's header: the identifier before
    the parameter list (the last parenthesized group)."""
    end = header.rfind(")")
    if end < 0:
        return None
    depth = 0
    for i in range(end, -1, -1):
        if header[i] == ")":
            depth += 1
        elif header[i] == "(":
            depth -= 1
            if depth == 0:
                m = _IDENT_BEFORE_RE.search(header[:i])
                return m.group(1) if m else None
    return None


def _functions(f: _CFile) -> List[_CFunction]:
    """Every ``__global__`` / ``__device__`` function defined in ``f``."""
    out: List[_CFunction] = []
    pos = 0
    code = f.code
    while True:
        m = _QUALIFIER_RE.search(code, pos)
        if m is None:
            return out
        brace, semi = code.find("{", m.end()), code.find(";", m.end())
        if brace < 0 or (0 <= semi < brace):
            pos = m.end()
            continue
        name = _name_of(code[m.start():brace])
        end = _match_brace(code, brace)
        if name:
            out.append(_CFunction(f, name, brace, end,
                                  m.group(1) == "__global__"))
        pos = end


def _csrc_files(mods: Iterable[ModuleInfo]) -> List[Tuple[str, List[
        _CFile], List[ModuleInfo]]]:
    """``(csrc dir, its C files, the package's scanned ops/ modules)``
    for each package whose scanned set holds an ``ops/`` module and that
    has a ``csrc/`` directory."""
    packages: Dict[str, List[ModuleInfo]] = {}
    for mod in mods:
        parts = mod.path.replace(os.sep, "/").split("/")
        if len(parts) >= 2 and parts[-2] == "ops":
            root = os.path.dirname(os.path.dirname(mod.path))
            packages.setdefault(os.path.join(root, "csrc"), []).append(mod)
    out = []
    for csrc, ops_mods in sorted(packages.items()):
        if not os.path.isdir(csrc):
            continue
        files = []
        for name in sorted(os.listdir(csrc)):
            if name.endswith((".cu", ".cuh")):
                path = os.path.join(csrc, name)
                text = _read(path)
                if text is not None:
                    files.append(_CFile(path.replace(os.sep, "/"), text))
        out.append((csrc, files, ops_mods))
    return out


def _finding(rule: str, f: _CFile, line: int, msg: str
             ) -> Optional[Finding]:
    if _c_suppressed(f.lines, line, rule):
        return None
    return Finding(rule, f.path, line, 0, msg)


# -- dma-unwaited -------------------------------------------------------------

def _calls(fn: _CFunction, names: Set[str]) -> List[Tuple[int, str]]:
    """``(offset, callee)`` of every call in ``fn``'s body to a function
    of ``names``."""
    body = fn.file.code[fn.start:fn.end]
    out = []
    for m in re.finditer(r"\b([A-Za-z_]\w*)\s*(?:<[^<>;(){}]*>)?\s*\(",
                         body):
        if m.group(1) in names and m.group(1) != fn.name:
            out.append((fn.start + m.start(), m.group(1)))
    return out


def _dma_events(fn: _CFunction, names: Set[str]
                ) -> List[Tuple[int, str, Optional[str]]]:
    """``(offset, "issue" | "wait" | "call", callee)`` in body order."""
    raw = fn.file.raw[fn.start:fn.end]
    ev = [(fn.start + m.start(), "issue", None)
          for m in _COPY_RE.finditer(raw)]
    ev += [(fn.start + m.start(), "wait", None)
           for m in _WAIT_RE.finditer(raw)]
    ev += [(pos, "call", name) for pos, name in _calls(fn, names)]
    return sorted(ev)


def _resolved(events, summary: Dict[str, Tuple[bool, bool]]):
    """``events`` with each call read as what its callee leaves: an
    issue where it owes a wait, a wait where it waits; others dropped."""
    for pos, kind, callee in events:
        if kind == "call":
            owes, waits = summary[callee]
            kind = "issue" if owes else "wait" if waits else None
        if kind is not None:
            yield pos, kind, callee


def _dma_summaries(fns: List[_CFunction]):
    """Each function name's ``(owes a wait at its end, waits at all)``,
    to a fixed point over the calls (overloads of one name merge: any
    that owes makes the name owe), and each function's events."""
    names = {fn.name for fn in fns}
    events = {id(fn): _dma_events(fn, names) for fn in fns}
    summary: Dict[str, Tuple[bool, bool]] = {n: (False, False)
                                             for n in names}
    while True:
        new = {n: (False, False) for n in names}
        for fn in fns:
            owes, waits = False, False
            for _, kind, _ in _resolved(events[id(fn)], summary):
                owes = kind == "issue"
                waits = waits or kind == "wait"
            o, w = new[fn.name]
            new[fn.name] = (o or owes, w or waits)
        if new == summary:
            return summary, events
        summary = new


def rule_dma_unwaited(mods: List[ModuleInfo],
                      ctx: CheckContext) -> List[Finding]:
    findings: List[Finding] = []
    for _, files, _ in _csrc_files(mods):
        fns = [fn for f in files for fn in _functions(f)]
        summary, events = _dma_summaries(fns)
        called = {name for fn in fns for _, kind, name in events[id(fn)]
                  if kind == "call"}
        for fn in fns:
            if fn.name in called or not summary[fn.name][0]:
                continue
            first, via = None, None  # the first issue after the last wait
            for pos, kind, callee in _resolved(events[id(fn)], summary):
                if kind == "wait":
                    first, via = None, None
                elif first is None:
                    first, via = pos, callee
            if first is None:
                continue
            how = f" (through `{via}`)" if via else ""
            f = _finding(
                DMA_RULE, fn.file, fn.file.line_of(first),
                f"asynchronous copy issued in `{fn.name}`{how} with no "
                f"cp.async.wait_group / wait_all or mbarrier wait after it "
                f"before the kernel ends: the copy lands in shared memory "
                f"while the kernel reads it (or after it exits) — wait on "
                f"every issued group before its buffer is read")
            if f is not None:
                findings.append(f)
    return findings


# -- low-precision-accumulator ------------------------------------------------

def _low_names(text: str) -> Dict[str, str]:
    return {m.group(2): m.group(1) for m in _LOW_DECL_RE.finditer(text)}


def _accumulations(body: str, names: Dict[str, str]
                   ) -> Iterable[Tuple[int, str]]:
    """``(offset in body, name)`` of each accumulation into a
    low-precision name."""
    for name in names:
        target = re.compile(r"\b" + re.escape(name)
                            + r"\s*(?:\[[^\]\n]*\])*\s*(\+=|-=|\*=|=(?!=))")
        for m in target.finditer(body):
            if m.group(1) != "=":
                yield m.start(), name
                continue
            end = body.find(";", m.end())
            rhs = body[m.end():end if end >= 0 else len(body)]
            if re.search(r"\b" + re.escape(name) + r"\b", rhs) \
                    or _HALF_MATH_RE.search(rhs):
                yield m.start(), name


def rule_low_precision_accumulator(mods: List[ModuleInfo],
                                   ctx: CheckContext) -> List[Finding]:
    findings: List[Finding] = []
    for _, files, _ in _csrc_files(mods):
        for f in files:
            fns = _functions(f)
            # file-scope declarations (shared arrays): the text outside
            # every function body
            top = list(f.code)
            for fn in fns:
                top[fn.start:fn.end] = " " * (fn.end - fn.start)
            shared = _low_names("".join(top))
            seen: Set[int] = set()
            for fn in fns:
                body = f.code[fn.start:fn.end]
                names = dict(shared)
                names.update(_low_names(body))
                for off, name in _accumulations(body, names):
                    line = f.line_of(fn.start + off)
                    if line in seen:
                        continue
                    seen.add(line)
                    hit = _finding(
                        ACC_RULE, f, line,
                        f"accumulation into {names[name]} `{name}` in "
                        f"`{fn.name}`: every partial sum rounds to "
                        f"{names[name]} and the sum drifts — accumulate "
                        f"in a float (upcast after the load) and convert "
                        f"once at the store")
                    if hit is not None:
                        findings.append(hit)
            for m in _MMA_RE.finditer(f.raw):
                tokens = [t for t in m.group(3).split(".") if t]
                if m.group(1).startswith(("wgmma", "gmma")):
                    dtype = tokens[0] if tokens else None
                else:
                    dtype = next((t for t in tokens if t in _MMA_DTYPES),
                                 None)
                if dtype in _LOW_MMA:
                    hit = _finding(
                        ACC_RULE, f, f.line_of(m.start()),
                        f"`{m.group(0)}` accumulates in {dtype}: the "
                        f"tensor core sums in {dtype} — use an f32 "
                        f"accumulator (.f32 D and C) and convert at the "
                        f"store")
                    if hit is not None:
                        findings.append(hit)
            for m in _WMMA_ACC_RE.finditer(f.code):
                hit = _finding(
                    ACC_RULE, f, f.line_of(m.start()),
                    f"a WMMA accumulator fragment of {m.group(1)}: the "
                    f"tensor core sums in it — declare the accumulator "
                    f"fragment float")
                if hit is not None:
                    findings.append(hit)
    return findings


# -- missing-interpret-fallback -----------------------------------------------

def _is_ops_module(mod: ModuleInfo) -> bool:
    parts = mod.path.replace(os.sep, "/").split("/")
    return len(parts) >= 2 and parts[-2] == "ops"


def _own_nodes(fn: ast.AST) -> Iterable[ast.AST]:
    """``fn``'s nodes, nested definitions left out."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _called_names(mod: ModuleInfo, fn: ast.AST) -> Set[str]:
    out = set()
    for n in _own_nodes(fn):
        if isinstance(n, ast.Call):
            name = mod.resolve(n.func) or ""
            out.add(name.rsplit(".", 1)[-1])
    return out


def _cpu_side(test: ast.AST) -> Tuple[bool, bool]:
    """Whether an ``if``'s test puts its body (``x == "cpu"``) or its
    else branch (``x != "cpu"``) on the CPU side, where the plain
    version runs; any other test excuses neither."""
    if isinstance(test, ast.Compare) and len(test.ops) == 1 and any(
            isinstance(x, ast.Constant) and x.value == "cpu"
            for x in (test.left, test.comparators[0])):
        op = test.ops[0]
        return isinstance(op, (ast.Eq, ast.Is)), \
            isinstance(op, (ast.NotEq, ast.IsNot))
    return False, False


def _is_empty_guard(test: ast.AST) -> bool:
    return isinstance(test, ast.Compare) and len(test.ops) == 1 \
        and isinstance(test.ops[0], ast.Eq) \
        and isinstance(test.comparators[0], ast.Constant) \
        and test.comparators[0].value == 0


def _launcher_findings(mod: ModuleInfo) -> List[Finding]:
    fns = [n for n in ast.walk(mod.tree)
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    loaders = {fn.name for fn in fns
               if "load_library" in _called_names(mod, fn)}
    findings: List[Finding] = []
    for fn in fns:
        if fn.name in loaders:
            continue
        launch = [n.lineno for n in _own_nodes(fn)
                  if isinstance(n, ast.Call)
                  and isinstance(n.func, ast.Name) and n.func.id in loaders]
        if not launch:
            continue
        first = min(launch)

        def walk(nodes, excused: bool, handler: bool):
            for n in nodes:
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                    continue
                if isinstance(n, ast.Return) and (
                        handler or (not excused and n.lineno < first)):
                    why = ("returns from an `except` handler: a try that "
                           "falls back hides a failed launch"
                           if handler else
                           "returns before its kernel launches, off the "
                           "plain (CPU) branch")
                    findings.append(Finding(
                        FALLBACK_RULE, mod.path, n.lineno, n.col_offset,
                        f"launcher `{fn.name}` {why}: a CUDA tensor "
                        f"reaches neither the kernel nor a refusal — "
                        f"launch, or raise"))
                    continue
                if isinstance(n, ast.If):
                    body_cpu, else_cpu = _cpu_side(n.test)
                    walk(n.body, excused or body_cpu
                         or _is_empty_guard(n.test), handler)
                    walk(n.orelse, excused or else_cpu, handler)
                    continue
                if isinstance(n, ast.Try):
                    walk(n.body, excused, handler)
                    for h in n.handlers:
                        walk(h.body, excused, True)
                    walk(n.orelse, excused, handler)
                    walk(n.finalbody, excused, handler)
                    continue
                walk(list(ast.iter_child_nodes(n)), excused, handler)

        walk(fn.body, False, False)
    return findings


def _macro_spans(text: str) -> List[Tuple[int, int]]:
    """``(start, end)`` of every ``#define`` with its continued lines."""
    out = []
    for m in re.finditer(r"^[ \t]*#\s*define\b", text, re.M):
        end = m.end()
        while True:
            nl = text.find("\n", end)
            if nl < 0:
                nl = len(text)
                break
            if not text[:nl].rstrip().endswith("\\"):
                break
            end = nl + 1
        out.append((m.start(), nl))
    return out


def _exports(f: _CFile) -> List[Tuple[str, int]]:
    """``(name, line)`` of each C export of ``f`` that takes a stream:
    written out, or made by a macro (``#define E(NAME, ...)`` whose body
    defines ``extern "C" ... NAME(... stream ...)``), at its use."""
    out = []
    text = f.raw
    defines = _macro_spans(text)
    outside = list(text)
    for a, b in defines:
        outside[a:b] = " " * (b - a)
    for m in _EXTERN_RE.finditer("".join(outside)):
        if re.search(r"\bstream\b", m.group(2)):
            out.append((m.group(1), f.line_of(m.start())))
    for m in _DEFINE_RE.finditer(text):
        params = [p.strip() for p in m.group(2).split(",")]
        end = m.end()
        while True:
            nl = text.find("\n", end)
            if nl < 0 or not text[:nl].rstrip().endswith("\\"):
                break
            end = nl + 1
        body = text[m.end():nl if nl >= 0 else len(text)]
        em = re.search(r'extern\s+"C"\s+[\w\s\*]+?\b([A-Za-z_]\w*)\s*\('
                       r'([^)]*)\)', body)
        if not em or em.group(1) not in params \
                or not re.search(r"\bstream\b", em.group(2)):
            continue
        slot = params.index(em.group(1))
        use = re.compile(r"^\s*" + re.escape(m.group(1)) + r"\s*\(([^)]*)\)",
                         re.M)
        for u in use.finditer(text, nl if nl >= 0 else len(text)):
            args = [a.strip() for a in u.group(1).split(",")]
            if len(args) > slot:
                out.append((args[slot], f.line_of(u.start(1))))
    return out


def _named_in(mods: Iterable[ModuleInfo]) -> Set[str]:
    out: Set[str] = set()
    for mod in mods:
        for n in ast.walk(mod.tree):
            if isinstance(n, ast.Constant) and isinstance(n.value, str):
                out.add(n.value)
            elif isinstance(n, ast.Attribute):
                out.add(n.attr)
    return out


def rule_missing_interpret_fallback(mods: List[ModuleInfo],
                                    ctx: CheckContext) -> List[Finding]:
    findings: List[Finding] = []
    for mod in mods:
        if _is_ops_module(mod):
            findings.extend(_launcher_findings(mod))
    for _, files, ops_mods in _csrc_files(mods):
        named = _named_in(ops_mods)
        for f in files:
            for name, line in _exports(f):
                if name in named:
                    continue
                hit = _finding(
                    FALLBACK_RULE, f, line,
                    f"C export `{name}` launches work on a stream but no "
                    f"ops/ wrapper names it: a kernel no wrapper launches "
                    f"is never held to its plain version nor counted — "
                    f"bind it in an ops/ wrapper or remove it")
                if hit is not None:
                    findings.append(hit)
    return findings
