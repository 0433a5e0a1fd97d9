"""``smem-overbudget``: the shared-memory budget of the port's kernels.

The counterpart of the JAX package's ``vmem-overbudget``
(``predictionio_tpu/analysis/kernels.py``, a 16 MiB VMEM budget a core)
for the hand-written Hopper kernels under ``csrc/``. A block may ask
for 48 KB of dynamic shared memory by default and, once its kernel opts
in with ``cudaFuncSetAttribute(kernel,
cudaFuncAttributeMaxDynamicSharedMemorySize, n)``, up to the card's
opt-in limit (232,448 bytes on an H100). Past 48 KB without the opt-in,
or past the limit at all, the launch fails — at the one rank, wire or
batch that reaches it, mid-serve.

The rule is project-scoped and fires where the scanned set holds an
``ops/smem.py`` (the port's: one torch-free formula a kernel). It
executes nothing of that module: :mod:`.interp` walks its AST in a
subset of Python that computes integers and reaches nothing of the host
(a module that imports, or steps outside the subset, is a finding). It
reports:

- for each entry of its ``KERNELS``, a point of ``grid()`` (every point
  the launcher accepts) whose ``bytes(point)`` passes ``SMEM_LIMIT``
  and that ``refuses(point, nbytes)`` (the launcher's own refusal) does
  not refuse — anchored at the kernel's ``<<<…>>>`` launch in
  ``csrc/``;
- any ``<<<grid, block, smem, stream>>>`` launch in ``csrc/*.cu`` /
  ``*.cuh`` whose dynamic shared memory can pass 48 KB (its
  ``KERNELS`` formula's largest accepted point; a constant expression;
  anything else is taken to) with no ``cudaFuncSetAttribute(<the same
  kernel>, cudaFuncAttributeMaxDynamicSharedMemorySize, …)`` before it
  in the launching function.

A finding in a C file is suppressed by ``// ptpu:
allow[smem-overbudget] — why`` on the launch line or in the comment
block directly above it; one anchored in ``ops/smem.py`` by the usual
``#`` pragma. ``chip_smoke.py``'s phase ``check`` holds each formula to
the C library's ``<name>_smem_bytes`` export on the card, point by
point.
"""

from __future__ import annotations

import ast
import functools
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from . import interp
from .core import CheckContext, Finding, ModuleInfo

RULE = "smem-overbudget"

#: the formula module, relative to its package
SMEM_MODULE = "ops/smem.py"

_LAUNCH_RE = re.compile(
    r"([A-Za-z_][\w:]*(?:<[^<>;()]*>)?)\s*<<<(.*?)>>>", re.S)
_C_PRAGMA_RE = re.compile(r"//.*?ptpu:\s*allow\[([^\]]*)\]")
_NAMESPACE_RE = re.compile(r"\bnamespace\b[\w\s:]*$")


def _strip_comments(text: str, strings: bool = True) -> str:
    """C source with comments and string literals blanked (same length,
    newlines kept), so braces and calls inside them are not read; with
    ``strings=False`` the string literals stay (inline PTX is read
    there)."""
    out = []
    i, n = 0, len(text)
    while i < n:
        two = text[i:i + 2]
        if two == "//":
            j = text.find("\n", i)
            j = n if j < 0 else j
            out.append(" " * (j - i))
            i = j
        elif two == "/*":
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append("".join(c if c == "\n" else " "
                               for c in text[i:j]))
            i = j
        elif text[i] == '"':
            j = i + 1
            while j < n and text[j] != '"':
                j += 2 if text[j] == "\\" else 1
            out.append(" " * (min(j + 1, n) - i) if strings
                       else text[i:min(j + 1, n)])
            i = j + 1
        else:
            out.append(text[i])
            i += 1
    return "".join(out)


def _function_start(code: str, pos: int) -> int:
    """Offset of the body of the function holding ``pos``: the outermost
    ``{`` enclosing it that does not open a namespace (0 when none)."""
    stack: List[Tuple[int, bool]] = []
    for i, c in enumerate(code[:pos]):
        if c == "{":
            head = code[max(0, i - 80):i]
            stack.append((i, bool(_NAMESPACE_RE.search(head))))
        elif c == "}" and stack:
            stack.pop()
    for i, is_ns in stack:
        if not is_ns:
            return i
    return 0


def _split_args(text: str) -> List[str]:
    args, depth, cur = [], 0, []
    for c in text:
        if c in "(<[":
            depth += 1
        elif c in ")>]":
            depth -= 1
        if c == "," and depth == 0:
            args.append("".join(cur).strip())
            cur = []
        else:
            cur.append(c)
    if "".join(cur).strip():
        args.append("".join(cur).strip())
    return args


def _const_eval(expr: str) -> Optional[int]:
    """An integer constant expression (digits, ``+ - * / ( )``)."""
    expr = expr.strip()
    if not expr or not re.fullmatch(r"[\d\s\+\-\*/\(\)]+", expr):
        return None
    try:
        tree = ast.parse(expr.replace("/", "//"), mode="eval")
    except SyntaxError:
        return None

    def ev(node) -> int:
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return node.value
        if isinstance(node, ast.BinOp):
            a, b = ev(node.left), ev(node.right)
            ops = {ast.Add: a + b, ast.Sub: a - b, ast.Mult: a * b}
            if isinstance(node.op, ast.FloorDiv):
                return a // b
            return ops[type(node.op)]
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            return -ev(node.operand)
        raise ValueError(expr)

    try:
        return ev(tree)
    except (ValueError, KeyError, ZeroDivisionError):
        return None


def _c_suppressed(lines: Sequence[str], line: int,
                  rule: str = RULE) -> bool:
    """Whether ``// ptpu: allow[rule]`` sits on ``line`` or in the
    comment block directly above it."""
    candidates = [line]
    ln = line - 1
    while ln >= 1 and lines[ln - 1].strip().startswith("//"):
        candidates.append(ln)
        ln -= 1
    for ln in candidates:
        m = _C_PRAGMA_RE.search(lines[ln - 1]) if ln <= len(lines) else None
        if m:
            allowed = {r.strip() for r in m.group(1).split(",")}
            if "*" in allowed or rule in allowed:
                return True
    return False


def _norm(expr: str) -> str:
    return re.sub(r"\s+", "", expr)


class _Launch:
    __slots__ = ("path", "line", "kernel", "smem", "opted_in")

    def __init__(self, path: str, line: int, kernel: str, smem: str,
                 opted_in: bool):
        self.path = path
        self.line = line
        self.kernel = kernel
        self.smem = smem
        self.opted_in = opted_in


def _launches(path: str, text: str) -> List[_Launch]:
    code = _strip_comments(text)
    out: List[_Launch] = []
    for m in _LAUNCH_RE.finditer(code):
        kernel = m.group(1)
        args = _split_args(m.group(2))
        smem = args[2] if len(args) > 2 else "0"
        body = code[_function_start(code, m.start()):m.start()]
        opt = re.compile(
            r"cudaFuncSetAttribute\(\s*" + r"\s*".join(
                re.escape(c) for c in _norm(kernel))
            + r"\s*,\s*cudaFuncAttributeMaxDynamicSharedMemorySize")
        out.append(_Launch(path, code.count("\n", 0, m.start()) + 1,
                           kernel, smem, bool(opt.search(body))))
    return out


@functools.lru_cache(maxsize=8)
def _evaluate(path: str, source: str) -> Tuple[Optional[dict], str]:
    """Each kernel of ``ops/smem.py``'s ``KERNELS`` with its largest
    accepted point, evaluated by :mod:`.interp` (nothing of the module
    is executed), and ``SMEM_LIMIT`` and ``DEFAULT_LIMIT``; or (None,
    why) where it imports anything or steps outside the subset."""
    tree = ast.parse(source, filename=path)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            return None, (f"{SMEM_MODULE} imports "
                          f"(line {node.lineno}); the rule reads it only "
                          f"when it imports nothing")
    try:
        it, ns = interp.interpret(tree)
        kernels = ns.get("KERNELS")
        if not isinstance(kernels, dict) \
                or not isinstance(ns.get("SMEM_LIMIT"), int):
            return None, (f"{SMEM_MODULE} defines no KERNELS dict and "
                          f"SMEM_LIMIT")
        out = {}
        for name, spec in kernels.items():
            top, top_bytes = None, -1
            for point in it.call(spec["grid"]):
                nbytes = it.call(spec["bytes"], point)
                if nbytes > top_bytes \
                        and not it.call(spec["refuses"], point, nbytes):
                    top, top_bytes = point, nbytes
            out[name] = {k: spec[k] for k in ("source", "launch", "args")}
            out[name].update(point=top, bytes=top_bytes)
    except (interp.FormulaError, KeyError, TypeError) as e:
        return None, (f"{SMEM_MODULE} does not evaluate in the formula "
                      f"subset: {type(e).__name__}: {e}")
    return {"kernels": out, "limit": ns["SMEM_LIMIT"],
            "default": ns.get("DEFAULT_LIMIT", 48 * 1024)}, ""


def _entry_line(mod: ModuleInfo, name: str) -> int:
    for i, line in enumerate(mod.lines, start=1):
        if f'"{name}":' in line:
            return i
    return 1


def _csrc_dir(mod: ModuleInfo) -> str:
    return os.path.join(os.path.dirname(os.path.dirname(mod.path)), "csrc")


def _read(path: str) -> Optional[str]:
    try:
        with open(path, "r", encoding="utf-8") as fh:
            return fh.read()
    except (OSError, UnicodeDecodeError):
        return None


def _check_module(mod: ModuleInfo) -> List[Finding]:
    ev, why = _evaluate(mod.path, mod.source)
    if ev is None:
        return [Finding(RULE, mod.path, 1, 0, why)]
    limit, default = ev["limit"], ev["default"]
    csrc = _csrc_dir(mod)
    names = sorted(os.listdir(csrc)) if os.path.isdir(csrc) else []
    sources = {n: _read(os.path.join(csrc, n)) for n in names
               if n.endswith((".cu", ".cuh"))}
    launches = {n: _launches(os.path.join(csrc, n).replace(os.sep, "/"),
                             t)
                for n, t in sources.items() if t is not None}
    findings: List[Finding] = []
    largest: Dict[Tuple[str, str], int] = {}
    for name, spec in ev["kernels"].items():
        worst, worst_bytes = spec["point"], spec["bytes"]
        largest[(spec["source"], _norm(spec["launch"]))] = worst_bytes
        if worst_bytes <= limit:
            continue
        at = [x for x in launches.get(spec["source"], ())
              if _norm(x.kernel) == _norm(spec["launch"])]
        path, line = (at[0].path, at[0].line) if at \
            else (mod.path, _entry_line(mod, name))
        if at and _c_suppressed(sources[spec["source"]].splitlines(), line):
            continue
        point = ", ".join(f"{a}={v}" for a, v in zip(spec["args"], worst))
        findings.append(Finding(
            RULE, path, line, 0,
            f"`{name}` asks for {worst_bytes:,} bytes of dynamic shared "
            f"memory at {point}, past the card's opt-in limit of "
            f"{limit:,}, and its launcher does not refuse that point: the "
            f"launch fails there — shrink the tile at that point or "
            f"refuse it in the launcher"))
    for fname, items in launches.items():
        lines = sources[fname].splitlines()
        for launch in items:
            nbytes = largest.get((fname, _norm(launch.kernel)))
            if nbytes is None:
                nbytes = _const_eval(launch.smem)
            if nbytes is None:
                assigned = re.findall(
                    r"\b" + re.escape(launch.smem) + r"\s*=\s*([^;]+);",
                    _strip_comments(sources[fname]))
                nbytes = _const_eval(assigned[-1]) if assigned else None
            if (nbytes is not None and nbytes <= default) \
                    or launch.opted_in \
                    or _c_suppressed(lines, launch.line):
                continue
            size = (f"{nbytes:,} bytes" if nbytes is not None
                    else f"`{launch.smem}` bytes (no formula in "
                         f"{SMEM_MODULE}, not a constant)")
            findings.append(Finding(
                RULE, launch.path, launch.line, 0,
                f"`{launch.kernel}<<<…>>>` can ask for {size} of dynamic "
                f"shared memory, past the {default:,}-byte default, with "
                f"no cudaFuncSetAttribute({launch.kernel}, "
                f"cudaFuncAttributeMaxDynamicSharedMemorySize, …) before "
                f"it: the launch fails past 48 KB — opt in first"))
    return findings


def rule_smem_overbudget(mods: Sequence[ModuleInfo],
                         ctx: CheckContext) -> List[Finding]:
    findings: List[Finding] = []
    for mod in mods:
        if mod.path.endswith(SMEM_MODULE):
            findings.extend(_check_module(mod))
    return findings


def smem_report(module_path: str) -> Dict[str, dict]:
    """Each kernel's largest accepted point of ``ops/smem.py`` at
    ``module_path`` and its bytes: ``{name: {"point": {...}, "bytes":
    n}}`` (what ``chip_smoke.py`` prints beside the card's limit)."""
    with open(module_path, "r", encoding="utf-8") as fh:
        source = fh.read()
    ev, why = _evaluate(module_path, source)
    if ev is None:
        raise ValueError(why)
    return {name: {"point": dict(zip(spec["args"], spec["point"])),
                   "bytes": spec["bytes"]}
            for name, spec in ev["kernels"].items()}
