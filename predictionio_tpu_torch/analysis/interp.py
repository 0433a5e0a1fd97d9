"""A restricted interpreter for the shared-memory formula module.

``smem-overbudget`` must evaluate ``ops/smem.py``'s formulas over every
point a launcher accepts, yet a checker that runs code from the tree it
scans is no checker one can point at any tree. So the rule does not
execute the module: it walks its AST here, in a subset of Python that
can compute integers and nothing else.

- Statements: assignments (to names and tuples of names), augmented
  assignments, ``def``, ``return``, ``if``, ``for``, ``while``,
  ``break``, ``continue``, ``pass``, ``yield`` (a generator runs to its
  end and returns its list), ``raise`` of and ``try``/``except`` on the
  names in :data:`EXCEPTIONS`, and docstrings. No import, ``class``,
  ``global``, ``with`` or ``del``.
- Values: ``int``, ``bool``, ``str``, ``None``, tuples, lists, sets,
  dicts, ranges and the module's own functions. An integer may not pass
  :data:`MAX_INT_BITS` bits.
- Calls: the module's functions, the builtins of :data:`BUILTINS`, and
  the methods of :data:`METHODS`. No other attribute is read, so no
  dunder and no object of the host is reachable.
- Every statement, expression and item a builtin consumes costs a step;
  past :data:`MAX_STEPS` the run stops.

Anything outside the subset raises :class:`FormulaError`, which the
rule reports as the module failing to run.
"""

from __future__ import annotations

import ast
import operator
from typing import Any, Dict, Iterable, Iterator, List, Optional

#: steps a module's evaluation may take in all (the port's takes about
#: 2.8 million, some 4 s)
MAX_STEPS = 20_000_000

#: the widest integer a formula may make
MAX_INT_BITS = 4096

#: exceptions a formula may raise and catch
EXCEPTIONS = ("ValueError",)

_BINOPS = {
    ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
    ast.FloorDiv: operator.floordiv, ast.Mod: operator.mod,
    ast.Pow: operator.pow, ast.LShift: operator.lshift,
    ast.RShift: operator.rshift, ast.BitAnd: operator.and_,
    ast.BitOr: operator.or_, ast.BitXor: operator.xor,
}
_CMPOPS = {
    ast.Eq: operator.eq, ast.NotEq: operator.ne, ast.Lt: operator.lt,
    ast.LtE: operator.le, ast.Gt: operator.gt, ast.GtE: operator.ge,
    ast.Is: operator.is_, ast.IsNot: operator.is_not,
    ast.In: lambda a, b: a in b, ast.NotIn: lambda a, b: a not in b,
}
_UNARY = {ast.USub: operator.neg, ast.UAdd: operator.pos,
          ast.Invert: operator.invert, ast.Not: operator.not_}
_CONSTANTS = (int, str, type(None))


class FormulaError(Exception):
    """The module steps outside the subset, fails, or runs too long."""


class _Raised(Exception):
    def __init__(self, kind: str, message: str):
        super().__init__(f"{kind}: {message}")
        self.kind = kind


class _Return(Exception):
    def __init__(self, value):
        self.value = value


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


class _ExcType:
    """``ValueError`` and its kin as a formula sees them: callable to
    make the message :func:`raise` carries."""

    def __init__(self, name: str):
        self.name = name

    def __call__(self, message: Any = "") -> "_ExcValue":
        return _ExcValue(self.name, str(message))


class _ExcValue:
    def __init__(self, kind: str, message: str):
        self.kind = kind
        self.message = message


class _Function:
    """A ``def`` or ``lambda`` of the module, callable from Python (the
    rule calls ``grid()``, ``bytes(point)`` and ``refuses(...)``)."""

    def __init__(self, interp: "Interpreter", name: str, args: ast.arguments,
                 body, scope: Optional[dict], is_expr: bool):
        if args.vararg or args.kwarg or args.kwonlyargs \
                or getattr(args, "posonlyargs", None):
            raise FormulaError(f"`{name}` takes only plain parameters")
        self.interp = interp
        self.name = name
        self.params = [a.arg for a in args.args]
        self.defaults = [interp.eval(d, scope) for d in args.defaults]
        self.body = body
        self.scope = scope  # the enclosing function's locals, or None
        self.is_expr = is_expr
        self.generator = not is_expr and any(
            isinstance(n, (ast.Yield, ast.YieldFrom))
            for stmt in body for n in ast.walk(stmt))

    def __call__(self, *args, **kwargs):
        if len(args) > len(self.params):
            raise FormulaError(f"`{self.name}` takes {len(self.params)} "
                               f"arguments, got {len(args)}")
        local: Dict[str, Any] = dict(zip(self.params, args))
        for name, value in kwargs.items():
            if name not in self.params or name in local:
                raise FormulaError(f"`{self.name}`: bad argument `{name}`")
            local[name] = value
        first_default = len(self.params) - len(self.defaults)
        for i, name in enumerate(self.params):
            if name not in local:
                if i < first_default:
                    raise FormulaError(f"`{self.name}` misses `{name}`")
                local[name] = self.defaults[i - first_default]
        frame = {"locals": local, "outer": self.scope, "yields": None}
        if self.is_expr:
            return self.interp.eval(self.body, frame)
        if self.generator:
            frame["yields"] = []
        try:
            self.interp.run_block(self.body, frame)
        except _Return as r:
            if not self.generator:
                return r.value
        return frame["yields"] if self.generator else None


def _method(value, name: str):
    """The one method of :data:`METHODS` that ``value`` may call."""
    for kind, names in METHODS:
        if isinstance(value, kind) and name in names:
            return getattr(value, name)
    raise FormulaError(f"`.{name}` of a {type(value).__name__} is outside "
                       f"the formula subset")


#: the methods a formula may call, by the type of their object
METHODS = (
    (int, ("bit_length",)),
    (list, ("append",)),
    (set, ("add",)),
)


class Interpreter:
    """Evaluates one module's AST in the subset; :meth:`run` returns its
    globals, whose functions stay callable."""

    def __init__(self, max_steps: int = MAX_STEPS):
        self.max_steps = max_steps
        self.steps = 0
        self.globals: Dict[str, Any] = {}
        self.builtins = dict(BUILTINS)
        for name in EXCEPTIONS:
            self.builtins[name] = _ExcType(name)
        for name in ("sum", "max", "min", "sorted", "set", "list", "tuple"):
            self.builtins[name] = self._consuming(BUILTINS[name])

    # -- bookkeeping ----------------------------------------------------

    def step(self) -> None:
        self.steps += 1
        if self.steps > self.max_steps:
            raise FormulaError(f"ran past {self.max_steps:,} steps")

    def _charged(self, it: Iterable) -> Iterator:
        for item in it:
            self.step()
            yield item

    def _consuming(self, fn):
        def call(*args, **kwargs):
            args = [self._charged(a) if isinstance(
                a, (range, list, tuple, set, dict, Iterator)) else a
                for a in args]
            return fn(*args, **kwargs)
        return call

    @staticmethod
    def _int(value):
        if isinstance(value, int) and value.bit_length() > MAX_INT_BITS:
            raise FormulaError(f"an integer past {MAX_INT_BITS} bits")
        return value

    # -- the module -----------------------------------------------------

    def run(self, tree: ast.Module) -> Dict[str, Any]:
        frame = {"locals": self.globals, "outer": None, "yields": None}
        try:
            self.run_block(tree.body, frame)
        except (_Return, _Break, _Continue):
            raise FormulaError("return, break or continue outside a "
                               "function or loop")
        return self.globals

    def call(self, fn, *args):
        """Call a value of the module from the host, turning any failure
        into :class:`FormulaError`."""
        if not isinstance(fn, _Function):
            raise FormulaError(f"{fn!r} is not a function of the module")
        try:
            return fn(*args)
        except FormulaError:
            raise
        except (_Break, _Continue):
            raise FormulaError(f"`{fn.name}`: break or continue outside a "
                               f"loop") from None
        except _Raised as e:
            raise FormulaError(f"`{fn.name}` raised {e}") from None
        except (TypeError, ValueError, ArithmeticError, KeyError,
                IndexError, RecursionError) as e:
            raise FormulaError(f"`{fn.name}` failed: "
                               f"{type(e).__name__}: {e}") from None

    # -- statements -----------------------------------------------------

    def run_block(self, body, frame) -> None:
        for stmt in body:
            self.step()
            self.exec_stmt(stmt, frame)

    def exec_stmt(self, node, frame) -> None:
        t = type(node)
        if t is ast.Expr:
            value = node.value
            if isinstance(value, ast.Constant) and isinstance(value.value,
                                                              str):
                return  # a docstring
            if isinstance(value, ast.Yield):
                if frame["yields"] is None:
                    raise FormulaError("yield outside a function")
                frame["yields"].append(
                    None if value.value is None
                    else self.eval(value.value, frame))
                return
            self.eval(value, frame)
        elif t is ast.Assign:
            value = self.eval(node.value, frame)
            for target in node.targets:
                self.assign(target, value, frame)
        elif t is ast.AugAssign:
            if not isinstance(node.target, ast.Name):
                raise FormulaError("augmented assignment to a non-name")
            op = _BINOPS.get(type(node.op))
            if op is None:
                raise FormulaError(f"operator {type(node.op).__name__}")
            cur = self.lookup(node.target.id, frame)
            self.assign(node.target, self.binop(
                op, cur, self.eval(node.value, frame)), frame)
        elif t is ast.FunctionDef:
            if node.decorator_list:
                raise FormulaError(f"`{node.name}` is decorated")
            scope = frame if frame["locals"] is not self.globals else None
            frame["locals"][node.name] = _Function(
                self, node.name, node.args, node.body, scope, False)
        elif t is ast.Return:
            raise _Return(None if node.value is None
                          else self.eval(node.value, frame))
        elif t is ast.If:
            branch = node.body if self.eval(node.test, frame) else node.orelse
            self.run_block(branch, frame)
        elif t is ast.While:
            if node.orelse:
                raise FormulaError("while ... else")
            while self.eval(node.test, frame):
                try:
                    self.run_block(node.body, frame)
                except _Break:
                    break
                except _Continue:
                    continue
        elif t is ast.For:
            if node.orelse:
                raise FormulaError("for ... else")
            for item in self.iterate(self.eval(node.iter, frame)):
                self.assign(node.target, item, frame)
                try:
                    self.run_block(node.body, frame)
                except _Break:
                    break
                except _Continue:
                    continue
        elif t is ast.Break:
            raise _Break()
        elif t is ast.Continue:
            raise _Continue()
        elif t is ast.Pass:
            return
        elif t is ast.Raise:
            exc = self.eval(node.exc, frame) if node.exc is not None \
                else None
            if isinstance(exc, _ExcType):
                exc = exc()
            if not isinstance(exc, _ExcValue):
                raise FormulaError("raise of something other than "
                                   + "/".join(EXCEPTIONS))
            raise _Raised(exc.kind, exc.message)
        elif t is ast.Try:
            self.exec_try(node, frame)
        else:
            raise FormulaError(f"statement `{t.__name__}` (line "
                               f"{getattr(node, 'lineno', '?')}) is outside "
                               f"the formula subset")

    def exec_try(self, node: ast.Try, frame) -> None:
        if node.finalbody:
            raise FormulaError("try ... finally")
        kinds = []
        for h in node.handlers:
            if h.name or not isinstance(h.type, ast.Name) \
                    or h.type.id not in EXCEPTIONS:
                raise FormulaError("except other than a bare "
                                   + "/".join(EXCEPTIONS))
            kinds.append(h)
        try:
            self.run_block(node.body, frame)
        except _Raised as e:
            for h in kinds:
                if h.type.id == e.kind:
                    self.run_block(h.body, frame)
                    return
            raise
        self.run_block(node.orelse, frame)

    def assign(self, target, value, frame) -> None:
        if isinstance(target, ast.Name):
            frame["locals"][target.id] = value
        elif isinstance(target, (ast.Tuple, ast.List)):
            items = list(self.iterate(value))
            if len(items) != len(target.elts):
                raise FormulaError(f"unpacking {len(items)} values into "
                                   f"{len(target.elts)} names")
            for t, v in zip(target.elts, items):
                self.assign(t, v, frame)
        else:
            raise FormulaError(f"assignment to `{type(target).__name__}`")

    def iterate(self, value) -> Iterator:
        if not isinstance(value, (range, list, tuple, set, dict, str,
                                  Iterator)):
            raise FormulaError(f"iterating a {type(value).__name__}")
        return self._charged(value)

    # -- expressions ----------------------------------------------------

    def lookup(self, name: str, frame) -> Any:
        f = frame
        while f is not None:
            if name in f["locals"]:
                return f["locals"][name]
            f = f["outer"]
        if name in self.globals:
            return self.globals[name]
        if name in self.builtins:
            return self.builtins[name]
        raise FormulaError(f"name `{name}` is not defined in the formula "
                           f"subset")

    def binop(self, op, a, b):
        if not (isinstance(a, int) and isinstance(b, int)):
            if op is operator.add and type(a) is type(b) \
                    and isinstance(a, (tuple, str)):
                return a + b
            raise FormulaError(f"arithmetic on {type(a).__name__} and "
                               f"{type(b).__name__}")
        if op is operator.pow and (b < 0 or b > 256):
            raise FormulaError(f"an exponent of {b}")
        if op is operator.lshift and b > MAX_INT_BITS:
            raise FormulaError(f"a shift of {b}")
        v = op(a, b)
        if v.bit_length() > MAX_INT_BITS:
            raise FormulaError(f"an integer past {MAX_INT_BITS} bits")
        return v

    def eval(self, node, frame) -> Any:
        self.steps += 1
        if self.steps > self.max_steps:
            raise FormulaError(f"ran past {self.max_steps:,} steps")
        handler = _EVAL.get(type(node))
        if handler is None:
            raise FormulaError(
                f"expression `{type(node).__name__}` (line "
                f"{getattr(node, 'lineno', '?')}) is outside the formula "
                f"subset")
        return handler(self, node, frame)

    def _constant(self, node, frame):
        if not isinstance(node.value, _CONSTANTS):
            raise FormulaError(f"a {type(node.value).__name__} constant")
        return node.value

    def _name(self, node, frame):
        return self.lookup(node.id, frame)

    def _binop(self, node, frame):
        op = _BINOPS.get(type(node.op))
        if op is None:
            raise FormulaError(f"operator {type(node.op).__name__}")
        return self.binop(op, self.eval(node.left, frame),
                          self.eval(node.right, frame))

    def _unaryop(self, node, frame):
        v = self.eval(node.operand, frame)
        if not isinstance(node.op, ast.Not) and not isinstance(v, int):
            raise FormulaError(f"{type(node.op).__name__} of a "
                               f"{type(v).__name__}")
        return _UNARY[type(node.op)](v)

    def _compare(self, node, frame):
        left = self.eval(node.left, frame)
        for op, right_node in zip(node.ops, node.comparators):
            right = self.eval(right_node, frame)
            if not _CMPOPS[type(op)](left, right):
                return False
            left = right
        return True

    def _boolop(self, node, frame):
        is_and = isinstance(node.op, ast.And)
        value = None
        for v in node.values:
            value = self.eval(v, frame)
            if bool(value) != is_and:
                return value
        return value

    def _ifexp(self, node, frame):
        return self.eval(node.body if self.eval(node.test, frame)
                         else node.orelse, frame)

    def _tuple(self, node, frame):
        return tuple([self.eval(e, frame) for e in node.elts])

    def _list(self, node, frame):
        return [self.eval(e, frame) for e in node.elts]

    def _set(self, node, frame):
        return {self.eval(e, frame) for e in node.elts}

    def _dict(self, node, frame):
        if any(k is None for k in node.keys):
            raise FormulaError("`**` in a dict")
        return {self.eval(k, frame): self.eval(v, frame)
                for k, v in zip(node.keys, node.values)}

    def _subscript(self, node, frame):
        value = self.eval(node.value, frame)
        if not isinstance(value, (tuple, list, dict, str, range)):
            raise FormulaError(f"indexing a {type(value).__name__}")
        return value[self.eval(node.slice, frame)]

    def _lambda(self, node, frame):
        return _Function(self, "<lambda>", node.args, node.body,
                         frame if frame["locals"] is not self.globals
                         else None, True)

    def _comprehension(self, node, frame):
        items = self.comprehend(node.generators, frame,
                                lambda f: self.eval(node.elt, f))
        return set(items) if isinstance(node, ast.SetComp) else items

    def _joinedstr(self, node, frame):
        return "".join(self.eval(v, frame) if isinstance(v, ast.Constant)
                       else self.eval_format(v, frame)
                       for v in node.values)

    def eval_format(self, node: ast.FormattedValue, frame) -> str:
        value = self.eval(node.value, frame)
        spec = "" if node.format_spec is None \
            else self.eval(node.format_spec, frame)
        if not isinstance(value, (int, str)) or node.conversion != -1 \
                or not isinstance(spec, str) or len(spec) > 16:
            raise FormulaError("a format outside the formula subset")
        return format(value, spec)

    def comprehend(self, generators, frame, make) -> List[Any]:
        scope = {"locals": {}, "outer": frame, "yields": None}
        out: List[Any] = []

        def level(i: int) -> None:
            if i == len(generators):
                out.append(make(scope))
                return
            gen = generators[i]
            if gen.is_async:
                raise FormulaError("async comprehension")
            for item in self.iterate(self.eval(gen.iter, scope)):
                self.assign(gen.target, item, scope)
                if all(self.eval(c, scope) for c in gen.ifs):
                    level(i + 1)

        level(0)
        return out

    def eval_call(self, node: ast.Call, frame) -> Any:
        if isinstance(node.func, ast.Attribute):
            fn = _method(self.eval(node.func.value, frame), node.func.attr)
        else:
            fn = self.eval(node.func, frame)
            if not isinstance(fn, (_Function, _ExcType)) \
                    and not any(fn is b for b in self.builtins.values()):
                raise FormulaError(f"calling a {type(fn).__name__}")
        args: List[Any] = []
        for a in node.args:
            if isinstance(a, ast.Starred):
                args.extend(self.iterate(self.eval(a.value, frame)))
            else:
                args.append(self.eval(a, frame))
        kwargs = {}
        for kw in node.keywords:
            if kw.arg is None:
                raise FormulaError("`**` in a call")
            kwargs[kw.arg] = self.eval(kw.value, frame)
        try:
            return self._int(fn(*args, **kwargs))
        except (FormulaError, _Raised, _Return):
            raise
        except (TypeError, ValueError, ArithmeticError, KeyError,
                IndexError) as e:
            raise FormulaError(f"a call failed: {type(e).__name__}: {e}") \
                from None


_EVAL = {
    ast.Constant: Interpreter._constant, ast.Name: Interpreter._name,
    ast.BinOp: Interpreter._binop, ast.UnaryOp: Interpreter._unaryop,
    ast.Compare: Interpreter._compare, ast.BoolOp: Interpreter._boolop,
    ast.IfExp: Interpreter._ifexp, ast.Call: Interpreter.eval_call,
    ast.Tuple: Interpreter._tuple, ast.List: Interpreter._list,
    ast.Set: Interpreter._set, ast.Dict: Interpreter._dict,
    ast.Subscript: Interpreter._subscript, ast.Lambda: Interpreter._lambda,
    ast.ListComp: Interpreter._comprehension,
    ast.SetComp: Interpreter._comprehension,
    ast.GeneratorExp: Interpreter._comprehension,
    ast.JoinedStr: Interpreter._joinedstr,
}

#: the builtins a formula may call
BUILTINS: Dict[str, Any] = {
    "range": range, "len": len, "sum": sum, "max": max, "min": min,
    "sorted": sorted, "set": set, "list": list, "tuple": tuple,
}


def interpret(tree: ast.Module, max_steps: int = MAX_STEPS
              ) -> "tuple[Interpreter, Dict[str, Any]]":
    """Run ``tree`` in the subset: the interpreter and the module's
    globals. Raises :class:`FormulaError`."""
    interp = Interpreter(max_steps)
    try:
        return interp, interp.run(tree)
    except _Raised as e:
        raise FormulaError(f"the module raised {e}") from None
    except (TypeError, ValueError, ArithmeticError, KeyError, IndexError,
            RecursionError) as e:
        raise FormulaError(f"{type(e).__name__}: {e}") from None
