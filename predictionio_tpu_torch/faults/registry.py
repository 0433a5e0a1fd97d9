"""The fault registry: named injection points, seeded schedules (the
port's own copy of ``predictionio_tpu/faults/registry.py``).

- **Fast when off.** ``fire()`` is one module-global bool check until a
  spec is armed; instrumented paths pay nothing in production.
- **Deterministic.** Every spec owns a ``random.Random(seed)``: a
  ``rate=0.3,seed=7`` schedule injects the *same* sequence of fires on
  every run.
- **Scriptable from outside.** ``PTPU_FAULTS`` (and
  ``ServerConfig.faults`` / ``deploy --faults``) carries a spec grammar so
  a drill can arm a child process it is about to start::

      PTPU_FAULTS="stream.pass=error,after=2;stream.pass=latency,delay_ms=50"

  Grammar: ``point=mode[,key=value...]`` joined by ``;``. Modes:
  ``error`` (raise :class:`FaultError`), ``latency`` (sleep
  ``delay_ms`` then proceed), ``crash`` (``os._exit(42)``). Keys:
  ``rate`` (probability per matching fire, default 1), ``times`` (stop
  after N injections, default unlimited), ``after`` (skip the first N
  matching fires), ``delay_ms``, ``seed``, and any other key is a label
  match (``stream.pass=error,consumer=a`` only fails consumer a).
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from dataclasses import dataclass, field
from fnmatch import fnmatchcase
from typing import Callable, Dict, List, Optional

log = logging.getLogger(__name__)

#: exit code of a ``crash``-mode injection — drills assert on it to
#: tell a scripted preemption from a real interpreter fault
CRASH_EXIT_CODE = 42

#: catalog of declared injection points (name → description), built by
#: the instrumented modules at import time
POINTS: Dict[str, str] = {}


def declare(point: str, description: str) -> str:
    """Register an injection point in the catalog (idempotent)."""
    POINTS.setdefault(point, description)
    return point


class FaultError(RuntimeError):
    """An injected failure (mode=``error``). Carries the point name so
    handlers/telemetry can attribute it."""

    def __init__(self, point: str, message: str = ""):
        super().__init__(message or f"injected fault at {point}")
        self.point = point


@dataclass
class FaultSpec:
    """One armed injection: where, how, and on what schedule."""

    point: str                 # point name or fnmatch glob
    mode: str = "error"        # error | latency | crash
    rate: float = 1.0          # probability per matching fire
    times: int = -1            # max injections (-1 = unlimited)
    after: int = 0             # skip the first N matching fires
    delay_ms: float = 0.0      # latency mode: sleep this long
    seed: int = 0              # deterministic schedule
    message: str = ""
    match: Dict[str, str] = field(default_factory=dict)  # label filters

    def __post_init__(self) -> None:
        if self.mode not in ("error", "latency", "crash"):
            raise ValueError(
                f"fault mode must be error|latency|crash, got "
                f"{self.mode!r}")
        if not (0.0 <= self.rate <= 1.0):
            raise ValueError(f"fault rate must be in [0,1]: {self.rate}")


class _Armed:
    """A spec plus its live schedule state."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self.rng = random.Random(spec.seed)
        self.seen = 0       # matching fires observed
        self.injected = 0   # injections delivered

    def decide(self, point: str, labels: Dict[str, str]) -> bool:
        s = self.spec
        if not fnmatchcase(point, s.point):
            return False
        for k, v in s.match.items():
            if str(labels.get(k)) != v:
                return False
        self.seen += 1
        if self.seen <= s.after:
            return False
        if s.times >= 0 and self.injected >= s.times:
            return False
        if s.rate < 1.0 and self.rng.random() >= s.rate:
            return False
        self.injected += 1
        return True


class FaultRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._armed: List[_Armed] = []
        self._env_loaded = False
        self._fired: Dict[str, int] = {}       # point -> fires observed
        self._injections: Dict[str, int] = {}  # "point|mode" -> count
        self._listeners: List[Callable[[str, str], None]] = []

    # -- arming ------------------------------------------------------------
    def inject(self, spec: FaultSpec) -> FaultSpec:
        global _ACTIVE
        with self._lock:
            self._armed.append(_Armed(spec))
            _ACTIVE = True
        log.warning("fault armed: %s mode=%s rate=%s times=%s after=%s "
                    "match=%s", spec.point, spec.mode, spec.rate,
                    spec.times, spec.after, spec.match)
        return spec

    def clear(self, point: Optional[str] = None) -> int:
        """Disarm every spec (or only those for ``point``); returns how
        many were removed."""
        global _ACTIVE
        with self._lock:
            before = len(self._armed)
            if point is None:
                self._armed = []
            else:
                self._armed = [a for a in self._armed
                               if a.spec.point != point]
            _ACTIVE = bool(self._armed)
            return before - len(self._armed)

    def load_env(self, env_var: str = "PTPU_FAULTS") -> None:
        """Arm specs from the environment ONCE per process."""
        with self._lock:
            if self._env_loaded:
                return
            self._env_loaded = True
        raw = os.environ.get(env_var, "")
        if not raw:
            return
        for spec in parse_specs(raw):
            self.inject(spec)

    # -- firing ------------------------------------------------------------
    def fire(self, point: str, **labels) -> None:
        with self._lock:
            self._fired[point] = self._fired.get(point, 0) + 1
            hits = [a for a in self._armed if a.decide(point, labels)]
            for a in hits:
                key = f"{point}|{a.spec.mode}"
                self._injections[key] = self._injections.get(key, 0) + 1
            listeners = list(self._listeners) if hits else []
        for a in hits:
            for cb in listeners:
                try:
                    cb(point, a.spec.mode)
                except Exception:  # noqa: BLE001 — telemetry only
                    log.exception("fault listener failed")
        for a in hits:
            mode = a.spec.mode
            if mode == "latency":
                time.sleep(max(a.spec.delay_ms, 0.0) / 1000.0)
            elif mode == "crash":
                log.error("injected crash at %s (exit %d)", point,
                          CRASH_EXIT_CODE)
                # the preemption simulator: no atexit, no finally, the
                # process is gone as after kill -9
                os._exit(CRASH_EXIT_CODE)
            else:
                raise FaultError(point, a.spec.message)


    # -- observability -----------------------------------------------------
    def add_listener(self, cb: Callable[[str, str], None]) -> None:
        """``cb(point, mode)`` on every delivered injection (metrics)."""
        with self._lock:
            self._listeners.append(cb)

    def remove_listener(self, cb: Callable[[str, str], None]) -> None:
        with self._lock:
            if cb in self._listeners:
                self._listeners.remove(cb)

    def enabled(self) -> bool:
        with self._lock:
            return bool(self._armed)

    def status(self) -> dict:
        with self._lock:
            return {
                "enabled": bool(self._armed),
                "armed": [{
                    "point": a.spec.point, "mode": a.spec.mode,
                    "rate": a.spec.rate, "times": a.spec.times,
                    "after": a.spec.after, "match": dict(a.spec.match),
                    "seen": a.seen, "injected": a.injected,
                } for a in self._armed],
                "fired": dict(self._fired),
                "injections": dict(self._injections),
            }


def parse_specs(raw: str) -> List[FaultSpec]:
    """Parse the ``PTPU_FAULTS`` grammar (module docstring)."""
    out: List[FaultSpec] = []
    for chunk in raw.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        point, _, rest = chunk.partition("=")
        if not point or not rest:
            raise ValueError(
                f"bad fault spec {chunk!r} (want point=mode[,k=v...])")
        parts = rest.split(",")
        kwargs: dict = {"point": point.strip(), "mode": parts[0].strip()}
        match: Dict[str, str] = {}
        for kv in parts[1:]:
            k, _, v = kv.partition("=")
            k, v = k.strip(), v.strip()
            if not k or not v:
                raise ValueError(f"bad fault option {kv!r} in {chunk!r}")
            if k in ("rate", "delay_ms"):
                kwargs[k] = float(v)
            elif k in ("times", "after", "seed"):
                kwargs[k] = int(v)
            elif k == "message":
                kwargs[k] = v
            else:
                match[k] = v
        kwargs["match"] = match
        out.append(FaultSpec(**kwargs))
    return out


#: the ONE fast-path gate: False means fire() returns before touching the
#: registry lock
_ACTIVE = False

_REGISTRY = FaultRegistry()
_REGISTRY.load_env()


def registry() -> FaultRegistry:
    return _REGISTRY


def fire(point: str, **labels) -> None:
    """The instrumented-site entry: no-op unless something is armed."""
    if not _ACTIVE:
        return
    _REGISTRY.fire(point, **labels)


def inject(point: str, mode: str = "error", **kwargs) -> FaultSpec:
    return _REGISTRY.inject(FaultSpec(point=point, mode=mode, **kwargs))


def clear(point: Optional[str] = None) -> int:
    return _REGISTRY.clear(point)


def inject_spec(raw: str) -> List[FaultSpec]:
    """Arm every spec in a ``PTPU_FAULTS``-grammar string."""
    return [_REGISTRY.inject(s) for s in parse_specs(raw)]


def enabled() -> bool:
    return _REGISTRY.enabled()


def status() -> dict:
    return _REGISTRY.status()
