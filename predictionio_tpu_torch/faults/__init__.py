"""Fault injection for failure drills (the port's own copy of the
registry in ``predictionio_tpu/faults/``).

A process-wide registry of *named injection points*: an instrumented
site calls :func:`fire`, a single global-bool check until something is
injected. The port's points: ``serving.dispatch`` (the engine server's
batch dispatch), ``storage.io`` (MEMORY and SQLite reads and writes),
``storage.remote`` (the REMOTE client's requests), ``stream.pass`` (the
stream trainer's pass) and ``checkpoint.save`` / ``checkpoint.commit`` /
``checkpoint.restore`` (``workflow/checkpoint.py``). Armed from
``PTPU_FAULTS``, ``ServerConfig.faults``, ``deploy --faults`` or
:func:`inject_spec`; :func:`status` reports what is armed and what fired.
"""

from .registry import (
    FaultError,
    FaultSpec,
    POINTS,
    clear,
    declare,
    enabled,
    fire,
    inject,
    inject_spec,
    parse_specs,
    registry,
    status,
)

__all__ = [
    "FaultError",
    "FaultSpec",
    "POINTS",
    "clear",
    "declare",
    "enabled",
    "fire",
    "inject",
    "inject_spec",
    "parse_specs",
    "registry",
    "status",
]
