"""Fault injection for failure drills (the port's own copy of the
registry in ``predictionio_tpu/faults/``).

A process-wide registry of *named injection points*: an instrumented
site calls :func:`fire`, a single global-bool check until something is
injected. The port instruments the stream trainer's pass
(``stream.pass``) and the REMOTE storage client's requests
(``storage.remote``); the other points of the JAX package wait for their
subsystems (``ROADMAP.md`` queue 1 item 11).
"""

from .registry import (
    FaultError,
    FaultSpec,
    POINTS,
    clear,
    declare,
    fire,
    inject,
    parse_specs,
)

__all__ = [
    "FaultError",
    "FaultSpec",
    "POINTS",
    "clear",
    "declare",
    "fire",
    "inject",
    "parse_specs",
]
