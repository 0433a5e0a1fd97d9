"""What one run holds: its cell and arguments, the host spans and trace
it recorded, the work its window did, and what its check compared."""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .registry import Cell
from .spans import Spans
from .trace import TraceSummary, Tracer


@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    traced: bool
    device: object                       # torch.device
    #: the configuration's lower-precision control in the program's place
    control: bool = False
    spans: Spans = field(default_factory=Spans)
    tracer: Optional[Tracer] = None
    #: set-up facts: seconds of its parts (``pack_s``, ``nvcc_s``, ...)
    setup: Dict[str, float] = field(default_factory=dict)
    #: the work one unit does, for the readers (slots, rows, rank, ...)
    shape: Dict[str, float] = field(default_factory=dict)
    #: host clock (``time.perf_counter``) at the measured window's ends
    window: Tuple[float, float] = (0.0, 0.0)
    #: end-to-end values by metric name
    e2e: Dict[str, float] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    #: (name, value, limit) of every number the check compared
    checks: List[Tuple[str, float, float]] = field(default_factory=list)
    summary: Optional[TraceSummary] = None

    @property
    def cuda(self) -> bool:
        return getattr(self.device, "type", "cpu") == "cuda"

    def note(self, line: str) -> None:
        """A line of the run's report (standard error), before the
        result."""
        print(f"portbench: {line}", file=sys.stderr, flush=True)

    def sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    @property
    def correct(self) -> bool:
        """Every compared number finite and within its limit, and at
        least one compared."""
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for _, v, lim in self.checks)

    def traced_window(self) -> Optional[Tuple[float, float]]:
        """The host interval of the traced sub-window, if any."""
        return None if self.summary is None else self.summary.host
