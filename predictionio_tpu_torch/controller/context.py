"""Workflow context: what flows through every DASE stage (the port of
``predictionio_tpu/controller/context.py``).

A :class:`Context` names the device training runs on (the card unless
the caller asks for the CPU), the seed and the workflow options. It has
no mesh and no storage yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from ..utils.device import DeviceLike


@dataclass
class Context:
    """Execution context for training."""

    device: DeviceLike = None
    seed: int = 0
    app_name: str = ""
    stop_after_read: bool = False
    stop_after_prepare: bool = False
    skip_sanity_check: bool = False
    #: wall-clock seconds per stage (read_s, prepare_s, algo_train_s),
    #: filled as training runs (``ALSAlgorithm.train`` returns only once
    #: its work on the card has finished, so algo_train_s covers it)
    stage_timings: Dict[str, float] = field(default_factory=dict)
