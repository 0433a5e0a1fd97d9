"""Workflow context: what flows through every DASE stage (the port of
``predictionio_tpu/controller/context.py``).

A :class:`Context` names the device training runs on (the card unless
the caller asks for the CPU), or the mesh it lays out over
(``parallel/mesh.py``; None: the device alone, or in a process group of
several processes the global mesh), the seed, the storage the data
source reads and the workflow writes, and the workflow options.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional

import torch

from ..data.storage.registry import Storage, get_storage
from ..data.store import EventStoreFacade
from ..utils.device import DeviceLike, resolve_device


@dataclass
class Context:
    """Execution context for training."""

    device: DeviceLike = None
    seed: int = 0
    app_name: str = ""
    batch: str = ""
    stop_after_read: bool = False
    stop_after_prepare: bool = False
    skip_sanity_check: bool = False
    #: wall-clock seconds per stage (read_s, prepare_s, algo_train_s,
    #: persist_s), filled as training runs (``ALSAlgorithm.train``
    #: returns only once its work on the card has finished, so
    #: algo_train_s covers it)
    stage_timings: Dict[str, float] = field(default_factory=dict)
    _storage: Optional[Storage] = None
    #: the mesh ALS and seqrec train over (``parallel.make_mesh``); None:
    #: ``device``
    mesh: Optional[object] = None

    @property
    def storage(self) -> Storage:
        """The storage given at construction, else the process-wide one
        (built from ``PIO_STORAGE_*`` / ``PIO_HOME``)."""
        return self._storage if self._storage is not None else get_storage()

    @property
    def event_store(self) -> EventStoreFacade:
        return EventStoreFacade(self._storage)

    def rng(self) -> torch.Generator:
        """An explicit generator on ``device`` (the card unless it names
        the CPU), seeded by ``seed``: the same seed gives the same draws
        (never those of the JAX package's ``jax.random.key``)."""
        gen = torch.Generator(device=resolve_device(self.device))
        gen.manual_seed(int(self.seed))
        return gen

    def with_mesh(self):
        """The mesh, laid out by ``parallel.make_mesh()`` (every local
        device on the data axis) when none is set."""
        if self.mesh is None:
            from ..parallel.mesh import local_devices, make_mesh

            self.mesh = make_mesh(devices=local_devices(self.device))
        return self.mesh

    def copy(self, **changes) -> "Context":
        return replace(self, **changes)


def default_context(**kw) -> Context:
    return Context(**kw)
