"""Where the run keeps its caches, the card it needs, and the modules it
may not load.

Every cache of the program lives at a fixed directory under
``portbench/.cache/`` inside the checkout, so only a checkout's first run
builds: the port's ``nvcc`` libraries (``PTPU_ARTIFACT_DIR``), Triton's
cache, PyTorch's extension cache, CUDA's JIT cache, and the dataset
(``harness/dataset.py``).
"""

from __future__ import annotations

import os
import sys
from typing import Iterable, List

from .registry import BENCH

CACHE = BENCH / ".cache"

#: environment variable -> directory under the cache
CACHE_ENV = {
    "PTPU_ARTIFACT_DIR": "artifacts",
    "TRITON_CACHE_DIR": "triton",
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
    "CUDA_CACHE_PATH": "cuda",
}

#: top-level module names a run may not load: JAX, its libraries, and
#: the JAX package the port was made from (compared whole, since the
#: port's own name begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "predictionio_tpu")


def set_cache_env() -> dict:
    """Point every cache at its fixed directory under the checkout, over
    whatever the environment said. Returns the settings."""
    out = {}
    for var, sub in CACHE_ENV.items():
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
        out[var] = str(path)
    return out


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: what
    ``sys.modules`` holds), each compared whole: the part of a module's
    name before its first dot."""
    names = list(sys.modules) if names is None else names
    tops = {n.split(".", 1)[0] for n in names}
    return sorted(tops.intersection(FORBIDDEN))


class NoCard(SystemExit):
    """The run needs more CUDA cards than this machine shows."""


def require_cards(chips: int) -> None:
    """Exit (code 2, no result) unless ``chips`` CUDA cards are here."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("portbench: no CUDA card (torch.cuda.is_available() "
                     "is false); the benchmark never runs on the CPU")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"portbench: the cell needs {chips} cards, "
                     f"torch.cuda.device_count() is "
                     f"{torch.cuda.device_count()}")
