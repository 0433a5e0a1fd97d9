"""Seeds of a run's parts, derived from ``--seed`` and a key, so that one
seed gives the same inputs in every run and each part draws its own."""

from __future__ import annotations

import zlib

import numpy as np


def derive(seed: int, *keys) -> int:
    """A 32-bit seed for the part named by ``keys`` (strings or whole
    numbers) of the run seeded with ``seed`` (any whole number)."""
    words = [int(seed) % (1 << 64)]
    for k in keys:
        words.append(zlib.crc32(k.encode()) if isinstance(k, str)
                     else int(k) % (1 << 64))
    return int(np.random.SeedSequence(words).generate_state(1, np.uint32)[0])


def rng(seed: int, *keys) -> np.random.Generator:
    """A numpy generator for the part named by ``keys``."""
    return np.random.default_rng(derive(seed, *keys))
