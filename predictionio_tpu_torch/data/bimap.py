"""Bidirectional maps for id indexation: the port's own copy of
``predictionio_tpu/data/bimap.py``.

Templates index string entity ids into dense 0-based integer ids, which
are the row indices of the factor tables on the card.
"""

from __future__ import annotations

from typing import Dict, Generic, Iterable, Mapping, Sequence, TypeVar

import numpy as np

K = TypeVar("K")
V = TypeVar("V")


class BiMap(Generic[K, V]):
    """Immutable one-to-one mapping with O(1) forward and inverse lookup."""

    def __init__(self, forward: Mapping[K, V]):
        self._fwd: Dict[K, V] = dict(forward)
        if len(set(self._fwd.values())) != len(self._fwd):
            raise ValueError("BiMap values must be unique")
        self._rev: Dict[V, K] = {v: k for k, v in self._fwd.items()}

    def __getitem__(self, k: K) -> V:
        return self._fwd[k]

    def get(self, k: K, default=None):
        return self._fwd.get(k, default)

    def __contains__(self, k: K) -> bool:
        return k in self._fwd

    def __len__(self) -> int:
        return len(self._fwd)

    def __iter__(self):
        return iter(self._fwd)

    def items(self):
        return self._fwd.items()

    def keys(self):
        return self._fwd.keys()

    def values(self):
        return self._fwd.values()

    @property
    def inverse(self) -> "BiMap[V, K]":
        """The inverted map."""
        inv = BiMap.__new__(BiMap)
        inv._fwd = self._rev
        inv._rev = self._fwd
        return inv

    def take(self, keys: Iterable[K]) -> "BiMap[K, V]":
        return BiMap({k: self._fwd[k] for k in keys if k in self._fwd})

    def to_dict(self) -> Dict[K, V]:
        return dict(self._fwd)

    @staticmethod
    def string_int(keys: Iterable[str]) -> "BiMap[str, int]":
        """Dense 0-based int ids in first-seen order over unique keys."""
        fwd: Dict[str, int] = {}
        for k in keys:
            if k not in fwd:
                fwd[k] = len(fwd)
        return BiMap(fwd)

    string_long = string_int

    def map_array(self, keys: Sequence[K], missing: int = -1) -> np.ndarray:
        """Vectorized lookup of many keys -> int64 array; absent keys map to
        ``missing``."""
        return np.fromiter((self._fwd.get(k, missing) for k in keys),
                           dtype=np.int64, count=len(keys))
