"""One-hot binary vectorizer over (property, value) pairs (the port's
copy of ``predictionio_tpu/e2/vectorizer.py``).

Behavior parity with
``e2/src/main/scala/org/apache/predictionio/e2/engine/BinaryVectorizer.scala``
(:27-63): a fixed (property, value) → column map built from training
data; vectorizing a point sets 1.0 at each known pair's column and
ignores unknown pairs. Where the reference's ``.distinct.collect`` order
is nondeterministic, this build uses first-seen order (deterministic).

``to_matrix`` emits one dense float32 ``[B, F]`` batch, the layout a
downstream classifier takes.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Sequence, Set, Tuple

import numpy as np

Pair = Tuple[str, str]


class BinaryVectorizer:
    def __init__(self, property_map: Dict[Pair, int]):
        self.property_map = dict(property_map)
        self.num_features = len(self.property_map)
        #: column order, for introspection (reference ``properties`` array)
        self.properties: List[Pair] = [
            p for p, _ in sorted(self.property_map.items(),
                                 key=lambda kv: kv[1])]

    def __repr__(self) -> str:
        pairs = ",".join(f"({k}, {v})" for k, v in self.properties)
        return f"BinaryVectorizer({self.num_features}): {pairs}"

    def to_binary(self, pairs: Sequence[Pair]) -> np.ndarray:
        """[F] float32 with 1.0 at each known pair's column."""
        vec = np.zeros(self.num_features, dtype=np.float32)
        for p in pairs:
            idx = self.property_map.get(p)
            if idx is not None:
                vec[idx] = 1.0
        return vec

    def to_matrix(self, batch: Sequence[Sequence[Pair]]) -> np.ndarray:
        """[B, F] float32 one-hot batch."""
        out = np.zeros((len(batch), self.num_features), dtype=np.float32)
        for b, pairs in enumerate(batch):
            for p in pairs:
                idx = self.property_map.get(p)
                if idx is not None:
                    out[b, idx] = 1.0
        return out

    @staticmethod
    def from_maps(maps: Iterable[Mapping[str, str]],
                  properties: Set[str]) -> "BinaryVectorizer":
        """Build from property dicts, keeping only names in ``properties``
        (reference object.apply over RDD[HashMap] :47-57)."""
        seen: Dict[Pair, int] = {}
        for m in maps:
            for k, v in m.items():
                if k in properties and (k, v) not in seen:
                    seen[(k, v)] = len(seen)
        return BinaryVectorizer(seen)

    @staticmethod
    def from_pairs(pairs: Sequence[Pair]) -> "BinaryVectorizer":
        """Build with explicit column order (reference apply(Seq) :59-62)."""
        return BinaryVectorizer({p: i for i, p in enumerate(pairs)})
