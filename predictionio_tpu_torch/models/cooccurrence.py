"""Item-item co-occurrence top-N (the port of
``predictionio_tpu/models/cooccurrence.py``).

Distinct (user, item) pairs, the co-occurrence count of every item pair,
the top-N neighbours of each item. The counts are ``AᵀA`` for the 0/1
user x item incidence matrix A: one ``torch.matmul`` on the entry's
device (the card unless the caller names the CPU), the diagonal zeroed,
then the top-N of each row. Past ``_DENSE_CELL_LIMIT`` cells in A or in
``AᵀA`` a host path accumulates each basket's pairs instead.

The order is total and the same on both paths: descending count, ties
by the lower item index (what ``lax.top_k`` gives the JAX package's
dense path). The product is exact: A is 0/1 and every count stays under
2^24, so f32 sums of ones (even at TF32's input precision) are integers.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device

# the dense path holds an [n_users, n_items] incidence matrix AND an
# [n_items, n_items] count matrix; past this many cells in either, the
# per-basket host path runs (O(sum of basket^2) time, O(pairs) memory)
_DENSE_CELL_LIMIT = 64 * 1024 * 1024


class CooccurrenceModel:
    def __init__(self, indices: np.ndarray, counts: np.ndarray,
                 n_items: int, top_n: int):
        #: [I, k] neighbour item index (-1 = pad)
        self.indices = indices
        #: [I, k] co-occurrence count (0 at pads)
        self.counts = counts
        self.n_items = n_items
        self.n = top_n

    def neighbors(self, item: int) -> List[Tuple[int, int]]:
        keep = self.indices[item] >= 0
        return list(zip(self.indices[item][keep].tolist(),
                        self.counts[item][keep].astype(int).tolist()))

    def score_items(self, query_items: Sequence[int]) -> Dict[int, float]:
        """Neighbour counts summed over the query items."""
        out: Dict[int, float] = {}
        for q in query_items:
            if 0 <= q < self.n_items:
                for j, c in self.neighbors(q):
                    out[j] = out.get(j, 0.0) + c
        return out


def train_cooccurrence(users: np.ndarray, items: np.ndarray,
                       n_users: int, n_items: int, top_n: int,
                       device: DeviceLike = None) -> CooccurrenceModel:
    """``users``/``items``: parallel arrays of (user, item) indices of view
    events. The dense path runs on ``device`` (the card by default)."""
    users = np.asarray(users, dtype=np.int64)
    items = np.asarray(items, dtype=np.int64)
    # distinct (user, item): repeated views count once
    pairs = np.unique(users * np.int64(n_items) + items)
    pu = pairs // n_items
    pi = (pairs % n_items).astype(np.int64)

    if (n_users * n_items <= _DENSE_CELL_LIMIT
            and n_items * n_items <= _DENSE_CELL_LIMIT):
        k = min(top_n, max(n_items - 1, 1))
        indices, counts = _dense_topk(pu, pi, n_users, n_items, k,
                                      resolve_device(device))
        # zero-count neighbours are pads
        indices = np.where(counts > 0, indices, -1).astype(np.int32)
        counts = np.where(counts > 0, counts, 0).astype(np.float32)
        return CooccurrenceModel(indices, counts, n_items, top_n)
    return _sparse_topn(pu, pi, n_items, top_n)


def _dense_topk(pu: np.ndarray, pi: np.ndarray, n_users: int, n_items: int,
                k: int, dev: torch.device) -> Tuple[np.ndarray, np.ndarray]:
    """``AᵀA`` on ``dev``, diagonal zeroed, then each row's top ``k``
    under the total order: the int64 key ``count * I + (I - 1 - index)``
    is unique within a row, so ``topk`` has no ties to break."""
    A = torch.zeros((n_users, n_items), dtype=torch.float32, device=dev)
    A[torch.from_numpy(pu).to(dev), torch.from_numpy(pi).to(dev)] = 1.0
    cooc = torch.matmul(A.T, A)
    del A
    cooc.fill_diagonal_(0)
    rev = (n_items - 1) - torch.arange(n_items, dtype=torch.int64,
                                       device=dev)
    key = cooc.to(torch.int64) * n_items + rev
    del cooc
    top = torch.topk(key, k, dim=1, sorted=True).values.cpu().numpy()
    counts = (top // n_items).astype(np.float32)
    indices = (n_items - 1) - top % n_items
    return indices, counts


def _sparse_topn(pu: np.ndarray, pi: np.ndarray, n_items: int,
                 top_n: int) -> CooccurrenceModel:
    """Host path for large catalogues: per-item neighbour dicts, never a
    dense matrix. Memory is O(distinct co-occurring pairs)."""
    order = np.argsort(pu, kind="stable")
    pu, pi = pu[order], pi[order]
    starts = np.flatnonzero(np.r_[True, pu[1:] != pu[:-1]])
    ends = np.r_[starts[1:], len(pu)]
    neigh: Dict[int, Dict[int, int]] = defaultdict(lambda: defaultdict(int))
    for s, e in zip(starts, ends):
        basket = pi[s:e].tolist()
        for a in basket:
            row = neigh[a]
            for b in basket:
                if b != a:
                    row[b] += 1
    indices = np.full((n_items, top_n), -1, dtype=np.int32)
    counts = np.zeros((n_items, top_n), dtype=np.float32)
    for a, row in neigh.items():
        # descending count, ties by the lower item index
        top = sorted(row.items(), key=lambda kv: (-kv[1], kv[0]))[:top_n]
        for j, (b, c) in enumerate(top):
            indices[a, j] = b
            counts[a, j] = c
    return CooccurrenceModel(indices, counts, n_items, top_n)
