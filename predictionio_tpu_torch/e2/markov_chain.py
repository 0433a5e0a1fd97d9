"""Top-N Markov chain over transition tallies (the port of
``predictionio_tpu/e2/markov_chain.py``).

Behavior parity with
``e2/src/main/scala/org/apache/predictionio/e2/engine/MarkovChain.scala``
(train :33-56, predict :69-87): each row is normalized by its FULL tally
total, then only the top-N probabilities are kept (so a row's kept mass
may sum to < 1 — reference semantics, e.g. row total 25 keeping 9/25 and
8/25). Ties keep the lower column index (the reference's stable
``sortBy`` over column-ordered entries).

The model is a pair of dense ``[n_states, top_n]`` arrays (column
indices + probabilities, −1/0 padding); ``predict`` is one
``index_add_`` on ``device`` (the card unless the caller asks for the
CPU), in f32. On the card the order of the summation is not fixed, so
two calls may differ in the last bits.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device


class MarkovChainModel:
    def __init__(self, indices: np.ndarray, probs: np.ndarray,
                 n_states: int, top_n: int):
        #: [S, top_n] destination state per kept transition (−1 = pad)
        self.indices = indices
        #: [S, top_n] transition probability (0 at pads)
        self.probs = probs
        self.n_states = n_states
        self.n = top_n
        self._predictor = None

    def row(self, state: int):
        """Kept (destination, probability) pairs for a state, by column."""
        keep = self.indices[state] >= 0
        return list(zip(self.indices[state][keep].tolist(),
                        self.probs[state][keep].tolist()))

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_predictor"] = None  # cached device tensors stay behind
        return state

    def predict(self, current_state: Sequence[float],
                device: DeviceLike = None) -> np.ndarray:
        """Next-state distribution: currentᵀ · T over the kept entries,
        on ``device``.

        Computed in float32; expect ~1e-7 relative error vs the float64
        ``row()`` values.
        """
        dev = resolve_device(device)
        if self._predictor is None or self._predictor[0] != dev:
            self._predictor = (
                dev,
                torch.as_tensor(np.where(self.indices < 0, 0, self.indices)
                                .reshape(-1), dtype=torch.long, device=dev),
                torch.as_tensor(self.probs, dtype=torch.float32,
                                device=dev))
        _, idx, prb = self._predictor
        cur = torch.as_tensor(np.asarray(current_state, dtype=np.float32),
                              device=dev)
        contrib = prb * cur[:, None]  # [S, top_n]
        out = torch.zeros_like(cur).index_add_(0, idx, contrib.reshape(-1))
        return out.cpu().numpy()


def train_markov_chain(rows: Sequence[int], cols: Sequence[int],
                       tallies: Sequence[float], n_states: int,
                       top_n: int) -> MarkovChainModel:
    """Build the model from COO transition tallies (duplicates summed)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    tallies = np.asarray(tallies, dtype=np.float64)

    # O(nnz) duplicate aggregation: unique (row, col) keys, sorted, so each
    # row's entries are contiguous and ascending by column
    keys = rows * np.int64(n_states) + cols
    uniq, inverse = np.unique(keys, return_inverse=True)
    vals = np.zeros(len(uniq), dtype=np.float64)
    np.add.at(vals, inverse, tallies)
    urows = uniq // n_states
    ucols = (uniq % n_states).astype(np.int32)
    row_ids, starts = np.unique(urows, return_index=True)
    ends = np.append(starts[1:], len(uniq))

    indices = np.full((n_states, top_n), -1, dtype=np.int32)
    probs = np.zeros((n_states, top_n), dtype=np.float64)
    for r, s0, s1 in zip(row_ids, starts, ends):
        c, v = ucols[s0:s1], vals[s0:s1]
        total = v.sum()
        # stable sort by descending tally → ties keep lower column index;
        # kept entries re-sorted by column (reference :40-44)
        kept = np.sort(np.argsort(-v, kind="stable")[:top_n])
        indices[r, :kept.size] = c[kept]
        probs[r, :kept.size] = v[kept] / total
    return MarkovChainModel(indices, probs, n_states, top_n)
