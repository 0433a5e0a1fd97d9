"""Faults planted underneath the timed path, for the check's own tests
and for reading what each fault reads at a cell's size
(``readings.py --fault``): each breaks the program as a faulty change
could, and the check has to come out not correct.

Each fault takes ``setattr``-like ``patch(obj, name, value)`` and
replaces one function of the program. One card holds each cell, so no
exchange between cards exists to leave out.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def no_iterations(patch) -> None:
    """Training: every step returns its state unchanged (the initial
    draw comes back)."""
    from predictionio_tpu_torch.templates import _common

    orig = _common.train_als

    def train_als(ratings, params, **kw):
        return orig(ratings, dataclasses.replace(params, num_iterations=0),
                    **kw)

    patch(_common, "train_als", train_als)


def half_the_ratings(patch) -> None:
    """Training: each row's normal equations from the first half of its
    ratings only."""
    from predictionio_tpu_torch.models import als

    orig = als._update_block

    def update_block(fixed, G, indices, values, counts, *a, **kw):
        return orig(fixed, G, indices, values, counts // 2, *a, **kw)

    patch(als, "_update_block", update_block)


def one_factor_altered(patch) -> None:
    """Training: one entry of each half-step's new factors altered."""
    from predictionio_tpu_torch.models import als

    orig = als._update_side

    def update_side(*a, **kw):
        out = orig(*a, **kw)
        out[0, 0] += 1.0
        return out

    patch(als, "_update_side", update_side)


def stale_flush(patch) -> None:
    """Scoring: each flush answers with the previous flush's result."""
    from predictionio_tpu_torch.models import als

    orig = als.recommend_batch_async
    last = []

    def recommend_batch_async(model, users, k):
        now = orig(model, users, k)()
        prev = last[-1] if last else now
        last.append(now)
        return lambda: prev

    patch(als, "recommend_batch_async", recommend_batch_async)


def half_the_flush(patch) -> None:
    """Scoring: half of each flush left out, its rows answered with the
    other half's."""
    from predictionio_tpu_torch.models import als

    orig = als.recommend_batch_async

    def recommend_batch_async(model, users, k):
        h = len(users) // 2
        ids, scores = orig(model, users[:len(users) - h], k)()
        return lambda: (np.concatenate([ids, ids[:h]]),
                        np.concatenate([scores, scores[:h]]))

    patch(als, "recommend_batch_async", recommend_batch_async)


def one_id_altered(patch) -> None:
    """Scoring: one served id of each launch altered where the kernel
    produces it."""
    from predictionio_tpu_torch.models import als

    orig = als.fused_topk

    def fused_topk(*a, **kw):
        scores, ids = orig(*a, **kw)
        ids = ids.clone()
        ids[0, 0] = (ids[0, 0] + 1) % kw["n_items"]
        return scores, ids

    patch(als, "fused_topk", fused_topk)


#: the faults of each loop, by name
FAULTS = {
    "train": {"state-unchanged": no_iterations,
              "half-the-ratings": half_the_ratings,
              "answer-altered": one_factor_altered},
    "score": {"state-unchanged": stale_flush,
              "half-the-flush": half_the_flush,
              "answer-altered": one_id_altered},
}
