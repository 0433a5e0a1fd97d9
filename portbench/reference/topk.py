"""Plain top-k in float64: what a served flush has to hold.

For each judged user the reference scores every item, ``u . v`` over the
same float32 tables in float64, and ranks them. A served answer is its
first ``num`` ids and their scores; it reads

- ``rank_gap``: the widest gap by which the served item at a position
  lies below the reference's item at that position,
- ``score_err``: the widest gap between a served score and the
  reference's score of the same item,

both over the row's best reference score's magnitude. An id outside the
catalogue, an id served twice in a row, a short row or a non-finite
score reads infinite.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def judge(U: np.ndarray, V: np.ndarray, users: np.ndarray,
          ids: np.ndarray, scores: np.ndarray, num: int, device) -> dict:
    n_items = V.shape[0]
    ids = np.asarray(ids)
    scores = np.asarray(scores)
    bad = {"rank_gap": math.inf, "score_err": math.inf}
    k = min(num, n_items)
    if ids.shape != (len(users), k) or scores.shape != ids.shape:
        return bad
    if ids.min() < 0 or ids.max() >= n_items \
            or not np.isfinite(scores).all():
        return bad
    srt = np.sort(ids, axis=1)
    if (srt[:, 1:] == srt[:, :-1]).any():
        return bad
    u = torch.from_numpy(np.asarray(U)[users]).to(device, torch.float64)
    v = torch.from_numpy(np.asarray(V)).to(device, torch.float64)
    S = u @ v.T
    best = torch.topk(S, k, dim=1).values
    idx = torch.from_numpy(ids.astype(np.int64)).to(device)
    served = torch.gather(S, 1, idx)
    scale = best[:, :1].abs().clamp_min(1e-30)
    gap = ((best - served) / scale).max()
    err = ((torch.from_numpy(scores).to(device, torch.float64) - served)
           .abs() / scale).max()
    return {"rank_gap": float(gap), "score_err": float(err)}
