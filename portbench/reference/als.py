"""Plain ALS in float64: what the recommendation template's training has
to produce, from the ratings and the seed alone.

Semantics (ALS-WR, Zhou et al. 2008; implicit feedback as Hu, Koren and
Volinsky 2008), as the template states them:

- the initial factors are N(0, 1) / sqrt(rank), drawn in float32 by a
  CPU ``torch.Generator`` seeded with the template's ``seed``, the user
  table first and then the item table;
- an iteration solves every user row against the item table, then every
  item row against the new user table;
- explicit: ``(sum_i v_i v_i^T + reg * n_u * I) u = sum_i r_ui v_i`` over
  the user's ``n_u`` ratings; implicit, with ``c = 1 + alpha * r``:
  ``(V^T V + sum_i (c - 1) v_i v_i^T + reg * n_u * I) u = sum_i c v_i``,
  ``V^T V`` over every row of the fixed table;
- a row with no ratings is 0;
- each system is solved with ``1e-6`` added to its diagonal (the
  program's stated solve: ``(A + jitter I) x = b``).

Rows are grouped here by the next power of two of their length and
gathered into padded blocks of at most ``SLOTS`` slots, the reference's
own packing, computed in float64 with a Cholesky solve.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

#: most slots (rows x padded length) a gathered block holds
SLOTS = 1 << 22
#: added to every system's diagonal
JITTER = 1e-6


def initial_factors(seed: int, n_users: int, n_items: int, rank: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The float32 draw a training starts from (module docstring)."""
    gen = torch.Generator().manual_seed(int(seed))
    u = torch.randn((n_users, rank), generator=gen,
                    dtype=torch.float32) / math.sqrt(rank)
    v = torch.randn((n_items, rank), generator=gen,
                    dtype=torch.float32) / math.sqrt(rank)
    return u, v


class Side:
    """One side's ratings as padded blocks: ``(rows, idx, val, mask,
    counts)`` a block, every row with ratings in exactly one block."""

    def __init__(self, rows: np.ndarray, cols: np.ndarray,
                 vals: np.ndarray, n_rows: int, device):
        rows_t = torch.from_numpy(np.asarray(rows, np.int64)).to(device)
        order = torch.argsort(rows_t, stable=True)
        r_s = rows_t[order]
        c_s = torch.from_numpy(np.asarray(cols, np.int64)).to(device)[order]
        v_s = torch.from_numpy(np.asarray(vals, np.float64)).to(device)[order]
        counts = torch.bincount(rows_t, minlength=n_rows)
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.arange(len(r_s), device=device) - starts[r_s]
        length = torch.ones_like(counts)
        while True:  # next power of two of each row's count
            short = length < counts
            if not bool(short.any()):
                break
            length = torch.where(short, length * 2, length)
        self.n_rows = n_rows
        self.counts = counts
        self.blocks: List[tuple] = []
        has = counts > 0
        for L in torch.unique(length[has]).tolist():
            members = torch.nonzero(has & (length == L)).flatten()
            per = max(1, SLOTS // L)
            for s in range(0, len(members), per):
                rws = members[s:s + per]
                local = torch.full((n_rows,), -1, dtype=torch.int64,
                                   device=device)
                local[rws] = torch.arange(len(rws), device=device)
                li = local[r_s]
                sel = li >= 0
                li, p = li[sel], pos[sel]
                idx = torch.zeros((len(rws), L), dtype=torch.int64,
                                  device=device)
                val = torch.zeros((len(rws), L), dtype=torch.float64,
                                  device=device)
                mask = torch.zeros((len(rws), L), dtype=torch.float64,
                                   device=device)
                idx[li, p] = c_s[sel]
                val[li, p] = v_s[sel]
                mask[li, p] = 1.0
                self.blocks.append((rws, idx, val, mask, counts[rws]))


def half_step(fixed: torch.Tensor, side: Side, reg: float, alpha: float,
              implicit: bool) -> torch.Tensor:
    """Every row of ``side`` solved against the ``fixed`` table
    (float64)."""
    r = fixed.shape[1]
    out = torch.zeros((side.n_rows, r), dtype=torch.float64,
                      device=fixed.device)
    G = fixed.T @ fixed if implicit else None
    eye = torch.eye(r, dtype=torch.float64, device=fixed.device)
    for rws, idx, val, mask, counts in side.blocks:
        F = fixed[idx]                                   # [B, L, r]
        if implicit:
            wa = alpha * val * mask
            wb = (1.0 + alpha * val) * mask
        else:
            wa = mask
            wb = val * mask
        A = torch.bmm((F * wa[..., None]).transpose(1, 2), F)
        b = torch.bmm(F.transpose(1, 2), wb[..., None])[..., 0]
        del F
        if G is not None:
            A += G
        A += (reg * counts.to(torch.float64) + JITTER)[:, None, None] * eye
        chol = torch.linalg.cholesky(A)
        out[rws] = torch.cholesky_solve(b[..., None], chol)[..., 0]
    return out


def train(users, items, stars, n_users: int, n_items: int, *, rank: int,
          iterations: int, reg: float, alpha: float, implicit: bool,
          seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(U, V)`` float64 after ``iterations`` from the seed's draw."""
    u0, v0 = initial_factors(seed, n_users, n_items, rank)
    user_side = Side(users, items, stars, n_users, device)
    item_side = Side(items, users, stars, n_items, device)
    U = u0.to(device, torch.float64)
    V = v0.to(device, torch.float64)
    for _ in range(iterations):
        U = half_step(V, user_side, reg, alpha, implicit)
        V = half_step(U, item_side, reg, alpha, implicit)
    return U, V


def compare_factors(got, ref) -> dict:
    """How far the program's ``(U, V)`` lie from the reference's:
    ``factor_rel_err``, the worse table's ``|P - R| / |R|`` (Frobenius),
    and ``row_rel_err``, the worst row's ``|p - r| / max(|r|, the
    table's median row norm)``. A non-finite entry reads infinite."""
    fro, worst = 0.0, 0.0
    for p, r in zip(got, ref):
        p = p.to(r.device, torch.float64)
        if not bool(torch.isfinite(p).all()):
            return {"factor_rel_err": math.inf, "row_rel_err": math.inf}
        d = p - r
        fro = max(fro, float(torch.linalg.norm(d) / torch.linalg.norm(r)))
        rn = torch.linalg.norm(r, dim=1)
        floor = torch.clamp(rn, min=float(rn.median()))
        worst = max(worst, float((torch.linalg.norm(d, dim=1)
                                  / floor).max()))
    return {"factor_rel_err": fro, "row_rel_err": worst}
