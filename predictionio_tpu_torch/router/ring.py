"""Consistent-hash ring with entity affinity (the port's own copy of
``predictionio_tpu/router/ring.py``).

The router's placement primitive: every replica owns ``vnodes``
pseudo-random points on a 64-bit circle; an entity key hashes to a point
and is served by the first replica clockwise from it. Adding or removing
one replica remaps only the arcs that replica's virtual nodes owned (an
expected ``1/N`` of the key space), so the per-replica serving caches
and pinned hot tiers, which key on the same entity id, keep their hit
rates through membership changes. A modulo router would remap almost
everything on every scale event and cold-start the whole fleet.

Hashing is ``sha256`` over the UTF-8 key, the idiom of
:func:`~predictionio_tpu_torch.rollout.splitter.cohort_bucket`, never
Python's ``hash()``: placement is deterministic across processes,
restarts, interpreter versions and the two packages, so a user lands on
the same replica whichever package routes it.

The ring itself is unsynchronized on purpose: the
:class:`~predictionio_tpu_torch.router.router.QueryRouter` mutates it
only under its own lock.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["HashRing", "key_point"]

#: virtual nodes per member: enough that one member's share has low
#: variance (stddev ~ 1/sqrt(vnodes) of the mean share) while keeping
#: membership changes cheap (vnodes sorted inserts)
DEFAULT_VNODES = 64


def key_point(key: str) -> int:
    """64-bit ring point for an entity key — sha256, the same stable
    digest the rollout splitter's ``cohort_bucket`` uses."""
    digest = hashlib.sha256(
        key.encode("utf-8", "surrogatepass")).digest()
    return int.from_bytes(digest[:8], "big")


class HashRing:
    """Sorted-point consistent-hash ring; lookups are ``O(log(N *
    vnodes))`` bisects."""

    def __init__(self, members: Iterable[str] = (),
                 vnodes: int = DEFAULT_VNODES) -> None:
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = int(vnodes)
        self._points: List[Tuple[int, str]] = []
        self._members: Dict[str, bool] = {}
        for m in members:
            self.add(m)

    # -- membership ---------------------------------------------------------
    def add(self, member: str) -> None:
        if member in self._members:
            return
        self._members[member] = True
        for i in range(self.vnodes):
            # ties between two members' vnodes (astronomically rare)
            # break on the member name, so both orders of construction
            # yield the identical ring
            bisect.insort(self._points,
                          (key_point(f"{member}#{i}"), member))

    def remove(self, member: str) -> None:
        if member not in self._members:
            return
        del self._members[member]
        self._points = [p for p in self._points if p[1] != member]

    def members(self) -> List[str]:
        return sorted(self._members)

    def __len__(self) -> int:
        return len(self._members)

    def __contains__(self, member: str) -> bool:
        return member in self._members

    # -- assignment ---------------------------------------------------------
    def assign(self, key: str) -> Optional[str]:
        """The key's affinity replica: owner of the first virtual node
        clockwise from the key's point (None on an empty ring)."""
        if not self._points:
            return None
        idx = bisect.bisect_right(self._points, (key_point(key), ""))
        if idx == len(self._points):
            idx = 0
        return self._points[idx][1]

    def preference(self, key: str, n: int) -> List[str]:
        """The first ``n`` DISTINCT members clockwise from the key's
        point — position 0 is the affinity replica, the rest are the
        spill/retry order. Every router computes the same list, so a
        hot key spilled across ``n`` replicas still lands on a stable,
        cache-warm set."""
        if not self._points or n <= 0:
            return []
        out: List[str] = []
        start = bisect.bisect_right(self._points, (key_point(key), ""))
        total = len(self._points)
        for off in range(total):
            member = self._points[(start + off) % total][1]
            if member not in out:
                out.append(member)
                if len(out) >= min(n, len(self._members)):
                    break
        return out

    def describe(self) -> Dict[str, int]:
        """Virtual-node count per member (the balance diagnostic
        ``fleet route`` prints)."""
        counts: Dict[str, int] = {m: 0 for m in self._members}
        for _pt, m in self._points:
            counts[m] += 1
        return counts
