"""Versioned release registry over engine-instance metadata (the port's
own copy of ``predictionio_tpu/rollout/registry.py``).

Every action that changes which model serves traffic (deploy, reload,
canary start, ramp step, promote, rollback, undeploy, pin) is recorded as
a :class:`ReleaseEvent` (who, when, why), and the current release state
(stable instance, pinned instance, live candidate) is readable from any
process that shares the storage.

The state is a JSON blob in the MODELDATA repository
(``storage.models()``) under a reserved ``__release__`` key, with one
index blob listing every tracked engine triple. Key, document and index
are the JAX package's byte for byte, so a store written by either package
reads the same in the other. Writes are last-writer-wins per engine
triple; the writers are the deploy-time CLI and the one engine server
that owns the triple.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional, Tuple

from ..concurrency import new_rlock
from ..data.storage.base import (
    RESERVED_MODEL_KEY_PREFIX as RESERVED_PREFIX,
    STATUS_COMPLETED,
    Model,
)

#: One extra blob lists every engine triple that has release state, so
#: ``release list`` can enumerate without a scan of the models.
INDEX_KEY = RESERVED_PREFIX + "-index"

#: History is capped so the blob stays small on servers that reload
#: every retrain for months; the newest events win.
MAX_HISTORY = 500


def _utcnow_iso() -> str:
    return datetime.now(timezone.utc).isoformat()


@dataclass(frozen=True)
class ReleaseEvent:
    """One recorded release action: who did what, when, and why."""

    seq: int
    time: str
    action: str
    instance_id: str = ""
    actor: str = ""
    reason: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return asdict(self)

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "ReleaseEvent":
        return ReleaseEvent(
            seq=int(d.get("seq", 0)), time=d.get("time", ""),
            action=d.get("action", ""),
            instance_id=d.get("instance_id", ""),
            actor=d.get("actor", ""), reason=d.get("reason", ""),
            extra=dict(d.get("extra") or {}))


def _empty_state() -> Dict[str, Any]:
    return {
        "stable": "",          # instance id currently serving 100%
        "previousStable": "",  # what `rollback` reverts to
        "pinned": "",          # deploy/reload bind this instead of latest
        "candidate": "",       # live canary/shadow instance id
        "candidateMode": "",   # "canary" | "shadow" | ""
        "fraction": 0.0,       # candidate traffic fraction
        "seq": 0,
        "history": [],         # ReleaseEvent dicts, oldest first
    }


class ReleaseRegistry:
    """Release state and history for one engine triple
    (engine_id, engine_version, engine_variant)."""

    def __init__(self, storage, engine_id: str,
                 engine_version: str = "1",
                 engine_variant: str = "engine.json"):
        self.storage = storage
        self.engine_id = engine_id
        self.engine_version = engine_version
        self.engine_variant = engine_variant
        # held across load + mutate + save: the read-modify-write
        # boundary of the blob (admin-plane calls, never the query path)
        self._lock = new_rlock("ReleaseRegistry._lock")

    # -- persistence --------------------------------------------------------
    @property
    def key(self) -> str:
        """Blob key: hashed so variant paths (slashes, dots) never leak
        into a backend's key grammar."""
        digest = hashlib.sha1(
            "\x00".join((self.engine_id, self.engine_version,
                         self.engine_variant)).encode("utf-8")).hexdigest()
        return f"{RESERVED_PREFIX}-{digest[:20]}"

    def _load(self) -> Dict[str, Any]:
        blob = self.storage.models().get(self.key)
        if blob is None:
            return _empty_state()
        try:
            state = json.loads(blob.models.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return _empty_state()
        merged = _empty_state()
        merged.update(state)
        return merged

    def _save(self, state: Dict[str, Any]) -> None:
        state["history"] = state["history"][-MAX_HISTORY:]
        payload = json.dumps(state).encode("utf-8")
        self.storage.models().insert(Model(id=self.key, models=payload))
        self._index_self()

    def _index_self(self) -> None:
        triple = [self.engine_id, self.engine_version, self.engine_variant]
        models = self.storage.models()
        blob = models.get(INDEX_KEY)
        entries: List[List[str]] = []
        if blob is not None:
            try:
                entries = json.loads(blob.models.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                entries = []
        if triple not in entries:
            entries.append(triple)
            models.insert(Model(
                id=INDEX_KEY,
                models=json.dumps(entries).encode("utf-8")))

    @staticmethod
    def list_tracked(storage) -> List[Tuple[str, str, str]]:
        """Every engine triple with recorded release state."""
        blob = storage.models().get(INDEX_KEY)
        if blob is None:
            return []
        try:
            entries = json.loads(blob.models.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return []
        return [tuple(e) for e in entries if len(e) == 3]

    # -- reads --------------------------------------------------------------
    def state(self) -> Dict[str, Any]:
        """Current release state WITHOUT the history list."""
        with self._lock:
            st = self._load()
        st.pop("history", None)
        return st

    def history(self, limit: Optional[int] = None) -> List[ReleaseEvent]:
        """Recorded events, oldest first (``limit`` keeps the newest)."""
        with self._lock:
            raw = self._load()["history"]
        if limit is not None:
            raw = raw[-limit:]
        return [ReleaseEvent.from_json(d) for d in raw]

    def pinned_instance(self) -> Optional[str]:
        """The pinned instance id, or None: deploy and reload bind this
        over the latest COMPLETED instance."""
        pinned = self.state().get("pinned") or ""
        return pinned or None

    def to_json(self, history_limit: int = 50) -> Dict[str, Any]:
        """The ``/release.json`` payload body."""
        with self._lock:
            st = self._load()
        history = st.pop("history", [])[-history_limit:]
        return {
            "engineId": self.engine_id,
            "engineVersion": self.engine_version,
            "engineVariant": self.engine_variant,
            "state": st,
            "history": history,
        }

    # -- writes -------------------------------------------------------------
    def _record_locked(self, state: Dict[str, Any], action: str,
                       instance_id: str = "", actor: str = "",
                       reason: str = "",
                       **extra: Any) -> ReleaseEvent:
        state["seq"] = int(state.get("seq", 0)) + 1
        ev = ReleaseEvent(seq=state["seq"], time=_utcnow_iso(),
                          action=action, instance_id=instance_id,
                          actor=actor, reason=reason, extra=dict(extra))
        state["history"].append(ev.to_json())
        return ev

    def record(self, action: str, instance_id: str = "", actor: str = "",
               reason: str = "", **extra: Any) -> ReleaseEvent:
        """Append a history event without changing release state
        (``undeploy``, ``shadow-window``, ``stream-*``)."""
        with self._lock:
            state = self._load()
            ev = self._record_locked(state, action, instance_id, actor,
                                     reason, **extra)
            self._save(state)
        return ev

    def _require_completed(self, instance_id: str) -> None:
        inst = self.storage.engine_instances().get(instance_id)
        if inst is None:
            raise ValueError(f"engine instance {instance_id!r} not found")
        if inst.status != STATUS_COMPLETED:
            raise ValueError(
                f"engine instance {instance_id!r} is {inst.status}, "
                f"not {STATUS_COMPLETED}")

    def record_deploy(self, instance_id: str, actor: str = "",
                      reason: str = "") -> ReleaseEvent:
        """A deploy (or reload) bound ``instance_id`` as the serving
        stable."""
        with self._lock:
            state = self._load()
            if state["stable"] and state["stable"] != instance_id:
                state["previousStable"] = state["stable"]
            state["stable"] = instance_id
            ev = self._record_locked(state, "deploy", instance_id, actor,
                                     reason)
            self._save(state)
        return ev

    def pin(self, instance_id: str, actor: str = "",
            reason: str = "") -> ReleaseEvent:
        """Pin deploy/reload to ``instance_id`` (must be COMPLETED)."""
        self._require_completed(instance_id)
        with self._lock:
            state = self._load()
            state["pinned"] = instance_id
            ev = self._record_locked(state, "pin", instance_id, actor,
                                     reason)
            self._save(state)
        return ev

    def unpin(self, actor: str = "", reason: str = "") -> ReleaseEvent:
        with self._lock:
            state = self._load()
            was = state["pinned"]
            state["pinned"] = ""
            ev = self._record_locked(state, "unpin", was, actor, reason)
            self._save(state)
        return ev

    def start_candidate(self, instance_id: str, fraction: float,
                        mode: str = "canary", actor: str = "",
                        reason: str = "") -> ReleaseEvent:
        """A canary/shadow candidate started at ``fraction``."""
        self._require_completed(instance_id)
        with self._lock:
            state = self._load()
            state["candidate"] = instance_id
            state["candidateMode"] = mode
            state["fraction"] = float(fraction)
            ev = self._record_locked(state, mode, instance_id, actor,
                                     reason, fraction=float(fraction))
            self._save(state)
        return ev

    def set_fraction(self, fraction: float, actor: str = "",
                     reason: str = "") -> ReleaseEvent:
        """A ramp step moved the candidate to ``fraction``."""
        with self._lock:
            state = self._load()
            state["fraction"] = float(fraction)
            ev = self._record_locked(state, "ramp", state["candidate"],
                                     actor, reason,
                                     fraction=float(fraction))
            self._save(state)
        return ev

    def promote(self, instance_id: str, actor: str = "",
                reason: str = "") -> ReleaseEvent:
        """``instance_id`` becomes the pinned stable (the candidate is
        cleared when it was the candidate)."""
        with self._lock:
            state = self._load()
            prior = state["stable"]
            if prior and prior != instance_id:
                state["previousStable"] = prior
            state["stable"] = instance_id
            state["pinned"] = instance_id
            if state["candidate"] == instance_id:
                state["candidate"] = ""
                state["candidateMode"] = ""
                state["fraction"] = 0.0
            ev = self._record_locked(state, "promote", instance_id, actor,
                                     reason, previous_stable=prior)
            self._save(state)
        return ev

    def rollback(self, actor: str = "", reason: str = "") -> ReleaseEvent:
        """Abort the live candidate; with no candidate, revert stable to
        ``previousStable`` (re-pinning it so reload binds it)."""
        with self._lock:
            state = self._load()
            if state["candidate"]:
                was = state["candidate"]
                state["candidate"] = ""
                state["candidateMode"] = ""
                state["fraction"] = 0.0
                ev = self._record_locked(state, "rollback", was, actor,
                                         reason, kind="candidate")
            elif state["previousStable"]:
                was = state["stable"]
                state["stable"] = state["previousStable"]
                state["pinned"] = state["previousStable"]
                state["previousStable"] = ""
                ev = self._record_locked(
                    state, "rollback", was, actor, reason,
                    kind="stable", reverted_to=state["stable"])
            else:
                raise ValueError(
                    "nothing to roll back: no live candidate and no "
                    "previous stable recorded")
            self._save(state)
        return ev
