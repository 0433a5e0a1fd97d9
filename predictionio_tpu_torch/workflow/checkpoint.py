"""Step-level checkpoint and resume (the port of the single-process half
of ``predictionio_tpu/workflow/checkpoint.py``).

A training loop saves its state every k steps and, restarted after a
crash, resumes from the newest *restorable* step::

    ckpt = make_checkpointer(dir)
    start, state = ckpt.restore_latest(like=state, max_step=n)
    for step in range(start, n):
        state = update(state)
        ckpt.maybe_save(step + 1, state, every=k)

The container is the port's own: one ``step_<n>.npz`` a step (the state
dict's arrays, read back with ``allow_pickle=False``) and the run's
metadata as ``run_metadata.json``; never a pickle. Every file is written
atomically (a temp file, ``fsync``, ``os.replace``, then an ``fsync`` of
the directory), so a crash mid-save leaves the previous step, never a
truncated one; a step that does not read back (a torn or foreign file) is
skipped by :meth:`Checkpointer.restore_latest`, which falls back to the
step before it.

The JAX package writes orbax step directories (digit-named
subdirectories) that the port cannot read: a directory holding them is
refused, never silently restarted from step 0. The multi-process
``DistributedCheckpointer`` waits for sharded training (``ROADMAP.md``
queue 1 item 13).

Fault points: ``checkpoint.save`` (a save's entry), ``checkpoint.commit``
(after the state is encoded, before its file is renamed into place: the
torn-checkpoint window) and ``checkpoint.restore``.
"""

from __future__ import annotations

import io
import json
import logging
import os
import zipfile
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..faults import declare, fire

log = logging.getLogger(__name__)

F_SAVE = declare("checkpoint.save",
                 "entry of a checkpoint save (before any bytes hit disk)")
F_COMMIT = declare("checkpoint.commit",
                   "after the state is encoded, before its file is renamed "
                   "into place: the torn-checkpoint window")
F_RESTORE = declare("checkpoint.restore", "entry of a checkpoint restore")

_METADATA = "run_metadata.json"


def _fsync_dir(path: str) -> None:
    """Durably record a rename or creation in its directory (skipped on
    filesystems without directory file descriptors)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write(path: str, data: bytes) -> None:
    """After this returns ``path`` durably holds exactly ``data``; a crash
    at any earlier instant leaves its previous content (or nothing),
    never a truncated file."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


def _host_array(name: str, value: Any) -> np.ndarray:
    """A state entry as a numeric host array (a tensor is copied off its
    device; the copy waits for the work that wrote it)."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    arr = np.asarray(value)
    if arr.dtype.kind not in "biuf":
        raise TypeError(f"checkpoint state {name!r} is {arr.dtype}; only "
                        f"bool, int and float arrays are saved")
    return arr


class Checkpointer:
    """Step checkpoints of a flat state dict under one directory."""

    def __init__(self, directory: str, keep: int = 2):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        orbax_steps = [n for n in os.listdir(self.directory)
                       if n.isdigit()
                       and os.path.isdir(os.path.join(self.directory, n))]
        if orbax_steps:
            raise RuntimeError(
                f"{self.directory} holds orbax checkpoints (steps "
                f"{sorted(orbax_steps)}), the JAX package's format, which "
                f"the port does not read; use a fresh directory instead "
                f"of silently restarting from scratch")

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.npz")

    def save(self, step: int, state: Mapping[str, Any]) -> int:
        """Write ``state`` as step ``step``; returns the bytes written."""
        fire(F_SAVE, step=step)
        arrays = {k: _host_array(k, v) for k, v in state.items()}
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        payload = buf.getvalue()
        fire(F_COMMIT, step=step)
        _atomic_write(self._path(step), payload)
        self._prune()
        return len(payload)

    def restore(self, step: int, like: Optional[Mapping[str, Any]] = None
                ) -> Dict[str, Any]:
        """Step ``step``'s state: host arrays, or, for each entry of
        ``like`` that is a tensor, a tensor of its dtype on its device.
        With ``like`` the keys, shapes and dtypes must match it."""
        fire(F_RESTORE, step=step)
        with np.load(self._path(step), allow_pickle=False) as z:
            state = {k: np.array(z[k]) for k in z.files}
        if like is None:
            return state
        if set(state) != set(like):
            raise ValueError(f"checkpoint step {step} holds "
                             f"{sorted(state)}, expected {sorted(like)}")
        out: Dict[str, Any] = {}
        for k, ref in like.items():
            arr = state[k]
            if isinstance(ref, torch.Tensor):
                want = str(ref.dtype).replace("torch.", "")
                if tuple(arr.shape) != tuple(ref.shape) \
                        or arr.dtype.name != want:
                    raise ValueError(
                        f"checkpoint step {step}: {k} is {arr.dtype.name} "
                        f"{tuple(arr.shape)}, expected {want} "
                        f"{tuple(ref.shape)}")
                out[k] = torch.from_numpy(arr).to(ref.device)
            else:
                out[k] = arr
        return out

    def restore_latest(self, like: Optional[Mapping[str, Any]] = None,
                       max_step: Optional[int] = None
                       ) -> Tuple[int, Optional[Dict[str, Any]]]:
        """``(step, state)`` of the newest restorable step at or below
        ``max_step``: a step that does not read back (a torn or corrupt
        file) is logged and skipped, falling back to the one before it;
        ``(0, None)`` when none restores."""
        steps = [s for s in self.all_steps()
                 if max_step is None or s <= max_step]
        for s in sorted(steps, reverse=True):
            try:
                return s, self.restore(s, like=like)
            except (OSError, ValueError, KeyError, EOFError,
                    zipfile.BadZipFile) as e:
                log.warning("checkpoint step %s unreadable (%s); falling "
                            "back to the previous step", s, e)
        return 0, None

    def all_steps(self) -> list:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and name.endswith(".npz"):
                try:
                    out.append(int(name[5:-4]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return max(steps) if steps else None

    def maybe_save(self, step: int, state: Mapping[str, Any],
                   every: int) -> bool:
        """Save when ``step`` is a multiple of ``every`` (0: never)."""
        if every and step % every == 0:
            self.save(step, state)
            return True
        return False

    # -- run metadata (the fingerprint that refuses a foreign run) ---------
    def set_metadata(self, meta: dict) -> None:
        _atomic_write(os.path.join(self.directory, _METADATA),
                      json.dumps(meta).encode("utf-8"))

    def get_metadata(self) -> Optional[dict]:
        path = os.path.join(self.directory, _METADATA)
        if not os.path.exists(path):
            return None
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)

    def close(self) -> None:
        """Writes are synchronous: nothing is left to drain."""

    def _prune(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            os.remove(self._path(s))


def make_checkpointer(directory: str, keep: int = 2) -> Checkpointer:
    """The checkpointer training loops call: the single-process one (the
    port trains on one card)."""
    return Checkpointer(directory, keep=keep)
