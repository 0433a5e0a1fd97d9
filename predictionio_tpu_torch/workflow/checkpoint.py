"""Step-level checkpoint and resume (the port of
``predictionio_tpu/workflow/checkpoint.py``).

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
refused, never silently restarted from step 0.

:class:`DistributedCheckpointer` is the container of a training of
several processes (``make_checkpointer`` picks it when the process group
has more than one, or ``PTPU_DIST_CKPT=1`` forces it): each process
writes only its own row shards of the sharded entries
(``shard_p<rank>.npz`` and its manifest), every process meets at a
barrier, and process 0 writes ``COMMIT.json`` last. A step without a
valid commit marker is torn (a process died mid-save) and is skipped by
``restore_latest``, which falls back to the previous committed step.

Fault points: ``checkpoint.save`` (a save's entry), ``checkpoint.commit``
(after the state is encoded, before its file is renamed into place: the
torn-checkpoint window) and ``checkpoint.restore``.
"""

from __future__ import annotations

import io
import json
import logging
import os
import shutil
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


# -- the distributed container ------------------------------------------------

_COMMIT = "COMMIT.json"


class TornCheckpointError(RuntimeError):
    """A step directory that is not a committed, readable checkpoint (a
    save was cut short): callers fall back to an earlier step."""


def _is_row_sharded(value: Any) -> bool:
    """A row-sharded table (``models/als.py::RowShardedTable``)."""
    return hasattr(value, "shards") and hasattr(value, "mesh")


class DistributedCheckpointer:
    """Per-process shard files of a flat state dict with a commit marker
    written last (module docstring). Layout::

        <dir>/step_00000003/shard_p0.npz   # process 0's entries
        <dir>/step_00000003/shard_p0.json  # which rows of what each holds
        <dir>/step_00000003/shard_p1.npz
        <dir>/step_00000003/shard_p1.json
        <dir>/step_00000003/COMMIT.json    # written LAST, by process 0

    A row-sharded table is written shard by shard by the process that
    owns each shard's mesh position; any other entry (a tensor, an
    array, a number) once, by process 0. The directory is shared by the
    processes. A restore reads every process's files, so each process
    gets every entry whole."""

    def __init__(self, directory: str, keep: int = 2,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        if process_index is None or process_count is None:
            from ..parallel import multihost

            process_index = multihost.process_index()
            process_count = multihost.process_count()
        self.pid = int(process_index)
        self.n_proc = int(process_count)
        self._refuse_foreign()

    def _refuse_foreign(self) -> None:
        """The JAX package's distributed steps index shards by pytree leaf
        (``"leaf"``), which the port does not read: refuse the directory
        rather than restart from step 0 unseen."""
        for name in sorted(os.listdir(self.directory)):
            manifest = os.path.join(self.directory, name, "shard_p0.json")
            try:
                with open(manifest, "r", encoding="utf-8") as f:
                    entries = json.load(f).get("entries") or []
            except (OSError, ValueError):
                continue
            if entries and "leaf" in entries[0]:
                raise RuntimeError(
                    f"{self.directory} holds the JAX package's distributed "
                    f"checkpoints ({name}), which the port does not read; "
                    f"use a fresh directory instead of silently restarting "
                    f"from scratch")

    def _barrier(self, tag: str) -> None:
        if self.n_proc <= 1:
            return
        from ..parallel.multihost import barrier

        barrier(f"ckpt:{os.path.basename(self.directory)}:{tag}")

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step):08d}")

    def save(self, step: int, state: Mapping[str, Any]) -> int:
        """Write this process's part of ``state`` as step ``step``, meet
        the others, then (process 0) commit; returns the bytes this
        process wrote."""
        fire(F_SAVE, step=step)
        step_dir = self._step_dir(step)
        os.makedirs(step_dir, exist_ok=True)
        arrays: Dict[str, np.ndarray] = {}
        entries = []
        for name, value in state.items():
            if _is_row_sharded(value):
                n_loc = int(value.shards[0].shape[0])
                total = n_loc * len(value.shards)
                for p in value.mesh.local_positions():
                    key = f"{name}__s{p}"
                    arrays[key] = _host_array(name, value.shards[p])
                    entries.append({"name": name, "key": key,
                                    "rows": [p * n_loc, (p + 1) * n_loc],
                                    "total": total})
            elif self.pid == 0:
                key = f"{name}__full"
                arrays[key] = _host_array(name, value)
                entries.append({"name": name, "key": key, "rows": None})
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        npz = f"shard_p{self.pid}.npz"
        _atomic_write(os.path.join(step_dir, npz), buf.getvalue())
        _atomic_write(os.path.join(step_dir, f"shard_p{self.pid}.json"),
                      json.dumps({"process": self.pid, "npz": npz,
                                  "entries": entries}).encode("utf-8"))
        # every process's shards durable before anyone may commit
        self._barrier(f"save:{step}")
        fire(F_COMMIT, step=step)
        if self.pid == 0:
            _atomic_write(os.path.join(step_dir, _COMMIT), json.dumps({
                "step": int(step), "processes": self.n_proc,
                "manifests": [f"shard_p{p}.json"
                              for p in range(self.n_proc)],
            }).encode("utf-8"))
        # nobody prunes or overwrites before the marker exists
        self._barrier(f"commit:{step}")
        if self.pid == 0:
            self._prune()
        return len(buf.getvalue())

    def _read_commit(self, step: int) -> dict:
        try:
            with open(os.path.join(self._step_dir(step), _COMMIT), "r",
                      encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError) as e:
            raise TornCheckpointError(
                f"step {step}: no valid commit marker ({e}); the save was "
                f"cut short") from e

    def restore(self, step: int, like: Optional[Mapping[str, Any]] = None
                ) -> Dict[str, Any]:
        """Step ``step``'s state, every entry whole: a row-sharded table
        reassembled from every process's shards (host array), any other
        entry as saved; with ``like`` the keys must match and an entry
        whose ``like`` is a tensor comes back as a tensor of its dtype on
        its device. Raises :class:`TornCheckpointError` on a missing
        marker, shard file or row range."""
        fire(F_RESTORE, step=step)
        commit = self._read_commit(step)
        step_dir = self._step_dir(step)
        full: Dict[str, np.ndarray] = {}
        parts: Dict[str, list] = {}
        for manifest_name in commit["manifests"]:
            try:
                with open(os.path.join(step_dir, manifest_name), "r",
                          encoding="utf-8") as f:
                    manifest = json.load(f)
                with np.load(os.path.join(step_dir, manifest["npz"]),
                             allow_pickle=False) as z:
                    data = {k: np.array(z[k]) for k in z.files}
            except (OSError, ValueError, KeyError, EOFError,
                    zipfile.BadZipFile) as e:
                raise TornCheckpointError(
                    f"step {step}: shard manifest {manifest_name} "
                    f"unreadable ({e})") from e
            for e in manifest["entries"]:
                if e["rows"] is None:
                    full[e["name"]] = data[e["key"]]
                else:
                    parts.setdefault(e["name"], []).append(
                        (e["rows"], e["total"], data[e["key"]]))
        for name, pieces in parts.items():
            pieces.sort(key=lambda x: x[0][0])
            total = pieces[0][1]
            at = 0
            for (lo, hi), _, _ in pieces:
                if lo != at:
                    raise TornCheckpointError(
                        f"step {step}: {name} rows [{at}, {lo}) in no "
                        f"shard")
                at = hi
            if at != total:
                raise TornCheckpointError(
                    f"step {step}: {name} rows [{at}, {total}) in no shard")
            full[name] = np.concatenate([a for _, _, a in pieces])
        if like is None:
            return full
        if set(full) != set(like):
            raise TornCheckpointError(
                f"step {step} holds {sorted(full)}, expected {sorted(like)}")
        out: Dict[str, Any] = {}
        for k, ref in like.items():
            out[k] = torch.from_numpy(full[k]).to(ref.device) \
                if isinstance(ref, torch.Tensor) else full[k]
        return out

    def restore_latest(self, like: Optional[Mapping[str, Any]] = None,
                       max_step: Optional[int] = None
                       ) -> Tuple[int, Optional[Dict[str, Any]]]:
        """``(step, state)`` of the newest committed restorable step at or
        below ``max_step``, torn steps skipped (every process walks the
        same committed list, so all fall back alike); ``(0, None)`` when
        none restores."""
        steps = [s for s in self.all_steps()
                 if max_step is None or s <= max_step]
        for s in sorted(steps, reverse=True):
            try:
                return s, self.restore(s, like=like)
            except (TornCheckpointError, OSError, ValueError) as e:
                log.warning("checkpoint step %s unreadable (%s); falling "
                            "back to the previous committed step", s, e)
        return 0, None

    def discard_torn(self) -> list:
        """Remove step directories without a valid commit marker
        (process 0 removes, the others only list); returns their steps."""
        torn = []
        for name in sorted(os.listdir(self.directory)):
            if not name.startswith("step_"):
                continue
            try:
                step = int(name[5:])
            except ValueError:
                continue
            try:
                self._read_commit(step)
            except TornCheckpointError:
                torn.append(step)
                if self.pid == 0:
                    shutil.rmtree(os.path.join(self.directory, name),
                                  ignore_errors=True)
        return torn

    def all_steps(self) -> list:
        """Committed steps only: a directory without its marker is not a
        checkpoint."""
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.directory, name, _COMMIT)):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return max(steps) if steps else None

    def maybe_save(self, step: int, state: Mapping[str, Any],
                   every: int) -> bool:
        if every and step % every == 0:
            self.save(step, state)
            return True
        return False

    def set_metadata(self, meta: dict) -> None:
        """Process 0 writes the run metadata; everyone meets after."""
        if self.pid == 0:
            _atomic_write(os.path.join(self.directory, _METADATA),
                          json.dumps(meta).encode("utf-8"))
        self._barrier("metadata")

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
            shutil.rmtree(self._step_dir(s), ignore_errors=True)


def make_checkpointer(directory: str, keep: int = 2):
    """The checkpointer training loops call: :class:`DistributedCheckpointer`
    in a process group of more than one process (or with
    ``PTPU_DIST_CKPT=1``), else the single-process :class:`Checkpointer`."""
    from ..parallel.multihost import process_count

    if os.environ.get("PTPU_DIST_CKPT", "") == "1" or process_count() > 1:
        return DistributedCheckpointer(directory, keep=keep)
    return Checkpointer(directory, keep=keep)
