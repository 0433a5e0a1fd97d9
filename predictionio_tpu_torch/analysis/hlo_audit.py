"""``audit-hlo`` — the port's collective census (the port of
``predictionio_tpu/analysis/hlo_audit.py``).

The JAX package compiles its SPMD entry points on a forced 8-device
mesh and reads the collectives GSPMD put into the HLO. The port has no
HLO: its collectives are explicit calls (``parallel/collectives.py``),
and the moves GSPMD would derive unseen are plain tensor ops on blocks of
several mesh positions. This module runs the same 8 entry points at
small shapes on ``device`` (the card unless ``"cpu"`` is asked for) over
``AUDIT_DEVICE_COUNT`` positions on the one device, and records per
entry, in the JAX manifest's keys:

- ``collectives`` and ``collective_shapes`` — each public collective
  call, under its HLO op name, with its per-position result shape in the
  HLO style (``f32[16,16]``), from the recorder of
  ``parallel/collectives.py`` (:func:`~..parallel.collectives.
  record_collectives`);
- ``temp_bytes`` — the peak of live bytes the entry allocated above what
  it held at its start: every storage an aten op made under the
  ``TorchDispatchMode``, counted until it is freed (the same count on
  both platforms, so their sections compare);
- ``joins`` (the port's own key) — aten op -> result shapes of every op
  whose inputs hold blocks of two or more mesh positions outside a
  collective: a cross-position move that goes through no collective.
  The mesh helpers mark each block they cut with its position
  (:func:`~..parallel.collectives.tag_position`, keyed on the block's
  storage); under the mode an op's result carries its inputs' positions,
  a collective's ops are not looked at and its result carries none, and
  a view moves nothing, so it is never a join.

Each entry runs once unrecorded (libraries load, caches fill), then once
on fresh inputs recorded. The manifest (``analysis/hlo_baseline.json``)
keeps one section a platform (``cpu``, ``cuda``), each with its own
``devices`` and ``entries``. :func:`diff_manifests` gates a fresh census
against one section with the JAX package's ratchet, ``joins`` gated as
``collectives``:

- an op or join the section does not record — or a count above the
  recorded one — fails, naming the entry, the op and its shapes;
- temp bytes above ``TEMP_GROWTH_RATIO`` x recorded plus
  ``TEMP_SLACK_BYTES`` fail; an unrecorded entry fails; a device-count
  mismatch fails;
- everything below the record prints as shrinkable, and
  ``--write-baseline`` only ratchets the section down; recording new
  collectives, joins or entries takes ``--baseline-grow`` (a platform's
  first section needs neither).

A kernel's launch is a ctypes call the mode cannot see: a kernel's
output carries no position on the card, where the CPU's plain version
passes its inputs' on. None of the 8 entries joins downstream of a
kernel, so both platforms record one structure.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .numerics_audit import AuditError, _forced_devices, platform_of, section

#: the layout with one section a platform (numerics_baseline.json's)
MANIFEST_VERSION = 2

#: mesh positions the entries run over (the JAX package's forced host
#: device count)
AUDIT_DEVICE_COUNT = 8

#: temp allocation may grow this factor (plus slack) over the recorded
#: baseline before the gate fails — a materialized gathered table moves
#: it a lot
TEMP_GROWTH_RATIO = 1.5
TEMP_SLACK_BYTES = 64 * 1024

DEFAULT_BASELINE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "hlo_baseline.json")

#: the half-step entries' ratings: users x items, ratings, rank
N_USERS, N_ITEMS, N_RATINGS, RANK = 64, 48, 320, 16


# ---------------------------------------------------------------------------
# the census
# ---------------------------------------------------------------------------

def census(setup: Callable, dev) -> dict:
    """One entry's record: ``setup(dev)`` builds fresh inputs under a
    recorder that keeps positions, and the call it returns runs under
    the mode; ``{collectives, collective_shapes, temp_bytes, joins}``."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    from torch.multiprocessing.reductions import StorageWeakRef

    from ..parallel.collectives import hlo_shape, record_collectives

    joins: Dict[str, List[str]] = {}
    live: Dict[int, Tuple[object, int]] = {}
    held = {"now": 0, "peak": 0}

    def tensors(tree) -> list:
        return [t for t in tree_flatten(tree)[0]
                if isinstance(t, torch.Tensor)]

    def allocated(results, inputs) -> None:
        known = {t.untyped_storage()._cdata for t in inputs}
        for t in results:
            st = t.untyped_storage()
            if st._cdata in known or st._cdata in live or not st.nbytes():
                continue
            for key in [k for k, (ref, _) in live.items() if ref.expired()]:
                held["now"] -= live.pop(key)[1]
            live[st._cdata] = (StorageWeakRef(st), st.nbytes())
            held["now"] += st.nbytes()
            held["peak"] = max(held["peak"], held["now"])

    with record_collectives(positions=True) as rec:
        run = setup(dev)
        start = len(rec.records)  # the setup's collectives are not the entry's
        place = rec.placement

        class _Census(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                inputs = tensors((args, kwargs))
                results = tensors(out)
                allocated(results, inputs)
                if rec.depth:  # a collective's own op
                    return out
                pos = frozenset()
                for t in inputs:
                    pos |= place.of(t)
                if not pos or func.is_view:
                    return out
                if len(pos) > 1 and results:
                    joins.setdefault(f"aten.{func.overloadpacket.__name__}",
                                     []).append(hlo_shape(results[0]))
                # a written input, or a new storage: an alias the op
                # did not write carries its storage's positions already
                read = {t.untyped_storage()._cdata for t in inputs}
                for t in results:
                    if func._schema.is_mutable \
                            or t.untyped_storage()._cdata not in read:
                        place.add(t, pos)
                return out

        with _Census():
            run()
        return {"collectives": rec.counts(start),
                "collective_shapes": rec.shapes(start),
                "temp_bytes": held["peak"],
                "joins": joins}


# ---------------------------------------------------------------------------
# entry points: each ``setup(dev)`` builds fresh inputs on ``dev`` and
# returns the call the census records
# ---------------------------------------------------------------------------

def _mesh_devices(dev):
    from ..parallel.mesh import local_devices

    devices = local_devices(dev)
    if len(devices) < AUDIT_DEVICE_COUNT:
        raise AuditError(
            f"audit-hlo needs {AUDIT_DEVICE_COUNT} mesh positions, found "
            f"{len(devices)}; run it through run_audit, which sets "
            f"PTPU_TORCH_FORCE_DEVICE_COUNT={AUDIT_DEVICE_COUNT}")
    return devices[:AUDIT_DEVICE_COUNT]


def _training_mesh(dev):
    from ..parallel.mesh import make_mesh

    return make_mesh(devices=_mesh_devices(dev))


def gramian_call(mesh, dev) -> Callable:
    """``gramian_allreduce`` of a seeded [64, 16] table row-split over
    ``mesh`` (this process's blocks of it, over a process mesh)."""
    from ..parallel.collectives import _split, gramian_allreduce
    from ..parallel.mesh import rows_spec
    from .numerics_audit import _table

    shards = _split(_table(8 * mesh.size, RANK, 10, dev), mesh,
                    rows_spec(mesh))
    return lambda: gramian_allreduce(shards, mesh=mesh)


def _entry_gramian_allreduce(dev):
    return gramian_call(_training_mesh(dev), dev)


def _sharded_items(dev):
    from ..models.als import _shard_table
    from ..parallel.mesh import make_serving_mesh
    from .numerics_audit import ITEM_ROWS, _table

    mesh = make_serving_mesh(devices=_mesh_devices(dev))
    return _shard_table(_table(ITEM_ROWS, RANK, 2, dev), mesh)


def _entry_gather_rows(dev):
    import numpy as np

    from ..models.als import _user_vecs

    table = _sharded_items(dev)
    rows = np.array([0, 9, 27, 63], np.int64)
    return lambda: _user_vecs(table, rows, dev)


def _entry_sharded_rank(dev):
    from ..models.als import _rank_sharded
    from .numerics_audit import _table

    table = _sharded_items(dev)
    vecs = _table(4, RANK, 1, dev)
    return lambda: _rank_sharded(vecs, None, table, 8, 60)


def seeded_unshard(dev):
    """The seeded fault (the JAX package's "replicating a sharded
    table"): ``sharded_rank`` with its item table first made whole
    through ``unshard_table``, then split again to rank."""
    from ..models.als import _rank_sharded, _shard_table, unshard_table
    from .numerics_audit import _table

    table = _sharded_items(dev)
    vecs = _table(4, RANK, 1, dev)
    return lambda: _rank_sharded(
        vecs, None, _shard_table(unshard_table(table), table.mesh), 8, 60)


def _ratings():
    """A seeded ratings set of ``N_RATINGS`` distinct (user, item)
    pairs."""
    import numpy as np

    from ..models.als import RatingsCOO

    rng = np.random.default_rng(7)
    pairs = rng.choice(N_USERS * N_ITEMS, N_RATINGS, replace=False)
    stars = rng.integers(1, 6, N_RATINGS).astype(np.float32)
    return RatingsCOO(pairs // N_ITEMS, pairs % N_ITEMS, stars, N_USERS,
                      N_ITEMS)


def _entry_half_step(gram: str, implicit: bool):
    def setup(dev):
        from ..models.als import (
            ALSParams,
            _mesh_half_step,
            _replicate,
            _rows_padded,
            pack_ratings,
        )
        from .numerics_audit import _table

        mesh = _training_mesh(dev)
        params = ALSParams(rank=RANK, gram_mode=gram,
                           implicit_prefs=implicit)
        packed = pack_ratings(_ratings(), params, mesh=mesh)
        side = packed.mesh_side("user", params)
        fixed = _replicate(_table(_rows_padded(packed.item_h), RANK, 3,
                                  "cpu"), mesh)
        return lambda: _mesh_half_step(fixed, side, params, mesh, N_ITEMS)
    return setup


def seqrec_call(mesh, dev) -> Callable:
    """One ``_MeshStep.step`` over ``mesh`` on a seeded batch of 8
    windows (every process of a process mesh holds the whole batch)."""
    import torch

    from ..models.seqrec import SeqRecParams, _init_weights, _MeshStep
    from .numerics_audit import _gen

    p = SeqRecParams(dim=16, heads=2, max_len=8, n_negatives=4,
                     batch_size=8)
    w = {k: v.to(dev) for k, v in _init_weights(32, p).items()}
    m = {k: torch.zeros_like(v) for k, v in w.items()}
    v = {k: torch.zeros_like(t) for k, t in w.items()}
    g = _gen(5)
    seq = torch.randint(0, 32, (8, 8), generator=g,
                        dtype=torch.int32).to(dev)
    negs = torch.randint(0, 32, (8, 7, 4), generator=g).to(dev)
    step = _MeshStep(w, m, v, mesh)
    return lambda: step.step(0, seq, negs, p)


def _entry_seqrec_train_step(dev):
    return seqrec_call(_training_mesh(dev), dev)


def _entry_sharded_topk(dev):
    from ..parallel.collectives import sharded_top_k
    from ..parallel.mesh import make_mesh
    from .numerics_audit import _table

    mesh = make_mesh(data=2, model=4, devices=_mesh_devices(dev))
    scores = _table(4, 64, 6, dev)
    return lambda: sharded_top_k(scores, 8, mesh, axis="model")


#: name → (setup, one-line description); ordered — the manifest lists
#: entries in this order. The names and the order are the JAX package's.
ENTRY_POINTS: Dict[str, Tuple[Callable, str]] = {
    "gramian_allreduce": (
        _entry_gramian_allreduce,
        "per-shard Gramian partials + their all-reduce "
        "(parallel/collectives.py)"),
    "gather_rows": (
        _entry_gather_rows,
        "cross-shard user-row fetch (_user_vecs of a row-sharded table)"),
    "sharded_rank": (
        _entry_sharded_rank,
        "one fused_topk a shard + the candidate merge (_rank_sharded)"),
    "lhs_einsum": (
        _entry_half_step("einsum", False),
        "explicit half-step over the mesh (_mesh_half_step, einsum)"),
    "lhs_fused": (
        _entry_half_step("fused", False),
        "explicit half-step over the mesh through fused_gram and "
        "chol_solve"),
    "train_update_block": (
        _entry_half_step("einsum", True),
        "implicit half-step over the mesh (each device's own Gramian)"),
    "seqrec_train_step": (
        _entry_seqrec_train_step,
        "data-parallel seqrec step: the gradients' all-reduce "
        "(_MeshStep.step)"),
    "sharded_topk": (
        _entry_sharded_topk,
        "two-phase global top-k over the (data=2, model=4) mesh"),
}


def run_audit(names: Optional[Sequence[str]] = None,
              device=None) -> dict:
    """Census every (selected) entry point on ``device`` (the card unless
    ``"cpu"``; without CUDA and without ``"cpu"`` this raises, as every
    entry point of the port does); returns the manifest of that
    platform's section."""
    from ..parallel.mesh import local_devices
    from ..utils.device import resolve_device

    unknown = set(names or ()) - set(ENTRY_POINTS)
    if unknown:
        raise AuditError(f"unknown entry point(s): {sorted(unknown)} "
                         f"(have: {sorted(ENTRY_POINTS)})")
    dev = resolve_device(device)
    entries: Dict[str, dict] = {}
    with _forced_devices(AUDIT_DEVICE_COUNT):
        n_dev = len(local_devices(dev))
        for name, (setup, _desc) in ENTRY_POINTS.items():
            if names and name not in names:
                continue
            setup(dev)()  # unrecorded: libraries load, caches fill
            entries[name] = census(setup, dev)
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)
    return {"version": MANIFEST_VERSION, "platform": platform_of(dev),
            "devices": n_dev, "entries": entries}


# ---------------------------------------------------------------------------
# manifest I/O + ratchet diff
# ---------------------------------------------------------------------------

def load_manifest(path: str) -> dict:
    """The whole baseline file: ``{version, platforms: {name: {devices,
    entries}}}``."""
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict) \
            or doc.get("version") != MANIFEST_VERSION \
            or not isinstance(doc.get("platforms"), dict):
        raise ValueError(f"{path}: not an audit-hlo manifest (expected "
                         f"version {MANIFEST_VERSION} with a section a "
                         f"platform)")
    return doc


def write_manifest(path: str, manifest: dict,
                   cap: Optional[dict] = None) -> None:
    """Persist ``manifest`` as its platform's section of the file at
    ``path``, keeping the other sections. With ``cap`` (the section as
    committed) the write RATCHETS: entries, ops and joins the old section
    never held are dropped, counts and temp bytes clamp to the recorded
    values — the section only shrinks (``--baseline-grow`` writes as
    is)."""
    entries = manifest.get("entries", {})
    if cap is not None:
        old = cap.get("entries", {})
        capped: Dict[str, dict] = {}
        for name, rec in entries.items():
            if name not in old:
                continue
            orec = old[name]
            ocolls = orec.get("collectives", {})
            colls = {op: min(c, ocolls[op])
                     for op, c in rec.get("collectives", {}).items()
                     if op in ocolls}
            ojoins = orec.get("joins", {})
            capped[name] = {
                "collectives": colls,
                "collective_shapes": {
                    op: rec.get("collective_shapes", {}).get(op, [])
                    for op in colls},
                "temp_bytes": min(rec.get("temp_bytes", 0),
                                  orec.get("temp_bytes", 0)),
                "joins": {op: shapes[:len(ojoins[op])]
                          for op, shapes in rec.get("joins", {}).items()
                          if op in ojoins},
            }
        entries = capped
    doc = {"version": MANIFEST_VERSION, "platforms": {}}
    if os.path.exists(path):
        try:
            doc = load_manifest(path)
        except (OSError, ValueError):
            pass  # not a sectioned manifest: replaced whole
    doc["platforms"][manifest["platform"]] = {
        "devices": manifest.get("devices", AUDIT_DEVICE_COUNT),
        "entries": entries}
    from .baseline import atomic_write_text

    atomic_write_text(
        path, json.dumps(doc, indent=2, sort_keys=True) + "\n")


#: what a violation says of a new collective, and of a new join
_NEW_COLLECTIVE = (
    "a new collective call in the entry",
    "A block was regathered: find the collective call feeding this entry "
    "point")
_NEW_JOIN = (
    "a move between mesh positions through no collective",
    "A block of one position met another's outside "
    "parallel/collectives.py: keep it on its position or route it "
    "through a collective")


def _ratchet(name: str, what: str, counts: Dict[str, int],
             shapes: Dict[str, List[str]], recorded: Dict[str, int],
             why: Tuple[str, str], violations: List[str],
             shrinkable: List[str]) -> None:
    """One entry's counts against the record: above it fails, below it
    is shrinkable."""
    for op, count in sorted(counts.items()):
        b = recorded.get(op, 0)
        if count > b:
            found = shapes.get(op, [])
            violations.append(
                f"{name}: {what}{op} x{count} (baseline {b}) — {why[0]}"
                + (f"; shapes {found}" if found else "")
                + f". {why[1]}, or record deliberately with "
                f"--baseline-grow")
        elif count < b:
            shrinkable.append(f"{name}: {what}{op} recorded {b}, "
                              f"found {count}")
    for op, b in sorted(recorded.items()):
        if op not in counts:
            shrinkable.append(f"{name}: {what}{op} recorded {b}, found 0")


def diff_manifests(current: dict, baseline: dict
                   ) -> Tuple[List[str], List[str]]:
    """(violations, shrinkable) between a fresh census and one section
    of the golden baseline (the JAX package's semantics, ``joins`` gated
    as ``collectives``). Violations name the entry, the op or join and
    its shapes — the line an operator greps for."""
    violations: List[str] = []
    shrinkable: List[str] = []
    if current.get("devices") != baseline.get("devices"):
        violations.append(
            f"device count {current.get('devices')} != baseline "
            f"{baseline.get('devices')} (the collective structure is "
            f"topology-dependent; audit on the forced mesh)")
    cur = current.get("entries", {})
    base = baseline.get("entries", {})
    for name, rec in cur.items():
        brec = base.get(name)
        if brec is None:
            violations.append(
                f"{name}: entry point not in the baseline — record it "
                f"deliberately with --write-baseline --baseline-grow")
            continue
        _ratchet(name, "", rec.get("collectives", {}),
                 rec.get("collective_shapes", {}),
                 brec.get("collectives", {}), _NEW_COLLECTIVE, violations,
                 shrinkable)
        btemp = brec.get("temp_bytes", 0)
        temp = rec.get("temp_bytes", 0)
        if temp > btemp * TEMP_GROWTH_RATIO + TEMP_SLACK_BYTES:
            violations.append(
                f"{name}: temp allocation {temp}B vs baseline "
                f"{btemp}B (> x{TEMP_GROWTH_RATIO} + "
                f"{TEMP_SLACK_BYTES}B slack) — the entry is "
                f"materializing a gathered buffer; check for a block "
                f"made whole, or --baseline-grow")
        elif temp < btemp / TEMP_GROWTH_RATIO - TEMP_SLACK_BYTES:
            shrinkable.append(f"{name}: temp_bytes recorded {btemp}, "
                              f"found {temp}")
        joins, bjoins = rec.get("joins", {}), brec.get("joins", {})
        _ratchet(name, "join ", {op: len(v) for op, v in joins.items()},
                 joins, {op: len(v) for op, v in bjoins.items()}, _NEW_JOIN,
                 violations, shrinkable)
    for name in base:
        if name not in cur:
            shrinkable.append(f"{name}: entry point no longer audited")
    return violations, shrinkable


def structure(manifest: dict) -> dict:
    """Each entry's ``collectives``, ``collective_shapes`` and ``joins``:
    what does not depend on the device."""
    keys = ("collectives", "collective_shapes", "joins")
    return {name: {k: rec.get(k, {}) for k in keys}
            for name, rec in manifest.get("entries", {}).items()}


def format_text(manifest: dict) -> str:
    lines: List[str] = []
    for name, rec in manifest.get("entries", {}).items():
        colls = rec.get("collectives", {})
        summary = ", ".join(f"{op} x{c}"
                            for op, c in sorted(colls.items())) \
            or "no collectives"
        lines.append(f"{name}: {summary}; "
                     f"temp {rec.get('temp_bytes', 0)}B")
        for op, shapes in sorted(
                rec.get("collective_shapes", {}).items()):
            lines.append(f"  {op}: {' '.join(shapes)}")
        for op, shapes in sorted(rec.get("joins", {}).items()):
            lines.append(f"  join {op} x{len(shapes)}: {' '.join(shapes)}")
    return "\n".join(lines)


__all__ = (
    "AUDIT_DEVICE_COUNT",
    "AuditError",
    "DEFAULT_BASELINE",
    "ENTRY_POINTS",
    "MANIFEST_VERSION",
    "TEMP_GROWTH_RATIO",
    "TEMP_SLACK_BYTES",
    "census",
    "diff_manifests",
    "format_text",
    "gramian_call",
    "load_manifest",
    "platform_of",
    "run_audit",
    "section",
    "seeded_unshard",
    "seqrec_call",
    "structure",
    "write_manifest",
)
