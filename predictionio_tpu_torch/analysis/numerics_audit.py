"""``audit-numerics`` — the port's runtime dtype census (the port of
``predictionio_tpu/analysis/numerics_audit.py``).

The static dtype-flow rules (:mod:`.numerics`) catch the narrowings and
upcasts the AST can see; this module catches the ones only a running
program shows. It runs the port's numeric entry points at small shapes
on ``device`` (the card unless ``"cpu"`` is asked for) under a
``TorchDispatchMode`` that sees every aten op they run, and records a
per-entry **dtype census** in the JAX manifest's keys:

- ``ops`` — aten op results counted by dtype;
- ``casts`` — ``src->dst`` keys of every ``aten._to_copy`` and every
  ``copy_`` between two dtypes: the cast inventory. A new
  ``int8->float32`` or ``bfloat16->float32`` in a quantized entry is a
  dequantized table copy; a new ``->bfloat16`` is dropped mantissa;
- ``reductions`` — the result dtype of each reducing aten op (``sum``,
  ``mean``, ``prod``, ``cumsum``, ``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, ``dot``, ``mv``; ``einsum`` and ``matmul`` reach the mode
  as ``mm`` / ``bmm``): the result dtype stands for the accumulator's,
  so an einsum that lost its upcast shows as a ``bmm`` at ``bfloat16``;
- ``bytes`` — result bytes by dtype: the footprint that moves when an
  entry starts materializing wide buffers;
- ``kernels`` — each kernel wrapper's launches over the entry, read
  from the ``LAUNCHES`` counters of ``ops/`` (a dispatch mode cannot
  see a ctypes launch). On the CPU every wrapper takes its plain
  version, so each reads 0.

Each entry runs once unrecorded (libraries load, caches fill), then once
on fresh inputs under the mode. The mesh entries run over
``PTPU_TORCH_FORCE_DEVICE_COUNT=8`` positions on the one device, which
:func:`run_audit` sets for its own duration.

The manifest (``analysis/numerics_baseline.json``) keeps one section a
platform (``cpu``, ``cuda``), each with its own ``devices`` and
``entries``: the CPU runs the plain versions, the card the kernels.
:func:`diff_manifests` gates a fresh census against one section with
the JAX package's ratchet:

- a cast key the section does not record — or a count above the
  recorded one — fails, naming the entry, the cast and the count;
- a reducing op accumulating at bf16/f16 beyond the recorded count
  fails (an accumulator lost its widening);
- per-dtype bytes above ``BYTES_GROWTH_RATIO`` × recorded (plus a fixed
  slack) fail; an unrecorded entry fails; a device-count mismatch
  fails;
- fewer launches of a kernel than recorded fail (the entry stopped
  going through it);
- everything below the record prints as shrinkable, and
  ``--write-baseline`` only ratchets the section down; recording new
  casts or entries takes ``--baseline-grow`` (a platform's first
  section needs neither).
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: the layout with one section a platform
MANIFEST_VERSION = 2

#: mesh positions the sharded entries run over (the JAX package's forced
#: host device count)
AUDIT_DEVICE_COUNT = 8

#: per-dtype result bytes may grow this factor (plus slack) over the
#: recorded baseline before the gate fails — a dequantized table copy
#: moves them a lot
BYTES_GROWTH_RATIO = 1.5
BYTES_SLACK = 64 * 1024

DEFAULT_BASELINE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "numerics_baseline.json")

#: accumulation dtypes that fail the gate when a reduction's count
#: grows — a sum/matmul accumulating here is a lost f32 widening
LOW_PRECISION = ("bfloat16", "float16", "float8")

#: reducing aten ops whose RESULT dtype stands for the accumulator's
REDUCING_OPS = frozenset({
    "sum", "mean", "prod", "cumsum", "mm", "bmm", "addmm", "baddbmm",
    "dot", "mv",
})

#: kernel name -> the ``ops/`` wrapper module whose ``LAUNCHES`` counts it
KERNEL_MODULES = {
    "fused_topk": "fused_topk",
    "fused_gram": "fused_gram",
    "chol_solve": "solve",
    "gram_table": "gram",
}

#: the serving entries' item table: rows and rank (its f32 size is the
#: bound a quantized wire's f32 results must stay under)
ITEM_ROWS, RANK = 64, 16


class AuditError(RuntimeError):
    """The audit could not run (an unknown entry, too few mesh
    positions) — an environment error, not a regression."""


def is_low(dtype: str) -> bool:
    """Whether an accumulator of ``dtype`` is below f32."""
    return any(dtype.startswith(p) for p in LOW_PRECISION)


# ---------------------------------------------------------------------------
# the census
# ---------------------------------------------------------------------------

def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _launch_counts() -> Dict[str, int]:
    import importlib

    return {name: int(importlib.import_module(
                f"predictionio_tpu_torch.ops.{mod}").LAUNCHES)
            for name, mod in KERNEL_MODULES.items()}


def census(run: Callable[[], object]) -> dict:
    """One entry's record: ``{ops, casts, reductions, bytes, kernels}``
    over the aten ops ``run()`` dispatches, and the kernel launches it
    counts."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    ops: Dict[str, int] = {}
    casts: Dict[str, int] = {}
    reductions: Dict[str, Dict[str, int]] = {}
    nbytes: Dict[str, int] = {}

    def cast(src, dst) -> None:
        if src != dst:
            key = f"{_dtype_name(src)}->{_dtype_name(dst)}"
            casts[key] = casts.get(key, 0) + 1

    class _Census(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            results = [t for t in tree_flatten(out)[0]
                       if isinstance(t, torch.Tensor)]
            for t in results:
                d = _dtype_name(t.dtype)
                ops[d] = ops.get(d, 0) + 1
                nbytes[d] = nbytes.get(d, 0) + t.numel() * t.element_size()
            if name == "_to_copy" and results \
                    and isinstance(args[0], torch.Tensor):
                cast(args[0].dtype, results[0].dtype)
            elif name == "copy_" and len(args) > 1 \
                    and isinstance(args[1], torch.Tensor):
                cast(args[1].dtype, args[0].dtype)
            elif name in REDUCING_OPS and results:
                d = _dtype_name(results[0].dtype)
                by = reductions.setdefault(name, {})
                by[d] = by.get(d, 0) + 1
            return out

    before = _launch_counts()
    with _Census():
        run()
    after = _launch_counts()
    return {"ops": ops, "casts": casts, "reductions": reductions,
            "bytes": nbytes,
            "kernels": {k: after[k] - before[k] for k in after}}


# ---------------------------------------------------------------------------
# entry points: each ``setup(dev)`` builds fresh inputs on ``dev`` and
# returns the call the census records
# ---------------------------------------------------------------------------

def _gen(seed: int):
    import torch

    return torch.Generator().manual_seed(seed)


def _table(rows: int, rank: int, seed: int, dev):
    import torch

    return torch.randn((rows, rank), generator=_gen(seed)).to(dev)


def _als_model(dev):
    """A rank-16 model: 32 users, 60 items on 64 rows, random factors."""
    from ..models.als import ALSModel

    return ALSModel(_table(32, RANK, 1, dev),
                    _table(ITEM_ROWS, RANK, 2, dev), 32, 60)


def _serving_tables(quant: str, dev):
    """The u [32, 16] and v [64, 16] serving tables in ``quant``, made
    through the parity funnel (its probe off: the tables are random)."""
    from ..models.als import place_model, quantize_serving_model

    model = _als_model(dev)
    if quant != "off":
        model = place_model(quantize_serving_model(model, quant,
                                                   parity_floor=0.0), dev)
    return model.user_factors, model.item_factors


def _entry_device_topk(quant: str):
    def setup(dev):
        import numpy as np

        from ..models.als import _device_topk

        u, v = _serving_tables(quant, dev)
        idx = np.arange(4, dtype=np.int32)
        return lambda: _device_topk(u, v, idx, 8, 60)
    return setup


def _entry_quantize_serving_model(dev):
    from ..models.als import dequantize_table, quantize_serving_model

    model = _als_model(dev)

    def run():
        # the parity funnel (probe on), then the two dequant funnels its
        # consumers route through: scaled int8 and plain bf16
        q8 = quantize_serving_model(model, "int8", parity_floor=0.5)
        q16 = quantize_serving_model(model, "bf16", parity_floor=0.5)
        dequantize_table(q8.item_factors.to(dev))
        dequantize_table(q16.item_factors.to(dev))
    return run


def _lhs_arrays(dev, blocks: int = 8):
    import torch

    g = _gen(3)
    table = torch.randn((64, 16), generator=g).to(dev)
    idx = torch.randint(0, 64, (blocks, 4, 8), generator=g,
                        dtype=torch.int32).to(dev)
    w = torch.rand((blocks, 4, 8), generator=g).to(dev)
    return table, idx, w


def _entry_lhs(gram: str):
    def setup(dev):
        from ..models.als import _lhs_fn

        table, idx, w = _lhs_arrays(dev)
        return lambda: _lhs_fn(table, idx, w, w, gram=gram, bf16=False)
    return setup


def _block_arrays(dev):
    import torch

    g = _gen(4)
    idx = torch.randint(0, 64, (32, 8), generator=g,
                        dtype=torch.int32).to(dev)
    values = torch.rand((32, 8), generator=g).to(dev)
    counts = torch.randint(1, 9, (32,), generator=g,
                           dtype=torch.int32).to(dev)
    return idx, values, counts


def _entry_train_update_block(dev):
    from ..models.als import _update_block, gramian

    table = _table(64, 16, 3, dev)
    idx, values, counts = _block_arrays(dev)
    G = gramian(table)
    return lambda: _update_block(table, G, idx, values, counts, 0.1, 40.0,
                                 implicit=True, scale_reg=True, bf16=False,
                                 gram="einsum")


def _entry_foldin_update_bf16(dev):
    import numpy as np

    from ..models.als import ALSParams, fold_in_rows

    table = _table(64, 16, 3, dev)
    rng = np.random.default_rng(4)
    indices = rng.integers(0, 64, (4, 8)).astype(np.int32)
    values = rng.random((4, 8)).astype(np.float32)
    counts = np.full(4, 8, np.int32)
    # the fold-in's bf16 gather shadow into _update_block; accumulation
    # stays f32
    params = ALSParams(rank=16, implicit_prefs=True,
                       gather_dtype="bfloat16")
    return lambda: fold_in_rows(table, indices, values, counts, params)


def _entry_seqrec_train_step(dev):
    import torch

    from ..models.seqrec import SeqRecParams, _init_weights, train_step

    p = SeqRecParams(dim=16, heads=2, max_len=8, n_negatives=4,
                     batch_size=8)
    w = {k: v.to(dev) for k, v in _init_weights(32, p).items()}
    m = {k: torch.zeros_like(v) for k, v in w.items()}
    v = {k: torch.zeros_like(t) for k, t in w.items()}
    g = _gen(5)
    seq = torch.randint(0, 32, (8, 8), generator=g,
                        dtype=torch.int32).to(dev)
    negs = torch.randint(0, 32, (8, 7, 4), generator=g).to(dev)
    return lambda: train_step(w, m, v, 0, seq, negs, p)


def _mesh_devices(dev):
    from ..parallel.mesh import local_devices

    devices = local_devices(dev)
    if len(devices) < AUDIT_DEVICE_COUNT:
        raise AuditError(
            f"audit-numerics needs {AUDIT_DEVICE_COUNT} mesh positions, "
            f"found {len(devices)}; run it through run_audit, which sets "
            f"PTPU_TORCH_FORCE_DEVICE_COUNT={AUDIT_DEVICE_COUNT}")
    return devices[:AUDIT_DEVICE_COUNT]


def _entry_gramian_allreduce(dev):
    from ..parallel.collectives import gramian_allreduce
    from ..parallel.mesh import make_mesh

    mesh = make_mesh(devices=_mesh_devices(dev))
    shards = [_table(8, 16, 10 + s, d) for s, d in enumerate(mesh.devices)]
    return lambda: gramian_allreduce(shards, mesh=mesh)


def _sharded_items(dev):
    from ..models.als import _shard_table
    from ..parallel.mesh import make_serving_mesh

    mesh = make_serving_mesh(devices=_mesh_devices(dev))
    return _shard_table(_table(64, 16, 2, dev), mesh)


def _entry_gather_rows(dev):
    import numpy as np

    from ..models.als import _user_vecs

    table = _sharded_items(dev)
    rows = np.array([0, 9, 27, 63], np.int64)
    return lambda: _user_vecs(table, rows, dev)


def _entry_sharded_rank(dev):
    from ..models.als import _rank_sharded

    table = _sharded_items(dev)
    vecs = _table(4, 16, 1, dev)
    return lambda: _rank_sharded(vecs, None, table, 8, 60)


def _entry_sharded_topk(dev):
    from ..parallel.collectives import sharded_top_k
    from ..parallel.mesh import make_mesh

    mesh = make_mesh(data=2, model=4, devices=_mesh_devices(dev))
    scores = _table(4, 64, 6, dev)
    return lambda: sharded_top_k(scores, 8, mesh, axis="model")


#: name → (setup, one-line description); ordered — the manifest lists
#: entries in this order. The names are the JAX package's.
ENTRY_POINTS: Dict[str, Tuple[Callable, str]] = {
    "gramian_allreduce": (
        _entry_gramian_allreduce,
        "per-shard Gramian partials summed in position order "
        "(parallel/collectives.py)"),
    "gather_rows": (
        _entry_gather_rows,
        "cross-shard user-row fetch (_user_vecs of a row-sharded table)"),
    "sharded_rank": (
        _entry_sharded_rank,
        "one fused_topk a shard + the candidate merge (_rank_sharded)"),
    "lhs_einsum": (
        _entry_lhs("einsum"),
        "_lhs_fn normal-equation build (einsum mode)"),
    "lhs_fused": (
        _entry_lhs("fused"),
        "_lhs_fn through the fused_gram kernel"),
    "train_update_block": (
        _entry_train_update_block,
        "one ALS training block (gather+Gramian+chol_solve)"),
    "seqrec_train_step": (
        _entry_seqrec_train_step,
        "sequential-model Adam step (train_step)"),
    "sharded_topk": (
        _entry_sharded_topk,
        "two-phase global top-k over the (data=2, model=4) mesh"),
    "foldin_update_bf16": (
        _entry_foldin_update_bf16,
        "streaming fold-in solve under the bf16 gather shadow "
        "(fold_in_rows)"),
    "quantize_serving_model": (
        _entry_quantize_serving_model,
        "the parity funnel, then the dequant funnel pair (scaled int8 "
        "+ plain bf16)"),
    "device_topk_off": (
        _entry_device_topk("off"),
        "batched serving dispatch (_device_topk), plain f32 tables"),
    "device_topk_bf16": (
        _entry_device_topk("bf16"),
        "batched serving dispatch, bf16 tables (upcast after the load)"),
    "device_topk_int8": (
        _entry_device_topk("int8"),
        "batched serving dispatch, int8+scale tables"),
}


@contextlib.contextmanager
def _forced_devices(n: int):
    """``PTPU_TORCH_FORCE_DEVICE_COUNT=n`` for the block, then the
    variable as it was."""
    from ..parallel.mesh import FORCE_DEVICE_COUNT_ENV

    old = os.environ.get(FORCE_DEVICE_COUNT_ENV)
    os.environ[FORCE_DEVICE_COUNT_ENV] = str(n)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(FORCE_DEVICE_COUNT_ENV, None)
        else:
            os.environ[FORCE_DEVICE_COUNT_ENV] = old


def platform_of(dev) -> str:
    """The manifest section a device's census belongs to."""
    return "cuda" if dev.type == "cuda" else "cpu"


def run_audit(names: Optional[Sequence[str]] = None,
              device=None) -> dict:
    """Census every (selected) entry point on ``device`` (the card unless
    ``"cpu"``; without CUDA and without ``"cpu"`` this raises, as every
    entry point of the port does); returns the manifest of that
    platform's section."""
    from ..parallel.mesh import local_devices
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    unknown = set(names or ()) - set(ENTRY_POINTS)
    if unknown:
        raise AuditError(f"unknown entry point(s): {sorted(unknown)} "
                         f"(have: {sorted(ENTRY_POINTS)})")
    entries: Dict[str, dict] = {}
    with _forced_devices(AUDIT_DEVICE_COUNT):
        n_dev = len(local_devices(dev))
        for name, (setup, _desc) in ENTRY_POINTS.items():
            if names and name not in names:
                continue
            setup(dev)()  # unrecorded: libraries load, caches fill
            entries[name] = census(setup(dev))
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
        raise ValueError(f"{path}: not an audit-numerics manifest "
                         f"(expected version {MANIFEST_VERSION} with a "
                         f"section a platform)")
    return doc


def section(doc: dict, platform: str) -> Optional[dict]:
    """One platform's section of a loaded baseline, shaped as a fresh
    manifest (None when the file records no such platform)."""
    sec = doc.get("platforms", {}).get(platform)
    if sec is None:
        return None
    return {"version": doc["version"], "platform": platform,
            "devices": sec.get("devices"),
            "entries": sec.get("entries", {})}


def _clamp_counts(new: Dict[str, int], old: Dict[str, int]
                  ) -> Dict[str, int]:
    return {k: min(c, old[k]) for k, c in new.items() if k in old}


def write_manifest(path: str, manifest: dict,
                   cap: Optional[dict] = None) -> None:
    """Persist ``manifest`` as its platform's section of the file at
    ``path``, keeping the other sections. With ``cap`` (the section as
    committed) the write RATCHETS: entries/keys the old section never
    held are dropped and counts/bytes clamp to the recorded values — the
    section only shrinks (``--baseline-grow`` writes as is)."""
    platform = manifest["platform"]
    entries = manifest.get("entries", {})
    if cap is not None:
        old = cap.get("entries", {})
        capped: Dict[str, dict] = {}
        for name, rec in entries.items():
            if name not in old:
                continue
            orec = old[name]
            oreds = orec.get("reductions", {})
            capped[name] = {
                "ops": _clamp_counts(rec.get("ops", {}),
                                     orec.get("ops", {})),
                "casts": _clamp_counts(rec.get("casts", {}),
                                       orec.get("casts", {})),
                "reductions": {
                    op: _clamp_counts(by, oreds[op])
                    for op, by in rec.get("reductions", {}).items()
                    if op in oreds},
                "bytes": _clamp_counts(rec.get("bytes", {}),
                                       orec.get("bytes", {})),
                "kernels": _clamp_counts(rec.get("kernels", {}),
                                         orec.get("kernels", {})),
            }
        entries = capped
    doc = {"version": MANIFEST_VERSION, "platforms": {}}
    if os.path.exists(path):
        try:
            doc = load_manifest(path)
        except (OSError, ValueError):
            pass  # not a sectioned manifest: replaced whole
    doc["platforms"][platform] = {
        "devices": manifest.get("devices", AUDIT_DEVICE_COUNT),
        "entries": entries}
    from .baseline import atomic_write_text

    atomic_write_text(
        path, json.dumps(doc, indent=2, sort_keys=True) + "\n")


def diff_manifests(current: dict, baseline: dict
                   ) -> Tuple[List[str], List[str]]:
    """(violations, shrinkable) between a fresh census and one section
    of the golden baseline (the JAX package's semantics, plus the kernel
    launches). Violations name the entry, the op/cast and the counts —
    the line an operator greps for."""
    violations: List[str] = []
    shrinkable: List[str] = []
    if current.get("devices") != baseline.get("devices"):
        violations.append(
            f"device count {current.get('devices')} != baseline "
            f"{baseline.get('devices')} (mesh entries run "
            f"topology-dependent programs; audit on the forced mesh)")
    cur = current.get("entries", {})
    base = baseline.get("entries", {})
    for name, rec in cur.items():
        brec = base.get(name)
        if brec is None:
            violations.append(
                f"{name}: entry point not in the baseline — record it "
                f"deliberately with --write-baseline --baseline-grow")
            continue
        bcasts = brec.get("casts", {})
        for key, c in sorted(rec.get("casts", {}).items()):
            b = bcasts.get(key, 0)
            if c > b:
                violations.append(
                    f"{name}: cast {key} x{c} (baseline {b}) — a new "
                    f"_to_copy / copy_ between dtypes in the entry. An "
                    f"upcast of quantized data materializes a wide "
                    f"copy (forfeits the serving-quant HBM win); a "
                    f"downcast drops mantissa: find the .float() / .to() "
                    f"or the copy feeding this entry, or record "
                    f"deliberately with --baseline-grow")
            elif c < b:
                shrinkable.append(f"{name}: cast {key} recorded {b}, "
                                  f"found {c}")
        for key, b in sorted(bcasts.items()):
            if key not in rec.get("casts", {}):
                shrinkable.append(f"{name}: cast {key} recorded {b}, "
                                  f"found 0")
        breds = brec.get("reductions", {})
        for op, by in sorted(rec.get("reductions", {}).items()):
            bby = breds.get(op, {})
            for dt, c in sorted(by.items()):
                b = bby.get(dt, 0)
                if is_low(dt) and c > b:
                    violations.append(
                        f"{name}: {op} accumulating at {dt} x{c} "
                        f"(baseline {b}) — a reduction lost its f32 "
                        f"accumulator; upcast the operands (.float()) "
                        f"or pass dtype=torch.float32, or record "
                        f"deliberately with --baseline-grow")
                elif c < b:
                    shrinkable.append(f"{name}: {op}@{dt} recorded "
                                      f"{b}, found {c}")
        bbytes = brec.get("bytes", {})
        for dt, n in sorted(rec.get("bytes", {}).items()):
            b = bbytes.get(dt, 0)
            if n > b * BYTES_GROWTH_RATIO + BYTES_SLACK:
                violations.append(
                    f"{name}: {dt} result traffic {n}B vs baseline "
                    f"{b}B (> x{BYTES_GROWTH_RATIO} + {BYTES_SLACK}B "
                    f"slack) — the entry is materializing wider "
                    f"buffers (a dequantized table copy?); or "
                    f"--baseline-grow")
            elif n < b / BYTES_GROWTH_RATIO - BYTES_SLACK:
                shrinkable.append(f"{name}: {dt} bytes recorded {b}, "
                                  f"found {n}")
        kernels = rec.get("kernels", {})
        for k, b in sorted(brec.get("kernels", {}).items()):
            c = kernels.get(k, 0)
            if c < b:
                violations.append(
                    f"{name}: kernel {k} launched x{c} (baseline {b}) — "
                    f"the entry no longer goes through its kernel")
    for name in base:
        if name not in cur:
            shrinkable.append(f"{name}: entry point no longer audited")
    return violations, shrinkable


def format_text(manifest: dict) -> str:
    lines: List[str] = []
    for name, rec in manifest.get("entries", {}).items():
        ops = rec.get("ops", {})
        summary = ", ".join(f"{dt} x{c}"
                            for dt, c in sorted(ops.items())) \
            or "no ops"
        lines.append(f"{name}: {summary}")
        casts = rec.get("casts", {})
        if casts:
            lines.append("  casts: " + ", ".join(
                f"{k} x{c}" for k, c in sorted(casts.items())))
        for op, by in sorted(rec.get("reductions", {}).items()):
            lines.append(f"  {op}: " + ", ".join(
                f"{dt} x{c}" for dt, c in sorted(by.items())))
        low = {dt: n for dt, n in rec.get("bytes", {}).items()
               if is_low(dt) or dt == "int8"}
        if low:
            lines.append("  low-precision bytes: " + ", ".join(
                f"{dt} {n}B" for dt, n in sorted(low.items())))
        launched = {k: c for k, c in rec.get("kernels", {}).items() if c}
        if launched:
            lines.append("  kernels: " + ", ".join(
                f"{k} x{c}" for k, c in sorted(launched.items())))
    return "\n".join(lines)


__all__ = (
    "AUDIT_DEVICE_COUNT",
    "AuditError",
    "BYTES_GROWTH_RATIO",
    "BYTES_SLACK",
    "DEFAULT_BASELINE",
    "ENTRY_POINTS",
    "ITEM_ROWS",
    "KERNEL_MODULES",
    "LOW_PRECISION",
    "MANIFEST_VERSION",
    "RANK",
    "REDUCING_OPS",
    "census",
    "diff_manifests",
    "format_text",
    "is_low",
    "load_manifest",
    "platform_of",
    "run_audit",
    "section",
    "write_manifest",
)
