"""The port's model file: arrays as ``.npz``, ids, params and metadata
as JSON, never a pickle; and the reader of the JAX package's blob.

:func:`dumps_models` writes the per-algorithm model list of an engine
into one blob; :func:`loads_models` reads it back with host (CPU)
tensors and numpy arrays, and deploy places them where they serve. Read
with ``allow_pickle=False``, so a blob can carry data only.

Each model carries its kind. ``ALSModel`` (the recommendation
template) is built in; a template's module registers its own kinds with
:func:`register_kind` (their encoding lives beside the model), and the
blob names that module, so a reader imports it to decode. One blob may
mix kinds, one a model. A model stored as ``None`` (an algorithm that
persists nothing) is kept as ``None``: deploy retrains it.

:func:`loads_models` also reads the blob the JAX package writes (a
protocol-4 pickle of its host models), told apart by its first bytes. A
restricted unpickler (:class:`_JaxBlobUnpickler`) resolves only the JAX
package's model, params, item and ``BiMap`` classes, to inert records,
and numpy's array and scalar reconstructors; any other global is refused
before anything of it runs. Each record is then mapped field by field to
the port's own kind (:func:`_from_jax`), and a field the port does not
know is refused by name.
"""

from __future__ import annotations

import dataclasses
import importlib
import io
import json
import pickle
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..controller.base import PersistentModelManifest
from ..data.bimap import BiMap
from ..models.als import (
    ALSModel,
    ALSParams,
    QuantizedFactors,
    unshard_table,
)

FORMAT = "predictionio_tpu_torch.models/1"
_PACKAGE = __name__.split(".")[0]


def _move(obj: Any, fn: Callable[[torch.Tensor], torch.Tensor]) -> Any:
    """``obj`` with ``fn`` applied to every tensor in it: through
    dataclasses (a copy of each), named tuples, tuples, lists, dicts and
    :class:`QuantizedFactors`; anything else is kept as it is."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _move(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_move(v, fn) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_move(v, fn) for v in obj)
    if isinstance(obj, dict):
        return {k: _move(v, fn) for k, v in obj.items()}
    return obj


def to_host(model: Any) -> Any:
    """``model`` with every tensor moved to the CPU (a copy)."""
    return _move(model, lambda t: t.detach().cpu())


def to_device(model: Any, device=None) -> Any:
    """``model`` with every tensor moved to ``device`` (the card by
    default)."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    return _move(model, lambda t: t.to(dev))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()  # bits; meta records the dtype
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def _put_table(arrays: Dict[str, np.ndarray], prefix: str, table) -> dict:
    # a row-sharded serving table is stored whole: a blob never carries
    # a mesh
    table = unshard_table(table)
    if isinstance(table, QuantizedFactors):
        data, scale, quant = table.data, table.scale, table.quant
    else:
        data, scale, quant = table, None, "off"
    arrays[f"{prefix}.data"] = _to_numpy(data)
    if scale is not None:
        arrays[f"{prefix}.scale"] = _to_numpy(scale)
    return {"quant": quant, "dtype": str(data.dtype).replace("torch.", ""),
            "scale": scale is not None}


def _get_table(arrays, prefix: str, meta: dict):
    data = _from_numpy(arrays[f"{prefix}.data"], meta["dtype"])
    if meta["quant"] == "off":
        return data
    scale = (_from_numpy(arrays[f"{prefix}.scale"], "float32")
             if meta["scale"] else None)
    # ptpu: allow[quantize-without-parity-gate] — loads a persisted
    # table's stored data and scales as they were written; the gate ran
    # when the table was quantized
    return QuantizedFactors(data, scale, meta["quant"])


def ids_json(m: Optional[BiMap]) -> Optional[List[list]]:
    """A ``BiMap`` as JSON: ``[[key, index], ...]``."""
    return None if m is None else [[k, int(v)] for k, v in m.items()]


def bimap_json(rows: Optional[List[list]]) -> Optional[BiMap]:
    """Invert :func:`ids_json`."""
    return None if rows is None else BiMap({k: v for k, v in rows})


@dataclasses.dataclass(frozen=True)
class ModelKind:
    """How one model kind is stored. ``encode(model)`` gives its named
    arrays and its JSON metadata; ``decode(arrays, meta)`` rebuilds it
    from them (the arrays as numpy, under the names ``encode`` gave)."""
    name: str
    cls: type
    encode: Callable[[Any], Tuple[Dict[str, np.ndarray], dict]]
    decode: Callable[[Dict[str, np.ndarray], dict], Any]
    #: the module that registers the kind, which a reader imports
    module: str


#: kind name -> ModelKind; ``ALSModel`` is built in, and a template's
#: module adds its own kinds when it is imported
_KINDS: Dict[str, ModelKind] = {}


def register_kind(name: str, cls: type, encode, decode,
                  module: Optional[str] = None) -> None:
    """Let :func:`dumps_models` store models of ``cls`` as kind ``name``
    and :func:`loads_models` read them back. ``module`` is the module
    that makes this call (``cls``'s own by default): a reader imports it
    to register the kind."""
    _KINDS[name] = ModelKind(name, cls, encode, decode,
                             module or cls.__module__)


def _encode_als(m: ALSModel) -> Tuple[Dict[str, np.ndarray], dict]:
    arrays: Dict[str, np.ndarray] = {}
    return arrays, {
        "n_users": m.n_users, "n_items": m.n_items,
        "params": dataclasses.asdict(m.params),
        "user_ids": ids_json(m.user_ids), "item_ids": ids_json(m.item_ids),
        "user_factors": _put_table(arrays, "user", m.user_factors),
        "item_factors": _put_table(arrays, "item", m.item_factors),
    }


def _decode_als(arrays: Dict[str, np.ndarray], m: dict) -> ALSModel:
    return ALSModel(
        user_factors=_get_table(arrays, "user", m["user_factors"]),
        item_factors=_get_table(arrays, "item", m["item_factors"]),
        n_users=m["n_users"], n_items=m["n_items"],
        user_ids=bimap_json(m["user_ids"]),
        item_ids=bimap_json(m["item_ids"]), params=ALSParams(**m["params"]))


register_kind("ALSModel", ALSModel, _encode_als, _decode_als)


def _encode_manifest(m: PersistentModelManifest
                     ) -> Tuple[Dict[str, np.ndarray], dict]:
    return {}, {"class_name": m.class_name,
                "engine_instance_id": m.engine_instance_id,
                "algo_index": m.algo_index, "location": m.location,
                "extra": m.extra}


register_kind("PersistentModelManifest", PersistentModelManifest,
              _encode_manifest,
              lambda arrays, m: PersistentModelManifest(
                  m["class_name"], m["engine_instance_id"],
                  m["algo_index"], m["location"], m["extra"]))


#: the kind of a model stored as nothing (an algorithm whose persistent
#: model is None, the reference's Unit model): deploy retrains it
#: (``Engine.prepare_deploy``)
_NONE_KIND = "None"


def _dump_one(arrays: Dict[str, np.ndarray], i: int, m: Any) -> dict:
    if m is None:
        return {"kind": _NONE_KIND}
    for kind in _KINDS.values():
        if isinstance(m, kind.cls):
            named, meta = kind.encode(m)
            for name, arr in named.items():
                arrays[f"{i}.{name}"] = np.ascontiguousarray(arr)
            return {"kind": kind.name, "module": kind.module, **meta}
    raise TypeError(f"model {i} is a {type(m).__name__}; no model kind is "
                    f"registered for it (registered: {', '.join(_KINDS)})")


def dumps_models(models: List[Any]) -> bytes:
    """Serialize the per-algorithm model list to one blob."""
    arrays: Dict[str, np.ndarray] = {}
    metas = [_dump_one(arrays, i, m) for i, m in enumerate(models)]
    meta = json.dumps({"format": FORMAT, "models": metas}).encode("utf-8")
    arrays["meta"] = np.frombuffer(meta, dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _load_one(arrays, i: int, m: dict) -> Any:
    name = m.get("kind", "ALSModel")  # blobs before kinds held ALS only
    if name == _NONE_KIND:
        return None
    module = m.get("module", "")
    if name not in _KINDS and module.startswith(f"{_PACKAGE}."):
        importlib.import_module(module)  # registers the module's kinds
    if name not in _KINDS:
        raise ValueError(f"model {i}: unknown kind {name!r}")
    prefix = f"{i}."
    named = {k[len(prefix):]: np.array(arrays[k]) for k in arrays.files
             if k.startswith(prefix)}
    return _KINDS[name].decode(named, m)


#: first bytes of an ``.npz`` (a zip archive)
_NPZ_MAGIC = b"PK\x03\x04"


def loads_models(blob: bytes) -> List[Any]:
    """Invert :func:`dumps_models`, or read the JAX package's blob (a
    pickle, :func:`loads_jax_models`); tensors come back on the CPU."""
    blob = bytes(blob)
    if blob[:1] == b"\x80" and blob[1:2] in (b"\x02", b"\x03", b"\x04",
                                            b"\x05"):
        return loads_jax_models(blob)
    if blob[:4] != _NPZ_MAGIC:
        raise ValueError(f"not a model blob: it starts {blob[:8]!r}, "
                         f"neither an npz ({FORMAT}) nor the JAX "
                         f"package's pickle")
    with np.load(io.BytesIO(blob), allow_pickle=False) as arrays:
        meta = json.loads(arrays["meta"].tobytes().decode("utf-8"))
        if meta.get("format") != FORMAT:
            raise ValueError(f"not a {FORMAT} blob: {meta.get('format')!r}")
        return [_load_one(arrays, i, m)
                for i, m in enumerate(meta["models"])]


# -- the JAX package's blob -----------------------------------------------------

#: the JAX package's import name, spelled out: the port never imports it
_JAX = "predictionio_tpu"

#: (module, name) of each class the JAX package's shipped templates pickle
#: into a blob -> the record name the converters below read
_JAX_CLASSES = {
    (f"{_JAX}.models.als", "ALSModel"): "ALSModel",
    (f"{_JAX}.models.als", "ALSParams"): "ALSParams",
    (f"{_JAX}.templates.ecommerce", "ECommModel"): "ECommModel",
    (f"{_JAX}.templates.ecommerce", "Item"): "Item",
    (f"{_JAX}.templates.similarproduct", "SPModel"): "SPModel",
    (f"{_JAX}.templates.similarproduct", "Item"): "Item",
    (f"{_JAX}.models.cooccurrence", "CooccurrenceModel"):
        "CooccurrenceModel",
    (f"{_JAX}.models.classify", "NaiveBayesModel"): "NaiveBayesModel",
    (f"{_JAX}.models.classify", "RandomForestModel"): "RandomForestModel",
    (f"{_JAX}.models.seqrec", "SeqRecModel"): "SeqRecModel",
    (f"{_JAX}.models.seqrec", "SeqRecParams"): "SeqRecParams",
    (f"{_JAX}.data.bimap", "BiMap"): "BiMap",
}

#: numpy's reconstructors, under the module names numpy 1 and numpy 2 write
_NUMPY_GLOBALS = {
    (mod, name): fn
    for mod in ("numpy.core.multiarray", "numpy._core.multiarray")
    for name, fn in (
        ("_reconstruct", np.ndarray.__reduce__(np.zeros(0))[0]),
        ("scalar", np.float32(0).__reduce__()[0]))
}
_NUMPY_GLOBALS[("numpy", "ndarray")] = np.ndarray
_NUMPY_GLOBALS[("numpy", "dtype")] = np.dtype


class _Record:
    """An inert stand-in for one of the JAX package's objects: its class's
    record name and the state its pickle carries. Built by ``NEWOBJ``
    with no arguments and filled by ``BUILD``; nothing else runs."""

    name = ""

    def __new__(cls, *args):
        if args:
            raise pickle.UnpicklingError(
                f"{cls.name}: the blob constructs it with arguments, "
                f"which no JAX-package blob does")
        return object.__new__(cls)

    def __setstate__(self, state) -> None:
        if isinstance(state, tuple) and len(state) == 2:  # (dict, slots)
            state = {**(state[0] or {}), **(state[1] or {})}
        if not isinstance(state, dict):
            raise pickle.UnpicklingError(
                f"{self.name}: state must be a dict, got "
                f"{type(state).__name__}")
        self.state = dict(state)


_RECORDS: Dict[str, type] = {
    name: type(f"_{name}Record", (_Record,), {"name": name})
    for name in set(_JAX_CLASSES.values())}


class _JaxBlobUnpickler(pickle.Unpickler):
    """Resolves the JAX package's classes to :class:`_Record` types and
    numpy's reconstructors to numpy's own; refuses every other global, so
    nothing the blob names outside that list runs."""

    def find_class(self, module: str, name: str):
        rec = _JAX_CLASSES.get((module, name))
        if rec is not None:
            return _RECORDS[rec]
        fn = _NUMPY_GLOBALS.get((module, name))
        if fn is not None:
            return fn
        if module.split(".")[0] == "ml_dtypes":
            raise pickle.UnpicklingError(
                f"the blob holds a {module}.{name} array: no shipped "
                f"template writes one, and the port reads f32, int and "
                f"bool leaves only")
        raise pickle.UnpicklingError(
            f"the blob names the global {module}.{name}, which is not a "
            f"class of the JAX package's models; refused")

    def persistent_load(self, pid):
        raise pickle.UnpicklingError("persistent ids are refused")


def _state(obj: Any, name: str, known: Tuple[str, ...], what: str) -> dict:
    """The state of a record of ``name``, holding no field outside
    ``known``."""
    if not isinstance(obj, _Record) or obj.name != name:
        raise ValueError(f"{what}: expected the JAX package's {name}, got "
                         f"{getattr(obj, 'name', type(obj).__name__)}")
    state = getattr(obj, "state", {})
    extra = sorted(set(state) - set(known))
    if extra:
        raise ValueError(f"{what}: the JAX package's {name} carries "
                         f"field(s) {', '.join(extra)} the port does not "
                         f"know; refused")
    return state


def _array(x: Any, what: str) -> np.ndarray:
    """A numeric host array (never one of objects)."""
    if not isinstance(x, np.ndarray) or x.dtype.kind not in "biuf":
        raise ValueError(f"{what}: expected a numeric array, got "
                         f"{getattr(x, 'dtype', type(x).__name__)}")
    return x


def _ids(x: Any, what: str) -> Optional[List[list]]:
    """A JAX ``BiMap`` record as the port's id JSON (:func:`ids_json`),
    from its forward dict."""
    if x is None:
        return None
    fwd = _state(x, "BiMap", ("_fwd", "_rev"), what).get("_fwd")
    if not isinstance(fwd, dict):
        raise ValueError(f"{what}: a BiMap without its forward dict")
    return [[k, int(v)] for k, v in fwd.items()]


def _items(x: Any, what: str) -> List[list]:
    """A template's ``{index: Item}`` as :func:`items_json` rows."""
    rows = []
    for k, item in dict(x).items():
        cats = _state(item, "Item", ("categories",), what).get("categories")
        rows.append([int(k), None if cats is None else list(cats)])
    return rows


def _params(x: Any, name: str, cls: type, what: str) -> dict:
    known = tuple(f.name for f in dataclasses.fields(cls))
    return dict(_state(x, name, known, what))


def _als(st: dict, what: str):
    if st.get("mesh") is not None:
        raise ValueError(f"{what}: a persisted ALSModel holds no mesh")
    params = _params(st["params"], "ALSParams", ALSParams, what)
    if params.get("gram_mode") == "pair":
        params["gram_mode"] = "einsum"  # the port has no "pair" kernel
    off = {"quant": "off", "dtype": "float32", "scale": False}
    arrays = {}
    for side in ("user", "item"):
        t = _array(st[f"{side}_factors"], f"{what} {side}_factors")
        if t.dtype != np.float32:
            raise ValueError(f"{what}: {side}_factors are {t.dtype}, not "
                             f"float32")
        arrays[f"{side}.data"] = t
    return arrays, {
        "n_users": int(st["n_users"]), "n_items": int(st["n_items"]),
        "params": params, "user_ids": _ids(st["user_ids"], what),
        "item_ids": _ids(st["item_ids"], what),
        "user_factors": off, "item_factors": off}


def _arrays_and(st: dict, names: Tuple[str, ...], what: str) -> dict:
    return {k: _array(st[k], f"{what} {k}") for k in names}


def _from_jax(obj: Any, i: int) -> Any:
    """The port's model for one of the JAX package's host models."""
    what = f"model {i}"
    tpl = f"{_PACKAGE}.templates"
    if isinstance(obj, tuple):  # the similar-product co-occurrence model
        if len(obj) != 3:
            raise ValueError(f"{what}: a tuple of {len(obj)}, not the "
                             f"co-occurrence model's three")
        st = _state(obj[0], "CooccurrenceModel",
                    ("indices", "counts", "n_items", "n"), what)
        kind, module = "CooccurrenceModel", f"{tpl}.similarproduct"
        arrays = _arrays_and(st, ("indices", "counts"), what)
        meta = {"n_items": int(st["n_items"]), "n": int(st["n"]),
                "item_ids": _ids(obj[1], what),
                "items": _items(obj[2], what)}
    elif getattr(obj, "name", "") == "ALSModel":
        st = _state(obj, "ALSModel", (
            "user_factors", "item_factors", "n_users", "n_items",
            "user_ids", "item_ids", "params", "mesh"), what)
        kind, module = "ALSModel", __name__
        arrays, meta = _als(st, what)
    elif getattr(obj, "name", "") == "ECommModel":
        names = ("user_factors", "has_user", "item_factors", "has_item",
                 "popular_count")
        st = _state(obj, "ECommModel", names + (
            "app_name", "rank", "user_ids", "item_ids", "items"), what)
        kind, module = "ECommModel", f"{tpl}.ecommerce"
        arrays = _arrays_and(st, names, what)
        meta = {"app_name": str(st["app_name"]), "rank": int(st["rank"]),
                "user_ids": _ids(st["user_ids"], what),
                "item_ids": _ids(st["item_ids"], what),
                "items": _items(st["items"], what)}
    elif getattr(obj, "name", "") == "SPModel":
        st = _state(obj, "SPModel", (
            "item_factors", "has_factors", "item_ids", "items"), what)
        kind, module = "SPModel", f"{tpl}.similarproduct"
        arrays = _arrays_and(st, ("item_factors", "has_factors"), what)
        meta = {"item_ids": _ids(st["item_ids"], what),
                "items": _items(st["items"], what)}
    elif getattr(obj, "name", "") == "NaiveBayesModel":
        names = ("log_priors", "log_likelihoods", "classes")
        st = _state(obj, "NaiveBayesModel", names, what)
        kind, module = "NaiveBayesModel", f"{tpl}.classification"
        arrays, meta = _arrays_and(st, names, what), {}
    elif getattr(obj, "name", "") == "RandomForestModel":
        names = ("feature", "threshold", "left", "right", "leaf", "classes")
        st = _state(obj, "RandomForestModel", names + ("max_depth",), what)
        kind, module = "RandomForestModel", f"{tpl}.classification"
        arrays = _arrays_and(st, names, what)
        meta = {"max_depth": int(st["max_depth"])}
    elif getattr(obj, "name", "") == "SeqRecModel":
        from ..models.seqrec import SeqRecParams

        st = _state(obj, "SeqRecModel", (
            "weights", "n_items", "item_ids", "params", "events",
            "app_name"), what)
        kind, module = "SeqRecModel", f"{tpl}.sequential"
        arrays = {f"w.{k}": _array(v, f"{what} weight {k}")
                  for k, v in dict(st["weights"]).items()}
        events = st.get("events")
        meta = {"n_items": int(st["n_items"]),
                "item_ids": _ids(st.get("item_ids"), what),
                "params": _params(st["params"], "SeqRecParams",
                                  SeqRecParams, what),
                "events": None if events is None else list(events),
                "app_name": str(st.get("app_name", ""))}
    else:
        raise ValueError(f"{what}: {getattr(obj, 'name', None) or type(obj).__name__} "
                         f"is not a model of the JAX package's shipped "
                         f"templates")
    if kind not in _KINDS:
        importlib.import_module(module)  # registers the template's kinds
    return _KINDS[kind].decode({k: np.array(v) for k, v in arrays.items()},
                               meta)


def loads_jax_models(blob: bytes) -> List[Any]:
    """The models of a blob the JAX package wrote
    (``pickle.dump([to_host(m) for m in models], protocol=4)``), as the
    port's own kinds with CPU tensors. Refuses a blob naming any global
    outside the JAX package's model classes and numpy's reconstructors
    before anything of it runs."""
    try:
        models = _JaxBlobUnpickler(io.BytesIO(blob)).load()
    except pickle.UnpicklingError as e:
        raise ValueError(f"JAX-package model blob refused: {e}") from e
    if not isinstance(models, list):
        raise ValueError(f"a JAX-package model blob holds a list, not a "
                         f"{type(models).__name__}")
    return [_from_jax(m, i) for i, m in enumerate(models)]
