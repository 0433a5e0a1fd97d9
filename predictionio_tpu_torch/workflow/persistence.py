"""The port's model file: arrays as ``.npz``, ids, params and metadata
as JSON, never a pickle.

:func:`dumps_models` writes the per-algorithm model list of an engine
into one blob; :func:`loads_models` reads it back with host (CPU)
tensors and numpy arrays, and deploy places them where they serve. Read
with ``allow_pickle=False``, so a blob can carry data only.

Each model carries its kind. ``ALSModel`` (the recommendation
template) is built in; a template's module registers its own kinds with
:func:`register_kind` (their encoding lives beside the model), and the
blob names that module, so a reader imports it to decode. One blob may
mix kinds, one a model.
"""

from __future__ import annotations

import dataclasses
import importlib
import io
import json
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.bimap import BiMap
from ..models.als import ALSModel, ALSParams, QuantizedFactors

FORMAT = "predictionio_tpu_torch.models/1"
_PACKAGE = __name__.split(".")[0]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()  # bits; meta records the dtype
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def _put_table(arrays: Dict[str, np.ndarray], prefix: str, table) -> dict:
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


def _dump_one(arrays: Dict[str, np.ndarray], i: int, m: Any) -> dict:
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
    module = m.get("module", "")
    if name not in _KINDS and module.startswith(f"{_PACKAGE}."):
        importlib.import_module(module)  # registers the module's kinds
    if name not in _KINDS:
        raise ValueError(f"model {i}: unknown kind {name!r}")
    prefix = f"{i}."
    named = {k[len(prefix):]: np.array(arrays[k]) for k in arrays.files
             if k.startswith(prefix)}
    return _KINDS[name].decode(named, m)


def loads_models(blob: bytes) -> List[Any]:
    """Invert :func:`dumps_models`; tensors come back on the CPU."""
    with np.load(io.BytesIO(blob), allow_pickle=False) as arrays:
        meta = json.loads(arrays["meta"].tobytes().decode("utf-8"))
        if meta.get("format") != FORMAT:
            raise ValueError(f"not a {FORMAT} blob: {meta.get('format')!r}")
        return [_load_one(arrays, i, m)
                for i, m in enumerate(meta["models"])]
