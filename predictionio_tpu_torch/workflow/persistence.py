"""The port's model file: factor tables as ``.npz`` arrays, ids and
params as JSON, never a pickle.

:func:`dumps_models` writes the per-algorithm model list of an engine
into one blob; :func:`loads_models` reads it back with host (CPU)
tensors, and deploy places them on the card. Read with
``allow_pickle=False``, so a blob can carry data only.
"""

from __future__ import annotations

import dataclasses
import io
import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..data.bimap import BiMap
from ..models.als import ALSModel, ALSParams, QuantizedFactors

FORMAT = "predictionio_tpu_torch.models/1"


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


def _ids(m: Optional[BiMap]) -> Optional[List[list]]:
    return None if m is None else [[k, int(v)] for k, v in m.items()]


def dumps_models(models: List[ALSModel]) -> bytes:
    """Serialize the per-algorithm model list to one blob."""
    arrays: Dict[str, np.ndarray] = {}
    metas: List[Dict[str, Any]] = []
    for i, m in enumerate(models):
        if not isinstance(m, ALSModel):
            raise TypeError(f"model {i} is a {type(m).__name__}; this "
                            f"format holds ALSModel only")
        metas.append({
            "kind": "ALSModel", "n_users": m.n_users, "n_items": m.n_items,
            "params": dataclasses.asdict(m.params),
            "user_ids": _ids(m.user_ids), "item_ids": _ids(m.item_ids),
            "user_factors": _put_table(arrays, f"{i}.user", m.user_factors),
            "item_factors": _put_table(arrays, f"{i}.item", m.item_factors),
        })
    meta = json.dumps({"format": FORMAT, "models": metas}).encode("utf-8")
    arrays["meta"] = np.frombuffer(meta, dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def loads_models(blob: bytes) -> List[ALSModel]:
    """Invert :func:`dumps_models`; tensors come back on the CPU."""
    with np.load(io.BytesIO(blob), allow_pickle=False) as arrays:
        meta = json.loads(arrays["meta"].tobytes().decode("utf-8"))
        if meta.get("format") != FORMAT:
            raise ValueError(f"not a {FORMAT} blob: {meta.get('format')!r}")
        out = []
        for i, m in enumerate(meta["models"]):
            out.append(ALSModel(
                user_factors=_get_table(arrays, f"{i}.user",
                                        m["user_factors"]),
                item_factors=_get_table(arrays, f"{i}.item",
                                        m["item_factors"]),
                n_users=m["n_users"], n_items=m["n_items"],
                user_ids=(None if m["user_ids"] is None
                          else BiMap({k: v for k, v in m["user_ids"]})),
                item_ids=(None if m["item_ids"] is None
                          else BiMap({k: v for k, v in m["item_ids"]})),
                params=ALSParams(**m["params"])))
    return out
