"""Carry a trained model's weights (or an ALS model's initial factors)
into the port.

:func:`factors_to_numpy` takes a factor pair as host f32 arrays, for
``train_als(init=...)``; :func:`als_model_from_numpy` takes what a JAX-package ``ALSModel`` holds,
as plain host data: ``np.asarray`` of each factor table (or of a
quantized table's data and scale), ``dict(bimap)`` of each id map and
``dataclasses.asdict(params)``; :func:`als_model_from_jax` reads those
off the model itself, a row-sharded one (the JAX package's
``shard_model``) included. :func:`seqrec_model_from_numpy`,
:func:`naive_bayes_model_from_numpy` and
:func:`random_forest_model_from_numpy` do the same for the sequential
and classification models. Nothing of the JAX package is imported, so
both packages can compute on the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.bimap import BiMap
from ..parallel.mesh import DeviceMesh
from ..utils.device import DeviceLike, resolve_device
from .als import (
    ALSModel,
    ALSParams,
    QuantizedFactors,
    SERVING_QUANT_MODES,
    shard_model,
)
from .classify import NaiveBayesModel, RandomForestModel
from .seqrec import SeqRecModel, SeqRecParams


def _bf16_tensor(arr) -> torch.Tensor:
    """A bf16 tensor with the bits of a bfloat16 host array (numpy has no
    bf16 of its own: the array's dtype is an extension type)."""
    arr = np.asarray(arr)
    if arr.dtype.name != "bfloat16":
        raise TypeError(f"a bf16 table needs bfloat16 data, got {arr.dtype}")
    bits = np.ascontiguousarray(arr).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16)


def _table(data, scale, quant: str):
    if quant == "off":
        return torch.from_numpy(np.ascontiguousarray(data, np.float32))
    if quant == "bf16":
        # ptpu: allow[quantize-without-parity-gate] — decodes a table the
        # JAX package quantized (and gated) when it wrote the blob;
        # nothing is quantized here
        return QuantizedFactors(_bf16_tensor(data), None, "bf16")
    if scale is None:
        raise ValueError("an int8 table needs its per-row scales")
    # ptpu: allow[quantize-without-parity-gate] — the same decode, int8
    # data with its stored per-row scales
    return QuantizedFactors(
        torch.from_numpy(np.ascontiguousarray(data, np.int8)),
        torch.from_numpy(np.ascontiguousarray(scale, np.float32)
                         .reshape(-1, 1)),
        "int8")


def factors_to_numpy(user_factors, item_factors
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Host f32 copies of a factor pair from any array type that
    ``np.asarray`` reads: a JAX-package model's trained tables, or the
    initial draw of its ``train_als``. Pass the pair to
    ``train_als(init=...)`` to start the port from the same factors, or
    to :func:`als_model_from_numpy`."""
    out = tuple(np.array(f, dtype=np.float32, copy=True)
                for f in (user_factors, item_factors))
    for name, f in zip(("user", "item"), out):
        if f.ndim != 2:
            raise ValueError(f"{name} factors must be [n, rank], got "
                             f"{f.shape}")
    if out[0].shape[1] != out[1].shape[1]:
        raise ValueError(f"factor ranks differ: {out[0].shape[1]} and "
                         f"{out[1].shape[1]}")
    return out


def als_model_from_numpy(user_factors, item_factors, n_users: int,
                         n_items: int, user_ids: Optional[Mapping],
                         item_ids: Optional[Mapping], params,
                         *, user_scale=None, item_scale=None,
                         quant: str = "off",
                         device: DeviceLike = None) -> ALSModel:
    """The port's :class:`ALSModel` from host arrays and plain maps,
    placed on ``device`` (the card by default)."""
    if quant not in SERVING_QUANT_MODES:
        raise ValueError(f"quant must be one of {SERVING_QUANT_MODES}, "
                         f"got {quant!r}")
    if not isinstance(params, ALSParams):
        params = ALSParams(**dict(params or {}))
    dev = resolve_device(device)
    uf = _table(user_factors, user_scale, quant)
    vf = _table(item_factors, item_scale, quant)
    return ALSModel(
        user_factors=uf.to(dev), item_factors=vf.to(dev),
        n_users=int(n_users), n_items=int(n_items),
        user_ids=None if user_ids is None else BiMap(dict(user_ids)),
        item_ids=None if item_ids is None else BiMap(dict(item_ids)),
        params=params)


def als_model_from_jax(jmodel, device: DeviceLike = None,
                       mesh: Optional[DeviceMesh] = None) -> ALSModel:
    """The port's :class:`ALSModel` from a JAX-package ``ALSModel``,
    read by its fields (nothing of JAX is imported): ``np.asarray`` of
    each factor table's leaves (for a table the JAX package's
    ``shard_model`` spread over a mesh that is its ``jax.device_get``),
    with the padding rows past ``n_users`` / ``n_items`` dropped, the id
    maps and the params. With ``mesh`` the model is then split by the
    port's :func:`~.als.shard_model`; the JAX model's own mesh is never
    carried."""
    def leaves(t, n):
        data = getattr(t, "data", t)
        scale = getattr(t, "scale", None)
        quant = getattr(t, "quant", "off") if data is not t else "off"
        data = np.asarray(data)[:n]
        return (data, None if scale is None
                else np.asarray(scale, dtype=np.float32)[:n], quant)

    n_u, n_i = int(jmodel.n_users), int(jmodel.n_items)
    ud, us, quant = leaves(jmodel.user_factors, n_u)
    vd, vs, _ = leaves(jmodel.item_factors, n_i)
    params = {f.name: getattr(jmodel.params, f.name)
              for f in dataclasses.fields(ALSParams)
              if hasattr(jmodel.params, f.name)}
    model = als_model_from_numpy(
        ud, vd, n_u, n_i,
        None if jmodel.user_ids is None else dict(jmodel.user_ids.items()),
        None if jmodel.item_ids is None else dict(jmodel.item_ids.items()),
        params, user_scale=us, item_scale=vs, quant=quant, device=device)
    return model if mesh is None else shard_model(model, mesh)


def seqrec_model_from_numpy(weights: Mapping[str, np.ndarray], n_items: int,
                            item_ids: Optional[Mapping], params,
                            events: Optional[Sequence[str]] = None,
                            app_name: str = "",
                            device: DeviceLike = None) -> SeqRecModel:
    """The port's :class:`SeqRecModel` from a JAX-package model's weights
    as host arrays (``{k: np.asarray(v)}``), its id map as a dict and
    its params as a dict, placed on ``device`` (the card by default)."""
    if not isinstance(params, SeqRecParams):
        params = SeqRecParams(**dict(params or {}))
    dev = resolve_device(device)
    w = {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
         for k, v in weights.items()}
    return SeqRecModel(
        weights=w, n_items=int(n_items),
        item_ids=None if item_ids is None else BiMap(dict(item_ids)),
        params=params, events=None if events is None else tuple(events),
        app_name=app_name)


def naive_bayes_model_from_numpy(log_priors, log_likelihoods, classes,
                                 device: DeviceLike = None
                                 ) -> NaiveBayesModel:
    """The port's :class:`NaiveBayesModel` from a JAX-package one's
    arrays (host numpy already: a copy), scoring batches on ``device``
    (the card by default)."""
    return NaiveBayesModel(
        np.array(log_priors, copy=True), np.array(log_likelihoods, copy=True),
        np.array(classes, copy=True),
        device=str(resolve_device(device)))


def random_forest_model_from_numpy(feature, threshold, left, right, leaf,
                                   classes, max_depth: int,
                                   device: DeviceLike = None
                                   ) -> RandomForestModel:
    """The port's :class:`RandomForestModel` from a JAX-package one's
    per-node arrays (a copy), traversing on ``device`` (the card by
    default)."""
    return RandomForestModel(
        *(np.array(a, copy=True)
          for a in (feature, threshold, left, right, leaf, classes)),
        max_depth=int(max_depth), device=str(resolve_device(device)))
