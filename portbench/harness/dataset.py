"""The dataset a configuration names, generated once a checkout and then
loaded from the cache.

A configuration's ``dataset`` names its generator (a module of
``portbench/``), its ``scale`` and its ``seed``. The first run in a
checkout generates the ratings and saves them under
``portbench/.cache/data/`` as int32 users and items and f32 stars; later
runs load them. The run's own ``--seed`` never changes the data.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from dataclasses import dataclass

import numpy as np

from .env import CACHE
from .registry import BENCH, load_module


@dataclass
class Ratings:
    """Rating triples (host numpy) and the matrix's size."""

    users: np.ndarray   # int32 [nnz]
    items: np.ndarray   # int32 [nnz]
    stars: np.ndarray   # float32 [nnz]
    n_users: int
    n_items: int
    #: seconds spent generating them in this run (0 when loaded)
    generated_s: float = 0.0
    #: seconds spent loading them from the cache (0 when generated)
    loaded_s: float = 0.0


def _key(spec: dict) -> str:
    return f"{spec['generator']}-scale{float(spec['scale'])!r}-seed{int(spec['seed'])}"


def load(spec: dict) -> Ratings:
    """The ratings of a configuration's ``dataset`` entry."""
    d = CACHE / "data" / _key(spec)
    meta_path = d / "meta.json"
    if meta_path.exists():
        t0 = time.perf_counter()
        meta = json.loads(meta_path.read_text())
        arrays = [np.load(d / f"{n}.npy") for n in ("users", "items", "stars")]
        return Ratings(*arrays, meta["n_users"], meta["n_items"],
                       loaded_s=time.perf_counter() - t0)
    gen = load_module(BENCH / f"{spec['generator']}.py",
                      "portbench_gen__" + spec["generator"])
    t0 = time.perf_counter()
    users, items, stars, _ts, n_users, n_items = gen.generate(
        scale=float(spec["scale"]), seed=int(spec["seed"]))
    generated_s = time.perf_counter() - t0
    users = users.astype(np.int32, copy=False)
    items = items.astype(np.int32, copy=False)
    stars = stars.astype(np.float32, copy=False)
    for key in ("n_ratings", "n_users", "n_items"):
        want = spec.get(key)
        got = {"n_ratings": len(users), "n_users": n_users,
               "n_items": n_items}[key]
        if want is not None and int(want) != int(got):
            raise ValueError(f"dataset {_key(spec)}: {key} is {got}, the "
                             f"configuration states {want}")
    # written beside, then renamed: a run that dies mid-write leaves no
    # half a dataset behind for the next run to load
    tmp = d.with_name(d.name + f".tmp{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    for name, arr in (("users", users), ("items", items), ("stars", stars)):
        np.save(tmp / f"{name}.npy", arr)
    (tmp / "meta.json").write_text(json.dumps(
        {"n_users": int(n_users), "n_items": int(n_items),
         "n_ratings": len(users), "generated_s": generated_s}))
    try:
        os.rename(tmp, d)
    except OSError:  # another run saved it first
        shutil.rmtree(tmp, ignore_errors=True)
    return Ratings(users, items, stars, int(n_users), int(n_items),
                   generated_s=generated_s)
