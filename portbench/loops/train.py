"""Whole trainings back to back through the recommendation template's
``Engine.train``.

Set-up loads the configuration's ratings, builds the training kernels,
packs the ratings once (``pack_s``) and runs one whole training, which
warms every shape the window uses. The window then runs whole trainings,
each through ``Engine.train`` on an in-memory data source that holds the
one ``RatingsCOO``, so every training hits the pack cache as a ``pio
eval`` grid or a deploy's retrain does. Each training takes the
template's ``seed`` from the run's seed and its index, so each starts
from its own draw of the factors and all do the same work.

The check runs the plain reference over one training of the window,
drawn from the seed, and compares its factors.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from portbench.harness import dataset, registry
from portbench.harness.seeds import derive, rng


def _variant(run, seed: int) -> dict:
    cfg = run.cell.config
    params = dict(cfg["algorithm"])
    if run.control:
        params.update(cfg["control"]["algorithm"])
    params["seed"] = seed
    return {"algorithms": [{"name": "als", "params": params}]}


def setup(run) -> dict:
    from predictionio_tpu_torch.controller.base import DataSource
    from predictionio_tpu_torch.controller.context import Context
    from predictionio_tpu_torch.data.bimap import BiMap
    from predictionio_tpu_torch.models.als import (
        RatingsCOO,
        pack_ratings_cached,
    )
    from predictionio_tpu_torch.templates.recommendation import (
        ALSAlgorithm,
        TrainingData,
        recommendation_engine,
    )

    with run.spans.span("setup.data"):
        data = dataset.load(run.cell.config["dataset"])
    run.setup["dataset_generated_s"] = data.generated_s
    run.setup["dataset_loaded_s"] = data.loaded_s
    if data.generated_s:
        run.note(f"first run in this checkout: dataset generated in "
                 f"{data.generated_s:.3f} s")
    ratings = RatingsCOO(data.users, data.items, data.stars, data.n_users,
                         data.n_items)
    with run.spans.span("setup.maps"):
        user_ids = BiMap({f"u{n}": n for n in range(data.n_users)})
        item_ids = BiMap({f"i{n}": n for n in range(data.n_items)})

    class MemoryDataSource(DataSource):
        def read_training(self, ctx):
            return TrainingData(ratings, user_ids, item_ids)

    spans = run.spans

    class TimedALS(ALSAlgorithm):
        """The template's algorithm, its ``train`` inside a span."""

        def train(self, ctx, td):
            with spans.span("train.algorithm"):
                return super().train(ctx, td)

    engine = recommendation_engine(datasource_classes=MemoryDataSource)
    engine.algorithm_classes = {**engine.algorithm_classes, "als": TimedALS}
    ctx = Context(device=run.device)
    if run.cuda:
        from predictionio_tpu_torch.ops import _build

        with spans.span("setup.build"):
            built = _build.build_timed(run.cell.mix["kernels"])
        run.setup["nvcc_s"] = max((b["seconds"] for b in built.values()
                                   if b["compiled"]), default=0.0)
        if run.setup["nvcc_s"]:
            run.note(f"first run in this checkout: nvcc "
                     f"{run.setup['nvcc_s']:.3f} s for "
                     f"{', '.join(n for n, b in built.items() if b['compiled'])}")
    params = engine.params_from_variant(_variant(run, 0)).algorithms[0][1]
    with spans.span("setup.pack"):
        packed = pack_ratings_cached(ratings, params, device=run.device)
        run.sync()
    (t0, t1), = spans.by_name["setup.pack"]
    run.setup["pack_s"] = t1 - t0

    users_rated = int(np.count_nonzero(np.bincount(
        data.users, minlength=data.n_users)))
    items_rated = int(np.count_nonzero(np.bincount(
        data.items, minlength=data.n_items)))
    padded = sum(getattr(h, "padded_entries", 0) for h in packed)
    run.shape.update(
        rank=params.rank, implicit=bool(params.implicit_prefs), nnz=len(data.users),
        users_rated=users_rated, items_rated=items_rated,
        n_users=data.n_users, n_items=data.n_items)
    run.note(f"slots an iteration: {2 * len(data.users)} real, {padded} "
             f"padded; systems solved an iteration: "
             f"{users_rated + items_rated}")
    del packed
    with spans.span("setup.warm"):
        engine.train(ctx, engine.params_from_variant(
            _variant(run, derive(run.seed, "warm"))))
        run.sync()
    return {"engine": engine, "ctx": ctx, "data": data, "ratings": ratings,
            "iterations": params.num_iterations}


def window(run, state) -> None:
    from predictionio_tpu_torch.ops import fused_gram, solve

    engine, ctx = state["engine"], state["ctx"]
    iters = state["iterations"]
    spans, tracer = run.spans, run.tracer
    pick = rng(run.seed, "sample")
    fused_gram.LAUNCHES = 0
    solve.LAUNCHES = 0
    kept = None
    n = 0
    t0 = time.perf_counter()
    while True:
        elapsed = time.perf_counter() - t0
        if elapsed >= run.seconds:
            break
        tracer.boundary(elapsed, lambda: None)
        seed = derive(run.seed, "train", n)
        ep = engine.params_from_variant(_variant(run, seed))
        with spans.span("train.engine"):
            (model,) = engine.train(ctx, ep).models
        tracer.add("iterations", iters)
        n += 1
        # a uniform sample of one training of the window (reservoir)
        if pick.integers(n) == 0:
            kept = (seed, model.user_factors, model.item_factors)
    t1 = time.perf_counter()
    tracer.stop(lambda: None)
    run.window = (t0, t1)
    run.e2e["train_iter_ms"] = (t1 - t0) * 1e3 / (n * iters)
    run.attempted = n
    run.failed = 0
    each = sorted(run.spans.durations("train.engine", run.window))
    q = [each[int(f * (len(each) - 1))] for f in (0.0, 0.25, 0.5, 0.75, 1.0)]
    run.note(f"window: {n} trainings, {n * iters} iterations in "
             f"{t1 - t0:.3f} s; a training's seconds (min, quartiles, max) "
             f"{', '.join(f'{x:.4f}' for x in q)}; launches an iteration: "
             f"fused_gram "
             f"{fused_gram.LAUNCHES / (n * iters):g}, chol_solve "
             f"{solve.LAUNCHES / (n * iters):g}")
    state["kept"] = kept


def check(run, state) -> None:
    """The reference trains from the kept training's seed on the same
    ratings; the factors are compared table by table and row by row."""
    import torch

    seed, U, V = state.pop("kept")
    data = state.pop("data")
    cfg = run.cell.config
    alg = cfg["algorithm"]
    n_u, n_i = data.n_users, data.n_items
    U = U[:n_u].detach()
    V = V[:n_i].detach()
    state.clear()  # the program's engine, packing and ratings go
    gc.collect()
    if run.cuda:
        torch.cuda.empty_cache()
    ref = registry.reference(cfg["reference"])
    t0 = time.perf_counter()
    Ur, Vr = ref.train(
        data.users, data.items, data.stars, n_u, n_i,
        rank=int(alg["rank"]), iterations=int(alg["numIterations"]),
        reg=float(alg["lambda"]), alpha=float(alg.get("alpha", 1.0)),
        implicit=bool(alg.get("implicitPrefs", False)), seed=seed,
        device=run.device)
    got = ref.compare_factors((U, V), (Ur, Vr))
    run.sync()
    run.note(f"check: reference training (seed {seed}) in "
             f"{time.perf_counter() - t0:.3f} s")
    limits = run.cell.limits
    run.checks = [(name, float(got[name]), float(limits[name]))
                  for name in limits]
