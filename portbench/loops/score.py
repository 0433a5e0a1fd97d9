"""A batch prediction of every user's top items, as ``pio batchpredict``
scores them: flushes of users through ``recommend_batch_async`` with a
few in flight, each resolved to host ids and scores.

Set-up draws the factor tables on the card from the seed, binds them as
the batch job binds a model (``models/convert.py::als_model_from_numpy``,
the template's ``bind_serving`` and ``prepare_serving_model`` at the
configuration's serving wire), builds the serving kernel and warms the
two flush shapes a pass uses. The window passes over every user in a
seeded order, again and again, in flushes of the mix's size (the last
flush of a pass takes the users left).

The check compares a sample of the window's flushes, drawn from the
seed, with the plain reference's top items.
"""

from __future__ import annotations

import gc
import math
import time
from collections import deque

import numpy as np

from portbench.harness import registry
from portbench.harness.seeds import derive, rng


def setup(run) -> dict:
    import torch

    from predictionio_tpu_torch.controller.context import Context
    from predictionio_tpu_torch.models.als import (
        quantize_serving_model,
        recommend_batch_async,
    )
    from predictionio_tpu_torch.models.convert import als_model_from_numpy
    from predictionio_tpu_torch.templates.recommendation import ALSAlgorithm

    cfg, mix = run.cell.config, run.cell.mix
    alg = cfg["algorithm"]
    n_users = int(cfg["dataset"]["n_users"])
    n_items = int(cfg["dataset"]["n_items"])
    r = int(alg["rank"])
    with run.spans.span("setup.factors"):
        gen = torch.Generator(device=run.device).manual_seed(
            derive(run.seed, "factors"))
        U = torch.randn((n_users, r), generator=gen, device=run.device) \
            / math.sqrt(r)
        V = torch.randn((n_items, r), generator=gen, device=run.device) \
            / math.sqrt(r)
        U_h, V_h = U.cpu().numpy(), V.cpu().numpy()
        del U, V
    with run.spans.span("setup.bind"):
        model = als_model_from_numpy(
            U_h, V_h, n_users, n_items,
            {f"u{n}": n for n in range(n_users)},
            {f"i{n}": n for n in range(n_items)},
            {"rank": r}, device=run.device)
        algo = ALSAlgorithm(model.params)
        algo.bind_serving(Context(device=run.device))
        wire = cfg["control"]["serving"]["wire"] if run.control \
            else cfg["serving"]["wire"]
        if wire != "off":
            # the control: the program's own lower-precision wire, past
            # the deploy-time parity probe that could keep f32
            model = quantize_serving_model(model, wire, parity_floor=0.0)
        model = algo.prepare_serving_model(model, run.device)
    if run.cuda:
        from predictionio_tpu_torch.ops import _build

        with run.spans.span("setup.build"):
            built = _build.build_timed(mix["kernels"])
        run.setup["nvcc_s"] = max((b["seconds"] for b in built.values()
                                   if b["compiled"]), default=0.0)
        if run.setup["nvcc_s"]:
            run.note(f"first run in this checkout: nvcc "
                     f"{run.setup['nvcc_s']:.3f} s")
    size = int(mix["flush_users"])
    order = rng(run.seed, "order").permutation(n_users)
    flushes = [order[s:s + size] for s in range(0, n_users, size)]
    num = int(mix["num"])
    depth = int(mix["in_flight"])
    with run.spans.span("setup.warm"):
        for users in {len(f): f for f in flushes}.values():
            recommend_batch_async(model, users, num)()
        # a queue as deep as the window's, so the pinned host buffers of
        # every flush in flight are allocated before the window opens
        handles = [recommend_batch_async(model, flushes[n % len(flushes)],
                                         num) for n in range(depth)]
        for handle in handles:
            handle()
        del handles
    run.shape.update(rank=r, n_items=n_items, n_users=n_users, num=num,
                     itemsize=4 if wire == "off" else 2)
    return {"model": model, "flushes": flushes, "num": num,
            "depth": depth, "U": U_h, "V": V_h}


def window(run, state) -> None:
    from predictionio_tpu_torch.models.als import recommend_batch_async
    from predictionio_tpu_torch.ops import fused_topk

    model, flushes = state["model"], state["flushes"]
    num, depth = state["num"], state["depth"]
    spans, tracer = run.spans, run.tracer
    keep = int(run.cell.mix["check_flushes"])
    pick = rng(run.seed, "sample")
    kept = []          # a uniform sample of resolved flushes (reservoir)
    inflight = deque()
    counts = {"resolved": 0, "users": 0}

    def resolve_one():
        users, handle = inflight.popleft()
        with spans.span("score.resolve"):
            ids, scores = handle()
        counts["resolved"] += 1
        counts["users"] += len(users)
        if len(kept) < keep:
            kept.append((users, ids, scores))
        else:
            j = pick.integers(counts["resolved"])
            if j < keep:
                kept[j] = (users, ids, scores)

    def drain():
        while inflight:
            resolve_one()

    fused_topk.LAUNCHES = 0
    dispatched = 0
    f = 0
    t0 = time.perf_counter()
    while True:
        elapsed = time.perf_counter() - t0
        if elapsed >= run.seconds:
            break
        tracer.boundary(elapsed, drain)
        users = flushes[f]
        f = (f + 1) % len(flushes)
        with spans.span("score.dispatch"):
            handle = recommend_batch_async(model, users, num)
        inflight.append((users, handle))
        dispatched += len(users)
        tracer.add("flushes")
        tracer.add("users", len(users))
        if len(inflight) >= depth:
            resolve_one()
    drain()
    t1 = time.perf_counter()
    tracer.stop(drain)
    run.window = (t0, t1)
    run.e2e["score_users_per_s"] = counts["users"] / (t1 - t0)
    run.attempted = dispatched
    run.failed = dispatched - counts["users"]
    run.note(f"window: {counts['users']} users in {counts['resolved']} "
             f"flushes, {t1 - t0:.3f} s; fused_topk launches a flush: "
             f"{fused_topk.LAUNCHES / max(counts['resolved'], 1):g}")
    state["kept"] = kept


def check(run, state) -> None:
    """The sampled flushes' ids and scores against the reference's
    float64 ranking of the same users over the same tables."""
    import torch

    kept, U, V = state.pop("kept"), state.pop("U"), state.pop("V")
    num = state["num"]
    state.clear()  # the program's model goes
    gc.collect()
    if run.cuda:
        torch.cuda.empty_cache()
    ref = registry.reference(run.cell.config["serving_reference"])
    users = np.concatenate([k[0] for k in kept])
    ids = np.concatenate([k[1] for k in kept])
    scores = np.concatenate([k[2] for k in kept])
    got = ref.judge(U, V, users, ids, scores, num, run.device)
    limits = run.cell.limits
    run.note(f"check: {len(users)} users of {len(kept)} flushes")
    run.checks = [(name, float(got[name]), float(limits[name]))
                  for name in limits]
