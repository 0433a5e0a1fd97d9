"""Batched serving and batch prediction (the port of
``predictionio_tpu/workflow/batch_predict.py``).

The engine server's two batch-path architectures and the ``pio
batchpredict`` job share these pieces: supplement a batch of queries,
DISPATCH one batched prediction per algorithm (for the ALS template, one
``fused_topk`` launch on the card) without waiting for it, then RESOLVE
(wait for the results on the host) and serve each query. A query that
fails to supplement or serve fills only its own slot with the exception
it raised; a dispatch or resolve failure fills every live slot (it is
one launch). ``timings`` accumulate the wall seconds of each phase under
``supplement``, ``dispatch``, ``device_wait`` and ``serve``.

The JAX package runs concurrent supplements and blocking predictions on
a module-level thread pool that nobody shuts down. Here the pool is the
caller's (``pool=``; the engine server owns one and shuts it down on
``close()``, the batch-predict job holds one for its run), and without
one the work runs on the calling thread. The base class's identity
supplement never goes to the pool: it would pay a hand-off for nothing.

Batch prediction reads JSON lines of queries and writes one
``{"query": ..., "prediction": ...}`` line each, flushing the queries in
batches of ``batch_size`` through the same path, after
``Algorithm.bind_serving`` has given each algorithm the job's context.
"""

from __future__ import annotations

import functools
import json
import time
from concurrent.futures import Executor, ThreadPoolExecutor
from typing import Any, Dict, Iterable, Iterator, List, Optional

from ..controller.base import Serving
from ..controller.context import Context
from ..controller.engine import Engine
from ..controller.params import EngineParams
from ..data.storage.base import EngineInstance
from ..utils.device import DeviceLike, resolve_device
from ..utils.jsonutil import from_jsonable, to_jsonable

#: threads of a batch path's pool (concurrent supplements, and the
#: blocking predictions of algorithms without a dispatch/readback split)
POOL_WORKERS = 8


def make_pool() -> ThreadPoolExecutor:
    """The pool a batch path owns; its threads start on first use."""
    return ThreadPoolExecutor(max_workers=POOL_WORKERS,
                              thread_name_prefix="algo-batch-dispatch")


def _add(timings: Optional[Dict[str, float]], key: str, dt: float) -> None:
    if timings is not None:
        timings[key] = timings.get(key, 0.0) + dt


def supplement_batch(serving: Any, queries: List[Any], out: List[Any],
                     timings: Optional[Dict[str, float]] = None,
                     pool: Optional[Executor] = None) -> tuple:
    """Supplement each query (the assemble stage's host work). Returns
    ``(supplemented, live)``; a query whose supplement raises gets the
    exception in its ``out`` slot. With a pool, several queries and a
    supplement of the template's own, the supplements run concurrently
    (a supplement may read the event store); results and error slots
    come back in query order either way."""
    supplemented: List[Any] = []
    live: List[int] = []
    t0 = time.monotonic()
    own = getattr(type(serving), "supplement", None) is not Serving.supplement
    if pool is not None and own and len(queries) > 1:
        futures = [pool.submit(serving.supplement, q) for q in queries]
        for i, f in enumerate(futures):
            try:
                supplemented.append(f.result())
                live.append(i)
            except Exception as e:  # noqa: BLE001 — isolate per query
                out[i] = e
    else:
        for i, q in enumerate(queries):
            try:
                supplemented.append(serving.supplement(q))
                live.append(i)
            except Exception as e:  # noqa: BLE001 — isolate per query
                out[i] = e
    _add(timings, "supplement", time.monotonic() - t0)
    return supplemented, live


def dispatch_batch(algorithms: List[Any], models: List[Any],
                   supplemented: List[Any],
                   timings: Optional[Dict[str, float]] = None,
                   pool: Optional[Executor] = None) -> List[Any]:
    """Launch each algorithm's batched prediction without waiting for
    it: one no-arg resolver per algorithm, which blocks until that
    algorithm's predictions are on the host. An algorithm with
    ``batch_predict_async`` launches here and waits only in its
    resolver, which lets the staged pipeline launch batch k+1 before
    batch k is read back. One without it runs its blocking
    ``batch_predict`` on the pool, or, where there is none, in its
    resolver.

    A failure at launch raises out of this call; a failure while
    waiting raises out of the resolver."""
    t0 = time.monotonic()
    try:
        resolvers: List[Any] = []
        for a, m in zip(algorithms, models):
            async_fn = getattr(a, "batch_predict_async", None)
            if async_fn is not None:
                resolvers.append(async_fn(m, supplemented))
            elif pool is not None:
                resolvers.append(pool.submit(a.batch_predict, m,
                                             supplemented).result)
            else:
                resolvers.append(functools.partial(a.batch_predict, m,
                                                   supplemented))
        return resolvers
    finally:
        _add(timings, "dispatch", time.monotonic() - t0)


class PendingBatch:
    """A batch whose predictions are launched but not read back:
    :meth:`resolve` waits for them and serves each query (the readback
    stage's work)."""

    __slots__ = ("queries", "serving", "out", "live", "resolvers")

    def __init__(self, queries: List[Any], serving: Any, out: List[Any],
                 live: List[int], resolvers: List[Any]):
        self.queries = queries
        self.serving = serving
        self.out = out
        self.live = live
        self.resolvers = resolvers

    def resolve(self, timings: Optional[Dict[str, float]] = None
                ) -> List[Any]:
        """Wait for the predictions (``device_wait``), then serve per
        query (``serve``). A resolver's failure fills every live slot; a
        serve failure fills only its own."""
        out, live = self.out, self.live
        if not live:
            return out
        t1 = time.monotonic()
        try:
            per_algo = [r() for r in self.resolvers]
        except Exception as e:  # noqa: BLE001 — one launch, whole batch
            for i in live:
                out[i] = e
            return out
        finally:
            t2 = time.monotonic()
            _add(timings, "device_wait", t2 - t1)
        for row, i in enumerate(live):
            try:
                # serve sees the original query, not the supplemented one
                out[i] = self.serving.serve(
                    self.queries[i], [preds[row] for preds in per_algo])
            except Exception as e:  # noqa: BLE001 — isolate per query
                out[i] = e
        _add(timings, "serve", time.monotonic() - t2)
        return out


def dispatch_serve_batch(algorithms: List[Any], models: List[Any],
                         serving: Any, queries: List[Any],
                         timings: Optional[Dict[str, float]] = None,
                         pool: Optional[Executor] = None) -> PendingBatch:
    """Supplement and launch, without waiting: the returned
    :class:`PendingBatch`'s ``resolve()`` reads back and serves."""
    out: List[Any] = [None] * len(queries)
    supplemented, live = supplement_batch(serving, queries, out,
                                          timings=timings, pool=pool)
    resolvers: List[Any] = []
    if live:
        try:
            resolvers = dispatch_batch(algorithms, models, supplemented,
                                       timings=timings, pool=pool)
        except Exception as e:  # noqa: BLE001 — one launch, whole batch
            for i in live:
                out[i] = e
            live = []
    return PendingBatch(queries, serving, out, live, resolvers)


def predict_serve_batch(algorithms: List[Any], models: List[Any],
                        serving: Any, queries: List[Any],
                        timings: Optional[Dict[str, float]] = None,
                        pool: Optional[Executor] = None) -> List[Any]:
    """The serial batch path shared by the engine server's drainers and
    the batch-predict job: :func:`dispatch_serve_batch` and an immediate
    resolve, so the serial and staged paths cannot diverge."""
    return dispatch_serve_batch(algorithms, models, serving, queries,
                                timings=timings, pool=pool
                                ).resolve(timings=timings)


def batch_predict_lines(engine: Engine, engine_params: EngineParams,
                        models: List[Any], query_lines: Iterable[str],
                        batch_size: int = 1024,
                        device: DeviceLike = None,
                        ctx: Optional[Context] = None) -> Iterator[str]:
    """One JSON result line per non-empty query line. The models are
    placed on ``device`` (the card by default) once; a query that fails
    fails the job. With ``ctx``, each algorithm is bound to it for its
    serving-time reads."""
    dev = resolve_device(device)
    algorithms = engine.make_algorithms(engine_params)
    if ctx is not None:
        for a in algorithms:
            a.bind_serving(ctx)
    models = [a.prepare_serving_model(m, dev)
              for a, m in zip(algorithms, models)]
    serving = engine.make_serving(engine_params)
    query_cls = algorithms[0].query_class

    def flush(raw_batch: List[Any], pool: Executor) -> Iterator[str]:
        queries = [from_jsonable(query_cls, q) for q in raw_batch]
        results = predict_serve_batch(algorithms, models, serving, queries,
                                      pool=pool)
        for raw, prediction in zip(raw_batch, results):
            if isinstance(prediction, Exception):
                raise prediction  # a batch job fails loudly
            yield json.dumps({"query": to_jsonable(raw),
                              "prediction": to_jsonable(prediction)})

    with make_pool() as pool:
        raw_batch: List[Any] = []
        for line in query_lines:
            line = line.strip()
            if not line:
                continue
            raw_batch.append(json.loads(line))
            if len(raw_batch) >= batch_size:
                yield from flush(raw_batch, pool)
                raw_batch = []
        if raw_batch:
            yield from flush(raw_batch, pool)


def run_batch_predict(ctx: Context, engine: Engine,
                      engine_params: EngineParams,
                      input_path: str, output_path: str,
                      engine_id: str = "default", engine_version: str = "1",
                      engine_variant: str = "engine.json",
                      instance: Optional[EngineInstance] = None,
                      batch_size: int = 1024) -> int:
    """The ``pio batchpredict`` flow: the latest COMPLETED instance's
    models (or ``instance``'s) on ``ctx.device`` (the card unless the
    context names the CPU), the input file streamed through
    :func:`batch_predict_lines`, the output file written. Returns the
    number of predictions written."""
    from . import core as wf

    if instance is None:
        instance = wf.get_latest_completed(ctx, engine_id, engine_version,
                                           engine_variant)
        if instance is None:
            raise RuntimeError("No COMPLETED engine instance; train first.")
    models = wf.load_models_for_deploy(ctx, engine, instance, engine_params)
    n = 0
    with open(input_path, "r", encoding="utf-8") as fin, \
            open(output_path, "w", encoding="utf-8") as fout:
        for line in batch_predict_lines(engine, engine_params, models, fin,
                                        batch_size=batch_size,
                                        device=ctx.device, ctx=ctx):
            fout.write(line + "\n")
            n += 1
    return n
