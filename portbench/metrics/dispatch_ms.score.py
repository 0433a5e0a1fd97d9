"""``dispatch_ms.score``: host milliseconds a flush spends inside
``models/als.py::recommend_batch_async`` (staging the ids, launching
``fused_topk``, queueing the readback), from the benchmark's host spans
outside the traced sub-window."""

from portbench.harness.readers import span_mean_ms


def read(run):
    return span_mean_ms(run, "score.dispatch")
