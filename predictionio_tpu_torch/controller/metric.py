"""Metric library: the port's own copy of
``predictionio_tpu/controller/metric.py`` (plain numpy and ``math``).

Evaluation data is ``[(eval_info, [(q, p, a)])]``, one entry a fold.
Point-wise metrics score each ``(q, p, a)`` and aggregate the scores of
every fold together with numpy; a point scored ``None`` is left out of
the numerator and the denominator alike.
"""

from __future__ import annotations

import abc
import math
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

EvalData = Sequence[Tuple[Any, Sequence[Tuple[Any, Any, Any]]]]


class Metric(abc.ABC):
    """Computes a scalar score from evaluation output; larger is better
    unless ``compare`` is overridden."""

    @abc.abstractmethod
    def calculate(self, eval_data: EvalData) -> float:
        ...

    def compare(self, a: float, b: float) -> int:
        """Ordering for model selection (> 0: ``a`` is better)."""
        return (a > b) - (a < b)

    @property
    def header(self) -> str:
        return type(self).__name__

    def __repr__(self) -> str:
        return self.header


class PointwiseMetric(Metric):
    """Base for metrics defined by a per-(q, p, a) score."""

    def calculate_point(self, eval_info, q, p, a) -> Optional[float]:
        raise NotImplementedError

    def _scores(self, eval_data: EvalData) -> np.ndarray:
        vals: List[float] = []
        for ei, qpas in eval_data:
            for q, p, a in qpas:
                s = self.calculate_point(ei, q, p, a)
                if s is not None:
                    vals.append(float(s))
        return np.asarray(vals, dtype=np.float64)


class AverageMetric(PointwiseMetric):
    """Mean of the per-point scores; ``None`` points are excluded (NaN
    when none is left)."""

    def calculate(self, eval_data: EvalData) -> float:
        s = self._scores(eval_data)
        return float(s.mean()) if s.size else float("nan")


OptionAverageMetric = AverageMetric


class StdevMetric(PointwiseMetric):
    """Population standard deviation of the per-point scores."""

    def calculate(self, eval_data: EvalData) -> float:
        s = self._scores(eval_data)
        return float(s.std()) if s.size else float("nan")


OptionStdevMetric = StdevMetric


class SumMetric(PointwiseMetric):
    """Sum of the per-point scores."""

    def calculate(self, eval_data: EvalData) -> float:
        return float(self._scores(eval_data).sum())


class ZeroMetric(Metric):
    """Always 0: a placeholder for eval-only runs."""

    def calculate(self, eval_data: EvalData) -> float:
        return 0.0


# -- ranking metrics ----------------------------------------------------------

def precision_at_k(predicted: Sequence[Any], relevant: set, k: int
                   ) -> Optional[float]:
    """|top-k ∩ relevant| / min(k, |relevant|); None (excluded) when
    nothing is relevant."""
    if not relevant:
        return None
    topk = list(predicted)[:k]
    hits = sum(1 for x in topk if x in relevant)
    return hits / min(k, len(relevant))


def ndcg_at_k(predicted: Sequence[Any], relevant: set, k: int
              ) -> Optional[float]:
    """Binary-relevance NDCG@K; None when nothing is relevant."""
    if not relevant:
        return None
    topk = list(predicted)[:k]
    dcg = sum(1.0 / math.log2(i + 2) for i, x in enumerate(topk)
              if x in relevant)
    ideal = sum(1.0 / math.log2(i + 2)
                for i in range(min(k, len(relevant))))
    return dcg / ideal if ideal > 0 else None
