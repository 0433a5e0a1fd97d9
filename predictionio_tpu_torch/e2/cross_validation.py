"""k-fold split utility for evaluation data sources (the port's copy of
``predictionio_tpu/e2/cross_validation.py``).

Behavior parity with
``e2/src/main/scala/org/apache/predictionio/e2/evaluation/CrossValidation.scala``
(``CommonHelperFunctions.splitData`` :44-75): point i lands in the test
set of fold ``i % k`` and the training set of every other fold.

Host-side by design — fold selection is index arithmetic over the event
log; the heavy lifting happens in the per-fold training that consumes the
split.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple, TypeVar

D = TypeVar("D")
TD = TypeVar("TD")
EI = TypeVar("EI")
Q = TypeVar("Q")
A = TypeVar("A")


def split_data(
        eval_k: int,
        dataset: Sequence[D],
        evaluator_info: EI,
        training_data_creator: Callable[[List[D]], TD],
        query_creator: Callable[[D], Q],
        actual_creator: Callable[[D], A],
) -> List[Tuple[TD, EI, List[Tuple[Q, A]]]]:
    """Split into eval_k (training-data, eval-info, [(query, actual)])."""
    out = []
    for fold in range(eval_k):
        training = [p for i, p in enumerate(dataset) if i % eval_k != fold]
        testing = [p for i, p in enumerate(dataset) if i % eval_k == fold]
        out.append((
            training_data_creator(training),
            evaluator_info,
            [(query_creator(p), actual_creator(p)) for p in testing],
        ))
    return out
