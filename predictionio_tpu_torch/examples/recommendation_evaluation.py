"""Shipped evaluation of the recommendation template: the port's
counterpart of ``examples/recommendation/evaluation.py``, with the same
metrics and grid, importing only the port.

Run (an app named like ``APP_NAME`` below must hold rating events)::

    python -m predictionio_tpu_torch.cli eval \\
        predictionio_tpu_torch.examples.recommendation_evaluation:evaluation \\
        predictionio_tpu_torch.examples.recommendation_evaluation:engine_params_generator \\
        [--device cpu] [--parallelism 2]
"""

import os

from ..controller.evaluation import EngineParamsGenerator, Evaluation
from ..controller.params import EngineParams
from ..models.als import ALSParams
from ..templates.recommendation import (
    DataSourceParams,
    NDCGAtK,
    PositiveCount,
    PrecisionAtK,
    recommendation_engine,
)

APP_NAME = os.environ.get("PTPU_EVAL_APP", "MyApp1")

#: Precision@10 (threshold 4.0) as the optimized metric; Precision at
#: k in {1, 3, 10} x thresholds {0, 2, 4}, NDCG@10 and PositiveCount as
#: side metrics.
evaluation = Evaluation(
    engine=recommendation_engine(),
    metric=PrecisionAtK(k=10, rating_threshold=4.0),
    other_metrics=[
        *(PrecisionAtK(k=k, rating_threshold=t)
          for t in (0.0, 2.0, 4.0) for k in (1, 3, 10)
          if not (k == 10 and t == 4.0)),
        NDCGAtK(k=10, rating_threshold=2.0),
        PositiveCount(rating_threshold=2.0),
    ],
)


class _Gen(EngineParamsGenerator):
    """rank x numIterations grid."""

    engine_params_list = [
        EngineParams(
            datasource=("", DataSourceParams(app_name=APP_NAME, eval_k=3)),
            algorithms=[("als", ALSParams(rank=rank, num_iterations=it,
                                          reg=0.01, seed=3))])
        for rank in (8, 16) for it in (5, 10)
    ]


engine_params_generator = _Gen()
