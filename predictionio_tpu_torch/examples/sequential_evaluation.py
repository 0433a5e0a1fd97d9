"""Leave-one-out evaluation of the sequential template: the port's
counterpart of ``examples/sequential/evaluation.py``, with the same
metrics and grid, importing only the port.

Run (an app named like ``APP_NAME`` below must hold ``view``, ``rate``
or ``buy`` events)::

    python -m predictionio_tpu_torch.cli eval \\
        predictionio_tpu_torch.examples.sequential_evaluation:evaluation \\
        predictionio_tpu_torch.examples.sequential_evaluation:engine_params_generator \\
        [--device cpu]
"""

import os

from ..controller.evaluation import EngineParamsGenerator, Evaluation
from ..controller.params import EngineParams
from ..models.seqrec import SeqRecParams
from ..templates.sequential import (
    DataSourceParams,
    HitRateAtK,
    SeqNDCGAtK,
    sequential_engine,
)

APP_NAME = os.environ.get("PTPU_EVAL_APP", "MyApp1")

#: HitRate@10 optimized, SeqNDCG@10 beside it
evaluation = Evaluation(
    engine=sequential_engine(),
    metric=HitRateAtK(k=10),
    other_metrics=[SeqNDCGAtK(k=10)],
)


class _Gen(EngineParamsGenerator):
    """dim x num_blocks grid."""

    engine_params_list = [
        EngineParams(
            datasource=("", DataSourceParams(app_name=APP_NAME,
                                             max_len=50,
                                             eval_query_num=10)),
            algorithms=[("seqrec", SeqRecParams(
                dim=dim, heads=2, num_blocks=blocks, max_len=50,
                num_epochs=20, batch_size=256, learning_rate=1e-3,
                n_negatives=64, seed=7))])
        for dim in (32, 64)
        for blocks in (1, 2)
    ]


engine_params_generator = _Gen()
