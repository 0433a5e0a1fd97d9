"""PredictionIO on PyTorch and CUDA: the port of ``predictionio_tpu``.

A second package beside the JAX one, which stays the reference. It
imports ``torch``, numpy and the standard library only, never JAX or the
JAX package. Module paths mirror the JAX package's, so each counterpart
is found under the same name.

It trains and serves the recommendation template's ALS model:
``Engine.train`` packs the rating histories and alternates half-steps
whose normal equations and solves run in kernels written by hand for the
H100 (``csrc/fused_gram.cu``, ``csrc/chol_solve.cu``); a model is bound
at deploy, optionally row-quantized behind an NDCG parity gate, and
answers ``POST /queries.json`` through the batched top-k kernel
(``csrc/fused_topk.cu``). Entry points run on the CUDA card unless the
caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from .data.bimap import BiMap
from .data.datamap import DataMap, PropertyMap
from .data.event import Event

__all__ = ["DataMap", "PropertyMap", "Event", "BiMap", "__version__"]
