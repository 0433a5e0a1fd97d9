"""PredictionIO on PyTorch and CUDA: the port of ``predictionio_tpu``.

A second package beside the JAX one, which stays the reference. It
imports ``torch``, numpy and the standard library only, never JAX or the
JAX package. Module paths mirror the JAX package's, so each counterpart
is found under the same name.

This slice serves the recommendation template's ALS model: bind at
deploy, optionally row-quantize the serving tables behind an NDCG parity
gate, and answer ``POST /queries.json`` through the batched top-k, whose
kernel (``csrc/fused_topk.cu``) is written by hand for the H100. Entry
points run on the CUDA card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
