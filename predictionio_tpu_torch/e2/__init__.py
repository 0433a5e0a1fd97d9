"""e2 — reusable algorithm library beside the engine templates (the
port of ``predictionio_tpu/e2``).

Capability parity with the reference's ``e2/`` sbt module: string-keyed
combinators become integer-indexed vocabularies
(:class:`~predictionio_tpu_torch.data.bimap.BiMap`) plus dense arrays;
batch scoring gathers them as tensors on the card unless the caller asks
for the CPU.
"""

from .naive_bayes import (  # noqa: F401
    CategoricalNaiveBayesModel,
    LabeledPoint,
    train_naive_bayes,
)
from .markov_chain import MarkovChainModel, train_markov_chain  # noqa: F401
from .vectorizer import BinaryVectorizer  # noqa: F401
from .cross_validation import split_data  # noqa: F401
