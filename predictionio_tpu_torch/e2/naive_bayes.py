"""Categorical naive Bayes over string features (the port of
``predictionio_tpu/e2/naive_bayes.py``).

Behavior parity with the reference's
``e2/src/main/scala/org/apache/predictionio/e2/engine/CategoricalNaiveBayes.scala``
(train :29-81, logScore :97-135, predict :137-148): per-label log priors
``log(labelCount / total)``, per-(label, feature-slot) log likelihoods
``log(valueCount / labelCount)`` with NO smoothing, missing feature value
→ a caller-supplied default (−inf by default), unknown label → None.

The model holds one dense ``[n_labels, n_slots, max_vocab]``
log-likelihood array (absent values hold −inf; a parallel validity mask
distinguishes "absent" from a real −inf) plus BiMap vocabularies.
Single-point ``log_score``/``predict`` stay on the host (dict lookups);
``predict_batch`` gathers the f32 tensor on ``device`` (the card unless
the caller asks for the CPU) and takes the argmax over labels, the first
on a tie, as ``jnp.argmax`` does. The tensors are cached on the model
per device, and dropped when it is pickled.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.bimap import BiMap
from ..utils.device import DeviceLike, resolve_device

NEG_INF = float("-inf")


@dataclass(frozen=True)
class LabeledPoint:
    """A label plus one string value per feature slot."""
    label: str
    features: Tuple[str, ...]

    def __init__(self, label: str, features: Sequence[str]):
        object.__setattr__(self, "label", label)
        object.__setattr__(self, "features", tuple(features))


class CategoricalNaiveBayesModel:
    def __init__(self, labels: BiMap, vocabs: List[BiMap],
                 priors: np.ndarray, likelihoods: np.ndarray,
                 present: np.ndarray):
        #: label string → row index
        self.labels = labels
        #: per feature slot: value string → column index
        self.vocabs = vocabs
        #: [L] log priors
        self.priors = priors
        #: [L, F, Vmax] log likelihoods (−inf where absent)
        self.likelihoods = likelihoods
        #: [L, F, Vmax] bool: True where the (label, slot, value) count > 0
        self.present = present
        self.feature_count = likelihoods.shape[1]
        self._batch_scorer = None

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_batch_scorer"] = None  # jitted closure is not picklable
        return state

    def prior(self, label: str) -> float:
        return float(self.priors[self.labels[label]])

    def likelihood(self, label: str, slot: int, value: str
                   ) -> Optional[float]:
        """Log likelihood, or None when the (label, value) pair was never
        observed (parity with ``likelihoods(label)(slot)`` missing keys)."""
        li = self.labels[label]
        vi = self.vocabs[slot].get(value)
        if vi is None or not self.present[li, slot, vi]:
            return None
        return float(self.likelihoods[li, slot, vi])

    def _slot_likelihoods(self, label_idx: int, slot: int) -> List[float]:
        row = self.likelihoods[label_idx, slot]
        mask = self.present[label_idx, slot]
        return [float(v) for v in row[mask]]

    def log_score(self, point: LabeledPoint,
                  default_likelihood: Callable[[Sequence[float]], float]
                  = lambda ls: NEG_INF) -> Optional[float]:
        """Log score of (label, features); None for an unknown label.

        ``default_likelihood`` receives the label's observed likelihoods for
        the slot whenever the feature value is unseen for that label
        (reference ``logScore`` :97-115).
        """
        li = self.labels.get(point.label)
        if li is None:
            return None
        return self._score_internal(li, point.features, default_likelihood)

    def _score_internal(self, label_idx: int, features: Sequence[str],
                        default_likelihood: Callable[[Sequence[float]], float]
                        = lambda ls: NEG_INF) -> float:
        total = float(self.priors[label_idx])
        for slot, value in enumerate(features):
            vi = self.vocabs[slot].get(value)
            if vi is not None and self.present[label_idx, slot, vi]:
                total += float(self.likelihoods[label_idx, slot, vi])
            else:
                total += default_likelihood(
                    self._slot_likelihoods(label_idx, slot))
        return total

    def predict(self, features: Sequence[str]) -> str:
        """Label with the highest log score (−inf default likelihood)."""
        scores = [(self._score_internal(li, features), li)
                  for li in range(len(self.labels))]
        best = max(scores, key=lambda s: s[0])
        return self.labels.inverse[best[1]]

    def encode(self, features_batch: Sequence[Sequence[str]]) -> np.ndarray:
        """[B, F] int32 value indices; unseen values → the padded −inf col."""
        out = np.full((len(features_batch), self.feature_count),
                      self.likelihoods.shape[2] - 1, dtype=np.int32)
        for b, features in enumerate(features_batch):
            for slot, value in enumerate(features):
                vi = self.vocabs[slot].get(value)
                if vi is not None:
                    out[b, slot] = vi
        return out

    def predict_batch(self, features_batch: Sequence[Sequence[str]],
                      device: DeviceLike = None) -> List[str]:
        """Vectorized argmax over labels for a batch of points, on
        ``device``: a gather of the f32 likelihoods and a sum over
        slots."""
        dev = resolve_device(device)
        if self._batch_scorer is None or self._batch_scorer[0] != dev:
            self._batch_scorer = (
                dev,
                torch.as_tensor(self.likelihoods, dtype=torch.float32,
                                device=dev),
                torch.as_tensor(self.priors, dtype=torch.float32,
                                device=dev))
        _, lik, pri = self._batch_scorer
        idx = torch.from_numpy(self.encode(features_batch)).to(dev).long()
        L = lik.shape[0]
        # gather [L, F, B], then reduce the slots
        g = torch.gather(lik, 2, idx.T[None].expand(L, -1, -1))
        scores = pri[:, None] + g.sum(dim=1)  # [L, B]
        best = torch.argmax(scores, dim=0).cpu().numpy()
        inv = self.labels.inverse
        return [inv[int(b)] for b in best]


def train_naive_bayes(points: Sequence[LabeledPoint]
                      ) -> CategoricalNaiveBayesModel:
    """Count-based fit (reference ``CategoricalNaiveBayes.train`` :29-81).

    Counting is host-side (one pass over the log, trivially cheap); the
    output arrays are what ``predict_batch`` scores with.
    """
    if not points:
        raise ValueError("cannot train naive Bayes on an empty dataset")
    n_slots = len(points[0].features)
    labels = BiMap.string_int(sorted({p.label for p in points}))
    vocabs = [BiMap.string_int(sorted({p.features[s] for p in points}))
              for s in range(n_slots)]
    n_labels = len(labels)
    # +1 padded column stays −inf / absent so encode() can point unseen
    # values at it
    vmax = max(len(v) for v in vocabs) + 1

    label_counts = np.zeros(n_labels, dtype=np.int64)
    counts = np.zeros((n_labels, n_slots, vmax), dtype=np.int64)
    for p in points:
        li = labels[p.label]
        label_counts[li] += 1
        for slot, value in enumerate(p.features):
            counts[li, slot, vocabs[slot][value]] += 1

    priors = np.log(label_counts / float(len(points)))
    present = counts > 0
    with np.errstate(divide="ignore"):
        likelihoods = np.where(
            present,
            np.log(counts / label_counts[:, None, None].astype(np.float64)),
            NEG_INF)
    return CategoricalNaiveBayesModel(labels, vocabs, priors,
                                      likelihoods, present)
