"""Classification models: multinomial naive Bayes + random forest (the
port of ``predictionio_tpu/models/classify.py``).

The role MLlib's ``NaiveBayes`` and ``RandomForest`` play for the
classification template (reference
``examples/scala-parallel-classification/add-algorithm/src/main/scala/
{NaiveBayesAlgorithm,RandomForestAlgorithm}.scala``).

- Naive Bayes: MLlib-compatible multinomial fit (additive ``lambda``
  smoothing over feature-value sums) producing a ``[C]`` log-prior vector
  and ``[C, F]`` log-likelihood matrix; ``predict`` is float64 on the
  host, ``predict_batch`` one f32 matmul and an argmax on ``device``.
- Random forest: trees are grown on the host with
  ``np.random.default_rng(seed)``, the JAX package's code, so the trees
  are equal bit for bit; the fitted forest is encoded as dense arrays
  (feature / threshold / left / right / leaf-class per node, padded
  across trees) so inference is ``max_depth + 1`` gathers on ``device``,
  batched over queries and trees at once, then the vote and its argmax.

``device`` is the card unless the caller asks for the CPU; a model
remembers the device it was trained or placed on (``model.device``, not
stored in the model file). ``torch.argmax`` returns the first maximum,
as ``jnp.argmax`` does. The device tensors are cached on the model and
dropped when it is pickled.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device


# ---------------------------------------------------------------------------
# multinomial naive Bayes (MLlib NaiveBayes.train(data, lambda) parity)
# ---------------------------------------------------------------------------

@dataclass
class NaiveBayesModel:
    log_priors: np.ndarray       # [C]
    log_likelihoods: np.ndarray  # [C, F]
    classes: np.ndarray          # [C] original class labels (float/int)
    #: where ``predict_batch`` runs by default (None: the card)
    device: Optional[str] = None

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_scorer", None)
        return state

    def predict(self, features: Sequence[float]) -> float:
        x = np.asarray(features, dtype=np.float64)
        scores = self.log_priors + self.log_likelihoods @ x
        return float(self.classes[int(np.argmax(scores))])

    def predict_batch(self, features: np.ndarray,
                      device: DeviceLike = None) -> np.ndarray:
        """[B, F] → [B] labels via one f32 matmul and an argmax on
        ``device`` (else ``self.device``)."""
        dev = resolve_device(device if device is not None else self.device)
        scorer = getattr(self, "_scorer", None)
        if scorer is None or scorer[0] != dev:
            scorer = self._scorer = (
                dev,
                torch.as_tensor(self.log_likelihoods, dtype=torch.float32,
                                device=dev),
                torch.as_tensor(self.log_priors, dtype=torch.float32,
                                device=dev))
        _, ll, lp = scorer
        x = torch.as_tensor(np.asarray(features, dtype=np.float32),
                            device=dev)
        idx = torch.argmax(x @ ll.T + lp, dim=1).cpu().numpy()
        return self.classes[idx]


def train_naive_bayes_multinomial(features: np.ndarray, labels: np.ndarray,
                                  lam: float = 1.0) -> NaiveBayesModel:
    """MLlib multinomial NB: ``pi_c = log((N_c + λ)/(N + λC))``,
    ``theta_cf = log((Σ x_f|c + λ)/(Σ x|c + λF))``. Features must be
    non-negative (counts/one-hot)."""
    features = np.asarray(features, dtype=np.float64)
    labels = np.asarray(labels)
    if features.ndim != 2 or len(features) != len(labels):
        raise ValueError("features must be [N, F] aligned with labels")
    if (features < 0).any():
        raise ValueError("multinomial NB requires non-negative features")
    if lam <= 0:
        # λ=0 sends log(counts + λ) to -inf for any empty class/feature
        # and poisons every downstream score with NaN
        raise ValueError("lam (Laplace smoothing) must be positive")
    classes, class_idx = np.unique(labels, return_inverse=True)
    C, F = len(classes), features.shape[1]
    counts = np.bincount(class_idx, minlength=C).astype(np.float64)
    sums = np.zeros((C, F), dtype=np.float64)
    np.add.at(sums, class_idx, features)
    log_priors = np.log(counts + lam) - np.log(len(labels) + lam * C)
    log_likelihoods = (np.log(sums + lam)
                       - np.log(sums.sum(axis=1, keepdims=True) + lam * F))
    return NaiveBayesModel(log_priors, log_likelihoods, classes)


# ---------------------------------------------------------------------------
# random forest (MLlib RandomForest.trainClassifier parity)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RandomForestParams:
    num_classes: int = 2
    num_trees: int = 10
    feature_subset_strategy: str = "auto"  # auto|all|sqrt|log2|onethird
    impurity: str = "gini"
    max_depth: int = 5
    max_bins: int = 32
    seed: int = 0


class RandomForestModel:
    """Forest encoded as dense per-node arrays, padded across trees.

    ``feature[t, n] < 0`` marks a leaf whose class is ``leaf[t, n]``;
    internal nodes route to ``left/right[t, n]`` on
    ``x[feature] <= threshold``.
    """

    def __init__(self, feature: np.ndarray, threshold: np.ndarray,
                 left: np.ndarray, right: np.ndarray, leaf: np.ndarray,
                 classes: np.ndarray, max_depth: int,
                 device: Optional[str] = None):
        self.feature = feature      # [T, N] int32 (−1 = leaf)
        self.threshold = threshold  # [T, N] float32
        self.left = left            # [T, N] int32
        self.right = right          # [T, N] int32
        self.leaf = leaf            # [T, N] int32 (class index)
        self.classes = classes
        self.max_depth = max_depth
        #: where ``predict_batch`` runs by default (None: the card)
        self.device = device

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_traverse", None)
        return state

    def predict(self, features: Sequence[float]) -> float:
        return float(self.predict_batch(
            np.asarray(features, dtype=np.float32)[None, :])[0])

    def votes(self, features: np.ndarray,
              device: DeviceLike = None) -> torch.Tensor:
        """[B, F] → [B, C] f32 votes on ``device`` (else
        ``self.device``): a fixed-depth traversal of all trees at
        once."""
        dev = resolve_device(device if device is not None else self.device)
        arrays = getattr(self, "_traverse", None)
        if arrays is None or arrays[0] != dev:
            arrays = self._traverse = (dev,) + tuple(
                torch.as_tensor(a, device=dev).long() if a.dtype.kind == "i"
                else torch.as_tensor(a, device=dev)
                for a in (self.feature, self.threshold, self.left,
                          self.right, self.leaf))
        _, feat, thr, lft, rgt, leaf = arrays
        x = torch.as_tensor(np.asarray(features, dtype=np.float32),
                            device=dev)
        B, T = x.shape[0], feat.shape[0]
        trees = torch.arange(T, device=dev)[None, :].expand(B, T)
        node = torch.zeros((B, T), dtype=torch.long, device=dev)
        for _ in range(self.max_depth + 1):
            f = feat[trees, node]                                # [B, T]
            xv = torch.gather(x, 1, f.clamp_min(0))
            nxt = torch.where(xv <= thr[trees, node], lft[trees, node],
                              rgt[trees, node])
            node = torch.where(f < 0, node, nxt)
        cls = leaf[trees, node]                                  # [B, T]
        out = torch.zeros((B, len(self.classes)), dtype=torch.float32,
                          device=dev)
        return out.scatter_add_(1, cls, torch.ones_like(cls, dtype=out.dtype))

    def predict_batch(self, features: np.ndarray,
                      device: DeviceLike = None) -> np.ndarray:
        """[B, F] → [B] labels: the majority vote, the first class on a
        tie."""
        idx = torch.argmax(self.votes(features, device), dim=1)
        return self.classes[idx.cpu().numpy()]


def _n_subset_features(strategy: str, n_features: int) -> int:
    if strategy in ("auto", "sqrt"):
        return max(1, int(np.sqrt(n_features)))
    if strategy == "log2":
        return max(1, int(np.log2(n_features)))
    if strategy == "onethird":
        return max(1, n_features // 3)
    return n_features  # "all"


def _gini(counts: np.ndarray) -> float:
    n = counts.sum()
    if n == 0:
        return 0.0
    p = counts / n
    return float(1.0 - (p * p).sum())


def _entropy(counts: np.ndarray) -> float:
    n = counts.sum()
    if n == 0:
        return 0.0
    p = counts[counts > 0] / n
    return float(-(p * np.log2(p)).sum())


def train_random_forest(features: np.ndarray, labels: np.ndarray,
                        params: RandomForestParams) -> RandomForestModel:
    """Bootstrap + per-node feature subsetting + binned threshold search
    (MLlib ``RandomForest.trainClassifier`` semantics at template scale)."""
    X = np.asarray(features, dtype=np.float32)
    y_raw = np.asarray(labels)
    classes, y = np.unique(y_raw, return_inverse=True)
    if len(classes) > params.num_classes:
        raise ValueError(
            f"found {len(classes)} distinct labels but num_classes="
            f"{params.num_classes} (MLlib trainClassifier validates this)")
    n, F = X.shape
    C = len(classes)
    impurity_fn = _gini if params.impurity == "gini" else _entropy
    rng = np.random.default_rng(params.seed)
    k_feats = _n_subset_features(params.feature_subset_strategy, F)

    trees = []
    for _ in range(params.num_trees):
        sample = rng.integers(0, n, n)  # bootstrap
        nodes = {"feature": [], "threshold": [], "left": [], "right": [],
                 "leaf": []}

        def new_node():
            for v in nodes.values():
                v.append(0)
            nodes["feature"][-1] = -1
            return len(nodes["feature"]) - 1

        def grow(idx: np.ndarray, depth: int) -> int:
            me = new_node()
            counts = np.bincount(y[idx], minlength=C).astype(np.float64)
            majority = int(np.argmax(counts))
            nodes["leaf"][me] = majority
            if depth >= params.max_depth or len(np.unique(y[idx])) <= 1 \
                    or len(idx) < 2:
                return me
            parent_imp = impurity_fn(counts)
            best = (0.0, None, None)  # (gain, feature, threshold)
            for f in rng.choice(F, size=k_feats, replace=False):
                vals = X[idx, f]
                uniq = np.unique(vals)
                if len(uniq) <= 1:
                    continue
                if len(uniq) > params.max_bins:
                    qs = np.quantile(vals, np.linspace(0, 1,
                                                       params.max_bins + 1)
                                     [1:-1])
                    cand = np.unique(qs)
                else:
                    cand = (uniq[:-1] + uniq[1:]) / 2
                for t in cand:
                    mask = vals <= t
                    nl = mask.sum()
                    if nl == 0 or nl == len(idx):
                        continue
                    cl = np.bincount(y[idx[mask]], minlength=C)
                    cr = counts - cl
                    gain = parent_imp - (
                        nl / len(idx) * impurity_fn(cl.astype(np.float64))
                        + (1 - nl / len(idx))
                        * impurity_fn(cr.astype(np.float64)))
                    if gain > best[0]:
                        best = (gain, int(f), float(t))
            if best[1] is None:
                return me
            _, f, t = best
            mask = X[idx, f] <= t
            li = grow(idx[mask], depth + 1)
            ri = grow(idx[~mask], depth + 1)
            nodes["feature"][me] = f
            nodes["threshold"][me] = t
            nodes["left"][me] = li
            nodes["right"][me] = ri
            return me

        grow(sample, 0)
        trees.append(nodes)

    max_nodes = max(len(t["feature"]) for t in trees)
    T = len(trees)
    feature = np.full((T, max_nodes), -1, dtype=np.int32)
    threshold = np.zeros((T, max_nodes), dtype=np.float32)
    left = np.zeros((T, max_nodes), dtype=np.int32)
    right = np.zeros((T, max_nodes), dtype=np.int32)
    leaf = np.zeros((T, max_nodes), dtype=np.int32)
    for ti, t in enumerate(trees):
        m = len(t["feature"])
        feature[ti, :m] = t["feature"]
        threshold[ti, :m] = t["threshold"]
        left[ti, :m] = t["left"]
        right[ti, :m] = t["right"]
        leaf[ti, :m] = t["leaf"]
    return RandomForestModel(feature, threshold, left, right, leaf,
                             classes, params.max_depth)
