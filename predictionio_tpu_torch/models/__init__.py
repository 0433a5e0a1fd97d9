"""The algorithm library: ALS training and serving on the card, and the
ratings helpers templates train from. Importing it builds no kernel:
each is compiled at its first launch."""

from .als import (
    ALSModel,
    ALSParams,
    RatingsCOO,
    recommend_batch,
    recommend_products,
    train_als,
)
from .data import kfold_split, ratings_from_events

__all__ = [
    "ALSModel",
    "ALSParams",
    "RatingsCOO",
    "kfold_split",
    "ratings_from_events",
    "recommend_batch",
    "recommend_products",
    "train_als",
]
