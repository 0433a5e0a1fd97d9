"""Engine templates: the recommendation (ALS), e-commerce,
similar-product, classification and sequential engines."""

from .classification import classification_engine
from .ecommerce import ecommerce_engine
from .recommendation import recommendation_engine
from .sequential import sequential_engine
from .similarproduct import similarproduct_engine

__all__ = ["classification_engine", "ecommerce_engine",
           "recommendation_engine", "sequential_engine",
           "similarproduct_engine"]
