"""Engine templates: the recommendation (ALS), e-commerce and
similar-product engines."""

from .ecommerce import ecommerce_engine
from .recommendation import recommendation_engine
from .similarproduct import similarproduct_engine

__all__ = ["ecommerce_engine", "recommendation_engine",
           "similarproduct_engine"]
