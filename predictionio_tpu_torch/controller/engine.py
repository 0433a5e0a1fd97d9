"""Engine: binds named algorithm and serving classes (the serving half of
``predictionio_tpu/controller/engine.py``)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Type, Union

from .base import Algorithm, Serving
from .params import EngineParams, engine_params_from_variant, instantiate

ClassMap = Union[Type, Dict[str, Type]]


def _as_map(x: ClassMap) -> Dict[str, Type]:
    return x if isinstance(x, dict) else {"": x}


class Engine:
    """Named class maps for the algorithm and serving slots."""

    def __init__(self, algorithm_classes: ClassMap,
                 serving_classes: ClassMap,
                 algorithm_params_classes: Optional[Dict[str, Type]] = None,
                 serving_params_class: Optional[Type] = None):
        self.algorithm_classes = _as_map(algorithm_classes)
        self.serving_classes = _as_map(serving_classes)
        self.algorithm_params_classes = algorithm_params_classes or {}
        self.serving_params_class = serving_params_class

    def _make(self, classes: Dict[str, Type], pair: Tuple[str, Any],
              slot: str):
        name, params = pair
        if name not in classes:
            raise KeyError(f"{slot} {name!r} not registered "
                           f"(available: {sorted(classes)})")
        return instantiate(classes[name], params)

    def make_algorithms(self, ep: EngineParams) -> List[Algorithm]:
        return [self._make(self.algorithm_classes, pair, "algorithm")
                for pair in ep.algorithms]

    def make_serving(self, ep: EngineParams) -> Serving:
        return self._make(self.serving_classes, ep.serving, "serving")

    def params_from_variant(self, variant: dict) -> EngineParams:
        return engine_params_from_variant(
            variant,
            algorithm_params_classes=self.algorithm_params_classes,
            serving_params_cls=self.serving_params_class)
