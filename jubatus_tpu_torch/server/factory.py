"""Engine → driver factory (counterpart of ``jubatus_tpu/server/factory.py``).

Config is the reference's JSON config verbatim. Only the engines this port
has reached map to a driver; every other engine is "not yet ported". The
classifier splits by method family: NN / cosine / euclidean go to the
instance-based driver, the linear methods (perceptron, PA, PA1, PA2, CW,
AROW, NHERD) to the linear one.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Type

from jubatus_tpu_torch.models.anomaly import AnomalyDriver
from jubatus_tpu_torch.models.classifier import ClassifierDriver
from jubatus_tpu_torch.models.classifier_nn import NN_METHODS, ClassifierNNDriver
from jubatus_tpu_torch.models.nearest_neighbor import NearestNeighborDriver
from jubatus_tpu_torch.models.recommender import RecommenderDriver
from jubatus_tpu_torch.models.regression import RegressionDriver

DRIVER_CLASSES: Dict[str, Type] = {
    "anomaly": AnomalyDriver,
    "nearest_neighbor": NearestNeighborDriver,
    "recommender": RecommenderDriver,
    "regression": RegressionDriver,
}

#: the JAX package's engines, for the error message
KNOWN_ENGINES = ("anomaly", "bandit", "burst", "classifier", "clustering",
                 "graph", "nearest_neighbor", "recommender", "regression",
                 "stat", "weight")


class NotYetPorted(NotImplementedError):
    pass


def driver_class(engine: str, config: dict) -> Type:
    """The driver class serving ``engine`` under ``config``."""
    if engine == "classifier":
        if config.get("method") in NN_METHODS:
            return ClassifierNNDriver
        return ClassifierDriver
    cls = DRIVER_CLASSES.get(engine)
    if cls is None:
        if engine in KNOWN_ENGINES:
            raise NotYetPorted(f"engine {engine!r} is not yet ported")
        raise KeyError(f"unknown engine {engine!r}; known: "
                       f"{', '.join(KNOWN_ENGINES)}")
    return cls


def create_driver(engine: str, config: Any, device=None):
    """Instantiate the engine's driver from a JSON config (str or dict) on
    ``device`` (cuda unless "cpu" is asked for)."""
    if isinstance(config, str):
        config = json.loads(config)
    return driver_class(engine, config)(config, device=device)
