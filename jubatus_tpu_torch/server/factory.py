"""Engine → driver factory (counterpart of ``jubatus_tpu/server/factory.py``).

Config is the reference's JSON config verbatim. All eleven engines map to a
driver. The classifier splits by method family: NN / cosine / euclidean go
to the instance-based driver, the linear methods (perceptron, PA, PA1, PA2,
CW, AROW, NHERD) to the linear one. Features within an engine that the
port has not reached raise ``NotYetPorted`` from the driver.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Type

from jubatus_tpu_torch import NotYetPorted  # noqa: F401
from jubatus_tpu_torch.models.anomaly import AnomalyDriver
from jubatus_tpu_torch.models.bandit import BanditDriver
from jubatus_tpu_torch.models.burst import BurstDriver
from jubatus_tpu_torch.models.classifier import ClassifierDriver
from jubatus_tpu_torch.models.classifier_nn import NN_METHODS, ClassifierNNDriver
from jubatus_tpu_torch.models.clustering import ClusteringDriver
from jubatus_tpu_torch.models.graph import GraphDriver
from jubatus_tpu_torch.models.nearest_neighbor import NearestNeighborDriver
from jubatus_tpu_torch.models.recommender import RecommenderDriver
from jubatus_tpu_torch.models.regression import RegressionDriver
from jubatus_tpu_torch.models.stat import StatDriver
from jubatus_tpu_torch.models.weight import WeightDriver

DRIVER_CLASSES: Dict[str, Type] = {
    "anomaly": AnomalyDriver,
    "bandit": BanditDriver,
    "burst": BurstDriver,
    "classifier": ClassifierDriver,
    "clustering": ClusteringDriver,
    "graph": GraphDriver,
    "nearest_neighbor": NearestNeighborDriver,
    "recommender": RecommenderDriver,
    "regression": RegressionDriver,
    "stat": StatDriver,
    "weight": WeightDriver,
}

#: the engines, as the JAX package names them
KNOWN_ENGINES = tuple(sorted(DRIVER_CLASSES))


def driver_class(engine: str, config: dict) -> Type:
    """The driver class serving ``engine`` under ``config``."""
    if engine == "classifier" and config.get("method") in NN_METHODS:
        return ClassifierNNDriver
    cls = DRIVER_CLASSES.get(engine)
    if cls is None:
        raise KeyError(f"unknown engine {engine!r}; known: "
                       f"{', '.join(KNOWN_ENGINES)}")
    return cls


def create_driver(engine: str, config: Any, device=None):
    """Instantiate the engine's driver from a JSON config (str or dict) on
    ``device`` (cuda unless "cpu" is asked for)."""
    if isinstance(config, str):
        config = json.loads(config)
    return driver_class(engine, config)(config, device=device)
