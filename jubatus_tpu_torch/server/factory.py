"""Engine → driver factory (counterpart of ``jubatus_tpu/server/factory.py``).

Config is the reference's JSON config verbatim. All eleven engines map to a
driver. The classifier splits by method family: NN / cosine / euclidean go
to the instance-based driver, the linear methods (perceptron, PA, PA1, PA2,
CW, AROW, NHERD) to the linear one.

``--shard-devices`` routes by engine family, as in the JAX package:
feature-sharded tables for the linear classifier and regression,
row-sharded stores for the instance engines' hash methods.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Type

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


#: engines with a sharded layout, by mechanism (the JAX package's lists)
FEATURE_SHARDED_ENGINES = ("classifier", "regression")
ROW_SHARDED_ENGINES = ("nearest_neighbor", "recommender", "anomaly")


def create_driver(engine: str, config: Any, device=None, mesh=None,
                  shard_features: int = 0, ann: str = "off",
                  ann_cells: int = 0, ann_nprobe: int = 8):
    """Instantiate the engine's driver from a JSON config (str or dict) on
    ``device`` (cuda unless "cpu" is asked for).

    ``mesh`` (``--shard-devices``, a ``parallel/mesh.py:ShardMesh``):
    span the model over the mesh's devices: feature-sharded [.., D] tables
    for the linear engines (classifier, regression;
    ``parallel/sharded_model.py``), row-sharded arenas and signature
    tables for the instance engines with hash methods (nearest_neighbor,
    recommender, anomaly, the NN classifier; ``NNBackend.attach_mesh``).

    ``shard_features`` (``--shard-features D_PER_SHARD``): linear engines
    only; the shard count is the feature dim over the per-device budget.

    ``ann`` (``--ann {off,ivf}``): arm the IVF tier on the instance
    engines' NN backend, with ``ann_cells`` / ``ann_nprobe``
    (``--ann-cells`` / ``--ann-nprobe``); "off" keeps every query on the
    exact scan. The classifier and regression return before that check
    and ignore the flag, as in the JAX package."""
    if isinstance(config, str):
        config = json.loads(config)
    cls = driver_class(engine, config)
    if shard_features and engine not in FEATURE_SHARDED_ENGINES:
        raise ValueError(
            f"--shard-features applies to the feature-sharded linear "
            f"engines ({', '.join(FEATURE_SHARDED_ENGINES)}), not "
            f"{engine!r}; row-store engines "
            f"({', '.join(ROW_SHARDED_ENGINES)}) shard rows via "
            "--shard-devices N")
    if cls is ClassifierNNDriver:
        return _maybe_attach(cls(config, device=device), mesh)
    if engine in FEATURE_SHARDED_ENGINES:
        return cls(config, mesh=mesh, shard_features=shard_features,
                   device=device)
    if ann != "off" and engine not in ROW_SHARDED_ENGINES:
        raise ValueError(
            f"--ann applies to the instance engines "
            f"({', '.join(ROW_SHARDED_ENGINES)}), not {engine!r}")
    if engine in ROW_SHARDED_ENGINES:
        driver = _maybe_attach(cls(config, device=device), mesh)
        if ann != "off":
            backend = getattr(driver, "backend", None)
            if backend is None:
                raise ValueError(
                    "--ann: this method has no NN backend to index")
            backend.configure_ann(ann, cells=ann_cells, nprobe=ann_nprobe)
        return driver
    if mesh is not None:
        raise ValueError(
            f"--shard-devices is not supported for engine {engine!r}; "
            f"sharding-capable engines: "
            f"{', '.join(FEATURE_SHARDED_ENGINES)} (feature-sharded "
            "weight state; also --shard-features D_PER_SHARD) and "
            f"{', '.join(ROW_SHARDED_ENGINES)} (row-sharded stores). "
            "Spell the flag --shard-devices N (local device count) or "
            "--shard-features D_PER_SHARD (per-device feature budget)")
    return cls(config, device=device)


def _maybe_attach(driver, mesh):
    """Row-shard an instance driver's NN backend over the mesh (hash
    methods only: NNBackend.attach_mesh validates)."""
    if mesh is not None:
        backend = getattr(driver, "backend", None)
        if backend is None:
            raise ValueError(
                "--shard-devices: this method has no shardable backend")
        backend.attach_mesh(mesh)
    return driver
