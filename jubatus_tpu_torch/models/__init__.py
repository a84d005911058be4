"""Engine drivers of the port: all eleven engines of the JAX package."""

from jubatus_tpu_torch.models.anomaly import AnomalyDriver  # noqa: F401
from jubatus_tpu_torch.models.bandit import BanditDriver  # noqa: F401
from jubatus_tpu_torch.models.burst import BurstDriver  # noqa: F401
from jubatus_tpu_torch.models.classifier import ClassifierDriver  # noqa: F401
from jubatus_tpu_torch.models.classifier_nn import ClassifierNNDriver  # noqa: F401
from jubatus_tpu_torch.models.clustering import ClusteringDriver  # noqa: F401
from jubatus_tpu_torch.models.graph import GraphDriver  # noqa: F401
from jubatus_tpu_torch.models.nearest_neighbor import NearestNeighborDriver  # noqa: F401
from jubatus_tpu_torch.models.recommender import RecommenderDriver  # noqa: F401
from jubatus_tpu_torch.models.regression import RegressionDriver  # noqa: F401
from jubatus_tpu_torch.models.stat import StatDriver  # noqa: F401
from jubatus_tpu_torch.models.weight import WeightDriver  # noqa: F401
