"""Engine drivers of the port: nearest_neighbor, recommender, anomaly,
the classifier (linear and instance-based) and regression."""

from jubatus_tpu_torch.models.anomaly import AnomalyDriver  # noqa: F401
from jubatus_tpu_torch.models.classifier import ClassifierDriver  # noqa: F401
from jubatus_tpu_torch.models.classifier_nn import ClassifierNNDriver  # noqa: F401
from jubatus_tpu_torch.models.nearest_neighbor import NearestNeighborDriver  # noqa: F401
from jubatus_tpu_torch.models.recommender import RecommenderDriver  # noqa: F401
from jubatus_tpu_torch.models.regression import RegressionDriver  # noqa: F401
