"""Client library (copy of ``jubatus_tpu/client/``; ≙ jubatus/client/).

Typed per-engine clients over a common base, same wire protocol as the
reference's generated clients (client/common/client.hpp:30-87): every call
carries the cluster name as its first parameter; the same client talks to a
standalone server, a cluster member, or a proxy.

    from jubatus_tpu_torch.client import ClassifierClient
    c = ClassifierClient("127.0.0.1", 9199, "name")
    c.train([("spam", Datum({"subject": "win money"}))])
    c.classify([Datum({"subject": "hello"})])

Engine method sets are generated from the IDL tables
(jubatus_tpu_torch.framework.idl) — one class per engine, one method per RPC.
Datum-typed arguments accept `Datum` objects (packed to the wire 3-tuple
automatically); datum-typed results come back as wire tuples — use
`Datum.from_msgpack` when you want the typed view.

Self-healing plane: idempotent calls (classify /
estimate / get_status / ...) transparently retry on transport failures
with jittered backoff under a per-client retry budget; effectful calls
(train / push / clear) never do. Cap an operation's total latency with
``deadline_after`` (re-exported here) — the remaining budget propagates
to the server, which rejects already-expired work:

    with deadline_after(0.2):
        c.classify([Datum({"subject": "hello"})])
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from jubatus_tpu_torch.core.datum import Datum  # noqa: F401  (re-export)
from jubatus_tpu_torch.framework.idl import SERVICES
from jubatus_tpu_torch.rpc.client import RpcClient
from jubatus_tpu_torch.rpc.deadline import deadline_after  # noqa: F401  (re-export)


class ClientBase:
    """Common built-ins (client/common/client.hpp:30-87)."""

    ENGINE = ""

    def __init__(self, host: str, port: int, name: str, timeout: float = 10.0):
        self.name = name
        self.client = RpcClient(host, port, timeout)

    # -- built-ins -----------------------------------------------------------
    def get_config(self) -> str:
        return self.client.call("get_config", self.name)

    def save(self, model_id: str) -> Dict[str, str]:
        return self.client.call("save", self.name, model_id)

    def load(self, model_id: str) -> bool:
        return self.client.call("load", self.name, model_id)

    def get_status(self) -> Dict[str, Dict[str, Any]]:
        return self.client.call("get_status", self.name)

    def do_mix(self) -> bool:
        return self.client.call("do_mix", self.name)

    def get_proxy_status(self) -> Dict[str, Dict[str, Any]]:
        return self.client.call("get_proxy_status", self.name)

    def close(self) -> None:
        self.client.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _make_method(method_name: str):
    def call(self, *args):
        return self.client.call(method_name, self.name, *args)

    call.__name__ = method_name
    return call


def _make_client_class(engine: str, methods) -> type:
    ns: Dict[str, Any] = {"ENGINE": engine, "__doc__": f"{engine} client "
                          f"(≙ {engine}_client.hpp, generated from {engine}.idl)."}
    for m in methods:
        ns[m.name] = _make_method(m.name)
    return type(f"{engine.title().replace('_', '')}Client", (ClientBase,), ns)


AnomalyClient = _make_client_class("anomaly", SERVICES["anomaly"])
BanditClient = _make_client_class("bandit", SERVICES["bandit"])
BurstClient = _make_client_class("burst", SERVICES["burst"])
ClassifierClient = _make_client_class("classifier", SERVICES["classifier"])
ClusteringClient = _make_client_class("clustering", SERVICES["clustering"])
GraphClient = _make_client_class("graph", SERVICES["graph"])
NearestNeighborClient = _make_client_class(
    "nearest_neighbor", SERVICES["nearest_neighbor"]
)
RecommenderClient = _make_client_class("recommender", SERVICES["recommender"])
RegressionClient = _make_client_class("regression", SERVICES["regression"])
StatClient = _make_client_class("stat", SERVICES["stat"])
WeightClient = _make_client_class("weight", SERVICES["weight"])

CLIENT_CLASSES = {
    "anomaly": AnomalyClient,
    "bandit": BanditClient,
    "burst": BurstClient,
    "classifier": ClassifierClient,
    "clustering": ClusteringClient,
    "graph": GraphClient,
    "nearest_neighbor": NearestNeighborClient,
    "recommender": RecommenderClient,
    "regression": RegressionClient,
    "stat": StatClient,
    "weight": WeightClient,
}
