"""The port's client library (``jubatus_tpu_torch/client``).

Mirrors ``tests/test_client_blackbox.py`` case for case. The JAX suite
runs against a live deployment named by ``JUBATUS_HOST`` /
``JUBATUS_PORT`` and skips without one; here each case drives the port's
typed client against an in-process port server of its engine on the CPU
(a standalone server: an empty cluster name, as the reference's harness
runs it). Then the two packages across the wire: the port's client
against a JAX server, and the JAX client against a port server, answer
the same session as the JAX client against a JAX server.
"""

from __future__ import annotations

import json
import os
import uuid

import pytest

from jubatus_tpu_torch.client import CLIENT_CLASSES, Datum
from jubatus_tpu_torch.server import EngineServer
from jubatus_tpu_torch.server.args import ServerArgs

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "config")
CONFIGS = {
    "classifier": "classifier/arow.json",
    "regression": "regression/default.json",
    "recommender": "recommender/inverted_index.json",
    "nearest_neighbor": "nearest_neighbor/lsh.json",
    "anomaly": "anomaly/lof.json",
    "stat": "stat/default.json",
    "clustering": "clustering/kmeans.json",
    "graph": "graph/default.json",
}
NAME = ""        # standalone (util.hpp:52-54)
TIMEOUT = 10.0


def _conf(engine):
    with open(os.path.join(CONFIG_DIR, CONFIGS[engine])) as f:
        return json.load(f)


@pytest.fixture()
def serve(tmp_path):
    """serve(engine) → a port client on a fresh port server of that
    engine; both are closed after the test."""
    started = []

    def make(engine):
        srv = EngineServer(engine, _conf(engine), ServerArgs(
            engine=engine, datadir=str(tmp_path), telemetry_interval=0),
            device="cpu")
        port = srv.start(0)
        client = CLIENT_CLASSES[engine]("127.0.0.1", port, NAME,
                                        timeout=TIMEOUT)
        started.append((srv, client))
        return client

    yield make
    for srv, client in started:
        client.close()
        srv.stop()


def test_get_config_is_json(serve):
    client = serve("classifier")
    conf = json.loads(client.get_config())
    assert isinstance(conf, dict)


def test_get_status_shape(serve):
    st = serve("classifier").get_status()
    assert st, "empty status map"
    for node, entries in st.items():
        assert "_" in node  # "<ip>_<port>"
        assert "uptime" in entries


def test_save_returns_path_map(serve):
    client = serve("classifier")
    model_id = f"bb_{uuid.uuid4().hex[:8]}"
    paths = client.save(model_id)
    assert paths and all(model_id in p for p in paths.values())


def test_classifier_train_classify_roundtrip(serve):
    """≙ client_test/classifier_test.cpp:26-66 train/classify round trip."""
    client = serve("classifier")
    lab_a, lab_b = f"a_{uuid.uuid4().hex[:6]}", f"b_{uuid.uuid4().hex[:6]}"
    n = client.train([[lab_a, Datum({"bbx": 1.0})],
                      [lab_b, Datum({"bbx": -1.0})]])
    assert n == 2
    labels = client.get_labels()
    assert lab_a in labels and lab_b in labels
    (res,) = client.classify([Datum({"bbx": 1.0})])
    assert {lab for lab, _ in res} >= {lab_a, lab_b}


def test_regression_train_estimate_roundtrip(serve):
    """≙ client_test/regression_test.cpp train/estimate round trip."""
    client = serve("regression")
    n = client.train([[2.0, Datum({"bbx": 1.0, "bbb": 1.0})],
                      [0.0, Datum({"bbx": -1.0, "bbb": 1.0})]])
    assert n == 2
    (est,) = client.estimate([Datum({"bbx": 1.0, "bbb": 1.0})])
    assert isinstance(est, float)


def test_recommender_row_roundtrip(serve):
    """≙ client_test/recommender_test.cpp update/similar/decode."""
    client = serve("recommender")
    rid = f"bb_{uuid.uuid4().hex[:8]}"
    assert client.update_row(rid, Datum({"bbx": 1.0, "bby": 0.5}))
    assert rid in client.get_all_rows()
    sim = client.similar_row_from_id(rid, 5)
    assert any(r == rid for r, _ in sim)
    decoded = Datum.from_msgpack(client.decode_row(rid))
    assert dict(decoded.num_values)["bbx"] == 1.0
    assert client.clear_row(rid)


def test_nearest_neighbor_row_roundtrip(serve):
    """≙ client_test/nearest_neighbor_test.cpp set/neighbor round trip."""
    client = serve("nearest_neighbor")
    rid = f"bb_{uuid.uuid4().hex[:8]}"
    assert client.set_row(rid, Datum({"bbx": 1.0, "bby": -1.0}))
    assert rid in client.get_all_rows()
    near = client.neighbor_row_from_id(rid, 5)
    assert any(r == rid for r, _ in near)


def test_anomaly_add_score_roundtrip(serve):
    """≙ client_test/anomaly_test.cpp add/calc_score."""
    client = serve("anomaly")
    rid, score = client.add(Datum({"bbx": 0.0, "bby": 0.0}))
    assert rid
    s = client.calc_score(Datum({"bbx": 0.1, "bby": 0.0}))
    assert isinstance(s, float)
    assert rid in client.get_all_rows()


def test_stat_push_aggregates(serve):
    """≙ client_test/stat_test.cpp push/sum/max/min."""
    client = serve("stat")
    key = f"bb_{uuid.uuid4().hex[:8]}"
    for v in (1.0, 2.0, 3.0):
        assert client.push(key, v)
    assert client.sum(key) == 6.0
    assert client.max(key) == 3.0
    assert client.min(key) == 1.0


def test_clustering_push_revision(serve):
    """≙ client_test/clustering_test.cpp push/get_revision."""
    client = serve("clustering")
    before = client.get_revision()
    pts = [[f"bb_{uuid.uuid4().hex[:6]}_{i}", Datum({"bbx": float(i % 3)})]
           for i in range(12)]
    assert client.push(pts)
    assert client.get_revision() >= before


def test_graph_node_edge_roundtrip(serve):
    """≙ client_test/graph_test.cpp node/edge lifecycle."""
    client = serve("graph")
    a = client.create_node()
    b = client.create_node()
    assert client.update_node(a, {"side": "l"})
    assert client.update_node(b, {"side": "r"})
    # edge wire shape: [property map, source, target] (graph.idl:38-42)
    eid = client.create_edge(a, [{"w": "1"}, a, b])
    assert eid is not None  # 0 is a valid first edge id
    edge = client.get_edge(a, eid)
    assert edge[1] == a and edge[2] == b
    node = client.get_node(a)
    assert node  # [properties, in_edges, out_edges]
    assert client.remove_node(b)


# -- across the packages -------------------------------------------------------


def test_client_classes_match_the_jax_package():
    """The same eleven typed clients, each with the JAX client's methods."""
    from jubatus_tpu.client import CLIENT_CLASSES as JCLIENT_CLASSES

    assert set(CLIENT_CLASSES) == set(JCLIENT_CLASSES)
    for engine, cls in CLIENT_CLASSES.items():
        jcls = JCLIENT_CLASSES[engine]
        assert cls.__name__ == jcls.__name__
        assert cls.ENGINE == jcls.ENGINE == engine
        mine = {m for m in vars(cls) if not m.startswith("_")}
        theirs = {m for m in vars(jcls) if not m.startswith("_")}
        assert mine == theirs, engine


def _session(client_cls, datum_cls, port):
    """One classifier and one regression-style session's answers."""
    c = client_cls("127.0.0.1", port, "", timeout=TIMEOUT)
    try:
        rows = [["spam", datum_cls({"subject": "win money now", "n": 1.0})],
                ["ham", datum_cls({"subject": "meeting at noon",
                                   "n": -1.0})]] * 3
        return [c.train(rows), c.get_labels(),
                c.classify([datum_cls({"subject": "win money", "n": 0.5}),
                            datum_cls({"subject": "noon"})]),
                c.set_label("eggs"), c.delete_label("eggs"),
                sorted(json.loads(c.get_config())),
                c.clear(), c.get_labels()]
    finally:
        c.close()


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("port", "jax"), ("jax", "port")])
def test_client_and_server_cross_the_packages(client_pkg, server_pkg,
                                              tmp_path, monkeypatch):
    """A port client against a JAX server and a JAX client against a port
    server answer a classifier session as the JAX client against a JAX
    server does, answer for answer."""
    from jubatus_tpu.client import ClassifierClient as JClassifierClient
    from jubatus_tpu.client import Datum as JDatum
    from jubatus_tpu.server import EngineServer as JEngineServer
    from jubatus_tpu.server.args import ServerArgs as JServerArgs

    from jubatus_tpu_torch.client import ClassifierClient

    monkeypatch.setenv("JUBATUS_TPU_NATIVE_RPC", "0")
    monkeypatch.setenv("JUBATUS_TPU_NATIVE_INGEST", "0")
    conf = _conf("classifier")

    def server(pkg, sub):
        if pkg == "jax":
            return JEngineServer("classifier", conf, args=JServerArgs(
                engine="classifier", datadir=str(tmp_path / sub),
                telemetry_interval=0))
        return EngineServer("classifier", conf, ServerArgs(
            engine="classifier", datadir=str(tmp_path / sub),
            telemetry_interval=0), device="cpu")

    clients = {"jax": (JClassifierClient, JDatum),
               "port": (ClassifierClient, Datum)}
    answers = []
    for cpkg, spkg, sub in (("jax", "jax", "ref"),
                            (client_pkg, server_pkg, "x")):
        srv = server(spkg, sub)
        try:
            answers.append(_session(*clients[cpkg], srv.start(0)))
        finally:
            srv.stop()
    assert answers[1] == answers[0]
    assert answers[0][0] == 6 and answers[0][-1] == {}
