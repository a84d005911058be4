"""The port's engine server (jubatus_tpu_torch.server) on device="cpu",
driven over the wire by the JAX package's NearestNeighborClient and by the
port's own RpcClient — mirrors tests/test_server_e2e.py's nearest_neighbor
round trip, plus lsh and minhash against the JAX package's own server.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from jubatus_tpu.client import Datum as JDatum
from jubatus_tpu.client import NearestNeighborClient
from jubatus_tpu.rpc.errors import RpcMethodNotFound, RpcTypeError
from jubatus_tpu.server import EngineServer as JEngineServer
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.rpc import client as port_client
from jubatus_tpu_torch.rpc import errors as port_errors
from jubatus_tpu_torch.server import EngineServer
from jubatus_tpu_torch.server.factory import NotYetPorted

NAME = "e2e"
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _serve(conf):
    srv = EngineServer("nearest_neighbor", conf, device="cpu")
    port = srv.start(0)
    return srv, port


def _nn_conf(method, hash_num=64):
    return {"method": method, "parameter": {"hash_num": hash_num},
            "converter": {"num_rules": [{"key": "*", "type": "num"}]}}


def test_nearest_neighbor_roundtrip():
    srv, port = _serve(_nn_conf("euclid_lsh", 128))
    try:
        with NearestNeighborClient("127.0.0.1", port, NAME) as nn:
            nn.set_row("p1", JDatum({"x": 0.0, "y": 0.0}))
            nn.set_row("p2", JDatum({"x": 1.0, "y": 0.0}))
            nn.set_row("p3", JDatum({"x": 10.0, "y": 10.0}))
            got = nn.neighbor_row_from_datum(JDatum({"x": 0.1, "y": 0.0}), 2)
            assert got[0][0] == "p1"
            assert {g[0] for g in got} == {"p1", "p2"}
    finally:
        srv.stop()


@pytest.mark.parametrize("method", ["lsh", "minhash"])
def test_hash_methods_answer_as_the_jax_server(method):
    """The same calls to the port's server and to the JAX package's server
    give the same answers (distances exact; ids up to ties)."""
    conf = {"method": method, "parameter": {"hash_num": 64},
            "converter": {"string_rules": [{"key": "*", "type": "str",
                                            "sample_weight": "bin",
                                            "global_weight": "bin"}],
                          "num_rules": [{"key": "*", "type": "num"}]}}
    srv, port = _serve(conf)
    jsrv = JEngineServer("nearest_neighbor", conf)
    jport = jsrv.start(0)
    try:
        with NearestNeighborClient("127.0.0.1", port, NAME) as nn, \
                NearestNeighborClient("127.0.0.1", jport, NAME) as jnn:
            for i in range(60):
                d = JDatum({"a": float(i % 7), "b": f"s{i % 5}",
                            "c": float((i * 37) % 11) - 5.0})
                assert nn.set_row(f"r{i}", d) is True
                assert jnn.set_row(f"r{i}", d) is True
            q = JDatum({"a": 3.0, "b": "s2", "c": 1.0})
            for call, arg in (("neighbor_row_from_datum", q),
                              ("similar_row_from_datum", q),
                              ("neighbor_row_from_id", "r12"),
                              ("similar_row_from_id", "r12")):
                got = getattr(nn, call)(arg, 6)
                want = getattr(jnn, call)(arg, 6)
                assert [g[1] for g in got] == [w[1] for w in want]
                edge = want[-1][1]
                assert {g[0] for g in got if g[1] != edge} == \
                    {w[0] for w in want if w[1] != edge}
            assert sorted(nn.get_all_rows()) == sorted(jnn.get_all_rows())
            st = next(iter(nn.get_status().values()))
            assert st["type"] == "nearest_neighbor"
            assert st["driver.num_rows"] == 60
            assert st["driver.device"] == "cpu"
            assert json.loads(nn.get_config()) == conf
            assert nn.clear() is True
            assert nn.get_all_rows() == []
    finally:
        srv.stop()
        jsrv.stop()


def test_wire_errors_match_msgpack_rpc_codes():
    srv, port = _serve(_nn_conf("lsh"))
    try:
        with NearestNeighborClient("127.0.0.1", port, NAME) as nn:
            with pytest.raises(RpcMethodNotFound):
                nn.client.call("no_such_method", NAME)
            with pytest.raises(RpcTypeError):
                nn.client.call("set_row", NAME, "only-two-args")
            # a failed call leaves the connection usable
            assert nn.get_all_rows() == []
    finally:
        srv.stop()


def test_port_client_round_trips_and_errors():
    srv, port = _serve(_nn_conf("minhash"))
    try:
        with port_client.NearestNeighborClient("127.0.0.1", port, NAME) as c:
            for i in range(20):
                assert c.set_row(f"r{i}", Datum({"x": float(i), "y": 1.0}))
            got = c.neighbor_row_from_id("r4", 3)
            assert got[0] == ["r4", 0.0]
            with pytest.raises(port_errors.RpcMethodNotFound):
                c.client.call("nope", NAME)
            with pytest.raises(port_errors.RpcTypeError):
                c.client.call("get_all_rows")
            assert len(c.get_all_rows()) == 20
    finally:
        srv.stop()


def test_unported_engine_is_refused():
    with pytest.raises(NotYetPorted):
        EngineServer("classifier", {"method": "AROW"}, device="cpu")


def test_server_main_config_test_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "jubatus_tpu_torch.server", "nearest_neighbor",
         "--config-test", "-f", os.path.join(ROOT, "config",
                                             "nearest_neighbor", "lsh.json"),
         "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "config ok" in proc.stdout


def _serve_engine(engine, conf):
    srv = EngineServer(engine, conf, device="cpu")
    return srv, srv.start(0)


def test_recommender_roundtrip_answers_as_the_driver():
    from jubatus_tpu.client import RecommenderClient
    from jubatus_tpu_torch.models.recommender import RecommenderDriver

    conf = {"method": "lsh", "parameter": {"hash_num": 64},
            "converter": {"num_rules": [{"key": "*", "type": "num"}],
                          "string_rules": [{"key": "*", "type": "str",
                                            "sample_weight": "bin",
                                            "global_weight": "bin"}]}}
    srv, port = _serve_engine("recommender", conf)
    ref = RecommenderDriver(conf, device="cpu")
    try:
        with RecommenderClient("127.0.0.1", port, NAME) as c:
            for i in range(30):
                d = {"a": float(i % 5), "b": f"s{i % 4}", "c": float(i % 3)}
                assert c.update_row(f"u{i}", JDatum(d)) is True
                ref.update_row(f"u{i}", Datum(d))
            q = {"a": 2.0, "b": "s1"}
            got = c.similar_row_from_datum(JDatum(q), 5)
            want = ref.similar_row_from_datum(Datum(q), 5)
            assert [g[1] for g in got] == [w[1] for w in want]
            comp = c.complete_row_from_id("u3")
            assert [list(kv) for kv in comp[1]] == \
                [list(kv) for kv in ref.complete_row_from_id("u3").num_values]
            dec = c.decode_row("u7")
            assert dict((k, v) for k, v in dec[1]) == {"a": 2.0, "c": 1.0}
            assert c.calc_l2norm(JDatum({"a": 3.0, "c": 4.0})) == 5.0
            assert c.calc_similarity(JDatum({"a": 1.0}),
                                     JDatum({"a": 2.0})) == pytest.approx(1.0)
            assert c.clear_row("u0") is True
            assert len(c.get_all_rows()) == 29
            st = next(iter(c.get_status().values()))
            assert st["type"] == "recommender"
            assert st["driver.device"] == "cpu"
    finally:
        srv.stop()


def test_anomaly_roundtrip_answers_as_the_driver():
    from jubatus_tpu.client import AnomalyClient
    from jubatus_tpu_torch.models.anomaly import AnomalyDriver

    conf = {"method": "lof", "converter": {"num_rules": [{"key": "*",
                                                          "type": "num"}]},
            "parameter": {"nearest_neighbor_num": 4,
                          "reverse_nearest_neighbor_num": 12,
                          "method": "minhash", "parameter": {"hash_num": 64}}}
    srv, port = _serve_engine("anomaly", conf)
    ref = AnomalyDriver(conf, device="cpu")
    try:
        with AnomalyClient("127.0.0.1", port, NAME) as c:
            for i in range(25):
                d = {"x": float(i % 6), "y": float((i * 7) % 5)}
                rid, score = c.add(JDatum(d))
                want = ref.add(Datum(d))
                assert (rid, score) == want
            assert c.calc_score(JDatum({"x": 40.0})) == \
                ref.calc_score(Datum({"x": 40.0}))
            assert c.update("3", JDatum({"x": 1.0})) == \
                ref.update("3", Datum({"x": 1.0}))
            assert c.overwrite("z", JDatum({"y": 2.0})) == \
                ref.overwrite("z", Datum({"y": 2.0}))
            assert c.clear_row("z") is True
            assert sorted(c.get_all_rows()) == sorted(ref.get_all_rows()[:-1])
            assert c.clear() is True and c.get_all_rows() == []
    finally:
        srv.stop()


def test_classifier_roundtrip_with_the_port_client():
    conf = {"method": "NN", "converter": {"num_rules": [{"key": "*",
                                                         "type": "num"}]},
            "parameter": {"method": "lsh", "parameter": {"hash_num": 64},
                          "nearest_neighbor_num": 3, "local_sensitivity": 1}}
    srv, port = _serve_engine("classifier", conf)
    try:
        with port_client.ClassifierClient("127.0.0.1", port, NAME) as c:
            data = [["p", Datum({"x": 1.0, "y": 1.0})],
                    ["p", Datum({"x": 0.9, "y": 1.2})],
                    ["n", Datum({"x": -1.0, "y": -1.0})]]
            assert c.train(data) == 3
            (res,) = c.classify([Datum({"x": 1.0, "y": 0.9})])
            assert [r[0] for r in res] == ["n", "p"]
            assert max(res, key=lambda r: r[1])[0] == "p"
            assert c.get_labels() == {"p": 2, "n": 1}
            assert c.set_label("q") is True
            assert c.delete_label("n") is True
            assert c.get_labels() == {"p": 2, "q": 0}
            assert c.clear() is True and c.get_labels() == {}
    finally:
        srv.stop()


@pytest.mark.parametrize("engine,path,client", [
    ("recommender", "recommender/default.json", "RecommenderClient"),
    ("anomaly", "anomaly/lof_inverted_index_euclid.json", "AnomalyClient"),
    ("classifier", "classifier/nn.json", "ClassifierClient"),
])
def test_server_main_serves_new_engines_on_cpu(engine, path, client):
    """``python -m jubatus_tpu_torch.server <engine> -f <config> --device
    cpu`` serves: it prints its port and answers over the wire."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "jubatus_tpu_torch.server", engine,
         "-f", os.path.join(ROOT, "config", path), "-p", "0",
         "-b", "127.0.0.1", "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "serving on port" in line, proc.stderr.read()
        port = int(line.split("serving on port")[1].split()[0])
        with getattr(port_client, client)("127.0.0.1", port, NAME) as c:
            st = next(iter(c.get_status().values()))
            assert st["type"] == engine and st["driver.device"] == "cpu"
            assert c.clear() is True
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_server_main_refuses_a_linear_classifier():
    proc = subprocess.run(
        [sys.executable, "-m", "jubatus_tpu_torch.server", "classifier",
         "--config-test", "-f", os.path.join(ROOT, "config", "classifier",
                                             "arow.json"),
         "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert "not yet ported" in proc.stderr
