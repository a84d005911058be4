"""The port's engine server (jubatus_tpu_torch.server) on device="cpu",
driven over the wire by the JAX package's NearestNeighborClient and by the
port's own RpcClient — mirrors tests/test_server_e2e.py's nearest_neighbor
round trip, plus lsh and minhash against the JAX package's own server.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import msgpack
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
        EngineServer("clustering", {"method": "kmeans"}, device="cpu")


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
    ("classifier", "classifier/arow.json", "ClassifierClient"),
    ("regression", "regression/default.json", "RegressionClient"),
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
        _terminate(proc)


def _terminate(proc, bound=30):
    """SIGTERM, then require exit within ``bound`` seconds. Past it, SIGABRT
    makes the server print every thread's stack (faulthandler), and the
    test fails with its stderr."""
    proc.terminate()
    try:
        return proc.wait(timeout=bound)
    except subprocess.TimeoutExpired:
        proc.send_signal(signal.SIGABRT)
        try:
            _out, err = proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            _out, err = proc.communicate()
        pytest.fail(f"server did not exit within {bound} s of SIGTERM; "
                    f"stderr:\n{err}")


def _start_main(engine, path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "jubatus_tpu_torch.server", engine,
         "-f", os.path.join(ROOT, "config", path), "-p", "0",
         "-b", "127.0.0.1", "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    if "serving on port" not in line:
        proc.kill()
        pytest.fail(f"server did not start: {line!r} {proc.stderr.read()}")
    return proc, int(line.split("serving on port")[1].split()[0])


def test_server_exits_on_sigterm_with_a_stalled_client_and_an_idle_one():
    """SIGTERM with one idle open connection and one client that pipelined
    requests but reads no replies: a worker is then blocked in sendall on
    a full socket. The server must still exit within the bound, with 0."""
    proc, port = _start_main("classifier", "classifier/nn.json")
    idle = socket.create_connection(("127.0.0.1", port))
    stalled = socket.create_connection(("127.0.0.1", port))
    try:
        with port_client.ClassifierClient("127.0.0.1", port, NAME) as c:
            c.get_status()  # the server answers
        req = b"".join(msgpack.packb([0, i, "get_status", [NAME]])
                       for i in range(20000))
        stalled.sendall(req)
        # the replies (~1 KB each) fill both socket buffers and block a
        # worker in sendall; give the server time to get there
        time.sleep(2.0)
        assert _terminate(proc) == 0
    finally:
        idle.close()
        stalled.close()
        if proc.poll() is None:
            proc.kill()


def test_server_main_refuses_an_unported_engine():
    """An engine the port has not reached (clustering) exits 1 with "not
    yet ported", as the linear classifier did before it was ported."""
    proc = subprocess.run(
        [sys.executable, "-m", "jubatus_tpu_torch.server", "clustering",
         "--config-test", "-f", os.path.join(ROOT, "config", "clustering",
                                             "kmeans.json"),
         "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert "not yet ported" in proc.stderr


# -- the linear classifier and regression (tests/test_server_e2e.py) -----------
LINEAR_CONF = {"method": "AROW",
               "parameter": {"regularization_weight": 1.0},
               "converter": {"string_rules": [{"key": "*", "type": "str",
                                               "sample_weight": "bin",
                                               "global_weight": "bin"}],
                             "num_rules": [{"key": "*", "type": "num"}]}}
REGRESSION_CONF = {"method": "PA",
                   "parameter": {"sensitivity": 0.1,
                                 "regularization_weight": 3.0},
                   "converter": {"num_rules": [{"key": "*", "type": "num"}]}}


def test_linear_classifier_roundtrip_answers_as_the_driver():
    """The JAX package's ClassifierClient against the port's server: the
    e2e round trip, with every answer equal to the port's driver fed the
    same datums (one train call is one coalesced flush: a lone client)."""
    from jubatus_tpu.client import ClassifierClient
    from jubatus_tpu_torch.models.classifier import ClassifierDriver

    srv, port = _serve_engine("classifier", LINEAR_CONF)
    ref = ClassifierDriver(LINEAR_CONF, device="cpu")
    data = [("spam", {"subject": "win money now"}),
            ("ham", {"subject": "meeting at noon"})] * 5
    try:
        with ClassifierClient("127.0.0.1", port, NAME) as c:
            assert c.train([[lab, JDatum(d)] for lab, d in data]) == 10
            ref.train([(lab, Datum(d)) for lab, d in data])
            q = [{"subject": "win money"}, {"x": 1.0}]
            got = c.classify([JDatum(d) for d in q])
            want = ref.classify([Datum(d) for d in q])
            assert [[list(r) for r in row] for row in got] == \
                [[[lab, s] for lab, s in row] for row in want]
            assert max(got[0], key=lambda ls: ls[1])[0] == "spam"
            assert c.get_labels() == {"spam": 5, "ham": 5}
            assert c.set_label("neutral") is True
            assert c.delete_label("neutral") is True
            st = next(iter(c.get_status().values()))
            assert st["driver.method"] == "AROW"
            assert st["microbatch.train.flush_count"] == 1
            assert c.clear() is True
            assert c.get_labels() == {}
    finally:
        srv.stop()


def test_regression_roundtrip_answers_as_the_driver():
    from jubatus_tpu.client import RegressionClient
    from jubatus_tpu_torch.models.regression import RegressionDriver

    srv, port = _serve_engine("regression", REGRESSION_CONF)
    ref = RegressionDriver(REGRESSION_CONF, device="cpu")
    data = [(float(2 * x), {"x": float(x)}) for x in range(1, 30)]
    try:
        with RegressionClient("127.0.0.1", port, NAME) as r:
            assert r.train([[y, JDatum(d)] for y, d in data]) == 29
            ref.train([(y, Datum(d)) for y, d in data])
            (est,) = r.estimate([JDatum({"x": 10.0})])
            assert est == pytest.approx(20.0, rel=0.35)
            assert est == ref.estimate([Datum({"x": 10.0})])[0]
            st = next(iter(r.get_status().values()))
            assert st["type"] == "regression"
            assert st["kernel.online_scan.launches"] == 0  # the CPU: plain
            assert r.clear() is True
            assert r.estimate([JDatum({"x": 10.0})]) == [0.0]
    finally:
        srv.stop()


@pytest.mark.parametrize("engine,conf,label", [
    ("classifier", LINEAR_CONF, lambda i: f"l{i % 3}"),
    ("regression", REGRESSION_CONF, lambda i: float(i % 5)),
])
def test_concurrent_train_calls_are_merged_by_the_coalescer(engine, conf,
                                                            label):
    """8 clients train at once while the first flush is held back: later
    calls queue and merge into fewer flushes; every caller gets its own
    count back and every example lands once."""
    from jubatus_tpu_torch.server.args import ServerArgs

    srv = EngineServer(engine, conf, ServerArgs(engine=engine, thread=8),
                       device="cpu")
    apply_fn = srv.driver.train_hashed
    first = threading.Event()

    def slow_first(*args):
        if not first.is_set():
            first.set()
            time.sleep(0.3)
        return apply_fn(*args)

    srv.driver.train_hashed = slow_first
    port = srv.start(0)
    counts, errors = [], []

    def client(k):
        try:
            with port_client.RpcClient("127.0.0.1", port) as c:
                for j in range(3):
                    batch = [[label(i), Datum({"x": float(i), "k": k})]
                             for i in range(k + 1 + j)]
                    counts.append((len(batch),
                                   c.call("train", NAME, batch)))
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        assert all(sent == got for sent, got in counts) and len(counts) == 24
        stats = srv.coalescers["train"].stats()
        assert stats["item_count"] == sum(sent for sent, _ in counts)
        assert stats["flush_count"] < 24
        assert srv.driver.update_count == stats["item_count"]
    finally:
        srv.stop()


def test_microbatch_max_zero_trains_per_rpc():
    from jubatus_tpu_torch.server.args import ServerArgs, parse_server_args

    srv = EngineServer("classifier", LINEAR_CONF,
                       ServerArgs(engine="classifier", microbatch_max=0),
                       device="cpu")
    port = srv.start(0)
    try:
        with port_client.ClassifierClient("127.0.0.1", port, NAME) as c:
            assert c.train([["a", Datum({"x": 1.0})]]) == 1
            assert c.get_labels() == {"a": 1}
        assert srv.coalescers == {}
    finally:
        srv.stop()
    args = parse_server_args(["classifier", "-f", "x.json",
                              "--microbatch-max", "0"])
    assert args.microbatch_max == 0
    assert parse_server_args(["regression", "-f", "x.json"]).microbatch_max \
        == 8192


@pytest.mark.parametrize("engine,name", [
    ("classifier", n) for n in ("perceptron.json", "pa.json", "pa1.json",
                                "pa2.json", "cw.json", "arow.json",
                                "nherd.json", "default.json",
                                "arow_combinational_feature.json")
] + [("regression", n) for n in ("default.json", "pa.json",
                                 "pa_combinational_feature.json")])
def test_every_linear_config_passes_config_test(engine, name, capsys):
    from jubatus_tpu_torch.server.__main__ import main

    assert main([engine, "--config-test", "-f",
                 os.path.join(ROOT, "config", engine, name),
                 "--device", "cpu"]) == 0
    assert "config ok" in capsys.readouterr().out
