"""The port's engine server (jubatus_tpu_torch.server) on device="cpu",
driven over the wire by the JAX package's NearestNeighborClient and by the
port's own RpcClient — mirrors tests/test_server_e2e.py's nearest_neighbor
round trip, plus lsh and minhash against the JAX package's own server.
"""

from __future__ import annotations

import json
import logging
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
from jubatus_tpu_torch.core.fv.converter import ConverterError
from jubatus_tpu_torch.rpc import client as port_client
from jubatus_tpu_torch.rpc import errors as port_errors
from jubatus_tpu_torch.server import EngineServer

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


#: a converter whose string type is a plugin (``dynamic``) naming a ``.so``
#: that does not exist
PLUGIN_CONVERTER = {
    "string_types": {"p": {"method": "dynamic", "path": "libp.so",
                           "function": "create"}},
    "string_rules": [{"key": "*", "type": "p", "sample_weight": "bin",
                      "global_weight": "bin"}]}


def test_unported_engine_is_refused():
    """Every engine of the JAX package is served now; an unknown engine is
    refused, and a converter plugin that cannot load (here a missing
    ``.so``) is a config error, ConverterError."""
    with pytest.raises(KeyError, match="unknown engine"):
        EngineServer("no_such_engine", {}, device="cpu")
    with pytest.raises(ConverterError, match="not found"):
        EngineServer("clustering", {"method": "kmeans",
                                    "converter": PLUGIN_CONVERTER},
                     device="cpu")
    assert EngineServer("clustering", {"method": "kmeans"},
                        device="cpu").driver.device.type == "cpu"


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


def _start_main(engine, path, env=None):
    proc = subprocess.Popen(
        [sys.executable, "-m", "jubatus_tpu_torch.server", engine,
         "-f", os.path.join(ROOT, "config", path), "-p", "0",
         "-b", "127.0.0.1", "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=None if env is None else dict(os.environ, **env))
    line = proc.stdout.readline()
    if "serving on port" not in line:
        proc.kill()
        pytest.fail(f"server did not start: {line!r} {proc.stderr.read()}")
    return proc, int(line.split("serving on port")[1].split()[0])


@pytest.mark.parametrize("transport", ["python", "native"])
def test_server_exits_on_sigterm_with_a_stalled_client_and_an_idle_one(
        transport):
    """SIGTERM with one idle open connection and one client that pipelined
    requests but reads no replies: a worker (the Python transport) or the
    connection's C++ reader (the native one) is then blocked sending to a
    full socket. The server must still exit within the bound, with 0."""
    proc, port = _start_main("classifier", "classifier/nn.json", env={
        "JUBATUS_TPU_NATIVE_RPC": "1" if transport == "native" else "0"})
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


def test_server_main_refuses_an_unported_engine(tmp_path):
    """Every engine is ported now (config/clustering/kmeans.json passes
    --config-test); a converter plugin that cannot load exits 1 with the
    converter's "not found", as a config error."""
    with open(os.path.join(ROOT, "config", "clustering", "kmeans.json")) as f:
        conf = json.load(f)
    path = tmp_path / "plugin.json"
    path.write_text(json.dumps(dict(conf, converter=PLUGIN_CONVERTER)))
    for config, rc in ((os.path.join(ROOT, "config", "clustering",
                                      "kmeans.json"), 0), (str(path), 1)):
        proc = subprocess.run(
            [sys.executable, "-m", "jubatus_tpu_torch.server", "clustering",
             "--config-test", "-f", config, "--device", "cpu"],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert proc.returncode == rc, proc.stderr
    assert "config error" in proc.stderr and "not found" in proc.stderr


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
            # arow's converter is one the native parser expresses: the
            # call took the raw-wire path
            assert st["microbatch.train_raw.flush_count"] == 1
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
    count back and every example lands once. Both converters are ones the
    native parser expresses, so the calls take the raw-wire path: its
    coalescer (``train_raw``) flushes the classifier's uniform key schema
    through ``train_indexed_schema`` and regression through
    ``train_hashed``."""
    from jubatus_tpu_torch.server.args import ServerArgs

    srv = EngineServer(engine, conf, ServerArgs(engine=engine, thread=8),
                       device="cpu")
    step = "train_indexed_schema" if engine == "classifier" \
        else "train_hashed"
    apply_fn = getattr(srv.driver, step)
    first = threading.Event()

    def slow_first(*args):
        if not first.is_set():
            first.set()
            time.sleep(0.3)
        return apply_fn(*args)

    setattr(srv.driver, step, slow_first)
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
        assert first.is_set()
        stats = srv.coalescers["train_raw"].stats()
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


@pytest.fixture
def own_root_logging():
    """The server's main installs the process's root log handler, a stream
    on this test's captured stderr; the root logger is put back as it was
    afterwards, so that no later test of the process logs into that
    closed stream."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for h in list(root.handlers):
        root.removeHandler(h)
    for h in handlers:
        root.addHandler(h)
    root.setLevel(level)


@pytest.mark.parametrize("engine,name", [
    ("classifier", n) for n in ("perceptron.json", "pa.json", "pa1.json",
                                "pa2.json", "cw.json", "arow.json",
                                "nherd.json", "default.json",
                                "arow_combinational_feature.json")
] + [("regression", n) for n in ("default.json", "pa.json",
                                 "pa_combinational_feature.json")])
def test_every_linear_config_passes_config_test(engine, name, capsys,
                                                own_root_logging):
    from jubatus_tpu_torch.server.__main__ import main

    assert main([engine, "--config-test", "-f",
                 os.path.join(ROOT, "config", engine, name),
                 "--device", "cpu"]) == 0
    assert "config ok" in capsys.readouterr().out


# -- clustering, graph, stat, bandit, burst and weight --------------------------
NEW_ENGINES = ("clustering", "graph", "stat", "bandit", "burst", "weight")


def _engine_conf(engine):
    with open(os.path.join(ROOT, "config", engine, "default.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("engine", NEW_ENGINES)
def test_new_engines_bind_the_jax_wire_names_and_arities(engine):
    """Each engine's methods under the JAX package's IDL names, with its
    arities (the cluster name first), and the built-ins."""
    from jubatus_tpu.framework.idl import SERVICES
    from jubatus_tpu_torch.rpc.server import RpcServer
    from jubatus_tpu_torch.server.service import bind_engine

    rpc = RpcServer()
    bind_engine(rpc, EngineServer(engine, _engine_conf(engine), device="cpu"))
    want = {m.name: 1 + len(m.args) for m in SERVICES[engine]}
    want.update(get_config=1, get_status=1, save=2, load=2, do_mix=1,
                get_epoch=1, drain=2, drain_status=1, rebalance=1,
                migrate_range=5, put_rows=2, get_row_count=1, rollback=2,
                store_restore=2, get_store_status=1, get_metrics=1,
                get_spans=2, get_slow_log=1, get_profile=2,
                profile_device=2, get_timeseries=1, get_alerts=1,
                get_quality=1, get_usage=1, get_tune=1, get_events=3,
                get_incidents=2)
    assert dict(rpc._arity) == want


def _calls(engine):
    """(method, args) of a short session of ``engine``'s traffic, in wire
    shapes: updates, then queries."""
    d = lambda **kv: JDatum(kv).to_msgpack()  # noqa: E731
    q = [[], []]
    if engine == "clustering":
        pts = [[f"p{i}", d(x=float(i % 3) * 10 + (i % 7) * 0.1,
                           y=float(i % 5), s=f"t{i % 2}")] for i in range(24)]
        return [("push", (pts[:12],)), ("get_revision", ()),
                ("push", (pts[12:],)), ("get_revision", ()),
                ("get_k_center", ()), ("get_core_members_light", ()),
                ("get_core_members", ()),
                ("get_nearest_center", (d(x=19.0, y=1.0),)),
                ("get_nearest_members_light", (d(x=1.0),)),
                ("get_nearest_members", (d(x=1.0),))]
    if engine == "graph":
        calls = [("create_node", ())] * 6
        calls += [("update_node", (str(i), {"k": "ab"[i % 2]}))
                  for i in range(6)]
        calls += [("create_edge", ("0", [{"r": "x"}, str(i % 6),
                                         str((i * 5 + 1) % 6)]))
                  for i in range(10)]
        calls += [("create_node_here", ("40",)),
                  ("create_edge_here", (100, [{}, "40", "0"])),
                  ("add_centrality_query", (q,)),
                  ("add_shortest_path_query", (q,)), ("update_index", ()),
                  ("get_centrality", ("1", 0, q)),
                  ("get_centrality", ("40", 0, q)),
                  ("get_shortest_path", (["40", "5", 6, q],)),
                  ("get_node", ("0",)), ("get_edge", ("0", 3)),
                  ("update_edge", ("0", 3, [{"r": "y"}, "3", "4"])),
                  ("remove_edge", ("0", 4)), ("remove_global_node", ("2",)),
                  ("get_node", ("3",)), ("remove_node", ("5",)),
                  ("update_index", ()), ("get_centrality", ("0", 0, q))]
        return calls
    if engine == "stat":
        calls = [("push", (f"k{i % 3}", float(i * 7 % 11) - 2.5))
                 for i in range(300)]
        for k in ("k0", "k1"):
            calls += [("sum", (k,)), ("stddev", (k,)), ("max", (k,)),
                      ("min", (k,)), ("moment", (k, 3, 1.0))]
        return calls + [("entropy", ("k0",))]
    if engine == "bandit":
        calls = [("register_arm", (a,)) for a in "abc"]
        for i in range(40):
            calls += [("select_arm", (f"p{i % 2}",)),
                      ("register_reward", (f"p{i % 2}", "abc"[i % 3],
                                           float(i % 3 == 1)))]
        return calls + [("get_arm_info", ("p0",)), ("reset", ("p1",)),
                        ("get_arm_info", ("p1",)), ("delete_arm", ("c",)),
                        ("get_arm_info", ("p0",))]
    if engine == "burst":
        docs = [[float(i) * 0.7, "storm rising" if 30 <= i < 45 else
                 f"calm {i % 4}"] for i in range(120)]
        return [("add_keyword", (["storm", 2.0, 1.0],)),
                ("add_keyword", (["calm", 1.5, 1.0],)),
                ("add_documents", (docs,)), ("get_result", ("storm",)),
                ("get_result_at", ("storm", 30.0)),
                ("get_all_bursted_results", ()),
                ("get_all_bursted_results_at", (30.0,)),
                ("get_all_keywords", ()), ("remove_keyword", ("calm",)),
                ("get_all_keywords", ())]
    texts = ["a b a", "b c", "c d e", "a e"]
    return [("update", (d(t=texts[i % 4], n=float(i)),)) for i in range(8)] + \
        [("calc_weight", (d(t="a b z"),))]


def _close(got, want, rtol):
    """Equal, floats within ``rtol`` (relative) where ``rtol`` > 0."""
    if isinstance(want, float) and rtol:
        return got == pytest.approx(want, rel=rtol, abs=1e-6)
    if isinstance(want, (list, tuple)):
        return len(got) == len(want) and all(
            _close(g, w, rtol) for g, w in zip(got, want))
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(
            _close(got[k], want[k], rtol) for k in want)
    return got == want


def _answer(client, method, args):
    """("ok", result), or ("error", the error's class) where the call
    fails: graph's update_edge fails in both packages (the binder hands
    the driver's update_edge the wire edge's source and target too)."""
    try:
        return "ok", client.call(method, NAME, *args)
    except Exception as e:  # broad-ok — the error class is the answer
        return "error", type(e).__name__


@pytest.mark.parametrize("engine", NEW_ENGINES)
def test_new_engines_answer_as_the_jax_server(engine):
    """The same session to the port's server and to the JAX package's
    server on the CPU gives the same answers: exactly for the host engines,
    within 1e-5 (relative) for clustering's centres and graph's ranks."""
    from jubatus_tpu_torch.rpc.client import RpcClient

    conf = _engine_conf(engine)
    if engine == "clustering":
        conf["compressor_parameter"]["bucket_size"] = 12
    srv, port = _serve_engine(engine, conf)
    jsrv = JEngineServer(engine, conf)
    jport = jsrv.start(0)
    rtol = 1e-5 if engine in ("clustering", "graph") else 0
    try:
        with RpcClient("127.0.0.1", port) as c, \
                RpcClient("127.0.0.1", jport) as jc:
            for method, args in _calls(engine):
                got = _answer(c, method, args)
                want = _answer(jc, method, args)
                assert _close(got, want, rtol), (method, got, want)
            st = next(iter(c.call("get_status", NAME).values()))
            assert st["type"] == engine and st["driver.device"] == "cpu"
            assert c.call("clear", NAME) is True
    finally:
        srv.stop()
        jsrv.stop()


def _wd(**kv):
    return Datum(kv).to_msgpack()


@pytest.mark.parametrize("engine,update,query,want", [
    ("clustering", ("push", [["p0", _wd(x=1.0)]]), ("get_revision",), 0),
    ("graph", ("create_node",), ("get_node", "0"), [{}, [], []]),
    ("stat", ("push", "k", 2.5), ("sum", "k"), 2.5),
    ("bandit", ("register_arm", "a"), ("get_arm_info", "p"), {"a": [0, 0.0]}),
    ("burst", ("add_keyword", ["fire", 2.0, 1.0]), ("get_all_keywords",),
     [["fire", 2.0, 1.0]]),
    ("weight", ("update", _wd(t="a b a")), ("calc_weight", _wd(t="a b")),
     None),
])
def test_server_main_serves_the_six_new_engines_on_cpu(engine, update, query,
                                                       want):
    """``python -m jubatus_tpu_torch.server <engine> -f
    config/<engine>/default.json --device cpu`` serves: one update and one
    query over the wire with the port's client (weight's answer held
    against the port's driver on the CPU fed the same datum)."""
    proc, port = _start_main(engine, f"{engine}/default.json")
    try:
        with getattr(port_client, engine.title() + "Client")(
                "127.0.0.1", port, NAME) as c:
            assert getattr(c, update[0])(*update[1:]) not in (None, False)
            got = getattr(c, query[0])(*query[1:])
            if engine == "weight":
                from jubatus_tpu_torch.models.weight import WeightDriver

                ref = WeightDriver(_engine_conf(engine), device="cpu")
                ref.update(Datum({"t": "a b a"}))
                want = [[k, v] for k, v in ref.calc_weight(Datum({"t": "a b"}))]
                assert len(want) == 2
            assert got == want
            st = next(iter(c.get_status().values()))
            assert st["type"] == engine and st["driver.device"] == "cpu"
    finally:
        _terminate(proc)
