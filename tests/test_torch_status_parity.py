"""The port server's and proxy's status maps against the JAX package's:
``get_status`` carries the original Jubatus server's process rows (``VIRT``,
``RSS``, ``SHR`` from /proc/self/statm, ``loadavg``, as
tests/test_server_e2e.py::test_builtins_and_save_load asserts of the JAX
server) and no registry gauge copied in unprefixed; for every config under
``config/`` a fresh server of each package has the same key set, digits
normalised, apart from the rows that follow the backend; and the proxies'
``get_proxy_status`` maps have the same key set."""

from __future__ import annotations

import glob
import json
import os
import re

import pytest

from jubatus_tpu.coord.memory import MemoryCoordinator as JMemoryCoordinator
from jubatus_tpu.coord.memory import _Store as JStore
from jubatus_tpu.server import EngineServer as JEngineServer
from jubatus_tpu.server.args import ServerArgs as JServerArgs
from jubatus_tpu.server.proxy import Proxy as JProxy
from jubatus_tpu.server.proxy import ProxyArgs as JProxyArgs
from jubatus_tpu_torch.coord.memory import MemoryCoordinator, _Store
from jubatus_tpu_torch.native.ingest import spec_from_converter_config
from jubatus_tpu_torch.rpc.client import ClassifierClient, RpcClient
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.server import EngineServer
from jubatus_tpu_torch.server.args import ServerArgs
from jubatus_tpu_torch.server.proxy import Proxy, ProxyArgs

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in
                 glob.glob(os.path.join(ROOT, "config", "*", "*.json")))

#: rows that follow the backend: the JAX runtime's compile and cache
#: counters, the port's kernel build counters and launch counts, its
#: device rows and the converter's memo caches
BACKEND_ROWS = re.compile(
    r"^(runtime\.jax_|runtime\.kernel_build_|kernel\.|argv\.device$|"
    r"driver\.device$|fv\.memo)")

#: the top-level rows of the original server's map (server_helper.hpp)
PLAIN_ROWS = {"timestamp", "uptime", "type", "name", "version",
              "update_count", "last_saved", "last_loaded", "rpc_port",
              "VIRT", "RSS", "SHR", "loadavg"}


def _keys(st):
    return {re.sub(r"\d+", "N", k) for k in st if not BACKEND_ROWS.match(k)}


@pytest.fixture(autouse=True)
def _python_transport(monkeypatch):
    # both packages on the Python transport (their native ones bill and
    # count through other paths); the ingest is on in both packages in
    # test_get_status_key_set_with_the_ingest_on
    monkeypatch.setenv("JUBATUS_TPU_NATIVE_RPC", "0")
    monkeypatch.setenv("JUBATUS_TPU_NATIVE_INGEST", "0")


def test_node_status_has_the_process_rows_and_no_bare_gauges():
    conf = {"method": "PA", "parameter": {"regularization_weight": 1.0},
            "converter": {"num_rules": [{"key": "*", "type": "num"}]}}
    srv = EngineServer("classifier", conf, ServerArgs(
        engine="classifier", listen_addr="127.0.0.1",
        telemetry_interval=0), device="cpu")
    srv.trace.gauge("probe.bare_gauge", 1.0)
    port = srv.start(0)
    try:
        with ClassifierClient("127.0.0.1", port, "") as c:
            c.train([["a", Datum({"x": 1.0})], ["b", Datum({"x": -1.0})]])
            (node_status,) = c.get_status().values()
        assert node_status["type"] == "classifier"
        assert node_status["update_count"] >= 2
        assert "RSS" in node_status
        page = os.sysconf("SC_PAGE_SIZE")
        for row in ("VIRT", "RSS", "SHR"):
            assert node_status[row] > 0 and node_status[row] % page == 0
        assert node_status["VIRT"] >= node_status["RSS"]
        assert node_status["loadavg"] >= 0.0
        assert not {k for k in node_status if "." not in k} - PLAIN_ROWS
        assert "probe.bare_gauge" not in node_status
        (snap,) = srv.get_metrics("").values()
        assert snap["gauges"]["probe.bare_gauge"] == 1.0
    finally:
        srv.stop()


@pytest.mark.parametrize("path", CONFIGS)
def test_get_status_key_set_equals_the_jax_server(path):
    engine = path.split(os.sep)[1]
    with open(os.path.join(ROOT, path)) as f:
        conf = json.load(f)
    port_srv = EngineServer(engine, conf, ServerArgs(
        engine=engine, configpath=path, listen_addr="127.0.0.1",
        telemetry_interval=0), device="cpu")
    jax_srv = JEngineServer(engine, conf, args=JServerArgs(
        engine=engine, configpath=path, listen_addr="127.0.0.1",
        telemetry_interval=0))
    try:
        port_srv.start(0)
        jax_srv.start(0)
        (port_st,) = port_srv.get_status("").values()
        (jax_st,) = jax_srv.get_status("").values()
    finally:
        port_srv.stop()
        jax_srv.stop()
    assert _keys(port_st) == _keys(jax_st)
    assert {"VIRT", "RSS", "SHR", "loadavg", "argv.auto_tune",
            "argv.tune_interval_floor", "argv.tune_interval_ceiling",
            "argv.legacy_wire", "argv.modern_wire"} <= set(port_st)


#: the linear engines' shipped configs whose converter the native parser
#: expresses: their servers register the raw-wire path by default
RAW_CONFIGS = [p for p in CONFIGS
               if p.split(os.sep)[1] in ("classifier", "regression")
               and spec_from_converter_config(json.load(open(
                   os.path.join(ROOT, p))).get("converter")) is not None]


@pytest.mark.parametrize("path", RAW_CONFIGS)
def test_get_status_key_set_with_the_ingest_on(path, monkeypatch):
    """With the native ingest on in both packages, a server of each has
    the same key set after the same train call, the ``ingest.*`` and
    ``microbatch.train_raw.*`` rows in both wherever the engine's driver
    takes hashed batches."""
    monkeypatch.delenv("JUBATUS_TPU_NATIVE_INGEST")
    engine = path.split(os.sep)[1]
    with open(os.path.join(ROOT, path)) as f:
        conf = json.load(f)
    port_srv = EngineServer(engine, conf, ServerArgs(
        engine=engine, configpath=path, listen_addr="127.0.0.1",
        telemetry_interval=0), device="cpu")
    jax_srv = JEngineServer(engine, conf, args=JServerArgs(
        engine=engine, configpath=path, listen_addr="127.0.0.1",
        telemetry_interval=0))
    label = "a" if engine == "classifier" else 1.0
    try:
        for srv in (port_srv, jax_srv):
            port = srv.start(0)
            with RpcClient("127.0.0.1", port) as c:
                assert c.call("train", "", [[label, Datum(
                    {"x": 1.0, "s": "w"}).to_msgpack()]]) == 1
        (port_st,) = port_srv.get_status("").values()
        (jax_st,) = jax_srv.get_status("").values()
    finally:
        port_srv.stop()
        jax_srv.stop()
    assert _keys(port_st) == _keys(jax_st)
    raw = hasattr(port_srv.driver, "train_hashed")
    assert ("ingest.schema_flushes" in port_st) == raw
    assert ("microbatch.train_raw.item_count" in port_st) == raw
    if raw:
        assert port_st["microbatch.train_raw.item_count"] == \
            jax_st["microbatch.train_raw.item_count"] == 1


@pytest.mark.parametrize("engine", ["classifier", "nearest_neighbor"])
def test_proxy_status_key_set_equals_the_jax_proxy(engine):
    port_proxy = Proxy(ProxyArgs(engine=engine, listen_addr="127.0.0.1",
                                 telemetry_interval=0),
                       coord=MemoryCoordinator(_Store()))
    jax_proxy = JProxy(JProxyArgs(engine=engine, listen_addr="127.0.0.1",
                                  telemetry_interval=0),
                       coord=JMemoryCoordinator(JStore()))
    try:
        port_proxy.start(0)
        jax_proxy.start(0)
        (port_st,) = port_proxy.get_proxy_status("").values()
        (jax_st,) = jax_proxy.get_proxy_status("").values()
    finally:
        port_proxy.stop()
        jax_proxy.stop()
    assert port_st["argv.daemon"] is False
    assert _keys(port_st) == _keys(jax_st)
