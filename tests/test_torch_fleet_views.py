"""The port proxy's observability planes and forensics RPCs
(jubatus_tpu_torch/server/proxy.py), on port servers on the CPU,
mirroring tests/test_metrics_plane.py (a proxied call shares one trace id,
a broadcast too), tests/test_trace_forensics.py (one trace through a proxy
and two backends assembles into one tree with the per-backend client-call
hop; get_slow_log through the proxy), tests/test_model_health.py (the
proxy folds get_timeseries / get_alerts), tests/test_event_plane.py (the
proxy folds get_events / get_incidents) and tests/test_quality.py (the
proxy folds get_quality, on both transports); then the port's own: the
client-call span on both forward paths (the decoded one and the raw
relay), the two paths billing the same usage row, the plane rows of
get_proxy_status, /metrics and /healthz on --metrics-port, the SLO and
incident planes at the proxy hop, the flag set against the JAX proxy's,
and a port proxy in front of one JAX member and one port member."""

from __future__ import annotations

import argparse
import json
import time
import urllib.request

import numpy as np
import pytest

from jubatus_tpu_torch.cmd.jubactl import assemble_trace
from jubatus_tpu_torch.coord.memory import MemoryCoordinator, _Store
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.rpc import principal as principals
from jubatus_tpu_torch.rpc.client import ClassifierClient, RpcClient
from jubatus_tpu_torch.server import EngineServer
from jubatus_tpu_torch.server.args import ServerArgs
from jubatus_tpu_torch.server.proxy import Proxy, ProxyArgs
from jubatus_tpu_torch.utils import tracing
from jubatus_tpu_torch.utils import usage as usage_mod
from jubatus_tpu_torch.utils.quality import merge_quality

CONF = {
    "method": "PA",
    "parameter": {"regularization_weight": 1.0},
    "converter": {"num_rules": [{"key": "*", "type": "num"}]},
}


def _server(store, name, tmp_path=None, **flags):
    # the stack sampler off unless a test reads it: it would only load the
    # host the other test files share
    flags.setdefault("profile_hz", 0)
    srv = EngineServer("classifier", CONF, ServerArgs(
        engine="classifier", coordinator="(shared)", name=name,
        listen_addr="127.0.0.1", interval_sec=1e9, interval_count=1 << 30,
        datadir=str(tmp_path) if tmp_path is not None else "/tmp",
        **flags), device="cpu", coord=MemoryCoordinator(store))
    srv.start(0)
    return srv


def _proxy(store, **flags):
    flags.setdefault("profile_hz", 0)
    p = Proxy(ProxyArgs(engine="classifier", listen_addr="127.0.0.1",
                        **flags), coord=MemoryCoordinator(store))
    p.start(0)
    return p


@pytest.fixture()
def python_transport(monkeypatch):
    """Servers and proxies made after it serve on the Python transport:
    the tests that count the proxy's Python relay with the ``relayed`` spy
    ask for it first, since the C++ relay of the native transport takes
    random-routed calls from the refresher's first tick on, and they never
    reach ``call_raw`` then."""
    monkeypatch.setenv("JUBATUS_TPU_NATIVE_RPC", "0")


@pytest.fixture()
def relayed(monkeypatch):
    """The methods the proxy's zero-decode relay forwarded: each relay is
    one ``RpcClient.call_raw`` (the proxy's ``relay_count`` counts only
    the requests a C++ relay served, none on the Python transport)."""
    calls = []
    real = RpcClient.call_raw

    def spy(self, method, raw_params):
        calls.append(method)
        return real(self, method, raw_params)

    monkeypatch.setattr(RpcClient, "call_raw", spy)
    return calls


@pytest.fixture()
def one_node_cluster():
    store = _Store()
    srv = _server(store, "tr1")
    proxy = _proxy(store)
    yield srv, proxy
    proxy.stop()
    srv.stop()


@pytest.fixture()
def proxy_two_backends(tmp_path):
    store = _Store()
    servers = [_server(store, "fx", tmp_path, telemetry_interval=0)
               for _ in range(2)]
    proxy = _proxy(store, telemetry_interval=0)
    yield servers, proxy
    proxy.stop()
    for s in servers:
        s.stop()


def _node(x) -> str:
    return f"127.0.0.1_{x.args.rpc_port}"


def _tree_names(root):
    names = []

    def walk(n):
        names.append(n["name"])
        for c in n["children"]:
            walk(c)

    walk(root)
    return names


def _depth(node, d=1):
    return max([_depth(c, d + 1) for c in node["children"]] or [d])


def _spans(per_node):
    out = []
    for node, recs in per_node.items():
        for rec in recs:
            rec = dict(rec)
            rec.setdefault("node", node)
            out.append(rec)
    return out


# -- tests/test_metrics_plane.py ---------------------------------------------

def test_proxied_call_shares_one_trace_id(python_transport,
                                           one_node_cluster, relayed):
    """A proxied call yields ONE trace id across the proxy's and the
    backend's status maps, on the decoded path and on the raw relay."""
    srv, proxy = one_node_cluster
    with ClassifierClient("127.0.0.1", proxy.args.rpc_port, "tr1") as c:
        c.train([["a", Datum({"x": 1.0})], ["b", Datum({"x": -1.0})]])
        c.classify([Datum({"x": 1.0})])
    pst = proxy.rpc.trace.trace_status()
    bst = srv.rpc.trace.trace_status()
    key = "trace.rpc.classify.last_trace_id"
    assert key in pst and key in bst
    assert pst[key] == bst[key]
    tkey = "trace.rpc.train.last_trace_id"
    assert pst[tkey] == bst[tkey]
    assert relayed == ["train", "classify"]  # both took the raw relay


def test_proxy_fanout_broadcast_shares_trace(one_node_cluster):
    srv, proxy = one_node_cluster
    with ClassifierClient("127.0.0.1", proxy.args.rpc_port, "tr1") as c:
        assert c.get_status()
    key = "trace.rpc.get_status.last_trace_id"
    assert proxy.rpc.trace.trace_status()[key] == \
        srv.rpc.trace.trace_status()[key]


# -- tests/test_trace_forensics.py ---------------------------------------------

def test_cross_node_span_assembly(proxy_two_backends):
    """ONE trace id through the proxy and 2 backends assembles into a
    single tree with >= 3 hops (proxy dispatch -> per-backend client
    calls -> backend dispatches)."""
    servers, proxy = proxy_two_backends
    ctx = tracing.new_root()
    with tracing.use_trace(ctx):
        with RpcClient("127.0.0.1", proxy.args.rpc_port) as c:
            assert c.call("get_status", "fx")
    with RpcClient("127.0.0.1", proxy.args.rpc_port) as c:
        spans_map = c.call("get_spans", "fx", ctx.trace_id)
    assert len(spans_map) == 3, sorted(spans_map)  # proxy + 2 backends
    assert all(spans_map.values())
    spans = _spans(spans_map)
    assert {s["trace_id"] for s in spans} == {ctx.trace_id}
    roots = assemble_trace(spans)
    assert len(roots) == 1, [r["name"] for r in roots]
    root = roots[0]
    assert root["name"] == "rpc.get_status"
    assert _depth(root) >= 3, "proxy -> client-call -> backend hops"
    assert "rpc.client.get_status" in _tree_names(root)
    backend_nodes = {s["node"] for s in spans
                     if s["name"] == "rpc.get_status"
                     and s["node"] != _node(proxy)}
    assert backend_nodes == {_node(s) for s in servers}
    assert root["node"] == _node(proxy)


def test_get_slow_log_rpc_through_proxy(proxy_two_backends):
    servers, proxy = proxy_two_backends
    for s in servers:
        s.rpc.trace.slowlog.configure(min_count=1, quantile=0.5)
    with ClassifierClient("127.0.0.1", proxy.args.rpc_port, "fx") as c:
        for _ in range(20):
            c.train([["a", Datum({"x": 1.0})]])
    with RpcClient("127.0.0.1", proxy.args.rpc_port) as rc:
        out = rc.call("get_slow_log", "fx")
    # the proxy's own node key is present even if its ring is empty; at
    # least one backend captured something
    assert len(out) == 3, sorted(out)
    captured = [r for recs in out.values() for r in recs]
    assert captured
    assert all("method" in r and "duration_ms" in r and "trace_id" in r
               for r in captured)


# -- the client-call hop on both forward paths -----------------------------------

def test_client_records_a_hop_span_on_both_paths(python_transport,
                                                  proxy_two_backends,
                                                  relayed):
    """The proxy's backend client records ``rpc.client.<method>`` under
    the child id it ships, on the decoded path (a broadcast) and on the
    zero-decode relay (a random-routed read): each trace's tree runs
    proxy dispatch -> client call -> backend dispatch."""
    servers, proxy = proxy_two_backends
    with ClassifierClient("127.0.0.1", proxy.args.rpc_port, "fx") as c:
        c.train([["a", Datum({"x": 1.0})], ["b", Datum({"x": -1.0})]])
    before = len(relayed)
    for method, args in (("get_labels", ("fx",)),       # raw relay
                         ("get_status", ("fx",))):      # decoded broadcast
        ctx = tracing.new_root()
        with tracing.use_trace(ctx), \
                RpcClient("127.0.0.1", proxy.args.rpc_port) as c:
            assert isinstance(c.call(method, *args), dict)
        own = proxy.get_proxy_spans("fx", ctx.trace_id)[_node(proxy)]
        assert f"rpc.client.{method}" in {r["name"] for r in own}
        with RpcClient("127.0.0.1", proxy.args.rpc_port) as c:
            roots = assemble_trace(_spans(c.call("get_spans", "fx",
                                                 ctx.trace_id)))
        assert len(roots) == 1 and _depth(roots[0]) == 3, method
        hop = next(n for n in roots[0]["children"]
                   if n["name"] == f"rpc.client.{method}")
        assert hop["node"] == _node(proxy)
        assert {k["name"] for k in hop["children"]} == {f"rpc.{method}"}
    assert relayed[before:] == ["get_labels"]


def test_client_hop_span_needs_a_trace(one_node_cluster):
    """An untraced call records no client span; a traced one records one
    per attempt on ``call`` and on ``call_raw`` alike."""
    import msgpack

    srv, _proxy = one_node_cluster
    reg = tracing.Registry()
    with RpcClient("127.0.0.1", srv.args.rpc_port, registry=reg) as c:
        c.call("get_labels", "tr1")
        c.call_raw("get_labels", msgpack.packb(["tr1"]))
        assert reg.recent_spans() == []
        ctx = tracing.new_root()
        with tracing.use_trace(ctx):
            c.call("get_labels", "tr1")
            c.call_raw("get_labels", msgpack.packb(["tr1"]))
    recs = reg.get_spans(ctx.trace_id)
    assert [r["name"] for r in recs] == ["rpc.client.get_labels"] * 2
    assert all(r["parent_id"] == ctx.span_id for r in recs)
    assert len({r["span_id"] for r in recs}) == 2


# -- usage: the relay and the decoded path bill alike ----------------------------

def test_relayed_and_decoded_forwards_bill_the_same_row(python_transport,
                                                       one_node_cluster,
                                                       relayed):
    """One tenant's classify through the zero-decode relay and another's
    (a same-length name) through the decoded path: the proxy's ledger
    bills each tenant one request with the same bytes in and out, and
    CPU-seconds of its own; both leave the dispatch span and the
    client-call hop in the trace."""
    srv, proxy = one_node_cluster
    with ClassifierClient("127.0.0.1", proxy.args.rpc_port, "tr1") as c:
        c.train([["a", Datum({"x": 1.0})], ["b", Datum({"x": -1.0})]])
    raw = proxy.rpc._raw_methods
    traces = {}
    for tenant, relay in (("tr", True), ("td", False)):
        saved = raw.pop("classify") if not relay else None
        before = len(relayed)
        try:
            ctx = tracing.new_root()
            with principals.use(tenant), tracing.use_trace(ctx), \
                    RpcClient("127.0.0.1", proxy.args.rpc_port) as c:
                c.call("classify", "tr1", [Datum({"x": 0.5})])
        finally:
            if saved is not None:
                raw["classify"] = saved
        assert len(relayed) - before == (1 if relay else 0)
        traces[tenant] = {r["name"] for r in proxy.rpc.trace.get_spans(
            ctx.trace_id)}
    table = proxy.usage.snapshot()["table"]
    exact = [usage_mod.FIELDS.index(f) for f in
             ("requests", "errors", "retries", "bytes_in", "bytes_out")]
    rel, dec = table["tr"]["classify"], table["td"]["classify"]
    assert [rel[i] for i in exact] == [dec[i] for i in exact]
    assert rel[usage_mod.FIELDS.index("requests")] == 1
    assert rel[usage_mod.FIELDS.index("bytes_in")] > 0
    assert rel[usage_mod.FIELDS.index("bytes_out")] > 0
    cpu = usage_mod.FIELDS.index("cpu_seconds")
    assert rel[cpu] > 0.0 and dec[cpu] > 0.0
    assert traces["tr"] == traces["td"] == {"rpc.classify",
                                            "rpc.client.classify"}


# -- tests/test_model_health.py, tests/test_event_plane.py ---------------------

def test_proxy_folds_timeseries_and_alerts():
    """get_timeseries / get_alerts against a proxy return backend AND
    proxy entries in one call (broadcast + fold-own)."""
    store = _Store()
    srv = _server(store, "pf", telemetry_interval=0,
                  slo=["error_rate:*:0.01"])
    proxy = _proxy(store, telemetry_interval=0,
                   slo=["latency:rpc.classify:p99:100"])
    try:
        srv._model_health_tick()
        proxy._model_health_tick()
        time.sleep(0.02)
        srv._model_health_tick()
        proxy._model_health_tick()
        srv.slo.evaluate()
        proxy.slo.evaluate()
        with RpcClient("127.0.0.1", proxy.args.rpc_port) as c:
            ts = c.call("get_timeseries", "pf")
            al = c.call("get_alerts", "pf")
        assert len(ts) == 2 and len(al) == 2  # backend + proxy entries
        assert all("points" in v for v in ts.values())
        assert len(ts[_node(proxy)]["points"]) == 2
        slo_names = {s["name"] for doc in al.values()
                     for s in doc.get("slos", [])}
        assert {"errors.*", "rpc.classify.p99"} <= slo_names
    finally:
        proxy.stop()
        srv.stop()


def test_proxy_folds_events_and_incidents(tmp_path):
    """One get_events / get_incidents against the proxy returns backend
    AND proxy views (broadcast + own fold); the get_proxy_* twins answer
    for the proxy alone."""
    store = _Store()
    servers = [_server(store, "evp", tmp_path, telemetry_interval=0)
               for _ in range(2)]
    proxy = _proxy(store, telemetry_interval=0)
    pport = proxy.args.rpc_port
    try:
        for i, s in enumerate(servers):
            s.rpc.trace.events.emit("t", f"backend{i}")
        proxy.rpc.trace.events.emit("t", "proxyown")
        with RpcClient("127.0.0.1", pport) as c:
            doc = c.call("get_events", "evp", 0, "")
        assert len(doc) == 3  # 2 backends + the proxy's own view
        all_types = {r["type"] for d in doc.values()
                     for r in (d.get("events") or [])}
        assert {"backend0", "backend1", "proxyown"} <= all_types
        own_events = doc[_node(proxy)]["events"]
        assert any(r["type"] == "proxyown" and r["node"] == _node(proxy)
                   for r in own_events)
        with RpcClient("127.0.0.1", pport) as c:
            inc = c.call("get_incidents", "evp", "")
        assert len(inc) == 3
        assert all("incidents" in d for d in inc.values())
        with RpcClient("127.0.0.1", pport) as c:
            own = c.call("get_proxy_events", "evp", 0, "")
            assert len(own) == 1
            (d,) = own.values()
            assert any(r["type"] == "proxyown" for r in d["events"])
            assert len(c.call("get_proxy_incidents", "evp", "")) == 1
    finally:
        proxy.stop()
        for s in servers:
            s.stop()


# -- tests/test_quality.py ------------------------------------------------------

@pytest.mark.parametrize("native", [False, True])
def test_get_quality_rpc_and_proxy_fold(monkeypatch, native):
    """get_quality is served by the member and folded through the proxy:
    the proxy's own (empty) doc folds away, the backend doc survives. On
    both transports (get_quality is a broadcast: the C++ relay never
    takes it)."""
    monkeypatch.setenv("JUBATUS_TPU_NATIVE_RPC", "1" if native else "0")
    store = _Store()
    srv = _server(store, "ql", telemetry_interval=0, quality_sample=1.0,
                  quality_window=1.0, quality_ref_windows=1)
    proxy = _proxy(store, telemetry_interval=0)
    try:
        rng = np.random.default_rng(9)
        q = srv.quality
        base = time.time()
        q.tick(now=base)
        q.record_named(["ch%d" % i for i in range(100)],
                       rng.uniform(size=100))
        q.tick(now=base + 2.0)
        q.record_named(["ch%d" % i for i in range(100)],
                       rng.uniform(size=100) + 0.9)
        q.record_classified("a", [("a", 1.0), ("b", 0.0)])
        q.tick(now=base + 4.0)
        node = _node(srv)
        with RpcClient("127.0.0.1", srv.args.rpc_port) as c:
            direct = c.call("get_quality", "ql")
        assert direct[node]["drift"]["ch"] > 0.2
        with RpcClient("127.0.0.1", proxy.args.rpc_port) as c:
            folded = c.call("get_quality", "ql")
            assert c.call("get_proxy_quality", "ql") == {}
        assert set(folded) == {node}
        assert folded[node]["drift"]["ch"] == direct[node]["drift"]["ch"]
        assert folded[node]["prequential"]["n"] == 1
        assert merge_quality(list(folded.values()))["drift"]["ch"] > 0.2
    finally:
        proxy.stop()
        srv.stop()


# -- the proxy's own planes -------------------------------------------------------

def test_proxy_status_carries_every_plane(one_node_cluster):
    srv, proxy = one_node_cluster
    with ClassifierClient("127.0.0.1", proxy.args.rpc_port, "tr1") as c:
        c.train([["a", Datum({"x": 1.0})]])
    proxy.telemetry.sample()
    with RpcClient("127.0.0.1", proxy.args.rpc_port) as c:
        (st,) = c.call("get_proxy_status", "tr1").values()
        (snap,) = c.call("get_proxy_metrics", "tr1").values()
        metrics = c.call("get_metrics", "tr1")
    for prefix in ("runtime.", "slowlog.", "profiler.", "events.",
                   "incident.", "usage.", "trace.rpc.train."):
        assert any(k.startswith(prefix) for k in st), prefix
    assert st["argv.metrics_port"] == -1
    assert st["argv.incident_dir"] == ""
    assert "rpc.train" in snap["hists"]
    assert set(metrics) == {_node(srv)}  # a plain broadcast
    assert "rpc.train" in metrics[_node(srv)]["hists"]


def test_proxy_metrics_port_serves_metrics_and_healthz():
    store = _Store()
    srv = _server(store, "mp")
    proxy = _proxy(store, metrics_port=0, telemetry_interval=0)
    try:
        assert proxy.args.metrics_port > 0
        with ClassifierClient("127.0.0.1", proxy.args.rpc_port, "mp") as c:
            c.train([["a", Datum({"x": 1.0})]])
        base = f"http://127.0.0.1:{proxy.args.metrics_port}"
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            text = r.read().decode()
        assert 'span="rpc.train"' in text
        assert 'engine="classifier_proxy"' in text
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert health["engine"] == "classifier_proxy"
        assert health["status"] == "ok"
        assert health["forward_count"] >= 1
    finally:
        proxy.stop()
        srv.stop()


def test_proxy_slo_fires_one_incident_bundle(tmp_path):
    """A latency SLO on the proxy's own dispatch span fires on a burst of
    slow forwards: one bundle in --incident-dir, with the breaching trace
    ids, the slow log and the breaker table."""
    store = _Store()
    srv = _server(store, "ps")
    proxy = _proxy(store, telemetry_interval=0,
                   slo=["latency:rpc.classify:p99:50"],
                   slo_fast_window=1.0, slo_slow_window=2.5,
                   incident_dir=str(tmp_path / "inc"))
    try:
        reg = proxy.rpc.trace
        reg.slowlog.configure(min_count=1, quantile=0.5)
        for _ in range(100):
            reg.record("rpc.classify", 0.001)
        proxy._model_health_tick()
        time.sleep(0.3)
        ctx = tracing.new_root()
        with tracing.use_trace(ctx):
            for _ in range(40):
                reg.record("rpc.classify", 0.5)
        proxy._model_health_tick()
        proxy._model_health_tick()
        assert [a["name"] for a in proxy.slo.alerts()] == [
            "rpc.classify.p99"]
        assert proxy.incidents.stats()["captured"] == 1
        (meta,) = proxy.incidents.list()["incidents"]
        assert meta["reason"] == "slo_firing:rpc.classify.p99"
        bundle = proxy.incidents.get(meta["id"])
        assert ctx.trace_id in bundle["trace_ids"]
        assert ctx.trace_id in {r["trace_id"] for r in bundle["slow_log"]}
        assert bundle["node"] == _node(proxy)
        assert "breakers" in bundle and "usage" in bundle
        assert bundle["health"]["status"] == "degraded"
        assert (tmp_path / "inc").is_dir()
    finally:
        proxy.stop()
        srv.stop()


def test_proxy_incident_dir_default_is_the_jax_proxys():
    store = _Store()
    proxy = _proxy(store, telemetry_interval=0)
    try:
        assert proxy._incident_dir() == \
            f"/tmp/jubatus_incidents_classifier_proxy_{proxy.args.rpc_port}"
    finally:
        proxy.stop()


def _option_strings(main, argv):
    """The option strings ``main``'s parser knows (its parse stops at
    parse_args)."""
    seen = []
    real = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        seen.extend(s for a in self._actions for s in a.option_strings)
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            main(argv)
    finally:
        argparse.ArgumentParser.parse_args = real
    return set(seen)


def test_proxy_takes_every_jax_proxy_flag_but_the_legacy_wire():
    """Every JAX proxy flag, the legacy wire's (``--legacy-wire``,
    ``--modern-wire``) included since it was ported."""
    from jubatus_tpu.server.proxy import main as jmain
    from jubatus_tpu_torch.server.proxy import main

    port = _option_strings(main, ["classifier", "-z", "memory"])
    jax = _option_strings(jmain, ["classifier", "-z", "memory"])
    assert jax - port == set()
    assert port - jax == set()


def test_proxy_main_serves_the_planes(monkeypatch, tmp_path):
    """The main builds the planes from its flags and starts them with the
    listener; a bad SLO is refused at argv time."""
    from jubatus_tpu_torch.server import proxy as proxy_mod

    seen = {}

    def join(self, timeout=None):
        seen["args"] = self.args
        url = f"http://127.0.0.1:{self.args.metrics_port}/healthz"
        with urllib.request.urlopen(url, timeout=10) as r:
            seen["health"] = json.loads(r.read())
        seen["slos"] = [s["name"] for s in self.slo.status()]
        self.stop()
        return True

    monkeypatch.setattr(proxy_mod.Proxy, "join", join)
    assert proxy_mod.main([
        "classifier", "-z", "memory", "-b", "127.0.0.1", "-p", "0",
        "--metrics-port", "0", "--telemetry-interval", "0",
        "--slo", "latency:rpc.classify:p99:100", "--slowlog-min-count", "8",
        "--incident-dir", str(tmp_path), "--usage-top", "4"]) == 0
    args = seen["args"]
    assert args.metrics_port > 0 and args.slowlog_min_count == 8
    assert args.incident_dir == str(tmp_path) and args.usage_top == 4
    assert seen["health"]["status"] == "ok"
    assert seen["slos"] == ["rpc.classify.p99"]
    with pytest.raises(SystemExit):
        proxy_mod.main(["classifier", "-z", "memory", "--slo", "bogus"])


# -- a mixed fleet: a port proxy before one JAX member and one port member -------

@pytest.fixture()
def mixed_fleet(monkeypatch, tmp_path):
    """A port proxy before one JAX and one port classifier member on the
    port's coordination service; quality sampling on, telemetry off."""
    from jubatus_tpu.coord.remote import RemoteCoordinator as JRemote
    from jubatus_tpu.server import EngineServer as JEngineServer
    from jubatus_tpu.server.args import ServerArgs as JServerArgs
    from jubatus_tpu_torch.coord.remote import RemoteCoordinator
    from jubatus_tpu_torch.coord.server import CoordServer

    monkeypatch.setenv("JUBATUS_TPU_NATIVE_RPC", "0")
    monkeypatch.setenv("JUBATUS_TPU_NATIVE_INGEST", "0")
    coordd = CoordServer(lease_sec=5.0)
    cport = coordd.start(0, host="127.0.0.1")
    common = dict(engine="classifier", coordinator="(shared)", name="mx",
                  listen_addr="127.0.0.1", interval_sec=1e9,
                  interval_count=1 << 30, telemetry_interval=0,
                  profile_hz=0, quality_sample=1.0, microbatch_max=0,
                  datadir=str(tmp_path))
    jsrv = JEngineServer("classifier", CONF, JServerArgs(**common),
                         coord=JRemote("127.0.0.1", cport))
    jsrv.start(0)
    psrv = EngineServer("classifier", CONF, ServerArgs(**common),
                        device="cpu", coord=RemoteCoordinator("127.0.0.1",
                                                              cport))
    psrv.start(0)
    proxy = Proxy(ProxyArgs(engine="classifier", listen_addr="127.0.0.1",
                            telemetry_interval=0, profile_hz=0),
                  coord=RemoteCoordinator("127.0.0.1", cport))
    proxy.start(0)
    rng = np.random.default_rng(5)
    for i in range(6):
        batch = [["ab"[k % 2], Datum({"x": float(np.round(
            rng.standard_normal(), 3)), "y": float(k)})]
            for k in range(6 + i)]
        for port in (jsrv.rpc.port, psrv.rpc.port):
            with principals.use("tenant-m"), \
                    RpcClient("127.0.0.1", port, timeout=30) as c:
                assert c.call("train", "mx", batch) == len(batch)
    for s in (jsrv, psrv):
        s.rpc.trace.events.emit("t", "member_note")
        s._model_health_tick()
    proxy._model_health_tick()
    yield cport, jsrv, psrv, proxy
    proxy.stop()
    psrv.stop()
    jsrv.stop()
    coordd.stop()


def test_mixed_fleet_proxy_folds_both_members(mixed_fleet):
    """The port proxy answers get_quality, get_usage, get_timeseries and
    get_events keyed by the JAX member, the port member and (but for
    quality, which has no proxy doc) itself."""
    _cport, jsrv, psrv, proxy = mixed_fleet
    members = {_node(jsrv), _node(psrv)}
    with RpcClient("127.0.0.1", proxy.args.rpc_port, timeout=30) as c:
        quality = c.call("get_quality", "mx")
        usage = c.call("get_usage", "mx")
        ts = c.call("get_timeseries", "mx")
        evs = c.call("get_events", "mx", 0, "")
    assert set(quality) == members
    assert all(d["prequential"]["n"] > 0 for d in quality.values())
    assert set(usage) == set(ts) == set(evs) == members | {_node(proxy)}
    for node in members:
        assert "tenant-m" in usage[node]["table"]
        assert ts[node]["points"]
        assert "member_note" in {r["type"] for r in evs[node]["events"]}
    merged = usage_mod.merge_usage(list(usage.values()))
    rows = dict(usage_mod.principal_rows(merged))
    assert rows["tenant-m"]["requests"] == 12
