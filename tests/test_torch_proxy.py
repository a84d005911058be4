"""The port's routing proxy (jubatus_tpu_torch/server/proxy.py), mirroring
tests/test_proxy.py (routing classes, built-ins, dead backends, the member
cache; its C++ relay tests are tests/test_torch_native_rpc.py's) and tests/test_proxy_engines.py (CHT
replication, the server-side CHT(2) placement of anomaly ``add`` and graph
``create_node``, broadcast folds, internal methods) on port servers on the
CPU; then the mixed fleets: a port proxy in front of one JAX and one port
server, and a JAX proxy in front of port servers, answer as a JAX proxy
over JAX servers (lsh / minhash nearest_neighbor: the same distances, ids
equal below the k-th distance; AROW: bit-equal models, scores within the
tolerance tests/test_torch_classifier_driver.py states)."""

from __future__ import annotations

import numpy as np
import pytest

from jubatus_tpu.client import ClassifierClient as JClassifierClient
from jubatus_tpu.client import Datum as JDatum
from jubatus_tpu.client import NearestNeighborClient as JNNClient
from jubatus_tpu.rpc.client import RpcClient as JRpcClient
from jubatus_tpu.coord.remote import RemoteCoordinator as JRemoteCoordinator
from jubatus_tpu.server import EngineServer as JEngineServer
from jubatus_tpu.server.args import ServerArgs as JServerArgs
from jubatus_tpu.server.proxy import Proxy as JProxy
from jubatus_tpu.server.proxy import ProxyArgs as JProxyArgs
from jubatus_tpu_torch.coord import membership
from jubatus_tpu_torch.coord.cht import CHT
from jubatus_tpu_torch.coord.memory import MemoryCoordinator, _Store
from jubatus_tpu_torch.coord.remote import RemoteCoordinator
from jubatus_tpu_torch.coord.server import CoordServer
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.rpc.client import (AnomalyClient, BurstClient,
                                          ClassifierClient, GraphClient,
                                          NearestNeighborClient,
                                          RecommenderClient, RpcClient,
                                          StatClient)
from jubatus_tpu_torch.rpc.errors import RpcMethodNotFound
from jubatus_tpu_torch.server import EngineServer
from jubatus_tpu_torch.server.args import ServerArgs
from jubatus_tpu_torch.server.proxy import (Proxy, ProxyArgs,
                                            _peek_cluster_name)

NAME = "pcl"

CLASSIFIER_CONF = {
    "method": "PA",
    "parameter": {"regularization_weight": 1.0},
    "converter": {"num_rules": [{"key": "*", "type": "num"}]},
}
CONV = {"num_rules": [{"key": "*", "type": "num"}]}


def _args(engine):
    return ServerArgs(engine=engine, coordinator="(shared)", name=NAME,
                      listen_addr="127.0.0.1", interval_sec=1e9,
                      interval_count=1 << 30)


def _boot(engine, conf, n, store):
    servers = []
    for _ in range(n):
        srv = EngineServer(engine, conf, _args(engine), device="cpu",
                           coord=MemoryCoordinator(store))
        srv.start(0)
        servers.append(srv)
    return servers


def _proxy(engine, store, **kw):
    p = Proxy(ProxyArgs(engine=engine, listen_addr="127.0.0.1", **kw),
              coord=MemoryCoordinator(store))
    p.start(0)
    return p


def _stack(engine, conf, n=3):
    store = _Store()
    servers = _boot(engine, conf, n, store)
    return servers, _proxy(engine, store)


def _teardown(servers, proxy):
    proxy.stop()
    for s in servers:
        s.stop()


def _text(x):
    return x.decode() if isinstance(x, bytes) else x


@pytest.fixture()
def classifier_cluster():
    store = _Store()
    servers = _boot("classifier", CLASSIFIER_CONF, 3, store)
    proxy = _proxy("classifier", store)
    yield servers, proxy, store
    proxy.stop()
    for s in servers:
        s.stop()


# -- tests/test_proxy.py -------------------------------------------------------

def test_random_routing_single_backend(classifier_cluster):
    servers, proxy, _ = classifier_cluster
    c = ClassifierClient("127.0.0.1", proxy.args.rpc_port, NAME)
    # train goes to exactly ONE backend per call (random routing)
    assert c.train([["pos", Datum({"x": 1.0})]]) == 1
    assert sum(s.driver.update_count for s in servers) == 1
    c.close()


def test_broadcast_clear_reaches_all(classifier_cluster):
    servers, proxy, _ = classifier_cluster
    for s in servers:
        with ClassifierClient("127.0.0.1", s.args.rpc_port, NAME) as d:
            d.train([["pos", Datum({"x": 1.0})]])
    assert all(s.driver.update_count == 1 for s in servers)
    c = ClassifierClient("127.0.0.1", proxy.args.rpc_port, NAME)
    assert c.clear() is True  # all_and over 3 backends
    for s in servers:
        with ClassifierClient("127.0.0.1", s.args.rpc_port, NAME) as d:
            assert d.get_labels() == {}
    c.close()


def test_get_status_merges_all_nodes(classifier_cluster):
    servers, proxy, _ = classifier_cluster
    c = ClassifierClient("127.0.0.1", proxy.args.rpc_port, NAME)
    st = c.get_status()
    assert len(st) == 3  # one entry per backend, merged
    assert {int(k.rsplit("_", 1)[1]) for k in st} == {
        s.args.rpc_port for s in servers}
    c.close()


def test_save_broadcast_merge_and_load(classifier_cluster, tmp_path):
    servers, proxy, _ = classifier_cluster
    for s in servers:
        s.args.datadir = str(tmp_path)
    c = ClassifierClient("127.0.0.1", proxy.args.rpc_port, NAME)
    c.train([["pos", Datum({"x": 1.0})]])
    paths = c.save("m1")
    assert len(paths) == 3  # per-server path map, merged (proxy.cpp:48-54)
    # broadcast load restores every node's OWN snapshot (all_and): only
    # the node that got the random-routed train has the label again
    assert c.clear() is True
    assert c.load("m1") is True
    assert sum("pos" in s.driver.get_labels() for s in servers) == 1
    c.close()


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
    """The methods the proxies' zero-decode relay forwarded: each relay is
    one ``RpcClient.call_raw``, in the port's proxy and in the JAX
    proxy's Python relay alike (``relay_count`` counts only the requests
    a C++ relay served)."""
    calls = []
    for cls in (RpcClient, JRpcClient):
        real = cls.call_raw

        def spy(self, method, raw_params, _real=real):
            calls.append(method)
            return _real(self, method, raw_params)

        monkeypatch.setattr(cls, "call_raw", spy)
    return calls


def test_proxy_status_counters(python_transport, classifier_cluster,
                               relayed):
    _, proxy, _ = classifier_cluster
    c = ClassifierClient("127.0.0.1", proxy.args.rpc_port, NAME)
    c.train([["a", Datum({"x": 1.0})]])
    c.get_labels()
    (node_st,) = c.get_proxy_status().values()
    assert node_st["type"] == "classifier_proxy"
    assert node_st["request.train"] == 1
    assert node_st["request.get_labels"] == 1
    assert node_st["forward_count"] >= 2
    # both random-routed calls went through the zero-decode relay, which
    # on the Python transport counts as a forward, not in relay_count
    assert relayed == ["train", "get_labels"]
    assert node_st["relay_count"] == 0
    assert node_st["trace.rpc.train.count"] == 1
    c.close()


def test_relay_counters_equal_the_jax_proxy_on_the_python_transport(
        monkeypatch, relayed):
    """A port proxy and a JAX proxy on the Python transport, each before
    one member of its own package, relay the same N raw ``train`` calls:
    both report N forwards, N ``request.train`` and ``relay_count`` 0
    (the zero-decode relay counts as a forward; ``relay_count`` is the
    C++ relay's)."""
    from jubatus_tpu.coord.memory import MemoryCoordinator as JMemCoord
    from jubatus_tpu.coord.memory import _Store as JStore

    monkeypatch.setenv("JUBATUS_TPU_NATIVE_RPC", "0")
    n = 5
    jstore, store = JStore(), _Store()
    jsrv = JEngineServer("classifier", CLASSIFIER_CONF, JServerArgs(
        engine="classifier", coordinator="(shared)", name=NAME,
        listen_addr="127.0.0.1", interval_sec=1e9, interval_count=1 << 30),
        coord=JMemCoord(jstore))
    jsrv.start(0)
    (srv,) = _boot("classifier", CLASSIFIER_CONF, 1, store)
    jproxy = JProxy(JProxyArgs(engine="classifier", listen_addr="127.0.0.1"),
                    coord=JMemCoord(jstore))
    jproxy.start(0)
    proxy = _proxy("classifier", store)
    rows = []
    try:
        for p in (proxy, jproxy):
            with ClassifierClient("127.0.0.1", p.args.rpc_port, NAME) as c:
                for i in range(n):
                    assert c.train([["ab"[i % 2], Datum({"x": i - 2.0})]]) == 1
            (st,) = p.get_proxy_status("").values()
            rows.append({k: st[k] for k in
                         ("forward_count", "relay_count", "request.train")})
    finally:
        proxy.stop()
        jproxy.stop()
        srv.stop()
        jsrv.stop()
    assert relayed == ["train"] * (2 * n)
    assert rows[0] == rows[1] == {"forward_count": n, "relay_count": 0,
                                  "request.train": n}


def test_dead_backend_tolerated_on_broadcast(classifier_cluster):
    servers, proxy, _ = classifier_cluster
    # kill one backend but leave its actives entry: proxy must still answer
    dead = servers.pop()
    dead.rpc.stop()
    c = ClassifierClient("127.0.0.1", proxy.args.rpc_port, NAME)
    assert len(c.get_status()) == 2  # merged over the 2 live nodes
    c.close()
    dead.stop()


def test_no_actives_raises():
    store = _Store()
    proxy = _proxy("classifier", store)
    c = ClassifierClient("127.0.0.1", proxy.args.rpc_port, NAME, timeout=2.0)
    with pytest.raises(Exception) as ei:
        c.get_labels()
    assert "no active" in str(ei.value)
    c.close()
    proxy.stop()


def test_cht_routing_pins_key():
    """stat push/sum route by key: the same key must land on the same
    backend every time (stat_proxy.cpp:21-36, #@cht(1))."""
    servers, proxy = _stack("stat", {"window_size": 64})
    try:
        c = StatClient("127.0.0.1", proxy.args.rpc_port, NAME)
        for v in (1.0, 2.0, 3.0):
            c.push("alpha", v)
        assert c.sum("alpha") == pytest.approx(6.0)
        holders = [s for s in servers if s.driver.update_count == 3]
        assert len(holders) == 1
        assert all(s.driver.update_count in (0, 3) for s in servers)
        c.push("beta", 10.0)
        assert c.sum("beta") == pytest.approx(10.0)
        c.close()
    finally:
        _teardown(servers, proxy)


def test_member_cache_invalidation():
    """A new server joining becomes visible to the proxy."""
    store = _Store()
    servers = _boot("classifier", CLASSIFIER_CONF, 1, store)
    proxy = _proxy("classifier", store)
    try:
        assert len(proxy.members.actives(NAME)) == 1
        servers += _boot("classifier", CLASSIFIER_CONF, 1, store)
        proxy.members.invalidate(NAME)
        assert len(proxy.members.actives(NAME)) == 2
    finally:
        _teardown(servers, proxy)


def test_peek_cluster_name_reads_the_first_param_without_decoding():
    import msgpack

    for params in (["c1", 1, 2], ["x" * 40, []], ["é" * 200]):
        assert _peek_cluster_name(msgpack.packb(params)) == params[0]
    assert _peek_cluster_name(msgpack.packb([])) is None
    assert _peek_cluster_name(msgpack.packb([1, "c"])) is None


def test_unported_proxy_flags_exit_with_their_roadmap_item(capsys,
                                                          monkeypatch):
    """No proxy flag is refused any more: the legacy wire (A23) serves
    (``--legacy-wire`` forces the old format, ``--modern-wire`` turns the
    per-connection detection off), as do the planes' flags, such as
    --metrics-port; get_proxy_status carries ``argv.daemon`` as the JAX
    proxy's does."""
    from jubatus_tpu_torch.server import proxy as proxy_mod

    seen = []

    def join(self, timeout=None):
        (st,) = self.get_proxy_status("").values()
        seen.append((self.metrics.port if self.metrics else None,
                     self.rpc.legacy_wire, self.rpc.wire_detect,
                     st["argv.daemon"], st["argv.legacy_wire"],
                     st["argv.modern_wire"]))
        self.stop()
        return True

    monkeypatch.setattr(proxy_mod.Proxy, "join", join)
    base = ["classifier", "-z", "memory", "-b", "127.0.0.1", "-p", "0",
            "--telemetry-interval", "0"]
    assert proxy_mod.main(base + ["--legacy-wire"]) == 0
    assert proxy_mod.main(base + ["--modern-wire"]) == 0
    assert proxy_mod.main(base + ["--metrics-port", "0"]) == 0
    assert seen[0][1:] == (True, True, False, True, False)
    assert seen[1][1:] == (False, False, False, False, True)
    assert seen[2][0] and seen[2][1:] == (False, True, False, False, False)
    assert "not yet ported" not in capsys.readouterr().err


# -- tests/test_proxy_engines.py -----------------------------------------------

def test_recommender_cht_replication_and_queries():
    conf = {"method": "inverted_index", "parameter": {}, "converter": CONV}
    servers, proxy = _stack("recommender", conf)
    try:
        c = RecommenderClient("127.0.0.1", proxy.args.rpc_port, NAME)
        for i in range(8):
            assert c.update_row(f"r{i}", Datum({"x": float(i), "y": 1.0})) is True
        # cht(2) writes: each row must exist on EXACTLY 2 backends
        for i in range(8):
            holders = sum(1 for s in servers
                          if f"r{i}" in s.driver.backend.store)
            assert holders == 2, f"r{i} on {holders} backends"
        sim = c.similar_row_from_id("r3", 3)
        assert sim and _text(sim[0][0]) == "r3"
        assert c.clear() is True
        assert all(len(s.driver.backend.store) == 0 for s in servers)
        c.close()
    finally:
        _teardown(servers, proxy)


def _owners(servers, key):
    ring = CHT.from_coordinator(servers[0].coord, servers[0].engine, NAME)
    return {n.name for n in ring.find(key, 2)}


def test_anomaly_add_lands_on_both_cht_owners_then_cht_update():
    """add routes random; the member that takes it mints the id and
    places the row on its CHT(2) owners, so the CHT-routed update,
    overwrite and calc_score-by-row that follow find it."""
    conf = {"method": "lof",
            "parameter": {"nearest_neighbor_num": 3, "method": "euclid_lsh",
                          "parameter": {"hash_num": 64}},
            "converter": CONV}
    servers, proxy = _stack("anomaly", conf)
    try:
        c = AnomalyClient("127.0.0.1", proxy.args.rpc_port, NAME)
        ids = []
        for i in range(6):
            rid, score = c.add(Datum({"x": float(i)}))
            ids.append(_text(rid))
            assert isinstance(score, float)
        assert len(set(ids)) == 6  # cluster idgen: no collisions
        by_name = {s.self_nodeinfo().name: s for s in servers}
        for rid in ids:
            owners = _owners(servers, rid)
            assert len(owners) == 2
            for name, srv in by_name.items():
                with AnomalyClient("127.0.0.1", srv.args.rpc_port,
                                   NAME) as d:
                    held = rid in {_text(x) for x in d.get_all_rows()}
                assert held == (name in owners), (rid, name)
        # CHT-routed writes reach the owners that hold the row
        assert isinstance(c.update(ids[0], Datum({"x": 9.0})), float)
        assert isinstance(c.overwrite(ids[1], Datum({"x": 8.0})), float)
        assert isinstance(c.calc_score(Datum({"x": 2.5})), float)
        assert c.clear() is True
        c.close()
    finally:
        _teardown(servers, proxy)


def test_graph_create_node_lands_on_both_cht_owners():
    conf = {"method": "graph_wo_index",
            "parameter": {"damping_factor": 0.9, "landmark_num": 3}}
    servers, proxy = _stack("graph", conf)
    try:
        c = GraphClient("127.0.0.1", proxy.args.rpc_port, NAME)
        nids = [_text(c.create_node()) for _ in range(4)]
        assert len(set(nids)) == 4  # cluster-unique ids via coordinator
        by_name = {s.self_nodeinfo().name: s for s in servers}
        for nid in nids:
            owners = _owners(servers, nid)
            for name, srv in by_name.items():
                assert (nid in srv.driver.nodes) == (name in owners), \
                    (nid, name)
        # cht(2) reads and writes find the node on its owners
        assert c.update_node(nids[0], {"k": "v"}) is True
        node = c.get_node(nids[0])
        assert {_text(k): _text(v) for k, v in node[0].items()} == {"k": "v"}
        assert c.add_shortest_path_query([[], []]) is True
        c.close()
    finally:
        _teardown(servers, proxy)


def test_burst_broadcast_add_and_keyword_registry():
    conf = {"parameter": {"window_batch_size": 4, "batch_interval": 10,
                          "max_reuse_batch_num": 5, "costcut_threshold": -1,
                          "result_window_rotate_size": 4}}
    servers, proxy = _stack("burst", conf)
    try:
        c = BurstClient("127.0.0.1", proxy.args.rpc_port, NAME)
        assert c.add_keyword(["fire", 2.0, 0.1]) is True
        assert all(list(s.driver.keywords) == ["fire"] for s in servers)
        # add_documents broadcasts; #@pass returns ONE node's count
        n = c.add_documents([[10.0, "fire in the hall"], [10.0, "all calm"]])
        assert n == 2
        assert len(c.get_status()) == 3
        kw = c.get_all_keywords()
        assert kw and _text(kw[0][0]) == "fire"
        c.close()
    finally:
        _teardown(servers, proxy)


def test_burst_cht_keyword_partitioning():
    """Keywords are processed only by their CHT(2) owners, and queries
    routed cht(2) through the proxy see the counts."""
    conf = {"parameter": {"window_batch_size": 4, "batch_interval": 10,
                          "max_reuse_batch_num": 5, "costcut_threshold": -1,
                          "result_window_rotate_size": 4}}
    servers, proxy = _stack("burst", conf)
    try:
        c = BurstClient("127.0.0.1", proxy.args.rpc_port, NAME)
        kws = [f"kw{i}" for i in range(8)]
        for kw in kws:
            assert c.add_keyword([kw, 2.0, 1.0]) is True
        docs = [[25.0, " ".join(kws)]] * 3
        assert c.add_documents(docs) == 3
        cht = CHT.from_coordinator(servers[0].coord, "burst", NAME,
                                   actives_only=False)
        by_name = {s.self_nodeinfo().name: s for s in servers}
        for kw in kws:
            owners = {n.name for n in cht.find(kw, 2)}
            for nm, srv in by_name.items():
                assert bool(srv.driver._rel_d.get(kw)) == (nm in owners), \
                    (kw, nm)
        res = c.get_result("kw3")
        assert res[1][-1][1] == 3  # relevant_data_count of the last batch
        c.close()
    finally:
        _teardown(servers, proxy)


def test_internal_methods_not_exposed_on_proxy():
    conf = {"method": "graph_wo_index",
            "parameter": {"damping_factor": 0.9, "landmark_num": 3}}
    servers, proxy = _stack("graph", conf, n=1)
    try:
        with RpcClient("127.0.0.1", proxy.args.rpc_port) as c:
            for method, args in (("create_node_here", ("x",)),
                                 ("remove_global_node", ("x",)),
                                 ("create_edge_here", (1, [{}, "a", "b"]))):
                with pytest.raises(RpcMethodNotFound):
                    c.call(method, NAME, *args)
    finally:
        _teardown(servers, proxy)


# -- mixed fleets ---------------------------------------------------------------

NN_CONF = {"method": "lsh", "parameter": {"hash_num": 64},
           "converter": CONV}
AROW_CONF = {"method": "AROW", "parameter": {"regularization_weight": 1.0},
             "converter": CONV}


@pytest.fixture()
def coordd():
    srv = CoordServer(lease_sec=5.0)
    port = srv.start(0, host="127.0.0.1")
    yield port
    srv.stop()


def _member(kind, engine, conf, port, name):
    """A JAX or a port server on the coordination service at ``port``."""
    if kind == "jax":
        srv = JEngineServer(engine, conf, JServerArgs(
            engine=engine, coordinator="(shared)", name=name,
            listen_addr="127.0.0.1", interval_sec=1e9,
            interval_count=1 << 30, microbatch_max=0),
            coord=JRemoteCoordinator("127.0.0.1", port))
    else:
        srv = EngineServer(engine, conf, ServerArgs(
            engine=engine, coordinator="(shared)", name=name,
            listen_addr="127.0.0.1", interval_sec=1e9,
            interval_count=1 << 30, microbatch_max=0), device="cpu",
            coord=RemoteCoordinator("127.0.0.1", port))
    srv.start(0)
    return srv


def _front(kind, engine, port):
    if kind == "jax":
        p = JProxy(JProxyArgs(engine=engine, listen_addr="127.0.0.1"),
                   coord=JRemoteCoordinator("127.0.0.1", port))
    else:
        p = Proxy(ProxyArgs(engine=engine, listen_addr="127.0.0.1"),
                  coord=RemoteCoordinator("127.0.0.1", port))
    p.start(0)
    return p


def _nn_rows(n=60, seed=3):
    rng = np.random.default_rng(seed)
    return [(f"r{i}", {f"f{j}": float(np.round(rng.standard_normal(), 3))
                       for j in rng.choice(16, 5, replace=False)})
            for i in range(n)]


def _fleet(proxy_kind, member_kinds, engine, conf, port, name, drive,
           packs=None):
    """Drive a fleet through its proxy; ``packs`` (a list) receives every
    member's model after the drive."""
    servers = [_member(k, engine, conf, port, name) for k in member_kinds]
    proxy = _front(proxy_kind, engine, port)
    try:
        view = RemoteCoordinator("127.0.0.1", port)
        try:
            assert len(membership.get_all_actives(view, engine, name)) == \
                len(servers)
        finally:
            view.close()
        out = drive(proxy.args.rpc_port, name)
        if packs is not None:
            packs.extend(s.driver.pack() for s in servers)
        return out
    finally:
        proxy.stop()
        for s in servers:
            s.stop()


def _drive_nn(port, name):
    rows = _nn_rows()
    c = JNNClient("127.0.0.1", port, name, timeout=60.0)
    for rid, feats in rows:
        assert c.set_row(rid, JDatum(feats)) is True
    # one mix round: every member then holds every row, so a
    # random-routed query answers the same on any member
    assert c.do_mix() is True
    out = []
    for _, feats in rows[:10]:
        out.append(c.neighbor_row_from_datum(JDatum(feats), 5))
        out.append(c.similar_row_from_datum(JDatum(feats), 5))
    c.close()
    return out


def _same_ranked(got, want):
    for g, w in zip(got, want):
        gd = [d for _, d in g]
        assert gd == [d for _, d in w]  # bit-equal distances
        edge = gd[-1]
        assert {_text(i) for i, d in g if d != edge} == \
            {_text(i) for i, d in w if d != edge}


def _drive_arow(port, name):
    rng = np.random.default_rng(11)
    data = []
    for i in range(60):
        label = "ab"[i % 2]
        feats = {f"f{j}": float(np.round(rng.standard_normal(), 3))
                 for j in rng.choice(12, 4, replace=False)}
        feats["bias"] = 1.0 if label == "a" else -1.0
        data.append([label, JDatum(feats)])
    c = JClassifierClient("127.0.0.1", port, name, timeout=60.0)
    # one train call: whichever member takes it, the mix then gives every
    # member the same model
    assert c.train(data) == len(data)
    assert c.do_mix() is True
    out = c.classify([d for _, d in data[:20]])
    c.close()
    return [sorted((_text(lbl), s) for lbl, s in r) for r in out]


@pytest.mark.parametrize("method", ["lsh", "minhash"])
def test_mixed_fleets_answer_nearest_neighbor_as_a_jax_fleet(coordd, method):
    """A port proxy over one JAX and one port server, and a JAX proxy over
    two port servers, on the port's coordination service, answer as a JAX
    proxy over two JAX servers."""
    conf = dict(NN_CONF, method=method)
    want = _fleet("jax", ["jax", "jax"], "nearest_neighbor", conf, coordd,
                  "nnj", _drive_nn)
    for proxy_kind, members, name in (("port", ["jax", "port"], "nnm"),
                                      ("jax", ["port", "port"], "nnp")):
        got = _fleet(proxy_kind, members, "nearest_neighbor", conf, coordd,
                     name, _drive_nn)
        _same_ranked(got, want)


def assert_scores_close(got, want):
    """tests/test_torch_classifier_driver.py's score tolerance."""
    assert [[lab for lab, _ in r] for r in got] == \
        [[lab for lab, _ in r] for r in want]
    g = np.array([[s for _, s in r] for r in got], dtype=np.float64)
    w = np.array([[s for _, s in r] for r in want], dtype=np.float64)
    scale = float(np.abs(w).max()) if w.size else 0.0
    np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * scale + 1e-12)


def test_mixed_fleets_answer_arow_as_a_jax_fleet(coordd):
    """After one train call and one mix through the proxy, every member
    of the mixed fleets holds the JAX fleet's AROW model bit for bit; the
    scores carry tests/test_torch_classifier_driver.py's stated tolerance
    (the port's score sums add in another order than XLA's)."""
    want_packs = []
    want = _fleet("jax", ["jax", "jax"], "classifier", AROW_CONF, coordd,
                  "aj", _drive_arow, want_packs)
    for proxy_kind, members, name in (("port", ["jax", "port"], "am"),
                                      ("jax", ["port", "port"], "ap")):
        packs = []
        got = _fleet(proxy_kind, members, "classifier", AROW_CONF, coordd,
                     name, _drive_arow, packs)
        for pack in packs:
            for key in ("w", "prec", "label_counts"):
                assert np.array_equal(np.asarray(pack[key]),
                                      np.asarray(want_packs[0][key])), key
        assert_scores_close(got, want)


def test_port_proxy_carries_principal_deadline_and_trace_to_a_jax_server(
        coordd):
    """The forward re-ships the caller's principal, its remaining deadline
    and its trace id: a JAX backend behind the port proxy sees them."""
    from jubatus_tpu.rpc import deadline as jdeadline
    from jubatus_tpu.rpc import principal as jprincipal
    from jubatus_tpu.utils import tracing as jtracing
    from jubatus_tpu_torch.rpc import deadline, principal
    from jubatus_tpu_torch.utils import tracing

    seen = {}
    srv = _member("jax", "classifier", CLASSIFIER_CONF, coordd, "env")
    real = srv.rpc._methods["get_labels"]

    def spy(name):
        seen["principal"] = jprincipal.current()
        seen["remaining"] = jdeadline.remaining()
        seen["trace"] = jtracing.current_trace().trace_id
        return real(name)

    srv.rpc._methods["get_labels"] = spy
    proxy = _front("port", "classifier", coordd)
    try:
        ctx = tracing.from_wire(None)
        with RpcClient("127.0.0.1", proxy.args.rpc_port) as c, \
                principal.use("tenant-a"), deadline.deadline_after(20.0), \
                tracing.use_trace(ctx):
            assert c.call("get_labels", "env") == {}
        assert seen["principal"] == "tenant-a"
        assert 0.0 < seen["remaining"] <= 20.0
        assert seen["trace"] == ctx.trace_id
    finally:
        proxy.stop()
        srv.stop()
