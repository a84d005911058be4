"""The port's coordination service (jubatus_tpu_torch/coord/server.py,
``jubacoordd``) and its remote coordinator (coord/remote.py), mirroring
tests/test_coord_service.py: CRUD, ephemerals, leases, locks, create_id,
watches, the journal, session resumption across a restart; then the
interop: a port server on a JAX jubacoordd, a JAX server on the port's,
each package's jubacoordd recovering the other's journal, and a port
fleet behind a port proxy coordinating over tcp://.

Every wait polls the coordinator's registries or the session's state
against a deadline; nothing sleeps a fixed time."""

from __future__ import annotations

import time

import pytest

from jubatus_tpu_torch.coord import create_coordinator, membership
from jubatus_tpu_torch.coord.remote import RemoteCoordinator
from jubatus_tpu_torch.coord.server import CoordServer

WAIT_S = 20.0


def _wait(pred, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


@pytest.fixture()
def service():
    srv = CoordServer(lease_sec=1.5)
    port = srv.start(0, host="127.0.0.1")
    yield srv, port
    srv.stop()


def _client(port) -> RemoteCoordinator:
    return RemoteCoordinator("127.0.0.1", port)


def test_locator_parsing(service):
    _srv, port = service
    for spec in (f"tcp://127.0.0.1:{port}", f"127.0.0.1:{port}"):
        c = create_coordinator(spec)
        assert isinstance(c, RemoteCoordinator)
        c.close()


def test_crud_roundtrip(service):
    _srv, port = service
    a, b = _client(port), _client(port)
    try:
        assert a.create("/x/y", b"payload")
        assert not b.create("/x/y")          # already exists
        assert b.read("/x/y") == b"payload"
        assert b.exists("/x/y")
        assert a.set("/x/y", b"v2") and b.read("/x/y") == b"v2"
        a.create("/x/z")
        assert b.list("/x") == ["y", "z"]
        assert b.remove("/x/y") and not b.exists("/x/y")
    finally:
        a.close(), b.close()


def test_ephemerals_die_with_session(service):
    _srv, port = service
    a, b = _client(port), _client(port)
    try:
        a.create("/e/one", ephemeral=True)
        assert b.exists("/e/one")
        a.close()
        assert not b.exists("/e/one")
    finally:
        b.close()


def test_session_lease_expiry(service):
    _srv, port = service
    a, b = _client(port), _client(port)
    try:
        a.create("/lease/node", ephemeral=True)
        a._hb_stop.set()  # simulate client death: heartbeats stop
        assert _wait(lambda: not b.exists("/lease/node")), \
            "lease never expired"
    finally:
        b.close()
        a._closed = True
        a._client.close()


def test_locks_are_session_scoped(service):
    _srv, port = service
    a, b = _client(port), _client(port)
    try:
        assert a.try_lock("/locks/m")
        assert not b.try_lock("/locks/m")
        assert not b.unlock("/locks/m")  # not the owner
        assert a.unlock("/locks/m")
        assert b.try_lock("/locks/m")
    finally:
        a.close(), b.close()


def test_lock_released_on_session_close(service):
    _srv, port = service
    a, b = _client(port), _client(port)
    try:
        assert a.try_lock("/locks/n")
        a.close()
        assert b.try_lock("/locks/n")
    finally:
        b.close()


def test_create_id_monotonic_across_sessions(service):
    _srv, port = service
    a, b = _client(port), _client(port)
    try:
        ids = [a.create_id("/ids/g"), b.create_id("/ids/g"),
               a.create_id("/ids/g")]
        assert ids == sorted(set(ids)), "ids must be unique and increasing"
    finally:
        a.close(), b.close()


def test_watch_children_and_delete(service):
    _srv, port = service
    a, b = _client(port), _client(port)
    fired = {"child": 0, "delete": 0}
    try:
        a.create("/w/seed")
        a.watch_children("/w", lambda _p: fired.__setitem__(
            "child", fired["child"] + 1))
        a.watch_delete("/w/seed", lambda _p: fired.__setitem__(
            "delete", fired["delete"] + 1))
        b.create("/w/new")
        b.remove("/w/seed")
        assert _wait(lambda: fired["child"] and fired["delete"])
        assert fired["delete"] == 1
    finally:
        a.close(), b.close()


# -- durability + session resumption -------------------------------------------

def test_journal_recovers_configs_and_counters(tmp_path):
    jpath = str(tmp_path / "coord.journal")
    srv = CoordServer(lease_sec=1.0, journal_path=jpath)
    port = srv.start(0, "127.0.0.1")
    rc = RemoteCoordinator("127.0.0.1", port)
    rc.set("/jubatus/config/classifier/c1", b'{"method": "PA"}')
    ids = [rc.create_id("/jubatus/actors/classifier/c1/id_generator")
           for _ in range(5)]
    rc.create("/jubatus/actors/classifier/c1/nodes/h_1", b"", ephemeral=True)
    rc.close()
    srv.stop()

    srv2 = CoordServer(lease_sec=1.0, journal_path=jpath)
    port2 = srv2.start(0, "127.0.0.1")
    rc2 = RemoteCoordinator("127.0.0.1", port2)
    try:
        # persistent config survived; the ephemeral did not
        assert rc2.read("/jubatus/config/classifier/c1") == b'{"method": "PA"}'
        assert not rc2.exists("/jubatus/actors/classifier/c1/nodes/h_1")
        # counters resume past the reservation — never reissue an id
        nxt = rc2.create_id("/jubatus/actors/classifier/c1/id_generator")
        assert nxt > max(ids)
    finally:
        rc2.close()
        srv2.stop()


def test_journal_compaction_bounds_growth(tmp_path):
    import os

    jpath = str(tmp_path / "coord.journal")
    srv = CoordServer(journal_path=jpath)
    for i in range(50):
        srv._root.set("/jubatus/config/x", b"v%d" % i)
    srv.stop()
    size_before = os.path.getsize(jpath)
    srv2 = CoordServer(journal_path=jpath)  # compacts at open
    srv2.stop()
    assert os.path.getsize(jpath) < size_before
    srv3 = CoordServer(journal_path=jpath)
    assert srv3.store.nodes["/jubatus/config/x"][0] == b"v49"
    srv3.stop()


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_each_packages_journal_recovers_in_the_other(tmp_path, writer,
                                                     reader):
    """The journal's records are the JAX package's: either package's
    jubacoordd recovers a journal the other wrote."""
    from jubatus_tpu.coord.server import CoordServer as JCoordServer

    servers = {"port": CoordServer, "jax": JCoordServer}
    jpath = str(tmp_path / "coord.journal")
    srv = servers[writer](journal_path=jpath)
    srv._root.set("/jubatus/config/stat/s", b'{"window_size": 8}')
    ids = [srv._root.create_id("/jubatus/actors/stat/s/id_generator")
           for _ in range(3)]
    srv.stop()
    srv2 = servers[reader](journal_path=jpath)
    try:
        assert srv2._root.read("/jubatus/config/stat/s") == \
            b'{"window_size": 8}'
        assert srv2._root.create_id(
            "/jubatus/actors/stat/s/id_generator") > max(ids)
    finally:
        srv2.stop()


def test_session_resumes_across_coordd_restart(tmp_path):
    """Kill/restart coordd mid-cluster: the client must re-open its session
    and re-create its ephemerals — no membership loss, no suicide."""
    jpath = str(tmp_path / "coord.journal")
    srv = CoordServer(lease_sec=1.0, journal_path=jpath)
    port = srv.start(0, "127.0.0.1")
    rc = RemoteCoordinator("127.0.0.1", port, resume_window_sec=20.0)
    suicided = []
    member = "/jubatus/actors/classifier/c1/nodes/host_9199"
    assert rc.create(member, b"", ephemeral=True)
    rc.watch_delete(member, lambda p: suicided.append(p))
    srv.stop()  # the "crash"
    # heartbeats fail while coordd is down
    assert _wait(rc._suspect.is_set), "the session never noticed"
    srv2 = CoordServer(lease_sec=1.0, journal_path=jpath)
    srv2.start(port, "127.0.0.1")  # same port, recovered store
    try:
        assert _wait(lambda: srv2._root.exists(member)), \
            "ephemeral was not re-created"
        assert not suicided, "delete watcher fired despite successful resume"
        assert not rc._closed
        # the resumed session is fully functional
        assert rc.create(member + "_b", b"", ephemeral=True)
    finally:
        rc.close()
        srv2.stop()


def test_session_lost_after_resume_window():
    """coordd gone for longer than the resume window -> the original
    cleanup contract: delete watchers fire, client closes."""
    srv = CoordServer(lease_sec=0.6)
    port = srv.start(0, "127.0.0.1")
    rc = RemoteCoordinator("127.0.0.1", port, resume_window_sec=1.0)
    fired = []
    assert rc.create("/jubatus/actors/x/n/nodes/h", b"", ephemeral=True)
    rc.watch_delete("/jubatus/actors/x/n/nodes/h", lambda p: fired.append(p))
    srv.stop()
    assert _wait(lambda: rc._closed)
    assert fired == ["/jubatus/actors/x/n/nodes/h"]


def test_close_during_outage_does_not_fire_suicide():
    """Intentional shutdown while coordd is down must NOT run the
    session-lost suicide path."""
    srv = CoordServer(lease_sec=0.6)
    port = srv.start(0, "127.0.0.1")
    rc = RemoteCoordinator("127.0.0.1", port, resume_window_sec=30.0)
    fired = []
    assert rc.create("/jubatus/actors/x/n/nodes/h", b"", ephemeral=True)
    rc.watch_delete("/jubatus/actors/x/n/nodes/h", lambda p: fired.append(p))
    srv.stop()
    assert _wait(rc._suspect.is_set)  # heartbeats fail into the resume loop
    rc.close()       # operator shutdown during the outage
    rc._hb.join(timeout=10)
    assert not rc._hb.is_alive()
    assert fired == [], "suicide watcher fired on intentional close"


# -- the packages on each other's jubacoordd -------------------------------------

CONF = {"method": "PA", "parameter": {"regularization_weight": 1.0},
        "converter": {"num_rules": [{"key": "*", "type": "num"}]}}


def _port_server(locator, name):
    from jubatus_tpu_torch.server import EngineServer
    from jubatus_tpu_torch.server.args import ServerArgs

    srv = EngineServer("classifier", CONF, ServerArgs(
        engine="classifier", coordinator=locator, name=name,
        listen_addr="127.0.0.1", interval_sec=1e9, interval_count=1 << 30),
        device="cpu")
    srv.start(0)
    return srv


def _jax_server(locator, name):
    from jubatus_tpu.server import EngineServer
    from jubatus_tpu.server.args import ServerArgs

    srv = EngineServer("classifier", CONF, ServerArgs(
        engine="classifier", coordinator=locator, name=name,
        listen_addr="127.0.0.1", interval_sec=1e9, interval_count=1 << 30))
    srv.start(0)
    return srv


@pytest.mark.parametrize("coordd", ["jax", "port"])
def test_jax_and_port_servers_share_either_jubacoordd(coordd):
    """A port server and a JAX server register on one jubacoordd of either
    package, see each other in its registries and mix over RPC."""
    from jubatus_tpu.client import ClassifierClient, Datum
    from jubatus_tpu.coord.server import CoordServer as JCoordServer

    service = (JCoordServer if coordd == "jax" else CoordServer)(
        lease_sec=2.0)
    port = service.start(0, "127.0.0.1")
    locator = f"tcp://127.0.0.1:{port}"
    servers = [_port_server(locator, "mx"), _jax_server(locator, "mx")]
    view = RemoteCoordinator("127.0.0.1", port)
    try:
        assert _wait(lambda: len(membership.get_all_actives(
            view, "classifier", "mx")) == 2)
        assert {n.port for n in membership.get_all_nodes(
            view, "classifier", "mx")} == {s.args.rpc_port for s in servers}
        clients = [ClassifierClient("127.0.0.1", s.args.rpc_port, "mx")
                   for s in servers]
        clients[0].train([["pos", Datum({"x": 1.0})]])
        clients[1].train([["neg", Datum({"x": -1.0})]])
        assert clients[0].do_mix() is True
        for c in clients:
            res = c.classify([Datum({"x": 1.0}), Datum({"x": -1.0})])
            assert [max(r, key=lambda s: s[1])[0] for r in res] == \
                ["pos", "neg"]
            c.close()
    finally:
        view.close()
        for s in servers:
            s.stop()
        service.stop()


def test_port_fleet_behind_a_port_proxy_over_tcp():
    """Two port classifier servers and a port proxy coordinate over
    tcp://: train through the proxy, mix, classify."""
    from jubatus_tpu_torch.core.datum import Datum
    from jubatus_tpu_torch.rpc.client import ClassifierClient
    from jubatus_tpu_torch.server.proxy import Proxy, ProxyArgs

    service = CoordServer(lease_sec=2.0)
    port = service.start(0, "127.0.0.1")
    locator = f"tcp://127.0.0.1:{port}"
    servers = [_port_server(locator, "tc") for _ in range(2)]
    proxy = Proxy(ProxyArgs(engine="classifier", coordinator=locator,
                            listen_addr="127.0.0.1"))
    proxy.start(0)
    try:
        c = ClassifierClient("127.0.0.1", proxy.args.rpc_port, "tc")
        for _ in range(10):
            c.train([["pos", Datum({"x": 1.0})]])
            c.train([["neg", Datum({"x": -1.0})]])
        assert len(c.get_status()) == 2  # both backends via tcp membership
        assert c.do_mix() is True
        res = c.classify([Datum({"x": 1.0}), Datum({"x": -1.0})])
        assert [max(r, key=lambda s: s[1])[0] for r in res] == ["pos", "neg"]
        c.close()
        view = RemoteCoordinator("127.0.0.1", port)
        assert len(view.list(membership.PROXY_BASE)) == 1
        view.close()
    finally:
        proxy.stop()
        for s in servers:
            s.stop()
        service.stop()
