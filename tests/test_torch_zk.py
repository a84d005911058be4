"""The port's ZooKeeper backend (``jubatus_tpu_torch/coord/zk.py``).

Mirrors ``tests/test_zk_coordinator.py`` case for case against the port's
``ZkCoordinator``: the contract suite on ``tests/fake_zk.py`` (and on a
live ensemble when ``JUBATUS_TPU_ZK`` names one), the in-session reconnect
cases and the two soaks, and the engine cluster over ``zk://`` with the
port's server and client. Then the two packages together: the same
operations through each package's coordinator leave the same tree, and a
JAX and a port classifier on one fake ensemble see each other and mix
over RPC to the model a two-JAX-server fleet holds.
"""

from __future__ import annotations

import os
import time
import uuid

import numpy as np
import pytest

from jubatus_tpu_torch.coord import CoordinatorError, create_coordinator
from jubatus_tpu_torch.coord.zk import ZkCoordinator

from fake_zk import FakeZkServer  # tests/ is the rootdir on sys.path


def _backends():
    out = ["fake"]
    if os.environ.get("JUBATUS_TPU_ZK"):
        out.append("real")
    return out


@pytest.fixture(params=_backends())
def zk(request):
    """(make_coordinator, root_path) for a fake or real ensemble."""
    if request.param == "fake":
        srv = FakeZkServer()
        port = srv.start(0)
        root = "/jubatus_test"

        def make():
            return ZkCoordinator.from_locator(f"zk://127.0.0.1:{port}")

        yield make, root
        srv.stop()
    else:
        spec = os.environ["JUBATUS_TPU_ZK"]
        root = f"/jubatus_test_{uuid.uuid4().hex[:8]}"

        def make():
            return create_coordinator(f"zk://{spec}")

        yield make, root


def test_crud_roundtrip(zk):
    make, root = zk
    c = make()
    try:
        assert c.create(f"{root}/config/classifier/c1", b'{"m": 1}')
        assert not c.create(f"{root}/config/classifier/c1", b"dup")
        assert c.read(f"{root}/config/classifier/c1") == b'{"m": 1}'
        assert c.set(f"{root}/config/classifier/c1", b"v2")
        assert c.read(f"{root}/config/classifier/c1") == b"v2"
        assert c.set(f"{root}/config/classifier/new", b"x")  # set creates
        assert c.exists(f"{root}/config/classifier/new")
        assert sorted(c.list(f"{root}/config/classifier")) == ["c1", "new"]
        assert c.remove(f"{root}/config/classifier/new")
        assert not c.remove(f"{root}/config/classifier/new")
        assert c.read(f"{root}/config/classifier/nope") is None
    finally:
        c.close()


def test_ephemerals_die_with_session(zk):
    make, root = zk
    a = make()
    b = make()
    try:
        assert a.create(f"{root}/eph/nodes/h_1", b"", ephemeral=True)
        assert b.exists(f"{root}/eph/nodes/h_1")
        a.close()
        deadline = time.time() + 15
        while time.time() < deadline and b.exists(f"{root}/eph/nodes/h_1"):
            time.sleep(0.2)
        assert not b.exists(f"{root}/eph/nodes/h_1")
    finally:
        b.close()


def test_sequence_nodes_unique_and_ordered(zk):
    make, root = zk
    c = make()
    try:
        first = c.create_seq(f"{root}/seq/lock-", b"")
        second = c.create_seq(f"{root}/seq/lock-", b"")
        assert first != second and first < second
        assert first.startswith(f"{root}/seq/lock-")
    finally:
        c.close()


def test_watch_children_fires_and_rearms(zk):
    make, root = zk
    c = make()
    obs = make()
    try:
        fired = []
        obs.watch_children(f"{root}/wc/nodes", lambda p: fired.append(p))
        c.create(f"{root}/wc/nodes/a", b"", ephemeral=True)
        deadline = time.time() + 10
        while time.time() < deadline and len(fired) < 1:
            time.sleep(0.1)
        assert len(fired) >= 1
        # one-shot ZK watches must be re-armed by the client: a SECOND
        # change must also fire
        c.create(f"{root}/wc/nodes/b", b"", ephemeral=True)
        deadline = time.time() + 10
        while time.time() < deadline and len(fired) < 2:
            time.sleep(0.1)
        assert len(fired) >= 2
    finally:
        c.close()
        obs.close()


def test_watch_delete_fires(zk):
    make, root = zk
    c = make()
    obs = make()
    try:
        c.create(f"{root}/wd/me", b"")
        fired = []
        obs.watch_delete(f"{root}/wd/me", lambda p: fired.append(p))
        c.remove(f"{root}/wd/me")
        deadline = time.time() + 10
        while time.time() < deadline and not fired:
            time.sleep(0.1)
        assert fired == [f"{root}/wd/me"]
    finally:
        c.close()
        obs.close()


def test_locks_are_session_scoped(zk):
    make, root = zk
    a = make()
    b = make()
    try:
        assert a.try_lock(f"{root}/lk/master_lock")
        assert a.try_lock(f"{root}/lk/master_lock")  # reentrant for holder
        assert not b.try_lock(f"{root}/lk/master_lock")
        assert not b.unlock(f"{root}/lk/master_lock")
        assert a.unlock(f"{root}/lk/master_lock")
        assert b.try_lock(f"{root}/lk/master_lock")
        b.unlock(f"{root}/lk/master_lock")
        # session death releases the lock
        assert a.try_lock(f"{root}/lk/other")
        a.close()
        deadline = time.time() + 15
        got = False
        while time.time() < deadline:
            if b.try_lock(f"{root}/lk/other"):
                got = True
                break
            time.sleep(0.2)
        assert got, "lock not released by session death"
    finally:
        b.close()


def test_create_id_monotonic_across_sessions(zk):
    make, root = zk
    a = make()
    b = make()
    try:
        ids = [a.create_id(f"{root}/idg"), a.create_id(f"{root}/idg"),
               b.create_id(f"{root}/idg"), a.create_id(f"{root}/idg")]
        assert ids == sorted(ids)
        assert len(set(ids)) == len(ids)
    finally:
        a.close()
        b.close()


def test_engine_cluster_over_zk():
    """Full stack over the zk:// locator (fake ensemble): 2 port
    classifiers register membership, train, mix, answer through the port's
    client — the drop-in path an existing ZK deployment would use."""
    from jubatus_tpu_torch.client import ClassifierClient, Datum
    from jubatus_tpu_torch.server import EngineServer
    from jubatus_tpu_torch.server.args import ServerArgs

    srv = FakeZkServer()
    port = srv.start(0)
    locator = f"zk://127.0.0.1:{port}"
    conf = {"method": "PA", "parameter": {"regularization_weight": 1.0},
            "converter": {"num_rules": [{"key": "*", "type": "num"}]}}
    servers = []
    try:
        for _ in range(2):
            args = ServerArgs(engine="classifier", coordinator=locator,
                              name="zc", listen_addr="127.0.0.1",
                              interval_sec=1e9, interval_count=1 << 30)
            s = EngineServer("classifier", conf, args, device="cpu")
            s.start(0)
            servers.append(s)
        c0 = ClassifierClient("127.0.0.1", servers[0].args.rpc_port, "zc")
        c1 = ClassifierClient("127.0.0.1", servers[1].args.rpc_port, "zc")
        for _ in range(4):
            c0.train([["pos", Datum({"a": 1.0})]])
            c1.train([["neg", Datum({"b": 1.0})]])
        assert len(c0.get_status()) == 1  # direct server status
        assert c0.do_mix() is True
        (r,) = c1.classify([Datum({"a": 1.0})])
        scores = dict(r)
        assert scores["pos"] > scores["neg"]
        c0.close()
        c1.close()
    finally:
        for s in servers:
            s.stop()
        srv.stop()


# -- in-session reconnect ----------------------------------------------------
# Fake-only: these need session_grace + expire_session + host-list surgery,
# which a shared real ensemble can't offer.


def _wait_until(cond, timeout=8.0, step=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(step)
    return False


def test_socket_loss_resumes_session_ephemerals_survive():
    """A TCP reset is NOT session loss: the client reconnects with
    sessionId+passwd inside the negotiated timeout (zk.cpp:139-150), the
    ephemerals survive, and no delete/suicide watcher fires."""
    srv = FakeZkServer()
    srv.session_grace = 15.0
    port = srv.start(0)
    c = ZkCoordinator.from_locator(f"zk://127.0.0.1:{port}")
    try:
        assert c.create("/app/me", b"x", ephemeral=True)
        fired = []
        c.watch_delete("/app/me", fired.append)
        sid = c._conn.session_id

        c._conn._sock.shutdown(2)  # the network blip

        assert _wait_until(lambda: c._conn.reconnect_count == 1
                           and not c._conn._closed)
        assert c._conn.session_id == sid          # same session, new socket
        assert c.read("/app/me") == b"x"          # ephemeral survived
        assert c.exists("/app/me")
        time.sleep(0.3)
        assert fired == []                        # no spurious suicide
        # the session still works end to end
        assert c.create("/app/me2", b"y", ephemeral=True)
    finally:
        c.close()
        srv.stop()


def test_watches_rearm_after_reconnect():
    """One-shot watches die with the socket; after an in-session resume
    the coordinator re-arms them, so changes made through ANOTHER client
    still notify this one."""
    srv = FakeZkServer()
    srv.session_grace = 15.0
    port = srv.start(0)
    c = ZkCoordinator.from_locator(f"zk://127.0.0.1:{port}")
    other = ZkCoordinator.from_locator(f"zk://127.0.0.1:{port}")
    try:
        kids = []
        c.watch_children("/members", kids.append)
        c._conn._sock.shutdown(2)
        assert _wait_until(lambda: c._conn.reconnect_count == 1)
        seen = len(kids)
        other.create("/members/n1", b"")
        assert _wait_until(lambda: len(kids) > seen)
        assert c.list("/members") == ["n1"]
    finally:
        c.close()
        other.close()
        srv.stop()


def test_delete_during_disconnect_fires_on_resume():
    """A delete-watched node removed WHILE the socket is down can never
    deliver its event; the re-arm pass detects the absence and fires the
    handler on resume (no lost-deletion window)."""
    srv = FakeZkServer()
    srv.session_grace = 15.0
    port = srv.start(0)
    c = ZkCoordinator.from_locator(f"zk://127.0.0.1:{port}")
    other = ZkCoordinator.from_locator(f"zk://127.0.0.1:{port}")
    try:
        other.create("/app/gone", b"")
        fired = []
        c.watch_delete("/app/gone", fired.append)
        # force the reconnect loop to spin against a dead port while the
        # other client deletes the node
        real_hosts = c._conn.hosts
        c._conn.hosts = [("127.0.0.1", 1)]
        c._conn._sock.shutdown(2)
        assert _wait_until(lambda: not c._conn._up.is_set())
        other.remove("/app/gone")
        c._conn.hosts = real_hosts
        assert _wait_until(lambda: fired == ["/app/gone"])
        assert not c._conn._closed                # session itself survived
    finally:
        c.close()
        other.close()
        srv.stop()


def test_session_expiry_still_fires_session_lost():
    """Genuine server-side expiry during the outage must still take the
    suicide path: resume is answered with session 0, delete watchers
    fire, and the coordinator is dead."""
    srv = FakeZkServer()
    srv.session_grace = 15.0
    port = srv.start(0)
    c = ZkCoordinator.from_locator(f"zk://127.0.0.1:{port}")
    try:
        c.create("/app/me", b"", ephemeral=True)
        fired = []
        c.watch_delete("/app/me", fired.append)
        sid = c._conn.session_id
        # block reconnects while we expire the session server-side
        real_hosts = c._conn.hosts
        c._conn.hosts = [("127.0.0.1", 1)]
        c._conn._sock.shutdown(2)
        assert _wait_until(lambda: not c._conn._up.is_set())
        srv.expire_session(sid)
        c._conn.hosts = real_hosts
        assert _wait_until(lambda: fired == ["/app/me"], timeout=12.0)
        assert c._conn._closed
        with pytest.raises(Exception):
            c.read("/app/me")
    finally:
        c.close()
        srv.stop()


def test_reconnect_soak_randomized():
    """Hundreds of randomized disconnect / delete-
    during-outage / watch-storm cycles against the fake quorum. Invariants
    after every cycle: the session survives (no suicide), the ephemeral
    registration is intact, every delete watcher fires EXACTLY once per
    actual delete (no loss, no double-fire), child watchers keep
    delivering, and neither side leaks watch entries."""
    import random

    srv = FakeZkServer()
    srv.session_grace = 60.0
    port = srv.start(0)
    c = ZkCoordinator.from_locator(f"zk://127.0.0.1:{port}")
    other = ZkCoordinator.from_locator(f"zk://127.0.0.1:{port}")
    rng = random.Random(0xA50C)
    fired: dict = {}          # path -> fire count
    deleted: dict = {}        # path -> expected fire count (1 per delete)
    kid_events = []
    try:
        assert c.create("/soak/me", b"alive", ephemeral=True)
        c.watch_children("/soak/kids", kid_events.append)
        seq = 0
        for cycle in range(250):
            action = rng.randrange(4)
            if action == 0:
                # network blip mid-session; must resume, not suicide
                before = c._conn.reconnect_count
                try:
                    c._conn._sock.shutdown(2)
                except OSError:
                    pass
                assert _wait_until(
                    lambda: c._conn.reconnect_count > before
                    and c._conn._up.is_set()), f"cycle {cycle}: no resume"
            elif action == 1:
                # delete-watched node removed while CONNECTED
                seq += 1
                p = f"/soak/d{seq}"
                other.create(p, b"")
                fired.setdefault(p, 0)
                c.watch_delete(p, lambda q: fired.__setitem__(
                    q, fired.get(q, 0) + 1))
                other.remove(p)
                deleted[p] = deleted.get(p, 0) + 1
            elif action == 2:
                # delete-watched node removed while DISCONNECTED: the
                # re-arm pass must detect the absence and fire exactly once
                seq += 1
                p = f"/soak/d{seq}"
                other.create(p, b"")
                fired.setdefault(p, 0)
                c.watch_delete(p, lambda q: fired.__setitem__(
                    q, fired.get(q, 0) + 1))
                real_hosts = c._conn.hosts
                c._conn.hosts = [("127.0.0.1", 1)]
                try:
                    c._conn._sock.shutdown(2)
                except OSError:
                    pass
                assert _wait_until(lambda: not c._conn._up.is_set())
                other.remove(p)
                deleted[p] = deleted.get(p, 0) + 1
                c._conn.hosts = real_hosts
                assert _wait_until(lambda: c._conn._up.is_set(),
                                   timeout=12.0), f"cycle {cycle}"
            else:
                # child watch storm
                seq += 1
                n = len(kid_events)
                other.create(f"/soak/kids/k{seq}", b"")
                assert _wait_until(lambda: len(kid_events) > n), \
                    f"cycle {cycle}: child watch went dead"
        # drain: every delete observed exactly once, nothing double-fired
        assert _wait_until(
            lambda: all(fired.get(p, 0) == n for p, n in deleted.items()),
            timeout=15.0), {p: (fired.get(p, 0), n)
                            for p, n in deleted.items()
                            if fired.get(p, 0) != n}
        assert all(n == 1 for n in deleted.values())
        # session alive the whole way; registration intact
        assert not c._conn._closed
        assert c.read("/soak/me") == b"alive"
        # no leaked client-side delete watchers (all popped on fire)
        assert not any(c._delete_watchers.get(p) for p in deleted)
        # server-side watch table bounded: only the live watch paths
        # (children + exists re-arms), not one entry per soak cycle
        with srv._lock if hasattr(srv, "_lock") else _null():
            leaked = sum(len(v) for v in srv._watches.values())
        assert leaked < 50, f"server watch table leaked: {leaked}"
    finally:
        c.close()
        other.close()
        srv.stop()


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def test_lock_idgen_contention_soak():
    """Multi-client zkmutex contention + id minting
    under connection churn against the fake quorum (≙ zk_test.cpp's
    trylock/create_id cases, here concurrent and chaotic).

    Four coordinators hammer one lock path and one id path from worker
    threads while the main thread blips random clients' connections
    (network outage, NOT session expiry — session_grace keeps ephemerals,
    so a blip must never silently release a held lock). Invariants:

      * mutual exclusion holds through every blip (no two workers inside
        the critical section; a surviving session keeps the lock node);
      * every client both acquires the lock and mints ids (liveness —
        contention and churn starve nobody out);
      * ids minted concurrently by all clients are globally unique and
        each client observes its own mints strictly increasing
        (create_id's version-counter contract,
        global_id_generator_zk.cpp:32-56)."""
    import random
    import threading

    srv = FakeZkServer()
    srv.session_grace = 60.0
    port = srv.start(0)
    n_clients = 4
    clients = [ZkCoordinator.from_locator(f"zk://127.0.0.1:{port}")
               for _ in range(n_clients)]
    stop = threading.Event()
    inside = [0]              # critical-section occupancy counter
    violations: list = []
    ids = [[] for _ in range(n_clients)]
    acquired = [0] * n_clients
    errors: list = []

    def worker(i: int) -> None:
        c = clients[i]
        rng = random.Random(0x1D6E + i)
        while not stop.is_set():
            try:
                ids[i].append(c.create_id("/soak/idgen"))
            except Exception:  # noqa: BLE001 — mint raced a blip; retry
                time.sleep(0.02)
            got = False
            try:
                got = c.try_lock("/soak/lock")
            except Exception:  # noqa: BLE001 — try_lock raced a blip
                time.sleep(0.02)
            if got:
                inside[0] += 1
                if inside[0] != 1:
                    violations.append((i, inside[0]))
                time.sleep(rng.uniform(0.0, 0.003))
                if inside[0] != 1:
                    violations.append((i, inside[0], "during"))
                inside[0] -= 1
                deadline = time.time() + 15.0
                while time.time() < deadline:
                    try:
                        if c.unlock("/soak/lock"):
                            break
                    except Exception:  # noqa: BLE001 — mid-reconnect
                        pass
                    time.sleep(0.05)
                else:
                    errors.append(f"client {i}: unlock never succeeded")
                    stop.set()
                acquired[i] += 1
            time.sleep(rng.uniform(0.0, 0.002))

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(n_clients)]
    try:
        for t in threads:
            t.start()
        # chaos plane: ~10 blips across random clients over ~7 s; each
        # must resume its session (reconnect_count advances, _up returns)
        rng = random.Random(0xC4A0)
        for blip in range(10):
            time.sleep(0.6)
            c = clients[rng.randrange(n_clients)]
            before = c._conn.reconnect_count
            try:
                c._conn._sock.shutdown(2)
            except OSError:
                pass
            assert _wait_until(
                lambda: c._conn.reconnect_count > before
                and c._conn._up.is_set(), timeout=12.0), \
                f"blip {blip}: client never resumed"
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(timeout=30.0)
        assert not any(t.is_alive() for t in threads), "worker hung"
        assert not errors, errors
        assert not violations, f"mutual exclusion broken: {violations[:5]}"
        assert all(a > 0 for a in acquired), \
            f"a client was starved of the lock: {acquired}"
        assert all(len(x) > 0 for x in ids), "a client minted no ids"
        flat = [v for lst in ids for v in lst]
        assert len(set(flat)) == len(flat), "duplicate ids minted"
        for i, lst in enumerate(ids):
            assert lst == sorted(lst), f"client {i} ids not increasing"
        # the winning sessions never expired (suicide would close conns)
        assert not any(c._conn._closed for c in clients)
    finally:
        stop.set()
        for c in clients:
            c.close()
        srv.stop()


# -- a lost reply around a lock (C11) ------------------------------------------


def _three(port, cls):
    return [cls.from_locator(f"zk://127.0.0.1:{port}") for _ in range(3)]


def test_unlock_after_a_lost_delete_reply_keeps_another_sessions_lock():
    """A blip lost the reply to an applied delete, so ``a`` still counts
    the lock held and retries ``unlock`` after ``b`` took it: the retry
    must not delete ``b``'s node. The JAX coordinator's retry does (C11:
    two holders); the port's removes only its own node."""
    from jubatus_tpu.coord.zk import ZkCoordinator as JZkCoordinator

    srv = FakeZkServer()
    port = srv.start(0)
    held = {}
    try:
        for name, cls in (("port", ZkCoordinator), ("jax", JZkCoordinator)):
            a, b, c = _three(port, cls)
            path = f"/lk/{name}"
            try:
                assert a.try_lock(path)
                assert a.remove(path)        # applied; the reply was lost
                assert b.try_lock(path)
                assert a.unlock(path)        # a's retry of the release
                held[name] = not c.try_lock(path)
            finally:
                for x in (a, b, c):
                    x.close()
    finally:
        srv.stop()
    assert held == {"port": True, "jax": False}


def test_try_lock_after_a_lost_create_reply_takes_back_its_own_node():
    """A blip lost the reply to an applied create, so ``a`` does not know
    it holds the lock: its next ``try_lock`` must take back its own node.
    The JAX coordinator answers False to every session from then on (C11:
    a wedged lock); the port's takes the node back."""
    from jubatus_tpu.coord import zk as jzk

    from jubatus_tpu_torch.coord import zk

    srv = FakeZkServer()
    port = srv.start(0)
    got = {}
    try:
        for name, mod in (("port", zk), ("jax", jzk)):
            a, b, _c = _three(port, mod.ZkCoordinator)
            path = f"/lk2/{name}"
            try:
                a._mkparents(path)
                err, _ = a._create(path, b"", mod.F_EPHEMERAL)
                assert err == mod.ZOK        # applied; the reply was lost
                got[name] = (a.try_lock(path), b.try_lock(path))
            finally:
                for x in (a, b, _c):
                    x.close()
    finally:
        srv.stop()
    assert got == {"port": (True, False), "jax": (False, False)}


# -- the two packages on ZooKeeper -------------------------------------------


def _tree(srv):
    """The fake ensemble's tree: path → (data, version, ephemeral)."""
    with srv._lock:
        return {p: (n.data, n.version, n.owner != 0)
                for p, n in srv.nodes.items()}


def _drive(coord, membership):
    """One fixed sequence of coordinator and membership operations; the
    sequence nodes' names and every answer are returned."""
    out = [
        coord.create("/jubatus/config/classifier/c1", b'{"m": 1}'),
        coord.create("/jubatus/config/classifier/c1", b"dup"),
        coord.set("/jubatus/config/classifier/c1", b"v2"),
        coord.set("/jubatus/config/classifier/new", b"x"),
        coord.remove("/jubatus/config/classifier/new"),
        coord.create_seq("/jubatus/seq/lock-", b"a"),
        coord.create_seq("/jubatus/seq/lock-", b"b"),
        coord.try_lock("/jubatus/actors/classifier/c1/master_lock"),
        coord.create_id("/jubatus/ids/idg"),
        coord.create_id("/jubatus/ids/idg"),
        membership.register_actor(coord, "classifier", "c1", "10.0.0.1",
                                  9199),
        membership.register_active(coord, "classifier", "c1", "10.0.0.1",
                                   9199),
        membership.register_active(coord, "classifier", "c1", "10.0.0.2",
                                   9200),
        membership.unregister_active(coord, "classifier", "c1", "10.0.0.2",
                                     9200),
        membership.register_proxy(coord, "10.0.0.9", 9198),
        coord.unlock("/jubatus/actors/classifier/c1/master_lock"),
        sorted(coord.list("/jubatus/actors/classifier/c1/actives")),
        [n.name for n in membership.get_all_actives(coord, "classifier",
                                                    "c1")],
        membership.get_epoch(coord, "classifier", "c1"),
    ]
    return out


def test_same_operations_leave_the_same_tree_in_both_packages():
    """The same operations through the JAX package's and the port's
    coordinator, each on a fake ensemble of its own, answer alike and
    leave the same tree: paths, data, versions, sequence names and which
    nodes are ephemeral."""
    from jubatus_tpu.coord import membership as jmembership
    from jubatus_tpu.coord.zk import ZkCoordinator as JZkCoordinator

    from jubatus_tpu_torch.coord import membership

    trees, answers = [], []
    for make, mem in ((JZkCoordinator.from_locator, jmembership),
                      (create_coordinator, membership)):
        srv = FakeZkServer()
        port = srv.start(0)
        coord = make(f"zk://127.0.0.1:{port}")
        try:
            answers.append(_drive(coord, mem))
            trees.append(_tree(srv))
        finally:
            coord.close()
            srv.stop()
    assert answers[0] == answers[1]
    assert trees[0] == trees[1]
    assert any(eph for _, _, eph in trees[1].values())
    assert "/jubatus/seq/lock-0000000000" in trees[1]


CONF = {"method": "PA", "parameter": {"regularization_weight": 1.0},
        "converter": {"num_rules": [{"key": "*", "type": "num"}]}}


def _jax_member(locator):
    from jubatus_tpu.server import EngineServer as JEngineServer
    from jubatus_tpu.server.args import ServerArgs as JServerArgs

    srv = JEngineServer("classifier", CONF, JServerArgs(
        engine="classifier", coordinator=locator, name="mixed",
        listen_addr="127.0.0.1", interval_sec=1e9, interval_count=1 << 30,
        microbatch_max=0))
    srv.start(0)
    return srv


def _port_member(locator):
    from jubatus_tpu_torch.server import EngineServer
    from jubatus_tpu_torch.server.args import ServerArgs

    srv = EngineServer("classifier", CONF, ServerArgs(
        engine="classifier", coordinator=locator, name="mixed",
        listen_addr="127.0.0.1", interval_sec=1e9, interval_count=1 << 30,
        microbatch_max=0), device="cpu")
    srv.start(0)
    return srv


def _halves(n=40, seed=5):
    from jubatus_tpu_torch.core.datum import Datum

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        label = "abc"[i % 3]
        feats = {f"f{j}": float(np.round(rng.standard_normal(), 3))
                 for j in rng.choice(12, 4, replace=False)}
        feats["bias"] = {"a": 1.0, "b": -1.0, "c": 0.5}[label]
        rows.append([label, Datum(feats)])
    return rows[0::2], rows[1::2]


def _zk_fleet(members, master):
    """Two members on one fake ensemble train disjoint halves, the master
    mixes; returns (post-mix packs, the actives each member's coordinator
    sees, the master's classify answer)."""
    from jubatus_tpu.coord import membership as jmembership

    from jubatus_tpu_torch.client import ClassifierClient
    from jubatus_tpu_torch.core.datum import Datum

    zk = FakeZkServer()
    locator = f"zk://127.0.0.1:{zk.start(0)}"
    srvs = []
    try:
        srvs = [make(locator) for make in members]
        seen = [sorted(n.name for n in jmembership.get_all_actives(
            s.coord, "classifier", "mixed")) for s in srvs]
        for srv, half in zip(srvs, _halves()):
            with ClassifierClient("127.0.0.1", srv.args.rpc_port,
                                  "mixed") as c:
                assert c.train(half) == len(half)
        with ClassifierClient("127.0.0.1", srvs[master].args.rpc_port,
                              "mixed") as c:
            assert c.do_mix() is True
            answer = c.classify([Datum({"bias": 1.0, "f3": 0.5}),
                                 Datum({"bias": -1.0})])
        return [s.driver.pack() for s in srvs], seen, answer
    finally:
        for s in srvs:
            s.stop()
        zk.stop()


@pytest.mark.parametrize("master", ["jax", "port"])
def test_mixed_fleet_on_one_ensemble_mixes_as_a_jax_fleet(master):
    """A JAX and a port classifier on one fake ensemble see each other's
    ephemerals and mix over RPC to the model (and answers) of a two-JAX
    fleet on another ensemble, bit for bit, with either as master."""
    jax_packs, jax_seen, jax_answer = _zk_fleet(
        [_jax_member, _jax_member], master=0)
    packs, seen, answer = _zk_fleet(
        [_jax_member, _port_member], master=0 if master == "jax" else 1)
    assert len(seen[0]) == 2 and seen[0] == seen[1]
    assert len(jax_seen[0]) == 2
    for got in packs:
        for key in ("w", "prec", "label_counts"):
            assert np.array_equal(np.asarray(got[key]),
                                  np.asarray(jax_packs[0][key])), key
    assert answer == jax_answer


def test_zk_locator_errors_match_the_jax_package():
    """An unreachable ensemble and a malformed locator raise the JAX
    package's CoordinatorError messages."""
    from jubatus_tpu.coord import create_coordinator as jcreate
    from jubatus_tpu.coord.base import CoordinatorError as JCoordinatorError

    for spec in ("zk://127.0.0.1:1", "zk://nohost", "zk://a:1,b"):
        with pytest.raises(CoordinatorError) as mine:
            create_coordinator(spec)
        with pytest.raises(JCoordinatorError) as theirs:
            jcreate(spec)
        assert str(mine.value) == str(theirs.value)
