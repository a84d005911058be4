"""Elastic membership on the port's server: the epoch protocol, drain,
and the row migration plane, on the CPU.

Mirrors ``tests/test_elastic.py`` (epoch bumps, the wire codes, the stale
epoch refusal, the double-dispatch union, drain under traffic, the
serve_range cursor walk, failover after a source dies mid-stream, a full
join → migrate → drain cycle, the quorum without draining members, the
status keys) against the port; its proxy and ``jubactl`` tests wait for
the proxy. Then the two packages: ``serve_range`` gives the same chunks
and cursors in both for the same rows and ring, and a port server pulls
rows from a JAX server and hands rows off to one, and the other way
round, with the moved rows answering ``neighbor_row_from_id`` as at their
source. Drains are waited for by joining the drain thread, not by
polling a clock.
"""

from __future__ import annotations

import threading

import pytest

from jubatus_tpu.coord.base import NodeInfo as JNodeInfo
from jubatus_tpu.coord.cht import CHT as JCHT
from jubatus_tpu.coord.file import FileCoordinator as JFileCoordinator
from jubatus_tpu.framework import migration as jax_migration
from jubatus_tpu.models.nearest_neighbor import \
    NearestNeighborDriver as JNearestNeighborDriver
from jubatus_tpu.rpc import errors as jax_errors
from jubatus_tpu.server import EngineServer as JEngineServer
from jubatus_tpu.server.args import ServerArgs as JServerArgs
from jubatus_tpu_torch.coord import membership
from jubatus_tpu_torch.coord.base import NodeInfo
from jubatus_tpu_torch.coord.cht import CHT, ring_key
from jubatus_tpu_torch.coord.file import FileCoordinator
from jubatus_tpu_torch.coord.memory import MemoryCoordinator, _Store
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.framework import migration
from jubatus_tpu_torch.framework.linear_mixer import RpcLinearCommunication
from jubatus_tpu_torch.models.nearest_neighbor import NearestNeighborDriver
from jubatus_tpu_torch.rpc.client import NearestNeighborClient, RpcClient
from jubatus_tpu_torch.rpc.errors import (EPOCH_MISMATCH_ERROR,
                                          NODE_DRAINING_ERROR, EpochMismatch,
                                          NodeDraining, error_to_wire,
                                          is_retryable, wire_to_error)
from jubatus_tpu_torch.server import EngineServer
from jubatus_tpu_torch.server.args import ServerArgs, parse_server_args

WAIT_S = 30.0
ENGINE = "nearest_neighbor"
NAME = "nn"
CONF = {"method": "lsh", "parameter": {"hash_num": 8},
        "converter": {"num_rules": [{"key": "*", "type": "num"}]}}


def _args(**kw):
    base = dict(engine=ENGINE, coordinator="(shared)", name=NAME,
                listen_addr="127.0.0.1", interval_sec=1e9,
                interval_count=1 << 30, drain_grace=0.05, thread=4)
    base.update(kw)
    return base


def _boot(store, **kw):
    srv = EngineServer(ENGINE, CONF, ServerArgs(**_args(**kw)),
                       device="cpu", coord=MemoryCoordinator(store))
    srv.start(0)
    if srv.join_thread is not None:
        srv.join_thread.join(WAIT_S)
    return srv


def _client(srv) -> RpcClient:
    return RpcClient("127.0.0.1", srv.args.rpc_port, timeout=30.0)


def _datum(i: int) -> Datum:
    return Datum({"f0": float(i) + 1.0, "f1": float(i % 7) + 1.0})


def _drained(srv) -> str:
    """Wait for the drain thread to finish; its final state."""
    srv.drain_ctl._thread.join(WAIT_S)
    return srv.drain_ctl.status()["state"]


def _ids(rows):
    return {i.decode() if isinstance(i, bytes) else i for i in rows}


# -- epoch protocol ------------------------------------------------------------

def test_epoch_bumps_on_actual_join_and_leave_only():
    store = _Store()
    c = MemoryCoordinator(store)
    assert membership.get_epoch(c, ENGINE, NAME) == 0
    membership.register_active(c, ENGINE, NAME, "127.0.0.1", 9000)
    assert membership.get_epoch(c, ENGINE, NAME) == 1
    # re-registration (the post-put_diff self-promotion) is no change
    membership.register_active(c, ENGINE, NAME, "127.0.0.1", 9000)
    assert membership.get_epoch(c, ENGINE, NAME) == 1
    membership.register_active(c, ENGINE, NAME, "127.0.0.1", 9001)
    assert membership.get_epoch(c, ENGINE, NAME) == 2
    membership.unregister_active(c, ENGINE, NAME, "127.0.0.1", 9000)
    assert membership.get_epoch(c, ENGINE, NAME) == 3
    membership.unregister_active(c, ENGINE, NAME, "127.0.0.1", 9000)
    assert membership.get_epoch(c, ENGINE, NAME) == 3
    ring = CHT.from_coordinator(c, ENGINE, NAME)
    assert ring.epoch == 3
    assert ring.key == ring_key(ring.members)


def test_epoch_bumps_when_servers_join_and_drain():
    store = _Store()
    s1 = _boot(store)
    s2 = _boot(store)
    try:
        view = MemoryCoordinator(store)
        assert membership.get_epoch(view, ENGINE, NAME) == 2
        assert s1.get_epoch() == 2
        with _client(s1) as cli:
            cli.call("drain", NAME, False)
        assert _drained(s1) == "drained"
        # drain = one leave -> one bump; the marker is set then cleared
        assert membership.get_epoch(view, ENGINE, NAME) == 3
        assert membership.get_draining(view, ENGINE, NAME) == []
    finally:
        s1.stop()
        s2.stop()


def test_wire_codes_round_trip_and_are_retryable():
    assert error_to_wire(NodeDraining()) == NODE_DRAINING_ERROR
    assert error_to_wire(EpochMismatch()) == EPOCH_MISMATCH_ERROR
    nd = wire_to_error(NODE_DRAINING_ERROR, "set_row")
    em = wire_to_error(EPOCH_MISMATCH_ERROR, "migrate_range")
    assert isinstance(nd, NodeDraining) and is_retryable(nd)
    assert isinstance(em, EpochMismatch) and is_retryable(em)
    # the JAX package's codes: a refusal from either server reads the
    # same in either client
    assert NODE_DRAINING_ERROR == jax_errors.NODE_DRAINING_ERROR
    assert EPOCH_MISMATCH_ERROR == jax_errors.EPOCH_MISMATCH_ERROR


def test_migrate_range_rejects_stale_epoch():
    store = _Store()
    s1 = _boot(store)
    s2 = _boot(store)
    try:
        with _client(s1) as cli:
            good = cli.call("migrate_range", NAME, s1.get_epoch(),
                            s2.self_nodeinfo().name, "", 1 << 20)
            assert good.get("done") is True
            with pytest.raises(EpochMismatch):
                cli.call("migrate_range", NAME, s1.get_epoch() + 17,
                         s2.self_nodeinfo().name, "", 1 << 20)
    finally:
        s1.stop()
        s2.stop()


def test_double_dispatch_union_leaves_no_key_without_owners():
    """For any single join/leave, every key's owners under the old and
    the new ring together hold at least one member of each ring."""
    base = [NodeInfo("10.0.0.1", 1), NodeInfo("10.0.0.2", 2),
            NodeInfo("10.0.0.3", 3)]
    scenarios = [
        (base, base + [NodeInfo("10.0.0.4", 4)]),       # join
        (base, base[:-1]),                               # leave
        (base, base[:-1] + [NodeInfo("10.0.0.5", 5)]),   # replace
    ]
    for old_members, new_members in scenarios:
        old, new = CHT(old_members), CHT(new_members)
        live = {m.name for m in new_members}
        stale = {m.name for m in old_members}
        for i in range(200):
            key = f"k{i}"
            union = {n.name for n in new.find(key, 2)} \
                | {n.name for n in old.find(key, 2)}
            assert union & live, f"key {key}: no live owner in union"
            assert union & stale, f"key {key}: old owners dropped"


# -- drain under traffic -------------------------------------------------------

def test_drain_rejects_new_effectful_finishes_inflight():
    store = _Store()
    s1 = _boot(store, drain_grace=0.5)
    s2 = _boot(store)
    cli, cli2 = _client(s1), _client(s1)
    try:
        cli.call("set_row", NAME, "pre", _datum(0).to_msgpack())
        # the NEXT set_row is held: in flight when the gate flips, it
        # must still complete
        release, entered = threading.Event(), threading.Event()
        real = s1.driver.set_row

        def slow_set_row(rid, datum):
            entered.set()
            release.wait(WAIT_S)
            return real(rid, datum)

        s1.driver.set_row = slow_set_row
        result: dict = {}

        def inflight():
            try:
                result["ok"] = cli2.call("set_row", NAME, "inflight",
                                         _datum(1).to_msgpack())
            except Exception as e:  # noqa: BLE001 — asserted below
                result["err"] = e

        t = threading.Thread(target=inflight, daemon=True)
        t.start()
        assert entered.wait(WAIT_S)
        cli.call("drain", NAME, False)
        assert cli.call("drain_status", NAME)["state"] in (
            "draining", "handoff", "drained")
        # NEW effectful work is refused with the retryable NodeDraining
        with pytest.raises(NodeDraining):
            cli.call("set_row", NAME, "rejected", _datum(2).to_msgpack())
        assert s1.trace.counters().get("rpc.drain_rejected", 0) >= 1
        # reads keep answering through the gate (get_config: this read
        # takes no model lock, which the held call keeps)
        assert cli.call("get_config", NAME)
        release.set()
        t.join(WAIT_S)
        assert result.get("ok") is True
        assert isinstance(cli.call("get_all_rows", NAME), list)
        assert _drained(s1) == "drained"
        # ... and the in-flight row was handed to the survivor
        with _client(s2) as c2:
            ids = _ids(c2.call("get_all_rows", NAME))
        assert {"pre", "inflight"} <= ids
        assert "rejected" not in ids
    finally:
        cli.close()
        cli2.close()
        s1.stop()
        s2.stop()


# -- migration data plane ------------------------------------------------------

def test_serve_range_cursor_resume_and_chunking():
    d = NearestNeighborDriver(CONF, device="cpu")
    for i in range(50):
        d.set_row(f"row{i:03d}", _datum(i))
    ring = CHT([NodeInfo("10.0.0.1", 1), NodeInfo("10.0.0.2", 2)])
    target = "10.0.0.1_1"
    owned = [rid for rid in sorted(d.row_ids())
             if migration.row_owned_by(ring, rid, target)]
    got, cursor, chunks = [], "", 0
    while True:
        doc = migration.serve_range(d, ring, target, cursor, limit_bytes=1)
        got.extend(r[0] for r in doc["rows"])
        chunks += 1
        if doc["done"]:
            break
        assert doc["cursor"] > cursor
        cursor = doc["cursor"]
    assert got == owned
    assert chunks >= len(owned)  # 1-byte budget = 1 row per chunk
    mid = owned[len(owned) // 2]
    doc = migration.serve_range(d, ring, target, mid, limit_bytes=1 << 20)
    assert [r[0] for r in doc["rows"]] == [rid for rid in owned if rid > mid]


@pytest.mark.parametrize("limit", [1, 200, 1 << 12, 1 << 23])
def test_serve_range_chunks_and_cursors_are_the_jax_packages(limit):
    """The same rows and ring give the same chunks, rows and cursors in
    both packages, at every byte budget (a JAX puller and a port source
    walk one sequence)."""
    pd = NearestNeighborDriver(CONF, device="cpu")
    jd = JNearestNeighborDriver(CONF)
    for i in range(120):
        for d in (pd, jd):
            d.set_row(f"r{(i * 37) % 1000:04d}", _datum(i))
    names = [("10.0.0.1", 1), ("10.0.0.2", 2), ("10.0.0.3", 3)]
    ring = CHT([NodeInfo(h, p) for h, p in names])
    jring = JCHT([JNodeInfo(h, p) for h, p in names])
    for target in ("10.0.0.1_1", "10.0.0.3_3"):
        cursor = ""
        while True:
            got = migration.serve_range(pd, ring, target, cursor, limit)
            want = jax_migration.serve_range(jd, jring, target, cursor,
                                             limit)
            assert got["cursor"] == want["cursor"]
            assert got["done"] == want["done"]
            assert [r[:3] for r in got["rows"]] == \
                [[r[0], list(r[1]), list(r[2])] for r in want["rows"]]
            if got["done"]:
                break
            cursor = got["cursor"]


def test_migration_resumes_after_midstream_source_crash():
    """Kill a source after its first chunk: the puller fails over and
    coverage holds, the rows being CHT(2)-replicated onto the dead
    source's ring successor."""
    store = _Store()
    servers = [_boot(store, auto_rebalance=False) for _ in range(3)]
    joiner = _boot(store, auto_rebalance=False)
    try:
        nodes = [s.self_nodeinfo() for s in servers]
        ring = CHT(nodes)
        clients = {s.self_nodeinfo().name: _client(s) for s in servers}
        all_rows = [f"row{i:03d}" for i in range(60)]
        for rid in all_rows:
            for owner in ring.find(rid, 2):
                clients[owner.name].call(
                    "set_row", NAME, rid, _datum(int(rid[3:])).to_msgpack())
        me = joiner.self_nodeinfo()
        victim = servers[0]
        victim_name = victim.self_nodeinfo().name
        chunk_log = []

        def apply_rows(rows):
            chunk_log.append(len(rows))
            with joiner.driver.lock:
                n = joiner.driver.put_rows(rows)
            if len(chunk_log) == 1:
                victim.stop()  # mid-stream crash after the first chunk
            return n

        puller = migration.RangePuller(
            NAME, me.name, apply_rows,
            client_factory=joiner.peer_client, stats=joiner.migration,
            chunk_bytes=64, epoch_of=lambda: joiner.get_epoch())
        out = puller.pull([victim.self_nodeinfo()] + nodes[1:])
        assert out["sources_failed"] == [victim_name]
        assert joiner.migration.snapshot()["failovers"] >= 1
        new_ring = CHT(nodes[1:] + [me])
        expected = {rid for rid in all_rows
                    if migration.row_owned_by(new_ring, rid, me.name)}
        assert expected <= set(joiner.driver.row_ids())
        for c in clients.values():
            c.close()
    finally:
        for s in servers + [joiner]:
            s.stop()


def test_full_cycle_join_migrate_leave_row_parity():
    """Zero rows lost across a join -> migrate -> leave cycle, with
    row-count parity between get_rows and put_rows."""
    store = _Store()
    s1 = _boot(store)
    s2 = _boot(store)
    servers = [s1, s2]
    try:
        total = 80
        with _client(s1) as c1, _client(s2) as c2:
            for i in range(total):
                (c1 if i % 2 == 0 else c2).call(
                    "set_row", NAME, f"row{i:03d}", _datum(i).to_msgpack())
        with s1.driver.lock:
            rows = s1.driver.get_rows()
        scratch = NearestNeighborDriver(CONF, device="cpu")
        assert scratch.put_rows(rows) == len(rows) == len(s1.driver.row_ids())
        assert sorted(scratch.row_ids()) == sorted(s1.driver.row_ids())
        # join: the new member pulls its owned ranges on its own
        s3 = _boot(store)
        servers.append(s3)
        assert s3.migration.snapshot()["pulls"] >= 1
        assert s3.migration.snapshot()["active"] == 0
        assert s3.migration.snapshot()["rows_moved"] > 0
        s1.drain(NAME, False)
        assert _drained(s1) == "drained"
        union = set()
        for s in servers[1:]:
            with _client(s) as c:
                union |= _ids(c.call("get_all_rows", NAME))
        assert {f"row{i:03d}" for i in range(total)} - union == set()
    finally:
        for s in servers:
            s.stop()


def test_mixer_quorum_excludes_draining_members():
    store = _Store()
    c = MemoryCoordinator(store)
    for port in (9000, 9001, 9002):
        membership.register_actor(c, ENGINE, NAME, "127.0.0.1", port)
        membership.register_active(c, ENGINE, NAME, "127.0.0.1", port)
    comm = RpcLinearCommunication(MemoryCoordinator(store), ENGINE, NAME)
    assert len(comm.update_members()) == 3
    assert comm.membership_epoch() == 3
    membership.mark_draining(c, ENGINE, NAME, "127.0.0.1", 9000)
    members = comm.update_members()
    assert len(members) == 2
    assert "127.0.0.1_9000" not in {m.name for m in members}
    comm.close()


def test_status_carries_epoch_drain_state_and_migration():
    store = _Store()
    s1 = _boot(store)
    s2 = _boot(store)
    try:
        with _client(s1) as cli:
            doc = next(iter(cli.call("get_status", NAME).values()))
            assert cli.call("get_row_count", NAME) == 0
        assert doc.get("cluster.epoch") == 2
        assert doc.get("drain.state") == "active"
        assert "migration.rows_moved" in doc
    finally:
        s1.stop()
        s2.stop()


def test_server_args_elastic_flags():
    args = parse_server_args(["nearest_neighbor", "-f", "/dev/null",
                              "--no-auto-rebalance", "--drain-grace", "2.5"])
    assert args.auto_rebalance is False and args.drain_grace == 2.5
    args = parse_server_args(["nearest_neighbor", "-f", "/dev/null"])
    assert args.auto_rebalance is True and args.drain_grace == 1.0


def test_standalone_drain_is_a_no_op():
    srv = EngineServer(ENGINE, CONF, ServerArgs(engine=ENGINE,
                                                listen_addr="127.0.0.1"),
                       device="cpu")
    srv.start(0)
    try:
        assert srv.drain(NAME)["state"] == "active"
        assert srv.rebalance(NAME)["rows"] == 0
        assert srv.get_epoch() == 0
    finally:
        srv.stop()


# -- one fleet of both packages --------------------------------------------------

def _member(pkg, coord_dir, **kw):
    if pkg == "jax":
        srv = JEngineServer(ENGINE, CONF, JServerArgs(
            telemetry_interval=0, **_args(**kw)),
            coord=JFileCoordinator(coord_dir))
    else:
        srv = EngineServer(ENGINE, CONF, ServerArgs(**_args(**kw)),
                           device="cpu", coord=FileCoordinator(coord_dir))
    srv.start(0)
    return srv


def _neighbors(srv, rid):
    with NearestNeighborClient("127.0.0.1", srv.args.rpc_port, NAME) as c:
        return [[_ids([i]).pop(), float(s)]
                for i, s in c.neighbor_row_from_id(rid, 5)]


def _same_neighbors(got, want):
    """lsh distances are equal across the packages; ids are equal up to
    ties at the k-th distance."""
    assert [s for _, s in got] == [s for _, s in want]
    edge = want[-1][1]
    assert {i for i, s in got if s != edge} == \
        {i for i, s in want if s != edge}


@pytest.mark.parametrize("mode", ["pull", "drain"])
@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_rows_move_between_the_packages(src, dst, mode, tmp_path):
    """A server of one package holds the rows; a server of the other
    joins and pulls them (``rebalance``), or the holder drains and hands
    them off (``put_rows``). Two members own every row (CHT(2)), so the
    receiver ends with all of them, answering neighbor_row_from_id as the
    source did."""
    coord_dir = str(tmp_path / "coord")
    source = _member(src, coord_dir, auto_rebalance=False)
    dest = None
    try:
        rows = [f"row{i:03d}" for i in range(40)]
        with NearestNeighborClient("127.0.0.1", source.args.rpc_port,
                                   NAME) as c:
            for i, rid in enumerate(rows):
                c.set_row(rid, _datum(i))
        want = {rid: _neighbors(source, rid) for rid in rows[::7]}
        dest = _member(dst, coord_dir, auto_rebalance=False)
        # the file coordinator's watch polls; invalidate the source's ring
        # view as its actives watch would, so both sides agree on the epoch
        source._invalidate_cht()
        if mode == "pull":
            out = dest.rebalance(NAME)
            assert out["rows"] == len(rows) and not out["sources_failed"]
        else:
            source.drain(NAME, False)
            source.drain_ctl._thread.join(WAIT_S)
            st = source.drain_ctl.status()
            assert st["state"] == "drained" and not st["error"]
            assert st["rows_handed_off"] == len(rows)
        assert sorted(dest.driver.row_ids()) == rows
        for rid, ans in want.items():
            _same_neighbors(_neighbors(dest, rid), ans)
    finally:
        for s in (source, dest):
            if s is not None:
                s.stop()
