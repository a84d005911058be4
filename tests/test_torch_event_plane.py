"""The port's event plane and incident bundles
(``jubatus_tpu_torch/utils/events.py``, ``utils/incidents.py``), mirroring
``tests/test_event_plane.py``'s cases that need no proxy and no jubactl:
the HLC, the journal ring, the SLO's and the fault plane's emissions, the
drain's phase events on a server, ``get_events`` / ``get_incidents`` over
the wire, the incident manager's debounce, cap and pull, the plane's rows
in get_status; and the server's three incident triggers (a rollback, an
SLO going to firing, /healthz going from ok to degraded)."""

from __future__ import annotations

import time

import pytest

from jubatus_tpu_torch.utils import events, tracing
from jubatus_tpu_torch.utils.events import (EventJournal, HLCClock, hlc_now,
                                            hlc_wall_s, merge_events,
                                            wall_to_hlc)
from jubatus_tpu_torch.utils.incidents import IncidentManager

CONF = {
    "method": "PA",
    "parameter": {"regularization_weight": 1.0},
    "converter": {"num_rules": [{"key": "*", "type": "num"}]},
}


# -- HLC ----------------------------------------------------------------------


def test_hlc_monotonic_within_one_process():
    c = HLCClock()
    stamps = [c.now() for _ in range(1000)]
    assert stamps == sorted(stamps)
    assert len(set(stamps)) == len(stamps)  # strictly monotonic


def test_hlc_observe_orders_across_skewed_clocks():
    """Node B's wall clock runs BEHIND node A's. Without observation
    B's events would sort before A's; after B receives a message
    carrying A's HLC, B's subsequent events sort after it."""
    ahead, behind = HLCClock(), HLCClock()
    # simulate skew: push 'ahead' far into the future
    future = wall_to_hlc(time.time() + 3600)
    ahead.observe(future)
    a1 = ahead.now()
    b_pre = behind.now()
    assert b_pre < a1  # skew: B's un-connected events sort first
    behind.observe(a1)  # message from A arrives at B
    b_post = behind.now()
    assert b_post > a1  # causality restored despite the hour of skew
    # observe() of an older stamp must not move the clock backwards
    behind.observe(b_pre)
    assert behind.now() > b_post


def test_hlc_wall_roundtrip_and_since_filter():
    t = time.time()
    h = wall_to_hlc(t)
    assert abs(hlc_wall_s(h) - t) < 0.001
    j = EventJournal()
    early = j.emit("t", "early")
    late = j.emit("t", "late")
    assert [r["type"] for r in j.snapshot(since=early["hlc"])] == ["late"]
    assert j.snapshot(since=late["hlc"]) == []


def test_merge_events_skewed_nodes_causal_order():
    """Cross-node merge: a mix master on a fast clock broadcasts its
    HLC; the member's post-apply event sorts after the master's fold
    even though the member's wall clock is behind."""
    master, member = HLCClock(), HLCClock()
    master.observe(wall_to_hlc(time.time() + 1800))  # 30 min ahead
    fold = {"hlc": master.now(), "node": "A", "subsystem": "mix",
            "type": "round"}
    member.observe(fold["hlc"])  # put_diff payload carries it
    applied = {"hlc": member.now(), "node": "B", "subsystem": "mix",
               "type": "applied"}
    merged = merge_events([[applied], [fold]])
    assert [r["type"] for r in merged] == ["round", "applied"]


def test_merge_events_dedups_same_record():
    j = EventJournal()
    j.node = "n1"
    rec = j.emit("t", "x")
    merged = merge_events([[rec], [dict(rec)]])
    assert len(merged) == 1


# -- journal ring -------------------------------------------------------------


def test_journal_ring_bounds_and_eviction():
    reg = tracing.Registry()
    reg.events.set_capacity(5)
    for i in range(12):
        reg.events.emit("t", f"e{i}")
    st = reg.events.stats()
    assert st["emitted"] == 12 and st["retained"] == 5
    assert [r["type"] for r in reg.events.snapshot()] == \
        [f"e{i}" for i in range(7, 12)]
    counters = reg.counters()
    assert counters["event.emitted"] == 12
    assert counters["event.dropped"] == 7  # evictions past capacity


def test_journal_capacity_zero_disables_emission():
    j = EventJournal(capacity=0)
    assert not j.enabled
    assert j.emit("t", "x") is None
    assert j.snapshot() == [] and j.stats()["emitted"] == 0


def test_journal_grep_and_trace_capture():
    j = EventJournal()
    ctx = tracing.new_root()
    with tracing.use_trace(ctx):
        j.emit("breaker", "open", backend="10.0.0.1:9199")
    j.emit("slo", "firing", name="lat.p99")
    assert [r["type"] for r in j.snapshot(grep="10.0.0.1")] == ["open"]
    assert j.snapshot(grep="nomatch") == []
    rec = j.snapshot(grep="open")[0]
    assert rec["trace_id"] == ctx.trace_id


# -- per-subsystem emission ---------------------------------------------------


def test_slo_fire_and_clear_emit():
    from jubatus_tpu_torch.utils.slo import SloEngine, parse_slo
    from jubatus_tpu_torch.utils.timeseries import TimeSeriesRing

    reg = tracing.Registry()
    ring = TimeSeriesRing(capacity=16)
    eng = SloEngine([parse_slo("latency:rpc.x:p99:50")], ring, reg,
                    fast_window_s=10.0, slow_window_s=20.0)
    fired = []
    eng.on_fire = lambda name, st: fired.append(name)
    for _ in range(10):
        reg.record("rpc.x", 0.001)
    ring.sample(reg.snapshot(), ts=0.0)
    for _ in range(50):
        reg.record("rpc.x", 0.5)
    ring.sample(reg.snapshot(), ts=5.0)
    eng.evaluate(now=5.0)
    kinds = [r["type"] for r in reg.events.snapshot()
             if r["subsystem"] == "slo"]
    assert kinds == ["firing"]
    assert fired == ["rpc.x.p99"]  # incident hook ran exactly once
    # recovery clears -> resolved edge, no second on_fire
    for _ in range(2000):
        reg.record("rpc.x", 0.001)
    ring.sample(reg.snapshot(), ts=10.0)
    ring.sample(reg.snapshot(), ts=15.0)
    eng.evaluate(now=15.0)
    kinds = [r["type"] for r in reg.events.snapshot()
             if r["subsystem"] == "slo"]
    assert kinds == ["firing", "resolved"]
    assert fired == ["rpc.x.p99"]


def test_fault_arm_and_fire_emit():
    from jubatus_tpu_torch.utils import faults

    cur = hlc_now()
    with faults.armed("evtest.site:error@1"):
        with pytest.raises(faults.FaultInjected):
            faults.fire("evtest.site")
    recs = [r for r in events.default_journal().snapshot(since=cur)
            if r["subsystem"] == "faults"]
    assert [r["type"] for r in recs] == ["armed", "fired"]
    assert recs[0]["rules"] == ["evtest.site:error@1"]
    assert recs[1]["site"] == "evtest.site"
    assert recs[1]["action"] == "error"


def test_incident_manager_debounce_cap_and_pull(tmp_path):
    reg = tracing.Registry()
    mgr = IncidentManager(reg, lambda: {"events": [], "extra": "x"},
                          lambda: str(tmp_path / "inc"), window_s=300.0,
                          capacity=3, journal=reg.events)
    first = mgr.trigger("slo_firing:a", trace_ids=["t1", "t2"])
    assert first is not None and first["id"].startswith("inc-")
    # debounced inside the window
    assert mgr.trigger("slo_firing:a") is None
    st = mgr.stats()
    assert st["captured"] == 1 and st["suppressed"] == 1
    assert reg.counters()["incident.captured"] == 1
    assert reg.counters()["incident.suppressed"] == 1
    # the capture itself is a timeline event
    assert [r["type"] for r in reg.events.snapshot()
            if r["subsystem"] == "incident"] == ["captured"]
    # force captures pierce the window; the dir cap prunes oldest
    ids = [first["id"]]
    for i in range(4):
        doc = mgr.trigger(f"manual:{i}", force=True)
        ids.append(doc["id"])
    listing = mgr.list()
    kept = [m["id"] for m in listing["incidents"]]
    assert len(kept) == 3 and kept == ids[-3:]
    # pull returns the full doc with the correlated trace ids
    pulled = mgr.get(ids[-1])
    assert pulled["reason"] == "manual:3" and pulled["extra"] == "x"
    assert "error" in mgr.get("inc-nope")
    assert "error" in mgr.get("../evil")


# -- servers -------------------------------------------------------------------


def _server(tmp_path, **flags):
    from jubatus_tpu_torch.server import EngineServer
    from jubatus_tpu_torch.server.args import ServerArgs

    flags.setdefault("telemetry_interval", 0)
    srv = EngineServer("classifier", CONF, ServerArgs(
        engine="classifier", listen_addr="127.0.0.1",
        datadir=str(tmp_path), **flags), device="cpu")
    srv.start(0)
    return srv


def test_drain_phase_events_via_server(tmp_path):
    """The drain state machine's phase edges land in the server's journal
    (draining -> handoff -> drained)."""
    srv = _server(tmp_path, coordinator=str(tmp_path / "coord"), name="evd",
                  interval_sec=1e9, interval_count=1 << 30, drain_grace=0.05)
    try:
        srv.drain_ctl.start()
        deadline = time.monotonic() + 20
        while srv.drain_ctl.state != "drained" and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        assert srv.drain_ctl.state == "drained"
        kinds = [r["type"] for r in srv.trace.events.snapshot()
                 if r["subsystem"] == "drain"]
        assert kinds == ["draining", "handoff", "drained"]
    finally:
        srv.stop()


def test_get_events_and_incidents_over_the_wire(tmp_path):
    """get_events / get_incidents answer plain and traced/deadlined
    envelopes, keyed by node; the since cursor and grep filter."""
    from jubatus_tpu_torch.rpc import deadline as deadlines
    from jubatus_tpu_torch.rpc.client import RpcClient

    srv = _server(tmp_path)
    port = srv.rpc.port
    try:
        marker = srv.trace.events.emit("t", "wire_probe", n=1)
        with RpcClient("127.0.0.1", port) as rc:
            doc = rc.call("get_events", "", 0, "")
            assert list(doc) == [srv._node_key()]
            (d,) = doc.values()
            assert any(r["type"] == "wire_probe" for r in d["events"])
            assert d["hlc_now"] > marker["hlc"]
            assert d["stats"]["capacity"] == 2048
            newest = max(r["hlc"] for r in d["events"])
            (d2,) = rc.call("get_events", "", newest, "").values()
            assert d2["events"] == []
            (dg,) = rc.call("get_events", "", 0, "wire_probe").values()
            assert [r["type"] for r in dg["events"]] == ["wire_probe"]
            (di,) = rc.call("get_incidents", "", "").values()
            assert di["incidents"] == [] and "stats" in di
        ctx = tracing.new_root()
        with tracing.use_trace(ctx), deadlines.deadline_after(30.0):
            with RpcClient("127.0.0.1", port) as rc:
                (d3,) = rc.call("get_events", "", 0, "").values()
        assert any(r["type"] == "wire_probe" for r in d3["events"])
    finally:
        srv.stop()


def test_get_events_merges_the_process_journal(tmp_path):
    """A process-scoped emission (a fault arming) shows under the
    server's get_events beside its own journal, in HLC order."""
    from jubatus_tpu_torch.utils import faults

    srv = _server(tmp_path)
    try:
        cur = hlc_now()
        srv.trace.events.emit("t", "mine")
        with faults.armed("evtest.merge:delay:0"):
            pass
        (d,) = srv.get_events("", cur, "").values()
        kinds = [(r["subsystem"], r["type"]) for r in d["events"]]
        assert ("t", "mine") in kinds and ("faults", "armed") in kinds
        hlcs = [r["hlc"] for r in d["events"]]
        assert hlcs == sorted(hlcs)
    finally:
        srv.stop()


def test_event_and_incident_stats_in_get_status(tmp_path):
    srv = _server(tmp_path, event_capacity=128)
    try:
        (st,) = srv.get_status("").values()
        assert st["events.capacity"] == 128
        assert st["incident.window_s"] == 300.0
        assert "events.emitted" in st and "incident.captured" in st
        assert srv._health()["incidents_captured"] == 0
    finally:
        srv.stop()


def test_event_capacity_zero_disables_the_journal(tmp_path):
    srv = _server(tmp_path, event_capacity=0)
    try:
        assert srv.trace.events.emit("t", "x") is None
        (d,) = srv.get_events("", 0, "").values()
        assert not any(r.get("node") == srv.trace.events.node
                       for r in d["events"])
    finally:
        srv.stop()


def test_rollback_captures_an_incident_bundle(tmp_path):
    """A rollback is a forensics moment: one bundle under --incident-dir,
    listed and pulled through get_incidents."""
    from jubatus_tpu_torch.core.datum import Datum

    inc_dir = tmp_path / "incidents"
    srv = _server(tmp_path, incident_dir=str(inc_dir))
    try:
        srv.driver.train([("a", Datum({"x": 1.0}))])
        srv.take_snapshot()
        out = srv.rollback("", "drill")
        assert out["rolled_back"] is True
        (listing,) = srv.get_incidents("", "").values()
        (meta,) = listing["incidents"]
        (doc,) = srv.get_incidents("", meta["id"]).values()
        assert doc["reason"] == "rollback:drill"
        assert doc["node"] == srv._node_key()
        assert "slow_log" in doc and "health" in doc and "events" in doc
        assert "timeseries" in doc and "quality" in doc and "usage" in doc
        assert (inc_dir / f"{meta['id']}.json").exists()
        kinds = [r["type"] for r in srv.trace.events.snapshot()
                 if r["subsystem"] == "incident"]
        assert kinds == ["captured"]
    finally:
        srv.stop()


def test_healthz_going_degraded_captures_one_bundle(tmp_path):
    """/healthz going from ok to degraded (here a drain) bundles one
    incident at the next tick; staying degraded bundles no more."""
    srv = _server(tmp_path, incident_window=0.001)
    try:
        srv._model_health_tick()
        assert srv.incidents.stats()["captured"] == 0
        srv.drain_ctl.state = "draining"
        srv._model_health_tick()
        assert srv.incidents.stats()["captured"] == 1
        assert srv.incidents.last_id
        (doc,) = srv.get_incidents("", srv.incidents.last_id).values()
        assert doc["reason"] == "healthz_degraded:draining"
        srv._model_health_tick()
        assert srv.incidents.stats()["captured"] == 1
    finally:
        srv.drain_ctl.state = "active"
        srv.stop()
