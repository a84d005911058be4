"""The port jubactl's observability views (jubatus_tpu_torch/cmd/jubactl.py)
on port fleets on the CPU, mirroring tests/test_metrics_plane.py (the
merged metrics view), tests/test_trace_forensics.py (``-c trace`` renders
one tree), tests/test_profiler.py (the cluster-folded profile, the table
and ``--device``), tests/test_model_health.py (``watch --once`` and
``status --all``) and tests/test_event_plane.py (the ``--follow`` cursors,
an SLO breach captured as one bundle and rendered by ``timeline``,
``incident`` and ``watch``); then parity with the JAX package's jubactl:
the same seeded docs through both packages' pure renderers give the same
text, ``status --all`` prints the same ANN line for an ``--ann ivf``
member, and both jubactls print the same ``quality`` and ``usage`` views
of a port proxy before one JAX and one port member."""

from __future__ import annotations

import io
import json
import re
import threading
import time

import numpy as np
import pytest

from jubatus_tpu.cmd import jubactl as jctl
from jubatus_tpu_torch.cmd import jubactl
from jubatus_tpu_torch.coord import create_coordinator
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.rpc import principal as principals
from jubatus_tpu_torch.rpc.client import ClassifierClient, RpcClient
from jubatus_tpu_torch.server import EngineServer
from jubatus_tpu_torch.server.args import ServerArgs
from jubatus_tpu_torch.server.proxy import Proxy, ProxyArgs
from jubatus_tpu_torch.utils import tracing

CONF = {
    "method": "PA",
    "parameter": {"regularization_weight": 1.0},
    "converter": {"num_rules": [{"key": "*", "type": "num"}]},
}


def _server(coord_dir, name, tmp_path, **flags):
    # the stack sampler off unless a test reads it: it would only load the
    # host the other test files share
    flags.setdefault("profile_hz", 0)
    srv = EngineServer("classifier", CONF, ServerArgs(
        engine="classifier", coordinator=coord_dir, name=name,
        listen_addr="127.0.0.1", interval_sec=1e9, interval_count=1 << 30,
        datadir=str(tmp_path), **flags), device="cpu")
    srv.start(0)
    return srv


def _proxy(coord_dir, **flags):
    flags.setdefault("profile_hz", 0)
    p = Proxy(ProxyArgs(engine="classifier", listen_addr="127.0.0.1",
                        coordinator=coord_dir, **flags))
    p.start(0)
    return p


def _node(x) -> str:
    return f"127.0.0.1_{x.args.rpc_port}"


# -- tests/test_metrics_plane.py ---------------------------------------------

def test_jubactl_metrics_merged_view(tmp_path, capsys):
    """jubactl metrics against a 3-member cluster prints merged p50/p99
    for rpc.* and mix.round."""
    coord_dir = str(tmp_path / "coord")
    servers = [_server(coord_dir, "jm", tmp_path) for _ in range(3)]
    try:
        for s in servers:
            with ClassifierClient("127.0.0.1", s.args.rpc_port, "jm") as c:
                c.train([["a", Datum({"x": 1.0})],
                         ["b", Datum({"x": -1.0})]])
        assert servers[0].mixer.mix_now() is not None
        rc = jubactl.main(["-c", "metrics", "-t", "classifier", "-n", "jm",
                           "-z", coord_dir])
        out = capsys.readouterr().out
        assert rc == 0
        assert "merged metrics from 3 node(s)" in out
        assert "p50_ms" in out and "p99_ms" in out
        assert "rpc.train" in out
        assert "mix.round" in out
    finally:
        for s in servers:
            s.stop()


# -- tests/test_trace_forensics.py ---------------------------------------------

def test_jubactl_trace_renders_tree(tmp_path, capsys):
    """jubactl -c trace TRACE_ID against a live 1-proxy/2-backend cluster
    prints ONE assembled tree with the proxy's and the backends' spans."""
    coord_dir = str(tmp_path / "coord")
    servers = [_server(coord_dir, "jt", tmp_path) for _ in range(2)]
    proxy = _proxy(coord_dir)
    try:
        ctx = tracing.new_root()
        with tracing.use_trace(ctx), \
                RpcClient("127.0.0.1", proxy.args.rpc_port) as c:
            assert c.call("get_status", "jt")
        rc = jubactl.main(["-c", "trace", "-t", "classifier", "-n", "jt",
                           "-z", coord_dir, ctx.trace_id])
        out = capsys.readouterr().out
        assert rc == 0
        assert f"trace {ctx.trace_id}" in out
        assert "1 root(s)" in out, out
        assert "rpc.get_status" in out and "rpc.client.get_status" in out
        assert "ms  @127.0.0.1_" in out and "[t+" in out
        for srv in servers:
            assert _node(srv) in out
        assert _node(proxy) in out
        # an unknown trace id: a graceful nonzero exit
        assert jubactl.main(["-c", "trace", "-t", "classifier", "-n", "jt",
                             "-z", coord_dir, "feedfacefeedface"]) == -1
    finally:
        proxy.stop()
        for s in servers:
            s.stop()


# -- tests/test_profiler.py -------------------------------------------------------

@pytest.fixture()
def profile_cluster(tmp_path):
    coord_dir = str(tmp_path / "coord")
    servers = [_server(coord_dir, "pf", tmp_path, profile_hz=67.0)
               for _ in range(2)]
    proxy = _proxy(coord_dir, profile_hz=67.0)
    try:
        # every node's sampler lands at least one sample
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not all(
                x.profiler.stats()["samples"] > 0
                for x in [*servers, proxy]):
            time.sleep(0.05)
        yield coord_dir, servers, proxy
    finally:
        proxy.stop()
        for s in servers:
            s.stop()


def test_cluster_folded_profile_acceptance(profile_cluster, capsys):
    """``jubactl -c profile --folded`` against a live proxy + 2-backend
    cluster emits a non-empty cluster-folded collapsed-stack profile
    with frames from BOTH backends."""
    coord_dir, servers, proxy = profile_cluster
    with RpcClient("127.0.0.1", proxy.args.rpc_port) as c:
        prof = c.call("get_profile", "pf", 60.0)
    assert len(prof) == 3, sorted(prof)
    for node, doc in prof.items():
        assert doc["folded"], f"{node} contributed no frames"
        assert sum(doc["folded"].values()) > 0
    backend_nodes = {_node(s) for s in servers}
    assert backend_nodes <= set(prof)
    rc = jubactl.main(["-c", "profile", "-t", "classifier", "-n", "pf",
                       "-z", coord_dir, "--folded"])
    cap = capsys.readouterr()
    assert rc == 0
    lines = [ln for ln in cap.out.splitlines() if ln.strip()]
    assert lines, cap.err
    for ln in lines:
        stack, _, count = ln.rpartition(" ")
        assert stack and int(count) > 0
    total = sum(int(ln.rpartition(" ")[2]) for ln in lines)
    assert total >= sum(
        sum(d["folded"].values()) for d in prof.values()) * 0.5
    for node in backend_nodes | {_node(proxy)}:
        assert node in cap.err


def test_jubactl_profile_table_and_device(profile_cluster, capsys):
    coord_dir, servers, proxy = profile_cluster
    rc = jubactl.main(["-c", "profile", "-t", "classifier", "-n", "pf",
                       "-z", coord_dir, "--top", "5"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "frame" in out and "self%" in out
    assert "folded from 3 node(s)" in out
    rc = jubactl.main(["-c", "profile", "-t", "classifier", "-n", "pf",
                       "-z", coord_dir, "--device"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("0 capture(s) in") == 2  # a listing, no new capture


# -- tests/test_model_health.py -------------------------------------------------

@pytest.fixture()
def health_cluster(tmp_path):
    """Three port members mixing through a file coordinator, SLOs set, the
    telemetry thread off (the tests drive the ticks)."""
    coord_dir = str(tmp_path / "coord")
    servers = [_server(coord_dir, "mh", tmp_path, telemetry_interval=0,
                       slo=["latency:rpc.classify:p99:50",
                            "error_rate:*:0.01"],
                       slo_fast_window=1.0, slo_slow_window=2.5,
                       metrics_port=0) for _ in range(3)]
    for i, s in enumerate(servers):
        with ClassifierClient("127.0.0.1", s.args.rpc_port, "mh") as c:
            c.train([[f"l{i}", Datum({"x": float(i + 1)})],
                     [f"l{(i + 1) % 3}", Datum({"x": -2.0 * i - 1})]])
            for _ in range(20):
                c.classify([Datum({"x": 1.0})])
    yield coord_dir, servers
    for s in servers:
        s.stop()


def test_jubactl_watch_once_renders_cluster_frame(health_cluster, capsys):
    """jubactl -c watch --once renders ONE coherent frame: every node's
    row with rates, p99 and mix health, plus the alerts line."""
    coord_dir, servers = health_cluster
    servers[0].mixer.mix_now()
    for s in servers:
        s._model_health_tick()
    time.sleep(0.05)
    for s in servers:
        for _ in range(5):
            s.rpc.trace.record("rpc.classify", 0.002)
        s._model_health_tick()
    rc = jubactl.main(["-c", "watch", "--once", "--window", "120",
                       "-t", "classifier", "-n", "mh", "-z", coord_dir])
    out = capsys.readouterr().out
    assert rc == 0
    lines = out.splitlines()
    assert "3 server(s)" in lines[0] and "window 120s" in lines[0]
    for s in servers:
        row = next(ln for ln in lines
                   if ln.strip().startswith(s.self_nodeinfo().name))
        assert "div " in row and "stale " in row  # mix health cell
        # the window saw five classify spans: a rate and a p99 cell
        assert " classify" in row
    assert any("alerts firing:" in ln for ln in lines)
    assert "req/s" in out and "p99 ms" in out


def test_jubactl_status_all_renders_health_line(health_cluster, capsys):
    coord_dir, servers = health_cluster
    rc = jubactl.main(["-c", "status", "--all", "-t", "classifier",
                       "-n", "mh", "-z", coord_dir])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("health: ok") == 3


# -- tests/test_event_plane.py ----------------------------------------------------

def test_follow_cursor_semantics_collect_events(tmp_path):
    """collect_events advances per-node HLC cursors: a second poll
    returns ONLY events emitted since the first (the --follow loop)."""
    coord_dir = str(tmp_path / "coord")
    srv = _server(coord_dir, "evf", tmp_path, telemetry_interval=0)
    coord = create_coordinator(coord_dir)
    try:
        cursors: dict = {}
        first = jubactl.collect_events(coord, "classifier", "evf",
                                       cursors=cursors)
        assert first  # boot produced membership events at least
        assert cursors
        assert jubactl.collect_events(coord, "classifier", "evf",
                                      cursors=cursors) == []
        srv.rpc.trace.events.emit("t", "fresh_one")
        third = jubactl.collect_events(coord, "classifier", "evf",
                                       cursors=cursors)
        assert [r["type"] for r in third] == ["fresh_one"]
    finally:
        coord.close()
        srv.stop()


def test_timeline_follow_streams_only_new_events(tmp_path, monkeypatch,
                                                 capsys):
    """``-c timeline --follow`` prints the retained events, then on each
    poll only what was emitted since, once."""
    coord_dir = str(tmp_path / "coord")
    srv = _server(coord_dir, "evt", tmp_path, telemetry_interval=0)
    coord = create_coordinator(coord_dir)
    polls = []
    real_sleep = time.sleep

    def sleep(_s):
        if threading.current_thread() is not threading.main_thread():
            return real_sleep(_s)  # the server's own threads
        polls.append(_s)
        if len(polls) == 1:
            srv.rpc.trace.events.emit("t", "between_polls")
        elif len(polls) == 3:
            raise KeyboardInterrupt

    monkeypatch.setattr(time, "sleep", sleep)
    try:
        assert jubactl.show_timeline(coord, "classifier", "evt",
                                     follow=True, interval=0.5) == 0
    finally:
        coord.close()
        srv.stop()
    cap = capsys.readouterr()
    assert "[following]" in cap.err
    lines = cap.out.splitlines()
    assert sum("t.between_polls" in ln for ln in lines) == 1
    assert "membership.epoch_bump" in lines[0] or any(
        "membership." in ln for ln in lines[:-1])
    assert "t.between_polls" in lines[-1]
    assert polls == [0.5, 0.5, 0.5]


def test_cluster_slo_breach_captures_one_correlated_bundle(tmp_path,
                                                           capsys):
    """On a live 3-member cluster an induced latency SLO breach gives a
    timeline interleaving the breach and the mix and membership events in
    causal order, exactly ONE bundle sharing the breaching trace id, an
    ``incident`` listing and the watch frame's event cells."""
    coord_dir = str(tmp_path / "coord")
    servers = [_server(coord_dir, "evc", tmp_path / f"d{i}",
                       telemetry_interval=0,
                       slo=["latency:rpc.classify:p99:50"],
                       slo_fast_window=1.0, slo_slow_window=2.5,
                       incident_window=300.0) for i in range(3)]
    try:
        with ClassifierClient("127.0.0.1", servers[0].args.rpc_port,
                              "evc") as c:
            c.train([["a", Datum({"x": 1.0})], ["b", Datum({"x": -1.0})]])
        servers[0].mixer.mix_now()
        srv0 = servers[0]
        reg = srv0.rpc.trace
        reg.slowlog.configure(min_count=1, quantile=0.5)
        for _ in range(100):
            reg.record("rpc.classify", 0.001)
        srv0._model_health_tick()
        time.sleep(0.3)
        breach = tracing.new_root()
        with tracing.use_trace(breach):
            for _ in range(40):
                reg.record("rpc.classify", 0.5)
        srv0._model_health_tick()
        assert len(srv0.slo.alerts()) >= 1
        srv0._model_health_tick()
        assert srv0.incidents.stats()["captured"] == 1
        (meta,) = srv0.incidents.list()["incidents"]
        bundle = srv0.incidents.get(meta["id"])
        assert bundle["reason"].startswith("slo_firing:")
        assert breach.trace_id in bundle["trace_ids"]
        assert breach.trace_id in {r.get("trace_id")
                                   for r in bundle["slow_log"]}
        rc = jubactl.main(["-c", "timeline", "-t", "classifier",
                           "-n", "evc", "-z", coord_dir])
        out = capsys.readouterr().out
        assert rc == 0
        assert "slo.firing" in out and "mix.round" in out
        assert "membership.epoch_bump" in out
        assert "incident.captured" in out
        lines = [ln for ln in out.splitlines() if ln.strip()]
        first_epoch = next(i for i, ln in enumerate(lines)
                           if "epoch_bump" in ln)
        firing = next(i for i, ln in enumerate(lines) if "slo.firing" in ln)
        assert first_epoch < firing
        rc = jubactl.main(["-c", "incident", "-t", "classifier",
                           "-n", "evc", "-z", coord_dir])
        out = capsys.readouterr().out
        assert rc == 0 and "slo_firing:" in out
        assert "1 incident bundle(s) across 3 node(s)" in out
        rc = jubactl.main(["-c", "incident", "-t", "classifier",
                           "-n", "evc", "-z", coord_dir,
                           "--pull", meta["id"]])
        cap = capsys.readouterr()
        assert rc == 0
        assert json.loads(cap.out)["id"] == meta["id"]
        rc = jubactl.main(["-c", "watch", "--once", "-t", "classifier",
                           "-n", "evc", "-z", coord_dir])
        out = capsys.readouterr().out
        assert rc == 0
        assert "last_event" in out
        assert "last event" in out.splitlines()[0]  # membership age
        assert "slo firing" in out
    finally:
        for s in servers:
            s.stop()


# -- parity with the JAX jubactl -------------------------------------------------

NOW = 1_790_000_000.25


@pytest.fixture()
def frozen_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)


def _seeded_spans(rng):
    """A seeded trace across four nodes: a proxy dispatch, client hops,
    backend dispatches and their inner spans, plus one orphan."""
    spans = [{"trace_id": "t1", "span_id": "s0", "parent_id": "cli",
              "name": "rpc.classify", "duration_ms": 12.5, "ts": NOW,
              "node": "127.0.0.1_9300"}]
    for b in range(3):
        hop = f"h{b}"
        start = NOW + 0.001 * (b + 1)
        spans.append({"trace_id": "t1", "span_id": hop, "parent_id": "s0",
                      "name": "rpc.client.classify",
                      "duration_ms": round(float(rng.uniform(1, 9)), 3),
                      "ts": start, "node": "127.0.0.1_9300"})
        spans.append({"trace_id": "t1", "span_id": f"d{b}",
                      "parent_id": hop, "name": "rpc.classify",
                      "duration_ms": round(float(rng.uniform(0.5, 5)), 3),
                      "ts": start + 0.0002, "node": f"127.0.0.1_92{b:02d}"})
        for k in range(int(rng.integers(0, 3))):
            spans.append({"trace_id": "t1", "span_id": f"d{b}k{k}",
                          "parent_id": f"d{b}", "name": "kernel.sig_scan",
                          "duration_ms": round(float(rng.uniform(0, 1)), 3),
                          "ts": start + 0.0003 + 1e-4 * k,
                          "node": f"127.0.0.1_92{b:02d}"})
    spans.append({"trace_id": "t1", "span_id": "x", "parent_id": "gone",
                  "name": "mix.round", "duration_ms": 3.0, "ts": NOW + 0.5,
                  "node": "127.0.0.1_9201"})
    order = rng.permutation(len(spans))
    return [spans[i] for i in order]


def test_parity_trace_assembly_and_render():
    rng = np.random.default_rng(151)
    spans = _seeded_spans(rng)
    ours, theirs = jubactl.assemble_trace(spans), jctl.assemble_trace(spans)
    assert json.dumps(ours, sort_keys=True) == \
        json.dumps(theirs, sort_keys=True)
    assert len(ours) == 2  # the proxy dispatch and the orphan
    a, b = io.StringIO(), io.StringIO()
    jubactl.render_trace("t1", ours, out=a)
    jctl.render_trace("t1", theirs, out=b)
    assert a.getvalue() == b.getvalue()
    assert f"trace t1: {len(spans)} span(s), 2 root(s)" in a.getvalue()


def _quality_docs():
    """One node's doc from each package's quality plane, fed the same
    seeded stream: a reference window, a shifted live window, labels and
    classified scores."""
    from jubatus_tpu.utils.quality import QualityPlane as JQualityPlane
    from jubatus_tpu_torch.utils.quality import QualityPlane

    docs = {}
    for node, cls in (("127.0.0.1_9201", QualityPlane),
                      ("127.0.0.1_9202", JQualityPlane)):
        rng = np.random.default_rng(7)
        q = cls(sample=1.0, window_s=1.0, ref_windows=1)
        base = NOW
        q.tick(now=base)
        for shift, t in ((0.0, 2.0), (0.7, 4.0), (1.1, 6.0)):
            q.record_named([f"ch{i}" for i in range(120)],
                           rng.uniform(size=120) + shift)
            q.record_named([f"num{i}" for i in range(60)],
                           rng.normal(size=60))
            for _ in range(30):
                truth = "ab"[int(rng.integers(0, 2))]
                p = float(rng.uniform())
                q.record_classified(truth, [("a", p), ("b", 1.0 - p)])
            q.tick(now=base + t)
        docs[node] = q.snapshot()
    return docs


def test_parity_render_quality():
    docs = _quality_docs()
    ours = jubactl.render_quality("classifier", "c1", docs)
    assert ours == jctl.render_quality("classifier", "c1", docs)
    assert "data quality across 2 node(s)" in ours
    assert "prequential n=" in ours and "DRIFTING" in ours


def _usage_docs():
    from jubatus_tpu.utils.usage import UsageLedger as JUsageLedger
    from jubatus_tpu_torch.utils.usage import UsageLedger

    docs = {}
    for node, cls in (("127.0.0.1_9201", UsageLedger),
                      ("127.0.0.1_9202", JUsageLedger),
                      ("127.0.0.1_9300", UsageLedger)):
        rng = np.random.default_rng(19)
        led = cls(top=4)
        led.tick(50.0 if node != "127.0.0.1_9300" else 0.0, now=NOW)
        for i in range(60):
            p = f"tenant-{int(rng.integers(0, 7))}"
            method = ("train", "classify")[i % 2]
            led.account(method, principal=p, requests=1,
                        rows=float(rng.integers(1, 64)),
                        cpu_seconds=float(rng.uniform(0, 0.01)),
                        bytes_in=float(rng.integers(100, 5000)),
                        bytes_out=float(rng.integers(10, 500)))
            if i % 11 == 0:
                led.account(method, principal=p, errors=1, retries=1)
        led.record_batch("tenant-1", "train", 32.0, 0.002, 0.001)
        led.tick(now=NOW + 10.0)
        docs[node] = led.snapshot()
    return docs


@pytest.mark.parametrize("top", [0, 3])
def test_parity_render_usage(top):
    docs = _usage_docs()
    ours = jubactl.render_usage("classifier", "c1", docs, top=top)
    assert ours == jctl.render_usage("classifier", "c1", docs, top=top)
    assert "usage across 3 node(s)" in ours
    assert "capacity 100 rows/s" in ours
    if top:
        assert "more principal(s) (raise --top)" in ours


def _seeded_events(rng):
    recs = []
    for i in range(25):
        rec = {"hlc": 10_000 + i, "ts": NOW - 60 + 2.37 * i,
               "node": f"127.0.0.1_92{i % 3:02d}",
               "subsystem": ("mix", "slo", "membership", "breaker")[i % 4],
               "type": ("round", "firing", "epoch_bump", "open")[i % 4],
               "severity": ("info", "warning", "error", "debug")[i % 4]}
        for k in range(int(rng.integers(0, 4))):
            rec[f"f{k}"] = round(float(rng.uniform()), 4)
        if i % 3 == 0:
            rec["trace_id"] = f"tr{i}"
        if rec["subsystem"] == "slo":
            rec["name"] = "rpc.classify.p99"
            rec["burn_fast"] = round(float(rng.uniform(1, 30)), 2)
        recs.append(rec)
    return recs


def test_parity_render_event_line():
    for rec in _seeded_events(np.random.default_rng(3)):
        assert jubactl.render_event_line(rec) == jctl.render_event_line(rec)


def _watch_data(pkg_timeseries, points, events_, status):
    """collect_watch's shape, its window built by ``pkg_timeseries``."""
    nodes = {}
    for i, (name, st) in enumerate(sorted(status.items())):
        nodes[name] = {"error": "", "status": st,
                       "window": pkg_timeseries.window_from_points(
                           points[i], 60.0),
                       "alerts": ["rpc.classify.p99"] if i == 1 else [],
                       "events": [e for e in events_ if e["node"] == name]}
    nodes["127.0.0.1_9299"] = {"error": "connection refused"}
    return {"engine": "classifier", "name": "c1", "window_s": 60.0,
            "nodes": nodes, "actives": {"127.0.0.1_9200",
                                        "127.0.0.1_9201"},
            "draining": {"127.0.0.1_9202"}, "epoch": 4,
            "proxies": {"127.0.0.1_9300": {"error": "", "status": {
                "breaker_open": 1, "breaker_backends": 3,
                "forward_count": 812, "forward_errors": 2,
                "relay_count": 700}},
                "127.0.0.1_9301": {"error": "timed out"}}}


def _ring_points(rng):
    from jubatus_tpu_torch.utils.timeseries import TimeSeriesRing

    reg = tracing.Registry()
    ring = TimeSeriesRing(capacity=32)
    for k in range(6):
        for _ in range(int(rng.integers(5, 40))):
            reg.record("rpc.classify", float(rng.uniform(0.0005, 0.02)))
            reg.record("rpc.train", float(rng.uniform(0.001, 0.05)))
        reg.count("rpc.classify.errors", int(rng.integers(0, 3)))
        ring.sample(reg.snapshot(), ts=NOW - 50 + 10 * k)
    return ring.points()


def test_parity_render_watch_frame(frozen_clock):
    """Both packages' watch frames agree on the same scrape, each with
    its own package's windows over the same ring points."""
    from jubatus_tpu.utils import timeseries as jts
    from jubatus_tpu_torch.utils import timeseries as pts

    rng = np.random.default_rng(42)
    points = [_ring_points(rng) for _ in range(3)]
    events_ = _seeded_events(rng)
    status = {
        "127.0.0.1_9200": {
            "health.status": "ok", "mixer.health_premix_divergence_mean":
            0.1234, "mixer.health_staleness_max": 1,
            "mixer.model_version": 9,
            "mixer.mix_ef_contrib_residual_norm": 0.000123,
            "driver.ann.mode": "ivf", "driver.ann.cells": 64,
            "driver.ann.recall_probe": 0.971, "quality.drift_max": 0.31,
            "quality.reference_pinned": True,
            "quality.prequential_accuracy": 0.8125,
            "usage.top_principal": "tenant-a", "usage.headroom": 0.42},
        "127.0.0.1_9201": {
            "health.status": "degraded", "mixer.self_staleness": 3,
            "mixer.guard_quarantined": ["x", "y"], "rollback.count": 2,
            "mixer.async_mode": True, "mixer.async_lag_rounds": 1,
            "mixer.async_inbox_depth": 4, "driver.shard.count": 4,
            "driver.shard.rows": 1000, "driver.shard.rows_per_shard":
            [250] * 4, "driver.ann.mode": "ivf",
            "driver.ann.degraded": True},
        "127.0.0.1_9202": {
            "health.status": "ok", "drain.state": "draining",
            "driver.shard.count": 2, "driver.shard.bytes_in_use": 1 << 24},
    }
    ours = jubactl.render_watch_frame(
        _watch_data(pts, points, events_, status), ts="12:00:00")
    theirs = jctl.render_watch_frame(
        _watch_data(jts, points, events_, status), ts="12:00:00")
    assert ours == theirs
    assert "last event" in ours.splitlines()[0]
    assert "alerts firing: rpc.classify.p99" in ours
    # the windowed p99 cell names the slowest span of each member's window
    assert len(re.findall(r" \d+\.\d train ", ours)) == 3


ANN_STATUS = [
    {}, {"driver.ann.mode": "off"},
    {"driver.ann.mode": "ivf"},
    {"driver.ann.mode": "ivf", "driver.ann.degraded": True,
     "driver.ann.cells": 16, "driver.ann.nprobe": 4},
    {"driver.ann.mode": "ivf", "driver.ann.cells": 1024,
     "driver.ann.nprobe": 8, "driver.ann.probed_cells": 8,
     "driver.ann.rescore_candidates": 1311,
     "driver.ann.recall_probe": 0.9375},
]


@pytest.mark.parametrize("st", ANN_STATUS)
def test_parity_fmt_ann(st):
    assert jubactl._fmt_ann(st) == jctl._fmt_ann(st)


def test_status_all_prints_the_jax_ann_line_for_an_ivf_member(capsys):
    """``status --all`` over an ``--ann ivf`` port member prints the same
    ANN line from both packages' jubactl (the member's index built and
    queried once)."""
    from jubatus_tpu.coord.remote import RemoteCoordinator as JRemote
    from jubatus_tpu_torch.coord.remote import RemoteCoordinator
    from jubatus_tpu_torch.coord.server import CoordServer

    conf = {"method": "lsh", "parameter": {"hash_num": 64},
            "converter": {"num_rules": [{"key": "*", "type": "num"}]}}
    coordd = CoordServer(lease_sec=5.0)
    cport = coordd.start(0, host="127.0.0.1")
    srv = EngineServer("nearest_neighbor", conf, ServerArgs(
        engine="nearest_neighbor", coordinator="(shared)", name="ivf",
        listen_addr="127.0.0.1", interval_sec=1e9, interval_count=1 << 30,
        ann="ivf", ann_cells=4, ann_nprobe=2, profile_hz=0), device="cpu",
        coord=RemoteCoordinator("127.0.0.1", cport))
    srv.start(0)
    views = (RemoteCoordinator("127.0.0.1", cport),
             JRemote("127.0.0.1", cport))
    try:
        rng = np.random.default_rng(8)
        with RpcClient("127.0.0.1", srv.args.rpc_port, timeout=60) as c:
            for i in range(160):
                c.call("set_row", "ivf", f"r{i}", Datum(
                    {f"f{j}": float(rng.standard_normal())
                     for j in range(8)}))
            c.call("neighbor_row_from_id", "ivf", "r0", 5)
        lines = []
        for ctl, view in zip((jubactl, jctl), views):
            assert ctl.show_status(view, "nearest_neighbor", "ivf",
                                   show_all=True) == 0
            out = capsys.readouterr().out
            lines.append([ln for ln in out.splitlines()
                          if ln.startswith("    ann: ")])
        assert lines[0] == lines[1]
        (line,) = lines[0]
        assert line.startswith("    ann: ivf  4 cells (probe 2)")
    finally:
        for v in views:
            v.close()
        srv.stop()
        coordd.stop()


# -- both jubactls over a mixed fleet ----------------------------------------------

def test_jubactl_quality_and_usage_match_the_jax_jubactl(monkeypatch,
                                                         tmp_path, capsys):
    """A port proxy before one JAX and one port member: both packages'
    ``-c quality`` print the same text and ``-c usage`` the same lines
    but the ``(untagged)`` and ``(system)`` rows, which each scrape bills
    to the fleet itself (its get_usage and the proxy's lookups are
    requests too)."""
    from jubatus_tpu.coord.remote import RemoteCoordinator as JRemote
    from jubatus_tpu.server import EngineServer as JEngineServer
    from jubatus_tpu.server.args import ServerArgs as JServerArgs
    from jubatus_tpu_torch.coord.remote import RemoteCoordinator
    from jubatus_tpu_torch.coord.server import CoordServer

    monkeypatch.setenv("JUBATUS_TPU_NATIVE_RPC", "0")
    monkeypatch.setenv("JUBATUS_TPU_NATIVE_INGEST", "0")
    coordd = CoordServer(lease_sec=5.0)
    cport = coordd.start(0, host="127.0.0.1")
    common = dict(engine="classifier", coordinator="(shared)", name="mq",
                  listen_addr="127.0.0.1", interval_sec=1e9,
                  interval_count=1 << 30, telemetry_interval=0,
                  profile_hz=0, quality_sample=1.0, quality_window=1.0,
                  quality_ref_windows=1, microbatch_max=0,
                  datadir=str(tmp_path))
    jsrv = JEngineServer("classifier", CONF, JServerArgs(**common),
                         coord=JRemote("127.0.0.1", cport))
    jsrv.start(0)
    psrv = EngineServer("classifier", CONF, ServerArgs(**common),
                        device="cpu",
                        coord=RemoteCoordinator("127.0.0.1", cport))
    psrv.start(0)
    proxy = Proxy(ProxyArgs(engine="classifier", listen_addr="127.0.0.1",
                            telemetry_interval=0, profile_hz=0),
                  coord=RemoteCoordinator("127.0.0.1", cport))
    proxy.start(0)
    locator = f"tcp://127.0.0.1:{cport}"
    try:
        rng = np.random.default_rng(23)
        base = time.time()
        for srv in (jsrv, psrv):
            srv.quality.tick(now=base)
        for w, shift in enumerate((0.0, 0.0, 1.5)):
            for k in range(4):
                batch = [["ab"[(k + j) % 2], Datum({
                    "x": float(np.round(rng.uniform() + shift, 3)),
                    "y": float(np.round(rng.normal(), 3))})]
                    for j in range(8)]
                with principals.use(f"tenant-{k % 2}"), \
                        RpcClient("127.0.0.1", proxy.args.rpc_port,
                                  timeout=30) as c:
                    assert c.call("train", "mq", batch) == len(batch)
            for srv in (jsrv, psrv):
                srv.quality.tick(now=base + 2.0 * (w + 1))
        outs = {}
        for cmd in ("quality", "usage"):
            for name, ctl in (("port", jubactl), ("jax", jctl)):
                rc = ctl.main(["-c", cmd, "-t", "classifier", "-n", "mq",
                               "-z", locator])
                cap = capsys.readouterr()
                assert rc == 0, cap.err
                outs[cmd, name] = cap.out
        assert outs["quality", "port"] == outs["quality", "jax"]
        assert "data quality across 2 node(s)" in outs["quality", "port"]

        def billed(text):
            return [ln for ln in text.splitlines()
                    if not ln.lstrip().startswith(("(untagged)",
                                                   "(system)"))]

        assert billed(outs["usage", "port"]) == billed(outs["usage", "jax"])
        text = outs["usage", "port"]
        assert "usage across 3 node(s)" in text
        assert re.search(r"^\s+tenant-[01]\s+\d+", text, re.M)
    finally:
        proxy.stop()
        psrv.stop()
        jsrv.stop()
        coordd.stop()
