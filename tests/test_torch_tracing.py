"""The port's tracing and metrics plane (jubatus_tpu_torch/utils/tracing.py,
slowlog.py, metrics_http.py, runtime_telemetry.py and the server's
forensics RPCs), mirroring tests/test_tracing.py and the cases of
tests/test_metrics_plane.py and tests/test_trace_forensics.py that need no
proxy and no jubactl view, on port servers on the CPU; plus a parity case:
the same recorded spans, counters and gauges give the same snapshot,
merged quantiles and Prometheus text in both packages."""

from __future__ import annotations

import json
import re
import threading
import time
import urllib.error
import urllib.request

import pytest

from jubatus_tpu.utils import tracing as jtracing
from jubatus_tpu_torch.coord.memory import MemoryCoordinator, _Store
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.rpc import deadline as deadlines
from jubatus_tpu_torch.rpc.client import ClassifierClient, RpcClient
from jubatus_tpu_torch.rpc.server import RpcServer
from jubatus_tpu_torch.server import EngineServer
from jubatus_tpu_torch.server.args import ServerArgs
from jubatus_tpu_torch.utils import tracing

CONF = {
    "method": "PA",
    "parameter": {"regularization_weight": 1.0},
    "converter": {"num_rules": [{"key": "*", "type": "num"}]},
}


@pytest.fixture(autouse=True)
def _fresh():
    tracing.reset()
    yield
    tracing.reset()


def _server(**kw) -> EngineServer:
    return EngineServer("classifier", CONF,
                        ServerArgs(engine="classifier",
                                   listen_addr="127.0.0.1", **kw),
                        device="cpu")


# -- tests/test_tracing.py ----------------------------------------------------


def test_span_aggregates():
    for _ in range(3):
        with tracing.span("unit.op"):
            pass
    st = tracing.trace_status()
    assert st["trace.unit.op.count"] == 3
    assert st["trace.unit.op.mean_ms"] >= 0.0
    assert st["trace.unit.op.max_ms"] >= st["trace.unit.op.mean_ms"]


def test_span_records_on_exception():
    with pytest.raises(ValueError):
        with tracing.span("unit.boom"):
            raise ValueError("x")
    assert tracing.trace_status()["trace.unit.boom.count"] == 1


def test_record_external():
    tracing.record("ext", 0.25)
    assert tracing.trace_status()["trace.ext.last_ms"] == 250.0


def test_device_trace_noop_without_dir(monkeypatch):
    monkeypatch.delenv("JUBATUS_TPU_TRACE_DIR", raising=False)
    with tracing.device_trace():
        pass  # must not need the profiler


def test_device_trace_writes_profile(tmp_path, monkeypatch):
    import torch

    monkeypatch.setenv("JUBATUS_TPU_TRACE_DIR", str(tmp_path))
    with tracing.device_trace():
        float(torch.ones(8, 8).sum())
    doc = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("cat") == "cpu_op" for e in doc["traceEvents"])


def test_rpc_dispatch_records_spans():
    srv = RpcServer()
    srv.register("ping", lambda: "pong", arity=0)
    port = srv.serve_background(0, host="127.0.0.1")
    try:
        with RpcClient("127.0.0.1", port) as c:
            assert c.call("ping") == "pong"
        assert srv.trace.trace_status()["trace.rpc.ping.count"] == 1
    finally:
        srv.stop()


def test_per_server_span_isolation():
    """Two servers in one process must not merge each other's counters."""
    a, b = RpcServer(), RpcServer()
    a.register("hit", lambda: 1, arity=0)
    b.register("hit", lambda: 2, arity=0)
    pa = a.serve_background(0, host="127.0.0.1")
    b.serve_background(0, host="127.0.0.1")
    try:
        with RpcClient("127.0.0.1", pa) as c:
            c.call("hit")
        assert a.trace.trace_status()["trace.rpc.hit.count"] == 1
        assert "trace.rpc.hit.count" not in b.trace.trace_status()
    finally:
        a.stop(), b.stop()


def test_server_status_includes_traces():
    srv = _server()
    port = srv.start(0)
    try:
        c = ClassifierClient("127.0.0.1", port, "")
        c.train([["a", Datum({"x": 1.0})]])
        (node_st,) = c.get_status().values()
        assert node_st["trace.rpc.train.count"] >= 1
        assert node_st["trace.rpc.train.last_trace_id"]
        c.close()
    finally:
        srv.stop()


# -- tests/test_metrics_plane.py: histograms ----------------------------------


def test_histogram_empty():
    h = tracing.Histogram()
    assert h.quantile(0.5) is None
    assert h.count == 0 and h.max_s == 0.0


def test_histogram_single_sample_quantiles_exact():
    h = tracing.Histogram()
    h.record(0.005)
    for q in (0.0, 0.5, 0.99, 1.0):
        assert h.quantile(q) == pytest.approx(0.005)


def test_histogram_overflow_bucket():
    h = tracing.Histogram()
    h.record(1e6)  # past the 128 s top bucket
    assert h.quantile(0.5) == pytest.approx(1e6)
    assert max(int(k) for k in h.state()["buckets"]) == tracing._OVERFLOW


def test_histogram_underflow_clamps_to_first_bucket():
    h = tracing.Histogram()
    h.record(0.0)
    h.record(1e-12)
    assert h.count == 2
    assert h.quantile(0.5) is not None


def test_histogram_quantile_accuracy_bounded():
    """Bucket width is 2^(1/4) ≈ 19%: quantiles land within one bucket."""
    h = tracing.Histogram()
    for i in range(1, 1001):
        h.record(i / 1000.0)
    p50 = h.quantile(0.5)
    assert 0.5 / 1.2 <= p50 <= 0.5 * 1.2, p50
    p99 = h.quantile(0.99)
    assert 0.99 / 1.2 <= p99 <= 1.0, p99


def test_histogram_concurrent_record():
    reg = tracing.Registry()
    n, threads = 2000, 8

    def pump():
        for i in range(n):
            reg.record("conc", 1e-4 * (1 + i % 7))

    ts = [threading.Thread(target=pump) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert reg.trace_status()["trace.conc.count"] == n * threads
    snap = reg.snapshot()
    assert sum(snap["hists"]["conc"]["buckets"].values()) == n * threads


def test_snapshot_merge_and_state_quantile():
    a, b = tracing.Registry(), tracing.Registry()
    for _ in range(100):
        a.record("x", 0.001)
    for _ in range(100):
        b.record("x", 0.1)
    a.count("errs", 2)
    b.count("errs", 3)
    merged = tracing.merge_snapshots([a.snapshot(), b.snapshot()])
    st = merged["hists"]["x"]
    assert st["count"] == 200
    assert merged["counters"]["errs"] == 5
    assert tracing.state_quantile(st, 0.25) == pytest.approx(0.001, rel=0.25)
    assert tracing.state_quantile(st, 0.75) == pytest.approx(0.1, rel=0.25)
    assert st["max_s"] == pytest.approx(0.1, rel=0.01)


def test_trace_context_adopt_and_fresh():
    root = tracing.from_wire(None)
    assert root.trace_id and root.span_id and root.parent_id == ""
    child = tracing.from_wire(tracing.to_wire(root))
    assert child.trace_id == root.trace_id
    assert child.parent_id == root.span_id
    assert child.span_id != root.span_id
    b = tracing.from_wire({"t": b"abc", "s": b"def"})
    assert b.trace_id == "abc" and b.parent_id == "def"


def test_use_trace_restores_previous():
    ctx = tracing.from_wire(None)
    assert tracing.current_trace() is None
    with tracing.use_trace(ctx):
        assert tracing.current_trace() is ctx
        with tracing.use_trace(None):
            assert tracing.current_trace() is None
        assert tracing.current_trace() is ctx
    assert tracing.current_trace() is None


# -- prometheus exposition ----------------------------------------------------


def _parse_prometheus(text: str):
    """Format-0.0.4 validation: every non-comment line is ``name{labels}
    value``; returns the parsed samples."""
    samples = []
    pat = re.compile(
        r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? ([0-9eE.+-]+|NaN|\+Inf)$')
    assert text.endswith("\n")
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = pat.match(line.split(" # ", 1)[0])
        assert m, f"unparseable exposition line: {line!r}"
        samples.append((m.group(1), m.group(2) or "", float(m.group(3))))
    return samples


def test_prometheus_text_parses_and_buckets_cumulative():
    reg = tracing.Registry()
    for i in range(50):
        reg.record("rpc.unit", 1e-4 * (1 + i))
    reg.count("rpc.unit.errors", 3)
    text = reg.prometheus_text({"node": "127.0.0.1_1"})
    samples = _parse_prometheus(text)
    buckets = [v for n, _lab, v in samples
               if n == "jubatus_span_duration_seconds_bucket"]
    assert buckets == sorted(buckets)
    assert buckets[-1] == 50
    counts = {n: v for n, _l, v in samples}
    assert counts["jubatus_span_duration_seconds_count"] == 50
    assert counts["jubatus_events_total"] == 3
    assert 'node="127.0.0.1_1"' in text


def test_metrics_endpoint_smoke():
    """--metrics-port 0 binds an ephemeral port; /metrics parses with the
    rpc.train span and the engine label; /healthz answers JSON; an unknown
    path is a 404."""
    srv = _server(metrics_port=0)
    port = srv.start(0)
    try:
        mport = srv.args.metrics_port
        assert mport > 0
        c = ClassifierClient("127.0.0.1", port, "")
        c.train([["a", Datum({"x": 1.0})]])
        (st,) = c.get_status().values()
        assert st["argv.metrics_port"] == mport
        c.close()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{mport}/metrics", timeout=10) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"].startswith("text/plain")
            body = resp.read().decode()
        samples = _parse_prometheus(body)
        spans = {lab for n, lab, _v in samples
                 if n == "jubatus_span_duration_seconds_count"}
        assert any('span="rpc.train"' in lab for lab in spans), spans
        assert any('engine="classifier"' in lab for lab in spans)
        gauges = {lab for n, lab, _v in samples
                  if n == "jubatus_runtime_gauge"}
        assert any('key="rss_bytes"' in lab for lab in gauges)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{mport}/healthz", timeout=10) as resp:
            doc = json.loads(resp.read().decode())
        assert doc["status"] == "ok" and doc["engine"] == "classifier"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{mport}/nope",
                                   timeout=10)
    finally:
        srv.stop()
    assert srv.metrics._httpd is None


def test_rpc_error_counter_per_method():
    srv = RpcServer()
    srv.register("boom", lambda: 1 / 0, arity=0)
    srv.register("ok", lambda: 1, arity=0)
    port = srv.serve_background(0, host="127.0.0.1")
    try:
        with RpcClient("127.0.0.1", port) as c:
            assert c.call("ok") == 1
            for _ in range(2):
                with pytest.raises(Exception):
                    c.call("boom")
        st = srv.trace.trace_status()
        assert st["trace.counter.rpc.boom.errors"] == 2
        assert "trace.counter.rpc.ok.errors" not in st
        assert st["trace.rpc.boom.count"] == 2
    finally:
        srv.stop()


def test_flight_recorder_ring_and_fields():
    from jubatus_tpu_torch.framework.mixer import MixFlightRecorder

    fr = MixFlightRecorder(capacity=4)
    fr.node = "me_1"
    for i in range(6):
        fr.record("collective", ok=(i % 2 == 0), round_id=f"r{i}",
                  phases={"ship_ms": 1.0, "reduce_ms": 2.0,
                          "readback_ms": 3.0, "chunks": 4},
                  members=3)
    snap = fr.snapshot()
    assert [r["round_id"] for r in snap] == ["r2", "r3", "r4", "r5"]
    last = snap[-1]
    assert last["node"] == "me_1" and last["members"] == 3
    for key in ("ship_ms", "reduce_ms", "readback_ms", "chunks"):
        assert key in last["phases"]
    stats = fr.stats()
    assert stats["recorded"] == 6 and stats["retained"] == 4
    assert fr.snapshot(last=2) == snap[-2:]


def _pair(name: str):
    store = _Store()
    servers = []
    for _ in range(2):
        srv = EngineServer(
            "classifier", CONF,
            ServerArgs(engine="classifier", coordinator="(shared)",
                       name=name, listen_addr="127.0.0.1", interval_sec=1e9,
                       interval_count=1 << 30),
            device="cpu", coord=MemoryCoordinator(store))
        srv.start(0)
        servers.append(srv)
    for s in servers:
        c = ClassifierClient("127.0.0.1", s.args.rpc_port, name)
        c.train([["a", Datum({"x": 1.0})]])
        c.close()
    return servers


def test_get_mix_history_rpc_after_round(capsys):
    """A 2-node linear-mixer cluster: one mix round is one flight record
    with its phases and its trace id, over get_mix_history and jubadump
    --mix-history."""
    from jubatus_tpu_torch.cmd import jubadump

    servers = _pair("fh")
    try:
        assert servers[0].mixer.mix_now() is not None
        with RpcClient("127.0.0.1", servers[0].args.rpc_port) as c:
            hist = c.call("get_mix_history", "fh")
        rec = hist[-1]
        assert rec["mode"] == "rpc" and rec["ok"] is True
        assert rec["members"] == 2 and rec["bytes"] > 0
        assert rec["trace_id"]
        for key in ("schema_ms", "get_diff_ms", "fold_ms", "put_diff_ms"):
            assert key in rec["phases"], rec
        assert jubadump.main([
            "--mix-history", f"127.0.0.1:{servers[0].args.rpc_port}",
            "-n", "fh"]) == 0
        dumped = json.loads(capsys.readouterr().out)
        assert dumped[-1]["trace_id"] == rec["trace_id"]
    finally:
        for s in servers:
            s.stop()


def test_status_all_shows_traces_and_mixer(tmp_path, capsys):
    from jubatus_tpu_torch.cmd import jubactl

    coord_dir = str(tmp_path / "coord")
    servers = []
    try:
        for _ in range(3):
            srv = EngineServer(
                "classifier", CONF,
                ServerArgs(engine="classifier", coordinator=coord_dir,
                           name="jm", listen_addr="127.0.0.1",
                           interval_sec=1e9, interval_count=1 << 30),
                device="cpu")
            srv.start(0)
            servers.append(srv)
        for s in servers:
            c = ClassifierClient("127.0.0.1", s.args.rpc_port, "jm")
            c.train([["a", Datum({"x": 1.0})], ["b", Datum({"x": -1.0})]])
            c.close()
        assert servers[0].mixer.mix_now() is not None
        rc = jubactl.main(["-c", "status", "--all", "-t", "classifier",
                           "-n", "jm", "-z", coord_dir])
        out = capsys.readouterr().out
        assert rc == 0
        assert "3 node(s), 3 active" in out
        assert "trace.rpc.train.p99_ms" in out
        assert "mixer.mix_count" in out
        assert "runtime.rss_bytes" in out
    finally:
        for s in servers:
            s.stop()


# -- tests/test_trace_forensics.py: span store and slow log -------------------


def test_span_store_indexed_by_trace():
    reg = tracing.Registry()
    ctx_a, ctx_b = tracing.new_root(), tracing.new_root()
    with tracing.use_trace(ctx_a):
        reg.record("rpc.x", 0.001)
        reg.record("rpc.y", 0.002)
    with tracing.use_trace(ctx_b):
        reg.record("rpc.x", 0.003)
    spans_a = reg.get_spans(ctx_a.trace_id)
    assert [s["name"] for s in spans_a] == ["rpc.x", "rpc.y"]
    assert all(s["trace_id"] == ctx_a.trace_id for s in spans_a)
    assert len(reg.get_spans(ctx_b.trace_id)) == 1
    assert reg.get_spans("nope") == []


def test_span_store_ring_evicts_oldest_and_prunes_index():
    reg = tracing.Registry(span_capacity=8)
    first = tracing.new_root()
    with tracing.use_trace(first):
        reg.record("rpc.old", 0.001)
    for _ in range(20):
        with tracing.use_trace(tracing.new_root()):
            reg.record("rpc.new", 0.001)
    assert len(reg.recent_spans()) == 8
    assert reg.get_spans(first.trace_id) == []
    assert len(reg._by_trace) == 8


def test_span_parent_edges_from_child_context():
    root = tracing.new_root()
    child = tracing.child_of(root)
    assert child.trace_id == root.trace_id
    assert child.parent_id == root.span_id
    assert child.span_id != root.span_id


def test_span_handle_cancel_suppresses_record():
    reg = tracing.Registry()
    with reg.span("kept"):
        pass
    with reg.span("dropped") as sp:
        sp.cancel()
    st = reg.trace_status()
    assert st["trace.kept.count"] == 1
    assert "trace.dropped.count" not in st
    assert sp.seconds >= 0.0


def test_forensics_toggle_keeps_histograms():
    reg = tracing.Registry()
    reg.slowlog.configure(min_count=1, quantile=0.5)
    reg.set_forensics(False)
    ctx = tracing.new_root()
    with tracing.use_trace(ctx):
        for _ in range(10):
            reg.record("rpc.z", 0.001)
    assert reg.trace_status()["trace.rpc.z.count"] == 10
    assert reg.get_spans(ctx.trace_id) == []
    assert reg.slowlog.snapshot() == []


def test_slowlog_threshold_behavior():
    """No capture below min_count; past it only requests at/above the
    quantile of their own histogram land in the ring."""
    reg = tracing.Registry()
    reg.slowlog.configure(capacity=16, quantile=0.99, min_count=64)
    ctx = tracing.new_root()
    with tracing.use_trace(ctx):
        for i in range(64):
            reg.record("rpc.t", 0.001 * (1 + i % 32))
        base = len(reg.slowlog.snapshot())
        reg.record("rpc.t", 0.002)  # ~median: under the p99 threshold
        assert len(reg.slowlog.snapshot()) == base
        reg.record("rpc.t", 1.0)  # the tail
    recs = reg.slowlog.snapshot()
    assert len(recs) == base + 1
    slow = recs[-1]
    assert slow["method"] == "rpc.t"
    assert slow["duration_ms"] == pytest.approx(1000.0, rel=0.01)
    assert slow["trace_id"] == ctx.trace_id
    assert slow["threshold_ms"] > 2.0
    assert "peer" in slow and "ts" in slow


def test_slowlog_no_capture_below_min_count():
    reg = tracing.Registry()
    reg.slowlog.configure(capacity=16, quantile=0.99, min_count=64)
    for _ in range(63):
        reg.record("rpc.m", 0.001)
    assert reg.slowlog.snapshot() == []


def test_slowlog_ring_bounded():
    reg = tracing.Registry()
    reg.slowlog.configure(capacity=4, quantile=0.5, min_count=1)
    for _ in range(50):
        reg.record("rpc.b", 0.001)
    stats = reg.slowlog.stats()
    assert stats["retained"] <= 4
    assert stats["captured"] >= stats["retained"]


def test_slowlog_records_deadline_remaining():
    reg = tracing.Registry()
    reg.slowlog.configure(capacity=8, quantile=0.5, min_count=1)
    with deadlines.deadline_after(30.0):
        for _ in range(3):
            reg.record("rpc.d", 0.001)
    recs = reg.slowlog.snapshot()
    assert recs
    assert 0 < recs[-1]["deadline_remaining_ms"] <= 30_000


_EXEMPLAR_RE = re.compile(
    r'^jubatus_span_duration_seconds_bucket\{[^}]*\} \d+ '
    r'# \{trace_id="([0-9a-f]+)"\} [0-9eE.+-]+ [0-9.]+$')


def test_prometheus_exemplar_line_parses():
    reg = tracing.Registry()
    reg.slowlog.configure(min_count=1, quantile=0.5)
    ctx = tracing.new_root()
    with tracing.use_trace(ctx):
        for _ in range(5):
            reg.record("rpc.e", 0.002)
        reg.record("rpc.e", 0.5)
    text = reg.prometheus_text({"node": "n1"})
    ex_lines = [ln for ln in text.splitlines() if "# {trace_id=" in ln]
    assert ex_lines, text
    m = _EXEMPLAR_RE.match(ex_lines[-1])
    assert m, ex_lines[-1]
    assert m.group(1) == ctx.trace_id
    for ln in text.splitlines():
        if ln.startswith("#") or not ln or "# {" in ln:
            continue
        assert re.match(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? '
                        r'[0-9eE.+-]+$', ln), ln


def test_concurrent_span_store_safe():
    reg = tracing.Registry(span_capacity=64)
    stop = threading.Event()
    errors = []

    def pump():
        try:
            while not stop.is_set():
                with tracing.use_trace(tracing.new_root()):
                    reg.record("conc", 1e-4)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def read():
        try:
            while not stop.is_set():
                for rec in reg.recent_spans()[:8]:
                    reg.get_spans(rec["trace_id"])
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=pump) for _ in range(4)] + \
        [threading.Thread(target=read) for _ in range(2)]
    for t in threads:
        t.start()
    time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(reg.recent_spans()) <= 64


# -- the mix round as a trace -------------------------------------------------


def test_mix_round_spans_share_one_trace():
    """The master's mix.round and phase spans and the member's mix_*
    dispatch spans land under the trace id stamped into the flight
    record."""
    servers = _pair("mt")
    try:
        assert servers[0].mixer.mix_now() is not None
        rec = servers[0].mixer.flight.snapshot()[-1]
        assert rec["mode"] == "rpc"
        tid = rec["trace_id"]
        names = {s["name"] for s in servers[0].trace.get_spans(tid)}
        assert "mix.round" in names
        assert "mix.phase.get_diff" in names and "mix.phase.put_diff" in names
        member = {s["name"] for s in servers[1].trace.get_spans(tid)}
        assert "rpc.mix_get_diff" in member, member
        assert "rpc.mix_put_diff" in member
    finally:
        for s in servers:
            s.stop()


# -- the server's forensics RPCs ----------------------------------------------


@pytest.mark.parametrize("native", [False, True])
def test_forensics_rpcs_envelope_compat(monkeypatch, native):
    """get_spans / get_slow_log answer the plain 4-element envelope and the
    traced + deadlined one, on both transports."""
    monkeypatch.setenv("JUBATUS_TPU_NATIVE_RPC", "1" if native else "0")
    srv = _server(slowlog_min_count=1, slowlog_quantile=0.5)
    port = srv.start(0)
    try:
        c = ClassifierClient("127.0.0.1", port, "")
        for _ in range(5):
            c.train([["a", Datum({"x": 1.0})]])
        c.close()
        ctx = tracing.new_root()
        with tracing.use_trace(ctx):
            with RpcClient("127.0.0.1", port) as rc:
                rc.call("get_status", "")
        with RpcClient("127.0.0.1", port) as rc:
            (recs,) = rc.call("get_spans", "", ctx.trace_id).values()
            assert any(r["name"] == "rpc.get_status" for r in recs)
            assert all(r["trace_id"] == ctx.trace_id for r in recs)
            (slow_recs,) = rc.call("get_slow_log", "").values()
            assert slow_recs and all("trace_id" in r for r in slow_recs)
            (metrics,) = rc.call("get_metrics", "").values()
            assert metrics["hists"]["rpc.train"]["count"] == 5
        probe = tracing.new_root()
        with tracing.use_trace(probe), deadlines.deadline_after(30.0):
            with RpcClient("127.0.0.1", port) as rc:
                (traced,) = rc.call("get_spans", "", ctx.trace_id).values()
        assert {r["span_id"] for r in traced} >= {r["span_id"] for r in recs}
    finally:
        srv.stop()


def test_runtime_keys_in_get_status_and_healthz():
    srv = _server(metrics_port=0)
    port = srv.start(0)
    try:
        c = ClassifierClient("127.0.0.1", port, "")
        c.train([["a", Datum({"x": 1.0})]])
        (st,) = c.get_status().values()
        c.close()
        assert st["runtime.rss_bytes"] > 0
        assert st["runtime.kernel_build_count"] == 0
        # no jax_* key: the port has no XLA compiler to report
        assert not any(k.startswith("runtime.jax_") for k in st)
        assert st["slowlog.capacity"] == 256
        assert st["argv.slowlog_quantile"] == 0.99
        assert st["profiler.hz"] == 67.0
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.args.metrics_port}/healthz",
                timeout=10) as resp:
            doc = json.loads(resp.read().decode())
        assert doc["rss_bytes"] > 0 and "slowlog_depth" in doc
        assert doc["profiler_hz"] == 67.0
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.args.metrics_port}/slowlog",
                timeout=10) as resp:
            sl = json.loads(resp.read().decode())
        assert sl["stats"]["capacity"] == 256
        assert isinstance(sl["records"], list)
    finally:
        srv.stop()


def test_server_flags_parse_as_the_jax_parser():
    from jubatus_tpu.server.args import parse_server_args as jparse
    from jubatus_tpu_torch.server.args import parse_server_args

    fields = ("metrics_port", "slowlog_capacity", "slowlog_quantile",
              "slowlog_min_count", "telemetry_interval", "profile_hz",
              "profile_dir", "profile_trigger_breaches",
              "profile_trigger_window")
    for argv in (["classifier", "-f", "/dev/null"],
                 ["classifier", "-f", "/dev/null", "--metrics-port", "0",
                  "--slowlog-capacity", "8", "--slowlog-quantile", "0.9",
                  "--slowlog-min-count", "2", "--telemetry-interval", "1",
                  "--profile-hz", "0", "--profile-dir", "/tmp/p",
                  "--profile-trigger-breaches", "5",
                  "--profile-trigger-window", "3"]):
        got, want = parse_server_args(argv), jparse(argv)
        for f in fields:
            assert getattr(got, f) == getattr(want, f), (argv, f)
    for bad in (["--slowlog-quantile", "0"], ["--slowlog-capacity", "-1"],
                ["--telemetry-interval", "-1"], ["--profile-hz", "1001"],
                ["--profile-trigger-breaches", "-1"],
                ["--profile-trigger-window", "0"],
                ["--metrics-port", "70000"]):
        with pytest.raises(SystemExit):
            parse_server_args(["classifier", "-f", "/dev/null", *bad])
        with pytest.raises(SystemExit):
            jparse(["classifier", "-f", "/dev/null", *bad])


# -- parity with the JAX registry ---------------------------------------------


def _drive(mod, reg) -> None:
    """The same spans (under fixed trace contexts), counters and gauges."""
    reg.slowlog.configure(min_count=4, quantile=0.75)
    for i in range(40):
        ctx = mod.TraceContext(f"{i % 3:016x}", f"{i:016x}", "")
        with mod.use_trace(ctx):
            reg.record("rpc.train", 1e-4 * (1 + (i * 7) % 13))
            reg.record("rpc.classify", 2e-3 * (1 + i % 5))
    reg.record("mix.round", 0.25)
    reg.count("rpc.train.errors", 2)
    reg.count("mix.bytes", 12345)
    reg.gauge("rss_bytes", 1.5e8)
    reg.gauge("shard.count", 4)


def _no_ts(text: str) -> str:
    # an exemplar's trailing field is the wall time it was stamped
    return re.sub(r"(# \{trace_id=\"[0-9a-f]*\"\} \S+) \S+", r"\1", text)


def test_registry_parity_with_the_jax_package():
    jreg, preg = jtracing.Registry(), tracing.Registry()
    _drive(jtracing, jreg)
    _drive(tracing, preg)
    assert preg.snapshot() == jreg.snapshot()
    labels = {"engine": "classifier", "cluster": "c", "node": "n_1"}
    assert _no_ts(preg.prometheus_text(labels)) == \
        _no_ts(jreg.prometheus_text(labels))
    assert "# {trace_id=" in preg.prometheus_text(labels)
    assert preg.trace_status() == jreg.trace_status()
    # merged views fold the same, in either package's merge
    jm = jtracing.merge_snapshots([jreg.snapshot(), jreg.snapshot()])
    pm = tracing.merge_snapshots([preg.snapshot(), preg.snapshot()])
    assert pm == jm
    for q in (0.5, 0.9, 0.99):
        for name in ("rpc.train", "rpc.classify"):
            assert tracing.state_quantile(pm["hists"][name], q) == \
                jtracing.state_quantile(jm["hists"][name], q)
    strip = [{k: v for k, v in r.items() if k != "ts"}
             for r in preg.slowlog.snapshot()]
    assert strip == [{k: v for k, v in r.items() if k != "ts"}
                     for r in jreg.slowlog.snapshot()]
    assert [(r["name"], r["span_id"]) for r in preg.recent_spans()] == \
        [(r["name"], r["span_id"]) for r in jreg.recent_spans()]


def test_folding_parity_with_the_jax_package():
    from jubatus_tpu.utils import profiler as jprof
    from jubatus_tpu_torch.utils.profiler import (fold_profiles,
                                                  folded_lines, render_top,
                                                  top_table)

    folded = {"thread:a;x.py:f;y.py:g": 7, "thread:a;x.py:f": 2,
              "thread:b;z.py:h;z.py:h": 4}
    docs = [{"folded": folded}, {"folded": {"thread:a;x.py:f": 1}}]
    assert fold_profiles(docs) == jprof.fold_profiles(docs)
    assert folded_lines(folded) == jprof.folded_lines(folded)
    assert top_table(folded) == jprof.top_table(folded)
    assert render_top(folded, 5) == jprof.render_top(folded, 5)
