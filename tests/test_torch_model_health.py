"""The port's model-health plane: the metric time-series ring
(``jubatus_tpu_torch/utils/timeseries.py``) and the SLO burn-rate engine
(``utils/slo.py``), mirroring the unit cases of ``tests/test_model_health.py``
and its server cases that need no proxy and no jubactl (mix-round gauges on
every member, staleness, ``get_timeseries``, an SLO burst that fires,
degrades ``/healthz`` and clears, the structured degraded reasons). No case
sleeps through a window: the ring and the SLO engine take explicit
timestamps. Parity: the same ring points give both packages' engines equal
burn rates."""

from __future__ import annotations

import json
import urllib.request

import pytest

from jubatus_tpu_torch.utils import timeseries, tracing
from jubatus_tpu_torch.utils.slo import SloEngine, parse_slo
from jubatus_tpu_torch.utils.timeseries import TimeSeriesRing, window_from_points

CONF = {
    "method": "PA",
    "parameter": {"regularization_weight": 1.0},
    "converter": {"num_rules": [{"key": "*", "type": "num"}]},
}


# -- time-series ring ---------------------------------------------------------


def test_ring_bounds_and_eviction():
    ring = TimeSeriesRing(capacity=5)
    reg = tracing.Registry()
    for i in range(12):
        reg.count("evt")
        assert ring.sample(reg.snapshot(), ts=1000.0 + i)
    assert len(ring) == 5
    pts = ring.points()
    assert [p["ts"] for p in pts] == [1007.0, 1008.0, 1009.0, 1010.0, 1011.0]
    st = ring.stats()
    assert st["sampled"] == 12 and st["retained"] == 5
    assert st["oldest_ts"] == 1007.0 and st["newest_ts"] == 1011.0
    assert ring.points(last=2) == pts[-2:]


def test_ring_spacing_guard_and_force():
    ring = TimeSeriesRing(capacity=8, min_spacing_s=5.0)
    reg = tracing.Registry()
    assert ring.sample(reg.snapshot(), ts=100.0)
    assert not ring.sample(reg.snapshot(), ts=101.0)  # too close
    assert ring.sample(reg.snapshot(), ts=101.0, force=True)
    assert ring.sample(reg.snapshot(), ts=107.0)
    assert len(ring) == 3


def test_window_counter_rates_and_quantiles():
    reg = tracing.Registry()
    ring = TimeSeriesRing(capacity=16)
    for _ in range(100):
        reg.record("rpc.classify", 0.001)
    reg.count("rpc.classify.errors", 2)
    ring.sample(reg.snapshot(), ts=0.0)
    for _ in range(50):
        reg.record("rpc.classify", 0.2)
    reg.count("rpc.classify.errors", 8)
    ring.sample(reg.snapshot(), ts=10.0)
    win = ring.window(60.0)
    assert win is not None
    # only the BETWEEN-points traffic is in the window
    assert win.span_count("rpc.classify") == 50
    assert win.span_rate("rpc.classify") == pytest.approx(5.0)
    assert win.counter_delta("rpc.classify.errors") == 8
    assert win.counter_rate("rpc.classify.errors") == pytest.approx(0.8)
    # windowed p50 reflects the slow burst, not the lifetime histogram
    assert win.quantile_ms("rpc.classify", 0.5) == pytest.approx(200, rel=0.3)
    assert win.bad_fraction("rpc.classify", 0.05) == pytest.approx(1.0)
    assert win.counter_names("rpc.") == ["rpc.classify.errors"]
    assert win.spans("rpc.") == ["rpc.classify"]


def test_window_clamps_after_registry_reset():
    reg = tracing.Registry()
    ring = TimeSeriesRing(capacity=8)
    reg.count("c", 100)
    reg.record("s", 0.01)
    ring.sample(reg.snapshot(), ts=0.0)
    reg.reset()
    reg.count("c", 5)
    ring.sample(reg.snapshot(), ts=10.0)
    win = ring.window(60.0)
    assert win.counter_delta("c") == 0  # clamped, not negative
    assert win.span_count("s") == 0


def test_window_from_points_baseline_selection():
    pts = [{"ts": float(t), "hists": {}, "counters": {"c": t}, "gauges": {}}
           for t in (0, 10, 20, 30)]
    win = window_from_points(pts, 15.0)  # start at 30-15=15 -> baseline 10
    assert win.baseline["ts"] == 10.0
    assert win.counter_delta("c") == 20
    # window longer than the ring: falls back to the oldest point
    win = window_from_points(pts, 1000.0)
    assert win.baseline["ts"] == 0.0
    assert window_from_points(pts[:1], 10.0) is None


def test_hist_state_delta_is_window_histogram():
    a, b = tracing.Histogram(), None
    for _ in range(10):
        a.record(0.001)
    before = a.state()
    for _ in range(10):
        a.record(1.0)
    d = timeseries.hist_state_delta(a.state(), before)
    assert d["count"] == 10
    assert tracing.state_quantile(d, 0.5) == pytest.approx(1.0, rel=0.3)
    d0 = timeseries.hist_state_delta(a.state(), b)  # no baseline
    assert d0["count"] == 20


# -- slo grammar + burn math --------------------------------------------------


def test_parse_slo_grammar():
    s = parse_slo("latency:rpc.classify:p99:50")
    assert s.kind == "latency" and s.span == "rpc.classify"
    assert s.threshold_s == pytest.approx(0.05)
    assert s.objective == pytest.approx(0.01)
    assert s.name == "rpc.classify.p99"
    s = parse_slo("hot=latency:rpc.train:p90:20:0.2")
    assert s.name == "hot" and s.objective == pytest.approx(0.2)
    s = parse_slo("error_rate:*:0.01")
    assert s.kind == "error_rate" and s.span == "*"
    s = parse_slo("gauge:mix.ef_residual_drift_rate:0.05")
    assert s.kind == "gauge" and s.ceiling == pytest.approx(0.05)
    for bad in ("latency:rpc.x:q99:50", "latency:rpc.x:p99:0",
                "error_rate:*:1.5", "gauge:k:0", "nope:x:y",
                "latency:rpc.x:p99", "error_rate:*"):
        with pytest.raises(ValueError):
            parse_slo(bad)


def _ticked(reg, ring, ts):
    ring.sample(reg.snapshot(), ts=ts)


def test_burn_rate_fires_and_clears():
    """Multi-window burn math on a synthetic timeline: an error/latency
    burst fires (both windows above threshold), recovery clears (the
    fast window moves past the burst while the slow one still sees
    it)."""
    reg = tracing.Registry()
    ring = TimeSeriesRing(capacity=32)
    eng = SloEngine(
        [parse_slo("latency:rpc.classify:p99:50"),
         parse_slo("error_rate:*:0.01")],
        ring, reg, fast_window_s=30.0, slow_window_s=120.0,
        burn_threshold=2.0)
    t0 = 10_000.0
    for _ in range(200):
        reg.record("rpc.classify", 0.001)
    _ticked(reg, ring, t0)
    # quiet period: no burn
    for _ in range(100):
        reg.record("rpc.classify", 0.001)
    _ticked(reg, ring, t0 + 20)
    st = {s["name"]: s for s in eng.evaluate(now=t0 + 20)}
    assert not st["rpc.classify.p99"]["firing"]
    assert not st["errors.*"]["firing"]
    # burst: slow requests + errors
    for _ in range(50):
        reg.record("rpc.classify", 0.4)
    reg.count("rpc.classify.errors", 10)
    _ticked(reg, ring, t0 + 40)
    st = {s["name"]: s for s in eng.evaluate(now=t0 + 40)}
    assert st["rpc.classify.p99"]["firing"]
    assert st["errors.*"]["firing"]
    assert st["errors.*"]["burn_fast"] > 2.0
    assert reg.gauges()["slo.rpc.classify.p99.firing"] == 1.0
    assert reg.counters()["slo.transitions"] == 2
    assert len(eng.alerts()) == 2
    # recovery: healthy traffic, fast window moves past the burst
    for _ in range(300):
        reg.record("rpc.classify", 0.001)
    _ticked(reg, ring, t0 + 80)
    for _ in range(300):
        reg.record("rpc.classify", 0.001)
    _ticked(reg, ring, t0 + 110)
    st = {s["name"]: s for s in eng.evaluate(now=t0 + 110)}
    assert not st["rpc.classify.p99"]["firing"]
    assert not st["errors.*"]["firing"]
    assert eng.alerts() == []
    assert reg.gauges()["slo.rpc.classify.p99.firing"] == 0.0


def test_gauge_slo_burns_on_windowed_mean():
    reg = tracing.Registry()
    ring = TimeSeriesRing(capacity=8)
    eng = SloEngine([parse_slo("gauge:mix.drift:0.1")], ring, reg,
                    fast_window_s=30, slow_window_s=60, burn_threshold=2.0)
    reg.gauge("mix.drift", 0.05)
    _ticked(reg, ring, 0.0)
    reg.gauge("mix.drift", 0.05)
    _ticked(reg, ring, 10.0)
    st = eng.evaluate(now=10.0)[0]
    assert st["burn_fast"] == pytest.approx(0.5) and not st["firing"]
    reg.gauge("mix.drift", 0.4)
    _ticked(reg, ring, 20.0)
    st = eng.evaluate(now=20.0)[0]
    assert st["burn_fast"] > 2.0 and st["firing"]


# -- parity: equal burn rates on the same ring points --------------------------


def _timeline(reg, ring, jring, t0):
    """One registry's snapshots, sampled into both packages' rings at the
    same timestamps: quiet, a latency and error burst, recovery."""
    steps = [(200, 0.001, 0), (100, 0.001, 0), (50, 0.4, 10), (300, 0.001, 0),
             (300, 0.001, 0)]
    for k, (n, sec, errs) in enumerate(steps):
        for _ in range(n):
            reg.record("rpc.classify", sec)
        if errs:
            reg.count("rpc.classify.errors", errs)
        reg.gauge("quality.drift.max", 0.05 if k < 2 else 0.5)
        snap = reg.snapshot()
        ring.sample(snap, ts=t0 + 20.0 * k)
        jring.sample(snap, ts=t0 + 20.0 * k)
        yield t0 + 20.0 * k


def test_parity_burn_rates_on_the_same_ring_points():
    from jubatus_tpu.utils import tracing as jtracing
    from jubatus_tpu.utils.slo import SloEngine as JSloEngine
    from jubatus_tpu.utils.slo import parse_slo as jparse_slo
    from jubatus_tpu.utils.timeseries import TimeSeriesRing as JRing

    specs = ["latency:rpc.classify:p99:50", "error_rate:*:0.01",
             "drift=gauge:quality.drift.max:0.1"]
    reg = tracing.Registry()
    ring, jring = TimeSeriesRing(capacity=32), JRing(capacity=32)
    preg, jreg = tracing.Registry(), jtracing.Registry()
    eng = SloEngine([parse_slo(s) for s in specs], ring, preg,
                    fast_window_s=30.0, slow_window_s=120.0,
                    burn_threshold=2.0)
    jeng = JSloEngine([jparse_slo(s) for s in specs], jring, jreg,
                      fast_window_s=30.0, slow_window_s=120.0,
                      burn_threshold=2.0)
    fired = set()
    for now in _timeline(reg, ring, jring, 50_000.0):
        got, want = eng.evaluate(now=now), jeng.evaluate(now=now)
        assert got == want
        fired |= {s["name"] for s in got if s["firing"]}
        assert preg.gauges() == jreg.gauges()
    assert fired == {"rpc.classify.p99", "errors.*", "drift"}
    assert eng.alerts() == jeng.alerts()
    assert ring.points() == jring.points()


# -- servers -------------------------------------------------------------------


@pytest.fixture()
def health_cluster(tmp_path):
    """Three port members mixing through a file coordinator, SLOs set, the
    telemetry thread off (the tests drive the ticks)."""
    from jubatus_tpu_torch.rpc.client import ClassifierClient
    from jubatus_tpu_torch.core.datum import Datum
    from jubatus_tpu_torch.server import EngineServer
    from jubatus_tpu_torch.server.args import ServerArgs

    coord_dir = str(tmp_path / "coord")
    servers = []
    for _ in range(3):
        srv = EngineServer(
            "classifier", CONF,
            ServerArgs(engine="classifier", coordinator=coord_dir,
                       name="mh", listen_addr="127.0.0.1",
                       interval_sec=1e9, interval_count=1 << 30,
                       telemetry_interval=0, datadir=str(tmp_path),
                       slo=["latency:rpc.classify:p99:50",
                            "error_rate:*:0.01"],
                       slo_fast_window=30.0, slo_slow_window=120.0,
                       metrics_port=0),
            device="cpu")
        srv.start(0)
        servers.append(srv)
    # DIFFERENT data per node, so contributions diverge
    for i, s in enumerate(servers):
        with ClassifierClient("127.0.0.1", s.args.rpc_port, "mh") as c:
            c.train([[f"l{i}", Datum({"x": float(i + 1)}).to_msgpack()],
                     [f"l{(i + 1) % 3}",
                      Datum({"x": -2.0 * i - 1}).to_msgpack()]])
            for _ in range(20):
                c.classify([Datum({"x": 1.0}).to_msgpack()])
    yield coord_dir, servers
    for s in servers:
        s.stop()


def test_mix_round_gauges_on_every_member(health_cluster):
    """One mix round: divergence, staleness and update-norm gauges on
    every member; health stamped in the flight record and get_status."""
    _coord, servers = health_cluster
    res = servers[0].mixer.mix_now()
    assert res is not None and res["health"]["contributors"] == 3
    assert res["health"]["premix_divergence_max"] > 0
    assert res["health"]["staleness_max"] == 0
    for s in servers:
        g = s.trace.gauges()
        assert g["mix.premix_divergence_mean"] > 0
        assert g["mix.premix_divergence_max"] >= g["mix.premix_divergence_mean"]
        assert g["mix.update_norm"] > 0
        assert g["mix.self_staleness"] == 0.0
        assert g["mix.staleness_max"] == 0.0
        assert g["mix.contributors"] == 3.0
    rec = servers[0].mixer.flight.snapshot()[-1]
    assert rec["health"]["contributors"] == 3
    st = next(iter(servers[1].get_status().values()))
    assert st["mixer.health_update_norm"] > 0
    assert st["health.status"] == "ok" and st["health.reasons"] == []
    assert st["slo.configured"] == 2 and st["slo.firing"] == 0


def test_staleness_tracks_missing_member(health_cluster):
    """A member whose get_diff keeps failing goes stale in the master's
    ledger; the health dict every member receives says so."""
    _coord, servers = health_cluster
    assert servers[0].mixer.mix_now() is not None
    servers[2].rpc.stop()  # wedge member 2's mix_get_diff
    res = None
    for _ in range(2):
        res = servers[0].mixer.mix_now()
    assert res is not None
    victim = servers[2].self_nodeinfo().name
    assert res["health"]["staleness"][victim] >= 2
    assert res["health"]["staleness_max"] >= 2
    assert res["degraded"] is True
    assert servers[0].trace.gauges()["mix.staleness_max"] >= 2


def test_get_timeseries_rpc_and_windowed_rates(health_cluster):
    from jubatus_tpu_torch.rpc.client import RpcClient

    _coord, servers = health_cluster
    srv = servers[0]
    srv._model_health_tick()
    for _ in range(10):
        srv.trace.record("rpc.classify", 0.002)
    srv._model_health_tick()
    with RpcClient("127.0.0.1", srv.args.rpc_port) as c:
        ts = c.call("get_timeseries", "mh")
    node = srv.self_nodeinfo().name
    assert list(ts) == [node]
    points = ts[node]["points"]
    assert len(points) >= 2
    assert ts[node]["stats"]["retained"] == len(points)
    win = window_from_points(points, 60.0)
    assert win.span_count("rpc.classify") >= 10
    st = next(iter(srv.get_status().values()))
    assert st["timeseries.retained"] >= 2
    # the tick gauged the coalescer before sampling
    assert "microbatch.queue_depth" in points[-1]["gauges"]


def _healthz(srv):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.args.metrics_port}/healthz",
            timeout=10) as resp:
        return json.loads(resp.read().decode())


def test_slo_burst_fires_degrades_healthz_then_clears(health_cluster,
                                                      monkeypatch):
    """An injected latency and error burst fires a burn-rate alert that
    get_alerts lists, degrades /healthz and bundles one incident; recovery
    clears it. The server's own tick runs, on a clock the test sets."""
    import types

    from jubatus_tpu_torch.rpc.client import RpcClient
    from jubatus_tpu_torch.utils import slo as slo_mod

    now = [1_000_000.0]
    clock = types.SimpleNamespace(time=lambda: now[0])
    monkeypatch.setattr(timeseries, "time", clock)
    monkeypatch.setattr(slo_mod, "time", clock)
    _coord, servers = health_cluster
    srv = servers[0]
    reg = srv.trace
    for _ in range(100):
        reg.record("rpc.classify", 0.001)
    srv._model_health_tick()
    now[0] += 20.0
    for _ in range(40):
        reg.record("rpc.classify", 0.5)
    reg.count("rpc.classify.errors", 10)
    srv._model_health_tick()
    assert len(srv.slo.alerts()) == 2
    doc = _healthz(srv)
    assert doc["status"] == "degraded"
    assert "slo_firing" in {r["kind"] for r in doc["degraded_reasons"]}
    assert doc["slo_firing"] == 2
    with RpcClient("127.0.0.1", srv.args.rpc_port) as c:
        alerts = c.call("get_alerts", "mh")
        incidents = c.call("get_incidents", "mh", "")
    node = srv.self_nodeinfo().name
    assert {a["name"] for a in alerts[node]["alerts"]} == \
        {"rpc.classify.p99", "errors.*"}
    # the first SLO going to firing bundled one incident; the second and
    # /healthz's transition fall in its debounce window
    bundles = incidents[node]["incidents"]
    assert len(bundles) == 1
    assert bundles[0]["reason"].startswith("slo_firing:")
    assert srv.incidents.stats()["suppressed"] >= 1
    # recovery: healthy traffic moves the fast window past the burst
    for step in (40.0, 50.0, 30.0):
        now[0] += step
        for _ in range(400):
            reg.record("rpc.classify", 0.001)
        srv._model_health_tick()
    assert srv.slo.alerts() == []
    assert _healthz(srv)["status"] == "ok"


def test_degraded_reasons_cover_mix_states(health_cluster):
    """Structured /healthz reasons: a quorum-degraded round and an
    obsolete model show up with their kinds (no SLO involved)."""
    _coord, servers = health_cluster
    srv = servers[1]
    srv.mixer.last_round_degraded = True
    srv.mixer._obsolete = True
    kinds = {r["kind"] for r in srv._degraded_reasons()}
    assert {"mix_quorum_degraded", "model_obsolete"} <= kinds
    assert srv._health()["status"] == "degraded"
    srv.mixer.last_round_degraded = False
    srv.mixer._obsolete = False
    assert srv._health()["status"] == "ok"


def test_timeseries_capacity_zero_disables_ring_and_slos(tmp_path):
    from jubatus_tpu_torch.server import EngineServer
    from jubatus_tpu_torch.server.args import ServerArgs

    srv = EngineServer("classifier", CONF, ServerArgs(
        engine="classifier", listen_addr="127.0.0.1", telemetry_interval=0,
        timeseries_capacity=0, datadir=str(tmp_path)), device="cpu")
    srv.start(0)
    try:
        assert srv.timeseries is None and srv.slo is None
        key = srv._node_key()
        assert srv.get_timeseries() == {key: {"stats": {}, "points": []}}
        assert srv.get_alerts() == {key: {"alerts": [], "slos": []}}
        srv._model_health_tick()  # a no-op without the ring
        st = next(iter(srv.get_status().values()))
        assert "timeseries.retained" not in st and "slo.firing" not in st
    finally:
        srv.stop()
