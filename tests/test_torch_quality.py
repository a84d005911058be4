"""The port's data-quality plane (``jubatus_tpu_torch/utils/quality.py``),
mirroring ``tests/test_quality.py`` (PSI/KL scores, prequential and
calibration math, the plane's windows and gauges under an injected clock,
the fleet fold and the incident slice; its proxy fold waits for the port's
proxy, and ``merge_quality`` is tested here as a unit), plus parity: a JAX
server and a port server fed the same train stream under
``--quality-sample 1.0`` report equal prequential totals and drift."""

from __future__ import annotations

import numpy as np
import pytest

from jubatus_tpu_torch.utils import quality, sketches, tracing
from jubatus_tpu_torch.utils.quality import (
    QualityPlane, calibration_ece, group_of, kl_from_freqs,
    merge_prequential, merge_quality, prequential_accuracy,
    prequential_mae, psi_from_freqs, psi_value_states, value_freqs,
)

CONF = {
    "method": "PA",
    "parameter": {"regularization_weight": 1.0},
    "converter": {"num_rules": [{"key": "*", "type": "num"}]},
}


def _value_state(values) -> dict:
    sk = sketches.ValueSketch()
    sk.observe_array(np.asarray(values, dtype=np.float64))
    return sk.state()


# -- drift scores ------------------------------------------------------------


def test_psi_zero_on_identical_and_grows_with_shift():
    rng = np.random.default_rng(1)
    base = rng.uniform(0.0, 1.0, size=2000)
    same = psi_value_states(_value_state(base), _value_state(base))
    assert same == pytest.approx(0.0, abs=1e-9)
    small = psi_value_states(_value_state(base),
                             _value_state(base * 1.05))
    big = psi_value_states(_value_state(base),
                           _value_state(base + 0.8))
    assert 0.0 <= small < big
    assert big > quality.DEFAULT_DRIFT_THRESHOLD


def test_psi_symmetric_kl_not():
    p = {"a": 0.8, "b": 0.2}
    q = {"a": 0.3, "b": 0.7}
    assert psi_from_freqs(p, q) == pytest.approx(psi_from_freqs(q, p))
    assert psi_from_freqs(p, q) == pytest.approx(
        kl_from_freqs(p, q) + kl_from_freqs(q, p))
    assert psi_from_freqs({}, {}) == 0.0
    # disjoint support stays finite (smoothing)
    assert np.isfinite(psi_from_freqs({"a": 1.0}, {"b": 1.0}))


def test_value_freqs_coarsens_and_normalizes():
    st = _value_state([1.0] * 60 + [-1.0] * 40)
    fr = value_freqs(st)
    assert sum(fr.values()) == pytest.approx(1.0)
    # octave coarsening: strictly fewer support points than raw bins
    assert len(fr) <= len(st["bins"])


def test_group_of_prefix_rules():
    assert group_of("ch003") == "ch"
    assert group_of("user@str$tokyo") == "user"
    assert group_of("age") == "age"
    assert group_of("7seas") == "other"
    assert group_of("") == "other"


# -- prequential + calibration -----------------------------------------------


def test_prequential_merge_and_scores():
    a = quality._empty_prequential()
    a.update(n=10, correct=7, abs_err=2.0, sq_err=1.0)
    b = quality._empty_prequential()
    b.update(n=30, correct=18, abs_err=6.0, sq_err=3.0)
    m = merge_prequential([a, b, {}])
    assert m["n"] == 40 and m["correct"] == 25
    assert prequential_accuracy(m) == pytest.approx(25 / 40)
    assert prequential_mae(m) == pytest.approx(8.0 / 40)
    assert prequential_accuracy({"n": 0}) is None


def test_calibration_ece_weighted_gap():
    st = quality._empty_prequential()
    # bin 9: 100 rows at conf 0.95, 60% right -> gap 0.35
    st["conf"][9] = [100, 60, 95.0]
    # bin 5: 100 rows at conf 0.55, 55% right -> gap 0.0
    st["conf"][5] = [100, 55, 55.0]
    assert calibration_ece(st) == pytest.approx(0.5 * 0.35 + 0.5 * 0.0)
    assert calibration_ece(quality._empty_prequential()) is None


def test_record_classified_uses_top_ranked_and_bins_confidence():
    plane = QualityPlane(sample=1.0, window_s=60.0)
    plane.record_classified("a", [("a", 5.0), ("b", 0.0)])
    plane.record_classified("a", [("b", 5.0), ("a", 0.0)])
    snap = plane.snapshot()
    preq = snap["prequential"]
    assert preq["n"] == 2 and preq["correct"] == 1
    assert sum(r[0] for r in preq["conf"]) == 2
    # the prediction-output sketch saw both winners
    assert snap["live"]["predictions"]["total"] == 2


# -- sampling gate -----------------------------------------------------------


def test_admit_stride_sampler_is_deterministic():
    plane = QualityPlane(sample=0.25, window_s=60.0)
    hits = [plane.admit("fv") for _ in range(100)]
    assert sum(hits) == 25
    # a second gate strides independently
    assert sum(plane.admit("train") for _ in range(8)) == 2
    off = QualityPlane(sample=0.0, window_s=60.0)
    assert not any(off.admit("fv") for _ in range(10))


# -- plane windowing + drift gauges ------------------------------------------


def _plane(reg=None, **kw):
    kw.setdefault("sample", 1.0)
    kw.setdefault("window_s", 1.0)
    kw.setdefault("ref_windows", 1)
    kw.setdefault("drift_min_count", 10)
    return QualityPlane(registry=reg, **kw)


def test_plane_rolls_windows_pins_reference_and_scores_drift():
    reg = tracing.Registry()
    plane = _plane(reg)
    rng = np.random.default_rng(2)
    plane.tick(now=1000.0)  # stamps the live window start
    names = ["ch%d" % i for i in range(100)]
    plane.record_named(names, rng.uniform(0.0, 1.0, size=100))
    g = plane.tick(now=1002.0)  # rolls window 1 -> reference pinned
    assert plane.ring.reference is not None
    assert g["quality.drift.max"] == 0.0  # nothing to compare yet
    plane.record_named(names, rng.uniform(0.0, 1.0, size=100) + 0.8)
    g = plane.tick(now=1004.0)  # rolls the shifted window, scores it
    assert g["quality.drift.ch"] > quality.DEFAULT_DRIFT_THRESHOLD
    assert g["quality.drift.max"] == g["quality.drift.ch"]
    gauges = reg.gauges()
    assert gauges["quality.drift.ch"] == g["quality.drift.ch"]
    assert gauges["quality.drift.max"] == g["quality.drift.max"]
    assert reg.counters()["quality.recorded_values"] == 200
    snap = plane.snapshot()
    assert snap["drift"]["ch"] == g["quality.drift.ch"]
    assert snap["stats"]["reference_pinned"]
    assert [p["drift_max"] for p in snap["trend"]][-1] > 0.2


def test_drift_max_rollup_excludes_model_output_keys():
    """quality.drift.max pages on INPUT drift only: a cold model's
    prediction mix swinging between windows moves its own
    quality.drift.label_predictions gauge but must not move the
    roll-up the input-drift SLO rides."""
    plane = _plane()
    names = ["ch%d" % i for i in range(50)]
    vals = np.linspace(0.05, 0.95, 50)  # byte-identical both windows
    plane.tick(now=1000.0)
    plane.record_named(names, vals)
    for _ in range(20):
        plane.record_classified("a", [("a", 3.0), ("b", 0.0)])
    plane.tick(now=1002.0)  # reference: stable inputs, all-"a" outputs
    plane.record_named(names, vals)
    for _ in range(20):
        plane.record_classified("a", [("b", 3.0), ("a", 0.0)])
    g = plane.tick(now=1004.0)  # output mix flipped, inputs identical
    assert g["quality.drift.label_predictions"] > 1.0
    assert g["quality.drift.ch"] == 0.0
    assert g["quality.drift.max"] == 0.0


def test_plane_prequential_gauges_publish_on_tick():
    reg = tracing.Registry()
    plane = _plane(reg)
    for i in range(20):
        truth = "a" if i < 15 else "b"
        plane.record_classified(truth, [("a", 3.0), ("b", 0.0)])
    g = plane.tick(now=50.0)
    assert g["quality.prequential.accuracy"] == pytest.approx(0.75)
    assert g["quality.prequential.error_rate"] == pytest.approx(0.25)
    assert "quality.calibration.ece" in g
    assert reg.gauges()["quality.prequential.accuracy"] == \
        pytest.approx(0.75)
    assert reg.counters()["quality.scored_rows"] == 20
    st = plane.stats()
    assert st["scored_rows"] == 20
    assert st["prequential_accuracy"] == pytest.approx(0.75)


def test_plane_group_cap_overflows_not_grows():
    plane = _plane()
    for i in range(quality.MAX_GROUPS + 20):
        plane.record_named(["grp%s@x" % chr(97 + i % 26) * (i // 26 + 1)],
                           np.array([1.0]))
    snap = plane.snapshot()
    assert snap["stats"]["groups"] <= quality.MAX_GROUPS + 1
    # past the cap new names fold into the overflow group
    plane2 = _plane()
    for i in range(quality.MAX_GROUPS):
        plane2._group_sketch("g%s" % i if False else "u" + "x" * i)
    assert plane2._group_sketch("brand_new") is \
        plane2._groups[quality.OVERFLOW_GROUP]


def test_plane_small_live_window_holds_last_drift_via_ring():
    """Mid-window (too few live values) the tick scores the NEWEST
    completed window instead of noise."""
    plane = _plane(drift_min_count=50)
    rng = np.random.default_rng(4)
    plane.tick(now=0.0)
    plane.record_named(["v%d" % i for i in range(200)],
                       rng.uniform(size=200))
    plane.tick(now=2.0)  # reference
    plane.record_named(["v%d" % i for i in range(200)],
                       rng.uniform(size=200) + 1.0)
    g1 = plane.tick(now=4.0)  # shifted window rolled
    assert g1["quality.drift.v"] > 0.2
    # 3 live values < min_count: drift keeps scoring the rolled window
    plane.record_named(["v1", "v2", "v3"], np.array([9.0, 9.0, 9.0]))
    g2 = plane.tick(now=4.5)
    assert g2["quality.drift.v"] == g1["quality.drift.v"]


def test_incident_doc_names_top_group_with_sketch_pair():
    plane = _plane()
    rng = np.random.default_rng(6)
    plane.tick(now=0.0)
    plane.record_named(["se%d" % i for i in range(100)],
                       rng.uniform(size=100))
    plane.record_named(["ch%d" % i for i in range(100)],
                       rng.uniform(size=100))
    plane.tick(now=2.0)
    plane.record_named(["se%d" % i for i in range(100)],
                       rng.uniform(size=100))          # stable group
    plane.record_named(["ch%d" % i for i in range(100)],
                       rng.uniform(size=100) + 2.0)    # shifted group
    plane.tick(now=4.0)
    doc = plane.incident_doc()
    assert doc["top_drift_group"] == "ch"
    assert doc["drift"]["ch"] > doc["drift"]["se"]
    assert doc["reference_sketch"]["count"] == 100
    assert doc["live_sketch"]["count"] == 100


# -- fleet folds -------------------------------------------------------------


def test_merge_quality_recomputes_drift_from_merged_sketches():
    """Two half-fleet nodes with opposite half-shifts: the fold merges
    sketches and rescoring sees the TRUE fleet drift, not an average of
    node scores."""
    rng = np.random.default_rng(8)
    docs = []
    for shift in (0.0, 0.8):
        plane = _plane()
        plane.tick(now=0.0)
        plane.record_named(["ad%d" % i for i in range(200)],
                           rng.uniform(size=200))
        plane.tick(now=2.0)
        plane.record_named(["ad%d" % i for i in range(200)],
                           rng.uniform(size=200) + shift)
        for i in range(10):
            plane.record_classified("a", [("a", 1.0), ("b", 0.0)])
        plane.tick(now=2.5)  # mid-window: live sketches stay populated
        docs.append(plane.snapshot())
    fleet = merge_quality(docs)
    assert fleet["nodes"] == 2
    # node gauges score COMPLETED windows only, so mid-window both
    # still read 0.0 — while the fold, rescoring the MERGED live
    # sketches (clean half + shifted half), already sees the fleet
    # truth no per-node score carries yet: recomputed, not averaged
    per_node = [d["drift"].get("ad", 0.0) for d in docs]
    assert per_node == [0.0, 0.0]
    assert fleet["drift"]["ad"] > quality.DEFAULT_DRIFT_THRESHOLD
    assert fleet["prequential"]["n"] == 20
    assert fleet["reference"]["features"]["ad"]["count"] == 400
    assert fleet["live"]["features"]["ad"]["count"] == 400
    assert len(fleet["trend"]) > 0


def test_merge_quality_falls_back_to_node_drift_mid_window():
    """A node whose live window just rolled ships empty live sketches;
    its last computed drift still reaches the fleet doc (per-key max)."""
    doc = {"reference": None, "live": None,
           "drift": {"ch": 3.1, "labels": 0.4},
           "prequential": quality._empty_prequential(),
           "trend": [], "sample": 0.1}
    worse = dict(doc, drift={"ch": 5.2})
    fleet = merge_quality([doc, {}, worse])
    assert fleet["drift"] == {"ch": 5.2, "labels": 0.4}  # per-key max
    assert fleet["nodes"] == 2
    assert fleet["sample"] == 0.1


# -- parity: a JAX server and a port server on one train stream --------------

PARITY_CONF = {
    "method": "AROW",
    "parameter": {"regularization_weight": 1.0},
    "converter": {
        "num_rules": [{"key": "*", "type": "num"}],
        "string_rules": [{"key": "*", "type": "str", "sample_weight": "bin",
                          "global_weight": "bin"}]},
}
REG_CONF = {
    "method": "PA",
    "parameter": {"sensitivity": 0.1, "regularization_weight": 3.0},
    "converter": {"num_rules": [{"key": "*", "type": "num"}]},
}


def _stream(seed, n=192, shift_at=96):
    """Seeded classifier rows whose label mix and feature scale shift
    after ``shift_at``."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        late = i >= shift_at
        lab = ("a" if rng.random() < (0.2 if late else 0.8) else "b")
        x = float(rng.normal(loc=(2.0 if lab == "a" else -2.0)))
        rows.append((lab, {"x": x * (3.0 if late else 1.0),
                           "y": float(rng.uniform()),
                           "c": "k%d" % int(rng.integers(4))}))
    return rows


def _both_servers(monkeypatch, engine, conf, **flags):
    """One JAX server on its Python paths and one port server on the CPU,
    both with the telemetry thread off (the test drives the windows)."""
    from jubatus_tpu.server import EngineServer as JServer
    from jubatus_tpu.server.args import ServerArgs as JArgs
    from jubatus_tpu_torch.server import EngineServer
    from jubatus_tpu_torch.server.args import ServerArgs

    # the native transport and ingest parse are fast paths that record
    # through other paths (the parse scores hashed features): compare
    # both packages on the generic path
    monkeypatch.setenv("JUBATUS_TPU_NATIVE_RPC", "0")
    monkeypatch.setenv("JUBATUS_TPU_NATIVE_INGEST", "0")
    common = dict(engine=engine, listen_addr="127.0.0.1",
                  telemetry_interval=0, quality_sample=1.0,
                  quality_window=1.0, quality_ref_windows=1, **flags)
    jsrv = JServer(engine, conf, args=JArgs(**common))
    psrv = EngineServer(engine, conf, ServerArgs(**common), device="cpu")
    jsrv.start(0)
    psrv.start(0)
    return jsrv, psrv


def _feed(port, rows, to_wire, tenant):
    from jubatus_tpu_torch.core.datum import Datum
    from jubatus_tpu_torch.rpc import principal as principals
    from jubatus_tpu_torch.rpc.client import RpcClient

    with principals.use(tenant), RpcClient("127.0.0.1", port, 30.0) as c:
        for i in range(0, len(rows), 16):
            c.call("train", "", [[to_wire(t), Datum(d).to_msgpack()]
                                 for t, d in rows[i:i + 16]])


def _get(port, method):
    from jubatus_tpu_torch.rpc.client import RpcClient

    with RpcClient("127.0.0.1", port, 30.0) as c:
        (doc,) = c.call(method, "").values()
    return doc


def test_parity_classifier_prequential_totals_and_drift(monkeypatch):
    """Every train batch is scored on the current model before it trains
    (test-then-train) in both servers: equal counts and correct counts,
    confidence bins within float32 score order (rel 1e-5), equal input
    drift once the shifted half has rolled a window."""
    jsrv, psrv = _both_servers(monkeypatch, "classifier", PARITY_CONF)
    try:
        rows = _stream(5)
        base = 1_000_000.0
        for srv in (jsrv, psrv):
            srv.quality.tick(now=base)
        for srv in (jsrv, psrv):
            _feed(srv.rpc.port, rows[:96], str, "tenant-a")
            srv.quality.tick(now=base + 2.0)
            _feed(srv.rpc.port, rows[96:], str, "tenant-b")
            srv.quality.tick(now=base + 4.0)
        jdoc = _get(jsrv.rpc.port, "get_quality")
        pdoc = _get(psrv.rpc.port, "get_quality")
        jp, pp = jdoc["prequential"], pdoc["prequential"]
        # 12 calls, 8 scored rows each; the first meets a model with no
        # labels yet, whose empty ranking scores nothing
        assert pp["n"] == jp["n"] == 11 * 8
        assert pp["correct"] == jp["correct"]
        assert [r[:2] for r in pp["conf"]] == [r[:2] for r in jp["conf"]]
        for pr, jr in zip(pp["conf"], jp["conf"]):
            assert pr[2] == pytest.approx(jr[2], rel=1e-5)
        assert set(pdoc["drift"]) == set(jdoc["drift"])
        for k, v in jdoc["drift"].items():
            assert pdoc["drift"][k] == pytest.approx(v, rel=1e-9, abs=1e-12)
        assert pdoc["drift"]["x"] > DEFAULT_SHIFT
        for win in ("live", "reference"):
            _same_window(pdoc[win], jdoc[win])
        assert pdoc["stats"]["recorded_rows"] == \
            jdoc["stats"]["recorded_rows"] > 0
    finally:
        jsrv.stop()
        psrv.stop()


def _same_window(p, j):
    """Two window docs agree: sketches and counts exactly, the confidence
    sums within float32 score order; the wall-clock stamp aside."""
    p, j = dict(p), dict(j)
    p.pop("ts"), j.pop("ts")
    pc, jc = p.pop("prequential"), j.pop("prequential")
    assert p == j
    assert {k: v for k, v in pc.items() if k != "conf"} == \
        {k: v for k, v in jc.items() if k != "conf"}
    for pr, jr in zip(pc["conf"], jc["conf"]):
        assert pr[:2] == jr[:2]
        assert pr[2] == pytest.approx(jr[2], rel=1e-5)


#: PSI past which the shifted half counts as drift
DEFAULT_SHIFT = quality.DEFAULT_DRIFT_THRESHOLD


def test_parity_regression_prequential_mae(monkeypatch):
    """The regression server scores its estimate before each train:
    equal counts, and MAE within float32 (rel 1e-5)."""
    jsrv, psrv = _both_servers(monkeypatch, "regression", REG_CONF)
    rng = np.random.default_rng(6)
    rows = [(float(3.0 * x - 1.0), {"x": float(x), "z": float(z)})
            for x, z in rng.normal(size=(128, 2))]
    try:
        for srv in (jsrv, psrv):
            _feed(srv.rpc.port, rows, float, "tenant-a")
        jp = _get(jsrv.rpc.port, "get_quality")["prequential"]
        pp = _get(psrv.rpc.port, "get_quality")["prequential"]
        assert pp["n"] == jp["n"] == 8 * 8
        assert pp["abs_err"] == pytest.approx(jp["abs_err"], rel=1e-5)
        assert pp["sq_err"] == pytest.approx(jp["sq_err"], rel=1e-5)
        assert prequential_mae(pp) == pytest.approx(prequential_mae(jp),
                                                    rel=1e-5)
    finally:
        jsrv.stop()
        psrv.stop()


def test_scoring_failure_never_reaches_ingest(monkeypatch):
    """A prequential scorer that raises is counted and logged; the train
    call still answers and trains."""
    from jubatus_tpu_torch.core.datum import Datum
    from jubatus_tpu_torch.rpc.client import RpcClient
    from jubatus_tpu_torch.server import EngineServer
    from jubatus_tpu_torch.server.args import ServerArgs

    srv = EngineServer("classifier", PARITY_CONF, ServerArgs(
        engine="classifier", listen_addr="127.0.0.1", telemetry_interval=0,
        quality_sample=1.0), device="cpu")
    srv.start(0)
    try:
        def boom(*_args):
            raise RuntimeError("scorer down")

        # the decoded path scores through classify, the raw path through
        # classify_hashed
        monkeypatch.setattr(srv.driver, "classify", boom)
        monkeypatch.setattr(srv.driver, "classify_hashed", boom)
        with RpcClient("127.0.0.1", srv.rpc.port, 30.0) as c:
            assert c.call("train", "", [["a", Datum({"x": 1.0})
                                         .to_msgpack()]]) == 1
        assert srv.driver.update_count == 1
        assert srv.trace.counters()["quality.score_errors"] == 1
    finally:
        srv.stop()
