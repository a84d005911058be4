"""The port's anomaly (LOF) driver against the JAX package's, on the CPU.

Mirrors the anomaly cases of tests/test_knn_engines.py (each run on both
packages) and adds LOF over nested lsh and minhash, the methods whose
support rebuild runs the signature scan batched (up to 256 queries a call).

Tie rule: both packages compute the LOF support and score on the host in
numpy (sort / argsort / argpartition over the same [n, C] float32
distances), so the same distances give the same scores. Over lsh and
minhash the distances are equal, and the scores must be bit-equal; over
euclid_lsh and the exact euclid method the distances agree within float32
rounding, and scores within rtol 1e-4 (a distance error of a few ulps
moves kdist, the reach distances and the lrd ratio by a few ulps each).
"""

from __future__ import annotations

import math

import numpy as np
import pytest

from jubatus_tpu.core.datum import Datum as JDatum
from jubatus_tpu.models.anomaly import AnomalyDriver as JDriver
from jubatus_tpu_torch import convert
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.models.anomaly import AnomalyDriver

CONV = {
    "string_rules": [{"key": "*", "type": "str", "sample_weight": "bin",
                      "global_weight": "bin"}],
    "num_rules": [{"key": "*", "type": "num"}],
}
ANOMALY_CFG = {
    "converter": CONV,
    "method": "lof",
    "parameter": {"nearest_neighbor_num": 3,
                  "reverse_nearest_neighbor_num": 9,
                  "method": "euclid_lsh",
                  "parameter": {"hash_num": 256}},
}
DIM_BITS = 12
SCORE_RTOL = 1e-4


def _cfg(nn_method, method="lof", k=5, hash_num=64, **extra):
    param = {"nearest_neighbor_num": k, "reverse_nearest_neighbor_num": 3 * k,
             "method": nn_method, "parameter": {"hash_num": hash_num,
                                                "seed": 7}}
    param.update(extra)
    return {"converter": CONV, "method": method, "parameter": param}


def _both(cfg):
    return (JDriver(cfg, dim_bits=DIM_BITS),
            AnomalyDriver(cfg, dim_bits=DIM_BITS, device="cpu"))


def _points(n, seed=0):
    rng = np.random.default_rng(seed)
    pts = []
    for i in range(n):
        d = {f"x{j}": float(np.round(rng.normal(), 2)) for j in range(4)}
        if i % 9 == 0:
            d["x0"] += 6.0                             # a sparse cluster
        d["tag"] = f"t{i % 3}"
        pts.append(d)
    return pts


def assert_scores(got, want, exact):
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(np.isinf(got), np.isinf(want))
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=SCORE_RTOL)


# ---------------------------------------------------------------------------
# the cases of tests/test_knn_engines.py, on both packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_anomaly_outlier_scores_higher(pkg):
    rng = np.random.default_rng(0)
    D = JDatum if pkg == "jax" else Datum
    a = _both(ANOMALY_CFG)[pkg == "port"]
    for _ in range(20):
        a.add(D({"x": float(rng.normal()), "y": float(rng.normal())}))
    inlier = a.calc_score(D({"x": 0.0, "y": 0.0}))
    outlier = a.calc_score(D({"x": 40.0, "y": 40.0}))
    assert outlier > inlier
    assert outlier > 1.5


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_anomaly_add_update_overwrite_clear(pkg):
    D = JDatum if pkg == "jax" else Datum
    a = _both(ANOMALY_CFG)[pkg == "port"]
    rid, _ = a.add(D({"x": 1.0}))
    assert rid == "0"
    rid2, _ = a.add(D({"x": 1.1}))
    assert rid2 == "1"
    assert isinstance(a.update(rid, D({"x": 1.05})), float)
    with pytest.raises(KeyError):
        a.update("nope", D({"x": 0.0}))
    a.overwrite("77", D({"x": 2.0}))
    assert "77" in a.get_all_rows()
    assert a.clear_row("77")
    a.clear()
    assert a.get_all_rows() == []


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_anomaly_save_load(pkg):
    D = JDatum if pkg == "jax" else Datum
    a, a2 = (_both(ANOMALY_CFG)[pkg == "port"] for _ in range(2))
    for i in range(5):
        a.add(D({"x": float(i)}))
    a2.unpack(a.pack())
    assert sorted(a2.get_all_rows()) == sorted(a.get_all_rows())
    rid, _ = a2.add(D({"x": 9.0}))
    assert rid == "5"


# ---------------------------------------------------------------------------
# parity on the same seeded points
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nn_method,exact", [("lsh", True), ("minhash", True),
                                             ("euclid_lsh", False),
                                             ("inverted_index_euclid", False)])
@pytest.mark.parametrize("method", ["lof", "light_lof"])
def test_lof_scores_match_jax(method, nn_method, exact):
    jd, td = _both(_cfg(nn_method, method))
    pts = _points(40)
    got, want = [], []
    for p in pts:
        jid, js = jd.add(JDatum(p))
        tid, ts = td.add(Datum(p))
        assert tid == jid
        want.append(js)
        got.append(ts)
    assert_scores(got, want, exact)
    rng = np.random.default_rng(3)
    queries = [{"x0": float(rng.normal() * 3), "x2": 1.0, "tag": "t1"}
               for _ in range(6)] + [{"x0": 50.0}, {}]
    assert_scores([td.calc_score(Datum(q)) for q in queries],
                  [jd.calc_score(JDatum(q)) for q in queries], exact)
    assert_scores([td.update("4", Datum(pts[9])), td.overwrite("x", Datum(pts[1]))],
                  [jd.update("4", JDatum(pts[9])), jd.overwrite("x", JDatum(pts[1]))],
                  exact)


@pytest.mark.parametrize("nn_method", ["lsh", "minhash"])
def test_lof_support_is_bit_equal_to_jax(nn_method):
    """kdist and lrd over every slot, from the batched scan (three calls of
    at most 256 rows at n = 600)."""
    jd, td = _both(_cfg(nn_method, k=10))
    for p in _points(600, seed=5):
        jd.backend.set_row(str(len(jd.backend.store)),
                           jd.converter.convert(JDatum(p), update_weights=True))
        td.backend.set_row(str(len(td.backend.store)),
                           td.converter.convert(Datum(p), update_weights=True))
    calls = []
    scan = td.backend._scan
    td.backend._scan = lambda q, sigs: calls.append(q.shape[0]) or scan(q, sigs)
    jk, jl = jd._support()
    tk, tl = td._support()
    assert calls == [256, 256, 88]
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tl, jl)
    assert td._support()[0] is tk                   # cached per store version
    assert calls == [256, 256, 88]


def test_lof_lru_unlearner_matches_jax():
    cfg = _cfg("minhash", unlearner="lru", unlearner_parameter={"max_size": 30})
    jd, td = _both(cfg)
    got, want = [], []
    for p in _points(60, seed=8):
        want.append(jd.add(JDatum(p))[1])
        got.append(td.add(Datum(p))[1])
    assert len(td.get_all_rows()) == 30
    assert sorted(td.get_all_rows()) == sorted(jd.get_all_rows())
    assert_scores(got, want, exact=True)


@pytest.mark.parametrize("nn_method,exact", [("lsh", True),
                                             ("euclid_lsh", False)])
def test_pack_moves_both_ways(nn_method, exact):
    cfg = _cfg(nn_method)
    jd, td = _both(cfg)
    pts = _points(40, seed=9)
    for p in pts:
        jd.add(JDatum(p))
        td.add(Datum(p))
    port = convert.from_jax_pack(jd.pack(), cfg, engine="anomaly",
                                 device="cpu")
    back = JDriver(cfg, dim_bits=DIM_BITS)
    back.unpack(td.pack())
    q = {"x0": 2.0, "x1": -1.0, "tag": "t0"}
    for got, want in ((port, jd), (td, back)):
        assert_scores([got.calc_score(Datum(q))],
                      [want.calc_score(JDatum(q))], exact)
        rid, score = got.add(Datum(q))
        wid, wscore = want.add(JDatum(q))
        assert rid == wid == "40"
        assert_scores([score], [wscore], exact)


def test_id_generator_and_small_stores():
    class Gen:
        n = 100

        def generate(self):
            self.n += 1
            return self.n

    td = AnomalyDriver(_cfg("lsh"), dim_bits=DIM_BITS, device="cpu")
    assert td.calc_score(Datum({"x0": 1.0})) == 1.0        # n < 2
    td.set_id_generator(Gen())
    assert td.add(Datum({"x0": 1.0}))[0] == "101"
    assert td.add(Datum({"x0": 1.0}))[1] == 1.0
    s = td.add(Datum({"x0": 1.0}))[1]
    assert s == 1.0 or math.isinf(s) or s > 0
    st = td.get_status()
    assert st["num_rows"] == 3 and st["k"] == 5 and st["device"] == "cpu"
