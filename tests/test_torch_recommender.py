"""The port's recommender driver against the JAX package's, on the CPU.

Mirrors the recommender cases of tests/test_knn_engines.py (each run on both
packages), then feeds the same seeded datums to jubatus_tpu's
RecommenderDriver and to the port's, for all six methods:

- similar_row_*: similarity lists equal for lsh/minhash; within rtol 1e-5
  (atol 1e-6) for inverted_index, and squared within rtol 1e-5 / atol 1e-5
  for the euclid family (inverted_index_euclid, euclid_lsh,
  nearest_neighbor_recommender over euclid_lsh), whose distance expansion
  cancels near 0 (tests/test_torch_exact_knn.py). Ids equal as a set
  below the k-th distance (less the tolerance): rows tied at the k-th
  distance may come in either order.
- complete_row_*: fewer rows are stored than the 128 that complete_row
  reads, so every row votes and the tie order at the boundary cannot
  change the result; the values agree within rtol 1e-5 (the weighted sum
  runs over the rows in neighbor order, which ties permute).
- a model packed by either package loads in the other and answers the same.
"""

from __future__ import annotations

import numpy as np
import pytest

from jubatus_tpu.core.datum import Datum as JDatum
from jubatus_tpu.models.recommender import RecommenderDriver as JDriver
from jubatus_tpu_torch import convert
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.models.recommender import RecommenderDriver

CONV = {
    "string_rules": [{"key": "*", "type": "str", "sample_weight": "bin",
                      "global_weight": "bin"}],
    "num_rules": [{"key": "*", "type": "num"}],
}
DIM_BITS = 12
K = 8
RTOL, ATOL, ATOL_SQ = 1e-5, 1e-6, 1e-5
METHODS = ["inverted_index", "inverted_index_euclid", "lsh", "minhash",
           "euclid_lsh", "nearest_neighbor_recommender"]
EUCLID = ("inverted_index_euclid", "euclid_lsh", "nearest_neighbor_recommender")


def _rec_cfg(method, **param):
    cfg = {"converter": CONV, "method": method}
    if param or method not in ("inverted_index", "inverted_index_euclid"):
        cfg["parameter"] = param
    return cfg


def _cfg(method):
    if method == "nearest_neighbor_recommender":
        return {"converter": CONV, "method": method,
                "parameter": {"method": "euclid_lsh",
                              "parameter": {"hash_num": 128, "seed": 5}}}
    if method in ("lsh", "minhash", "euclid_lsh"):
        return _rec_cfg(method, hash_num=64, seed=3)
    return _rec_cfg(method)


def _both(cfg):
    return (JDriver(cfg, dim_bits=DIM_BITS),
            RecommenderDriver(cfg, dim_bits=DIM_BITS, device="cpu"))


def _rows(n=90, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        d = {f"item{j}": float(np.round(rng.random() * 5, 1))
             for j in rng.choice(30, 5, replace=False)}
        d["genre"] = f"g{int(rng.integers(6))}"
        rows.append((f"u{i}", d))
    return rows


def _fill(pair, rows):
    jd, td = pair
    for rid, d in rows:
        assert jd.update_row(rid, JDatum(d))
        assert td.update_row(rid, Datum(d))


def assert_same_similar(got, want, method):
    """Similarities within the module's tolerance; ids equal as a set where
    the similarity is clear of the k-th one."""
    gs = np.array([s for _, s in got])
    ws = np.array([s for _, s in want])
    assert gs.shape == ws.shape
    if method in ("lsh", "minhash"):
        np.testing.assert_array_equal(gs, ws)
        margin = 0.0
    elif method in EUCLID:
        np.testing.assert_allclose(gs ** 2, ws ** 2, rtol=RTOL, atol=ATOL_SQ)
        margin = 1e-2
    else:
        np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=ATOL)
        margin = 1e-5
    if not len(ws):
        return
    edge = ws[-1]
    assert {r for r, s in got if s > edge + margin} == \
        {r for r, s in want if s > edge + margin}


def assert_same_datum(got, want):
    assert [k for k, _ in got.string_values] == \
        [k for k, _ in want.string_values]
    assert list(got.string_values) == list(want.string_values)
    gk = [k for k, _ in got.num_values]
    assert gk == [k for k, _ in want.num_values]
    np.testing.assert_allclose([v for _, v in got.num_values],
                               [v for _, v in want.num_values], rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# the cases of tests/test_knn_engines.py, on both packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_recommender_inverted_index_similarity(pkg):
    D = JDatum if pkg == "jax" else Datum
    r = _both(_rec_cfg("inverted_index"))[pkg == "port"]
    r.update_row("u1", D({"item_a": 1.0, "item_b": 1.0}))
    r.update_row("u2", D({"item_a": 1.0, "item_b": 1.0}))
    r.update_row("u3", D({"item_z": 1.0}))
    sims = r.similar_row_from_id("u1", 3)
    assert sims[0][1] == pytest.approx(1.0, abs=1e-5)
    assert {s[0] for s in sims[:2]} == {"u1", "u2"}
    assert dict(sims).get("u3", 0.0) == pytest.approx(0.0, abs=1e-5)
    assert r.calc_similarity(D({"a": 1.0}), D({"a": 1.0})) == pytest.approx(1.0)
    assert r.calc_l2norm(D({"a": 3.0, "b": 4.0})) == pytest.approx(5.0)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_recommender_complete_and_decode_row(pkg):
    D = JDatum if pkg == "jax" else Datum
    r = _both(_rec_cfg("inverted_index"))[pkg == "port"]
    r.update_row("u1", D({"x": 2.0, "y": 4.0}))
    r.update_row("u2", D({"x": 2.0, "z": 8.0}))
    assert dict(r.decode_row("u1").num_values) == {"x": 2.0, "y": 4.0}
    nv = dict(r.complete_row_from_datum(D({"x": 2.0})).num_values)
    assert nv.get("x", 0) > 0
    assert "y" in nv and "z" in nv
    r.update_row("u1", D({"y": 9.0}))
    assert dict(r.decode_row("u1").num_values) == {"x": 2.0, "y": 9.0}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_recommender_clear_row_and_get_all(pkg):
    D = JDatum if pkg == "jax" else Datum
    r = _both(_rec_cfg("lsh", hash_num=64))[pkg == "port"]
    r.update_row("a", D({"f": 1.0}))
    r.update_row("b", D({"f": 2.0}))
    assert r.clear_row("a")
    assert not r.clear_row("a")
    assert r.get_all_rows() == ["b"]
    r.clear()
    assert r.get_all_rows() == []


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_recommender_nn_recommender_method(pkg):
    D = JDatum if pkg == "jax" else Datum
    cfg = {"converter": CONV, "method": "nearest_neighbor_recommender",
           "parameter": {"method": "euclid_lsh",
                         "parameter": {"hash_num": 128}}}
    r = _both(cfg)[pkg == "port"]
    r.update_row("a", D({"f1": 1.0}))
    r.update_row("b", D({"f1": 1.05}))
    r.update_row("c", D({"f1": 30.0}))
    assert [s[0] for s in r.similar_row_from_id("a", 2)] == ["a", "b"]


def test_recommender_save_load_keeps_datums():
    r, r2 = (RecommenderDriver(_rec_cfg("inverted_index"), dim_bits=DIM_BITS,
                               device="cpu") for _ in range(2))
    r.update_row("a", Datum({"x": 1.0}))
    r2.unpack(r.pack())
    assert dict(r2.decode_row("a").num_values) == {"x": 1.0}


# ---------------------------------------------------------------------------
# parity on the same seeded datums
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", METHODS)
def test_similar_rows_match_jax(method):
    rows = _rows()
    pair = _both(_cfg(method))
    _fill(pair, rows)
    jd, td = pair
    rng = np.random.default_rng(1)
    for _ in range(4):
        q = {f"item{j}": float(np.round(rng.random() * 5, 1))
             for j in rng.choice(30, 4, replace=False)}
        assert_same_similar(td.similar_row_from_datum(Datum(q), K),
                            jd.similar_row_from_datum(JDatum(q), K), method)
        rid = rows[int(rng.integers(len(rows)))][0]
        assert_same_similar(td.similar_row_from_id(rid, K),
                            jd.similar_row_from_id(rid, K), method)
    assert sorted(td.get_all_rows()) == sorted(jd.get_all_rows())


@pytest.mark.parametrize("method", METHODS)
def test_complete_row_matches_jax(method):
    rows = _rows(n=60, seed=2)      # < 128: every stored row votes
    pair = _both(_cfg(method))
    _fill(pair, rows)
    jd, td = pair
    q = {"item3": 2.0, "item7": 1.5, "genre": "g2"}
    assert_same_datum(td.complete_row_from_datum(Datum(q)),
                      jd.complete_row_from_datum(JDatum(q)))
    assert_same_datum(td.complete_row_from_id("u5"),
                      jd.complete_row_from_id("u5"))


def test_update_row_merge_decode_and_calc_match_jax():
    pair = _both(_cfg("lsh"))
    jd, td = pair
    _fill(pair, _rows(n=10, seed=3))
    jd.update_row("u1", JDatum({"item99": 7.0, "genre": "gX"}))
    td.update_row("u1", Datum({"item99": 7.0, "genre": "gX"}))
    want, got = jd.decode_row("u1"), td.decode_row("u1")
    assert got.string_values == want.string_values
    assert got.num_values == want.num_values
    assert td.decode_row("nope") == Datum()
    a, b = {"item1": 1.0, "genre": "g1"}, {"item1": 2.0, "item2": 1.0}
    assert td.calc_similarity(Datum(a), Datum(b)) == \
        jd.calc_similarity(JDatum(a), JDatum(b))
    assert td.calc_l2norm(Datum(a)) == jd.calc_l2norm(JDatum(a))
    with pytest.raises(KeyError):
        td.similar_row_from_id("ghost", 3)


def test_lru_unlearner_matches_jax():
    cfg = _rec_cfg("minhash", hash_num=64, unlearner="lru",
                   unlearner_parameter={"max_size": 20})
    pair = _both(cfg)
    _fill(pair, _rows(n=50, seed=4))
    jd, td = pair
    assert len(td.get_all_rows()) == 20
    assert sorted(td.get_all_rows()) == sorted(jd.get_all_rows())
    q = {"item1": 1.0, "item2": 3.0}
    assert_same_similar(td.similar_row_from_datum(Datum(q), K),
                        jd.similar_row_from_datum(JDatum(q), K), "minhash")


@pytest.mark.parametrize("method", ["inverted_index", "lsh", "euclid_lsh"])
def test_pack_moves_both_ways(method):
    rows = _rows(n=40, seed=6)
    jd, td = _both(_cfg(method))
    for rid, d in rows:
        jd.update_row(rid, JDatum(d))
    port = convert.from_jax_pack(jd.pack(), _cfg(method),
                                 engine="recommender", device="cpu")
    back = JDriver(_cfg(method), dim_bits=DIM_BITS)
    for rid, d in rows:
        td.update_row(rid, Datum(d))
    back.unpack(td.pack())
    q = {"item4": 1.0, "genre": "g3"}
    for got, want in ((port, jd), (td, back)):
        assert_same_similar(got.similar_row_from_datum(Datum(q), K),
                            want.similar_row_from_datum(JDatum(q), K), method)
        for rid, _ in rows[:5]:
            g, w = got.decode_row(rid), want.decode_row(rid)
            assert g.num_values == w.num_values
            assert g.string_values == w.string_values
        np.testing.assert_array_equal(got.converter.weights.pack()["df"],
                                      want.converter.weights.pack()["df"])


def test_reverse_table_decodes_as_jax():
    """complete_row decodes through the hasher's reverse table: the same
    names, capacity bound included."""
    from jubatus_tpu.core.fv.hashing import FeatureHasher as JHasher
    from jubatus_tpu_torch.core.fv.hashing import FeatureHasher

    names = [f"k{i}$v{i % 7}@str#bin/bin" for i in range(50)]
    jh, th = JHasher(8, reverse_capacity=16), FeatureHasher(8, reverse_capacity=16)
    assert th.index_many(names) == jh.index_many(names)
    more = [f"m{i}@num" for i in range(30)]
    np.testing.assert_array_equal(th.index_array(more), jh.index_array(more))
    assert th._reverse == jh._reverse and len(th._reverse) == 16
    for i in range(256):
        assert th.name_of(i) == jh.name_of(i)
    assert th.index("new", remember=False) == jh.index("new", remember=False)
    th.index("another")
    assert len(th._reverse) == 16                         # the bound holds
