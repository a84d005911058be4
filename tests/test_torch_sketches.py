"""The port's streaming sketches (``jubatus_tpu_torch/utils/sketches.py``),
mirroring ``tests/test_sketches.py`` case for case — signed log-bucket
geometry, merge algebra, bounded memory under cardinality churn, quantile
walks, the reference-vs-live snapshot ring — plus parity: the same seeded
stream gives both packages equal sketch states, and equal PSI."""

from __future__ import annotations

import numpy as np
import pytest

from jubatus_tpu_torch.utils import sketches
from jubatus_tpu_torch.utils.sketches import (
    NBINS, ZERO_BIN, CategoricalSketch, SnapshotRing, ValueSketch,
    bin_rep, categorical_freqs, merge_categorical_states,
    merge_value_states, value_bin, value_bins, value_quantile,
)


# -- signed log-bucket geometry ----------------------------------------------


def test_value_bins_order_along_real_line():
    """Bins are ordered like the reals: more negative -> lower bin,
    zero -> ZERO_BIN, larger positive -> higher bin."""
    vals = [-100.0, -1.0, -0.001, 0.0, 0.001, 1.0, 100.0]
    bins = [value_bin(v) for v in vals]
    assert bins == sorted(bins)
    assert value_bin(0.0) == ZERO_BIN
    assert value_bin(1.0) > ZERO_BIN > value_bin(-1.0)
    assert all(0 <= b < NBINS for b in bins)


def test_bin_rep_roundtrip_sign_and_magnitude():
    for v in (-7.3, -0.02, 0.5, 3.0, 90.0):
        rep = bin_rep(value_bin(v))
        assert np.sign(rep) == np.sign(v)
        # quarter-octave buckets: representative within ~2x of the value
        assert 0.5 <= abs(rep) / abs(v) <= 2.0
    assert bin_rep(ZERO_BIN) == 0.0


def test_value_bins_vectorized_matches_scalar():
    rng = np.random.default_rng(7)
    v = rng.normal(scale=10.0, size=256)
    v[::17] = 0.0
    assert list(value_bins(v)) == [value_bin(float(x)) for x in v]


# -- value sketch + merge algebra --------------------------------------------


def _sketch_of(values) -> ValueSketch:
    sk = ValueSketch()
    sk.observe_array(np.asarray(values, dtype=np.float64))
    return sk


def test_value_sketch_moments_and_nonfinite_mask():
    sk = ValueSketch()
    n = sk.observe_array(np.array([1.0, -2.0, np.nan, np.inf, 0.0]))
    assert n == 3 and sk.count == 3
    assert sk.min == -2.0 and sk.max == 1.0
    st = sk.state()
    assert sum(st["bins"].values()) == 3
    assert st["min"] == -2.0 and st["max"] == 1.0


def test_value_merge_commutative_and_equals_single_stream():
    """merge(a, b) == merge(b, a) == sketch(a ++ b): bins/count/min/max
    exact; float sums may differ in the last ulp (accumulation order)."""
    rng = np.random.default_rng(11)
    a = rng.normal(loc=1.0, size=500)
    b = rng.exponential(size=300) - 0.5
    ab = merge_value_states([_sketch_of(a).state(), _sketch_of(b).state()])
    ba = merge_value_states([_sketch_of(b).state(), _sketch_of(a).state()])
    one = _sketch_of(np.concatenate([a, b])).state()
    for merged in (ab, ba):
        assert merged["bins"] == one["bins"]
        assert merged["count"] == one["count"] == 800
        assert merged["min"] == one["min"]
        assert merged["max"] == one["max"]
        assert merged["sum"] == pytest.approx(one["sum"], abs=1e-9)


def test_value_merge_string_keys_and_empty_states():
    """msgpack map keys may arrive as strings; empty states fold away."""
    st = _sketch_of([1.0, 2.0]).state()
    wired = dict(st, bins={str(k): v for k, v in st["bins"].items()})
    merged = merge_value_states([{}, wired, {"bins": {}, "count": 0}])
    assert merged["bins"] == st["bins"] and merged["count"] == 2


def test_value_quantile_walk():
    rng = np.random.default_rng(3)
    v = rng.uniform(1.0, 100.0, size=4000)
    st = _sketch_of(v).state()
    for q in (0.1, 0.5, 0.9):
        exact = float(np.quantile(v, q))
        got = value_quantile(st, q)
        assert got == pytest.approx(exact, rel=0.25)
    assert value_quantile({"count": 0, "bins": {}}, 0.5) is None
    # quantiles clamp into the observed range
    assert value_quantile(st, 0.0) >= st["min"]
    assert value_quantile(st, 1.0) <= st["max"]


def test_value_sketch_memory_is_fixed():
    """The dense array never grows: 219 bins regardless of stream size
    or value range."""
    sk = ValueSketch()
    rng = np.random.default_rng(5)
    for _ in range(10):
        sk.observe_array(rng.normal(scale=1e6, size=1000))
    assert sk.bins.shape == (NBINS,)
    assert sk.count == 10000


# -- categorical sketch ------------------------------------------------------


def test_categorical_freqs_and_other_residual():
    sk = CategoricalSketch(k=2)
    for item, n in (("a", 50), ("b", 30), ("c", 15), ("d", 5)):
        sk.observe(item, n)
    fr = categorical_freqs(sk.state())
    assert fr["a"] == pytest.approx(0.5)
    assert fr["b"] == pytest.approx(0.3)
    # only k=2 heavy hitters kept; the tail mass lands in __other__
    assert set(fr) == {"a", "b", "__other__"}
    assert sum(fr.values()) == pytest.approx(1.0)


def test_categorical_merge_commutative_and_equals_single_stream():
    a, b, one = CategoricalSketch(), CategoricalSketch(), CategoricalSketch()
    for i in range(200):
        item = "lab%d" % (i % 7)
        (a if i % 2 else b).observe(item)
        one.observe(item)
    ab = merge_categorical_states([a.state(), b.state()])
    ba = merge_categorical_states([b.state(), a.state()])
    assert ab == ba
    assert ab["total"] == one.state()["total"] == 200
    assert ab["rows"] == one.state()["rows"]
    assert categorical_freqs(ab) == categorical_freqs(one.state())


def test_categorical_bounded_under_cardinality_churn():
    """10k distinct labels through a k=16 sketch: the matrix stays at
    its fixed geometry and the top-k dict never exceeds k."""
    sk = CategoricalSketch()
    for i in range(10000):
        sk.observe("u%d" % i)
    st = sk.state()
    assert sk.rows.shape == (sk.depth, sk.width)
    assert len(st["topk"]) <= sk.k
    assert st["total"] == 10000
    # heavy hitter injected after churn still surfaces
    for _ in range(2000):
        sk.observe("whale")
    assert "whale" in sk.state()["topk"]


def test_categorical_merge_geometry_mismatch_skipped():
    a = CategoricalSketch(width=512)
    b = CategoricalSketch(width=64)
    a.observe("x", 10)
    b.observe("y", 99)
    merged = merge_categorical_states([a.state(), b.state()])
    assert merged["total"] == 10  # mismatched matrix skipped, not corrupted


# -- snapshot ring -----------------------------------------------------------


def test_snapshot_ring_eviction_and_pinned_reference():
    ring = SnapshotRing(capacity=3)
    ring.pin_reference({"win": "ref"}, ts=100.0)
    for i in range(6):
        ring.push({"win": i}, ts=200.0 + i)
    assert [p["doc"]["win"] for p in ring.points()] == [3, 4, 5]
    assert ring.newest() == {"win": 5}
    assert ring.points(last=2)[0]["doc"]["win"] == 4
    # the reference survives ring eviction
    assert ring.reference == {"win": "ref"}
    st = ring.stats()
    assert st["pushed"] == 6 and st["retained"] == 3
    assert st["reference_pinned"] and st["reference_ts"] == 100.0


def test_top_bins_rendering_helper():
    st = _sketch_of([5.0] * 90 + [-1.0] * 10).state()
    top = sketches.top_bins(st, n=2)
    assert len(top) == 2
    assert top[0][1] == 90 and top[0][0] == pytest.approx(5.0, rel=0.5)
    assert top[1][1] == 10 and top[1][0] < 0


# -- parity with the JAX package ---------------------------------------------


def _stream(seed):
    rng = np.random.default_rng(seed)
    v = np.concatenate([rng.normal(loc=2.0, scale=3.0, size=3000),
                        rng.exponential(size=500) * -7.0, np.zeros(40),
                        [np.nan, np.inf, -np.inf]])
    labels = ["l%d" % int(x) for x in rng.zipf(1.6, size=4000) % 500]
    return v, labels


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parity_value_and_categorical_states(seed):
    """Every state field is equal: bins, counts, extrema and sums (the
    same numpy reductions in the same order, so exact), and the
    categorical sketch's rows, top-k and totals."""
    from jubatus_tpu.utils import sketches as jsk

    v, labels = _stream(seed)
    pv, jv = ValueSketch(), jsk.ValueSketch()
    for chunk in np.array_split(v, 7):
        assert pv.observe_array(chunk) == jv.observe_array(chunk)
    assert pv.state() == jv.state()
    pc, jc = CategoricalSketch(), jsk.CategoricalSketch()
    for lab in labels:
        pc.observe(lab)
        jc.observe(lab)
    assert pc.state() == jc.state()
    assert categorical_freqs(pc.state()) == jsk.categorical_freqs(jc.state())
    half = len(v) // 2
    assert merge_value_states([_sketch_of(v[:half]).state(),
                               _sketch_of(v[half:]).state()]) == \
        jsk.merge_value_states([_jsketch_of(jsk, v[:half]),
                                _jsketch_of(jsk, v[half:])])
    for q in (0.05, 0.5, 0.95):
        assert value_quantile(pv.state(), q) == \
            jsk.value_quantile(jv.state(), q)


def _jsketch_of(jsk, values):
    sk = jsk.ValueSketch()
    sk.observe_array(np.asarray(values, dtype=np.float64))
    return sk.state()


@pytest.mark.parametrize("seed", [3, 4])
def test_parity_psi_on_one_recorded_stream(seed):
    """PSI between a reference and a shifted live window, from each
    package's sketches and scorer: equal to the last bit."""
    from jubatus_tpu.utils import quality as jq
    from jubatus_tpu.utils import sketches as jsk
    from jubatus_tpu_torch.utils import quality as pq

    rng = np.random.default_rng(seed)
    ref = rng.normal(size=2000)
    live = rng.normal(loc=0.7, scale=1.5, size=2000)
    p = pq.psi_value_states(_sketch_of(ref).state(),
                            _sketch_of(live).state())
    j = jq.psi_value_states(_jsketch_of(jsk, ref), _jsketch_of(jsk, live))
    assert p == j and p > 0.1
    pref, plive = CategoricalSketch(), CategoricalSketch()
    jref, jlive = jsk.CategoricalSketch(), jsk.CategoricalSketch()
    for i in range(3000):
        a, b = "c%d" % (i % 5), "c%d" % (i % 3)
        pref.observe(a)
        jref.observe(a)
        plive.observe(b)
        jlive.observe(b)
    assert pq.psi_categorical_states(pref.state(), plive.state()) == \
        jq.psi_categorical_states(jref.state(), jlive.state())
