"""The port's instance-based classifier (NN / cosine / euclidean) and its
batch converter, against the JAX package's, on the CPU.

Mirrors tests/test_classifier_nn.py (its 13 tests, on the port), then holds
the port against jubatus_tpu on the same seeded datums:

- ``convert_batch``: equal CSR output and weight state, including idf under
  ``update_weights=True`` (the whole batch observed first) and a
  combination-rule config.
- classify votes. Tie rule: where the k-th and (k+1)-th nearest distances
  differ (checked first, on the JAX backend), the same rows vote in both
  packages and the scores agree within rtol 1e-9 for lsh/minhash (equal
  distances; the per-label sums may add in another order) and 1e-4 for
  cosine / euclidean / euclid_lsh (float32 distances within a few ulps).
  Where they tie, the multiset of the k nearest distances is compared
  instead. With fewer stored rows than k, every row votes.
- a model packed by either package loads in the other and answers the same.
Row ids are uuid4, so the tests compare scores per label, never row ids.
"""

from __future__ import annotations

import numpy as np
import pytest

from jubatus_tpu.core.datum import Datum as JDatum
from jubatus_tpu.core.fv.converter import make_fv_converter as jmake
from jubatus_tpu.models.classifier_nn import ClassifierNNDriver as JDriver
from jubatus_tpu_torch import convert
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.core.fv.converter import ConverterError, make_fv_converter
from jubatus_tpu_torch.models.classifier_nn import ClassifierNNDriver
from jubatus_tpu_torch.server.factory import create_driver

CONV = {"num_rules": [{"key": "*", "type": "num"}]}
DIM_BITS = 12


def _conf(clf_method, **param):
    base = {"nearest_neighbor_num": 3, "local_sensitivity": 0.5}
    base.update(param)
    return {"method": clf_method, "converter": CONV, "parameter": base}


def _drv(conf):
    return ClassifierNNDriver(conf, device="cpu")


TRAIN = [
    ("pos", {"x": 1.0, "y": 1.0}),
    ("pos", {"x": 0.9, "y": 0.8}),
    ("pos", {"x": 1.1, "y": 0.9}),
    ("neg", {"x": -1.0, "y": -1.0}),
    ("neg", {"x": -0.8, "y": -1.1}),
    ("neg", {"x": -1.2, "y": -0.9}),
]


def _train(pairs):
    return [(lab, Datum(d)) for lab, d in pairs]


# ---------------------------------------------------------------------------
# the 13 tests of tests/test_classifier_nn.py, on the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method,param", [
    ("cosine", {}),
    ("euclidean", {}),
    ("NN", {"method": "euclid_lsh", "parameter": {"hash_num": 128}}),
    ("NN", {"method": "lsh", "parameter": {"hash_num": 128}}),
])
def test_classify_separable(method, param):
    d = _drv(_conf(method, **param))
    assert d.train(_train(TRAIN)) == 6
    results = d.classify([Datum({"x": 1.0, "y": 0.9}),
                          Datum({"x": -1.0, "y": -0.95})])
    assert max(results[0], key=lambda s: s[1])[0] == "pos"
    assert max(results[1], key=lambda s: s[1])[0] == "neg"
    assert {lab for lab, _ in results[0]} == {"pos", "neg"}


def test_factory_routes_nn_methods():
    assert isinstance(create_driver("classifier", _conf("cosine"),
                                    device="cpu"), ClassifierNNDriver)
    linear = create_driver("classifier", {"method": "AROW", "converter": CONV},
                           device="cpu")
    assert not isinstance(linear, ClassifierNNDriver)
    assert linear.method == "AROW"
    # every engine maps to a driver now; a converter plugin loads by path,
    # and one that cannot load is a config error (ConverterError)
    assert create_driver("clustering", {"method": "kmeans", "converter": CONV},
                         device="cpu").TYPE == "clustering"
    plugin = {"string_types": {"p": {"method": "dynamic", "path": "libp.so",
                                     "function": "create"}},
              "string_rules": [{"key": "*", "type": "p",
                                "sample_weight": "bin",
                                "global_weight": "bin"}]}
    with pytest.raises(ConverterError, match="not found"):
        create_driver("classifier", _conf("cosine") | {"converter": plugin},
                      device="cpu")


def test_labels_and_delete():
    d = _drv(_conf("euclidean"))
    d.train(_train(TRAIN))
    assert d.get_labels() == {"pos": 3, "neg": 3}
    assert d.set_label("zzz") is True
    assert d.set_label("zzz") is False
    assert d.get_labels()["zzz"] == 0
    assert d.delete_label("pos") is True
    assert "pos" not in d.get_labels()
    (res,) = d.classify([Datum({"x": 1.0, "y": 1.0})])
    assert {lab for lab, _ in res} == {"neg", "zzz"}
    assert d.delete_label("ghost") is False


def test_clear():
    d = _drv(_conf("cosine"))
    d.train(_train(TRAIN))
    d.clear()
    assert d.get_labels() == {}
    (res,) = d.classify([Datum({"x": 1.0})])
    assert res == []


def test_pack_unpack_roundtrip():
    import msgpack

    d = _drv(_conf("euclidean"))
    d.train(_train(TRAIN))
    d.set_label("extra")
    obj = d.pack()
    obj["weights"]["df"] = obj["weights"]["df"].tolist()
    blob = msgpack.packb(obj)
    d2 = _drv(_conf("euclidean"))
    d2.unpack(msgpack.unpackb(blob, strict_map_key=False))
    assert d2.get_labels() == {"pos": 3, "neg": 3, "extra": 0}
    (res,) = d2.classify([Datum({"x": 1.0, "y": 1.0})])
    assert max(res, key=lambda s: s[1])[0] == "pos"


def test_mix_merges_examples():
    a, b = _drv(_conf("euclidean")), _drv(_conf("euclidean"))
    a.train(_train([(lab, d) for lab, d in TRAIN if lab == "pos"]))
    b.train(_train([(lab, d) for lab, d in TRAIN if lab == "neg"]))
    ma, mb = a.get_mixables()["rows"], b.get_mixables()["rows"]
    folded = ma.mix(ma.get_diff(), mb.get_diff())
    ma.put_diff(folded)
    mb.put_diff(folded)
    for drv in (a, b):
        res = drv.classify([Datum({"x": 1.0, "y": 1.0}),
                            Datum({"x": -1.0, "y": -1.0})])
        assert max(res[0], key=lambda s: s[1])[0] == "pos"
        assert max(res[1], key=lambda s: s[1])[0] == "neg"


def _mix_labels(x, y):
    mx, my = x.get_mixables()["labels"], y.get_mixables()["labels"]
    folded = mx.mix(mx.get_diff(), my.get_diff())
    mx.put_diff(folded)
    my.put_diff(folded)


def test_set_label_propagates_via_mix():
    a, b = _drv(_conf("cosine")), _drv(_conf("cosine"))
    a.set_label("early")
    _mix_labels(a, b)
    assert b.get_labels() == {"early": 0}


def test_label_diff_is_not_destructive():
    a = _drv(_conf("cosine"))
    a.set_label("x")
    m = a.get_mixables()["labels"]
    first = m.get_diff()
    second = m.get_diff()
    assert first == second and "x" in second


def test_delete_label_tombstone_beats_stale_registration():
    a, b = _drv(_conf("cosine")), _drv(_conf("cosine"))
    a.set_label("spam")
    _mix_labels(a, b)
    assert b.get_labels() == {"spam": 0}
    a.delete_label("spam")
    _mix_labels(a, b)
    assert a.get_labels() == {} and b.get_labels() == {}
    _mix_labels(b, a)
    assert a.get_labels() == {}


def test_label_propagates_transitively():
    a, b, c = (_drv(_conf("cosine")) for _ in range(3))
    a.set_label("relay")
    _mix_labels(a, b)
    _mix_labels(b, c)
    assert c.get_labels() == {"relay": 0}


def test_local_sensitivity_sharpness():
    sharp = _drv(_conf("euclidean", local_sensitivity=0.05))
    sharp.train(_train(TRAIN))
    (res,) = sharp.classify([Datum({"x": 0.95, "y": 0.9})])
    assert max(res, key=lambda s: s[1])[0] == "pos"


def test_bad_config_rejected():
    with pytest.raises(ValueError):
        _drv(_conf("cosine", nearest_neighbor_num=0))
    with pytest.raises(ValueError):
        _drv(_conf("cosine", local_sensitivity=0))
    with pytest.raises(ValueError):
        _drv({"method": "what", "converter": CONV})


def test_server_e2e_nn_classifier():
    from jubatus_tpu.client import ClassifierClient
    from jubatus_tpu_torch.server import EngineServer

    srv = EngineServer("classifier", _conf("cosine"), device="cpu")
    port = srv.start(0)
    try:
        c = ClassifierClient("127.0.0.1", port, "")
        assert c.train([[lab, JDatum(d)] for lab, d in TRAIN]) == 6
        (res,) = c.classify([JDatum({"x": 1.0, "y": 1.0})])
        assert max(res, key=lambda s: s[1])[0] == "pos"
        assert c.get_labels() == {"pos": 3, "neg": 3}
        c.close()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# convert_batch against the JAX converter
# ---------------------------------------------------------------------------
IDF_CONV = {
    "string_types": {"bigram": {"method": "ngram", "char_num": "2"}},
    "string_rules": [
        {"key": "text", "type": "bigram", "sample_weight": "tf",
         "global_weight": "idf"},
        {"key": "tag", "type": "str", "sample_weight": "bin",
         "global_weight": "weight"},
    ],
    "num_rules": [{"key": "*", "type": "num"}],
}
COMBO_CONV = {
    "string_rules": [{"key": "*", "type": "str", "sample_weight": "bin",
                      "global_weight": "idf"}],
    "num_rules": [{"key": "*", "type": "num"}],
    "combination_types": {"prod": {"method": "mul"}},
    "combination_rules": [
        {"key_left": "a*", "key_right": "b*", "type": "prod"},
        {"key_left": "*", "key_right": "c@num", "type": "add"},
    ],
}


def _batch(rng, n, with_text=True):
    out = []
    for i in range(n):
        d = {"a": float(np.round(rng.normal(), 2)),
             "b": float(np.round(rng.normal(), 2))}
        if i % 3:
            d["c"] = float(i)
        if with_text:
            d["text"] = "".join(rng.choice(list("abcde"), int(rng.integers(2, 9))))
        d["tag"] = f"t{i % 4}"
        out.append(d)
    return out


def assert_same_csr(got, want):
    np.testing.assert_array_equal(got.row_offsets, want.row_offsets)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.values, want.values)


@pytest.mark.parametrize("conv", [IDF_CONV, COMBO_CONV, CONV],
                         ids=["idf", "combination", "num"])
def test_convert_batch_matches_jax(conv):
    rng = np.random.default_rng(4)
    jc, tc = jmake(conv, dim_bits=DIM_BITS), make_fv_converter(conv, dim_bits=DIM_BITS)
    for _ in range(3):                     # the idf state grows batch by batch
        data = _batch(rng, 17)
        assert_same_csr(tc.convert_batch([Datum(d) for d in data],
                                         update_weights=True),
                        jc.convert_batch([JDatum(d) for d in data],
                                         update_weights=True))
        np.testing.assert_array_equal(tc.weights.pack()["df"],
                                      jc.weights.pack()["df"])
        assert tc.weights.ndocs == jc.weights.ndocs
    query = _batch(rng, 5)
    assert_same_csr(tc.convert_batch([Datum(d) for d in query]),
                    jc.convert_batch([JDatum(d) for d in query]))
    assert tc.weights.ndocs == jc.weights.ndocs == (0 if conv is CONV else 51)


def f32(vec):
    """A sparse vector with its values rounded to float32, as the CSR
    batch holds them."""
    return [(i, np.float32(v)) for i, v in vec]


def test_convert_batch_observes_the_whole_batch_first():
    """Under update_weights=True with idf, the batch is observed before any
    lookup, so a row's idf already counts the rows after it: not what a
    convert() loop gives for a batch of more than one, the same for one."""
    rng = np.random.default_rng(5)
    data = [Datum(d) for d in _batch(rng, 6)]
    batch = make_fv_converter(IDF_CONV, dim_bits=DIM_BITS)
    loop = make_fv_converter(IDF_CONV, dim_bits=DIM_BITS)
    csr = batch.convert_batch(data, update_weights=True)
    rows = [f32(loop.convert(d, update_weights=True)) for d in data]
    assert f32(csr.row(5)) == rows[5]                # the last row sees all
    assert f32(csr.row(0)) != rows[0]
    one = make_fv_converter(IDF_CONV, dim_bits=DIM_BITS)
    assert f32(one.convert_batch(data[:1], update_weights=True).row(0)) == \
        f32(make_fv_converter(IDF_CONV, dim_bits=DIM_BITS).convert(
            data[0], update_weights=True))
    assert csr.batch_size == 6 and batch.convert_batch([]).batch_size == 0


def test_user_weights_apply_in_the_batch_path():
    tc = make_fv_converter(IDF_CONV, dim_bits=DIM_BITS)
    jc = jmake(IDF_CONV, dim_bits=DIM_BITS)
    idx = tc.hasher.index("tag$t1@str#bin/weight")
    tc.weights._user_weights[idx] = 2.5
    jc.weights.set_user_weight(idx, 2.5)
    data = _batch(np.random.default_rng(6), 8)
    assert_same_csr(tc.convert_batch([Datum(d) for d in data]),
                    jc.convert_batch([JDatum(d) for d in data]))


# ---------------------------------------------------------------------------
# classify parity
# ---------------------------------------------------------------------------
def _nn_json(method=None, k=128, ls=1.0):
    """config/classifier/nn.json's shape (nested euclid_lsh unless
    ``method``); k and local_sensitivity as given."""
    return {"method": "NN",
            "converter": {"string_rules": [{"key": "*", "type": "str",
                                            "sample_weight": "bin",
                                            "global_weight": "bin"}],
                          "num_rules": [{"key": "*", "type": "num"}]},
            "parameter": {"method": method or "euclid_lsh",
                          "parameter": {"hash_num": 64},
                          "nearest_neighbor_num": k, "local_sensitivity": ls}}


def _examples(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        lab = f"c{i % 3}"
        d = {"x": float(np.round(rng.normal() + (i % 3) * 2, 2)),
             "y": float(np.round(rng.normal(), 2)), "kind": f"k{i % 5}"}
        out.append((lab, d))
    return out


CASES = [("NN-lsh", _nn_json("lsh", k=7, ls=0.5), 1e-9),
         ("NN-minhash", _nn_json("minhash", k=7, ls=0.5), 1e-9),
         ("NN-euclid_lsh", _nn_json(k=7, ls=2.0), 1e-4),
         ("cosine", _conf("cosine", nearest_neighbor_num=7), 1e-4),
         ("euclidean", _conf("euclidean", nearest_neighbor_num=7,
                             local_sensitivity=2.0), 1e-4)]


@pytest.mark.parametrize("name,conf,rtol", CASES, ids=[c[0] for c in CASES])
def test_classify_votes_match_jax(name, conf, rtol):
    ex = _examples(90, seed=7)
    jd, td = JDriver(conf, dim_bits=DIM_BITS), ClassifierNNDriver(
        conf, dim_bits=DIM_BITS, device="cpu")
    for lo in range(0, len(ex), 30):
        jd.train([(lab, JDatum(d)) for lab, d in ex[lo:lo + 30]])
        td.train([(lab, Datum(d)) for lab, d in ex[lo:lo + 30]])
    assert td.get_labels() == jd.get_labels()
    queries = [d for _, d in _examples(12, seed=8)]
    got = td.classify([Datum(q) for q in queries])
    want = jd.classify([JDatum(q) for q in queries])
    jvecs = jd.converter.convert_batch([JDatum(q) for q in queries])
    compared = 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert [lab for lab, _ in g] == [lab for lab, _ in w]
        nn = jd.backend.neighbors(jvecs.row(i), jd.k + 1)
        if nn[jd.k - 1][1] != nn[jd.k][1]:
            np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                       rtol=rtol)
            compared += 1
        else:
            tn = td.backend.neighbors(td.converter.convert_batch(
                [Datum(queries[i])]).row(0), td.k)
            gd = np.sort([d for _, d in tn])
            wd = np.sort([d for _, d in nn[:jd.k]])
            if rtol < 1e-6:
                np.testing.assert_array_equal(gd, wd)
            else:
                np.testing.assert_allclose(gd ** 2, wd ** 2, rtol=1e-5,
                                           atol=1e-5)
    assert compared >= 6, f"only {compared} of 12 queries clear of a tie"


@pytest.mark.parametrize("method", ["lsh", "euclid_lsh"])
def test_all_rows_vote_when_fewer_than_k(method):
    """config/classifier/nn.json (k = 128) with 40 examples: every row
    votes, whatever order ties take."""
    conf = _nn_json(method)
    ex = _examples(40, seed=9)
    jd, td = JDriver(conf, dim_bits=DIM_BITS), ClassifierNNDriver(
        conf, dim_bits=DIM_BITS, device="cpu")
    jd.train([(lab, JDatum(d)) for lab, d in ex])
    td.train([(lab, Datum(d)) for lab, d in ex])
    queries = [d for _, d in _examples(5, seed=10)]
    rtol = 1e-9 if method == "lsh" else 1e-4
    for g, w in zip(td.classify([Datum(q) for q in queries]),
                    jd.classify([JDatum(q) for q in queries])):
        assert [lab for lab, _ in g] == [lab for lab, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   rtol=rtol)


@pytest.mark.parametrize("conf", [_nn_json("minhash", k=5), _conf("cosine")],
                         ids=["NN-minhash", "cosine"])
def test_pack_moves_both_ways(conf):
    ex = _examples(30, seed=11)
    jd = JDriver(conf, dim_bits=DIM_BITS)
    td = ClassifierNNDriver(conf, dim_bits=DIM_BITS, device="cpu")
    jd.train([(lab, JDatum(d)) for lab, d in ex])
    jd.set_label("empty")
    jd.delete_label("c2")
    td.train([(lab, Datum(d)) for lab, d in ex])
    td.set_label("empty")
    td.delete_label("c2")
    port = convert.from_jax_pack(jd.pack(), conf, engine="classifier",
                                 device="cpu")
    back = JDriver(conf, dim_bits=DIM_BITS)
    back.unpack(td.pack())
    q = [{"x": 0.5, "y": 0.1, "kind": "k1"}, {"x": 2.5, "y": -0.3}]
    for got, want in ((port, jd), (td, back)):
        assert got.get_labels() == want.get_labels() == \
            {"c0": 10, "c1": 10, "empty": 0}
        assert got._label_states == want._label_states
        for g, w in zip(got.classify([Datum(d) for d in q]),
                        want.classify([JDatum(d) for d in q])):
            assert [lab for lab, _ in g] == [lab for lab, _ in w]
            np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                       rtol=1e-4)
