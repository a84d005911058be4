"""The port converter's memo caches, counter and quality hook, mirroring
the memo cases of ``tests/test_fv_batch.py``: the caches never serve a
stale idf or user weight, a zero size disables them and changes nothing,
the bound holds. Beyond them: the hit and miss counts (``memo_stats``),
the filter memo, ``--fv-cache-size`` on a server, the
``fv.nonfinite_rejected`` counter, and ``quality_hook``, whose failure
never reaches a conversion; parity of ``convert_batch`` with the JAX
package's, memoized or not."""

from __future__ import annotations

import math

import numpy as np
import pytest

from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.core.fv import make_fv_converter
from jubatus_tpu_torch.utils import tracing

TEXT_TF = {"string_rules": [
    {"key": "*", "type": "space", "sample_weight": "tf",
     "global_weight": "bin"}]}
FILTERED = {
    "string_filter_types": {
        "strip": {"method": "regexp", "pattern": "[0-9]+", "replace": ""}},
    "string_filter_rules": [{"key": "*", "type": "strip", "suffix": "-s"}],
    "string_rules": [{"key": "*", "type": "space", "sample_weight": "tf",
                      "global_weight": "idf"}],
    "num_rules": [{"key": "*", "type": "num"}]}


def test_memo_cache_never_serves_stale_idf():
    """The memos hold tokenizations and hashes only: after the df state
    moves, the same input string comes out with the new idf; a user
    weight set after a conversion applies at once."""
    conf = {"string_rules": [
        {"key": "*", "type": "space", "sample_weight": "bin",
         "global_weight": "idf"}]}
    conv = make_fv_converter(conf, dim_bits=16)
    d = Datum({"t": "common rare"})
    first = conv.convert_batch([d], update_weights=True)
    for _ in range(3):
        conv.convert_batch([Datum({"t": "common"})], update_weights=True)
    again = conv.convert_batch([d])
    ic = conv.hasher.index("t$common@space#bin/idf")
    ir = conv.hasher.index("t$rare@space#bin/idf")
    vals = dict(zip(again.indices.tolist(), again.values.tolist()))
    assert vals[ic] == pytest.approx(math.log(4 / 4))
    assert vals[ir] == pytest.approx(math.log(4 / 1))
    vals0 = dict(zip(first.indices.tolist(), first.values.tolist()))
    assert vals0[ic] == pytest.approx(math.log(1 / 1))
    conf_w = {"string_rules": [
        {"key": "*", "type": "space", "sample_weight": "bin",
         "global_weight": "weight"}]}
    cw = make_fv_converter(conf_w, dim_bits=16)
    dw = Datum({"t": "x"})
    before = cw.convert_batch([dw])
    iw = cw.hasher.index("t$x@space#bin/weight")
    cw.weights._user_weights[iw] = 7.0
    after = cw.convert_batch([dw])
    assert dict(zip(before.indices.tolist(),
                    before.values.tolist()))[iw] == 1.0
    assert dict(zip(after.indices.tolist(),
                    after.values.tolist()))[iw] == 7.0


def test_cache_disabled_still_correct():
    a = make_fv_converter(TEXT_TF, dim_bits=16, cache_size=0)
    b = make_fv_converter(TEXT_TF, dim_bits=16)
    d = [Datum({"t": "a b a c"}), Datum({"t": "a b a c"})]
    ca, cb = a.convert_batch(d), b.convert_batch(d)
    np.testing.assert_array_equal(ca.indices, cb.indices)
    np.testing.assert_array_equal(ca.values, cb.values)
    assert not a._token_memo and not a._name_memo
    assert a.memo_stats()["hit_rate"] == 0.0


def test_cache_bound_holds():
    conv = make_fv_converter(TEXT_TF, dim_bits=16)
    conv.set_cache_size(8)
    for i in range(100):
        conv.convert_batch([Datum({"t": "tok%d" % i})])
    assert len(conv._token_memo) <= 8
    assert len(conv._name_memo) <= 8


def test_memo_stats_count_hits_and_misses():
    conv = make_fv_converter(FILTERED, dim_bits=16)
    batch = [Datum({"t": "a1 b22 a1", "x": 1.0}) for _ in range(4)]
    conv.convert_batch(batch)
    st = conv.memo_stats()
    # the first datum misses each cache once, the other three hit
    assert st["filter"] == {"entries": 1, "hits": 3, "misses": 1}
    assert st["token"]["misses"] == 2 and st["token"]["hits"] == 6
    # a batch resolves its names in one sweep: the memo fills after it,
    # and the next batch hits every name
    assert st["name"] == {"entries": 5, "hits": 0, "misses": 20}
    assert st["cache_size"] == 65536
    conv.convert_batch(batch[:1])
    assert conv.memo_stats()["name"]["hits"] == 5
    st = conv.memo_stats()
    lookups = sum(st[c]["hits"] + st[c]["misses"]
                  for c in ("filter", "token", "name"))
    hits = sum(st[c]["hits"] for c in ("filter", "token", "name"))
    assert st["hit_rate"] == pytest.approx(hits / lookups)


@pytest.mark.parametrize("cache_size", [0, 4, 65536])
def test_parity_convert_batch_with_the_jax_converter(cache_size):
    from jubatus_tpu.core.datum import Datum as JDatum
    from jubatus_tpu.core.fv import make_fv_converter as jmake

    rng = np.random.default_rng(cache_size)
    words = ["w%d" % i for i in range(12)] + ["7x", "x77"]
    rows = [{"t": " ".join(rng.choice(words, size=5)),
             "u": str(rng.choice(words)), "x": float(rng.normal())}
            for _ in range(40)]
    p = make_fv_converter(FILTERED, dim_bits=16, cache_size=cache_size)
    j = jmake(FILTERED, dim_bits=16, cache_size=cache_size)
    for i in range(0, 40, 8):
        pb = p.convert_batch([Datum(r) for r in rows[i:i + 8]],
                             update_weights=True)
        jb = j.convert_batch([JDatum(r) for r in rows[i:i + 8]],
                             update_weights=True)
        for f in ("row_offsets", "indices", "values"):
            np.testing.assert_array_equal(getattr(pb, f), getattr(jb, f))


def test_nonfinite_values_are_counted_in_the_default_registry():
    reg = tracing.default_registry()
    before = reg.counters().get("fv.nonfinite_rejected", 0)
    conv = make_fv_converter({"num_rules": [{"key": "*", "type": "num"}]},
                             dim_bits=16)
    out = conv.convert(Datum({"a": float("nan"), "b": float("inf"),
                              "c": 2.0}))
    assert [v for _i, v in out] == [2.0]
    assert conv.nonfinite_rejected == 2
    assert reg.counters()["fv.nonfinite_rejected"] == before + 2


def test_quality_hook_sees_names_and_values_and_cannot_break_a_batch():
    conv = make_fv_converter(TEXT_TF, dim_bits=16)
    seen = []
    conv.quality_hook = lambda names, vals: seen.append(
        (list(names), np.asarray(vals).tolist()))
    conv.convert_batch([Datum({"t": "a a b"})])
    assert seen == [(["t$a@space#tf/bin", "t$b@space#tf/bin"], [2.0, 1.0])]

    def boom(_names, _vals):
        raise RuntimeError("quality plane down")

    conv.quality_hook = boom
    out = conv.convert_batch([Datum({"t": "a a b"})])
    assert sorted(out.values.tolist()) == [1.0, 2.0]


def test_server_fv_cache_size_flag_reaches_the_converter(tmp_path):
    from jubatus_tpu_torch.server import EngineServer
    from jubatus_tpu_torch.server.args import ServerArgs

    conf = {"method": "AROW", "parameter": {"regularization_weight": 1.0},
            "converter": TEXT_TF}
    srv = EngineServer("classifier", conf, ServerArgs(
        engine="classifier", fv_cache_size=16, telemetry_interval=0,
        datadir=str(tmp_path)), device="cpu")
    try:
        assert srv.driver.converter.memo_stats()["cache_size"] == 16
        srv.driver.train([("a", Datum({"t": "x y"}))] * 3)
        (st,) = srv.get_status().values()
        assert 0.0 < st["fv.memo_hit_rate"] <= 1.0
        assert st["fv.memo.name.entries"] >= 2
    finally:
        srv.stop()
