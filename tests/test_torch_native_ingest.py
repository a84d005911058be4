"""The port's native ingest parse (jubatus_tpu_torch/native/ingest.py on
native/fast_ingest.cpp) and its raw-wire train / classify / estimate
paths, mirroring tests/test_native_ingest.py case for case (its repeats
merged into parametrised cases).

Parser cases: on the same seeded datums the port's ``idx`` / ``val`` /
label arrays equal the JAX ``IngestParser``'s bit for bit, and the port
converter's feature vectors bit for bit. Server cases: the port server's
raw path against its own decoded path (bit-equal scores: the same arrays
reach the same driver), and against the JAX server's raw path on the
Python transport (``JUBATUS_TPU_NATIVE_RPC=0``) within rtol 1e-5, atol
1e-6 (the K-sums add in another order than XLA's,
tests/test_torch_classifier_driver.py). The port builds the parser into
``build/torch_native/``; a failed build on an eligible config raises at
server start instead of serving the Python converter.
"""

from __future__ import annotations

import json
import os
import random

import msgpack
import numpy as np
import pytest

from jubatus_tpu.native import ingest as jingest
from jubatus_tpu.core.fv.weight_manager import WeightManager as JWeights
from jubatus_tpu_torch import native
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.core.fv.converter import make_fv_converter
from jubatus_tpu_torch.core.fv.weight_manager import WeightManager
from jubatus_tpu_torch.native import ingest
from jubatus_tpu_torch.rpc.client import (ClassifierClient, RegressionClient,
                                          RpcClient)
from jubatus_tpu_torch.server import EngineServer
from jubatus_tpu_torch.server.args import ServerArgs
from jubatus_tpu_torch.utils import usage as usage_mod

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

MIXED_CONV = {
    "string_rules": [
        {"key": "*", "type": "space", "sample_weight": "tf",
         "global_weight": "bin"},
        {"key": "s*", "type": "str", "sample_weight": "bin",
         "global_weight": "bin"},
    ],
    "num_rules": [
        {"key": "*", "type": "num"},
        {"key": "n*", "type": "log"},
        {"key": "*", "type": "str"},
    ],
}

COMBO_CONV = {
    "string_rules": [
        {"key": "*", "type": "str", "sample_weight": "bin",
         "global_weight": "bin"},
    ],
    "num_rules": [{"key": "*", "type": "num"}],
    "combination_rules": [
        {"key_left": "*", "key_right": "*", "type": "mul"},
    ],
}

TEXT_FILTER_CONV = {
    "string_filter_types": {
        "strip_digits": {"method": "regexp", "pattern": "[0-9]+",
                         "replace": ""}},
    "string_filter_rules": [
        {"key": "*", "type": "strip_digits", "suffix": "-nodigit"}],
    "string_rules": [
        {"key": "*", "type": "space", "sample_weight": "tf",
         "global_weight": "bin"}],
}

#: the idf case of tests/test_native_ingest.py's server tests (pure idf:
#: the deferred-idf plan)
IDF_CONV = {"string_rules": [
    {"key": "*", "type": "space", "sample_weight": "tf",
     "global_weight": "idf"}]}


def _rand_datum(rng):
    words = ["win", "money", "now", "meet", "lunch", "café", "日本語", ""]
    sv = [(rng.choice(["subject", "sbody", "txt"]),
           " ".join(rng.choice(words) for _ in range(rng.randint(0, 6))))
          for _ in range(rng.randint(0, 3))]
    nv = [(rng.choice(["n1", "num2", "f3"]),
           rng.choice([0.0, 1.0, -2.5, 3.25, 7, 123456, 0.1, 1e16,
                       -0.0001, rng.uniform(-10, 10)]))
          for _ in range(rng.randint(0, 4))]
    return Datum(string_values=sv, num_values=nv)


def _expected(pyconv, datum, **kw):
    return [(int(a), float(np.float32(b)))
            for a, b in pyconv.convert(datum, **kw)]


def _got(idx_row, val_row):
    return [(int(a), float(b)) for a, b in zip(idx_row, val_row) if a != 0]


def _parsers(conv, dim_bits, from_config=False):
    """The port's and the JAX package's parser on one config."""
    if from_config:
        return (ingest.IngestParser.from_converter_config(conv, dim_bits),
                jingest.IngestParser.from_converter_config(conv, dim_bits))
    return (ingest.IngestParser(ingest.spec_from_converter_config(conv),
                                dim_bits),
            jingest.IngestParser(jingest.spec_from_converter_config(conv),
                                 dim_bits))


def _same(got, want):
    """Parser outputs equal bit for bit (arrays, labels, None)."""
    if want is None:
        assert got is None
        return
    assert got is not None and len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def _wire(data, **kw):
    return msgpack.packb(["c", [[lab, d.to_msgpack()] for lab, d in data]],
                         **kw)


# -- parser parity: port == JAX parser == port converter, bit for bit ---------

def _mixed_workload():
    rng = random.Random(7)
    return MIXED_CONV, 20, [("lab%d" % rng.randint(0, 3), _rand_datum(rng))
                            for _ in range(400)]


def _unicode_whitespace():
    conv = {"string_rules": [{"key": "*", "type": "space",
                              "sample_weight": "tf", "global_weight": "bin"}]}
    texts = ["a\x1cb", "a\xa0b", "a　b", "a b c", "x\x85y",
             " lead", "trail ", "mixed \t 　 runs",
             "café\xa0日本語", "plain space only"]
    return conv, 20, [("t", Datum(string_values=[("k", s)])) for s in texts]


def _ngram():
    conv = {
        "string_types": {"bigram": {"method": "ngram", "char_num": "2"},
                         "tri": {"method": "ngram", "char_num": "3"}},
        "string_rules": [
            {"key": "*", "type": "bigram", "sample_weight": "tf",
             "global_weight": "bin"},
            {"key": "t*", "type": "tri", "sample_weight": "log_tf",
             "global_weight": "bin"},
        ],
    }
    se = "surrogateescape"
    texts = ["", "a", "ab", "abc", "ababab", "café au lait", "日本語のテキスト",
             "mixed 日本 text", "aa" * 40,
             b"bad\xffutf8\xc3(seq".decode("utf-8", se),
             b"\xe2\x82".decode("utf-8", se),
             b"\xc0\x80a".decode("utf-8", se),
             b"\xe0\x80\x80b".decode("utf-8", se),
             b"\xed\xa0\x80c".decode("utf-8", se),
             b"\xf0\x80\x80\x80d".decode("utf-8", se),
             b"\xf4\x90\x80\x80e".decode("utf-8", se),
             b"\xf5\x80\x80\x80f".decode("utf-8", se),
             b"a\xc2 b\xe1\x80 c\xf3\x80\x80".decode("utf-8", se),
             b"x\xc0\xa0y".decode("utf-8", se)]
    rng = random.Random(21)
    alphabet = "abφ語 \t"
    texts += ["".join(rng.choice(alphabet)
                      for _ in range(rng.randint(0, 30)))
              for _ in range(120)]
    return conv, 18, [("L", Datum(string_values=[
        (rng.choice(["txt", "body"]), t)])) for t in texts]


def _space_hostile_utf8():
    conv = {"string_rules": [{"key": "*", "type": "space",
                              "sample_weight": "tf",
                              "global_weight": "bin"}]}
    se = "surrogateescape"
    texts = [b"x\xc0\xa0y".decode("utf-8", se),
             b"a\xe0\x80\x85b".decode("utf-8", se),
             b"u\xc2\x85v".decode("utf-8", se),
             b"q\xed\xa0\x80 r".decode("utf-8", se)]
    return conv, 18, [("L", Datum(string_values=[("t", t)])) for t in texts]


def _num_filters():
    conv = {
        "num_filter_types": {
            "a5": {"method": "add", "value": "5.5"},
            "lin": {"method": "linear_normalization", "min": "-2",
                    "max": "3"},
            "gz": {"method": "gaussian_normalization", "average": "0.5",
                   "standard_deviation": "2.0"},
            "sig": {"method": "sigmoid_normalization", "gain": "1.5",
                    "bias": "0.25"},
        },
        "num_filter_rules": [
            {"key": "x*", "type": "a5", "suffix": "+5"},
            {"key": "*+5", "type": "sig", "suffix": "$s"},  # chained
            {"key": "y", "type": "lin", "suffix": "_n"},
            {"key": "*", "type": "gz", "suffix": "@g"},
        ],
        "num_rules": [{"key": "*", "type": "num"},
                      {"key": "*_n", "type": "str"}],
    }
    rng = random.Random(44)
    data = []
    for _ in range(150):
        nv = [(rng.choice(["x1", "x2", "y", "z"]),
               rng.choice([0.0, -3.0, 2.5, 7.25, rng.uniform(-10, 10)]))
              for _ in range(rng.randint(0, 5))]
        data.append(("L", Datum(num_values=nv)))
    return conv, 18, data


def _combination_rules():
    rng = random.Random(11)
    return COMBO_CONV, 20, [("l%d" % rng.randint(0, 2), _rand_datum(rng))
                            for _ in range(200)]


def _combination_add_and_matchers():
    conv = {
        "string_rules": [
            {"key": "s*", "type": "space", "sample_weight": "tf",
             "global_weight": "bin"},
        ],
        "num_rules": [{"key": "*", "type": "num"}],
        "combination_types": {"plus": {"method": "add"}},
        "combination_rules": [
            {"key_left": "*@num", "key_right": "*", "type": "plus"},
            {"key_left": "s*", "key_right": "*#tf/bin", "type": "mul"},
        ],
    }
    rng = random.Random(13)
    return conv, 18, [("x", _rand_datum(rng)) for _ in range(200)]


def _combo_plan_replay_fixed_schema():
    rng = random.Random(17)
    data = []
    for _ in range(60):  # fixed 6-key schema: plan hit after datum 0
        data.append(("a", Datum(num_values=[
            (f"f{j}", rng.uniform(-5, 5)) for j in range(6)])))
    for _ in range(60):  # schema change: rebuild, then hits again
        data.append(("b", Datum(num_values=[
            (f"f{j}", rng.uniform(-5, 5)) for j in range(7)])))
    for _ in range(30):  # a base key named like a combined pair
        data.append(("c", Datum(num_values=[
            ("x", rng.uniform(-2, 2)), ("y", rng.uniform(-2, 2)),
            ("x@num&y@num", rng.uniform(-2, 2))])))
    return COMBO_CONV, 20, data


def _string_filters_hybrid():
    rng = random.Random(23)
    words = ["abc123", "x9y", "2024", "plain", "日本7語", ""]
    data = []
    for _ in range(120):
        body = " ".join(rng.choice(words) for _ in range(rng.randint(0, 8)))
        data.append((rng.choice("ab"), Datum({"body": body})))
    return TEXT_FILTER_CONV, 20, data


def _cascaded_string_filters():
    conv = {
        "string_filter_types": {
            "strip_digits": {"method": "regexp", "pattern": "[0-9]+",
                             "replace": ""},
            "dash": {"method": "regexp", "pattern": " ", "replace": "-"}},
        "string_filter_rules": [
            {"key": "*", "type": "strip_digits", "suffix": "-nd"},
            {"key": "*-nd", "type": "dash", "suffix": "-dashed"}],
        "string_rules": [
            {"key": "*", "type": "space", "sample_weight": "bin",
             "global_weight": "bin"}],
    }
    return conv, 18, [("x", Datum({"body": "a1 b2 c3"}))]


PARITY_CASES = {
    "mixed_workload": _mixed_workload,
    "unicode_whitespace_tokenizes_like_python": _unicode_whitespace,
    "ngram_splitter": _ngram,
    "space_splitter_hostile_utf8": _space_hostile_utf8,
    "num_filters": _num_filters,
    "combination_rules": _combination_rules,
    "combination_add_and_matchers": _combination_add_and_matchers,
    "combo_plan_replay_fixed_schema": _combo_plan_replay_fixed_schema,
    "string_filters_hybrid": _string_filters_hybrid,
    "cascaded_string_filters": _cascaded_string_filters,
}


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_parse_parity(case):
    """The train wire and the datum-list wire parse to the JAX parser's
    arrays and to the port converter's vectors, bit for bit."""
    conv, bits, data = PARITY_CASES[case]()
    filters = bool(conv.get("string_filter_rules"))
    port, jax = _parsers(conv, bits, from_config=filters)
    assert port is not None and jax is not None
    assert (port._prefilters is not None) == filters
    pyconv = make_fv_converter(conv, dim_bits=bits)
    raw = _wire(data, use_bin_type=True, unicode_errors="surrogateescape")
    got = port.parse(raw)
    _same(got, jax.parse(raw))
    labels, idx, val = got
    assert labels == [lab for lab, _ in data]
    for i, (_lab, d) in enumerate(data):
        assert _got(idx[i], val[i]) == _expected(pyconv, d), (case, i)
    rawq = msgpack.packb(["c", [d.to_msgpack() for _l, d in data]],
                         use_bin_type=True, unicode_errors="surrogateescape")
    gotq = port.parse_datums(rawq)
    _same(gotq, jax.parse_datums(rawq))
    for i, (_lab, d) in enumerate(data):
        assert _got(gotq[0][i], gotq[1][i]) == _expected(pyconv, d), i


def test_parity_legacy_wire_and_num_formats():
    conv = {"num_rules": [{"key": "*", "type": "str"}],
            "string_rules": [{"key": "*", "type": "space",
                              "sample_weight": "log_tf",
                              "global_weight": "bin"}]}
    port, jax = _parsers(conv, 18)
    pyconv = make_fv_converter(conv, dim_bits=18)
    vals = [0.0, -0.0, 1.0, -1.0, 0.5, -0.0001, 0.0001, 1e-5, -1e-5, 1e16,
            1e15 + 0.5, 123456789.125, 3.141592653589793, 2.5e-10, 9.9e15,
            1.00000000001, 1e16 + 2.0, 4.5e18]
    rng = random.Random(9)
    vals += [rng.uniform(-1, 1) * 10 ** rng.randint(-15, 15)
             for _ in range(200)]
    data = [("x", Datum(num_values=[("k", v)],
                        string_values=[("t", "a b b a")])) for v in vals]
    for use_bin in (True, False):  # modern + legacy request wire
        raw = _wire(data, use_bin_type=use_bin)
        got = port.parse(raw)
        _same(got, jax.parse(raw))
        _labels, idx, val = got
        for i, (_, d) in enumerate(data):
            assert _got(idx[i], val[i]) == _expected(pyconv, d), vals[i]


def test_numeric_targets_regression_wire():
    conv = {"num_rules": [{"key": "*", "type": "num"}]}
    port, jax = _parsers(conv, 16)
    data = [[1.5, Datum({"x": 2.0}).to_msgpack()],
            [-0.25, Datum({"x": -1.0}).to_msgpack()]]
    raw = msgpack.packb(["c", data])
    got = port.parse(raw)
    _same(got, jax.parse(raw))
    labels, idx, _val = got
    assert isinstance(labels, np.ndarray)
    np.testing.assert_allclose(labels, [1.5, -0.25])
    assert idx.shape == (2, 8)
    # the indexed form: float targets as they are
    _same(port.parse_indexed(raw), jax.parse_indexed(raw))


def test_huge_integral_and_mixed_labels_fall_back():
    conv = {"num_rules": [{"key": "*", "type": "str"}]}
    port, _jax = _parsers(conv, 16)
    raw = msgpack.packb(
        ["c", [["x", Datum(num_values=[("k", 1e100)]).to_msgpack()]]])
    assert port.parse(raw) is None  # str(int(1e100)) not reproducible
    mixed = msgpack.packb(
        ["c", [["x", Datum({"k": 1.0}).to_msgpack()],
               [3, Datum({"k": 1.0}).to_msgpack()]]])
    assert port.parse(mixed) is None  # mixed label kinds


def _ngram_conv(bad):
    return {"string_types": {"g": {"method": "ngram", "char_num": bad}},
            "string_rules": [{"key": "*", "type": "g",
                              "sample_weight": "bin",
                              "global_weight": "bin"}]}


#: configs the native spec must not express (the Python converter serves)
DECLINED = {
    "none": None,
    "empty": {},
    "user_weight": {"string_rules": [{"key": "*", "type": "space",
                                      "sample_weight": "bin",
                                      "global_weight": "weight"}]},
    "num_filter_unknown_type": {
        "num_rules": [{"key": "*", "type": "num"}],
        "num_filter_rules": [{"key": "*", "type": "x", "suffix": "y"}]},
    "combination_unknown_method": {
        "num_rules": [{"key": "*", "type": "num"}],
        "combination_types": {"odd": {"method": "concat"}},
        "combination_rules": [{"key_left": "*", "key_right": "*",
                               "type": "odd"}]},
    "regexp_splitter": {
        "string_types": {"rx": {"method": "regexp", "pattern": "a+"}},
        "string_rules": [{"key": "*", "type": "rx", "sample_weight": "bin",
                          "global_weight": "bin"}]},
    "ngram_char_num_0": _ngram_conv("0"),
    "ngram_char_num_-1": _ngram_conv("-1"),
    "ngram_char_num_x": _ngram_conv("x"),
    "ngram_char_num_None": _ngram_conv(None),
    "ngram_char_num_2^32+1": _ngram_conv("4294967297"),
    "num_filter_unknown_method": {
        "num_filter_types": {"w": {"method": "wavelet"}},
        "num_filter_rules": [{"key": "*", "type": "w", "suffix": "#"}],
        "num_rules": [{"key": "*", "type": "num"}]},
    "combo_with_idf": {
        "string_rules": [{"key": "*", "type": "space",
                          "sample_weight": "tf", "global_weight": "idf"}],
        "combination_rules": [{"key_left": "*", "key_right": "*",
                               "type": "mul"}]},
}

#: configs the native spec expresses since the JAX package's later rounds
EXPRESSED = {
    "idf": IDF_CONV,
    "combination_mul": {
        "num_rules": [{"key": "*", "type": "num"}],
        "combination_rules": [{"key_left": "*", "key_right": "*",
                               "type": "mul"}]},
    "ngram": {"string_types": {"bigram": {"method": "ngram",
                                          "char_num": "2"}},
              "string_rules": [{"key": "*", "type": "bigram",
                                "sample_weight": "bin",
                                "global_weight": "bin"}]},
}


@pytest.mark.parametrize("case", sorted(DECLINED))
def test_spec_declines_unsupported_configs(case):
    conv = DECLINED[case]
    assert ingest.spec_from_converter_config(conv) is None
    assert jingest.spec_from_converter_config(conv) is None
    assert ingest.IngestParser.from_converter_config(conv, 16) is None


@pytest.mark.parametrize("case", sorted(EXPRESSED))
def test_spec_expresses_the_jax_spec(case):
    conv = EXPRESSED[case]
    spec = ingest.spec_from_converter_config(conv)
    assert spec is not None
    assert spec == jingest.spec_from_converter_config(conv)


def test_string_filter_unknown_method_declines():
    conv = dict(TEXT_FILTER_CONV,
                string_filter_types={"odd": {"method": "mystery"}},
                string_filter_rules=[
                    {"key": "*", "type": "odd", "suffix": "-x"}])
    assert ingest.IngestParser.from_converter_config(conv, 20) is None
    assert jingest.IngestParser.from_converter_config(conv, 20) is None


def test_hostile_lengths_error_not_abort():
    """A tiny request claiming 2^32 array elements returns a parse error,
    never an abort, and the handle still works afterwards."""
    conv = {"num_rules": [{"key": "*", "type": "num"}]}
    port, _jax = _parsers(conv, 16)
    hostile = (b"\x92\xa1c\x91\x92\xa1x\x92"
               b"\xdd\xff\xff\xff\xff")  # array32 len 0xffffffff, no body
    assert port.parse(hostile) is None
    hostile2 = b"\x92\xa1c\x91\x92\xa1x\x92\x90\xdd\xff\xff\xff\xff"
    assert port.parse(hostile2) is None
    ok = msgpack.packb(["c", [["x", Datum({"k": 1.0}).to_msgpack()]]])
    assert port.parse(ok) is not None


def test_parse_datums_matches_converter():
    port, jax = _parsers(MIXED_CONV, 20)
    pyconv = make_fv_converter(MIXED_CONV, dim_bits=20)
    rng = random.Random(11)
    data = [_rand_datum(rng) for _ in range(100)]
    raw = msgpack.packb(["c", [d.to_msgpack() for d in data]])
    parsed = port.parse_datums(raw)
    _same(parsed, jax.parse_datums(raw))
    idx, val = parsed
    for i, d in enumerate(data):
        assert _got(idx[i], val[i]) == _expected(pyconv, d), i
    # a train-shaped wire is NOT a datum list
    train_raw = msgpack.packb(["c", [["lb", data[0].to_msgpack()]]])
    assert port.parse_datums(train_raw) is None


def test_parser_survives_mutation_fuzz():
    """Randomly mutated request bytes yield the JAX parser's answer: a
    clean parse (equal arrays) or a clean None, never a crash."""
    port, jax = _parsers(MIXED_CONV, 16)
    rng = random.Random(13)
    base = msgpack.packb(
        ["c", [["lbl%d" % i, _rand_datum(rng).to_msgpack()]
               for i in range(8)]])
    for _trial in range(1500):
        raw = bytearray(base)
        for _ in range(rng.randint(1, 6)):
            raw[rng.randrange(len(raw))] = rng.randrange(256)
        if rng.random() < 0.3:
            raw = raw[:rng.randrange(len(raw))]
        raw = bytes(raw)
        out = port.parse(raw)
        _same(out, jax.parse(raw))
        if out is not None:
            assert out[1].shape == out[2].shape
        out2 = port.parse_datums(raw)
        _same(out2, jax.parse_datums(raw))


def test_parity_idf_global_weight():
    """jt_ingest_parse_w replays convert(update_weights=True)'s per-document
    protocol against the port WeightManager's tables, request by request,
    as the JAX parser does against the JAX tables."""
    conv = {"string_rules": [{"key": "*", "type": "space",
                              "sample_weight": "tf",
                              "global_weight": "idf"}],
            "num_rules": [{"key": "*", "type": "num"}]}
    port, jax = _parsers(conv, 18)
    assert port.needs_weights and not port.deferred_idf
    pyconv = make_fv_converter(conv, dim_bits=18)
    wp, wj = WeightManager(1 << 18), JWeights(1 << 18)
    rng = random.Random(33)
    words = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta"]
    for req in range(6):
        data = []
        for _ in range(rng.randint(1, 30)):
            text = " ".join(rng.choice(words)
                            for _ in range(rng.randint(0, 8)))
            nv = [("n", rng.uniform(-2, 2))] if rng.random() < 0.5 else []
            data.append(("L%d" % rng.randint(0, 2),
                         Datum(string_values=[("t", text)], num_values=nv)))
        raw = _wire(data)
        with wp.lock:
            out = port.parse(raw, weights=wp)
        with wj.lock:
            _same(out, jax.parse(raw, weights=wj))
        _labels, idx, val = out
        for i, (_, d) in enumerate(data):
            assert _got(idx[i], val[i]) == _expected(
                pyconv, d, update_weights=True), (req, i)
    np.testing.assert_array_equal(wp._df_diff, pyconv.weights._df_diff)
    np.testing.assert_array_equal(wp._df_diff, wj._df_diff)
    assert wp.ndocs == pyconv.weights.ndocs == wj.ndocs

    # the QUERY path reads idf without observing
    before = wp.ndocs
    qraw = msgpack.packb(["c", [Datum({"t": "alpha beta"}).to_msgpack()]])
    with wp.lock:
        qi, qv = port.parse_datums(qraw, weights=wp)
    assert wp.ndocs == before
    assert _got(qi[0], qv[0]) == _expected(pyconv, Datum({"t": "alpha beta"}))

    # an idf spec without weights declines, not crashes
    assert port.parse(raw) is None
    assert port.parse_datums(qraw) is None


def test_deferred_idf_scale_matches_the_jax_flush():
    """A pure-idf config defers weighting to the flush: the lock-free
    parse gives raw values, and ``deferred_idf_scale`` (observe once,
    scale once) gives the JAX flush's arrays and df tables, which equal
    the converter fed the same documents one flush at a time."""
    port, jax = _parsers(IDF_CONV, 18, from_config=True)
    assert port.deferred_idf and jax.deferred_idf
    wp, wj = WeightManager(1 << 18), JWeights(1 << 18)
    rng = random.Random(5)
    words = ["alpha", "beta", "gamma", "delta"]
    for _ in range(4):
        data = [("L", Datum({"t": " ".join(rng.choice(words) for _ in
                                           range(rng.randint(1, 6)))}))
                for _ in range(rng.randint(1, 12))]
        raw = _wire(data)
        _labels, idx, val = port.parse(raw)
        _same((idx, val), jax.parse(raw)[1:])
        got = ingest.deferred_idf_scale(idx, val, wp, observe=True)
        want = jingest.deferred_idf_scale(idx, val, wj, observe=True)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(wp._df_diff, wj._df_diff)
    assert wp.ndocs == wj.ndocs


def test_sigmoid_overflow_falls_back_like_python_raises():
    conv = {"num_filter_types": {"s": {"method": "sigmoid_normalization",
                                       "gain": "1.5", "bias": "0"}},
            "num_filter_rules": [{"key": "*", "type": "s", "suffix": "#"}],
            "num_rules": [{"key": "*", "type": "num"}]}
    port, jax = _parsers(conv, 16)
    pyconv = make_fv_converter(conv, dim_bits=16)
    ok = msgpack.packb(["c", [["x", Datum({"k": -400.0}).to_msgpack()]]])
    _same(port.parse(ok), jax.parse(ok))
    assert port.parse(ok) is not None  # exp(600) is finite
    bad = msgpack.packb(["c", [["x", Datum({"k": -500.0}).to_msgpack()]]])
    assert port.parse(bad) is None     # exp(750) overflows -> decline
    with pytest.raises(OverflowError):
        pyconv.convert(Datum({"k": -500.0}))


def test_weight_manager_observe_rows_equals_the_jax_tables():
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 64, size=(9, 6)).astype(np.int32)
    idx[:, -2:] = 0  # padding
    wp, wj = WeightManager(64), JWeights(64)
    wp.observe_rows(idx)
    wj.observe_rows(idx)
    np.testing.assert_array_equal(wp._df_diff, wj._df_diff)
    assert wp.ndocs == wj.ndocs == 9.0
    assert wp._df_diff[0] == 0.0


# -- the native build and helpers ---------------------------------------------

def test_hash_names_and_crc32_equal_zlib_and_the_hasher(monkeypatch):
    import zlib

    from jubatus_tpu.native import hash_names as jhash_names
    from jubatus_tpu_torch.core.fv.hashing import FeatureHasher

    names = ["a", "feature", "café", "日本語", "x" * 300, ""]
    mask = (1 << 18) - 1
    got = native.hash_names(names, mask)
    np.testing.assert_array_equal(got, jhash_names(names, mask))
    for data in (b"", b"hello", "日本語".encode()):
        assert native.crc32(data) == zlib.crc32(data)
    hasher = FeatureHasher(18)
    plain = hasher.index_many(names)
    monkeypatch.setenv("JUBATUS_TPU_NATIVE", "1")
    assert FeatureHasher(18).index_many(names) == plain == \
        [int(i) for i in got]
    assert native.available()
    monkeypatch.setenv("JUBATUS_TPU_NATIVE", "0")
    assert not native.available()
    np.testing.assert_array_equal(native.hash_names(names, mask), got)


def test_build_writes_a_hashed_library_by_rename(monkeypatch, tmp_path):
    """The build writes under a name of its own process and renames: the
    final library appears whole, and a second call reuses it."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "torch_native")
    path = native.ensure_built("jt_native")
    assert path.parent == tmp_path / "torch_native"
    assert path.name.startswith("libjt_native_") and path.suffix == ".so"
    assert sorted(p.name for p in path.parent.iterdir()) == [path.name]
    mtime = path.stat().st_mtime_ns
    assert native.ensure_built("jt_native") == path
    assert path.stat().st_mtime_ns == mtime


def _break_the_build(monkeypatch, tmp_path):
    """A compiler that does not exist and an empty build directory."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "torch_native")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(ingest, "_lib", None)


def test_failed_build_raises_at_server_start(monkeypatch, tmp_path):
    """An eligible config with a failed build raises at start, the
    compiler's failure in the message; with the switch at 0 the server
    starts on the decoded path; an ineligible config never builds. On the
    Python transport: the native one's own build would fail first
    (tests/test_torch_native_rpc.py holds that)."""
    monkeypatch.setenv("JUBATUS_TPU_NATIVE_RPC", "0")
    _break_the_build(monkeypatch, tmp_path)
    conf = json.load(open(os.path.join(ROOT, "config/classifier/arow.json")))
    with pytest.raises(native.NativeBuildError, match="no-such-g"):
        EngineServer("classifier", conf, ServerArgs(
            engine="classifier", listen_addr="127.0.0.1"),
            device="cpu").start(0)
    with pytest.raises(native.NativeBuildError):
        ingest.IngestParser.from_converter_config(conf["converter"], 16)
    monkeypatch.setenv("JUBATUS_TPU_NATIVE_INGEST", "0")
    srv = EngineServer("classifier", conf, ServerArgs(
        engine="classifier", listen_addr="127.0.0.1"), device="cpu")
    port = srv.start(0)
    try:
        assert "train" not in srv.rpc._raw_methods
        with ClassifierClient("127.0.0.1", port, "t") as c:
            assert c.train([["a", Datum({"x": "y"})]]) == 1
        (st,) = srv.get_status("").values()
        assert st["microbatch.train.item_count"] == 1
    finally:
        srv.stop()
    assert not (tmp_path / "torch_native").exists() or \
        not list((tmp_path / "torch_native").iterdir())


# -- the server: raw path against the decoded path and the JAX raw path ------

SERVER_CONV = {
    "method": "AROW",
    "parameter": {"regularization_weight": 1.0},
    "converter": {
        "string_rules": [{"key": "*", "type": "space",
                          "sample_weight": "bin", "global_weight": "bin"}],
        "num_rules": [{"key": "*", "type": "num"}],
    },
}

PA_CONF = {"method": "PA", "parameter": {"sensitivity": 0.1,
                                         "regularization_weight": 1.0},
           "converter": {"num_rules": [{"key": "*", "type": "num"}]}}


def _train_data():
    return [["spam", Datum({"t": "win money now", "n": 1.0})],
            ["ham", Datum({"t": "meet at noon", "n": -1.0})]] * 8


def _server(engine, conf, decoded=False, **flags):
    srv = EngineServer(engine, conf, ServerArgs(
        engine=engine, listen_addr="127.0.0.1", telemetry_interval=0,
        **flags), device="cpu")
    srv.start(0)
    if decoded:
        srv.rpc._raw_methods.clear()  # force the converter path
    return srv


@pytest.fixture()
def jax_server(monkeypatch):
    """The JAX server on the Python transport (its raw ingest on)."""
    from jubatus_tpu.server import EngineServer as JEngineServer
    from jubatus_tpu.server.args import ServerArgs as JServerArgs

    monkeypatch.setenv("JUBATUS_TPU_NATIVE_RPC", "0")
    made = []

    def make(engine, conf):
        srv = JEngineServer(engine, conf, args=JServerArgs(
            engine=engine, listen_addr="127.0.0.1", telemetry_interval=0))
        srv.start(0)
        made.append(srv)
        return srv

    yield make
    for srv in made:
        srv.stop()


def _ranked(rows):
    return [sorted((lab, s) for lab, s in r) for r in rows]


def _close_ranked(got, want):
    assert [[lab for lab, _ in r] for r in got] == \
        [[lab for lab, _ in r] for r in want]
    np.testing.assert_allclose([[s for _, s in r] for r in got],
                               [[s for _, s in r] for r in want],
                               rtol=1e-5, atol=1e-6)


def test_server_fast_path_matches_converter_path(jax_server):
    """The same traffic through the raw path, the decoded path and the
    JAX server's raw path: equal models."""
    fast = _server("classifier", SERVER_CONV)
    slow = _server("classifier", SERVER_CONV, decoded=True)
    jsrv = jax_server("classifier", SERVER_CONV)
    try:
        assert {"train", "classify"} <= set(fast.rpc._raw_methods)
        probe = [Datum({"t": "win money", "n": 0.5})]
        out = []
        for port in (fast.rpc.port, slow.rpc.port, jsrv.rpc.port):
            with ClassifierClient("127.0.0.1", port, "t") as c:
                assert c.train(_train_data()) == 16
                out.append(_ranked(c.classify(probe)))
        assert out[0] == out[1]
        _close_ranked(out[0], out[2])
        (st,) = fast.get_status("").values()
        assert st["microbatch.train_raw.item_count"] == 16
        assert st["microbatch.train.item_count"] == 0
        (st2,) = slow.get_status("").values()
        assert st2["microbatch.train.item_count"] == 16
        (jst,) = jsrv.get_status("").values()
        assert jst["microbatch.train_raw.item_count"] == 16
        np.testing.assert_array_equal(fast.driver.state.w.numpy(),
                                      slow.driver.state.w.numpy())
    finally:
        fast.stop()
        slow.stop()


def test_server_fast_path_regression(jax_server):
    srv = _server("regression", PA_CONF)
    jsrv = jax_server("regression", PA_CONF)
    data = [[float(2 * x), Datum({"x": float(x)})] for x in range(-8, 9)] * 4
    try:
        ests = []
        for port in (srv.rpc.port, jsrv.rpc.port):
            with RegressionClient("127.0.0.1", port, "t") as c:
                assert c.train(data) == len(data)
                ests.append(c.estimate([Datum({"x": 3.0})]))
        assert 2.0 < ests[0][0] < 10.0
        np.testing.assert_allclose(ests[0], ests[1], rtol=1e-5, atol=1e-6)
        (st,) = srv.get_status("").values()
        assert st["microbatch.train_raw.item_count"] == len(data)
    finally:
        srv.stop()


def test_server_ineligible_config_uses_converter_path():
    conf = {"method": "PA", "parameter": {},
            "converter": {
                "string_types": {"rx": {"method": "regexp",
                                        "pattern": "[a-z]+"}},
                "string_rules": [
                    {"key": "*", "type": "rx", "sample_weight": "tf",
                     "global_weight": "bin"}]}}
    srv = _server("classifier", conf)
    try:
        assert "train" not in srv.rpc._raw_methods
        with ClassifierClient("127.0.0.1", srv.rpc.port, "t") as c:
            assert c.train([["a", Datum({"t": "x y"})],
                            ["b", Datum({"t": "y z"})]]) == 2
        (st,) = srv.get_status("").values()
        assert st["microbatch.train.item_count"] == 2
        assert not any(k.startswith("ingest.") for k in st)
    finally:
        srv.stop()


def test_server_idf_fast_path_matches_converter_path(jax_server):
    """A pure-idf config rides the raw path with the deferred idf: its
    model and df tables stay equal to a decoded server's fed the same
    calls one at a time."""
    conf = {"method": "AROW", "parameter": {"regularization_weight": 1.0},
            "converter": IDF_CONV}
    fast = _server("classifier", conf)
    slow = _server("classifier", conf, decoded=True)
    jsrv = jax_server("classifier", conf)
    data = [["spam", Datum({"t": "win money now now"})],
            ["ham", Datum({"t": "meet at noon"})],
            ["spam", Datum({"t": "money money fast"})],
            ["ham", Datum({"t": "noon lunch plan"})]]
    probe = [Datum({"t": "money now"}), Datum({"t": "noon plan"}),
             Datum({"t": "unseen words"})]
    try:
        assert "train" in fast.rpc._raw_methods
        out = []
        for port in (fast.rpc.port, slow.rpc.port, jsrv.rpc.port):
            with ClassifierClient("127.0.0.1", port, "t") as c:
                for _ in range(5):
                    assert c.train(data) == 4
                out.append(_ranked(c.classify(probe)))
        assert out[0] == out[1]
        _close_ranked(out[0], out[2])
        assert fast.coalescers["train_raw"].stats()["item_count"] == 20
        np.testing.assert_array_equal(
            fast.driver.converter.weights._df_diff,
            slow.driver.converter.weights._df_diff)
        np.testing.assert_array_equal(
            fast.driver.converter.weights._df_diff,
            jsrv.driver.converter.weights._df_diff)
        (st,) = fast.get_status("").values()
        assert st["ingest.sparse_flushes"] >= 1
        assert st["ingest.schema_flushes"] == 0
    finally:
        fast.stop()
        slow.stop()


def test_server_fallback_on_undecodable_fast_wire():
    """Numeric labels on a classifier: the parser declines and the
    generic path serves the call, as it did before the raw path."""
    srv = _server("classifier", SERVER_CONV)
    try:
        with ClassifierClient("127.0.0.1", srv.rpc.port, "t") as c:
            n = c.client.call("train", "t",
                              [[3, Datum({"n": 1.0}).to_msgpack()],
                               [4, Datum({"n": -1.0}).to_msgpack()]])
            assert n == 2
            assert set(c.get_labels()) == {3, 4}
        (st,) = srv.get_status("").values()
        assert st["microbatch.train_raw.item_count"] == 0
    finally:
        srv.stop()


def test_fallback_counts_trace_span_once():
    srv = _server("classifier", SERVER_CONV)
    try:
        with ClassifierClient("127.0.0.1", srv.rpc.port, "t") as c:
            c.client.call("train", "t", [[3, Datum({"n": 1.0}).to_msgpack()]])
            (st,) = c.get_status().values()
        assert st["trace.rpc.train.count"] == 1
    finally:
        srv.stop()


def test_server_fast_classify_and_estimate_match_slow_path(jax_server):
    srv = _server("classifier", SERVER_CONV)
    slow = _server("classifier", SERVER_CONV, decoded=True)
    jsrv = jax_server("classifier", SERVER_CONV)
    probe = [Datum({"t": "win money", "n": 0.5}), Datum({"t": "meet at noon"})]
    try:
        assert "classify" in srv.rpc._raw_methods
        out = []
        for port in (srv.rpc.port, slow.rpc.port, jsrv.rpc.port):
            with ClassifierClient("127.0.0.1", port, "t") as c:
                c.train(_train_data())
                out.append(_ranked(c.classify(probe)))
        assert out[0] == out[1]
        _close_ranked(out[0], out[2])
    finally:
        srv.stop()
        slow.stop()

    rsrv = _server("regression", PA_CONF)
    rslow = _server("regression", PA_CONF, decoded=True)
    try:
        assert "estimate" in rsrv.rpc._raw_methods
        ests = []
        for port in (rsrv.rpc.port, rslow.rpc.port):
            with RegressionClient("127.0.0.1", port, "t") as c:
                c.train([[float(2 * x), Datum({"x": float(x)})]
                         for x in range(-8, 9)] * 4)
                ests.append(c.estimate([Datum({"x": 3.0}),
                                        Datum({"x": -2.0})]))
        assert ests[0] == ests[1]
        assert 2.0 < ests[0][0] < 10.0 and -8.0 < ests[0][1] < -1.0
    finally:
        rsrv.stop()
        rslow.stop()


def test_server_combo_plan_rides_the_device_expansion(jax_server):
    """A combination config: a fixed-schema feed rides the combo device
    plan (train and classify), equal to the decoded path and to the JAX
    server's raw path. The shipped arow_combinational_feature.json weighs
    its strings by idf, which the native spec cannot compose with
    combinations, so its converter declines in both packages; the plan
    runs on the same rules with bin weights."""
    path = os.path.join(ROOT, "config/classifier/"
                              "arow_combinational_feature.json")
    shipped = json.load(open(path))
    assert ingest.IngestParser.from_converter_config(
        shipped["converter"], 20) is None
    conv = json.loads(json.dumps(shipped["converter"]))
    for rule in conv["string_rules"]:
        rule["global_weight"] = "bin"
    conf = dict(shipped, converter=conv)
    fast = _server("classifier", conf)
    slow = _server("classifier", conf, decoded=True)
    jsrv = jax_server("classifier", conf)
    rng = np.random.default_rng(8)
    data = [["ab"[i % 2], Datum({f"f{j}": float(np.round(v, 3))
                                 for j, v in enumerate(
                                     rng.standard_normal(5))})]
            for i in range(48)]
    probe = [d for _, d in data[:6]]
    try:
        out = []
        for port in (fast.rpc.port, slow.rpc.port, jsrv.rpc.port):
            with ClassifierClient("127.0.0.1", port, "t") as c:
                assert c.train(data) == len(data)
                out.append(_ranked(c.classify(probe)))
        np.testing.assert_allclose(
            [[s for _, s in r] for r in out[0]],
            [[s for _, s in r] for r in out[1]], rtol=1e-5, atol=1e-6)
        _close_ranked(out[0], out[2])
        (st,) = fast.get_status("").values()
        assert st["ingest.combo_flushes"] >= 1
        assert st["microbatch.train_raw.item_count"] == len(data)
    finally:
        fast.stop()
        slow.stop()


def test_server_schema_plan_on_a_uniform_feed():
    """A fixed key schema rides the dense schema plan on train and on
    coalesced classify."""
    conf = json.load(open(os.path.join(ROOT, "config/classifier/arow.json")))
    srv = _server("classifier", conf)
    try:
        with ClassifierClient("127.0.0.1", srv.rpc.port, "t") as c:
            data = [["ab"[i % 2], Datum({"x": float(i % 5), "y": -1.0})]
                    for i in range(32)]
            assert c.train(data) == 32
            assert len(c.classify([d for _, d in data[:4]])) == 4
        (st,) = srv.get_status("").values()
        assert st["ingest.schema_flushes"] >= 1
        assert st["ingest.schema_query_flushes"] >= 1
    finally:
        srv.stop()


def test_raw_train_bills_quality_and_usage_like_the_decoded_path():
    """A sampled raw batch is scored before its own update (the data
    quality plane's prequential count grows) and billed to its tenant."""
    srv = _server("classifier", SERVER_CONV, quality_sample=1.0)
    try:
        with ClassifierClient("127.0.0.1", srv.rpc.port, "t") as c:
            c.train(_train_data())
            c.train(_train_data())
        (q,) = srv.get_quality("").values()
        assert q["live"]["prequential"]["n"] > 0
        assert q["live"]["features"]["hashed"]["count"] > 0
        (u,) = srv.get_usage("").values()
        row = u["table"]["(untagged)"]["train"]
        assert row[usage_mod.FIELDS.index("requests")] == 2
        assert row[usage_mod.FIELDS.index("rows")] == 32
    finally:
        srv.stop()


def test_raw_params_with_the_port_client_and_call_raw():
    """A raw train and classify straight through ``call_raw``: the bytes
    the proxy relays reach the raw handlers."""
    srv = _server("classifier", SERVER_CONV)
    try:
        with RpcClient("127.0.0.1", srv.rpc.port) as c:
            span = c.call_raw("train", msgpack.packb(
                ["t", [[lab, d.to_msgpack()] for lab, d in _train_data()]]))
            assert msgpack.unpackb(span) == 16
            span = c.call_raw("classify", msgpack.packb(
                ["t", [Datum({"t": "win"}).to_msgpack()]]))
            (row,) = msgpack.unpackb(span, raw=False)
            assert {lab for lab, _ in row} == {"spam", "ham"}
    finally:
        srv.stop()
