"""The port's burst and weight engines (jubatus_tpu_torch/models/{burst,weight}.py)
against the JAX package's: the burst cases of
tests/test_clustering_burst_graph.py, run on both packages with the same
calls, and weight's update / calc_weight against the JAX WeightDriver; the
answers held equal, exactly (both keep host state and run the same float64
host arithmetic). Each case also keeps the reference test's own
assertions, on the port. Plus the cross-pack cases: a JAX pack loads
through convert.from_jax_pack and answers the same; the port's pack loads
in the JAX driver.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from jubatus_tpu.core.datum import Datum as JDatum
from jubatus_tpu.models import BurstDriver as JBurst
from jubatus_tpu.models import WeightDriver as JWeight
from jubatus_tpu.parallel import LocalMixGroup
from jubatus_tpu_torch.convert import from_jax_pack
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.models.burst import BurstDriver
from jubatus_tpu_torch.models.weight import WeightDriver
from torch_parity import port_mix

ROOT = os.path.join(os.path.dirname(__file__), "..")

BURST_CFG = {"parameter": {"window_batch_size": 5, "batch_interval": 10,
                           "max_reuse_batch_num": 5, "costcut_threshold": -1,
                           "result_window_rotate_size": 5}}

PORT = dict(Burst=lambda c: BurstDriver(c, device="cpu"), mix=port_mix)
JAX = dict(Burst=JBurst, mix=lambda ds: LocalMixGroup(ds).mix())


def both(case):
    """Run ``case(pkg)`` on each package; their records must be equal.
    Returns the port's record."""
    got, want = case(PORT), case(JAX)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# burst
# ---------------------------------------------------------------------------
def test_burst_detects_burst_window():
    def case(p):
        b = p["Burst"](BURST_CFG)
        out = [b.add_keyword("fire", scaling_param=2.0, gamma=1.0),
               b.add_keyword("fire", scaling_param=2.0, gamma=1.0)]
        docs = []
        for batch in range(5):
            for i in range(20):
                relevant = (i < 18) if batch == 3 else (i < 2)
                docs.append((batch * 10 + 0.5,
                             "fire alarm" if relevant else "calm day"))
        out += [b.add_documents(docs), b.get_result("fire"),
                b.get_all_bursted_results(), b.get_all_keywords()]
        return out

    added, again, n, win, allres, kws = both(case)
    assert added and not again and n == 100
    assert win["start_pos"] == 0.0
    assert len(win["batches"]) == 5
    assert win["batches"][3]["relevant_data_count"] == 18
    assert win["batches"][3]["burst_weight"] > 0
    assert win["batches"][0]["burst_weight"] == 0.0
    assert "fire" in allres
    assert kws[0]["keyword"] == "fire"


def test_burst_result_at_and_remove():
    def case(p):
        b = p["Burst"](BURST_CFG)
        b.add_keyword("x", 2.0, 1.0)
        b.add_documents([(p_, "x") for p_ in range(0, 100, 2)])
        out = [b.get_result_at("x", 45.0), b.get_result_at("x", 95.0),
               b.get_all_bursted_results_at(95.0), b.remove_keyword("x")]
        with pytest.raises(KeyError):
            b.get_result("x")
        b.add_keyword("y", 2.0, 1.0)
        b.remove_all_keywords()
        out.append(b.get_all_keywords())
        return out

    win, win2, _, removed, kws = both(case)
    assert win["start_pos"] == 0.0 and win2["start_pos"] == 50.0
    assert removed and kws == []


def test_burst_mix_merges_broadcast_counts():
    def case(p):
        a, b = p["Burst"](BURST_CFG), p["Burst"](BURST_CFG)
        for d in (a, b):
            d.add_keyword("k", 2.0, 1.0)
        docs = [(5.0, "k here")] * 3 + [(5.0, "nothing")] * 2
        a.add_documents(docs)
        b.add_documents(docs)
        p["mix"]([a, b])
        out = [d.get_result("k")["batches"][-1] for d in (a, b)]
        p["mix"]([a, b])
        out.append(a.get_result("k")["batches"][-1])
        c = p["Burst"](BURST_CFG)
        c.add_keyword("k", 2.0, 1.0)
        c.add_documents(docs[:2])
        p["mix"]([a, c])
        out.append(c.get_result("k")["batches"][-1])
        return out

    for last in both(case):
        assert last["all_data_count"] == 5
        assert last["relevant_data_count"] == 3


def test_burst_assignment_partitions_processing():
    def case(p):
        a, b = p["Burst"](BURST_CFG), p["Burst"](BURST_CFG)
        for d in (a, b):
            d.add_keyword("k1", 2.0, 1.0)
            d.add_keyword("k2", 2.0, 1.0)
        a.set_assignment(lambda kw: kw == "k1")
        b.set_assignment(lambda kw: kw == "k2")
        docs = [(5.0, "k1 and k2 both")] * 4
        a.add_documents(docs)
        b.add_documents(docs)
        assert a._rel_d["k1"] and not a._rel_d.get("k2")
        assert b._rel_d["k2"] and not b._rel_d.get("k1")
        out = [a.get_result("k1")["batches"][-1]["relevant_data_count"],
               b.get_result("k2")["batches"][-1]["relevant_data_count"]]
        p["mix"]([a, b])
        assert not a._rel_m.get("k2") and not b._rel_m.get("k1")
        a.set_assignment(lambda kw: True)
        b.set_assignment(lambda kw: kw == "k2")
        p["mix"]([a, b])
        out.append(a.get_result("k2")["batches"][-1]["relevant_data_count"])
        return out

    assert both(case) == [4, 4, 4]


def test_burst_save_load():
    def case(p):
        b = p["Burst"](BURST_CFG)
        b.add_keyword("k", 2.0, 1.0)
        b.add_documents([(5.0, "k")] * 5)
        b2 = p["Burst"](BURST_CFG)
        b2.unpack(b.pack())
        return b2.get_result("k")

    assert both(case)["batches"][-1]["relevant_data_count"] == 5


def _burst_stream(rng, n=600):
    words = ["fire", "flood", "calm", "quiet", "storm"]
    docs = []
    for i in range(n):
        pos = float(i // 12) + float(rng.random())
        hot = "storm" if 20 <= pos < 26 else words[int(rng.integers(4))]
        docs.append((pos, f"{hot} {words[int(rng.integers(5))]}"))
    return docs


def test_burst_weights_equal_on_a_seeded_stream():
    """A seeded stream with a burst of "storm": every window of every
    keyword at every position equal, weights included, with a costcut."""
    cfg = {"parameter": dict(BURST_CFG["parameter"], costcut_threshold=3.0,
                             batch_interval=2)}

    def case(p):
        b = p["Burst"](cfg)
        for kw, s, g in (("storm", 2.0, 1.0), ("fire", 1.5, 0.5),
                         ("calm", 3.0, 2.0)):
            b.add_keyword(kw, s, g)
        docs = _burst_stream(np.random.default_rng(3))
        out = []
        for lo in range(0, len(docs), 50):
            b.add_documents(docs[lo:lo + 50])
            out.append(b.get_all_bursted_results())
        out += [b.get_result_at(kw, pos) for kw in ("storm", "fire", "calm")
                for pos in (10.0, 23.5, 40.0)]
        return out

    out = both(case)
    assert any("storm" in r for r in out[:-9])


def test_burst_packs_cross_load_both_ways():
    j = JBurst(BURST_CFG)
    for kw in ("storm", "fire"):
        j.add_keyword(kw, 2.0, 1.0)
    j.add_documents(_burst_stream(np.random.default_rng(8), 300))
    t = from_jax_pack(j.pack(), BURST_CFG, engine="burst", device="cpu")
    for kw in ("storm", "fire"):
        assert t.get_result(kw) == j.get_result(kw)
    assert t.get_all_keywords() == j.get_all_keywords()
    t.add_documents([(30.0, "fire here")] * 7)
    j2 = JBurst(BURST_CFG)
    j2.unpack(t.pack())
    assert j2.get_result("fire") == t.get_result("fire")


# ---------------------------------------------------------------------------
# weight
# ---------------------------------------------------------------------------
def _weight_config():
    with open(os.path.join(ROOT, "config", "weight", "default.json")) as f:
        return json.load(f)


WEIGHT_TEXTS = ["the quick brown fox", "the lazy dog", "quick quick fox",
                "a dog and a fox", "brown dog"]


def _weight_datum(D, i):
    return D({"text": WEIGHT_TEXTS[i % len(WEIGHT_TEXTS)],
              "n": float(i % 4) + 0.5})


def test_weight_update_and_calc_weight_equal():
    """config/weight/default.json (space-split words, tf sample weight,
    idf global weight, num features): every update's and calc_weight's
    named weights equal, document frequencies accumulating alike."""
    conf = _weight_config()
    j, t = JWeight(conf), WeightDriver(conf, device="cpu")
    for i in range(12):
        got = t.update(_weight_datum(Datum, i))
        assert got == j.update(_weight_datum(JDatum, i))
        assert got and all(isinstance(k, str) for k, _ in got)
    for i in range(5):
        q = {"text": WEIGHT_TEXTS[i] + " unseen", "n": 2.0}
        assert t.calc_weight(Datum(q)) == j.calc_weight(JDatum(q))
    idf = dict(t.calc_weight(Datum({"text": "the fox"})))
    assert idf["text$the@space#tf/idf"] > 0
    t.clear()
    j.clear()
    assert t.calc_weight(Datum({"text": "fox"})) == \
        j.calc_weight(JDatum({"text": "fox"}))


def test_weight_packs_cross_load_both_ways():
    conf = _weight_config()
    j = JWeight(conf)
    for i in range(9):
        j.update(_weight_datum(JDatum, i))
    t = from_jax_pack(j.pack(), conf, engine="weight", device="cpu")
    q = {"text": "the quick dog", "n": 1.0}
    assert t.calc_weight(Datum(q)) == j.calc_weight(JDatum(q))
    t.update(Datum({"text": "dog dog"}))
    j2 = JWeight(conf)
    j2.unpack(t.pack())
    assert j2.calc_weight(JDatum(q)) == t.calc_weight(Datum(q))
    assert t.get_status()["device"] == "cpu"
