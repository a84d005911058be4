"""The port's linear classifier driver (jubatus_tpu_torch/models/classifier.py)
against the JAX package's, on the CPU.

Mirrors tests/test_classifier_driver.py on the port (train / classify round
trips, label counts, set / delete with slot reuse, capacity growth, clear,
pack / unpack, a two-replica mix with distinct labels through get_schema /
sync_schema and the row-trimmed mixable), then holds it against
jubatus_tpu's driver fed the same datums: classify scores, labels, the
hashed, indexed, schema and combo entry points, sync_schema's row permute,
and checkpoints in both directions (a JAX ``pack()`` loads through
``convert.from_jax_pack``; the port's ``pack()`` loads in the JAX driver).

Tolerance: scores and tables within 1e-5 of the table's (or the scores')
largest magnitude plus rtol 1e-4: the K-sums add in another order than
XLA's (tests/test_torch_classifier_ops.py says why). A model moved between
the packages classifies bit-equal to where it came from only up to that
order, so cross-loaded scores use the same tolerance; the tables
themselves move bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from jubatus_tpu.core import Datum as JDatum
from jubatus_tpu.models import ClassifierDriver as JDriver
from jubatus_tpu.parallel import LocalMixGroup
from jubatus_tpu_torch import convert
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.models.classifier import ClassifierDriver
from torch_parity import port_mix

CFG = {
    "method": "AROW",
    "parameter": {"regularization_weight": 1.0},
    "converter": {
        "string_rules": [{"key": "*", "type": "space", "sample_weight": "tf",
                          "global_weight": "bin"}],
        "num_rules": [{"key": "*", "type": "num"}],
    },
}

SPAM = ["buy cheap pills now", "cheap pills discount buy now",
        "discount pills buy"]
HAM = ["meeting notes for tuesday", "tuesday agenda and meeting notes",
       "agenda for the meeting"]
EGGS = ["fresh organic eggs from the farm", "farm eggs organic dozen",
        "dozen fresh eggs"]


def _drv(cfg=CFG, dim_bits=12, **kw):
    return ClassifierDriver(cfg, dim_bits=dim_bits, device="cpu", **kw)


def _data(Dt, *groups):
    return [(lab, Dt({"t": t})) for lab, texts in groups for t in texts]


def trained_driver(dim_bits=12):
    d = _drv(dim_bits=dim_bits)
    for _ in range(3):
        d.train(_data(Datum, ("spam", SPAM), ("ham", HAM)))
    return d


def top_label(result):
    return max(result, key=lambda kv: kv[1])[0]


def assert_scores_close(got, want):
    assert [[lab for lab, _ in r] for r in got] == \
        [[lab for lab, _ in r] for r in want]
    g = np.array([[s for _, s in r] for r in got], dtype=np.float64)
    w = np.array([[s for _, s in r] for r in want], dtype=np.float64)
    scale = float(np.abs(w).max()) if w.size else 0.0
    np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * scale + 1e-12)


# -- tests/test_classifier_driver.py, on the port -------------------------------
def test_train_classify_roundtrip():
    d = trained_driver()
    res = d.classify([Datum({"t": "cheap discount pills"}),
                      Datum({"t": "notes for agenda"})])
    assert top_label(res[0]) == "spam"
    assert top_label(res[1]) == "ham"
    assert {lab for lab, _ in res[0]} == {"spam", "ham"}


def test_get_labels_counts_and_set_delete():
    d = trained_driver()
    assert d.get_labels() == {"spam": 9, "ham": 9}
    assert d.set_label("eggs") is True
    assert d.set_label("eggs") is False
    assert set(d.get_labels()) == {"spam", "ham", "eggs"}
    assert d.get_labels()["eggs"] == 0
    assert d.delete_label("eggs") is True
    assert d.delete_label("eggs") is False
    assert set(d.get_labels()) == {"spam", "ham"}


def test_deleted_label_slot_reuse_is_clean():
    d = trained_driver()
    d.delete_label("spam")
    d.set_label("other")
    scores = dict(d.classify([Datum({"t": "cheap discount pills"})])[0])
    assert scores["other"] == 0.0


def test_train_returns_count_and_empty_ok():
    d = _drv(dim_bits=10)
    assert d.train([]) == 0
    assert d.train([("a", Datum({"t": "x y"})), ("b", Datum({"t": "z w"}))]) == 2
    assert d.classify([]) == []


def test_clear_resets():
    d = trained_driver()
    d.clear()
    assert d.get_labels() == {}
    assert d.classify([Datum({"t": "anything"})]) == [[]]
    assert d.update_count == 0


def test_label_capacity_growth():
    d = _drv(dim_bits=10)
    for i in range(20):
        d.train([(f"label{i:02d}", Datum({"t": f"word{i} tok{i}"}))])
    assert len(d.get_labels()) == 20
    assert d.capacity == 32
    assert d.state.w.shape == (32, 1 << 10)


def test_unknown_method_raises():
    with pytest.raises(ValueError):
        ClassifierDriver({"method": "SVM"}, device="cpu")


def test_feature_sharding_is_not_yet_ported():
    """Feature sharding is ported: mesh= splits the tables into blocks
    and the driver answers as the flat one; shard_features= derives the
    shard count from the budget (the CPU is one local device, so only a
    budget of the whole dim starts), with the JAX package's errors."""
    from jubatus_tpu_torch.parallel.mesh import ShardMesh

    flat, shard = trained_driver(), _drv(mesh=ShardMesh(["cpu"] * 4))
    for _ in range(3):
        shard.train(_data(Datum, ("spam", SPAM), ("ham", HAM)))
    assert len(shard.state.w) == 4 and shard.get_labels() == flat.get_labels()
    q = [Datum({"t": "cheap discount pills"})]
    for (la, sa), (lb, sb) in zip(flat.classify(q)[0], shard.classify(q)[0]):
        assert la == lb
        np.testing.assert_allclose(sa, sb, rtol=1e-5, atol=1e-6)
    assert _drv(shard_features=1 << 12).shard_stats() == {}
    with pytest.raises(ValueError, match="feature sharding needs 4 local "
                                         "devices, have 1"):
        _drv(shard_features=1 << 10)
    with pytest.raises(ValueError, match="does not divide"):
        _drv(shard_features=1000)


def test_pack_unpack_roundtrip():
    d = trained_driver()
    before = d.classify([Datum({"t": "cheap discount pills"})])
    d2 = _drv()
    d2.unpack(d.pack())
    after = d2.classify([Datum({"t": "cheap discount pills"})])
    assert before == after
    assert d2.get_labels() == d.get_labels()
    with pytest.raises(ValueError, match="method"):
        _drv(dict(CFG, method="PA")).unpack(d.pack())
    with pytest.raises(ValueError, match="dim"):
        _drv(dim_bits=10).unpack(d.pack())


def test_mix_two_replicas_with_distinct_labels():
    d0, d1 = _drv(), _drv()
    for _ in range(3):
        d0.train(_data(Datum, ("spam", SPAM), ("ham", HAM)))
        d1.train(_data(Datum, ("eggs", EGGS), ("ham", HAM)))
    port_mix([d0, d1])
    assert d0.get_schema() == d1.get_schema() == ["eggs", "ham", "spam"]
    assert d0.get_labels() == d1.get_labels() == {"spam": 9, "ham": 18,
                                                  "eggs": 9}
    for d in (d0, d1):
        res = d.classify([Datum({"t": "cheap discount pills"}),
                          Datum({"t": "meeting agenda notes"}),
                          Datum({"t": "organic farm eggs"})])
        assert [top_label(r) for r in res] == ["spam", "ham", "eggs"]
    w_before = d0.state.w.clone()
    port_mix([d0, d1])
    np.testing.assert_allclose(d0.state.w.numpy(), w_before.numpy(), atol=1e-6)


# -- against the JAX driver ---------------------------------------------------------
QUERIES = ["cheap discount pills", "notes for agenda", "organic eggs now",
           "buy meeting", "nothing known"]


@pytest.mark.parametrize("method", ["perceptron", "PA", "PA1", "PA2", "CW",
                                    "AROW", "NHERD"])
def test_classify_matches_the_jax_driver(method):
    cfg = dict(CFG, method=method)
    j, t = JDriver(cfg, dim_bits=12), _drv(cfg)
    for _ in range(3):
        j.train(_data(JDatum, ("spam", SPAM), ("ham", HAM), ("eggs", EGGS)))
        t.train(_data(Datum, ("spam", SPAM), ("ham", HAM), ("eggs", EGGS)))
    assert t.get_labels() == j.get_labels()
    assert_scores_close(t.classify([Datum({"t": q}) for q in QUERIES]),
                        j.classify([JDatum({"t": q}) for q in QUERIES]))
    assert t.update_count == j.update_count


def test_sequential_mode_matches_the_jax_driver():
    j = JDriver(CFG, dim_bits=12, train_mode="sequential")
    t = _drv(train_mode="sequential")
    for _ in range(2):
        j.train(_data(JDatum, ("spam", SPAM), ("ham", HAM)))
        t.train(_data(Datum, ("spam", SPAM), ("ham", HAM)))
    assert_scores_close(t.classify([Datum({"t": q}) for q in QUERIES]),
                        j.classify([JDatum({"t": q}) for q in QUERIES]))


def _hashed(rng, b, k=8, dim=1 << 12):
    idx = rng.integers(1, dim, size=(b, k)).astype(np.int32)
    val = rng.normal(size=(b, k)).astype(np.float32)
    return idx, val


def test_hashed_and_indexed_entry_points_match_the_jax_driver():
    rng = np.random.default_rng(3)
    j, t = JDriver(CFG, dim_bits=12), _drv()
    idx, val = _hashed(rng, 40)
    labels = [f"l{i % 3}" for i in range(40)]
    assert t.train_hashed(labels, idx, val) == j.train_hashed(labels, idx, val)
    idx, val = _hashed(rng, 30)
    uniq = ["l1", "l9", "l1"]  # a repeated uniq label counts once per row
    lidx = rng.integers(0, 3, size=30).astype(np.int32)
    assert t.train_indexed(uniq, lidx, idx, val) == \
        j.train_indexed(uniq, lidx, idx, val)
    assert t.get_labels() == j.get_labels()
    q_idx, q_val = _hashed(rng, 5)
    assert_scores_close(t.classify_hashed(q_idx, q_val),
                        j.classify_hashed(q_idx, q_val))


def test_schema_and_combo_entry_points_match_the_jax_driver():
    rng = np.random.default_rng(4)
    j, t = JDriver(CFG, dim_bits=12), _drv()
    uidx = rng.choice(np.arange(1, 1 << 12), size=11,
                      replace=False).astype(np.int32)
    val = rng.normal(size=(24, 11)).astype(np.float32)
    uniq, lidx = ["a", "b"], (np.arange(24) % 2).astype(np.int32)
    assert t.train_indexed_schema(uniq, lidx, uidx, val) == \
        j.train_indexed_schema(uniq, lidx, uidx, val)
    assert_scores_close(t.classify_hashed_schema(uidx, val[:3]),
                        j.classify_hashed_schema(uidx, val[:3]))
    a_idx = np.array([0, 1, 2, 0, 3], np.int32)
    b_idx = np.array([1, 2, 3, 4, 5], np.int32)
    mul = np.array([True, False, True, False, True])
    base = rng.normal(size=(24, 6)).astype(np.float32)
    assert t.train_indexed_combo(uniq, lidx, uidx, base, a_idx, b_idx, mul) \
        == j.train_indexed_combo(uniq, lidx, uidx, base, a_idx, b_idx, mul)
    assert_scores_close(
        t.classify_hashed_combo(uidx, base[:4], a_idx, b_idx, mul),
        j.classify_hashed_combo(uidx, base[:4], a_idx, b_idx, mul))
    assert t.get_labels() == j.get_labels()
    for a, b in zip(j.state, t.state):
        want = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_sequential_schema_and_combo_take_the_sparse_path():
    rng = np.random.default_rng(5)
    j = JDriver(CFG, dim_bits=12, train_mode="sequential")
    t = _drv(train_mode="sequential")
    uidx = rng.choice(np.arange(1, 1 << 12), size=11,
                      replace=False).astype(np.int32)
    base = rng.normal(size=(12, 6)).astype(np.float32)
    a_idx = np.array([0, 1, 2, 0, 3], np.int32)
    b_idx = np.array([1, 2, 3, 4, 5], np.int32)
    mul = np.array([True, False, True, False, True])
    lidx = (np.arange(12) % 2).astype(np.int32)
    t.train_indexed_combo(["a", "b"], lidx, uidx, base, a_idx, b_idx, mul)
    j.train_indexed_combo(["a", "b"], lidx, uidx, base, a_idx, b_idx, mul)
    want = np.asarray(j.state.dw)
    np.testing.assert_allclose(t.state.dw.numpy(), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))


def test_sync_schema_permutes_rows_as_the_jax_driver():
    """A union that inserts labels before the existing ones and grows the
    capacity past 8: both drivers move the same rows to the same slots."""
    j, t = JDriver(CFG, dim_bits=10), _drv(dim_bits=10)
    for d, Dt in ((j, JDatum), (t, Datum)):
        d.train(_data(Dt, ("spam", SPAM), ("ham", HAM)))
        d.set_label("zz")
        d.delete_label("ham")
    union = [f"a{i}" for i in range(8)] + ["spam", "zz"]
    j.sync_schema(union)
    t.sync_schema(union)
    assert t.capacity == j.capacity == 16
    assert t.labels == j.labels and t.label_slots == j.label_slots
    np.testing.assert_array_equal(t.label_counts, j.label_counts)
    ts = ClassifierDriver(CFG, dim_bits=10, device="cpu")
    ts.unpack(j.pack())  # the JAX tables, bit for bit, to permute again
    for d in (j, ts):
        d.sync_schema(sorted(union + ["b"]))
    # unpack folded dw into w (and dprec into prec): compare the sums
    np.testing.assert_array_equal((ts.state.w + ts.state.dw).numpy(),
                                  np.asarray(j.state.w + j.state.dw))
    np.testing.assert_array_equal((ts.state.prec + ts.state.dprec).numpy(),
                                  np.asarray(j.state.prec + j.state.dprec))
    t.sync_schema(t.get_schema())  # already aligned: nothing moves
    assert t.get_schema() == sorted(union)


def test_mix_matches_the_jax_mix_group():
    js = [JDriver(CFG, dim_bits=10) for _ in range(2)]
    ts = [_drv(dim_bits=10) for _ in range(2)]
    groups = [(("spam", SPAM), ("ham", HAM)), (("eggs", EGGS), ("ham", HAM))]
    for jd, td, g in zip(js, ts, groups):
        jd.train(_data(JDatum, *g))
        td.train(_data(Datum, *g))
    LocalMixGroup(js).mix()
    port_mix(ts)
    assert ts[0].get_labels() == js[0].get_labels()
    for jd, td in zip(js, ts):
        for a, b in zip(jd.state, td.state):
            want = np.asarray(a)
            np.testing.assert_allclose(b.numpy(), want, rtol=1e-4,
                                       atol=1e-5 * float(np.abs(want).max()))


def test_mixable_ships_only_the_live_rows_as_host_numpy():
    d = trained_driver()
    diff = d.get_mixables()["classifier"].get_diff()
    assert isinstance(diff["dw"], np.ndarray) and diff["dw"].shape[0] == 2
    assert diff["dprec"].shape == (2, 1 << 12)
    np.testing.assert_array_equal(diff["label_counts"], [9.0, 9.0])


@pytest.mark.parametrize("method", ["AROW", "PA1"])
def test_a_jax_model_loads_in_the_port_and_back(method):
    cfg = dict(CFG, method=method)
    j = JDriver(cfg, dim_bits=12)
    for _ in range(2):
        j.train(_data(JDatum, ("spam", SPAM), ("ham", HAM), ("eggs", EGGS)))
    j.delete_label("eggs")
    t = convert.from_jax_pack(j.pack(), cfg, engine="classifier",
                              device="cpu")
    assert isinstance(t, ClassifierDriver)
    assert t.get_labels() == j.get_labels() and t.labels == j.labels
    # pack() folds dw into w; the tables move bit for bit
    np.testing.assert_array_equal(t.state.w.numpy(),
                                  np.asarray(j.state.w + j.state.dw))
    assert_scores_close(t.classify([Datum({"t": q}) for q in QUERIES]),
                        j.classify([JDatum({"t": q}) for q in QUERIES]))
    # and the port's own pack loads in a fresh JAX driver
    t.train(_data(Datum, ("ham", HAM)))
    j2 = JDriver(cfg, dim_bits=12)
    j2.unpack(t.pack())
    assert j2.get_labels() == t.get_labels()
    np.testing.assert_array_equal(np.asarray(j2.state.w),
                                  (t.state.w + t.state.dw).numpy())
    assert_scores_close(t.classify([Datum({"t": q}) for q in QUERIES]),
                        j2.classify([JDatum({"t": q}) for q in QUERIES]))


def test_classify_dispatches_under_the_lock_and_reads_back_after():
    """The scores are launched while the lock is held and read back once
    it is free: a classify racing a train sees the state before or after
    each train step, never a torn one, and both finish."""
    import threading

    d = trained_driver()
    errors = []

    def trainer():
        try:
            for _ in range(20):
                d.train(_data(Datum, ("spam", SPAM)))
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    th = threading.Thread(target=trainer)
    th.start()
    for _ in range(20):
        (res,) = d.classify([Datum({"t": "cheap pills"})])
        assert {lab for lab, _ in res} == {"spam", "ham"}
        assert all(np.isfinite(s) for _, s in res)
    th.join()
    assert not errors
    assert not d.lock._is_owned()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_driver_matches_cpu_driver(cuda):
    on_card = ClassifierDriver(CFG, dim_bits=12, device=cuda)
    on_cpu = _drv()
    for d in (on_card, on_cpu):
        for _ in range(3):
            d.train(_data(Datum, ("spam", SPAM), ("ham", HAM), ("eggs", EGGS)))
    assert on_card.get_status()["device"].startswith("cuda")
    assert_scores_close(on_card.classify([Datum({"t": q}) for q in QUERIES]),
                        on_cpu.classify([Datum({"t": q}) for q in QUERIES]))
    packed = on_card.pack()
    assert isinstance(packed["w"], np.ndarray)
