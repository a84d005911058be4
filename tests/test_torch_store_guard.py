"""The port's durable model plane (the model store with ``store:`` ids and
warm boot) and its model snapshot ring with rollback, on the CPU.

Mirrors ``tests/test_model_store.py``, all sixteen tests (diff documents,
chain semantics, CRC refusal and fault sites, warm boot, save/load with
store ids, reshard-on-restore 1→8 and 8→2), and the snapshot-ring,
rollback and quarantine tests of ``tests/test_model_guard.py``, against
the port. Then the two packages on one store: the keys and record bytes
are the JAX package's, a record either package wrote materializes in the
other to the same bytes, a server of either package boots warm from the
other's uploads and loads the other's ``store:<key>``, and a push fleet
under ``--mix-guard quarantine`` refuses a poisoned total and rolls every
receiving member back to its snapshot.
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np
import pytest

from jubatus_tpu.framework import model_store as jax_model_store
from jubatus_tpu.server import EngineServer as JEngineServer
from jubatus_tpu.server.args import ServerArgs as JServerArgs
from jubatus_tpu.server.factory import create_driver as jax_create_driver
from jubatus_tpu.utils import faults as jax_faults
from jubatus_tpu_torch.coord.memory import MemoryCoordinator, _Store
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.framework.linear_mixer import PROTOCOL_VERSION
from jubatus_tpu_torch.framework.model_guard import (DEFAULT_QUARANTINE_AFTER,
                                                     DEFAULT_RELEASE_AFTER,
                                                     MixGuard,
                                                     ModelSnapshotRing)
from jubatus_tpu_torch.framework.model_store import (LocalDirBackend,
                                                     ModelStore,
                                                     StoreUploader,
                                                     apply_diff, diff_tree)
from jubatus_tpu_torch.framework.save_load import (SaveLoadError,
                                                   pack_envelope,
                                                   read_envelope)
from jubatus_tpu_torch.rpc.client import ClassifierClient, RpcClient
from jubatus_tpu_torch.server import EngineServer
from jubatus_tpu_torch.server.args import ServerArgs, parse_server_args
from jubatus_tpu_torch.server.factory import create_driver
from jubatus_tpu_torch.utils import events, faults
from jubatus_tpu_torch.utils.serialization import pack_obj, unpack_obj
from jubatus_tpu_torch.utils.tree import tree_leaves, tree_map

CLF_CONF = {"method": "AROW", "parameter": {"regularization_weight": 1.0},
            "converter": {"num_rules": [{"key": "*", "type": "num"}]}}
NN_CONF = {"method": "lsh", "parameter": {"hash_num": 8},
           "converter": {"num_rules": [{"key": "*", "type": "num"}]}}
PA_CONF = {"method": "PA", "parameter": {"regularization_weight": 1.0},
           "converter": {"num_rules": [{"key": "*", "type": "num"}]}}


class _Counts(dict):
    def __call__(self, name, n=1):
        self[name] = self.get(name, 0) + n


def _mkstore(tmp_path, counter=None, engine="classifier"):
    return ModelStore(LocalDirBackend(str(tmp_path / "store")),
                      cluster="t", engine=engine, counter=counter)


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    return [("pos" if rng.random() < 0.5 else "neg",
             {"f0": float(rng.normal()), "f1": float(rng.normal())})
            for _ in range(n)]


def _clf_driver():
    return create_driver("classifier", CLF_CONF, device="cpu")


def _tree_equal(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and \
            all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and \
            all(_tree_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return isinstance(a, np.ndarray) and isinstance(b, np.ndarray) \
            and a.dtype == b.dtype and bool(np.array_equal(a, b))
    return a == b


# -- diff documents -------------------------------------------------------------

def test_diff_tree_lossless_roundtrip():
    base = {"w": np.arange(8, dtype=np.float32),
            "meta": {"n": 3, "tag": "x"},
            "rows": [np.ones(4, dtype=np.float32), "keep"]}
    new = {"w": np.arange(8, dtype=np.float32) * 1.7 + 0.1,
           "meta": {"n": 5, "tag": "x"},
           "rows": [np.ones(4, dtype=np.float32) * 2.0, "keep"]}
    doc, belief = diff_tree(base, new)
    replay = apply_diff(unpack_obj(pack_obj(base)), doc)
    assert _tree_equal(replay, new)
    assert _tree_equal(belief, new)
    paths = [tuple(p) for p, _ in doc["changed"]]
    assert ("rows", 1) not in paths and ("meta", "tag") not in paths


def test_diff_tree_structure_change_ships_raw():
    base = {"labels": {"pos": np.zeros(4, dtype=np.float32)}}
    new = {"labels": {"pos": np.zeros(4, dtype=np.float32),
                      "neg": np.ones(4, dtype=np.float32)}}
    doc, belief = diff_tree(base, new)
    replay = apply_diff(unpack_obj(pack_obj(base)), doc)
    assert _tree_equal(replay, new)
    (path, spec), = doc["changed"]
    assert spec["m"] == "raw"


def test_diff_chain_int8_error_feedback_telescopes():
    """In int8 mode belief == what a replayer reconstructs, so the chain's
    error never accumulates past the last diff's quantization residual."""
    rng = np.random.default_rng(7)
    state = {"w": rng.normal(size=512).astype(np.float32)}
    belief = unpack_obj(pack_obj(state))
    replay = unpack_obj(pack_obj(state))
    for _ in range(5):
        new = {"w": (state["w"] + rng.normal(size=512).astype(np.float32)
                     * 0.01).astype(np.float32)}
        doc, belief = diff_tree(belief, new, compress="int8")
        replay = apply_diff(replay, doc)
        state = new
    assert _tree_equal(replay, belief)
    assert float(np.abs(replay["w"] - state["w"]).max()) < 1e-3


@pytest.mark.parametrize("compress", ["off", "int8"])
def test_diff_documents_are_the_jax_packages(compress):
    """The same base and new state give the same diff document and the
    same belief in both packages (the int8 blocks included)."""
    rng = np.random.default_rng(3)
    base = {"w": rng.normal(size=(3, 300)).astype(np.float32),
            "n": 4, "labels": ["a", "b"]}
    new = {"w": base["w"] + 0.01 * rng.normal(size=(3, 300)).astype(
        np.float32), "n": 5, "labels": ["a", "b", "c"]}
    doc, belief = diff_tree(unpack_obj(pack_obj(base)),
                            unpack_obj(pack_obj(new)), compress=compress)
    jdoc, jbelief = jax_model_store.diff_tree(
        unpack_obj(pack_obj(base)), unpack_obj(pack_obj(new)),
        compress=compress)
    assert pack_obj(doc) == pack_obj(jdoc)
    assert _tree_equal(belief, jbelief)


# -- chain semantics --------------------------------------------------------------

def _upload_chain(store, driver, ticks=3, rows_per_tick=20, seed=1,
                  compress="off"):
    up = StoreUploader(store, "n1", config=json.dumps(CLF_CONF),
                       compress=compress)
    version = 0
    for t in range(ticks):
        driver.train([(lab, Datum(d))
                      for lab, d in _rows(rows_per_tick, seed + t)])
        version += rows_per_tick
        up.tick(driver, version)
    return up


def test_chain_gap_refused_truncates_at_prefix(tmp_path):
    store = _mkstore(tmp_path)
    _upload_chain(store, _clf_driver(), ticks=4)
    recs = store.records(kind="diff")
    assert len(recs) == 3
    _, meta = store.materialize(node="n1")
    assert meta["chain_len"] == 3
    store.backend.delete(recs[1].key)
    _, meta = store.materialize(node="n1")
    assert meta["chain_len"] == 1
    assert meta["model_version"] == recs[0].version


def test_chain_replay_equals_compacted_full(tmp_path):
    """With --store-compress off, the chain's replay IS the compacted full
    record, byte for byte."""
    store = _mkstore(tmp_path)
    _upload_chain(store, _clf_driver(), ticks=4)
    blob_replay, meta = store.materialize(node="n1")
    assert meta["chain_len"] == 3
    key = store.compact(node="n1")
    assert key is not None
    assert store.records(kind="diff", node="n1") == []
    blob_compact, meta2 = store.materialize(node="n1")
    assert meta2["chain_len"] == 0
    assert blob_compact == blob_replay
    _, user_replay = read_envelope(blob_replay, "replay")
    _, user_compact = read_envelope(blob_compact, "compact")
    assert _tree_equal(unpack_obj(user_replay), unpack_obj(user_compact))


def test_point_in_time_resolve_picks_newest_at_or_before(tmp_path):
    store = _mkstore(tmp_path)
    _upload_chain(store, _clf_driver(), ticks=3)
    recs = store.records()
    mid_hlc = recs[1].hlc  # full + first diff
    _, meta = store.materialize(at=mid_hlc, node="n1")
    assert meta["chain_len"] == 1
    assert meta["hlc"] == mid_hlc
    _, meta_latest = store.materialize(node="n1")
    assert meta_latest["hlc"] == recs[-1].hlc


# -- CRC refusal + fault sites ------------------------------------------------------

def test_put_blob_refuses_unstamped_bytes(tmp_path):
    store = _mkstore(tmp_path)
    with pytest.raises(SaveLoadError):
        store.put_blob(b"not an envelope", kind="full", node="n1",
                       model_version=1)
    assert store.records() == []


def test_corrupt_get_is_refused_counted_and_evented(tmp_path):
    counts = _Counts()
    store = _mkstore(tmp_path, counter=counts)
    blob = pack_envelope(pack_obj({"type": "classifier"}), pack_obj([1, {}]))
    key = store.put_blob(blob, kind="full", node="n1", model_version=1)
    before = events.hlc_now()
    with faults.armed("store.get:bitflip"):
        with pytest.raises(SaveLoadError):
            store.fetch(key)
        assert store.latest() is None  # no snapshot, never a partial one
    assert counts.get("store.crc_refused", 0) >= 1
    evs = events.default_journal().snapshot(since=before, grep="crc_refused")
    assert evs and evs[-1]["subsystem"] == "store"
    assert store.fetch(key) == blob


def test_put_fault_counted_chain_consistent(tmp_path):
    counts = _Counts()
    store = _mkstore(tmp_path, counter=counts)
    d = _clf_driver()
    up = _upload_chain(store, d, ticks=2)
    with faults.armed("store.put:error"):
        d.train([("pos", Datum({"f0": 1.0}))])
        with pytest.raises(faults.FaultInjected):
            up.tick(d, 999)
    assert counts.get("store.put_errors", 0) >= 1
    _, meta = store.materialize(node="n1")
    assert meta["chain_len"] == 1


def test_compact_fault_is_advisory(tmp_path):
    store = _mkstore(tmp_path)
    _upload_chain(store, _clf_driver(), ticks=3)
    with faults.armed("store.compact:error"):
        with pytest.raises(faults.FaultInjected):
            store.compact(node="n1")
    _, meta = store.materialize(node="n1")
    assert meta["chain_len"] == 2


# -- server integration: warm boot, save/load, degrade-to-cold -----------------------

def _clf_args(tmp_path, **over):
    base = dict(engine="classifier", listen_addr="127.0.0.1",
                datadir=str(tmp_path / "data"),
                store_dir=str(tmp_path / "store"), store_interval=30.0,
                interval_sec=1e9, interval_count=1 << 30)
    base.update(over)
    os.makedirs(base["datadir"], exist_ok=True)
    return base


def _clf_server(tmp_path, pkg="port", **over):
    if pkg == "jax":
        srv = JEngineServer("classifier", CLF_CONF, JServerArgs(
            telemetry_interval=0, **_clf_args(tmp_path, **over)))
    else:
        srv = EngineServer("classifier", CLF_CONF,
                           ServerArgs(**_clf_args(tmp_path, **over)),
                           device="cpu")
    srv.start(0)
    return srv


def _train_and_tick(srv, rows=40, seed=3):
    if isinstance(srv, EngineServer):
        data = [(lab, Datum(d)) for lab, d in _rows(rows, seed)]
    else:
        from jubatus_tpu.core.datum import Datum as JDatum

        data = [(lab, JDatum(d)) for lab, d in _rows(rows, seed)]
    srv.driver.train(data)
    # the tests tick the uploader directly, past its interval throttle
    srv.store_uploader.tick(srv.driver, int(srv.driver.update_count))


PROBES = [{"f0": 0.5, "f1": -0.5}, {"f0": 1.5, "f1": 0.25},
          {"f0": -2.0, "f1": 1.0}]


def _answers(srv):
    with ClassifierClient("127.0.0.1", srv.args.rpc_port, "") as c:
        return [sorted((_text(lab), s) for lab, s in r)
                for r in c.classify([Datum(p) for p in PROBES])]


def _text(x):
    return x.decode() if isinstance(x, bytes) else x


def test_warm_boot_restores_identical_model(tmp_path):
    s1 = _clf_server(tmp_path)
    try:
        _train_and_tick(s1)
        before = _answers(s1)
    finally:
        s1.stop()  # hard kill: stop() persists nothing
    s2 = _clf_server(tmp_path)
    try:
        assert s2.warmboot["outcome"] == "warm"
        assert s2.warmboot["model_version"] == 40
        assert _answers(s2) == before
        st = list(s2.get_status().values())[0]
        assert st["warmboot.outcome"] == "warm"
        assert st["store.records_full"] >= 1
    finally:
        s2.stop()


def test_flaky_store_degrades_warm_to_cold_never_wrong(tmp_path):
    s1 = _clf_server(tmp_path)
    try:
        _train_and_tick(s1)
    finally:
        s1.stop()
    before = events.hlc_now()
    with faults.armed("store.get:bitflip"):
        s2 = _clf_server(tmp_path)
        try:
            assert s2.warmboot["outcome"] == "degraded_to_cold"
            assert s2.driver.update_count == 0  # pristine, not partial
            counters = s2.trace.counters()
            assert counters.get("warmboot.degraded_to_cold", 0) == 1
            assert counters.get("store.crc_refused", 0) >= 1
            evs = s2.trace.events.snapshot(grep="degraded_to_cold")
            assert evs and evs[-1]["subsystem"] == "warmboot"
        finally:
            s2.stop()
    evs = events.default_journal().snapshot(since=before, grep="crc_refused")
    assert evs and evs[-1]["subsystem"] == "store"


def test_no_snapshot_cold_boot_counted(tmp_path):
    srv = _clf_server(tmp_path)
    try:
        assert srv.warmboot["outcome"] == "cold"
        assert srv.trace.counters().get("warmboot.no_snapshot", 0) == 1
    finally:
        srv.stop()


def test_save_reply_carries_store_id_and_load_accepts_it(tmp_path):
    s1 = _clf_server(tmp_path)
    try:
        _train_and_tick(s1)
        want = _answers(s1)
        reply = s1.save("t", "snap1")
        store_keys = [v for k, v in reply.items()
                      if str(k).startswith("store:")]
        assert len(store_keys) == 1 and store_keys[0].endswith(".jub")
    finally:
        s1.stop()
    s2 = _clf_server(tmp_path, datadir=str(tmp_path / "data2"),
                     store_warmboot=False)
    try:
        assert s2.load("t", "store:" + store_keys[0])
        assert _answers(s2) == want
        s2.driver.clear()
        # by plain id, through the store scan: no local file exists
        assert s2.load("t", "snap1")
        assert _answers(s2) == want
    finally:
        s2.stop()


# -- reshard-on-restore through the store ---------------------------------------------

def _nn_boot(tmp_path, coord_store, **over):
    base = dict(engine="nearest_neighbor", coordinator="(shared)",
                name="nn", listen_addr="127.0.0.1",
                datadir=str(tmp_path / "data"),
                store_dir=str(tmp_path / "store"), store_interval=30.0,
                interval_sec=1e9, interval_count=1 << 30)
    base.update(over)
    os.makedirs(base["datadir"], exist_ok=True)
    srv = EngineServer("nearest_neighbor", NN_CONF, ServerArgs(**base),
                       device="cpu", coord=MemoryCoordinator(coord_store))
    srv.start(0)
    if srv.join_thread is not None:
        srv.join_thread.join(30.0)
    return srv


def _nn_datum(i):
    return Datum({"f0": float(i) + 1.0, "f1": float(i % 7) + 1.0})


def _direct_rows(tmp_path):
    """Ground truth: every row from every node's snapshot, loaded straight
    from the store's envelopes (no server)."""
    store = ModelStore(LocalDirBackend(str(tmp_path / "store")),
                       cluster="nn", engine="nearest_neighbor")
    rows = {}
    for _node, (blob, _meta) in store.materialize_all().items():
        system_b, user_b = read_envelope(blob, "direct")
        system = unpack_obj(system_b)
        scratch = create_driver("nearest_neighbor",
                                json.loads(system["config"]), device="cpu")
        _ver, state = unpack_obj(user_b)
        scratch.unpack(state)
        for row in scratch.get_rows():
            rows[row[0]] = pack_obj(row[1:])
    return rows


def _fleet_rows(servers):
    rows = {}
    for s in servers:
        for row in s.driver.get_rows():
            got = pack_obj(row[1:])
            assert rows.get(row[0], got) == got, \
                f"row {row[0]} differs between fleet members"
            rows[row[0]] = got
    return rows


def _reshard_cycle(tmp_path, n_from, n_to, rows=48):
    coord = _Store()
    fleet = [_nn_boot(tmp_path, coord) for _ in range(n_from)]
    try:
        for i in range(rows):
            fleet[i % n_from].driver.set_row(f"row{i:03d}", _nn_datum(i))
        for s in fleet:
            s.store_uploader.tick(s.driver, int(s.driver.update_count))
    finally:
        for s in fleet:
            s.stop()
    direct = _direct_rows(tmp_path)
    assert len(direct) == rows
    coord2 = _Store()
    fleet2 = [_nn_boot(tmp_path, coord2, store_warmboot=False)
              for _ in range(n_to)]
    try:
        # the memory coordinator's watches fire in line: every member
        # already sees the whole ring
        assert all(len(s.cluster_cht().members) == n_to for s in fleet2)
        for s in fleet2:
            with RpcClient("127.0.0.1", s.rpc.port, timeout=60.0) as c:
                doc = c.call("store_restore", "nn", 0)
            assert doc.get("restored"), doc
        restored = _fleet_rows(fleet2)
    finally:
        for s in fleet2:
            s.stop()
    return direct, restored


def test_reshard_restore_1_to_8(tmp_path):
    direct, restored = _reshard_cycle(tmp_path, 1, 8)
    assert restored == direct


def test_reshard_restore_8_to_2(tmp_path):
    direct, restored = _reshard_cycle(tmp_path, 8, 2)
    assert restored == direct


def test_server_args_store_flags():
    args = parse_server_args(
        ["classifier", "-f", "/dev/null", "--store-dir", "/x",
         "--store-interval", "5", "--store-compact-every", "3",
         "--store-compress", "int8", "--no-store-warmboot"])
    assert (args.store_dir, args.store_interval, args.store_compact_every,
            args.store_compress, args.store_warmboot) == \
        ("/x", 5.0, 3, "int8", False)
    args = parse_server_args(["classifier", "-f", "/dev/null"])
    assert (args.store_dir, args.store_interval, args.store_compact_every,
            args.store_compress, args.store_warmboot) == \
        ("", 0.0, 8, "off", True)
    for bad in (["--store-interval", "-1"], ["--store-compact-every", "0"],
                ["--store-interval", "5"]):
        with pytest.raises(SystemExit):
            parse_server_args(["classifier", "-f", "/dev/null"] + bad)


# -- one store, both packages -----------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_records_cross_between_the_packages(writer, tmp_path):
    """A full record and a diff chain uploaded by either package carry the
    other's keys and materialize in the other to the same bytes; int8
    chains stay within one quantization step of the writer's model."""
    from jubatus_tpu.core.datum import Datum as JDatum

    for compress in ("off", "int8"):
        root = str(tmp_path / f"store_{compress}")
        stores = {
            "port": ModelStore(LocalDirBackend(root), cluster="x",
                               engine="classifier"),
            "jax": jax_model_store.ModelStore(
                jax_model_store.LocalDirBackend(root), cluster="x",
                engine="classifier")}
        if writer == "jax":
            d = jax_create_driver("classifier", CLF_CONF)
            up = jax_model_store.StoreUploader(
                stores["jax"], "n1", config=json.dumps(CLF_CONF),
                compress=compress)
            mk = JDatum
        else:
            d = _clf_driver()
            up = StoreUploader(stores["port"], "n1",
                               config=json.dumps(CLF_CONF), compress=compress)
            mk = Datum
        for t in range(3):
            d.train([(lab, mk(x)) for lab, x in _rows(20, 10 + t)])
            up.tick(d, 20 * (t + 1))
        keys = [r.key for r in stores["port"].records()]
        assert keys == [r.key for r in stores["jax"].records()]
        assert len(keys) == 3
        blob, meta = stores["port"].materialize(node="n1")
        jblob, jmeta = stores["jax"].materialize(node="n1")
        assert blob == jblob and meta == jmeta and meta["chain_len"] == 2
        _, user = read_envelope(blob, "x")
        state = unpack_obj(user)[1]
        truth = unpack_obj(pack_obj(d.pack()))
        if compress == "off":
            assert _tree_equal(state, truth)
        else:
            err = max(float(np.abs(np.asarray(a, np.float64)
                                   - np.asarray(b, np.float64)).max())
                      for a, b in zip(tree_leaves(state["w"]),
                                      tree_leaves(truth["w"])))
            assert err < 1e-3


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_warm_boot_and_store_ids_cross_between_the_packages(src, dst,
                                                            tmp_path):
    """A server of one package uploads and is stopped; a server of the
    other boots warm from the same store and answers as the first did;
    it also loads the first server's save by its ``store:`` id."""
    s1 = _clf_server(tmp_path, src)
    try:
        _train_and_tick(s1)
        want = _answers(s1)
        reply = s1.save("", "cross")
        (key,) = [v for k, v in reply.items() if str(k).startswith("store:")]
    finally:
        s1.stop()
    s2 = _clf_server(tmp_path, dst, datadir=str(tmp_path / "data2"))
    try:
        assert s2.warmboot["outcome"] == "warm"
        assert _answers(s2) == want
        s2.driver.clear()
        assert s2.load("", "store:" + key) is True
        assert _answers(s2) == want
    finally:
        s2.stop()


# -- the model guard: breaker, snapshot ring, rollback ------------------------------------

NAMES = ["w"]
GOOD = {"w": np.ones(8, np.float32)}
NAN = {"w": np.array([1.0, np.nan, 2.0], np.float32)}


def test_quarantine_breaker_trip_and_k_clean_release():
    g = MixGuard(mode="quarantine", quarantine_after=2, release_after=3)
    rep = g.screen({"a": GOOD, "b": NAN}, NAMES)
    assert rep.flagged == {"b": "nonfinite"} and not rep.quarantined_now
    assert not g.is_quarantined("b")
    rep = g.screen({"a": GOOD, "b": NAN}, NAMES)
    assert rep.quarantined_now == ["b"] and g.is_quarantined("b")
    for _ in range(2):
        rep = g.screen({"a": GOOD, "b": GOOD}, NAMES)
        assert rep.flagged == {"b": "quarantined"}
        assert set(rep.admitted) == {"a"} and not rep.released
    rep = g.screen({"a": GOOD, "b": GOOD}, NAMES)
    assert rep.released == ["b"] and set(rep.admitted) == {"a", "b"}
    assert not g.is_quarantined("b")
    g2 = MixGuard(mode="quarantine", quarantine_after=2)
    g2.screen({"a": GOOD, "b": NAN}, NAMES)
    g2.screen({"a": GOOD, "b": GOOD}, NAMES)
    rep = g2.screen({"a": GOOD, "b": NAN}, NAMES)
    assert not rep.quarantined_now and not g2.is_quarantined("b")
    assert DEFAULT_QUARANTINE_AFTER >= 2 and DEFAULT_RELEASE_AFTER >= 1


def test_screen_payload_inbox_semantics():
    g = MixGuard(mode="quarantine", quarantine_after=2, release_after=2)
    assert g.screen_payload("m", GOOD, NAMES) is None
    assert g.screen_payload("m", NAN, NAMES) == "nonfinite"
    assert g.screen_payload("m", NAN, NAMES) == "nonfinite"  # trips
    assert g.is_quarantined("m")
    assert g.screen_payload("m", GOOD, NAMES) == "quarantined"
    assert g.screen_payload("m", GOOD, NAMES) is None  # released
    assert not g.is_quarantined("m")
    w = MixGuard(mode="warn", quarantine_after=1)
    assert w.screen_payload("m", NAN, NAMES) == "nonfinite"
    assert not w.is_quarantined("m")
    assert MixGuard().screen_payload("m", NAN, NAMES) is None


def test_snapshot_ring_bounds_and_crc():
    class FakeDriver:
        TYPE = "classifier"
        USER_DATA_VERSION = 1

        def __init__(self):
            self.state = {"w": [1.0, 2.0]}

        def pack(self):
            return dict(self.state)

        def unpack(self, data):
            self.state = dict(data)

    d = FakeDriver()
    ring = ModelSnapshotRing(capacity=3)
    assert ring.latest() is None
    with pytest.raises(RuntimeError):
        ring.restore(d)
    for v in range(5):
        d.state["w"] = [float(v)]
        ring.snapshot(d, model_version=v)
    assert ring.stats()["count"] == 3 and ring.stats()["taken"] == 5
    assert [e["model_version"] for e in ring.list()] == [2, 3, 4]
    d.state["w"] = [999.0]
    assert ring.restore(d) == 4
    assert d.state["w"] == [4.0]
    assert ring.stats()["restored"] == 1
    entry = ring.latest()
    blob = bytearray(entry["blob"])
    blob[60] ^= 0xFF
    entry["blob"] = bytes(blob)
    with pytest.raises(SaveLoadError):
        ring.restore(d, entry)


def test_rollback_classed_effectful():
    from jubatus_tpu_torch.framework.idl import EFFECTFUL_BUILTINS

    assert "rollback" in EFFECTFUL_BUILTINS
    assert "store_restore" in EFFECTFUL_BUILTINS


def test_server_args_guard_flags():
    args = parse_server_args(
        ["classifier", "-f", "/dev/null", "--mix-guard", "quarantine",
         "--mix-norm-bound", "6.5", "--model-snapshot-interval", "30"])
    assert args.mix_guard == "quarantine"
    assert args.mix_norm_bound == 6.5
    assert args.model_snapshot_interval == 30.0
    defaults = parse_server_args(["classifier", "-f", "/dev/null"])
    assert defaults.mix_guard == "warn"
    assert defaults.model_snapshot_interval == 0.0
    for bad in (["--mix-guard", "nonsense"], ["--mix-norm-bound", "0"],
                ["--model-snapshot-interval", "-1"]):
        with pytest.raises(SystemExit):
            parse_server_args(["classifier", "-f", "/dev/null"] + bad)


def _guard_fleet(n=3, **kw):
    store = _Store()
    base = dict(engine="classifier", coordinator="(shared)", name="mg",
                listen_addr="127.0.0.1", interval_sec=1e9,
                interval_count=1 << 30, mix_guard="quarantine",
                mix_norm_bound=8.0, microbatch_max=0)
    base.update(kw)
    servers = []
    for _ in range(n):
        srv = EngineServer("classifier", PA_CONF, ServerArgs(**base),
                           device="cpu", coord=MemoryCoordinator(store))
        srv.start(0)
        servers.append(srv)
    return servers


def _train(srv, rows):
    with ClassifierClient("127.0.0.1", srv.args.rpc_port, "mg") as c:
        c.train([[label, Datum(d)] for label, d in rows])


def _model_finite(srv) -> bool:
    for leaf in tree_leaves(srv.driver.pack()):
        a = np.asarray(leaf)
        if a.dtype != object and np.issubdtype(a.dtype, np.floating) \
                and not np.isfinite(a).all():
            return False
    return True


def test_live_poisoner_quarantined_and_released():
    """One member armed with a NaN poisoner is flagged and dropped from
    every fold, the breaker trips on the repeat offense, models stay
    finite everywhere, and K clean rounds after disarm the member folds
    again."""
    servers = _guard_fleet()
    victim = servers[2]
    vname = victim.self_nodeinfo().name
    try:
        rules = faults.arm(f"mix.diff.poison.{vname}:nan")
        try:
            for rnd in range(3):
                for i, s in enumerate(servers):
                    _train(s, [(f"l{i % 2}", {"x": float(rnd + i + 1)})])
                r = servers[0].mixer.mix_now()
                assert r is not None
                assert r["contributors"] == 2
                assert r["quarantined"] == [vname]
        finally:
            faults.disarm(rules)
        master = servers[0]
        counters = master.trace.counters()
        assert counters["mix.quarantined"] == 3
        assert counters["mix.guard.nonfinite"] == 3
        assert master.mixer.guard.is_quarantined(vname)
        assert len(master.trace.events.snapshot(
            grep="member_quarantined")) == 1
        recs = [rec for rec in master.mixer.flight.snapshot()
                if rec.get("health")]
        assert recs[-1]["health"]["staleness"][vname] >= 2
        assert all(_model_finite(s) for s in servers)
        assert victim.mixer.model_version == master.mixer.model_version
        st = next(iter(master.get_status().values()))
        assert st["mixer.guard_mode"] == "quarantine"
        assert st["mixer.guard_quarantined"] == [vname]
        released_round = None
        for rnd in range(DEFAULT_RELEASE_AFTER + 1):
            for i, s in enumerate(servers):
                _train(s, [(f"l{i % 2}", {"x": 1.0})])
            if servers[0].mixer.mix_now()["contributors"] == 3:
                released_round = rnd
                break
        assert released_round is not None
        assert not master.mixer.guard.is_quarantined(vname)
        assert master.trace.events.snapshot(grep="member_released")
    finally:
        for s in servers:
            s.stop()


def test_live_scale_poisoner_trips_norm_screen():
    servers = _guard_fleet()
    victim = servers[2]
    try:
        rules = faults.arm(
            f"mix.diff.poison.{victim.self_nodeinfo().name}:scale:1e6")
        try:
            for i, s in enumerate(servers):
                _train(s, [(f"l{i % 2}", {"x": float(i + 1)})])
            r = servers[0].mixer.mix_now()
        finally:
            faults.disarm(rules)
        assert r["contributors"] == 2
        assert servers[0].trace.counters()["mix.guard.norm_outlier"] == 1
        assert all(_model_finite(s) for s in servers)
    finally:
        for s in servers:
            s.stop()


def test_async_inbox_admission():
    """A poisoned async submission is refused at the inbox in quarantine
    mode (counted + evented), and the sender is told."""
    from jubatus_tpu_torch.framework.linear_mixer import pack_mix

    servers = _guard_fleet(mix_async=True)
    try:
        master = servers[0]
        m = master.mixer
        good = {"protocol": 2, "schema": [], "version": 0,
                "diffs": {"weights": np.ones(4, np.float32)}}
        assert m.local_submit_diff("peer_1", pack_mix(good))["accepted"]
        assert m.inbox.depth() == 1
        names = list(master.driver.get_mixables())
        bad = {"protocol": 2, "schema": [], "version": 0,
               "diffs": {names[0]: np.array([np.nan], np.float32)}}
        ack = m.local_submit_diff("peer_2", pack_mix(bad))
        assert ack["accepted"] is False and ack.get("quarantined")
        assert m.inbox.depth() == 1
        counters = master.trace.counters()
        assert counters["mix.quarantined"] == 1
        assert counters["mix.guard.nonfinite"] == 1
        assert master.trace.events.snapshot(grep="inbox_rejected")
    finally:
        for s in servers:
            s.stop()


def test_rollback_ring_and_auto_rollback():
    """Snapshot → poison the apply path → put_diff refuses the non-finite
    total, rolls back to last-good, and the weights come back
    bit-identical."""
    (srv,) = _guard_fleet(n=1, model_snapshot_interval=3600.0)
    try:
        _train(srv, [("l0", {"x": 1.0}), ("l1", {"x": -2.0})])
        snap = srv.take_snapshot()
        assert snap["model_version"] == srv.mixer.model_version
        assert snap["lock_ms"] >= 0
        want = srv.driver.pack()
        _train(srv, [("l0", {"x": 5.0})])  # post-snapshot training

        def _nanify(x):
            a = np.asarray(x)
            if a.dtype != object and np.issubdtype(a.dtype, np.floating):
                return np.full_like(a, np.nan)
            return a

        with srv.driver.lock:
            diffs = {n: mx.get_diff()
                     for n, mx in srv.driver.get_mixables().items()}
        poisoned = {"protocol": PROTOCOL_VERSION,
                    "schema": srv.mixer.local_get_schema(),
                    "base_version": srv.mixer.model_version,
                    "diffs": tree_map(_nanify, diffs)}
        assert srv.mixer.local_put_obj(poisoned) is False
        assert srv.rollbacks == 1
        assert srv.trace.counters()["mix.rollbacks"] == 1
        assert srv.trace.counters()["mix.guard.nonfinite_total"] == 1
        assert srv.trace.events.snapshot(grep="rollback")
        assert srv.mixer._obsolete is False
        got = srv.driver.pack()
        for a, b in zip(tree_leaves(want), tree_leaves(got)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        st = next(iter(srv.get_status().values()))
        assert st["snapshot.count"] == 1
        assert st["rollback.count"] == 1
    finally:
        srv.stop()


def test_rollback_without_snapshot_refuses():
    (srv,) = _guard_fleet(n=1)
    try:
        with RpcClient("127.0.0.1", srv.args.rpc_port) as c:
            out = c.call("rollback", "mg", "operator")
        assert out["rolled_back"] is False
        assert "no model snapshot" in out["error"]
    finally:
        srv.stop()


def test_snapshot_tick_thread_fills_the_ring():
    """With --model-snapshot-interval the tick thread takes snapshots on
    its own; the test waits for the first one on an event."""
    taken = threading.Event()
    (srv,) = _guard_fleet(n=1, model_snapshot_interval=0.01)
    try:
        real = srv.snapshots.snapshot

        def noted(*a, **k):
            out = real(*a, **k)
            taken.set()
            return out

        srv.snapshots.snapshot = noted
        assert taken.wait(30.0)
        assert srv.snapshots.stats()["taken"] >= 1
    finally:
        srv.stop()


@pytest.mark.parametrize("poisoner", ["jax", "port"])
def test_quarantined_push_round_rolls_the_receivers_back(poisoner,
                                                         tmp_path):
    """A two-member push fleet under --mix-guard quarantine, one JAX and
    one port server: the poisoned member's own diff makes the exchange's
    folded total non-finite; both members refuse it and roll back to
    their snapshots, answering as before the round."""
    from jubatus_tpu.client import ClassifierClient as JClassifierClient
    from jubatus_tpu.client import Datum as JDatum
    from jubatus_tpu.coord.file import FileCoordinator as JFileCoordinator
    from jubatus_tpu_torch.coord.file import FileCoordinator

    coord_dir = str(tmp_path / "coord")
    kw = dict(engine="classifier", coordinator="(shared)", name="q",
              listen_addr="127.0.0.1", interval_sec=1e9,
              interval_count=1 << 30, mixer="broadcast_mixer",
              mix_guard="quarantine", model_snapshot_interval=3600.0,
              microbatch_max=0)
    jsrv = JEngineServer("classifier", PA_CONF,
                         JServerArgs(telemetry_interval=0, **kw),
                         coord=JFileCoordinator(coord_dir))
    psrv = EngineServer("classifier", PA_CONF, ServerArgs(**kw),
                        device="cpu", coord=FileCoordinator(coord_dir))
    servers = [jsrv, psrv]
    for s in servers:
        s.start(0)
    mod = jax_faults if poisoner == "jax" else faults
    victim = jsrv if poisoner == "jax" else psrv
    try:
        for i, s in enumerate(servers):
            with JClassifierClient("127.0.0.1", s.args.rpc_port, "q") as c:
                c.train([[f"l{j % 2}", JDatum({"x": float(i + j + 1)})]
                         for j in range(4)])
        for s in servers:
            s.take_snapshot()
        before = [_answers_q(s) for s in servers]
        rules = mod.arm(
            f"mix.diff.poison.{victim.self_nodeinfo().name}:nan")
        try:
            victim.mixer.mix_now()
        finally:
            mod.disarm(rules)
        assert [s.rollbacks for s in servers] == [1, 1]
        assert all(_model_finite(s) for s in servers)
        assert [_answers_q(s) for s in servers] == before
    finally:
        for s in servers:
            s.stop()


def test_a_snapshot_tick_waits_out_the_round():
    """A snapshot tick that falls inside a push round, after the round
    aligned the initiator's label slots and before its poisoned total is
    refused, takes no snapshot: the rollback restores the model served
    before the round, its labels in their old order, scores bit-equal."""
    servers = _guard_fleet(n=2, mixer="broadcast_mixer",
                           model_snapshot_interval=3600.0)
    a, b = servers
    try:
        _train(a, [("l1", {"x": 1.0}), ("l0", {"x": -2.0})])
        _train(b, [("l0", {"x": -1.0}), ("l1", {"x": 3.0})])
        for s in servers:
            s.take_snapshot()
        probes = [Datum({"x": v}) for v in (-2.0, 0.5, 3.0)]

        def answers(srv):
            with ClassifierClient("127.0.0.1", srv.args.rpc_port,
                                  "mg") as c:
                return [[(_text(lab), sc) for lab, sc in r]
                        for r in c.classify(probes)]

        before = [answers(s) for s in servers]
        assert [lab for lab, _ in before[0][0]] == ["l1", "l0"]
        taken = a.snapshots.stats()["taken"]
        real = a.mixer.local_diff_obj

        def tick_inside_the_round(*args, **kw):
            a._last_snapshot = 0.0  # due
            t = threading.Thread(target=a._model_snapshot_tick)
            t.start()
            t.join(30.0)
            return real(*args, **kw)

        a.mixer.local_diff_obj = tick_inside_the_round
        rules = faults.arm(f"mix.diff.poison.{a.self_nodeinfo().name}:nan")
        try:
            a.mixer.mix_now()
        finally:
            faults.disarm(rules)
            a.mixer.local_diff_obj = real
        assert a.snapshots.stats()["taken"] == taken
        assert [s.rollbacks for s in servers] == [1, 1]
        assert [answers(s) for s in servers] == before
        a._last_snapshot = 0.0
        a._model_snapshot_tick()  # between rounds: taken at once
        assert a.snapshots.stats()["taken"] == taken + 1
    finally:
        for s in servers:
            s.stop()


def _answers_q(srv):
    with ClassifierClient("127.0.0.1", srv.args.rpc_port, "q") as c:
        return [sorted((_text(lab), s) for lab, s in r)
                for r in c.classify([Datum({"x": v}) for v in
                                     (-2.0, 0.5, 3.0)])]


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
def test_a_card_server_boots_warm_from_the_store(cuda, tmp_path):
    """A regression server on the card uploads to the store and stops; a
    new one on the card boots warm from it, estimates as the first did,
    and its next train flush launches the scan kernel."""
    from jubatus_tpu_torch.ops import online_scan
    from jubatus_tpu_torch.rpc.client import RegressionClient

    conf = {"method": "PA1",
            "parameter": {"sensitivity": 0.1, "regularization_weight": 3.0},
            "converter": {"num_rules": [{"key": "*", "type": "num"}]}}
    rows = [[float(i % 5) - 2.0, Datum({"a": float(i % 7), "b": i * 0.1})]
            for i in range(300)]
    probes = [Datum({"a": 1.0, "b": 2.5}), Datum({"a": -3.0, "b": 0.5})]

    def server():
        srv = EngineServer("regression", conf, ServerArgs(
            engine="regression", listen_addr="127.0.0.1",
            datadir=str(tmp_path), store_dir=str(tmp_path / "store"),
            store_interval=30.0), device=cuda)
        srv.start(0)
        return srv

    s1 = server()
    try:
        with RegressionClient("127.0.0.1", s1.args.rpc_port, "") as c:
            c.train(rows)
            want = c.estimate(probes)
        s1.store_uploader.tick(s1.driver, int(s1.driver.update_count))
    finally:
        s1.stop()
    s2 = server()
    try:
        assert s2.warmboot["outcome"] == "warm"
        before = online_scan.pa_scan.launches
        with RegressionClient("127.0.0.1", s2.args.rpc_port, "") as c:
            assert c.estimate(probes) == want
            c.train(rows[:64])
        assert online_scan.pa_scan.launches > before
    finally:
        s2.stop()
