"""The port's push (gossip) mixers and its asynchronous staleness-bounded
mix plane, on the CPU.

Mirrors ``tests/test_push_mixer.py`` (the candidate strategies, the
factory, propagation, the three-node broadcast, the late joiner, the
anomaly ids) and ``tests/test_async_mix.py`` (fold weights, scale_tree's
dtypes, the inbox, the staleness ledger, the wiring and flags, rounds and
gauges, decay then drop, straggler chaos, drift parity against sync,
concurrent train and classify, submit faults, schema churn, the
non-contributor capture, ``_merge_delta_tree``) against the port. Where
the reference sleeps, these tests wait on events. Then the two packages
in one fleet: a JAX and a port server on one FileCoordinator mix PA with
``broadcast_mixer`` and with ``--mix-async``, and the weights equal a
two-JAX fleet's bit for bit, with either package as master.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

from jubatus_tpu.client import ClassifierClient as JClassifierClient
from jubatus_tpu.coord.file import FileCoordinator as JFileCoordinator
from jubatus_tpu.framework import async_mixer as jax_async_mixer
from jubatus_tpu.parallel.mix import tree_sum as jax_tree_sum
from jubatus_tpu.server import EngineServer as JEngineServer
from jubatus_tpu.server.args import ServerArgs as JServerArgs
from jubatus_tpu_torch.coord.base import NodeInfo
from jubatus_tpu_torch.coord.file import FileCoordinator
from jubatus_tpu_torch.coord.memory import MemoryCoordinator, _Store
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.framework.async_mixer import (AsyncLinearMixer,
                                                     DiffInbox,
                                                     _merge_delta_tree,
                                                     fold_weight, scale_tree)
from jubatus_tpu_torch.framework.linear_mixer import (RpcLinearMixer,
                                                      pack_mix)
from jubatus_tpu_torch.framework.push_mixer import (DummyMixer, RpcPushMixer,
                                                    broadcast_candidates,
                                                    create_mixer,
                                                    random_candidates,
                                                    skip_candidates)
from jubatus_tpu_torch.parallel.mix import tree_sum
from jubatus_tpu_torch.rpc.client import (AnomalyClient, ClassifierClient,
                                          RpcClient)
from jubatus_tpu_torch.server import EngineServer
from jubatus_tpu_torch.server.args import ServerArgs, parse_server_args
from jubatus_tpu_torch.utils import faults

WAIT_S = 30.0
NAME = "pm"

CONF = {
    "method": "PA",
    "parameter": {"regularization_weight": 1.0},
    "converter": {"num_rules": [{"key": "*", "type": "num"}]},
}


def _cluster(engine, conf, n, store, mixer="linear_mixer", device="cpu",
             **kw):
    servers = []
    for _ in range(n):
        args = ServerArgs(
            engine=engine, coordinator="(shared)", name=NAME, mixer=mixer,
            listen_addr="127.0.0.1", interval_sec=1e9,
            interval_count=1 << 30, **kw)
        srv = EngineServer(engine, conf, args, device=device,
                           coord=MemoryCoordinator(store))
        srv.start(0)
        servers.append(srv)
    return servers


def _label(x):
    return x.decode() if isinstance(x, bytes) else x


# -- candidate strategies --------------------------------------------------------

def _members(n):
    return [NodeInfo("10.0.0.1", 9000 + i) for i in range(n)]


def test_broadcast_candidates_excludes_self():
    ms = _members(4)
    assert broadcast_candidates(ms, ms[1]) == [ms[0], ms[2], ms[3]]


def test_random_candidates_one_other():
    ms = _members(5)
    for _ in range(20):
        (pick,) = random_candidates(ms, ms[0])
        assert pick.name != ms[0].name
    assert random_candidates([ms[0]], ms[0]) == []


def test_skip_candidates_fingers():
    """8 members sorted by name; node 0's fingers are offsets +1 +2 +4
    (skip_mixer.hpp stride pattern), the JAX package's picks."""
    from jubatus_tpu.coord.base import NodeInfo as JNodeInfo
    from jubatus_tpu.framework.push_mixer import \
        skip_candidates as jax_skip

    ms = _members(8)  # names sort by port
    picks = skip_candidates(ms, ms[0])
    assert [p.port for p in picks] == [9001, 9002, 9004]
    picks = skip_candidates(ms, ms[7])
    assert [p.port for p in picks] == [9000, 9001, 9003]
    jms = [JNodeInfo(m.host, m.port) for m in ms]
    for i in range(8):
        assert [p.name for p in skip_candidates(ms, ms[i])] == \
            [p.name for p in jax_skip(jms, jms[i])]


def test_skip_candidates_unknown_self_falls_back():
    ms = _members(3)
    stranger = NodeInfo("9.9.9.9", 1)
    assert skip_candidates(ms, stranger) == broadcast_candidates(ms, stranger)


def test_factory_selects():
    class _C:  # minimal comm stand-in
        pass

    class _D:
        def get_mixables(self):
            return {}

    assert isinstance(create_mixer("linear_mixer", _D(), _C()),
                      RpcLinearMixer)
    m = create_mixer("skip_mixer", _D(), _C())
    assert isinstance(m, RpcPushMixer) and m.strategy == "skip_mixer"
    assert isinstance(create_mixer("dummy_mixer", _D(), _C()), DummyMixer)
    with pytest.raises(ValueError, match="unknown mixer"):
        create_mixer("nope", _D(), _C())
    from jubatus_tpu_torch.framework.collective_mixer import \
        CollectiveMixer

    cm = create_mixer("collective_mixer", _D(), _C(), mix_bf16=True,
                      mix_topology="2x2")
    assert isinstance(cm, CollectiveMixer)
    assert cm.compress == "bf16" and cm.topology == "2x2"
    assert create_mixer("collective_mixer", _D(), _C(),
                        mix_compress="int8").compress == "int8"


# -- gossip rounds over real servers ---------------------------------------------

@pytest.mark.parametrize("strategy", ["broadcast_mixer", "random_mixer",
                                      "skip_mixer"])
def test_push_mix_propagates(strategy):
    store = _Store()
    servers = _cluster("classifier", CONF, 2, store, strategy)
    try:
        c0 = ClassifierClient("127.0.0.1", servers[0].args.rpc_port, NAME)
        c1 = ClassifierClient("127.0.0.1", servers[1].args.rpc_port, NAME)
        for _ in range(10):
            c0.train([["pos", Datum({"x": 1.0, "y": 0.2})]])
            c1.train([["neg", Datum({"x": -1.0, "y": -0.2})]])
        assert c0.do_mix() is True  # node 0 gossips with node 1
        for c in (c0, c1):
            assert set(c.get_labels()) == {"pos", "neg"}
            (res,) = c.classify([Datum({"x": 1.0, "y": 0.2})])
            assert max(res, key=lambda ls: ls[1])[0] == "pos"
        c0.close(), c1.close()
    finally:
        for s in servers:
            s.stop()


def test_push_mix_three_nodes_broadcast_converges():
    store = _Store()
    servers = _cluster("classifier", CONF, 3, store, "broadcast_mixer")
    try:
        clients = [ClassifierClient("127.0.0.1", s.args.rpc_port, NAME)
                   for s in servers]
        labels = ["a", "b", "c"]
        for c, lab, x in zip(clients, labels, (1.0, -1.0, 0.0)):
            for _ in range(5):
                c.train([[lab, Datum({"x": x, "y": x * 0.5 + 1.0})]])
        # one broadcast round per node guarantees full propagation
        for c in clients:
            c.do_mix()
        for c in clients:
            assert set(c.get_labels()) == set(labels)
        for c in clients:
            c.close()
    finally:
        for s in servers:
            s.stop()


def test_push_late_joiner_adopts_full_model():
    """A node joining after gossip rounds ran is version-behind: when ITS
    round initiates, it adopts the peer's full model before folding."""
    store = _Store()
    servers = _cluster("classifier", CONF, 2, store, "broadcast_mixer")
    try:
        c0 = ClassifierClient("127.0.0.1", servers[0].args.rpc_port, NAME)
        for _ in range(10):
            c0.train([["pos", Datum({"x": 1.0, "y": 0.2})]])
            c0.train([["neg", Datum({"x": -1.0, "y": -0.2})]])
        assert c0.do_mix() is True  # pair now at model version 1
        late = _cluster("classifier", CONF, 1, store, "broadcast_mixer")[0]
        servers.append(late)
        cl = ClassifierClient("127.0.0.1", late.args.rpc_port, NAME)
        assert cl.do_mix() is True  # late node initiates → adopts
        (res,) = cl.classify([Datum({"x": 1.0, "y": 0.2})])
        assert max(res, key=lambda s: s[1])[0] == "pos"
        (st,) = cl.get_status().values()
        assert st["mixer.model_version"] >= 1
        assert st["mixer.obsolete"] is False
        c0.close(), cl.close()
    finally:
        for s in servers:
            s.stop()


def test_anomaly_ids_unique_across_nodes():
    conf = {"method": "lof",
            "parameter": {"nearest_neighbor_num": 3, "method": "euclid_lsh",
                          "parameter": {"hash_num": 64}},
            "converter": {"num_rules": [{"key": "*", "type": "num"}]}}
    store = _Store()
    servers = _cluster("anomaly", conf, 2, store)
    try:
        a0 = AnomalyClient("127.0.0.1", servers[0].args.rpc_port, NAME)
        a1 = AnomalyClient("127.0.0.1", servers[1].args.rpc_port, NAME)
        ids = set()
        for a in (a0, a1):
            for i in range(5):
                rid, _score = a.add(Datum({"x": float(i)}))
                ids.add(rid)
        assert len(ids) == 10, "id collision across cluster nodes"
        a0.close(), a1.close()
    finally:
        for s in servers:
            s.stop()


def test_standalone_keeps_local_ids():
    from jubatus_tpu_torch.server.factory import create_driver

    conf = {"method": "lof",
            "parameter": {"nearest_neighbor_num": 3, "method": "euclid_lsh",
                          "parameter": {"hash_num": 64}},
            "converter": {"num_rules": [{"key": "*", "type": "num"}]}}
    d = create_driver("anomaly", conf, device="cpu")
    rid, _ = d.add(Datum({"x": 1.0}))
    assert rid == "0"  # local counter, standalone semantics unchanged


# -- async: pure units -----------------------------------------------------------

def test_fold_weight_decay_and_drop():
    assert fold_weight(0, 4) == 1.0
    assert fold_weight(1, 4) == 0.5
    assert fold_weight(3, 4) == 0.125
    assert fold_weight(4, 4) == 2.0 ** -4  # at the bound: decayed, kept
    assert fold_weight(5, 4) == 0.0        # past the bound: dropped
    assert fold_weight(-2, 4) == 1.0       # future-stamped clamps fresh
    assert fold_weight(1, 0) == 0.0        # bound 0: only fresh folds


def test_scale_tree_preserves_dtypes():
    diff = {"w": np.ones((4,), np.float32) * 8.0,
            "counts": np.array([4, 8], np.int64),
            "s": 2.0}
    out = scale_tree(diff, 0.5)
    assert out["w"].dtype == np.float32
    np.testing.assert_allclose(out["w"], 4.0)
    # integer leaves stay integral (truncation IS the down-weighting)
    assert out["counts"].dtype == np.int64
    np.testing.assert_array_equal(out["counts"], [2, 4])
    assert out["s"] == 1.0
    # identity weight returns the tree untouched (no copy)
    assert scale_tree(diff, 1.0) is diff


@pytest.mark.parametrize("staleness", [0, 1, 3, 8])
def test_weighted_fold_is_the_jax_packages_to_the_bit(staleness):
    """The async fold's arithmetic — scale each diff by 2**-s, then the
    host tree_sum with its trailing-row pad — gives the JAX package's
    bits for the same inbox, leaf by leaf and dtype by dtype."""
    rng = np.random.default_rng(staleness)
    inbox = [{"w": rng.standard_normal((3 + i, 5)).astype(np.float32),
              "n": rng.integers(0, 50, (3 + i,)).astype(np.int32),
              "c": np.float32(1.0),
              "rows": [rng.standard_normal(4).astype(np.float64), 3.5]}
             for i in range(3)]
    weights = [fold_weight(staleness + i, 8) for i in range(3)]
    pairs = [(w, d) for w, d in zip(weights, inbox) if w]
    got = tree_sum([scale_tree(d, w) for w, d in pairs])
    want = jax_tree_sum([jax_async_mixer.scale_tree(d, w)
                         for w, d in pairs])
    for key in ("w", "n", "c"):
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype and np.array_equal(a, b), key
    assert np.array_equal(got["rows"][0], np.asarray(want["rows"][0]))
    assert float(got["rows"][1]) == float(want["rows"][1])


def test_inbox_latest_wins_and_drain():
    inbox = DiffInbox()
    inbox.submit("a", {"version": 1, "diffs": {"x": 1}})
    inbox.submit("b", {"version": 2, "diffs": {"x": 2}})
    inbox.submit("a", {"version": 3, "diffs": {"x": 30}})  # supersedes
    assert inbox.depth() == 2
    assert inbox.submits == 3
    entries = inbox.drain()
    assert set(entries) == {"a", "b"}
    assert entries["a"]["version"] == 3
    assert entries["a"]["payload"]["diffs"]["x"] == 30
    # drain consumes: a silent member does not replay its last delta
    assert inbox.depth() == 0
    assert inbox.drain() == {}


def test_staleness_ledger_rebases_on_epoch_bump():
    """A drained-and-rejoined node must not inherit the staleness its
    past incarnation accrued while gone."""
    class FakeComm:
        epoch = 1

        def membership_epoch(self):
            return self.epoch

    class FakeDriver:
        lock = threading.Lock()

    comm = FakeComm()
    mixer = RpcLinearMixer(FakeDriver(), comm)
    a, b = NodeInfo("h", 1), NodeInfo("h", 2)
    assert mixer._staleness_update([a, b], {a.name, b.name})[
        "staleness_max"] == 0
    for _ in range(2):
        health = mixer._staleness_update([a, b], {a.name})
    assert health["staleness"][b.name] == 2
    comm.epoch = 2
    for _ in range(3):
        health = mixer._staleness_update([a], {a.name})
    assert b.name not in health["staleness"]
    assert b.name not in mixer._member_last_contrib
    comm.epoch = 3
    health = mixer._staleness_update([a, b], {a.name})
    assert health["staleness"][b.name] == 1
    health = mixer._staleness_update([a, b], {a.name})
    assert health["staleness"][b.name] == 2


def test_create_mixer_async_wiring():
    class FakeDriver:
        lock = threading.Lock()

    m = create_mixer("linear_mixer", FakeDriver(), None, mix_async=True,
                     mix_staleness_bound=3)
    assert isinstance(m, AsyncLinearMixer)
    assert m.staleness_bound == 3
    assert m._scheduler.fire_idle is True
    with pytest.raises(ValueError):
        create_mixer("random_mixer", FakeDriver(), None, mix_async=True)
    with pytest.raises(ValueError):
        create_mixer("collective_mixer", FakeDriver(), None,
                     mix_async=True)


def test_server_args_flags():
    args = parse_server_args(
        ["classifier", "-f", "/dev/null", "--mix-async",
         "--mix-staleness-bound", "6",
         "--fault", "mix.put_diff:error@1",
         "--fault", "migration.pull:delay:0.1"])
    assert args.mix_async is True
    assert args.mix_staleness_bound == 6
    assert args.fault == ["mix.put_diff:error@1",
                          "migration.pull:delay:0.1"]
    with pytest.raises(SystemExit):
        parse_server_args(["classifier", "-f", "/dev/null",
                           "--fault", "nonsense-rule"])
    defaults = parse_server_args(["classifier", "-f", "/dev/null"])
    assert defaults.mix_async is False and defaults.mix_staleness_bound == 8
    for mixer in ("random_mixer", "broadcast_mixer", "skip_mixer",
                  "dummy_mixer"):
        assert parse_server_args(["classifier", "-f", "/dev/null",
                                  "-x", mixer]).mixer == mixer
    with pytest.raises(SystemExit):
        parse_server_args(["classifier", "-f", "/dev/null",
                           "--mix-async", "-x", "random_mixer"])
    with pytest.raises(SystemExit):
        parse_server_args(["classifier", "-f", "/dev/null",
                           "--mix-staleness-bound", "-1"])
    # the collective mixer is ported: a standalone server with it builds
    # (standalone mixes with nobody, so it holds no mixer)
    args = parse_server_args(["classifier", "-f", "/dev/null", "-x",
                              "collective_mixer", "--device", "cpu",
                              "--mix-compress", "int8"])
    assert args.mixer == "collective_mixer" and args.mix_compress == "int8"
    srv = EngineServer("classifier", CONF, args)
    assert srv.mixer is None


def test_async_status_rpc_and_idempotency():
    from jubatus_tpu_torch.framework.idl import (EFFECTFUL_BUILTINS,
                                                 IDEMPOTENT_BUILTINS)

    assert "mix_async_status" in IDEMPOTENT_BUILTINS
    assert "mix_submit_diff" in EFFECTFUL_BUILTINS


def test_merge_delta_tree_keeps_normalization_scalars():
    a = {"dw": np.ones((2, 4), np.float32), "count": np.float32(1.0)}
    b = {"dw": np.full((3, 4), 2.0, np.float32), "count": np.float32(1.0)}
    out = _merge_delta_tree(a, b)
    # arrays add with the trailing-row pad; the equal replica-count
    # scalar stays 1 (one member's two deltas = ONE replica)
    assert out["dw"].shape == (3, 4)
    np.testing.assert_allclose(out["dw"][:2], 3.0)
    np.testing.assert_allclose(out["dw"][2], 2.0)
    assert float(out["count"]) == 1.0
    # genuinely different scalars still add
    out = _merge_delta_tree({"n": 2.0}, {"n": 3.0})
    assert float(out["n"]) == 5.0


# -- async: live cluster ---------------------------------------------------------

def _async_cluster(n=3, bound=3, mix_async=True):
    return _cluster("classifier", CONF, n, _Store(), mix_async=mix_async,
                    mix_staleness_bound=bound, microbatch_max=0)


def _train(srv, rows):
    c = ClassifierClient("127.0.0.1", srv.args.rpc_port, NAME)
    c.train([[label, Datum(d)] for label, d in rows])
    c.close()


def _classify(srv, d):
    c = ClassifierClient("127.0.0.1", srv.args.rpc_port, NAME)
    out = c.classify([Datum(d)])
    c.close()
    return out


@pytest.fixture()
def async_cluster():
    servers = _async_cluster()
    yield servers
    faults.disarm_all()
    for s in servers:
        s.stop()


def test_async_round_streams_and_gauges(async_cluster):
    """One fold tick consumes whatever arrived — no gather barrier, no
    quorum abort — and the async gauges land on every member."""
    servers = async_cluster
    for i, s in enumerate(servers):
        _train(s, [(f"l{i % 2}", {"x": float(i + 1)})])
    r1 = servers[0].mixer.mix_now()
    assert r1 is not None and r1["mode"] == "async"
    assert r1["contributors"] == 1
    assert "quorum" not in str(r1)
    assert servers[1].mixer.submit_now() is True
    assert servers[2].mixer.submit_now() is True
    assert servers[0].mixer.inbox.depth() == 2
    r2 = servers[0].mixer.mix_now()
    assert r2["contributors"] == 2
    assert all(w == 1.0 for w in r2["weights"].values())  # all fresh
    assert r2["base_version"] == 1
    assert r2["acked"] == 3
    for s in servers:
        g = s.trace.gauges()
        assert g["mix.model_version"] == 2.0
        assert g["mix.apply_stall_ms"] >= 0
        assert s.mixer.model_version == 2
    g0 = servers[0].trace.gauges()
    assert g0["mix.async_fold_weight_min"] == 1.0
    assert g0["mix.async_inbox_depth"] == 0.0
    assert servers[0].trace.counters()["mix.async_rounds"] == 2
    recs = [r for r in servers[0].mixer.flight.snapshot()
            if r["mode"] == "async"]
    assert len(recs) == 2 and recs[-1]["contributors"] == 2
    st = next(iter(servers[1].get_status().values()))
    assert st["mixer.async_mode"] is True
    assert st["mixer.async_lag_rounds"] == 0
    assert st["mixer.staleness_bound"] == 3


def test_async_status_over_the_wire(async_cluster):
    servers = async_cluster
    _train(servers[0], [("l0", {"x": 1.0})])
    servers[0].mixer.mix_now()
    with RpcClient("127.0.0.1", servers[0].args.rpc_port, 5.0) as c:
        doc = c.call("mix_async_status", NAME)
    assert doc["rounds"] == 1
    assert doc["staleness_bound"] == 3
    assert doc["model_version"] == 1


def test_stale_submission_decays_then_drops(async_cluster):
    """A payload snapshot k folds ago folds at weight 2**-k and is dropped
    past the bound."""
    servers = async_cluster
    straggler = servers[2]
    _train(straggler, [("l1", {"x": -3.0}), ("l0", {"x": 0.25})])
    _train(servers[0], [("l0", {"x": 0.5}), ("l1", {"x": -0.5})])
    held = straggler.mixer.local_diff_obj()
    for k in range(2):
        _train(servers[0], [("l0", {"x": float(k + 1)})])
        assert servers[0].mixer.mix_now() is not None
    assert servers[0].mixer.model_version == 2
    name = straggler.self_nodeinfo().name
    with RpcClient("127.0.0.1", servers[0].args.rpc_port, 5.0) as c:
        c.call("mix_submit_diff", NAME, name, pack_mix(held))
        _train(servers[0], [("l0", {"x": 9.0})])
        r = servers[0].mixer.mix_now()
        assert r["weights"][name] == 0.25
        assert not r["dropped_stale"]
        _train(servers[0], [("l0", {"x": 4.0})])
        assert servers[0].mixer.mix_now() is not None
        c.call("mix_submit_diff", NAME, name, pack_mix(held))
        _train(servers[0], [("l0", {"x": 2.0})])
        r = servers[0].mixer.mix_now()
    assert r is not None
    assert r["dropped_stale"] == 1
    assert name not in r["weights"]
    assert servers[0].trace.counters()["mix.async_dropped_stale"] == 1


def test_straggler_chaos_decays_not_stalls():
    """One member's submission held back while six rounds stream: every
    round completes without it, serving answers between folds, and the
    payload that finally lands is decayed or dropped — never a stall.
    The hold is an event the test releases, not a sleep."""
    servers = _async_cluster(bound=2)
    try:
        straggler = servers[2]
        name = straggler.self_nodeinfo().name
        for s in servers:
            _train(s, [("l0", {"x": 1.0}), ("l1", {"x": -1.0})])
        assert servers[0].mixer.mix_now() is not None
        release, entered = threading.Event(), threading.Event()
        real = straggler.mixer._submit_client

        def held_client(master):
            entered.set()
            release.wait(WAIT_S)
            return real(master)

        straggler.mixer._submit_client = held_client
        _train(straggler, [("l1", {"x": -5.0})])
        sub = threading.Thread(target=straggler.mixer.submit_now,
                               daemon=True)
        sub.start()
        assert entered.wait(WAIT_S)  # its snapshot is taken and held
        rounds = serving_ok = 0
        for k in range(6):
            _train(servers[0], [("l0", {"x": float(k)})])
            _train(servers[1], [("l0", {"x": float(k) + 0.5})])
            servers[1].mixer.submit_now()
            if servers[0].mixer.mix_now() is not None:
                rounds += 1
            serving_ok += bool(_classify(servers[0], {"x": 1.0}))
        release.set()
        sub.join(WAIT_S)
        assert not sub.is_alive()
        assert rounds == 6  # the fleet never waited for the straggler
        assert serving_ok == 6
        reasons = [r.get("reason", "") for r in
                   servers[0].mixer.flight.snapshot()]
        assert not any("quorum" in r for r in reasons)
        assert servers[0].trace.counters().get("mix.quorum_aborted", 0) == 0
        _train(servers[0], [("l0", {"x": 7.0})])
        r = servers[0].mixer.mix_now()
        assert r is not None
        w = r["weights"].get(name)
        dropped_total = servers[0].trace.counters().get(
            "mix.async_dropped_stale", 0)
        assert (w is not None and w < 1.0) or dropped_total >= 1
    finally:
        for s in servers:
            s.stop()


def test_drift_parity_async_vs_sync():
    """N rounds of async mix with fresh contributors give the same folded
    model and the same convergence telemetry as the sync plane on the
    same traffic."""
    sync = _async_cluster(mix_async=False)
    async_ = _async_cluster(mix_async=True)
    try:
        rows = [
            [("l0", {"x": 1.0, "y": -0.5}), ("l1", {"x": -1.0, "y": 2.0})],
            [("l0", {"x": 0.5, "y": -2.0}), ("l1", {"x": -0.25, "y": 1.0})],
            [("l1", {"x": -2.0, "y": 0.75}), ("l0", {"x": 2.0, "y": -1.0})],
        ]
        assert async_[0].mixer.mix_now() is not None  # elect + publish
        div_sync, div_async = [], []
        for _ in range(3):
            for i in range(3):
                _train(sync[i], rows[i])
                _train(async_[i], rows[i])
            rs = sync[0].mixer.mix_now()
            assert rs is not None
            div_sync.append(rs["health"]["premix_divergence_mean"])
            for s in async_[1:]:
                assert s.mixer.submit_now() is True
            ra = async_[0].mixer.mix_now()
            assert ra is not None and ra["contributors"] == 3
            div_async.append(ra["health"]["premix_divergence_mean"])
            rows = rows[1:] + rows[:1]
        np.testing.assert_allclose(div_async, div_sync, rtol=1e-5)
        probe = {"x": 0.8, "y": -0.3}
        ss = {_label(e[0]): e[1] for e in _classify(sync[0], probe)[0]}
        sa = {_label(e[0]): e[1] for e in _classify(async_[0], probe)[0]}
        assert set(ss) == set(sa)
        for label in ss:
            assert sa[label] == pytest.approx(ss[label], rel=1e-5)
        for s in async_:
            assert s.trace.gauges()["mix.apply_stall_ms"] < 500
    finally:
        for s in sync + async_:
            s.stop()


def test_double_buffer_concurrent_train_classify(async_cluster):
    """Concurrent train/classify during background rounds see a
    consistent (model, version) pair: the version a reader sees is
    monotone and no reader errors on a torn model. Each round waits for
    the hammers to make progress (an event), not for a clock."""
    servers = async_cluster
    stop = threading.Event()
    progressed = threading.Event()
    errors: list = []
    versions: list = []

    def hammer_train(idx):
        k = 0
        while not stop.is_set():
            try:
                _train(servers[idx], [(f"l{k % 2}", {"x": float(k % 7)})])
            except Exception as e:  # noqa: BLE001 — the assertion
                errors.append(e)
                return
            progressed.set()
            k += 1

    def hammer_read(idx):
        while not stop.is_set():
            try:
                out = _classify(servers[idx], {"x": 1.0})
                with servers[idx].driver.lock:
                    versions.append(servers[idx].mixer.model_version)
                assert out is not None
            except Exception as e:  # noqa: BLE001
                errors.append(e)
                return

    threads = [threading.Thread(target=hammer_train, args=(i,))
               for i in range(3)]
    threads += [threading.Thread(target=hammer_read, args=(0,))]
    for t in threads:
        t.start()
    rounds = 0
    try:
        for _ in range(8):
            assert progressed.wait(WAIT_S)
            progressed.clear()
            for s in servers[1:]:
                s.mixer.submit_now()
            if servers[0].mixer.mix_now() is not None:
                rounds += 1
    finally:
        stop.set()
        for t in threads:
            t.join(WAIT_S)
    assert not errors, errors
    assert rounds >= 3
    assert versions == sorted(versions)
    assert versions[-1] >= rounds - 1
    g = servers[0].trace.gauges()
    assert g["mix.model_version"] == float(servers[0].mixer.model_version)


def test_submit_faults_drop_and_inbox(async_cluster):
    servers = async_cluster
    _train(servers[0], [("l0", {"x": 1.0})])
    assert servers[0].mixer.mix_now() is not None  # master + hint
    _train(servers[1], [("l1", {"x": 2.0})])
    me = servers[1].self_nodeinfo().name
    with faults.armed(f"mix.async.submit.{me}:drop"):
        assert servers[1].mixer.submit_now() is False
    assert servers[0].mixer.inbox.depth() == 0
    with faults.armed("mix.async.inbox.*:drop"):
        assert servers[1].mixer.submit_now() is False
    assert servers[0].mixer.inbox.depth() == 0
    assert servers[1].mixer.submit_now() is True
    assert servers[0].mixer.inbox.depth() == 1


def test_schema_churn_prefix_folds_nonprefix_defers(async_cluster):
    """A payload whose sorted vocabulary is a PREFIX of the union folds
    as-is; a non-prefix payload defers one tick while the union
    broadcast realigns its owner."""
    servers = async_cluster
    _train(servers[0], [("l0", {"x": 1.0})])
    assert servers[0].mixer.mix_now() is not None
    _train(servers[1], [("a0", {"x": -2.0})])
    _train(servers[2], [("l0", {"x": 3.0})])
    assert servers[1].mixer.submit_now() is True
    assert servers[2].mixer.submit_now() is True
    r = servers[0].mixer.mix_now()
    assert r is not None
    assert (r.get("deferred_schema") or 0) >= 1
    assert servers[0].trace.counters()["mix.async_schema_deferred"] >= 1
    _train(servers[1], [("a0", {"x": -1.0})])
    _train(servers[2], [("l0", {"x": 2.0})])
    assert servers[1].mixer.submit_now() is True
    assert servers[2].mixer.submit_now() is True
    r = servers[0].mixer.mix_now()
    assert r is not None and not r.get("deferred_schema")
    assert r["contributors"] == 2


def test_nonconcontributor_apply_captures_pending_updates(async_cluster):
    """A fold's broadcast resets every member's accumulation, including
    members whose diffs weren't in the fold: their training survives
    through the apply-time capture."""
    servers = async_cluster
    _train(servers[0], [("l0", {"x": 2.0}), ("l1", {"x": -0.1})])
    _train(servers[1], [("l1", {"x": -2.0}), ("l0", {"x": 0.1})])
    r1 = servers[0].mixer.mix_now()
    assert r1 is not None and r1["contributors"] == 1
    assert servers[1].trace.counters().get("mix.async_captures") == 1
    assert servers[1].mixer.submit_now() is True
    r2 = servers[0].mixer.mix_now()
    assert r2["contributors"] == 1
    for probe, win, lose in ((2.0, "l0", "l1"), (-2.0, "l1", "l0")):
        scores = {_label(e[0]): e[1]
                  for e in _classify(servers[2], {"x": probe})[0]}
        assert scores[win] > scores[lose]
    assert not servers[0].trace.counters().get("mix.async_captures")


# -- one fleet of both packages --------------------------------------------------

def _halves(n=40, seed=5):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        label = "abc"[i % 3]
        feats = {f"f{j}": float(np.round(rng.standard_normal(), 3))
                 for j in rng.choice(12, 4, replace=False)}
        feats["bias"] = {"a": 1.0, "b": -1.0, "c": 0.5}[label]
        rows.append([label, Datum(feats)])
    return rows[0::2], rows[1::2]


def _member_args(**kw):
    return dict(coordinator="(shared)", name="mixed",
                listen_addr="127.0.0.1", interval_sec=1e9,
                interval_count=1 << 30, microbatch_max=0, **kw)


def _jax_member(coord_dir, **kw):
    srv = JEngineServer("classifier", CONF, JServerArgs(
        engine="classifier", telemetry_interval=0, **_member_args(**kw)),
        coord=JFileCoordinator(coord_dir))
    srv.start(0)
    return srv


def _port_member(coord_dir, **kw):
    srv = EngineServer("classifier", CONF, ServerArgs(
        engine="classifier", **_member_args(**kw)), device="cpu",
        coord=FileCoordinator(coord_dir))
    srv.start(0)
    return srv


def _fleet_round(members, coord_dir, master, mode):
    """Two members train disjoint halves; one round of ``mode``
    (``broadcast_mixer`` or ``async``) with member ``master`` leading;
    returns each member's pack after the round."""
    kw = {"mix_async": True} if mode == "async" else {"mixer": mode}
    srvs = [make(coord_dir, **kw) for make in members]
    try:
        if mode == "async":
            # the first fold elects the master and publishes its hint
            assert srvs[master].mixer.mix_now() is not None
        for srv, half in zip(srvs, _halves()):
            with JClassifierClient("127.0.0.1", srv.args.rpc_port,
                                   "mixed") as c:
                assert c.train(half) == len(half)
        if mode == "async":
            assert srvs[1 - master].mixer.submit_now() is True
            r = srvs[master].mixer.mix_now()
            assert r["contributors"] == 2
            assert all(w == 1.0 for w in r["weights"].values())
        else:
            with JClassifierClient("127.0.0.1", srvs[master].args.rpc_port,
                                   "mixed") as c:
                assert c.do_mix() is True
        return [s.driver.pack() for s in srvs]
    finally:
        for s in srvs:
            s.stop()


@pytest.mark.parametrize("mode", ["broadcast_mixer", "async"])
@pytest.mark.parametrize("master", ["jax", "port"])
def test_mixed_fleet_push_and_async_are_bit_equal_to_a_jax_fleet(
        mode, master, tmp_path):
    """One JAX and one port server on one FileCoordinator: a push exchange
    (broadcast_mixer) or an async fold at staleness 0 leaves PA's weights
    bit-equal to a two-JAX fleet's, with either package leading."""
    want = _fleet_round([_jax_member, _jax_member], str(tmp_path / "jj"),
                        0, mode)
    got = _fleet_round([_jax_member, _port_member], str(tmp_path / "jp"),
                       0 if master == "jax" else 1, mode)
    assert not np.array_equal(np.asarray(want[0]["w"]), 0)
    for pack in got:
        assert [x for x in pack["labels"] if x] == ["a", "b", "c"]
        for key in ("w", "prec", "label_counts"):
            assert np.array_equal(np.asarray(pack[key]),
                                  np.asarray(want[0][key])), key


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
def test_an_async_fold_on_the_card_is_the_cpu_fold(cuda):
    """Two port servers on the card with --mix-async: a staleness-0 fold
    of both members' diffs leaves both replicas with the model two CPU
    port servers fold from the same halves (the card's scatter may add
    duplicates in another order: within 1e-6 of the largest weight)."""
    def run(device):
        servers = _cluster("classifier", CONF, 2, _Store(), mix_async=True,
                           microbatch_max=0, device=device)
        try:
            assert servers[0].mixer.mix_now() is not None
            for srv, half in zip(servers, _halves()):
                with ClassifierClient("127.0.0.1", srv.args.rpc_port,
                                      NAME) as c:
                    c.train(half)
            assert servers[1].mixer.submit_now() is True
            r = servers[0].mixer.mix_now()
            assert r["contributors"] == 2
            return [s.driver.pack() for s in servers]
        finally:
            for s in servers:
                s.stop()

    card, cpu = run(cuda), run("cpu")
    scale = float(np.abs(cpu[0]["w"]).max())
    for got in card:
        np.testing.assert_array_equal(got["w"], card[0]["w"])
        np.testing.assert_allclose(got["w"], cpu[0]["w"], rtol=0,
                                   atol=1e-6 * scale)
