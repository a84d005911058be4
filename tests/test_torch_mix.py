"""The port's RPC linear mix plane and its coordinator.

Mirrors ``tests/test_mixer_and_drivers.py`` (the stabilizer-loop
thresholds, mix_now, stop, regression and weight mix, concurrent train and
mix, tree_sum's row padding) and ``tests/test_distributed_cluster.py``
(membership, averaging, update counts, stat mix, late joiner recovery, the
fold against a stub) against the port, on the CPU. Then the two packages
in one fleet: ``pack_mix`` payloads cross between them, and a JAX server
and a port server on one FileCoordinator mix over RPC to the model a
two-JAX-server fleet holds, with either package as master. The tests wait
on events and on the mixer's own threads, never on the wall clock.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from jubatus_tpu.client import ClassifierClient as JClassifierClient
from jubatus_tpu.client import StatClient as JStatClient
from jubatus_tpu.coord.file import FileCoordinator as JFileCoordinator
from jubatus_tpu.framework import linear_mixer as jax_linear_mixer
from jubatus_tpu.server import EngineServer as JEngineServer
from jubatus_tpu.server.args import ServerArgs as JServerArgs
from jubatus_tpu_torch.coord import (CoordinatorError, create_coordinator,
                                     membership)
from jubatus_tpu_torch.coord.base import NodeInfo
from jubatus_tpu_torch.coord.file import FileCoordinator
from jubatus_tpu_torch.coord.memory import MemoryCoordinator, _Store
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.framework import linear_mixer
from jubatus_tpu_torch.framework.linear_mixer import (PROTOCOL_VERSION,
                                                      LinearCommunication,
                                                      RpcLinearMixer,
                                                      pack_mix, unpack_mix)
from jubatus_tpu_torch.framework.mixer import IntervalMixer
from jubatus_tpu_torch.framework.save_load import load_model, save_model
from jubatus_tpu_torch.models.classifier import ClassifierDriver
from jubatus_tpu_torch.models.regression import RegressionDriver
from jubatus_tpu_torch.models.weight import WeightDriver
from jubatus_tpu_torch.parallel.mix import tree_sum
from jubatus_tpu_torch.rpc.client import ClassifierClient, StatClient
from jubatus_tpu_torch.server import EngineServer
from jubatus_tpu_torch.server.args import ServerArgs
from jubatus_tpu_torch.server.factory import create_driver
from jubatus_tpu_torch.utils.serialization import pack_obj

WAIT_S = 30.0


# -- the stabilizer loop (framework/mixer.py) ----------------------------------

def test_mixer_fires_on_count_threshold():
    fired = threading.Event()
    calls = []

    def mix():
        calls.append(1)
        fired.set()

    m = IntervalMixer(mix, interval_sec=9999, interval_count=10)
    m.POLL_SEC = 0.01
    m.start()
    try:
        m.updated(9)
        assert not m.due()
        m.updated(1)
        assert fired.wait(WAIT_S)
    finally:
        m.stop()
    assert len(calls) == 1
    assert m.mix_count == 1
    assert m.get_status()["counter"] == 0


def test_mixer_fires_on_time_threshold_only_with_updates():
    fired = threading.Event()
    m = IntervalMixer(fired.set, interval_sec=0.05, interval_count=10_000)
    m.POLL_SEC = 0.01
    m._last_mix_time -= 1.0  # the interval has passed
    assert not m.due()  # no updates -> no mix
    m.start()
    try:
        m.updated(1)
        assert m.due() or fired.is_set()
        assert fired.wait(WAIT_S)
    finally:
        m.stop()
    assert m.mix_count == 1


def test_mixer_mix_now_and_failure_does_not_kill_loop():
    calls = []
    second = threading.Event()

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("boom")
        second.set()
        return {"mode": "test", "members": 1}

    m = IntervalMixer(flaky, interval_sec=9999, interval_count=1)
    m.POLL_SEC = 0.01
    with pytest.raises(RuntimeError, match="boom"):
        m.mix_now()
    m.start()
    try:
        m.updated(1)
        assert second.wait(WAIT_S)
    finally:
        m.stop()
    assert len(calls) == 2
    recs = m.flight.snapshot()
    assert [r["ok"] for r in recs] == [False, True]
    assert recs[0]["reason"] == "RuntimeError: boom"
    assert recs[1]["mode"] == "test" and recs[1]["members"] == 1
    assert m.trace.counters()["mix.round.errors"] >= 1


def test_mixer_stop_while_running_is_clean():
    m = IntervalMixer(lambda: None)
    m.start()
    m.stop()
    assert m._thread is None


# -- drivers mixed in process through the mixer's wire -------------------------

REG_CFG = {
    "method": "PA1",
    "parameter": {"sensitivity": 0.01, "regularization_weight": 1.0},
    "converter": {"num_rules": [{"key": "*", "type": "num"}],
                  "string_rules": []},
}


class _LocalComm(LinearCommunication):
    """Every member's mixer in this process: the master's fan-outs call
    the members' mix_* handlers directly, payloads packed as on the wire."""

    def __init__(self, group):
        self.group = group  # node name -> RpcLinearMixer

    def update_members(self):
        return [NodeInfo.from_name(n) for n in self.group]

    def try_lock(self):
        return True

    def unlock(self):
        pass

    def get_schemas(self):
        return [m.local_get_schema() for m in self.group.values()]

    def sync_schema(self, union):
        for m in self.group.values():
            m.local_sync_schema(union)

    def get_diff(self):
        return [(NodeInfo.from_name(n), m.local_get_diff())
                for n, m in self.group.items()]

    def put_diff(self, packed):
        return {n: m.local_put_diff(packed) for n, m in self.group.items()}

    def get_model(self, member):
        return self.group[member.name].local_get_model()


def _local_group(drivers, **kw):
    """One RpcLinearMixer per driver, sharing a _LocalComm; a round is
    ``mixers[0].mix_now()``."""
    group = {}
    comm = _LocalComm(group)
    mixers = []
    for i, d in enumerate(drivers):
        node = NodeInfo("local", i)
        m = RpcLinearMixer(d, comm, self_node=node, **kw)
        group[node.name] = m
        mixers.append(m)
    return mixers


def test_regression_driver_end_to_end(tmp_path, rng):
    d = RegressionDriver(REG_CFG, dim_bits=10, device="cpu")
    data = [(2.0 * x + 1.0, Datum({"x": x, "bias": 1.0}))
            for x in rng.uniform(-1, 1, 200)]
    for _ in range(5):
        d.train(data)
    pred = d.estimate([Datum({"x": 0.5, "bias": 1.0}),
                       Datum({"x": -0.5, "bias": 1.0})])
    assert pred[0] == pytest.approx(2.0, abs=0.3)
    assert pred[1] == pytest.approx(0.0, abs=0.3)

    path = str(tmp_path / "r.jubatus")
    save_model(path, d, config="{}")
    d2 = RegressionDriver(REG_CFG, dim_bits=10, device="cpu")
    load_model(path, d2, expected_config="{}")
    assert d2.estimate([Datum({"x": 0.5, "bias": 1.0})])[0] == \
        pytest.approx(pred[0], abs=1e-5)

    d.clear()
    assert d.estimate([Datum({"x": 0.5, "bias": 1.0})])[0] == 0.0


def test_regression_mix(rng):
    ds = [RegressionDriver(REG_CFG, dim_bits=10, device="cpu")
          for _ in range(2)]
    xs = rng.uniform(-1, 1, 200)
    for i, d in enumerate(ds):
        for _ in range(5):
            d.train([(3.0 * x, Datum({"x": x})) for x in xs[i::2]])
    result = _local_group(ds)[0].mix_now()
    assert result["members"] == 2 and result["acked"] == 2
    for d in ds:
        assert d.estimate([Datum({"x": 1.0})])[0] == pytest.approx(3.0,
                                                                   abs=0.4)


WEIGHT_CFG = {
    "converter": {
        "string_rules": [
            {"key": "*", "type": "space", "sample_weight": "tf",
             "global_weight": "idf"}
        ],
        "num_rules": [{"key": "*", "type": "num"}],
    }
}


def test_weight_driver_update_and_mix():
    d0 = WeightDriver(WEIGHT_CFG, dim_bits=10, device="cpu")
    d1 = WeightDriver(WEIGHT_CFG, dim_bits=10, device="cpu")
    for _ in range(4):
        d0.update(Datum({"t": "common rare0"}))
        d1.update(Datum({"t": "common rare1"}))
    # idf on d0 only knows its local docs pre-mix
    pre = dict(d0.calc_weight(Datum({"t": "common rare1"})))
    _local_group([d0, d1])[0].mix_now()
    post = dict(d0.calc_weight(Datum({"t": "common rare1"})))
    # after mix, d0 knows rare1 occurs in half the corpus -> finite idf < pre
    k = "t$rare1@space#tf/idf"
    assert post[k] < pre[k]
    common = "t$common@space#tf/idf"
    assert post[common] == pytest.approx(0.0, abs=1e-6)  # in every doc


def test_concurrent_train_and_mix_thread_safety():
    """Train/classify from two threads while background rounds run — the
    model-lock discipline keeps state consistent (the reference's
    rw_mutex, server_base.hpp:70-72)."""
    cfg = {
        "method": "PA",
        "converter": {
            "string_rules": [{"key": "*", "type": "space",
                              "sample_weight": "bin", "global_weight": "bin"}],
            "num_rules": [],
        },
    }
    ds = [ClassifierDriver(cfg, dim_bits=10, device="cpu") for _ in range(2)]
    master = _local_group(ds)[0]
    mixer = IntervalMixer(master.mix_now, interval_sec=9999,
                          interval_count=4)
    mixer.POLL_SEC = 0.005
    errors = []

    def hammer(d, tag):
        try:
            for i in range(30):
                d.train([(f"l{i % 3}", Datum({"t": f"w{i} z{i % 5} {tag}"}))])
                mixer.updated(1)
                d.classify([Datum({"t": f"w{i}"})])
        except Exception as e:  # pragma: no cover
            errors.append(e)

    mixer.start()
    threads = [threading.Thread(target=hammer, args=(d, i))
               for i, d in enumerate(ds)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    mixer.stop()
    assert not errors, errors
    assert mixer.mix_count >= 1
    # both replicas converged to the same schema
    master.mix_now()
    assert ds[0].get_schema() == ds[1].get_schema()


def test_tree_sum_pads_row_trimmed_diffs():
    """Row-trimmed label diffs can differ by a row when a replica trains
    a novel label between schema sync and get_diff; the fold zero-pads
    to the larger row count instead of aborting the round."""
    a = {"dw": np.ones((2, 4), np.float32), "count": np.float32(1.0)}
    b = {"dw": np.full((3, 4), 2.0, np.float32), "count": np.float32(1.0)}
    tot = tree_sum([a, b])
    assert tot["dw"].shape == (3, 4)
    np.testing.assert_allclose(tot["dw"][:2], 3.0)
    np.testing.assert_allclose(tot["dw"][2], 2.0)
    assert float(tot["count"]) == 2.0


def test_tree_sum_is_the_jax_packages_fold():
    """The same contributions fold to the same bits in both packages."""
    from jubatus_tpu.parallel.mix import tree_sum as jax_tree_sum

    rng = np.random.default_rng(3)
    diffs = [{"dw": rng.standard_normal((n, 8)).astype(np.float32),
              "dprec": rng.standard_normal((n, 8)).astype(np.float32),
              "count": 1.0, "label_counts": np.ones(n, np.float32)}
             for n in (2, 3, 3)]
    got, want = tree_sum(diffs), jax_tree_sum(diffs)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


# -- a fleet of port servers over RPC (MemoryCoordinator) -----------------------

CONF = {
    "method": "PA",
    "parameter": {"regularization_weight": 1.0},
    "converter": {"num_rules": [{"key": "*", "type": "num"}]},
}

NAME = "cl"


def _args(engine, **kw):
    return ServerArgs(engine=engine, coordinator="(shared)", name=NAME,
                      listen_addr="127.0.0.1", interval_sec=1e9,
                      interval_count=1 << 30, **kw)


def _cluster(engine, conf, n, store, device="cpu"):
    servers = []
    for _ in range(n):
        srv = EngineServer(engine, conf, _args(engine), device=device,
                           coord=MemoryCoordinator(store))
        srv.start(0)
        servers.append(srv)
    return servers


@pytest.fixture()
def cluster():
    store = _Store()
    servers = _cluster("classifier", CONF, 3, store)
    yield servers, store
    for s in servers:
        s.stop()


def test_membership_registered(cluster):
    servers, store = cluster
    view = MemoryCoordinator(store)
    nodes = membership.get_all_nodes(view, "classifier", NAME)
    assert len(nodes) == 3
    assert {n.port for n in nodes} == {s.args.rpc_port for s in servers}
    assert len(membership.get_all_actives(view, "classifier", NAME)) == 3
    assert membership.get_epoch(view, "classifier", NAME) == 3


def test_mix_averages_models(cluster):
    servers, _ = cluster
    # each node trains a DIFFERENT class — only mixing can teach them both
    c0, c1, c2 = (ClassifierClient("127.0.0.1", s.args.rpc_port, NAME)
                  for s in servers)
    for _ in range(10):
        c0.train([["pos", Datum({"x": 1.0, "y": 0.2})]])
        c1.train([["neg", Datum({"x": -1.0, "y": -0.2})]])
    # before mix: node 2 has never seen any data
    assert c2.get_labels() == {}
    assert c2.do_mix() is True
    assert set(c2.get_labels()) == {"pos", "neg"}
    # after mix every node classifies both classes correctly
    for c in (c0, c1, c2):
        (res,) = c.classify([Datum({"x": 1.0, "y": 0.2})])
        assert max(res, key=lambda ls: ls[1])[0] == "pos"
        (res,) = c.classify([Datum({"x": -1.0, "y": -0.2})])
        assert max(res, key=lambda ls: ls[1])[0] == "neg"
    (st,) = c2.get_status().values()
    (rec,) = servers[2].mixer.flight.snapshot()
    assert rec["ok"] and rec["mode"] == "rpc" and rec["members"] == 3
    assert set(rec["phases"]) == {"schema_ms", "get_diff_ms", "fold_ms",
                                  "put_diff_ms"}
    assert st["mixer.flight_recorded"] == 1
    assert st["trace.mix.phase.get_diff.count"] == 1
    # the gauges are served by get_metrics, as the JAX server serves them
    (snap,) = servers[2].get_metrics("").values()
    assert "mix.snapshot_stall_ms" in snap["gauges"]
    for c in (c0, c1, c2):
        c.close()


def test_mix_counts_updates(cluster):
    servers, _ = cluster
    c0 = ClassifierClient("127.0.0.1", servers[0].args.rpc_port, NAME)
    c0.train([["a", Datum({"x": 1.0})]])
    (node_st,) = c0.get_status().values()
    assert node_st["mixer.counter"] >= 1  # update reached the mixer
    c0.do_mix()
    (node_st,) = c0.get_status().values()
    assert node_st["mixer.mix_count"] == 1
    assert node_st["mixer.counter"] == 0  # reset by the round
    c0.close()


def test_stat_cluster_mix():
    """Engines with dict-shaped sparse diffs mix over RPC too."""
    store = _Store()
    servers = _cluster("stat", {"window_size": 64}, 2, store)
    try:
        s0 = StatClient("127.0.0.1", servers[0].args.rpc_port, NAME)
        s1 = StatClient("127.0.0.1", servers[1].args.rpc_port, NAME)
        for v in (1.0, 2.0):
            s0.push("k", v)
        for v in (3.0, 4.0):
            s1.push("k", v)
        s0.do_mix()
        # stat's mix shares cluster-wide counts; local windows stay local
        assert s0.sum("k") == pytest.approx(3.0)
        assert s1.sum("k") == pytest.approx(7.0)
        s0.close()
        s1.close()
    finally:
        for s in servers:
            s.stop()


class _StubComm(LinearCommunication):
    """The reference's linear_communication_stub
    (linear_mixer_test.cpp:65-112): canned get_diff payloads, captured
    put_diff."""

    def __init__(self, canned):
        self.canned = canned
        self.put = []

    def update_members(self):
        return [NodeInfo("s", i) for i in range(len(self.canned))]

    def try_lock(self):
        return True

    def unlock(self):
        pass

    def get_diff(self):
        return [(NodeInfo("s", i), p) for i, p in enumerate(self.canned)]

    def put_diff(self, packed):
        self.put.append(packed)
        return {f"s_{i}": True for i in range(len(self.canned))}

    def get_model(self, member):
        raise AssertionError("not used")


def test_late_joiner_recovers_full_model():
    """A node joining AFTER the cluster has mixed is version-obsolete: the
    next round's delta fold cannot teach it, so it pulls a full model from
    a peer (linear_mixer.cpp:598-632)."""
    store = _Store()
    servers = _cluster("classifier", CONF, 2, store)
    try:
        c0 = ClassifierClient("127.0.0.1", servers[0].args.rpc_port, NAME)
        for _ in range(10):
            c0.train([["pos", Datum({"x": 1.0, "y": 0.2})]])
            c0.train([["neg", Datum({"x": -1.0, "y": -0.2})]])
        assert c0.do_mix() is True  # cluster now at model version 1
        # late joiner: fresh model, version 0
        servers += _cluster("classifier", CONF, 1, store)
        late = servers[-1]
        assert c0.do_mix() is True  # marks the joiner obsolete
        late.mixer.recover_thread.join(WAIT_S)
        cl = ClassifierClient("127.0.0.1", late.args.rpc_port, NAME)
        (res,) = cl.classify([Datum({"x": 1.0, "y": 0.2})])
        assert max(res, key=lambda s: s[1])[0] == "pos"
        (st,) = cl.get_status().values()
        assert st["mixer.model_version"] >= 1
        assert st["mixer.obsolete"] is False
        c0.close(), cl.close()
    finally:
        for s in servers:
            s.stop()


def test_mixer_fold_with_stub():
    """Mix rounds run against canned diffs — no sockets, no coordinator."""
    driver = create_driver("stat", {"window_size": 8}, device="cpu")
    driver.push("k", 5.0)
    local = driver.get_mixables()["stat"].get_diff()
    remote = {"counts": np.asarray([2.0], dtype=np.float32)}
    canned = [
        pack_obj({"protocol": PROTOCOL_VERSION, "schema": ["k"],
                  "diffs": {"stat": local}}),
        pack_obj({"protocol": PROTOCOL_VERSION, "schema": ["k"],
                  "diffs": {"stat": remote}}),
    ]
    comm = _StubComm(canned)
    mixer = RpcLinearMixer(driver, comm)
    result = mixer.mix_now()
    assert result is not None
    assert len(comm.put) == 1
    folded = unpack_mix(comm.put[0])["diffs"]["stat"]
    # stat diff = {"counts": per-key window counts}; 1 (local) + 2 (canned)
    assert folded["counts"][0] == pytest.approx(3.0)


# -- the two packages in one fleet ---------------------------------------------

@pytest.mark.parametrize("size", [16, 1 << 14])
def test_pack_mix_payloads_cross_between_the_packages(size):
    """The same payload packs to the same bytes in both packages (raw
    below the compression threshold, zlib above it), and each package
    unpacks the other's."""
    rng = np.random.default_rng(size)
    obj = {"protocol": PROTOCOL_VERSION, "schema": ["a", "b"], "version": 3,
           "diffs": {"classifier": {
               "dw": np.round(rng.standard_normal((2, size)), 1)
               .astype(np.float32),
               "count": 1.0, "label_counts": np.ones(2, np.float32)}}}
    mine, theirs = pack_mix(obj), jax_linear_mixer.pack_mix(obj)
    assert mine == theirs
    assert mine[:1] == (b"Z" if size > 16 else b"R")
    for got in (unpack_mix(theirs), jax_linear_mixer.unpack_mix(mine)):
        assert got["schema"] == ["a", "b"] and got["version"] == 3
        assert np.array_equal(got["diffs"]["classifier"]["dw"],
                              obj["diffs"]["classifier"]["dw"])
    assert linear_mixer.PROTOCOL_VERSION == jax_linear_mixer.PROTOCOL_VERSION


def _jax_member(engine, conf, coord_dir, name):
    srv = JEngineServer(engine, conf, JServerArgs(
        engine=engine, coordinator="(shared)", name=name,
        listen_addr="127.0.0.1", interval_sec=1e9, interval_count=1 << 30,
        microbatch_max=0), coord=JFileCoordinator(coord_dir))
    srv.start(0)
    return srv


def _port_member(engine, conf, coord_dir, name):
    srv = EngineServer(engine, conf, ServerArgs(
        engine=engine, coordinator="(shared)", name=name,
        listen_addr="127.0.0.1", interval_sec=1e9, interval_count=1 << 30,
        microbatch_max=0), device="cpu", coord=FileCoordinator(coord_dir))
    srv.start(0)
    return srv


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


def _classifier_fleet(members, coord_dir, master):
    """Two members train disjoint halves (one train call each), the master
    runs do_mix; returns each member's (pre-mix, post-mix) pack."""
    srvs = [make("classifier", CONF, coord_dir, "mixed")
            for make in members]
    try:
        for srv, half in zip(srvs, _halves()):
            with ClassifierClient("127.0.0.1", srv.args.rpc_port,
                                  "mixed") as c:
                assert c.train(half) == len(half)
        pre = [s.driver.pack() for s in srvs]
        with ClassifierClient("127.0.0.1", srvs[master].args.rpc_port,
                              "mixed") as c:
            assert c.do_mix() is True
        post = [s.driver.pack() for s in srvs]
        for s in srvs:
            (st,) = JClassifierClient(
                "127.0.0.1", s.args.rpc_port, "mixed").get_status().values()
            assert st["mixer.model_version"] == 1
        return pre, post
    finally:
        for s in srvs:
            s.stop()


@pytest.mark.parametrize("master", ["jax", "port"])
def test_mixed_fleet_classifier_is_bit_equal_to_a_jax_fleet(master,
                                                             tmp_path):
    """One JAX and one port server on one FileCoordinator mix PA over RPC
    to the weights a two-JAX-server fleet holds, bit for bit, with the
    JAX server or the port server as master. Both fleets fold host numpy
    in tree_sum and apply one float32 add per element."""
    jax_fleet_pre, jax_fleet = _classifier_fleet(
        [_jax_member, _jax_member], str(tmp_path / "jj"), master=0)
    mixed_pre, mixed = _classifier_fleet(
        [_jax_member, _port_member], str(tmp_path / "jp"),
        master=0 if master == "jax" else 1)
    # the port member trained its half to the JAX member's bits
    for key in ("w", "prec", "label_counts"):
        assert np.array_equal(np.asarray(mixed_pre[1][key]),
                              np.asarray(jax_fleet_pre[1][key])), key
    assert not np.array_equal(np.asarray(mixed_pre[0]["w"]),
                              np.asarray(mixed_pre[1]["w"]))
    for got in mixed:
        assert [x for x in got["labels"] if x] == ["a", "b", "c"]
        for key in ("w", "prec", "label_counts"):
            assert np.array_equal(np.asarray(got[key]),
                                  np.asarray(jax_fleet[0][key])), key


@pytest.mark.parametrize("master", ["jax", "port"])
def test_mixed_fleet_stat_answers_as_a_jax_fleet(master, tmp_path):
    """Stat's dict-shaped diffs mix between the packages too: every
    answer of the mixed fleet equals the two-JAX fleet's, exactly."""
    def run(members, coord_dir, master_i):
        srvs = [make("stat", {"window_size": 64}, coord_dir, "st")
                for make in members]
        try:
            clients = [JStatClient("127.0.0.1", s.args.rpc_port, "st")
                       for s in srvs]
            for i, c in enumerate(clients):
                for v in range(6):
                    c.push(f"k{v % 2}", float(3 * i + v) - 1.5)
            assert clients[master_i].do_mix() is True
            out = [[getattr(c, m)(k) for k in ("k0", "k1")
                    for m in ("sum", "stddev", "max", "min", "entropy")]
                   for c in clients]
            for c in clients:
                c.close()
            return out
        finally:
            for s in srvs:
                s.stop()

    want = run([_jax_member, _jax_member], str(tmp_path / "jj"), 0)
    got = run([_jax_member, _port_member], str(tmp_path / "jp"),
              0 if master == "jax" else 1)
    assert got == want


# -- flags the port refuses -----------------------------------------------------

@pytest.mark.parametrize("flags", [
    {"mixer": "collective_mixer"},
    {"mixer": "collective_mixer", "mix_guard": "quarantine"},
    {"mixer": "collective_mixer", "coordinator": "(shared)", "name": "c"}])
def test_unported_mix_flags_raise_not_yet_ported(flags):
    """Every --mixer value is ported now, the collective mixer last (it
    raised NotYetPorted until then): a server builds with it whatever
    flags ride along, and in a fleet it holds a CollectiveMixer carrying
    the guard."""
    from jubatus_tpu_torch.framework.collective_mixer import CollectiveMixer

    srv = EngineServer("stat", {"window_size": 8},
                       ServerArgs(engine="stat", **flags), device="cpu",
                       coord=MemoryCoordinator(_Store())
                       if "coordinator" in flags else None)
    try:
        if "coordinator" not in flags:
            assert srv.mixer is None
            return
        assert isinstance(srv.mixer, CollectiveMixer)
        assert srv.mixer.guard.mode == flags.get("mix_guard", "warn")
    finally:
        if srv.coord is not None:
            srv.coord.close()


def test_every_coordinator_locator_builds_its_backend(tmp_path):
    """``zk://`` builds a ``ZkCoordinator`` session on a (fake) ensemble
    and, like tcp:// and host:port, raises "cannot reach" where none
    listens; file:// builds a FileCoordinator."""
    from fake_zk import FakeZkServer

    from jubatus_tpu_torch.coord.zk import ZkCoordinator

    zk = FakeZkServer()
    try:
        coord = create_coordinator(f"zk://127.0.0.1:{zk.start(0)}")
        assert isinstance(coord, ZkCoordinator)
        assert coord.create("/jubatus/probe", b"x")
        assert coord.read("/jubatus/probe") == b"x"
        coord.close()
    finally:
        zk.stop()
    for spec in ("zk://127.0.0.1:1", "tcp://127.0.0.1:1", "127.0.0.1:1"):
        with pytest.raises(CoordinatorError, match="cannot reach"):
            create_coordinator(spec)
    coord = create_coordinator(f"file://{tmp_path}")
    assert isinstance(coord, FileCoordinator)
    coord.close()


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_fleet_on_the_card_mixes_as_a_fleet_on_the_cpu(cuda):
    """Two port servers on the card mix to the model two CPU port servers
    mix to, from the same halves (the card's scatter may add duplicates
    in another order: within 1e-6 of the largest weight)."""
    def run(device):
        store = _Store()
        servers = _cluster("classifier", CONF, 2, store, device=device)
        try:
            for srv, half in zip(servers, _halves()):
                with ClassifierClient("127.0.0.1", srv.args.rpc_port,
                                      NAME) as c:
                    c.train(half)
            with ClassifierClient("127.0.0.1", servers[0].args.rpc_port,
                                  NAME) as c:
                assert c.do_mix() is True
            return [s.driver.pack() for s in servers]
        finally:
            for s in servers:
                s.stop()

    card, cpu = run("cuda"), run("cpu")
    scale = float(np.abs(cpu[0]["w"]).max())
    for got in card:
        np.testing.assert_allclose(got["w"], card[0]["w"], atol=0)
        np.testing.assert_allclose(got["w"], cpu[0]["w"], rtol=0,
                                   atol=1e-6 * scale)


def test_burst_members_process_their_cht_keywords():
    """In a fleet, burst processes only the keywords its CHT(2) places on
    it, on the same ring the JAX package builds from the membership."""
    from jubatus_tpu.coord.base import NodeInfo as JNodeInfo
    from jubatus_tpu.coord.cht import CHT as JCHT

    store = _Store()
    servers = _cluster("burst", {"parameter": {}}, 3, store)
    try:
        ring = JCHT([JNodeInfo.from_name(s.self_nodeinfo().name)
                     for s in servers])
        for kw in (f"kw{i}" for i in range(24)):
            want = {n.name for n in ring.find(kw, 2)}
            got = {s.self_nodeinfo().name for s in servers
                   if s.driver._is_assigned(kw)}
            assert got == want, kw
    finally:
        for s in servers:
            s.stop()
