"""The port's feature-sharded linear drivers (models/classifier.py and
models/regression.py under ``mesh=``) against their flat form and against
the JAX package's sharded drivers, on the CPU.

Mirrors tests/test_sharded_driver.py: the lifecycle against the dense
driver (train, classify, label growth and delete, schema sync, clear),
save / load across sharded and flat drivers of both packages, the
indivisible dim, an in-process sharded server over RPC, regression, the
factory's routing, and sharded members mixing over the RPC linear mixer,
a sharded JAX member and a sharded port member in one round included.
The port's shards are ``ShardMesh(["cpu"] * S)``; the JAX package's the
conftest's virtual CPU devices.

Tolerances: scores within the JAX test's rtol 1e-5 / atol 1e-6 of the
port's dense driver and of the JAX package's sharded driver (the K-sums
and the cross-shard sums add in other orders); the tables of sharded
members that mixed are equal to each other bit for bit, and tables moved
through a model file arrive bit for bit.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from jubatus_tpu.client import ClassifierClient as JClassifierClient
from jubatus_tpu.coord.file import FileCoordinator as JFileCoordinator
from jubatus_tpu.core.datum import Datum as JDatum
from jubatus_tpu.framework import load_model as jload_model
from jubatus_tpu.framework import save_model as jsave_model
from jubatus_tpu.models.classifier import ClassifierDriver as JDriver
from jubatus_tpu.models.regression import RegressionDriver as JRegression
from jubatus_tpu.server import EngineServer as JEngineServer
from jubatus_tpu.server.args import ServerArgs as JServerArgs
from jubatus_tpu.server.factory import create_driver as jcreate
from jubatus_tpu_torch.coord.file import FileCoordinator
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.framework.save_load import load_model, save_model
from jubatus_tpu_torch.models.classifier import (ClassifierConfigError,
                                                 ClassifierDriver)
from jubatus_tpu_torch.models.regression import (RegressionConfigError,
                                                 RegressionDriver)
from jubatus_tpu_torch.parallel import sharded_model as sm
from jubatus_tpu_torch.parallel.mesh import ShardMesh
from jubatus_tpu_torch.rpc.client import ClassifierClient, RegressionClient
from jubatus_tpu_torch.server import EngineServer
from jubatus_tpu_torch.server.args import ServerArgs
from jubatus_tpu_torch.server.factory import create_driver

CONF = {
    "method": "AROW",
    "parameter": {"regularization_weight": 1.0},
    "converter": {
        "string_rules": [{"key": "*", "type": "space",
                          "sample_weight": "bin", "global_weight": "bin"}],
        "num_rules": [{"key": "*", "type": "num"}],
    },
}
RCONF = {"method": "PA1",
         "parameter": {"sensitivity": 0.1, "regularization_weight": 1.0},
         "converter": {"num_rules": [{"key": "*", "type": "num"}]}}
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def mesh():
    return ShardMesh(["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh():
    return Mesh(np.asarray(jax.devices()[:8]), axis_names=("shard",))


def _train_all(drivers, rng, n=40):
    """One datum a train call, the same to every driver (JAX drivers get
    the JAX package's Datum)."""
    for i in range(n):
        x = float(rng.normal())
        lbl = "pos" if x > 0 else "neg"
        row = {"x": x, "b": 1.0, "w": f"tok{i % 7}"}
        for d in drivers:
            D = JDatum if isinstance(d, JDriver) else Datum
            d.train([(lbl, D(row))])


def _scores(d, rows):
    D = JDatum if isinstance(d, (JDriver,)) else Datum
    return [sorted(r) for r in d.classify([D(x) for x in rows])]


def _close(a, b):
    for ra, rb in zip(a, b):
        assert [lab for lab, _ in ra] == [lab for lab, _ in rb]
        np.testing.assert_allclose([s for _, s in ra], [s for _, s in rb],
                                   **TOL)


Q = [{"x": 0.7, "b": 1.0}, {"x": -0.7, "b": 1.0}, {"x": 0.1, "w": "tok3"}]


def test_sharded_matches_dense_lifecycle(mesh, jmesh, rng):
    dense = ClassifierDriver(CONF, dim_bits=12, device="cpu")
    shard = ClassifierDriver(CONF, dim_bits=12, mesh=mesh, device="cpu")
    jshard = JDriver(CONF, dim_bits=12, mesh=jmesh)
    # the state really lives in blocks, one a shard
    assert len(shard.state.w) == 8 and shard.state.w[0].shape == (8, 512)
    _train_all([dense, shard, jshard], rng)
    assert dense.get_labels() == shard.get_labels() == jshard.get_labels()
    _close(_scores(dense, Q), _scores(shard, Q))
    _close(_scores(jshard, Q), _scores(shard, Q))

    # label churn: grow past capacity (8) and delete; the layout sticks
    for d in (dense, shard, jshard):
        for i in range(10):
            d.set_label(f"extra{i}")
        d.delete_label("extra3")
    assert shard.capacity == dense.capacity == 16
    assert len(shard.state.w) == 8 and shard.state.w[3].shape == (16, 512)
    assert dense.get_labels().keys() == shard.get_labels().keys()
    _close(_scores(dense, Q), _scores(shard, Q))

    # the schema sync's row permute keeps the layout
    union = sorted(shard.get_labels()) + ["zz"]
    for d in (dense, shard, jshard):
        d.sync_schema(union)
    assert len(shard.state.dw) == 8
    _close(_scores(dense, Q), _scores(shard, Q))
    _close(_scores(jshard, Q), _scores(shard, Q))
    st = shard.get_status()
    assert st["shard.count"] == 8 and st["shard.rows"] == 16
    assert st["shard.bytes_in_use"] == jshard.get_status()[
        "shard.bytes_in_use"]

    # clear keeps the layout and zeroes the model
    shard.clear()
    assert len(shard.state.w) == 8 and shard.state.w[0].shape == (8, 512)
    assert shard.get_labels() == {}
    assert all(not b.any() for b in shard.state.dw)


def test_sharded_save_load_across_both_packages(mesh, jmesh, rng, tmp_path):
    """A sharded port model file loads into flat and sharded drivers of
    both packages; a sharded JAX model file into the port's sharded and
    flat drivers: tables bit for bit, scores within the tolerance."""
    shard = ClassifierDriver(CONF, dim_bits=12, mesh=mesh, device="cpu")
    jshard = JDriver(CONF, dim_bits=12, mesh=jmesh)
    _train_all([shard, jshard], rng, n=20)
    conf = json.dumps(CONF)
    port_file, jax_file = str(tmp_path / "p.jubatus"), str(tmp_path / "j")
    save_model(port_file, shard, config=conf)
    jsave_model(jax_file, jshard, config=conf)
    saved = shard.pack()
    assert saved["w"].shape == (8, 4096)           # the unsharded layout
    for path, source in ((port_file, shard), (jax_file, jshard)):
        want = source.pack()
        targets = [ClassifierDriver(CONF, dim_bits=12, device="cpu"),
                   ClassifierDriver(CONF, dim_bits=12, mesh=mesh,
                                    device="cpu"),
                   JDriver(CONF, dim_bits=12),
                   JDriver(CONF, dim_bits=12, mesh=jmesh)]
        for t in targets:
            (jload_model if isinstance(t, JDriver) else load_model)(
                path, t, expected_config=conf)
            got = t.pack()
            for key in ("w", "prec", "label_counts"):
                assert np.array_equal(np.asarray(got[key]),
                                      np.asarray(want[key])), key
            _close(_scores(source, Q), _scores(t, Q))
        assert len(targets[1].state.w) == 8        # re-placed in blocks


def test_indivisible_dim_rejected_with_the_jax_message():
    mesh3 = ShardMesh(["cpu"] * 3)
    jmesh3 = Mesh(np.array(jax.devices()[:3]), axis_names=("shard",))
    for cls, jcls, err, conf in (
            (ClassifierDriver, JDriver, ClassifierConfigError, CONF),
            (RegressionDriver, JRegression, RegressionConfigError, RCONF)):
        with pytest.raises(err, match="not divisible") as got:
            cls(conf, dim_bits=4, mesh=mesh3, device="cpu")
        with pytest.raises(ValueError) as want:
            jcls(conf, dim_bits=4, mesh=jmesh3)
        assert str(got.value) == str(want.value)


def test_server_over_a_mesh(rng):
    """EngineServer on 4 logical shards: the full RPC stack on a sharded
    model, answering as a JAX server with --shard-devices 4 does."""
    srv = EngineServer("classifier", CONF, ServerArgs(engine="classifier"),
                       device="cpu", mesh=ShardMesh(["cpu"] * 4))
    jsrv = JEngineServer("classifier", CONF,
                         JServerArgs(engine="classifier", shard_devices=4))
    assert len(srv.driver.state.w) == 4
    ports = [srv.start(0), jsrv.start(0)]
    try:
        res = []
        for port in ports:
            with ClassifierClient("127.0.0.1", port, "sd") as c:
                assert c.train([["up", Datum({"x": 1.0})],
                                ["down", Datum({"x": -1.0})]]) == 2
                (r,) = c.classify([Datum({"x": 0.9})])
                assert max(r, key=lambda e: e[1])[0] == "up"
                res.append(sorted(r))
                (st,) = c.get_status().values()
                assert st["driver.shard.count"] == 4
        # the port server publishes the shard.* gauges on every status
        assert srv.trace.gauges()["shard.count"] == 4.0
        assert srv.trace.gauges()["shard.bytes_in_use"] == float(
            jsrv.driver.shard_stats()["bytes_in_use"])
        _close([res[0]], [res[1]])
    finally:
        srv.stop()
        jsrv.stop()


def test_regression_server_over_a_mesh(rng):
    """A regression server on 4 logical shards trains and estimates over
    RPC as a flat port server fed the same calls (bit for bit: the
    sharded scan is the flat scan on gathered columns)."""
    servers = [EngineServer("regression", RCONF,
                            ServerArgs(engine="regression"), device="cpu",
                            mesh=mesh) for mesh in (ShardMesh(["cpu"] * 4),
                                                    None)]
    rows = [[float(rng.normal()), Datum({"x": float(rng.normal()),
                                         "y": float(rng.normal())})]
            for _ in range(64)]
    try:
        got = []
        for srv in servers:
            with RegressionClient("127.0.0.1", srv.start(0), "sr") as c:
                for lo in range(0, 64, 16):
                    assert c.train(rows[lo:lo + 16]) == 16
                got.append(c.estimate([d for _, d in rows[:8]]))
        assert got[0] == got[1] or np.allclose(got[0], got[1], **TOL)
        assert np.array_equal(servers[0].driver.pack()["w"],
                              servers[1].driver.pack()["w"])
        assert servers[0].driver.get_status()["shard.count"] == 4
    finally:
        for srv in servers:
            srv.stop()


def test_shard_devices_flag_on_the_cpu_is_refused():
    """--shard-devices N needs N local devices; the CPU is one."""
    with pytest.raises(ValueError, match="--shard-devices 2 but only 1 "
                                         "local devices present"):
        EngineServer("regression", RCONF,
                     ServerArgs(engine="regression", shard_devices=2),
                     device="cpu")


@pytest.mark.parametrize("n_shards", (2, 8))
def test_sharded_regression_matches_dense(n_shards, rng):
    """The sharded train equals the dense port driver bit for bit (one
    train call per datum, and one batch of 30); estimates within the
    tolerance of the dense port's and the JAX package's sharded ones."""
    mesh = ShardMesh(["cpu"] * n_shards)
    jmesh = Mesh(np.asarray(jax.devices()[:n_shards]), ("shard",))
    dense = RegressionDriver(RCONF, dim_bits=12, device="cpu")
    shard = RegressionDriver(RCONF, dim_bits=12, mesh=mesh, device="cpu")
    jshard = JRegression(RCONF, dim_bits=12, mesh=jmesh)
    assert len(shard.state.w) == n_shards
    rows = []
    for _ in range(30):
        x = float(rng.uniform(-1, 1))
        rows.append((2.0 * x + 1.0, {"x": x, "b": 1.0, f"z{_ % 5}": 0.5}))
    for y, r in rows:
        dense.train([(y, Datum(r))])
        shard.train([(y, Datum(r))])
        jshard.train([(y, JDatum(r))])
    dense.train([(y, Datum(r)) for y, r in rows])
    shard.train([(y, Datum(r)) for y, r in rows])
    jshard.train([(y, JDatum(r)) for y, r in rows])
    assert np.array_equal(shard.pack()["w"], dense.pack()["w"])
    q = [{"x": 0.5, "b": 1.0}, {"x": -0.5, "b": 1.0, "z1": 0.5}]
    got = shard.estimate([Datum(r) for r in q])
    np.testing.assert_allclose(got, dense.estimate([Datum(r) for r in q]),
                               **TOL)
    np.testing.assert_allclose(got, jshard.estimate([JDatum(r) for r in q]),
                               **TOL)
    np.testing.assert_allclose(shard.pack()["w"],
                               np.asarray(jshard.pack()["w"]), **TOL)
    st = shard.get_status()
    assert st["shard.count"] == n_shards and st["shard.rows"] == 1
    assert st["shard.bytes_in_use"] == jshard.shard_stats()["bytes_in_use"]
    shard.clear()
    assert len(shard.state.w) == n_shards
    assert shard.estimate([Datum(r) for r in q]) == [0.0, 0.0]


def test_factory_routes_the_mesh_as_jax_does(mesh, jmesh):
    """create_driver hands the mesh (or the budget) to the linear engines
    of both packages; the layouts they build agree."""
    for engine, conf in (("classifier", {"method": "AROW"}),
                         ("classifier", {"method": "PA"}),
                         ("regression", {"method": "PA1"})):
        got = create_driver(engine, conf, device="cpu", mesh=mesh)
        want = jcreate(engine, conf, mesh=jmesh)
        assert type(got).__name__ == type(want).__name__
        assert got.shard_stats() == want.shard_stats()
        assert got.get_status()["shard.count"] == 8
        # a budget of the whole dim is one shard: no mesh in either
        got = create_driver(engine, conf, device="cpu",
                            shard_features=1 << 18)
        want = jcreate(engine, conf, shard_features=1 << 18)
        assert got.shard_stats() == want.shard_stats() == {}
        with pytest.raises(ValueError, match="needs 4 local devices, "
                                             "have 1"):
            create_driver(engine, conf, device="cpu", shard_features=1 << 16)


def _member(make, coord_dir, name, shards, conf=CONF, engine="classifier"):
    if make == "port":
        srv = EngineServer(engine, conf, ServerArgs(
            engine=engine, coordinator="(shared)", name=name,
            listen_addr="127.0.0.1", interval_sec=1e9,
            interval_count=1 << 30, microbatch_max=0), device="cpu",
            coord=FileCoordinator(coord_dir),
            mesh=ShardMesh(["cpu"] * shards) if shards else None)
    else:
        srv = JEngineServer(engine, conf, JServerArgs(
            engine=engine, coordinator="(shared)", name=name,
            listen_addr="127.0.0.1", interval_sec=1e9,
            interval_count=1 << 30, microbatch_max=0, shard_devices=shards),
            coord=JFileCoordinator(coord_dir))
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


def _fleet(members, coord_dir):
    """Members train disjoint halves, the first runs do_mix; returns every
    member's pack after the round."""
    srvs = [_member(make, coord_dir, "smix", shards)
            for make, shards in members]
    try:
        for srv, half in zip(srvs, _halves()):
            with ClassifierClient("127.0.0.1", srv.args.rpc_port,
                                  "smix") as c:
                assert c.train(half) == len(half)
        with ClassifierClient("127.0.0.1", srvs[0].args.rpc_port,
                              "smix") as c:
            assert c.do_mix() is True
        for s in srvs:
            (st,) = JClassifierClient(
                "127.0.0.1", s.args.rpc_port, "smix").get_status().values()
            assert st["mixer.model_version"] == 1
        return [s.driver.pack() for s in srvs]
    finally:
        for s in srvs:
            s.stop()


@pytest.mark.parametrize("members", [
    (("port", 4), ("port", 4)),
    (("jax", 4), ("port", 4)),
    (("port", 4), ("jax", 4)),
], ids=["port_port", "jax_master", "port_master"])
def test_sharded_members_mix_over_rpc(members, tmp_path):
    """Sharded members fold their per-shard chunks over the RPC linear
    mixer, with a sharded JAX member beside a sharded port member too:
    every member ends with the same model bit for bit, within the
    tolerance of a fleet of two unsharded JAX servers."""
    got = _fleet(members, str(tmp_path / "s"))
    ref = _fleet((("jax", 0), ("jax", 0)), str(tmp_path / "ref"))
    for pack in got:
        assert [x for x in pack["labels"] if x] == ["a", "b", "c"]
        for key in ("w", "prec", "label_counts"):
            assert np.array_equal(np.asarray(pack[key]),
                                  np.asarray(got[0][key])), key
            np.testing.assert_allclose(np.asarray(pack[key]),
                                       np.asarray(ref[0][key]), **TOL)


def _diff_pair(shards, jshards, rng):
    """A port and a JAX driver, sharded as asked, trained alike and
    schema-synced; returns (port, jax)."""
    mesh = ShardMesh(["cpu"] * shards) if shards else None
    jmesh = (Mesh(np.asarray(jax.devices()[:jshards]), ("shard",))
             if jshards else None)
    p = ClassifierDriver(CONF, dim_bits=12, mesh=mesh, device="cpu")
    j = JDriver(CONF, dim_bits=12, mesh=jmesh)
    _train_all([p, j], rng, n=24)
    for d in (p, j):
        d.sync_schema(["neg", "pos"])
    return p, j


def test_unsharded_members_apply_sharded_diffs(rng):
    """A sharded diff of either package, applied by an unsharded member of
    either package (chunks joined on the host) and by a sharded port
    member, gives the scores the sender holds after applying it."""
    port_sender, jax_sender = _diff_pair(4, 4, rng)
    for sender in (port_sender, jax_sender):
        diff = sender.get_mixables()["classifier"].get_diff()
        assert sm.is_chunked(diff["dw"]) and len(diff["dw"]) == 4
        receivers = list(_diff_pair(0, 0, rng)) + [_diff_pair(4, 0, rng)[0]]
        for r in receivers:
            r.get_mixables()["classifier"].put_diff(diff)
        sender.get_mixables()["classifier"].put_diff(diff)
        want = sender.pack()
        for r in receivers:
            np.testing.assert_allclose(np.asarray(r.pack()["w"]),
                                       np.asarray(want["w"]), **TOL)
    # a sharded member applies an unsharded peer's diff too
    flat = ClassifierDriver(CONF, dim_bits=12, device="cpu")
    shard = ClassifierDriver(CONF, dim_bits=12, device="cpu",
                             mesh=ShardMesh(["cpu"] * 4))
    _train_all([flat, shard], rng, n=24)
    diff = flat.get_mixables()["classifier"].get_diff()
    for d in (flat, shard):
        d.get_mixables()["classifier"].put_diff(diff)
    np.testing.assert_allclose(shard.pack()["w"], flat.pack()["w"], **TOL)
    assert not any(b.any() for b in shard.state.dw)


def test_regression_diff_chunks_cross_the_packages(rng):
    """Regression's chunked diffs: a sharded port diff applied by flat
    and sharded drivers of both packages, and the custom fold sums
    chunk dicts."""
    mesh = ShardMesh(["cpu"] * 4)
    jmesh = Mesh(np.asarray(jax.devices()[:4]), ("shard",))
    shard = RegressionDriver(RCONF, dim_bits=12, mesh=mesh, device="cpu")
    rows = [(float(rng.normal()), {"x": float(rng.normal()), "b": 1.0})
            for _ in range(20)]
    shard.train([(y, Datum(r)) for y, r in rows])
    mixable = shard.get_mixables()["regression"]
    diff = mixable.get_diff()
    assert sm.is_chunked(diff["dw"]) and len(diff["dw"]) == 4
    total = mixable.mix(diff, diff)
    np.testing.assert_array_equal(total["dw"]["c0"], 2 * diff["dw"]["c0"])
    receivers = [RegressionDriver(RCONF, dim_bits=12, device="cpu"),
                 JRegression(RCONF, dim_bits=12),
                 JRegression(RCONF, dim_bits=12, mesh=jmesh)]
    for r in receivers:
        r.get_mixables()["regression"].put_diff(dict(total))
    mixable.put_diff(dict(total))
    want = shard.pack()["w"]
    for r in receivers:
        assert np.array_equal(np.asarray(r.pack()["w"]), want)


def test_a_layout_mismatch_raises_the_jax_error(rng):
    """A diff chunked for 2 shards is refused by a 4-shard receiver of
    either package with the same message."""
    sender, _ = _diff_pair(2, 0, rng)
    diff = sender.get_mixables()["classifier"].get_diff()
    port4, jax4 = _diff_pair(4, 4, rng)
    with pytest.raises(ValueError, match="layout mismatch") as got:
        port4.get_mixables()["classifier"].put_diff(diff)
    with pytest.raises(ValueError) as want:
        jax4.get_mixables()["classifier"].put_diff(diff)
    assert str(got.value) == str(want.value)
