"""Row-sharded serving through the port's NNBackend (``attach_mesh``)
against its flat path and against the JAX package's sharded backend.

Mirrors ``tests/test_mesh_nn_backend.py`` on ``ShardMesh(["cpu"] * 8)``
(the JAX side on the conftest's 8 virtual CPU devices). Tolerances: lsh /
minhash distances and LOF scores exactly equal (the scans are bit-exact,
and the store's slot layout is the JAX package's, so LOF's host sorts see
the same columns); ids equal except among rows tied at the k-th distance;
euclid_lsh within the JAX test's 2e-3 absolute (the batch expansion
against the direct single-query form) and LOF over euclid_lsh within
1e-4 relative.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from jubatus_tpu.models._nn_backend import NNBackend as JNNBackend
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.models._nn_backend import HASH_METHODS, NNBackend
from jubatus_tpu_torch.parallel.mesh import ShardMesh

DIM = 1 << 12


@pytest.fixture(scope="module")
def mesh():
    return ShardMesh(["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh():
    return Mesh(np.asarray(jax.devices()[:8]), axis_names=("shard",))


def _vec(rng, nnz=6):
    idx = rng.integers(1, DIM, size=nnz)
    val = rng.normal(size=nnz)
    return [(int(i), float(v)) for i, v in zip(idx, val)]


def _tied_below(got, want):
    """Distances equal; ids equal below the k-th distance."""
    assert [d for _, d in got] == [d for _, d in want]
    if want:
        edge = want[-1][1]
        assert {r for r, d in got if d < edge} == \
            {r for r, d in want if d < edge}


@pytest.mark.parametrize("method", HASH_METHODS)
def test_mesh_matches_dense(method, mesh, jmesh, rng):
    dense = NNBackend(method, dim=DIM, hash_num=64, device="cpu")
    sharded = NNBackend(method, dim=DIM, hash_num=64, device="cpu")
    jsharded = JNNBackend(method, dim=DIM, hash_num=64)
    for i in range(37):                  # odd count: the padding path
        v = _vec(rng)
        for b in (dense, sharded, jsharded):
            b.set_row(f"r{i}", v)
    sharded.attach_mesh(mesh)
    jsharded.attach_mesh(jmesh)
    q = _vec(rng)
    want, got, jgot = (dense.neighbors(q, 5), sharded.neighbors(q, 5),
                       jsharded.neighbors(q, 5))
    np.testing.assert_allclose([d for _, d in got], [d for _, d in want],
                               rtol=1e-5, atol=1e-6)
    true_d = dense.distances(q)
    for rid, d in got:
        np.testing.assert_allclose(d, true_d[dense.store.slots[rid]],
                                   rtol=1e-5, atol=1e-6)
    if method != "euclid_lsh":
        _tied_below(got, want)
        _tied_below(got, jgot)


def test_mesh_masks_removed_rows(mesh, rng):
    b = NNBackend("lsh", dim=DIM, hash_num=64, device="cpu")
    for i in range(16):
        b.set_row(f"r{i}", _vec(rng))
    b.attach_mesh(mesh)
    q = _vec(rng)
    first = b.neighbors(q, 3)[0][0]
    b.remove_row(first)
    after = [r for r, _ in b.neighbors(q, 16)]
    assert first not in after and len(after) == 15


def test_mesh_neighbors_batch_and_similar(mesh, rng):
    b = NNBackend("minhash", dim=DIM, hash_num=32, device="cpu")
    for i in range(24):
        b.set_row(f"r{i}", _vec(rng))
    b.attach_mesh(mesh)
    qs = [_vec(rng) for _ in range(5)]
    batch = b.neighbors_batch(qs, 4)
    assert len(batch) == 5
    for q, row in zip(qs, batch):
        assert row == b.neighbors(q, 4)
    sim = b.similar(qs[0], 4)
    assert [r for r, _ in sim] == [r for r, _ in batch[0]]


def test_mesh_rejects_exact_methods(mesh, jmesh):
    b = NNBackend("inverted_index", dim=DIM, device="cpu")
    with pytest.raises(ValueError, match="hash methods") as got:
        b.attach_mesh(mesh)
    with pytest.raises(ValueError) as want:
        JNNBackend("inverted_index", dim=DIM).attach_mesh(jmesh)
    assert str(got.value) == str(want.value)


def test_mesh_empty_store(mesh, rng):
    b = NNBackend("lsh", dim=DIM, hash_num=32, device="cpu")
    b.attach_mesh(mesh)
    assert b.neighbors(_vec(rng), 3) == []
    assert np.isinf(b.distances(_vec(rng))).all()


def test_driver_level_mesh(mesh):
    """The nearest_neighbor driver serving from a sharded table."""
    from jubatus_tpu_torch.models.nearest_neighbor import NearestNeighborDriver

    cfg = {"method": "lsh", "parameter": {"hash_num": 64},
           "converter": {"num_rules": [{"key": "*", "type": "num"}]}}
    d_dense = NearestNeighborDriver(cfg, dim_bits=12, device="cpu")
    d_mesh = NearestNeighborDriver(cfg, dim_bits=12, device="cpu")
    for i in range(20):
        dm = Datum({"x": float(i), "y": float(i % 7)})
        d_dense.set_row(f"row{i}", dm)
        d_mesh.set_row(f"row{i}", dm)
    d_mesh.backend.attach_mesh(mesh)
    q = Datum({"x": 3.2, "y": 3.0})
    got = d_mesh.neighbor_row_from_datum(q, 5)
    want = d_dense.neighbor_row_from_datum(q, 5)
    assert [d for _, d in got] == [d for _, d in want]
    want_by_id = dict(d_dense.neighbor_row_from_datum(q, 20))
    assert all(want_by_id[rid] == d for rid, d in got)
    st = d_mesh.get_status()
    assert st["shard.count"] == 8 and st["shard.rows"] == 20
    assert "shard.count" not in d_dense.get_status()


@pytest.mark.parametrize("method", HASH_METHODS)
def test_mesh_full_distances_match_dense(method, mesh, jmesh, rng):
    """sharded_distances (LOF's full-row path) reproduces the flat
    distances per ROW (aligned through each store's id → slot map), with
    the dead-slot +inf mask and the batched distances_from_slots; and the
    JAX package's sharded distances slot for slot."""
    dense = NNBackend(method, dim=DIM, hash_num=32, device="cpu")
    shard = NNBackend(method, dim=DIM, hash_num=32, device="cpu")
    jshard = JNNBackend(method, dim=DIM, hash_num=32)
    for i in range(21):
        v = _vec(rng)
        for b in (dense, shard, jshard):
            b.set_row(f"r{i}", v)
    shard.attach_mesh(mesh)
    jshard.attach_mesh(jmesh)
    for b in (dense, shard, jshard):
        b.remove_row("r7")
    atol = 2e-3 if method == "euclid_lsh" else 0.0
    q = _vec(rng)
    d_shard, d_dense = shard.distances(q), dense.distances(q)
    for rid, ds in dense.store.slots.items():
        np.testing.assert_allclose(d_shard[shard.store.slots[rid]],
                                   d_dense[ds], rtol=1e-4 if atol else 0,
                                   atol=atol)
    assert np.isinf(d_shard[~shard.store.live_mask()]).all()
    assert shard.store.slots == jshard.store.slots
    np.testing.assert_allclose(d_shard, jshard.distances(q),
                               rtol=1e-4 if atol else 0, atol=atol)
    rids = sorted(dense.store.slots)[:6]
    out_shard = shard.distances_from_slots(
        np.asarray([shard.store.slots[r] for r in rids]))
    out_dense = dense.distances_from_slots(
        np.asarray([dense.store.slots[r] for r in rids]))
    for rid2 in dense.store.slots:
        np.testing.assert_allclose(
            out_shard[:, shard.store.slots[rid2]],
            out_dense[:, dense.store.slots[rid2]],
            rtol=1e-4 if atol else 0, atol=atol)


@pytest.mark.parametrize("nn_method", ["euclid_lsh", "lsh"])
def test_anomaly_driver_sharded_lof(nn_method, mesh, jmesh, rng):
    """LOF on a row-sharded backend: over euclid_lsh it matches the flat
    driver (rtol 1e-4) and separates the outlier; over lsh its scores
    equal the JAX package's sharded driver's exactly."""
    from jubatus_tpu.core.datum import Datum as JDatum
    from jubatus_tpu.server.factory import create_driver as jcreate
    from jubatus_tpu_torch.server.factory import create_driver

    cfg = {"method": "lof",
           "parameter": {"nearest_neighbor_num": 5,
                         "reverse_nearest_neighbor_num": 10,
                         "method": nn_method,
                         "parameter": {"hash_num": 64}},
           "converter": {"num_rules": [{"key": "*", "type": "num"}]}}
    dense = create_driver("anomaly", cfg, device="cpu")
    shard = create_driver("anomaly", cfg, device="cpu", mesh=mesh)
    jshard = jcreate("anomaly", cfg, mesh=jmesh)
    for i in range(30):
        row = {"x": float(rng.normal(0, 0.1)), "y": float(rng.normal(0, 0.1))}
        dense.add(Datum(row))
        shard.add(Datum(row))
        jshard.add(JDatum(row))
    q_in, q_out = {"x": 0.02, "y": -0.03}, {"x": 6.0, "y": -6.0}
    for q in (q_in, q_out):
        got = shard.calc_score(Datum(q))
        if nn_method == "euclid_lsh":
            np.testing.assert_allclose(got, dense.calc_score(Datum(q)),
                                       rtol=1e-4)
        else:
            assert got == jshard.calc_score(JDatum(q))
    if nn_method == "euclid_lsh":
        assert shard.calc_score(Datum(q_out)) > shard.calc_score(Datum(q_in))


def _lof_by_id(driver, vecs):
    """LOF of ``vecs`` from the driver's backend distances, with ties
    between equal distances broken by row id (columns in id order, stable
    sorts): a layout-independent version of the driver's ``_support`` and
    ``_score``, whose unstable numpy sorts break ties by column."""
    be = driver.backend
    slots = np.asarray([be.store.slots[r] for r in sorted(be.store.slots)])
    n = len(slots)
    kk = min(driver.k, n - 1)
    d = np.asarray(be.distances_from_slots(slots))[:, slots]   # [n, n]
    d[np.arange(n), np.arange(n)] = np.inf
    nbr = np.argsort(d, axis=1, kind="stable")[:, :kk]
    kdist = np.take_along_axis(d, nbr[:, -1:], 1)[:, 0]
    denom = np.maximum(kdist[nbr], np.take_along_axis(d, nbr, 1)).sum(1)
    lrd = np.where(denom > 0, kk / np.maximum(denom, 1e-30), np.inf)
    k = min(driver.k, n)
    out = []
    for vec in vecs:
        dq = np.asarray(be.distances(vec))[slots]
        order = np.argsort(dq, kind="stable")[:k]
        lrd_q = k / np.maximum(kdist[order], dq[order]).sum()
        out.append(float(lrd[order].mean() / lrd_q))
    return out


def test_sharded_lof_ties_follow_columns(mesh, jmesh):
    """Why sharded LOF over lsh differs from flat LOF in both packages: the
    per-row distances are equal, and only the order of tied distances
    moves. Before any growth of the sharded store, the JAX package's
    sharded LOF differs from its flat LOF on the same rows; each port
    driver equals its JAX counterpart exactly; and with ties broken by
    row id the four drivers' scores are exactly equal."""
    from jubatus_tpu.core.datum import Datum as JDatum
    from jubatus_tpu.server.factory import create_driver as jcreate
    from jubatus_tpu_torch.server.factory import create_driver

    cfg = {"method": "lof",
           "parameter": {"nearest_neighbor_num": 5,
                         "reverse_nearest_neighbor_num": 10,
                         "method": "lsh", "parameter": {"hash_num": 64}},
           "converter": {"num_rules": [{"key": "*", "type": "num"}]}}
    flat = create_driver("anomaly", cfg, device="cpu")
    shard = create_driver("anomaly", cfg, device="cpu", mesh=mesh)
    jflat = jcreate("anomaly", cfg)
    jshard = jcreate("anomaly", cfg, mesh=jmesh)
    rng = np.random.default_rng(0)
    keys = ("x", "y", "z")
    rows = [{k: float(v) for k, v in zip(keys, rng.normal(0, 0.1, 3))}
            for _ in range(60)]
    for row in rows:
        for drv in (flat, shard):
            drv.add(Datum(row))
        for drv in (jflat, jshard):
            drv.add(JDatum(row))
    assert jshard.backend.store.capacity == 8 * 64       # no growth yet
    queries = [{k: float(v) for k, v in zip(keys, rng.normal(0, 0.1, 3))}
               for _ in range(10)]
    got = {name: [drv.calc_score(D(q)) for q in queries]
           for name, drv, D in (("flat", flat, Datum),
                                ("shard", shard, Datum),
                                ("jflat", jflat, JDatum),
                                ("jshard", jshard, JDatum))}
    assert got["flat"] == got["jflat"]
    assert got["shard"] == got["jshard"]
    assert got["jflat"] != got["jshard"]
    by_id = [_lof_by_id(drv, [drv.converter.convert(D(q)) for q in queries])
             for drv, D in ((flat, Datum), (shard, Datum),
                            (jflat, JDatum), (jshard, JDatum))]
    assert by_id[0] == by_id[1] == by_id[2] == by_id[3]


def test_create_driver_errors_match_jax(mesh, jmesh):
    """The factory's sharding and IVF errors are the JAX package's; both
    packages' factories hand a mesh to the feature-sharded linear engines
    and build the same layout."""
    from jubatus_tpu.server.factory import create_driver as jcreate
    from jubatus_tpu_torch.server.factory import create_driver

    cases = [
        ("stat", {"window_size": 8}, dict(shard_features=1024), {}),
        ("stat", {"window_size": 8}, dict(ann="ivf"), {}),
        ("stat", {"window_size": 8}, {}, {"mesh": True}),
        ("anomaly", {"method": "lof", "parameter": {"method": "euclid"}},
         {}, {"mesh": True}),
    ]
    for engine, conf, kw, m in cases:
        with pytest.raises(ValueError) as got:
            create_driver(engine, conf, device="cpu",
                          mesh=mesh if m else None, **kw)
        with pytest.raises(ValueError) as want:
            jcreate(engine, conf, mesh=jmesh if m else None, **kw)
        assert str(got.value) == str(want.value)
    for engine, conf in (("classifier", {"method": "AROW"}),
                         ("regression", {"method": "PA1"})):
        got = create_driver(engine, conf, device="cpu", mesh=mesh)
        want = jcreate(engine, conf, mesh=jmesh)
        assert type(got).__name__ == type(want).__name__
        assert got.shard_stats() == want.shard_stats()
        assert got.shard_stats()["count"] == 8
        # 2^18 / 1024 = 256 shards: more local devices than either has
        with pytest.raises(ValueError, match="feature sharding needs 256 "
                                             "local devices, have 1"):
            create_driver(engine, conf, device="cpu", shard_features=1024)
        with pytest.raises(ValueError, match="feature sharding needs 256 "
                                             "local devices, have 8"):
            jcreate(engine, conf, shard_features=1024)
    nn = create_driver("classifier", {"method": "NN", "parameter": {
        "method": "lsh", "nearest_neighbor_num": 3}}, device="cpu",
        mesh=mesh)
    assert nn.backend.store.n_shards == 8
    rec = create_driver("recommender", {"method": "inverted_index"},
                        device="cpu", ann="ivf", ann_cells=16, ann_nprobe=3)
    assert rec.ann_stats()["nprobe"] == 3 and rec.backend.ann_cells == 16
    # both packages return the classifier and regression before the --ann
    # check and ignore the flag there
    for engine, conf in (("classifier", {"method": "AROW"}),
                         ("classifier", {"method": "cosine"}),
                         ("regression", {"method": "PA1"})):
        got = create_driver(engine, conf, device="cpu", ann="ivf")
        want = jcreate(engine, conf, ann="ivf")
        assert type(got).__name__ == type(want).__name__
        backend = getattr(got, "backend", None)
        assert getattr(backend, "ann_mode", "off") == "off"


# -- the server flags ------------------------------------------------------------

_NN_CONF = ["nearest_neighbor", "-f", "config/nearest_neighbor/lsh.json"]


@pytest.mark.parametrize("extra", [
    ["--shard-devices", "-1"],
    ["--shard-features", "-1"],
    ["--shard-features", "64", "--shard-devices", "2"],
    ["--ann-cells", "-1"],
    ["--ann-nprobe", "0"],
    ["--ann", "ivf", "--ann-cells", "4", "--ann-nprobe", "8"],
])
def test_server_flag_validation_matches_jax(extra):
    from jubatus_tpu.server.args import parse_server_args as jparse
    from jubatus_tpu_torch.server.args import parse_server_args

    with pytest.raises(SystemExit) as got:
        parse_server_args(_NN_CONF + extra)
    with pytest.raises(SystemExit) as want:
        jparse(_NN_CONF + extra)
    assert str(got.value) == str(want.value) and str(got.value)


def test_server_flags_parse_and_reach_the_driver(mesh):
    from jubatus_tpu_torch.server import EngineServer
    from jubatus_tpu_torch.server.args import parse_server_args

    args = parse_server_args(_NN_CONF + [
        "--ann", "ivf", "--ann-cells", "16", "--ann-nprobe", "4",
        "--shard-devices", "1", "--device", "cpu"])
    assert (args.ann, args.ann_cells, args.ann_nprobe, args.shard_devices) \
        == ("ivf", 16, 4, 1)
    srv = EngineServer.from_args(args)
    be = srv.driver.backend
    assert be.ann_mode == "ivf" and be.ann_cells == 16 and be._mesh is None
    srv2 = EngineServer("nearest_neighbor", {"method": "minhash"},
                        device="cpu", mesh=mesh)
    assert srv2.driver.backend.store.n_shards == 8


def test_shard_devices_past_the_devices_fails_like_jax(tmp_path):
    """``--shard-devices 2`` with one device: the server main exits 1
    with the JAX server's message."""
    import os
    import subprocess
    import sys

    root = os.path.join(os.path.dirname(__file__), "..")
    proc = subprocess.run(
        [sys.executable, "-m", "jubatus_tpu_torch.server", *_NN_CONF,
         "--shard-devices", "2", "--device", "cpu", "-p", "0"],
        cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert "--shard-devices 2 but only 1 local devices present" in proc.stderr
