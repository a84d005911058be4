"""The port's feature-sharded linear model state
(jubatus_tpu_torch/parallel/sharded_model.py) against the JAX package's
(jubatus_tpu/parallel/sharded_model.py), on the CPU.

Mirrors tests/test_sharded_model.py: the port runs on
``ShardMesh(["cpu"] * S)`` (logical shards), the JAX package on the
conftest's virtual CPU devices, both fed the same seeded numpy batches.

Tolerances: the classifier's sharded train and scores within the JAX
test's own rtol = atol = 3e-5 of the JAX package's sharded ops (the K-sums
and the cross-shard sums add in another order than XLA's). The port's
sharded regression scan equals the port's flat scan bit for bit (the same
values scanned in the same order), and is within 3e-5 of the JAX
package's sharded scan, whose per-step psum reorders each prediction's
sum. The sequential mode and the uniform-schema plans run the flat ops on
gathered columns, so they equal the flat port driver bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from jubatus_tpu.ops import classifier as jcops
from jubatus_tpu.ops import regression as jrops
from jubatus_tpu.parallel import sharded_model as jsm
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.ops import classifier as cops
from jubatus_tpu_torch.ops import regression as rops
from jubatus_tpu_torch.parallel import sharded_model as sm
from jubatus_tpu_torch.parallel.mesh import ShardMesh

D, L, B, K = 512, 4, 48, 8
SHARD_COUNTS = (2, 4, 8)
TOL = dict(rtol=3e-5, atol=3e-5)


def _mesh(n):
    return ShardMesh(["cpu"] * n)


def _jmesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("shard",))


def _batch(rng, b=B, k=K, dim=D):
    idx = rng.integers(0, dim, (b, k)).astype(np.int32)
    val = rng.normal(size=(b, k)).astype(np.float32)
    labels = rng.integers(0, 3, b).astype(np.int32)
    mask = np.zeros(L, bool)
    mask[:3] = True
    return idx, val, labels, mask


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _joined(leaf):
    """A state leaf as one host array (blocks joined along the columns)."""
    if sm.is_blocks(leaf):
        return torch.cat(leaf, dim=-1).numpy()
    return leaf.numpy()


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
@pytest.mark.parametrize("method", ("AROW", "PA1", "CW"))
def test_train_and_scores_parity(method, n_shards, rng):
    conf = method in cops.CONFIDENCE_METHODS
    mesh, jmesh = _mesh(n_shards), _jmesh(n_shards)
    st = sm.place_state(mesh, cops.init_state(L, D, conf, device="cpu"), D)
    jst = jsm.place_state(jmesh, jcops.init_state(L, D, conf), D)
    # two consecutive batches: the second trains against the first's
    # diffs, so a divergence would compound
    for _ in range(2):
        batch = _batch(rng)
        st = sm.train_batch(mesh, st, *_t(*batch), 1.0, method=method)
        jst = jsm.train_batch(jmesh, jst, *_j(*batch), 1.0, method=method)
    for name, a, b in zip(("w", "dw", "prec", "dprec"), st, jst):
        np.testing.assert_allclose(_joined(a), np.asarray(b), err_msg=name,
                                   **TOL)
    qi, qv, _, mask = _batch(rng)
    got = sm.scores(mesh, st, *_t(qi, qv, mask))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jsm.scores(jmesh, jst, *_j(qi, qv, mask))),
        **TOL)
    assert (got[:, 3] == -1e30).all()          # the dead label


@pytest.mark.parametrize("method", ("AROW", "PA1", "CW"))
def test_sharded_train_tracks_the_flat_port_train(method, rng):
    """4 logical shards against the flat port step on the same batches:
    the same arithmetic but for the order of the cross-shard sums."""
    conf = method in cops.CONFIDENCE_METHODS
    mesh = _mesh(4)
    flat = cops.init_state(L, D, conf, device="cpu")
    st = sm.place_state(mesh, cops.init_state(L, D, conf, device="cpu"), D)
    for _ in range(2):
        batch = _t(*_batch(rng))
        flat = cops.train_batch(flat, *batch, 1.0, method=method)
        st = sm.train_batch(mesh, st, *batch, 1.0, method=method)
    for a, b in zip(st, flat):
        np.testing.assert_allclose(_joined(a), b.numpy(), **TOL)


def test_rival_ties_pick_the_first_label_as_jax_does(rng):
    """Rows 1 and 2 hold the same weights, so every example of label 0
    sees two rivals with equal scores: the reduced sums stay equal and
    decide_updates' argmax picks row 1, as jnp.argmax does."""
    mesh, jmesh = _mesh(4), _jmesh(4)
    w = np.zeros((L, D), np.float32)
    w[1] = w[2] = rng.normal(size=D).astype(np.float32)
    idx, val, _, mask = _batch(rng)
    labels = np.zeros(B, np.int32)
    st = sm.place_state(mesh, cops.ClassifierState(
        *_t(w, np.zeros_like(w), np.ones((L, D), np.float32),
            np.zeros((L, D), np.float32))), D)
    jst = jsm.place_state(jmesh, jcops.ClassifierState(
        *_j(w, np.zeros_like(w), np.ones((L, D), np.float32),
            np.zeros((L, D), np.float32))), D)
    st = sm.train_batch(mesh, st, *_t(idx, val, labels, mask), 1.0,
                        method="AROW")
    jst = jsm.train_batch(jmesh, jst, *_j(idx, val, labels, mask), 1.0,
                          method="AROW")
    dw = _joined(st.dw)
    assert np.abs(dw[1]).max() > 0 and not dw[2].any()
    np.testing.assert_allclose(dw, np.asarray(jst.dw), **TOL)


def test_per_device_footprint_is_sliced():
    """Each shard holds exactly D/S columns of every feature-spanning
    leaf, on its own device; the placeholders stay whole."""
    mesh = ShardMesh(["cpu"] * 4)
    st = sm.place_state(mesh, cops.init_state(L, D, True, device="cpu"), D)
    for leaf in st:
        assert len(leaf) == 4
        for blk, dev in zip(leaf, mesh.devices):
            assert blk.shape == (L, D // 4) and blk.device == dev
            assert blk.is_contiguous()
    st = sm.place_state(mesh, cops.init_state(L, D, False, device="cpu"), D)
    assert st.prec.shape == (1, 1) and not sm.is_blocks(st.dprec)
    assert sm.nbytes(st) == 2 * L * D * 4 + 2 * 4


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
@pytest.mark.parametrize("method", ("PA", "PA1", "PA2"))
def test_regression_parity(method, n_shards, rng):
    """The sharded scan equals the flat port scan bit for bit, and the JAX
    package's sharded scan within 3e-5; estimates alike."""
    mesh, jmesh = _mesh(n_shards), _jmesh(n_shards)
    idx = rng.integers(0, D, (24, K)).astype(np.int32)
    idx[3, :3] = idx[3, 4]                      # duplicates within a row
    val = rng.normal(size=(24, K)).astype(np.float32)
    tgt = rng.normal(size=24).astype(np.float32)
    flat = rops.train_batch(rops.init_state(D, device="cpu"),
                            *_t(idx, val, tgt), 0.1, 1.0, method=method)
    st = sm.place_state(mesh, rops.init_state(D, device="cpu"), D)
    st = sm.regression_train_batch(mesh, st, idx, val, tgt, 0.1, 1.0,
                                   method=method)
    assert np.array_equal(_joined(st.dw), flat.dw.numpy())
    assert np.array_equal(_joined(st.w), flat.w.numpy())
    jst = jsm.place_state(jmesh, jrops.init_state(D), D)
    jst = jsm.regression_train_batch(jmesh, jst, *_j(idx, val, tgt), 0.1,
                                     1.0, method=method)
    np.testing.assert_allclose(_joined(st.dw), np.asarray(jst.dw), **TOL)
    np.testing.assert_allclose(
        sm.regression_estimate(mesh, st, *_t(idx, val)).numpy(),
        np.asarray(jsm.regression_estimate(jmesh, jst, *_j(idx, val))),
        **TOL)


def test_gather_and_scatter_columns_follow_the_owners(rng):
    mesh = _mesh(4)
    full = torch.from_numpy(rng.normal(size=(3, D)).astype(np.float32))
    blocks = sm.split_columns(mesh, full)
    uniq = np.unique(rng.integers(0, D, 40))
    got = sm.gather_columns(blocks, uniq)
    assert np.array_equal(got.numpy(), full.numpy()[:, uniq])
    new = torch.from_numpy(rng.normal(size=(3, len(uniq))).astype(np.float32))
    sm.scatter_columns(blocks, uniq, new)
    want = full.numpy().copy()
    want[:, uniq] = new.numpy()
    assert np.array_equal(torch.cat(blocks, -1).numpy(), want)
    # keys all in one shard, and none
    plan = sm.ColumnPlan(blocks, np.array([D - 2, D - 1]))
    assert [k.numel() for k in plan.keys] == [0, 0, 0, 2]
    assert sm.gather_columns(blocks, np.array([], np.int64)).shape == (3, 0)


def test_chunk_roundtrip_and_layout_validation(rng):
    mesh, jmesh = _mesh(4), _jmesh(4)
    st = sm.place_state(mesh, cops.init_state(L, D, True, device="cpu"), D)
    st = sm.train_batch(mesh, st, *_t(*_batch(rng)), 1.0, method="AROW")
    chunks = sm.shard_chunks(st.dw)
    assert set(chunks) == {f"c{i * (D // 4)}" for i in range(4)}
    assert all(c.shape == (L, D // 4) for c in chunks.values())
    assert sm.is_chunked(chunks) and not sm.is_chunked({"x": 1}) \
        and not sm.is_chunked(np.zeros(3)) and not sm.is_chunked({})
    # the chunks are copies: a later train does not move them
    before = {k: v.copy() for k, v in chunks.items()}
    sm.train_batch(mesh, st, *_t(*_batch(rng)), 1.0, method="AROW")
    assert all(np.array_equal(before[k], chunks[k]) for k in chunks)
    back = sm.assemble_chunks(chunks, mesh)
    assert np.array_equal(torch.cat(back, -1).numpy(),
                          np.concatenate([chunks[f"c{i * (D // 4)}"]
                                          for i in range(4)], -1))
    # keys as bytes (msgpack without raw=False) work alike
    as_bytes = {k.encode(): v for k, v in chunks.items()}
    assert sm.is_chunked(as_bytes)
    assert np.array_equal(sm.concat_chunks(as_bytes),
                          torch.cat(back, -1).numpy())
    trimmed = sm.shard_chunks(st.dw, rows=2)
    assert all(c.shape == (2, D // 4) for c in trimmed.values())
    # a peer with another layout is refused with the JAX package's errors
    jchunks = jsm.shard_chunks(jsm.place_state(
        jmesh, jcops.init_state(L, D, True), D).dw)
    assert set(jchunks) == set(chunks)
    for bad in ({k: v for k, v in chunks.items() if k != f"c{D // 4}"},
                dict(chunks, **{f"c{D // 4}": chunks[f"c{D // 4}"][:, 1:],
                                f"c{D // 2}": chunks[f"c{D // 2}"]}),
                {f"c{i * 8}": chunks["c0"][:, :8] for i in range(3)}
                | {"c32": chunks["c0"][:, :8]}):
        with pytest.raises(ValueError, match="layout mismatch") as got:
            sm.assemble_chunks(bad, mesh)
        with pytest.raises(ValueError) as want:
            jsm.assemble_chunks(bad, jsm.chunk_sharding(jmesh, rank=2))
        assert str(got.value) == str(want.value)


def test_put_diff_equals_the_flat_put_diff(rng):
    """The sharded apply is the flat apply element for element."""
    mesh = _mesh(4)
    flat = cops.init_state(L, D, True, device="cpu")
    flat = cops.train_batch(flat, *_t(*_batch(rng)), 1.0, method="AROW")
    st = sm.place_state(mesh, cops.ClassifierState(
        *(a.clone() for a in flat)), D)
    diff = {"dw": rng.normal(size=(2, D)).astype(np.float32),
            "dprec": rng.random(size=(2, D)).astype(np.float32),
            "count": 3.0}
    cops.put_diff(flat, diff)
    sm.put_diff(st, dict(diff, dw=sm.split_columns(mesh, _t(diff["dw"])[0]),
                         dprec=sm.split_columns(mesh,
                                                _t(diff["dprec"])[0])))
    for a, b in zip(st, flat):
        assert np.array_equal(_joined(a), b.numpy())


def test_mesh_for_features():
    from jubatus_tpu_torch.models.classifier import (ClassifierConfigError,
                                                     ClassifierDriver)

    assert sm.mesh_for_features(256, 256, device="cpu") is None
    for args in ((256, 100), (256, 0)):
        with pytest.raises(ValueError) as got:
            sm.mesh_for_features(*args, device="cpu")
        with pytest.raises(ValueError) as want:
            jsm.mesh_for_features(*args)
        assert str(got.value) == str(want.value)
    # the CPU is one local device: 16 shards of 256 need 16
    with pytest.raises(ValueError,
                       match="feature sharding needs 16 local devices, "
                             "have 1"):
        sm.mesh_for_features(256, 16, device="cpu")
    with pytest.raises(ValueError,
                       match="feature sharding needs 16 local devices, "
                             "have 8"):
        jsm.mesh_for_features(256, 16)
    with pytest.raises(ClassifierConfigError, match="needs 4 local devices"):
        ClassifierDriver(CONF, shard_features=1 << 16, device="cpu")
    # a budget of the whole dim is one shard: no mesh
    drv = ClassifierDriver(CONF, shard_features=1 << 18, device="cpu")
    assert drv._mesh is None and drv.shard_stats() == {}


CONF = {"method": "AROW", "parameter": {"regularization_weight": 1.0},
        "converter": {"num_rules": [{"key": "*", "type": "num"}]}}


def _row(rng):
    return {f"f{j}": float(v) for j, v in enumerate(rng.normal(size=8))}


def _datum(rng):
    return Datum(_row(rng))


def test_sequential_mode_under_a_mesh(rng):
    """train_mode="sequential" under a mesh runs the exact per-example
    loop on the batch's gathered columns: equal to the flat port driver
    bit for bit, and to the JAX package's sharded sequential driver
    within the tolerance."""
    from jubatus_tpu.core.datum import Datum as JDatum
    from jubatus_tpu.models.classifier import ClassifierDriver as JDriver
    from jubatus_tpu_torch.models.classifier import ClassifierDriver

    drv = ClassifierDriver(CONF, train_mode="sequential", mesh=_mesh(4),
                           device="cpu")
    ref = ClassifierDriver(CONF, train_mode="sequential", device="cpu")
    jdrv = JDriver(CONF, train_mode="sequential", mesh=_jmesh(4))
    rows = [("a" if i % 2 else "b", _row(rng)) for i in range(16)]
    data = [(lab, Datum(r)) for lab, r in rows]
    drv.train(data)
    ref.train(data)
    jdrv.train([(lab, JDatum(r)) for lab, r in rows])
    assert sm.is_blocks(drv.state.w) and len(drv.state.w) == 4
    got, want = drv.pack(), ref.pack()
    for key in ("w", "prec"):
        assert np.array_equal(got[key], want[key]), key
        np.testing.assert_allclose(got[key], np.asarray(jdrv.pack()[key]),
                                   **TOL)
    q = [_datum(rng) for _ in range(4)]
    assert drv.classify(q) == ref.classify(q)


def test_schema_plans_under_a_mesh(rng):
    """The uniform-schema and combo plans on the gathered columns equal
    the flat port driver's bit for bit (no duplicate index in uidx)."""
    from jubatus_tpu_torch.models.classifier import ClassifierDriver

    drv = ClassifierDriver(CONF, dim_bits=10, mesh=_mesh(4), device="cpu")
    ref = ClassifierDriver(CONF, dim_bits=10, device="cpu")
    uidx = np.array([1000, 3, 700, 260, 511], np.int32)
    k0 = 3
    a_idx, b_idx = np.array([0, 1], np.int32), np.array([2, 2], np.int32)
    mul = np.array([True, False])
    for _ in range(2):
        val = rng.normal(size=(6, len(uidx))).astype(np.float32)
        lab = rng.integers(0, 2, 6).astype(np.int32)
        for d in (drv, ref):
            d.train_indexed_schema(["x", "y"], lab, uidx, val)
            d.train_indexed_combo(["x", "y"], lab, uidx, val[:, :k0],
                                  a_idx, b_idx, mul)
    for key in ("w", "prec"):
        assert np.array_equal(drv.pack()[key], ref.pack()[key]), key
    val = rng.normal(size=(3, len(uidx))).astype(np.float32)
    assert drv.classify_hashed_schema(uidx, val) == \
        ref.classify_hashed_schema(uidx, val)
    assert drv.classify_hashed_combo(uidx, val[:, :k0], a_idx, b_idx,
                                     mul) == \
        ref.classify_hashed_combo(uidx, val[:, :k0], a_idx, b_idx, mul)


def test_jubactl_renders_shard_layout():
    """status --all and the watch view render the shard layout from the
    shard.* gauges as the JAX package's jubactl does, for a row-sharded
    and a feature-sharded member."""
    from jubatus_tpu.cmd import jubactl as jctl
    from jubatus_tpu_torch.cmd import jubactl as ctl

    st = {"driver.shard.count": 8, "driver.shard.rows": 1200,
          "driver.shard.rows_per_shard": [150] * 8,
          "driver.shard.bytes_in_use": 256 * 2 ** 20,
          "driver.shard.topk_merge_ms": 12.5,
          "health.status": "ok"}
    st2 = {"driver.shard.count": 4,
           "driver.shard.bytes_in_use": 2048 * 2 ** 20,
           "health.status": "ok"}
    wide = dict(st, **{"driver.shard.rows_per_shard": list(range(10))})
    for doc in (st, st2, wide, {"health.status": "ok"}):
        assert ctl._fmt_shard_layout(doc) == jctl._fmt_shard_layout(doc)
    line = ctl._fmt_shard_layout(st)
    assert line.startswith("shards: 8 ×")
    assert "150/150" in line and "topk_merge 12.5 ms" in line
    assert "rows 0/1/2/3/4/5/6/7/…," in ctl._fmt_shard_layout(wide)
    assert "sh 8x1200r" in ctl._watch_node_row("n1", {"status": st},
                                              active=True)
    assert "sh 4x512MB" in ctl._watch_node_row("n2", {"status": st2},
                                              active=True)
    assert "sh 4x512MB" in jctl._watch_node_row("n2", {"status": st2},
                                               active=True)
    assert ctl._fmt_shard_layout({"health.status": "ok"}) == ""
    assert " sh " not in ctl._watch_node_row("n3", {"status": {}},
                                             active=True)
