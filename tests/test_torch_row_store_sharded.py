"""The port's sharded row store (``jubatus_tpu_torch/parallel/
row_store.py``) against the JAX package's on the same seeded rows.

Mirrors ``tests/test_row_store_sharded.py``: CHT-stable placement, arena
growth and eviction, the shared pack format (flat and sharded, either
package, any shard count), per-shard diffs, the sharded top-k through the
backend, rows put by the migration plane landing in their owning shard and
``serve_range`` walking shards without touching a device table. The slot
layout is compared exactly with the JAX package's (placement is a function
of the ids and their order); answers as in test_torch_sharded_knn.py
(lsh distances exactly, ids where not tied).
"""

from __future__ import annotations

import numpy as np
import pytest

from jubatus_tpu.core.row_store import RowStore as JRowStore
from jubatus_tpu.parallel.row_store import ShardedRowStore as JShardedRowStore
from jubatus_tpu_torch.coord.base import NodeInfo
from jubatus_tpu_torch.coord.cht import CHT, shard_for
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.core.row_store import RowStore
from jubatus_tpu_torch.models._nn_backend import NNBackend
from jubatus_tpu_torch.parallel.mesh import ShardMesh
from jubatus_tpu_torch.parallel.row_store import ShardedRowStore

DIM = 1 << 10


def _vec(rng, nnz=6):
    idx = rng.integers(1, DIM, size=nnz)
    val = rng.normal(size=nnz)
    return [(int(i), float(v)) for i, v in zip(idx, val)]


def _same_layout(t, j):
    assert t.slots == j.slots and t.cap_per_shard == j.cap_per_shard
    assert t.ids == j.ids and t.width == j.width
    np.testing.assert_array_equal(t.idx, j.idx)
    np.testing.assert_array_equal(t.val, j.val)
    np.testing.assert_array_equal(t.live, j.live_mask())


# -- store semantics ---------------------------------------------------------

def test_placement_is_cht_stable(rng):
    s, js = ShardedRowStore(n_shards=4), JShardedRowStore(n_shards=4)
    for i in range(300):
        rid, v = f"row{i}", _vec(rng)
        s.set_row(rid, v)
        js.set_row(rid, v)
        shard, local = s.shard_slot(rid)
        assert shard == shard_for(rid, 4)
        assert 0 <= local < s.cap_per_shard
        assert s.slots[rid] == shard * s.cap_per_shard + local
    assert sum(s.rows_per_shard()) == 300
    assert s.rows_per_shard() == js.rows_per_shard()
    _same_layout(s, js)


def test_growth_preserves_rows_and_shards(rng):
    s = ShardedRowStore(n_shards=3, capacity_per_shard=4)
    js = JShardedRowStore(n_shards=3, capacity_per_shard=4)
    vecs = {f"r{i}": _vec(rng, nnz=int(rng.integers(1, 20)))
            for i in range(200)}                    # many doublings
    for rid, v in vecs.items():
        s.set_row(rid, v)
        js.set_row(rid, v)
    assert s.cap_per_shard > 4
    for rid, v in vecs.items():
        got = s.get_row(rid)
        assert [i for i, _ in got] == [i for i, _ in v]
        np.testing.assert_allclose([x for _, x in got], [x for _, x in v],
                                   rtol=1e-6)       # float32 round trip
        assert s.shard_slot(rid)[0] == shard_for(rid, 3)
    assert s.live_mask().sum() == 200 and len(s.live) == s.capacity
    _same_layout(s, js)


def test_remove_reuses_slots_and_lru_eviction(rng):
    s, js = ShardedRowStore(n_shards=2, max_size=10), \
        JShardedRowStore(n_shards=2, max_size=10)
    for st in (s, js):
        r2 = np.random.default_rng(7)
        for i in range(10):
            st.set_row(f"r{i}", _vec(r2))
        st.touch("r0")                  # r1 becomes the LRU victim
        st.set_row("r10", _vec(r2))
        assert len(st) == 10 and "r1" not in st and "r0" in st
        cap_before = st.capacity
        st.remove_row("r2")
        st.set_row("r11", _vec(r2))
        assert st.capacity == cap_before   # freed slots are reused
    _same_layout(s, js)


def test_place_all_equals_set_row_in_order(rng):
    """The bulk fill a mesh attach uses gives the state of one set_row a
    row in the same order (slots, arenas, LRU clock, trackers)."""
    flat = RowStore(keep_datum=True)
    for i in range(500):
        v = _vec(rng, nnz=int(rng.integers(1, 12)))
        if i % 7 == 0:
            v.append((3, 0.0))          # a zero entry: dropped either way
        flat.set_row(f"r{i}", v, datum=f"d{i}" if i % 3 else None)
    ids = flat.all_ids()
    slots = np.asarray([flat.slots[r] for r in ids])
    bulk = ShardedRowStore(n_shards=4, keep_datum=True)
    bulk.place_all(ids, flat.idx[slots], flat.val[slots],
                   [flat.datums.get(r) for r in ids])
    seq = ShardedRowStore(n_shards=4, keep_datum=True)
    for rid in ids:
        seq.set_row(rid, flat.get_row(rid), datum=flat.datums.get(rid))
    assert bulk.slots == seq.slots and bulk.ids == seq.ids
    assert bulk.cap_per_shard == seq.cap_per_shard
    assert bulk.width == seq.width
    np.testing.assert_array_equal(bulk.idx, seq.idx)
    np.testing.assert_array_equal(bulk.val, seq.val)
    np.testing.assert_array_equal(bulk.live, seq.live)
    assert bulk._touch == seq._touch and bulk._clock == seq._clock
    assert bulk._fill == seq._fill and bulk.datums == seq.datums
    assert bulk.updated_since_mix == seq.updated_since_mix
    with pytest.raises(ValueError, match="empty store"):
        bulk.place_all(ids[:1], flat.idx[:1], flat.val[:1])


def test_flat_parity_and_pack_interchange(rng):
    """Flat and sharded stores of both packages interchange checkpoints;
    a 4-shard pack re-places into a 2-shard store."""
    flat, sh4 = RowStore(), ShardedRowStore(n_shards=4)
    vecs = {f"r{i}": _vec(rng) for i in range(64)}
    for rid, v in vecs.items():
        flat.set_row(rid, v)
        sh4.set_row(rid, v)
    assert sorted(flat.all_ids()) == sorted(sh4.all_ids())
    p = sh4.pack()
    assert p == flat.pack()
    sh2, jsh2 = ShardedRowStore(n_shards=2), JShardedRowStore(n_shards=2)
    sh2.unpack(p)
    jsh2.unpack(p)
    _same_layout(sh2, jsh2)
    for rid, v in vecs.items():
        got = sh2.get_row(rid)
        assert [i for i, _ in got] == [i for i, _ in v]
        assert sh2.shard_slot(rid)[0] == shard_for(rid, 2)
    back, jback = RowStore(), JRowStore()
    back.unpack(p)
    jback.unpack(sh2.pack())
    assert sorted(back.all_ids()) == sorted(jback.all_ids()) == \
        sorted(flat.all_ids())
    assert JShardedRowStore(n_shards=3).pack().keys() == \
        ShardedRowStore(n_shards=3).pack().keys()


def test_per_shard_update_diffs(rng):
    s = ShardedRowStore(n_shards=4)
    for i in range(40):
        s.set_row(f"r{i}", _vec(rng))
    per = s.pop_update_diff_sharded()
    assert len(per) == 4 and sum(len(d) for d in per) == 40
    for k, d in enumerate(per):
        assert all(shard_for(rid, 4) == k for rid in d)
    assert not s.updated_since_mix
    s.apply_update_diff({"rx": ([1, 2], [0.5, 0.5], None)})
    assert s.pop_update_diff() == {}


def test_device_view_is_cached_per_version(rng):
    s = ShardedRowStore(n_shards=2)
    for i in range(10):
        s.set_row(f"r{i}", _vec(rng))
    idx, val, live = s.device_view("cpu")
    assert s.device_view("cpu")[0] is idx
    np.testing.assert_array_equal(live.numpy(), s.live)
    s.remove_row("r3")
    assert s.device_view("cpu")[0] is not idx


# -- sharded top-k via the backend -------------------------------------------

@pytest.mark.parametrize("n_shards", (2, 3, 8))
def test_backend_topk_matches_dense(n_shards, rng):
    dense = NNBackend("lsh", dim=DIM, hash_num=64, device="cpu")
    shard = NNBackend("lsh", dim=DIM, hash_num=64, device="cpu")
    shard.attach_mesh(ShardMesh(["cpu"] * n_shards))
    assert isinstance(shard.store, ShardedRowStore)
    for i in range(120):
        v = _vec(rng)
        dense.set_row(f"r{i}", v)
        shard.set_row(f"r{i}", v)
    q = _vec(rng)
    want = dense.neighbors(q, 9)
    got = shard.neighbors(q, 9)
    assert [d for _, d in got] == [d for _, d in want]
    true_d = dict(dense.neighbors(q, 120))
    assert all(true_d[rid] == d for rid, d in got)
    assert shard.last_topk_ms is not None and shard.last_topk_ms > 0
    st = shard.shard_stats()
    assert st["count"] == n_shards and st["rows"] == 120
    assert st["topk_merge_ms"] == round(shard.last_topk_ms, 3)


def test_sharded_growth_keeps_signatures_aligned(rng):
    """Rows signed before the sharded store grows keep their signatures
    when their shard's slot range moves (ROADMAP C5: the JAX package pads
    the table at its end instead)."""
    dense = NNBackend("lsh", dim=DIM, hash_num=64, device="cpu")
    shard = NNBackend("lsh", dim=DIM, hash_num=64, device="cpu")
    shard.attach_mesh(ShardMesh(["cpu"] * 4))
    for lo, hi in ((0, 100), (100, 700)):
        for i in range(lo, hi):
            v = _vec(rng)
            dense.set_row(f"r{i}", v)
            shard.set_row(f"r{i}", v)
        q = _vec(rng)
        dd, sd = dense.distances(q), shard.distances(q)
        for rid, slot in dense.store.slots.items():
            assert sd[shard.store.slots[rid]] == dd[slot]
        assert [d for _, d in shard.neighbors(q, 7)] == \
            [d for _, d in dense.neighbors(q, 7)]


def test_merge_topk_matches_flat_selection(rng):
    """Distinct scores: the tree merge picks exactly the flat top-k,
    non-power-of-two shard counts included."""
    import torch

    from jubatus_tpu_torch.parallel.sharded_knn import merge_topk

    for s_count in (2, 3, 5, 8):
        scores = rng.permutation(s_count * 4 * 7).reshape(
            s_count, 4, 7).astype(np.float32)
        ids = np.arange(s_count * 4 * 7).reshape(s_count, 4, 7)
        got_s, got_i = merge_topk(torch.from_numpy(scores),
                                  torch.from_numpy(ids), 5)
        flat_s = scores.transpose(1, 0, 2).reshape(4, -1)
        flat_i = ids.transpose(1, 0, 2).reshape(4, -1)
        order = np.argsort(-flat_s, axis=1)[:, :5]
        np.testing.assert_array_equal(got_s.numpy(),
                                      np.take_along_axis(flat_s, order, 1))
        np.testing.assert_array_equal(got_i.numpy(),
                                      np.take_along_axis(flat_i, order, 1))


# -- migration plane ---------------------------------------------------------

def _nn_driver(mesh=None):
    from jubatus_tpu_torch.server.factory import create_driver

    cfg = {"method": "lsh", "parameter": {"hash_num": 64},
           "converter": {"num_rules": [{"key": "*", "type": "num"}]}}
    return create_driver("nearest_neighbor", cfg, device="cpu", mesh=mesh)


def test_migrated_rows_land_in_owning_shard_and_skip_next_diff(rng):
    drv = _nn_driver(mesh=ShardMesh(["cpu"] * 4))
    store = drv.backend.store
    assert isinstance(store, ShardedRowStore)
    rows = [[f"m{i}", [int(j) for j in rng.integers(1, DIM, size=5)],
             [float(v) for v in rng.normal(size=5)], None]
            for i in range(24)]
    assert drv.put_rows(rows) == 24
    for row in rows:
        assert store.shard_slot(row[0])[0] == shard_for(row[0], 4)
    assert drv.get_mixables()["rows"].get_diff() == {}
    drv.set_row("local1", Datum({"f0": 1.0}))
    assert set(drv.get_mixables()["rows"].get_diff()) == {"local1"}
    assert drv.get_status()["shard.count"] == 4


def test_serve_range_walks_shards_without_device_table(rng):
    from jubatus_tpu_torch.framework.migration import (row_owned_by,
                                                       serve_range)

    drv = _nn_driver(mesh=ShardMesh(["cpu"] * 4))
    for i in range(60):
        drv.set_row(f"r{i:03d}", Datum(
            {f"f{j}": float(v) for j, v in enumerate(rng.normal(size=5))}))
    store = drv.backend.store

    def boom(*a, **k):
        raise AssertionError("serve_range touched the device table")

    store.device_view = boom
    drv.backend._mesh_view = boom
    drv.backend.sig_table = boom
    members = [NodeInfo("10.0.0.1", 9199), NodeInfo("10.0.0.2", 9199)]
    ring = CHT(members, epoch=1)
    target = members[0].name
    got, cursor, rounds = [], "", 0
    while True:
        doc = serve_range(drv, ring, target, cursor, limit_bytes=512)
        got.extend(doc["rows"])
        rounds += 1
        if doc["done"]:
            break
        cursor = doc["cursor"]
    assert rounds > 1
    ids = [r[0] for r in got]
    assert ids == sorted(ids)
    assert ids == [rid for rid in sorted(store.all_ids())
                   if row_owned_by(ring, rid, target)]


def test_shard_ids_covers_all_rows(rng):
    s = ShardedRowStore(n_shards=4)
    for i in range(50):
        s.set_row(f"q{i}", _vec(rng))
    seen = []
    for k in range(4):
        ids = s.shard_ids(k)
        assert all(shard_for(rid, 4) == k for rid in ids)
        seen.extend(ids)
    assert sorted(seen) == sorted(s.all_ids())
