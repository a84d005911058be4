"""The port's nearest_neighbor driver against the JAX package's, on the CPU.

The same seeded datums go to a jubatus_tpu NearestNeighborDriver and to the
port's driver — fed directly, and rebuilt from the JAX driver's pack() via
jubatus_tpu_torch.convert — and all four query methods must answer the
same up to ties: distance lists equal (lsh, minhash exactly; euclid_lsh
within 1e-5), ids equal as sets below the k-th distance, and at the k-th
distance carrying it.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from jubatus_tpu.core.datum import Datum as JDatum
from jubatus_tpu.models.nearest_neighbor import NearestNeighborDriver as JDriver
from jubatus_tpu_torch import convert
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.models._nn_backend import NNBackend
from jubatus_tpu_torch.models.nearest_neighbor import NearestNeighborDriver

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "config",
                          "nearest_neighbor")
DIM_BITS = 12
K = 8


def _config(method: str, hash_num: int = 64) -> dict:
    with open(os.path.join(CONFIG_DIR, "lsh.json")) as f:
        conf = json.load(f)
    conf["method"] = method
    conf["parameter"] = {"hash_num": hash_num, "seed": 3}
    return conf


def _rows(n=300, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        d = {f"k{j}": float(np.round(rng.standard_normal(), 3))
             for j in rng.choice(40, 6, replace=False)}
        d["tag"] = f"t{int(rng.integers(10))}"
        rows.append((f"r{i}", d))
    return rows


def assert_same_ranking(got, want, tol=0.0):
    gd = np.array([d for _, d in got])
    wd = np.array([d for _, d in want])
    assert gd.shape == wd.shape
    np.testing.assert_allclose(gd, wd, atol=tol, rtol=tol)
    if not len(gd):
        return
    edge = wd[-1]
    below = lambda res, ds: {i for (i, _), d in zip(res, ds)  # noqa: E731
                             if d < edge - tol}
    assert below(got, gd) == below(want, wd)


def _queries(drv_pair, rows, method):
    jd, td = drv_pair
    tol = 1e-5 if method == "euclid_lsh" else 0.0
    rng = np.random.default_rng(1)
    for _ in range(6):
        q = {f"k{j}": float(rng.standard_normal()) for j in rng.choice(40, 5)}
        assert_same_ranking(td.neighbor_row_from_datum(Datum(q), K),
                            jd.neighbor_row_from_datum(JDatum(q), K), tol)
        assert_same_ranking(td.similar_row_from_datum(Datum(q), K),
                            jd.similar_row_from_datum(JDatum(q), K), tol)
        rid = rows[int(rng.integers(len(rows)))][0]
        assert_same_ranking(td.neighbor_row_from_id(rid, K),
                            jd.neighbor_row_from_id(rid, K), tol)
        assert_same_ranking(td.similar_row_from_id(rid, K),
                            jd.similar_row_from_id(rid, K), tol)
    assert sorted(td.get_all_rows()) == sorted(jd.get_all_rows())


@pytest.fixture(params=["lsh", "minhash", "euclid_lsh"])
def method(request):
    return request.param


def _jax_driver(method, rows, hash_num=64):
    jd = JDriver(_config(method, hash_num), dim_bits=DIM_BITS)
    for rid, d in rows:
        jd.set_row(rid, JDatum(d))
    return jd


def test_fed_directly_matches_jax(method):
    rows = _rows()
    jd = _jax_driver(method, rows)
    td = NearestNeighborDriver(_config(method), dim_bits=DIM_BITS, device="cpu")
    for rid, d in rows:
        assert td.set_row(rid, Datum(d))
    _queries((jd, td), rows, method)


@pytest.mark.parametrize("hash_num", [64, 128])
def test_from_jax_pack_matches_jax(method, hash_num):
    rows = _rows(seed=2)
    jd = _jax_driver(method, rows, hash_num)
    td = convert.from_jax_pack(jd.pack(), _config(method, hash_num),
                               device="cpu")
    assert td.backend.hash_num == hash_num
    _queries((jd, td), rows, method)


def test_pack_loads_back_into_jax(method):
    """A model packed by the port loads in the JAX package and answers the
    same."""
    rows = _rows(seed=4)
    td = NearestNeighborDriver(_config(method), dim_bits=DIM_BITS, device="cpu")
    for rid, d in rows:
        td.set_row(rid, Datum(d))
    jd = JDriver(_config(method), dim_bits=DIM_BITS)
    jd.unpack(td.pack())
    _queries((jd, td), rows, method)


def test_signature_tables_match_jax_bit_for_bit():
    rows = _rows(seed=5)
    for method in ("lsh", "minhash"):
        jd = _jax_driver(method, rows)
        td = convert.from_jax_pack(jd.pack(), _config(method), device="cpu")
        jd.backend._flush()
        want = jd.backend._sigs
        got = convert.sigs_to_numpy(td.backend.sig_table())
        slots_j = [jd.backend.store.slots[r] for r, _ in rows]
        slots_t = [td.backend.store.slots[r] for r, _ in rows]
        np.testing.assert_array_equal(got[slots_t], want[slots_j])


def test_sigs_from_numpy_keeps_bits():
    a = np.array([[0, 1, 0x80000000, 0xFFFFFFFF]], np.uint32)
    t = convert.sigs_from_numpy(a, device="cpu")
    assert t.dtype == torch.int32
    assert t.tolist() == [[0, 1, -(2**31), -1]]
    np.testing.assert_array_equal(convert.sigs_to_numpy(t), a)


def test_remove_clear_and_unknown_row():
    td = NearestNeighborDriver(_config("lsh"), dim_bits=DIM_BITS, device="cpu")
    for rid, d in _rows(20):
        td.set_row(rid, Datum(d))
    assert td.backend.remove_row("r3")
    res = td.neighbor_row_from_datum(Datum({"k1": 1.0}), 50)
    assert len(res) == 19 and "r3" not in {r for r, _ in res}
    with pytest.raises(KeyError):
        td.neighbor_row_from_id("r3", 3)
    td.clear()
    assert td.get_all_rows() == []
    assert td.neighbor_row_from_datum(Datum({"k1": 1.0}), 5) == []


def test_distances_from_slots_matches_single_queries():
    td = NearestNeighborDriver(_config("lsh"), dim_bits=DIM_BITS, device="cpu")
    for rid, d in _rows(70):
        td.set_row(rid, Datum(d))
    be = td.backend
    be.remove_row("r5")
    slots = np.array([be.store.slots[r] for r in ("r0", "r9", "r33")])
    batch = be.distances_from_slots(slots, chunk=2)
    for row, rid in zip(batch, ("r0", "r9", "r33")):
        np.testing.assert_array_equal(row, be.distances(be.store.get_row(rid)))
    assert np.isinf(batch[:, ~be.store.live]).all()


def test_unported_layouts_raise():
    """The sharded layout and the IVF tier are ported: they raise only
    the JAX package's own errors (an unknown ann mode; a mesh under an
    exact method), never NotYetPorted."""
    from jubatus_tpu_torch.parallel.mesh import ShardMesh

    be = NNBackend("lsh", dim=1 << DIM_BITS, device="cpu")
    be.configure_ann("ivf")
    be.attach_mesh(ShardMesh(["cpu"] * 2))
    assert be.ann_stats()["mode"] == "ivf" and be.store.n_shards == 2
    with pytest.raises(ValueError, match="unknown ann mode"):
        be.configure_ann("hnsw")
    exact = NNBackend("inverted_index", dim=1 << DIM_BITS, device="cpu")
    exact.configure_ann("ivf")
    assert exact.sig_table().shape == (exact.store.capacity, 64)
    with pytest.raises(ValueError, match="hash methods"):
        exact.attach_mesh(ShardMesh(["cpu"] * 2))


def test_backend_live_mask_is_cached_per_store_version():
    td = NearestNeighborDriver(_config("lsh"), dim_bits=DIM_BITS, device="cpu")
    for rid, d in _rows(10):
        td.set_row(rid, Datum(d))
    be = td.backend
    live = be._live_view()
    assert be._live_view() is live
    np.testing.assert_array_equal(live.numpy(), be.store.live)
    assert int(live.sum()) == 10
    be.remove_row("r2")
    live2 = be._live_view()
    assert live2 is not live and int(live2.sum()) == 9
    assert not bool(live2[be.store.capacity - 1])
    got = td.neighbor_row_from_datum(Datum(_rows(3)[2][1]), 10)
    assert len(got) == 9 and all(rid != "r2" for rid, _ in got)


def test_mix_diff_and_row_migration_between_port_drivers():
    rows = _rows(30)
    a = NearestNeighborDriver(_config("minhash"), dim_bits=DIM_BITS, device="cpu")
    b = NearestNeighborDriver(_config("minhash"), dim_bits=DIM_BITS, device="cpu")
    for rid, d in rows[:20]:
        a.set_row(rid, Datum(d))
    ma, mb = a.get_mixables()["rows"], b.get_mixables()["rows"]
    mb.put_diff(ma.mix({}, ma.get_diff()))
    assert sorted(b.get_all_rows()) == sorted(a.get_all_rows())
    assert ma.get_diff() == {}                   # the tracker was popped
    c = NearestNeighborDriver(_config("minhash"), dim_bits=DIM_BITS, device="cpu")
    assert c.put_rows(a.get_rows()) == 20
    assert c.backend.store.updated_since_mix == {}
    q = Datum(rows[25][1])
    assert_same_ranking(c.neighbor_row_from_datum(q, K),
                        a.neighbor_row_from_datum(q, K))
