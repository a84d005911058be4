"""The port's row-sharded scans (``jubatus_tpu_torch/parallel/
sharded_knn.py``, ``sharded_ivf.py``) against the JAX package's on the
same seeded inputs.

Mirrors ``tests/test_sharded_knn.py``. The JAX side runs on a ``Mesh`` of
the conftest's virtual CPU devices, the port on ``ShardMesh(["cpu"] *
S)``. Tolerances: lsh / minhash distances exactly equal (the scans are
bit-exact); ids equal where no other row ties at the same distance (the
per-shard top-k over a block may order equal distances either way);
``merge_topk`` exactly equal to the JAX package's, ids included (both
keep the lower position first among equal scores, then order score
descending, id ascending); euclid_lsh distances within 1e-5 (float32).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from jubatus_tpu.ops import knn as jknn
from jubatus_tpu.parallel import sharded_knn as jsk
from jubatus_tpu_torch.ops import ivf, sig_scan
from jubatus_tpu_torch.parallel import sharded_ivf, sharded_knn
from jubatus_tpu_torch.parallel.mesh import ShardMesh, local_shard_mesh
from jubatus_tpu_torch.parallel.sharded_knn import (merge_topk, replicate,
                                                    shard_table,
                                                    sharded_hamming_topk)


@pytest.fixture(scope="module")
def shard_mesh():
    return ShardMesh(["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh():
    return Mesh(np.asarray(jax.devices()[:8]), axis_names=("shard",))


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


def test_sharded_topk_matches_single_device(shard_mesh, jmesh, rng):
    B, C, W, k = 4, 1024, 4, 8
    hash_num = W * 32
    q = rng.integers(0, 2**32, size=(B, W), dtype=np.uint32)
    rows = rng.integers(0, 2**32, size=(C, W), dtype=np.uint32)
    dist, gidx = sharded_hamming_topk(shard_mesh, _t(q),
                                      shard_table(shard_mesh, _t(rows)),
                                      hash_num=hash_num, k=k)
    full = sig_scan.hamming_plain(_t(q), _t(rows), hash_num).numpy()
    np.testing.assert_array_equal(dist.numpy(), np.sort(full, axis=1)[:, :k])
    d, g = dist.numpy(), gidx.numpy()
    for b in range(B):
        for j in range(k):
            assert full[b, g[b, j]] == d[b, j]
    jd, _ = jsk.sharded_hamming_topk(
        jmesh, jsk.replicate(jmesh, jnp.asarray(q)),
        jsk.shard_table(jmesh, jnp.asarray(rows)), hash_num=hash_num, k=k)
    np.testing.assert_array_equal(d, np.asarray(jd))


def test_sharded_topk_exact_match_row(shard_mesh, rng):
    rows = rng.integers(0, 2**32, size=(512, 2), dtype=np.uint32)
    dist, gidx = sharded_hamming_topk(shard_mesh, _t(rows[137:138]),
                                      _t(rows), hash_num=64, k=3)
    assert float(dist[0, 0]) == 0.0 and int(gidx[0, 0]) == 137


def test_sharded_topk_k_larger_than_shard(shard_mesh, rng):
    """k past a single shard's rows still yields the global best k."""
    B, C, W, k = 2, 64, 2, 16            # 8 rows a shard < k
    q = rng.integers(0, 2**32, size=(B, W), dtype=np.uint32)
    rows = rng.integers(0, 2**32, size=(C, W), dtype=np.uint32)
    dist, _ = sharded_hamming_topk(shard_mesh, _t(q), _t(rows),
                                   hash_num=64, k=k)
    full = sig_scan.hamming_plain(_t(q), _t(rows), 64).numpy()
    np.testing.assert_array_equal(dist.numpy(), np.sort(full, axis=1)[:, :k])


def test_shard_table_and_replicate_place_blocks(shard_mesh):
    table = torch.arange(64 * 3, dtype=torch.int32).reshape(64, 3)
    blocks = shard_table(shard_mesh, table)
    assert len(blocks) == 8 and all(b.shape == (8, 3) for b in blocks)
    torch.testing.assert_close(torch.cat(blocks), table)
    assert len(replicate(shard_mesh, table[0])) == 8
    with pytest.raises(ValueError, match="do not split"):
        shard_table(shard_mesh, table[:60])


def test_local_shard_mesh_needs_the_devices():
    with pytest.raises(ValueError, match="--shard-devices 2 but only 1 "
                                         "local devices present"):
        local_shard_mesh(2, "cpu")
    assert ShardMesh(["cpu"] * 3).shape["shard"] == 3


# -- merge_topk ----------------------------------------------------------------

def _merge(scores, ids, k):
    s, i = merge_topk(torch.as_tensor(np.asarray(scores, np.float32)),
                      torch.as_tensor(np.asarray(ids, np.int64)), k)
    js, ji = jsk.merge_topk(jnp.asarray(scores, jnp.float32),
                            jnp.asarray(ids, jnp.int32), k)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    return s.numpy(), i.numpy()


def test_merge_topk_k_exceeds_live_rows():
    ninf = -np.inf
    scores = np.array([[[5.0, ninf, ninf, ninf]],
                       [[3.0, 2.0, ninf, ninf]],
                       [[ninf, ninf, ninf, ninf]],
                       [[9.0, ninf, ninf, ninf]]])
    ids = np.arange(16).reshape(4, 1, 4)
    s, i = _merge(scores, ids, k=10)
    assert s.shape == (1, 10)
    np.testing.assert_allclose(s[0][np.isfinite(s[0])], [9.0, 5.0, 3.0, 2.0])
    assert list(i[0][:4]) == [12, 0, 4, 5]
    assert not np.isfinite(s[0][4:]).any()


def test_merge_topk_all_dead_shards():
    s, i = _merge(np.full((8, 2, 4), -np.inf), np.zeros((8, 2, 4)), k=4)
    assert s.shape == (2, 4) and i.shape == (2, 4)
    assert not np.isfinite(s).any()


def test_merge_topk_cross_shard_ties_pin_ascending_id():
    scores = np.array([[[1.0, 0.5]], [[1.0, 0.25]],
                       [[1.0, 0.125]], [[1.0, 0.0625]]])
    ids = np.array([[[30, 31]], [[10, 11]], [[20, 21]], [[0, 1]]])
    s, i = _merge(scores, ids, k=4)
    np.testing.assert_allclose(s[0], [1.0, 1.0, 1.0, 1.0])
    assert list(i[0]) == [0, 10, 20, 30]
    s2, i2 = _merge(scores[::-1].copy(), ids[::-1].copy(), k=4)
    np.testing.assert_allclose(s2[0], s[0])
    assert list(i2[0]) == list(i[0])


@pytest.mark.parametrize("s_count", [2, 3, 5, 8])
def test_merge_topk_matches_jax_under_heavy_ties(s_count, rng):
    """Scores drawn from four values: the tree's selection and tie rule
    pick exactly the JAX package's candidates, odd carries included."""
    scores = rng.integers(0, 4, size=(s_count, 3, 6)).astype(np.float32)
    scores[0, 0, :2] = -np.inf
    ids = rng.permutation(s_count * 3 * 6).reshape(s_count, 3, 6)
    _merge(scores, ids, k=7)


# -- full distances and the sharded IVF ---------------------------------------

@pytest.mark.parametrize("method", ["lsh", "minhash", "euclid_lsh"])
def test_sharded_distances_match_flat(method, jmesh, rng):
    mesh = ShardMesh(["cpu"] * 4)
    hash_num = 64
    if method == "euclid_lsh":
        q = rng.normal(size=(3, hash_num)).astype(np.float32)
        rows = rng.normal(size=(96, hash_num)).astype(np.float32)
    else:
        w = 2 if method == "lsh" else hash_num
        q = rng.integers(0, 2**32, size=(3, w), dtype=np.uint32)
        rows = rng.integers(0, 2**32, size=(96, w), dtype=np.uint32)
        if method == "minhash":
            q, rows = q % 3, rows % 3
    got = sharded_knn.sharded_distances(mesh, _t(q), _t(rows), method=method,
                                        hash_num=hash_num).numpy()
    jm = Mesh(np.asarray(jax.devices()[:4]), axis_names=("shard",))
    want = np.asarray(jsk.sharded_distances(
        jm, jnp.asarray(q), jsk.shard_table(jm, jnp.asarray(rows)),
        method=method, hash_num=hash_num))
    assert got.shape == (3, 96)
    if method == "euclid_lsh":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method,n_shards", [("lsh", 2), ("lsh", 4),
                                             ("minhash", 2), ("minhash", 4)])
def test_sharded_ivf_full_probe_equals_sharded_exact(method, n_shards, rng):
    """Probing every cell of every shard is the exact sharded scan:
    distances equal exactly."""
    mesh = ShardMesh(["cpu"] * n_shards)
    c_local, n_cells, k, hash_num = 48, 3, 9, 64
    w = 2 if method == "lsh" else hash_num
    rows = rng.integers(0, 2**32, size=(n_shards * c_local, w),
                        dtype=np.uint32)
    if method == "minhash":
        rows %= 4
    q = rows[[5, 70]].copy()
    emb = ivf.embed_signatures(_t(rows), method=method, hash_num=hash_num)
    cen = torch.from_numpy(ivf.train_centroids(emb, n_cells, seed=0))
    cells = ivf.assign_cells(emb, cen).numpy()
    cap = 64
    tab = np.full((n_shards * n_cells, cap), -1, np.int32)
    for s in range(n_shards):
        for c in range(n_cells):
            mine = [g - s * c_local for g in range(s * c_local,
                                                   (s + 1) * c_local)
                    if cells[g] == c]
            tab[s * n_cells + c, :len(mine)] = mine
    qe = ivf.embed_signatures(_t(q), method=method, hash_num=hash_num)
    d, g = sharded_ivf.sharded_ivf_topk(
        mesh, _t(q), qe, _t(rows), cen, torch.from_numpy(tab),
        method=method, hash_num=hash_num, k=k, nprobe=n_cells)
    topk = (sharded_knn.sharded_hamming_topk(mesh, _t(q), _t(rows),
                                             hash_num=hash_num, k=k)
            if method == "lsh"
            else sharded_knn.sharded_minhash_topk(mesh, _t(q), _t(rows), k=k))
    np.testing.assert_array_equal(d.numpy(), topk[0].numpy())
    full = (sig_scan.hamming_plain(_t(q), _t(rows), hash_num) if method == "lsh"
            else sig_scan.minhash_plain(_t(q), _t(rows))).numpy()
    for b in range(2):
        for j in range(k):
            assert full[b, g[b, j]] == d[b, j]
