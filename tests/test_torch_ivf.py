"""The port's IVF tier (``jubatus_tpu_torch/ops/ivf.py``, the NN backend's
``configure_ann``) against the JAX package's on the same seeded inputs.

Mirrors ``tests/test_ann_ivf.py``, the two-level assignment included.
Tolerances:

- the embeddings, the lsh / minhash candidate rescore, the full-probe IVF
  answers and the centroids of the lsh / minhash tiers: exactly equal to
  the JAX package's (the rescore also exactly equal to the port's own
  batch scan);
- euclid_lsh's candidate rescore against the batch expansion: 1e-3
  absolute (float32 accumulation order), as the JAX test states;
- float centroids trained by both packages: ``KMEANS_TOL`` (1e-5,
  absolute) of tests/test_torch_clustering.py;
- cell assignment with the SAME centroids (flat, or two-level with the
  same super tables): equal, except rows whose two nearest candidate
  centroid distances lie within ``ASSIGN_RTOL`` (relative) of each other,
  where float order may pick either; the host's grouped assignment is the
  JAX package's numpy code and equal outright;
- approximate against exact answers: ``tie_equal`` (distance sequences
  within the stated atol, ids equal below the k-th distance).
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from jubatus_tpu.models._nn_backend import NNBackend as JNNBackend
from jubatus_tpu.ops import ivf as jivf
from jubatus_tpu.ops import knn as jknn
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.models._nn_backend import NNBackend
from jubatus_tpu_torch.ops import ivf, knn, sig_scan
from jubatus_tpu_torch.parallel.mesh import ShardMesh
from jubatus_tpu_torch.utils import events, faults

DIM = 64
KMEANS_TOL = 1e-5
ASSIGN_RTOL = 1e-5


@pytest.fixture(scope="module")
def mesh():
    return ShardMesh(["cpu"] * 4)


@pytest.fixture(scope="module")
def jmesh():
    return Mesh(np.asarray(jax.devices()[:4]), axis_names=("shard",))


def _vec(rng, nnz=6):
    idx = rng.integers(1, DIM, size=nnz)
    val = rng.normal(size=nnz)
    return [(int(i), float(v)) for i, v in zip(idx, val)]


def _pair(method, rows, rng, **ann):
    """A JAX and a port backend holding the same rows (IVF armed when
    ``ann`` is given)."""
    j = JNNBackend(method, dim=DIM, hash_num=64)
    t = NNBackend(method, dim=DIM, hash_num=64, device="cpu")
    if ann:
        j.configure_ann("ivf", **ann)
        t.configure_ann("ivf", **ann)
    for i in range(rows):
        v = _vec(rng)
        j.set_row(f"r{i}", v)
        t.set_row(f"r{i}", v)
    return j, t


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


def tie_equal(got, want, atol=1e-5):
    """Approximate-vs-exact comparison robust to tie groups at the k
    boundary: distance sequences match, and id sets match below the
    boundary distance."""
    gd = [d for _, d in got]
    wd = [d for _, d in want]
    np.testing.assert_allclose(gd, wd, atol=atol, rtol=1e-5)
    if not wd:
        return
    bound = wd[-1] - atol
    assert {r for r, d in got if d < bound} == \
        {r for r, d in want if d < bound}


def _sigs(rng, method, n, hash_num=64):
    if method == "lsh":
        return rng.integers(0, 2**32, size=(n, 2), dtype=np.uint32)
    if method == "minhash":
        return rng.integers(0, 2**32, size=(n, hash_num), dtype=np.uint32)
    return rng.normal(size=(n, hash_num)).astype(np.float32)


# -- ops ---------------------------------------------------------------------

def test_lsh_embedding_is_exact_hamming(rng):
    """±1 bits: squared euclidean distance is exactly 4x the bit-hamming
    distance, and the embedding equals the JAX package's."""
    sigs = rng.integers(0, 2**32, size=(32, 2), dtype=np.uint32)
    emb = ivf.embed_signatures(_t(sigs), method="lsh", hash_num=64)
    np.testing.assert_array_equal(
        emb.numpy(), np.asarray(jivf.embed_signatures(
            jnp.asarray(sigs), method="lsh", hash_num=64)))
    d2 = ivf.pairwise_sq_dists(emb, emb).numpy()
    ham = sig_scan.hamming_plain(_t(sigs), _t(sigs), 64).numpy() * 64
    np.testing.assert_allclose(d2, 4.0 * ham, atol=1e-3)


@pytest.mark.parametrize("method,hash_num", [("lsh", 48), ("minhash", 64),
                                             ("minhash", 13),
                                             ("euclid_lsh", 64)])
def test_embeddings_match_jax_exactly(method, hash_num, rng):
    """uint32 wrap-around, logical shifts and the uint32 → float32
    rounding of the minhash embedding, computed in int64 on int32 words,
    give the JAX package's floats bit for bit (words up to 2^32 − 1)."""
    sigs = _sigs(rng, method, 200, hash_num)
    if method == "minhash":
        sigs[:3] = 0xFFFFFFFF
        sigs[3:6] = 0x80000000
    got = ivf.embed_signatures(_t(sigs), method=method, hash_num=hash_num)
    want = jivf.embed_signatures(jnp.asarray(sigs), method=method,
                                 hash_num=hash_num)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_auto_cells_sqrt_scaling():
    assert ivf.auto_cells(0) == 8
    assert ivf.auto_cells(100) == 8
    assert ivf.auto_cells(10_000) == 128
    assert ivf.auto_cells(1_000_000) == 1024
    for n in (5, 500, 77_000, 3_000_000, 2**20 + 3):
        c = ivf.auto_cells(n)
        assert c & (c - 1) == 0 and c == jivf.auto_cells(n)


@pytest.mark.parametrize("method", ["lsh", "minhash", "euclid_lsh"])
def test_candidate_kernels_match_batch_kernels(method, rng):
    """The candidate rescore over every row (and −1 padding) equals the
    batch scan for those rows: exactly for lsh / minhash, within 1e-3 for
    euclid_lsh; and the JAX package's candidate distances."""
    B, C, hash_num = 3, 64, 64
    q, rows = _sigs(rng, method, B), _sigs(rng, method, C)
    cand = np.tile(np.arange(C), (B, 1))
    cand[:, -5:] = -1
    got = ivf.candidate_sig_distances(_t(q), _t(rows), _t(cand.astype(
        np.int64)), method=method, hash_num=hash_num).numpy()
    full = knn.euclid_lsh_distances_batch(_t(q), _t(rows), hash_num=hash_num) \
        if method == "euclid_lsh" else (
            sig_scan.hamming_plain(_t(q), _t(rows), hash_num)
            if method == "lsh" else sig_scan.minhash_plain(_t(q), _t(rows)))
    full = full.numpy()
    assert np.isinf(got[:, -5:]).all()
    want_j = np.asarray(jivf.candidate_sig_distances(
        jnp.asarray(q), jnp.asarray(rows)[jnp.asarray(cand[:, :-5])],
        method=method, hash_num=hash_num))
    if method == "euclid_lsh":
        np.testing.assert_allclose(got[:, :-5], full[:, :-5], atol=1e-3)
        np.testing.assert_allclose(got[:, :-5], want_j, atol=1e-3)
    else:
        np.testing.assert_array_equal(got[:, :-5], full[:, :-5])
        np.testing.assert_array_equal(got[:, :-5], want_j)


@pytest.mark.parametrize("mode,w,m", [("hamming", 2, 1), ("hamming", 3, 7),
                                      ("minhash", 64, 7), ("minhash", 70, 33)])
def test_gathered_plain_is_the_gathered_batch_scan(mode, w, m, rng):
    """The gathered variant's plain version (the CPU path): each query's
    candidates gathered, then the plain scan; padding +inf; the table's
    last slot reachable."""
    c = 40
    q = _t(rng.integers(0, 2**32, size=(3, w), dtype=np.uint32))
    r = _t(rng.integers(0, 2**32 if mode == "hamming" else 5, size=(c, w),
                        dtype=np.uint32))
    cand = rng.integers(-1, c, size=(3, m))
    cand[0, 0] = c - 1
    cand[2] = -1
    got = sig_scan.gathered(mode, q, r, _t(cand), 32 * w)
    for b in range(3):
        for j in range(m):
            s = cand[b, j]
            if s < 0:
                assert got[b, j] == float("inf")
                continue
            ref = (sig_scan.hamming_plain(q[b:b + 1], r[s:s + 1], 32 * w)
                   if mode == "hamming"
                   else sig_scan.minhash_plain(q[b:b + 1], r[s:s + 1]))
            assert got[b, j] == ref[0, 0]
    assert sig_scan.GATHERS[mode].launches == 0   # the CPU launches nothing


def _cell_table(cells, n_cells):
    cap = int(np.bincount(cells, minlength=n_cells).max())
    slots = np.full((n_cells, cap), -1, np.int32)
    fill = np.zeros(n_cells, np.int64)
    for slot, c in enumerate(cells):
        slots[c, fill[c]] = slot
        fill[c] += 1
    return slots


@pytest.mark.parametrize("method", ["lsh", "minhash"])
def test_ivf_topk_full_probe_matches_exact_and_jax(method, rng):
    """Probing every cell is the exact scan: distances equal the sorted
    full scan, and (distances, slots) equal the JAX package's ivf_topk
    given the same centroids and cell table, ties included."""
    C, n_cells, k, hash_num = 200, 4, 10, 64
    sigs = _sigs(rng, method, C)
    if method == "minhash":
        sigs %= 6   # many equal lanes: many tied distances
    emb = ivf.embed_signatures(_t(sigs), method=method, hash_num=hash_num)
    cen = ivf.train_centroids(emb, n_cells, seed=1)
    cells = ivf.assign_cells(emb, torch.from_numpy(cen)).numpy()
    slots = _cell_table(cells, n_cells)
    q = _t(sigs[:3])
    d, s = ivf.ivf_topk(q, emb[:3], _t(sigs), torch.from_numpy(cen),
                        torch.from_numpy(slots), method=method,
                        hash_num=hash_num, k=k, nprobe=n_cells)
    full = (sig_scan.hamming_plain(q, _t(sigs), hash_num) if method == "lsh"
            else sig_scan.minhash_plain(q, _t(sigs))).numpy()
    np.testing.assert_array_equal(d.numpy(), np.sort(full, axis=1)[:, :k])
    jd, js = jivf.ivf_topk(
        jnp.asarray(sigs[:3]), jnp.asarray(emb[:3].numpy()),
        jnp.asarray(sigs), jnp.asarray(cen), jnp.asarray(slots),
        method=method, hash_num=hash_num, k=k, nprobe=n_cells)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("n_cells", [4, 300])
def test_train_centroids_matches_jax(n_cells, rng):
    """kmeans_fit up to 256 cells, sample-seeded Lloyd above: within
    KMEANS_TOL of the JAX package's centroids."""
    emb = rng.normal(size=(1200, 16)).astype(np.float32)
    got = ivf.train_centroids(torch.from_numpy(emb), n_cells, seed=3)
    want = jivf.train_centroids(jnp.asarray(emb), n_cells, seed=3)
    assert got.shape == (n_cells, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=KMEANS_TOL)


def test_assign_cells_matches_jax_with_the_same_centroids(rng):
    emb = rng.normal(size=(3000, 32)).astype(np.float32)
    cen = rng.normal(size=(64, 32)).astype(np.float32)
    got = ivf.assign_cells(torch.from_numpy(emb), torch.from_numpy(cen))
    want = np.asarray(jivf.assign_cells(jnp.asarray(emb), jnp.asarray(cen)))
    got = got.numpy()
    d2 = ((emb[:, None, :] - cen[None]) ** 2).sum(-1)
    two = np.sort(d2, axis=1)[:, :2]
    near_tie = (two[:, 1] - two[:, 0]) <= ASSIGN_RTOL * two[:, 1]
    assert ((got == want) | near_tie).all()
    assert (got == want).mean() > 0.99


def _clustered(rng, n, n_cells, dim=DIM):
    """Planted centers + small noise (the regime the tier serves)."""
    centers = rng.normal(size=(n_cells, dim)) * 4.0
    return (centers[rng.integers(0, n_cells, size=n)]
            + rng.normal(size=(n, dim))).astype(np.float32)


def test_hierarchical_assignment_agrees_with_flat(rng):
    """The two-level (super-cell) assignment of the 1e8-row build path
    agrees with the flat argmin on the vast majority of rows; the
    host-side grouped build is the same assignment."""
    n, n_cells = 4000, 16
    emb = _clustered(rng, n, n_cells)
    cen = ivf.train_centroids(torch.from_numpy(emb), n_cells, seed=0)
    flat = ivf.assign_cells(torch.from_numpy(emb),
                            torch.from_numpy(cen)).numpy()
    supers, members = ivf.build_super(cen, n_super=4, seed=0, device="cpu")
    hier = ivf.assign_cells_hier(
        torch.from_numpy(emb), torch.from_numpy(cen),
        torch.from_numpy(supers), torch.from_numpy(members),
        top_supers=2).numpy()
    assert hier.dtype == np.int32 and hier.shape == (n,)
    assert (flat == hier).mean() > 0.9
    grouped = ivf.assign_cells_grouped(emb, cen, supers, members,
                                       top_supers=2)
    assert (grouped == hier).mean() > 0.999


@pytest.mark.parametrize("n_cells,n_super", [(16, 4), (300, 7)])
def test_build_super_matches_jax(n_cells, n_super, rng):
    """The same centroids group into the JAX package's super tables:
    supers within KMEANS_TOL, the member table equal."""
    cen = rng.normal(size=(n_cells, 16)).astype(np.float32)
    supers, members = ivf.build_super(cen, n_super=n_super, seed=2,
                                      device="cpu")
    jsupers, jmembers = jivf.build_super(cen, n_super=n_super, seed=2)
    assert supers.dtype == np.float32 and members.dtype == np.int32
    np.testing.assert_allclose(supers, jsupers, rtol=0, atol=KMEANS_TOL)
    np.testing.assert_array_equal(members, jmembers)
    assert sorted(members[members >= 0].tolist()) == list(range(n_cells))


@pytest.mark.parametrize("top_supers", [1, 2, 4])
def test_two_level_assignment_matches_jax_with_the_same_tables(top_supers,
                                                               rng):
    """``assign_cells_hier`` and ``assign_cells_grouped`` answer the JAX
    functions' cells on the same embeddings, centroids and super tables."""
    n, n_cells = 3000, 64
    emb = _clustered(rng, n, n_cells, dim=32)
    cen = rng.normal(size=(n_cells, 32)).astype(np.float32) * 4.0
    supers, members = (np.array(a) for a in jivf.build_super(
        cen, n_super=8, seed=1))
    got = ivf.assign_cells_hier(
        torch.from_numpy(emb), torch.from_numpy(cen),
        torch.from_numpy(supers), torch.from_numpy(members),
        top_supers=top_supers).numpy()
    want = np.asarray(jivf.assign_cells_hier(
        jnp.asarray(emb), jnp.asarray(cen), jnp.asarray(supers),
        jnp.asarray(members), top_supers=top_supers))
    # near ties among each row's candidate cells may go either way
    sd = ((emb[:, None, :] - supers[None]) ** 2).sum(-1)
    gsel = np.argsort(sd, axis=1, kind="stable")[:, :top_supers]
    near_tie = np.zeros(n, bool)
    for i in range(n):
        cells = members[gsel[i]].reshape(-1)
        cells = cells[cells >= 0]
        d2 = np.sort(((cen[cells] - emb[i]) ** 2).sum(-1))
        near_tie[i] = len(d2) > 1 and d2[1] - d2[0] <= ASSIGN_RTOL * d2[1]
    assert ((got == want) | near_tie).all()
    assert (got == want).mean() > 0.99
    grouped = ivf.assign_cells_grouped(emb, cen, supers, members,
                                       top_supers=top_supers)
    np.testing.assert_array_equal(grouped, jivf.assign_cells_grouped(
        emb, cen, supers, members, top_supers=top_supers))


# -- cell arenas -------------------------------------------------------------

def test_cell_arenas_assign_move_remove_tables():
    from jubatus_tpu.core.row_store import RowStore as JRowStore
    from jubatus_tpu.parallel.row_store import CellArenas as JCellArenas
    from jubatus_tpu_torch.core.row_store import RowStore
    from jubatus_tpu_torch.parallel.row_store import CellArenas

    tables = []
    for store, arenas in ((RowStore(), CellArenas), (JRowStore(), JCellArenas)):
        for i in range(6):
            store.set_row(f"r{i}", [(1, 1.0)])
        a = arenas(store, 2)
        for i in range(6):
            a.assign(f"r{i}", i % 2)
        assert a.sizes() == [3, 3]
        a.assign("r0", 1)
        assert a.cell_of("r0") == 1 and a.sizes() == [2, 4]
        a.remove("r5")
        tab, cap = (a.device_tables("cpu") if arenas is CellArenas
                    else a.device_tables())
        assert tab.shape[0] == 2 and cap >= 3
        assert (np.asarray(tab) >= 0).sum() == 5
        assert a.add_cell() == 2 and a.n_cells == 3
        store.remove_row("r1")            # pruned lazily at the next build
        tab2, _ = (a.device_tables("cpu") if arenas is CellArenas
                   else a.device_tables())
        assert (np.asarray(tab2) >= 0).sum() == 4
        tables.append(np.asarray(tab2))
    np.testing.assert_array_equal(tables[0], tables[1])


# -- backend: flat -----------------------------------------------------------

@pytest.mark.parametrize("method", ["lsh", "minhash", "euclid_lsh"])
def test_flat_full_probe_parity(method, rng):
    """Full probe: the port's IVF answers equal its exact answers (tie-
    aware), and for lsh / minhash the JAX package's IVF answers exactly."""
    j, ann = _pair(method, 150, rng, cells=4, nprobe=4)
    _, exact = _pair(method, 0, rng)
    for rid in ann.store.all_ids():
        exact.set_row(rid, ann.store.get_row(rid))
    for _ in range(4):
        q = _vec(rng)
        got = ann.neighbors(q, 8)
        tie_equal(got, exact.neighbors(q, 8), atol=1e-3)
        want = j.neighbors(q, 8)
        if method != "euclid_lsh":
            assert got == want
    assert ann.ann_stats() == j.ann_stats()


@pytest.mark.parametrize("method", ["inverted_index", "euclid"])
def test_flat_exact_methods_rescore_is_exact(method, rng):
    """Cosine / euclid under IVF: the probe is hashed, the rescore the
    true metric, so full-probe answers are exact."""
    _, ann = _pair(method, 150, rng, cells=4, nprobe=4)
    exact = NNBackend(method, dim=DIM, hash_num=64, device="cpu")
    for rid in ann.store.all_ids():
        exact.set_row(rid, ann.store.get_row(rid))
    q = _vec(rng)
    tie_equal(ann.neighbors(q, 8), exact.neighbors(q, 8), atol=1e-4)
    assert ann.ann_stats()["built"]


def test_ann_off_is_bit_identical(rng):
    """--ann off is the exact path: toggling the tier on and back off
    gives byte for byte the answers of a backend that never had it."""
    base = NNBackend("lsh", dim=DIM, hash_num=64, device="cpu")
    toggled = NNBackend("lsh", dim=DIM, hash_num=64, device="cpu")
    toggled.configure_ann("ivf", cells=4, nprobe=2)
    for i in range(100):
        v = _vec(rng)
        base.set_row(f"r{i}", v)
        toggled.set_row(f"r{i}", v)
    q = _vec(rng)
    toggled.neighbors(q, 5)                  # builds the index
    toggled.configure_ann("off")
    assert toggled.neighbors(q, 5) == base.neighbors(q, 5)
    np.testing.assert_array_equal(toggled.distances(q), base.distances(q))
    assert toggled.ann_stats() == {}
    with pytest.raises(ValueError, match="unknown ann mode"):
        toggled.configure_ann("hnsw")


def test_online_insert_lands_in_a_cell(rng):
    j, b = _pair("lsh", 140, rng, cells=4, nprobe=4)
    q = _vec(rng)
    b.neighbors(q, 5)                        # build
    j.neighbors(q, 5)
    v = _vec(rng)
    b.set_row("fresh", v)
    j.set_row("fresh", v)
    res = b.neighbors(v, 141)                # flushes + assigns
    assert res == j.neighbors(v, 141)
    assert b._ann_arenas.cell_of("fresh") == j._ann_arenas.cell_of("fresh")
    assert "fresh" in [r for r, _ in res]


def test_resplit_grows_cells_and_keeps_answers(rng):
    j, b = _pair("lsh", 0, rng, cells=2, nprobe=64)
    j.ann_split_width = b.ann_split_width = 24   # force overflow re-splits
    exact = NNBackend("lsh", dim=DIM, hash_num=64, device="cpu")
    for i in range(160):
        v = _vec(rng)
        for be in (j, b, exact):
            be.set_row(f"r{i}", v)
    before = events.default_journal().stats()["emitted"]
    q = _vec(rng)
    got = b.neighbors(q, 8)
    st = b.ann_stats()
    assert st["resplits"] > 0 and st["cells"] > 2
    assert st["rows_indexed"] == 160
    tie_equal(got, exact.neighbors(q, 8), atol=1e-3)
    assert got == j.neighbors(q, 8) and st == j.ann_stats()
    np.testing.assert_array_equal(b._ann_centroids, j._ann_centroids)
    recs = events.default_journal().snapshot(grep="resplit")
    assert events.default_journal().stats()["emitted"] > before
    assert any(r["subsystem"] == "ann" and r["type"] == "resplit"
               for r in recs)


def test_rebuild_fault_degrades_to_the_exact_scan(rng):
    b = NNBackend("lsh", dim=DIM, hash_num=64, device="cpu")
    b.configure_ann("ivf", cells=4, nprobe=1)
    exact = NNBackend("lsh", dim=DIM, hash_num=64, device="cpu")
    for i in range(150):
        v = _vec(rng)
        b.set_row(f"r{i}", v)
        exact.set_row(f"r{i}", v)
    q = _vec(rng)
    with faults.armed("ann.rebuild:error"):
        assert b.neighbors(q, 6) == exact.neighbors(q, 6)
    st = b.ann_stats()
    assert st["degraded"] and not st["built"] and st["rebuild_failed"] == 1
    assert b.neighbors(q, 6) == exact.neighbors(q, 6)   # sticky
    recs = events.default_journal().snapshot(grep="degraded")
    assert any(r["subsystem"] == "ann" for r in recs)
    b.configure_ann("ivf", cells=4, nprobe=1)           # clears the latch
    b.neighbors(q, 6)
    assert b.ann_stats()["built"]


# -- backend: mesh -----------------------------------------------------------

@pytest.mark.parametrize("method", ["lsh", "minhash", "euclid_lsh"])
def test_mesh_full_probe_parity(method, mesh, jmesh, rng):
    j, ann = _pair(method, 170, rng, cells=4, nprobe=4)
    exact = NNBackend(method, dim=DIM, hash_num=64, device="cpu")
    for rid in ann.store.all_ids():
        exact.set_row(rid, ann.store.get_row(rid))
    ann.attach_mesh(mesh)
    j.attach_mesh(jmesh)
    for _ in range(3):
        q = _vec(rng)
        got = ann.neighbors(q, 8)
        tie_equal(got, exact.neighbors(q, 8), atol=1e-3)
        want = j.neighbors(q, 8)
        if method != "euclid_lsh":
            assert [d for _, d in got] == [d for _, d in want]
    st = ann.ann_stats()
    assert st["built"] and st["probed_cells"] >= 1
    assert st["rows_indexed"] == j.ann_stats()["rows_indexed"] == 170


def test_mesh_remove_row_masks_ann(mesh, rng):
    b = NNBackend("lsh", dim=DIM, hash_num=64, device="cpu")
    b.configure_ann("ivf", cells=4, nprobe=4)
    for i in range(150):
        b.set_row(f"r{i}", _vec(rng))
    b.attach_mesh(mesh)
    q = _vec(rng)
    first = b.neighbors(q, 3)[0][0]
    b.remove_row(first)
    after = [r for r, _ in b.neighbors(q, 149)]
    assert first not in after and len(after) == 149


# -- persistence / reshard ---------------------------------------------------

def test_pack_unpack_preserves_centroids(rng):
    _, b = _pair("lsh", 140, rng, cells=4, nprobe=4)
    q = _vec(rng)
    want = b.neighbors(q, 8)
    cen = b._ann_centroids.copy()
    b2 = NNBackend("lsh", dim=DIM, hash_num=64, device="cpu")
    b2.configure_ann("ivf", cells=4, nprobe=4)
    b2.unpack(b.pack())
    np.testing.assert_array_equal(b2._ann_centroids, cen)
    tie_equal(b2.neighbors(q, 8), want, atol=1e-3)
    assert b2.ann_stats()["cells"] == 4


@pytest.mark.parametrize("method", ["lsh", "minhash"])
def test_ann_pack_crosses_between_the_packages(method, rng):
    """The "ann" entry is byte for byte the JAX package's; a JAX pack
    loads into the port (and back) with its centroids, and both answer
    alike afterwards."""
    j, t = _pair(method, 160, rng, cells=8, nprobe=2)
    q = _vec(rng)
    assert t.neighbors(q, 6) == j.neighbors(q, 6)
    jp, tp = j.pack(), t.pack()
    assert tp["ann"] == jp["ann"]
    assert isinstance(tp["ann"]["centroids"], bytes)
    t2 = NNBackend(method, dim=DIM, hash_num=64, device="cpu")
    t2.configure_ann("ivf", cells=8, nprobe=2)
    t2.unpack(jp)
    j2 = JNNBackend(method, dim=DIM, hash_num=64)
    j2.configure_ann("ivf", cells=8, nprobe=2)
    j2.unpack(tp)
    np.testing.assert_array_equal(t2._ann_centroids, j._ann_centroids)
    np.testing.assert_array_equal(j2._ann_centroids, t._ann_centroids)
    for _ in range(3):
        q = _vec(rng)
        assert t2.neighbors(q, 6) == j2.neighbors(q, 6) == j.neighbors(q, 6)


def test_restore_onto_mesh_reshards_cells(mesh, rng):
    """Written flat, restored onto a 4-shard mesh: rows re-partition
    through the STORED centroids over the new layout."""
    _, flat = _pair("lsh", 160, rng, cells=4, nprobe=4)
    q = _vec(rng)
    want = flat.neighbors(q, 8)
    sharded = NNBackend("lsh", dim=DIM, hash_num=64, device="cpu")
    sharded.configure_ann("ivf", cells=4, nprobe=4)
    sharded.attach_mesh(mesh)
    sharded.unpack(flat.pack())
    np.testing.assert_array_equal(sharded._ann_centroids,
                                  flat._ann_centroids)
    tie_equal(sharded.neighbors(q, 8), want, atol=1e-3)
    assert sharded.ann_stats()["rows_indexed"] == 160
    assert sharded.ann_stats()["builds"] == 0   # restored, not retrained


# -- migration ---------------------------------------------------------------

def test_migration_with_ann_loses_zero_rows():
    """A row handoff between two IVF backends: every row survives, lands
    in a cell on the target and answers there."""
    from jubatus_tpu_torch.models.nearest_neighbor import NearestNeighborDriver

    conf = {"method": "lsh",
            "converter": {"num_rules": [{"key": "*", "type": "num"}]},
            "parameter": {"hash_num": 64}}
    src = NearestNeighborDriver(conf, device="cpu")
    dst = NearestNeighborDriver(conf, device="cpu")
    src.backend.configure_ann("ivf", cells=4, nprobe=4)
    dst.backend.configure_ann("ivf", cells=4, nprobe=4)
    rng2 = np.random.default_rng(3)
    for i in range(130):
        src.set_row(f"r{i}", Datum(
            {f"f{j}": float(rng2.random()) for j in range(8)}))
    src.neighbor_row_from_id("r0", 5)
    ids = src.row_ids()
    assert dst.put_rows(src.get_rows(ids)) == 130
    for rid in ids:
        src.backend.remove_row(rid)
    assert len(dst.backend.store) == 130 and len(src.backend.store) == 0
    assert len(dst.neighbor_row_from_id("r7", 130)) == 130
    assert dst.backend.ann_stats()["rows_indexed"] == 130
    st = dst.get_status()
    assert st["ann.built"] and st["ann.cells"] == 4


# -- the server --------------------------------------------------------------

def _server_conf(engine):
    path = {"nearest_neighbor": "nearest_neighbor/lsh.json",
            "recommender": "recommender/default.json",
            "anomaly": "anomaly/lof.json"}[engine]
    with open(os.path.join(os.path.dirname(__file__), "..", "config",
                           path)) as f:
        return json.load(f)


def _calls(engine, rng):
    # enough rows to build the index (128); LOF rebuilds its support at
    # every add, so anomaly takes fewer
    n = 40 if engine == "anomaly" else 200
    rows = [{"a": float(rng.normal()), "b": float(rng.normal()),
             "c": f"w{int(rng.integers(0, 9))}"} for _ in range(n)]
    if engine == "anomaly":
        return [("add", [r]) for r in rows], ("calc_score", [rows[3]])
    method = "set_row" if engine == "nearest_neighbor" else "update_row"
    query = ("neighbor_row_from_datum" if engine == "nearest_neighbor"
             else "similar_row_from_datum")
    return ([(method, [f"r{i}", r]) for i, r in enumerate(rows)],
            (query, [rows[7], 5]))


@pytest.mark.parametrize("engine", ["nearest_neighbor", "recommender",
                                    "anomaly"])
def test_servers_with_ann_answer_and_report_status(engine, rng):
    """``--ann ivf`` servers start, answer, and report ``ann.*``: the
    driver's keys in get_status, the gauges in get_metrics; anomaly's
    scores stay exact (LOF reads full distance rows)."""
    from jubatus_tpu.client import Datum as JDatum
    from jubatus_tpu.server import EngineServer as JEngineServer
    from jubatus_tpu.server.args import ServerArgs as JServerArgs
    from jubatus_tpu_torch.rpc.client import RpcClient
    from jubatus_tpu_torch.server import EngineServer
    from jubatus_tpu_torch.server.args import ServerArgs

    conf = _server_conf(engine)
    port_srv = EngineServer(engine, conf, ServerArgs(
        engine=engine, listen_addr="127.0.0.1", ann="ivf", ann_cells=4,
        ann_nprobe=4, microbatch_max=0), device="cpu")
    jax_srv = JEngineServer(engine, conf, JServerArgs(
        engine=engine, listen_addr="127.0.0.1", ann="ivf", ann_cells=4,
        ann_nprobe=4, microbatch_max=0))
    updates, (qm, qargs) = _calls(engine, rng)
    try:
        answers = []
        for srv in (port_srv, jax_srv):
            dt = JDatum if srv is jax_srv else Datum
            with RpcClient("127.0.0.1", srv.start(0), timeout=60) as c:
                for method, args in updates:
                    c.call(method, "x", *[dt(a) if isinstance(a, dict) else a
                                          for a in args])
                answers.append(c.call(qm, "x", *[
                    dt(a) if isinstance(a, dict) else a for a in qargs]))
                (st,) = c.call("get_status", "x").values()
                st = {k.decode() if isinstance(k, bytes) else k: v
                      for k, v in st.items()}
                assert st["driver.ann.mode"] in ("ivf", b"ivf")
                if srv is port_srv:
                    port_st = st
                    # the ann.* gauges are served by get_metrics, as the
                    # JAX server serves them, not copied into the map
                    (snap,) = c.call("get_metrics", "x").values()
                    port_gauges = snap["gauges"]
        if engine == "anomaly":
            assert answers[0] == pytest.approx(answers[1], rel=1e-4)
            assert not port_st["driver.ann.built"]   # LOF never probes
        else:
            got, want = answers
            assert [r[0] for r in got][:1] == [r[0] for r in want][:1] \
                or got[0][1] == pytest.approx(want[0][1], abs=1e-5)
            assert port_st["driver.ann.built"] is True
            assert port_gauges["ann.cells"] == 4.0
            assert port_gauges["ann.recall_probe"] == \
                port_st["driver.ann.recall_probe"]
            assert port_gauges["ann.recall_probe_deficit"] == pytest.approx(
                1.0 - port_gauges["ann.recall_probe"])
            assert not any(k.startswith("ann.") for k in port_st)
    finally:
        port_srv.stop()
        jax_srv.stop()


def _ivf_server(pkg, datadir):
    conf = _server_conf("nearest_neighbor")
    if pkg == "jax":
        from jubatus_tpu.server import EngineServer as S
        from jubatus_tpu.server.args import ServerArgs as A
        srv = S("nearest_neighbor", conf, A(
            engine="nearest_neighbor", listen_addr="127.0.0.1",
            datadir=datadir, ann="ivf", ann_cells=8, ann_nprobe=2))
    else:
        from jubatus_tpu_torch.server import EngineServer as S
        from jubatus_tpu_torch.server.args import ServerArgs as A
        srv = S("nearest_neighbor", conf, A(
            engine="nearest_neighbor", listen_addr="127.0.0.1",
            datadir=datadir, ann="ivf", ann_cells=8, ann_nprobe=2),
            device="cpu")
    return srv, srv.start(0)


@pytest.mark.parametrize("saver,loader", [("jax", "port"), ("port", "jax")])
def test_ivf_model_files_cross_load(saver, loader, tmp_path, rng):
    """An ``--ann ivf`` model saved by one package's server loads into the
    other's: the centroids arrive byte for byte and the loaded server
    answers as the saver does."""
    from jubatus_tpu.client import Datum as JDatum
    from jubatus_tpu_torch.rpc.client import RpcClient

    dirs = [str(tmp_path / side) for side in ("s", "l")]
    for d in dirs:
        os.makedirs(d)
    (s_srv, s_port), (l_srv, l_port) = (_ivf_server(saver, dirs[0]),
                                        _ivf_server(loader, dirs[1]))
    rows = [{"a": float(rng.normal()), "b": float(rng.normal()),
             "c": f"w{int(rng.integers(0, 9))}"} for _ in range(300)]
    try:
        with RpcClient("127.0.0.1", s_port, timeout=60) as s, \
                RpcClient("127.0.0.1", l_port, timeout=60) as ld:
            for i, r in enumerate(rows):
                s.call("set_row", "x", f"r{i}", JDatum(r))
            s.call("neighbor_row_from_datum", "x", JDatum(rows[0]), 5)
            (path,) = s.call("save", "x", "m1").values()
            shutil.copy(path, l_srv.model_path("m1"))
            assert ld.call("load", "x", "m1") is True
            np.testing.assert_array_equal(
                l_srv.driver.backend._ann_centroids,
                s_srv.driver.backend._ann_centroids)
            assert l_srv.driver.backend._ann_centroids.tobytes() == \
                s_srv.driver.backend._ann_centroids.tobytes()
            for r in rows[1:6]:
                want = s.call("neighbor_row_from_datum", "x", JDatum(r), 5)
                got = ld.call("neighbor_row_from_datum", "x", JDatum(r), 5)
                assert got == want
    finally:
        s_srv.stop()
        l_srv.stop()


@pytest.mark.cuda
def test_gathered_kernel_matches_plain_on_card(rng):
    """The gathered variant on the card, bit-equal to its plain version
    at the edge shapes (chip_smoke.py phase 2 repeats these)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for mode in ("hamming", "minhash"):
        for w in (2, 3, 64, 70):
            for m in (1, 7, 4099):
                c = 4099
                hi = 2**32 if mode == "hamming" else 40
                q = _t(rng.integers(0, hi, size=(5, w), dtype=np.uint32))
                r = _t(rng.integers(0, hi, size=(c, w), dtype=np.uint32))
                cand = rng.integers(-1, c, size=(5, m))
                cand[0, 0] = c - 1
                cand[1] = -1
                cand = _t(cand.astype(np.int32))
                got = sig_scan.gathered(mode, q.cuda(), r.cuda(),
                                        cand.cuda(), 32 * w).cpu()
                want = sig_scan.gathered_plain(mode, q, r, cand, 32 * w)
                assert torch.equal(got, want), (mode, w, m)
