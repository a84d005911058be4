"""The port's ring scans (``jubatus_tpu_torch/parallel/ring.py``) against
the JAX package's ``parallel/ring.py``.

Mirrors ``tests/test_ring.py`` case for case on ``ShardMesh(["cpu"] * 4)``
and holds each ring function to the JAX one run on 4 of the conftest's 8
virtual CPU devices, on the same seeded inputs (the signatures are the
JAX package's words, viewed as int32). Tolerances: hamming distances and
ids exactly equal (both rings keep the running candidates first among
equal scores, then the lower slot, so ties resolve alike); euclid
distances within 1e-5 (float32 sums in another order) and ids equal
where no other row lies within that tolerance.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jubatus_tpu.ops import knn as jknn
from jubatus_tpu.parallel import ring as jring
from jubatus_tpu.parallel.mesh import grid_mesh
from jubatus_tpu_torch.ops import sig_scan
from jubatus_tpu_torch.parallel import ring_euclid_topk, ring_hamming_topk
from jubatus_tpu_torch.parallel.mesh import ShardMesh
from jubatus_tpu_torch.parallel.ring import ring_scan, shard_rows

S = 4
EUCLID_TOL = 1e-5


@pytest.fixture(scope="module")
def mesh():
    return ShardMesh(["cpu"] * S)


@pytest.fixture(scope="module")
def jmesh():
    return grid_mesh(replica=1, shard=S, devices=jax.devices()[:S])


def _t(a):
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _sparse_rows(rng, n, nnz, dim):
    idx = rng.integers(1, dim, size=(n, nnz)).astype(np.int32)
    val = rng.normal(size=(n, nnz)).astype(np.float32)
    return jnp.asarray(idx), jnp.asarray(val)


def _sigs(rng, hash_num, dim, nnz, *counts):
    out = []
    for n in counts:
        i, v = _sparse_rows(rng, n, nnz, dim)
        out.append(jknn.lsh_signature(i, v, hash_num=hash_num))
    return out


def _jax_hamming(jmesh, q_sigs, row_sigs, valid=None, **kw):
    d, g = jring.ring_hamming_topk(
        jmesh, jring.shard_rows(jmesh, q_sigs),
        jring.shard_rows(jmesh, row_sigs),
        valid=None if valid is None else jring.shard_rows(
            jmesh, jnp.asarray(valid)), **kw)
    return np.asarray(d), np.asarray(g)


def test_ring_scan_visits_every_block_once(mesh):
    """Each shard must accumulate the sum over ALL blocks, with origin ids
    summing to 0+1+...+S-1 — catches rotation/origin bookkeeping bugs."""
    blocks = [(torch.tensor([10.0 * s]),) for s in range(S)]
    seen = [[] for _ in range(S)]

    def step(s, carry, block, origin):
        total, origin_sum = carry
        seen[s].append(origin)
        assert block[0].item() == 10.0 * origin   # the block's own origin
        return total + block[0].sum().item(), origin_sum + origin

    out = ring_scan(mesh, step, [(0.0, 0)] * S, blocks)
    assert out == [(10.0 * sum(range(S)), sum(range(S)))] * S
    # the JAX ring's order: shard s visits origins s, s-1, ..., s-S+1
    assert seen == [[(s - t) % S for t in range(S)] for s in range(S)]


def test_ring_hamming_matches_dense(mesh, jmesh, rng):
    hash_num, dim, nnz = 64, 1 << 12, 8
    B, C, k = 16, 64, 5
    q_sigs, row_sigs = _sigs(rng, hash_num, dim, nnz, B, C)

    d, gidx = ring_hamming_topk(mesh, shard_rows(mesh, _t(q_sigs)),
                                shard_rows(mesh, _t(row_sigs)),
                                hash_num=hash_num, k=k)
    d, gidx = d.numpy(), gidx.numpy()
    dense = sig_scan.hamming_plain(_t(q_sigs), _t(row_sigs),
                                   hash_num).numpy()
    for b in range(B):
        want = np.sort(dense[b])[:k]
        np.testing.assert_allclose(np.sort(d[b]), want, rtol=1e-6)
        # returned ids really score those distances
        np.testing.assert_allclose(np.sort(dense[b][gidx[b]]), want,
                                   rtol=1e-6)
    jd, jg = _jax_hamming(jmesh, q_sigs, row_sigs, hash_num=hash_num, k=k)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(gidx, jg)


def _euclid_inputs(rng, B, C, dim, nnz):
    qi, qv = _sparse_rows(rng, B, nnz, dim)
    ri, rv = _sparse_rows(rng, C, nnz, dim)
    q_dense = jnp.stack([jknn.densify(qi[b], qv[b], dim=dim)
                         for b in range(B)])
    return q_dense, ri, rv


def _euclid_ids_agree(d, gidx, jd, jg, dense_rows):
    """ids equal wherever no other row lies within the tolerance of the
    returned distance."""
    for b in range(d.shape[0]):
        for j in range(d.shape[1]):
            if gidx[b, j] == jg[b, j] or not np.isfinite(d[b, j]):
                continue
            near = np.abs(dense_rows[b] - d[b, j]) <= 2 * EUCLID_TOL
            assert near.sum() > 1, (b, j, gidx[b, j], jg[b, j])


def test_ring_euclid_matches_dense(mesh, jmesh, rng):
    dim, nnz = 1 << 10, 6
    B, C, k = 8, 32, 4
    q_dense, ri, rv = _euclid_inputs(rng, B, C, dim, nnz)

    d, gidx = ring_euclid_topk(mesh, shard_rows(mesh, _t(q_dense)),
                               shard_rows(mesh, _t(ri)),
                               shard_rows(mesh, _t(rv)), k=k)
    d, gidx = d.numpy(), gidx.numpy()
    dense_rows = []
    for b in range(B):
        dense = np.asarray(jknn.euclid_distances(ri, rv, q_dense[b]))
        dense_rows.append(dense)
        want = np.sort(dense)[:k]
        np.testing.assert_allclose(np.sort(d[b]), want, rtol=1e-5,
                                   atol=EUCLID_TOL)
        np.testing.assert_allclose(np.sort(dense[gidx[b]]), want,
                                   rtol=1e-5, atol=EUCLID_TOL)
    jd, jg = jring.ring_euclid_topk(
        jmesh, jring.shard_rows(jmesh, q_dense), jring.shard_rows(jmesh, ri),
        jring.shard_rows(jmesh, rv), k=k)
    np.testing.assert_allclose(d, np.asarray(jd), rtol=1e-5, atol=EUCLID_TOL)
    _euclid_ids_agree(d, gidx, np.asarray(jd), np.asarray(jg), dense_rows)


def test_ring_k_exceeding_table_clamps(mesh, jmesh, rng):
    """k > C must clamp to C (no +inf/fabricated-id padding columns)."""
    hash_num, dim, nnz = 32, 1 << 10, 4
    B, C = 8, 16
    q_sigs, row_sigs = _sigs(rng, hash_num, dim, nnz, B, C)
    d, gidx = ring_hamming_topk(mesh, shard_rows(mesh, _t(q_sigs)),
                                shard_rows(mesh, _t(row_sigs)),
                                hash_num=hash_num, k=24)
    assert d.shape == (B, C) and gidx.shape == (B, C)
    assert np.isfinite(d.numpy()).all()
    for b in range(B):
        assert sorted(gidx.numpy()[b].tolist()) == list(range(C))
    jd, jg = _jax_hamming(jmesh, q_sigs, row_sigs, hash_num=hash_num, k=24)
    np.testing.assert_array_equal(d.numpy(), jd)
    np.testing.assert_array_equal(gidx.numpy(), jg)


def test_ring_k_larger_than_local_block(mesh, jmesh, rng):
    """k spanning multiple blocks: the running merge must keep candidates
    from several origins (c_local = 4 here, k = 6)."""
    hash_num, dim, nnz = 32, 1 << 10, 4
    B, C, k = 8, 16, 6
    q_sigs, row_sigs = _sigs(rng, hash_num, dim, nnz, B, C)

    d, gidx = ring_hamming_topk(mesh, _t(q_sigs), _t(row_sigs),
                                hash_num=hash_num, k=k)
    d, gidx = d.numpy(), gidx.numpy()
    dense = sig_scan.hamming_plain(_t(q_sigs), _t(row_sigs),
                                   hash_num).numpy()
    for b in range(B):
        np.testing.assert_allclose(np.sort(d[b]), np.sort(dense[b])[:k],
                                   rtol=1e-6)
        assert len(set(gidx[b].tolist())) == k  # no duplicate winners
    jd, jg = _jax_hamming(jmesh, q_sigs, row_sigs, hash_num=hash_num, k=k)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(gidx, jg)


def test_ring_euclid_valid_mask_hides_dead_rows(mesh, jmesh, rng):
    """Deleted/padding rows must never surface as finite euclid hits."""
    dim, nnz = 1 << 10, 6
    B, C, k = 8, 32, 4
    q_dense, ri, rv = _euclid_inputs(rng, B, C, dim, nnz)
    valid = np.ones(C, bool)
    valid[::3] = False

    d, gidx = ring_euclid_topk(mesh, _t(q_dense), _t(ri), _t(rv), k=k,
                               valid=torch.from_numpy(valid))
    d, gidx = d.numpy(), gidx.numpy()
    finite = np.isfinite(d)
    assert valid[gidx[finite]].all(), "masked row surfaced as a finite hit"
    dense_rows = []
    for b in range(B):
        dense = np.asarray(jknn.euclid_distances(ri, rv, q_dense[b]))
        dense_rows.append(dense)
        want = np.sort(np.where(valid, dense, np.inf))[:k]
        np.testing.assert_allclose(np.sort(d[b]), want, rtol=1e-5,
                                   atol=EUCLID_TOL)
    jd, jg = jring.ring_euclid_topk(
        jmesh, jring.shard_rows(jmesh, q_dense), jring.shard_rows(jmesh, ri),
        jring.shard_rows(jmesh, rv), k=k,
        valid=jring.shard_rows(jmesh, jnp.asarray(valid)))
    np.testing.assert_allclose(d, np.asarray(jd), rtol=1e-5, atol=EUCLID_TOL)
    _euclid_ids_agree(d, gidx, np.asarray(jd), np.asarray(jg), dense_rows)


def test_ring_hamming_valid_mask_matches_jax(mesh, jmesh, rng):
    """A masked hamming ring answers the JAX ring's distances and ids
    exactly, the masked rows' −inf ties included."""
    hash_num, dim, nnz = 64, 1 << 12, 8
    B, C, k = 8, 32, 16               # 12 live rows: 4 −inf columns
    q_sigs, row_sigs = _sigs(rng, hash_num, dim, nnz, B, C)
    valid = np.ones(C, bool)
    valid[1::2] = False
    valid[:8] = False                 # one whole block dead
    d, gidx = ring_hamming_topk(mesh, _t(q_sigs), _t(row_sigs),
                                hash_num=hash_num, k=k,
                                valid=torch.from_numpy(valid))
    jd, jg = _jax_hamming(jmesh, q_sigs, row_sigs, valid=valid,
                          hash_num=hash_num, k=k)
    np.testing.assert_array_equal(d.numpy(), jd)
    np.testing.assert_array_equal(gidx.numpy(), jg)
    assert np.isinf(jd).any()


def test_ring_rejects_indivisible_row_count(mesh, rng):
    """C % shards != 0 must raise, not silently drop rows."""
    dim, nnz, hash_num = 1 << 10, 4, 32
    B, C = 8, 13  # 13 % 4 != 0
    q_sigs, row_sigs = _sigs(rng, hash_num, dim, nnz, B, C)
    with pytest.raises(ValueError, match="not divisible"):
        ring_hamming_topk(mesh, _t(q_sigs), _t(row_sigs),
                          hash_num=hash_num, k=4)
