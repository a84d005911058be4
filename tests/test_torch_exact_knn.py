"""The port's exact scorers (jubatus_tpu_torch.ops.knn densify / dot_scores /
row_norms / cosine_scores / euclid_distances), the exact methods of its
NNBackend and RowStore.device_view, against jubatus_tpu.ops.knn and the JAX
backend on the same seeded numpy inputs, on the CPU.

Tolerance: float32 sums whose order may differ between XLA and torch, so
rtol 1e-5 with atol 1e-6 on scores and distances (a few float32 ulps of the
terms summed); densify of distinct indices is exact. Euclid distances of
whole rows are compared squared (rtol 1e-5, atol 1e-5): the expansion
||r||² - 2 r·q + ||q||² cancels, so near 0 an error of a few float32 ulps of
the squared norms (~1e-6 at these norms) becomes ~1e-3 after the square
root.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jubatus_tpu.models._nn_backend import NNBackend as JBackend
from jubatus_tpu.ops import knn as jknn
from jubatus_tpu_torch.core.row_store import RowStore
from jubatus_tpu_torch.models._nn_backend import NNBackend
from jubatus_tpu_torch.ops import knn

RTOL, ATOL = 1e-5, 1e-6
ATOL_SQ = 1e-5
DIM = 1 << 10


def assert_distances_close(got, want, method):
    """Same dead (+inf) entries; finite ones within the tolerance above."""
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    if method in ("euclid", "euclid_lsh"):
        np.testing.assert_allclose(got[fin] ** 2, want[fin] ** 2, rtol=RTOL,
                                   atol=ATOL_SQ)
    else:
        np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _arenas(rng, c=40, k=8, dead=(3, 17)):
    """[C, K] padded rows over DIM features; the rows in ``dead`` are all
    padding, and each row's tail is padding after a random width."""
    idx = rng.integers(1, DIM, (c, k)).astype(np.int32)
    val = rng.normal(size=(c, k)).astype(np.float32)
    for r in range(c):
        w = int(rng.integers(1, k + 1))
        idx[r, w:] = 0
        val[r, w:] = 0.0
    idx[list(dead)] = 0
    val[list(dead)] = 0.0
    return idx, val


def _query(rng, n=12):
    qi = rng.integers(1, DIM, n).astype(np.int32)
    qi[1] = qi[0]
    qi[5] = qi[0]                                   # a triple duplicate
    qv = rng.normal(size=n).astype(np.float32)
    return qi, qv


def test_densify_sums_duplicate_indices(rng):
    qi, qv = _query(rng)
    got = knn.densify(torch.from_numpy(qi), torch.from_numpy(qv), dim=DIM)
    want = np.asarray(jknn.densify(jnp.asarray(qi), jnp.asarray(qv), dim=DIM))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert got[int(qi[0])] == pytest.approx(float(qv[0] + qv[1] + qv[5]),
                                            rel=1e-6)
    distinct = np.setdiff1d(np.arange(DIM), qi[[0, 1, 5]])
    np.testing.assert_array_equal(got.numpy()[distinct], want[distinct])


def test_densify_of_distinct_indices_is_exact(rng):
    qi = rng.choice(np.arange(1, DIM), 20, replace=False).astype(np.int32)
    qv = rng.normal(size=20).astype(np.float32)
    got = knn.densify(torch.from_numpy(qi), torch.from_numpy(qv), dim=DIM)
    want = np.asarray(jknn.densify(jnp.asarray(qi), jnp.asarray(qv), dim=DIM))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fn", ["dot_scores", "cosine_scores",
                                "euclid_distances"])
def test_scorers_match_jax(rng, fn):
    idx, val = _arenas(rng)
    qi, qv = _query(rng)
    qd = np.asarray(jknn.densify(jnp.asarray(qi), jnp.asarray(qv), dim=DIM))
    got = getattr(knn, fn)(torch.from_numpy(idx), torch.from_numpy(val),
                           torch.from_numpy(qd.copy()))
    want = np.asarray(getattr(jknn, fn)(jnp.asarray(idx), jnp.asarray(val),
                                        jnp.asarray(qd)))
    assert got.shape == want.shape == (idx.shape[0],)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_row_norms_match_jax(rng):
    idx, val = _arenas(rng)
    got = knn.row_norms(torch.from_numpy(idx), torch.from_numpy(val))
    want = np.asarray(jknn.row_norms(jnp.asarray(idx), jnp.asarray(val)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_edge_rules(rng):
    """Dead and zero rows score 0 for cosine (a zero query too); the clamp
    before the square root keeps a row's distance to itself at a finite
    value near 0, never NaN."""
    idx, val = _arenas(rng)
    ti, tv = torch.from_numpy(idx), torch.from_numpy(val)
    q = knn.densify(ti[0], tv[0], dim=DIM)
    cos = knn.cosine_scores(ti, tv, q)
    assert float(cos[3]) == 0.0 and float(cos[17]) == 0.0
    assert float(cos[0]) == pytest.approx(1.0, abs=1e-6)
    zero = knn.cosine_scores(ti, tv, torch.zeros(DIM))
    assert torch.equal(zero, torch.zeros_like(zero))
    d = knn.euclid_distances(ti, tv, q)
    assert torch.isfinite(d).all() and float(d[0]) < 1e-3
    # rows whose ||r||² - 2 r·q + ||q||² rounds below 0 clamp to exactly 0
    big = torch.full((1, 2), 3e3)
    bi = torch.tensor([[5, 6]], dtype=torch.int32)
    qb = knn.densify(bi[0], big[0] * (1 + 1e-7), dim=DIM)
    assert float(knn.euclid_distances(bi, big, qb)[0]) >= 0.0


def _fill(rows, jbe, tbe):
    for rid, vec in rows:
        jbe.set_row(rid, vec)
        tbe.set_row(rid, vec)


def _vecs(rng, n=50):
    out = []
    for r in range(n):
        ii = rng.choice(np.arange(1, 64), int(rng.integers(1, 9)), replace=False)
        out.append((f"r{r}", [(int(i), float(np.round(rng.normal(), 3)))
                              for i in sorted(ii)]))
    return out


@pytest.mark.parametrize("method", ["inverted_index", "euclid"])
def test_backend_exact_distances_match_jax(rng, method):
    rows = _vecs(rng)
    jbe = JBackend(method, dim=DIM)
    tbe = NNBackend(method, dim=DIM, device="cpu")
    _fill(rows, jbe, tbe)
    jbe.remove_row("r7")
    tbe.remove_row("r7")
    for q in ([(3, 1.0), (9, -2.0)], rows[4][1], []):
        assert_distances_close(tbe.distances(q), jbe.distances(q), method)
    slots = np.asarray(sorted(tbe.store.slots.values()))
    assert_distances_close(tbe.distances_from_slots(slots),
                           jbe.distances_from_slots(slots), method)


@pytest.mark.parametrize("method", ["inverted_index", "euclid"])
def test_backend_exact_neighbors_match_jax(rng, method):
    """Nearest rows: the distance lists agree within the tolerance, and
    the ids agree as a set below the k-th distance less 1e-3 (rows within
    the tolerance of the k-th distance may order either way)."""
    rows = _vecs(rng, 80)
    jbe = JBackend(method, dim=DIM)
    tbe = NNBackend(method, dim=DIM, device="cpu")
    _fill(rows, jbe, tbe)
    for q in (rows[1][1], [(5, 1.0), (6, 1.0), (40, -0.5)]):
        want = jbe.neighbors(q, 10)
        got = tbe.neighbors(q, 10)
        assert_distances_close(np.array([d for _, d in got]),
                               np.array([d for _, d in want]), method)
        edge = want[-1][1]
        assert {r for r, d in got if d < edge - 1e-3} == \
            {r for r, d in want if d < edge - 1e-3}


def test_similarity_convention():
    for method, want in (("inverted_index", 0.75), ("euclid", -0.25),
                         ("lsh", 0.75), ("euclid_lsh", -0.25)):
        be = NNBackend(method, dim=DIM, device="cpu")
        assert float(be.similarity_from_distance(np.float32(0.25))) == want


def test_exact_backend_holds_no_signatures():
    be = NNBackend("euclid", dim=DIM, device="cpu")
    be.set_row("a", [(1, 1.0)])
    assert be.flush() == 0 and be.sig_table() is None
    assert be.neighbors([(1, 1.0)], 3) == [("a", 0.0)]


def test_device_view_is_cached_per_version():
    rs = RowStore()
    rs.set_row("a", [(1, 1.0), (2, 2.0)])
    idx, val, live = rs.device_view("cpu")
    assert rs.device_view("cpu")[0] is idx
    np.testing.assert_array_equal(idx.numpy(), rs.idx)
    np.testing.assert_array_equal(val.numpy(), rs.val)
    np.testing.assert_array_equal(live.numpy(), rs.live)
    rs.idx[0, 0] = 99                            # the view is a copy
    assert int(idx[0, 0]) == 1
    rs.idx[0, 0] = 1
    rs.set_row("b", [(3, 3.0)])
    idx2, _, live2 = rs.device_view("cpu")
    assert idx2 is not idx and int(live2.sum()) == 2
    rs.clear()
    assert int(rs.device_view("cpu")[2].sum()) == 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fn", ["cosine_scores", "euclid_distances"])
def test_scorers_on_card_match_cpu(cuda, rng, fn):
    """On the card the densify's atomics sum colliding indices in no fixed
    order: the same tolerance as against JAX."""
    idx, val = _arenas(rng)
    qi, qv = _query(rng)
    cpu = getattr(knn, fn)(torch.from_numpy(idx), torch.from_numpy(val),
                           knn.densify(torch.from_numpy(qi),
                                       torch.from_numpy(qv), dim=DIM))
    dev = getattr(knn, fn)(torch.from_numpy(idx).to(cuda),
                           torch.from_numpy(val).to(cuda),
                           knn.densify(torch.from_numpy(qi).to(cuda),
                                       torch.from_numpy(qv).to(cuda), dim=DIM))
    np.testing.assert_allclose(dev.cpu().numpy(), cpu.numpy(), rtol=RTOL,
                               atol=ATOL)
