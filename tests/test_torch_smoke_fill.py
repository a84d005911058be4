"""``chip_smoke.py``'s bulk fill of phases 3 and 5 against the per-row
fill it replaced, on the CPU at a small size: the same row arenas and
bookkeeping, the same signatures after the flush and the same answers,
for the hash methods' backends and the exact recommender's."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def cs():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def _backend(method):
    from jubatus_tpu_torch.models._nn_backend import NNBackend

    return NNBackend(method, dim=1 << 18, hash_num=64, seed=0, device="cpu")


def _recommender():
    from jubatus_tpu_torch.models.recommender import RecommenderDriver

    return RecommenderDriver({
        "method": "inverted_index",
        "converter": {"num_rules": [{"key": "*", "type": "num"}]}},
        device="cpu").backend


@pytest.mark.parametrize("make", ["lsh", "minhash", "euclid_lsh",
                                  "recommender"])
@pytest.mark.parametrize("rows", [0, 1, 700])
def test_bulk_fill_leaves_the_state_of_the_per_row_fill(cs, monkeypatch,
                                                        make, rows):
    monkeypatch.setattr(cs, "FILL_STEP", 300)     # several draws per fill
    pair = [_recommender() if make == "recommender" else _backend(make)
            for _ in range(2)]
    ref, bulk = pair
    v0 = bulk.store.version
    cs.fill_rows(ref, rows, seed=7)
    cs.bulk_fill(bulk, rows, seed=7)
    a, b = ref.store, bulk.store
    assert (b.version > v0 and b.version != a.version) == (rows > 0)
    for key in ("capacity", "width", "ids", "slots", "_clock", "_touch",
                "updated_since_mix", "datums"):
        assert getattr(a, key) == getattr(b, key), key
    for key in ("idx", "val", "live"):
        x, y = getattr(a, key), getattr(b, key)
        assert x.dtype == y.dtype and x.shape == y.shape, key
        np.testing.assert_array_equal(x, y, err_msg=key)
    assert list(ref._pending) == list(bulk._pending)
    assert ref.flush() == bulk.flush()
    if ref._sigs is not None:
        assert ref._sigs.dtype == bulk._sigs.dtype
        np.testing.assert_array_equal(ref._sigs.numpy(), bulk._sigs.numpy())
    if rows:
        rng = np.random.default_rng(3)
        for _ in range(3):
            vec = list(zip(rng.integers(1, 1 << 18, 32).tolist(),
                           (rng.random(32) + 0.05).tolist()))
            assert ref.neighbors(vec, 5) == bulk.neighbors(vec, 5)


def test_bulk_fill_refuses_a_store_it_cannot_stand_for(cs):
    be = _backend("lsh")
    be.set_row("x", [(1, 1.0)])
    with pytest.raises(cs.SmokeError, match="empty"):
        cs.bulk_fill(be, 10, seed=0)
