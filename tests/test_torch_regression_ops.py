"""The port's regression ops (jubatus_tpu_torch/ops/regression.py) and the
per-example scan (ops/online_scan.py) against the JAX package's, on the CPU.

Mirrors tests/test_regression_ops.py (PA, PA1, PA2 learn; two replicas mix)
on the port, then holds it against jubatus_tpu on the same seeded numpy
inputs, with duplicate indices and padding in the rows.

Tolerances, and why: the scan adds each example's K products in the CUDA
kernel's order (32 lanes, then a tree), XLA in sequence, so a prediction
differs by a few ulps of sum|w x|, and the update after it by as much.
Trained weights are compared against their scale: |d| <= 1e-5 * max|want|
+ 1e-4 * |want|. Estimates over one shared state: |d| <= 8 K eps
sum|w x|. put_diff has no sum and is bit-equal.

The kernel itself is held bit-equal to the plain version on the card
(``cuda`` tests here and chip_smoke.py).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jubatus_tpu.ops import regression as JR
from jubatus_tpu_torch.core.sparse import SparseBatch
from jubatus_tpu_torch.ops import online_scan
from jubatus_tpu_torch.ops import regression as R

DIM = 1 << 12
EPS = np.finfo(np.float32).eps


def T(a):
    return torch.from_numpy(np.array(a))


def make_linear(rng, n, n_features=8, noise=0.01):
    feat_idx = rng.choice(np.arange(1, DIM), size=n_features, replace=False)
    w_true = rng.normal(size=n_features)
    x = rng.normal(size=(n, n_features))
    y = x @ w_true + noise * rng.normal(size=n)
    vectors = [[(int(feat_idx[j]), float(x[i, j])) for j in range(n_features)]
               for i in range(n)]
    return vectors, y


def assert_table_close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()) + 1e-12,
                               err_msg=what)


# -- the reference's own tests, on the port ------------------------------------
@pytest.mark.parametrize("method", R.METHODS)
def test_regression_learns(method, rng):
    vectors, y = make_linear(rng, 400)
    sb = SparseBatch.from_vectors(vectors)
    idx, val = T(sb.idx), T(sb.val)
    targets = T(y.astype(np.float32))
    state = R.init_state(DIM, device="cpu")
    for _ in range(5):
        state = R.train_batch(state, idx, val, targets, 0.01, 1.0,
                              method=method)
    pred = R.estimate(state, idx, val)
    rmse = float(torch.sqrt(torch.mean((pred - targets) ** 2)))
    assert rmse < 0.25, f"{method}: rmse={rmse}"


def test_mix_two_replicas(rng):
    vectors, y = make_linear(rng, 400)
    states = []
    for lo, hi in ((0, 200), (200, 400)):
        sb = SparseBatch.from_vectors(vectors[lo:hi])
        st = R.init_state(DIM, device="cpu")
        for _ in range(3):
            st = R.train_batch(st, T(sb.idx), T(sb.val),
                               T(y[lo:hi].astype(np.float32)), 0.01, 1.0,
                               method="PA1")
        states.append(st)
    total = R.mix_diffs(R.get_diff(states[0]), R.get_diff(states[1]))
    mixed = R.put_diff(states[0], total)
    sb = SparseBatch.from_vectors(vectors)
    pred = R.estimate(mixed, T(sb.idx), T(sb.val))
    rmse = float(torch.sqrt(torch.mean((pred - T(y.astype(np.float32))) ** 2)))
    assert rmse < 0.5
    assert float(mixed.dw.abs().max()) == 0.0


# -- against the JAX package ------------------------------------------------------
def _batches(seed, n_batches=3, b=64, k=40):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        idx = rng.integers(1, 300, size=(b, k)).astype(np.int32)
        val = rng.normal(size=(b, k)).astype(np.float32)
        idx[:, -6:] = 0          # padding
        val[:, -6:] = 0.0
        idx[::3, 5] = idx[::3, 2]   # duplicates in one round of 32 ...
        idx[::4, 33] = idx[::4, 1]  # ... and across rounds
        y = (rng.normal(size=b) * 3).astype(np.float32)
        out.append((idx, val, y))
    return out


def _both(method, batches, sens=0.1, c=0.7):
    js = JR.init_state(DIM)
    ts = R.init_state(DIM, device="cpu")
    for idx, val, y in batches:
        js = JR.train_batch(js, jnp.asarray(idx), jnp.asarray(val),
                            jnp.asarray(y), sens, c, method=method)
        ts = R.train_batch(ts, T(idx), T(val), T(y), sens, c, method=method)
    return js, ts


@pytest.mark.parametrize("c", [0.13, 0.7])
@pytest.mark.parametrize("method", R.METHODS)
def test_train_matches_jax(method, c):
    js, ts = _both(method, _batches(1), c=c)
    assert_table_close(ts.dw.numpy(), np.asarray(js.dw), method)
    np.testing.assert_array_equal(ts.w.numpy(), np.asarray(js.w))
    assert float(ts.dw.abs().max()) > 0.0


@pytest.mark.parametrize("method", R.METHODS)
def test_estimate_matches_jax(method):
    js, _ = _both(method, _batches(2))
    ts = R.RegressionState(T(np.asarray(js.w)), T(np.asarray(js.dw)))
    idx, val, _ = _batches(3, n_batches=1)[0]
    want = np.asarray(JR.estimate(js, jnp.asarray(idx), jnp.asarray(val)))
    got = R.estimate(ts, T(idx), T(val)).numpy()
    eff = np.asarray(js.w + js.dw)[idx]
    tol = 8 * idx.shape[1] * EPS * np.abs(eff * val).sum(1)
    assert (np.abs(got - want) <= tol + 1e-30).all()


def test_put_diff_matches_jax():
    a, b = _both("PA1", _batches(4)), _both("PA1", _batches(5))
    jd = JR.mix_diffs(JR.get_diff(a[0]), JR.get_diff(b[0]))
    td = {"dw": np.asarray(jd["dw"]), "count": float(jd["count"])}
    want = JR.put_diff(a[0], jd)
    base = R.RegressionState(T(np.asarray(a[0].w)), T(np.asarray(a[0].dw)))
    got = R.put_diff(base, td)
    np.testing.assert_array_equal(got.w.numpy(), np.asarray(want.w))
    assert float(got.dw.abs().max()) == 0.0


def test_padding_rows_are_noops():
    idx, val, y = _batches(6, n_batches=1)[0]
    padded_idx = np.concatenate([idx, np.zeros((16, idx.shape[1]), np.int32)])
    padded_val = np.concatenate([val, np.zeros((16, val.shape[1]), np.float32)])
    padded_y = np.concatenate([y, np.zeros(16, np.float32)])
    a = R.train_batch(R.init_state(DIM, device="cpu"), T(idx), T(val), T(y),
                      0.1, 1.0, method="PA")
    b = R.train_batch(R.init_state(DIM, device="cpu"), T(padded_idx),
                      T(padded_val), T(padded_y), 0.1, 1.0, method="PA")
    assert torch.equal(a.dw, b.dw)


# -- the scan's plain version ---------------------------------------------------
def _serial_reference(w, dw, idx, val, y, sens, c, method):
    """The scan in numpy float32, one operation at a time, summing in the
    kernel's lane order and scattering serially in k order."""
    sens, c = np.float32(sens), np.float32(c)
    dw = dw.copy()
    k = idx.shape[1]
    rounds = -(-k // 32)
    for b in range(idx.shape[0]):
        e_idx, e_val = idx[b], val[b]
        prod = np.zeros(rounds * 32, np.float32)
        sq = np.zeros(rounds * 32, np.float32)
        prod[:k] = (w[e_idx] + dw[e_idx]) * e_val
        sq[:k] = e_val * e_val
        lanes_p, lanes_x = prod[:32].copy(), sq[:32].copy()
        for r in range(1, rounds):
            lanes_p = lanes_p + prod[r * 32:(r + 1) * 32]
            lanes_x = lanes_x + sq[r * 32:(r + 1) * 32]
        off = 16
        while off:
            lanes_p = lanes_p[:off] + lanes_p[off:2 * off]
            lanes_x = lanes_x[:off] + lanes_x[off:2 * off]
            off //= 2
        pred, x2 = lanes_p[0], max(lanes_x[0], np.float32(1e-12))
        err = np.float32(y[b] - pred)
        loss = np.float32(abs(err) - sens)
        if method == "PA":
            alpha = loss / x2
        elif method == "PA1":
            alpha = min(c, loss / x2)
        else:
            alpha = loss / (x2 + np.float32(1.0) / (np.float32(2.0) * c))
        alpha = np.float32(alpha if loss > 0 else 0.0)
        step = np.float32(np.sign(err) * alpha)
        for kk in range(k):
            dw[e_idx[kk]] = np.float32(dw[e_idx[kk]] + step * e_val[kk])
    return dw


@pytest.mark.parametrize("method", R.METHODS)
def test_plain_scan_is_the_serial_definition(method):
    """pa_scan_plain is bit-equal to the scan written out element by
    element in numpy: the order the kernel follows."""
    idx, val, y = _batches(7, n_batches=1, b=24, k=70)[0]
    w = (np.random.default_rng(8).normal(size=DIM) * 0.1).astype(np.float32)
    dw = np.zeros(DIM, np.float32)
    got = online_scan.pa_scan_plain(T(w), T(dw), T(idx), T(val), T(y), 0.1,
                                    0.7, method)
    want = _serial_reference(w, dw, idx, val, y, 0.1, 0.7, method)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_on_the_cpu_runs_the_plain_version_uncounted():
    idx, val, y = _batches(9, n_batches=1, b=8)[0]
    before = online_scan.pa_scan.launches
    dw = torch.zeros(DIM)
    online_scan.pa_scan(torch.zeros(DIM), dw, T(idx), T(val), T(y), 0.1, 1.0,
                        "PA")
    assert online_scan.pa_scan.launches == before
    assert float(dw.abs().max()) > 0.0


@pytest.mark.parametrize("bad", ["dtype", "shape", "method"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    idx, val, y = (T(a) for a in _batches(10, n_batches=1, b=4)[0])
    w, dw = torch.zeros(DIM), torch.zeros(DIM)
    method = "PA"
    if bad == "dtype":
        idx = idx.long()
    elif bad == "shape":
        y = y[:2]
    else:
        method = "PA3"
    with pytest.raises((TypeError, ValueError)):
        online_scan.pa_scan(w, dw, idx, val, y, 0.1, 1.0, method)


def test_tile_fits_shared_memory():
    for k in (1, 8, 64, 100, 128, 129, 1024, 6000, online_scan.MAX_K):
        t = online_scan.tile_for(k)
        assert 1 <= t <= online_scan.MAX_TILE
        assert online_scan.smem_bytes(k) <= online_scan.MAX_SMEM
        if online_scan.choose_variant(k) == "direct":
            assert t * k * 8 + t * 4 + 128 <= max(online_scan.TILE_BYTES,
                                                  k * 8 + 132)
        else:
            assert t * k <= online_scan.TILE_ELEMS


@pytest.mark.parametrize("k,variant", [
    (1, "r1"), (16, "r1"), (32, "r1"), (33, "r2"), (64, "r2"), (65, "r4"),
    (128, "r4"), (129, "direct"), (4096, "direct"),
    (online_scan.MAX_K, "direct")])
def test_variant_chosen_by_width(k, variant):
    assert online_scan.choose_variant(k) == variant


def test_shared_memory_budget_of_every_width():
    """Every width the wrapper takes fits the H100's 227 KB a block, and a
    table variant keeps room for a full tile above its flush threshold."""
    for k in range(1, online_scan.MAX_K + 1):
        assert online_scan.smem_bytes(k) <= online_scan.MAX_SMEM, k
        if online_scan.choose_variant(k) != "direct":
            cap = online_scan.table_capacity(k)
            assert cap > 0
            assert cap + online_scan.tile_for(k) * k \
                <= online_scan.TABLE_SLOTS * 3 // 4


@pytest.mark.parametrize("k", [0, -3, online_scan.MAX_K + 1, 1 << 16])
def test_no_variant_takes_refused_widths(k):
    with pytest.raises(ValueError, match="no kernel variant"):
        online_scan.choose_variant(k)


def test_plan_refuses_a_cpu_tensor():
    idx, val, y = (T(a) for a in _batches(13, n_batches=1, b=4)[0])
    with pytest.raises(ValueError, match="no kernel"):
        online_scan.pa_scan.plan(torch.zeros(DIM), torch.zeros(DIM), idx,
                                 val, y, 0.1, 1.0, "PA")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _on_card_and_cpu(cuda, w, idx, val, y, method, sens=0.1, c=0.7,
                     dim=None):
    """The kernel on the card and the plain version on the CPU from the
    same inputs: (card dw on the CPU, CPU dw, the launch's counters)."""
    dim = dim or w.shape[0]
    dw_cpu = online_scan.pa_scan_plain(T(w), torch.zeros(dim), T(idx),
                                       T(val), T(y), sens, c, method)
    before = online_scan.pa_scan.launches
    variant = online_scan.choose_variant(idx.shape[1])
    by_before = online_scan.pa_scan.by_variant[variant]
    dw_card = torch.zeros(dim, device=cuda)
    online_scan.pa_scan(T(w).to(cuda), dw_card, T(idx).to(cuda),
                        T(val).to(cuda), T(y).to(cuda), sens, c, method)
    torch.cuda.synchronize()
    assert online_scan.pa_scan.launches == before + 1
    assert online_scan.pa_scan.by_variant[variant] == by_before + 1
    return dw_card.cpu(), dw_cpu, online_scan.pa_scan.stats()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 16, 31, 33, 64, 70, 128, 200, 4096])
@pytest.mark.parametrize("method", R.METHODS)
def test_kernel_is_bit_equal_to_the_plain_version(cuda, method, k):
    """Duplicates within a round, across rounds and across tiles; padding."""
    idx, val, y = _batches(11, n_batches=1, b=300, k=max(k, 40))[0]
    idx, val = np.ascontiguousarray(idx[:, :k]), np.ascontiguousarray(val[:, :k])
    w = (np.random.default_rng(12).normal(size=DIM) * 0.1).astype(np.float32)
    got, want, _ = _on_card_and_cpu(cuda, w, idx, val, y, method)
    assert torch.equal(got, want)
    assert float(want.abs().max()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 64])
@pytest.mark.parametrize("edge", [None, -1, 0, 1])
@pytest.mark.parametrize("method", R.METHODS)
def test_kernel_at_one_tile_and_one_example(cuda, method, edge, k):
    """B = 1, and B at one tile less one, one tile, one tile and one."""
    b = 1 if edge is None else online_scan.tile_for(k) + edge
    idx, val, y = _batches(14 + b, n_batches=1, b=b, k=max(k, 40))[0]
    idx, val = np.ascontiguousarray(idx[:, :k]), np.ascontiguousarray(val[:, :k])
    w = (np.random.default_rng(15).normal(size=DIM) * 0.1).astype(np.float32)
    got, want, _ = _on_card_and_cpu(cuda, w, idx, val, y, method)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 64])
@pytest.mark.parametrize("method", ["PA", "PA2"])
def test_kernel_with_an_infinite_step(cuda, method, k):
    """A step that overflows (a huge target over tiny values) makes the
    padding columns' updates 0 * inf = NaN, as in the plain version: the
    NaNs land where the plain version puts them, and every other weight is
    bit-equal."""
    idx, val, y = _batches(18, n_batches=1, b=40, k=max(k, 40))[0]
    idx, val = np.ascontiguousarray(idx[:, :k]), np.ascontiguousarray(val[:, :k])
    val[5] *= np.float32(1e-25)
    y[5] = np.float32(3e38)
    w = (np.random.default_rng(19).normal(size=DIM) * 0.1).astype(np.float32)
    got, want, _ = _on_card_and_cpu(cuda, w, idx, val, y, method)
    assert bool(want.isnan().any())
    assert torch.equal(got.isnan(), want.isnan())
    keep = ~want.isnan()
    assert torch.equal(got[keep], want[keep])


def _distinct_rows(k, b, dim, seed, repeat_first):
    """b rows of k keys, no key repeated anywhere, except (repeat_first)
    that the last row repeats the first row's first key and the row
    before's first key."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(np.arange(1, dim))[:b * k].reshape(b, k)
    idx = idx.astype(np.int32)
    if repeat_first:
        idx[-1, 0] = idx[0, 0]
        idx[-1, 1] = idx[-2, 0]
    val = rng.normal(size=(b, k)).astype(np.float32)
    y = (rng.normal(size=b) * 3).astype(np.float32)
    w = (rng.normal(size=dim) * 0.1).astype(np.float32)
    return w, idx, val, y


@pytest.mark.cuda
@pytest.mark.parametrize("over", [0, 1])
@pytest.mark.parametrize("k", [16, 64])
@pytest.mark.parametrize("method", R.METHODS)
def test_kernel_at_and_over_the_table_capacity(cuda, method, k, over):
    """Tiles of distinct keys fill the table to exactly 3/4 of its slots (no
    flush); one example more flushes once, and two of its keys, written
    before the flush (one by the first tile, one by the tile walked while
    the flush began), are read back after it."""
    tile = online_scan.tile_for(k)
    full_tiles = online_scan.TABLE_SLOTS * 3 // 4 // (tile * k)
    assert full_tiles * tile * k - tile * k == online_scan.table_capacity(k)
    b = full_tiles * tile + over
    dim = 1 << 16
    w, idx, val, y = _distinct_rows(k, b, dim, 16 + k + over,
                                    repeat_first=bool(over))
    got, want, stats = _on_card_and_cpu(cuda, w, idx, val, y, method,
                                        dim=dim)
    assert stats["flushes"] == over
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("method", R.METHODS)
def test_kernel_across_several_flushes(cuda, method):
    """Rows over 2^16 features with padding and duplicates: ~2.3·10^4
    distinct keys, two flushes or more, keys coming back after each."""
    rng = np.random.default_rng(20)
    dim = 1 << 16
    idx = rng.integers(1, dim, size=(600, 64)).astype(np.int32)
    val = rng.normal(size=(600, 64)).astype(np.float32)
    idx[:, 48:] = 0
    val[:, 48:] = 0.0
    idx[::3, 5] = idx[::3, 2]
    idx[::5, 37] = idx[::5, 2]
    y = (rng.normal(size=600) * 3).astype(np.float32)
    w = (rng.normal(size=dim) * 0.1).astype(np.float32)
    got, want, stats = _on_card_and_cpu(cuda, w, idx, val, y, method)
    assert stats["flushes"] >= 2
    assert torch.equal(got, want)


def _server_batch(rows, seed):
    """Rows as a regression server's traffic looks (8 of 64 numeric keys, 1
    of 40 cities, 1 of 7 kinds), featurized by the CPU driver of
    config/regression/default.json."""
    import json
    import os

    from jubatus_tpu_torch.core.datum import Datum
    from jubatus_tpu_torch.models.regression import RegressionDriver

    path = os.path.join(os.path.dirname(__file__), "..", "config",
                        "regression", "default.json")
    with open(path) as f:
        driver = RegressionDriver(json.load(f), device="cpu")
    rng = np.random.default_rng(seed)
    data = []
    for i in range(rows):
        d = Datum()
        for j in rng.choice(64, 8, replace=False):
            d.add(f"f{j}", float(np.round(rng.standard_normal(), 3)))
        d.add("city", f"c{int(rng.integers(40))}")
        d.add("kind", f"k{i % 7}")
        data.append((float(rng.normal() * 3), d))
    targets, idx, val = driver.featurize_train(data)
    w = (rng.normal(size=driver.converter.dim) * 0.1).astype(np.float32)
    return w, idx, val, targets


@pytest.mark.cuda
@pytest.mark.parametrize("method", R.METHODS)
def test_kernel_on_a_server_shaped_batch(cuda, method):
    w, idx, val, y = _server_batch(1024, seed=17)
    assert idx.shape[1] == 16
    got, want, stats = _on_card_and_cpu(cuda, w, idx, val, y, method)
    assert stats["flushes"] == 0
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_launch_layout_matches_the_wrapper(cuda):
    lib = online_scan.library()
    for k in (1, 16, 31, 33, 64, 70, 128, 129, 4096, online_scan.MAX_K):
        variant = online_scan.VARIANTS.index(online_scan.choose_variant(k))
        assert lib.jt_pa_scan_smem_bytes(k, online_scan.tile_for(k),
                                         variant) == online_scan.smem_bytes(k)
