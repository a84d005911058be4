"""The port's linear classifier ops (jubatus_tpu_torch/ops/classifier.py)
against the JAX package's, on the CPU.

Mirrors tests/test_classifier_ops.py and tests/test_classifier_schema_path.py
on the port, then holds the port against jubatus_tpu on the same seeded
numpy inputs: all seven methods, the parallel, sequential, schema and combo
paths, duplicate indices, label growth, row-trimmed put_diff.

Tolerances, and why:

- Element-wise work (``_alpha_and_prec``, ``decide_updates``) is bit-equal:
  no sum is involved and the parameter is a float32 tensor, as the JAX jit
  traces it. CW's closed form is the exception, within 4 ulps (rtol 5e-7):
  XLA contracts its multiply-adds into fused multiply-adds.
- Every sum over K differs in order: XLA on the CPU adds the K products in
  sequence with fused multiply-adds, PyTorch in its vectorized order. So
  scores agree within a few float32 ulps of sum|w*x|: |d| <= 8 * K * eps *
  sum|w*x| (``_sum_tol``).
- Trained tables carry that through margins, alphas and updates, and
  updates of both signs that land on one weight cancel, so relative error
  per element is meaningless near 0. They are compared against the table's
  scale: |d| <= 1e-5 * max|want| + 1e-4 * |want|.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jubatus_tpu.core.sparse import SparseBatch as JSparseBatch
from jubatus_tpu.ops import classifier as JC
from jubatus_tpu_torch.core.sparse import SparseBatch
from jubatus_tpu_torch.ops import classifier as C

DIM = 1 << 12
L = 4
EPS = np.finfo(np.float32).eps


def T(a):
    return torch.from_numpy(np.array(a))


def make_blobs(rng, n, n_features=16, n_classes=3, sep=3.0):
    centers = rng.normal(size=(n_classes, n_features)) * sep
    labels = rng.integers(0, n_classes, size=n)
    dense = centers[labels] + rng.normal(size=(n, n_features))
    feat_idx = rng.choice(np.arange(1, DIM), size=n_features, replace=False)
    vectors = [[(int(feat_idx[j]), float(dense[i, j]))
                for j in range(n_features)] for i in range(n)]
    return vectors, labels


def batchify(vectors, labels):
    sb = SparseBatch.from_vectors(vectors)
    return T(sb.idx), T(sb.val), T(np.asarray(labels, np.int32))


def accuracy(state, idx, val, labels, mask):
    s = C.scores(state, idx, val, mask)
    return float((s.argmax(1) == labels).float().mean())


def _mask(*live):
    return T(np.array(live, dtype=bool))


def assert_table_close(got, want, what=""):
    got = np.asarray(got)
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale + 1e-12,
                               err_msg=what)


def _sum_tol(g, v):
    """8 K eps sum|g v|: the reorder bound of a float32 sum of K terms."""
    return 8 * v.shape[-1] * EPS * np.abs(g * v).sum(-1)


# -- the reference's own tests, on the port ------------------------------------
@pytest.mark.parametrize("mode", ["parallel", "sequential"])
@pytest.mark.parametrize("method", C.METHODS)
def test_method_learns_separable_data(method, mode, rng):
    vectors, labels = make_blobs(rng, 300)
    idx, val, y = batchify(vectors, labels)
    mask = _mask(True, True, True, False)
    state = C.init_state(L, DIM, method in C.CONFIDENCE_METHODS, device="cpu")
    for _ in range(3):
        state = C.train_batch(state, idx, val, y, mask, 1.0, method=method,
                              mode=mode)
    acc = accuracy(state, idx, val, y, mask)
    assert acc > 0.9, f"{method}/{mode} failed to learn: acc={acc}"


def test_parallel_matches_sequential_on_batch_of_one(rng):
    vectors, labels = make_blobs(rng, 20)
    mask = _mask(True, True, True, False)
    s_par = C.init_state(L, DIM, True, device="cpu")
    s_seq = C.init_state(L, DIM, True, device="cpu")
    for vec, lab in zip(vectors, labels):
        sb = SparseBatch.from_vectors([vec])
        args = (T(sb.idx), T(sb.val), T(np.array([lab], np.int32)), mask, 1.0)
        s_par = C.train_batch(s_par, *args, method="AROW", mode="parallel")
        s_seq = C.train_batch(s_seq, *args, method="AROW", mode="sequential")
    np.testing.assert_allclose(s_par.dw.numpy(), s_seq.dw.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s_par.dprec.numpy(), s_seq.dprec.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_dead_labels_never_predicted(rng):
    vectors, labels = make_blobs(rng, 100, n_classes=2)
    idx, val, y = batchify(vectors, labels)
    mask = _mask(True, True, False, False)
    state = C.init_state(L, DIM, False, device="cpu")
    state = C.train_batch(state, idx, val, y, mask, 1.0, method="PA")
    s = C.scores(state, idx, val, mask)
    assert int(s.argmax(1).max()) <= 1


def test_single_label_still_learns(rng):
    vectors, labels = make_blobs(rng, 10, n_classes=1)
    idx, val, y = batchify(vectors, labels)
    mask = _mask(True, False, False, False)
    state = C.init_state(L, DIM, False, device="cpu")
    state = C.train_batch(state, idx, val, y, mask, 1.0, method="PA")
    dw = state.dw.numpy()
    assert np.abs(dw[0]).max() > 0.0
    assert np.abs(dw[1:]).max() == 0.0


def test_padding_is_noop(rng):
    vectors, labels = make_blobs(rng, 50)
    mask = _mask(True, True, True, False)
    narrow = SparseBatch.from_vectors(vectors, min_width=16)
    wide = SparseBatch.from_vectors(vectors, min_width=64)
    y = T(np.asarray(labels, np.int32))
    s1 = C.init_state(L, DIM, True, device="cpu")
    s2 = C.init_state(L, DIM, True, device="cpu")
    s1 = C.train_batch(s1, T(narrow.idx), T(narrow.val), y, mask, 1.0,
                       method="AROW")
    s2 = C.train_batch(s2, T(wide.idx), T(wide.val), y, mask, 1.0,
                       method="AROW")
    np.testing.assert_allclose(s1.dw.numpy(), s2.dw.numpy(), atol=1e-5)
    np.testing.assert_allclose(s1.dprec.numpy(), s2.dprec.numpy(), atol=1e-5)


def test_mix_diff_additive_and_order_free(rng):
    vectors, labels = make_blobs(rng, 200)
    mask = _mask(True, True, True, False)
    states = []
    for lo, hi in ((0, 100), (100, 200)):
        idx, val, y = batchify(vectors[lo:hi], labels[lo:hi])
        st = C.init_state(L, DIM, True, device="cpu")
        states.append(C.train_batch(st, idx, val, y, mask, 1.0, method="AROW"))
    d0, d1 = C.get_diff(states[0]), C.get_diff(states[1])
    m01, m10 = C.mix_diffs(d0, d1), C.mix_diffs(d1, d0)
    for k in m01:
        np.testing.assert_array_equal(np.asarray(m01[k]), np.asarray(m10[k]))
    assert float(m01["count"]) == 2.0
    mixed0 = C.put_diff(states[0], m01)
    mixed1 = C.put_diff(states[1], m10)
    np.testing.assert_allclose(mixed0.w.numpy(), mixed1.w.numpy(), atol=1e-6)
    assert float(mixed0.dw.abs().max()) == 0.0
    idx, val, y = batchify(vectors, labels)
    assert accuracy(mixed0, idx, val, y, mask) > 0.85


def test_grow_labels_preserves_model(rng):
    vectors, labels = make_blobs(rng, 100)
    idx, val, y = batchify(vectors, labels)
    mask = _mask(True, True, True, False)
    state = C.init_state(L, DIM, True, device="cpu")
    state = C.train_batch(state, idx, val, y, mask, 1.0, method="AROW")
    grown = C.grow_labels(state, 6)
    assert grown.w.shape == (6, DIM)
    np.testing.assert_array_equal(grown.w[:L].numpy(), state.w.numpy())
    assert float(grown.prec[L:].min()) == 1.0
    mask6 = _mask(True, True, True, False, False, False)
    assert accuracy(grown, idx, val, y, mask6) > 0.9


# -- tests/test_classifier_schema_path.py, on the port ----------------------------
SD, SL, SK, SB = 1 << 14, 3, 16, 64


def _schema_inputs(seed=0, dup_pad=False):
    rng = np.random.default_rng(seed)
    uidx = rng.choice(np.arange(1, SD), size=SK, replace=False).astype(np.int32)
    if dup_pad:
        uidx = np.concatenate([uidx[:-2], np.zeros(2, np.int32)])
    val = rng.normal(size=(SB, SK)).astype(np.float32)
    if dup_pad:
        val[:, -2:] = 0.0
    labels = rng.integers(0, SL, size=SB).astype(np.int32)
    return uidx, val, labels


@pytest.mark.parametrize("method", ["AROW", "CW", "NHERD", "PA", "PA1",
                                    "perceptron"])
def test_schema_train_matches_parallel(method):
    uidx, val, labels = _schema_inputs()
    mask = torch.ones(SL, dtype=torch.bool)
    conf = method in C.CONFIDENCE_METHODS
    st_a = C.init_state(SL, SD, conf, device="cpu")
    st_b = C.init_state(SL, SD, conf, device="cpu")
    tiled = T(np.broadcast_to(uidx, (SB, SK)).copy())
    for step in range(3):
        v = T(val * (1.0 + 0.1 * step))
        st_a = C.train_batch_parallel(st_a, tiled, v, T(labels), mask, 1.0,
                                      method=method)
        st_b = C.train_batch_schema(st_b, T(uidx), v, T(labels), mask, 1.0,
                                    method=method)
    np.testing.assert_allclose(st_a.dw.numpy(), st_b.dw.numpy(),
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(st_a.dprec.numpy(), st_b.dprec.numpy(),
                               rtol=2e-4, atol=1e-5)


def test_schema_scores_match_sparse():
    uidx, val, labels = _schema_inputs(seed=1)
    mask = torch.ones(SL, dtype=torch.bool)
    st = C.init_state(SL, SD, True, device="cpu")
    st = C.train_batch_schema(st, T(uidx), T(val), T(labels), mask, 1.0,
                              method="AROW")
    tiled = T(np.broadcast_to(uidx, (SB, SK)).copy())
    np.testing.assert_allclose(C.scores(st, tiled, T(val), mask).numpy(),
                               C.scores_schema(st, T(uidx), T(val),
                                               mask).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_schema_duplicate_pad_columns_are_noops():
    uidx, val, labels = _schema_inputs(seed=2, dup_pad=True)
    mask = torch.ones(SL, dtype=torch.bool)
    st_a = C.init_state(SL, SD, True, device="cpu")
    st_b = C.init_state(SL, SD, True, device="cpu")
    tiled = T(np.broadcast_to(uidx, (SB, SK)).copy())
    st_a = C.train_batch_parallel(st_a, tiled, T(val), T(labels), mask, 1.0,
                                  method="AROW")
    st_b = C.train_batch_schema(st_b, T(uidx), T(val), T(labels), mask, 1.0,
                                method="AROW")
    np.testing.assert_allclose(st_a.dw.numpy(), st_b.dw.numpy(),
                               rtol=2e-4, atol=1e-5)
    assert float(st_b.dw[:, 0].abs().sum()) == 0.0


def test_schema_zero_rows_are_noops():
    uidx, val, labels = _schema_inputs(seed=3)
    val[SB // 2:] = 0.0
    mask = torch.ones(SL, dtype=torch.bool)
    full = C.init_state(SL, SD, True, device="cpu")
    half = C.init_state(SL, SD, True, device="cpu")
    full = C.train_batch_schema(full, T(uidx), T(val), T(labels), mask, 1.0,
                                method="AROW")
    half = C.train_batch_schema(half, T(uidx), T(val[: SB // 2]),
                                T(labels[: SB // 2]), mask, 1.0, method="AROW")
    np.testing.assert_allclose(full.dw.numpy(), half.dw.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_single_label_no_rival_schema_matches_parallel():
    uidx, val, _ = _schema_inputs(seed=4)
    mask = T(np.array([True, False, False]))
    labels = np.zeros(SB, np.int32)
    st_a = C.init_state(SL, SD, True, device="cpu")
    st_b = C.init_state(SL, SD, True, device="cpu")
    tiled = T(np.broadcast_to(uidx, (SB, SK)).copy())
    st_a = C.train_batch_parallel(st_a, tiled, T(val), T(labels), mask, 1.0,
                                  method="AROW")
    st_b = C.train_batch_schema(st_b, T(uidx), T(val), T(labels), mask, 1.0,
                                method="AROW")
    np.testing.assert_allclose(st_a.dw.numpy(), st_b.dw.numpy(),
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(st_a.dprec.numpy(), st_b.dprec.numpy(),
                               rtol=2e-4, atol=1e-5)


# -- against the JAX package --------------------------------------------------------
def _batches(seed, n_batches=3, b=48, k=16, dups=True, dim=DIM, labels=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        idx = rng.integers(1, 400, size=(b, k)).astype(np.int32)
        val = rng.normal(size=(b, k)).astype(np.float32)
        if dups:  # duplicate indices within an example, and padding
            idx[::3, 5] = idx[::3, 2]
            idx[:, -3:] = 0
            val[:, -3:] = 0.0
        lab = rng.integers(0, labels, size=b).astype(np.int32)
        out.append((idx, val, lab))
    return out


def _both(method, mode, batches, mask, param):
    conf = method in C.CONFIDENCE_METHODS
    js = JC.init_state(L, DIM, conf)
    ts = C.init_state(L, DIM, conf, device="cpu")
    for idx, val, lab in batches:
        js = JC.train_batch(js, jnp.asarray(idx), jnp.asarray(val),
                            jnp.asarray(lab), jnp.asarray(mask), param,
                            method=method, mode=mode)
        ts = C.train_batch(ts, T(idx), T(val), T(lab), T(mask), param,
                           method=method, mode=mode)
    return js, ts


@pytest.mark.parametrize("mode", ["parallel", "sequential"])
@pytest.mark.parametrize("method", C.METHODS)
def test_train_matches_jax(method, mode):
    """Three batches with duplicate indices and padding, 3 live labels of
    4: every table within the stated tolerance of the JAX package's."""
    mask = np.array([True, True, True, False])
    js, ts = _both(method, mode, _batches(7), mask, 0.7)
    for name, a, b in zip(("w", "dw", "prec", "dprec"), js, ts):
        assert b.shape == tuple(a.shape), name
        assert_table_close(b.numpy(), np.asarray(a), f"{method}/{mode} {name}")
    assert float(ts.dw.abs().max()) > 0.0


@pytest.mark.parametrize("method", ["AROW", "PA1", "perceptron"])
def test_single_label_matches_jax(method):
    """One live label: the rival score is 0, and a confidence method's
    missing rival carries the unit precision prior."""
    mask = np.array([True, False, False, False])
    batches = [(i, v, np.zeros_like(lab)) for i, v, lab in _batches(8)]
    for mode in ("parallel", "sequential"):
        js, ts = _both(method, mode, batches, mask, 1.0)
        assert_table_close(ts.dw.numpy(), np.asarray(js.dw), mode)
        assert float(ts.dw[1:].abs().max()) == 0.0


@pytest.mark.parametrize("method", C.METHODS)
def test_scores_match_jax_within_sum_reorder(method):
    mask = np.array([True, True, True, False])
    batches = _batches(9)
    js, ts = _both(method, "parallel", batches, mask, 1.0)
    idx, val, _ = batches[-1]
    want = np.asarray(JC.scores(js, jnp.asarray(idx), jnp.asarray(val),
                                jnp.asarray(mask)))
    got = C.scores(ts, T(idx), T(val), T(mask)).numpy()
    np.testing.assert_array_equal(got[:, 3], want[:, 3])  # the dead label
    # the same state in both packages, so only the sum's order differs
    eff = np.asarray(js.w + js.dw)
    same = C.scores(C.ClassifierState(T(np.asarray(js.w)), T(np.asarray(js.dw)),
                                      ts.prec, ts.dprec),
                    T(idx), T(val), T(mask)).numpy()
    g = np.moveaxis(eff[:, idx], 0, -1)                      # [B, K, L]
    tol = _sum_tol(np.moveaxis(g, -1, 0), val[None])          # [L, B]
    assert (np.abs(same - want)[:, :3] <= tol.T[:, :3] + 1e-30).all()
    assert_table_close(got[:, :3], want[:, :3])


def _decision_inputs(seed, b=64, k=8, labels=4):
    rng = np.random.default_rng(seed)
    s = (rng.normal(size=(b, labels)) * 2).astype(np.float32)
    lab = rng.integers(0, 3, size=b).astype(np.int32)
    x2_vec = (rng.random(size=(b, k)) ** 2).astype(np.float32)
    x2_vec[::9] = 0.0  # rows with no features
    x2 = x2_vec.sum(1).astype(np.float32)
    v = (rng.random(size=b) * 3).astype(np.float32)
    s[::5, 1] = s[::5, 2]  # ties for the rival: the first index wins
    return s, lab, x2, v, x2_vec


@pytest.mark.parametrize("param", [0.1, 0.3, 1.0, 7.0])
@pytest.mark.parametrize("method", C.METHODS)
def test_decision_is_bit_equal_with_a_float32_parameter(method, param):
    """decide_updates / _alpha_and_prec have no sums: with the parameter
    held as a float32 tensor they equal the JAX package's bit for bit
    (1 / (2 C), x2_vec / r and (v + 2r) / r^2 round in float32), ties for
    the rival resolve to the first index, and _NEG masks dead labels."""
    s, lab, x2, v, x2_vec = _decision_inputs(int(param * 10))
    mask = np.array([True, True, True, False])
    want = JC.decide_updates(jnp.asarray(s), jnp.asarray(lab),
                             jnp.asarray(mask), jnp.asarray(x2),
                             jnp.asarray(v), jnp.asarray(x2_vec),
                             jnp.float32(param), method=method)
    got = C.decide_updates(T(s), T(lab), T(mask), T(x2), T(v), T(x2_vec),
                           torch.tensor(np.float32(param)), method=method)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for a, b in zip(want[1:], got[1:]):
        if a is None:
            assert b is None
        elif method == "CW":
            # XLA contracts CW's closed form (a*a - 8 phi (m - phi v), ...)
            # into fused multiply-adds; PyTorch rounds every operation
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=5e-7,
                                       atol=0)
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_a_python_float_parameter_would_round_differently():
    """Why the parameter is a float32 tensor: at C = 0.13, 1 / (2 C) taken
    in float64 and rounded once is not the float32 chain's value, and
    PA2's alphas built on it would not be the JAX package's bits."""
    c = 0.13
    assert np.float32(1.0 / (2.0 * c)) != \
        np.float32(1.0) / (np.float32(2.0) * np.float32(c))
    s, lab, x2, v, x2_vec = _decision_inputs(3, b=4096)
    mask = np.array([True, True, True, False])
    want = np.asarray(JC.decide_updates(
        jnp.asarray(s), jnp.asarray(lab), jnp.asarray(mask), jnp.asarray(x2),
        jnp.asarray(v), jnp.asarray(x2_vec), jnp.float32(c),
        method="PA2")[1])
    got = C.decide_updates(T(s), T(lab), T(mask), T(x2), T(v), T(x2_vec),
                           torch.tensor(np.float32(c)), method="PA2")[1]
    np.testing.assert_array_equal(got.numpy(), want)
    # the same expression with the Python float
    _, _, _, _ = s, lab, v, x2_vec
    loss = T(want) * (2.0 * torch.clamp_min(T(x2), 1e-12)
                      + torch.tensor(np.float32(1.0) / (np.float32(2.0)
                                                        * np.float32(c))))
    x2s = torch.clamp_min(T(x2), 1e-12)
    as_f32 = loss / (2.0 * x2s + 1.0 / (2.0 * torch.tensor(np.float32(c))))
    as_f64 = loss / (2.0 * x2s + 1.0 / (2.0 * c))
    assert not torch.equal(as_f32, as_f64)


@pytest.mark.parametrize("method", ["AROW", "CW", "NHERD", "PA", "PA1",
                                    "perceptron"])
def test_schema_paths_match_jax(method):
    uidx, val, labels = _schema_inputs(seed=5)
    mask = np.ones(SL, dtype=bool)
    conf = method in C.CONFIDENCE_METHODS
    js = JC.init_state(SL, SD, conf)
    ts = C.init_state(SL, SD, conf, device="cpu")
    for step in range(2):
        v = (val * (1.0 + 0.1 * step)).astype(np.float32)
        js = JC.train_batch_schema(js, jnp.asarray(uidx), jnp.asarray(v),
                                   jnp.asarray(labels), jnp.asarray(mask),
                                   1.0, method=method)
        ts = C.train_batch_schema(ts, T(uidx), T(v), T(labels), T(mask), 1.0,
                                  method=method)
    assert_table_close(ts.dw.numpy(), np.asarray(js.dw), "dw")
    assert_table_close(ts.dprec.numpy(), np.asarray(js.dprec), "dprec")
    assert_table_close(
        C.scores_schema(ts, T(uidx), T(val), T(mask)).numpy(),
        np.asarray(JC.scores_schema(js, jnp.asarray(uidx), jnp.asarray(val),
                                    jnp.asarray(mask))))


def test_combo_paths_match_jax():
    rng = np.random.default_rng(11)
    k0, s_n = 6, 5
    base_idx = rng.choice(np.arange(1, SD), size=k0 + s_n,
                          replace=False).astype(np.int32)
    a_idx = rng.integers(0, k0, size=s_n).astype(np.int32)
    b_idx = rng.integers(0, k0, size=s_n).astype(np.int32)
    mul = np.array([True, False, True, True, False])
    base_val = rng.normal(size=(SB, k0)).astype(np.float32)
    labels = rng.integers(0, SL, size=SB).astype(np.int32)
    mask = np.ones(SL, dtype=bool)
    np.testing.assert_array_equal(
        C._expand_combo(T(base_val), T(a_idx), T(b_idx), T(mul)).numpy(),
        np.asarray(JC._expand_combo(jnp.asarray(base_val), jnp.asarray(a_idx),
                                    jnp.asarray(b_idx), jnp.asarray(mul))))
    js = JC.train_batch_schema_combo(
        JC.init_state(SL, SD, True), jnp.asarray(base_idx),
        jnp.asarray(base_val), jnp.asarray(a_idx), jnp.asarray(b_idx),
        jnp.asarray(mul), jnp.asarray(labels), jnp.asarray(mask), 1.0,
        method="AROW")
    ts = C.train_batch_schema_combo(
        C.init_state(SL, SD, True, device="cpu"), T(base_idx), T(base_val),
        T(a_idx), T(b_idx), T(mul), T(labels), T(mask), 1.0, method="AROW")
    assert_table_close(ts.dw.numpy(), np.asarray(js.dw), "dw")
    assert_table_close(ts.dprec.numpy(), np.asarray(js.dprec), "dprec")
    assert_table_close(
        C.scores_schema_combo(ts, T(base_idx), T(base_val), T(a_idx),
                              T(b_idx), T(mul), T(mask)).numpy(),
        np.asarray(JC.scores_schema_combo(
            js, jnp.asarray(base_idx), jnp.asarray(base_val),
            jnp.asarray(a_idx), jnp.asarray(b_idx), jnp.asarray(mul),
            jnp.asarray(mask))))


def test_duplicate_indices_sum_like_the_reference():
    """Every entry of a row on one index: .at[].add sums all of them;
    index_put_(accumulate=True) must too (t[i] += v would keep one)."""
    idx = np.full((4, 8), 17, np.int32)
    val = np.ones((4, 8), np.float32)
    lab = np.zeros(4, np.int32)
    mask = np.array([True, True, False, False])
    js, ts = _both("PA", "parallel", [(idx, val, lab)], mask, 1.0)
    np.testing.assert_array_equal(ts.dw.numpy(), np.asarray(js.dw))
    assert float(ts.dw[0, 17]) != 0.0


def test_grow_labels_matches_jax():
    js, _ = _both("AROW", "parallel", _batches(12), np.array(
        [True, True, True, False]), 1.0)
    ts = C.ClassifierState(*(T(np.asarray(a).copy()) for a in js))
    for a, b in zip(JC.grow_labels(js, 8), C.grow_labels(ts, 8)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("rows", [2, 4])
def test_put_diff_row_trimmed_matches_jax(rows):
    """A diff of the first ``rows`` label rows (the mix plane ships only
    the live rows), summed over two replicas, applied to the leading rows."""
    mask = np.array([True, True, True, False])
    states = [_both("AROW", "parallel", _batches(s), mask, 1.0)
              for s in (13, 14)]
    jd = JC.mix_diffs(JC.get_diff(states[0][0]), JC.get_diff(states[1][0]))
    jd = dict(jd, dw=jd["dw"][:rows], dprec=jd["dprec"][:rows])
    td = {"dw": np.asarray(jd["dw"]), "dprec": np.asarray(jd["dprec"]),
          "count": float(jd["count"])}
    want = JC.put_diff(states[0][0], jd)
    got = C.put_diff(states[0][1], td)
    # w: the master of state 0 is the JAX one's up to the training
    # tolerance; the applied diff is the same host array, so compare the
    # change w - w_before bit for bit on top of the JAX master
    base = C.ClassifierState(T(np.asarray(states[0][0].w).copy()),
                             got.dw.clone(), T(np.asarray(states[0][0].prec).copy()),
                             got.dprec.clone())
    exact = C.put_diff(base, td)
    for a, b in zip(want, exact):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert float(got.dw.abs().max()) == 0.0 and float(got.dprec.abs().max()) == 0.0
    assert_table_close(got.w.numpy(), np.asarray(want.w))


def test_deterministic_mode_reproduces_itself_bit_for_bit():
    """Under torch.use_deterministic_algorithms(True) two runs of the same
    steps give the same bits (on the CPU; the card's run is in chip_smoke)."""
    mask = np.array([True, True, True, False])
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        runs = [_both("AROW", "parallel", _batches(15), mask, 1.0)[1]
                for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(was)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("method", C.METHODS)
def test_card_matches_cpu(cuda, method):
    mask = np.array([True, True, True, False])
    conf = method in C.CONFIDENCE_METHODS
    on_card = C.init_state(L, DIM, conf, device=cuda)
    on_cpu = C.init_state(L, DIM, conf, device="cpu")
    for idx, val, lab in _batches(16):
        args = (T(idx), T(val), T(lab), T(mask))
        C.train_batch_parallel(on_card, *(a.to(cuda) for a in args), 1.0,
                               method=method)
        C.train_batch_parallel(on_cpu, *args, 1.0, method=method)
    for a, b in zip(on_card, on_cpu):
        assert_table_close(a.cpu().numpy(), b.numpy())


@pytest.mark.cuda
def test_card_deterministic_mode_reproduces_itself(cuda):
    mask = T(np.array([True, True, True, False])).to(cuda)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for _ in range(2):
            st = C.init_state(L, DIM, True, device=cuda)
            for idx, val, lab in _batches(17):
                C.train_batch_parallel(st, T(idx).to(cuda), T(val).to(cuda),
                                       T(lab).to(cuda), mask, 1.0,
                                       method="AROW")
            runs.append(st)
    finally:
        torch.use_deterministic_algorithms(was)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_jax_sparse_batch_and_port_batch_agree():
    """Both packages pad the same vectors to the same arrays."""
    rng = np.random.default_rng(18)
    vectors, _ = make_blobs(rng, 30)
    a, b = JSparseBatch.from_vectors(vectors), SparseBatch.from_vectors(vectors)
    np.testing.assert_array_equal(a.idx, b.idx)
    np.testing.assert_array_equal(a.val, b.val)
