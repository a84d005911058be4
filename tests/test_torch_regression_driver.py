"""The port's regression driver (jubatus_tpu_torch/models/regression.py)
against the JAX package's, on the CPU: train / estimate on the same datums,
the hashed entry points, clear, the mixable, and checkpoints in both
directions (a JAX ``pack()`` loads through ``convert.from_jax_pack``; the
port's ``pack()`` loads in the JAX driver).

Tolerance: estimates within rtol 1e-4 plus 1e-5 of their largest magnitude:
each example's K-sum adds in the scan kernel's order, not XLA's
(tests/test_torch_regression_ops.py says why). Packed weights move bit for
bit.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from jubatus_tpu.core import Datum as JDatum
from jubatus_tpu.models import RegressionDriver as JDriver
from jubatus_tpu_torch import convert
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.models.regression import RegressionDriver

CFG = {"method": "PA1",
       "parameter": {"sensitivity": 0.1, "regularization_weight": 1.0},
       "converter": {"num_rules": [{"key": "*", "type": "num"}],
                     "string_rules": [{"key": "*", "type": "str",
                                       "sample_weight": "bin",
                                       "global_weight": "bin"}]}}


def _drv(cfg=CFG, **kw):
    return RegressionDriver(cfg, dim_bits=12, device="cpu", **kw)


def _rows(seed, n=60):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x, y = rng.normal(size=2)
        d = {"x": float(x), "y": float(y), "c": f"k{int(rng.integers(4))}"}
        out.append((float(2 * x - y + 0.5), d))
    return out


def assert_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()) + 1e-12)


def _train_both(method, seed=0, steps=3):
    cfg = dict(CFG, method=method)
    j, t = JDriver(cfg, dim_bits=12), _drv(cfg)
    rows = _rows(seed)
    for _ in range(steps):
        assert t.train([(y, Datum(d)) for y, d in rows]) == \
            j.train([(y, JDatum(d)) for y, d in rows])
    return j, t, rows


@pytest.mark.parametrize("method", ["PA", "PA1", "PA2"])
def test_estimate_matches_the_jax_driver(method):
    j, t, rows = _train_both(method)
    q = [d for _, d in _rows(1, 12)]
    assert_close(t.estimate([Datum(d) for d in q]),
                 j.estimate([JDatum(d) for d in q]))
    assert t.update_count == j.update_count
    # and it learned
    est = np.asarray(t.estimate([Datum(d) for _, d in rows]))
    assert np.sqrt(np.mean((est - [y for y, _ in rows]) ** 2)) < 0.5


def test_hashed_entry_points_match_the_jax_driver():
    rng = np.random.default_rng(2)
    j, t = JDriver(CFG, dim_bits=12), _drv()
    idx = rng.integers(1, 1 << 12, size=(37, 8)).astype(np.int32)
    val = rng.normal(size=(37, 8)).astype(np.float32)
    tgt = rng.normal(size=37).astype(np.float32)
    assert t.train_hashed(tgt, idx, val) == j.train_hashed(tgt, idx, val) == 37
    assert_close(t.estimate_hashed(idx[:5], val[:5]),
                 j.estimate_hashed(idx[:5], val[:5]))
    assert t.estimate_hashed(idx[:0], val[:0]) == []


def test_train_hashed_walks_only_the_live_rows(monkeypatch):
    """17 rows reach the scan as 17 rows (no power-of-two padding), and
    train as the 32-row padded batch does: a padded row updates nothing."""
    from jubatus_tpu_torch.models import regression as models_regression
    from jubatus_tpu_torch.ops import regression as R

    rng = np.random.default_rng(7)
    idx = rng.integers(1, 1 << 12, size=(17, 8)).astype(np.int32)
    val = rng.normal(size=(17, 8)).astype(np.float32)
    tgt = (rng.normal(size=17) * 3).astype(np.float32)
    seen = []
    real = R.train_batch

    def spy(state, i, v, t, *args, **kw):
        seen.append((tuple(i.shape), tuple(v.shape), tuple(t.shape)))
        return real(state, i, v, t, *args, **kw)

    monkeypatch.setattr(models_regression.ops, "train_batch", spy)
    t = _drv()
    assert t.train_hashed(tgt, idx, val) == 17
    assert seen == [((17, 8), (17, 8), (17,))]
    pad = ((0, 15), (0, 0))
    padded = real(R.init_state(1 << 12, device="cpu"),
                  torch.from_numpy(np.pad(idx, pad)),
                  torch.from_numpy(np.pad(val, pad)),
                  torch.from_numpy(np.pad(tgt, (0, 15))), t.sensitivity,
                  t.c, method=t.method)
    assert float(padded.dw.abs().max()) > 0.0
    assert torch.equal(t.state.dw, padded.dw)


def test_empty_calls_and_clear():
    t = _drv()
    assert t.train([]) == 0 and t.estimate([]) == []
    t.train([(y, Datum(d)) for y, d in _rows(3, 10)])
    assert t.update_count == 10
    t.clear()
    assert t.update_count == 0
    assert t.estimate([Datum({"x": 1.0})]) == [0.0]


def test_unknown_method_and_sharding_raise():
    """An unknown method raises; feature sharding is ported, and a budget
    the CPU (one local device) cannot hold raises the JAX package's
    message, as an indivisible split does."""
    from jubatus_tpu_torch.parallel.mesh import ShardMesh

    with pytest.raises(ValueError):
        RegressionDriver({"method": "OLS"}, device="cpu")
    with pytest.raises(ValueError, match="feature sharding needs 4 local "
                                         "devices, have 1"):
        _drv(shard_features=1 << 10)
    with pytest.raises(ValueError, match="feature dim 2\\^12 not divisible "
                                         "by 3 shard devices"):
        _drv(mesh=ShardMesh(["cpu"] * 3))
    drv = _drv(mesh=ShardMesh(["cpu"] * 4))
    assert len(drv.state.w) == 4 and drv.shard_stats()["count"] == 4


@pytest.mark.parametrize("method", ["PA", "PA2"])
def test_a_jax_model_loads_in_the_port_and_back(method):
    j, _, rows = _train_both(method)
    cfg = dict(CFG, method=method)
    t = convert.from_jax_pack(j.pack(), cfg, engine="regression",
                              device="cpu")
    assert isinstance(t, RegressionDriver)
    np.testing.assert_array_equal(t.state.w.numpy(),
                                  np.asarray(j.state.w + j.state.dw))
    q = [Datum(d) for _, d in rows[:10]]
    assert_close(t.estimate(q), j.estimate([JDatum(d) for _, d in rows[:10]]))
    t.train([(y, Datum(d)) for y, d in rows[:20]])
    j2 = JDriver(cfg, dim_bits=12)
    j2.unpack(t.pack())
    np.testing.assert_array_equal(np.asarray(j2.state.w),
                                  (t.state.w + t.state.dw).numpy())
    assert_close(j2.estimate([JDatum(d) for _, d in rows[:10]]), t.estimate(q))
    with pytest.raises(ValueError, match="method"):
        _drv(dict(CFG, method="PA1" if method != "PA1" else "PA")).unpack(
            t.pack())


def test_mix_two_replicas_averages_the_diffs():
    ds = [_drv(), _drv()]
    for d, seed in zip(ds, (4, 5)):
        d.train([(y, Datum(x)) for y, x in _rows(seed)])
    dws = [d.state.dw.clone() for d in ds]
    ms = [d.get_mixables()["regression"] for d in ds]
    diffs = [m.get_diff() for m in ms]
    assert isinstance(diffs[0]["dw"], np.ndarray)
    total = functools.reduce(type(ms[0]).mix, diffs)
    for m in ms:
        m.put_diff(total)
    want = ((dws[0] + dws[1]) / 2.0).numpy()
    for d in ds:
        np.testing.assert_allclose(d.state.w.numpy(), want, rtol=1e-6,
                                   atol=1e-7)
        assert float(d.state.dw.abs().max()) == 0.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_driver_is_bit_equal_to_the_cpu_driver(cuda):
    """The card's train is the scan kernel, bit-equal to the plain loop."""
    from jubatus_tpu_torch.ops import online_scan

    on_card = RegressionDriver(CFG, dim_bits=12, device=cuda)
    on_cpu = _drv()
    before = online_scan.pa_scan.launches
    rows = _rows(6)
    for d in (on_card, on_cpu):
        d.train([(y, Datum(x)) for y, x in rows])
    assert online_scan.pa_scan.launches == before + 1
    assert torch.equal(on_card.state.dw.cpu(), on_cpu.state.dw)
