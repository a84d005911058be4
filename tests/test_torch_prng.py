"""The port's threefry draws (jubatus_tpu_torch/ops/prng.py) against jax.random.

Tolerances: threefry keys, split keys and bits, and uniforms, are
bit-exact. Normals (sqrt(2)·erfinv(u), XLA's float32 erfinv polynomial with
the log taken in float64) are within NORMAL_ULP units in the last place of
JAX's. Gumbel draws (-log(-log(u)), each log taken in float64 and rounded
once, where XLA's float32 log is its own approximation) are within
GUMBEL_ULP units in the last place of max(|g|, 1): a value near 0 inherits
the inner log's absolute error. categorical (argmax of gumbel + logits)
picks the same index as jax.random.categorical.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jubatus_tpu_torch.ops import prng

NORMAL_ULP = 4
GUMBEL_ULP = 4
CATEGORICAL_SEEDS = 600
CASES = [(0, 0x1A5B), (7, 0x3C7D), (12345, 0x5E9F), (-1, 3), (2**31 - 1, 0)]


def _jax_keys(seed, tag, idx):
    base = jax.random.fold_in(jax.random.PRNGKey(seed), tag)
    return jax.vmap(lambda i: jax.random.fold_in(base, i))(idx)


def _torch_keys(seed, tag, idx):
    base = prng.fold_in(prng.PRNGKey(seed), tag)
    return prng.fold_in(base, torch.from_numpy(idx))


def _ulp(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 units in the last place (same-sign values)."""
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


@pytest.fixture
def idx(rng):
    return np.unique(rng.integers(0, 1 << 20, 400)).astype(np.int32)


@pytest.mark.parametrize("seed,tag", CASES)
def test_prng_key_and_fold_in_bit_exact(seed, tag, idx):
    want = np.asarray(jax.random.PRNGKey(seed))
    k1, k2 = prng.PRNGKey(seed)
    assert [int(k1), int(k2)] == want.tolist()
    jk = np.asarray(_jax_keys(seed, tag, idx))
    t1, t2 = _torch_keys(seed, tag, idx)
    np.testing.assert_array_equal(np.stack([t1.numpy(), t2.numpy()], -1),
                                  jk.astype(np.int64))


@pytest.mark.parametrize("seed,tag", CASES)
@pytest.mark.parametrize("n", [64, 100, 1])
def test_random_bits_bit_exact(seed, tag, n, idx):
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (n,)))(
        _jax_keys(seed, tag, idx)))
    got = prng.random_bits(_torch_keys(seed, tag, idx), n).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("seed,tag", CASES[:3])
@pytest.mark.parametrize("lo,hi", [(1e-12, 1.0), (0.0, 1.0), (-3.0, 5.5)])
def test_uniform_bit_exact(seed, tag, lo, hi, idx):
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (64,), minval=lo, maxval=hi))(_jax_keys(seed, tag, idx)))
    got = prng.uniform(_torch_keys(seed, tag, idx), 64, lo, hi).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _normal_gap_report(keys, got: np.ndarray, want: np.ndarray) -> str:
    """Where a normal draw breaks the ULP bound: the worst element's index,
    its uniform u, w = -log1p(-u*u) and erfinv's branch, both values, the
    gap, and how many elements break the bound."""
    gap = _ulp(got, want)
    at = np.unravel_index(int(gap.argmax()), gap.shape)
    u = prng.uniform(keys, got.shape[-1], prng._NORMAL_LO, 1.0).numpy()[at]
    w = float(-np.log1p(-np.float64(np.float32(u * u))))
    return (f"{int((gap > NORMAL_ULP).sum())} of {gap.size} elements over "
            f"{NORMAL_ULP} ULP; worst at {tuple(int(i) for i in at)}: "
            f"u={u!r} w={w!r} ({'w < 5' if w < 5 else 'w >= 5'} branch) "
            f"got={got[at]!r} want={want[at]!r}, {int(gap[at])} ULP")


@pytest.mark.parametrize("seed,tag", CASES[:3])
def test_normal_within_ulp_bound(seed, tag, idx):
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (128,)))(
        _jax_keys(seed, tag, idx)))
    keys = _torch_keys(seed, tag, idx)
    got = prng.normal(keys, 128).numpy()
    assert np.isfinite(got).all()
    assert _ulp(got, want).max() <= NORMAL_ULP, _normal_gap_report(
        keys, got, want)


# Elements of the (0, 0x1A5B) draw in erfinv's w >= 5 branch that once
# moved by 120 to 2496 ULP, when torch's float32 sqrt returned ~12-bit
# results in one CPU worker thread (u = -0.9987063, -0.99948496, 0.9971252).
SQRT_BRANCH_ELEMENTS = [(302, 120), (305, 96), (333, 98)]


@pytest.mark.parametrize("rel", [3.7e-4, -3.7e-4])
def test_normal_holds_against_an_inaccurate_library_sqrt(monkeypatch, idx,
                                                         rel):
    """The draw does not depend on the accuracy of torch.sqrt: with every
    square root off by ``rel`` (the error of a 12-bit estimate) the draw is
    bit-equal to the unperturbed one, and the elements that once moved stay
    within NORMAL_ULP of JAX's."""
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (128,)))(
        _jax_keys(0, 0x1A5B, idx)))
    keys = _torch_keys(0, 0x1A5B, idx)
    exact = prng.normal(keys, 128).numpy()
    real = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda t: real(t) * (1 + rel))
    got = prng.normal(keys, 128).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), exact.view(np.uint32))
    rows, cols = zip(*SQRT_BRANCH_ELEMENTS)
    u = prng.uniform(keys, 128, prng._NORMAL_LO, 1.0).numpy()[rows, cols]
    assert (-np.log1p(-np.float64(u * u)) >= 5).all()
    assert _ulp(got[rows, cols], want[rows, cols]).max() <= NORMAL_ULP


def test_sqrt_is_correctly_rounded(rng):
    x = np.concatenate([rng.uniform(0, 64, 100_000),
                        [0.0, 1e-30, 5.0, 3.4e38, np.inf]]).astype(np.float32)
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    got = prng._sqrt(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_erfinv_within_ulp_bound(rng):
    x = rng.uniform(-0.9999, 0.9999, 200_000).astype(np.float32)
    want = np.asarray(jax.jit(jax.lax.erf_inv)(x))
    got = prng.erfinv(torch.from_numpy(x)).numpy()
    assert _ulp(got, want).max() <= NORMAL_ULP
    edge = prng.erfinv(torch.tensor([1.0, -1.0, 0.0])).tolist()
    assert edge == [float("inf"), float("-inf"), 0.0]


def test_prng_key_rejects_seed_outside_int32():
    with pytest.raises(OverflowError):
        prng.PRNGKey(1 << 31)


def _sub_keys(seed):
    """``key, sub = jax.random.split(PRNGKey(seed))`` in both packages."""
    jkey, jsub = jax.random.split(jax.random.PRNGKey(seed))
    k1, k2 = prng.split(prng.PRNGKey(seed))
    return jsub, (k1[1], k2[1]), (k1[0], k2[0]), jkey


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, -1, 2**31 - 1])
@pytest.mark.parametrize("num", [2, 3, 8])
def test_split_bit_exact(seed, num):
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
    k1, k2 = prng.split(prng.PRNGKey(seed), num)
    np.testing.assert_array_equal(np.stack([k1.numpy(), k2.numpy()], -1),
                                  want.astype(np.int64))
    # a chain of splits, as k-means++ seeding takes it
    jkey, tkey = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for _ in range(5):
        jkey, _ = jax.random.split(jkey)
        a, b = prng.split(tkey)
        tkey = (a[0], b[0])
    assert [int(tkey[0]), int(tkey[1])] == np.asarray(jkey).tolist()


def test_uniform_on_tiny_to_one_bit_exact():
    """The Gumbel draw's uniform, on [finfo(float32).tiny, 1)."""
    tiny = float(np.finfo(np.float32).tiny)
    for seed in range(50):
        jsub, tsub, _, _ = _sub_keys(seed)
        want = np.asarray(jax.random.uniform(jsub, (257,), minval=tiny,
                                             maxval=1.0))
        got = prng.uniform(tsub, 257, tiny, 1.0).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def _gumbel_gap(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want| in units of the spacing of float32 at max(|want|, 1)."""
    scale = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    return np.abs(got.astype(np.float64) - want) / scale.astype(np.float64)


@pytest.mark.parametrize("n", [1, 257, 4096])
def test_gumbel_within_ulp_bound(n):
    worst = 0.0
    for seed in range(40):
        jsub, tsub, _, _ = _sub_keys(seed)
        want = np.asarray(jax.random.gumbel(jsub, (n,)))
        got = prng.gumbel(tsub, n).numpy()
        assert np.isfinite(got).all()
        worst = max(worst, float(_gumbel_gap(got, want).max()))
    assert worst <= GUMBEL_ULP


@pytest.mark.parametrize("n,spread", [(2, 1.0), (37, 3.0), (1000, 10.0)])
def test_categorical_picks_equal(n, spread):
    """CATEGORICAL_SEEDS seeds, each with its own logits; and logits as
    k-means++ seeding makes them (log of distance-weighted probabilities,
    some at the 1e-30 floor)."""
    rng = np.random.default_rng(n)
    for seed in range(CATEGORICAL_SEEDS):
        jsub, tsub, _, _ = _sub_keys(seed)
        logits = (rng.normal(size=n) * spread).astype(np.float32)
        if seed % 3 == 0:
            probs = rng.exponential(size=n).astype(np.float32)
            probs[rng.random(n) < 0.2] = 0.0
            logits = np.log(np.maximum(probs, 1e-30)).astype(np.float32)
        want = int(jax.random.categorical(jsub, jnp.asarray(logits)))
        got = prng.categorical(tsub, torch.from_numpy(logits))
        assert got.dtype == torch.int64 and got.dim() == 0
        assert int(got) == want, seed
