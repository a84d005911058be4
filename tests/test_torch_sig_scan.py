"""The signature scan (jubatus_tpu_torch/ops/sig_scan.py) against the Pallas
kernel it replaces (jubatus_tpu.ops.pallas_kernels, in interpret mode on
the CPU as tests/test_pallas_kernels.py runs it).

On the CPU the wrapper runs its plain PyTorch version. Tolerance: bit-equal
at power-of-two hash_num; atol 1e-6 otherwise (XLA may fuse 1 - n·s into a
multiply-add). The CUDA kernel itself is held against the plain version on
the card by the ``cuda`` tests below and by chip_smoke.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jubatus_tpu.ops import pallas_kernels
from jubatus_tpu_torch.ops import sig_scan


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _check(got: torch.Tensor, want, hash_num: int) -> None:
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == np.float32 and got.shape == want.shape
    if hash_num & (hash_num - 1) == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sig_scan CUDA kernel has no "
                    "CPU mode")
    return torch.device("cuda")


def test_popcount32_matches_numpy(rng):
    v = rng.integers(0, 2**32, size=(257,), dtype=np.uint32)
    got = sig_scan.popcount32(torch.from_numpy(v.astype(np.int64))).numpy()
    want = np.array([bin(int(x)).count("1") for x in v])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hash_num", [64, 100])
@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("c", [700, 513])
def test_hamming_matches_pallas(rng, hash_num, b, c):
    w = (hash_num + 31) // 32
    q = rng.integers(0, 2**32, size=(b, w), dtype=np.uint32)
    r = rng.integers(0, 2**32, size=(c, w), dtype=np.uint32)
    want = pallas_kernels.hamming_distances_batch(
        jnp.asarray(q), jnp.asarray(r), hash_num=hash_num, block=256)
    _check(sig_scan.hamming_distances_batch(_t(q), _t(r), hash_num=hash_num),
           want, hash_num)
    one = sig_scan.hamming_distances(_t(q[0]), _t(r), hash_num=hash_num)
    _check(one, pallas_kernels.hamming_distances(
        jnp.asarray(q[0]), jnp.asarray(r), hash_num=hash_num), hash_num)


@pytest.mark.parametrize("hash_num", [64, 100])
@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("c", [700, 513])
def test_minhash_matches_pallas(rng, hash_num, b, c):
    r = rng.integers(1, 50, size=(c, hash_num), dtype=np.uint32)
    r[::17] = 0xFFFFFFFF
    q = rng.integers(1, 50, size=(b, hash_num), dtype=np.uint32)
    want = pallas_kernels.minhash_distances_batch(
        jnp.asarray(q), jnp.asarray(r), block=256)
    _check(sig_scan.minhash_distances_batch(_t(q), _t(r)), want, hash_num)
    one = sig_scan.minhash_distances(_t(q[0]), _t(r))
    _check(one, pallas_kernels.minhash_distances(jnp.asarray(q[0]),
                                                 jnp.asarray(r)), hash_num)


def test_identical_row_scores_zero(rng):
    r = rng.integers(0, 2**32, size=(40, 2), dtype=np.uint32)
    d = sig_scan.hamming_distances(_t(r[7]), _t(r), hash_num=64)
    assert float(d[7]) == 0.0 and float(d.min()) == 0.0
    m = sig_scan.minhash_distances(_t(r[7]), _t(r))
    assert float(m[7]) == 0.0


def test_plain_chunking_matches_one_pass(rng, monkeypatch):
    q = rng.integers(0, 2**32, size=(3, 4), dtype=np.uint32)
    r = rng.integers(0, 2**32, size=(301, 4), dtype=np.uint32)
    whole_h = sig_scan.hamming_plain(_t(q), _t(r), 128)
    whole_m = sig_scan.minhash_plain(_t(q), _t(r))
    monkeypatch.setattr(sig_scan, "_chunk", lambda b, w: 13)
    assert torch.equal(sig_scan.hamming_plain(_t(q), _t(r), 128), whole_h)
    assert torch.equal(sig_scan.minhash_plain(_t(q), _t(r)), whole_m)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing(rng):
    q = rng.integers(0, 2**32, size=(2, 2), dtype=np.uint32)
    r = rng.integers(0, 2**32, size=(9, 2), dtype=np.uint32)
    before = (sig_scan.hamming.launches, sig_scan.minhash.launches)
    sig_scan.hamming_distances_batch(_t(q), _t(r), hash_num=64)
    sig_scan.minhash_distances_batch(_t(q), _t(r))
    assert (sig_scan.hamming.launches, sig_scan.minhash.launches) == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "words"])
def test_wrapper_rejects_bad_inputs(rng, bad):
    q = torch.zeros((2, 2), dtype=torch.int32)
    r = torch.zeros((5, 2), dtype=torch.int32)
    if bad == "dtype":
        q = q.to(torch.int64)
    elif bad == "shape":
        q = q[0]
    else:
        r = torch.zeros((5, 3), dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        sig_scan.hamming_distances_batch(q, r, hash_num=64)


@pytest.mark.parametrize("mode,b,w,aligned,want", [
    ("hamming", 1, 2, True, "w2"),
    ("hamming", 256, 2, True, "w2"),
    ("hamming", 1, 2, False, "generic"),
    ("hamming", 1, 3, True, "generic"),
    ("hamming", 300, 64, True, "generic"),
    ("minhash", 1, 64, True, "stream"),
    ("minhash", sig_scan.SMALL_B, 64, True, "stream"),
    ("minhash", sig_scan.SMALL_B + 1, 64, True, "tiled"),
    ("minhash", 256, 64, True, "tiled"),
    ("minhash", 1, 64, False, "generic"),
    ("minhash", 256, 64, False, "generic"),
    ("minhash", 1, 70, True, "generic"),
    ("minhash", 256, 3, True, "generic"),
    ("minhash", 1, sig_scan.STREAM_MAX_W, True, "stream"),
    ("minhash", 1, sig_scan.STREAM_MAX_W + 4, True, "generic"),
    ("minhash", 256, sig_scan.TILED_MAX_W, True, "tiled"),
    ("minhash", 256, sig_scan.TILED_MAX_W + 4, True, "generic"),
])
def test_choose_variant(mode, b, w, aligned, want):
    got = sig_scan.choose_variant(mode, b, w, aligned)
    assert got == want and got in sig_scan.VARIANTS[mode]


def test_every_variant_is_chosen_somewhere():
    chosen = {(mode, sig_scan.choose_variant(mode, b, w, aligned))
              for mode in sig_scan.VARIANTS for b in (1, 300)
              for w in (2, 3, 64, 200) for aligned in (True, False)}
    assert chosen == {(m, v) for m, vs in sig_scan.VARIANTS.items()
                      for v in vs}


def _table(cuda, r: np.ndarray, misaligned: bool) -> torch.Tensor:
    """The table on the card, starting 4 bytes past a 16-byte boundary when
    ``misaligned`` (a sliced table)."""
    if not misaligned:
        return _t(r).to(cuda)
    flat = torch.zeros(r.size + 1, dtype=torch.int32, device=cuda)
    flat[1:] = _t(r.reshape(-1)).to(cuda)
    return flat[1:].view(r.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["hamming", "minhash"])
@pytest.mark.parametrize("b", [1, 3, sig_scan.SMALL_B, sig_scan.SMALL_B + 1,
                               300])
@pytest.mark.parametrize("w", [2, 3, 64, 70])
@pytest.mark.parametrize("c", [1, 7, 4099])
@pytest.mark.parametrize("misaligned", [False, True])
def test_kernel_matches_plain_on_card(cuda, rng, mode, b, w, c, misaligned):
    r = rng.integers(0, 2**32 if mode == "hamming" else 40, size=(c, w),
                     dtype=np.uint32)
    q = rng.integers(0, 2**32 if mode == "hamming" else 40, size=(b, w),
                     dtype=np.uint32)
    qd, rd = _t(q).to(cuda), _table(cuda, r, misaligned)
    assert (rd.data_ptr() % 16 != 0) == misaligned
    kern = sig_scan.hamming if mode == "hamming" else sig_scan.minhash
    before = kern.launches
    if mode == "hamming":
        got = kern(qd, rd, 32 * w)
        want = sig_scan.hamming_plain(qd, rd, 32 * w)
    else:
        got = kern(qd, rd)
        want = sig_scan.minhash_plain(qd, rd)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,variant,b,w,misaligned", [
    ("hamming", "w2", 1, 3, False),
    ("hamming", "w2", 1, 2, True),
    ("minhash", "stream", sig_scan.SMALL_B + 1, 64, False),
    ("minhash", "stream", 1, 70, False),
    ("minhash", "stream", 1, 64, True),
    ("minhash", "tiled", 300, sig_scan.TILED_MAX_W + 4, False),
    ("minhash", "tiled", 300, 64, True),
])
def test_variant_refuses_what_it_does_not_take(cuda, mode, variant, b, w,
                                               misaligned):
    """An entry point called outside its variant's preconditions returns an
    error (cudaErrorInvalidValue) and launches nothing."""
    q = torch.zeros((b, w), dtype=torch.int32, device=cuda)
    r = _table(cuda, np.zeros((64, w), np.uint32), misaligned)
    out = torch.full((b, 64), 7.0, device=cuda)
    fn = getattr(sig_scan.library(), f"jt_sig_scan_{mode}_{variant}")
    err = fn(q.data_ptr(), r.data_ptr(), out.data_ptr(), b, 64, w, 0.5,
             torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 1
    assert bool((out == 7.0).all())
