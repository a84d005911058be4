"""The pieces of ``jax.random`` that the LSH family draws from, in torch.

``jubatus_tpu.ops.knn`` derives every per-feature projection from JAX's
counter-based threefry2x32 generator: ``fold_in(PRNGKey(seed), tag)``, then
``fold_in`` per feature index, then ``normal`` or ``uniform`` over the hash
lanes. Signatures are stored in rows and compared across replicas and across
the two packages, so this module reproduces those draws:

- ``threefry2x32``, ``PRNGKey``, ``fold_in``, ``split`` and the 32-bit
  ``random_bits`` are bit-exact with ``jax.random`` under
  ``jax_threefry_partitionable=True``
  (the JAX 0.9 default: lane ``h`` of a ``(H,)`` draw hashes the counter pair
  ``(0, h)`` and xors the two output words);
- ``uniform`` is bit-exact (mantissa fill, scale, shift, clamp at ``minval``);
- ``normal`` is ``sqrt(2) * erfinv(u)`` with XLA's single-precision erfinv
  (Giles' polynomial, as XLA lowers it, with fused multiply-adds). XLA's
  ``log1p`` is its own float32 approximation; here the log is taken in
  float64 and rounded, so a normal draw may differ from JAX's in the last
  bits (tests state the ULP bound). Every other step is exact integer work
  or a correctly rounded float operation, so the draws agree on the CPU and
  on the card unless the two float64 logs differ in a last bit that
  survives the rounding to float32. The square root is one of those
  correctly rounded steps by construction (``_sqrt``), not by trust in the
  library: on the CPU torch takes it from MKL's vector math, which is not
  correctly rounded, and once returned results good to about 12 bits in one
  worker thread of a process, which moved draws by thousands of ULP;
- ``gumbel`` is ``-log(-log(u))`` over a bit-exact uniform on
  ``[tiny, 1)``, each float32 log taken in float64 and rounded once (XLA's
  float32 log is its own approximation, so a Gumbel value may differ from
  JAX's in its last bits; tests state the bound), and ``categorical`` is
  ``argmax(gumbel + logits)``, as ``jax.random.categorical`` draws it: the
  picks agree unless two candidates lie within those last bits.

The 32-bit words are held in ``int64`` tensors masked with ``0xFFFFFFFF``:
``torch.uint32`` lacks shifts and adds on some backends. Keys are plain
``(k1, k2)`` int64 tensors of any matching shape, so a batch of keys is one
call.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Key = Tuple[torch.Tensor, torch.Tensor]


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds over broadcastable int64 word tensors
    (values in [0, 2^32)). Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def PRNGKey(seed: int, device="cpu") -> Key:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off: the seed is an
    int32, so the key is ``(0, seed mod 2^32)``."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise OverflowError(f"seed {seed} does not fit in int32")
    t = torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)
    return t[0], t[1]


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in``: hash the counter pair ``(0, data)`` under the
    key. ``data`` may be a tensor of indices, giving a batch of keys."""
    k1, k2 = key
    data = torch.as_tensor(data, dtype=torch.int64, device=k1.device) & MASK
    return threefry2x32(k1, k2, torch.zeros_like(data), data)


def split(key: Key, num: int = 2) -> Key:
    """``jax.random.split(key, num)`` for one key: key ``i`` hashes the
    counter pair ``(0, i)``. Returns ``(k1, k2)`` of shape [num]; row ``i``
    is ``(k1[i], k2[i])``."""
    k1, k2 = key
    lanes = torch.arange(num, dtype=torch.int64, device=k1.device)
    return threefry2x32(k1, k2, torch.zeros_like(lanes), lanes)


def random_bits(key: Key, n: int) -> torch.Tensor:
    """32-bit ``random_bits(key, (n,))`` for a batch of keys of shape S:
    returns [*S, n] int64 words."""
    k1, k2 = key
    lanes = torch.arange(n, dtype=torch.int64, device=k1.device)
    b1, b2 = threefry2x32(k1[..., None], k2[..., None],
                          torch.zeros_like(lanes), lanes)
    return b1 ^ b2


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """Fill the float32 mantissa of 1.0 with the top 23 bits: [0, 1)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: Key, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``, bit-exact,
    for a batch of keys: [*S, n] float32."""
    lo, hi = float(np.float32(minval)), float(np.float32(maxval))
    span = float(np.float32(hi - lo))
    u = _bits_to_unit(random_bits(key, n))
    # u * span + lo with one rounding, as XLA's fused multiply-add gives
    # it: the product of two float32 values is exact in float64
    v = (u.double() * span + lo).float()
    return torch.clamp(v, min=lo)


# XLA's float32 ErfInv (Giles, "Approximating the erfinv function"), the
# coefficients in the order XLA's Horner loop consumes them
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _sqrt(v: torch.Tensor) -> torch.Tensor:
    """float32 ``sqrt(v)``, correctly rounded. On a CUDA tensor torch's sqrt
    already is (IEEE round to nearest). On the CPU three Newton steps in
    float64 take the library's estimate, from within 1e-2, to within an ulp
    of float64, and float64 keeps enough bits that rounding to float32 is
    then exact."""
    if v.is_cuda:
        return torch.sqrt(v)
    v64 = v.double()
    s0 = torch.sqrt(v64)
    s = s0
    for _ in range(3):
        s = 0.5 * (s + v64 / s)
    # 0 and inf give 0/0 and inf/inf: keep the estimate there
    return torch.where(torch.isfinite(s), s, s0).float()


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv as XLA lowers it: each Horner step a fused
    multiply-add (emulated exactly in float64), the ``log1p`` in float64
    (see the module note)."""
    w = -torch.log1p((x * -x).double()).float()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, _sqrt(w) - 3.0)
    a = torch.tensor(np.float32(_ERFINV_LT5), device=x.device)
    b = torch.tensor(np.float32(_ERFINV_GE5), device=x.device)
    p = torch.where(lt, a[0], b[0])
    w64 = w.double()
    for i in range(1, len(_ERFINV_LT5)):
        # c + p*w rounded once, as XLA's fused multiply-add gives it
        p = (torch.where(lt, a[i], b[i]).double() + p.double() * w64).float()
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))


def normal(key: Key, n: int) -> torch.Tensor:
    """``jax.random.normal(key, (n,), float32)`` for a batch of keys:
    [*S, n] float32."""
    u = uniform(key, n, _NORMAL_LO, 1.0)
    return erfinv(u) * _SQRT2


_TINY = float(np.finfo(np.float32).tiny)


def _log32(v: torch.Tensor) -> torch.Tensor:
    """float32 natural log, taken in float64 and rounded once."""
    return torch.log(v.double()).float()


def gumbel(key: Key, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` (mode "low") for a batch of
    keys: ``-log(-log(u))``, u uniform on [tiny, 1). [*S, n] float32."""
    u = uniform(key, n, _TINY, 1.0)
    return -_log32(-_log32(u))


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis of a
    float32 [n] or [*S, n] tensor (one key per row): the index of the
    largest ``gumbel + logits``, as a 0-d (or [*S]) int64 tensor on the
    logits' device."""
    g = gumbel(key, logits.shape[-1])
    return torch.argmax(g + logits, dim=-1)
