"""Signature-table scan: the CUDA kernel, its launcher, and its plain version.

Replaces the Pallas TPU kernel ``jubatus_tpu/ops/pallas_kernels.py:_sig_scan``
(XOR+popcount / lane-match over packed LSH and minhash signature tables).
The kernels are in ``jubatus_tpu_torch/csrc/sig_scan.cu``; its source note
says what bounds each shape and what each variant does about it.
``choose_variant`` picks the variant from the mode, the query count, the
width and the table's alignment:

- hamming at W = 2 on a 16-byte-aligned table: ``w2`` (four rows per
  thread, 16-byte loads and streaming stores);
- minhash at W % 4 == 0 on a 16-byte-aligned table: ``stream`` for at most
  ``SMALL_B`` queries (a persistent grid streaming the table through a
  bulk-copy ring), ``tiled`` above that (a register tile over rows and
  queries);
- anything else: ``generic``, one thread per row.

Signature words are uint32 bit patterns held in ``int32`` tensors.

- ``hamming_distances_batch(q [B, W], r [C, W], hash_num)`` → [B, C]
  ``popcount(q ^ r) * (1/hash_num)``;
- ``minhash_distances_batch(q [B, H], r [C, H])`` → [B, C]
  ``1 - (#equal lanes) * (1/H)``.

The gathered variant scores each query against its own candidate rows
instead of the whole table (the IVF rescore, ``ops/ivf.py``):

- ``gathered(mode, q [B, W], table [C, W], cand [B, M], hash_num)`` → [B, M]
  float32, ``table[cand[b, m]]``'s distance to ``q[b]`` by the mode's
  formula, +inf where ``cand`` is −1 (padding). Its launches are counted
  apart, in ``hamming_gather.launches`` and ``minhash_gather.launches``.

On a CUDA tensor a wrapper launches the chosen kernel (or raises); on a CPU
tensor, and only there, it runs the plain PyTorch version beside it. Each
wrapper counts its kernel launches in ``.launches``, whatever the variant.

The kernel is built at first use with ``nvcc`` into a shared library with a
plain C interface (``build/torch_kernels/`` under the checkout), loaded with
ctypes (``ops/_build.py``).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np
import torch

from jubatus_tpu_torch.ops import _build

MASK = 0xFFFFFFFF
SOURCE = _build.CSRC / "sig_scan.cu"

#: the kernel variants of each mode, each one C entry point
#: ``jt_sig_scan_<mode>_<variant>`` with the same arguments
VARIANTS = {"hamming": ("generic", "w2"),
            "minhash": ("generic", "stream", "tiled")}
#: minhash: the most queries the ``stream`` variant takes (csrc: kSmallB)
SMALL_B = 4
#: minhash: the widest rows of ``stream`` and ``tiled`` (kStreamMaxW,
#: kTiledMaxW)
STREAM_MAX_W = 512
TILED_MAX_W = 128

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
#: what nvcc printed for the last build (ptxas register / spill report)
build_log = ""


def library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, build_log = _build.build(SOURCE)
        for mode, variants in VARIANTS.items():
            for variant in variants:
                fn = getattr(lib, f"jt_sig_scan_{mode}_{variant}")
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
                fn.restype = ctypes.c_int
        for mode in VARIANTS:
            fn = getattr(lib, f"jt_sig_scan_{mode}_gather")
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_float,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the kernel's reference)
# ---------------------------------------------------------------------------
def _words64(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & MASK


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of 32-bit words held in int64 (values in [0, 2^32))."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & MASK) >> 24


def _chunk(b: int, w: int) -> int:
    """Candidate rows per step so a [B, c, W] intermediate stays ~16M."""
    return max(1, (1 << 24) // max(1, b * w))


def hamming_plain(q: torch.Tensor, r: torch.Tensor, hash_num: int) -> torch.Tensor:
    scale = torch.tensor(np.float32(1.0 / hash_num), device=q.device)
    qw = _words64(q)[:, None, :]
    out = torch.empty((q.shape[0], r.shape[0]), dtype=torch.float32,
                      device=q.device)
    step = _chunk(q.shape[0], q.shape[1])
    for lo in range(0, r.shape[0], step):
        x = qw ^ _words64(r[lo:lo + step])[None, :, :]
        cnt = popcount32(x).sum(dim=-1)
        out[:, lo:lo + step] = cnt.to(torch.float32) * scale
    return out


def minhash_plain(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """1 - (equal-lane count) * (1/H): the equality mean, formed as the
    kernel forms it so the two agree bit for bit at every H."""
    scale = torch.tensor(np.float32(1.0 / q.shape[1]), device=q.device)
    out = torch.empty((q.shape[0], r.shape[0]), dtype=torch.float32,
                      device=q.device)
    step = _chunk(q.shape[0], q.shape[1])
    for lo in range(0, r.shape[0], step):
        cnt = (q[:, None, :] == r[None, lo:lo + step, :]).sum(dim=-1)
        out[:, lo:lo + step] = 1.0 - cnt.to(torch.float32) * scale
    return out


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------
def choose_variant(mode: str, b: int, w: int, aligned: bool) -> str:
    """The kernel variant for ``b`` queries of ``w`` words against a table
    whose data starts on 16 bytes (``aligned``); see the module note."""
    if mode == "hamming":
        return "w2" if w == 2 and aligned else "generic"
    if not aligned or w % 4:
        return "generic"
    if b <= SMALL_B:
        return "stream" if w <= STREAM_MAX_W else "generic"
    return "tiled" if w <= TILED_MAX_W else "generic"


class SigScan:
    """One mode of the scan. ``launches`` counts kernel launches only."""

    def __init__(self, mode: str) -> None:
        self.mode = mode
        self.launches = 0

    @staticmethod
    def _check(q: torch.Tensor, r: torch.Tensor) -> None:
        if q.device != r.device:
            raise ValueError(f"sig_scan: queries on {q.device}, "
                             f"table on {r.device}")
        if q.dtype != torch.int32 or r.dtype != torch.int32:
            raise TypeError("sig_scan: signature words must be int32 bit "
                            f"patterns, got {q.dtype} and {r.dtype}")
        if q.dim() != 2 or r.dim() != 2 or q.shape[1] != r.shape[1]:
            raise ValueError(f"sig_scan: shapes {tuple(q.shape)} and "
                             f"{tuple(r.shape)} do not match [B, W] x [C, W]")

    def __call__(self, q: torch.Tensor, r: torch.Tensor,
                 hash_num: int = 0) -> torch.Tensor:
        self._check(q, r)
        words = q.shape[1]
        if self.mode == "hamming":
            scale = 1.0 / hash_num
        else:
            scale = 1.0 / words
        if q.device.type == "cpu":
            if self.mode == "hamming":
                return hamming_plain(q, r, hash_num)
            return minhash_plain(q, r)
        if q.device.type != "cuda":
            raise ValueError(f"sig_scan: unsupported device {q.device}")
        if not (q.is_contiguous() and r.is_contiguous()):
            raise ValueError("sig_scan: inputs must be contiguous")
        b, c = q.shape[0], r.shape[0]
        out = torch.empty((b, c), dtype=torch.float32, device=q.device)
        if b == 0 or c == 0:
            return out
        variant = choose_variant(self.mode, b, words, r.data_ptr() % 16 == 0)
        fn = getattr(library(), f"jt_sig_scan_{self.mode}_{variant}")
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = fn(q.data_ptr(), r.data_ptr(), out.data_ptr(), b, c, words,
                     scale, stream)
        if err != 0:
            raise RuntimeError(f"sig_scan.{self.mode} ({variant}) launch "
                               f"failed: cudaError_t {err} (B={b}, C={c}, "
                               f"W={words})")
        self.launches += 1
        return out


hamming = SigScan("hamming")
minhash = SigScan("minhash")


def hamming_distances_batch(q_sigs: torch.Tensor, row_sigs: torch.Tensor, *,
                            hash_num: int) -> torch.Tensor:
    """q_sigs [B, W], row_sigs [C, W] → [B, C] normalized Hamming."""
    return hamming(q_sigs, row_sigs, hash_num)


def hamming_distances(q_sig: torch.Tensor, row_sigs: torch.Tensor, *,
                      hash_num: int) -> torch.Tensor:
    """q_sig [W], row_sigs [C, W] → [C]."""
    return hamming(q_sig[None, :], row_sigs, hash_num)[0]


def minhash_distances_batch(q_sigs: torch.Tensor,
                            row_sigs: torch.Tensor) -> torch.Tensor:
    """q_sigs [B, H], row_sigs [C, H] → [B, C] (1 - match fraction)."""
    return minhash(q_sigs, row_sigs)


def minhash_distances(q_sig: torch.Tensor, row_sigs: torch.Tensor) -> torch.Tensor:
    return minhash(q_sig[None, :], row_sigs)[0]


# ---------------------------------------------------------------------------
# the gathered variant (the IVF rescore)
# ---------------------------------------------------------------------------
def gathered_plain(mode: str, q: torch.Tensor, table: torch.Tensor,
                   cand: torch.Tensor, hash_num: int) -> torch.Tensor:
    """Plain version of the gathered variant: per query, gather its
    candidate rows and run ``hamming_plain`` / ``minhash_plain``."""
    out = torch.empty(cand.shape, dtype=torch.float32, device=q.device)
    rows = table[torch.clamp(cand, min=0).long()]            # [B, M, W]
    for b in range(q.shape[0]):
        if mode == "hamming":
            out[b] = hamming_plain(q[b:b + 1], rows[b], hash_num)[0]
        else:
            out[b] = minhash_plain(q[b:b + 1], rows[b])[0]
    return torch.where(cand >= 0, out, torch.full_like(out, float("inf")))


class GatherScan:
    """The gathered variant of one mode. ``launches`` counts kernel
    launches only."""

    def __init__(self, mode: str) -> None:
        self.mode = mode
        self.launches = 0

    def __call__(self, q: torch.Tensor, table: torch.Tensor,
                 cand: torch.Tensor, hash_num: int = 0) -> torch.Tensor:
        SigScan._check(q, table)
        if cand.device != q.device:
            raise ValueError(f"sig_scan.gather: candidates on {cand.device}, "
                             f"queries on {q.device}")
        if cand.dim() != 2 or cand.shape[0] != q.shape[0]:
            raise ValueError(f"sig_scan.gather: candidates {tuple(cand.shape)}"
                             f" for {q.shape[0]} queries")
        if q.device.type == "cpu":
            return gathered_plain(self.mode, q, table, cand, hash_num)
        if q.device.type != "cuda":
            raise ValueError(f"sig_scan.gather: unsupported device {q.device}")
        cand = cand.to(torch.int32)
        if not (q.is_contiguous() and table.is_contiguous()
                and cand.is_contiguous()):
            raise ValueError("sig_scan.gather: inputs must be contiguous")
        b, c, m, words = q.shape[0], table.shape[0], cand.shape[1], q.shape[1]
        out = torch.empty((b, m), dtype=torch.float32, device=q.device)
        if b == 0 or m == 0:
            return out
        scale = 1.0 / hash_num if self.mode == "hamming" else 1.0 / words
        fn = getattr(library(), f"jt_sig_scan_{self.mode}_gather")
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = fn(q.data_ptr(), table.data_ptr(), cand.data_ptr(),
                     out.data_ptr(), b, c, m, words, scale, stream)
        if err != 0:
            raise RuntimeError(f"sig_scan.{self.mode} (gather) launch failed: "
                               f"cudaError_t {err} (B={b}, C={c}, M={m}, "
                               f"W={words})")
        self.launches += 1
        return out


hamming_gather = GatherScan("hamming")
minhash_gather = GatherScan("minhash")
GATHERS = {"hamming": hamming_gather, "minhash": minhash_gather}


def gathered(mode: str, q: torch.Tensor, table: torch.Tensor,
             cand: torch.Tensor, hash_num: int = 0) -> torch.Tensor:
    """[B, M] distance of ``q[b]`` to ``table[cand[b, m]]`` in ``mode``
    (hamming or minhash), +inf where ``cand`` is −1."""
    return GATHERS[mode](q, table, cand, hash_num)
