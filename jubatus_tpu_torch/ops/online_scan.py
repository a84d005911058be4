"""Regression's per-example passive-aggressive scan: the CUDA kernel, its
launcher, and its plain version.

``jubatus_tpu/ops/regression.py:train_batch`` scans the examples in order
with ``jax.lax.scan``, one device-side loop. PyTorch has no such loop, so
the scan is one hand-written kernel (``csrc/online_scan.cu``; its note says
what bounds it and what the design does about that). It replaces no Pallas
kernel.

``pa_scan(w, dw, idx, val, targets, sensitivity, c, method)`` updates ``dw``
in place: w, dw [D] float32; idx [B, K] int32; val [B, K] float32; targets
[B] float32; method PA / PA1 / PA2; sensitivity and c are rounded to
float32, as the JAX jit traces them.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor, and only there, it runs ``pa_scan_plain``, a loop over the examples
that sums in the kernel's order: lane l of 32 adds the products k = l,
l+32, ... in turn, then a tree adds the lanes (offsets 16, 8, 4, 2, 1); the
scatter adds duplicate indices in k order. On the CPU, where
``index_put_(accumulate=True)`` adds serially in index order, the kernel and
the plain version agree bit for bit. On the card PyTorch's ``index_put_``
sums each run of duplicate indices in its own order before adding it, so
there the two agree only within a few ulps wherever a row repeats an index.
``pa_scan.launches`` counts kernel launches.

``latency_probe`` times one step of the scan's dependence chain on the card
(a dependent global load, a dependent shuffle-add): the numbers the scan's
bound is worked out from.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np
import torch

from jubatus_tpu_torch.ops import _build

SOURCE = _build.CSRC / "online_scan.cu"
METHODS = ("PA", "PA1", "PA2")
LANES = 32
#: shared memory for one tile of staged examples, and the most per launch
TILE_BYTES = 40 * 1024
MAX_SMEM = 227 * 1024
MAX_TILE = 256

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
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.jt_pa_scan.argtypes = [P, P, P, P, P, I, I, I, I, F, F, P]
        lib.jt_pa_scan.restype = I
        lib.jt_latency_probe.argtypes = [P, I, I, P, P]
        lib.jt_latency_probe.restype = I
        _lib = lib
        return lib


def tile_for(k: int) -> int:
    """Examples staged in shared memory at a time for rows of width k."""
    return max(1, min(MAX_TILE, TILE_BYTES // (k * 8 + 4)))


# ---------------------------------------------------------------------------
# the plain version (the CPU path, and the kernel's reference)
# ---------------------------------------------------------------------------
def _lane_tree(x: torch.Tensor) -> torch.Tensor:
    """Sum of x [K] in the kernel's order (module note)."""
    rounds = -(-x.shape[0] // LANES)
    pad = rounds * LANES - x.shape[0]
    lanes = torch.nn.functional.pad(x, (0, pad)).view(rounds, LANES)
    acc = lanes[0]
    for r in range(1, rounds):
        acc = acc + lanes[r]
    off = LANES // 2
    while off:
        acc = acc[:off] + acc[off:2 * off]
        off //= 2
    return acc[0]


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(np.float32(x), device=device)


def pa_scan_plain(w: torch.Tensor, dw: torch.Tensor, idx: torch.Tensor,
                  val: torch.Tensor, targets: torch.Tensor, sensitivity,
                  c, method: str) -> torch.Tensor:
    """The scan one example at a time, about 15 PyTorch ops each; dw is
    updated in place and returned."""
    dev = dw.device
    sens, c_t = _f32(sensitivity, dev), _f32(c, dev)
    for b in range(idx.shape[0]):
        e_idx, e_val = idx[b], val[b]
        pred = _lane_tree((w[e_idx] + dw[e_idx]) * e_val)
        x2 = torch.clamp_min(_lane_tree(e_val * e_val), 1e-12)
        err = targets[b] - pred
        loss = err.abs() - sens
        if method == "PA":
            alpha = loss / x2
        elif method == "PA1":
            alpha = torch.minimum(c_t, loss / x2)
        elif method == "PA2":
            alpha = loss / (x2 + 1.0 / (2.0 * c_t))
        else:
            raise ValueError(f"unknown regression method {method!r}")
        alpha = torch.where(loss > 0.0, alpha, 0.0)
        dw.index_put_((e_idx,), torch.sign(err) * alpha * e_val,
                      accumulate=True)
    return dw


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------
class OnlineScan:
    """``launches`` counts kernel launches only."""

    def __init__(self) -> None:
        self.launches = 0

    @staticmethod
    def _check(w, dw, idx, val, targets, method) -> None:
        if method not in METHODS:
            raise ValueError(f"unknown regression method {method!r}")
        devs = {t.device for t in (w, dw, idx, val, targets)}
        if len(devs) != 1:
            raise ValueError(f"online_scan: tensors on several devices {devs}")
        if idx.dtype != torch.int32:
            raise TypeError(f"online_scan: idx must be int32, got {idx.dtype}")
        for name, t in (("w", w), ("dw", dw), ("val", val),
                        ("targets", targets)):
            if t.dtype != torch.float32:
                raise TypeError(f"online_scan: {name} must be float32, "
                                f"got {t.dtype}")
        if (w.dim() != 1 or dw.shape != w.shape or idx.dim() != 2
                or val.shape != idx.shape
                or targets.shape != (idx.shape[0],)):
            raise ValueError(
                f"online_scan: shapes w {tuple(w.shape)}, dw "
                f"{tuple(dw.shape)}, idx {tuple(idx.shape)}, val "
                f"{tuple(val.shape)}, targets {tuple(targets.shape)}")

    def __call__(self, w, dw, idx, val, targets, sensitivity, c,
                 method: str) -> torch.Tensor:
        self._check(w, dw, idx, val, targets, method)
        if dw.device.type == "cpu":
            return pa_scan_plain(w, dw, idx, val, targets, sensitivity, c,
                                 method)
        if dw.device.type != "cuda":
            raise ValueError(f"online_scan: unsupported device {dw.device}")
        if not all(t.is_contiguous() for t in (w, dw, idx, val, targets)):
            raise ValueError("online_scan: inputs must be contiguous")
        b, k = idx.shape
        if b == 0 or k == 0:
            return dw
        # one sync: the kernel trusts every index it is given
        lo, hi = torch.stack(torch.aminmax(idx)).tolist()
        if lo < 0 or hi >= dw.shape[0]:
            raise ValueError(f"online_scan: indices in [{lo}, {hi}] outside "
                             f"[0, {dw.shape[0]})")
        tile = tile_for(k)
        if tile * k * 8 + tile * 4 + LANES * 4 > MAX_SMEM:
            raise ValueError(f"online_scan: rows of {k} features do not fit "
                             "the kernel's shared memory")
        with torch.cuda.device(dw.device):
            stream = torch.cuda.current_stream(dw.device).cuda_stream
            err = library().jt_pa_scan(
                w.data_ptr(), dw.data_ptr(), idx.data_ptr(), val.data_ptr(),
                targets.data_ptr(), b, k, tile, METHODS.index(method),
                float(np.float32(sensitivity)), float(np.float32(c)), stream)
        if err != 0:
            raise RuntimeError(f"online_scan launch failed: cudaError_t {err} "
                               f"(B={b}, K={k}, tile={tile})")
        self.launches += 1
        return dw


pa_scan = OnlineScan()


def latency_probe(device, hops: int = 1 << 16, footprint: int = 1 << 18,
                  seed: int = 0) -> dict:
    """Per-step latency, in ns, of a dependent global load over a random
    cycle of ``footprint`` int32 words (warm: the second of two runs) and
    of a dependent warp shuffle-add, each timed with CUDA events over
    ``hops`` steps."""
    dev = torch.device(device)
    perm = np.random.default_rng(seed).permutation(footprint)
    chain = np.empty(footprint, dtype=np.int32)
    chain[perm] = np.roll(perm, -1)
    chain_t = torch.from_numpy(chain).to(dev)
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = library()
    res = {}
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for mode, name in ((0, "load_ns"), (1, "shuffle_ns")):
            times = []
            for _ in range(2):
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                err = lib.jt_latency_probe(chain_t.data_ptr(), hops, mode,
                                           out.data_ptr(), stream)
                t1.record()
                if err != 0:
                    raise RuntimeError(f"latency probe failed: {err}")
                torch.cuda.synchronize(dev)
                times.append(t0.elapsed_time(t1))
            res[name] = times[-1] * 1e6 / hops
    return res
