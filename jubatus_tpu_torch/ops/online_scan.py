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

On a CUDA tensor the wrapper launches a variant of the kernel chosen from
K (``choose_variant``) or raises; on a CPU tensor, and only there, it runs
``pa_scan_plain``, a loop over the examples that sums in the kernel's
order: lane l of 32 adds the products k = l, l+32, ... in turn, then a
tree adds the lanes (offsets 16, 8, 4, 2, 1); the scatter adds duplicate
indices in k order. On the CPU, where ``index_put_(accumulate=True)`` adds
serially in index order, the kernel and the plain version agree bit for
bit wherever ``dw`` holds no -0.0 on entry (the kernel skips updates of
+-0, which change no other value; the drivers' ``dw`` starts at +0.0), and
as values otherwise. On the card PyTorch's ``index_put_`` sums each run of
duplicate indices in its own order before adding it, so there the two
agree only within a few ulps wherever a row repeats an index.

Variants: ``r1`` / ``r2`` / ``r4`` (K up to 32 / 64 / 128) hold dw's
working set in a slot table in shared memory, walked by one warp while 18
warps stage tiles of ``tile_for(K)`` examples; the table flushes to dw
when it holds more than ``table_capacity(K)`` keys before a tile. ``direct``
(K up to ``MAX_K``) keeps dw in device memory. ``pa_scan.launches`` counts
kernel launches, ``pa_scan.by_variant`` the launches of each variant.

``pa_scan.plan(...)`` checks a call (the index bounds cost one device sync)
and returns a ``ScanLaunch`` whose ``run()`` launches without checking
again, so a timing can leave the check out of its window. After a launch,
``pa_scan.last_stats`` holds the device tensor of its counters
(``STATS``).

``latency_probe`` times one step of the scan's dependence chain on the card
(a dependent load from device memory and from shared memory, a dependent
shuffle-add, a shared-memory load behind the warp's own store): the
numbers the scan's bounds are worked out from.
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
#: kernel variants, by their number in the C interface
VARIANTS = ("direct", "r1", "r2", "r4")
LANES = 32
#: shared memory a launch may take (H100: 227 KB per block)
MAX_SMEM = 227 * 1024
#: the table variants: slots of the shared-memory table, elements of one
#: staged tile, ring buffers (csrc/online_scan.cu)
TABLE_SLOTS = 1 << 14
TILE_ELEMS = 2048
RING = 2
MAX_TILE = 256
#: the counters a launch writes (the kernel's ScanArgs::stats): table
#: flushes; the walker's cycles waiting for a tile and in all; staging
#: thread 0's cycles waiting for a ring buffer, flushing, mapping elements
#: to slots, on per-example work, and in all (0 where a variant has none)
STATS = ("flushes", "walker_wait_cycles", "walker_cycles",
         "stage_wait_cycles", "stage_flush_cycles", "stage_map_cycles",
         "stage_info_cycles", "stage_cycles")
#: the direct variant: shared memory for one tile of staged examples
TILE_BYTES = 40 * 1024
#: the widest rows any variant takes (one direct tile of one example)
MAX_K = (MAX_SMEM - 4 - LANES * 4) // 8

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
        lib.jt_pa_scan.argtypes = [P, P, P, P, P, P, I, I, I, I, I, F, F, P]
        lib.jt_pa_scan.restype = I
        lib.jt_pa_scan_smem_bytes.argtypes = [I, I, I]
        lib.jt_pa_scan_smem_bytes.restype = ctypes.c_size_t
        lib.jt_latency_probe.argtypes = [P, I, I, P, P]
        lib.jt_latency_probe.restype = I
        _lib = lib
        return lib


def choose_variant(k: int) -> str:
    """The variant that takes rows of width k; raises for what none takes."""
    if k < 1 or k > MAX_K:
        raise ValueError(f"online_scan: rows of {k} features: no kernel "
                         f"variant takes them (1..{MAX_K})")
    for rounds, name in ((1, "r1"), (2, "r2"), (4, "r4")):
        if k <= rounds * LANES:
            return name
    return "direct"


def tile_for(k: int) -> int:
    """Examples staged in shared memory at a time for rows of width k."""
    if choose_variant(k) == "direct":
        return max(1, min(MAX_TILE, TILE_BYTES // (k * 8 + 4)))
    return max(1, min(MAX_TILE, TILE_ELEMS // k))


def _up16(x: int) -> int:
    return (x + 15) & ~15


def smem_bytes(k: int) -> int:
    """Shared memory of one launch for rows of width k (the kernel's
    ``layout``; ``jt_pa_scan_smem_bytes`` computes the same)."""
    tile = tile_for(k)
    if choose_variant(k) == "direct":
        return tile * k * 8 + tile * 4 + LANES * 4
    ring = _up16(tile * k * 16 + tile * 12)
    return TABLE_SLOTS * 9 + RING * ring + 2 * RING * 8 + 16


def table_capacity(k: int) -> int:
    """Distinct keys the table holds before a tile without flushing (table
    variants): 3/4 of the slots less one tile's elements."""
    return TABLE_SLOTS // 4 * 3 - tile_for(k) * k


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
class ScanLaunch:
    """One checked launch of the kernel; ``run()`` launches it (counted)
    without checking again, and may be called again on the same tensors."""

    def __init__(self, owner: "OnlineScan", w, dw, idx, val, targets,
                 sensitivity, c, method: str) -> None:
        self.owner = owner
        self.tensors = (w, dw, idx, val, targets)
        self.b, self.k = idx.shape
        self.variant = choose_variant(self.k)
        self.tile = tile_for(self.k)
        self.method = METHODS.index(method)
        self.sensitivity = float(np.float32(sensitivity))
        self.c = float(np.float32(c))
        self.stats = torch.empty(len(STATS), dtype=torch.int64,
                                 device=dw.device)

    def run(self) -> torch.Tensor:
        w, dw, idx, val, targets = self.tensors
        with torch.cuda.device(dw.device):
            stream = torch.cuda.current_stream(dw.device).cuda_stream
            err = library().jt_pa_scan(
                w.data_ptr(), dw.data_ptr(), idx.data_ptr(), val.data_ptr(),
                targets.data_ptr(), self.stats.data_ptr(), self.b, self.k,
                self.tile, VARIANTS.index(self.variant), self.method,
                self.sensitivity, self.c, stream)
        if err != 0:
            raise RuntimeError(
                f"online_scan launch failed: cudaError_t {err} (B={self.b}, "
                f"K={self.k}, variant={self.variant}, tile={self.tile})")
        self.owner.launches += 1
        self.owner.by_variant[self.variant] += 1
        self.owner.last_stats = self.stats
        return dw


class OnlineScan:
    """``launches`` counts kernel launches only, ``by_variant`` the same
    launches by variant."""

    def __init__(self) -> None:
        self.launches = 0
        self.by_variant = {v: 0 for v in VARIANTS}
        self.last_stats: Optional[torch.Tensor] = None

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

    def plan(self, w, dw, idx, val, targets, sensitivity, c,
             method: str) -> Optional[ScanLaunch]:
        """Check a call on CUDA tensors (one device sync for the index
        bounds) and return its launch; None when there is nothing to do."""
        self._check(w, dw, idx, val, targets, method)
        if dw.device.type != "cuda":
            raise ValueError(f"online_scan: no kernel for device {dw.device}")
        if not all(t.is_contiguous() for t in (w, dw, idx, val, targets)):
            raise ValueError("online_scan: inputs must be contiguous")
        b, k = idx.shape
        if b == 0 or k == 0:
            return None
        choose_variant(k)
        # one sync: the kernel trusts every index it is given
        lo, hi = torch.stack(torch.aminmax(idx)).tolist()
        if lo < 0 or hi >= dw.shape[0]:
            raise ValueError(f"online_scan: indices in [{lo}, {hi}] outside "
                             f"[0, {dw.shape[0]})")
        return ScanLaunch(self, w, dw, idx, val, targets, sensitivity, c,
                          method)

    def __call__(self, w, dw, idx, val, targets, sensitivity, c,
                 method: str) -> torch.Tensor:
        self._check(w, dw, idx, val, targets, method)
        if dw.device.type == "cpu":
            return pa_scan_plain(w, dw, idx, val, targets, sensitivity, c,
                                 method)
        launch = self.plan(w, dw, idx, val, targets, sensitivity, c, method)
        return dw if launch is None else launch.run()

    def stats(self) -> dict:
        """The last launch's counters (synchronises)."""
        return dict(zip(STATS, self.last_stats.tolist()))


pa_scan = OnlineScan()

#: words of the probe's shared-memory chain (kProbeWords in the source)
PROBE_SMEM_WORDS = 8192


def _cycle(n: int, rng) -> np.ndarray:
    """A random cycle through n int32 words: chain[p] is p's successor."""
    perm = rng.permutation(n)
    chain = np.empty(n, dtype=np.int32)
    chain[perm] = np.roll(perm, -1)
    return chain


def latency_probe(device, hops: int = 1 << 16, footprint: int = 1 << 18,
                  seed: int = 0) -> dict:
    """Per-step latency, in ns, of a dependent load from device memory over
    a random cycle of ``footprint`` int32 words (warm: the second of two
    runs), of a dependent load from shared memory over a random cycle of
    PROBE_SMEM_WORDS words (the launch copies them in first: 8192 words
    against ``hops`` dependent loads), of a dependent warp shuffle-add,
    and of a warp's shared-memory load, add and store to the same word
    with the next load at another word (``smem_store_load_ns``), each
    timed with CUDA events over ``hops`` steps."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    chains = {0: torch.from_numpy(_cycle(footprint, rng)).to(dev),
              2: torch.from_numpy(_cycle(PROBE_SMEM_WORDS, rng)).to(dev)}
    chains[1] = chains[3] = chains[0]
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = library()
    res = {}
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for mode, name in ((0, "load_ns"), (1, "shuffle_ns"),
                           (2, "smem_load_ns"), (3, "smem_store_load_ns")):
            times = []
            for _ in range(2):
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                err = lib.jt_latency_probe(chains[mode].data_ptr(), hops,
                                           mode, out.data_ptr(), stream)
                t1.record()
                if err != 0:
                    raise RuntimeError(f"latency probe failed: {err}")
                torch.cuda.synchronize(dev)
                times.append(t0.elapsed_time(t1))
            res[name] = times[-1] * 1e6 / hops
    return res
