"""Per-process runtime telemetry sampler (counterpart of
``jubatus_tpu/utils/runtime_telemetry.py``, on ``torch.cuda``).

One daemon thread per server that periodically samples:

- **process**: RSS/VIRT (``/proc/self/statm``), open FDs, thread count,
  GC generation counts + total collections (``_proc_sample``, the JAX
  package's as it is);
- **the card** (``_torch_sample``), in place of the JAX package's
  ``jax_*`` compiler and device keys: the caching allocator's bytes in
  use, bytes reserved, peak bytes, allocation retries and OOMs
  (``torch.cuda.memory_stats``, summed over the cards this process
  holds), the card's free and total bytes (``torch.cuda.mem_get_info``),
  and the port's kernel builds (``kernel_build_count`` /
  ``kernel_build_ms``: nvcc at first use, ops/_build.py), the
  counterpart of the XLA compile counters. The card is read only when
  CUDA is already initialized in this process: a sample never creates a
  CUDA context (jubactl, jubadump and jubacoordd must not pay for one),
  as the JAX sampler reads JAX only once it is imported;
- **forensics depth**: the owning registry's slow-log ring depth.

Every sample lands as gauges in the owning tracing ``Registry``
(``jubatus_runtime_gauge{key=...}`` on ``/metrics``) and in ``status()``
(merged as ``runtime.*`` keys into ``get_status`` and summarized in
``/healthz``). Sampling never raises: a missing /proc or an uninitialized
CUDA just drops keys.
"""

from __future__ import annotations

import gc
import logging
import os
import threading
import time
from typing import Any, Dict, Optional

from jubatus_tpu_torch.utils.tracing import Registry

log = logging.getLogger(__name__)

DEFAULT_INTERVAL_SEC = 10.0

#: torch.cuda.memory_stats key -> sample key (summed over the cards)
_MEMORY_STATS = {
    "allocated_bytes.all.current": "torch_device_bytes_in_use",
    "reserved_bytes.all.current": "torch_device_bytes_reserved",
    "allocated_bytes.all.peak": "torch_device_peak_bytes",
    "num_alloc_retries": "torch_alloc_retries",
    "num_ooms": "torch_ooms",
}


def _proc_sample() -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    try:
        with open("/proc/self/statm") as f:
            pages = f.read().split()
        page = os.sysconf("SC_PAGE_SIZE")
        out["vms_bytes"] = int(pages[0]) * page
        out["rss_bytes"] = int(pages[1]) * page
    except (OSError, IndexError, ValueError):
        pass
    try:
        out["open_fds"] = len(os.listdir("/proc/self/fd"))
    except OSError:
        pass
    out["threads"] = threading.active_count()
    gen = gc.get_count()
    for i, n in enumerate(gen):
        out[f"gc_gen{i}"] = n
    try:
        out["gc_collections"] = sum(
            s.get("collections", 0) for s in gc.get_stats())
    except Exception:  # noqa: BLE001 — telemetry must never raise
        pass
    return out


def _torch_sample() -> Dict[str, Any]:
    """The card's allocator and memory, and the kernel builds. The card is
    read only once CUDA is initialized in this process; the build counts
    need no device."""
    from jubatus_tpu_torch.ops._build import build_stats

    builds = build_stats()
    out: Dict[str, Any] = {"kernel_build_count": int(builds["count"]),
                           "kernel_build_ms": round(builds["ms"], 3)}
    import torch

    if not torch.cuda.is_initialized():
        return out
    try:
        sums = dict.fromkeys(_MEMORY_STATS.values(), 0)
        free = total = 0
        for i in range(torch.cuda.device_count()):
            ms = torch.cuda.memory_stats(i)
            if not ms.get("reserved_bytes.all.current"):
                continue  # a card this process holds nothing on
            for src, key in _MEMORY_STATS.items():
                sums[key] += int(ms.get(src, 0))
            f, t = torch.cuda.mem_get_info(i)
            free += int(f)
            total += int(t)
        out.update(sums)
        if total:
            out["torch_device_free_bytes"] = free
            out["torch_device_total_bytes"] = total
    except Exception:  # noqa: BLE001 — driver quirks must not kill sampling
        log.debug("device sample failed", exc_info=True)
    return out


class RuntimeTelemetry:
    """One process's sampler thread bound to one tracing Registry."""

    def __init__(self, registry: Registry,
                 interval_sec: float = DEFAULT_INTERVAL_SEC) -> None:
        self.registry = registry
        self.interval_sec = float(interval_sec)
        self._last: Dict[str, Any] = {}
        self._last_at = 0.0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._samples = 0
        #: per-tick callbacks: run after the runtime gauges are published,
        #: never raise (guarded anyway)
        self.hooks: list = []

    def sample(self) -> Dict[str, Any]:
        """Collect one sample now; publishes gauges into the registry and
        returns the sample dict (unprefixed keys)."""
        s = _proc_sample()
        s.update(_torch_sample())
        try:
            s["slowlog_depth"] = self.registry.slowlog.stats()["retained"]
        except Exception:  # noqa: BLE001
            pass
        with self._lock:
            self._samples += 1
            s["samples"] = self._samples
            self._last = s
            self._last_at = time.monotonic()
        for k, v in s.items():
            if isinstance(v, (int, float)):
                self.registry.gauge(k, v)
        for hook in list(self.hooks):
            try:
                hook()
            except Exception:  # noqa: BLE001 — a tick must never raise
                log.debug("telemetry tick hook failed", exc_info=True)
        return s

    def status(self) -> Dict[str, Any]:
        """Most recent sample, refreshed on demand when stale (> 1 s):
        get_status and /healthz readers see live numbers without paying a
        sample per call under scrape load."""
        with self._lock:
            fresh = (time.monotonic() - self._last_at) <= 1.0
            last = dict(self._last)
        if last and fresh:
            return last
        return self.sample()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None or self.interval_sec <= 0:
            return
        self.sample()  # get_status must have runtime keys immediately
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="runtime-telemetry")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_sec):
            try:
                self.sample()
            except Exception:  # noqa: BLE001 — the sampler must survive
                log.debug("runtime telemetry sample failed", exc_info=True)
