"""Continuous profiling plane (counterpart of
``jubatus_tpu/utils/profiler.py``).

Three capture modes:

- **Always-on sampling profiler** (:class:`SamplingProfiler`, the JAX
  package's as it is: pure Python over ``sys._current_frames()``): one
  daemon thread per server samples every thread's stack at
  ``--profile-hz`` (default ~67 Hz, a non-round rate so the sampler never
  phase-locks with periodic work; 0 = fully off, no thread). Samples fold
  into collapsed-stack keys (``root;caller;...;leaf``, one
  ``file.py:function`` token per frame) in a BOUNDED store: at most
  ``max_stacks`` distinct keys per bucket, overflow folding into
  ``(other)``. The store is windowed — the live bucket rotates into a
  bounded ring every ``bucket_s`` seconds, so ``profile(seconds=N)`` is
  an exact fold of the last N seconds. Served by the ``get_profile`` RPC
  and dumped by ``jubadump --profile``.
- **On-demand device capture** (:class:`DeviceCapture`): the
  ``profile_device`` RPC runs ``torch.profiler`` for a bounded duration
  (CPU ops, and the card's kernels — the hand-written ones under their
  own names — once CUDA is in use) and writes a Chrome trace into a fresh
  subdirectory of a capped artifacts directory (``--profile-dir``). Old
  captures are pruned.
- **Tail-triggered snapshots**: when utils/slowlog.py sees K breaches
  of the same span inside a window (``--profile-trigger-*``), it calls
  :meth:`SamplingProfiler.tail_snapshot`, which folds the last few
  seconds of samples into a bounded snapshot ring stamped with the
  offending trace_ids.

The sampler accounts its own wall time (``profiler.overhead_ms_per_s``
gauge).
"""

from __future__ import annotations

import logging
import os
import shutil
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from jubatus_tpu_torch.utils.disk import tree_bytes
from jubatus_tpu_torch.utils.tracing import Registry

log = logging.getLogger(__name__)

#: default sampling rate; ~67 Hz ≈ 15 ms period — coarse enough to stay
#: invisible next to a multi-ms RPC, fine enough that a 1-second stall
#: lands ~67 samples
DEFAULT_HZ = 67.0
#: distinct collapsed-stack keys retained per bucket before overflow
#: folds into ``(other)``
DEFAULT_MAX_STACKS = 512
#: live-bucket rotation period (the window resolution of ``profile()``)
DEFAULT_BUCKET_S = 5.0
#: ring depth: 10 minutes of history at the 5 s bucket
DEFAULT_RING = 120
#: tail-triggered snapshot ring depth
DEFAULT_SNAPSHOTS = 16
#: seconds of samples a tail-triggered snapshot folds
SNAPSHOT_WINDOW_S = 5.0
#: frames deeper than this truncate (a runaway recursion must not mint
#: unbounded keys)
MAX_DEPTH = 64

#: overflow key for stacks beyond the per-bucket bound
OTHER_KEY = "(other)"
#: a device capture's Chrome trace, inside its artifact directory
TRACE_FILE = "trace.json"


#: code object -> "file.py:func" token. Memoized because the token is
#: rebuilt for EVERY frame of EVERY thread at the sampling rate — the
#: basename+format work dominated the raw sample cost. Keyed by the
#: code object itself (keeps it alive; the population is bounded by the
#: program's code, and the overflow clear below backstops pathological
#: dynamic-code generators). Plain dict: GIL-atomic get/set.
_CODE_TOKENS: Dict[Any, str] = {}
_CODE_TOKENS_CAP = 8192


def _code_token(co: Any) -> str:
    tok = _CODE_TOKENS.get(co)
    if tok is None:
        if len(_CODE_TOKENS) >= _CODE_TOKENS_CAP:
            _CODE_TOKENS.clear()
        tok = _CODE_TOKENS[co] = \
            f"{os.path.basename(co.co_filename)}:{co.co_name}"
    return tok


def collapse_frame(frame: Any, thread_name: str = "") -> str:
    """One thread's stack as a collapsed key: ``root;...;leaf`` with
    ``file.py:function`` tokens (basename only, NO line numbers — hot
    functions aggregate; the key space stays bounded by the code, not
    the data). The thread name roots the stack so worker pools and the
    accept loop separate in a flamegraph."""
    parts: List[str] = []
    f = frame
    while f is not None and len(parts) < MAX_DEPTH:
        parts.append(_code_token(f.f_code))
        f = f.f_back
    parts.reverse()
    if thread_name:
        parts.insert(0, f"thread:{thread_name}")
    return ";".join(parts) if parts else "(empty)"


class SamplingProfiler:
    """Per-process always-on stack sampler with a bounded, windowed
    aggregate store. One instance per server, bound to its tracing
    Registry (gauges/counters land there)."""

    def __init__(self, registry: Optional[Registry] = None,
                 hz: float = DEFAULT_HZ,
                 max_stacks: int = DEFAULT_MAX_STACKS,
                 bucket_s: float = DEFAULT_BUCKET_S,
                 ring_capacity: int = DEFAULT_RING,
                 snapshot_capacity: int = DEFAULT_SNAPSHOTS) -> None:
        self.registry = registry
        self.hz = max(0.0, float(hz))
        self.max_stacks = max(8, int(max_stacks))
        self.bucket_s = max(0.5, float(bucket_s))
        self._lock = threading.Lock()
        #: live bucket: collapsed key -> sample count
        self._current: Dict[str, int] = {}
        self._current_start = time.time()  # wall-clock
        #: rotated buckets, oldest-first: (t_start, t_end, {key: count})
        self._ring: deque = deque(maxlen=max(2, int(ring_capacity)))
        #: tail-triggered snapshots (see tail_snapshot)
        self._snapshots: deque = deque(maxlen=max(1, int(snapshot_capacity)))
        self._samples = 0
        self._truncated = 0
        self._snapshots_taken = 0
        self._sample_s = 0.0          # cumulative wall time spent sampling
        self._bucket_samples = 0      # since last rotation (for gauges)
        self._bucket_sample_s = 0.0
        self._thread_names: Dict[int, str] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def enabled(self) -> bool:
        return self.hz > 0

    # -- sampling ------------------------------------------------------------
    def sample_once(self) -> int:
        """Take one sample of every live thread (except the sampler
        itself); returns the number of stacks folded."""
        t0 = time.perf_counter()
        me = threading.get_ident()
        frames = sys._current_frames()
        keys: List[str] = []
        fresh_names = None
        for ident, frame in frames.items():
            if ident == me:
                continue
            name = self._thread_names.get(ident)
            if name is None:
                if fresh_names is None:
                    fresh_names = {t.ident: t.name
                                   for t in threading.enumerate()}
                    self._thread_names = fresh_names
                name = fresh_names.get(ident, "?")
            keys.append(collapse_frame(frame, name))
        del frames
        now = time.time()  # wall-clock: windows compare across nodes
        cost = time.perf_counter() - t0
        with self._lock:
            self._samples += 1
            self._bucket_samples += 1
            self._sample_s += cost
            self._bucket_sample_s += cost
            for k in keys:
                self._ingest_locked(k)
            rotated = None
            if now - self._current_start >= self.bucket_s:
                rotated = self._rotate_locked(now)
        if rotated is not None:
            self._publish(rotated)
        return len(keys)

    def _ingest_locked(self, key: str) -> None:
        cur = self._current
        n = cur.get(key)
        if n is not None:
            cur[key] = n + 1
        elif len(cur) < self.max_stacks:
            cur[key] = 1
        else:
            cur[OTHER_KEY] = cur.get(OTHER_KEY, 0) + 1
            self._truncated += 1

    def _rotate_locked(self, now: float) -> Dict[str, Any]:
        """Push the live bucket into the ring; returns the gauge doc the
        caller publishes OUTSIDE the lock."""
        self._ring.append((self._current_start, now, self._current))
        doc = {
            "stacks": len(self._current),
            "samples": self._bucket_samples,
            "wall_s": max(now - self._current_start, 1e-9),
            "sample_s": self._bucket_sample_s,
        }
        self._current = {}
        self._current_start = now
        self._bucket_samples = 0
        self._bucket_sample_s = 0.0
        return doc

    def _publish(self, doc: Dict[str, Any]) -> None:
        reg = self.registry
        if reg is None:
            return
        reg.count("profiler.samples", int(doc["samples"]))
        reg.gauge("profiler.hz", self.hz)
        reg.gauge("profiler.stacks", doc["stacks"])
        reg.gauge("profiler.overhead_ms_per_s",
                  round(doc["sample_s"] / doc["wall_s"] * 1e3, 3))

    # -- views ---------------------------------------------------------------
    def profile(self, seconds: float = 0.0) -> Dict[str, Any]:
        """Wire-safe folded view over the last ``seconds`` (0 = every
        retained bucket): collapsed stacks, sampler stats, and the
        tail-triggered snapshot ring."""
        now = time.time()  # wall-clock
        with self._lock:
            entries: List[Tuple[float, float, Dict[str, int]]] = \
                list(self._ring)
            entries.append((self._current_start, now, dict(self._current)))
            snapshots = [dict(s) for s in self._snapshots]
            stats = self._stats_locked()
        start = now - float(seconds) if seconds and seconds > 0 else 0.0
        folded: Dict[str, int] = {}
        t_oldest = now
        for t0, t1, bucket in entries:
            if t1 < start:
                continue
            t_oldest = min(t_oldest, t0)
            for k, v in bucket.items():
                folded[k] = folded.get(k, 0) + v
        return {"folded": folded,
                "ts_start": round(max(start, t_oldest), 3),
                "ts_end": round(now, 3),
                "stats": stats,
                "snapshots": snapshots}

    def tail_snapshot(self, span: str,
                      trace_ids: Optional[List[str]] = None
                      ) -> Optional[Dict[str, Any]]:
        """Fold the last ``SNAPSHOT_WINDOW_S`` seconds of samples into a
        snapshot stamped with the breaching span + trace_ids and ring
        it (utils/slowlog.py's breach trigger calls this). No-op when
        the sampler is off — there is nothing to snapshot."""
        if not self.enabled:
            return None
        doc = self.profile(SNAPSHOT_WINDOW_S)
        rec = {"span": str(span),
               "trace_ids": [str(t) for t in (trace_ids or []) if t][:8],
               "ts": round(time.time(), 3),  # wall-clock
               "window_s": SNAPSHOT_WINDOW_S,
               "samples": sum(doc["folded"].values()),
               "folded": doc["folded"]}
        with self._lock:
            self._snapshots.append(rec)
            self._snapshots_taken += 1
        if self.registry is not None:
            self.registry.count("profiler.snapshots")
        return rec

    def snapshots(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(s) for s in self._snapshots]

    def _stats_locked(self) -> Dict[str, Any]:
        return {"enabled": self.enabled,
                "hz": self.hz,
                "samples": self._samples,
                "truncated": self._truncated,
                "ring_buckets": len(self._ring),
                "bucket_s": self.bucket_s,
                "current_stacks": len(self._current),
                "max_stacks": self.max_stacks,
                "snapshots_taken": self._snapshots_taken,
                "sample_ms_total": round(self._sample_s * 1e3, 3)}

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return self._stats_locked()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        if not self.enabled or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="stack-profiler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _loop(self) -> None:
        period = 1.0 / self.hz
        while not self._stop.wait(period):
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 — the sampler must survive
                log.debug("stack sample failed", exc_info=True)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._snapshots.clear()
            self._current = {}
            self._current_start = time.time()  # wall-clock
            self._samples = self._truncated = self._snapshots_taken = 0
            self._sample_s = 0.0
            self._bucket_samples = 0
            self._bucket_sample_s = 0.0


# -- cross-node folding + rendering -------------------------------------------


def fold_profiles(docs) -> Dict[str, int]:
    """Fold N ``profile()`` docs (or bare folded dicts) into one
    collapsed-stack map — bucket-wise sums, deterministic regardless of
    input order (same property as tracing.merge_snapshots)."""
    out: Dict[str, int] = {}
    for doc in docs:
        folded = doc.get("folded", doc) if isinstance(doc, dict) else {}
        for k, v in (folded or {}).items():
            out[str(k)] = out.get(str(k), 0) + int(v)
    return out


def folded_lines(folded: Dict[str, int]) -> List[str]:
    """flamegraph.pl / speedscope input: one ``stack count`` line per
    collapsed key, sorted for determinism."""
    return [f"{k} {v}" for k, v in sorted(folded.items())]


def top_table(folded: Dict[str, int]) -> List[Dict[str, Any]]:
    """Per-frame self/cumulative sample counts from a folded map,
    hottest-self first. ``cum`` counts each stack once per frame even
    under recursion (set-dedup within the stack)."""
    self_c: Dict[str, int] = {}
    cum: Dict[str, int] = {}
    total = 0
    for stack, n in folded.items():
        n = int(n)
        total += n
        frames = stack.split(";")
        leaf = frames[-1]
        self_c[leaf] = self_c.get(leaf, 0) + n
        for f in set(frames):
            cum[f] = cum.get(f, 0) + n
    rows = []
    for frame in cum:
        s = self_c.get(frame, 0)
        rows.append({
            "frame": frame,
            "self": s,
            "cum": cum[frame],
            "self_pct": round(s / total * 100, 2) if total else 0.0,
            "cum_pct": round(cum[frame] / total * 100, 2) if total else 0.0,
        })
    rows.sort(key=lambda r: (-r["self"], -r["cum"], r["frame"]))
    return rows


def render_top(folded: Dict[str, int], top: int = 30) -> str:
    """The profile table (the JAX package's ``jubactl -c profile``
    view): top-N frames by self time."""
    total = sum(int(v) for v in folded.values())
    lines = [f"{'self%':>7} {'cum%':>7} {'self':>8} {'cum':>8}  frame"]
    for row in top_table(folded)[:max(1, int(top))]:
        lines.append(f"{row['self_pct']:>6.2f}% {row['cum_pct']:>6.2f}% "
                     f"{row['self']:>8} {row['cum']:>8}  {row['frame']}")
    lines.append(f"total: {total} sample(s), "
                 f"{len(folded)} distinct stack(s)")
    return "\n".join(lines)


# -- on-demand device capture -------------------------------------------------

#: torch.profiler is process-wide: one capture at a time in a process,
#: whichever server (or caller) runs it
_capture_lock = threading.Lock()


def kineto_profile(cuda: bool):
    """A kineto capture of CPU ops and, with ``cuda``, the card's kernels
    and copies: ``torch.autograd.profiler.profile``, whose
    ``export_chrome_trace`` writes the same Chrome trace as
    ``torch.profiler.profile``'s. Not the latter: its start imports
    ``torch._inductor`` to read one config flag, which took 10.7–14.4 s of
    a server's first capture on an NVIDIA H100 80GB HBM3 at 700 W (triton
    is installed there)."""
    from torch.autograd.profiler import profile

    return profile(use_cpu=True, use_device="cuda" if cuda else None,
                   use_kineto=True)


class DeviceCapture:
    """Bounded torch.profiler capture directory: ``capture(seconds)``
    records CPU ops and, once CUDA is in use, the card's kernels and
    copies into a Chrome trace (``trace.json``) in a fresh subdirectory,
    pruning the oldest captures past ``max_captures`` so the artifacts dir
    is capped."""

    def __init__(self, base_dir: str, max_captures: int = 8) -> None:
        self.base_dir = str(base_dir)
        self.max_captures = max(1, int(max_captures))
        self._captures = 0

    #: a single capture may not run longer than this (its caller waits
    #: for the start, the window, the stop and the export)
    MAX_SECONDS = 60.0

    def capture(self, seconds: float) -> Dict[str, Any]:
        """Trace for ``seconds`` (clamped to [0.05, MAX_SECONDS]); returns
        {"artifact": path, ...} or {"error": ...}. ``timing_ms`` splits the
        capture's wall: the profiler's ``start`` (kineto's set-up), the
        ``window``, its ``stop`` (device sync, the activity buffers
        collected) and the Chrome trace's ``export``. A capture already running
        in this process (this or another server's, or any other
        torch.profiler session) answers "capture already in progress", and
        a failing profiler degrades to a structured error, never an
        exception on the RPC plane."""
        seconds = min(max(float(seconds), 0.05), self.MAX_SECONDS)
        if not _capture_lock.acquire(blocking=False):
            return {"error": "capture already in progress",
                    "dir": self.base_dir}
        try:
            import torch

            if torch.autograd.profiler._is_profiler_enabled:
                return {"error": "capture already in progress",
                        "dir": self.base_dir}
            self._captures += 1
            stamp = time.strftime("%Y%m%d-%H%M%S")  # wall-clock
            path = os.path.join(self.base_dir,
                                f"device-{stamp}-{self._captures:03d}")
            cuda = torch.cuda.is_initialized()
            activities = ["CPU", "CUDA"] if cuda else ["CPU"]
            marks = [time.perf_counter()]
            try:
                os.makedirs(path, exist_ok=True)
                with kineto_profile(cuda) as prof:
                    marks.append(time.perf_counter())
                    time.sleep(seconds)
                    marks.append(time.perf_counter())
                marks.append(time.perf_counter())
                prof.export_chrome_trace(os.path.join(path, TRACE_FILE))
                marks.append(time.perf_counter())
            except Exception as e:  # noqa: BLE001 — profiler quirks degrade
                log.warning("device capture failed", exc_info=True)
                shutil.rmtree(path, ignore_errors=True)
                return {"error": f"{type(e).__name__}: {e}",
                        "dir": self.base_dir}
            self._prune()
            return {"artifact": path, "seconds": seconds,
                    "bytes": tree_bytes(path),
                    "activities": activities,
                    "timing_ms": {
                        k: round((b - a) * 1e3, 3) for k, a, b in zip(
                            ("start", "window", "stop", "export"),
                            marks, marks[1:])}}
        finally:
            _capture_lock.release()

    def list(self) -> Dict[str, Any]:
        """Existing capture artifacts, oldest-first."""
        arts = []
        try:
            names = sorted(os.listdir(self.base_dir))
        except OSError:
            names = []
        for name in names:
            p = os.path.join(self.base_dir, name)
            if os.path.isdir(p):
                arts.append({"name": name, "path": p,
                             "bytes": tree_bytes(p)})
        return {"dir": self.base_dir, "artifacts": arts,
                "max_captures": self.max_captures}

    def _prune(self) -> None:
        try:
            names = sorted(n for n in os.listdir(self.base_dir)
                           if os.path.isdir(os.path.join(self.base_dir, n)))
        except OSError:
            return
        for name in names[:-self.max_captures]:
            shutil.rmtree(os.path.join(self.base_dir, name),
                          ignore_errors=True)
