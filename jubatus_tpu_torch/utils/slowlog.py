"""Tail-based slow-request capture (copy of ``jubatus_tpu/utils/slowlog.py``).

A bounded ring of structured records for requests that landed at or
above a configurable quantile of their OWN span histogram (default
p99): method, duration, trace_id, peer, deadline-remaining, and the
threshold that tripped. Tail-based means the log captures exactly the
requests an operator would go hunting for after a latency page — the
ones past the knee of the distribution — with no sampling decision made
before the duration is known.

The quantile threshold is computed against the span's log-bucketed
histogram (utils/tracing.py) and CACHED on the histogram, refreshed
every 64 records, so the record hot path pays one float compare, not a
109-bucket walk. No capture happens until a span has ``min_count``
samples — early in a process's life every request is "p99".

Owned by each tracing ``Registry`` (one per server); configured by
``--slowlog-capacity`` / ``--slowlog-quantile`` / ``--slowlog-min-count``;
queried by the ``get_slow_log`` RPC, ``jubadump --slow-log``, and the
``/slowlog`` endpoint of utils/metrics_http.py. Each captured record also
stamps a Prometheus exemplar (trace_id) onto the histogram bucket it
landed in. ``set_trigger`` arms the tail trigger: K captures of one span
inside a window call the profiler's snapshot once (utils/profiler.py).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

log = logging.getLogger(__name__)

#: ring size; 0 disables capture entirely (record() never consults us)
DEFAULT_CAPACITY = 256
#: a request at/above this quantile of its own span histogram is slow
DEFAULT_QUANTILE = 0.99
#: no thresholding until a span has this many samples
DEFAULT_MIN_COUNT = 64
#: tail-trigger defaults: K breaches of the SAME span inside
#: the window fire the breach callback (a profiler snapshot) ONCE
DEFAULT_TRIGGER_BREACHES = 3
DEFAULT_TRIGGER_WINDOW_S = 10.0
#: trace ids carried per breach window (enough to pivot into jubactl
#: -c trace; unbounded capture would let a storm grow the window rec)
_TRIGGER_MAX_IDS = 8


class SlowLog:
    """Bounded ring of slow-request records for one Registry."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 quantile: float = DEFAULT_QUANTILE,
                 min_count: int = DEFAULT_MIN_COUNT) -> None:
        self._lock = threading.Lock()
        self.capacity = int(capacity)
        self.quantile = float(quantile)
        self.min_count = int(min_count)
        self._ring: deque = deque(maxlen=max(self.capacity, 1))
        self._captured = 0
        #: tail-triggered profiling: ``on_breach(span,
        #: trace_ids)`` fires when ``trigger_breaches`` captures of the
        #: SAME span land inside ``trigger_window_s`` — exactly once per
        #: window (the flag clears when the window expires)
        self.on_breach: Optional[Callable[[str, List[str]], Any]] = None
        self.trigger_breaches = 0          # 0 = trigger disabled
        self.trigger_window_s = DEFAULT_TRIGGER_WINDOW_S
        self._windows: Dict[str, Dict[str, Any]] = {}
        self._trigger_fired = 0

    def configure(self, capacity: Optional[int] = None,
                  quantile: Optional[float] = None,
                  min_count: Optional[int] = None) -> None:
        """Re-tune at server start (flags); keeps already-captured
        records up to the new capacity."""
        with self._lock:
            if capacity is not None:
                self.capacity = int(capacity)
                self._ring = deque(self._ring,
                                   maxlen=max(self.capacity, 1))
            if quantile is not None:
                if not 0.0 < quantile <= 1.0:
                    raise ValueError(f"slowlog quantile {quantile} not in "
                                     "(0, 1]")
                self.quantile = float(quantile)
            if min_count is not None:
                self.min_count = max(1, int(min_count))

    def set_trigger(self, fn: Optional[Callable[[str, List[str]], Any]],
                    breaches: int = DEFAULT_TRIGGER_BREACHES,
                    window_s: float = DEFAULT_TRIGGER_WINDOW_S) -> None:
        """Arm (or disarm with fn=None / breaches=0) the tail trigger:
        K same-span captures inside the window call ``fn(span,
        trace_ids)`` once. The callback runs on the capturing request's
        thread OUTSIDE the ring lock and must be cheap (the profiler's
        snapshot fold is)."""
        with self._lock:
            self.on_breach = fn
            self.trigger_breaches = max(0, int(breaches))
            self.trigger_window_s = float(window_s)
            self._windows.clear()

    def add(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            self._captured += 1
            self._ring.append(rec)
        self._note_breach(str(rec.get("method", "")),
                          str(rec.get("trace_id", "")))

    def _note_breach(self, span: str, trace_id: str,
                     now: Optional[float] = None) -> bool:
        """Advance one span's breach window; fires the trigger exactly
        once per window when it reaches ``trigger_breaches`` captures.
        ``now`` is injectable for tests (monotonic domain). Returns
        True when the callback fired."""
        fire: Optional[Callable[[str, List[str]], Any]] = None
        ids: List[str] = []
        with self._lock:
            if self.trigger_breaches <= 0 or self.on_breach is None \
                    or not span:
                return False
            t = time.monotonic() if now is None else float(now)
            w = self._windows.get(span)
            if w is None or t - w["start"] > self.trigger_window_s:
                w = self._windows[span] = {"start": t, "count": 0,
                                           "ids": [], "fired": False}
            w["count"] += 1
            if trace_id and len(w["ids"]) < _TRIGGER_MAX_IDS:
                w["ids"].append(trace_id)
            if not w["fired"] and w["count"] >= self.trigger_breaches:
                w["fired"] = True
                self._trigger_fired += 1
                fire, ids = self.on_breach, list(w["ids"])
        if fire is None:
            return False
        try:
            fire(span, ids)
        except Exception:  # noqa: BLE001 — a trigger must never break capture
            log.debug("slowlog breach trigger failed", exc_info=True)
        return True

    def snapshot(self, last: int = 0) -> List[Dict[str, Any]]:
        """Oldest-first copy (the newest ``last`` when > 0)."""
        with self._lock:
            out = list(self._ring)
        return out[-last:] if last > 0 else out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"captured": self._captured,
                    "retained": len(self._ring),
                    "capacity": self.capacity,
                    "quantile": self.quantile,
                    "min_count": self.min_count,
                    "trigger_breaches": self.trigger_breaches,
                    "trigger_window_s": self.trigger_window_s,
                    "trigger_fired": self._trigger_fired}

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._captured = 0
            self._windows.clear()
            self._trigger_fired = 0
