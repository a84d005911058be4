"""Metric time-series: a bounded ring of periodic registry snapshots
(copy of ``jubatus_tpu/utils/timeseries.py``).

Every metric the cluster exports today is an instantaneous
snapshot — counters only ever go up, quantiles cover process lifetime,
and "is the error rate rising?" has no answer without scraping twice
and doing the subtraction by hand. This module does that subtraction as
a first-class facility:

- **TimeSeriesRing** — one per process, holding up to ``capacity``
  points sampled from the owning tracing ``Registry`` (the existing
  runtime-telemetry thread is the sampler; see server/base.py). Each
  point is the registry's mergeable ``snapshot()`` (sparse histogram
  buckets + counters + gauges) plus a wall-clock timestamp, so the ring
  costs a few KB per point and survives msgpack verbatim — the
  ``get_timeseries`` RPC ships points as-is and proxies broadcast+fold.
- **Window** — the delta between the newest point and the newest point
  at/older than the window start. Because histogram buckets are
  monotonic per span, a bucket-wise subtraction IS the histogram of the
  requests that arrived inside the window — windowed p50/p99 are exact
  at bucket resolution, windowed counter rates are exact, and the SLO
  engine's "fraction of requests above X ms over the last N seconds"
  (utils/slo.py) falls straight out of the cumulative-bucket diff.

A registry ``reset()`` (bench warmup hygiene) makes counters go
backwards; deltas clamp at 0 so a reset costs one window of data, not a
crash or a negative rate.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from jubatus_tpu_torch.utils import tracing

#: default ring capacity: one hour of history at the default 10 s
#: telemetry interval
DEFAULT_CAPACITY = 360


def _counters_of(point: Dict[str, Any]) -> Dict[str, int]:
    return point.get("counters") or {}


def _hists_of(point: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    return point.get("hists") or {}


def hist_state_delta(new: Dict[str, Any],
                     old: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """The histogram of events recorded between two snapshots of one
    span: bucket-wise (clamped) subtraction of the cumulative states.
    ``max_s`` keeps the newer side's value — an upper bound for the
    window (the true window max is not recoverable from cumulative
    buckets), which quantile clamping tolerates."""
    if old is None:
        old = {}
    old_buckets = {int(k): int(v)
                   for k, v in (old.get("buckets") or {}).items()}
    buckets: Dict[int, int] = {}
    for k, v in (new.get("buckets") or {}).items():
        i = int(k)
        d = int(v) - old_buckets.get(i, 0)
        if d > 0:
            buckets[i] = d
    return {
        "buckets": buckets,
        "count": max(0, int(new.get("count", 0)) - int(old.get("count", 0))),
        "total_s": max(0.0, float(new.get("total_s", 0.0))
                       - float(old.get("total_s", 0.0))),
        "max_s": float(new.get("max_s", 0.0)),
        "last_s": float(new.get("last_s", 0.0)),
        "last_trace_id": new.get("last_trace_id", ""),
    }


class Window:
    """One evaluated window over a ring: newest point vs the baseline
    point at/just-past ``seconds`` ago. All rates are per second over
    the ACTUAL covered span (``covered_s``), not the nominal window —
    a freshly-booted process reports honest rates immediately."""

    def __init__(self, newest: Dict[str, Any],
                 baseline: Optional[Dict[str, Any]]) -> None:
        self.newest = newest
        self.baseline = baseline or {"ts": newest.get("ts", 0.0)}
        self.covered_s = max(
            0.0, float(newest.get("ts", 0.0))
            - float(self.baseline.get("ts", 0.0)))

    def counter_delta(self, name: str) -> int:
        new = _counters_of(self.newest).get(name, 0)
        old = _counters_of(self.baseline).get(name, 0)
        return max(0, int(new) - int(old))

    def counter_rate(self, name: str) -> float:
        if self.covered_s <= 0:
            return 0.0
        return self.counter_delta(name) / self.covered_s

    def hist_delta(self, span: str) -> Optional[Dict[str, Any]]:
        """Histogram state of the requests inside the window; None when
        the span never appeared."""
        new = _hists_of(self.newest).get(span)
        if new is None:
            return None
        return hist_state_delta(new, _hists_of(self.baseline).get(span))

    def span_count(self, span: str) -> int:
        d = self.hist_delta(span)
        return int(d["count"]) if d else 0

    def span_rate(self, span: str) -> float:
        if self.covered_s <= 0:
            return 0.0
        return self.span_count(span) / self.covered_s

    def quantile_ms(self, span: str, q: float) -> Optional[float]:
        """Windowed quantile (ms) of one span, exact at bucket
        resolution — the p99-over-the-last-minute the lifetime
        histograms cannot answer."""
        d = self.hist_delta(span)
        if not d or not d["count"]:
            return None
        v = tracing.state_quantile(d, q)
        return None if v is None else v * 1e3

    def bad_fraction(self, span: str, threshold_s: float) -> Optional[float]:
        """Fraction of the window's requests that took >= threshold
        (bucket-resolution: a request counts as bad when its whole
        bucket lies at/above the threshold's bucket). None when the
        span saw no traffic in the window."""
        d = self.hist_delta(span)
        if not d or not d["count"]:
            return None
        thr_idx = tracing.bucket_index(threshold_s)
        bad = sum(c for i, c in d["buckets"].items() if int(i) >= thr_idx)
        return bad / d["count"]

    def spans(self, prefix: str = "") -> List[str]:
        return sorted(n for n in _hists_of(self.newest)
                      if n.startswith(prefix))

    def counter_names(self, prefix: str = "") -> List[str]:
        return sorted(n for n in _counters_of(self.newest)
                      if n.startswith(prefix))

    def gauge_mean(self, name: str) -> Optional[float]:
        """Mean of a gauge across the window's two endpoints (gauges are
        point-in-time; the ring doesn't integrate between samples)."""
        vals = [p.get("gauges", {}).get(name)
                for p in (self.baseline, self.newest)]
        vals = [float(v) for v in vals if v is not None]
        if not vals:
            return None
        return sum(vals) / len(vals)


def window_from_points(points: List[Dict[str, Any]], seconds: float,
                       now: Optional[float] = None) -> Optional[Window]:
    """A :class:`Window` over a raw oldest-first point list — what
    ``jubactl -c watch`` does with each node's ``get_timeseries`` reply
    (the ring itself stays on the server). None below two points."""
    if len(points) < 2:
        return None
    newest = points[-1]
    start = (float(newest["ts"]) if now is None else float(now)) \
        - float(seconds)
    baseline = points[0]
    for p in points[:-1]:
        if float(p["ts"]) <= start:
            baseline = p
        else:
            break
    return Window(newest, baseline)


class TimeSeriesRing:
    """Bounded per-process ring of timestamped registry snapshots."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 min_spacing_s: float = 0.0) -> None:
        self._lock = threading.Lock()
        self.capacity = max(2, int(capacity))
        #: samples closer than this to the previous one are dropped
        #: (the on-demand telemetry refresh under scrape load must not
        #: flood the ring with near-duplicate points)
        self.min_spacing_s = float(min_spacing_s)
        self._ring: deque = deque(maxlen=self.capacity)
        self._sampled = 0

    def sample(self, snapshot: Dict[str, Any], ts: Optional[float] = None,
               force: bool = False) -> bool:
        """Append one registry snapshot; returns False when dropped by
        the spacing guard. ``ts`` defaults to now (wall-clock: points
        must be comparable across nodes in jubactl views)."""
        ts = time.time() if ts is None else float(ts)
        point = {"ts": ts,
                 "hists": snapshot.get("hists") or {},
                 "counters": snapshot.get("counters") or {},
                 "gauges": snapshot.get("gauges") or {}}
        with self._lock:
            if not force and self._ring and self.min_spacing_s > 0 and \
                    ts - float(self._ring[-1]["ts"]) < self.min_spacing_s:
                return False
            self._ring.append(point)
            self._sampled += 1
        return True

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def points(self, last: int = 0) -> List[Dict[str, Any]]:
        """Oldest-first copy of the ring (the newest ``last`` when > 0)."""
        with self._lock:
            out = list(self._ring)
        return out[-last:] if last > 0 else out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {"sampled": self._sampled, "retained": len(self._ring),
                   "capacity": self.capacity}
            if self._ring:
                out["oldest_ts"] = self._ring[0]["ts"]
                out["newest_ts"] = self._ring[-1]["ts"]
        return out

    def window(self, seconds: float,
               now: Optional[float] = None) -> Optional[Window]:
        """The window ending at the newest point and starting
        ``seconds`` earlier. Baseline = the newest point at/older than
        the start (so the window COVERS at least ``seconds`` when the
        ring is deep enough, the whole ring otherwise). None when the
        ring holds fewer than two points."""
        with self._lock:
            pts = list(self._ring)
        return window_from_points(pts, seconds, now=now)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._sampled = 0
