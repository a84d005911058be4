"""Tracing & metrics plane (copy of ``jubatus_tpu/utils/tracing.py``).

Four layers:

- **Span histograms** (always on): every RPC dispatch and every mix
  round records into a fixed-size log-bucketed histogram (quarter-octave
  buckets, ~19% relative quantile error) per span name, so
  ``trace_status()`` reports p50/p90/p99/max. Monotonic **counters** and
  point-in-time **gauges** ride the same registry. Histograms expose a
  mergeable ``snapshot()`` (``merge_snapshots`` folds members' buckets
  into one cluster-wide quantile view) and a Prometheus text exposition
  (``prometheus_text``) served by utils/metrics_http.py. The bucket
  geometry, the metric names and the label set are the JAX package's,
  so one scraper reads JAX and port members alike.
- **Trace context** (request-scoped): a thread-local (trace_id, span_id)
  pair propagated through the RPC envelope (rpc/client.py attaches it,
  rpc/server.py adopts it), so a proxied call keeps one trace id on every
  hop, JAX and port hops alike.
- **Span store**: every registry keeps a bounded ring of span records
  indexed by trace_id (parent/child edges from the envelope's ``{"t",
  "s"}`` element), served over the ``get_spans`` RPC. Tail-based
  slow-request capture rides the same record path: a span at/above a
  configurable quantile of its own histogram lands in the slow-log ring
  (utils/slowlog.py) and stamps a Prometheus exemplar on its bucket.
  ``set_forensics(False)`` turns both off; the histograms stay on.
- **Device traces** (opt-in): ``device_trace()`` wraps a
  ``torch.profiler`` capture (CPU ops, and the card's kernels once CUDA is
  in use) when ``JUBATUS_TPU_TRACE_DIR`` is set (or a directory is
  passed), writing a Chrome trace there. A no-op otherwise.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from jubatus_tpu_torch.utils.events import EventJournal
from jubatus_tpu_torch.utils.slowlog import SlowLog

# -- histogram geometry -------------------------------------------------------
# Quarter-octave log buckets from 2^-20 s (~1 us) to 2^7 s (128 s) plus an
# overflow bucket: 109 fixed slots, bucket index is one log2 + one
# multiply — cheap enough for the RPC dispatch hot path.
_LOG2_MIN = -20
_SUB = 4                       # buckets per octave (2^(1/4) ~ 1.19x width)
_OCTAVES = 27
_OVERFLOW = _OCTAVES * _SUB    # index of the overflow bucket
_NBUCKETS = _OVERFLOW + 1
_MIN_S = 2.0 ** _LOG2_MIN
#: upper bound (seconds) of each finite bucket
_BOUNDS = [2.0 ** (_LOG2_MIN + (i + 1) / _SUB) for i in range(_OVERFLOW)]
#: geometric-midpoint factor: bucket value = upper_bound * 2^(-1/(2*SUB))
_MID = 2.0 ** (-0.5 / _SUB)


def bucket_index(seconds: float) -> int:
    """Histogram slot for a duration (clamped to [0, overflow])."""
    if seconds <= _MIN_S:
        return 0
    i = int((math.log2(seconds) - _LOG2_MIN) * _SUB)
    return i if i < _OVERFLOW else _OVERFLOW


class Histogram:
    """One span name's fixed-size log-bucketed latency histogram.

    Not internally locked — the owning Registry serializes access (one
    registry lock per record beats per-histogram locks at our fan-in).
    """

    __slots__ = ("counts", "count", "total_s", "max_s", "last_s",
                 "last_trace_id", "exemplars", "slow_threshold_s")

    def __init__(self) -> None:
        self.counts = [0] * _NBUCKETS
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self.last_s = 0.0
        self.last_trace_id = ""
        #: bucket index -> (trace_id, seconds, unix_ts) of the most recent
        #: SLOW request that landed there (Prometheus exemplars: the
        #: p99-spike bucket links straight to a trace)
        self.exemplars: Dict[int, Tuple[str, float, float]] = {}
        #: cached slow-log quantile threshold (refreshed every 64 records
        #: so the hot path pays one compare, not a bucket walk)
        self.slow_threshold_s: Optional[float] = None

    def record(self, seconds: float) -> None:
        self.counts[bucket_index(seconds)] += 1
        self.count += 1
        self.total_s += seconds
        self.last_s = seconds
        if seconds > self.max_s:
            self.max_s = seconds

    def quantile(self, q: float) -> Optional[float]:
        """q-quantile in seconds (geometric bucket midpoint, clamped to
        the observed max); None when empty."""
        if self.count == 0:
            return None
        target = max(1, math.ceil(q * self.count))
        cum = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            cum += c
            if cum >= target:
                if i >= _OVERFLOW:
                    return self.max_s
                return min(_BOUNDS[i] * _MID, self.max_s)
        return self.max_s

    def state(self) -> Dict[str, Any]:
        """Wire/JSON-safe mergeable state (sparse buckets)."""
        return {
            "buckets": {i: c for i, c in enumerate(self.counts) if c},
            "count": self.count,
            "total_s": self.total_s,
            "max_s": self.max_s,
            "last_s": self.last_s,
            "last_trace_id": self.last_trace_id,
        }


def merge_hist_states(states: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold histogram ``state()`` dicts from N nodes into one (bucket-wise
    sum — quantiles of the merge are exact at bucket resolution). Bucket
    keys may arrive as strings (JSON round trips)."""
    out: Dict[str, Any] = {"buckets": {}, "count": 0, "total_s": 0.0,
                           "max_s": 0.0, "last_s": 0.0, "last_trace_id": ""}
    for st in states:
        for k, c in (st.get("buckets") or {}).items():
            i = int(k)
            out["buckets"][i] = out["buckets"].get(i, 0) + int(c)
        out["count"] += int(st.get("count", 0))
        out["total_s"] += float(st.get("total_s", 0.0))
        out["max_s"] = max(out["max_s"], float(st.get("max_s", 0.0)))
        out["last_s"] = float(st.get("last_s", out["last_s"]))
        out["last_trace_id"] = st.get("last_trace_id") or out["last_trace_id"]
    return out


def state_quantile(state: Dict[str, Any], q: float) -> Optional[float]:
    """Quantile (seconds) from a histogram ``state()``/merged state."""
    count = int(state.get("count", 0))
    if count == 0:
        return None
    target = max(1, math.ceil(q * count))
    cum = 0
    max_s = float(state.get("max_s", 0.0))
    buckets = {int(k): int(v)
               for k, v in (state.get("buckets") or {}).items()}
    for i in sorted(buckets):
        cum += buckets[i]
        if cum >= target:
            if i >= _OVERFLOW:
                return max_s
            return min(_BOUNDS[i] * _MID, max_s)
    return max_s


def merge_snapshots(snaps: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold N registry ``snapshot()`` dicts into one cluster-wide view."""
    hist_states: Dict[str, List[Dict[str, Any]]] = {}
    counters: Dict[str, int] = {}
    for snap in snaps:
        for name, st in (snap.get("hists") or {}).items():
            hist_states.setdefault(str(name), []).append(st)
        for name, v in (snap.get("counters") or {}).items():
            counters[str(name)] = counters.get(str(name), 0) + int(v)
    return {"hists": {n: merge_hist_states(sts)
                      for n, sts in hist_states.items()},
            "counters": counters}


# -- trace context ------------------------------------------------------------

class TraceContext:
    """One hop's identity inside a distributed trace. ``peer`` is the
    remote address the request arrived from (best-effort: the Python
    transport stamps it per connection; the C++ transport does not
    surface it) — it rides into slow-log records, not the wire."""

    __slots__ = ("trace_id", "span_id", "parent_id", "peer")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: str = "", peer: str = "") -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.peer = peer


_tls = threading.local()
_id_seq = itertools.count(1)
_PROC = os.urandom(4).hex()


def _new_id() -> str:
    # process-unique prefix + atomic counter: ~200 ns, no urandom per call
    return f"{_PROC}{next(_id_seq) & 0xFFFFFFFF:08x}"


def current_trace() -> Optional[TraceContext]:
    return getattr(_tls, "ctx", None)


def swap_trace(ctx: Optional[TraceContext]) -> Optional[TraceContext]:
    """Install ``ctx`` as this thread's trace context; returns the
    previous one (restore it in a finally — dispatch pool threads are
    reused, a leaked context would mislabel the next request)."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    return prev


@contextlib.contextmanager
def use_trace(ctx: Optional[TraceContext]) -> Iterator[None]:
    prev = swap_trace(ctx)
    try:
        yield
    finally:
        swap_trace(prev)


def from_wire(wire: Any) -> TraceContext:
    """Adopt a wire trace element ({"t": trace_id, "s": caller span}) as a
    child context, or start a fresh root when the caller sent none."""
    if isinstance(wire, dict):
        tid = wire.get("t")
        if isinstance(tid, bytes):
            tid = tid.decode("utf-8", "replace")
        parent = wire.get("s", "")
        if isinstance(parent, bytes):
            parent = parent.decode("utf-8", "replace")
        if tid:
            return TraceContext(str(tid), _new_id(), str(parent))
    return TraceContext(_new_id(), _new_id(), "")


def to_wire(ctx: TraceContext) -> Dict[str, str]:
    return {"t": ctx.trace_id, "s": ctx.span_id}


def child_of(ctx: TraceContext) -> TraceContext:
    """A fresh child span of ``ctx`` (same trace, new span id): the
    identity an outbound client call records under, so the receiving
    hop's parent edge points at the CALL, not the whole dispatch."""
    return TraceContext(ctx.trace_id, _new_id(), ctx.span_id)


def new_root() -> TraceContext:
    """A fresh root context (e.g. a mix round starting its own trace)."""
    return TraceContext(_new_id(), _new_id(), "")


# -- the registry -------------------------------------------------------------

#: span records kept per registry, ring-evicted oldest-first and INDEXED
#: by trace_id so get_spans(trace_id) is an O(spans-in-trace) lookup
_SPAN_RING = 512


class _SpanHandle:
    """Yielded by ``Registry.span``: ``seconds`` is the measured duration
    (set at scope exit); ``cancel()`` drops the record (a request that
    falls back to another path is counted once, there)."""

    __slots__ = ("cancelled", "seconds")

    def __init__(self) -> None:
        self.cancelled = False
        self.seconds = 0.0

    def cancel(self) -> None:
        self.cancelled = True


class Registry:
    """One node's metrics: span histograms + counters + gauges + the
    trace-indexed span store + the slow-request log.

    Each server owns its own so multi-server processes (tests, embedded
    clusters) attribute spans per node; the module-level functions use a
    process default.
    """

    def __init__(self, span_capacity: int = _SPAN_RING) -> None:
        self._lock = threading.Lock()
        self._hists: Dict[str, Histogram] = {}
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._span_cap = span_capacity
        self._spans: deque = deque()
        self._by_trace: Dict[str, List[Dict[str, Any]]] = {}
        #: tail-based slow-request ring (utils/slowlog.py); servers tune
        #: it from --slowlog-* flags via slowlog.configure()
        self.slowlog = SlowLog()
        #: cluster event journal (utils/events.py): typed, HLC-stamped
        #: state-transition events; counts event.emitted/event.dropped
        #: into this registry
        self.events = EventJournal(counter=self.count)
        #: span store + slow log master switch (histograms stay on)
        self._forensics = True
        #: usage-ledger tap (utils/usage.py): every recorded span duration
        #: is offered to the ledger, which bills it to the dispatch
        #: thread's principal; called outside the registry lock
        self.usage_sink: Optional[Callable[[str, float], None]] = None

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[_SpanHandle]:
        t0 = time.perf_counter()
        h = _SpanHandle()
        try:
            yield h
        finally:
            h.seconds = time.perf_counter() - t0
            if not h.cancelled:
                self.record(name, h.seconds)

    def set_forensics(self, enabled: bool) -> None:
        """Toggle the span store + slow log (histograms/counters stay on)."""
        self._forensics = bool(enabled)

    def record(self, name: str, seconds: float) -> None:
        ctx = getattr(_tls, "ctx", None)
        slow_thr: Optional[float] = None
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.record(seconds)
            forensics = self._forensics
            if forensics:
                sl = self.slowlog
                if sl.capacity > 0 and h.count >= sl.min_count:
                    # cached threshold: a 109-bucket quantile walk per
                    # record would tax the dispatch hot path; refresh
                    # every 64 samples tracks the distribution closely
                    # enough for tail capture
                    thr = h.slow_threshold_s
                    if thr is None or (h.count & 63) == 0:
                        thr = h.slow_threshold_s = h.quantile(sl.quantile)
                    if thr is not None and seconds >= thr:
                        slow_thr = thr
                        h.exemplars[bucket_index(seconds)] = (
                            ctx.trace_id if ctx is not None else "",
                            seconds, time.time())
            if ctx is not None:
                h.last_trace_id = ctx.trace_id
                if forensics:
                    if len(self._spans) >= self._span_cap:
                        old = self._spans.popleft()
                        lst = self._by_trace.get(old["trace_id"])
                        if lst:
                            if lst[0] is old:
                                lst.pop(0)
                            else:  # defensive; eviction is FIFO per trace
                                try:
                                    lst.remove(old)
                                except ValueError:
                                    pass
                            if not lst:
                                del self._by_trace[old["trace_id"]]
                    rec = {
                        "trace_id": ctx.trace_id, "span_id": ctx.span_id,
                        "parent_id": ctx.parent_id, "name": name,
                        "duration_ms": round(seconds * 1e3, 3),
                        "ts": time.time() - seconds}
                    self._spans.append(rec)
                    self._by_trace.setdefault(ctx.trace_id, []).append(rec)
        if slow_thr is not None:
            self._capture_slow(name, seconds, slow_thr, ctx)
        sink = self.usage_sink
        if sink is not None:
            sink(name, seconds)

    def _capture_slow(self, name: str, seconds: float, threshold: float,
                      ctx: Optional[TraceContext]) -> None:
        """Build + ring one slow-request record (outside the registry
        lock — the slow path may consult the deadline plane)."""
        rec: Dict[str, Any] = {
            "method": name,
            "duration_ms": round(seconds * 1e3, 3),
            "threshold_ms": round(threshold * 1e3, 3),
            "trace_id": ctx.trace_id if ctx is not None else "",
            "span_id": ctx.span_id if ctx is not None else "",
            "peer": ctx.peer if ctx is not None else "",
            "ts": round(time.time() - seconds, 3),
        }
        rem = _deadline_remaining()
        if rem is not None:
            rec["deadline_remaining_ms"] = round(rem * 1e3, 3)
        self.slowlog.add(rec)

    def count(self, name: str, n: int = 1) -> None:
        """Bump a monotonic counter (rpc errors, mix failures, bytes, ...)."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def gauge(self, name: str, value: float) -> None:
        """Set a point-in-time gauge (runtime telemetry: RSS, FDs, device
        memory, kernel builds, ...) — exported on /metrics, not merged."""
        with self._lock:
            self._gauges[name] = float(value)

    def gauges(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    def recent_spans(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._spans)

    def get_spans(self, trace_id: str) -> List[Dict[str, Any]]:
        """All retained span records of one trace, oldest-first — the
        per-node half of the cross-node trace assembly (the ``get_spans``
        RPC)."""
        with self._lock:
            return [dict(r) for r in self._by_trace.get(str(trace_id), [])]

    def trace_status(self, prefix: str = "trace") -> Dict[str, Any]:
        """Flattened metrics for get_status maps: trace.<name>.{count,
        mean_ms, p50_ms, p90_ms, p99_ms, max_ms, last_ms[, last_trace_id]}
        plus trace.counter.<name> for the monotonic counters."""
        out: Dict[str, Any] = {}
        with self._lock:
            for name, h in self._hists.items():
                n = h.count or 1
                out[f"{prefix}.{name}.count"] = h.count
                out[f"{prefix}.{name}.mean_ms"] = round(h.total_s / n * 1e3, 3)
                for qname, q in (("p50", 0.50), ("p90", 0.90), ("p99", 0.99)):
                    v = h.quantile(q)
                    out[f"{prefix}.{name}.{qname}_ms"] = \
                        round((v or 0.0) * 1e3, 3)
                out[f"{prefix}.{name}.max_ms"] = round(h.max_s * 1e3, 3)
                out[f"{prefix}.{name}.last_ms"] = round(h.last_s * 1e3, 3)
                if h.last_trace_id:
                    out[f"{prefix}.{name}.last_trace_id"] = h.last_trace_id
            for name, v in self._counters.items():
                out[f"{prefix}.counter.{name}"] = v
        return out

    def snapshot(self) -> Dict[str, Any]:
        """Mergeable raw state for get_metrics.
        ``gauges`` ride along for single-node views; merge_snapshots
        ignores them (point-in-time per-process values don't sum)."""
        with self._lock:
            return {"hists": {n: h.state() for n, h in self._hists.items()},
                    "counters": dict(self._counters),
                    "gauges": dict(self._gauges)}

    def prometheus_text(self,
                        labels: Optional[Dict[str, str]] = None) -> str:
        """Prometheus text exposition (format 0.0.4) of every histogram,
        counter, and gauge. Bucket lines are emitted only at occupied
        bucket boundaries (+Inf always) — valid cumulative histograms,
        compact wire. Buckets holding a slow-request capture carry an
        OpenMetrics-style exemplar (``# {trace_id="..."} value ts``) so
        a p99 spike on a dashboard links straight to a trace; scrapers
        that only speak 0.0.4 ignore text after ``#``."""
        base = "".join(f',{k}="{_esc(v)}"'
                       for k, v in sorted((labels or {}).items()))
        lines = [
            "# TYPE jubatus_span_duration_seconds histogram",
            "# HELP jubatus_span_duration_seconds "
            "Span latency by name (log-bucketed).",
        ]
        with self._lock:
            hists = [(n, h.counts[:], h.count, h.total_s, h.max_s,
                      dict(h.exemplars))
                     for n, h in sorted(self._hists.items())]
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
        for name, counts, count, total_s, max_s, exemplars in hists:
            sel = f'span="{_esc(name)}"{base}'
            cum = 0
            for i, c in enumerate(counts):
                if not c or i >= _OVERFLOW:
                    continue
                cum += c
                line = (f"jubatus_span_duration_seconds_bucket{{{sel},"
                        f'le="{_BOUNDS[i]:.9g}"}} {cum}')
                ex = exemplars.get(i)
                if ex is not None and ex[0]:
                    line += (f' # {{trace_id="{_esc(ex[0])}"}} '
                             f"{ex[1]:.9g} {ex[2]:.3f}")
                lines.append(line)
            lines.append(
                f'jubatus_span_duration_seconds_bucket{{{sel},le="+Inf"}} '
                f"{count}")
            lines.append(
                f"jubatus_span_duration_seconds_sum{{{sel}}} {total_s:.9g}")
            lines.append(
                f"jubatus_span_duration_seconds_count{{{sel}}} {count}")
        lines.append("# TYPE jubatus_span_max_seconds gauge")
        for name, _counts, _count, _total, max_s, _ex in hists:
            lines.append(
                f'jubatus_span_max_seconds{{span="{_esc(name)}"{base}}} '
                f"{max_s:.9g}")
        lines.append("# TYPE jubatus_events_total counter")
        for name, v in counters:
            lines.append(
                f'jubatus_events_total{{event="{_esc(name)}"{base}}} {v}')
        if gauges:
            lines.append("# TYPE jubatus_runtime_gauge gauge")
            lines.append("# HELP jubatus_runtime_gauge "
                         "Process runtime telemetry (sampler).")
            for name, v in gauges:
                lines.append(
                    f'jubatus_runtime_gauge{{key="{_esc(name)}"{base}}} '
                    f"{v:.9g}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._hists.clear()
            self._counters.clear()
            self._gauges.clear()
            self._spans.clear()
            self._by_trace.clear()
        self.slowlog.clear()
        self.events.clear()


def _esc(v: Any) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace(
        "\n", r"\n")


_deadline_mod = None


def _deadline_remaining() -> Optional[float]:
    """Remaining deadline budget for slow-log records. Lazy module cache:
    utils must not import the rpc package at import time (rpc imports
    tracing), and the lookup only runs on the slow-capture cold path."""
    global _deadline_mod
    if _deadline_mod is None:
        from jubatus_tpu_torch.rpc import deadline as _d

        _deadline_mod = _d
    return _deadline_mod.remaining()


_default = Registry()


def default_registry() -> Registry:
    return _default


def span(name: str):
    return _default.span(name)


def record(name: str, seconds: float) -> None:
    _default.record(name, seconds)


def count(name: str, n: int = 1) -> None:
    _default.count(name, n)


def trace_status(prefix: str = "trace") -> Dict[str, Any]:
    return _default.trace_status(prefix)


def reset() -> None:
    _default.reset()


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str] = None) -> Iterator[None]:
    """torch.profiler capture around a block, written as a Chrome trace
    (``trace.json``) into the directory: CPU ops, and the card's kernels
    when CUDA is already in use (the capture never initializes it).
    No-op unless a directory is given or JUBATUS_TPU_TRACE_DIR is set."""
    trace_dir = trace_dir or os.environ.get("JUBATUS_TPU_TRACE_DIR", "")
    if not trace_dir:
        yield
        return
    import torch

    from jubatus_tpu_torch.utils.profiler import kineto_profile

    os.makedirs(trace_dir, exist_ok=True)
    with kineto_profile(torch.cuda.is_initialized()) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
