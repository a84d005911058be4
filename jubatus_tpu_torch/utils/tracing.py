"""Metrics registry and trace context (copy of the ``Registry`` and the
trace context of ``jubatus_tpu/utils/tracing.py``, trimmed to what the
mixer, its flight recorder and the RPC plane write).

One registry per server: span histograms (quarter-octave log buckets,
~19% relative quantile error), monotonic counters, point-in-time gauges,
and the server's event journal (utils/events.py). ``trace_status()``
flattens them into ``get_status`` keys (``trace.<span>.p50_ms`` …,
``trace.counter.<name>``), as in the JAX package. Not carried over: the
span store, the slow-request log, the Prometheus exposition and device
traces (the port's tracing plane is still to come).

The trace context is one hop's identity inside a distributed trace: the
RPC server adopts the caller's (the envelope's 5th element) or roots a
fresh one for the length of a dispatch, and a client call under it ships
a child span id, so a proxied call keeps one trace id on every hop, JAX
and port hops alike.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import os
import threading
import time
from typing import Any, Dict, Iterator, Optional

from jubatus_tpu_torch.utils.events import EventJournal

# -- histogram geometry -------------------------------------------------------
# Quarter-octave log buckets from 2^-20 s (~1 us) to 2^7 s (128 s) plus an
# overflow bucket: 109 fixed slots.
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
    """One span name's fixed-size log-bucketed latency histogram. Not
    internally locked — the owning Registry serializes access."""

    __slots__ = ("counts", "count", "total_s", "max_s", "last_s")

    def __init__(self) -> None:
        self.counts = [0] * _NBUCKETS
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self.last_s = 0.0

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
        }


class _SpanHandle:
    """Yielded by ``Registry.span``: ``seconds`` is the measured duration
    (set at scope exit); ``cancel()`` drops the record (a request that
    falls back to another path is counted once, there)."""

    __slots__ = ("seconds", "cancelled")

    def __init__(self) -> None:
        self.seconds = 0.0
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class Registry:
    """One node's metrics: span histograms + counters + gauges + the
    event journal. Each server owns its own, so a process holding several
    servers (tests, embedded clusters) attributes spans per node."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hists: Dict[str, Histogram] = {}
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        #: cluster event journal (utils/events.py): counts
        #: event.emitted/event.dropped into this registry
        self.events = EventJournal(counter=self.count)

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

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.record(seconds)

    def count(self, name: str, n: int = 1) -> None:
        """Bump a monotonic counter (mix failures, bytes shipped, ...)."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def gauge(self, name: str, value: float) -> None:
        """Set a point-in-time gauge."""
        with self._lock:
            self._gauges[name] = float(value)

    def gauges(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    def trace_status(self, prefix: str = "trace") -> Dict[str, Any]:
        """Flattened metrics for get_status maps: trace.<name>.{count,
        mean_ms, p50_ms, p90_ms, p99_ms, max_ms, last_ms} plus
        trace.counter.<name> for the monotonic counters."""
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
            for name, v in self._counters.items():
                out[f"{prefix}.counter.{name}"] = v
        return out

    def snapshot(self) -> Dict[str, Any]:
        """Mergeable raw state (histogram buckets, counters, gauges)."""
        with self._lock:
            return {"hists": {n: h.state() for n, h in self._hists.items()},
                    "counters": dict(self._counters),
                    "gauges": dict(self._gauges)}


_default = Registry()


def default_registry() -> Registry:
    return _default


# -- trace context ------------------------------------------------------------

class TraceContext:
    """One hop's identity inside a distributed trace. ``peer`` is the
    remote address the request arrived from (stamped per connection; it
    never rides the wire)."""

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
    # process-unique prefix + atomic counter: no urandom per call
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
    identity an outbound client call ships, so the receiving hop's parent
    edge points at the call, not the whole dispatch."""
    return TraceContext(ctx.trace_id, _new_id(), ctx.span_id)
