"""Cluster event plane (copy of ``jubatus_tpu/utils/events.py``): one
causally ordered, queryable record of *what happened, in what order,
across the fleet*.

Every state-transition-owning subsystem — membership epoch bumps, drain
phases, mix rounds/degrades/fallbacks, async-mix master elections,
breaker open/half-open/close, SLO fire/clear, autoscaler decisions,
checkpoint save/restore/reshard, fault arms/fires — emits one typed
event into a bounded per-process **EventJournal**. Events are stamped
with a **hybrid logical clock** timestamp, so merging journals from
nodes with skewed wall clocks still yields a causally consistent
interleaving wherever the clocks were connected by a message (the mix
plane's put_diff payload carries the master's HLC; receivers
``observe()`` it).

HLC encoding: one sortable int, ``wall_ms << 20 | counter``. The
physical component is the local wall clock in milliseconds; the logical
counter breaks same-millisecond ties and absorbs observed remote
timestamps that run ahead of the local clock. ``now()`` is strictly
monotonic per process — which makes the HLC double as the **cursor**
for ``get_events(since=...)`` (a follower's cursor): a
caller re-polls with the max HLC it has seen and receives exactly the
events emitted after it.

Two journals exist per process: each tracing ``Registry`` owns one
(``registry.events`` — per-server attribution, like the slow log), and
a module-level **default journal** catches emissions from code with no
registry in reach (membership epoch bumps, fault arms/fires, checkpoint
paths). ``get_events`` serves the merge of both; in the rare
multi-server test process, default-journal events appear under every
embedded server — by design (they are process-scoped facts).

Severities: ``debug`` < ``info`` < ``warning`` < ``error``. Each event
also captures the active trace_id when one exists, which is what lets
an incident bundle (utils/incidents.py) correlate the event window with
slow-log records and flight records of the same request.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

#: default journal depth — ~hours of cluster life at normal event rates,
#: minutes under a breaker flap storm (the ring bounds the damage)
DEFAULT_CAPACITY = 2048

#: logical-counter bits in the packed HLC int
_CTR_BITS = 20
_CTR_MASK = (1 << _CTR_BITS) - 1

SEVERITIES = ("debug", "info", "warning", "error")


class HLCClock:
    """Hybrid logical clock: strictly monotonic per process, merges
    remote timestamps so message receipt establishes happens-before
    even when the wall clocks are skewed."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._last = 0

    def now(self) -> int:
        phys = int(time.time() * 1000) << _CTR_BITS  # wall-clock
        with self._lock:
            self._last = phys if phys > self._last else self._last + 1
            return self._last

    def observe(self, remote: int) -> int:
        """Merge a remote HLC: every subsequent local ``now()`` sorts
        after it (and after everything local so far). Returns the
        clock's current value."""
        try:
            remote = int(remote)
        except (TypeError, ValueError):
            return self.peek()
        with self._lock:
            if remote > self._last:
                self._last = remote
            return self._last

    def peek(self) -> int:
        with self._lock:
            return self._last


def hlc_wall_s(hlc: int) -> float:
    """Wall-clock seconds encoded in an HLC timestamp (the physical
    component; logical ties collapse to the same instant)."""
    return (int(hlc) >> _CTR_BITS) / 1000.0


def wall_to_hlc(ts_s: float) -> int:
    """Lower bound of every HLC stamped at/after wall time ``ts_s`` —
    the ``since`` filter for 'events in the last N seconds'."""
    return max(0, int(ts_s * 1000)) << _CTR_BITS


_clock = HLCClock()


def hlc_now() -> int:
    """Next process-wide HLC tick (strictly monotonic)."""
    return _clock.now()


def observe(remote: int) -> int:
    """Merge a remote node's HLC into the process clock (call when a
    message carrying a remote timestamp is received)."""
    return _clock.observe(remote)


def _rec_matches(rec: Dict[str, Any], grep: str) -> bool:
    """Case-insensitive substring match over the rendered identity of
    one event (subsystem, type, severity, node, trace, field values)."""
    hay = " ".join(
        str(v) for v in rec.values() if isinstance(v, (str, int, float))
    ).lower()
    return grep.lower() in hay


class EventJournal:
    """Bounded per-process ring of typed, HLC-stamped events."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 counter: Optional[Any] = None) -> None:
        self._lock = threading.Lock()
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=max(1, self.capacity))
        self._emitted = 0
        #: owner's node name (set by the server once the port is known,
        #: like the mix flight recorder)
        self.node = ""
        #: optional ``count(name)`` callback (the owning Registry's) so
        #: `event.emitted` / `event.dropped` ride /metrics
        self._counter = counter

    def set_capacity(self, capacity: int) -> None:
        """Re-bound at server start (``--event-capacity``); 0 disables
        emission entirely (``emit`` becomes a no-op)."""
        with self._lock:
            self.capacity = int(capacity)
            self._ring = deque(self._ring, maxlen=max(1, self.capacity))

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def emit(self, subsystem: str, etype: str, severity: str = "info",
             **fields: Any) -> Optional[Dict[str, Any]]:
        """Record one event; returns the record (its ``hlc`` is the
        event id other planes cross-link) or None when disabled. The
        active trace context's id is captured automatically."""
        if self.capacity <= 0:
            return None
        h = _clock.now()
        rec: Dict[str, Any] = {
            "hlc": h,
            "ts": round(hlc_wall_s(h), 3),
            "node": self.node,
            "subsystem": str(subsystem),
            "type": str(etype),
            "severity": severity if severity in SEVERITIES else "info",
        }
        tid = _current_trace_id()
        if tid:
            rec["trace_id"] = tid
        for k, v in fields.items():
            if v is not None:
                rec[k] = v
        dropped = False
        with self._lock:
            self._emitted += 1
            if len(self._ring) == self._ring.maxlen:
                dropped = True
            self._ring.append(rec)
        if self._counter is not None:
            self._counter("event.emitted")
            if dropped:
                self._counter("event.dropped")
        return rec

    def snapshot(self, since: int = 0, grep: str = "",
                 limit: int = 0) -> List[Dict[str, Any]]:
        """Oldest-first copy of events with ``hlc > since`` (the
        cursor contract: re-poll with the max hlc you saw), optionally
        grep-filtered; ``limit > 0`` keeps the newest that many."""
        since = int(since or 0)
        with self._lock:
            out = [dict(r) for r in self._ring if r["hlc"] > since]
        if grep:
            out = [r for r in out if _rec_matches(r, str(grep))]
        return out[-limit:] if limit > 0 else out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"emitted": self._emitted,
                    "retained": len(self._ring),
                    "capacity": self.capacity}

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._emitted = 0


def merge_events(lists: Iterable[List[Dict[str, Any]]]
                 ) -> List[Dict[str, Any]]:
    """Fold event lists from N journals/nodes into one causally ordered
    timeline: sort by (hlc, node) — HLC order IS causal order wherever
    the clocks were connected by an observed message, and a stable
    node tiebreak keeps concurrent events deterministic. Deduplicates
    by (hlc, node): an HLC is unique per process, so the same record
    reaching the merge twice (a default-journal event served by every
    embedded server of a test process, or an overlapping re-poll) is
    the same event, not two."""
    out: List[Dict[str, Any]] = []
    seen: set = set()
    for lst in lists:
        for r in lst or []:
            key = (int(r.get("hlc", 0)), str(r.get("node", "")))
            if key in seen:
                continue
            seen.add(key)
            out.append(r)
    out.sort(key=lambda r: (int(r.get("hlc", 0)), str(r.get("node", ""))))
    return out


_tracing_mod = None


def _current_trace_id() -> str:
    """Active trace id, if any. Lazy module cache: tracing imports this
    module (Registry owns an EventJournal), so the reverse import must
    happen at first use, not at import time."""
    global _tracing_mod
    if _tracing_mod is None:
        from jubatus_tpu_torch.utils import tracing as _t

        _tracing_mod = _t
    ctx = _tracing_mod.current_trace()
    return ctx.trace_id if ctx is not None else ""


_default = EventJournal()


def default_journal() -> EventJournal:
    """The process-scoped journal for emitters with no Registry in
    reach (membership, faults, checkpoint plumbing). ``get_events``
    merges it with the serving registry's journal."""
    return _default


def emit(subsystem: str, etype: str, severity: str = "info",
         **fields: Any) -> Optional[Dict[str, Any]]:
    """Emit into the process default journal."""
    return _default.emit(subsystem, etype, severity=severity, **fields)
