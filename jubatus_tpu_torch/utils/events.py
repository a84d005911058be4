"""Cluster event plane (copy of ``jubatus_tpu/utils/events.py``, without
trace-id capture and the cross-node merge, which wait for the tracing
plane).

Subsystems that own a state transition — membership epoch bumps, mix
rounds, breaker open/half-open/close, fault arms/fires, the IVF tier's
cell re-splits and degradations (``ann`` / ``resplit``, ``degraded``) —
emit one typed
event into a bounded per-process **EventJournal**. Events are stamped with
a **hybrid logical clock** timestamp: one sortable int, ``wall_ms << 20 |
counter``, strictly monotonic per process. The mix plane's put_diff
payload carries the master's HLC and receivers ``observe()`` it, so a
member's later events sort after the round that caused them.

Each tracing ``Registry`` owns one journal (``registry.events``); a
module-level default journal catches emissions from code with no registry
in reach (membership epoch bumps, fault arms/fires).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

#: default journal depth
DEFAULT_CAPACITY = 2048

#: logical-counter bits in the packed HLC int
_CTR_BITS = 20

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
        after it. Returns the clock's current value."""
        try:
            remote = int(remote)
        except (TypeError, ValueError):
            remote = 0
        with self._lock:
            if remote > self._last:
                self._last = remote
            return self._last


def hlc_wall_s(hlc: int) -> float:
    """Wall-clock seconds encoded in an HLC timestamp."""
    return (int(hlc) >> _CTR_BITS) / 1000.0


_clock = HLCClock()


def hlc_now() -> int:
    """Next process-wide HLC tick (strictly monotonic)."""
    return _clock.now()


def observe(remote: int) -> int:
    """Merge a remote node's HLC into the process clock."""
    return _clock.observe(remote)


def _rec_matches(rec: Dict[str, Any], grep: str) -> bool:
    """Case-insensitive substring match over the rendered identity of
    one event (subsystem, type, severity, node, field values)."""
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
        #: owner's node name (set by the server once the port is known)
        self.node = ""
        #: optional ``count(name)`` callback (the owning Registry's)
        self._counter = counter

    def emit(self, subsystem: str, etype: str, severity: str = "info",
             **fields: Any) -> Optional[Dict[str, Any]]:
        """Record one event; returns the record (its ``hlc`` is the event
        id the flight recorder cross-links) or None when disabled."""
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


_default = EventJournal()


def default_journal() -> EventJournal:
    """The process-scoped journal for emitters with no Registry in reach
    (membership, faults)."""
    return _default


def emit(subsystem: str, etype: str, severity: str = "info",
         **fields: Any) -> Optional[Dict[str, Any]]:
    """Emit into the process default journal."""
    return _default.emit(subsystem, etype, severity=severity, **fields)
