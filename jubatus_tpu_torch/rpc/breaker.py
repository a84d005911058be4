"""Per-backend circuit breakers (copy of ``jubatus_tpu/rpc/breaker.py``).

The port uses them in the mix plane's fan-out (``mix.breaker``) and in the
routing proxy (``proxy.breaker``, server/proxy.py), as the JAX package does.

The reference's only reaction to a sick backend is cache invalidation
(proxy_common.cpp watch → re-read actives) — a backend that is REGISTERED
but limping (accepting connections, timing out calls) keeps receiving its
share of traffic and every request pays the full timeout. A breaker turns
repeated transport failures into an immediate routing decision:

- **closed** — traffic flows; failures land in a rolling window.
- **open** — ``failure_threshold`` transport failures inside
  ``window_sec`` trip the breaker: calls are refused instantly
  (``BreakerOpen``) for ``cooldown_sec``, so routing skips the backend
  and idempotent calls fail over to a healthy replica without burning a
  timeout each.
- **half-open** — after the cooldown, ONE probe call is admitted; its
  success closes the breaker (window cleared), its failure re-opens it
  for another cooldown. Probes are serialized (a thundering re-admit
  would re-melt a barely-recovered backend).

Only TRANSPORT failures count (``errors.is_retryable``): an application
error from a healthy backend proves the backend is alive and must not
open its breaker. State transitions bump counters in the owning
registry (``<prefix>_open`` / ``<prefix>_close``) and every decision
point fires a fault-injection site, so chaos tests can drive the state
machine deterministically.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Hashable, Optional

from jubatus_tpu_torch.utils import events, faults

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """One backend's failure window + state machine. Thread-safe."""

    __slots__ = ("window_sec", "failure_threshold", "cooldown_sec",
                 "_lock", "_failures", "_state", "_opened_at",
                 "_probe_in_flight", "opened_total", "name",
                 "_half_open_evt")

    def __init__(self, *, window_sec: float = 30.0,
                 failure_threshold: int = 5,
                 cooldown_sec: float = 5.0, name: str = "") -> None:
        self.window_sec = float(window_sec)
        self.failure_threshold = int(failure_threshold)
        self.cooldown_sec = float(cooldown_sec)
        self.name = name
        self._lock = threading.Lock()
        self._failures: deque = deque()  # monotonic timestamps
        self._state = CLOSED  # no-event — initial state, not a transition
        self._opened_at = 0.0
        self._probe_in_flight = False
        self.opened_total = 0
        #: set on the open→half_open transition inside allow(); the
        #: owning BreakerBoard consumes it to emit the half_open event
        self._half_open_evt = False

    def _prune(self, now: float) -> None:
        horizon = now - self.window_sec
        while self._failures and self._failures[0] < horizon:
            self._failures.popleft()

    def allow(self) -> bool:
        """May a call be sent to this backend right now? Half-open grants
        exactly one in-flight probe; the caller MUST follow up with
        record_success/record_failure (probe bookkeeping depends on it)."""
        now = time.monotonic()
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if now - self._opened_at < self.cooldown_sec:
                    return False
                self._state = HALF_OPEN  # no-event — surfaced by the board
                self._probe_in_flight = True
                self._half_open_evt = True
                return True
            # HALF_OPEN: one probe at a time
            if self._probe_in_flight:
                return False
            self._probe_in_flight = True
            return True

    @property
    def state(self) -> str:
        # surface open→half_open lazily so status views don't show a
        # breaker as "open" past its cooldown
        with self._lock:
            if self._state == OPEN and \
                    time.monotonic() - self._opened_at >= self.cooldown_sec:
                return HALF_OPEN
            return self._state

    def available(self) -> bool:
        """Peek: would a call be routable here? Unlike ``allow`` this
        NEVER claims the half-open probe slot — use it to FILTER
        candidates, then ``allow`` only on the node actually called
        (an unclaimed probe slot would wedge the breaker half-open)."""
        return self.state != OPEN

    def pop_half_open(self) -> bool:
        """Consume the open→half_open transition flag (board-side event
        emission; at most one per transition)."""
        with self._lock:
            v = self._half_open_evt
            self._half_open_evt = False
            return v

    def record_success(self) -> bool:
        """Returns True when this success CLOSED a half-open breaker."""
        with self._lock:
            self._probe_in_flight = False
            if self._state in (HALF_OPEN, OPEN):
                # OPEN can still see a success: a call admitted before the
                # trip returning late — treat it as the probe's evidence
                self._state = CLOSED  # no-event — surfaced by the board
                self._failures.clear()
                return True
            return False

    def record_failure(self) -> bool:
        """Returns True when this failure OPENED the breaker."""
        now = time.monotonic()
        with self._lock:
            self._probe_in_flight = False
            if self._state == HALF_OPEN:
                self._state = OPEN  # no-event — surfaced by the board
                self._opened_at = now
                self.opened_total += 1
                return True
            self._failures.append(now)
            self._prune(now)
            if self._state == CLOSED and \
                    len(self._failures) >= self.failure_threshold:
                self._state = OPEN  # no-event — surfaced by the board
                self._opened_at = now
                self.opened_total += 1
                return True
            return False

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            state = self._state
            if state == OPEN and \
                    time.monotonic() - self._opened_at >= self.cooldown_sec:
                state = HALF_OPEN
            return {"state": state,
                    "failures_in_window": len(self._failures),
                    "opened_total": self.opened_total,
                    "window_sec": self.window_sec,
                    "failure_threshold": self.failure_threshold,
                    "cooldown_sec": self.cooldown_sec}


class BreakerBoard:
    """Breakers keyed by backend identity (host, port), sharing one
    config. Owned by a Proxy (counter prefix ``proxy.breaker``) or a
    mixer communication seam (``mix.breaker``); transitions count into
    the supplied tracing registry."""

    def __init__(self, *, window_sec: float = 30.0,
                 failure_threshold: int = 5, cooldown_sec: float = 5.0,
                 registry: Optional[Any] = None,
                 counter_prefix: str = "proxy.breaker") -> None:
        self.window_sec = window_sec
        self.failure_threshold = failure_threshold
        self.cooldown_sec = cooldown_sec
        self.registry = registry
        self.counter_prefix = counter_prefix
        self._lock = threading.Lock()
        self._breakers: Dict[Hashable, CircuitBreaker] = {}

    def get(self, key: Hashable) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(key)
            if b is None:
                b = self._breakers[key] = CircuitBreaker(
                    window_sec=self.window_sec,
                    failure_threshold=self.failure_threshold,
                    cooldown_sec=self.cooldown_sec, name=str(key))
            return b

    def _count(self, name: str) -> None:
        if self.registry is not None:
            self.registry.count(name)

    def _emit(self, etype: str, key: Hashable, severity: str = "info",
              **fields: Any) -> None:
        """One breaker state-transition event into the
        owning registry's journal (proxy/mixer attribution) — or the
        process default journal for registry-less boards."""
        journal = self.registry.events if self.registry is not None \
            else events.default_journal()
        journal.emit("breaker", etype, severity=severity,
                     backend=str(key), plane=self.counter_prefix, **fields)

    def allow(self, key: Hashable) -> bool:
        if faults.is_armed():
            faults.fire(f"breaker.allow.{key}")
        b = self.get(key)
        admitted = b.allow()
        if b.pop_half_open():
            self._emit("half_open", key)
        return admitted

    def available(self, key: Hashable) -> bool:
        """Peek (no probe claim) — candidate filtering."""
        return self.get(key).available()

    def record(self, key: Hashable, ok: bool) -> None:
        """Fold one call outcome into the backend's breaker; counts
        ``<prefix>_open`` on a trip and ``<prefix>_close`` on a
        half-open probe's success, emitting the matching breaker event."""
        b = self.get(key)
        if ok:
            if b.record_success():
                self._count(f"{self.counter_prefix}_close")
                self._emit("close", key)
        else:
            if b.record_failure():
                self._count(f"{self.counter_prefix}_open")
                self._emit("open", key, severity="warning",
                           opened_total=b.opened_total)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            items = list(self._breakers.items())
        return {str(k): b.snapshot() for k, b in items}
