"""Shared controller core (copy of ``jubatus_tpu/coord/controller.py``):
the signal→decision→actuator machinery that the autoscaler and the perf
tuner ride.

- :class:`StreakGate`: hot/cold confirm streaks + the cooldown clock.
  Pure and clock-injected: synthetic timelines drive it in tests exactly
  like production ticks do. ``AutoscalerCore`` and every tuner core
  subclass or compose it.
- :class:`ControllerLoop`: the journal/eventing/counters/backoff half.
  ``record()`` appends one structured journal entry (HLC-stamped, with
  non-hold actions emitting a typed timeline event whose id the entry
  cross-links), bumps ``<subsystem>.decisions`` plus a per-action
  counter, and gauges the signals; ``guarded()`` runs one actuation
  through its fault site and, on failure, journals ``blocked`` and arms
  exponential backoff — the never-hot-loop guarantee every actuator
  inherits.

The same records, counters and backoff as the JAX package's, so a
timeline or ``jubactl -c tune`` / ``-c autoscale`` view reads either.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

from jubatus_tpu_torch.utils import events, faults
from jubatus_tpu_torch.utils.tracing import Registry

log = logging.getLogger(__name__)

__all__ = ["StreakGate", "ControllerLoop"]


class StreakGate:
    """Clock-injected hysteresis: a decision fires only after
    ``hot_confirm`` consecutive hot observations (or ``cold_confirm``
    cold ones), and any fired action starts a ``cooldown_s`` quiet
    window. Alternating signals reset the streaks — flap suppression by
    construction."""

    def __init__(self, hot_confirm: int, cold_confirm: int,
                 cooldown_s: float) -> None:
        self.hot_confirm = int(hot_confirm)
        self.cold_confirm = int(cold_confirm)
        self.cooldown_s = float(cooldown_s)
        self.hot_streak = 0
        self.cold_streak = 0
        self.last_action_ts = 0.0

    def step(self, hot: bool, cold: bool) -> None:
        """Fold one observation into the streaks (a tick is hot, cold,
        or neither — never both)."""
        self.hot_streak = self.hot_streak + 1 if hot else 0
        self.cold_streak = self.cold_streak + 1 if cold else 0

    @property
    def hot_confirmed(self) -> bool:
        return self.hot_streak >= self.hot_confirm

    @property
    def cold_confirmed(self) -> bool:
        return self.cold_streak >= self.cold_confirm

    def in_cooldown(self, now: float) -> bool:
        return now - self.last_action_ts < self.cooldown_s \
            and self.last_action_ts > 0

    def fired_hot(self, now: float) -> None:
        self.last_action_ts = now
        self.hot_streak = 0

    def fired_cold(self, now: float) -> None:
        self.last_action_ts = now
        self.cold_streak = 0

    def reset_clock(self) -> None:
        """A failed actuation must not start the cooldown clock — the
        retry after backoff would otherwise wait both out."""
        self.last_action_ts = 0.0

    def gate_state(self) -> Dict[str, Any]:
        return {"hot_streak": self.hot_streak,
                "cold_streak": self.cold_streak,
                "last_action_ts": self.last_action_ts}


class ControllerLoop:
    """Journal + events + counters + fault-wrapped actuation with
    exponential backoff. Subclasses set :attr:`subsystem` (the event
    subsystem AND the metric key prefix) and override the small hooks;
    everything else — HLC stamping, timeline cross-links, the blocked/
    backoff discipline — is shared verbatim with the autoscaler."""

    #: event-plane subsystem and ``<subsystem>.decisions`` counter prefix
    subsystem = "controller"

    def __init__(self, journal_capacity: int,
                 registry: Optional[Registry] = None) -> None:
        self.registry = registry or Registry()
        self.journal: deque = deque(maxlen=int(journal_capacity))
        self._jlock = threading.Lock()
        #: actuation-failure backoff state (the never-hot-loop guard)
        self.backoff_until = 0.0
        self._backoff_s = 0.0

    # -- subclass hooks ------------------------------------------------------
    def _counter_suffix(self, action: str,
                        extra: Dict[str, Any]) -> Optional[str]:
        """Per-action counter name under the subsystem prefix (e.g. the
        autoscaler's scale_out → ``spawns``); None counts nothing."""
        return None

    def _event_fields(self, signals: Dict[str, Any],
                      extra: Dict[str, Any]) -> Dict[str, Any]:
        """Extra fields stamped onto the timeline event of a non-hold
        record."""
        return {}

    def _gauge_signals(self, signals: Dict[str, Any]) -> None:
        """Publish the record's signals as gauges (subclass-specific
        keys so the catalog stays literal)."""

    def _on_actuation_failure(self) -> None:
        """Called when an actuation fails, before the blocked record —
        the autoscaler resets its cooldown clocks here so the retry
        after backoff is not additionally cooldown-delayed."""

    def _backoff_bounds(self) -> Tuple[float, float]:
        """(initial_s, max_s) of the exponential actuation backoff."""
        return 2.0, 60.0

    # -- journal -------------------------------------------------------------
    def record(self, action: str, reason: str, signals: Dict[str, Any],
               now: float, **extra: Any) -> Dict[str, Any]:
        """One structured journal entry. Entries ride the event plane's
        HLC helper (ordering agrees with ``jubactl -c timeline``), and
        every decision of consequence emits a timeline event whose id
        the journal entry cross-links (``event_hlc``)."""
        h = events.hlc_now()
        rec = {"ts": round(now, 3), "hlc": h, "action": action,
               "reason": reason, "signals": signals}
        rec.update(extra)
        if action != "hold":
            evt = self.registry.events.emit(
                self.subsystem, action,
                severity="warning" if action == "blocked" else "info",
                reason=reason, **self._event_fields(signals, extra))
            if evt is not None:
                rec["event_hlc"] = evt["hlc"]
        with self._jlock:
            self.journal.append(rec)
        self.registry.count(f"{self.subsystem}.decisions")
        if extra.get("dry_run"):
            pass  # intent only: the per-action counters count actuations
        else:
            suffix = self._counter_suffix(action, extra)
            if suffix:
                self.registry.count(f"{self.subsystem}.{suffix}")
        self._gauge_signals(signals)
        if action != "hold":
            log.info("%s %s (%s): %s%s", self.subsystem, action, reason,
                     signals,
                     f" target={extra.get('target')}"
                     if extra.get("target") else "")
        return rec

    def journal_tail(self, last: int = 32) -> list:
        with self._jlock:
            return list(self.journal)[-max(0, int(last)):]

    # -- actuation (fault sites + backoff live here) -------------------------
    def in_backoff(self, now: float) -> bool:
        return now < self.backoff_until

    def guarded(self, site: str, fn: Callable[[], Any], *, reason: str,
                signals: Dict[str, Any], now: float,
                **blocked_extra: Any
                ) -> Tuple[bool, Optional[Dict[str, Any]]]:
        """Run one actuation through its fault site. On failure the
        journal records ``blocked``, the backoff doubles (capped), and
        ``(False, blocked_record)`` comes back; on success the backoff
        resets and the CALLER records the action (it knows the
        decision's fields)."""
        try:
            faults.fire(site)
            fn()
        except Exception as e:  # broad-ok — actuation failure is a
            # first-class outcome: journal it, back off, never hot-loop
            initial, cap = self._backoff_bounds()
            self._backoff_s = min(cap, (self._backoff_s * 2) or initial)
            self.backoff_until = now + self._backoff_s
            self._on_actuation_failure()
            rec = self.record(
                "blocked", reason, signals, now,
                error=repr(e)[:200],
                backoff_s=round(self._backoff_s, 3), **blocked_extra)
            return False, rec
        self._backoff_s = 0.0
        self.backoff_until = 0.0
        return True, None

    def backoff_state(self) -> Dict[str, Any]:
        return {"backoff_until": round(self.backoff_until, 3),
                "backoff_s": round(self._backoff_s, 3)}
