"""Interval-driven mix scheduling (copy of ``jubatus_tpu/framework/mixer.py``;
≙ linear_mixer's stabilizer_loop).

Reference behavior (mixer/linear_mixer.cpp:362-435, defaults from
server_util.cpp:223-228): a background thread wakes at most every 0.5 s and
fires a mix when update_count >= interval_count (512) OR elapsed >=
interval_sec (16 s) with at least one update. The mix itself is a supplied
callable (the RPC linear mixer's round). Each round lands as one record in
the mixer's flight recorder. Every round roots a fresh trace context: the
``mix.round`` span, the master's phase spans and the members' ``mix_*``
dispatch spans (which inherit it through the RPC fan-out) land in the span
stores under one trace_id, stamped into the flight record. The async plane
sets ``fire_idle``: its fold tick fires on the interval whether or not
this process trained. The perf tuner's cadence core retargets the
interval through ``set_interval``.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from jubatus_tpu_torch.utils import events, tracing
from jubatus_tpu_torch.utils.tracing import Registry, default_registry

log = logging.getLogger(__name__)


class MixFlightRecorder:
    """Bounded ring of structured per-round mix records: mode, success +
    failure reason, duration, per-phase wall times, peers/bytes. Owned by
    each mixer and queryable over the ``get_mix_history`` RPC."""

    def __init__(self, capacity: int = 128) -> None:
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self._seq = 0
        #: owner's node name (set by the server once the port is known)
        self.node = ""

    def record(self, mode: str, *, ok: bool = True, round_id: str = "",
               reason: str = "", duration_ms: Optional[float] = None,
               phases: Optional[Dict[str, Any]] = None,
               **fields: Any) -> Dict[str, Any]:
        # records carry the event plane's HLC, so the event timeline and
        # the mix history agree on ordering; ``ts`` is the wall seconds
        # derived from the same tick
        h = events.hlc_now()
        rec: Dict[str, Any] = {
            "mode": mode, "ok": bool(ok),
            "hlc": h,
            "ts": round(events.hlc_wall_s(h), 3),
            "node": self.node,
        }
        if round_id:
            rec["round_id"] = round_id
        if reason:
            rec["reason"] = reason
        if duration_ms is not None:
            rec["duration_ms"] = round(duration_ms, 3)
        if phases:
            rec["phases"] = dict(phases)
        for k, v in fields.items():
            if v is not None:
                rec[k] = v
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._ring.append(rec)
        return rec

    def snapshot(self, last: int = 0) -> List[Dict[str, Any]]:
        """Oldest-first copy of the ring (the newest ``last`` when > 0)."""
        with self._lock:
            out = list(self._ring)
        return out[-last:] if last > 0 else out

    def stats(self) -> Dict[str, int]:
        with self._lock:
            recs = list(self._ring)
            total = self._seq
        return {"recorded": total,
                "retained": len(recs),
                "failed_retained": sum(1 for r in recs if not r["ok"])}


class IntervalMixer:
    POLL_SEC = 0.5  # linear_mixer.cpp:372-374

    def __init__(
        self,
        mix_fn: Callable[[], Any],
        *,
        interval_sec: float = 16.0,
        interval_count: int = 512,
        flight: Optional[MixFlightRecorder] = None,
    ) -> None:
        self._mix_fn = mix_fn
        self.interval_sec = interval_sec
        self.interval_count = interval_count
        #: async mix plane (framework/async_mixer.py) sets this: a fold
        #: tick must consume OTHER members' submitted diffs whether or
        #: not this process trained anything since the last round
        self.fire_idle = False
        #: set by the owning server so mix spans land in ITS registry
        self.trace: Registry = default_registry()
        #: per-round flight records; an owning mixer passes its own so
        #: scheduler-level and mixer-level records share one ring
        self.flight = flight if flight is not None else MixFlightRecorder()
        self._counter = 0
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._mix_serialize = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        # status counters (reference linear_mixer.cpp:349-360)
        self.mix_count = 0
        self.last_mix_duration = 0.0
        self._last_mix_time = time.monotonic()

    # -- server integration --------------------------------------------------
    def updated(self, n: int = 1) -> None:
        """Called on every model update (server_base::event_model_updated)."""
        with self._cond:
            self._counter += n
            if self._counter >= self.interval_count:
                self._cond.notify()

    def mix_now(self) -> Any:
        """Synchronous mix (the reference's do_mix RPC)."""
        return self._run_mix()

    def round_lock(self) -> threading.Lock:
        """The lock every round holds from its start to its end: whoever
        holds it sees the model between rounds."""
        return self._mix_serialize

    def set_interval(self, sec: float) -> float:
        """Retarget the cadence (the perf tuner's async-mix cadence core).
        The loop polls, so a new interval takes effect within its poll;
        the caller owns the floor/ceiling policy — here only non-positive
        values are refused. Returns the applied interval."""
        with self._cond:
            self.interval_sec = max(0.001, float(sec))
            self._cond.notify()
            return self.interval_sec

    def due(self) -> bool:
        """Would the loop fire a round now? ``interval_count`` updates, or
        ``interval_sec`` elapsed since the last round with at least one
        update (the reference's stabilizer condition), or with none when
        ``fire_idle`` is set."""
        with self._cond:
            return self._due_locked()

    def _due_locked(self) -> bool:
        elapsed = time.monotonic() - self._last_mix_time
        return self._counter >= self.interval_count or (
            (self._counter > 0 or self.fire_idle)
            and elapsed >= self.interval_sec)

    def _run_mix(self) -> Any:
        """Execute one mix round WITHOUT holding the condition lock: updated()
        callers (the train hot path) must never block behind a round.
        _mix_serialize keeps concurrent mix_now/loop rounds from
        overlapping. The round runs under a fresh root trace context."""
        ctx = tracing.new_root()
        with self._mix_serialize, tracing.use_trace(ctx):
            with self._cond:
                self._counter = 0
            # round start/end bracket the event timeline; the end event's
            # hlc cross-links into the flight record (event_hlc)
            self.trace.events.emit("mix", "round_start", severity="debug")
            try:
                with self.trace.span("mix.round") as sp:
                    result = self._mix_fn()
            except Exception as e:  # broad-ok — mix_fn is arbitrary
                self.trace.count("mix.round.errors")
                evt = self.trace.events.emit(
                    "mix", "round_error", severity="error",
                    reason=f"{type(e).__name__}: {e}")
                self.flight.record(
                    "error", ok=False,
                    reason=f"{type(e).__name__}: {e}",
                    duration_ms=sp.seconds * 1e3,
                    trace_id=ctx.trace_id,
                    event_hlc=evt["hlc"] if evt else None)
                raise
            with self._cond:
                self.last_mix_duration = sp.seconds
                self.mix_count += 1
                self._last_mix_time = time.monotonic()
            if isinstance(result, dict):
                # mixers annotate their round result (mode, members,
                # bytes, phases, round_id); record it as one flight entry
                extra = dict(result)
                mode = extra.pop("mode", "mix")
                phases = extra.pop("phases", None)
                rid = extra.pop("round_id", "")
                for k in ("ok", "reason", "duration_ms", "ts", "node",
                          "seq", "trace_id", "hlc", "event_hlc"):
                    extra.pop(k, None)  # reserved record fields
                evt = self.trace.events.emit(
                    "mix", "round", mode=mode, round_id=rid or None,
                    duration_ms=round(self.last_mix_duration * 1e3, 1),
                    degraded=extra.get("degraded"),
                    contributors=extra.get("contributors"))
                self.flight.record(
                    mode, ok=True, round_id=rid, phases=phases,
                    duration_ms=self.last_mix_duration * 1e3,
                    trace_id=ctx.trace_id,
                    event_hlc=evt["hlc"] if evt else None, **extra)
            return result

    # -- background loop ------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True, name="mixer")
        self._thread.start()

    def stop(self) -> None:
        with self._cond:
            self._running = False
            self._cond.notify()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _loop(self) -> None:
        while True:
            with self._cond:
                if not self._running:
                    return
                self._cond.wait(timeout=self.POLL_SEC)
                if not self._running:
                    return
                due = self._due_locked()
            if due:
                try:
                    self._run_mix()  # outside the cond lock
                except Exception:  # broad-ok — must not kill the loop
                    log.exception("mix round failed")

    def get_status(self) -> Dict[str, Any]:
        st = {
            "mix_count": self.mix_count,
            "counter": self._counter,
            "interval_sec": self.interval_sec,
            "interval_count": self.interval_count,
            "last_mix_duration": self.last_mix_duration,
        }
        for k, v in self.flight.stats().items():
            st[f"flight_{k}"] = v
        return st
