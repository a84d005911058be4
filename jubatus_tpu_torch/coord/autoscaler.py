"""Autoscaling control plane (copy of ``jubatus_tpu/coord/autoscaler.py``):
close the loop from telemetry to fleet size.

    signals ──> decision ──> actuation
    (poll)      (hysteresis)  (spawn / drain)

- **Signals** (:func:`poll_fleet`): one ``get_timeseries`` scrape per
  active member yields windowed request rates and worst p99 (the same
  math as ``jubactl -c watch``), the coalescer backpressure gauges
  (``microbatch.queue_depth`` / ``microbatch.arrival_per_sec``, sampled
  into the ring by the telemetry tick), and the live SLO burn gauges
  (``slo.*.burn_fast`` / ``.firing``). Draining members are excluded
  from capacity accounting.
- **Decision** (:class:`AutoscalerCore`): a pure, clock-injected
  hysteresis/cooldown state machine — scale-out only after
  ``scale_out_confirm`` consecutive hot polls (SLO burn at/above
  ``burn_hot`` or queued examples per replica at/above ``queue_hot``),
  scale-in only after a longer cold streak, both inside ``min/max``
  bounds, everything rate-limited by ``cooldown_s``. A fleet below the
  floor (a dead replica) restores immediately, bypassing confirm and
  cooldown. Scale-in picks the least-loaded replica (queue depth, then
  request rate).
- **Actuation** (:class:`VisorActuator` / :class:`HookActuator`):
  scale-out spawns replicas through jubavisor's ``start`` RPC
  (round-robin over registered visors); scale-in fires the member's
  drain state machine. Test harnesses plug a spawn/drain hook instead.
  Both paths run through the ``autoscale.spawn`` / ``autoscale.drain``
  fault sites, and a failing actuation backs off exponentially with the
  journal recording ``blocked`` — a broken spawn path must never
  hot-loop.

Every decision lands in a bounded **journal** of structured records and
bumps the ``autoscale.{decisions,spawns,drains,blocked}`` counters;
``get_autoscale_status`` (served when :meth:`Autoscaler.serve` is up,
registered under ``/jubatus/autoscalers``) exposes config, live state,
and the journal tail to ``jubactl -c autoscale --watch``. The
streak/cooldown gate and the journal/backoff discipline are the shared
coord/controller.py; this module keeps the fleet-specific halves. The
journal records, the RPC doc and the autoscaler registration are the JAX
package's, so either package's ``jubactl`` reads either's autoscaler.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from jubatus_tpu_torch.coord import membership
from jubatus_tpu_torch.coord.base import Coordinator, NodeInfo
from jubatus_tpu_torch.coord.controller import ControllerLoop, StreakGate
from jubatus_tpu_torch.utils.timeseries import window_from_points
from jubatus_tpu_torch.utils.tracing import Registry

log = logging.getLogger(__name__)

__all__ = [
    "AutoscaleConfig", "ReplicaStats", "FleetSnapshot", "Decision",
    "AutoscalerCore", "Autoscaler", "HookActuator", "VisorActuator",
    "poll_fleet",
]


@dataclasses.dataclass
class AutoscaleConfig:
    """Knobs of the control loop; defaults target a small serving fleet
    polled every few seconds. Everything an operator tunes rides
    ``jubactl -c autoscale`` flags."""
    min_replicas: int = 1
    max_replicas: int = 8
    #: control-loop period; also the unit the SLO-violation clock counts
    poll_interval_s: float = 5.0
    #: timeseries window for request rates / p99 (like watch --window)
    window_s: float = 30.0
    #: hot when any member's fast burn is at/above this (utils/slo.py
    #: burn semantics: 2.0 = spending error budget twice as fast as it
    #: accrues) ...
    burn_hot: float = 2.0
    #: ... or when queued examples PER NON-DRAINING REPLICA reach this
    queue_hot: float = 4096.0
    #: cold only when burn is under 1.0, nothing fires, and the queue
    #: sits below this fraction of queue_hot
    queue_cold_fraction: float = 0.1
    #: consecutive hot polls before a scale-out fires (flap suppression)
    scale_out_confirm: int = 2
    #: consecutive cold polls before a scale-in fires (asymmetric on
    #: purpose: growing too late burns SLO, shrinking too eagerly flaps)
    scale_in_confirm: int = 6
    #: replicas added per scale-out decision
    scale_out_step: int = 1
    #: quiet period after any actuation (floor restores are exempt)
    cooldown_s: float = 30.0
    #: actuation-failure backoff (doubles per failure up to the max)
    backoff_initial_s: float = 2.0
    backoff_max_s: float = 60.0
    journal_capacity: int = 256
    #: observe + journal, never actuate (the static-control twin and
    #: the safe default for `jubactl -c autoscale --once` exploration)
    dry_run: bool = False

    def validate(self) -> "AutoscaleConfig":
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if self.poll_interval_s <= 0:
            raise ValueError("poll_interval_s must be > 0")
        if self.scale_out_confirm < 1 or self.scale_in_confirm < 1:
            raise ValueError("confirm streaks must be >= 1")
        if self.burn_hot <= 0 or self.queue_hot <= 0:
            raise ValueError("burn_hot / queue_hot must be > 0")
        if self.backoff_initial_s <= 0 or \
                self.backoff_max_s < self.backoff_initial_s:
            raise ValueError("backoff bounds must be 0 < initial <= max")
        return self


@dataclasses.dataclass
class ReplicaStats:
    """One member's view for a single poll."""
    name: str
    req_per_sec: float = 0.0
    p99_ms: float = 0.0
    queue_depth: float = 0.0
    arrival_per_sec: float = 0.0
    burn_max: float = 0.0
    firing: bool = False
    draining: bool = False
    reachable: bool = True


@dataclasses.dataclass
class FleetSnapshot:
    """Everything one control tick decides from."""
    ts: float
    replicas: List[ReplicaStats] = dataclasses.field(default_factory=list)
    errors: List[str] = dataclasses.field(default_factory=list)

    @property
    def serving(self) -> List[ReplicaStats]:
        return [r for r in self.replicas if not r.draining]

    @property
    def size(self) -> int:
        return len(self.serving)

    @property
    def burn_max(self) -> float:
        return max((r.burn_max for r in self.serving), default=0.0)

    @property
    def firing(self) -> bool:
        return any(r.firing for r in self.serving)

    @property
    def queue_total(self) -> float:
        return sum(r.queue_depth for r in self.serving)

    @property
    def queue_per_replica(self) -> float:
        return self.queue_total / self.size if self.size else 0.0

    @property
    def req_per_sec(self) -> float:
        return sum(r.req_per_sec for r in self.serving)

    def signals(self) -> Dict[str, Any]:
        return {"replicas": self.size,
                "burn_max": round(self.burn_max, 4),
                "firing": self.firing,
                "queue_per_replica": round(self.queue_per_replica, 1),
                "req_per_sec": round(self.req_per_sec, 1)}


def _stats_from_points(name: str, points: List[Dict[str, Any]],
                       window_s: float) -> ReplicaStats:
    """Fold one member's ``get_timeseries`` points into a ReplicaStats:
    windowed request rate + worst p99 (watch math), newest-point
    coalescer gauges, and the worst live SLO burn gauge."""
    r = ReplicaStats(name)
    win = window_from_points(points, window_s)
    if win is not None:
        for span in win.spans("rpc."):
            rate = win.span_rate(span)
            r.req_per_sec += rate
            if rate > 0:
                q = win.quantile_ms(span, 0.99)
                if q is not None:
                    r.p99_ms = max(r.p99_ms, q)
    gauges = (points[-1].get("gauges") or {}) if points else {}
    r.queue_depth = float(gauges.get("microbatch.queue_depth", 0.0))
    r.arrival_per_sec = float(gauges.get("microbatch.arrival_per_sec", 0.0))
    for key, val in gauges.items():
        if key.startswith("slo.") and key.endswith(".burn_fast"):
            r.burn_max = max(r.burn_max, float(val))
        elif key.startswith("slo.") and key.endswith(".firing") and val:
            r.firing = True
    return r


def poll_fleet(coord: Coordinator, engine: str, name: str, *,
               window_s: float = 30.0, timeout: float = 5.0,
               now: Optional[float] = None) -> FleetSnapshot:
    """One scrape of the cluster's autoscaling signals (one
    ``get_timeseries`` RPC per active member). Unreachable members
    degrade per node — they stay in the snapshot as zero-signal rows so
    the floor-restore logic still counts the fleet honestly shrunken
    only when the registration is actually gone."""
    from jubatus_tpu_torch.rpc.client import RpcClient

    snap = FleetSnapshot(ts=time.time() if now is None else float(now))
    draining = {n.name for n in membership.get_draining(coord, engine, name)}
    for node in membership.get_all_actives(coord, engine, name):
        try:
            with RpcClient(node.host, node.port, timeout=timeout) as c:
                ts = c.call("get_timeseries", name)
        except Exception as e:  # broad-ok — a sick member is a signal
            snap.errors.append(f"{node.name}: {e}")
            r = ReplicaStats(node.name, reachable=False)
            r.draining = node.name in draining
            snap.replicas.append(r)
            continue
        points = ((ts or {}).get(node.name) or {}).get("points") or []
        r = _stats_from_points(node.name, points, window_s)
        r.draining = node.name in draining
        snap.replicas.append(r)
    return snap


@dataclasses.dataclass
class Decision:
    """What one control tick decided (pre-actuation intent)."""
    action: str               # hold | scale_out | scale_in
    reason: str
    count: int = 0            # scale_out: replicas to add
    target: str = ""          # scale_in: member to drain


class AutoscalerCore(StreakGate):
    """The pure decision state machine — no RPC, no threads, clock
    injected: synthetic burn/queue timelines drive it in tests exactly
    like production snapshots do. The streak/cooldown half is the
    shared :class:`StreakGate` (coord/controller.py); this class adds
    the fleet-shape classification and the bounded scale decision."""

    def __init__(self, config: AutoscaleConfig) -> None:
        self.config = config.validate()
        StreakGate.__init__(self, config.scale_out_confirm,
                            config.scale_in_confirm, config.cooldown_s)
        self.last_floor_restore_ts = 0.0

    # -- classification ------------------------------------------------------
    def is_hot(self, snap: FleetSnapshot) -> bool:
        return snap.burn_max >= self.config.burn_hot or \
            snap.queue_per_replica >= self.config.queue_hot

    def is_cold(self, snap: FleetSnapshot) -> bool:
        return (snap.burn_max < 1.0 and not snap.firing
                and snap.queue_per_replica <=
                self.config.queue_cold_fraction * self.config.queue_hot)

    @staticmethod
    def least_loaded(snap: FleetSnapshot) -> Optional[ReplicaStats]:
        """Scale-in victim: fewest queued examples, then lowest request
        rate — draining it shifts the least traffic."""
        serving = [r for r in snap.serving if r.reachable]
        if not serving:
            return None
        return min(serving,
                   key=lambda r: (r.queue_depth, r.req_per_sec, r.name))

    # -- the tick ------------------------------------------------------------
    def observe(self, snap: FleetSnapshot,
                now: Optional[float] = None) -> Decision:
        cfg = self.config
        now = snap.ts if now is None else float(now)
        n = snap.size
        hot, cold = self.is_hot(snap), self.is_cold(snap)
        self.step(hot, cold)
        # floor restore: a dead replica must come back NOW — no confirm
        # streak, and a cooldown from a prior hot/cold action does not
        # delay it (the bench kills a member and times this). Repeat
        # restores ARE spaced by cooldown_s though: freshly-spawned
        # replicas take seconds to register, and re-spawning on every
        # poll until they do is a spawn storm, not a recovery.
        if n < cfg.min_replicas:
            if self.last_floor_restore_ts and \
                    now - self.last_floor_restore_ts < cfg.cooldown_s:
                return Decision("hold", "floor_restore_pending")
            self.last_floor_restore_ts = now
            self.last_action_ts = now
            return Decision("scale_out", "below_min_floor",
                            count=cfg.min_replicas - n)
        if hot and self.hot_confirmed:
            if n >= cfg.max_replicas:
                return Decision("hold", "hot_at_max")
            if self.in_cooldown(now):
                return Decision("hold", "cooldown")
            self.fired_hot(now)
            return Decision(
                "scale_out", "sustained_hot",
                count=min(cfg.scale_out_step, cfg.max_replicas - n))
        if cold and self.cold_confirmed:
            if n <= cfg.min_replicas:
                return Decision("hold", "cold_at_min")
            if self.in_cooldown(now):
                return Decision("hold", "cooldown")
            victim = self.least_loaded(snap)
            if victim is None:
                return Decision("hold", "no_drainable_replica")
            self.fired_cold(now)
            return Decision("scale_in", "sustained_cold",
                            target=victim.name)
        if hot:
            return Decision("hold", "hot_unconfirmed")
        if cold:
            return Decision("hold", "cold_unconfirmed")
        return Decision("hold", "steady")

    def state(self) -> Dict[str, Any]:
        return dict(self.gate_state(),
                    last_floor_restore_ts=self.last_floor_restore_ts)


class HookActuator:
    """Pluggable actuation for test harnesses and in-process benches:
    ``spawn_fn(count)`` boots replicas, ``drain_fn(member_name)`` drains
    one. Either raising marks the actuation failed (backoff + blocked
    journal record)."""

    def __init__(self, spawn_fn: Callable[[int], Any],
                 drain_fn: Callable[[str], Any]) -> None:
        self.spawn_fn = spawn_fn
        self.drain_fn = drain_fn

    def spawn(self, count: int) -> None:
        self.spawn_fn(count)

    def drain(self, target: str) -> None:
        self.drain_fn(target)


class VisorActuator:
    """Production actuation: spawn replicas through registered
    jubavisors (round-robin, like ``jubactl -c start``), drain through
    the member's own drain RPC (``stop_after=True`` so the
    supervised child exits and its port recycles)."""

    def __init__(self, coord: Coordinator, engine: str, name: str,
                 server_argv: Optional[Dict[str, Any]] = None,
                 timeout: float = 10.0) -> None:
        self.coord = coord
        self.engine = engine
        self.name = name
        self.server_argv = dict(server_argv or {})
        #: replicas spawned with --store-dir warm-boot from
        #: the shared model store instead of cold-joining — scale-out
        #: recovery is bounded by snapshot download, not re-training
        self.warm_spawn = bool(self.server_argv.get("store_dir"))
        self.timeout = timeout
        self._rr = 0  # round-robin cursor over visors

    def _visors(self) -> List[NodeInfo]:
        out = []
        for child in self.coord.list(membership.SUPERVISOR_BASE):
            try:
                out.append(NodeInfo.from_name(child))
            except (ValueError, IndexError):
                continue
        return out

    def spawn(self, count: int) -> None:
        from jubatus_tpu_torch.rpc.client import RpcClient

        visors = self._visors()
        if not visors:
            raise RuntimeError("no jubavisor registered to spawn on")
        target = f"{self.engine}/{self.name}"
        if self.warm_spawn:
            log.info("spawning %d replica(s) with --store-dir: they will "
                     "warm-boot from the shared model store", count)
        for i in range(int(count)):
            visor = visors[(self._rr + i) % len(visors)]
            with RpcClient(visor.host, visor.port,
                           timeout=self.timeout) as c:
                rc = c.call("start", target, 1, self.server_argv)
            if rc != 0:
                raise RuntimeError(
                    f"jubavisor {visor.name} start returned {rc}")
        self._rr += count

    def drain(self, target: str) -> None:
        from jubatus_tpu_torch.rpc.client import RpcClient

        node = NodeInfo.from_name(target)
        with RpcClient(node.host, node.port, timeout=self.timeout) as c:
            c.call("drain", self.name, True)


class Autoscaler(ControllerLoop):
    """The control loop: poll → decide → actuate → journal.

    ``tick()`` runs one cycle (tests and ``--once`` call it directly);
    ``start()`` runs it on a daemon thread every ``poll_interval_s``;
    ``serve()`` additionally exposes ``get_autoscale_status`` over RPC
    and registers under ``/jubatus/autoscalers`` for the watch view.
    The journal/eventing/backoff machinery is the shared
    :class:`ControllerLoop` (coord/controller.py)."""

    subsystem = "autoscale"

    def __init__(self, coord: Coordinator, engine: str, name: str,
                 actuator: Any, config: Optional[AutoscaleConfig] = None,
                 registry: Optional[Registry] = None,
                 poller: Optional[Callable[..., FleetSnapshot]] = None
                 ) -> None:
        self.config = (config or AutoscaleConfig()).validate()
        ControllerLoop.__init__(self, self.config.journal_capacity,
                                registry)
        self.coord = coord
        self.engine = engine
        self.name = name
        self.actuator = actuator
        self.core = AutoscalerCore(self.config)
        self._poller = poller
        self.last_snapshot: Optional[FleetSnapshot] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.rpc = None
        self.start_time = time.time()  # wall-clock

    # -- ControllerLoop hooks ------------------------------------------------
    def _counter_suffix(self, action: str,
                        extra: Dict[str, Any]) -> Optional[str]:
        return {"scale_out": "spawns", "scale_in": "drains",
                "blocked": "blocked"}.get(action)

    def _event_fields(self, signals: Dict[str, Any],
                      extra: Dict[str, Any]) -> Dict[str, Any]:
        return {"target": extra.get("target") or None,
                "count": extra.get("count") or None,
                "dry_run": extra.get("dry_run") or None,
                "replicas": signals["replicas"]}

    def _gauge_signals(self, signals: Dict[str, Any]) -> None:
        self.registry.gauge("autoscale.replicas",
                            float(signals["replicas"]))
        self.registry.gauge("autoscale.burn_max", signals["burn_max"])
        self.registry.gauge("autoscale.queue_per_replica",
                            signals["queue_per_replica"])

    def _on_actuation_failure(self) -> None:
        # a failed actuation must not start the cooldown clock (or
        # the floor-restore spacing) — the retry after backoff
        # would otherwise wait both out
        self.core.reset_clock()
        self.core.last_floor_restore_ts = 0.0

    def _backoff_bounds(self):
        return self.config.backoff_initial_s, self.config.backoff_max_s

    # -- journal -------------------------------------------------------------
    def _record(self, action: str, reason: str, snap: FleetSnapshot,
                now: float, **extra: Any) -> Dict[str, Any]:
        return self.record(action, reason, snap.signals(), now, **extra)

    # -- actuation (fault sites + backoff live in ControllerLoop) ------------
    def _actuate(self, decision: Decision, snap: FleetSnapshot,
                 now: float) -> Dict[str, Any]:
        site = "autoscale.spawn" if decision.action == "scale_out" \
            else "autoscale.drain"
        if decision.action == "scale_out":
            fn = lambda: self.actuator.spawn(decision.count)  # noqa: E731
        else:
            fn = lambda: self.actuator.drain(decision.target)  # noqa: E731
        ok, blocked = self.guarded(
            site, fn, reason=decision.reason, signals=snap.signals(),
            now=now, wanted=decision.action, target=decision.target,
            count=decision.count)
        if not ok:
            return blocked
        extra: Dict[str, Any] = {}
        if decision.action == "scale_out" and \
                getattr(self.actuator, "warm_spawn", False):
            # the journal/timeline distinguishes warm scale-out
            # (replicas boot from the shared store) from cold
            extra["warm_spawn"] = True
        return self._record(decision.action, decision.reason, snap, now,
                            target=decision.target, count=decision.count,
                            dry_run=False, **extra)

    # -- one control cycle ---------------------------------------------------
    def tick(self, snap: Optional[FleetSnapshot] = None,
             now: Optional[float] = None) -> Dict[str, Any]:
        if snap is None:
            poller = self._poller or poll_fleet
            snap = poller(self.coord, self.engine, self.name,
                          window_s=self.config.window_s)
        now = snap.ts if now is None else float(now)
        self.last_snapshot = snap
        decision = self.core.observe(snap, now=now)
        if decision.action == "hold":
            return self._record("hold", decision.reason, snap, now)
        if self.in_backoff(now):
            # intent survives (streaks rebuilt next tick), attempt
            # suppressed: this is the "never hot-loop" half of backoff
            self.core.reset_clock()
            return self._record(
                "hold", "backoff", snap, now, wanted=decision.action,
                backoff_remaining_s=round(self.backoff_until - now, 3))
        if self.config.dry_run:
            return self._record(
                decision.action, decision.reason, snap, now,
                target=decision.target, count=decision.count,
                dry_run=True)
        return self._actuate(decision, snap, now)

    # -- status / RPC --------------------------------------------------------
    def status(self, last: int = 32) -> Dict[str, Any]:
        tail = self.journal_tail(last)
        doc: Dict[str, Any] = {
            "engine": self.engine, "name": self.name,
            "uptime_s": int(time.time() - self.start_time),  # wall-clock
            "config": dataclasses.asdict(self.config),
            "state": dict(self.core.state(), **self.backoff_state()),
            "counters": {k: v for k, v in self.registry.counters().items()
                         if k.startswith("autoscale.")},
            "gauges": {k: v for k, v in self.registry.gauges().items()
                       if k.startswith("autoscale.")},
            "journal": tail,
        }
        if self.last_snapshot is not None:
            doc["fleet"] = self.last_snapshot.signals()
            doc["replicas"] = [dataclasses.asdict(r)
                               for r in self.last_snapshot.replicas]
        return doc

    def get_autoscale_status(self, _name: str = "",
                             last: int = 32) -> Dict[str, Any]:
        """RPC surface: the status doc keyed like get_status (one map
        entry per autoscaler node)."""
        port = self.rpc.port if self.rpc is not None else 0
        me = NodeInfo("127.0.0.1", port or 0)
        return {me.name: self.status(last=int(last or 32))}

    # -- lifecycle -----------------------------------------------------------
    def serve(self, port: int = 0, host: str = "127.0.0.1") -> int:
        """Serve ``get_autoscale_status`` and register under
        ``/jubatus/autoscalers`` so the watch view finds us."""
        from jubatus_tpu_torch.rpc.server import RpcServer

        self.rpc = RpcServer()
        self.rpc.register("get_autoscale_status", self.get_autoscale_status,
                          arity=2)
        actual = self.rpc.serve_background(port, host=host)
        membership.register_autoscaler(self.coord, host, actual)
        return actual

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="autoscaler")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.config.poll_interval_s):
            try:
                self.tick()
            except Exception:  # broad-ok — the loop must survive a bad poll
                log.warning("autoscaler tick failed", exc_info=True)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if self.rpc is not None:
            try:
                self.rpc.stop()
            except Exception:  # broad-ok — teardown
                pass
            self.rpc = None
