"""Self-tuning performance plane (copy of
``jubatus_tpu/coord/perf_tuner.py``): close the loop from telemetry to
knobs.

Rides the shared controller core (coord/controller.py, the machinery
the autoscaler uses) and points it at three knob families:

- **mix plane** (:class:`MixPlanCore`): picks the wire mode
  (``off|bf16|int8``) and psum chunk size per process by hill-climbing
  on the MEASURED round time, with the measured ship fraction ordering
  the probes (a ship-dominated round tries the compression ladder first)
  and ``mix.ef_residual_drift_rate`` as the int8 guardrail (drifting
  residuals blacklist int8 and step back to bf16). Actuation is
  ``CollectiveMixer.set_wire_plan``: the plan rides the prepare
  signature, so a fleet applying a change non-simultaneously falls back
  to the RPC mix for at most one round per transition — never a wedged
  collective.
- **coalescer** (:class:`CoalescerCore`): adapts each microbatch
  queue's ``max_batch`` to the trailing arrival rate via a Little's-law
  residency target (depth ≈ arrival × target residency), bounded
  multiplicative steps, never below 1.
- **async-mix cadence** (:class:`CadenceCore`): speeds fold ticks when
  ``mix.premix_divergence_max`` runs hot, relaxes them when quiescent,
  inside an operator-set floor/ceiling.

All three run off the server's telemetry tick, journal every decision
through :class:`~jubatus_tpu_torch.coord.controller.ControllerLoop`
(evented, timeline-visible, ``jubactl -c tune`` renders state +
journal), and obey the ``--auto-tune {off,observe,on}`` ladder —
``observe`` journals dry-run recommendations without touching a knob.
Actuations run through the fault sites ``tune.{mix,coalescer,cadence}
.apply``; a failing apply journals ``blocked`` and backs off
exponentially, and because cores advance their internal plan only on
COMMIT (after a successful apply), a failed actuation never leaves the
tuner's belief diverged from the fleet's actual knobs.

Every knob default lives in :data:`TUNER_DEFAULTS`. The decisions,
reasons and journal records are the JAX package's, step for step.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from jubatus_tpu_torch.coord.controller import ControllerLoop, StreakGate
from jubatus_tpu_torch.utils.tracing import Registry

log = logging.getLogger(__name__)

__all__ = ["TUNER_DEFAULTS", "TunerConfig", "MixPlanCore", "CoalescerCore",
           "CadenceCore", "PerfTuner", "ServerTuneAdapter"]

#: THE defaults table: every tuner-actuated knob's ladder, bound, and
#: step lives here. Values are the
#: TunerConfig defaults; flags/config override per fleet.
TUNER_DEFAULTS: Dict[str, Any] = {
    # mix plane
    "chunk_ladder_mb": (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0),
    "wire_ladder": ("off", "bf16", "int8"),
    "improve_margin": 0.05,     # a move must win by 5% to displace best
    "settle_rounds": 2,         # rounds measured before judging a plan
    "ef_drift_max": 1e-3,       # int8 guardrail: residual norm growth/round
    # coalescer (Little's law: depth = arrival_rate x residency target)
    "residency_target_s": 0.05,
    "depth_floor": 1,
    "depth_ceiling": 65536,
    "depth_step_max": 2.0,      # max multiplicative step per decision
    "depth_band": 0.5,          # dead band: act only past +/-50% deviation
    # async-mix cadence
    "interval_floor_s": 1.0,
    "interval_ceiling_s": 120.0,
    "cadence_step": 2.0,        # halve/double per decision
    "divergence_hot": 0.25,
    "divergence_cold": 0.02,
    # controller
    "confirm": 2,
    "cooldown_s": 30.0,
    "backoff_initial_s": 2.0,
    "backoff_max_s": 60.0,
    "journal_capacity": 256,
}


@dataclass
class TunerConfig:
    """--auto-tune configuration. ``mode``: ``off`` (tuner absent),
    ``observe`` (journal recommendations, touch nothing), ``on``
    (actuate). Everything else defaults from :data:`TUNER_DEFAULTS`."""

    mode: str = "off"
    confirm: int = TUNER_DEFAULTS["confirm"]
    cooldown_s: float = TUNER_DEFAULTS["cooldown_s"]
    backoff_initial_s: float = TUNER_DEFAULTS["backoff_initial_s"]
    backoff_max_s: float = TUNER_DEFAULTS["backoff_max_s"]
    journal_capacity: int = TUNER_DEFAULTS["journal_capacity"]
    chunk_ladder: Tuple[float, ...] = TUNER_DEFAULTS["chunk_ladder_mb"]
    wire_ladder: Tuple[str, ...] = TUNER_DEFAULTS["wire_ladder"]
    improve_margin: float = TUNER_DEFAULTS["improve_margin"]
    settle_rounds: int = TUNER_DEFAULTS["settle_rounds"]
    ef_drift_max: float = TUNER_DEFAULTS["ef_drift_max"]
    residency_target_s: float = TUNER_DEFAULTS["residency_target_s"]
    depth_floor: int = TUNER_DEFAULTS["depth_floor"]
    depth_ceiling: int = TUNER_DEFAULTS["depth_ceiling"]
    depth_step_max: float = TUNER_DEFAULTS["depth_step_max"]
    depth_band: float = TUNER_DEFAULTS["depth_band"]
    interval_floor_s: float = TUNER_DEFAULTS["interval_floor_s"]
    interval_ceiling_s: float = TUNER_DEFAULTS["interval_ceiling_s"]
    cadence_step: float = TUNER_DEFAULTS["cadence_step"]
    divergence_hot: float = TUNER_DEFAULTS["divergence_hot"]
    divergence_cold: float = TUNER_DEFAULTS["divergence_cold"]

    def __post_init__(self) -> None:
        if self.mode not in ("off", "observe", "on"):
            raise ValueError(f"auto-tune mode must be off|observe|on, "
                             f"got {self.mode!r}")
        if self.interval_floor_s > self.interval_ceiling_s:
            raise ValueError("tune interval floor exceeds ceiling")
        if self.depth_floor < 1:
            raise ValueError("depth floor must be >= 1")


Plan = Tuple[str, float]  # (wire mode, chunk MB)


class MixPlanCore:
    """Pure hill-climb over the (wire mode, chunk MB) plan grid, scored
    by measured round milliseconds, so the tuned fleet converges toward
    the measured optimum instead of a proxy's.

    Propose-then-commit: ``observe()`` returns a proposal; the owner
    actuates it and calls ``commit()`` only on success. A failed apply
    (or observe mode) therefore never advances this core's belief about
    the live plan. ``observe()`` folds ``settle_rounds`` round times
    into one median score per plan, probes the unscored neighbors of
    the best-known plan (wire moves first when the round is
    ship-dominated — the wire is the bottleneck),
    and settles on the best plan once the neighborhood is exhausted.
    The EF-drift guardrail blacklists int8 the moment residual norms
    grow faster than ``ef_drift_max`` per round and steps back down the
    wire ladder."""

    def __init__(self, cfg: TunerConfig, mode: str = "off",
                 chunk_mb: float = 8.0) -> None:
        self.cfg = cfg
        self.plan: Plan = (mode, float(chunk_mb))
        #: plan -> best settled median round ms
        self.scores: Dict[Plan, float] = {}
        self._samples: List[float] = []
        self.int8_blacklisted = False
        self.trials = 0
        self.converged = False

    # -- internals -----------------------------------------------------------
    def _wires(self) -> List[str]:
        return [w for w in self.cfg.wire_ladder
                if not (self.int8_blacklisted and w == "int8")]

    def _neighbors(self, plan: Plan,
                   ship_frac: Optional[float]) -> List[Plan]:
        mode, chunk = plan
        wires = self._wires()
        ladder = list(self.cfg.chunk_ladder)
        wire_moves: List[Plan] = []
        if mode in wires:
            wi = wires.index(mode)
            if wi + 1 < len(wires):
                wire_moves.append((wires[wi + 1], chunk))
            if wi > 0:
                wire_moves.append((wires[wi - 1], chunk))
        elif wires:
            wire_moves.append((wires[0], chunk))
        chunk_moves: List[Plan] = []
        if chunk in ladder:
            ci = ladder.index(chunk)
            if ci + 1 < len(ladder):
                chunk_moves.append((mode, ladder[ci + 1]))
            if ci > 0:
                chunk_moves.append((mode, ladder[ci - 1]))
        else:
            # operator started off-ladder (env override): probe the
            # nearest rungs in each direction
            up = [c for c in ladder if c > chunk]
            dn = [c for c in ladder if c < chunk]
            if up:
                chunk_moves.append((mode, up[0]))
            if dn:
                chunk_moves.append((mode, dn[-1]))
        if ship_frac is not None and ship_frac >= 0.5:
            return wire_moves + chunk_moves
        return chunk_moves + wire_moves

    def best(self) -> Optional[Plan]:
        if not self.scores:
            return None
        return min(self.scores, key=lambda p: self.scores[p])

    def _next_probe(self, ship_frac: Optional[float]) -> Optional[Plan]:
        best = self.best()
        if best is None:
            return None
        for nb in self._neighbors(best, ship_frac):
            if nb not in self.scores:
                return nb
        return None

    # -- the decision step ---------------------------------------------------
    def observe(self, round_ms: float, ef_drift: Optional[float] = None,
                ship_frac: Optional[float] = None
                ) -> Optional[Dict[str, Any]]:
        """Fold one measured round; return a proposal dict
        ``{action, plan, reason}`` or None (hold)."""
        cfg = self.cfg
        mode, chunk = self.plan
        if mode == "int8" and ef_drift is not None \
                and ef_drift > cfg.ef_drift_max:
            # guardrail: quantization error is accumulating faster than
            # error feedback telescopes it away — int8 is off the table
            # until restart, and the plan steps back down the wire ladder
            self.int8_blacklisted = True
            self.scores = {p: s for p, s in self.scores.items()
                           if p[0] != "int8"}
            self._samples = []
            self.converged = False
            wires = self._wires()
            fallback = wires[-1] if wires else "off"
            return {"action": "retune", "plan": (fallback, chunk),
                    "reason": "ef_drift_guardrail"}
        self._samples.append(float(round_ms))
        if len(self._samples) < cfg.settle_rounds:
            return None
        score = sorted(self._samples)[len(self._samples) // 2]
        self._samples = []
        prev = self.scores.get(self.plan)
        self.scores[self.plan] = score if prev is None else min(prev, score)
        probe = self._next_probe(ship_frac)
        if probe is not None:
            return {"action": "probe", "plan": probe, "reason": "hill_climb"}
        best = self.best()
        self.converged = True
        if best is not None and best != self.plan and \
                self.scores[self.plan] > \
                self.scores[best] * (1.0 + cfg.improve_margin):
            return {"action": "retune", "plan": best,
                    "reason": "settle_on_best"}
        return None

    def commit(self, plan: Plan) -> None:
        """The proposal was successfully actuated: advance the belief.
        New plan, fresh sample window; probing may resume (a commit can
        open an unscored neighborhood)."""
        self.plan = (plan[0], float(plan[1]))
        self._samples = []
        self.trials += 1
        self.converged = False

    def state(self) -> Dict[str, Any]:
        best = self.best()
        return {"wire": self.plan[0], "chunk_mb": self.plan[1],
                "trials": self.trials, "converged": self.converged,
                "int8_blacklisted": self.int8_blacklisted,
                "plans_scored": len(self.scores),
                "best_wire": best[0] if best else None,
                "best_chunk_mb": best[1] if best else None,
                "best_ms": round(self.scores[best], 3) if best else None}


class CoalescerCore(StreakGate):
    """Little's-law depth controller for one microbatch queue: target
    depth ≈ arrival rate × residency target, a dead band suppresses
    noise, steps are bounded multiplicatively, and the floor is never
    below 1 (a zero depth would wedge every submit). Idle queues
    (arrival 0) hold — shrinking an idle queue's depth would punish the
    next burst for the quiet period."""

    def __init__(self, cfg: TunerConfig) -> None:
        StreakGate.__init__(self, cfg.confirm, cfg.confirm, cfg.cooldown_s)
        self.cfg = cfg

    def observe(self, now: float, arrival_per_sec: float,
                depth: int) -> Optional[Dict[str, Any]]:
        cfg = self.cfg
        target = arrival_per_sec * cfg.residency_target_s
        target = min(max(target, float(cfg.depth_floor)),
                     float(cfg.depth_ceiling))
        hot = target > depth * (1.0 + cfg.depth_band)
        cold = arrival_per_sec > 0.0 and \
            target < depth * (1.0 - cfg.depth_band) and \
            depth > cfg.depth_floor
        self.step(hot, cold)
        if self.in_cooldown(now):
            return None
        if hot and self.hot_confirmed:
            new = int(round(min(target, depth * cfg.depth_step_max)))
            new = max(1, min(new, cfg.depth_ceiling))
            if new <= depth:
                return None
            self.fired_hot(now)
            return {"action": "deepen", "depth": new,
                    "target": round(target, 1)}
        if cold and self.cold_confirmed:
            new = int(round(max(target, depth / cfg.depth_step_max)))
            new = max(1, cfg.depth_floor, new)
            if new >= depth:
                return None
            self.fired_cold(now)
            return {"action": "shallow", "depth": new,
                    "target": round(target, 1)}
        return None


class CadenceCore(StreakGate):
    """Async-mix cadence controller: fold faster while replicas diverge
    (``mix.premix_divergence_max`` hot), relax toward the ceiling when
    quiescent — inside the operator's floor/ceiling."""

    def __init__(self, cfg: TunerConfig) -> None:
        StreakGate.__init__(self, cfg.confirm, cfg.confirm, cfg.cooldown_s)
        self.cfg = cfg

    def observe(self, now: float, divergence: float,
                interval_sec: float) -> Optional[Dict[str, Any]]:
        cfg = self.cfg
        hot = divergence >= cfg.divergence_hot
        cold = divergence <= cfg.divergence_cold
        self.step(hot, cold)
        if self.in_cooldown(now):
            return None
        if hot and self.hot_confirmed and \
                interval_sec > cfg.interval_floor_s:
            new = max(cfg.interval_floor_s,
                      interval_sec / cfg.cadence_step)
            self.fired_hot(now)
            return {"action": "quicken", "interval_sec": round(new, 3),
                    "divergence": round(divergence, 6)}
        if cold and self.cold_confirmed and \
                interval_sec < cfg.interval_ceiling_s:
            new = min(cfg.interval_ceiling_s,
                      interval_sec * cfg.cadence_step)
            self.fired_cold(now)
            return {"action": "relax", "interval_sec": round(new, 3),
                    "divergence": round(divergence, 6)}
        return None


class PerfTuner(ControllerLoop):
    """The assembled loop: reads signals through an adapter (so tests
    and the regret bench drive it with synthetic fleets), runs the three
    cores, and actuates through the ``tune.*.apply`` fault sites with
    the shared journal/event/backoff discipline.

    The adapter duck-type::

        mix_signals()       -> dict | None   (rounds, round_ms, wire,
                                              chunk_mb, ef_drift, ship_frac)
        apply_mix(wire, chunk_mb)
        coalescer_signals() -> [dict]        (name, arrival_per_sec, depth)
        apply_coalescer(name, depth)
        cadence_signals()   -> dict | None   (divergence, interval_sec)
        apply_cadence(interval_sec)

    ``apply_*`` raise on failure; signal readers return None/[] when the
    corresponding plane does not exist on this server."""

    subsystem = "tune"

    def __init__(self, config: TunerConfig, adapter: Any,
                 registry: Optional[Registry] = None,
                 clock: Any = time.monotonic) -> None:
        ControllerLoop.__init__(self, config.journal_capacity, registry)
        self.config = config
        self.adapter = adapter
        self._clock = clock
        #: lazily seeded from the first mix signal (needs the live plan)
        self.mix: Optional[MixPlanCore] = None
        self.coalescers: Dict[str, CoalescerCore] = {}
        self.cadence = CadenceCore(config)
        self._last_mix_rounds = -1

    # -- ControllerLoop hooks ------------------------------------------------
    def _counter_suffix(self, action: str,
                        extra: Dict[str, Any]) -> Optional[str]:
        if action == "blocked":
            return "blocked"
        if action != "hold":
            return "applies"
        return None

    def _event_fields(self, signals: Dict[str, Any],
                      extra: Dict[str, Any]) -> Dict[str, Any]:
        return {"target": extra.get("target"),
                "dry_run": extra.get("dry_run") or None,
                "wire": signals.get("wire"),
                "chunk_mb": signals.get("chunk_mb"),
                "depth": signals.get("depth"),
                "interval_sec": signals.get("interval_sec")}

    def _gauge_signals(self, signals: Dict[str, Any]) -> None:
        v = signals.get("chunk_mb")
        if isinstance(v, (int, float)):
            self.registry.gauge("tune.mix.chunk_mb", float(v))
        w = signals.get("wire")
        if isinstance(w, str) and w in self.config.wire_ladder:
            # numeric so the time-series ring and SLO grammar can ride
            # it: the wire ladder index (0=off, 1=bf16, 2=int8)
            self.registry.gauge("tune.mix.wire_mode",
                                float(self.config.wire_ladder.index(w)))
        v = signals.get("depth")
        if isinstance(v, (int, float)):
            self.registry.gauge("tune.coalescer.max_batch", float(v))
        v = signals.get("interval_sec")
        if isinstance(v, (int, float)):
            self.registry.gauge("tune.cadence.interval_s", float(v))

    def _backoff_bounds(self) -> Tuple[float, float]:
        return self.config.backoff_initial_s, self.config.backoff_max_s

    # -- the tick ------------------------------------------------------------
    @property
    def dry_run(self) -> bool:
        return self.config.mode == "observe"

    def tick(self, now: Optional[float] = None) -> None:
        """One pass over all three planes; rides the server's telemetry
        tick. Never raises — a sick adapter must not kill the telemetry
        thread that owns every other periodic plane."""
        if self.config.mode == "off":
            return
        now = self._clock() if now is None else now
        if self.in_backoff(now):
            return
        for step in (self._tick_mix, self._tick_coalescers,
                     self._tick_cadence):
            try:
                step(now)
            except Exception:  # broad-ok — see docstring
                log.warning("perf tuner %s failed", step.__name__,
                            exc_info=True)
            if self.in_backoff(now):
                # an actuation just failed: stand down for the rest of
                # the tick instead of moving more knobs (a later success
                # would also clear the backoff the failure just armed)
                return

    def _tick_mix(self, now: float) -> None:
        sig = self.adapter.mix_signals()
        if not sig:
            return
        rounds = int(sig.get("rounds", 0))
        if rounds <= self._last_mix_rounds:
            return  # no new round measured since the last tick
        first = self._last_mix_rounds < 0
        self._last_mix_rounds = rounds
        if self.mix is None:
            self.mix = MixPlanCore(self.config,
                                   mode=sig.get("wire", "off"),
                                   chunk_mb=float(sig.get("chunk_mb", 8.0)))
        if first:
            return  # anchor only; the next round yields a clean sample
        proposal = self.mix.observe(float(sig.get("round_ms", 0.0)),
                                    ef_drift=sig.get("ef_drift"),
                                    ship_frac=sig.get("ship_frac"))
        if proposal is None:
            return
        wire, chunk = proposal["plan"]
        signals = {"round_ms": round(float(sig.get("round_ms", 0.0)), 3),
                   "wire": wire, "chunk_mb": chunk,
                   "from_wire": self.mix.plan[0],
                   "from_chunk_mb": self.mix.plan[1]}
        if self.dry_run:
            self.record(proposal["action"], proposal["reason"], signals,
                        now, dry_run=True, target="mix")
            return
        ok, _ = self.guarded(
            "tune.mix.apply",
            lambda: self.adapter.apply_mix(wire, chunk),
            reason=proposal["reason"], signals=signals, now=now,
            wanted=proposal["action"], target="mix")
        if ok:
            self.mix.commit((wire, chunk))
            self.record(proposal["action"], proposal["reason"], signals,
                        now, target="mix")

    def _tick_coalescers(self, now: float) -> None:
        for sig in self.adapter.coalescer_signals() or []:
            name = sig["name"]
            core = self.coalescers.get(name)
            if core is None:
                core = self.coalescers[name] = CoalescerCore(self.config)
            decision = core.observe(now,
                                    float(sig.get("arrival_per_sec", 0.0)),
                                    int(sig.get("depth", 1)))
            if decision is None:
                continue
            signals = {"coalescer": name, "depth": decision["depth"],
                       "from_depth": int(sig.get("depth", 1)),
                       "target": decision["target"],
                       "arrival_per_sec":
                           round(float(sig.get("arrival_per_sec", 0.0)), 1)}
            if self.dry_run:
                self.record(decision["action"], "littles_law", signals,
                            now, dry_run=True, target=name)
                continue
            depth = decision["depth"]
            ok, _ = self.guarded(
                "tune.coalescer.apply",
                lambda d=depth, n=name: self.adapter.apply_coalescer(n, d),
                reason="littles_law", signals=signals, now=now,
                wanted=decision["action"], target=name)
            if ok:
                self.record(decision["action"], "littles_law", signals,
                            now, target=name)

    def _tick_cadence(self, now: float) -> None:
        sig = self.adapter.cadence_signals()
        if not sig:
            return
        decision = self.cadence.observe(
            now, float(sig.get("divergence", 0.0)),
            float(sig.get("interval_sec", 0.0)))
        if decision is None:
            return
        signals = {"interval_sec": decision["interval_sec"],
                   "from_interval_sec":
                       round(float(sig.get("interval_sec", 0.0)), 3),
                   "divergence": decision["divergence"]}
        if self.dry_run:
            self.record(decision["action"], "divergence_band", signals,
                        now, dry_run=True, target="cadence")
            return
        sec = decision["interval_sec"]
        ok, _ = self.guarded(
            "tune.cadence.apply",
            lambda: self.adapter.apply_cadence(sec),
            reason="divergence_band", signals=signals, now=now,
            wanted=decision["action"], target="cadence")
        if ok:
            self.record(decision["action"], "divergence_band", signals,
                        now, target="cadence")

    # -- status --------------------------------------------------------------
    def status(self, last: int = 16) -> Dict[str, Any]:
        st: Dict[str, Any] = {"mode": self.config.mode}
        st.update(self.backoff_state())
        if self.mix is not None:
            st["mix"] = self.mix.state()
        if self.coalescers:
            st["coalescers"] = {n: c.gate_state()
                                for n, c in self.coalescers.items()}
        st["cadence"] = self.cadence.gate_state()
        st["journal"] = self.journal_tail(last)
        return st


class ServerTuneAdapter:
    """The production adapter: reads signals straight off an
    EngineServer's mixer/coalescers/registry and actuates the real
    knobs. Every reader degrades to None/[] when the plane is absent
    (standalone servers have no mixer; query-only servers may have no
    train coalescer)."""

    def __init__(self, server: Any) -> None:
        self._server = server

    # -- mix plane -----------------------------------------------------------
    def mix_signals(self) -> Optional[Dict[str, Any]]:
        mixer = getattr(self._server, "mixer", None)
        if mixer is None or not hasattr(mixer, "set_wire_plan"):
            return None
        sched = getattr(mixer, "_scheduler", None)
        if sched is None or sched.mix_count <= 0:
            return None
        from jubatus_tpu_torch.parallel.collective import (DEFAULT_CHUNK_MB,
                                                     _norm_compress)

        phases = getattr(mixer, "last_phases", None) or {}
        ship_frac = None
        ship = phases.get("ship_ms")
        total = sum(float(phases.get(k) or 0.0)
                    for k in ("ship_ms", "reduce_ms", "readback_ms"))
        if isinstance(ship, (int, float)) and total > 0:
            ship_frac = float(ship) / total
        gauges = self._server.rpc.trace.gauges()
        chunk = mixer.chunk_mb
        return {
            "rounds": int(sched.mix_count),
            "round_ms": float(sched.last_mix_duration) * 1e3,
            "wire": _norm_compress(mixer.compress),
            "chunk_mb": float(DEFAULT_CHUNK_MB if chunk is None else chunk),
            "ef_drift": gauges.get("mix.ef_residual_drift_rate"),
            "ship_frac": ship_frac,
        }

    def apply_mix(self, wire: str, chunk_mb: float) -> None:
        self._server.mixer.set_wire_plan(chunk_mb=chunk_mb, compress=wire)

    # -- coalescer plane -----------------------------------------------------
    def coalescer_signals(self) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for name, co in (getattr(self._server, "coalescers", None)
                         or {}).items():
            if not (hasattr(co, "arrival_per_sec")
                    and hasattr(co, "set_max_batch")):
                continue
            out.append({"name": name,
                        "arrival_per_sec": co.arrival_per_sec(),
                        "depth": co.max_batch})
        return out

    def apply_coalescer(self, name: str, depth: int) -> None:
        co = (getattr(self._server, "coalescers", None) or {})[name]
        co.set_max_batch(depth)

    # -- cadence plane -------------------------------------------------------
    def cadence_signals(self) -> Optional[Dict[str, Any]]:
        mixer = getattr(self._server, "mixer", None)
        sched = getattr(mixer, "_scheduler", None)
        if sched is None:
            return None
        div = self._server.rpc.trace.gauges().get(
            "mix.premix_divergence_max")
        if div is None:
            return None
        return {"divergence": float(div),
                "interval_sec": float(sched.interval_sec)}

    def apply_cadence(self, interval_sec: float) -> None:
        self._server.mixer._scheduler.set_interval(interval_sec)
