"""Declarative SLOs evaluated as multi-window burn rates (copy of
``jubatus_tpu/utils/slo.py``).

An SLO here is "at most ``objective`` of events may be bad"; the **burn
rate** over a window is ``bad_fraction / objective`` — burn 1.0 means
the error budget is being spent exactly as fast as it accrues, burn N
means N× too fast (Google SRE workbook, ch. 5). An alert **fires** only
when BOTH a fast and a slow window burn above the threshold: the slow
window keeps one latency blip from paging, the fast window makes the
alert clear quickly once the burst ends (the classic multi-window
multi-burn construction, with one burn threshold instead of the
four-pair ladder — operators tune windows/threshold via flags).

Spec grammar (``--slo``, repeatable; parsed by :func:`parse_slo`):

- ``latency:<span>:p<QQ>:<threshold_ms>[:<objective>]`` — bad event =
  a ``<span>`` request at/above ``threshold_ms``; the p<QQ> names the
  intent (p99 → objective 0.01, p90 → 0.10, ...) and doubles as the
  default objective. Example: ``latency:rpc.classify:p99:50``.
- ``error_rate:<span|*>:<objective>`` — bad event = a dispatch of
  ``<span>`` that raised (the ``rpc.<m>.errors`` counters); ``*`` sums
  every ``rpc.*`` span. Example: ``error_rate:*:0.01``.
- ``gauge:<key>:<ceiling>`` — burn = windowed mean of gauge ``<key>``
  divided by ``ceiling`` (for signals that are levels, not event
  streams: ``mix.ef_residual_drift_rate``, quantization drift, queue
  depths). Example: ``gauge:mix.ef_residual_drift_rate:0.05``.

Any spec may carry a ``name=`` prefix (``hot=latency:rpc.train:p99:20``)
— otherwise the name derives from the fields. Evaluation runs on the
runtime-telemetry sampler tick against the process's TimeSeriesRing
(utils/timeseries.py); results surface as ``slo.<name>.burn_fast`` /
``burn_slow`` / ``firing`` gauges on ``/metrics``, degrade ``/healthz``,
and list under ``jubactl -c alerts`` via the ``get_alerts`` RPC.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, List, Optional

from jubatus_tpu_torch.utils.timeseries import TimeSeriesRing, Window
from jubatus_tpu_torch.utils.tracing import Registry

log = logging.getLogger(__name__)

#: default multi-window pair (seconds): 5 min confirms the burst is
#: current, 1 h proves it is significant
DEFAULT_FAST_WINDOW = 300.0
DEFAULT_SLOW_WINDOW = 3600.0
#: default burn-rate threshold: fire at 2x budget spend
DEFAULT_BURN_THRESHOLD = 2.0

KINDS = ("latency", "error_rate", "gauge")


@dataclasses.dataclass(frozen=True)
class SloSpec:
    name: str
    kind: str                 # latency | error_rate | gauge
    span: str                 # span name, '*' (error_rate), or gauge key
    threshold_s: float = 0.0  # latency: bad at/above this duration
    objective: float = 0.01   # allowed bad fraction (error budget)
    ceiling: float = 0.0      # gauge: burn = mean / ceiling

    def describe(self) -> str:
        if self.kind == "latency":
            return (f"latency {self.span} >= {self.threshold_s * 1e3:g} ms "
                    f"for > {self.objective:g} of requests")
        if self.kind == "error_rate":
            return f"error rate of {self.span} > {self.objective:g}"
        return f"gauge {self.span} > {self.ceiling:g}"


def parse_slo(spec: str) -> SloSpec:
    """Parse one ``--slo`` spec string; raises ValueError on bad
    grammar so servers reject misconfiguration at argv time."""
    s = spec.strip()
    name = ""
    if "=" in s.split(":", 1)[0]:
        name, s = s.split("=", 1)
        name = name.strip()
    parts = [p.strip() for p in s.split(":")]
    if not parts or parts[0] not in KINDS:
        raise ValueError(
            f"--slo {spec!r}: kind must be one of {', '.join(KINDS)}")
    kind = parts[0]
    try:
        if kind == "latency":
            if len(parts) not in (4, 5):
                raise ValueError("want latency:<span>:p<QQ>:<threshold_ms>"
                                 "[:<objective>]")
            span, pq, thr_ms = parts[1], parts[2], float(parts[3])
            if not pq.startswith("p") or not pq[1:].isdigit():
                raise ValueError(f"bad quantile {pq!r} (want pNN)")
            q = int(pq[1:])
            if not 0 < q < 100:
                raise ValueError(f"quantile p{q} out of range")
            objective = float(parts[4]) if len(parts) == 5 \
                else (100 - q) / 100.0
            if thr_ms <= 0:
                raise ValueError("threshold_ms must be > 0")
            return SloSpec(name or f"{span}.{pq}", "latency", span,
                           threshold_s=thr_ms / 1e3, objective=objective)
        if kind == "error_rate":
            if len(parts) != 3:
                raise ValueError("want error_rate:<span|*>:<objective>")
            span, objective = parts[1], float(parts[2])
            if not 0 < objective < 1:
                raise ValueError("objective must be in (0, 1)")
            return SloSpec(name or f"errors.{span}", "error_rate", span,
                           objective=objective)
        # gauge
        if len(parts) != 3:
            raise ValueError("want gauge:<key>:<ceiling>")
        span, ceiling = parts[1], float(parts[2])
        if ceiling <= 0:
            raise ValueError("ceiling must be > 0")
        return SloSpec(name or f"gauge.{span}", "gauge", span,
                       ceiling=ceiling)
    except ValueError as e:
        raise ValueError(f"--slo {spec!r}: {e}") from None


def _slug(name: str) -> str:
    """Gauge-key-safe SLO name (no '*' or whitespace on /metrics)."""
    return name.replace("*", "all").replace(" ", "_")


class SloEngine:
    """Evaluates a set of SLO specs against one TimeSeriesRing and
    publishes the verdicts into one tracing Registry."""

    def __init__(self, specs: List[SloSpec], ring: TimeSeriesRing,
                 registry: Registry, *,
                 fast_window_s: float = DEFAULT_FAST_WINDOW,
                 slow_window_s: float = DEFAULT_SLOW_WINDOW,
                 burn_threshold: float = DEFAULT_BURN_THRESHOLD) -> None:
        self.specs = list(specs)
        self.ring = ring
        self.registry = registry
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn_threshold = float(burn_threshold)
        #: per-SLO evaluated state (name -> dict); see evaluate()
        self._state: Dict[str, Dict[str, Any]] = {}
        #: incident hook: called as ``on_fire(name, state)``
        #: when an SLO TRANSITIONS to firing (never on re-evaluation of
        #: an already-firing one); exceptions are swallowed — forensics
        #: must not break the telemetry tick
        self.on_fire: Optional[Any] = None

    # -- burn math ------------------------------------------------------------
    def _bad_fraction(self, spec: SloSpec,
                      win: Window) -> Optional[float]:
        if spec.kind == "latency":
            return win.bad_fraction(spec.span, spec.threshold_s)
        if spec.kind == "error_rate":
            if spec.span == "*":
                spans = win.spans("rpc.")
            else:
                spans = [spec.span]
            total = sum(win.span_count(s) for s in spans)
            if total == 0:
                return None
            bad = sum(win.counter_delta(f"{s}.errors") for s in spans)
            return min(1.0, bad / total)
        return None  # gauge kind does not use fractions

    def _burn(self, spec: SloSpec, win: Optional[Window]) -> float:
        if win is None:
            return 0.0
        if spec.kind == "gauge":
            mean = win.gauge_mean(spec.span)
            return 0.0 if mean is None else mean / spec.ceiling
        frac = self._bad_fraction(spec, win)
        if frac is None:
            return 0.0
        return frac / max(spec.objective, 1e-9)

    # -- evaluation -----------------------------------------------------------
    def evaluate(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One evaluation pass (the sampler tick): recompute every
        SLO's fast/slow burn, update firing state + gauges, and return
        the full per-SLO state list."""
        now = time.time() if now is None else float(now)
        fast = self.ring.window(self.fast_window_s, now=now)
        slow = self.ring.window(self.slow_window_s, now=now)
        out: List[Dict[str, Any]] = []
        for spec in self.specs:
            burn_fast = self._burn(spec, fast)
            burn_slow = self._burn(spec, slow)
            firing = burn_fast >= self.burn_threshold and \
                burn_slow >= self.burn_threshold
            st = self._state.get(spec.name)
            if st is None:
                st = {"name": spec.name, "kind": spec.kind,
                      "span": spec.span, "describe": spec.describe(),
                      "firing": False, "since_ts": 0.0,
                      "transitions": 0}
                self._state[spec.name] = st
            transitioned = firing != st["firing"]
            # commit the new state BEFORE any edge hook runs: the
            # incident trigger's forensic collector may (transitively)
            # re-enter evaluate, and a not-yet-committed transition
            # would read as a SECOND edge
            st["firing"] = firing
            st["burn_fast"] = round(burn_fast, 4)
            st["burn_slow"] = round(burn_slow, 4)
            st["burn_threshold"] = self.burn_threshold
            if transitioned:
                st["transitions"] += 1
                st["since_ts"] = round(now, 3)
                self.registry.count("slo.transitions")
                # event plane: every fire/clear edge is a
                # timeline event; fires additionally run the incident
                # trigger hook
                self.registry.events.emit(
                    "slo", "firing" if firing else "resolved",
                    severity="warning" if firing else "info",
                    name=spec.name, burn_fast=round(burn_fast, 4),
                    burn_slow=round(burn_slow, 4))
                if firing and self.on_fire is not None:
                    try:
                        self.on_fire(spec.name, dict(st))
                    except Exception:  # noqa: BLE001 — hook must not break
                        log.debug("slo on_fire hook failed", exc_info=True)
                (log.warning if firing else log.info)(
                    "SLO %s %s (burn fast=%.2f slow=%.2f, threshold %.2f): "
                    "%s", spec.name, "FIRING" if firing else "resolved",
                    burn_fast, burn_slow, self.burn_threshold,
                    spec.describe())
            slug = _slug(spec.name)
            self.registry.gauge(f"slo.{slug}.burn_fast", round(burn_fast, 4))
            self.registry.gauge(f"slo.{slug}.burn_slow", round(burn_slow, 4))
            self.registry.gauge(f"slo.{slug}.firing", 1.0 if firing else 0.0)
            out.append(dict(st))
        return out

    def alerts(self) -> List[Dict[str, Any]]:
        """Currently-firing SLOs (last evaluation's view)."""
        return [dict(st) for st in self._state.values() if st["firing"]]

    def status(self) -> List[Dict[str, Any]]:
        """Every SLO's last-evaluated state (firing or not)."""
        return [dict(st) for st in self._state.values()]
