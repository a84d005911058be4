"""The port's shared controller core (jubatus_tpu_torch/coord/
controller.py) against the JAX package's (jubatus_tpu/coord/controller.py):
``StreakGate``'s streaks, cooldown and clock reset, and ``ControllerLoop``'s
journal, counters, timeline events and fault-site actuation with
exponential backoff, on the same seeded observation and actuation
sequences; a fired ``autoscale.*`` / ``tune.*`` site blocks and backs off,
never hot-loops."""

from __future__ import annotations

import numpy as np
import pytest

from jubatus_tpu.coord import controller as jctl
from jubatus_tpu.utils import faults as jfaults
from jubatus_tpu.utils.tracing import Registry as JRegistry
from jubatus_tpu_torch.coord import controller as ctl
from jubatus_tpu_torch.utils import faults
from jubatus_tpu_torch.utils.tracing import Registry


def _loop(mod, registry):
    """A ControllerLoop of package ``mod`` with a counter per action and
    gauged signals."""
    class Loop(mod.ControllerLoop):
        subsystem = "probe"

        def _counter_suffix(self, action, extra):
            return {"go": "goes", "blocked": "blocked"}.get(action)

        def _event_fields(self, signals, extra):
            return {"level": signals["level"]}

        def _gauge_signals(self, signals):
            self.registry.gauge("probe.level", float(signals["level"]))

        def _backoff_bounds(self):
            return 0.5, 4.0

    return Loop(256, registry)


@pytest.mark.parametrize("seed", [0, 7, 21])
def test_streak_gate_equals_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    port, jax = ctl.StreakGate(2, 3, 5.0), jctl.StreakGate(2, 3, 5.0)
    now = 0.0
    for _ in range(400):
        k = int(rng.integers(0, 3))
        hot, cold = k == 1, k == 2
        port.step(hot, cold)
        jax.step(hot, cold)
        now += float(rng.choice([0.5, 1.0, 3.0]))
        assert port.in_cooldown(now) == jax.in_cooldown(now)
        assert (port.hot_confirmed, port.cold_confirmed) == \
            (jax.hot_confirmed, jax.cold_confirmed)
        if port.hot_confirmed and not port.in_cooldown(now):
            port.fired_hot(now)
            jax.fired_hot(now)
        elif port.cold_confirmed and not port.in_cooldown(now):
            port.fired_cold(now)
            jax.fired_cold(now)
        if rng.random() < 0.05:
            port.reset_clock()
            jax.reset_clock()
        assert port.gate_state() == jax.gate_state()


def _drive(mod, fmod, registry, seed):
    """Seeded records and guarded actuations (some through an armed
    fault site, some through a failing function); the journal with its
    wall-clock HLC stamps dropped, the counters, gauges and backoff."""
    rng = np.random.default_rng(seed)
    loop = _loop(mod, registry)
    now, calls = 100.0, []
    for i in range(120):
        now += float(rng.choice([0.1, 0.25, 1.0, 5.0]))
        level = int(rng.integers(0, 10))
        sig = {"level": level}
        if loop.in_backoff(now):
            loop.record("hold", "backoff", sig, now)
            continue
        if level < 4:
            loop.record("hold", "quiet", sig, now, dry_run=level == 0)
            continue
        mode = int(rng.choice([0, 0, 0, 1, 2]))

        def act(i=i, mode=mode):
            if mode == 2:
                raise RuntimeError(f"actuator down {i}")
            calls.append(i)

        rules = ["probe.apply:error@1"] if mode == 1 else []
        with fmod.armed(*rules):
            ok, rec = loop.guarded("probe.apply", act, reason="busy",
                                   signals=sig, now=now, wanted="go")
        if ok:
            loop.record("go", "busy", sig, now, target=f"t{i}")
    journal = [{k: v for k, v in r.items() if k not in ("hlc", "event_hlc")}
               for r in loop.journal_tail(256)]
    return (journal, loop.registry.counters(), loop.registry.gauges(),
            loop.backoff_state(), calls,
            [e["type"] for e in loop.registry.events.snapshot()
             if e["subsystem"] == "probe"])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_controller_loop_equals_the_jax_package(seed):
    got = _drive(ctl, faults, Registry(), seed)
    want = _drive(jctl, jfaults, JRegistry(), seed)
    assert got == want
    actions = {r["action"] for r in got[0]}
    assert {"hold", "go", "blocked"} <= actions
    blocked = [r for r in got[0] if r["action"] == "blocked"]
    assert all(r["backoff_s"] in (0.5, 1.0, 2.0, 4.0) for r in blocked)
    assert got[1]["probe.decisions"] == len(got[0]) == 120
    assert got[1]["probe.goes"] == len(got[4])


@pytest.mark.parametrize("site", ["autoscale.spawn", "autoscale.drain",
                                  "tune.mix.apply", "tune.coalescer.apply",
                                  "tune.cadence.apply"])
def test_fired_control_site_blocks_and_backs_off(site):
    """Each control loop's actuation site: a fired error journals
    ``blocked``, never runs the actuator, and doubles the backoff up to
    its cap; a success resets it."""
    loop = _loop(ctl, Registry())
    ran = []
    with faults.armed(f"{site}:error"):
        backoffs = []
        for k in range(5):
            ok, rec = loop.guarded(site, lambda: ran.append(k),
                                   reason="r", signals={"level": 5},
                                   now=10.0 * k)
            assert not ok and rec["action"] == "blocked"
            assert "FaultInjected" in rec["error"]
            backoffs.append(rec["backoff_s"])
    assert ran == [] and backoffs == [0.5, 1.0, 2.0, 4.0, 4.0]
    assert loop.in_backoff(40.0 + 3.9) and not loop.in_backoff(44.1)
    ok, rec = loop.guarded(site, lambda: ran.append("ok"), reason="r",
                           signals={"level": 5}, now=50.0)
    assert ok and rec is None and ran == ["ok"]
    assert loop.backoff_state() == {"backoff_until": 0.0, "backoff_s": 0.0}
    assert loop.registry.counters()["probe.blocked"] == 5
