"""The port's autoscaling control plane (jubatus_tpu_torch/coord/
autoscaler.py), case for case with tests/test_autoscaler.py: the pure
controller core on synthetic burn/queue timelines, the control loop's
journal, fault sites, backoff and dry run, signal folding, the
``get_autoscale_status`` RPC and registry, jubactl's frame and ``--once``,
and the floor-restore drill on a live port fleet (``device="cpu"``). The
traffic-model tests there exercise tools/fleet_sim.py, not a module of the
port, and are not repeated. Then parity with the JAX package: the same
seeded signal timelines give identical decisions, reasons and journal
records in both packages' ``AutoscalerCore`` and ``Autoscaler``, and both
jubactls render the same frame."""

from __future__ import annotations

import time
from argparse import Namespace

import pytest

from jubatus_tpu_torch.coord import membership
from jubatus_tpu_torch.coord.autoscaler import (AutoscaleConfig, Autoscaler,
                                          AutoscalerCore, FleetSnapshot,
                                          HookActuator, ReplicaStats,
                                          _stats_from_points, poll_fleet)
from jubatus_tpu_torch.coord.memory import MemoryCoordinator, _Store
from jubatus_tpu_torch.utils import faults


def snap(n, burn=0.0, queue=0.0, t=0.0, firing=None, queues=None,
         rates=None):
    reps = []
    for i in range(n):
        reps.append(ReplicaStats(
            f"127.0.0.1_{9300 + i}",
            burn_max=burn,
            firing=(burn >= 2.0) if firing is None else firing,
            queue_depth=(queues[i] if queues else queue),
            req_per_sec=(rates[i] if rates else 0.0)))
    return FleetSnapshot(ts=t, replicas=reps)


def cfg(**kw):
    base = dict(min_replicas=1, max_replicas=4, poll_interval_s=1.0,
                scale_out_confirm=2, scale_in_confirm=3, cooldown_s=10.0,
                queue_hot=1000.0, burn_hot=2.0)
    base.update(kw)
    return AutoscaleConfig(**base)


# -- controller core ----------------------------------------------------------

def test_config_validation_rejects_nonsense():
    with pytest.raises(ValueError):
        AutoscaleConfig(min_replicas=0).validate()
    with pytest.raises(ValueError):
        AutoscaleConfig(min_replicas=4, max_replicas=2).validate()
    with pytest.raises(ValueError):
        AutoscaleConfig(scale_out_confirm=0).validate()
    with pytest.raises(ValueError):
        AutoscaleConfig(backoff_initial_s=5.0, backoff_max_s=1.0).validate()


def test_scale_out_only_on_sustained_burn():
    core = AutoscalerCore(cfg())
    # one hot poll is a blip, not a trend
    assert core.observe(snap(2, burn=5.0, t=1.0)).action == "hold"
    d = core.observe(snap(2, burn=5.0, t=2.0))
    assert (d.action, d.reason, d.count) == ("scale_out", "sustained_hot", 1)


def test_queue_depth_alone_counts_hot():
    core = AutoscalerCore(cfg())
    core.observe(snap(2, queue=2000.0, t=1.0))
    d = core.observe(snap(2, queue=2000.0, t=2.0))
    assert d.action == "scale_out"


def test_flap_suppression_alternating_signals_never_actuate():
    core = AutoscalerCore(cfg(scale_out_confirm=2, scale_in_confirm=2,
                              cooldown_s=0.0))
    for t in range(40):
        s = snap(2, burn=5.0 if t % 2 == 0 else 0.0, t=float(t))
        assert core.observe(s).action == "hold"


def test_cooldown_blocks_back_to_back_scaleouts():
    core = AutoscalerCore(cfg(cooldown_s=10.0))
    core.observe(snap(2, burn=5.0, t=1.0))
    assert core.observe(snap(2, burn=5.0, t=2.0)).action == "scale_out"
    # still hot 3 s later: confirm streak is satisfied again but the
    # cooldown window holds the fleet steady
    core.observe(snap(3, burn=5.0, t=4.0))
    d = core.observe(snap(3, burn=5.0, t=5.0))
    assert (d.action, d.reason) == ("hold", "cooldown")
    # past the cooldown the next poll fires — the hot streak kept
    # building through the cooldown, so no re-confirmation is needed
    assert core.observe(snap(3, burn=5.0, t=13.0)).action == "scale_out"


def test_max_and_min_bounds_are_honored():
    core = AutoscalerCore(cfg(max_replicas=3, cooldown_s=0.0))
    core.observe(snap(3, burn=9.0, t=1.0))
    d = core.observe(snap(3, burn=9.0, t=2.0))
    assert (d.action, d.reason) == ("hold", "hot_at_max")
    core = AutoscalerCore(cfg(min_replicas=2, scale_in_confirm=2,
                              cooldown_s=0.0))
    core.observe(snap(2, t=1.0))
    d = core.observe(snap(2, t=2.0))
    assert (d.action, d.reason) == ("hold", "cold_at_min")


def test_floor_restore_bypasses_confirm_and_cooldown():
    core = AutoscalerCore(cfg(min_replicas=2, cooldown_s=100.0))
    core.observe(snap(2, burn=5.0, t=1.0))
    assert core.observe(snap(2, burn=5.0, t=2.0)).action == "scale_out"
    # a replica dies 1 s into the cooldown: restore NOW, count exact
    d = core.observe(snap(1, t=3.0))
    assert (d.action, d.reason, d.count) == \
        ("scale_out", "below_min_floor", 1)
    # ...but a REPEAT restore while the spawn is still booting is
    # spaced by cooldown_s — re-spawning every poll is a spawn storm
    d = core.observe(FleetSnapshot(ts=4.0, replicas=[]), now=4.0)
    assert (d.action, d.reason) == ("hold", "floor_restore_pending")
    d = core.observe(FleetSnapshot(ts=104.0, replicas=[]), now=104.0)
    assert (d.action, d.count) == ("scale_out", 2)


def test_scale_in_after_sustained_cold_picks_least_loaded():
    core = AutoscalerCore(cfg(min_replicas=1, scale_in_confirm=3,
                              cooldown_s=0.0))
    s = snap(3, t=0.0, queues=[50.0, 5.0, 200.0],
             rates=[10.0, 1.0, 30.0])
    for t in range(2):
        assert core.observe(s, now=float(t)).action == "hold"
    d = core.observe(s, now=2.0)
    assert (d.action, d.target) == ("scale_in", "127.0.0.1_9301")


def test_draining_members_do_not_count_as_capacity():
    s = snap(3, burn=0.0)
    s.replicas[0].draining = True
    assert s.size == 2
    core = AutoscalerCore(cfg(min_replicas=3))
    d = core.observe(s, now=1.0)
    assert (d.action, d.reason) == ("scale_out", "below_min_floor")


def test_synthetic_burn_timeline_end_to_end():
    """The drill's shape as a pure timeline: quiet -> sustained burn ->
    scale to max -> burn clears -> sustained cold -> scale back in."""
    core = AutoscalerCore(cfg(min_replicas=1, max_replicas=3,
                              scale_out_confirm=2, scale_in_confirm=4,
                              cooldown_s=2.0))
    n, t, actions = 1, 0.0, []
    timeline = [0.0] * 3 + [8.0] * 12 + [0.0] * 14
    for burn in timeline:
        t += 1.0
        d = core.observe(snap(n, burn=burn, t=t))
        actions.append(d.action)
        if d.action == "scale_out":
            n += d.count
        elif d.action == "scale_in":
            n -= 1
    assert n == 1
    assert actions.count("scale_out") == 2      # 1 -> 3 under burn
    assert actions.count("scale_in") == 2       # 3 -> 1 once quiescent
    first_out = actions.index("scale_out")
    assert first_out >= 4  # 3 quiet polls + confirm streak


# -- control loop: journal, counters, fault sites, backoff --------------------

def hook(spawned, drained):
    return HookActuator(lambda n: spawned.append(n),
                        lambda t: drained.append(t))


def mk_scaler(actuator, **kw):
    base = dict(min_replicas=1, max_replicas=4, poll_interval_s=0.05,
                scale_out_confirm=1, scale_in_confirm=2, cooldown_s=0.0,
                backoff_initial_s=0.25, backoff_max_s=2.0)
    base.update(kw)
    return Autoscaler(MemoryCoordinator(_Store()), "classifier", "c1",
                      actuator, config=AutoscaleConfig(**base))


def test_tick_journals_decisions_and_counts():
    spawned, drained = [], []
    sc = mk_scaler(hook(spawned, drained))
    sc.tick(snap(1, t=100.0))                    # steady -> hold
    sc.tick(snap(1, burn=9.0, t=101.0))          # hot x1 (confirm=1)
    assert spawned == [1]
    for t in range(2):
        sc.tick(snap(2, t=102.0 + t))            # cold streak
    assert drained and drained[0].startswith("127.0.0.1_")
    c = sc.registry.counters()
    assert c["autoscale.decisions"] == 4
    assert c["autoscale.spawns"] == 1
    assert c["autoscale.drains"] == 1
    acts = [j["action"] for j in sc.journal]
    assert acts == ["hold", "scale_out", "hold", "scale_in"]
    assert all("signals" in j for j in sc.journal)
    g = sc.registry.gauges()
    assert "autoscale.replicas" in g and "autoscale.burn_max" in g


def test_blocked_spawn_backs_off_and_never_hot_loops():
    spawned, drained = [], []
    calls = []

    def failing_spawn(n):
        calls.append(n)
        raise RuntimeError("spawn path down")

    sc = mk_scaler(HookActuator(failing_spawn, drained.append))
    with faults.armed():  # no-op scope; the hook itself fails
        t = 200.0
        for i in range(60):
            sc.tick(snap(1, burn=9.0, t=t))
            t += 0.01  # 60 polls in 0.6 s of model time
    # exponential backoff: 0.25 + 0.5 = 0.75 s of backoff inside 0.6 s
    # of polls -> at most 2 attempts ever reach the actuator
    assert len(calls) <= 2
    recs = list(sc.journal)
    blocked = [j for j in recs if j["action"] == "blocked"]
    assert blocked and blocked[0]["error"]
    assert blocked[0]["backoff_s"] == 0.25
    assert sc.registry.counters()["autoscale.blocked"] == len(calls)
    assert any(j["reason"] == "backoff" for j in recs)
    # the actuator recovers: next eligible tick (past backoff) spawns
    sc.actuator = hook(spawned, drained)
    sc.tick(snap(1, burn=9.0, t=t + 10.0))
    assert spawned == [1]
    assert sc.backoff_until == 0.0


def test_autoscale_spawn_fault_site_blocks_with_backoff():
    spawned, drained = [], []
    sc = mk_scaler(hook(spawned, drained))
    with faults.armed("autoscale.spawn:error"):
        rec = sc.tick(snap(1, burn=9.0, t=300.0))
    assert rec["action"] == "blocked"
    assert "FaultInjected" in rec["error"]
    assert spawned == []                      # site fires BEFORE actuation
    assert sc.backoff_until > 300.0
    # after the armed window + backoff expiry, actuation proceeds
    rec = sc.tick(snap(1, burn=9.0, t=310.0))
    assert rec["action"] == "scale_out" and spawned == [1]


def test_autoscale_drain_fault_site_blocks():
    spawned, drained = [], []
    sc = mk_scaler(hook(spawned, drained), min_replicas=1,
                   scale_in_confirm=1)
    with faults.armed("autoscale.drain:error"):
        rec = sc.tick(snap(2, t=400.0))
    assert rec["action"] == "blocked" and drained == []
    assert sc.registry.counters()["autoscale.blocked"] == 1


def test_dry_run_journals_intent_without_actuating():
    spawned, drained = [], []
    sc = mk_scaler(hook(spawned, drained), dry_run=True)
    rec = sc.tick(snap(1, burn=9.0, t=500.0))
    assert rec["action"] == "scale_out" and rec["dry_run"] is True
    assert spawned == []
    c = sc.registry.counters()
    assert c["autoscale.decisions"] == 1
    assert c.get("autoscale.spawns", 0) == 0


# -- signal folding -----------------------------------------------------------

def test_stats_from_points_reads_gauges_and_slo_burn():
    points = [
        {"ts": 100.0, "hists": {}, "counters": {}, "gauges": {}},
        {"ts": 110.0, "hists": {}, "counters": {},
         "gauges": {"microbatch.queue_depth": 1500.0,
                    "microbatch.arrival_per_sec": 800.0,
                    "slo.rpc.train.p99.burn_fast": 4.2,
                    "slo.rpc.train.p99.firing": 1.0,
                    "slo.other.burn_fast": 0.1}},
    ]
    r = _stats_from_points("127.0.0.1_9300", points, 60.0)
    assert r.queue_depth == 1500.0
    assert r.arrival_per_sec == 800.0
    assert r.burn_max == 4.2
    assert r.firing is True


def test_poll_fleet_counts_unreachable_members():
    store = _Store()
    coord = MemoryCoordinator(store)
    # a registered active that answers no RPC (nothing listening)
    membership.register_active(coord, "classifier", "c1",
                               "127.0.0.1", 1)
    s = poll_fleet(coord, "classifier", "c1", timeout=0.5)
    assert s.size == 1 and not s.replicas[0].reachable
    assert s.errors


# -- status / RPC / rendering -------------------------------------------------

def test_serve_status_rpc_and_registry():
    from jubatus_tpu_torch.rpc.client import RpcClient

    store = _Store()
    spawned, drained = [], []
    sc = Autoscaler(MemoryCoordinator(store), "classifier", "c1",
                    hook(spawned, drained),
                    config=AutoscaleConfig(scale_out_confirm=1,
                                           cooldown_s=0.0))
    try:
        port = sc.serve(0)
        assert [n.name for n in membership.get_autoscalers(
            MemoryCoordinator(store))] == [f"127.0.0.1_{port}"]
        sc.tick(snap(1, burn=9.0, t=600.0))
        with RpcClient("127.0.0.1", port, timeout=10.0) as c:
            per_node = c.call("get_autoscale_status", "c1", 8)
        doc = next(iter(per_node.values()))
        assert doc["counters"]["autoscale.spawns"] == 1
        assert doc["journal"][-1]["action"] == "scale_out"
        assert doc["config"]["max_replicas"] == 8
        assert doc["fleet"]["replicas"] == 1
    finally:
        sc.stop()


def test_get_autoscale_status_is_idempotent_builtin():
    from jubatus_tpu_torch.framework.idl import IDEMPOTENT_BUILTINS

    assert "get_autoscale_status" in IDEMPOTENT_BUILTINS


def test_render_autoscale_frame():
    from jubatus_tpu_torch.cmd.jubactl import render_autoscale_frame

    spawned, drained = [], []
    sc = mk_scaler(hook(spawned, drained))
    sc.tick(snap(2, burn=9.0, t=700.0, queues=[10.0, 20.0]))
    frame = render_autoscale_frame(sc.status())
    assert "classifier/c1 autoscaler" in frame
    assert "fleet 2 replica(s)" in frame
    assert "scale_out" in frame
    assert "127.0.0.1_9300" in frame
    assert "spawns 1" in frame


def test_jubactl_autoscale_once_dry_runs(capsys, monkeypatch):
    """--once with no registered autoscaler: one observe-only tick
    rendered — and nothing actuated (dry_run is forced)."""
    from jubatus_tpu_torch.cmd import jubactl
    from jubatus_tpu_torch.coord import autoscaler as as_mod

    coord = MemoryCoordinator(_Store())
    membership.register_active(coord, "classifier", "c1",
                               "127.0.0.1", 1)
    monkeypatch.setattr(
        as_mod, "poll_fleet",
        lambda *a, **k: snap(1, burn=9.0, t=time.time()))
    ns = Namespace(watch=False, once=True, interval=2.0, window=30.0,
                   as_min=1, as_max=4, autoscale_interval=0.5,
                   cooldown=0.0, scale_out_confirm=1,
                   scale_in_confirm=2, burn_hot=2.0, queue_hot=1000.0,
                   autoscale_port=0, dry_run=False, thread=2,
                   timeout=10, datadir="/tmp", logdir="", mixer="linear",
                   interval_sec=16, interval_count=512)
    rc = jubactl.run_autoscale(coord, "classifier", "c1", ns)
    assert rc == 0
    out = capsys.readouterr().out
    assert "autoscaler" in out and "scale_out" in out
    assert "[dry-run]" in out


# -- cluster: the floor-restore drill -----------------------------------------

ENGINE = "nearest_neighbor"
NN_CONF = {"method": "lsh", "parameter": {"hash_num": 8},
           "converter": {"num_rules": [{"key": "*", "type": "num"}]}}


def _boot_nn(store):
    from jubatus_tpu_torch.server import EngineServer
    from jubatus_tpu_torch.server.args import ServerArgs

    srv = EngineServer(
        ENGINE, NN_CONF,
        args=ServerArgs(engine=ENGINE, coordinator="(shared)", name="as",
                        listen_addr="127.0.0.1", interval_sec=1e9,
                        interval_count=1 << 30, telemetry_interval=0.5),
        device="cpu", coord=MemoryCoordinator(store))
    srv.start(0)
    return srv


def test_cluster_replica_death_restores_floor():
    """Kill a replica of a live fleet: the loop's next poll sees the
    fleet below min_replicas and spawns a replacement without operator
    input — the unattended-recovery contract, in process."""
    store = _Store()
    servers = [_boot_nn(store), _boot_nn(store)]

    def spawn(n):
        for _ in range(int(n)):
            servers.append(_boot_nn(store))

    sc = Autoscaler(
        MemoryCoordinator(store), ENGINE, "as",
        HookActuator(spawn, lambda t: None),
        config=AutoscaleConfig(min_replicas=2, max_replicas=3,
                               poll_interval_s=0.2, window_s=10.0,
                               scale_in_confirm=10_000,
                               cooldown_s=5.0))
    try:
        coord = MemoryCoordinator(store)
        assert len(membership.get_all_actives(coord, ENGINE, "as")) == 2
        sc.start()
        servers[0].stop()  # hard kill: ephemeral registrations vanish
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            if len(membership.get_all_actives(coord, ENGINE, "as")) >= 2 \
                    and len(servers) == 3:
                break
            time.sleep(0.1)
        assert len(servers) == 3, "autoscaler did not spawn a replacement"
        assert len(membership.get_all_actives(coord, ENGINE, "as")) >= 2
        restore = [j for j in sc.journal
                   if j["action"] == "scale_out"
                   and j["reason"] == "below_min_floor"]
        assert restore, "floor restore not journaled"
    finally:
        sc.stop()
        for s in servers:
            try:
                s.stop()
            except Exception:  # noqa: BLE001 — teardown
                pass


def test_warm_spawn_flag_rides_scale_out_journal():
    """When the actuator spawns replicas with --store-dir
    (they warm-boot from the shared model store), the scale_out journal
    record says so — the operator can tell warm capacity from cold."""
    from jubatus_tpu_torch.coord.autoscaler import VisorActuator

    # VisorActuator derives the flag from the spawn argv it will pass
    warm = VisorActuator(MemoryCoordinator(_Store()), "classifier", "c1",
                         server_argv={"store_dir": "/mnt/models"})
    cold = VisorActuator(MemoryCoordinator(_Store()), "classifier", "c1",
                         server_argv={})
    assert warm.warm_spawn and not cold.warm_spawn

    spawned, drained = [], []
    actuator = hook(spawned, drained)
    actuator.warm_spawn = True
    sc = mk_scaler(actuator)
    sc.tick(snap(1, t=400.0))                    # hold
    rec = sc.tick(snap(1, burn=9.0, t=401.0))    # scale_out
    assert rec["action"] == "scale_out" and spawned == [1]
    assert rec["warm_spawn"] is True
    # a cold actuator's record carries no warm_spawn claim
    sc2 = mk_scaler(hook(spawned, drained))
    sc2.tick(snap(1, t=410.0))
    rec2 = sc2.tick(snap(1, burn=9.0, t=411.0))
    assert rec2["action"] == "scale_out"
    assert "warm_spawn" not in rec2


# -- parity with the JAX package ----------------------------------------------

def _timeline(seed, ticks=120):
    """A seeded burn/queue/rate timeline: quiet stretches, sustained hot
    bursts, flapping stretches and dead polls, per replica slot."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    hot = False
    for _ in range(ticks):
        if rng.random() < 0.12:
            hot = not hot
        burn = float(rng.uniform(2.0, 9.0) if hot else rng.uniform(0, 1.2))
        queues = [float(q) for q in rng.integers(
            0, 3000 if hot else 200, size=8)]
        rates = [float(r) for r in rng.uniform(0, 500, size=8).round(1)]
        out.append({"burn": round(burn, 3), "queues": queues,
                    "rates": rates,
                    "down": int(rng.integers(0, 8))
                    if rng.random() < 0.05 else -1,
                    "draining": int(rng.integers(0, 8))
                    if rng.random() < 0.08 else -1,
                    "dt": float(rng.choice([0.5, 1.0, 1.0, 2.0, 7.0]))})
    return out


def _run_timeline(pkg, seed, **cfg_kw):
    """Drive one package's Autoscaler over the seeded timeline with a
    hook actuator that grows and shrinks the simulated fleet; returns the
    journal, with the wall-clock HLC stamps dropped."""
    import importlib

    asm = importlib.import_module(f"{pkg}.coord.autoscaler")
    mem = importlib.import_module(f"{pkg}.coord.memory")
    flt = importlib.import_module(f"{pkg}.utils.faults")
    size = [2]

    def spawn(n):
        size[0] += int(n)

    def drain(target):
        size[0] -= 1

    sc = asm.Autoscaler(mem.MemoryCoordinator(mem._Store()), "regression",
                        "p", asm.HookActuator(spawn, drain),
                        config=asm.AutoscaleConfig(**cfg_kw))
    t = 1000.0
    for i, step in enumerate(_timeline(seed)):
        reps = []
        for k in range(size[0]):
            reps.append(asm.ReplicaStats(
                f"127.0.0.1_{9300 + k}", burn_max=step["burn"],
                firing=step["burn"] >= 2.0,
                queue_depth=step["queues"][k % 8],
                req_per_sec=step["rates"][k % 8],
                reachable=k != step["down"],
                draining=k == step["draining"]))
        snap_ = asm.FleetSnapshot(ts=t, replicas=reps)
        if i % 37 == 36:  # a broken spawn/drain path now and then
            with flt.armed("autoscale.*:error@1"):
                sc.tick(snap_)
        else:
            sc.tick(snap_)
        t += step["dt"]
    journal = [{k: v for k, v in rec.items() if k not in ("hlc", "event_hlc")}
               for rec in sc.journal]
    return journal, sc.registry.counters(), sc.core.state()


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_autoscaler_decisions_and_journal_equal_the_jax_package(seed):
    kw = dict(min_replicas=2, max_replicas=5, scale_out_confirm=2,
              scale_in_confirm=4, cooldown_s=5.0, queue_hot=1200.0,
              burn_hot=2.5, backoff_initial_s=1.0, backoff_max_s=8.0)
    got = _run_timeline("jubatus_tpu_torch", seed, **kw)
    want = _run_timeline("jubatus_tpu", seed, **kw)
    assert got[0] == want[0]
    assert got[1] == want[1] and got[2] == want[2]
    actions = {rec["action"] for rec in got[0]}
    assert {"scale_out", "scale_in", "hold"} <= actions


def test_autoscaler_core_decisions_equal_the_jax_package():
    import numpy as np

    from jubatus_tpu.coord import autoscaler as jas

    rng = np.random.default_rng(5)
    port = AutoscalerCore(cfg(cooldown_s=3.0))
    jax = jas.AutoscalerCore(jas.AutoscaleConfig(
        min_replicas=1, max_replicas=4, poll_interval_s=1.0,
        scale_out_confirm=2, scale_in_confirm=3, cooldown_s=3.0,
        queue_hot=1000.0, burn_hot=2.0))
    n = 2
    for t in range(200):
        burn = float(rng.choice([0.0, 0.5, 3.0, 9.0]))
        queues = [float(q) for q in rng.integers(0, 2500, size=n)]
        p = port.observe(snap(n, burn=burn, t=float(t), queues=queues),
                         now=float(t))
        js = jas.FleetSnapshot(ts=float(t), replicas=[
            jas.ReplicaStats(f"127.0.0.1_{9300 + i}", burn_max=burn,
                             firing=burn >= 2.0, queue_depth=queues[i])
            for i in range(n)])
        j = jax.observe(js, now=float(t))
        assert (p.action, p.reason, p.count, p.target) == \
            (j.action, j.reason, j.count, j.target)
        assert port.state() == jax.state()
        if p.action == "scale_out":
            n = min(n + p.count, 4)
        elif p.action == "scale_in":
            n -= 1


def test_render_autoscale_frame_equals_the_jax_jubactl():
    from jubatus_tpu.cmd.jubactl import render_autoscale_frame as jrender
    from jubatus_tpu_torch.cmd.jubactl import render_autoscale_frame

    spawned, drained = [], []
    sc = mk_scaler(hook(spawned, drained))
    sc.tick(snap(2, burn=9.0, t=700.0, queues=[10.0, 20.0],
                 rates=[1.5, 2.25]))
    with faults.armed("autoscale.spawn:error"):
        sc.tick(snap(2, burn=9.0, t=720.0, queues=[10.0, 20.0]))
    sc.tick(snap(3, t=740.0, firing=True))
    doc = sc.status()
    doc["replicas"][1]["draining"] = True
    doc["replicas"][2]["reachable"] = False
    for ts in ("", "12:00:00"):
        for rows in (2, 8):
            assert render_autoscale_frame(doc, ts=ts, journal_rows=rows) \
                == jrender(doc, ts=ts, journal_rows=rows)
