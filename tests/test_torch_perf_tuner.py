"""The port's self-tuning performance plane (jubatus_tpu_torch/coord/
perf_tuner.py), case for case with tests/test_perf_tuner.py: the tuner
cores on synthetic telemetry timelines, the observe/on ladder, the chaos
drills against the ``tune.*.apply`` fault sites, and the server wiring
(``--auto-tune``, ``get_tune``, jubactl's view) with ``device="cpu"``.
Then parity with the JAX package: the same seeded timelines give
identical decisions, reasons and journal records in both packages'
``MixPlanCore``, ``CoalescerCore``, ``CadenceCore`` and ``PerfTuner``, and
both jubactls render the same tune view."""

from __future__ import annotations

import pytest

from jubatus_tpu_torch.coord.perf_tuner import (CadenceCore, CoalescerCore,
                                          MixPlanCore, PerfTuner,
                                          TunerConfig)
from jubatus_tpu_torch.utils import faults
from jubatus_tpu_torch.utils.tracing import Registry


def cfg(**kw) -> TunerConfig:
    base = dict(mode="on", confirm=1, cooldown_s=0.0, settle_rounds=1,
                backoff_initial_s=0.25, backoff_max_s=2.0)
    base.update(kw)
    return TunerConfig(**base)


# -- MixPlanCore ---------------------------------------------------------------

def synth_cost(plan, optimum=("bf16", 16.0)):
    """Synthetic round-time surface: unimodal around the optimum — the
    shape a real chunk sweep shows (too-small chunks pay per-collective
    overhead, too-large ones lose pipeline overlap; the wrong wire mode
    ships 2-4x the bytes)."""
    mode, chunk = plan
    base = {"off": 100.0, "bf16": 60.0, "int8": 70.0}[mode]
    return base + abs(chunk - optimum[1]) * 1.5


def drive(core, cost_fn, rounds=30, ship_frac=0.7, ef_drift=None):
    """Run the propose→commit loop against a synthetic cost surface;
    returns the number of observe() rounds consumed."""
    used = 0
    plan = core.plan
    while used < rounds:
        used += 1
        prop = core.observe(cost_fn(plan), ship_frac=ship_frac,
                            ef_drift=ef_drift)
        if prop is not None:
            plan = prop["plan"]
            core.commit(plan)
        elif core.converged:
            break
    return used


def test_mix_core_converges_to_synthetic_optimum():
    core = MixPlanCore(cfg(), mode="off", chunk_mb=8.0)
    used = drive(core, synth_cost)
    assert core.plan == ("bf16", 16.0)
    assert core.converged
    # the regret-bench budget: settle within the 12-round envelope
    assert used <= 12, used


def test_mix_core_chunk_first_when_not_ship_dominated():
    """A round whose time is NOT dominated by the ship phase probes the
    chunk ladder before the wire ladder (compression can't win when the
    wire isn't the bottleneck)."""
    core = MixPlanCore(cfg(), mode="off", chunk_mb=8.0)
    core.observe(100.0, ship_frac=0.2)         # scores the seed plan
    prop = core.observe(100.0, ship_frac=0.2)  # hmm settle_rounds=1
    # with settle_rounds=1 the FIRST observe already proposes
    first = core._next_probe(0.2)
    assert first is not None and first[0] == "off"  # chunk move, same wire


def test_mix_core_wire_first_when_ship_dominated():
    core = MixPlanCore(cfg(), mode="off", chunk_mb=8.0)
    core.observe(100.0, ship_frac=0.9)
    first = core._next_probe(0.9)
    assert first == ("bf16", 8.0)  # wire move, same chunk


def test_mix_core_int8_guardrail_blacklists_and_steps_down():
    """EF residual drift above the bound while on int8: int8 is
    blacklisted (purged from scores, never proposed again) and the plan
    steps back down the wire ladder."""
    c = cfg()
    core = MixPlanCore(c, mode="int8", chunk_mb=8.0)
    core.scores[("int8", 8.0)] = 10.0  # looks great — drift still kills it
    prop = core.observe(10.0, ef_drift=c.ef_drift_max * 10)
    assert prop == {"action": "retune", "plan": ("bf16", 8.0),
                    "reason": "ef_drift_guardrail"}
    assert core.int8_blacklisted
    assert all(p[0] != "int8" for p in core.scores)
    core.commit(prop["plan"])
    drive(core, lambda p: synth_cost(p, optimum=("bf16", 8.0)))
    assert all(p[0] != "int8" for p in core.scores)
    assert core.plan[0] != "int8"


def test_mix_core_settles_back_on_best_after_bad_probe():
    """A probe that lands on a worse plan must retune back to the best
    scored plan, not stay where it wandered."""
    core = MixPlanCore(cfg(chunk_ladder=(4.0, 8.0), wire_ladder=("off",)),
                       mode="off", chunk_mb=8.0)
    assert core.observe(50.0) == {"action": "probe", "plan": ("off", 4.0),
                                  "reason": "hill_climb"}
    core.commit(("off", 4.0))
    prop = core.observe(90.0)  # the probe was worse
    assert prop == {"action": "retune", "plan": ("off", 8.0),
                    "reason": "settle_on_best"}


# -- CoalescerCore -------------------------------------------------------------

def test_coalescer_arrival_burst_deepens_with_bounded_step():
    c = cfg(confirm=2, residency_target_s=0.1, depth_step_max=2.0)
    core = CoalescerCore(c)
    # arrival 10000/s x 0.1s residency => target 1000, current depth 64
    assert core.observe(1.0, 10000.0, 64) is None   # first hot tick: streak
    d = core.observe(2.0, 10000.0, 64)
    assert d is not None and d["action"] == "deepen"
    assert d["depth"] == 128  # bounded: one 2x step, not the full jump
    assert d["target"] == 1000.0


def test_coalescer_quiescent_shrinks_but_never_below_one():
    c = cfg(confirm=1, residency_target_s=0.05, depth_step_max=4.0)
    core = CoalescerCore(c)
    d = core.observe(1.0, 10.0, 8)  # target 0.5 -> floor 1
    assert d is not None and d["action"] == "shallow"
    assert d["depth"] >= 1
    d2 = core.observe(2.0, 10.0, d["depth"])
    while d2 is not None and d2["action"] == "shallow":
        assert d2["depth"] >= 1
        d2 = core.observe(3.0, 10.0, d2["depth"])


def test_coalescer_idle_holds():
    """Arrival 0 must HOLD, not shrink — an idle queue's depth is free,
    and shrinking it would punish the next burst."""
    core = CoalescerCore(cfg(confirm=1))
    for t in range(1, 5):
        assert core.observe(float(t), 0.0, 512) is None
    assert core.cold_streak == 0


def test_coalescer_dead_band_suppresses_noise():
    c = cfg(confirm=1, residency_target_s=0.05, depth_band=0.5)
    core = CoalescerCore(c)
    # target = 100*0.05 = 5 vs depth 6: inside the band -> hold
    assert core.observe(1.0, 100.0, 6) is None
    assert core.hot_streak == 0 and core.cold_streak == 0


def test_coalescer_cooldown_gates_consecutive_moves():
    c = cfg(confirm=1, cooldown_s=10.0, residency_target_s=0.1)
    core = CoalescerCore(c)
    d = core.observe(1.0, 10000.0, 4)
    assert d is not None
    assert core.observe(2.0, 10000.0, d["depth"]) is None  # in cooldown
    assert core.observe(12.0, 10000.0, d["depth"]) is not None


# -- CadenceCore ---------------------------------------------------------------

def test_cadence_divergence_spike_quickens_to_floor():
    c = cfg(confirm=2, interval_floor_s=2.0, interval_ceiling_s=64.0)
    core = CadenceCore(c)
    assert core.observe(1.0, 0.9, 16.0) is None  # first hot tick
    d = core.observe(2.0, 0.9, 16.0)
    assert d is not None and d["action"] == "quicken"
    assert d["interval_sec"] == 8.0
    # keep spiking: halves again but never below the floor
    core.observe(3.0, 0.9, 8.0)
    d = core.observe(4.0, 0.9, 8.0)
    assert d["interval_sec"] == 4.0
    core.observe(5.0, 0.9, 2.0)
    assert core.observe(6.0, 0.9, 2.0) is None  # at the floor: hold


def test_cadence_quiescence_relaxes_to_ceiling():
    c = cfg(confirm=1, interval_floor_s=2.0, interval_ceiling_s=32.0)
    core = CadenceCore(c)
    d = core.observe(1.0, 0.0, 16.0)
    assert d is not None and d["action"] == "relax"
    assert d["interval_sec"] == 32.0
    assert core.observe(2.0, 0.0, 32.0) is None  # at the ceiling


def test_cadence_mid_band_holds_and_resets_streaks():
    c = cfg(confirm=2)
    core = CadenceCore(c)
    core.observe(1.0, 0.9, 16.0)
    assert core.hot_streak == 1
    core.observe(2.0, 0.1, 16.0)  # between cold and hot thresholds
    assert core.hot_streak == 0 and core.cold_streak == 0


# -- PerfTuner (assembled loop, fake adapter) ---------------------------------

class FakeAdapter:
    """Synthetic fleet: a mix plane whose round time follows synth_cost
    for the currently-applied plan, one coalescer, one cadence plane.
    Tests mutate the signal fields to build timelines."""

    def __init__(self):
        self.wire = "off"
        self.chunk = 8.0
        self.rounds = 0
        self.ef_drift = 0.0
        self.ship_frac = 0.7
        self.depth = 64
        self.arrival = 0.0
        self.divergence = 0.0
        self.interval = 16.0
        self.mix_applies = []
        self.coalescer_applies = []
        self.cadence_applies = []

    def mix_signals(self):
        if self.rounds <= 0:
            return None
        return {"rounds": self.rounds,
                "round_ms": synth_cost((self.wire, self.chunk)),
                "wire": self.wire, "chunk_mb": self.chunk,
                "ef_drift": self.ef_drift, "ship_frac": self.ship_frac}

    def apply_mix(self, wire, chunk_mb):
        self.mix_applies.append((wire, chunk_mb))
        self.wire, self.chunk = wire, chunk_mb

    def coalescer_signals(self):
        return [{"name": "train", "arrival_per_sec": self.arrival,
                 "depth": self.depth}]

    def apply_coalescer(self, name, depth):
        self.coalescer_applies.append((name, depth))
        self.depth = depth

    def cadence_signals(self):
        return {"divergence": self.divergence,
                "interval_sec": self.interval}

    def apply_cadence(self, sec):
        self.cadence_applies.append(sec)
        self.interval = sec


def mk_tuner(adapter, **kw):
    reg = Registry()
    return PerfTuner(cfg(**kw), adapter, registry=reg), reg


def test_tuner_converges_fleet_to_optimum_and_journals():
    ad = FakeAdapter()
    tuner, reg = mk_tuner(ad)
    now = 0.0
    for _ in range(30):
        now += 1.0
        ad.rounds += 1  # one mix round completed per tick
        tuner.tick(now)
    assert (ad.wire, ad.chunk) == ("bf16", 16.0)
    assert tuner.mix is not None and tuner.mix.converged
    counters = reg.counters()
    assert counters["tune.decisions"] == len(tuner.journal_tail(10**6))
    assert counters["tune.applies"] == (len(ad.mix_applies)
                                        + len(ad.coalescer_applies)
                                        + len(ad.cadence_applies))
    assert reg.gauges()["tune.mix.chunk_mb"] == 16.0
    assert reg.gauges()["tune.mix.wire_mode"] == 1.0  # bf16 ladder index
    actions = {r["action"] for r in tuner.journal_tail(10**6)}
    assert "probe" in actions
    # every journal record cross-links a timeline event
    for rec in tuner.journal_tail(10**6):
        assert rec["hlc"]
        assert rec["event_hlc"]


def test_tuner_stale_round_count_feeds_no_sample():
    """No new mix round between ticks => no observation consumed (the
    tuner must never score a plan on a repeated stale measurement)."""
    ad = FakeAdapter()
    ad.rounds = 1
    tuner, _ = mk_tuner(ad, settle_rounds=2)
    tuner.tick(1.0)   # anchor
    for t in range(2, 10):
        tuner.tick(float(t))  # rounds never advances
    assert tuner.mix is not None
    assert tuner.mix.scores == {}  # nothing settled


def test_tuner_coalescer_burst_timeline():
    ad = FakeAdapter()
    tuner, reg = mk_tuner(ad, confirm=2, residency_target_s=0.1)
    ad.arrival = 10000.0  # burst: target 1000 vs depth 64
    tuner.tick(1.0)
    assert ad.coalescer_applies == []  # confirm streak not met yet
    tuner.tick(2.0)
    assert ad.coalescer_applies == [("train", 128)]  # bounded 2x step
    assert reg.gauges()["tune.coalescer.max_batch"] == 128.0


def test_tuner_cadence_divergence_timeline():
    ad = FakeAdapter()
    tuner, reg = mk_tuner(ad, confirm=1)
    ad.divergence = 0.9
    tuner.tick(1.0)
    assert ad.cadence_applies == [8.0]
    assert reg.gauges()["tune.cadence.interval_s"] == 8.0


def test_observe_mode_journals_dry_run_and_touches_nothing():
    ad = FakeAdapter()
    ad.arrival = 10000.0
    ad.divergence = 0.9
    tuner, reg = mk_tuner(ad, mode="observe", confirm=1)
    for t in range(1, 8):
        ad.rounds += 1
        tuner.tick(float(t))
    # recommendations journaled...
    recs = tuner.journal_tail(10**6)
    assert recs and all(r.get("dry_run") for r in recs)
    # ...but nothing actuated and no knob moved
    assert ad.mix_applies == []
    assert ad.coalescer_applies == []
    assert ad.cadence_applies == []
    assert (ad.wire, ad.chunk, ad.depth, ad.interval) == \
        ("off", 8.0, 64, 16.0)
    # dry-run intent counts decisions, never applies
    counters = reg.counters()
    assert counters["tune.decisions"] == len(recs)
    assert "tune.applies" not in counters


def test_off_mode_never_reads_signals():
    class Exploding:
        def __getattr__(self, name):
            raise AssertionError("off-mode tuner touched the adapter")

    tuner = PerfTuner(TunerConfig(mode="off"), Exploding(),
                      registry=Registry())
    tuner.tick(1.0)  # must not raise


def test_tuner_status_shape():
    ad = FakeAdapter()
    tuner, _ = mk_tuner(ad)
    ad.rounds = 1
    tuner.tick(1.0)
    st = tuner.status()
    assert st["mode"] == "on"
    assert "backoff_s" in st and "journal" in st and "cadence" in st
    assert st["mix"]["wire"] == "off" and st["mix"]["chunk_mb"] == 8.0


# -- chaos: the tune.*.apply fault sites --------------------------------------

def test_mix_apply_fault_blocks_backs_off_and_leaves_plan_coherent():
    """A failing mix actuation journals ``blocked``, arms exponential
    backoff (no hot-loop), and leaves BOTH the fleet knob and the
    core's belief on the previous plan — never a half-applied plan."""
    ad = FakeAdapter()
    tuner, reg = mk_tuner(ad, settle_rounds=1)
    ad.rounds = 1
    tuner.tick(1.0)  # anchor
    with faults.armed("tune.mix.apply:error"):
        ad.rounds = 2
        tuner.tick(2.0)
    blocked = [r for r in tuner.journal_tail(10) if r["action"] == "blocked"]
    assert len(blocked) == 1
    assert blocked[0]["backoff_s"] == 0.25
    assert "FaultInjected" in blocked[0]["error"]
    assert tuner.backoff_until == 2.25
    # knob untouched, belief untouched — coherent
    assert (ad.wire, ad.chunk) == ("off", 8.0)
    assert tuner.mix.plan == ("off", 8.0)
    assert reg.counters()["tune.blocked"] == 1
    # ticks inside the backoff window do nothing at all
    with faults.armed("tune.mix.apply:error"):
        ad.rounds = 3
        tuner.tick(2.1)
    assert len([r for r in tuner.journal_tail(10)
                if r["action"] == "blocked"]) == 1
    # backoff doubles on the next failure after the window
    with faults.armed("tune.mix.apply:error"):
        ad.rounds = 4
        tuner.tick(3.0)
    blocked = [r for r in tuner.journal_tail(10) if r["action"] == "blocked"]
    assert len(blocked) == 2
    assert blocked[-1]["backoff_s"] == 0.5
    # and a later successful apply clears the backoff
    ad.rounds = 5
    tuner.tick(10.0)
    assert ad.mix_applies  # actuated now
    assert tuner.backoff_until == 0.0


def test_coalescer_apply_fault_leaves_depth_unchanged():
    ad = FakeAdapter()
    ad.arrival = 10000.0
    tuner, _ = mk_tuner(ad, confirm=1)
    with faults.armed("tune.coalescer.apply:error"):
        tuner.tick(1.0)
    assert ad.depth == 64
    assert ad.coalescer_applies == []
    blocked = tuner.journal_tail(5)[-1]
    assert blocked["action"] == "blocked"
    assert blocked["target"] == "train"
    assert tuner.in_backoff(1.1)


def test_cadence_apply_fault_delay_rule_does_not_block():
    """A delay rule (slow actuation path) is not an error: the apply
    still lands, nothing journals blocked."""
    ad = FakeAdapter()
    ad.divergence = 0.9
    tuner, _ = mk_tuner(ad, confirm=1)
    with faults.armed("tune.cadence.apply:delay:0.01"):
        tuner.tick(1.0)
    assert ad.cadence_applies == [8.0]
    assert not any(r["action"] == "blocked" for r in tuner.journal_tail(10))


def test_cadence_apply_fault_blocks():
    ad = FakeAdapter()
    ad.divergence = 0.9
    tuner, _ = mk_tuner(ad, confirm=1)
    with faults.armed("tune.cadence.apply:error"):
        tuner.tick(1.0)
    assert ad.cadence_applies == []
    assert ad.interval == 16.0
    assert tuner.journal_tail(5)[-1]["action"] == "blocked"


def test_sick_adapter_never_kills_the_tick():
    class Sick:
        def mix_signals(self):
            raise RuntimeError("boom")

        def coalescer_signals(self):
            raise RuntimeError("boom")

        def cadence_signals(self):
            raise RuntimeError("boom")

    tuner = PerfTuner(cfg(), Sick(), registry=Registry())
    tuner.tick(1.0)  # must not raise


# -- config validation ---------------------------------------------------------

def test_config_rejects_bad_mode_and_bounds():
    with pytest.raises(ValueError):
        TunerConfig(mode="sometimes")
    with pytest.raises(ValueError):
        TunerConfig(interval_floor_s=10.0, interval_ceiling_s=1.0)
    with pytest.raises(ValueError):
        TunerConfig(depth_floor=0)


# -- server wiring + jubactl surface ------------------------------------------

def test_server_tuner_wiring_and_jubactl_tune_view():
    """--auto-tune observe boots a PerfTuner riding the telemetry tick,
    get_tune serves its status over the RPC (idempotent builtin — safe
    through proxies/retries), and jubactl's renderer turns the doc into
    the operator view."""
    from jubatus_tpu_torch.cmd import jubactl
    from jubatus_tpu_torch.coord.memory import MemoryCoordinator, _Store
    from jubatus_tpu_torch.framework.idl import IDEMPOTENT_BUILTINS
    from jubatus_tpu_torch.rpc.client import RpcClient
    from jubatus_tpu_torch.server import EngineServer
    from jubatus_tpu_torch.server.args import ServerArgs

    assert "get_tune" in IDEMPOTENT_BUILTINS
    conf = {"method": "PA", "parameter": {"regularization_weight": 1.0},
            "converter": {"num_rules": [{"key": "*", "type": "num"}]}}
    store = _Store()
    servers = []
    for _ in range(2):  # an in-process collective_mixer pair
        args = ServerArgs(engine="classifier", coordinator="(shared)",
                          name="tunesrv", listen_addr="127.0.0.1",
                          mixer="collective_mixer", interval_sec=1e9,
                          interval_count=1 << 30, auto_tune="observe",
                          telemetry_interval=0)
        servers.append(EngineServer("classifier", conf, args, device="cpu",
                                    coord=MemoryCoordinator(store)))
        servers[-1].start(0)
    srv = servers[0]
    try:
        assert srv.tuner is not None
        assert srv.tuner.dry_run
        srv._tune_tick()  # the telemetry hook, driven by hand
        with RpcClient("127.0.0.1", srv.args.rpc_port) as c:
            docs = c.call("get_tune", "tunesrv")
        assert len(docs) == 1
        (st,) = docs.values()
        assert st["mode"] == "observe"
        assert "mix" not in st  # no round yet: the mix plane has no signal
        text = jubactl.render_tune("classifier", "tunesrv", docs)
        assert "auto-tune across 1 node(s)" in text
        assert "mode observe" in text
        # a round (the pair is one process, so it mixes over RPC) gives
        # the mix core its first sample, read off the collective mixer
        with RpcClient("127.0.0.1", srv.args.rpc_port) as c:
            c.call("train", "tunesrv", [["pos", [[], [["a", 1.0]], []]]])
            assert c.call("do_mix", "tunesrv") is True
        srv._tune_tick()
        (st,) = srv.get_tune("tunesrv").values()
        assert st["mix"]["wire"] == "off"
        assert st["mix"]["chunk_mb"] == 8.0
        assert all(rec.get("dry_run") for rec in st["journal"])
        assert servers[1].mixer.compress in (None, "off")
    finally:
        for s in servers:
            s.stop()


def test_server_without_auto_tune_has_no_tuner():
    from jubatus_tpu_torch.cmd import jubactl
    from jubatus_tpu_torch.coord.memory import MemoryCoordinator, _Store
    from jubatus_tpu_torch.rpc.client import RpcClient
    from jubatus_tpu_torch.server import EngineServer
    from jubatus_tpu_torch.server.args import ServerArgs

    conf = {"method": "PA", "parameter": {"regularization_weight": 1.0},
            "converter": {"num_rules": [{"key": "*", "type": "num"}]}}
    args = ServerArgs(engine="classifier", coordinator="(shared)",
                      name="tunesrv", listen_addr="127.0.0.1",
                      interval_sec=1e9, interval_count=1 << 30)
    srv = EngineServer("classifier", conf, args, device="cpu",
                       coord=MemoryCoordinator(_Store()))
    srv.start(0)
    try:
        assert srv.tuner is None
        srv._tune_tick()  # hook stays a no-op, never raises
        with RpcClient("127.0.0.1", srv.args.rpc_port) as c:
            docs = c.call("get_tune", "tunesrv")
        (st,) = docs.values()
        assert st == {}
        text = jubactl.render_tune("classifier", "tunesrv", docs)
        assert "tuner off (--auto-tune off)" in text
    finally:
        srv.stop()


def test_render_tune_journal_lines():
    """The renderer is pure — feed it a canned doc and pin the shape
    operators read (plan line, blacklist flag, journal rows, dry-run
    and error tags)."""
    from jubatus_tpu_torch.cmd import jubactl

    docs = {"n1:9200": {
        "mode": "on", "backoff_s": 4.0,
        "mix": {"wire": "bf16", "chunk_mb": 16.0, "trials": 3,
                "converged": True, "int8_blacklisted": True,
                "best_wire": "bf16", "best_chunk_mb": 16.0,
                "best_ms": 57.5},
        "coalescers": {"train": {"hot_streak": 1, "cold_streak": 0}},
        "cadence": {"hot_streak": 0, "cold_streak": 2},
        "journal": [
            {"ts": 12.0, "action": "probe", "reason": "hill_climb",
             "target": "mix",
             "signals": {"wire": "bf16", "chunk_mb": 16.0}},
            {"ts": 13.0, "action": "deepen", "reason": "littles_law",
             "target": "train", "dry_run": True,
             "signals": {"depth": 128}},
            {"ts": 14.0, "action": "blocked", "reason": "littles_law",
             "target": "train", "error": "FaultInjected",
             "signals": {"depth": 256}},
        ]},
        "n2:9201": {}}
    text = jubactl.render_tune("classifier", "x", docs, last=8)
    assert "auto-tune across 2 node(s)" in text
    assert "mode on  backoff 4s" in text
    assert "plan bf16/16MB" in text and "converged" in text
    assert "int8 BLACKLISTED" in text
    assert "best bf16/16MB 57.5ms" in text
    assert "coalescer train: streaks hot 1 / cold 0" in text
    assert "-> bf16/16.0MB" in text
    assert "[dry-run]" in text
    assert "(FaultInjected)" in text
    assert "-> depth 128" in text
    assert "n2:9201: tuner off" in text


# -- parity with the JAX package ----------------------------------------------

def _tuner_timeline(seed, ticks=160):
    """Seeded signal timeline for the three knob families: round-time
    noise and ship fraction, EF drift spikes, arrival bursts, divergence
    spikes and quiet stretches, and apply faults now and then."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    burst = False
    for _ in range(ticks):
        if rng.random() < 0.1:
            burst = not burst
        out.append({
            "noise": float(rng.normal(0.0, 3.0)),
            "ship_frac": float(rng.uniform(0.1, 0.95)),
            "ef_drift": float(rng.choice([0.0, 0.0, 0.0, 5e-3])),
            "new_round": bool(rng.random() < 0.8),
            "arrival": float(rng.uniform(5e3, 4e4) if burst
                             else rng.uniform(0.0, 50.0)),
            "divergence": float(rng.choice([0.0, 0.01, 0.1, 0.5, 0.9])),
            "fault": str(rng.choice(["", "", "", "", "", "", "mix",
                                     "coalescer", "cadence"])),
            "dt": float(rng.choice([0.5, 1.0, 3.0, 40.0])),
        })
    return out


def _run_tuner(pkg, seed, mode):
    import importlib

    pt = importlib.import_module(f"{pkg}.coord.perf_tuner")
    flt = importlib.import_module(f"{pkg}.utils.faults")
    reg = importlib.import_module(f"{pkg}.utils.tracing").Registry()
    ad = FakeAdapter()
    tuner = pt.PerfTuner(pt.TunerConfig(
        mode=mode, confirm=2, cooldown_s=5.0, settle_rounds=2,
        backoff_initial_s=1.0, backoff_max_s=8.0,
        interval_floor_s=2.0, interval_ceiling_s=64.0), ad, registry=reg)
    now = 100.0
    for step in _tuner_timeline(seed):
        if step["new_round"]:
            ad.rounds += 1
        ad.ship_frac = step["ship_frac"]
        ad.ef_drift = step["ef_drift"]
        ad.arrival = step["arrival"]
        ad.divergence = step["divergence"]
        base = ad.mix_signals
        ad.mix_signals = (lambda b=base, n=step["noise"]: None
                          if b() is None else
                          dict(b(), round_ms=b()["round_ms"] + n))
        if step["fault"]:
            with flt.armed(f"tune.{step['fault']}.apply:error"):
                tuner.tick(now)
        else:
            tuner.tick(now)
        ad.mix_signals = base
        now += step["dt"]
    journal = [{k: v for k, v in rec.items() if k not in ("hlc", "event_hlc")}
               for rec in tuner.journal]
    status = tuner.status(last=0)
    status.pop("journal")
    return (journal, status, reg.counters(), ad.mix_applies,
            ad.coalescer_applies, ad.cadence_applies)


@pytest.mark.parametrize("mode", ["on", "observe"])
@pytest.mark.parametrize("seed", [1, 17])
def test_tuner_decisions_and_journal_equal_the_jax_package(seed, mode):
    got = _run_tuner("jubatus_tpu_torch", seed, mode)
    want = _run_tuner("jubatus_tpu", seed, mode)
    assert got == want
    targets = {rec.get("target") for rec in got[0]}
    assert {"mix", "train", "cadence"} <= targets
    if mode == "on":
        assert "blocked" in {rec["action"] for rec in got[0]}
        assert got[3] and got[4] and got[5]
    else:
        assert all(rec.get("dry_run") for rec in got[0])
        assert not (got[3] or got[4] or got[5])


@pytest.mark.parametrize("seed", [2, 8])
def test_tuner_cores_equal_the_jax_package(seed):
    import numpy as np

    from jubatus_tpu.coord import perf_tuner as jpt

    kw = dict(mode="on", confirm=2, cooldown_s=3.0, settle_rounds=2)
    rng = np.random.default_rng(seed)
    pm, jm = MixPlanCore(cfg(**kw)), jpt.MixPlanCore(jpt.TunerConfig(
        **dict(cfg(**kw).__dict__)))
    pc, jc = CoalescerCore(cfg(**kw)), jpt.CoalescerCore(jpt.TunerConfig(
        **dict(cfg(**kw).__dict__)))
    pd, jd = CadenceCore(cfg(**kw)), jpt.CadenceCore(jpt.TunerConfig(
        **dict(cfg(**kw).__dict__)))
    depth, interval = 64, 16.0
    for t in range(300):
        ms = synth_cost(pm.plan) + float(rng.normal(0, 4.0))
        ship = float(rng.uniform(0, 1))
        drift = float(rng.choice([0.0, 0.0, 1.0]))
        a, b = pm.observe(ms, ship_frac=ship, ef_drift=drift), \
            jm.observe(ms, ship_frac=ship, ef_drift=drift)
        assert a == b
        if a is not None and rng.random() < 0.8:  # some applies fail
            pm.commit(a["plan"])
            jm.commit(b["plan"])
        assert pm.state() == jm.state()
        arrival = float(rng.choice([0.0, 10.0, 2e3, 5e4]))
        a, b = pc.observe(float(t), arrival, depth), \
            jc.observe(float(t), arrival, depth)
        assert a == b and pc.gate_state() == jc.gate_state()
        if a is not None:
            depth = a["depth"]
        div = float(rng.choice([0.0, 0.01, 0.3, 0.8]))
        a, b = pd.observe(float(t), div, interval), \
            jd.observe(float(t), div, interval)
        assert a == b and pd.gate_state() == jd.gate_state()
        if a is not None:
            interval = a["interval_sec"]


def test_render_tune_equals_the_jax_jubactl():
    from jubatus_tpu.cmd.jubactl import render_tune as jrender
    from jubatus_tpu_torch.cmd.jubactl import render_tune

    ad = FakeAdapter()
    ad.rounds, ad.arrival, ad.divergence = 1, 3e4, 0.9
    tuner, _ = mk_tuner(ad)
    for i in range(12):
        ad.rounds += 1
        rules = ["tune.cadence.apply:error"] if i == 5 else []
        with faults.armed(*rules):
            tuner.tick(10.0 + i)
    docs = {"127.0.0.1_9200": tuner.status(), "127.0.0.1_9201": {},
            "127.0.0.1_9202": dict(tuner.status(), mode="observe",
                                   backoff_s=4.0)}
    for last in (0, 3, 8):
        assert render_tune("regression", "t", docs, last=last) == \
            jrender("regression", "t", docs, last=last)
