"""The port's collective mixer (jubatus_tpu_torch/framework/
collective_mixer.py) against the JAX package's
(tests/test_collective_mixer.py): the prepare/GO protocol, its failure
model, the signature (with the port's backend tag), the wire plan, the
topology and the representative election, in process on the CPU; then
port fleets of server processes that mix collectively over gloo, and a
mixed JAX/port fleet whose rounds fall back to the RPC mix and fold to
the JAX-only fleet's model."""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jubatus_tpu.framework.collective_mixer as jcm
from jubatus_tpu.client import ClassifierClient as JClassifierClient
from jubatus_tpu.coord.file import FileCoordinator as JFileCoordinator
from jubatus_tpu.server import EngineServer as JEngineServer
from jubatus_tpu.server.args import ServerArgs as JServerArgs
from jubatus_tpu.server.args import parse_server_args as jparse
import jubatus_tpu_torch.framework.collective_mixer as cm
from jubatus_tpu_torch.coord.file import FileCoordinator
from jubatus_tpu_torch.coord.memory import MemoryCoordinator, _Store
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.parallel import collective, multihost
from jubatus_tpu_torch.parallel.mesh import host_topology
from jubatus_tpu_torch.rpc.client import (ClassifierClient, RegressionClient,
                                          RpcClient)
from jubatus_tpu_torch.server import EngineServer
from jubatus_tpu_torch.server.args import ServerArgs, parse_server_args
from jubatus_tpu_torch.utils.serialization import pack_obj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "cm"
CONF = {"method": "PA", "parameter": {"regularization_weight": 1.0},
        "converter": {"num_rules": [{"key": "*", "type": "num"}]}}
#: every fleet of server processes here is killed past this
FLEET_TIMEOUT = 60.0
DEFAULT_SIG_TAIL = f"|chunk={collective.DEFAULT_CHUNK_MB}{cm.BACKEND_TAG}"


def _server(store, **kw):
    args = ServerArgs(engine="classifier", coordinator="(shared)",
                      name=NAME, listen_addr="127.0.0.1",
                      mixer="collective_mixer", interval_sec=1e9,
                      interval_count=1 << 30, **kw)
    srv = EngineServer("classifier", CONF, args, device="cpu",
                       coord=MemoryCoordinator(store))
    srv.start(0)
    return srv


def _trained(srv):
    c = ClassifierClient("127.0.0.1", srv.args.rpc_port, NAME)
    c.train([["pos", Datum({"a": 1.0})]])
    return c


def test_world_mismatch_falls_back_to_rpc_mix():
    """Two replicas in ONE process (a world of one) cannot span a
    collective: the round mixes over RPC and still converges."""
    store = _Store()
    servers = [_server(store) for _ in range(2)]
    try:
        c0 = ClassifierClient("127.0.0.1", servers[0].args.rpc_port, NAME)
        c1 = ClassifierClient("127.0.0.1", servers[1].args.rpc_port, NAME)
        for _ in range(4):
            c0.train([["pos", Datum({"a": 1.0})]])
            c1.train([["neg", Datum({"b": 1.0})]])
        assert c0.do_mix() is True
        st = next(iter(servers[0].get_status().values()))
        assert st["mixer.fallback_rounds"] >= 1
        assert st["mixer.collective_rounds"] == 0
        rec = [r for r in servers[0].mixer.flight.snapshot()
               if r.get("mode") == "collective"]
        assert "world_mismatch: 1 ranks vs 2 members" in rec[-1]["reason"]
        (r1,) = c1.classify([Datum({"a": 1.0})])
        scores = dict(r1)
        assert scores["pos"] > scores["neg"]
        c0.close()
        c1.close()
    finally:
        for s in servers:
            s.stop()


def test_prepared_member_discards_stage_without_go(monkeypatch):
    monkeypatch.setattr(cm, "GO_WAIT_SEC", 0.4)
    srv = _server(_Store(), interconnect_timeout=0.1)
    try:
        c = _trained(srv)
        entered = []
        srv.mixer._enter_collective = \
            lambda *a, **k: entered.append(a) or False
        _version, sig = srv.mixer.local_prepare("ghost-round", [])
        assert sig != "unsupported"
        assert "ghost-round" in srv.mixer._staged
        deadline = time.time() + 5
        while time.time() < deadline and srv.mixer._staged:
            time.sleep(0.05)
        assert not srv.mixer._staged, "staged diff not discarded"
        assert not entered, "entered a collective without GO"
        rec = srv.mixer.flight.snapshot()[-1]
        assert rec["reason"] == "go_timeout_verified_absent"
        srv.mixer.local_prepare("aborted-round", [])
        assert srv.mixer.local_abort("aborted-round") is True
        assert not srv.mixer._staged
        c.close()
    finally:
        srv.stop()


def test_go_timeout_with_unreadable_coordinator_tears_world_down(
        monkeypatch):
    """GO window expired and the coordinator unreadable: the member
    destroys its process group (peers' collectives then raise within the
    group's timeout), routes later rounds to RPC, and its readiness
    reports collective_dead."""
    monkeypatch.setattr(cm, "GO_WAIT_SEC", 0.4)
    srv = _server(_Store(), interconnect_timeout=0.1)
    try:
        c = _trained(srv)
        entered, killed = [], []
        srv.mixer._enter_collective = \
            lambda *a, **k: entered.append(a) or False
        monkeypatch.setattr(multihost, "shutdown", lambda: killed.append(1))

        def dead_read(path):
            raise RuntimeError("coordinator unreachable")

        monkeypatch.setattr(srv.mixer.comm.coord, "read", dead_read)
        srv.mixer.local_prepare("dark-round", [])
        deadline = time.time() + 5
        while time.time() < deadline and not killed:
            time.sleep(0.05)
        assert killed, "world not torn down on unverifiable GO absence"
        assert not entered
        assert not srv.mixer._staged
        assert srv.mixer.collective_dead
        _version, sig = srv.mixer.local_prepare("next-round", [])
        assert sig == "unsupported"
        srv.mixer.local_abort("next-round")
        st = next(iter(srv.get_status().values()))
        assert st["health.status"] == "degraded"
        assert {"kind": "collective_dead"} in st["health.reasons"]
        assert st["mixer.collective_dead"] is True
        c.close()
    finally:
        srv.stop()


def test_go_observed_only_at_final_check_still_enters(monkeypatch):
    monkeypatch.setattr(cm, "GO_WAIT_SEC", 0.4)
    srv = _server(_Store(), interconnect_timeout=0.1)
    try:
        c = _trained(srv)
        entered = []
        srv.mixer._enter_collective = \
            lambda rid, base, *a: entered.append((rid, base)) or True
        go = pack_obj({"rid": "late-round", "base": 7})
        srv.mixer._go_wait = lambda: 0.0
        monkeypatch.setattr(srv.mixer.comm.coord, "read", lambda p: go)
        srv.mixer.local_prepare("late-round", [])
        deadline = time.time() + 5
        while time.time() < deadline and not entered:
            time.sleep(0.05)
        assert entered and entered[0] == ("late-round", 7)
        assert not srv.mixer.collective_dead
        c.close()
    finally:
        srv.stop()


def test_64bit_diff_signature_stays_bare_unsupported():
    srv = _server(_Store(), mix_bf16=True, mix_compress="bf16")
    try:
        _v, sig = srv.mixer.local_prepare("r1", [])
        assert sig.endswith(f"|bf16=1{DEFAULT_SIG_TAIL}"), sig
        srv.mixer.local_abort("r1")
        mixable = srv.driver.get_mixables()["classifier"]
        orig = mixable.__class__.get_device_diff

        def poisoned(self):
            d = orig(self)
            d["poison"] = np.zeros(4, np.float64)
            return d

        import unittest.mock as um
        with um.patch.object(mixable.__class__, "get_device_diff", poisoned):
            _v, sig = srv.mixer.local_prepare("r2", [])
        assert sig == "unsupported", sig
        srv.mixer.local_abort("r2")
    finally:
        srv.stop()


def test_psum_pytree_phase_instrumentation():
    diff = {"w": np.ones((512, 512), np.float32),
            "b": np.arange(32, dtype=np.float32)}
    phases: dict = {}
    total = collective.psum_pytree(diff, phases=phases)
    np.testing.assert_allclose(total["w"], diff["w"])
    np.testing.assert_allclose(total["b"], diff["b"])
    for k in ("cast_ms", "ship_ms", "reduce_ms", "readback_ms",
              "payload_mb", "wire_mb_ring_model"):
        assert k in phases and phases[k] >= 0.0, (k, phases)
    f32_payload = phases["payload_mb"]
    assert f32_payload == round((512 * 512 + 32) * 4 / 2**20, 2)
    bf16_phases: dict = {}
    total_c = collective.psum_pytree(diff, compress=True,
                                     phases=bf16_phases)
    assert total_c["w"].dtype == np.float32
    np.testing.assert_allclose(total_c["w"], diff["w"], rtol=1e-2)
    assert bf16_phases["payload_mb"] == round(f32_payload / 2, 2)


def test_prepare_signature_per_compress_mode():
    """Three wire modes, three signatures, each the JAX package's suffix
    format with the port's backend tag at the end; the bool still signs
    as bf16."""
    srv = _server(_Store())
    try:
        c = _trained(srv)
        sigs = {}
        for mode in ("off", "bf16", "int8"):
            srv.mixer.compress = mode
            _v, sigs[mode] = srv.mixer.local_prepare(f"r-{mode}", [])
            srv.mixer.local_abort(f"r-{mode}")
        assert sigs["off"].endswith(f"|bf16=0{DEFAULT_SIG_TAIL}")
        assert sigs["bf16"].endswith(f"|bf16=1{DEFAULT_SIG_TAIL}")
        assert sigs["int8"].endswith(
            f"|bf16=0|quant=int8:{collective.QUANT_BLOCK}"
            f"{DEFAULT_SIG_TAIL}")
        assert len(set(sigs.values())) == 3
        srv.mixer.compress = True
        _v, sig_bool = srv.mixer.local_prepare("r-bool", [])
        srv.mixer.local_abort("r-bool")
        assert sig_bool == sigs["bf16"]
        c.close()
    finally:
        srv.stop()


def test_topology_rides_prepare_signature(monkeypatch):
    """Eight logical CPU lanes stand in for the JAX tests' virtual
    devices: flat signs no topology, an explicit or derived one appends
    ``|topo=NxM`` before the backend tag."""
    monkeypatch.setattr(multihost, "local_devices",
                        lambda: [torch.device("cpu")] * 8)
    store = _Store()
    sigs = {}
    for topo in ("", "2x4", "4x2", "auto"):
        srv = _server(store, mix_topology=topo)
        try:
            c = _trained(srv)
            _v, sigs[topo] = srv.mixer.local_prepare(
                f"r-{topo or 'flat'}", [])
            srv.mixer.local_abort(f"r-{topo or 'flat'}")
            c.close()
        finally:
            srv.stop()
    base = sigs[""][: -len(cm.BACKEND_TAG)]
    assert sigs[""].endswith(f"|bf16=0{DEFAULT_SIG_TAIL}")
    assert "|topo=" not in sigs[""]
    assert sigs["2x4"] == base + "|topo=2x4" + cm.BACKEND_TAG
    assert sigs["4x2"] == base + "|topo=4x2" + cm.BACKEND_TAG
    assert sigs["auto"] == base + "|topo=1x8" + cm.BACKEND_TAG
    assert len(set(sigs.values())) == 4


def test_topology_mismatch_falls_back_to_rpc_mix(monkeypatch):
    """Members resolving different tier shapes mismatch at prepare; the
    world-size gate is forced open so the signature is what routes the
    round to the RPC mix."""
    monkeypatch.setattr(multihost, "local_devices",
                        lambda: [torch.device("cpu")] * 8)
    store = _Store()
    servers = [_server(store, mix_topology=t) for t in ("2x4", "")]
    try:
        c0 = ClassifierClient("127.0.0.1", servers[0].args.rpc_port, NAME)
        c1 = ClassifierClient("127.0.0.1", servers[1].args.rpc_port, NAME)
        for _ in range(4):
            c0.train([["pos", Datum({"a": 1.0})]])
            c1.train([["neg", Datum({"b": 1.0})]])
        monkeypatch.setattr(collective, "world_size", lambda: 2)
        assert c0.do_mix() is True
        st = next(iter(servers[0].get_status().values()))
        assert st["mixer.fallback_rounds"] >= 1
        assert st["mixer.collective_rounds"] == 0
        rec = [r for r in servers[0].mixer.flight.snapshot()
               if r.get("mode") == "collective" and not r.get("ok")]
        assert rec and "prepare_not_viable" in rec[-1]["reason"], rec
        (r1,) = c1.classify([Datum({"a": 1.0})])
        scores = dict(r1)
        assert scores["pos"] > scores["neg"]
        c0.close()
        c1.close()
    finally:
        for s in servers:
            s.stop()


def test_representative_election_deterministic_and_degraded_stable():
    """The same fronts as the JAX package's election, for every layout."""
    from jubatus_tpu.parallel.mesh import host_topology as jhost_topology

    topo = host_topology(devices=["cpu"] * 8, override="2x4")
    jtopo = jhost_topology(override="2x4")
    names = [f"m{i}:920{i}" for i in range(8)]
    for members in (names, list(reversed(names)), names[:2], names[:5]):
        assert cm.elect_representatives(members, topo) == \
            jcm.elect_representatives(members, jtopo)
    assert cm.elect_representatives(names, topo) == \
        {0: "m0:9200", 1: "m4:9204"}
    assert cm.elect_representatives(names[:5], topo) == {}
    assert cm.elect_representatives(names, None) == {}


def test_status_reports_topology_and_local_devices(monkeypatch):
    monkeypatch.setattr(multihost, "local_devices",
                        lambda: [torch.device("cpu")] * 8)
    srv = _server(_Store(), mix_topology="2x4")
    try:
        st = srv.mixer.get_status()
        assert st["mix_topology"] == "2x4"
        assert st["mix_caps_local_devices"] == 8
        assert st["mix_caps_topology"] == "1x8"
        assert st["mix_caps_world"] == 1
        assert st["mix_caps_backend"] == "cpu"
    finally:
        srv.stop()


def test_unresolvable_topology_degrades_to_flat():
    srv = _server(_Store(), mix_topology="64x64")
    try:
        c = _trained(srv)
        _v, sig = srv.mixer.local_prepare("r-big", [])
        srv.mixer.local_abort("r-big")
        assert "|topo=" not in sig and sig.endswith(cm.BACKEND_TAG)
        assert srv.mixer.get_status()["mix_topology"] == "flat"
        c.close()
    finally:
        srv.stop()


def test_ef_residual_survives_failed_collective_entry(monkeypatch):
    srv = _server(_Store(), mix_compress="int8")
    try:
        c = _trained(srv)
        assert srv.mixer.get_status()["mix_compress"] == "int8"
        ef = collective.ErrorFeedback()
        ef.rounds = 3
        ef.key = ("sentinel",)
        srv.mixer.ef = ef
        srv.mixer.local_prepare("r-abort", [])
        assert srv.mixer.local_abort("r-abort") is True
        assert ef.rounds == 3 and ef.key == ("sentinel",)

        def boom(*a, **k):
            raise RuntimeError("world torn down")

        monkeypatch.setattr(collective, "psum_pytree", boom)
        srv.mixer.local_prepare("r-fail", [])
        with pytest.raises(RuntimeError, match="world torn down"):
            srv.mixer._enter_collective("r-fail", 0)
        assert ef.rounds == 3 and ef.key == ("sentinel",)
        c.close()
    finally:
        srv.stop()


def test_set_wire_plan_resigns_prepare_and_stages_plan():
    srv = _server(_Store())
    try:
        c = _trained(srv)
        _v, sig_a = srv.mixer.local_prepare("r-a", [])
        srv.mixer.local_abort("r-a")
        st = srv.mixer.set_wire_plan(chunk_mb=2.0, compress="bf16")
        assert st == {"chunk_mb": 2.0, "compress": "bf16",
                      "plan_version": 1}
        _v, sig_b = srv.mixer.local_prepare("r-b", [])
        assert sig_b.endswith("|bf16=1|chunk=2.0" + cm.BACKEND_TAG), sig_b
        assert sig_b != sig_a
        assert srv.mixer._staged["r-b"]["plan"] == \
            {"mode": "bf16", "chunk_mb": 2.0}
        srv.mixer.set_wire_plan(chunk_mb=16.0, compress="int8")
        assert srv.mixer._staged["r-b"]["plan"] == \
            {"mode": "bf16", "chunk_mb": 2.0}
        srv.mixer.local_abort("r-b")
        _v, sig_c = srv.mixer.local_prepare("r-c", [])
        srv.mixer.local_abort("r-c")
        assert sig_c.endswith(
            f"|bf16=0|quant=int8:{collective.QUANT_BLOCK}|chunk=16.0"
            + cm.BACKEND_TAG), sig_c
        status = srv.mixer.get_status()
        assert status["mix_chunk_mb"] == 16.0
        assert status["mix_plan_version"] == 2
        c.close()
    finally:
        srv.stop()


def test_signatures_of_the_two_packages_never_match():
    """The JAX member and the port member stage the same PA model; their
    signatures differ (the backend tag, the port's dtype and structure
    spelling), so the master's one-signature check always fails."""
    store = _Store()
    srv = _server(store)
    from jubatus_tpu.coord.memory import MemoryCoordinator as JMemory
    from jubatus_tpu.coord.memory import _Store as JStore

    jsrv = JEngineServer("classifier", CONF, JServerArgs(
        engine="classifier", coordinator="(shared)", name=NAME,
        listen_addr="127.0.0.1", mixer="collective_mixer",
        interval_sec=1e9, interval_count=1 << 30),
        coord=JMemory(JStore()))
    jsrv.start(0)
    try:
        c = _trained(srv)
        _v, sig = srv.mixer.local_prepare("r", [])
        _jv, jsig = jsrv.mixer.local_prepare("r", [])
        srv.mixer.local_abort("r")
        jsrv.mixer.local_abort("r")
        assert sig != jsig
        assert sig.endswith(cm.BACKEND_TAG)
        assert not jsig.endswith(cm.BACKEND_TAG)
        c.close()
    finally:
        srv.stop()
        jsrv.stop()


def test_collective_flags_parse_as_in_jax():
    """The six flags, with the JAX package's names and defaults; the
    deprecated --mix-bf16 resolves to bf16 unless --mix-compress says
    otherwise."""
    fields = ("jax_coordinator", "jax_processes", "jax_process_id",
              "mix_compress", "mix_bf16", "mix_topology")
    for argv in (["classifier", "-f", "/dev/null"],
                 ["classifier", "-f", "/dev/null", "-x", "collective_mixer",
                  "--jax-coordinator", "10.0.0.1:8476", "--jax-processes",
                  "4", "--jax-process-id", "2", "--mix-topology", "2x2",
                  "--mix-compress", "int8"],
                 ["classifier", "-f", "/dev/null", "--mix-bf16"],
                 ["classifier", "-f", "/dev/null", "--mix-bf16",
                  "--mix-compress", "int8"]):
        got, want = parse_server_args(argv), jparse(argv)
        for f in fields:
            assert getattr(got, f) == getattr(want, f), (argv, f)
        assert got.mixer == want.mixer
    with pytest.raises(SystemExit):
        parse_server_args(["classifier", "-f", "/dev/null",
                           "--mix-compress", "int4"])


# -- fleets of server processes ------------------------------------------------

def _datum(engine, feature, label_or_value):
    if engine == "classifier":
        return [label_or_value, Datum({feature: 1.0})]
    return [label_or_value, Datum({feature: 1.0})]


def _start_fleet(tmp_path, engine, config, n, extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # the members share the host with the suite's other workers
    env["OMP_NUM_THREADS"] = "2"
    port = multihost.free_port()
    procs, logs = [], []
    for r in range(n):
        argv = [sys.executable, "-m", "jubatus_tpu_torch.server", engine,
                "-f", os.path.join(REPO, "config", engine, config),
                "-z", f"file://{tmp_path}/coord", "-n", NAME,
                "-b", "127.0.0.1", "-p", "0", "-x", "collective_mixer",
                "-s", "1e9", "-i", str(1 << 30), "--device", "cpu",
                "--jax-processes", str(n), "--jax-process-id", str(r),
                *extra]
        if r == 0:
            argv += ["--jax-coordinator", f"127.0.0.1:{port}"]
        log = open(tmp_path / f"server{r}.log", "w+")
        logs.append(log)
        procs.append(subprocess.Popen(argv, stdout=log,
                                      stderr=subprocess.STDOUT, env=env,
                                      cwd=REPO))
    return procs, logs


def _ports(procs, logs, deadline):
    ports = [None] * len(procs)
    while time.monotonic() < deadline and None in ports:
        for i, log in enumerate(logs):
            log.seek(0)
            text = log.read()
            if "serving on port" in text:
                ports[i] = int(text.split("serving on port ")[1].split()[0])
            elif procs[i].poll() is not None:
                raise AssertionError(f"server {i} exited:\n{text[-3000:]}")
        time.sleep(0.1)
    assert None not in ports, "fleet did not boot in time"
    return ports


def _stop_fleet(procs, logs):
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in procs:
        try:
            p.wait(10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    for log in logs:
        log.close()


@pytest.mark.parametrize("engine,config,n,extra", [
    ("classifier", "arow.json", 2, []),
    ("classifier", "arow.json", 4, ["--mix-topology", "2x2",
                                    "--mix-compress", "int8"]),
    ("regression", "default.json", 2, ["--mix-compress", "bf16"]),
], ids=["arow-flat-off", "arow-2x2-int8", "regression-bf16"])
def test_port_fleet_mixes_collectively_over_gloo(tmp_path, engine, config,
                                                 n, extra):
    """A port fleet of server processes, one rank each of one gloo world:
    ``do_mix`` runs ONE collective round (no fallback), every member
    applies it, and a replica answers for a feature only a peer
    trained."""
    deadline = time.monotonic() + FLEET_TIMEOUT
    procs, logs = _start_fleet(tmp_path, engine, config, n, extra)
    try:
        ports = _ports(procs, logs, deadline)
        Client = ClassifierClient if engine == "classifier" \
            else RegressionClient
        clients = [Client("127.0.0.1", p, NAME, timeout=30) for p in ports]
        for r, c in enumerate(clients):
            rows = [_datum(engine, f"x{r}", "pos" if engine == "classifier"
                           else 1.0 + r)] * 8
            if engine == "classifier":
                rows += [_datum(engine, f"y{r}", "neg")] * 8
            c.train(rows)
        with RpcClient("127.0.0.1", ports[0], timeout=30) as rc:
            while time.monotonic() < deadline:
                (st,) = rc.call("get_status", NAME).values()
                if st.get("mixer.mix_caps_world") == n:
                    break
                time.sleep(0.1)
        assert clients[0].do_mix() is True
        for p in ports:
            with RpcClient("127.0.0.1", p, timeout=30) as rc:
                while time.monotonic() < deadline:
                    (st,) = rc.call("get_status", NAME).values()
                    if st["mixer.model_version"] >= 1:
                        break
                    time.sleep(0.1)
                assert st["mixer.model_version"] >= 1
                assert st["mixer.mix_caps_backend"] == "gloo"
                hist = rc.call("get_mix_history", NAME)
            col = [h for h in hist if h.get("mode") == "collective"
                   and h.get("ok")]
            assert col, hist
            ph = col[-1]["phases"]
            for key in ("ship_ms", "reduce_ms", "readback_ms", "chunks",
                        "quant", "wire_mb", "topo"):
                assert key in ph, (key, ph)
        with RpcClient("127.0.0.1", ports[0], timeout=30) as rc:
            (st,) = rc.call("get_status", NAME).values()
        assert st["mixer.collective_rounds"] == 1
        assert st["mixer.fallback_rounds"] == 0
        for r, c in enumerate(clients):
            other = f"x{(r + 1) % n}"
            if engine == "classifier":
                (res,) = c.classify([Datum({other: 1.0})])
                scores = dict(res)
                assert scores["pos"] > scores.get("neg", 0.0), scores
            else:
                (est,) = c.estimate([Datum({other: 1.0})])
                assert est > 0.0, est
            c.close()
    finally:
        _stop_fleet(procs, logs)


# -- the mixed JAX/port fleet -------------------------------------------------------

MIX_CONF = {"method": "PA", "parameter": {"regularization_weight": 1.0},
            "converter": {"num_rules": [{"key": "*", "type": "num"}]}}


def _jax_member(coord_dir, mixer):
    srv = JEngineServer("classifier", MIX_CONF, JServerArgs(
        engine="classifier", coordinator="(shared)", name="mixed",
        listen_addr="127.0.0.1", interval_sec=1e9, interval_count=1 << 30,
        microbatch_max=0, mixer=mixer), coord=JFileCoordinator(coord_dir))
    srv.start(0)
    return srv


def _port_member(coord_dir, mixer):
    srv = EngineServer("classifier", MIX_CONF, ServerArgs(
        engine="classifier", coordinator="(shared)", name="mixed",
        listen_addr="127.0.0.1", interval_sec=1e9, interval_count=1 << 30,
        microbatch_max=0, mixer=mixer), device="cpu",
        coord=FileCoordinator(coord_dir))
    srv.start(0)
    return srv


def _halves(n=40, seed=5):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        label = "abc"[i % 3]
        feats = {f"f{j}": float(np.round(rng.standard_normal(), 3))
                 for j in rng.choice(12, 4, replace=False)}
        feats["bias"] = {"a": 1.0, "b": -1.0, "c": 0.5}[label]
        rows.append([label, Datum(feats)])
    return rows[0::2], rows[1::2]


def _fleet(members, coord_dir, master):
    srvs = [make(coord_dir, "collective_mixer") for make in members]
    try:
        for srv, half in zip(srvs, _halves()):
            with ClassifierClient("127.0.0.1", srv.args.rpc_port,
                                  "mixed") as c:
                assert c.train(half) == len(half)
        with ClassifierClient("127.0.0.1", srvs[master].args.rpc_port,
                              "mixed") as c:
            assert c.do_mix() is True
        post = [s.driver.pack() for s in srvs]
        recs = [r for r in srvs[master].mixer.flight.snapshot()
                if r.get("mode") == "collective"]
        for s in srvs:
            (st,) = JClassifierClient(
                "127.0.0.1", s.args.rpc_port, "mixed").get_status().values()
            assert st["mixer.model_version"] == 1
            assert st["mixer.collective_rounds"] == 0
        return post, recs
    finally:
        for s in srvs:
            s.stop()


@pytest.mark.parametrize("master", ["jax", "port"])
def test_mixed_jax_port_fleet_falls_back_to_rpc(master, tmp_path,
                                                monkeypatch):
    """A JAX member and a port member, both under collective_mixer on one
    file:// coordinator. The master's world check is forced to see two
    ranks, so the prepare is what decides: the signatures differ by the
    backend tag, the round falls back to the RPC mix, and both members
    hold the model a JAX-only fleet folds, bit for bit."""
    import jax

    want, _ = _fleet([_jax_member, _jax_member], str(tmp_path / "jj"), 0)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(collective, "world_size", lambda: 2)
    got, recs = _fleet([_jax_member, _port_member], str(tmp_path / "jp"),
                       0 if master == "jax" else 1)
    assert recs and "prepare_not_viable" in recs[-1]["reason"], recs
    assert "1 signatures" not in recs[-1]["reason"]
    for member in got:
        for key in ("w", "prec", "label_counts"):
            assert np.array_equal(np.asarray(member[key]),
                                  np.asarray(want[0][key])), key
