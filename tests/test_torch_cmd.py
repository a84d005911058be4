"""The port's ops CLIs (jubatus_tpu_torch/cmd/): ``jubaconfig``, the
``jubavisor`` daemon and ``jubactl``'s start / save / status / stop of a
port child over the coordination service, ``restore``, ``rollback`` and
``breakers``; the ports of tests/test_elastic.py:274 (a drain with no
client errors through the proxy), :477 (jubactl drain and rebalance) and
:511 (status and watch carry the epoch and drain state), and of
tests/test_async_mix.py:593 (the watch row shows the async lag). Every
wait polls a registry or a status against a deadline."""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from jubatus_tpu_torch.cmd import jubaconfig, jubactl
from jubatus_tpu_torch.coord import membership
from jubatus_tpu_torch.coord.memory import MemoryCoordinator, _Store
from jubatus_tpu_torch.coord.remote import RemoteCoordinator
from jubatus_tpu_torch.coord.server import CoordServer
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.rpc.client import ClassifierClient, RpcClient
from jubatus_tpu_torch.server import EngineServer
from jubatus_tpu_torch.server.args import ServerArgs
from jubatus_tpu_torch.server.proxy import Proxy, ProxyArgs

ROOT = os.path.join(os.path.dirname(__file__), "..")
WAIT_S = 60.0

ENGINE = "nearest_neighbor"
NAME = "nn"
NN_CONF = {"method": "lsh", "parameter": {"hash_num": 8},
           "converter": {"num_rules": [{"key": "*", "type": "num"}]}}


def _wait(pred, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture()
def coordd():
    srv = CoordServer(lease_sec=3.0)
    port = srv.start(0, host="127.0.0.1")
    yield f"tcp://127.0.0.1:{port}", port
    srv.stop()


def _write_conf(tmp_path, conf, name="conf.json"):
    path = tmp_path / name
    path.write_text(json.dumps(conf))
    return str(path)


# -- jubaconfig ------------------------------------------------------------------

def test_jubaconfig_write_read_list_delete(coordd, tmp_path, capsys):
    locator, port = coordd
    path = _write_conf(tmp_path, {"window_size": 8})
    assert jubaconfig.main(["-c", "write", "-t", "stat", "-n", "s1", "-f",
                            path, "-z", locator, "--device", "cpu"]) == 0
    assert "wrote config for stat/s1" in capsys.readouterr().out
    # a second write replaces the stored config
    path2 = _write_conf(tmp_path, {"window_size": 16}, "conf2.json")
    assert jubaconfig.main(["-c", "write", "-t", "stat", "-n", "s1", "-f",
                            path2, "-z", locator, "--device", "cpu"]) == 0
    capsys.readouterr()
    assert jubaconfig.main(["-c", "read", "-t", "stat", "-n", "s1",
                            "-z", locator]) == 0
    assert json.loads(capsys.readouterr().out) == {"window_size": 16}
    view = RemoteCoordinator("127.0.0.1", port)
    try:
        assert view.read(membership.config_path("stat", "s1")) == \
            json.dumps({"window_size": 16}).encode()
    finally:
        view.close()
    assert jubaconfig.main(["-c", "list", "-z", locator]) == 0
    assert capsys.readouterr().out.split() == ["stat/s1"]
    assert jubaconfig.main(["-c", "delete", "-t", "stat", "-n", "s1",
                            "-z", locator]) == 0
    assert jubaconfig.main(["-c", "read", "-t", "stat", "-n", "s1",
                            "-z", locator]) == 1


@pytest.mark.parametrize("case", ["bad_json", "unknown_engine",
                                  "rejected_by_driver", "no_name",
                                  "no_coordinator"])
def test_jubaconfig_refuses(coordd, tmp_path, capsys, monkeypatch, case):
    locator, _ = coordd
    path = _write_conf(tmp_path, {"method": "no-such-method"})
    if case == "bad_json":
        (tmp_path / "conf.json").write_text("{not json")
    args = ["-c", "write", "-t", "classifier", "-n", "c", "-f", path,
            "-z", locator, "--device", "cpu"]
    if case == "unknown_engine":
        args[3] = "nope"
    if case == "no_name":
        args = args[:4] + args[6:]
    if case == "no_coordinator":
        monkeypatch.delenv("JUBATUS_COORDINATOR", raising=False)
        monkeypatch.delenv("ZK", raising=False)
        args = args[:8] + args[10:]
    assert jubaconfig.main(args) == 1
    err = capsys.readouterr().err
    assert {"bad_json": "invalid JSON", "unknown_engine": "unknown engine",
            "rejected_by_driver": "config rejected by classifier driver",
            "no_name": "without -t and -n",
            "no_coordinator": "no coordinator"}[case] in err


# -- jubavisor + jubactl start / save / status / stop -----------------------------

def _children_of(pid: int):
    """The live child processes of ``pid`` (from /proc)."""
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid and fields[0] != "Z":
            out.append(int(entry))
    return out


def test_jubavisor_and_jubactl_drive_a_port_child(coordd, tmp_path, capsys):
    locator, port = coordd
    path = _write_conf(tmp_path, {"window_size": 8})
    assert jubaconfig.main(["-c", "write", "-t", "stat", "-n", "v1", "-f",
                            path, "-z", locator, "--device", "cpu"]) == 0
    vport = _free_port()
    visor = subprocess.Popen(
        [sys.executable, "-m", "jubatus_tpu_torch.cmd.jubavisor", "-z",
         locator, "-p", str(vport), "-m", "4", "--device", "cpu",
         "-l", str(tmp_path / "children.log")],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    view = RemoteCoordinator("127.0.0.1", port)
    ctl = ["-t", "stat", "-n", "v1", "-z", locator]
    try:
        assert _wait(lambda: view.list(membership.SUPERVISOR_BASE)), \
            "the visor never registered"
        assert jubactl.main(["-c", "start", "-N", "1", "-B", "127.0.0.1",
                             "-D", str(tmp_path), *ctl]) == 0
        assert _wait(lambda: membership.get_all_actives(
            view, "stat", "v1")), "the child never joined"
        (node,) = membership.get_all_nodes(view, "stat", "v1")
        assert vport < node.port <= vport + 4  # from the visor's pool
        with RpcClient(node.host, node.port, timeout=30.0) as c:
            c.call("push", "v1", "k", 2.0)
            (st,) = c.call("get_status", "v1").values()
        assert st["driver.device"] == "cpu"
        capsys.readouterr()
        assert jubactl.main(["-c", "save", "-i", "m1", *ctl]) == 0
        assert f"sending save / v1 to {node.name}...ok." in \
            capsys.readouterr().out
        assert any(f.endswith("_stat_m1.jubatus")
                   for f in os.listdir(tmp_path))
        assert jubactl.main(["-c", "status", "--all", *ctl]) == 0
        out = capsys.readouterr().out
        assert "stat/v1: 1 node(s), 1 active" in out
        assert f"{node.name}  [active]" in out
        assert "update_count: 1" in out
        assert jubactl.main(["-c", "stop", *ctl]) == 0
        assert _wait(lambda: not membership.get_all_nodes(
            view, "stat", "v1")), "the child never left"
        assert _wait(lambda: not _children_of(visor.pid))
    finally:
        view.close()
        visor.send_signal(signal.SIGTERM)
        try:
            visor.wait(timeout=30)
        except subprocess.TimeoutExpired:
            visor.kill()
            visor.wait(timeout=30)


def test_jubavisor_appends_its_server_flags(coordd, monkeypatch):
    """``--server-flags`` reaches every child's command line after the
    flags of the argv map, e.g. to start a fleet with the forensics
    plane's sampler off."""
    from jubatus_tpu_torch.cmd import jubavisor

    spawned = []

    class _Proc:
        pid = 1

    monkeypatch.setattr(jubavisor.subprocess, "Popen",
                        lambda cmd, **_kw: spawned.append(cmd) or _Proc())
    locator, _ = coordd
    visor = jubavisor.Jubavisor(
        locator, 0, 2, device="cpu",
        server_flags=["--profile-hz", "0", "--telemetry-interval", "0"])
    visor._pool = [40001, 40002]
    try:
        assert visor.start_procs("stat/v1", 2, {"thread": 2}) == 0
    finally:
        visor._children.clear()
        visor.coord.close()
    assert len(spawned) == 2
    for cmd in spawned:
        assert cmd[-6:] == ["--thread", "2", "--profile-hz", "0",
                            "--telemetry-interval", "0"]


def test_jubavisor_forwards_timeout_and_logdir(coordd, monkeypatch, tmp_path):
    """The argv map's ``timeout`` and ``logdir`` reach each child as
    ``--timeout`` / ``--logdir`` (as the JAX jubavisor sends them), and
    the port server's parser takes both."""
    from jubatus_tpu_torch.cmd import jubavisor
    from jubatus_tpu_torch.server.args import parse_server_args

    spawned = []

    class _Proc:
        pid = 1

    monkeypatch.setattr(jubavisor.subprocess, "Popen",
                        lambda cmd, **_kw: spawned.append(cmd) or _Proc())
    locator, _ = coordd
    visor = jubavisor.Jubavisor(locator, 0, 1, device="cpu")
    visor._pool = [40011]
    try:
        assert visor.start_procs(
            "jubastat/v2", 1,
            {"timeout": 7, "logdir": str(tmp_path), "thread": 3}) == 0
    finally:
        visor._children.clear()
        visor.coord.close()
    (cmd,) = spawned
    assert cmd[cmd.index("--timeout") + 1] == "7"
    assert cmd[cmd.index("--logdir") + 1] == str(tmp_path)
    argv = cmd[cmd.index("jubatus_tpu_torch.server") + 1:]
    args = parse_server_args(argv)
    assert (args.timeout, args.logdir, args.thread) == (7.0, str(tmp_path), 3)


# -- restore, rollback, breakers ---------------------------------------------------

CLF_CONF = {"method": "AROW", "parameter": {"regularization_weight": 1.0},
            "converter": {"num_rules": [{"key": "*", "type": "num"}]}}
PROBES = [{"f0": 0.5, "f1": -0.5}, {"f0": 1.5, "f1": 0.25}]


def _clf_server(tmp_path, store):
    os.makedirs(tmp_path / "data", exist_ok=True)
    srv = EngineServer("classifier", CLF_CONF, ServerArgs(
        engine="classifier", coordinator="(shared)", name="rs",
        listen_addr="127.0.0.1", datadir=str(tmp_path / "data"),
        store_dir=str(tmp_path / "store"), store_interval=30.0,
        interval_sec=1e9, interval_count=1 << 30), device="cpu",
        coord=MemoryCoordinator(store))
    srv.start(0)
    return srv


def _train(srv, n=30, labels="ab"):
    rng = np.random.default_rng(4)
    data = [(labels[i % 2], Datum({"f0": float(rng.standard_normal()),
                                   "f1": 1.0 if i % 2 else -1.0}))
            for i in range(n)]
    srv.driver.train(data)


def _answers(srv):
    with ClassifierClient("127.0.0.1", srv.args.rpc_port, "rs") as c:
        return [sorted(r) for r in c.classify([Datum(p) for p in PROBES])]


def test_jubactl_restore_brings_the_store_record_back(tmp_path, capsys):
    store = _Store()
    srv = _clf_server(tmp_path, store)
    try:
        _train(srv)
        srv.store_uploader.tick(srv.driver, int(srv.driver.update_count))
        want = _answers(srv)
        with ClassifierClient("127.0.0.1", srv.args.rpc_port, "rs") as c:
            assert c.clear() is True
        assert _answers(srv) != want
        view = MemoryCoordinator(store)
        assert jubactl.restore_fleet(view, "classifier", "rs", "",
                                     "latest") == 0
        assert " ok: model_version 30" in capsys.readouterr().out
        assert _answers(srv) == want
        # usage errors
        assert jubactl.restore_fleet(view, "classifier", "rs", "", "x") == 1
        assert jubactl.restore_fleet(view, "classifier", "rs", "nope",
                                     "latest") == 1
    finally:
        srv.stop()


def test_jubactl_rollback_restores_the_last_snapshot(tmp_path, capsys):
    store = _Store()
    srv = _clf_server(tmp_path, store)
    try:
        _train(srv)
        srv.take_snapshot()
        want = _answers(srv)
        _train(srv, labels="ba")  # the opposite lesson moves the model
        assert _answers(srv) != want
        view = MemoryCoordinator(store)
        target = srv.self_nodeinfo().name
        assert jubactl.rollback_member(view, "classifier", "rs",
                                       target) == 0
        assert f"rollback {target}... ok: model_version" in \
            capsys.readouterr().out
        assert _answers(srv) == want
    finally:
        srv.stop()


def test_jubactl_breakers_reads_every_proxy(capsys):
    store = _Store()
    srv = EngineServer("stat", {"window_size": 8}, ServerArgs(
        engine="stat", coordinator="(shared)", name="b",
        listen_addr="127.0.0.1", interval_sec=1e9, interval_count=1 << 30),
        device="cpu", coord=MemoryCoordinator(store))
    srv.start(0)
    proxy = Proxy(ProxyArgs(engine="stat", listen_addr="127.0.0.1"),
                  coord=MemoryCoordinator(store))
    proxy.start(0)
    try:
        with RpcClient("127.0.0.1", proxy.args.rpc_port) as c:
            c.call("push", "b", "k", 1.0)
        assert jubactl.show_breakers(MemoryCoordinator(store), "stat",
                                     "b") == 0
        out = capsys.readouterr().out
        assert "1 backend(s) tracked" in out
        assert f"127.0.0.1:{srv.args.rpc_port}" in out or \
            str(srv.args.rpc_port) in out
        assert "closed" in out
    finally:
        proxy.stop()
        srv.stop()


@pytest.mark.parametrize("cmd", ["autoscale", "tune"])
def test_jubactl_unported_commands_exit_with_their_roadmap_item(
        cmd, capsys, monkeypatch):
    """The two commands that once exited with their ROADMAP item (A21)
    now run: ``tune`` renders a member's tuner journal from ``get_tune``,
    ``autoscale --once`` takes one dry-run tick over the fleet's
    time series and renders its frame."""
    store = _Store()
    srv = EngineServer("stat", {"window_size": 8}, ServerArgs(
        engine="stat", coordinator="(shared)", name="x",
        listen_addr="127.0.0.1", interval_sec=1e9, interval_count=1 << 30,
        auto_tune="observe", telemetry_interval=0),
        device="cpu", coord=MemoryCoordinator(store))
    srv.start(0)
    monkeypatch.setattr(jubactl, "create_coordinator",
                        lambda spec: MemoryCoordinator(store))
    try:
        assert jubactl.main(["-c", cmd, "-t", "stat", "-n", "x", "-z",
                             "memory", "--once"]) == 0
        out, err = capsys.readouterr()
        assert "not yet ported" not in out + err
        if cmd == "tune":
            assert out.splitlines()[:2] == [
                "stat/x: auto-tune across 1 node(s)",
                f"  127.0.0.1_{srv.args.rpc_port}: mode observe"]
            assert "(no decisions journaled yet)" in out
        else:
            head = out.splitlines()[0]
            assert head.startswith("stat/x autoscaler  fleet 1 replica(s) "
                                   "[1..8]")
            assert head.endswith("[dry-run]")
            assert f"127.0.0.1_{srv.args.rpc_port}" in out
            assert "hold" in out
    finally:
        srv.stop()


def test_jubactl_tune_and_autoscale_wait_for_the_perf_tuner():
    """get_tune and the autoscaler (A21) are served: the port's jubactl
    takes every JAX command, and the eleven autoscale flags parse to the
    JAX jubactl's values."""
    assert not hasattr(jubactl, "NOT_YET_PORTED")
    from jubatus_tpu.cmd import jubactl as jjubactl

    def commands(mod):
        (action,) = [a for a in mod._parser()._actions
                     if "--cmd" in a.option_strings]
        return set(action.choices)

    assert commands(jubactl) == commands(jjubactl)
    argv = ["-c", "autoscale", "-t", "regression", "-n", "r", "--watch",
            "--min", "2", "--max", "3", "--autoscale-interval", "1",
            "--cooldown", "5", "--scale-out-confirm", "2",
            "--scale-in-confirm", "3", "--burn-hot", "1.5",
            "--queue-hot", "256", "--autoscale-port", "0", "--dry-run"]
    for extra in ([], argv[6:]):
        got = vars(jubactl._parser().parse_args(argv[:6] + extra))
        want = vars(jjubactl._parser().parse_args(argv[:6] + extra))
        assert got == {k: want[k] for k in got}
        for dest in ("watch", "as_min", "as_max", "autoscale_interval",
                     "cooldown", "scale_out_confirm", "scale_in_confirm",
                     "burn_hot", "queue_hot", "autoscale_port", "dry_run"):
            assert dest in got


def test_jubactl_forwards_timeout_and_logdir_to_the_visor(monkeypatch):
    """``-T`` / ``-L`` ride the start argv map as the JAX jubactl sends
    them (the port visor turns them into --timeout / --logdir)."""
    sent = []
    monkeypatch.setattr(jubactl, "send2supervisor",
                        lambda coord, cmd, engine, name, num, argv:
                        sent.append(argv) or 0)
    monkeypatch.setattr(jubactl, "create_coordinator",
                        lambda spec: MemoryCoordinator(_Store()))
    assert jubactl.main(["-c", "start", "-t", "stat", "-n", "x", "-z",
                         "memory", "-T", "7", "-L", "/logs"]) == 0
    (argv,) = sent
    assert (argv["timeout"], argv["logdir"]) == (7, "/logs")


# -- tests/test_elastic.py, on the port ---------------------------------------------

def _boot(store, auto_rebalance=True, drain_grace=0.2):
    args = ServerArgs(engine=ENGINE, coordinator="(shared)", name=NAME,
                      listen_addr="127.0.0.1", interval_sec=1e9,
                      interval_count=1 << 30,
                      auto_rebalance=auto_rebalance,
                      drain_grace=drain_grace)
    srv = EngineServer(ENGINE, NN_CONF, args, device="cpu",
                       coord=MemoryCoordinator(store))
    srv.start(0)
    return srv


def _client(srv) -> RpcClient:
    return RpcClient("127.0.0.1", srv.args.rpc_port, timeout=30.0)


def _datum(i: int) -> Datum:
    return Datum({"f0": float(i) + 1.0, "f1": float(i % 7) + 1.0})


def _drain_state(cli) -> str:
    state = cli.call("drain_status", NAME).get("state")
    return state.decode() if isinstance(state, bytes) else state


def _ids(cli):
    return {i.decode() if isinstance(i, bytes) else i
            for i in cli.call("get_all_rows", NAME)}


def test_proxy_reroutes_during_drain_no_client_errors():
    """Effectful CHT-routed writes through the proxy keep succeeding
    while a backend drains (NodeDraining -> ring refresh -> re-route,
    the double-dispatch window covering the swap)."""
    store = _Store()
    s1 = _boot(store)
    s2 = _boot(store)
    proxy = Proxy(ProxyArgs(engine=ENGINE, listen_addr="127.0.0.1",
                            interconnect_timeout=30.0),
                  coord=MemoryCoordinator(store))
    pport = proxy.start(0)
    pcli = RpcClient("127.0.0.1", pport, timeout=30.0)
    cli1 = _client(s1)
    try:
        for i in range(10):
            assert pcli.call("set_row", NAME, f"r{i}",
                             _datum(i).to_msgpack()) is True
        cli1.call("drain", NAME, False)
        for i in range(10, 30):
            assert pcli.call("set_row", NAME, f"r{i}",
                             _datum(i).to_msgpack()) is True
        assert _wait(lambda: _drain_state(cli1) == "drained")
        for i in range(30, 40):
            assert pcli.call("set_row", NAME, f"r{i}",
                             _datum(i).to_msgpack()) is True
        for i in range(0, 40, 7):
            assert isinstance(
                pcli.call("neighbor_row_from_id", NAME, f"r{i}", 3), list)
        with _client(s2) as c2:
            assert {f"r{i}" for i in range(40)} <= _ids(c2)
    finally:
        pcli.close()
        cli1.close()
        proxy.stop()
        s1.stop()
        s2.stop()


def test_jubactl_drain_and_rebalance(capsys):
    store = _Store()
    s1 = _boot(store)
    s2 = _boot(store)
    try:
        with _client(s1) as c1:
            for i in range(20):
                c1.call("set_row", NAME, f"row{i:03d}",
                        _datum(i).to_msgpack())
        view = MemoryCoordinator(store)
        assert jubactl.show_status(view, ENGINE, NAME) == 0
        assert "epoch 2" in capsys.readouterr().out
        assert jubactl.rebalance_cluster(view, ENGINE, NAME) == 0
        assert "rebalance complete" in capsys.readouterr().out
        target = s1.self_nodeinfo().name
        assert jubactl.drain_member(view, ENGINE, NAME, target) == 0
        assert "drained" in capsys.readouterr().out
        # bad target is a usage error
        assert jubactl.drain_member(view, ENGINE, NAME, "") == 1
        assert jubactl.drain_member(view, ENGINE, NAME, "nope") == 1
    finally:
        s1.stop()
        s2.stop()


def test_status_and_watch_carry_epoch_and_drain_state(capsys, monkeypatch):
    store = _Store()
    s1 = _boot(store)
    s2 = _boot(store)
    try:
        with _client(s1) as cli:
            doc = next(iter(cli.call("get_status", NAME).values()))
        assert doc.get("cluster.epoch") == 2
        assert doc.get("drain.state") == "active"
        assert "migration.rows_moved" in doc
        view = MemoryCoordinator(store)
        frame = jubactl.render_watch_frame(
            jubactl.collect_watch(view, ENGINE, NAME))
        assert "epoch 2" in frame
        assert "(2 server(s), 0 proxy(ies))" in frame
        # the CLI form prints the same frame
        assert jubactl.show_watch(view, ENGINE, NAME, once=True) == 0
        assert "epoch 2" in capsys.readouterr().out
        # live: full-frame refreshes every --interval until interrupted
        naps = []
        real_sleep = time.sleep

        def sleep(s):
            if threading.current_thread() is not threading.main_thread():
                return real_sleep(s)  # the servers' own threads
            naps.append(s)
            if len(naps) == 2:
                raise KeyboardInterrupt

        monkeypatch.setattr(time, "sleep", sleep)
        assert jubactl.show_watch(view, ENGINE, NAME, interval=1.5) == 0
        out = capsys.readouterr().out
        assert out.count("\x1b[2J\x1b[H") == 2 and "epoch 2" in out
        assert naps == [1.5, 1.5]
    finally:
        s1.stop()
        s2.stop()


def test_watch_row_shows_async_lag():
    row = jubactl._watch_node_row("n1", {"status": {
        "health.status": "ok", "mixer.async_mode": True,
        "mixer.async_lag_rounds": 2, "mixer.async_inbox_depth": 3,
        "mixer.model_version": 7}, "error": ""}, active=True)
    assert "lag 2" in row
    assert "inbox 3" in row
    assert "v7" in row


def test_rebalance_after_a_drain_without_stop_fails_as_in_jax(capsys):
    """ROADMAP C4, kept for parity: after ``drain`` without ``--stop`` the
    drained member stays registered under nodes/, ``rebalance`` reaches
    it, and its drain gate refuses the (effectful) rebalance, so the
    command returns -1 in both packages."""
    from jubatus_tpu.cmd import jubactl as jjubactl
    from jubatus_tpu.coord.memory import MemoryCoordinator as JMemory
    from jubatus_tpu.coord.memory import _Store as JStore
    from jubatus_tpu.server import EngineServer as JEngineServer
    from jubatus_tpu.server.args import ServerArgs as JServerArgs

    def run(pkg):
        if pkg == "jax":
            store = JStore()
            servers = [JEngineServer(ENGINE, NN_CONF, JServerArgs(
                engine=ENGINE, coordinator="(shared)", name=NAME,
                listen_addr="127.0.0.1", interval_sec=1e9,
                interval_count=1 << 30, drain_grace=0.2),
                coord=JMemory(store)) for _ in range(2)]
            for s in servers:
                s.start(0)
            view, ctl = JMemory(store), jjubactl
        else:
            store = _Store()
            servers = [_boot(store) for _ in range(2)]
            view, ctl = MemoryCoordinator(store), jubactl
        try:
            target = servers[0].self_nodeinfo().name
            assert ctl.drain_member(view, ENGINE, NAME, target) == 0
            capsys.readouterr()
            rc = ctl.rebalance_cluster(view, ENGINE, NAME)
            out = capsys.readouterr().out
            return rc, sorted(out.replace(target, "T").replace(
                servers[1].self_nodeinfo().name, "S").splitlines())
        finally:
            for s in servers:
                s.stop()

    want, got = run("jax"), run("port")
    assert got == want
    assert got[0] == -1
    assert "rebalance T... failed. (rebalance: node draining)" in got[1]
    assert "rebalance S... ok: 0 row(s), 0.0 MB/s" in got[1]


# -- jubaconv (tests/test_cmd.py's three cases, each against the JAX tool) ----

CONV_CONF = {
    "method": "PA",
    "parameter": {"regularization_weight": 1.0},
    "converter": {
        "string_rules": [{"key": "*", "type": "str",
                          "sample_weight": "bin", "global_weight": "bin"}],
        "num_rules": [{"key": "*", "type": "num"}]},
}


def _conv(tool, argv, text):
    import io

    out = io.StringIO()
    rc = tool.main(argv, stdin=io.StringIO(text), stdout=out)
    return rc, out.getvalue()


def test_jubaconv_json_to_datum():
    from jubatus_tpu.cmd import jubaconv as jjubaconv

    from jubatus_tpu_torch.cmd import jubaconv

    text = ('{"user": "alice", "age": 31, "tags": ["a", "b"], '
            '"meta": {"ok": true}, "none": null}')
    rc, got = _conv(jubaconv, ["-o", "datum"], text)
    assert rc == 0
    doc = json.loads(got)
    assert ["user", "alice"] in doc["string_values"]
    assert ["tags[0]", "a"] in doc["string_values"]
    assert ["age", 31.0] in doc["num_values"]
    assert ["meta/ok", 1.0] in doc["num_values"]
    assert (rc, got) == _conv(jjubaconv, ["-o", "datum"], text)
    assert _conv(jubaconv, ["-o", "json"], text) == _conv(
        jjubaconv, ["-o", "json"], text)


def test_jubaconv_datum_to_fv(tmp_path):
    from jubatus_tpu.cmd import jubaconv as jjubaconv

    from jubatus_tpu_torch.cmd import jubaconv

    conf = tmp_path / "conv.json"
    conf.write_text(json.dumps(CONV_CONF))
    argv = ["-i", "datum", "-o", "fv", "-c", str(conf)]
    text = ('{"num_values": [["x", 2.0], ["y", -0.5]], '
            '"string_values": [["s", "hello world"]]}')
    rc, got = _conv(jubaconv, argv, text)
    assert rc == 0
    assert "x" in got and "2" in got
    assert (rc, got) == _conv(jjubaconv, argv, text)
    # the json input path through the converter too
    argv = ["-o", "fv", "-c", str(conf)]
    text = '{"user": "alice", "age": 31, "meta": {"ok": true}}'
    assert _conv(jubaconv, argv, text) == _conv(jjubaconv, argv, text)


def test_jubaconv_fv_requires_conf(capsys):
    from jubatus_tpu.cmd import jubaconv as jjubaconv

    from jubatus_tpu_torch.cmd import jubaconv

    results = []
    for tool in (jubaconv, jjubaconv):
        results.append((_conv(tool, ["-o", "fv"], "{}"),
                        _conv(tool, ["-o", "datum"], "{not json"),
                        _conv(tool, ["-i", "datum", "-o", "json"], "{}"),
                        capsys.readouterr().err))
    assert results[0][0][0] == 1
    assert results[0] == results[1]


# -- launch: the per-engine entry functions ------------------------------------


def test_launch_entry_points_call_the_mains_as_the_jax_package(monkeypatch):
    """The port's ``launch`` has the JAX package's 22 entry functions, and
    each calls the port's server or proxy main with its engine bound
    before the arguments, as the JAX one calls its own."""
    import jubatus_tpu.launch as jlaunch
    import jubatus_tpu.server.__main__ as jserver_main
    import jubatus_tpu.server.proxy as jproxy

    import jubatus_tpu_torch.launch as launch
    import jubatus_tpu_torch.server.__main__ as server_main
    import jubatus_tpu_torch.server.proxy as proxy

    calls = []
    for mod, tag in ((server_main, "port-server"), (proxy, "port-proxy"),
                     (jserver_main, "jax-server"), (jproxy, "jax-proxy")):
        monkeypatch.setattr(mod, "main",
                            lambda argv, tag=tag: calls.append((tag, argv)))
    names = sorted(n for n in vars(jlaunch) if n.startswith("juba"))
    assert len(names) == 22
    assert sorted(n for n in vars(launch) if n.startswith("juba")) == names
    for name in names:
        argv = ["-f", "conf.json", "-p", "9199"]
        assert getattr(launch, name)(argv) == 0
        assert getattr(jlaunch, name)(argv) == 0
        (mine, mine_argv), (theirs, theirs_argv) = calls[-2:]
        assert mine.split("-")[1] == theirs.split("-")[1]
        assert mine.startswith("port") and theirs.startswith("jax")
        assert mine_argv == theirs_argv
        assert mine_argv[0] == name[4:].removesuffix("_proxy")
    monkeypatch.setattr(sys, "argv", ["jubaregression", "-p", "1"])
    assert launch.jubaregression() == 0
    assert calls[-1] == ("port-server", ["regression", "-p", "1"])
