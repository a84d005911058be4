"""The port's continuous profiling plane (jubatus_tpu_torch/utils/
profiler.py and the server's get_profile / profile_device), mirroring the
server-side cases of tests/test_profiler.py on the CPU: the stack sampler
(bounded store, hz=0 off, folding determinism), the slow log's tail
trigger (once per window, trace ids stamped), DeviceCapture on
torch.profiler (capped, listed, one capture a process), the RPCs on a port
server, and jubadump --profile / --slow-log against it."""

from __future__ import annotations

import json
import os
import threading
import time

import pytest

from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.rpc import deadline as deadlines
from jubatus_tpu_torch.rpc.client import ClassifierClient, RpcClient
from jubatus_tpu_torch.server import EngineServer
from jubatus_tpu_torch.server.args import ServerArgs
from jubatus_tpu_torch.utils import profiler, tracing
from jubatus_tpu_torch.utils.profiler import (OTHER_KEY, TRACE_FILE,
                                              DeviceCapture, SamplingProfiler,
                                              collapse_frame, fold_profiles,
                                              folded_lines, render_top,
                                              top_table)
from jubatus_tpu_torch.utils.slowlog import SlowLog

CONF = {
    "method": "PA",
    "parameter": {"regularization_weight": 1.0},
    "converter": {"num_rules": [{"key": "*", "type": "num"}]},
}


def _server(**kw) -> EngineServer:
    return EngineServer("classifier", CONF,
                        ServerArgs(engine="classifier",
                                   listen_addr="127.0.0.1", **kw),
                        device="cpu")


# -- the sampler ---------------------------------------------------------------


def test_sampler_collects_stacks_with_thread_roots():
    reg = tracing.Registry()
    prof = SamplingProfiler(reg, hz=250)
    stop = threading.Event()

    def busy_beaver():
        while not stop.is_set():
            sum(i * i for i in range(500))

    t = threading.Thread(target=busy_beaver, name="prof-busy", daemon=True)
    t.start()
    prof.start()
    try:
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if any("busy_beaver" in k for k in prof.profile(60)["folded"]):
                break
            time.sleep(0.05)
    finally:
        stop.set()
        prof.stop()
        t.join(timeout=2)
    assert not t.is_alive()
    doc = prof.profile(60)
    assert doc["folded"] and doc["stats"]["enabled"]
    busy = [k for k in doc["folded"] if "busy_beaver" in k]
    assert busy, sorted(doc["folded"])[:5]
    assert any(k.startswith("thread:prof-busy;") for k in busy)
    assert not any("stack-profiler" in k.split(";", 1)[0]
                   for k in doc["folded"])


def test_bounded_store_under_churn():
    prof = SamplingProfiler(None, hz=0, max_stacks=8)
    with prof._lock:
        for i in range(100):
            prof._ingest_locked(f"thread:t;mod.py:f{i}")
    doc = prof.profile(0)
    assert len(doc["folded"]) <= 8 + 1
    assert doc["folded"][OTHER_KEY] == 100 - 8
    assert doc["stats"]["truncated"] == 100 - 8
    assert sum(doc["folded"].values()) == 100


def test_window_rotation_bounds_history():
    prof = SamplingProfiler(None, hz=0, bucket_s=0.5, ring_capacity=4)
    now = time.time()
    with prof._lock:
        prof._ingest_locked("thread:t;a.py:f")
        for i in range(10):
            prof._rotate_locked(now + i)
            prof._ingest_locked("thread:t;a.py:f")
    assert prof.stats()["ring_buckets"] <= 4
    assert prof.profile(0.001)["folded"].get("thread:t;a.py:f", 0) >= 1


def test_hz_zero_fully_off():
    prof = SamplingProfiler(None, hz=0)
    prof.start()
    assert prof._thread is None
    assert not prof.enabled
    doc = prof.profile(60)
    assert doc["folded"] == {} and doc["stats"]["enabled"] is False
    assert prof.tail_snapshot("rpc.x", ["t1"]) is None
    assert prof.snapshots() == []
    prof.stop()


def test_hz_zero_server_has_no_sampler_thread():
    srv = _server(profile_hz=0.0)
    port = srv.start(0)
    try:
        assert srv.profiler._thread is None
        assert not any(t.name == "stack-profiler"
                       for t in threading.enumerate())
        (doc,) = srv.get_profile("", 60).values()
        assert doc["folded"] == {} and doc["stats"]["enabled"] is False
        assert port
    finally:
        srv.stop()


def test_server_stop_ends_the_sampler_and_telemetry_threads():
    srv = _server(telemetry_interval=0.05)
    srv.start(0)
    threads = (srv.profiler._thread, srv.telemetry._thread)
    assert all(t is not None and t.is_alive() for t in threads)
    srv.stop()
    assert not any(t.is_alive() for t in threads)


def test_collapse_frame_shape():
    import sys

    key = collapse_frame(sys._getframe(), "tname")
    parts = key.split(";")
    assert parts[0] == "thread:tname"
    assert parts[-1].endswith(":test_collapse_frame_shape")
    assert all(":" in p for p in parts)


def test_folding_determinism_and_order_invariance():
    d1 = {"folded": {"t;a": 3, "t;b": 1}}
    d2 = {"folded": {"t;a": 2, "t;c": 5}}
    once = fold_profiles([d1, d2])
    assert once == {"t;a": 5, "t;b": 1, "t;c": 5}
    assert fold_profiles([d2, d1]) == once
    assert fold_profiles([{"t;a": 1}, d1])["t;a"] == 4
    lines = folded_lines(once)
    assert lines == sorted(lines)
    assert "t;a 5" in lines


def test_top_table_self_cum_math():
    folded = {"t;a;b": 6, "t;a;c": 4, "t;a": 2, "t;r;r": 3}
    rows = {r["frame"]: r for r in top_table(folded)}
    assert rows["b"]["self"] == 6 and rows["b"]["cum"] == 6
    assert rows["a"]["self"] == 2 and rows["a"]["cum"] == 12
    assert rows["t"]["cum"] == 15
    assert rows["r"]["self"] == 3 and rows["r"]["cum"] == 3
    text = render_top(folded, top=3)
    assert "frame" in text and "total: 15 sample(s)" in text


def test_concurrent_get_profile_during_sampling():
    prof = SamplingProfiler(tracing.Registry(), hz=500, bucket_s=0.5)
    prof.start()
    errors = []
    stop = threading.Event()

    def reader():
        try:
            while not stop.is_set():
                assert isinstance(prof.profile(1.0)["folded"], dict)
                prof.tail_snapshot("rpc.x", ["tid"])
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=reader, daemon=True)
               for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.6)
    stop.set()
    for t in threads:
        t.join(timeout=2)
    prof.stop()
    assert not errors, errors
    assert prof.stats()["samples"] > 0
    assert len(prof.snapshots()) <= SamplingProfiler(None)._snapshots.maxlen


# -- the tail trigger ----------------------------------------------------------


def test_slowlog_trigger_fires_once_per_window():
    sl = SlowLog()
    fired = []
    sl.set_trigger(lambda span, ids: fired.append((span, ids)),
                   breaches=3, window_s=10.0)
    t0 = 1000.0
    for i in range(5):
        sl._note_breach("rpc.classify", f"tid{i}", now=t0 + i)
    assert fired == [("rpc.classify", ["tid0", "tid1", "tid2"])]
    for i in range(3):
        sl._note_breach("rpc.classify", f"late{i}", now=t0 + 20 + i)
    assert len(fired) == 2 and fired[1][1] == ["late0", "late1", "late2"]
    sl._note_breach("rpc.train", "x", now=t0 + 21)
    assert len(fired) == 2
    assert sl.stats()["trigger_fired"] == 2


def test_slowlog_trigger_disabled_and_error_isolated():
    sl = SlowLog()
    assert sl._note_breach("rpc.x", "t", now=1.0) is False
    sl.set_trigger(lambda *_: 1 / 0, breaches=1, window_s=10.0)
    sl.add({"method": "rpc.x", "trace_id": "t1", "duration_ms": 1.0})
    assert sl.stats()["captured"] == 1
    assert sl.stats()["trigger_fired"] == 1


def test_breach_snapshot_carries_trace_id_through_registry():
    reg = tracing.Registry()
    prof = SamplingProfiler(reg, hz=100)
    reg.slowlog.configure(min_count=1, quantile=0.5)
    reg.slowlog.set_trigger(prof.tail_snapshot, breaches=3, window_s=30.0)
    ctx = tracing.new_root()
    with tracing.use_trace(ctx):
        for _ in range(4):
            reg.record("rpc.classify", 0.25)
    snaps = prof.snapshots()
    assert len(snaps) == 1, snaps
    assert snaps[0]["span"] == "rpc.classify"
    assert ctx.trace_id in snaps[0]["trace_ids"]
    doc = prof.profile(60)
    assert doc["snapshots"] and \
        ctx.trace_id in doc["snapshots"][0]["trace_ids"]


def test_server_breach_snapshot_end_to_end():
    srv = _server(slowlog_min_count=1, slowlog_quantile=0.5)
    port = srv.start(0)
    try:
        ctx = tracing.new_root()
        with tracing.use_trace(ctx):
            for _ in range(4):
                srv.trace.record("rpc.classify", 0.25)
        with RpcClient("127.0.0.1", port) as rc:
            (doc,) = rc.call("get_profile", "", 60.0).values()
        assert doc["snapshots"], doc["stats"]
        snap = doc["snapshots"][0]
        assert snap["span"] == "rpc.classify"
        assert ctx.trace_id in snap["trace_ids"]
        (st,) = srv.get_status().values()
        assert st["slowlog.trigger_fired"] >= 1
        assert st["profiler.snapshots_taken"] >= 1
        assert st["profiler.enabled"] is True
    finally:
        srv.stop()


# -- device capture ------------------------------------------------------------


def test_device_capture_capped_and_listed(tmp_path):
    cap = DeviceCapture(str(tmp_path / "prof"), max_captures=2)
    results = [cap.capture(0.05) for _ in range(3)]
    assert all("artifact" in r for r in results), results
    assert all(r["activities"] == ["CPU"] for r in results)
    listing = cap.list()
    assert len(listing["artifacts"]) == 2  # pruned past the cap
    assert listing["artifacts"][-1]["path"] == results[-1]["artifact"]
    doc = json.loads(open(os.path.join(results[-1]["artifact"],
                                       TRACE_FILE)).read())
    assert "traceEvents" in doc


def test_device_capture_splits_its_wall(tmp_path):
    """``timing_ms`` splits a capture into the profiler's start, the
    window, its stop and the export; the window is the asked seconds."""
    doc = DeviceCapture(str(tmp_path / "prof")).capture(0.2)
    timing = doc["timing_ms"]
    assert list(timing) == ["start", "window", "stop", "export"]
    assert all(v >= 0 for v in timing.values())
    assert 200 <= timing["window"] < 2000


def test_device_capture_clamps_seconds(tmp_path):
    cap = DeviceCapture(str(tmp_path / "prof"))
    assert cap.capture(0.0)["seconds"] == 0.05
    assert cap.MAX_SECONDS == 60.0


def test_device_capture_one_at_a_time_in_a_process(tmp_path):
    """torch.profiler is process-wide: a capture while another runs (this
    or another server's, or a caller's own profiler) answers "capture
    already in progress" and leaves the running one intact."""
    from torch.profiler import profile

    a = DeviceCapture(str(tmp_path / "a"))
    b = DeviceCapture(str(tmp_path / "b"))
    out = {}
    t = threading.Thread(target=lambda: out.update(a=a.capture(1.0)))
    t.start()
    # b asks only once a holds the process's capture: a b capture taken
    # first would make a's start the one refused
    deadline = time.monotonic() + 5.0
    while (not profiler._capture_lock.locked()
           and time.monotonic() < deadline):
        time.sleep(0.005)
    busy = {}
    while time.monotonic() < deadline:
        busy = b.capture(0.05)
        if "error" in busy:
            break
        time.sleep(0.01)
    t.join(timeout=30)
    assert not t.is_alive()
    assert busy == {"error": "capture already in progress",
                    "dir": str(tmp_path / "b")}
    assert "artifact" in out["a"]
    with profile():
        assert b.capture(0.05)["error"] == "capture already in progress"
    assert "artifact" in b.capture(0.05)


def test_profile_device_rpc_list_and_capture(tmp_path):
    srv = _server(profile_dir=str(tmp_path / "artifacts"))
    port = srv.start(0)
    try:
        with RpcClient("127.0.0.1", port) as rc:
            (empty,) = rc.call("profile_device", "", 0.0).values()
            assert empty["artifacts"] == []
            (cap,) = rc.call("profile_device", "", 0.1).values()
            assert "artifact" in cap, cap
            (after,) = rc.call("profile_device", "", 0.0).values()
            assert len(after["artifacts"]) == 1
        (st,) = srv.get_status().values()
        assert st["trace.counter.profiler.device_captures"] == 1
    finally:
        srv.stop()


def test_profile_device_holds_no_rpc_worker(tmp_path):
    """A capture runs on a thread of its own, not on an RPC worker: while
    it is in flight the capturing thread is the capture's, other calls
    answer, and the capture's reply (artifact, bytes, timing) arrives when
    it ends."""
    import sys

    srv = _server(profile_dir=str(tmp_path / "artifacts"), thread=2)
    port = srv.start(0)
    out = {}

    def capture():
        with RpcClient("127.0.0.1", port, timeout=60.0) as rc:
            (out["cap"],) = rc.call("profile_device", "", 1.5).values()

    t = threading.Thread(target=capture)
    try:
        t.start()
        time.sleep(0.3)
        names = {th.ident: th.name for th in threading.enumerate()}
        assert "device-capture" in names.values()
        # both workers idle, waiting for requests, while the capture runs
        workers = [collapse_frame(frame).rsplit(";", 1)[-1]
                   for ident, frame in sys._current_frames().items()
                   if names.get(ident, "").startswith("rpc-worker-")]
        answered = []
        for _ in range(2):
            with RpcClient("127.0.0.1", port) as rc:
                rc.call("get_status", "")
            answered.append(t.is_alive())
        t.join(timeout=60)
        assert workers == ["server.py:_worker"] * 2
        assert answered == [True, True]
        assert "artifact" in out["cap"] and out["cap"]["bytes"] > 0
        assert out["cap"]["timing_ms"]["window"] >= 1500
    finally:
        t.join(timeout=60)
        srv.stop()


def test_a_deferred_handler_answers_when_its_future_resolves():
    """The RPC server's deferred replies: six 1 s calls on two workers end
    together (held workers would take three waves), and an exception
    raised on the handler's thread reaches the caller as its error."""
    from concurrent.futures import ThreadPoolExecutor

    from jubatus_tpu_torch.rpc.server import RpcServer, deferred

    def boom():
        raise ValueError("no capture here")

    rpc = RpcServer()
    rpc.register("slow", deferred(lambda: time.sleep(1.0) or "done"),
                 arity=0)
    rpc.register("boom", deferred(boom), arity=0)
    port = rpc.serve_background(0, nthreads=2, host="127.0.0.1")

    def slow(_):
        with RpcClient("127.0.0.1", port, timeout=30.0) as rc:
            return rc.call("slow")

    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(6) as pool:
            got = list(pool.map(slow, range(6)))
        wall = time.perf_counter() - t0
        assert got == ["done"] * 6
        assert wall < 2.2, wall
        with RpcClient("127.0.0.1", port) as rc:
            with pytest.raises(Exception, match="no capture here"):
                rc.call("boom")
        assert rpc.trace.counters()["rpc.boom.errors"] == 1
    finally:
        rpc.stop()


def test_profile_device_default_dir_carries_the_bound_port(tmp_path):
    srv = _server(datadir=str(tmp_path))
    port = srv.start(0)
    try:
        (doc,) = srv.profile_device("", 0.0).values()
        assert doc["dir"] == os.path.join(
            str(tmp_path), f"jubatus_profile_classifier_{port}")
    finally:
        srv.stop()


def test_profile_rpcs_envelope_compat(tmp_path):
    """get_profile / profile_device answer the plain 4-element envelope and
    the traced + deadlined one."""
    srv = _server(profile_dir=str(tmp_path / "artifacts"))
    port = srv.start(0)
    try:
        deadline = time.monotonic() + 5.0
        while srv.profiler.stats()["samples"] == 0 and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        with RpcClient("127.0.0.1", port) as rc:
            (doc,) = rc.call("get_profile", "", 60.0).values()
            assert doc["folded"], doc["stats"]
            assert doc["stats"]["hz"] == 67.0
            (dev,) = rc.call("profile_device", "", 0.0).values()
            assert dev["artifacts"] == []
        probe = tracing.new_root()
        with tracing.use_trace(probe), deadlines.deadline_after(30.0):
            with RpcClient("127.0.0.1", port) as rc:
                (traced,) = rc.call("get_profile", "", 60.0).values()
                (tdev,) = rc.call("profile_device", "", 0.0).values()
        assert traced["folded"] and tdev["artifacts"] == []
    finally:
        srv.stop()


def test_profile_methods_registered_idempotent():
    from jubatus_tpu_torch.framework.idl import (CLIENT_SAFE_RETRY,
                                                 IDEMPOTENT_BUILTINS,
                                                 idempotent_methods)

    for m in ("get_profile", "profile_device", "get_metrics", "get_spans",
              "get_slow_log"):
        assert m in IDEMPOTENT_BUILTINS
        assert m in idempotent_methods("classifier")
        assert m in CLIENT_SAFE_RETRY


# -- jubadump's live modes -----------------------------------------------------


def test_jubadump_profile_and_slow_log_live(capsys):
    from jubatus_tpu_torch.cmd import jubadump

    srv = _server(slowlog_min_count=1, slowlog_quantile=0.5)
    port = srv.start(0)
    try:
        c = ClassifierClient("127.0.0.1", port, "pf")
        for _ in range(5):
            c.train([["a", Datum({"x": 1.0})]])
        c.close()
        deadline = time.monotonic() + 5.0
        while srv.profiler.stats()["samples"] == 0 and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        assert jubadump.main(["--profile", f"127.0.0.1:{port}", "-n", "pf",
                              "--seconds", "60"]) == 0
        (node_doc,) = json.loads(capsys.readouterr().out).values()
        assert node_doc["folded"]
        assert node_doc["stats"]["enabled"] is True
        assert jubadump.main(["--slow-log", f"127.0.0.1:{port}",
                              "-n", "pf"]) == 0
        (recs,) = json.loads(capsys.readouterr().out).values()
        # the RPC dispatches and the train coalescer's stage spans
        assert recs and all(r["method"].startswith("rpc.") or
                            r["method"] in ("fv.convert", "fv.upload")
                            for r in recs)
        assert any(r["method"].startswith("rpc.") for r in recs)
    finally:
        srv.stop()


def test_jubadump_live_target_errors_print_one_line(capsys):
    from jubatus_tpu_torch.cmd import jubadump

    assert jubadump.main(["--profile", "nohostport"]) == 1
    assert "HOST:PORT" in capsys.readouterr().err
    assert jubadump.main(["-i", "x", "--slow-log", "h:1"]) == 1


@pytest.mark.cuda
def test_device_keys_after_cuda_is_in_use():
    """On the card: the telemetry sample has no torch_device_* key before
    CUDA is initialized in the process, and reads the allocator and the
    card's memory once it is."""
    import subprocess
    import sys

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    probe = (
        "import torch\n"
        "from jubatus_tpu_torch.utils.runtime_telemetry import "
        "RuntimeTelemetry\n"
        "from jubatus_tpu_torch.utils.tracing import Registry\n"
        "rt = RuntimeTelemetry(Registry())\n"
        "before = rt.sample()\n"
        "assert not any(k.startswith('torch_') for k in before), before\n"
        "assert not torch.cuda.is_initialized()\n"
        "x = torch.ones(1 << 20, device='cuda')\n"
        "s = rt.sample()\n"
        "assert s['torch_device_bytes_in_use'] >= 4 << 20, s\n"
        "assert s['torch_device_total_bytes'] > s['torch_device_free_bytes']"
        " > 0, s\n"
        "assert s['torch_ooms'] == 0\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", probe], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr
