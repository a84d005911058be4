"""The RPC envelope on the port (jubatus_tpu_torch/rpc/{server,client,
deadline,principal,retry}.py) against the JAX package's: the optional
trace (5th), deadline (6th) and principal (7th) elements cross in both
directions; a request's bytes equal the JAX client's for the same call
and msgid; an expired deadline is refused before dispatch with
``DeadlineExceeded`` (wire code 3) and counted; ``call_raw`` returns the
JAX client's result span; the raw fast path of the server; idempotent
retries under the budget."""

from __future__ import annotations

import socket
import threading
import time

import msgpack
import numpy as np
import pytest

from jubatus_tpu.rpc import client as jclient
from jubatus_tpu.rpc import deadline as jdeadline
from jubatus_tpu.rpc import principal as jprincipal
from jubatus_tpu.rpc import server as jserver
from jubatus_tpu.utils import tracing as jtracing
from jubatus_tpu_torch.rpc import client as pclient
from jubatus_tpu_torch.rpc import deadline as pdeadline
from jubatus_tpu_torch.rpc import principal as pprincipal
from jubatus_tpu_torch.rpc import server as pserver
from jubatus_tpu_torch.rpc.errors import (DEADLINE_EXCEEDED_ERROR,
                                          DeadlineExceeded, RpcIoError)
from jubatus_tpu_torch.utils import faults
from jubatus_tpu_torch.utils import tracing as ptracing

PKG = {
    "jax": (jserver, jclient, jdeadline, jprincipal, jtracing),
    "port": (pserver, pclient, pdeadline, pprincipal, ptracing),
}


def _wait(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _echo_server(kind):
    """A bare RpcServer of ``kind`` whose ``whoami`` answers what the
    dispatch adopted: the remaining deadline, the principal, the trace."""
    server, _, dl, pr, tr = PKG[kind]
    srv = server.RpcServer()

    def whoami(x):
        ctx = tr.current_trace()
        return {"x": x, "remaining": dl.remaining(), "principal": pr.current(),
                "trace": ctx.trace_id, "parent": ctx.parent_id}

    srv.register("whoami", whoami)
    srv.serve_background(0, host="127.0.0.1")
    return srv


@pytest.mark.parametrize("client_kind,server_kind",
                         [("port", "jax"), ("jax", "port"),
                          ("port", "port")])
def test_deadline_principal_and_trace_cross_the_packages(client_kind,
                                                         server_kind):
    _, client, dl, pr, tr = PKG[client_kind]
    srv = _echo_server(server_kind)
    try:
        ctx = tr.from_wire(None)
        with client.RpcClient("127.0.0.1", srv.port) as c:
            assert c.call("whoami", 1)["principal"] is None  # 4 elements
            with dl.deadline_after(30.0), pr.use("tenant-7"), \
                    tr.use_trace(ctx):
                got = c.call("whoami", 2)
            with pr.use("only-me"):  # nil-padded trace and deadline
                tagged = c.call("whoami", 3)
        assert got["x"] == 2 and got["principal"] == "tenant-7"
        assert 0.0 < got["remaining"] <= 30.0
        assert got["trace"] == ctx.trace_id
        assert got["parent"] not in ("", ctx.span_id)  # the call's child span
        assert tagged["principal"] == "only-me"
        assert tagged["remaining"] is None
    finally:
        srv.stop()


class _Capture:
    """A socket server that records each request frame's bytes and
    answers ``[1, msgid, nil, True]``."""

    def __init__(self) -> None:
        self.frames = []
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.port = self.sock.getsockname()[1]
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self) -> None:
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._conn, args=(conn,),
                             daemon=True).start()

    def _conn(self, conn) -> None:
        framer = msgpack.Unpacker()
        buf = b""
        start = 0
        with conn:
            while True:
                data = conn.recv(65536)
                if not data:
                    return
                framer.feed(data)
                buf += data
                while True:
                    try:
                        framer.skip()
                    except msgpack.OutOfData:
                        break
                    frame = buf[start:framer.tell()]
                    start = framer.tell()
                    self.frames.append(frame)
                    msgid = msgpack.unpackb(frame, raw=False)[1]
                    conn.sendall(msgpack.packb([1, msgid, None, True]))

    def close(self) -> None:
        self.sock.close()


def _fixed_child(tr):
    return lambda ctx: tr.TraceContext(ctx.trace_id, "child-span",
                                       ctx.span_id)


ENVELOPES = ["plain", "principal", "deadline", "trace", "all",
             "deadline_principal", "trace_principal"]


@pytest.mark.parametrize("shape", ENVELOPES)
@pytest.mark.parametrize("raw", [False, True])
def test_request_bytes_equal_the_jax_clients(monkeypatch, shape, raw):
    """The same call under the same context and msgid packs to the same
    bytes from either client (the trace's child span id and the deadline's
    remaining seconds pinned, since they are minted per call)."""
    frames = {}
    for kind in ("jax", "port"):
        _, client, dl, pr, tr = PKG[kind]
        monkeypatch.setattr(tr, "child_of", _fixed_child(tr))
        monkeypatch.setattr(dl, "to_wire",
                            lambda dl=dl: None if dl.current() is None
                            else 2.5)
        cap = _Capture()
        try:
            with client.RpcClient("127.0.0.1", cap.port) as c:
                with _scope(kind, shape):
                    params = ["cluster", {"k": [1, 2.5, "v"]}, b"\x00\xff"]
                    if raw:
                        c.call_raw("set_row", msgpack.packb(params))
                    else:
                        c.call("set_row", *params)
            assert _wait(lambda: cap.frames)
            frames[kind] = cap.frames[0]
        finally:
            cap.close()
    assert frames["port"] == frames["jax"]
    n_extra = {"plain": 0, "trace": 1, "deadline": 2,
               "deadline_principal": 3, "trace_principal": 3,
               "principal": 3, "all": 3}[shape]
    assert len(msgpack.unpackb(frames["port"], raw=False)) == 4 + n_extra


class _scope:
    """The context of one envelope shape, in package ``kind``."""

    def __init__(self, kind, shape) -> None:
        _, _, dl, pr, tr = PKG[kind]
        self.cms = []
        if shape in ("deadline", "all", "deadline_principal"):
            self.cms.append(dl.deadline_after(30.0))
        if shape in ("principal", "all", "deadline_principal",
                     "trace_principal"):
            self.cms.append(pr.use("tenant"))
        if shape in ("trace", "all", "trace_principal"):
            self.cms.append(tr.use_trace(tr.TraceContext("tid", "sid", "")))

    def __enter__(self):
        for cm in self.cms:
            cm.__enter__()

    def __exit__(self, *exc):
        for cm in reversed(self.cms):
            cm.__exit__(*exc)


def _raw_request(port, env):
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(msgpack.packb(env))
        u = msgpack.Unpacker(raw=False)
        while True:
            data = s.recv(65536)
            assert data
            u.feed(data)
            for msg in u:
                return msg


def test_expired_deadline_is_refused_before_dispatch():
    srv = pserver.RpcServer()
    calls = []
    srv.register("work", lambda x: calls.append(x) or x)
    srv.serve_background(0, host="127.0.0.1")
    try:
        # a 6-element envelope whose remaining budget is 0: expired on
        # arrival, refused with wire code 3, the handler never runs
        resp = _raw_request(srv.port, [0, 7, "work", [1], None, 0.0])
        assert resp == [1, 7, DEADLINE_EXCEEDED_ERROR, None]
        assert calls == []
        assert srv.trace.counters()["rpc.deadline_rejected"] == 1
        # a live budget dispatches
        assert _raw_request(srv.port, [0, 8, "work", [2], None, 30.0]) == \
            [1, 8, None, 2]
        assert calls == [2]
        # the JAX client sees the refusal as its DeadlineExceeded
        from jubatus_tpu.rpc.errors import DeadlineExceeded as JDeadline

        with jclient.RpcClient("127.0.0.1", srv.port) as c:
            # skip the client's own pre-flight check, so the spent budget
            # reaches the server as a 0.0 deadline element
            c._effective_timeout = lambda m: 5.0
            with pytest.raises(JDeadline):
                with jdeadline.deadline_after(0.0):
                    c.call("work", 3)
        assert calls == [2]
        assert srv.trace.counters()["rpc.deadline_rejected"] == 2
    finally:
        srv.stop()


def test_an_injected_dispatch_delay_expires_the_budget():
    """``rpc.dispatch.<m>:delay`` fires before the deadline gate: the
    caller's budget runs out in the queue, the client raises
    DeadlineExceeded and the server counts the rejection."""
    srv = pserver.RpcServer()
    srv.register("slow", lambda: True)
    srv.serve_background(0, host="127.0.0.1")
    try:
        with faults.armed("rpc.dispatch.slow:delay:0.3"), \
                pclient.RpcClient("127.0.0.1", srv.port) as c:
            t0 = time.monotonic()
            with pytest.raises(DeadlineExceeded):
                with pdeadline.deadline_after(0.05):
                    c.call("slow")
            assert time.monotonic() - t0 < 0.25
            assert _wait(lambda: srv.trace.counters().get(
                "rpc.deadline_rejected") == 1)
    finally:
        srv.stop()


def test_client_refuses_to_send_with_no_budget_left():
    with pclient.RpcClient("127.0.0.1", 1) as c:  # nothing listens there
        with pdeadline.deadline_after(0.0):
            with pytest.raises(DeadlineExceeded):
                c.call("anything")


@pytest.mark.parametrize("server_kind", ["jax", "port"])
def test_call_raw_returns_the_jax_clients_result_span(server_kind):
    srv = _echo_server(server_kind)
    try:
        params = msgpack.packb([{"a": [1, 2, 3], "b": "x" * 300}])
        spans = []
        for kind in ("jax", "port"):
            with PKG[kind][1].RpcClient("127.0.0.1", srv.port) as c:
                spans.append(c.call_raw("whoami", params))
        strip = [msgpack.unpackb(s, raw=False) for s in spans]
        for s in strip:  # each call roots its own trace on the server
            s.pop("trace")
            s.pop("parent")
        assert strip[0] == strip[1]
        assert strip[0]["x"] == {"a": [1, 2, 3], "b": "x" * 300}
    finally:
        srv.stop()


def test_raw_fast_path_serves_splices_and_falls_back():
    srv = pserver.RpcServer()
    srv.register("m", lambda name, x: ["generic", x])
    seen = []

    def raw(params):
        seen.append(params)
        decoded = msgpack.unpackb(params, raw=False)
        if decoded[1] == "decline":
            return pserver.RAW_FALLBACK
        return pserver.RawResult(msgpack.packb(["raw", decoded[1]]))

    srv.register_raw("m", raw)
    srv.serve_background(0, host="127.0.0.1")
    try:
        with pclient.RpcClient("127.0.0.1", srv.port) as c:
            assert c.call("m", "c", 5) == ["raw", 5]
            assert c.call("m", "c", "decline") == ["generic", "decline"]
            with pprincipal.use("t"):  # a 7-element envelope
                assert c.call("m", "c", 6) == ["raw", 6]
        assert seen[0] == msgpack.packb(["c", 5])
        assert seen[2] == msgpack.packb(["c", 6])
        hist = srv.trace.trace_status()
        assert hist["trace.rpc.m.count"] == 3  # a fallback counted once
    finally:
        srv.stop()


def _random_obj(rng, depth=0):
    kind = rng.integers(9 if depth < 3 else 6)
    if kind == 0:
        return int(rng.integers(-2 ** 40, 2 ** 40))
    if kind == 1:
        return float(rng.standard_normal())
    if kind == 2:
        return "s" * int(rng.integers(0, 300))
    if kind == 3:
        return bytes(rng.integers(0, 256, int(rng.integers(0, 70000)))
                     .astype(np.uint8))
    if kind == 4:
        return None
    if kind == 5:
        return bool(rng.integers(2))
    if kind == 6:
        return [_random_obj(rng, depth + 1)
                for _ in range(int(rng.integers(0, 20)))]
    if kind == 7:
        return {f"k{i}": _random_obj(rng, depth + 1)
                for i in range(int(rng.integers(0, 20)))}
    return [_random_obj(rng, depth + 1) for _ in range(17)]


@pytest.mark.parametrize("seed", range(8))
def test_span_walk_matches_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    objs = [_random_obj(rng) for _ in range(6)]
    buf = b"".join(msgpack.packb(o) for o in objs)
    i = j = 0
    while i < len(buf):
        i, j = pserver.msgpack_span_end(buf, i), jserver.msgpack_span_end(buf, j)
        assert i == j
    with pytest.raises(ValueError):
        pserver.msgpack_span_end(b"\x92\x01", 0)  # truncated array


def test_idempotent_calls_retry_and_effectful_ones_do_not():
    srv = pserver.RpcServer()
    srv.register("get_status", lambda name: {"ok": True})
    srv.register("train", lambda name, rows: len(rows))
    srv.serve_background(0, host="127.0.0.1")
    try:
        with pclient.RpcClient("127.0.0.1", srv.port) as c:
            site = f"rpc.call.get_status.127.0.0.1:{srv.port}:error@1"
            with faults.armed(site):
                assert c.call("get_status", "c") == {"ok": True}
            assert c.retry_budget.status()["withdrawals"] == 1
            site = f"rpc.call.train.127.0.0.1:{srv.port}:error@1"
            with faults.armed(site):
                with pytest.raises(faults.FaultInjected):
                    c.call("train", "c", [1])
            # a refused connection is a retryable transport failure
        with pclient.RpcClient("127.0.0.1", 1, timeout=1.0) as dead:
            with pytest.raises(RpcIoError):
                dead.call("get_status", "c")
            assert dead.retry_budget.status()["withdrawals"] == 2
    finally:
        srv.stop()
