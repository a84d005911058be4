"""The port's native transport (jubatus_tpu_torch/rpc/native_server.py) on
the CPU, g++ building native/rpc_frontend.cpp into build/torch_native/.

Mirrors tests/test_native_rpc.py (round trip of every type, the error
taxonomy, pipelining, concurrent clients, notifications, trace spans, an
engine server and a proxy on the native transport), where a case has a
JAX counterpart server with the two packages' answers to the same seeded
request frames byte-equal; the four C++ relay tests of tests/test_proxy.py
(serves and counts, reroutes on a membership change, survives a garbage
backend, exactly one response under backend churn); tests/
test_usage_attribution.py's envelope on both transports and the relay
forwarding the principal verbatim; a JAX proxy and a port proxy, both
native, reporting the same relay counters; then the port's own cases: a
deferred ``profile_device`` answered on the native transport without
blocking its connection, ``NodeDraining`` from the drain gate, the bytes
the usage ledger bills on both transports, the transport factory, and a
failed g++ build raising ``NativeBuildError`` at server and proxy start
(but not under ``JUBATUS_TPU_NATIVE_RPC=0``)."""

from __future__ import annotations

import socket
import threading
import time

import msgpack
import numpy as np
import pytest

from jubatus_tpu.rpc import native_server as jnative
from jubatus_tpu_torch import native
from jubatus_tpu_torch.coord.memory import MemoryCoordinator, _Store
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.rpc import native_server
from jubatus_tpu_torch.rpc import principal as principals
from jubatus_tpu_torch.rpc.client import ClassifierClient, RpcClient
from jubatus_tpu_torch.rpc.errors import RpcMethodNotFound, RpcTypeError
from jubatus_tpu_torch.rpc.server import RpcServer
from jubatus_tpu_torch.server import EngineServer
from jubatus_tpu_torch.server.args import ServerArgs
from jubatus_tpu_torch.server.proxy import Proxy, ProxyArgs

NAME = "np"
CONF = {"method": "PA", "parameter": {},
        "converter": {"num_rules": [{"key": "*", "type": "num"}]}}


def _register(srv):
    srv.register("echo", lambda x: x, arity=1)
    srv.register("add", lambda a, b: a + b, arity=2)
    srv.register("boom", lambda: 1 / 0, arity=0)


@pytest.fixture()
def srv():
    s = native_server.NativeRpcServer()
    _register(s)
    s.serve_background(0, host="127.0.0.1")
    yield s
    s.stop()


@pytest.fixture()
def pair():
    """The port's native server and the JAX package's, same methods."""
    servers = [native_server.NativeRpcServer(), jnative.NativeRpcServer()]
    for s in servers:
        _register(s)
        s.serve_background(0, host="127.0.0.1")
    yield servers
    for s in servers:
        s.stop()


def _exchange(port: int, frames, want: int = 0,
              timeout: float = 30.0) -> dict:
    """Send ``frames`` down one connection at once and read ``want``
    response frames (one a frame by default): {msgid: the response
    frame's bytes}."""
    want = want or len(frames)
    out: dict = {}
    unp = msgpack.Unpacker()
    buf = b""
    base = 0
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.sendall(b"".join(frames))
        while len(out) < want:
            data = s.recv(65536)
            assert data, "the server closed the connection"
            unp.feed(data)
            buf += data
            while True:
                start = unp.tell()
                try:
                    msg = unp.unpack()
                except msgpack.OutOfData:
                    break
                out[msg[1]] = buf[start - base:unp.tell() - base]
            buf = buf[unp.tell() - base:]
            base = unp.tell()
    return out


def _seeded_values(seed: int, n: int):
    """``n`` msgpack values of every type, made from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = i % 8
        if k == 0:
            out.append(int(rng.integers(-2 ** 40, 2 ** 40)))
        elif k == 1:
            out.append(float(rng.standard_normal()))
        elif k == 2:
            out.append("".join(chr(int(c)) for c in
                               rng.integers(32, 0x3000, size=int(
                                   rng.integers(0, 300)))))
        elif k == 3:
            out.append(bytes(rng.integers(0, 256, size=int(
                rng.integers(0, 5000)), dtype=np.uint8)))
        elif k == 4:
            out.append([int(x) for x in rng.integers(0, 1000, size=20)])
        elif k == 5:
            out.append({f"k{j}": [float(rng.standard_normal()), None, True]
                        for j in range(int(rng.integers(1, 10)))})
        elif k == 6:
            out.append(None)
        else:
            out.append([1, [2, {"k": "v"}], b"\x00\xff", False])
    return out


# -- tests/test_native_rpc.py ----------------------------------------------------

def test_roundtrip_types(pair):
    port_srv, jax_srv = pair
    with RpcClient("127.0.0.1", port_srv.port) as c:
        assert c.call("add", 2, 3) == 5
        assert c.call("echo", "héllo") == "héllo"
        assert c.call("echo", [1, [2, {"k": "v"}], b"\x00\xff"]) == \
            [1, [2, {"k": "v"}], b"\x00\xff"]
        assert c.call("echo", None) is None
        assert c.call("echo", 3.5) == 3.5
    frames = [msgpack.packb([0, i, "echo", [v]])
              for i, v in enumerate(_seeded_values(7, 64))]
    got = _exchange(port_srv.port, frames)
    want = _exchange(jax_srv.port, frames)
    assert got == want and len(got) == 64


def test_error_taxonomy(pair):
    port_srv, jax_srv = pair
    with RpcClient("127.0.0.1", port_srv.port) as c:
        with pytest.raises(RpcMethodNotFound):
            c.call("nope")
        with pytest.raises(RpcTypeError):
            c.call("add", 1)  # arity error
        with pytest.raises(Exception, match="division"):
            c.call("boom")
        assert c.call("add", 1, 1) == 2  # the connection survives errors
    frames = [msgpack.packb(f) for f in (
        [0, 1, "nope", []], [0, 2, "add", [1]], [0, 3, "boom", []],
        [0, 4, "add", [1, 1]], [0, 5, "add", "not-a-list"])]
    assert _exchange(port_srv.port, frames) == \
        _exchange(jax_srv.port, frames)


def test_pipelining_same_connection(pair):
    """Many requests down one connection; responses correlate by msgid."""
    port_srv, jax_srv = pair
    with RpcClient("127.0.0.1", port_srv.port) as c:
        for i in range(200):
            assert c.call("add", i, i) == 2 * i
    rng = np.random.default_rng(3)
    frames = [msgpack.packb([0, i, "add", [int(a), int(b)]])
              for i, (a, b) in enumerate(rng.integers(-1000, 1000,
                                                      size=(300, 2)))]
    got = _exchange(port_srv.port, frames)
    assert got == _exchange(jax_srv.port, frames)
    assert sorted(got) == list(range(300))


def test_concurrent_clients(srv):
    errors = []

    def hammer(n):
        try:
            with RpcClient("127.0.0.1", srv.port) as c:
                for i in range(50):
                    assert c.call("add", n, i) == n + i
        except Exception as e:  # noqa: BLE001 — collected, asserted below
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(j,)) for j in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors


def test_notify_no_response(srv):
    hits = []
    srv.register("note", lambda x: hits.append(x), arity=1)
    out = _exchange(srv.port, [msgpack.packb([2, "note", ["fire-and-forget"]]),
                               msgpack.packb([0, 9, "add", [1, 2]])],
                    want=1)
    # only the request answers; its answer proves framing stayed aligned
    assert list(out) == [9] and msgpack.unpackb(out[9])[3] == 3
    assert hits == ["fire-and-forget"]


def test_trace_spans_recorded(srv):
    with RpcClient("127.0.0.1", srv.port) as c:
        c.call("echo", "x")
        with pytest.raises(RpcMethodNotFound):
            c.call("nope")
    st = srv.trace.trace_status()
    assert st["trace.rpc.echo.count"] >= 1
    assert st["trace.counter.rpc.nope.errors"] == 1


def _jax_server(**kw):
    from jubatus_tpu.server import EngineServer as JEngineServer
    from jubatus_tpu.server.args import ServerArgs as JServerArgs

    return JEngineServer("classifier", CONF, JServerArgs(
        engine="classifier", listen_addr="127.0.0.1", **kw))


def test_engine_server_over_native_transport(monkeypatch):
    """The full engine stack on the C++ transport, which is the default;
    the JAX server on its own native transport answers the same train
    frames byte for byte, and the classify scores within 1e-6."""
    monkeypatch.delenv("JUBATUS_TPU_NATIVE_RPC", raising=False)
    s = EngineServer("classifier", CONF, ServerArgs(
        engine="classifier", listen_addr="127.0.0.1"), device="cpu")
    assert isinstance(s.rpc, native_server.NativeRpcServer)
    js = _jax_server()
    assert isinstance(js.rpc, jnative.NativeRpcServer)
    port, jport = s.start(0), js.start(0)
    try:
        rng = np.random.default_rng(11)
        rows = [[["pos", "neg"][i % 2], Datum({"x": float(v)}).to_msgpack()]
                for i, v in enumerate(rng.standard_normal(8))]
        frames = [msgpack.packb([0, i, "train", ["", rows[i:i + 2]]])
                  for i in range(0, 8, 2)]
        got = {}
        for p in (port, jport):
            got[p] = {}
            for f in frames:  # one at a time: each call one flush
                got[p].update(_exchange(p, [f]))
        assert got[port] == got[jport]
        q = [Datum({"x": 1.0}).to_msgpack()]
        (res,) = msgpack.unpackb(_exchange(port, [msgpack.packb(
            [0, 1, "classify", ["", q]])])[1])[3]
        (jres,) = msgpack.unpackb(_exchange(jport, [msgpack.packb(
            [0, 1, "classify", ["", q]])])[1])[3]
        assert sorted(r[0] for r in res) == sorted(r[0] for r in jres)
        np.testing.assert_allclose(sorted(r[1] for r in res),
                                   sorted(r[1] for r in jres), rtol=1e-6,
                                   atol=1e-6)
        with ClassifierClient("127.0.0.1", port, "") as c:
            (st,) = c.get_status().values()
        assert st["trace.rpc.train.count"] == 4
        # the microbatch coalescer serves the native transport too
        items = (st.get("microbatch.train.item_count", 0)
                 + st.get("microbatch.train_raw.item_count", 0))
        flushes = (st.get("microbatch.train.flush_count", 0)
                   + st.get("microbatch.train_raw.flush_count", 0))
        assert (items, flushes) == (8, 4)
    finally:
        s.stop()
        js.stop()


def _member(store, name=NAME):
    srv = EngineServer("classifier", CONF, ServerArgs(
        engine="classifier", coordinator="(shared)", name=name,
        listen_addr="127.0.0.1", interval_sec=1e9, interval_count=1 << 30),
        device="cpu", coord=MemoryCoordinator(store))
    srv.start(0)
    return srv


def _front(store, **kw):
    proxy = Proxy(ProxyArgs(engine="classifier", listen_addr="127.0.0.1",
                            **kw), coord=MemoryCoordinator(store))
    proxy.start(0)
    return proxy


def test_proxy_over_native_transport(monkeypatch):
    """The proxy takes its transport from the same factory as the engine
    servers: native by default."""
    monkeypatch.delenv("JUBATUS_TPU_NATIVE_RPC", raising=False)
    store = _Store()
    srv = _member(store)
    proxy = None
    try:
        proxy = _front(store)
        assert isinstance(proxy.rpc, native_server.NativeRpcServer)
        with ClassifierClient("127.0.0.1", proxy.args.rpc_port, NAME) as c:
            assert c.train([["pos", Datum({"x": 1.0})]]) == 1
            (res,) = c.classify([Datum({"x": 1.0})])
            assert res
    finally:
        if proxy is not None:
            proxy.stop()
        srv.stop()


# -- the C++ relay (tests/test_proxy.py) -------------------------------------------

def _engage(cli, proxy, deadline_s: float = 8.0) -> dict:
    """Train through ``cli`` until the proxy's C++ relay has served a
    train: the first call notes the cluster, the refresher's next tick
    pushes the table."""
    cli.train([["a", Datum({"x": 1.0})], ["b", Datum({"x": -1.0})]])
    deadline = time.time() + deadline_s
    relayed: dict = {}
    while time.time() < deadline:
        time.sleep(0.3)
        cli.train([["a", Datum({"x": 1.0})]])
        relayed = proxy.rpc.relay_stats()
        if relayed.get("train"):
            break
    assert relayed.get("train"), "the relay never engaged"
    return relayed


def test_cpp_relay_plane_serves_and_counts():
    """After the refresher's first table push, random-routed raw traffic
    forwards in C++: answers unchanged, counts folded into
    get_proxy_status, and dead backends surface as errors, not hangs."""
    store = _Store()
    servers = [_member(store) for _ in range(2)]
    proxy = _front(store)
    cli = ClassifierClient("127.0.0.1", proxy.args.rpc_port, NAME,
                           timeout=30)
    try:
        relayed = _engage(cli, proxy)
        for _ in range(6):
            cli.train([["a", Datum({"x": 1.0})], ["b", Datum({"x": -1.0})]])
        (res,) = cli.classify([Datum({"x": 1.0})])
        assert max(res, key=lambda e: e[1])[0] == "a"
        (st,) = proxy.get_proxy_status("").values()
        assert st["relay_count"] >= relayed["train"] + 7
        assert st["request.train"] >= relayed["train"]
        assert st["forward_count"] >= st["relay_count"]
        # the relayed calls entered no Python: no dispatch span for them
        assert st["trace.rpc.train.count"] < st["request.train"]
        for s in servers:
            s.stop()
        with pytest.raises(Exception):
            for _ in range(20):
                cli.train([["a", Datum({"x": 1.0})]])
                time.sleep(0.3)
    finally:
        cli.close()
        proxy.stop()
        for s in servers:
            s.stop()


def test_cpp_relay_reroutes_on_membership_change():
    """A backend that leaves the routing table retires its pipes with the
    table's generation: traffic re-pins to the survivor on the same client
    connection (a call in flight when the backend died may fail)."""
    store = _Store()
    servers = [_member(store) for _ in range(2)]
    proxy = _front(store)
    cli = ClassifierClient("127.0.0.1", proxy.args.rpc_port, NAME,
                           timeout=30)
    try:
        _engage(cli, proxy)
        servers[0].stop()
        deadline = time.time() + 12.0
        streak = 0
        while time.time() < deadline and streak < 5:
            try:
                cli.train([["a", Datum({"x": 1.0})]])
                streak += 1
            except Exception:  # noqa: BLE001 — the window of the change
                streak = 0
                time.sleep(0.3)
        assert streak >= 5, "traffic never re-pinned to the survivor"
    finally:
        cli.close()
        proxy.stop()
        for s in servers:
            s.stop()


def test_cpp_relay_survives_garbage_backend():
    """A backend that answers garbage breaks only its pipe: the call
    errors, the client connection survives, and once the table drops the
    backend the Python handler serves."""
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(4)
    gport = lsock.getsockname()[1]

    def evil():
        try:
            conn, _ = lsock.accept()
            conn.recv(4096)
            conn.sendall(b"\xc1\xc1\xc1garbage\xff\xff")  # 0xc1: never valid
            time.sleep(0.2)
            conn.close()
        except OSError:
            pass

    threading.Thread(target=evil, daemon=True).start()
    srv = native_server.NativeRpcServer()
    served = []
    srv.register("probe", lambda n: served.append(n) or "py", arity=1)
    srv.serve_background(0, host="127.0.0.1")
    assert srv.relay_config(["probe"], {"c": [("127.0.0.1", gport)]},
                            timeout=5.0)
    try:
        with RpcClient("127.0.0.1", srv.port, timeout=10) as cli:
            with pytest.raises(Exception):
                cli.call("probe", "c")
            assert srv.relay_config(["probe"], {}, timeout=5.0) is True
            assert cli.call("probe", "c") == "py"
            assert served == ["c"]
            assert srv.relay_stats().get("__errors__", 0) >= 1
    finally:
        srv.stop()
        lsock.close()


def test_cpp_relay_exactly_one_response_under_backend_churn():
    """Pipelined relayed traffic while the backend dies and comes back:
    every msgid gets exactly one response, never none and never two."""
    backend = {"srv": None}

    def start_backend():
        b = native_server.NativeRpcServer()
        b.register("probe", lambda n, i: i, arity=2)
        p = b.serve_background(0, host="127.0.0.1")
        backend["srv"] = b
        return p

    bport = start_backend()
    front = native_server.NativeRpcServer()
    front.register("probe", lambda n, i: -1, arity=2)  # the Python path
    front.serve_background(0, host="127.0.0.1")
    assert front.relay_config(["probe"], {"c": [("127.0.0.1", bport)]},
                              timeout=3.0)
    sock = socket.create_connection(("127.0.0.1", front.port), timeout=30)
    unp = msgpack.Unpacker(raw=False)
    got: dict = {}
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            try:
                data = sock.recv(65536)
            except OSError:
                return
            if not data:
                return
            unp.feed(data)
            for msg in unp:
                got[msg[1]] = got.get(msg[1], 0) + 1

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    total, mid = 400, 0
    try:
        for wave in range(8):
            for _ in range(total // 8):
                mid += 1
                sock.sendall(msgpack.packb([0, mid, "probe", ["c", mid]]))
            if wave % 3 == 1:  # churn: the backend dies mid-wave
                backend["srv"].stop()
                time.sleep(0.2)
                assert front.relay_config(
                    ["probe"], {"c": [("127.0.0.1", start_backend())]},
                    timeout=3.0)
            time.sleep(0.15)
        deadline = time.time() + 20.0
        while time.time() < deadline and len(got) < total:
            time.sleep(0.2)
        assert len(got) == total, f"missing responses: {total - len(got)}"
        time.sleep(1.0)  # a late duplicate must not escape
        assert len(got) == total
        assert not {k: v for k, v in got.items() if v != 1}
    finally:
        stop.set()
        sock.close()
        front.stop()
        backend["srv"].stop()


# -- tests/test_usage_attribution.py ---------------------------------------------

def _whoami(native_transport: bool):
    srv = native_server.NativeRpcServer() if native_transport \
        else RpcServer()
    srv.register("whoami", lambda: principals.current() or "", arity=0)
    srv.serve_background(0, host="127.0.0.1")
    return srv


@pytest.mark.parametrize("native_transport", [False, True])
def test_envelope_4_to_7_elements_both_transports(native_transport):
    """Every envelope shape answers; the 7th element is the dispatch's
    principal; the earlier slots may be nil."""
    srv = _whoami(native_transport)
    try:
        cases = [
            ([0, 1, "whoami", []], ""),
            ([0, 2, "whoami", [], {}], ""),
            ([0, 3, "whoami", [], None, 30.0], ""),
            ([0, 4, "whoami", [], None, None, "tenant-a"], "tenant-a"),
            ([0, 5, "whoami", [], {}, 30.0, "tenant-b"], "tenant-b"),
        ]
        for env, expect in cases:
            msg = msgpack.unpackb(_exchange(srv.port, [msgpack.packb(env)])[
                env[1]])
            assert msg[:3] == [1, env[1], None], msg
            assert msg[3] == expect, env
    finally:
        srv.stop()


def test_cpp_relay_forwards_principal_verbatim():
    """The C++ relay forwards the 7-element frame verbatim: the backend's
    dispatch sees the tenant, with no decode at the relay."""
    back = native_server.NativeRpcServer()
    back.register("probe", lambda n: principals.current() or "", arity=1)
    bport = back.serve_background(0, host="127.0.0.1")
    front = native_server.NativeRpcServer()
    front.register("probe", lambda n: "(python)", arity=1)
    front.serve_background(0, host="127.0.0.1")
    try:
        assert front.relay_config(["probe"], {"c": [("127.0.0.1", bport)]},
                                  timeout=5.0)
        env = [0, 11, "probe", ["c"], None, None, "relayed-tenant"]
        msg = msgpack.unpackb(_exchange(front.port, [msgpack.packb(env)])[11])
        assert msg[2] is None and msg[3] == "relayed-tenant", msg
        assert front.relay_stats()["probe"] == 1
    finally:
        front.stop()
        back.stop()


def test_both_transports_bill_the_same_bytes():
    """The usage ledger's bytes in (the request frame) and out (the
    response frame) are the same on both transports for the same frames:
    plain, traced, tagged, a str8 method name and a long msgid."""
    from jubatus_tpu_torch.utils import usage as usage_mod

    frames = [msgpack.packb(f) for f in (
        [0, 1, "whoami", []],
        [0, 300, "whoami", [], {"t": "ab", "s": "cd"}],
        [0, 70000, "whoami", [], None, 30.0, "tenant-a"])]
    m = b"whoami"
    frames.append(b"\x94\x00\x04\xd9" + bytes([len(m)]) + m
                  + msgpack.packb([]))
    rows = []
    for native_transport in (False, True):
        srv = _whoami(native_transport)
        srv.usage_recorder = usage_mod.UsageLedger(top=8)
        try:
            _exchange(srv.port, frames)
            table = srv.usage_recorder.snapshot()["table"]
        finally:
            srv.stop()
        rows.append({p: v["whoami"] for p, v in table.items()})
    bytes_in = usage_mod.FIELDS.index("bytes_in")
    bytes_out = usage_mod.FIELDS.index("bytes_out")
    assert set(rows[0]) == set(rows[1]) and rows[0]
    for p in rows[0]:
        assert rows[0][p][bytes_in] == rows[1][p][bytes_in], p
        assert rows[0][p][bytes_out] == rows[1][p][bytes_out], p
    assert sum(r[bytes_in] for r in rows[0].values()) == \
        sum(len(f) for f in frames)


# -- the relay's counters against the JAX proxy's ----------------------------------

def test_relay_counters_equal_the_jax_proxy(monkeypatch):
    """A JAX proxy and a port proxy, both native, each before one member
    of its own package: once the relay has engaged, N more raw ``train``
    calls move each proxy's ``forward_count``, ``request.train`` and
    ``relay_count`` by N."""
    from jubatus_tpu.coord.memory import MemoryCoordinator as JMemCoord
    from jubatus_tpu.coord.memory import _Store as JStore
    from jubatus_tpu.server import EngineServer as JEngineServer
    from jubatus_tpu.server.args import ServerArgs as JServerArgs
    from jubatus_tpu.server.proxy import Proxy as JProxy
    from jubatus_tpu.server.proxy import ProxyArgs as JProxyArgs

    monkeypatch.setenv("JUBATUS_TPU_NATIVE_RPC", "1")
    n = 7
    jstore, store = JStore(), _Store()
    jsrv = JEngineServer("classifier", CONF, JServerArgs(
        engine="classifier", coordinator="(shared)", name=NAME,
        listen_addr="127.0.0.1", interval_sec=1e9, interval_count=1 << 30),
        coord=JMemCoord(jstore))
    jsrv.start(0)
    srv = _member(store)
    jproxy = JProxy(JProxyArgs(engine="classifier", listen_addr="127.0.0.1"),
                    coord=JMemCoord(jstore))
    jproxy.start(0)
    proxy = _front(store)
    keys = ("forward_count", "relay_count", "request.train")
    moved = []
    try:
        assert isinstance(jproxy.rpc, jnative.NativeRpcServer)
        assert isinstance(proxy.rpc, native_server.NativeRpcServer)
        for p in (proxy, jproxy):
            with ClassifierClient("127.0.0.1", p.args.rpc_port, NAME,
                                  timeout=30) as c:
                _engage(c, p)
                (before,) = p.get_proxy_status("").values()
                for i in range(n):
                    assert c.train([["ab"[i % 2], Datum({"x": i - 3.0})]]) \
                        == 1
                (after,) = p.get_proxy_status("").values()
            moved.append({k: after[k] - before[k] for k in keys})
            assert after["forward_errors"] == 0
    finally:
        proxy.stop()
        jproxy.stop()
        srv.stop()
        jsrv.stop()
    assert moved[0] == moved[1] == {k: n for k in keys}


# -- the port's own cases ------------------------------------------------------------

def test_deferred_profile_device_does_not_block_its_connection(tmp_path,
                                                               monkeypatch):
    """``profile_device`` answers with a future: on the native transport
    its reply goes out through ``jt_rpc_respond`` when the capture ends,
    while the connection's C++ reader serves the requests pipelined
    behind it (their answers come first)."""
    monkeypatch.delenv("JUBATUS_TPU_NATIVE_RPC", raising=False)
    srv = EngineServer("classifier", CONF, ServerArgs(
        engine="classifier", listen_addr="127.0.0.1",
        profile_dir=str(tmp_path / "artifacts")), device="cpu")
    port = srv.start(0)
    try:
        assert isinstance(srv.rpc, native_server.NativeRpcServer)
        frames = [msgpack.packb([0, 1, "profile_device", ["", 1.0]])] + [
            msgpack.packb([0, i, "get_status", [""]]) for i in (2, 3)]
        order = []
        unp = msgpack.Unpacker(raw=False, strict_map_key=False)
        with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
            t0 = time.monotonic()
            s.sendall(b"".join(frames))
            while len(order) < 3:
                data = s.recv(65536)
                assert data
                unp.feed(data)
                for msg in unp:
                    order.append((msg[1], time.monotonic() - t0, msg))
        # the two reads pipelined behind the capture answer first
        assert [o[0] for o in order] == [2, 3, 1]
        assert order[2][1] >= 0.9
        (cap,) = order[2][2][3].values()
        assert order[2][2][2] is None
        assert "artifact" in cap and cap["bytes"] > 0
        assert cap["timing_ms"]["window"] >= 1000
    finally:
        srv.stop()


def test_drain_gate_refuses_on_the_native_transport(monkeypatch):
    """The drain plane's gate (``dispatch_gate``) refuses effectful calls
    with the retryable ``NodeDraining`` on the native transport as on the
    Python one, raw path and decoded path alike, byte for byte; reads and
    get_status still answer."""
    answers = []
    frames = [msgpack.packb(f) for f in (
        [0, 1, "train", ["", [["a", Datum({"x": 1.0}).to_msgpack()]]]],
        [0, 2, "clear", [""]],
        [0, 3, "get_labels", [""]])]
    for transport in ("0", "1"):
        monkeypatch.setenv("JUBATUS_TPU_NATIVE_RPC", transport)
        srv = EngineServer("classifier", CONF, ServerArgs(
            engine="classifier", listen_addr="127.0.0.1",
            telemetry_interval=0), device="cpu")
        port = srv.start(0)
        try:
            assert isinstance(srv.rpc, native_server.NativeRpcServer) == \
                (transport == "1")
            srv.drain_ctl._install_gate()
            answers.append(_exchange(port, frames))
            (st,) = srv.get_status("").values()
            assert st["trace.counter.rpc.drain_rejected"] == 2
        finally:
            srv.stop()
    assert answers[0] == answers[1]
    train, clear, labels = (msgpack.unpackb(answers[1][i]) for i in (1, 2, 3))
    assert train[2] is not None and clear[2] is not None
    assert "draining" in str(train[2]) or train[2] == clear[2]
    assert labels[2] is None


@pytest.mark.parametrize("value,native_transport", [
    ("", True), ("1", True), ("0", False), ("false", False), ("no", False)])
def test_factory_follows_the_switch(monkeypatch, value, native_transport):
    monkeypatch.setenv("JUBATUS_TPU_NATIVE_RPC", value)
    srv = native_server.create_rpc_server()
    try:
        assert isinstance(srv, native_server.NativeRpcServer) == \
            native_transport
        assert type(srv) is (native_server.NativeRpcServer
                             if native_transport else RpcServer)
        assert srv.wire_detect is True
    finally:
        srv.stop()


def test_failed_build_raises_at_server_and_proxy_start(monkeypatch,
                                                       tmp_path):
    """With no compiler, the native transport's build raises
    ``NativeBuildError`` with the compiler's failure at server and proxy
    start; under ``JUBATUS_TPU_NATIVE_RPC=0`` both start on the Python
    transport and build nothing."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "torch_native")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native_server, "_lib", None)
    monkeypatch.setenv("JUBATUS_TPU_NATIVE_INGEST", "0")
    monkeypatch.delenv("JUBATUS_TPU_NATIVE_RPC", raising=False)
    assert not native_server.available()
    with pytest.raises(native.NativeBuildError, match="no-such-g"):
        EngineServer("classifier", CONF, ServerArgs(
            engine="classifier", listen_addr="127.0.0.1"), device="cpu")
    store = _Store()
    with pytest.raises(native.NativeBuildError, match="no-such-g"):
        Proxy(ProxyArgs(engine="classifier", listen_addr="127.0.0.1"),
              coord=MemoryCoordinator(store))
    monkeypatch.setenv("JUBATUS_TPU_NATIVE_RPC", "0")
    srv = _member(store)
    proxy = _front(store)
    try:
        assert type(srv.rpc) is RpcServer and type(proxy.rpc) is RpcServer
        with ClassifierClient("127.0.0.1", proxy.args.rpc_port, NAME) as c:
            assert c.train([["a", Datum({"x": 1.0})]]) == 1
    finally:
        proxy.stop()
        srv.stop()
    assert not (tmp_path / "torch_native").exists() or \
        not list((tmp_path / "torch_native").iterdir())
